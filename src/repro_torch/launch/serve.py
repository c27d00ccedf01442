"""Serving launcher for one server: plan each service with the EPARA
allocator, deploy one ``ServiceRuntime`` per arch, submit requests, drain.

On the card the services run at their full config; with ``--device cpu``
they run ``reduced(full)``, as the reference's CPU data plane does.  The
plan is computed for the allocator's default ``GPUSpec`` (the reference's
target hardware), so it matches the reference's plan.

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b

``--archs`` also takes mamba2-2.7b (the reference's default pair is
``minicpm-2b,mamba2-2.7b``) and whisper-large-v3, whose requests carry
zero frame embeddings, as the reference's do.  At full width neither plan
fits one 80 GB card: the allocator plans both at 512 slots, and a slot
holds 167.8 MB of SSD state (mamba2-2.7b, 86 GB in all) or 245.76 MB of
cross-attention K/V (whisper-large-v3, 125.8 GB).  On the card they run at
128 slots through ``chip_smoke.py``, which asks ``plan_for`` for them; on
the CPU the reduced configs serve at the plan's slots.

It takes the MoE archs mixtral-8x7b and grok-1-314b too.  Their full
configs' bf16 weights (93.4 GB and 633 GB) do not fit one card, so on the
card the launcher refuses them before allocating anything;
``chip_smoke.py`` serves mixtral-8x7b at 16 of its 32 layers.  On the CPU
the reduced configs serve; reduced(mixtral-8x7b)'s 64-token sliding window
is shorter than the default 256-token slot budget, so its K/V is a ring of
the last 64 tokens per slot and its prompts prefill in one shot.

The radix prefix cache runs at the category's retention unless
``--prefix-cache`` says otherwise (0 turns it off, > 0 retains that many
idle blocks); the launcher prints its hits, reused and computed prompt
tokens, copy-on-write copies and LRU evictions.  ``--mode sync`` serves
run-to-completion batches, ``--kvcache-impl dense`` the pre-arena dense
cache, ``--no-chunked-prefill`` one-shot prefill at admission, as in the
reference (the cache needs chunked prefill on the paged arena, so these
turn it off):

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b \
      --mode sync
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import zlib

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core.allocator import allocate
from repro_torch.core.categories import GPUSpec, Sensitivity, ServiceSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import launch_counts
from repro_torch.models.registry import model_api
from repro_torch.serving.engine import (PREFIX_CACHEABLE_FAMILIES,
                                        EparaServingEngine,
                                        GenerationRequest, ServiceRuntime)

# reference flags that are accepted but only at their defaults: the value
# that would need an unported part names the ROADMAP.md item porting it
_ITEM_MULTI_SERVER = "ROADMAP.md Queue 1 item 6 (multi-server control plane)"
_UNPORTED_FLAGS = (
    ("servers", 1, _ITEM_MULTI_SERVER),
    ("admission_policy", "fifo", "ROADMAP.md Queue 1 item 3 (SDF admission)"),
    ("no_preempt", False, "ROADMAP.md Queue 1 item 3 (SDF admission)"),
    ("deadline_s", 0.0, "ROADMAP.md Queue 1 item 3 (SDF admission)"),
    ("speculate", -1, "ROADMAP.md Queue 1 item 4 (speculation and forks)"),
    ("draft_arch", "", "ROADMAP.md Queue 1 item 4 (speculation and forks)"),
    ("n_samples", 1, "ROADMAP.md Queue 1 item 4 (speculation and forks)"),
    ("trace_out", "", "ROADMAP.md Queue 1 item 5 (observability)"),
    ("metrics_out", "", "ROADMAP.md Queue 1 item 5 (observability)"),
    ("calibrate_out", "", "ROADMAP.md Queue 1 item 5 (observability)"),
    ("fault_spec", "", _ITEM_MULTI_SERVER),
    ("chaos_seed", -1, _ITEM_MULTI_SERVER),
    ("chaos_horizon_s", 20.0, _ITEM_MULTI_SERVER),
    ("retry_timeout_s", 8.0, _ITEM_MULTI_SERVER),
    ("retry_max_attempts", 4, _ITEM_MULTI_SERVER),
    ("pjit_decode", False, "ROADMAP.md Queue 1 item 13 (launch tooling)"),
)


def service_spec_for(cfg) -> ServiceSpec:
    return ServiceSpec(
        name=cfg.name,
        flops_per_request=2.0 * cfg.active_param_count() * 64,
        weights_bytes=cfg.param_count() * 2.0,
        vram_bytes=cfg.param_count() * 2.0 * 1.5 + 5e8,
        sensitivity=Sensitivity(cfg.epara_sensitivity),
        slo_latency_s=2.0, slo_fps=20.0 if
        cfg.epara_sensitivity == "frequency" else 0.0,
        arch=cfg.name, stateful=cfg.family in ("ssm", "hybrid"),
        prefix_cacheable=cfg.family in PREFIX_CACHEABLE_FAMILIES)


def plan_for(full, kv_dtype=-1, bs=None, prefix_cache=-1):
    """The allocator's plan for config ``full`` on the default ``GPUSpec``,
    with ``kv_dtype`` and ``prefix_cache`` (-1 = the category's choice for
    either), and ``bs`` slots if given (the allocator's own ``user_bs``;
    None = its profile)."""
    return dataclasses.replace(
        allocate(service_spec_for(full), GPUSpec(), user_bs=bs),
        prefix_cache=prefix_cache, kv_dtype=kv_dtype)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="minicpm-2b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seq-len", type=int, default=256,
                    help="per-slot token budget the paged arena is sized "
                         "for (prompt + max_new_tokens)")
    ap.add_argument("--block-size", type=int, default=32,
                    help="paged-arena block size in tokens")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunk bucket size in tokens (0 = the plan's "
                         "category-derived default)")
    ap.add_argument("--kv-dtype", default="auto",
                    help="paged-KV pool precision: 'auto' = the plan's "
                         "category-derived choice, or 'bf16'/'int8'")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, full configs) or 'cpu' (reduced "
                         "configs)")
    # accepted for the reference's command lines; see _UNPORTED_FLAGS
    ap.add_argument("--mode", choices=("continuous", "sync"),
                    default="continuous",
                    help="serving data plane: slot-based continuous "
                         "batching (default) or run-to-completion batches")
    ap.add_argument("--kvcache-impl", choices=("paged", "dense"),
                    default="paged",
                    help="cache data plane: the fixed-capacity paged KV "
                         "arena (default) or the dense merge path")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="prefill each prompt in one shot at admission "
                         "instead of in chunks inside the decode loop")
    ap.add_argument("--servers", type=int, default=1)
    ap.add_argument("--prefix-cache", type=int, default=-1,
                    help="radix prefix-cache retention: -1 = the plan's "
                         "category-derived bound (frequency retains the "
                         "whole pool, latency a quarter), 0 = disabled, "
                         ">0 = max idle cached blocks")
    ap.add_argument("--admission-policy", default="fifo")
    ap.add_argument("--no-preempt", action="store_true")
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--speculate", type=int, default=-1)
    ap.add_argument("--draft-arch", default="")
    ap.add_argument("--n-samples", type=int, default=1)
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--calibrate-out", default="")
    ap.add_argument("--fault-spec", default="")
    ap.add_argument("--chaos-seed", type=int, default=-1)
    ap.add_argument("--chaos-horizon-s", type=float, default=20.0)
    ap.add_argument("--retry-timeout-s", type=float, default=8.0)
    ap.add_argument("--retry-max-attempts", type=int, default=4)
    ap.add_argument("--pjit-decode", action="store_true")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    for name, default, item in _UNPORTED_FLAGS:
        value = getattr(args, name)
        if value != default:
            flag = "--" + name.replace("_", "-")
            ap.error(f"{flag}={value!r} is not ported to repro_torch yet "
                     f"({item}); only {default!r} is")
    if args.block_size < 1:
        ap.error(f"--block-size must be positive, got {args.block_size}")
    if args.prefill_chunk < 0 or (args.prefill_chunk
                                  and args.prefill_chunk % args.block_size):
        ap.error(f"--prefill-chunk must be 0 (category default) or a "
                 f"positive multiple of --block-size={args.block_size}, "
                 f"got {args.prefill_chunk}")
    if args.prefix_cache < -1:
        ap.error(f"--prefix-cache must be -1 (category default), 0 "
                 f"(disabled) or a positive block count, got "
                 f"{args.prefix_cache}")
    if args.kv_dtype not in ("auto", "bf16", "int8"):
        ap.error(f"--kv-dtype must be auto (category default), bf16 or "
                 f"int8, got {args.kv_dtype!r}")
    if args.kv_dtype == "int8" and args.kvcache_impl != "paged":
        ap.error("--kv-dtype=int8 requires --kvcache-impl=paged (only "
                 "page pools are block-quantized)")
    arch_ids = [a.strip() for a in args.archs.split(",")]
    for a in arch_ids:
        if a not in ARCH_IDS:
            ap.error(f"unknown arch {a!r}; known: {ARCH_IDS}")
    device = resolve_device(args.device)
    kv_dtype = -1 if args.kv_dtype == "auto" else args.kv_dtype

    if device.type == "cuda":
        have = torch.cuda.get_device_properties(device).total_memory
        for a in arch_ids:
            need = get_config(a).param_count() * 2
            if need > have:
                smoke = ("chip_smoke.py serves it at 16 of its 32 layers, "
                         if a == "mixtral-8x7b" else "")
                raise RuntimeError(
                    f"{a}'s bf16 weights ({need / 1e9:.1f} GB) exceed the "
                    f"card's memory ({have / 1e9:.1f} GB) at full width; "
                    f"{smoke}--device cpu serves its reduced config")

    engine = EparaServingEngine()
    cfgs = {}
    print("EPARA plans:")
    for a in arch_ids:
        full = get_config(a)
        cfg = full if device.type == "cuda" else reduced(full)
        cfgs[a] = cfg
        plan = plan_for(full, kv_dtype, prefix_cache=args.prefix_cache)
        print(f"  {a:20s} {plan.category} mp={plan.mp} bs={plan.bs} "
              f"mt={plan.mt} mf={plan.mf} dp={plan.dp} "
              f"kv={plan.resolved_kv_dtype()}")
        params = model_api(cfg).init(zlib.crc32(a.encode()) + args.seed,
                                     cfg, device)
        engine.deploy(a, ServiceRuntime(
            cfg, params, plan, mode=args.mode,
            kvcache_impl=args.kvcache_impl, max_seq_len=args.max_seq_len,
            block_size=args.block_size,
            chunked_prefill=False if args.no_chunked_prefill else None,
            prefill_chunk=(args.prefill_chunk or None), device=device))

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        svc = arch_ids[i % len(arch_ids)]
        rng.integers(0, args.servers)    # the reference's entry-server draw
        cfg = cfgs[svc]
        prompt = rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
        extras = None
        if cfg.family == "audio":
            extras = {"embeddings": np.zeros((cfg.encoder_len, cfg.d_model),
                                             np.float32)}
        engine.submit(svc, GenerationRequest(
            rid=i, tokens=prompt, max_new_tokens=args.max_new_tokens,
            stream=i, extras=extras))
    launches0 = launch_counts()
    t0 = time.monotonic()
    results = engine.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    toks = sum(len(r.tokens) for r in results)
    rts = list(engine.runtimes.values())
    steps = sum(rt.decode_steps for rt in rts)
    chunks = sum(rt.prefill_chunk_calls for rt in rts)
    oneshot = sum(rt.oneshot_prefills for rt in rts)
    print(f"served {len(results)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s, {steps} fused "
          f"decode steps, {chunks} prefill chunks, {oneshot} one-shot "
          f"prefills, mode={args.mode}, kvcache={args.kvcache_impl}, "
          f"device={device})")
    print(f"prefix cache: {sum(rt.prefix_hits for rt in rts)} hits, "
          f"{sum(rt.prefix_hit_tokens for rt in rts)} prompt tokens reused, "
          f"{sum(rt.prefill_tokens_computed for rt in rts)} computed, "
          f"{sum(rt.prefix_cow_copies for rt in rts)} COW copies, "
          f"{sum(rt.prefix_evictions for rt in rts)} LRU evictions, "
          f"{oneshot} one-shot prefills")
    print("kernel launches: " + ", ".join(
        f"{k}={v - launches0[k]}" for k, v in launch_counts().items()))
    return 0 if len(results) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
