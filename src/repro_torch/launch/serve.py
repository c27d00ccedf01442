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

``--admission-policy sdf`` orders each step's queue by deadline slack,
sheds the requests that cannot make their ``--deadline-s`` (seconds from
the start of the run, 0 = none) with a verdict, and parks the laziest
decode slot for an urgent request (``--no-preempt`` turns parking off); the
run's clock is then the wall time since the first submission, as in the
reference.  ``--n-samples`` forks n-1 sibling slots off each request's
prompt (capped by the plan's category: minicpm-2b, a frequency service,
forks up to its batch size).  The launcher prints the verdicts,
preemptions and resumes, and exits 0 when every request was served or
rejected with a verdict:

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b \
      --admission-policy sdf --deadline-s 30 --requests 8

``--draft-arch`` names a draft model for speculative decoding: each
same-family same-vocabulary service of a latency plan speculates k tokens
a round (``--speculate``, -1 = the category's k, 4 for latency), the
others deploy without it and print a ``note:`` line.  Weights are seeded
by arch, so a draft of a deployed arch is a self-draft sharing its
tensors; on the card the draft runs its full config.  The launcher prints
the verify launches, the accepted tokens a launch, the draft steps and
the degraded slots:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --archs minicpm-2b,minitron-4b --draft-arch minitron-4b

``--trace-out``, ``--metrics-out`` and ``--calibrate-out`` write the run's
spans (Chrome trace-event JSON), metrics (Prometheus text, or a JSONL
snapshot for a ``.jsonl`` path) and simulator calibration (JSON), through
one tracer and one registry shared by every runtime, as the reference's
``make obs-smoke`` does:

  PYTHONPATH=src python -m repro_torch.launch.serve --archs minicpm-2b \
      --requests 6 --max-new-tokens 4 --trace-out trace.json \
      --metrics-out metrics.prom --calibrate-out calibration.json
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
from repro_torch.obs import (MetricsRegistry, Tracer, merge_telemetry,
                             telemetry_from_runtime, write_calibration)
from repro_torch.serving.engine import (PREFIX_CACHEABLE_FAMILIES,
                                        EparaServingEngine,
                                        GenerationRequest, ServiceRuntime)

# reference flags that are accepted but only at their defaults: the value
# that would need an unported part names the ROADMAP.md item porting it
_ITEM_MULTI_SERVER = "ROADMAP.md Queue 1 item 6 (multi-server control plane)"
_UNPORTED_FLAGS = (
    ("servers", 1, _ITEM_MULTI_SERVER),
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
    ap.add_argument("--trace-out", default="",
                    help="write the request and engine spans here "
                         "(Chrome trace-event JSON)")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics here: a JSONL snapshot for a "
                         ".jsonl path, else Prometheus text")
    ap.add_argument("--calibrate-out", default="",
                    help="write the simulator calibration derived from the "
                         "run here (JSON)")
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
    ap.add_argument("--admission-policy", choices=("fifo", "sdf"),
                    default="fifo",
                    help="admission control: arrival-order fifo (default) "
                         "or strictest-deadline-first: slack-ordered "
                         "queues, explicit reject verdicts, and preemption "
                         "of lazy decodes by block-table parking")
    ap.add_argument("--no-preempt", action="store_true",
                    help="with --admission-policy=sdf, disable block-table "
                         "parking (shed-only admission control)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request completion deadline in seconds from "
                         "submission (0 = none)")
    ap.add_argument("--n-samples", type=int, default=1,
                    help="parallel samples per request: n-1 sibling slots "
                         "fork off the prompt's blocks by refcount and "
                         "diverge copy-on-write (capped by the plan's "
                         "resolved_n_samples)")
    ap.add_argument("--speculate", type=int, default=-1,
                    help="speculative decoding draft depth k: -1 = the "
                         "plan's category default (latency services "
                         "speculate when a draft is given, frequency "
                         "services do not), 0 = off, > 0 = propose k tokens "
                         "a fused verify launch (requires --draft-arch)")
    ap.add_argument("--draft-arch", default="",
                    help="arch id of the draft model that proposes tokens "
                         "for speculative decoding; services of another "
                         "family or vocabulary deploy without speculation")
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
    if args.admission_policy != "fifo" and args.mode != "continuous":
        ap.error("--admission-policy=sdf requires --mode=continuous (the "
                 "controller acts between composer and slot engine)")
    if args.deadline_s < 0:
        ap.error(f"--deadline-s must be >= 0, got {args.deadline_s}")
    if args.n_samples < 1:
        ap.error(f"--n-samples must be >= 1, got {args.n_samples}")
    if args.speculate < -1:
        ap.error(f"--speculate must be -1 (category default), 0 "
                 f"(disabled) or a positive draft depth, got "
                 f"{args.speculate}")
    if args.speculate > 0 and not args.draft_arch:
        ap.error("--speculate > 0 requires --draft-arch (the model that "
                 "proposes the k tokens)")
    if args.draft_arch and args.draft_arch not in ARCH_IDS:
        ap.error(f"unknown --draft-arch {args.draft_arch!r}")
    if args.draft_arch and (args.mode != "continuous"
                            or args.kvcache_impl != "paged"
                            or args.no_chunked_prefill):
        ap.error("--draft-arch requires --mode=continuous, "
                 "--kvcache-impl=paged and chunked prefill (the draft "
                 "cache is chased through the paged chunk path)")
    arch_ids = [a.strip() for a in args.archs.split(",")]
    for a in arch_ids:
        if a not in ARCH_IDS:
            ap.error(f"unknown arch {a!r}; known: {ARCH_IDS}")
    device = resolve_device(args.device)
    kv_dtype = -1 if args.kv_dtype == "auto" else args.kv_dtype

    if device.type == "cuda":
        have = torch.cuda.get_device_properties(device).total_memory
        for a in arch_ids + ([args.draft_arch] if args.draft_arch else []):
            need = get_config(a).param_count() * 2
            if need > have:
                smoke = ("chip_smoke.py serves it at 16 of its 32 layers, "
                         if a == "mixtral-8x7b" else "")
                raise RuntimeError(
                    f"{a}'s bf16 weights ({need / 1e9:.1f} GB) exceed the "
                    f"card's memory ({have / 1e9:.1f} GB) at full width; "
                    f"{smoke}--device cpu serves its reduced config")

    engine = EparaServingEngine()
    # one tracer and one registry shared by every runtime: service names
    # become trace processes and metric labels
    tracer = Tracer() if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics_out else None
    cfgs = {}
    # weights are seeded per arch, so a draft of a deployed arch is a
    # self-draft: the service shares the draft's tensors
    weights = {}

    def params_of(arch, cfg):
        if arch not in weights:
            weights[arch] = model_api(cfg).init(
                zlib.crc32(arch.encode()) + args.seed, cfg, device)
        return weights[arch]

    draft_cfg = draft_params = None
    if args.draft_arch:
        full = get_config(args.draft_arch)
        draft_cfg = full if device.type == "cuda" else reduced(full)
        draft_params = params_of(args.draft_arch, draft_cfg)
    print("EPARA plans:")
    for a in arch_ids:
        full = get_config(a)
        cfg = full if device.type == "cuda" else reduced(full)
        cfgs[a] = cfg
        plan = dataclasses.replace(
            plan_for(full, kv_dtype, prefix_cache=args.prefix_cache),
            admission=args.admission_policy, speculate=args.speculate)
        print(f"  {a:20s} {plan.category} mp={plan.mp} bs={plan.bs} "
              f"mt={plan.mt} mf={plan.mf} dp={plan.dp} "
              f"kv={plan.resolved_kv_dtype()}")
        # the draft pairs only with same-family same-vocab services of a
        # cacheable family; the rest deploy without speculation (an
        # explicit --speculate > 0 still reaches the engine's gate)
        compat = (draft_cfg is not None
                  and cfg.family == draft_cfg.family
                  and cfg.vocab_size == draft_cfg.vocab_size
                  and cfg.family in PREFIX_CACHEABLE_FAMILIES)
        if draft_cfg is not None and not compat and args.speculate <= 0:
            print(f"  note: {a} incompatible with draft {args.draft_arch} "
                  f"(family/vocab) — non-speculative")
        engine.deploy(a, ServiceRuntime(
            cfg, params_of(a, cfg), plan, mode=args.mode,
            kvcache_impl=args.kvcache_impl, max_seq_len=args.max_seq_len,
            block_size=args.block_size,
            chunked_prefill=False if args.no_chunked_prefill else None,
            prefill_chunk=(args.prefill_chunk or None),
            preempt=not args.no_preempt, device=device,
            draft_params=draft_params if compat else None,
            draft_cfg=draft_cfg if compat else None,
            tracer=tracer, metrics=metrics))

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
            stream=i, extras=extras, n_samples=args.n_samples,
            deadline_s=args.deadline_s))
    launches0 = launch_counts()
    rejects = []
    # monotonic, not wall-clock: deadlines must not jump when the system
    # clock is slewed.  The data-plane clock is seconds since t0; the
    # deadlines and the admission controller's estimates live in it
    t0 = time.monotonic()
    clock = ((lambda: time.monotonic() - t0)
             if args.admission_policy == "sdf" else None)
    results = engine.serve_until_idle(
        clock=clock, on_stats=lambda name, st: rejects.extend(st.rejected))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    toks = sum(len(r.tokens) for r in results)
    rts = list(engine.runtimes.values())
    steps = sum(rt.decode_steps for rt in rts)
    chunks = sum(rt.prefill_chunk_calls for rt in rts)
    oneshot = sum(rt.oneshot_prefills for rt in rts)
    primaries = sum(1 for r in results if r.sample == 0)
    print(f"served {primaries}/{args.requests} requests, {toks} tokens "
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
    ver = sum(rt.verify_launches for rt in rts)
    acc = sum(rt.accepted_tokens for rt in rts)
    if ver or args.draft_arch:
        per = acc / ver if ver else 0.0
        print(f"speculative (draft={args.draft_arch or 'none'}): {ver} "
              f"verify launches, {acc} tokens accepted "
              f"({per:.2f}/launch), "
              f"{sum(rt.draft_steps for rt in rts)} draft steps, "
              f"{sum(rt.spec_degraded for rt in rts)} degraded, "
              f"{sum(rt.verify_traces for rt in rts)} verify compiles")
    forks = sum(rt.forks_spawned for rt in rts)
    if forks or args.n_samples > 1:
        print(f"parallel sampling (n={args.n_samples}): {forks} forks "
              f"spawned, {sum(rt.fork_shortfall for rt in rts)} shortfall")
    verdicts = {}
    for rt in rts:
        for v, n in rt.admission.verdicts.items():
            verdicts[v] = verdicts.get(v, 0) + n
    print(f"admission ({args.admission_policy}): "
          f"{verdicts or 'no verdicts'}, "
          f"{sum(rt.admission.preemptions for rt in rts)} preemptions, "
          f"{sum(rt.admission.resumes for rt in rts)} resumes, "
          f"{len(rejects)} final rejects")
    print("kernel launches: " + ", ".join(
        f"{k}={v - launches0[k]}" for k, v in launch_counts().items()))
    if tracer is not None:
        tracer.export(args.trace_out)
        print(f"trace: {tracer.emitted} events "
              f"({tracer.dropped} dropped by the ring) -> {args.trace_out}")
    if metrics is not None:
        if args.metrics_out.endswith(".jsonl"):
            metrics.append_jsonl(args.metrics_out)
        else:
            metrics.write_prometheus(args.metrics_out)
        print(f"metrics: {len(metrics._metrics)} series -> "
              f"{args.metrics_out}")
    if args.calibrate_out:
        tel = merge_telemetry(telemetry_from_runtime(name, rt)
                              for name, rt in engine.runtimes.items())
        cal = write_calibration(args.calibrate_out, tel)
        print(f"calibration: spec_accept_rate={cal.spec_accept_rate:.3f} "
              f"prefix_hit_rates={cal.prefix_hit_rates or {}} "
              f"prefill_token_s={cal.prefill_token_s:.2e} -> "
              f"{args.calibrate_out}")
    # every request is accounted for: served, or rejected with a verdict
    return 0 if primaries + len(rejects) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
