"""Where a serving step's time goes on the card.

``wave_runtime`` sets up the request wave of ``chip_smoke.py``'s phases 3
to 6: one arch at full width (minicpm-2b, mamba2-2.7b, whisper-large-v3,
whose requests also carry seeded random frame embeddings, or mixtral-8x7b
at 16 of its 32 layers), with prompts of 6-200 tokens.  ``main`` serves it
and profiles two windows of engine steps with ``torch.profiler``: the first
steps, which mix chunked prefill and decode, and later decode-only steps.
For each window it prints the host wall time per step (ending in a device
synchronize), the device time per step (the sum of the CUDA kernels' own
times), the device's idle share, the number of kernel launches per step,
and the kernels that take the most device time.  ``window`` profiles any
step function the same way (``chip_smoke.py`` phase 7 a training step).

  PYTHONPATH=src python -m repro_torch.launch.profile_step --kv-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch whisper-large-v3
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch mixtral-8x7b
  PYTHONPATH=src python -m repro_torch.launch.profile_step --kv-dtype bf16 \
      --dense-view
  PYTHONPATH=src python -m repro_torch.launch.profile_step --templated \
      --prefix-cache 0

``--dense-view`` profiles phase 8 (b)'s wave instead: minicpm-2b's
dense-view step (``paged_native=False``) at 128 slots.  ``--templated``
profiles phase 9's: ``templated_wave``'s requests that share one prompt
template, after its donor request has been served.  ``--prefix-cache``
sets the plan's prefix-cache knob (-1, the default, is the category's
retention; 0 turns the cache off).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import plan_for
from repro_torch.models.registry import model_api
from repro_torch.serving.engine import (DEFAULT_BLOCK_SIZE,
                                        GenerationRequest, ServiceRuntime)


# slots the card holds at full width, where the plan's do not fit: the
# allocator plans mamba2-2.7b at 512 slots of 167.8 MB of f32 SSD state
# (86 GB) and whisper-large-v3 at 512 slots of 245.76 MB of bf16 cross K/V
# (125.8 GB), so the wave asks each for 128 (21.5 GB and 31.5 GB)
WAVE_BS = {"mamba2-2.7b": 128, "whisper-large-v3": 128}
# layers the card holds at full width where the full depth does not fit:
# mixtral-8x7b's 32 layers of bf16 weights take 93.4 GB, its first 16 (the
# only cut) 46.96 GB, beside 8.59 GB of bf16 KV at the plan's 512 slots
WAVE_LAYERS = {"mixtral-8x7b": 16}
ARCHS = ("minicpm-2b", "mamba2-2.7b", "whisper-large-v3", "mixtral-8x7b")
# phase 9's templated wave: 64 requests of a 150-token template (4 full
# pages and a 22-token partial tail) plus 1-40 tokens of their own, 24 new
# tokens each, within the plan's 256-token slots
TEMPLATE_TOKENS, MAX_TAIL, TEMPLATED_REQUESTS, TEMPLATED_NEW = 150, 40, 64, 24


def wave_runtime(kv_dtype, n_requests: int = 32, new_tokens: int = 40,
                 device="cuda", arch: str = "minicpm-2b", bs=None,
                 prefix_cache: int = -1, **runtime_kw):
    """A full-width ``ServiceRuntime`` of ``arch`` (random weights from
    seed 1) with ``n_requests`` prompts of 6-200 tokens, spread evenly,
    already submitted; audio requests carry standard-normal frame
    embeddings drawn from seed 1.  ``kv_dtype`` is the plan's (-1 = the
    category's choice), and so is ``prefix_cache``.  The plan is the
    full config's, at ``bs`` slots if given (else ``WAVE_BS``'s, else the
    allocator's); the weights are cut to ``WAVE_LAYERS`` where that names
    the arch.  ``runtime_kw`` go to the runtime (``mode``,
    ``paged_native``, ...).  Returns (cfg, runtime)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=WAVE_LAYERS.get(
        arch, full.num_layers))
    device = resolve_device(device)
    rt = ServiceRuntime(cfg, model_api(cfg).init(1, cfg, device),
                        plan_for(full, kv_dtype, bs or WAVE_BS.get(arch),
                                 prefix_cache),
                        device=device, **runtime_kw)
    rng = np.random.default_rng(2)
    frames = np.random.default_rng(1)
    for rid, n in enumerate(np.linspace(6, 200, n_requests).astype(int)):
        extras = None
        if cfg.family == "audio":
            extras = {"embeddings": frames.standard_normal(
                (cfg.encoder_len, cfg.d_model), dtype=np.float32)}
        rt.submit(GenerationRequest(
            rid=rid, tokens=rng.integers(0, cfg.vocab_size, n).astype(
                np.int32), max_new_tokens=new_tokens, stream=rid,
            extras=extras))
    return cfg, rt


def templated_wave(kv_dtype, prefix_cache: int, templates: int = 1,
                   device="cuda", params=None):
    """minicpm-2b at full width and the plan's slots, serving requests that
    share a prompt template, as a frequency service's periodic requests
    do: ``templates`` templates of ``TEMPLATE_TOKENS`` tokens (seed 3), and
    ``TEMPLATED_REQUESTS`` requests, each a template plus a tail of its
    own of 1-``MAX_TAIL`` tokens (seed 4), with ``TEMPLATED_NEW`` tokens to
    generate.  The first ``templates`` requests are the donors, one a
    template, whose tails are short enough (1-9 tokens) that their prompts
    end in the page holding the template's partial tail, so that serving a
    donor to its eviction indexes that tail; the others take the templates
    in turn.  ``params`` are reused if given (else random from seed 1).
    Returns (cfg, runtime, donors, others); nothing is submitted."""
    cfg = get_config("minicpm-2b")
    device = resolve_device(device)
    if params is None:
        params = model_api(cfg).init(1, cfg, device)
    rt = ServiceRuntime(cfg, params,
                        plan_for(cfg, kv_dtype, prefix_cache=prefix_cache),
                        device=device)
    rng = np.random.default_rng(3)
    bodies = [rng.integers(0, cfg.vocab_size, TEMPLATE_TOKENS)
              for _ in range(templates)]
    rng = np.random.default_rng(4)
    tails = rng.integers(1, MAX_TAIL + 1, TEMPLATED_REQUESTS)
    # tail rows left in the page that holds the template's partial tail
    room = DEFAULT_BLOCK_SIZE - TEMPLATE_TOKENS % DEFAULT_BLOCK_SIZE - 1
    tails[:templates] = rng.integers(1, room + 1, templates)
    reqs = [GenerationRequest(
        rid=rid, tokens=np.concatenate([
            bodies[rid % templates],
            rng.integers(0, cfg.vocab_size, tails[rid])]).astype(np.int32),
        max_new_tokens=TEMPLATED_NEW, stream=rid)
        for rid in range(TEMPLATED_REQUESTS)]
    return cfg, rt, reqs[:templates], reqs[templates:]


def serve_donors(rt, donors):
    """Serve a templated wave's donors to their eviction, which indexes
    their prompts' partial tails; returns their results."""
    for req in donors:
        rt.submit(req)
    return rt.drain()


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def window(step, steps: int, label: str, top: int) -> dict:
    """Profiles ``steps`` calls of ``step()`` and prints the window's
    wall, device time, idle share and kernels per step, and its ``top``
    kernels by device time.  Returns the four per-step figures."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    print(f"{label}: {steps} steps, wall {wall_ms:.3f} ms/step, device "
          f"{dev_ms:.3f} ms/step, idle share "
          f"{1 - dev_ms / wall_ms:.3f}, {launches:.0f} kernels/step")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:7.1f}/step  {e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "idle_share": 1 - dev_ms / wall_ms, "kernels": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="minicpm-2b")
    ap.add_argument("--kv-dtype", choices=("auto", "int8", "bf16"),
                    default="auto",
                    help="paged-KV precision: 'auto' = the plan's category "
                         "choice (int8 for minicpm-2b and whisper-large-v3, "
                         "bf16 for mixtral-8x7b)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=40)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--dense-view", action="store_true",
                    help="the dense-view step (paged_native=False, the "
                         "reference's oracle: dense chunk and decode "
                         "attention on a gathered view) at 128 slots, as "
                         "chip_smoke's phase 8 (b)")
    ap.add_argument("--templated", action="store_true",
                    help="minicpm-2b's templated wave (templated_wave, "
                         "chip_smoke's phase 9), after its donor")
    ap.add_argument("--prefix-cache", type=int, default=-1,
                    help="the plan's prefix-cache knob: -1 = the "
                         "category's retention, 0 = off, > 0 = idle blocks")
    args = ap.parse_args(argv)
    kv_dtype = -1 if args.kv_dtype == "auto" else args.kv_dtype
    if args.templated:
        _, rt, donors, others = templated_wave(kv_dtype, args.prefix_cache)
        serve_donors(rt, donors)
        for req in others:
            rt.submit(req)
        label, n = "templated", len(donors) + len(others)
    else:
        view = dict(bs=128, paged_native=False) if args.dense_view else {}
        _, rt = wave_runtime(kv_dtype, args.requests, args.max_new_tokens,
                             arch=args.arch, prefix_cache=args.prefix_cache,
                             **view)
        label = "dense-view" if args.dense_view else "native"
        n = args.requests
    # max_wait_s=0: the MF composer flushes partial frame groups at once,
    # as drain() does
    rt.step(max_wait_s=0.0)                     # first admission + warm-up
    print(f"{rt.cfg.name}, {rt.kv_dtype} KV, {rt.cfg.num_layers} layers, "
          f"{label} step, {n} requests, prefix cache "
          f"{'on' if rt.prefix_cache_enabled else 'off'}, "
          f"{rt.plan.max_in_flight} slots, {torch.cuda.get_device_name(0)}")
    step = lambda: rt.step(max_wait_s=0.0)
    window(step, args.steps, "prefill+decode window", args.top)
    while any(s.prefilling for g in rt.groups.values() for s in g.slots):
        step()
    window(step, args.steps, "decode-only window", args.top)
    rt.drain()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
