"""Where a serving step's time goes on the card.

``wave_runtime`` sets up the request wave of ``chip_smoke.py``'s phases 3
to 6, 12, 14 and 15: one arch at full width (minicpm-2b, mamba2-2.7b,
whisper-large-v3, whose requests also carry seeded random frame
embeddings, mixtral-8x7b at 16 of its 32 layers, minitron-4b,
paligemma-3b, whose requests carry seeded random image embeddings in
512-token slots, or zamba2-7b at its plan's 256 slots), with prompts of
6-200 tokens.  ``main`` serves it and
profiles two windows of engine steps with ``torch.profiler``: the first
steps, which mix chunked prefill and decode, and later decode-only
steps.  For each window it
prints the host wall time per step (ending in a device synchronize), the
device time per step (the sum of the CUDA kernels' own times), the
device's idle share, the number of kernel launches per step, the host's
time blocked in synchronizing CUDA calls (the read-backs) per step, and
the kernels that take the most device time.  ``window`` profiles any step
function the same way (``chip_smoke.py`` phase 7 a training step).

  PYTHONPATH=src python -m repro_torch.launch.profile_step --kv-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch mamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch whisper-large-v3
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch mixtral-8x7b
  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch paligemma-3b
  PYTHONPATH=src python -m repro_torch.launch.profile_step --arch zamba2-7b
  PYTHONPATH=src python -m repro_torch.launch.profile_step --kv-dtype bf16 \
      --dense-view
  PYTHONPATH=src python -m repro_torch.launch.profile_step --templated \
      --prefix-cache 0

``--temperature`` (and ``--top-k``) serve the wave with the stochastic
sampler instead of greedy argmax (``chip_smoke.py`` phase 11 (b)):

  PYTHONPATH=src python -m repro_torch.launch.profile_step --kv-dtype int8 \
      --temperature 0.8 --top-k 50

``goodput_trace`` runs the reference's goodput overload trace
(``benchmarks/continuous_batching.py``'s ``_goodput_overload_rows``) on a
runtime the caller builds: phase 11 (c) at full width, the CPU tests on
the toy config.

``--draft-arch`` serves the wave with speculative decoding (``--speculate``
k, -1 = the category's), the draft at its full config, seeded as the
launcher seeds it (a draft of the profiled arch is a self-draft sharing
its weights); the second window then profiles speculation rounds, taken
once every slot's draft has caught up (``chip_smoke.py`` phase 12):

  PYTHONPATH=src python -m repro_torch.launch.profile_step \
      --arch minitron-4b --draft-arch minitron-4b

``--train`` profiles the second step of a training run instead: the
flags after it are the training launcher's (``chip_smoke.py`` phases 7
and 16), e.g.

  PYTHONPATH=src python -m repro_torch.launch.profile_step --train \
      --arch mamba2-2.7b --batch 2 --seq 4096 --microbatches 2 --lr 1e-3

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
import zlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import plan_for
from repro_torch.models.registry import model_api
from repro_torch.serving.engine import (DEFAULT_BLOCK_SIZE,
                                        GenerationRequest, ServiceRuntime)
from repro_torch.serving.sampler import SamplerConfig


# slots the card holds at full width, where the plan's do not fit: the
# allocator plans mamba2-2.7b at 512 slots of 167.8 MB of f32 SSD state
# (86 GB) and whisper-large-v3 at 512 slots of 245.76 MB of bf16 cross K/V
# (125.8 GB), so the wave asks each for 128 (21.5 GB and 31.5 GB)
WAVE_BS = {"mamba2-2.7b": 128, "whisper-large-v3": 128}
# layers the card holds at full width where the full depth does not fit:
# mixtral-8x7b's 32 layers of bf16 weights take 93.4 GB, its first 16 (the
# only cut) 46.96 GB, beside 8.59 GB of bf16 KV at the plan's 512 slots
WAVE_LAYERS = {"mixtral-8x7b": 16}
# slot budgets where the launcher's default 256 tokens do not hold a
# request: paligemma-3b's 256-row image prefix, a prompt of up to 200
# tokens and 40 new ones take 496
WAVE_MAX_SEQ_LEN = {"paligemma-3b": 512}
ARCHS = ("minicpm-2b", "mamba2-2.7b", "whisper-large-v3", "mixtral-8x7b",
         "minitron-4b", "paligemma-3b", "zamba2-7b")
# phase 9's templated wave: 64 requests of a 150-token template (4 full
# pages and a 22-token partial tail) plus 1-40 tokens of their own, 24 new
# tokens each, within the plan's 256-token slots
TEMPLATE_TOKENS, MAX_TAIL, TEMPLATED_REQUESTS, TEMPLATED_NEW = 150, 40, 64, 24


def wave_runtime(kv_dtype, n_requests: int = 32, new_tokens: int = 40,
                 device="cuda", arch: str = "minicpm-2b", bs=None,
                 prefix_cache: int = -1, **runtime_kw):
    """A full-width ``ServiceRuntime`` of ``arch`` (random weights from
    seed 1, or ``runtime_kw["params"]``) with ``n_requests`` prompts of
    6-200 tokens, spread evenly, already submitted; audio requests carry
    standard-normal frame embeddings drawn from seed 1, VLM requests
    standard-normal image embeddings (the prefix) from seed 1
    (``wave_extras``).  ``kv_dtype`` is the plan's (-1 = the category's
    choice), and so is ``prefix_cache``.
    The plan is the full config's, at ``bs`` slots if given (else
    ``WAVE_BS``'s, else the allocator's); the weights are cut to
    ``WAVE_LAYERS`` where that names the arch, and the slots hold
    ``WAVE_MAX_SEQ_LEN``'s tokens where that names it.  ``runtime_kw`` go
    to the runtime (``mode``, ``paged_native``, ...).  Returns (cfg,
    runtime)."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=WAVE_LAYERS.get(
        arch, full.num_layers))
    device = resolve_device(device)
    params = runtime_kw.pop("params", None)
    if params is None:
        params = model_api(cfg).init(1, cfg, device)
    if arch in WAVE_MAX_SEQ_LEN:
        runtime_kw.setdefault("max_seq_len", WAVE_MAX_SEQ_LEN[arch])
    rt = ServiceRuntime(cfg, params,
                        plan_for(full, kv_dtype, bs or WAVE_BS.get(arch),
                                 prefix_cache),
                        device=device, **runtime_kw)
    for rid, (prompt, extras) in enumerate(zip(
            wave_prompts(cfg.vocab_size, n_requests),
            wave_extras(cfg, n_requests))):
        rt.submit(GenerationRequest(
            rid=rid, tokens=prompt, max_new_tokens=new_tokens, stream=rid,
            extras=extras))
    return cfg, rt


def wave_extras(cfg, n_requests: int = 32):
    """``wave_runtime``'s request extras (seed 1), request ``i`` the
    ``i``-th: standard-normal frame embeddings (audio) or image embeddings
    (VLM) of (rows, d_model), else None."""
    if cfg.family not in ("audio", "vlm"):
        return [None] * n_requests
    rows = cfg.encoder_len if cfg.family == "audio" else cfg.prefix_len
    frames = np.random.default_rng(1)
    return [{"embeddings": frames.standard_normal((rows, cfg.d_model),
                                                  dtype=np.float32)}
            for _ in range(n_requests)]


def wave_prompts(vocab_size: int, n_requests: int = 32):
    """``wave_runtime``'s prompts (seed 2): ``n_requests`` of 6-200
    tokens, spread evenly, request ``i`` the ``i``-th."""
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab_size, n).astype(np.int32)
            for n in np.linspace(6, 200, n_requests).astype(int)]


def draft_spec(arch: str, draft_arch: str, device="cuda") -> dict:
    """The runtime arguments of a full-config draft of ``draft_arch`` for
    ``wave_runtime(arch=arch)``: a draft of the same arch shares the wave's
    weights (seed 1), another is seeded by its name; both at the wave's
    depth (``WAVE_LAYERS``)."""
    full = get_config(draft_arch)
    cfg = dataclasses.replace(full, num_layers=WAVE_LAYERS.get(
        draft_arch, full.num_layers))
    device = resolve_device(device)
    seed = 1 if draft_arch == arch else zlib.crc32(draft_arch.encode())
    params = model_api(cfg).init(seed, cfg, device)
    out = {"draft_params": params, "draft_cfg": cfg}
    if draft_arch == arch:
        out["params"] = params
    return out


def templated_wave(kv_dtype, prefix_cache: int, templates: int = 1,
                   device="cuda", params=None,
                   n_requests: int = TEMPLATED_REQUESTS):
    """minicpm-2b at full width and the plan's slots, serving requests that
    share a prompt template, as a frequency service's periodic requests
    do: ``templates`` templates of ``TEMPLATE_TOKENS`` tokens (seed 3), and
    ``n_requests`` requests (the first of ``TEMPLATED_REQUESTS``, drawn
    alike whatever their number), each a template plus a tail of its
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
        for rid in range(n_requests)]
    return cfg, rt, reqs[:templates], reqs[templates:]


def serve_donors(rt, donors):
    """Serve a templated wave's donors to their eviction, which indexes
    their prompts' partial tails; returns their results."""
    for req in donors:
        rt.submit(req)
    return rt.drain()


def goodput_trace(make_runtime, vocab_size: int, request_cls=None,
                  n_urgent: int = 8, long_new: int = 48,
                  budget: float = 14.0) -> dict:
    """The reference's goodput overload trace on ``make_runtime()``, under
    a logical clock (one tick a round): two deadline-less warmup requests
    (4-token prompts, 4 new tokens) served to idle; two deadline-less
    stragglers (6-token prompts, ``long_new`` new tokens) and two rounds;
    then ``n_urgent`` requests (4-token prompts, 4 new tokens, deadline
    ``budget`` ticks after submission), one every 3 rounds; then drained.
    Prompts come from ``default_rng(7)`` in that order.  ``request_cls``
    builds the requests (the port's ``GenerationRequest`` by default).

    Returns the on-time count (deadline-less requests count as on time),
    completed, rejected (each with its verdict) and submitted counts, the
    controller's preemptions, resumes and verdicts, the arenas' parks,
    parked blocks and live slots at the end, and the tokens and
    ``finished_s`` of each completed (rid, sample)."""
    request_cls = request_cls or GenerationRequest
    rt = make_runtime()
    rng = np.random.default_rng(7)
    results, rejected, deadlines = [], [], {}
    t = 0.0

    def step():
        nonlocal t
        st = rt.step(now=t)
        results.extend(st.results)
        rejected.extend(st.rejected)
        t += 1.0

    def drain():
        while rt.pending() or rt.in_flight():
            step()
            if t >= 5000.0:
                raise RuntimeError("the runtime failed to drain")

    def prompt(n):
        return rng.integers(1, vocab_size, n).astype(np.int32)

    for i in range(2):
        rt.submit(request_cls(rid=1000 + i, tokens=prompt(4),
                              max_new_tokens=4), now=t)
    drain()
    for i in range(2):
        rt.submit(request_cls(rid=i, tokens=prompt(6),
                              max_new_tokens=long_new), now=t)
    for _ in range(2):
        step()
    for i in range(n_urgent):
        deadlines[100 + i] = t + budget
        rt.submit(request_cls(rid=100 + i, tokens=prompt(4),
                              max_new_tokens=4, deadline_s=t + budget),
                  now=t)
        for _ in range(3):
            step()
    drain()
    arenas = [g.arena for g in rt.groups.values() if g.arena is not None]
    ctrl = rt.admission
    return {
        "goodput_ontime": sum(1 for r in results
                              if not deadlines.get(r.rid)
                              or r.finished_s <= deadlines[r.rid]),
        "completed": len(results), "rejected": len(rejected),
        "submitted": 4 + n_urgent,
        "reject_verdicts": sorted((r.req.rid, r.verdict.value)
                                  for r in rejected),
        "preemptions": ctrl.preemptions, "resumes": ctrl.resumes,
        "verdicts": dict(ctrl.verdicts),
        "arena_parks": sum(a.parks for a in arenas),
        "parked_blocks": sum(a.parked_blocks for a in arenas),
        "live_slots": sum(a.live for a in arenas),
        "tokens": {(r.rid, r.sample): tuple(int(x) for x in r.tokens)
                   for r in results},
        "finished_s": {(r.rid, r.sample): r.finished_s for r in results},
    }


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


# CUDA runtime calls in which the host waits for the device: the
# read-backs of sampled tokens and the explicit synchronizes
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync", "cudaMemcpy")


def window(step, steps: int, label: str, top: int) -> dict:
    """Profiles ``steps`` calls of ``step()`` and prints the window's
    wall, device time, idle share, kernels per step, the host's time in
    ``SYNC_CALLS`` per step (with their count), and its ``top`` kernels by
    device time.  Returns the per-step figures."""
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
    syncs = [e for e in prof.key_averages() if e.key in SYNC_CALLS]
    sync_ms = sum(e.self_cpu_time_total for e in syncs) / 1e3 / steps
    n_sync = sum(e.count for e in syncs) / steps
    print(f"{label}: {steps} steps, wall {wall_ms:.3f} ms/step, device "
          f"{dev_ms:.3f} ms/step, idle share "
          f"{1 - dev_ms / wall_ms:.3f}, {launches:.0f} kernels/step, host "
          f"blocked in {n_sync:.1f} sync calls/step for {sync_ms:.3f} "
          f"ms/step")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:7.1f}/step  {e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "idle_share": 1 - dev_ms / wall_ms, "kernels": launches,
            "sync_ms": sync_ms, "sync_calls": n_sync}


def profile_train(train_argv, top: int) -> int:
    """Profiles the second step of ``launch.train.train_steps`` run with
    ``train_argv`` (two steps; the first warms up)."""
    from repro_torch.launch import train
    steps = train.train_steps([*train_argv, "--steps", "2", "--log-every",
                               "1"])
    next(steps)
    window(lambda: next(steps), 1, "training step", top)
    steps.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="minicpm-2b")
    ap.add_argument("--kv-dtype", choices=("auto", "int8", "bf16"),
                    default="auto",
                    help="paged-KV precision: 'auto' = the plan's category "
                         "choice (int8 for minicpm-2b, whisper-large-v3 and "
                         "zamba2-7b, bf16 for mixtral-8x7b)")
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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter of the stochastic sampler (0 = off)")
    ap.add_argument("--draft-arch", default="",
                    help="draft model for speculative decoding (full "
                         "config; the profiled arch itself = a self-draft)")
    ap.add_argument("--speculate", type=int, default=-1,
                    help="draft depth k (-1 = the plan's category default)")
    ap.add_argument("--train", nargs=argparse.REMAINDER, default=None,
                    help="profile the second step of the training "
                         "launcher run with the flags that follow")
    args = ap.parse_args(argv)
    if args.train is not None:
        return profile_train(args.train, args.top)
    kv_dtype = -1 if args.kv_dtype == "auto" else args.kv_dtype
    sampler = SamplerConfig(args.temperature, args.top_k)
    if args.templated:
        _, rt, donors, others = templated_wave(kv_dtype, args.prefix_cache)
        serve_donors(rt, donors)
        for req in others:
            rt.submit(req)
        label, n = "templated", len(donors) + len(others)
    else:
        kw = dict(bs=128, paged_native=False) if args.dense_view else {}
        if args.draft_arch:
            kw.update(draft_spec(args.arch, args.draft_arch),
                      speculate=None if args.speculate < 0
                      else args.speculate)
        _, rt = wave_runtime(kv_dtype, args.requests, args.max_new_tokens,
                             arch=args.arch, prefix_cache=args.prefix_cache,
                             sampler=sampler, **kw)
        label = "dense-view" if args.dense_view else "native"
        n = args.requests
    # max_wait_s=0: the MF composer flushes partial frame groups at once,
    # as drain() does
    rt.step(max_wait_s=0.0)                     # first admission + warm-up
    print(f"{rt.cfg.name}, {rt.kv_dtype} KV, {rt.cfg.num_layers} layers, "
          f"{label} step, {n} requests, prefix cache "
          f"{'on' if rt.prefix_cache_enabled else 'off'}, "
          f"{rt.plan.max_in_flight} slots, sampler {rt.sampler}, "
          f"speculate k={rt.speculate_k} (draft "
          f"{args.draft_arch or 'none'}), {torch.cuda.get_device_name(0)}")
    step = lambda: rt.step(max_wait_s=0.0)
    window(step, args.steps, "prefill+decode window", args.top)
    # past every prefill, and every speculating slot's draft caught up
    while any(s.prefilling or (s.spec and s.draft_len < rt._spec_goal(s))
              for g in rt.groups.values() for s in g.slots):
        step()
    v0, a0 = rt.verify_launches, rt.accepted_tokens
    window(step, args.steps, "speculation window" if rt.speculate_k
           else "decode-only window", args.top)
    if rt.speculate_k:
        v = rt.verify_launches - v0
        print(f"speculation window: {v} verify launches, "
              f"{(rt.accepted_tokens - a0) / max(v, 1):.2f} tokens "
              f"accepted a launch")
    rt.drain()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
