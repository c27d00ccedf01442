"""End-to-end serving driver through the PyTorch/CUDA port
(``examples/serve_cluster.py`` on the JAX package): deploy reduced
variants of THREE architectures (dense + SSM + VLM) across a simulated
edge cloud and serve a batched request stream through the full EPARA
control plane (allocator, SSSP placement, ring sync and per-request
handler decisions, with MF batch composition for the frequency service
and sticky DP routing for the stateful SSM), the models on the card
(``--device cpu``: the kernels' plain versions on the CPU).  On the card
the reduced models' head dim rises from 32 to 64, the narrowest width of
the attention kernels (``ops.card_config``).

Every service's weights are random from a seed of its own, the CRC-32 of
its name (the JAX example seeds from Python's ``hash``, which changes
from process to process), or the trees passed to ``main(params=...)``.
The port compiles nothing, so where the JAX example counts decode
compiles, this one prints the kernel launches of the run
(``ops.launch_counts()``).

  PYTHONPATH=src python examples/torch_serve_cluster.py [--requests 24] \
      [--chaos] [--device cpu]
"""
import argparse
import time
import zlib

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core import (EdgeCloudControlPlane, ServerSpec, ServiceSpec,
                              Sensitivity)
from repro_torch.core.faults import FaultEvent, FaultInjector, FaultSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.registry import model_api
from repro_torch.serving.engine import (EparaServingEngine, GenerationRequest,
                                        ServiceRuntime)
from repro_torch.serving.failover import ClusterSupervisor, RetryPolicy

ARCHS = ["codeqwen1.5-7b", "mamba2-2.7b", "paligemma-3b"]


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=18)
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("--chaos", action="store_true",
                    help="crash one server mid-burst (then restart it): "
                         "its queued/in-flight/parked requests evacuate "
                         "to survivors and every rid must still end "
                         "served-or-verdicted")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace JSON of request lifecycles "
                         "and engine phases (Perfetto-loadable)")
    ap.add_argument("--metrics-out", default="",
                    help="write Prometheus text exposition (or a JSONL "
                         "snapshot when the path ends in .jsonl)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    return ap


def main(argv=None, *, params=None):
    """Serves the stream; ``params`` maps an arch to its weights (default:
    each arch's random weights from the CRC-32 of its name).  Returns
    0 when every rid is accounted for."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    params = dict(params or {})

    tracer = metrics = None
    if args.trace_out:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    if args.metrics_out:
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()

    specs, cfgs = {}, {}
    for a in ARCHS:
        full = get_config(a)
        freq = full.epara_sensitivity == "frequency"
        specs[a] = ServiceSpec(
            name=a, flops_per_request=2 * full.active_param_count() * 64,
            weights_bytes=full.param_count() * 2.0,
            vram_bytes=full.param_count() * 3.0,
            sensitivity=Sensitivity.FREQUENCY if freq
            else Sensitivity.LATENCY,
            slo_latency_s=2.0, slo_fps=20.0 if freq else 0.0,
            stateful=full.family in ("ssm", "hybrid"))
        cfgs[a] = ops.card_config(reduced(full), device)

    servers = [ServerSpec(sid=i, num_gpus=4) for i in range(args.servers)]
    cp = EdgeCloudControlPlane(servers, specs)
    placements = cp.run_placement(
        {(a, s.sid): 5.0 for a in ARCHS for s in servers})
    print("plans:")
    for a, plan in cp.plans.items():
        print(f"  {a:18s} {plan.category} mp={plan.mp} bs={plan.bs} "
              f"mt={plan.mt} mf={plan.mf} dp={plan.dp} "
              f"sticky={plan.sticky}")
    print("placements:", placements)

    engines = {s.sid: EparaServingEngine() for s in servers}
    rng = np.random.default_rng(0)
    for svc, sid in placements:
        if sid < 0:
            continue
        cfg = cfgs[svc]
        if svc not in params:
            params[svc] = model_api(cfg).init(zlib.crc32(svc.encode()), cfg,
                                              device)
        engines[sid].deploy(svc, ServiceRuntime(cfg, params[svc],
                                                cp.plans[svc],
                                                device=device,
                                                tracer=tracer,
                                                metrics=metrics))

    cp.publish_all(0.0)
    for _ in range(args.servers):
        cp.sync_step(0.0)

    before = ops.launch_counts()
    t0 = time.time()
    injector = None
    if args.chaos:
        # deterministic mid-burst crash of one service host, restarted a
        # few rounds later (rejoins via repair + re-publish); the first
        # logical round is t=1.0, so at_s=2.0 lands while requests are
        # still queued or decoding
        victim = next(sid for sid, e in engines.items() if e.runtimes)
        injector = FaultInjector(FaultSpec(events=(
            FaultEvent(at_s=2.0, kind="crash", sid=victim),
            FaultEvent(at_s=6.0, kind="restart", sid=victim))))
        print(f"chaos: crash server {victim} at t=2, restart at t=6")
    supervisor = ClusterSupervisor(cp, engines,
                                   retry=RetryPolicy(base_timeout_s=4.0),
                                   injector=injector, metrics=metrics,
                                   tracer=tracer)
    for i in range(args.requests):
        svc = ARCHS[i % len(ARCHS)]
        cfg = cfgs[svc]
        at = int(rng.integers(0, args.servers))
        extras = None
        if cfg.family == "vlm":
            extras = {"embeddings": np.zeros((cfg.prefix_len, cfg.d_model),
                                             np.float32)}
        supervisor.submit(svc, GenerationRequest(
            rid=i, tokens=rng.integers(0, cfg.vocab_size, 8,
                                       dtype=np.int64).astype(np.int32),
            max_new_tokens=6, stream=i % 4, extras=extras),
            at_server=at, now=0.0)
    # the supervisor steps every runtime until each rid is served or
    # verdicted, feeding queue-time estimates back to the handler state
    # and recovering from any injected faults along the way
    report = supervisor.run_until_idle()
    results = report.results
    outcomes = report.outcomes
    dt = time.time() - t0
    runtimes = [rt for eng in engines.values()
                for rt in eng.runtimes.values()]
    toks = sum(len(r.tokens) for r in results)
    steps = sum(rt.decode_steps for rt in runtimes)
    copies = sum(rt.whole_cache_copies for rt in runtimes)
    chunks = sum(rt.prefill_chunk_calls for rt in runtimes)
    print(f"\nserved {len(results)}/{args.requests} requests "
          f"({toks} tokens, {steps} fused decode steps, {chunks} prefill "
          f"chunks) in {dt:.1f}s — handler outcomes: {outcomes}")
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                if n > before[k]}
    print(f"paged arena: {len(runtimes)} deployed runtimes, {copies} "
          f"whole-cache admission copies; kernel launches: {launches}")
    if args.chaos:
        print(f"chaos: {report.evacuated} evacuated, {report.failovers} "
              f"failovers, {report.duplicates} duplicates deduplicated, "
              f"{len(report.rejects)} verdicted, "
              f"accounted {report.accounted}/{args.requests}")
    if tracer is not None:
        tracer.export(args.trace_out)
        print(f"trace: {tracer.emitted} events -> {args.trace_out}")
    if metrics is not None:
        if args.metrics_out.endswith(".jsonl"):
            metrics.append_jsonl(args.metrics_out)
        else:
            metrics.write_prometheus(args.metrics_out)
        print(f"metrics -> {args.metrics_out}")
    # served-or-verdicted: every rid is accounted for even when a server
    # crashed mid-burst (chaos mode); without faults nothing may be
    # verdicted at all
    assert report.accounted == args.requests, \
        (report.accounted, args.requests)
    if not args.chaos:
        assert len({r.rid for r in results}) == args.requests
    assert copies == 0          # arena admissions never copy the live batch
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
