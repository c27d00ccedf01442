"""Quickstart through the PyTorch/CUDA port: the EPARA pipeline end to end
in one file, as ``examples/quickstart.py`` runs it on the JAX package.

1. Describe two edge AI services (a chat LLM, a video segmenter).
2. The task-categorized allocator picks (MP, BS, MT, MF, DP) per service.
3. SSSP places services on a 3-server edge cloud.
4. The distributed handler routes requests using ring-synced (stale) state.
5. A reduced model (``reduced(minicpm-2b)``) serves the routed requests
   on the card through ``repro_torch``'s kernels (``--device cpu``: their
   plain versions on the CPU).  On the card its head dim rises from 32 to
   64, the narrowest width of the attention kernels (``ops.card_config``).

The port compiles nothing, so where the JAX example prints each runtime's
decode compiles, this one prints the kernel launches of the run
(``ops.launch_counts()``).  ``serve_requests`` takes the weights
(default: ``model_api(cfg).init(0, cfg, device)``), so that a test can
pass in the JAX example's own, carried across by
``repro_torch.bridge.params_from_jax``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core import (EdgeCloudControlPlane, Outcome, Request,
                              ServerSpec, ServiceSpec, Sensitivity)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.registry import model_api
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime


def control_plane():
    """Steps 1-4: the two services, their plans, their placements and
    three rounds of ring sync.  Returns (control plane, services,
    placements)."""
    services = {
        "llm-chat": ServiceSpec(
            "llm-chat", flops_per_request=2 * 2.7e9 * 256,
            weights_bytes=5.4e9, vram_bytes=8e9, slo_latency_s=2.0),
        "video-seg": ServiceSpec(
            "video-seg", flops_per_request=380e9, weights_bytes=1.3e8,
            vram_bytes=2e9, sensitivity=Sensitivity.FREQUENCY,
            slo_fps=60.0, slo_latency_s=0.2),
    }
    servers = [ServerSpec(sid=i, num_gpus=2) for i in range(3)]
    cp = EdgeCloudControlPlane(servers, services)
    print("== task-categorized plans (Fig. 5 operators) ==")
    for name, plan in cp.plans.items():
        print(f"  {name:10s} -> {plan.category}  "
              f"MP={plan.mp} BS={plan.bs} MT={plan.mt} "
              f"MF={plan.mf} DP={plan.dp}")
    demand = {(s, n): 20.0 for s in services for n in range(3)}
    placements = cp.run_placement(demand)
    print(f"== SSSP placements == {placements}")
    cp.publish_all(0.0)
    for _ in range(3):
        cp.sync_step(0.0)
    return cp, services, placements


def serve_requests(cp, services, placements, device, params=None):
    """Step 5: one ``ServiceRuntime`` per placed (service, server) over
    ``reduced(minicpm-2b)`` with ``params`` (default: seed 0's random
    weights on ``device``), six requests routed by the handler and each
    drained to its end.  Returns {rid: tokens}."""
    cfg = ops.card_config(reduced(get_config("minicpm-2b")), device)
    if params is None:
        params = model_api(cfg).init(0, cfg, device)
    runtimes = {}
    for svc, sid in placements:
        if sid >= 0:
            runtimes.setdefault(sid, {})[svc] = ServiceRuntime(
                cfg, params, cp.plans[svc], device=device)

    before = ops.launch_counts()
    rng = np.random.default_rng(0)
    tokens = {}
    print("== serving (continuous batching over the paged KV arena) ==")
    for i in range(6):
        svc = list(services)[i % 2]
        req = Request(rid=i, service=svc, arrival_s=0.0, deadline_s=10.0)
        at = i % 3
        d = cp.handle(req, now=0.0, at_server=at)
        target = d.destination if d.outcome == Outcome.OFFLOAD else at
        if target not in runtimes or svc not in runtimes[target]:
            target = next(s for s, m in runtimes.items() if svc in m)
        rt = runtimes[target][svc]
        rt.submit(GenerationRequest(
            rid=i, tokens=rng.integers(0, cfg.vocab_size, 6,
                                       dtype=np.int32).astype(np.int32),
            max_new_tokens=4))
        # each step() = evict / admit / one fused decode step; drain runs
        # the loop until this request's slot is evicted (frequency services
        # hold frames for MF grouping; max_wait_s=0.0 flushes for the demo)
        res = rt.drain(max_wait_s=0.0)[0]
        tokens[i] = list(res.tokens)
        print(f"  req{i} [{svc:9s}] {d.outcome.value:8s} -> server{target} "
              f"tokens={list(res.tokens)} "
              f"({res.prefill_s*1e3:.0f}ms prefill, "
              f"{res.decode_steps} decode steps)")

    # the arena data plane never copies the live batch on admission; the
    # port compiles nothing, and its kernel launches stand where the JAX
    # example counts decode compiles
    for sid, m in sorted(runtimes.items()):
        for svc, rt in m.items():
            print(f"  server{sid}/{svc}: {rt.whole_cache_copies} "
                  f"whole-cache copies, "
                  f"{rt.admission_copy_bytes // 1024} KB copied, "
                  f"{rt.chunk_write_bytes // 1024} KB chunk-written")
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                if n > before[k]}
    print(f"  kernel launches: {launches}")
    return tokens


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cp, services, placements = control_plane()
    serve_requests(cp, services, placements, device, params)
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
