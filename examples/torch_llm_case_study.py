"""Paper §4.3 case study, "LLMs from chats to robots", through the
PyTorch/CUDA port (``examples/llm_case_study.py`` on the JAX package).

The same LLM is latency-sensitive as a chat service and
frequency-sensitive as an HCI (virtual-assistant / robot) service;
EPARA's adaptive deployment (§4.1) derives different operator mixes for
each, then a reduced model (``reduced(codeqwen1.5-7b)``) serves the HCI
pattern live on the card (``--device cpu``: the kernels' plain versions
on the CPU): DP round-robin across replica groups with instant switching
to the latest decode output.  On the card the reduced model's head dim
rises from 32 to 64, the narrowest width of the attention kernels
(``ops.card_config``).

The port compiles nothing, so where the JAX example prints how often the
fused decode was compiled, this one prints the kernel launches of the
live demo (``ops.launch_counts()``).  ``hci_demo`` takes the weights
(default: ``model_api(cfg).init(0, cfg, device)``), so that a test can
pass in the JAX example's own, carried across by
``repro_torch.bridge.params_from_jax``.

  PYTHONPATH=src python examples/torch_llm_case_study.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.allocator import DPGroupRouter, allocate
from repro_torch.core.categories import EDGE_P100, Sensitivity, ServiceSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.registry import model_api
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

MODELS = {  # name: (params B, active B)
    "qwen2.5-1.5b": (1.5, 1.5),
    "llama3-8b": (8.0, 8.0),
    "deepseekv2-16b": (16.0, 2.4),
    "qwen2.5-32b": (32.0, 32.0),
}


def adaptive_deployment():
    """The §4.3 table: each model's chat and HCI services and their
    plans."""
    print("== §4.3 adaptive deployment (paper Fig. 8 analogue) ==")
    for name, (size, active) in MODELS.items():
        for mode, freq in (("chat", False), ("hci", True)):
            toks = 16 if freq else 256
            svc = ServiceSpec(
                name=f"{name}-{mode}",
                flops_per_request=2 * active * 1e9 * toks,
                weights_bytes=size * 2e9, vram_bytes=size * 3.2e9,
                sensitivity=Sensitivity.FREQUENCY if freq
                else Sensitivity.LATENCY,
                slo_latency_s=0.5 if freq else 2.0,
                slo_fps=24.0 if freq else 0.0)
            plan = allocate(svc, EDGE_P100)
            print(f"  {svc.name:22s} {str(plan.category):20s} "
                  f"TP{plan.mp} BS{plan.bs} MT{plan.mt} "
                  f"MF{plan.mf} DP{plan.dp}")


def hci_demo(device, params=None):
    """The live HCI pattern: interaction interruptions switch to the
    newest decode stream, DP groups serve alternating interactions.
    Returns {interaction: tokens}."""
    print("\n== live HCI interruption demo (reduced model) ==")
    cfg = ops.card_config(reduced(get_config("codeqwen1.5-7b")), device)
    if params is None:
        params = model_api(cfg).init(0, cfg, device)
    hci_svc = ServiceSpec(
        name="hci", flops_per_request=1e9, weights_bytes=1e8,
        vram_bytes=2e8, sensitivity=Sensitivity.FREQUENCY, slo_fps=24.0,
        slo_latency_s=0.5)
    plan = allocate(hci_svc, EDGE_P100)
    rt = ServiceRuntime(cfg, params, plan, device=device)
    router = DPGroupRouter(plan)
    rng = np.random.default_rng(0)
    before = ops.launch_counts()
    tokens = {}
    for interaction in range(3):
        group = router.route(session=interaction)
        rt.submit(GenerationRequest(
            rid=interaction,
            tokens=rng.integers(0, cfg.vocab_size, 5,
                                dtype=np.int64).astype(np.int32),
            max_new_tokens=4, stream=interaction))
        out = rt.drain(max_wait_s=0.0)[0]   # slot loop: step until evicted
        arena = rt.groups[out.group].arena
        tokens[interaction] = list(out.tokens)
        print(f"  interaction {interaction}: DP group {group}, "
              f"decode {list(out.tokens)} "
              f"({out.decode_s*1e3:.0f}ms decode, "
              f"{out.decode_steps} steps, arena "
              f"{arena.live}/{arena.capacity} slots after evict)")
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                if n > before[k]}
    print(f"  {rt.decode_steps} fused decode steps across all "
          f"interactions (paged arena: one static shape); kernel "
          f"launches: {launches}")
    return tokens


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    adaptive_deployment()
    hci_demo(device, params)
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
