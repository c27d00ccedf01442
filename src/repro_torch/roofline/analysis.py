"""Roofline terms of a step on the H100 (the port of the reference
package's ``roofline/analysis.py``).

Three terms per (arch x shape x mesh), all in SECONDS:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / NVLINK_BW

The card's peaks are the data sheet's for one H100 SXM 80GB at its full
700 W power limit (dense rates, no sparsity).  A card set below 700 W
runs slower under load, so a share of these peaks is stated beside the
card's power limit.  ``chip_smoke.py``'s kernel bounds divide by the same
constants.  The port compiles nothing, so FLOPs and bytes come from the
ops a step dispatches (``op_cost``) and from the analytic traffic model
(``analytic``), not from a compiler's cost analysis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

CARD = "H100 SXM 80GB, 700 W, data sheet"
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes / s
NVLINK_BW = 450e9            # NVLink 4 bytes / s, one direction
HBM_BYTES = 80e9             # device memory a card


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time in ms the card could take to move ``nbytes`` and
    compute ``flops`` at bf16's peak, and which of the two bounds it."""
    t_b, t_o = nbytes / HBM_BW, flops / PEAK_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


@dataclasses.dataclass
class Roofline:
    name: str
    chips: int
    flops_per_device: float
    bytes_per_device: float          # analytic HBM traffic
    collective_wire_bytes: float     # per device
    collective_counts: Dict[str, int]
    memory_stats: Dict[str, float]
    model_flops: float = 0.0         # 6·N·D (train) or 2·N·D (inference)
    op_bytes_per_device: float = 0.0  # the dispatched ops' bytes
    #                                   (cross-check; eager ops are unfused)
    traffic_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (dispatched FLOPs x chips): <1 means recompute,
        padding or dead rows; >1 that the analytic model overcounts."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "op_bytes_per_device": self.op_bytes_per_device,
            "traffic_breakdown": self.traffic_breakdown,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_counts": self.collective_counts,
            "memory_stats": self.memory_stats,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peaks": CARD,
        }


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for inference
    (D = tokens processed; decode D = batch)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch     # decode: one token per sequence


def format_table(rows: List[Roofline]) -> str:
    hdr = (f"{'pair':42s} {'chips':>5s} {'compute_s':>10s} {'memory_s':>10s}"
           f" {'coll_s':>10s} {'dominant':>10s} {'useful':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.name:42s} {r.chips:5d} {r.compute_s:10.4g} "
            f"{r.memory_s:10.4g} {r.collective_s:10.4g} {r.dominant:>10s} "
            f"{r.useful_flops_ratio:7.3f}")
    return "\n".join(lines)
