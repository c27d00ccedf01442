"""Token sampling for the serving engine: the greedy path.

Greedy sampling (``temperature <= 0``) draws no random bits, which is what
makes its tokens independent of batch composition by construction.  The
reference's per-slot counter-based stochastic streams (``jax.random``
threefry keys folded from request seed, sample index, stream and offset)
are not ported yet: ``temperature > 0`` raises (``ROADMAP.md`` Queue 1
item 7).
"""
from __future__ import annotations

import dataclasses

import torch

STREAM_DECODE = 0      # the reference's tag for the decode-loop stream


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled


def _apply_mask(out, live, occupancy, fill_token):
    mask = None
    if live is not None:
        mask = live.bool()
    if occupancy is not None:
        occ = occupancy.bool()
        mask = occ if mask is None else mask & occ
    if mask is not None:
        out = torch.where(mask, out, torch.full_like(out, fill_token))
    return out, mask


def sample_per_slot(logits, seeds, sample_ids, offsets,
                    cfg: SamplerConfig = SamplerConfig(), *,
                    stream: int = STREAM_DECODE, live=None, occupancy=None,
                    fill_token: int = 0):
    """logits: (B, V) -> (B,) int32.  Rows masked by ``live`` (finished
    slots) or ``occupancy`` (empty slots of the static-capacity batch) emit
    ``fill_token``.  ``seeds``/``sample_ids``/``offsets``/``stream`` name a
    row's stochastic stream and are unused by greedy."""
    if cfg.temperature > 0.0:
        raise NotImplementedError(
            "stochastic sampling is not ported yet (ROADMAP.md Queue 1 "
            "item 7, threefry sampling); use temperature=0")
    # torch.argmax returns the first maximal index, as jnp.argmax does, so
    # ties (common in bf16 logits) resolve identically
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    out, _ = _apply_mask(out, live, occupancy, fill_token)
    return out
