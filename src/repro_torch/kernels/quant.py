"""Quantized paged-KV block format: int8 values + per-row float scales.

The serving arena's page pools are the decode hot loop's working set, and
decode is memory-bound.  ``QuantPages`` packs a KV pool as symmetric
per-token-per-head int8 with an f32 scale stored as a sibling tensor of the
same leading (pool, block, row, head) layout, so every block-index
operation the arena performs applies uniformly to values and scales, and
the paged attention kernels dequantize in registers, never materializing a
float pool.

Quantization format (the order of the reference package's
``kernels/quant.py``, reproduced bit for bit on the same f32 rows):

    scale = max(|x| over the last axis) / 127, floored at ``EPS``
    q     = clip(round_half_even(x / scale), -127, 127) as int8
    x'    = float32(q) * scale
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0
EPS = 1e-8          # zero rows quantize to zeros, never divide by zero


class QuantPages:
    """An int8 tensor plus per-row (last-axis-reduced) float32 scales.

    ``values.shape == (*lead, D)`` and ``scales.shape == (*lead,)``.
    ``shape``/``dtype``/``ndim`` proxy the value tensor, so shape-reading
    call sites treat a QuantPages like the dense pool it replaces.
    Indexing (``pool[layer]``) indexes values and scales together and
    returns views, so writes through it land in the pool.
    """
    __slots__ = ("values", "scales")

    def __init__(self, values: torch.Tensor, scales: torch.Tensor):
        self.values = values
        self.scales = scales

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def device(self):
        return self.values.device

    def __getitem__(self, idx) -> "QuantPages":
        return QuantPages(self.values[idx], self.scales[idx])

    def __repr__(self):
        return (f"QuantPages(values={tuple(self.values.shape)},"
                f" scales={tuple(self.scales.shape)})")


def quantize(x: torch.Tensor):
    """Symmetric per-row int8: (values int8, scales f32) with
    ``scales.shape == x.shape[:-1]``."""
    xf = x.to(torch.float32)
    scales = torch.clamp_min(xf.abs().amax(dim=-1) / INT8_MAX, EPS)
    # torch.round rounds half to even, like jnp.round
    q = torch.clamp(torch.round(xf / scales[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scales


def dequantize(values: torch.Tensor, scales: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize`` (up to the rounding loss)."""
    out = values.to(torch.float32) * scales[..., None].to(torch.float32)
    return out.to(dtype)


def quantize_like(x: torch.Tensor, pool):
    """Quantize rows for insertion into ``pool``: a ``QuantPages`` pool gets
    (int8 rows, f32 scales); a dense pool passes through as (rows, None)."""
    if isinstance(pool, QuantPages):
        return quantize(x)
    return x, None
