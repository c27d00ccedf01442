"""The kernels as the models call them, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel (``paged_attention``,
``flash_attention``, ``flash_attention_bwd``, ``decode_attention``,
``chunk_attention``, ``ssd_scan``, ``grouped_matmul``), a CPU tensor to its
plain version
(``ref``).  There is no other switch and no fallback: on the card a kernel
launches or raises.
``QuantPages`` pools select the int8 attention kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import chunk_attention as ca
from . import decode_attention as da
from . import flash_attention as fa
from . import flash_attention_bwd as fab
from . import grouped_matmul as gmm
from . import paged_attention as pa
from . import ref
from . import ssd_scan as ssd
from .quant import QuantPages

_KERNEL_MODULES = (pa, fa, fab, da, ca, ssd, gmm)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches so far, by name."""
    return {name: n for mod in _KERNEL_MODULES
            for name, n in mod.launches.items()}


def reset_launches() -> None:
    for mod in _KERNEL_MODULES:
        mod.reset_launches()


def _flash_fwd(q, k, v, kw):
    if q.device.type != "cuda":
        return ref.flash_attention_ref(q, k, v, **kw)
    return fa.flash_attention(q, k, v, **kw)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` around its flash kernels: the forward
    kernel (or plain version) saves (q, k, v, out, lse), and the backward
    recomputes P from them in the backward kernel (or plain version).
    Autograd records none of the forward's own ops."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = _flash_fwd(q, k, v, kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type != "cuda":
            grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                **ctx.kw)
        else:
            grads = fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                            **ctx.kw)
        return (*grads, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, prefix_len: int = 0,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    softmax_scale=None):
    """Full (training, prefill, encoder or cross) attention: q
    (B, Lq, Hq, D) against k, v (B, Lk, Hkv, D) with the reference flash
    kernel's masks (see ``ref.flash_attention_ref``).  Returns
    (B, Lq, Hq, D).  Where autograd records a graph it goes through
    ``_FlashAttention``, whose backward is the flash backward; otherwise
    it is the forward alone."""
    kw = dict(causal=causal, window=window, prefix_len=prefix_len,
              q_offset=q_offset, kv_len=kv_len, softmax_scale=softmax_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kw)
    return _flash_fwd(q, k, v, kw)[0]


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None, softmax_scale=None):
    """Single-token decode against dense (B, S, Hkv, D) caches: q
    (B, Hq, D) attends to the first ``cache_len[b]`` keys of its slot (the
    last ``window`` of them when set); ``cache_len`` is a scalar or (B,).
    A slot of length 0 gets zeros.  Returns (B, Hq, D)."""
    if q.device.type != "cuda":
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                        window=window,
                                        softmax_scale=softmax_scale)
    return da.decode_attention(q, k_cache, v_cache,
                               ref.per_slot(cache_len, q.shape[0], q.device),
                               window=window, softmax_scale=softmax_scale)


def chunk_attention(q, k_cache, v_cache, start, chunk_len, *,
                    prefix_len: int = 0, softmax_scale=None):
    """Chunked-prefill attention against dense (B, S, Hkv, D) caches that
    already hold the chunk's own K/V: row i of q (B, T, Hq, D) sits at
    position ``start[b] + i`` and is real iff ``i < chunk_len[b]``
    (``start``/``chunk_len`` scalars or (B,)).  Returns (B, T, Hq, D),
    zeros in the rows past ``chunk_len``."""
    if q.device.type != "cuda":
        return ref.chunk_attention_ref(q, k_cache, v_cache, start, chunk_len,
                                       prefix_len=prefix_len,
                                       softmax_scale=softmax_scale)
    B = q.shape[0]
    return ca.chunk_prefill_attention(
        q, k_cache, v_cache, ref.per_slot(start, B, q.device),
        ref.per_slot(chunk_len, B, q.device), prefix_len=prefix_len,
        softmax_scale=softmax_scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, cache_len, *,
                           softmax_scale=None):
    """One-token decode against one layer's page pools (P, bs, Hkv, D)
    read through ``block_tables`` (B, nblk): q (B, Hq, D) attends to the
    first ``cache_len[b]`` tokens of its slot.  Returns (B, Hq, D)."""
    if q.device.type != "cuda":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, cache_len,
            softmax_scale=softmax_scale)
    lens = ref.per_slot(cache_len, q.shape[0], q.device)
    if isinstance(k_pages, QuantPages):
        return pa.paged_decode_attention_quant(
            q, k_pages.values, v_pages.values, k_pages.scales,
            v_pages.scales, block_tables, lens, softmax_scale=softmax_scale)
    return pa.paged_decode_attention(q, k_pages, v_pages, block_tables, lens,
                                     softmax_scale=softmax_scale)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, start,
                          chunk_len, *, prefix_len: int = 0,
                          softmax_scale=None):
    """Chunked-prefill attention against one layer's page pools, which
    already hold the chunk's own K/V: row i of q (B, T, Hq, D) sits at
    position ``start[b] + i`` and is real iff ``i < chunk_len[b]``.
    Returns (B, T, Hq, D), zeros in the rows past ``chunk_len``."""
    if q.device.type != "cuda":
        return ref.paged_chunk_attention_ref(
            q, k_pages, v_pages, block_tables, start, chunk_len,
            prefix_len=prefix_len, softmax_scale=softmax_scale)
    B = q.shape[0]
    start = ref.per_slot(start, B, q.device)
    chunk_len = ref.per_slot(chunk_len, B, q.device)
    if isinstance(k_pages, QuantPages):
        return pa.paged_chunk_prefill_attention_quant(
            q, k_pages.values, v_pages.values, k_pages.scales,
            v_pages.scales, block_tables, start, chunk_len,
            prefix_len=prefix_len, softmax_scale=softmax_scale)
    return pa.paged_chunk_prefill_attention(
        q, k_pages, v_pages, block_tables, start, chunk_len,
        prefix_len=prefix_len, softmax_scale=softmax_scale)


def paged_verify_attention(q, k_pages, v_pages, block_tables, start,
                           chunk_len, *, prefix_len: int = 0,
                           softmax_scale=None):
    """Speculative-decoding k-token verify: the same kernels as
    ``paged_chunk_attention``, with ``chunk_len`` a per-slot (B,) vector
    that is T for slots speculating this round and 0 for every other row.
    A zero-length row sees no key, so its output is zeros (the verifier
    masks it) and its K/V writes were routed to the trash page upstream."""
    chunk_len = torch.as_tensor(chunk_len, dtype=torch.int32,
                                device=q.device)
    if chunk_len.ndim != 1:
        raise ValueError(
            f"paged_verify_attention requires a per-slot (B,) chunk_len "
            f"vector (0 = row not speculating), got shape "
            f"{tuple(chunk_len.shape)}")
    return paged_chunk_attention(q, k_pages, v_pages, block_tables, start,
                                 chunk_len, prefix_len=prefix_len,
                                 softmax_scale=softmax_scale)


def ssd_scan(x, dt, A, B, C, D=None, *, chunk: int = 128,
             initial_state=None):
    """Mamba-2 SSD chunked scan: x (Bb, L, H, P); dt (Bb, L, H) f32; A (H,)
    f32; B, C (Bb, L, G, N); D (H,) f32 or None; initial_state
    (Bb, H, P, N) f32 or None.  Returns (y (Bb, L, H, P), final state
    (Bb, H, P, N) f32)."""
    if x.device.type != "cuda":
        return ref.ssd_chunked_ref(x, dt, A, B, C, D, chunk=chunk,
                                   initial_state=initial_state)
    return ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                        initial_state=initial_state)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D=None):
    """One recurrent SSD step, updating the f32 ``state`` in place.  It is
    elementwise-dominated, and the reference has no kernel for it either:
    plain PyTorch on every device.  Returns (y_t, state)."""
    return ref.ssd_decode_step_ref(state, x_t, dt_t, A, B_t, C_t, D)


def grouped_matmul(lhs, rhs):
    """The expert FFN's grouped GEMM after capacity dispatch: lhs
    (E, C, K) @ rhs (E, K, N) -> (E, C, N) in lhs's dtype, summed in f32."""
    if lhs.device.type != "cuda":
        return ref.grouped_matmul_ref(lhs, rhs)
    return gmm.grouped_matmul(lhs, rhs)
