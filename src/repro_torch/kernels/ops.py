"""The kernels as the models call them, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel (``paged_attention``,
``flash_attention``, ``flash_attention_bwd``, ``decode_attention``,
``chunk_attention``, ``ssd_scan``, ``grouped_matmul``), a CPU tensor to its
plain version
(``ref``).  There is no other switch and no fallback: on the card a kernel
launches or raises.
``QuantPages`` pools select the int8 attention kernels.

Where autograd records a graph, the flash attention, the SSD scan and the
grouped GEMM go through ``autograd.Function``s that dispatch by device
too, forward and backward: the flash backward kernel, a recompute of the
plain SSD scan, and the grouped GEMM again for dX and dW.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

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


# the observer of kernel calls, or None: ``roofline/op_cost.py`` installs
# one that counts each kernel's own work from its arguments and runs the
# call with its plain version's aten ops left out of the count
_observer: list = [None]


def _kernel(name: str) -> Callable:
    """Mark a dispatch function as kernel ``name`` for the observer."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            obs = _observer[0]
            if obs is None:
                return fn(*args, **kw)
            return obs(name, fn, args, kw)
        return call
    return wrap


@_kernel("flash_attention")
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
        return (*_flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.kw),
                None)


@_kernel("flash_attention_bwd")
def _flash_bwd(q, k, v, out, lse, dout, kw):
    if q.device.type != "cuda":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    return fab.flash_attention_bwd(q, k, v, out, lse, dout, **kw)


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


@_kernel("decode_attention")
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


@_kernel("chunk_prefill_attention")
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


@_kernel("paged_decode_attention")
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


@_kernel("paged_chunk_prefill_attention")
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


@_kernel("ssd_scan")
def _ssd_fwd(x, dt, A, B, C, D, chunk, initial_state):
    if x.device.type != "cuda":
        return ref.ssd_chunked_ref(x, dt, A, B, C, D, chunk=chunk,
                                   initial_state=initial_state)
    return ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                        initial_state=initial_state)


class _SsdScan(torch.autograd.Function):
    """Autograd around the SSD scan.  The forward is the kernel (or plain
    version) and saves (x, dt, A, B, C, D).  The backward recomputes the
    plain chunked scan (``ref.ssd_chunked_ref``) from them under autograd
    and differentiates it against dy: there is no reference VJP or
    backward kernel (``jax.grad`` cannot differentiate the reference's
    Pallas scan; under ``impl="ref"`` it is autodiff of the same plain
    scan).  Training never takes the gradient of the final state or of
    ``initial_state``; asking for either raises."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, initial_state, chunk):
        ctx.set_materialize_grads(False)
        y, state = _ssd_fwd(x, dt, A, B, C, D, chunk, initial_state)
        ctx.save_for_backward(x, dt, A, B, C, D, initial_state)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        if dstate is not None or ctx.needs_input_grad[6]:
            raise NotImplementedError(
                "ssd_scan: no gradient of the final state or of "
                "initial_state (training takes neither)")
        x, dt, A, B, C, D, h0 = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip((x, dt, A, B, C, D), need)]
        grads = [None] * 6
        if dy is not None and any(need):
            with torch.enable_grad():
                y, _ = ref.ssd_chunked_ref(*ins, chunk=ctx.chunk,
                                           initial_state=h0)
            got = iter(torch.autograd.grad(
                y, [t for t, n in zip(ins, need) if n], dy))
            grads = [next(got) if n else None for n in need]
        return (*grads, None, None)


def ssd_scan(x, dt, A, B, C, D=None, *, chunk: int = 128,
             initial_state=None):
    """Mamba-2 SSD chunked scan: x (Bb, L, H, P); dt (Bb, L, H) f32; A (H,)
    f32; B, C (Bb, L, G, N); D (H,) f32 or None; initial_state
    (Bb, H, P, N) f32 or None.  Returns (y (Bb, L, H, P), final state
    (Bb, H, P, N) f32).  Where autograd records a graph it goes through
    ``_SsdScan``, whose backward recomputes the plain scan; otherwise it
    is the forward alone."""
    args = (x, dt, A, B, C, D)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*args, initial_state)):
        return _SsdScan.apply(*args, initial_state, chunk)
    return _ssd_fwd(*args, chunk, initial_state)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D=None):
    """One recurrent SSD step, updating the f32 ``state`` in place.  It is
    elementwise-dominated, and the reference has no kernel for it either:
    plain PyTorch on every device.  Returns (y_t, state)."""
    return ref.ssd_decode_step_ref(state, x_t, dt_t, A, B_t, C_t, D)


@_kernel("grouped_matmul")
def _gmm_fwd(lhs, rhs):
    if lhs.device.type != "cuda":
        return ref.grouped_matmul_ref(lhs, rhs)
    return gmm.grouped_matmul(lhs, rhs)


class _GroupedMatmul(torch.autograd.Function):
    """Autograd around the grouped GEMM.  The reference has no VJP here
    (``jax.grad`` cannot differentiate its Pallas kernel; under
    ``impl="ref"`` it is autodiff of the einsum), and both gradients are
    grouped GEMMs again: dX = dY W^T and dW = X^T dY, each through the
    kernel on the card and the plain version on the CPU.  The kernel
    reads operands whose last axis is dense, so W^T and X^T are copied
    into the transposed layout: at mixtral-8x7b's (8, 4096, 14336) bf16
    expert weight that copy is 940 MB, at its training microbatch's
    (8, 1280, 4096) expert rows 84 MB."""

    @staticmethod
    def forward(ctx, lhs, rhs):
        ctx.save_for_backward(lhs, rhs)
        return _gmm_fwd(lhs, rhs)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs = ctx.saved_tensors
        dout = dout.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _gmm_fwd(dout, rhs.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            drhs = _gmm_fwd(lhs.transpose(1, 2).contiguous(), dout)
        return dlhs, drhs


def grouped_matmul(lhs, rhs):
    """The expert FFN's grouped GEMM after capacity dispatch: lhs
    (E, C, K) @ rhs (E, K, N) -> (E, C, N) in lhs's dtype, summed in f32.
    Where autograd records a graph it goes through ``_GroupedMatmul``;
    otherwise it is the forward alone."""
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _GroupedMatmul.apply(lhs, rhs)
    return _gmm_fwd(lhs, rhs)
