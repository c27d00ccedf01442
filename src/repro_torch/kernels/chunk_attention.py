"""Wrapper of the dense chunked-prefill attention CUDA kernel
(``csrc/chunk_attention.cu``).

``chunk_prefill_attention`` checks device, dtype, shape and layout,
allocates its output with ``torch.empty``, launches on the current stream
without synchronising, raises if the launch reports a CUDA error, and adds
one to ``launches["chunk_prefill_attention"]``.  It takes CUDA tensors
only: the CPU path is ``ops``' dispatch to the plain version in ``ref``.

Layouts are the reference package's: q (B, T, Hq, D) bf16 contiguous; the
caches (B, S, Hkv, D) bf16, read in place with their batch, sequence and
head strides (the last axis dense, the others multiples of 8 elements);
``start`` and ``chunk_len`` (B,) int32.  Head dim one of ``HEAD_DIMS``, Hq
a multiple of Hkv.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build

KERNELS = ("chunk_prefill_attention",)
HEAD_DIMS = (64, 128)

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_fn = None


def _entry():
    """The C entry point, resolved once with its argtypes set (the library
    is built on the first call)."""
    global _fn
    if _fn is None:
        fn = build.library("chunk_attention").chunk_attention_bf16
        fn.argtypes = [_P] * 6 + [_I] * 6 + [_LL] * 6 + [_I, _F, _P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def chunk_prefill_attention(q, k_cache, v_cache, start, chunk_len, *,
                            prefix_len: int = 0, softmax_scale=None):
    """Returns (B, T, Hq, D) bf16: row i of slot b, at position
    ``start[b] + i``, against the keys it sees in its cache; rows at or
    past ``chunk_len[b]`` are zeros.  Replaces
    ``chunk_prefill_attention_pallas``."""
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("start", start), ("chunk_len", chunk_len)):
        _require(t.device.type == "cuda",
                 f"{name} must be a CUDA tensor, got {t.device}")
        _require(t.device == dev, f"{name} is on {t.device}, q on {dev}")
    _require(q.dtype == torch.bfloat16 and q.ndim == 4 and q.is_contiguous()
             and q.data_ptr() % 16 == 0,
             f"q must be contiguous 16-byte aligned bf16 (B, T, Hq, D), got "
             f"{q.dtype} {tuple(q.shape)}")
    B, T, Hq, D = q.shape
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _require(t.dtype == torch.bfloat16 and t.ndim == 4
                 and t.shape[0] == B and t.shape[3] == D,
                 f"{name} must be bf16 ({B}, S, Hkv, {D}), got {t.dtype} "
                 f"{tuple(t.shape)}")
        _require(t.stride(3) == 1 and t.data_ptr() % 16 == 0
                 and all(t.stride(i) % 8 == 0 for i in range(3)),
                 f"{name} must have a dense head dim, 16-byte alignment and "
                 f"strides that are multiples of 8")
    _require(tuple(k_cache.shape) == tuple(v_cache.shape),
             f"caches must match, got {tuple(k_cache.shape)} and "
             f"{tuple(v_cache.shape)}")
    _, S, Hkv, _ = k_cache.shape
    _require(D in HEAD_DIMS, f"head dim must be one of {HEAD_DIMS}, got {D}")
    _require(Hkv >= 1 and Hq % Hkv == 0,
             f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    for name, t in (("start", start), ("chunk_len", chunk_len)):
        _require(t.dtype == torch.int32 and t.shape == (B,)
                 and t.is_contiguous(),
                 f"{name} must be contiguous int32 (B,), got {t.dtype} "
                 f"{tuple(t.shape)}")
    _require(prefix_len >= 0, f"prefix_len must be >= 0, got {prefix_len}")
    out = torch.empty_like(q)
    if B == 0 or T == 0 or S == 0:
        return out.zero_()
    scale = float(softmax_scale if softmax_scale is not None else D ** -0.5)
    args = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            start.data_ptr(), chunk_len.data_ptr(), out.data_ptr(), B, T,
            Hq, Hkv, D, S, *k_cache.stride()[:3], *v_cache.stride()[:3],
            int(prefix_len), scale]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"chunk_prefill_attention: kernel launch failed "
                           f"with CUDA error {rc}")
    launches["chunk_prefill_attention"] += 1
    return out
