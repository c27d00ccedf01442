"""Wrapper of the dense decode-attention CUDA kernel
(``csrc/decode_attention.cu``).

``decode_attention`` checks device, dtype, shape and layout, allocates its
output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
``launches["decode_attention"]``.  It takes CUDA tensors only: the CPU path
is ``ops``' dispatch to the plain version in ``ref``.

Layouts are the reference package's: q (B, Hq, D) bf16 contiguous; the
caches (B, S, Hkv, D) bf16, read in place with their batch, sequence and
head strides (the last axis dense); ``cache_len`` (B,) int32.  Head dim one
of ``HEAD_DIMS``, Hq a multiple of Hkv, at most ``MAX_GROUP`` query heads
per kv head (8 at D = 256).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build

KERNELS = ("decode_attention",)
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16

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
        fn = build.library("decode_attention").decode_attention_dense
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_LL] * 6 + [_I, _F, _P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None, softmax_scale=None):
    """Returns (B, Hq, D) bf16: each slot's new token against the first
    ``cache_len[b]`` keys of its cache (the last ``window`` of them when a
    window is set).  Replaces ``decode_attention_pallas``."""
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_len", cache_len)):
        _require(t.device.type == "cuda",
                 f"{name} must be a CUDA tensor, got {t.device}")
        _require(t.device == dev, f"{name} is on {t.device}, q on {dev}")
    _require(q.dtype == torch.bfloat16 and q.ndim == 3 and q.is_contiguous(),
             f"q must be contiguous bf16 (B, Hq, D), got {q.dtype} "
             f"{tuple(q.shape)}")
    B, Hq, D = q.shape
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
    max_group = MAX_GROUP if D <= 128 else MAX_GROUP // 2
    _require(Hq // Hkv <= max_group,
             f"query group {Hq // Hkv} exceeds {max_group} at D = {D}")
    _require(cache_len.dtype == torch.int32 and cache_len.shape == (B,)
             and cache_len.is_contiguous(),
             f"cache_len must be contiguous int32 (B,), got "
             f"{cache_len.dtype} {tuple(cache_len.shape)}")
    _require(window is None or window >= 0,
             f"window must be None or >= 0, got {window}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = float(softmax_scale if softmax_scale is not None else D ** -0.5)
    args = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            -1 if window is None else int(window), scale]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    launches["decode_attention"] += 1
    return out
