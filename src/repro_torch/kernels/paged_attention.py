"""Wrappers of the four paged-attention CUDA kernels (``csrc/paged_attention.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
its entry in ``launches``.  They take CUDA tensors only: the CPU path is
``ops``' dispatch to the plain versions in ``ref``.

Layouts are the reference package's: q (B, Hq, D) for decode and
(B, T, Hq, D) for a chunk, bf16; one layer's pages (P, bs, Hkv, D), bf16 or
int8 with f32 scales (P, bs, Hkv), read in place; block tables (B, nblk)
and lengths (B,) int32.  Head dim 64, 112, 128 or 256, Hq a multiple of
Hkv (at most 16 query heads a kv head in decode, 8 at D = 256 and 4 at
D = 112).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from . import build

KERNELS = ("paged_decode_attention", "paged_decode_attention_quant",
           "paged_chunk_prefill_attention",
           "paged_chunk_prefill_attention_quant")
HEAD_DIMS = (64, 112, 128, 256)
MAX_GROUP = 16          # query heads per kv head the decode kernel serves
MAX_GROUP_256 = 8       # the same at D = 256
MAX_GROUP_112 = 4       # and at D = 112

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    "paged_decode_attention_bf16": [_P] * 6 + [_I] * 6 + [_LL] * 2 + [_F, _P],
    "paged_decode_attention_int8": [_P] * 8 + [_I] * 6 + [_LL] * 4 + [_F, _P],
    "paged_chunk_attention_bf16": [_P] * 7 + [_I] * 7 + [_LL] * 2
    + [_I, _F, _P],
    "paged_chunk_attention_int8": [_P] * 9 + [_I] * 7 + [_LL] * 4
    + [_I, _F, _P],
}


_fns: Dict[str, Callable[..., int]] = {}


def _fn(symbol: str):
    """The C entry point ``symbol``, resolved once with its argtypes set
    (the library is built on the first call)."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.library("paged_attention"), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(q, k_pages, v_pages, block_tables, lens, qdims: int,
                  page_dtype) -> None:
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   block_tables=block_tables, lens=lens)
    for name, t in tensors.items():
        _require(t.device.type == "cuda",
                 f"{name} must be a CUDA tensor, got {t.device}")
        _require(t.device == q.device, f"{name} is on {t.device}, q on "
                 f"{q.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(q.dtype == torch.bfloat16, f"q must be bf16, got {q.dtype}")
    _require(q.ndim == qdims, f"q must have {qdims} dims, got {q.shape}")
    _require(k_pages.dtype == page_dtype and v_pages.dtype == page_dtype,
             f"pages must be {page_dtype}, got {k_pages.dtype}/"
             f"{v_pages.dtype}")
    _require(k_pages.ndim == 4 and k_pages.shape == v_pages.shape,
             f"pages must be matching (P, bs, Hkv, D), got {k_pages.shape} "
             f"and {v_pages.shape}")
    Hq, D = q.shape[-2], q.shape[-1]
    _, _, Hkv, Dk = k_pages.shape
    _require(D in HEAD_DIMS and Dk == D,
             f"head dim must be one of {HEAD_DIMS} in q and pages, got "
             f"{D}/{Dk}")
    _require(Hq % Hkv == 0, f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _require(block_tables.dtype == torch.int32 and block_tables.ndim == 2
             and block_tables.shape[0] == q.shape[0],
             f"block_tables must be int32 (B, nblk), got "
             f"{block_tables.dtype} {tuple(block_tables.shape)}")
    _require(lens.dtype == torch.int32 and lens.shape == (q.shape[0],),
             f"lengths must be int32 (B,), got {lens.dtype} "
             f"{tuple(lens.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _check_scales(k_pages, k_scales, v_scales) -> None:
    for name, s in (("k_scales", k_scales), ("v_scales", v_scales)):
        _require(s.device == k_pages.device and s.is_contiguous()
                 and s.dtype == torch.float32
                 and s.shape == k_pages.shape[:3],
                 f"{name} must be contiguous f32 {tuple(k_pages.shape[:3])} "
                 f"on {k_pages.device}, got {s.dtype} {tuple(s.shape)} on "
                 f"{s.device}")


def _launch(name: str, symbol: str, q, args) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn(symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    launches[name] += 1


def _scale(softmax_scale: Optional[float], D: int) -> float:
    return float(softmax_scale if softmax_scale is not None else D ** -0.5)


def _decode(name, q, k_pages, v_pages, k_scales, v_scales, block_tables,
            cache_len, softmax_scale):
    quant = k_scales is not None
    _check_common(q, k_pages, v_pages, block_tables, cache_len, 3,
                  torch.int8 if quant else torch.bfloat16)
    B, Hq, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    limit = {256: MAX_GROUP_256, 112: MAX_GROUP_112}.get(D, MAX_GROUP)
    _require(Hq // Hkv <= limit,
             f"query group {Hq // Hkv} exceeds {limit} at head dim {D}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    head = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        _check_scales(k_pages, k_scales, v_scales)
        head += [k_scales.data_ptr(), v_scales.data_ptr()]
    args = head + [block_tables.data_ptr(), cache_len.data_ptr(),
                   out.data_ptr(), B, Hq, Hkv, D, bs,
                   block_tables.shape[1], k_pages.stride(0),
                   k_pages.stride(1)]
    if quant:
        args += [k_scales.stride(0), k_scales.stride(1)]
    _launch(name, "paged_decode_attention_" + ("int8" if quant else "bf16"),
            q, args + [_scale(softmax_scale, D)])
    return out


def _chunk(name, q, k_pages, v_pages, k_scales, v_scales, block_tables,
           start, chunk_len, prefix_len, softmax_scale):
    quant = k_scales is not None
    _check_common(q, k_pages, v_pages, block_tables, start, 4,
                  torch.int8 if quant else torch.bfloat16)
    _require(chunk_len.device == q.device and chunk_len.dtype == torch.int32
             and chunk_len.shape == start.shape,
             f"chunk_len must be int32 (B,) on {q.device}")
    B, T, Hq, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    head = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()]
    if quant:
        _check_scales(k_pages, k_scales, v_scales)
        head += [k_scales.data_ptr(), v_scales.data_ptr()]
    args = head + [block_tables.data_ptr(), start.data_ptr(),
                   chunk_len.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, D,
                   bs, block_tables.shape[1], k_pages.stride(0),
                   k_pages.stride(1)]
    if quant:
        args += [k_scales.stride(0), k_scales.stride(1)]
    _launch(name, "paged_chunk_attention_" + ("int8" if quant else "bf16"),
            q, args + [int(prefix_len), _scale(softmax_scale, D)])
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, cache_len, *,
                           softmax_scale=None):
    """bf16 pages.  Replaces ``paged_decode_attention_pallas``."""
    return _decode("paged_decode_attention", q, k_pages, v_pages, None, None,
                   block_tables, cache_len, softmax_scale)


def paged_decode_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, cache_len, *,
                                 softmax_scale=None):
    """int8 pages + f32 scales.  Replaces
    ``paged_decode_attention_quant_pallas``."""
    return _decode("paged_decode_attention_quant", q, k_pages, v_pages,
                   k_scales, v_scales, block_tables, cache_len,
                   softmax_scale)


def paged_chunk_prefill_attention(q, k_pages, v_pages, block_tables, start,
                                  chunk_len, *, prefix_len: int = 0,
                                  softmax_scale=None):
    """bf16 pages.  Replaces ``paged_chunk_prefill_attention_pallas``."""
    return _chunk("paged_chunk_prefill_attention", q, k_pages, v_pages, None,
                  None, block_tables, start, chunk_len, prefix_len,
                  softmax_scale)


def paged_chunk_prefill_attention_quant(q, k_pages, v_pages, k_scales,
                                        v_scales, block_tables, start,
                                        chunk_len, *, prefix_len: int = 0,
                                        softmax_scale=None):
    """int8 pages + f32 scales.  Replaces
    ``paged_chunk_prefill_attention_quant_pallas``."""
    return _chunk("paged_chunk_prefill_attention_quant", q, k_pages, v_pages,
                  k_scales, v_scales, block_tables, start, chunk_len,
                  prefix_len, softmax_scale)
