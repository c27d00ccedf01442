"""Wrapper of the dense decode-attention CUDA kernel
(``csrc/decode_attention.cu``).

``decode_attention`` checks device, dtype, shape and layout, allocates its
output (and, with more than one split, its f32 workspace) with
``torch.empty``, launches on the current stream without synchronising,
raises if a launch reports a CUDA error, and adds one to
``launches["decode_attention"]`` per call, however many kernels the call
runs (the split kernel, then the merge when there are splits).  It takes
CUDA tensors only: the CPU path is ``ops``' dispatch to the plain version
in ``ref``.

Each (slot, kv head) item's keys are split over warps.  ``plan_splits``
picks the count from the shapes alone (B * Hkv, S, D and the card's SM
count, read once per device from ``torch.cuda.get_device_properties``),
never from ``cache_len``, so a call is free of host syncs and can be
captured in a CUDA graph: one split where B * Hkv already gives the card
``FILL_PER_SM`` items an SM; otherwise enough splits to reach
``ITEMS_PER_SM`` items an SM, each a whole number of ``TILE``-key tiles
and at least ``SPLIT_BYTES`` of K and V, so that a split is worth its
merge.  Splits past a slot's length cost a warp one load on the card, so
the planner can afford more of them than the live slots need.  With one
split the kernel writes the rows itself and no workspace is allocated.

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
HEAD_DIMS = (64, 112, 128, 256)
MAX_GROUP = 16
TILE = 32              # a split is a whole number of 32-key tiles
FILL_PER_SM = 16       # (slot, kv head) items an SM: one split fills the card
ITEMS_PER_SM = 32      # (slot, kv head, split) items an SM splits aim for
SPLIT_BYTES = 65536    # the fewest bytes of K and V a split streams

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_fn = None
_sms: Dict[int, int] = {}          # SM count by device index


def plan_splits(B: int, Hkv: int, S: int, D: int, sms: int):
    """(nsplit, split_len): ``nsplit`` splits of ``split_len`` keys cover
    [0, S), the last possibly short; with nsplit > 1, ``split_len`` is a
    whole number of ``TILE``s and at least ``SPLIT_BYTES`` of K and V, and
    with nsplit = 1 it is S (at least 1).  A pure function of the shapes
    and the SM count: the slots' lengths are not read, so splits past a
    short slot's keys are skipped on the card."""
    S1 = max(int(S), 1)
    items = B * Hkv
    if items >= FILL_PER_SM * sms:
        return 1, S1
    min_keys = -(-max(SPLIT_BYTES // (4 * D), 1) // TILE) * TILE
    want = -(-ITEMS_PER_SM * sms // max(items, 1))
    n = max(1, min(want, S1 // min_keys))
    if n == 1:
        return 1, S1
    per = -(-S1 // n)
    split_len = -(-per // TILE) * TILE
    return -(-S1 // split_len), split_len


def sm_count(dev: torch.device) -> int:
    """The device's SM count, read once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _entry():
    """The C entry point, resolved once with its argtypes set (the library
    is built on the first call)."""
    global _fn
    if _fn is None:
        fn = build.library("decode_attention").decode_attention_dense
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_LL] * 6 + [_I, _F, _I, _I] \
            + [_P] * 3
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
    nsplit, split_len = plan_splits(B, Hkv, S, D, sm_count(dev))
    ws_acc = ws_ml = None
    if nsplit > 1:
        ws_acc = torch.empty(B * Hq * nsplit * D, dtype=torch.float32,
                             device=dev)
        ws_ml = torch.empty(B * Hq * nsplit * 2, dtype=torch.float32,
                            device=dev)
    args = [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            -1 if window is None else int(window), scale, nsplit, split_len,
            None if ws_acc is None else ws_acc.data_ptr(),
            None if ws_ml is None else ws_ml.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    launches["decode_attention"] += 1
    return out
