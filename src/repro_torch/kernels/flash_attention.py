"""Wrapper of the flash-attention forward CUDA kernel
(``csrc/flash_attention.cu``).

``flash_attention`` checks device, dtype, shape and layout, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
``launches["flash_attention"]``.  It takes CUDA tensors only: the CPU path
is ``ops``' dispatch to the plain version in ``ref``.

Layouts are the reference package's: q (B, Lq, Hq, D), k and v
(B, Lk, Hkv, D), bf16, read in place with their batch, sequence and head
strides (the last axis dense); out (B, Lq, Hq, D) bf16 and lse
(B, Lq, Hq) f32, contiguous.  Head dim one of ``HEAD_DIMS``, Hq a multiple
of Hkv.  Forward only: nothing here records a gradient.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build

KERNELS = ("flash_attention",)
HEAD_DIMS = (64, 112, 128, 256)

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
        fn = build.library("flash_attention").flash_attention_fwd
        fn.argtypes = [_P] * 5 + [_I] * 6 + [_LL] * 9 + [_I] * 5 + [_F, _P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check(name: str, t, dev) -> None:
    _require(t.device.type == "cuda",
             f"{name} must be a CUDA tensor, got {t.device}")
    _require(t.device == dev, f"{name} is on {t.device}, q on {dev}")
    _require(t.dtype == torch.bfloat16, f"{name} must be bf16, got {t.dtype}")
    _require(t.ndim == 4, f"{name} must be (B, L, H, D), got "
             f"{tuple(t.shape)}")
    _require(t.stride(3) == 1, f"{name}'s head dim must be dense")
    _require(t.data_ptr() % 16 == 0
             and all(t.stride(i) % 8 == 0 for i in range(3)),
             f"{name} must be 16-byte aligned with strides that are "
             f"multiples of 8 (rows are read 16 bytes at a time)")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, prefix_len: int = 0,
                    q_offset: int = 0, kv_len: Optional[int] = None,
                    softmax_scale=None):
    """Returns (out (B, Lq, Hq, D) bf16, lse (B, Lq, Hq) f32), with the
    mask of ``ref.flash_attention_ref``.  Replaces
    ``flash_attention_pallas`` (forward, ``return_lse=True``)."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev)
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, Dk = k.shape
    _require(tuple(v.shape) == tuple(k.shape),
             f"k and v must match, got {tuple(k.shape)} and "
             f"{tuple(v.shape)}")
    _require(k.shape[0] == B, f"batch {k.shape[0]} of k != {B} of q")
    _require(D in HEAD_DIMS and Dk == D,
             f"head dim must be one of {HEAD_DIMS} in q and k, got {D}/{Dk}")
    _require(Hkv >= 1 and Hq % Hkv == 0,
             f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _require(Lk >= 1, "k and v hold no keys")
    kv_len = Lk if kv_len is None else int(kv_len)
    _require(0 <= kv_len <= Lk, f"kv_len must be in [0, {Lk}], got {kv_len}")
    _require(window is None or window >= 0,
             f"window must be None or >= 0, got {window}")
    _require(prefix_len >= 0 and q_offset >= 0,
             f"prefix_len and q_offset must be >= 0, got {prefix_len} and "
             f"{q_offset}")
    out = torch.empty((B, Lq, Hq, D), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((B, Lq, Hq), dtype=torch.float32, device=dev)
    if B == 0 or Lq == 0:
        return out, lse
    scale = float(softmax_scale if softmax_scale is not None else D ** -0.5)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Lq, Lk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else int(window),
            int(prefix_len), int(q_offset), kv_len, scale]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {rc}")
    launches["flash_attention"] += 1
    return out, lse
