"""Wrapper of the flash-attention backward CUDA kernels
(``csrc/flash_attention_bwd.cu``).

``flash_attention_bwd`` checks device, dtype, shape and layout, computes
delta = rowsum(dout * out) in f32 (one PyTorch op, as the reference does
outside its kernels), allocates dq, dk and dv with ``torch.empty``,
launches the dq and the dk/dv kernels on the current stream without
synchronising, raises if a launch reports a CUDA error, and adds one to
``launches["flash_attention_bwd"]``.  It takes CUDA tensors only: the CPU
path is ``ops``' dispatch to the plain version in ``ref``.

Layouts are the forward kernel's: q and dout (B, Lq, Hq, D), k and v
(B, Lk, Hkv, D), bf16, read in place with their batch, sequence and head
strides (the last axis dense); out (B, Lq, Hq, D) bf16 in any layout and
lse (B, Lq, Hq) f32 contiguous, as ``flash_attention.flash_attention``
returns them.  dq, dk and dv come back contiguous in bf16.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build
from .flash_attention import HEAD_DIMS, _check, _require

KERNELS = ("flash_attention_bwd",)

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
        fn = build.library("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = [_P] * 9 + [_I] * 6 + [_LL] * 12 + [_I] * 5 + [_F, _P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None, prefix_len: int = 0,
                        q_offset: int = 0, kv_len: Optional[int] = None,
                        softmax_scale=None):
    """Returns (dq, dk, dv), bf16 in q's, k's and v's shapes, with the mask
    of ``ref.flash_attention_ref``.  Replaces
    ``flash_attention_bwd_pallas``."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        _check(name, t, dev)
    B, Lq, Hq, D = q.shape
    _, Lk, Hkv, Dk = k.shape
    _require(tuple(v.shape) == tuple(k.shape),
             f"k and v must match, got {tuple(k.shape)} and "
             f"{tuple(v.shape)}")
    _require(k.shape[0] == B, f"batch {k.shape[0]} of k != {B} of q")
    for name, t in (("dout", dout), ("out", out)):
        _require(tuple(t.shape) == tuple(q.shape),
                 f"{name} must have q's shape {tuple(q.shape)}, got "
                 f"{tuple(t.shape)}")
    _require(out.device == dev and out.dtype == torch.bfloat16,
             f"out must be bf16 on {dev}, got {out.dtype} on {out.device}")
    _require(lse.device == dev and lse.dtype == torch.float32
             and tuple(lse.shape) == (B, Lq, Hq) and lse.is_contiguous(),
             f"lse must be a contiguous f32 (B, Lq, Hq) = {(B, Lq, Hq)} "
             f"tensor on {dev}, got {lse.dtype} {tuple(lse.shape)}")
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
    dq = torch.empty((B, Lq, Hq, D), dtype=torch.bfloat16, device=dev)
    dk = torch.empty((B, Lk, Hkv, D), dtype=torch.bfloat16, device=dev)
    dv = torch.empty((B, Lk, Hkv, D), dtype=torch.bfloat16, device=dev)
    if B == 0 or Lq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = (dout.float() * out.float()).sum(-1)              # (B, Lq, Hq)
    scale = float(softmax_scale if softmax_scale is not None else D ** -0.5)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Lq, Lk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3],
            int(causal), -1 if window is None else int(window),
            int(prefix_len), int(q_offset), kv_len, scale]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with "
                           f"CUDA error {rc}")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv
