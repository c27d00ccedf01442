"""Wrapper of the grouped (per-expert) GEMM CUDA kernel
(``csrc/grouped_matmul.cu``).

``grouped_matmul`` checks device, dtype and shape, allocates its output
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
``launches["grouped_matmul"]``.  It takes CUDA tensors only: the CPU path
is ``ops``' dispatch to the plain version in ``ref``.

lhs (E, C, K) and rhs (E, K, N), both bf16 (the serving path) or both
float32, are read in place when their last axis is dense (a copy is made
otherwise); C, K and N may take any size, ragged tiles are zero-filled in
shared memory.  The output (E, C, N) is contiguous in lhs's dtype.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

KERNELS = ("grouped_matmul",)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

launches: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_fn = None


def _entry():
    """The C entry point, resolved once with its argtypes set (the library
    is built on the first call)."""
    global _fn
    if _fn is None:
        fn = build.library("grouped_matmul").grouped_matmul
        fn.argtypes = [_P] * 3 + [_I] * 4 + [_LL] * 4 + [_I, _P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def grouped_matmul(lhs, rhs):
    """Returns lhs[e] @ rhs[e] for every expert e, (E, C, N) in lhs's
    dtype, summed in f32.  Replaces ``grouped_matmul_pallas``."""
    dev = lhs.device
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        _require(t.device.type == "cuda",
                 f"{name} must be a CUDA tensor, got {t.device}")
        _require(t.device == dev, f"{name} is on {t.device}, lhs on {dev}")
        _require(t.ndim == 3, f"{name} must be 3-D, got {tuple(t.shape)}")
    _require(lhs.dtype in DTYPES and rhs.dtype == lhs.dtype,
             f"lhs and rhs must both be bfloat16 or both float32, got "
             f"{lhs.dtype} and {rhs.dtype}")
    E, C, K = lhs.shape
    _require(rhs.shape[0] == E and rhs.shape[1] == K,
             f"rhs must be ({E}, {K}, N), got {tuple(rhs.shape)}")
    N = rhs.shape[2]
    out = torch.empty((E, C, N), dtype=lhs.dtype, device=dev)
    if E == 0 or C == 0 or N == 0:
        return out
    if lhs.stride(2) != 1:
        lhs = lhs.contiguous()
    if rhs.stride(2) != 1:
        rhs = rhs.contiguous()
    args = [lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), E, C, K, N,
            lhs.stride(0), lhs.stride(1), rhs.stride(0), rhs.stride(1),
            DTYPES[lhs.dtype]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul: kernel launch failed with CUDA "
                           f"error {rc}")
    launches["grouped_matmul"] += 1
    return out
