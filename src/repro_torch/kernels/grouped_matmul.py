"""Wrapper of the grouped (per-expert) GEMM CUDA kernel
(``csrc/grouped_matmul.cu``).

``grouped_matmul`` checks device, dtype and shape, allocates its output
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
``launches["grouped_matmul"]`` and to its route's entry in
``route_launches``.  It takes CUDA tensors only: the CPU path is ``ops``'
dispatch to the plain version in ``ref``.

lhs (E, C, K) and rhs (E, K, N), both bf16 (the serving path) or both
float32, are read in place when their last axis is dense (a copy is made
otherwise); C, K and N may take any size, ragged tiles are zero-filled in
shared memory.  The output (E, C, N) is contiguous in lhs's dtype.

Two routes, chosen by ``route`` from dtype, shapes, strides and pointers
alone (never by a failure, and with no fallback from one to the other):
``"tma"``, the kernel on ``wgmma`` fed by TMA, for what a tensor map can
describe (bf16, K and N multiples of 8, 16-byte-aligned pointers and
positive strides that are multiples of 8 elements); ``"mma_sync"``, the
kernel on ``mma.sync`` with element-by-element staging (float32 on its own
FMA tiles), for everything else.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from . import build

KERNELS = ("grouped_matmul",)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

ROUTES = ("tma", "mma_sync")

launches: Dict[str, int] = {name: 0 for name in KERNELS}
route_launches: Dict[str, int] = {name: 0 for name in ROUTES}


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"tma": [_P] * 3 + [_I] * 4 + [_LL] * 4 + [_P],
             "mma_sync": [_P] * 3 + [_I] * 4 + [_LL] * 4 + [_I, _P]}
_SYMBOLS = {"tma": "grouped_matmul_tma", "mma_sync": "grouped_matmul"}
_fns: Dict[str, Callable[..., int]] = {}


def _entry(which: str):
    """The C entry point of route ``which``, resolved once with its
    argtypes set (the library is built on the first call)."""
    fn = _fns.get(which)
    if fn is None:
        fn = getattr(build.library("grouped_matmul"), _SYMBOLS[which])
        fn.argtypes = _ARGTYPES[which]
        fn.restype = ctypes.c_int
        _fns[which] = fn
    return fn


def route(lhs, rhs) -> str:
    """The kernel that takes lhs (E, C, K) @ rhs (E, K, N) as given:
    ``"tma"`` where a TMA tensor map can describe both operands (bf16,
    last axes dense, K and N multiples of 8, 16-byte-aligned data
    pointers, every outer stride a positive multiple of 8 elements), else
    ``"mma_sync"``.  A plain function of dtype, shape, strides and
    pointers; it launches nothing."""
    K, N = lhs.shape[2], rhs.shape[2]
    strides = (lhs.stride(0), lhs.stride(1), rhs.stride(0), rhs.stride(1))
    ok = (lhs.dtype == torch.bfloat16 and rhs.dtype == torch.bfloat16
          and lhs.stride(2) == 1 and rhs.stride(2) == 1 and K > 0 and K % 8 == 0 and N % 8 == 0
          and lhs.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
          and all(s > 0 and s % 8 == 0 for s in strides))
    return "tma" if ok else "mma_sync"


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
    which = route(lhs, rhs)
    args = [lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), E, C, K, N,
            lhs.stride(0), lhs.stride(1), rhs.stride(0), rhs.stride(1)]
    if which == "mma_sync":
        args.append(DTYPES[lhs.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry(which)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul: kernel launch ({which} route) "
                           f"failed with CUDA error {rc}")
    launches["grouped_matmul"] += 1
    route_launches[which] += 1
    return out
