"""Wrapper of the Mamba-2 SSD chunked-scan CUDA kernel (``csrc/ssd_scan.cu``).

``ssd_scan`` checks device, dtype, shape and layout, allocates its outputs
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reports a CUDA error, and adds one to
``launches["ssd_scan"]`` and to its copy route's entry in
``route_launches``.  It takes CUDA tensors only: the CPU path is ``ops``'
dispatch to the plain version in ``ref``.

Layouts are the reference package's: x (Bb, L, H, P) and B, C
(Bb, L, G, N) bf16, dt (Bb, L, H) f32, A and D (H,) f32, the state
(Bb, H, P, N) f32.  x, dt, B and C are read in place with their batch and
time strides (the model passes slices of one projection); their last two
axes must be dense.  (P, N) is one of ``SHAPES``.

The kernel stages x, B and C in shared memory with 16-byte copies
(``"vec16"``) when every row of them, and the initial state, starts on 16
bytes, else with 4-byte copies (``"vec4"``): the kernel's entry point
chooses from the pointers and strides, and ``route`` states the same rule
in Python, so that the launches are counted by route.  It is a route
inside the kernel, not a fallback.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build

KERNELS = ("ssd_scan",)
SHAPES = ((64, 128), (64, 64), (16, 16))   # (P, N) pairs instantiated
MAX_CHUNK = 256

ROUTES = ("vec16", "vec4")

launches: Dict[str, int] = {name: 0 for name in KERNELS}
route_launches: Dict[str, int] = {name: 0 for name in ROUTES}


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


def route(x, B, C, initial_state=None) -> str:
    """The copy route the kernel takes for these operands: ``"vec16"``
    where x, B, C and the initial state (if any) start on 16 bytes and
    the batch and time strides of x, B and C are multiples of 8 elements
    (their head and state axes are dense, and P and N are multiples of 8,
    so every staged row then starts on 16 bytes), else ``"vec4"``.  A
    plain function of pointers and strides, the rule of ``ssd_scan_fwd``;
    it launches nothing."""
    ok = all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0
             and t.stride(1) % 8 == 0 for t in (x, B, C))
    if initial_state is not None:
        ok = ok and initial_state.data_ptr() % 16 == 0
    return "vec16" if ok else "vec4"


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_fn = None


def _entry():
    """The C entry point, resolved once with its argtypes set (the library
    is built on the first call)."""
    global _fn
    if _fn is None:
        fn = build.library("ssd_scan").ssd_scan_fwd
        fn.argtypes = [_P] * 9 + [_I] * 7 + [_LL] * 8 + [_P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_in(name: str, t, dev, dtype, shape) -> None:
    _require(t.device.type == "cuda",
             f"{name} must be a CUDA tensor, got {t.device}")
    _require(t.device == dev, f"{name} is on {t.device}, x on {dev}")
    _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def ssd_scan(x, dt, A, B, C, D=None, *, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None):
    """Returns (y (Bb, L, H, P) bf16, final state (Bb, H, P, N) f32), with
    the D skip term added to y.  Replaces ``ssd_scan_pallas``."""
    _require(x.ndim == 4 and B.ndim == 4,
             f"x and B must be 4-d, got {tuple(x.shape)} and "
             f"{tuple(B.shape)}")
    Bb, L, H, P = x.shape
    G, N = B.shape[2:]
    dev = x.device
    _check_in("x", x, dev, torch.bfloat16, (Bb, L, H, P))
    _check_in("dt", dt, dev, torch.float32, (Bb, L, H))
    _check_in("A", A, dev, torch.float32, (H,))
    _check_in("B", B, dev, torch.bfloat16, (Bb, L, G, N))
    _check_in("C", C, dev, torch.bfloat16, (Bb, L, G, N))
    if D is not None:
        _check_in("D", D, dev, torch.float32, (H,))
        _require(D.is_contiguous(), "D must be contiguous")
    if initial_state is not None:
        _check_in("initial_state", initial_state, dev, torch.float32,
                  (Bb, H, P, N))
        _require(initial_state.is_contiguous(),
                 "initial_state must be contiguous")
    _require((P, N) in SHAPES,
             f"(headdim P, state N) = {(P, N)} is not one of {SHAPES}")
    _require(G >= 1 and H % G == 0, f"H={H} is not a multiple of G={G}")
    _require(1 <= chunk, f"chunk must be positive, got {chunk}")
    _require(A.is_contiguous(), "A must be contiguous")
    _require(dt.stride(2) == 1, "dt's head axis must be dense")
    for name, t, inner in (("x", x, P), ("B", B, N), ("C", C, N)):
        _require(t.stride(3) == 1 and t.stride(2) == inner,
                 f"{name}'s last two axes must be dense")
        _require(t.data_ptr() % 4 == 0 and t.stride(0) % 2 == 0
                 and t.stride(1) % 2 == 0,
                 f"{name} must be 4-byte aligned with even strides (it is "
                 f"read two bf16 values at a time)")
    Q = min(chunk, max(8, L))
    _require(Q <= MAX_CHUNK, f"chunk {Q} exceeds {MAX_CHUNK}")
    y = torch.empty((Bb, L, H, P), dtype=torch.bfloat16, device=dev)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    if Bb == 0 or H == 0:
        return y, state
    args = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr() if D is not None else None,
            (initial_state.data_ptr() if initial_state is not None
             else None),
            y.data_ptr(), state.data_ptr(), Bb, L, H, G, P, N, Q,
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(*args, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{rc}")
    launches["ssd_scan"] += 1
    route_launches[route(x, B, C, initial_state)] += 1
    return y, state
