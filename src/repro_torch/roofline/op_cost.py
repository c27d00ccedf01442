"""FLOPs and bytes of the ops a step dispatches: the port's counterpart of
the reference package's ``roofline/hlo_cost.py``.

The reference parses the optimized HLO of a compiled step.  The port has
no HLO: it runs a step and counts what it dispatches.

  aten ops  -- FLOPs by ``torch.utils.flop_counter.FlopCounterMode``;
               bytes as each op's tensor inputs read once and outputs
               written once (eager ops are unfused, so this is what they
               move), with views free and an indexing op charged for the
               rows it gathers or scatters, not for the whole tensor it
               indexes;
  kernels   -- one rule a hand-written kernel (``RULES``), reckoning the
               kernel's own work from its arguments: the same FLOPs and
               bytes that ``chip_smoke.py`` divides for each kernel's
               bound.  The kernel's plain version, which a CPU or fake
               tensor runs instead, is left out of the aten count (the
               plain causal attention computes the whole square);
  the mesh  -- the bytes that pass through ``Mesh.all_reduce`` and
               ``Mesh.gather`` (a head-sharded step's reductions).

Where a kernel's work depends on its data (slot lengths, chunk starts),
a rule reads the data; a fake or meta tensor has none, and the rule then
counts the most the shapes allow (every slot at its table's full width),
as a compiled step's static cost analysis would.

Under ``FakeTensorMode`` on the CPU a step allocates and computes
nothing, so ``count`` prices a full-width step without a card; a kernel
called on fake tensors returns fake outputs of its shapes (``OUTPUTS``)
without tracing its plain version.  A fake
tensor on ``cuda`` would try to launch a real kernel, so steps are traced
on fake CPU tensors (``fake_copy``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.kernels.quant import QuantPages

aten = torch.ops.aten


@dataclasses.dataclass
class OpCost:
    """What a counted region dispatched."""
    aten_flops: float = 0.0
    aten_bytes: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    reduce_bytes: float = 0.0
    reduce_calls: int = 0

    @property
    def flops(self) -> float:
        return self.aten_flops + sum(self.kernel_flops.values())

    @property
    def bytes(self) -> float:
        return self.aten_bytes + sum(self.kernel_bytes.values())

    def to_dict(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "aten_flops": self.aten_flops, "aten_bytes": self.aten_bytes,
                "kernel_flops": dict(self.kernel_flops),
                "kernel_bytes": dict(self.kernel_bytes),
                "kernel_calls": dict(self.kernel_calls),
                "reduce_bytes": self.reduce_bytes,
                "reduce_calls": self.reduce_calls}


# ---------------------------------------------------------------------------
# data of a kernel's arguments
# ---------------------------------------------------------------------------

def _has_data(t) -> bool:
    return not (isinstance(t, FakeTensor)
                or (isinstance(t, torch.Tensor) and t.is_meta))


def _per_slot(x, B: int, most: int) -> np.ndarray:
    """A scalar or (B,) int argument's values, or ``most`` for each slot
    where it holds no data."""
    if isinstance(x, torch.Tensor) and not _has_data(x):
        return np.full((B,), most, np.int64)
    a = np.asarray(torch.as_tensor(x).detach().cpu()).astype(np.int64)
    return np.broadcast_to(a, (B,)).copy() if a.ndim == 0 else a


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _kv_bytes(keys: int, pool, Hkv: int, D: int) -> int:
    """Bytes of K and V rows (an int8 pool's scales too) for ``keys``
    tokens."""
    if isinstance(pool, QuantPages):
        return 2 * keys * (Hkv * D + Hkv * 4)
    return 2 * keys * Hkv * D * pool.element_size()


def visible_pairs(Lq: int, Lk: int, *, causal: bool = True,
                  window: Optional[int] = None, prefix_len: int = 0,
                  q_offset: int = 0, kv_len: Optional[int] = None) -> int:
    """(row, key) pairs the flash kernels' element mask keeps
    (``ref._flash_mask``): keys below ``kv_len``; with ``causal``, those
    at or before the row's position (within ``window``), or below
    ``prefix_len``."""
    kv = Lk if kv_len is None else min(int(kv_len), Lk)
    if not causal:
        return Lq * kv
    p = q_offset + np.arange(Lq, dtype=np.int64)
    lo = np.zeros_like(p) if window is None else np.maximum(0, p - window + 1)
    hi = np.minimum(p, kv - 1)
    a = np.maximum(0, hi - lo + 1)
    pre = min(prefix_len, kv)
    both = np.maximum(0, np.minimum(hi, pre - 1) - lo + 1)
    return int((a + pre - both).sum())


def _chunk_work(start, chunk_len, T: int, prefix_len: int):
    """(keys, pairs, rows) of a chunk launch: per live slot, the keys some
    real row can see, the visible (row, key) pairs and the real rows."""
    keys = pairs = rows = 0
    for s, c in zip(start.tolist(), chunk_len.tolist()):
        if c:
            keys += s + c
            rows += c
            i = np.arange(c, dtype=np.int64)
            pairs += int(np.minimum(s + c, np.maximum(s + i + 1,
                                                      prefix_len)).sum())
    return keys, pairs, rows


# ---------------------------------------------------------------------------
# one rule a kernel: (kernel name, flops, bytes)
# ---------------------------------------------------------------------------

def _paged_decode(q, k_pages, v_pages, block_tables, cache_len, **_):
    B, Hq, D = q.shape
    pool = k_pages.values if isinstance(k_pages, QuantPages) else k_pages
    _, bs, Hkv, _ = pool.shape
    lens = _per_slot(cache_len, B, block_tables.shape[1] * bs)
    keys, live = int(lens.sum()), int((lens > 0).sum())
    entries = int((-(-lens // bs)).sum())
    esz = q.element_size()
    nbytes = (live * Hq * D * esz + _nbytes(q) + B * 4 + entries * 4
              + _kv_bytes(keys, k_pages, Hkv, D))
    quant = "_quant" if isinstance(k_pages, QuantPages) else ""
    return f"paged_decode_attention{quant}", 4 * D * Hq * keys, nbytes


def _paged_chunk(q, k_pages, v_pages, block_tables, start, chunk_len, *,
                 prefix_len: int = 0, **_):
    B, T, Hq, D = q.shape
    pool = k_pages.values if isinstance(k_pages, QuantPages) else k_pages
    _, bs, Hkv, _ = pool.shape
    width = block_tables.shape[1] * bs
    st = _per_slot(start, B, max(0, width - T))
    cl = _per_slot(chunk_len, B, T)
    keys, pairs, rows = _chunk_work(st, cl, T, prefix_len)
    entries = int(sum(-(-(s + c) // bs) for s, c in zip(st, cl) if c))
    esz = q.element_size()
    nbytes = (rows * Hq * D * esz + _nbytes(q) + entries * 4 + 2 * B * 4
              + _kv_bytes(keys, k_pages, Hkv, D))
    quant = "_quant" if isinstance(k_pages, QuantPages) else ""
    return (f"paged_chunk_prefill_attention{quant}", 4 * D * Hq * pairs,
            nbytes)


def _dense_decode(q, k_cache, v_cache, cache_len, *, window=None, **_):
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    lens = np.minimum(_per_slot(cache_len, B, S), S)
    if window is not None:
        lens = np.minimum(lens, window)
    keys, live = int(lens.sum()), int((lens > 0).sum())
    esz = q.element_size()
    nbytes = (live * Hq * D * esz + B * 4 + _nbytes(q)
              + 2 * keys * Hkv * D * k_cache.element_size())
    return "decode_attention", 4 * D * Hq * keys, nbytes


def _dense_chunk(q, k_cache, v_cache, start, chunk_len, *,
                 prefix_len: int = 0, **_):
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    st = _per_slot(start, B, max(0, S - T))
    cl = _per_slot(chunk_len, B, T)
    keys, pairs, rows = _chunk_work(st, cl, T, prefix_len)
    esz = q.element_size()
    nbytes = (rows * Hq * D * esz + _nbytes(q) + 2 * B * 4
              + 2 * keys * Hkv * D * k_cache.element_size())
    return "chunk_prefill_attention", 4 * D * Hq * pairs, nbytes


def _flash_pairs(q, k, kw) -> int:
    B, Lq, Hq, _ = q.shape
    return B * Hq * visible_pairs(
        Lq, k.shape[1], causal=kw.get("causal", True),
        window=kw.get("window"), prefix_len=kw.get("prefix_len", 0),
        q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"))


def _flash_fwd(q, k, v, kw):
    D = q.shape[-1]
    B, Lq, Hq, _ = q.shape
    nbytes = (2 * _nbytes(q) + _nbytes(k) + _nbytes(v)
              + 4 * B * Lq * Hq)                  # q, k, v, out and lse
    return "flash_attention", 4 * D * _flash_pairs(q, k, kw), nbytes


def _flash_bwd(q, k, v, out, lse, dout, kw):
    D = q.shape[-1]
    nbytes = (2 * (_nbytes(q) + _nbytes(k) + _nbytes(v)) + _nbytes(out)
              + _nbytes(dout) + _nbytes(lse))
    return "flash_attention_bwd", 10 * D * _flash_pairs(q, k, kw), nbytes


def _ssd(x, dt, A, B, C, D, chunk, initial_state):
    Bb, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = min(chunk, max(8, L))
    full, rest = divmod(L, Q)
    pairs = full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2
    flops = 2 * Bb * H * (pairs * (N + P) + 2 * L * P * N)
    state = Bb * H * P * N * 4
    nbytes = (2 * _nbytes(x) + _nbytes(dt) + _nbytes(B) + _nbytes(C)
              + _nbytes(A) + (0 if D is None else _nbytes(D)) + state
              + (0 if initial_state is None else state))
    return "ssd_scan", flops, nbytes


def _gmm(lhs, rhs):
    E, C, K = lhs.shape
    N = rhs.shape[2]
    return ("grouped_matmul", 2 * E * C * K * N,
            lhs.element_size() * (lhs.numel() + rhs.numel() + E * C * N))


def _like(t, dtype=None):
    return torch.empty_like(t, dtype=dtype or t.dtype)


# each kernel's outputs, made without running it (fake inputs only: they
# hold no values to compute from)
OUTPUTS: Dict[str, Callable] = {
    "paged_decode_attention": lambda q, *a, **k: _like(q),
    "paged_chunk_prefill_attention": lambda q, *a, **k: _like(q),
    "decode_attention": lambda q, *a, **k: _like(q),
    "chunk_prefill_attention": lambda q, *a, **k: _like(q),
    "flash_attention": lambda q, k, v, kw: (
        _like(q), q.new_empty(q.shape[:3], dtype=torch.float32)),
    "flash_attention_bwd": lambda q, k, v, *a: (_like(q), _like(k),
                                                _like(v)),
    "ssd_scan": lambda x, dt, A, B, C, D, chunk, h0: (
        _like(x), x.new_empty((x.shape[0], x.shape[2], x.shape[3],
                               B.shape[3]), dtype=torch.float32)),
    "grouped_matmul": lambda lhs, rhs: lhs.new_empty(
        (lhs.shape[0], lhs.shape[1], rhs.shape[2])),
}


RULES: Dict[str, Callable[..., Tuple[str, float, float]]] = {
    "paged_decode_attention": _paged_decode,
    "paged_chunk_prefill_attention": _paged_chunk,
    "decode_attention": _dense_decode,
    "chunk_prefill_attention": _dense_chunk,
    "flash_attention": _flash_fwd,
    "flash_attention_bwd": _flash_bwd,
    "ssd_scan": _ssd,
    "grouped_matmul": _gmm,
}


def kernel_work(name: str, *args, **kw) -> Tuple[str, float, float]:
    """(kernel name, FLOPs, bytes) of one call of dispatch function
    ``name`` (``ops``'s names) on these arguments."""
    return RULES[name](*args, **kw)


# ---------------------------------------------------------------------------
# aten bytes
# ---------------------------------------------------------------------------

_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.detach,
         aten.alias, aten.lift_fresh, aten._local_scalar_dense}
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
_PUTS = {aten.index_put, aten.index_put_, aten._index_put_impl_}
_SCATTERS = {aten.index_copy, aten.index_copy_, aten.scatter, aten.scatter_}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_bytes(func, args, kwargs, out) -> int:
    packet = func.overloadpacket
    if func.namespace != "aten" or packet in _FREE or func.is_view:
        return 0
    if packet in _GATHERS:
        idx = sum(_nbytes(t) for t in _tensors(args[1:])
                  if not t.dtype.is_floating_point)
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + idx
    if packet in _PUTS or packet in _SCATTERS:
        # (self, indices, values) or (self, dim, index, source): the
        # indices read, the values read and written
        idx, vals = (args[1], args[2]) if packet in _PUTS \
            else (args[2], args[3])
        written = (_nbytes(vals) if isinstance(vals, torch.Tensor)
                   else _tensors(idx)[0].numel() * args[0].element_size())
        return sum(_nbytes(t) for t in _tensors(idx)) + 2 * written
    if packet is aten.copy_:
        return 2 * _nbytes(args[1])
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in _tensors(out)))


class _ByteCounter(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            self.cost.aten_bytes += _op_bytes(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# counting a region
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def count(mesh=None):
    """Count what the region dispatches into the yielded ``OpCost`` (its
    totals are final when the region exits).  ``mesh``: the mesh whose
    reductions the region's step runs."""
    cost = OpCost()
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter(cost)
    skipped = [0.0]
    r0 = (mesh.reduce_bytes, mesh.reduce_calls) if mesh is not None else None

    def observe(name, fn, args, kw):
        kname, f, b = RULES[name](*args, **kw)
        cost.kernel_flops[kname] = cost.kernel_flops.get(kname, 0.0) + f
        cost.kernel_bytes[kname] = cost.kernel_bytes.get(kname, 0.0) + b
        cost.kernel_calls[kname] = cost.kernel_calls.get(kname, 0) + 1
        if isinstance(args[0], FakeTensor):
            # nothing to compute: the plain version would only trace its
            # own ops (the whole attention square) for nothing
            return OUTPUTS[name](*args, **kw)
        before = flops.get_total_flops()
        nbytes.paused += 1
        try:
            return fn(*args, **kw)
        finally:
            nbytes.paused -= 1
            skipped[0] += flops.get_total_flops() - before

    if ops._observer[0] is not None:
        raise RuntimeError("op_cost.count does not nest")
    ops._observer[0] = observe
    try:
        with flops, nbytes:
            yield cost
    finally:
        ops._observer[0] = None
        cost.aten_flops = flops.get_total_flops() - skipped[0]
        if r0 is not None:
            cost.reduce_bytes = mesh.reduce_bytes - r0[0]
            cost.reduce_calls = mesh.reduce_calls - r0[1]


def fake_copy(tree, mode: FakeTensorMode, device="cpu"):
    """A tree of fake tensors on ``device`` with each tensor's shape,
    strides and dtype (``QuantPages`` both leaves), made under ``mode``:
    nothing is allocated and nothing of the originals is touched."""
    def one(t):
        if isinstance(t, QuantPages):
            return QuantPages(one(t.values), one(t.scales))
        if isinstance(t, torch.Tensor):
            with mode:
                return torch.empty_strided(tuple(t.shape), t.stride(),
                                           dtype=t.dtype, device=device)
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(one(v) for v in t)
        return t
    return one(tree)
