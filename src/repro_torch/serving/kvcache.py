"""Cache dict utilities for the serving engine's dense data planes (the
port of the reference package's ``serving/kvcache.py``).

Model caches are flat dicts of tensors (K/V for attention families, conv
and SSD state for SSM, cross K/V for the encoder-decoder).  The dense-cache
engine admits and evicts requests without knowing a family's layout; it
relies only on the shape convention every family shares:

* ``ndim >= 2`` leaves are batched state with layout ``(layers, batch,
  ...)``: the batch axis is axis 1;
* ``ndim == 1`` leaves are per-slot counters, batch axis 0 (each slot's
  own sequence length);
* ``ndim == 0`` leaves are counters shared by the whole batch (what the
  one-shot ``prefill`` functions emit as ``len``).

``select_slots``/``concat`` slice and join along the batch axis (evict /
admit).  ``merge`` is the admission workhorse: it promotes shared ``len``
scalars to per-slot vectors, zero-pads differing trailing axes (ragged KV
sequence capacity) up to the max, and concatenates, so a freshly prefilled
single-request cache can join a live batch whose KV capacity differs.
End-padding is safe for full-attention caches because per-slot lengths
mask the tail; ring (sliding-window) caches all share ``S = window``.

Every function returns new tensors: like the reference's, this path copies
the whole live batch on each admission and eviction (the engine counts
those copies), which is what the paged arena avoids.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Cache = Dict[str, torch.Tensor]


def _batch_axis(leaf: torch.Tensor) -> Optional[int]:
    """Batch axis of one leaf under the shape convention (None = shared)."""
    if leaf.ndim == 0:
        return None
    return 0 if leaf.ndim == 1 else 1


def map_batch(cache: Cache, fn) -> Cache:
    """Apply ``fn(leaf, batch_axis)`` to every batched leaf; shared scalars
    pass through untouched."""
    return {k: a if a.ndim == 0 else fn(a, _batch_axis(a))
            for k, a in cache.items()}


def batch_size(cache: Cache) -> int:
    """Number of slots in the cache (size of the batch axis)."""
    for leaf in cache.values():
        if leaf.ndim >= 2:
            return int(leaf.shape[1])
    for leaf in cache.values():
        if leaf.ndim == 1:
            return int(leaf.shape[0])
    raise ValueError("cache has no batched leaves")


def select_slots(cache: Cache, idx: Sequence[int]) -> Cache:
    """Keep only the slots in ``idx`` (evict everything else)."""
    return map_batch(cache, lambda a, ax: torch.index_select(
        a, ax, torch.as_tensor(list(idx), dtype=torch.long,
                               device=a.device)))


def concat(caches: Sequence[Cache]) -> Cache:
    """Join caches along the batch axis.  Leaf shapes must already agree
    away from the batch axis (use ``merge`` for ragged capacities); shared
    scalar leaves keep the first cache's value."""
    first = caches[0]
    return {k: a if a.ndim == 0 else torch.cat([c[k] for c in caches],
                                               dim=_batch_axis(a))
            for k, a in first.items()}


def _is_len(leaf: torch.Tensor) -> bool:
    return leaf.ndim <= 1 and not leaf.dtype.is_floating_point


def lens(cache: Cache) -> torch.Tensor:
    """Per-slot sequence lengths (B,) int32; broadcasts a shared scalar
    ``len``."""
    B = batch_size(cache)
    for leaf in cache.values():
        if leaf.ndim == 1:
            return leaf.to(torch.int32)
    for leaf in cache.values():
        if leaf.ndim == 0:
            return leaf.to(torch.int32).expand(B).clone()
    raise ValueError("cache has no length leaves")


def with_lens(cache: Cache, new_lens) -> Cache:
    """Replace every length leaf (integer, ndim 0 or 1) with per-slot
    ``new_lens``: how the engine turns a model-emitted cache (shared scalar
    ``len``) into slot form before merging it into the live batch."""
    ref = next(iter(cache.values()))
    new_lens = torch.as_tensor(new_lens, dtype=torch.int32,
                               device=ref.device)
    if new_lens.ndim == 0:
        new_lens = new_lens[None]
    return {k: new_lens if _is_len(a) else a for k, a in cache.items()}


def pad_to(cache: Cache, like) -> Cache:
    """Zero-pad each batched leaf's trailing axes (everything after the
    batch axis) up to ``like``'s sizes; ``like`` maps the same keys to
    caches' tensors or to shape tuples.  Used to grow a live batch's KV
    capacity when an admitted request needs a longer sequence budget."""
    if set(like) != set(cache):
        raise ValueError("pad_to: reference does not match cache structure")
    out = {}
    for key, leaf in cache.items():
        target = like[key]
        target = tuple(target.shape) if hasattr(target, "shape") \
            else tuple(target)
        if leaf.ndim <= 1:
            out[key] = leaf          # per-slot / shared counters never pad
            continue
        widths = []
        for d, (have, want) in enumerate(zip(leaf.shape, target)):
            if d != 1 and want < have:
                raise ValueError(
                    f"pad_to cannot shrink axis {d}: {have} -> {want}")
            widths.append(0 if d == 1 else want - have)
        if not any(widths):
            out[key] = leaf
            continue
        pad: List[int] = []
        for w in reversed(widths):   # F.pad lists the last axis first
            pad += [0, w]
        out[key] = F.pad(leaf, pad)
    return out


def merge(caches: Sequence[Cache]) -> Cache:
    """Admission merge: per-slot length promotion, ragged-capacity padding
    and batch concat in one call.  Every input keeps its own sequence
    length; trailing axes that differ across inputs (KV capacity S) are
    zero-padded at the end to the max.  The result always carries per-slot
    (B,) lengths, ready for the fused per-slot decode step."""
    normalized = [with_lens(c, lens(c)) for c in caches]
    if len(normalized) == 1:
        return normalized[0]
    targets = {}
    for key, leaf in normalized[0].items():
        if leaf.ndim <= 1:
            targets[key] = tuple(leaf.shape)
            continue
        shape = list(leaf.shape)
        for other in normalized[1:]:
            o = other[key]
            if o.ndim != leaf.ndim:
                raise ValueError("merge: mismatched cache structures")
            for d in range(leaf.ndim):
                if d != 1:       # batch axis may differ freely
                    shape[d] = max(shape[d], o.shape[d])
        targets[key] = tuple(shape)
    return concat([pad_to(c, targets) for c in normalized])


def cache_bytes(cache: Cache) -> int:
    """Bytes held by the batched state (length counters are negligible and
    excluded, matching the allocator's VRAM accounting)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in cache.values() if leaf.ndim >= 2)
