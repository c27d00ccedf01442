"""Paged KV arena: fixed-capacity, block-table cache store for the slot
engine (the port of the reference package's ``serving/arena.py``).

* The token axis is paged: every KV sequence leaf is stored as physical
  blocks of ``block_size`` tokens in a shared pool
  ``(layers, pool_blocks + 1, block_size, Hkv, D)``, and each slot owns a
  row of a ``(capacity, blocks_per_slot)`` block table mapping logical to
  physical block.  The pool's LAST block is reserved trash: it absorbs
  writes from unoccupied slots and padding rows, so the fused step needs no
  branches.
* A cache leaf that does not grow with ``max_len`` is per-slot state (the
  SSM family's conv tail and SSD state, the encoder-decoder's cross K/V,
  and the K/V of a sliding window shorter than the slot budget, a ring of
  the last ``window`` tokens): it is kept as one row per slot,
  ``(layers, capacity, ...)`` in the leaf's own dtype, and never quantized.
* Admission is an ``alloc``; pages are written chunk by chunk, or at once
  by ``write_prefill`` after a one-shot prefill.  Eviction is a free-list
  operation with no device work.
* Blocks are shareable across slots (the prefix cache): ``alloc`` can
  stitch resident blocks into the front of a new slot's table
  (``shared=...``), per-block refcounts keep them alive across the source
  slot's eviction, ``register``/``unregister`` let a prefix index freeze
  blocks (a writer copies first: ``cow_blocks``, ``ensure_writable``), and
  ref-0 registered blocks wait on an LRU that the allocator reclaims before
  it ever fails.  ``park``/``release_parked`` freeze a live slot's blocks
  while its slot is reused (preemption).
* The decode step always runs at the full static shape ``(capacity, ...)``
  with an occupancy mask.
* ``kv_dtype="int8"`` stores floating pools as ``QuantPages`` (int8 values
  plus one f32 scale per token and head, travelling with the blocks).
* ``dense_view`` gathers the pools into a dense ``(layers, B, slot_tokens,
  ...)`` view for the dense-cache steps (the families without paged-native
  steps, ring layouts and the ``paged_native=False`` oracle), and
  ``append_rows`` writes the rows such a step produced back into the pages.

Host bookkeeping (free lists, block tables, refcounts, the idle LRU,
occupancy) is numpy with the reference's semantics and counters.  Device
state is ``pages`` (one pool per paged leaf), ``state`` (one tensor per
state leaf) and ``lens`` ``(capacity,)`` int32; the model steps,
``write_prefill``, ``append_rows`` and ``cow_blocks`` update pools and
state in place, so ``pages`` and ``state`` are never re-bound.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.quant import QuantPages, dequantize, quantize

_LEN, _PAGED, _STATE = "len", "paged", "state"

VALID_KV_DTYPES = ("bf16", "int8")


def _is_len_leaf(t: torch.Tensor) -> bool:
    return t.ndim <= 1 and not t.dtype.is_floating_point


class KVArena:
    """Fixed-capacity paged cache arena for one DP replica group."""

    def __init__(self, cfg, init_cache: Callable, *, capacity: int,
                 max_seq_len: int, block_size: int = 32,
                 pool_blocks: Optional[int] = None, dtype=None,
                 kv_dtype: str = "bf16", device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if kv_dtype not in VALID_KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {VALID_KV_DTYPES}, "
                             f"got {kv_dtype!r}")
        # "bf16" = keep the family's native KV dtype (the model config's
        # compute dtype, f32 in the toy configs); "int8" = QuantPages pools
        self.kv_dtype = kv_dtype
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.block_size = int(block_size)
        self.blocks_per_slot = max(1, math.ceil(max_seq_len / block_size))
        self.slot_tokens = self.blocks_per_slot * self.block_size  # S_max
        self.pool_blocks = (self.capacity * self.blocks_per_slot
                            if pool_blocks is None else int(pool_blocks))
        if self.pool_blocks < self.blocks_per_slot:
            raise ValueError("pool smaller than one slot's block budget")
        self.trash_block = self.pool_blocks       # reserved garbage block

        # -- classify the family's cache layout: probe init_cache on the
        # meta device (no allocation) at two max_len values; the leaf axes
        # that grow are sequence axes and get paged, a leaf with none is
        # per-slot state.  Leaves are taken in sorted key order, the order
        # the reference's pytree flatten uses.  Growth is probed from one
        # token below the slot budget up to it: a sequence axis capped by a
        # sliding window equal to the budget still grows there (the
        # reference probes the budget and one block past it, where such an
        # axis does not grow, and then takes it for per-slot state).
        probe = lambda s: init_cache(cfg, 1, s, dtype, device="meta")
        below, lo = probe(self.slot_tokens - 1), probe(self.slot_tokens)
        self._keys: List[str] = sorted(lo)
        self._tags: List[str] = []
        paged_shapes: List[Tuple[Tuple[int, ...], torch.dtype]] = []
        state_shapes: List[Tuple[Tuple[int, ...], torch.dtype]] = []
        for key in self._keys:
            a, b = lo[key], below[key]
            if _is_len_leaf(a):
                self._tags.append(_LEN)
                continue
            grown = [d for d in range(a.ndim) if a.shape[d] != b.shape[d]]
            if not grown:
                if a.ndim < 2 or a.shape[1] != 1:
                    raise ValueError(f"state leaf {key!r} {tuple(a.shape)} "
                                     f"lacks a batch axis at 1")
                self._tags.append(_STATE)
                state_shapes.append((tuple(a.shape), a.dtype))
                continue
            if grown != [2] or a.ndim < 3 or a.shape[1] != 1:
                raise ValueError(
                    f"paged leaf must grow only along axis 2 (layers, "
                    f"batch, seq, ...); got {tuple(a.shape)} vs "
                    f"{tuple(b.shape)}")
            if a.shape[2] != self.slot_tokens:
                raise ValueError(f"seq axis {a.shape[2]} != arena "
                                 f"slot_tokens {self.slot_tokens}")
            self._tags.append(_PAGED)
            paged_shapes.append((tuple(a.shape), a.dtype))

        # -- device state ------------------------------------------------
        P1 = self.pool_blocks + 1                 # +1 trash block
        dev = self.device
        self.pages: List[Any] = []
        quantized: List[bool] = []
        for (A0, _, _, *rest), dt in paged_shapes:
            quant = (self.kv_dtype == "int8" and len(rest) >= 1
                     and dt.is_floating_point)
            quantized.append(quant)
            if quant:
                self.pages.append(QuantPages(
                    torch.zeros((A0, P1, self.block_size, *rest),
                                dtype=torch.int8, device=dev),
                    torch.zeros((A0, P1, self.block_size, *rest[:-1]),
                                dtype=torch.float32, device=dev)))
            else:
                self.pages.append(torch.zeros(
                    (A0, P1, self.block_size, *rest), dtype=dt, device=dev))
        self._paged_shapes = paged_shapes
        self._quantized = quantized
        self._views: Dict[int, List[torch.Tensor]] = {}  # dense_view buffers
        self.state: List[torch.Tensor] = [
            torch.zeros((A0, self.capacity, *rest), dtype=dt, device=dev)
            for (A0, _, *rest), dt in state_shapes]
        self.lens = torch.zeros((self.capacity,), dtype=torch.int32,
                                device=dev)

        # -- host bookkeeping --------------------------------------------
        self._block_tables = np.full(
            (self.capacity, self.blocks_per_slot), self.trash_block,
            np.int32)
        self._free_slots: List[int] = list(range(self.capacity))
        self._free_blocks: List[int] = list(range(self.pool_blocks))
        self._slot_blocks: Dict[int, List[int]] = {}
        self._occ = np.zeros((self.capacity,), bool)
        self._tables_dev: Optional[torch.Tensor] = None
        self._occ_dev: Optional[torch.Tensor] = None

        # -- cross-slot block sharing (prefix cache) ---------------------
        # ``_block_refs`` counts live slot references to a block;
        # ``_cached`` marks blocks registered by a prefix index (frozen:
        # any write copies first); ref-0 cached blocks wait in
        # ``_idle_cached``, an LRU by last release, and are reclaimed
        # before the allocator fails, through ``evict_hook`` so that the
        # index drops their entries
        self._block_refs = np.zeros((self.pool_blocks,), np.int32)
        self._cached: set = set()
        self._idle_cached: "OrderedDict[int, None]" = OrderedDict()
        self.evict_hook: Optional[Callable[[int], None]] = None
        self.cache_retention: Optional[int] = None  # max idle cached blocks
        self.cached_evictions = 0     # idle cached blocks reclaimed
        self.parks = 0                # preemption block-table parks
        self.parked_blocks = 0        # blocks held by parked requests
        self.cow_copies = 0           # copy-on-write block copies
        self.cow_calls = 0            # batched copy dispatches

        # bytes one cache token occupies across all paged leaves; a
        # quantized leaf counts 1 byte per value plus its f32 row scale
        self.token_bytes = 0
        for ((A0, _, _, *rest), dt), q in zip(paged_shapes, quantized):
            n = int(np.prod([A0, *rest]))
            if q:
                self.token_bytes += n + int(np.prod([A0, *rest[:-1]])) * 4
            else:
                self.token_bytes += n * dt.itemsize
        # and the fixed per-slot state footprint
        self.state_slot_bytes = sum(
            int(np.prod([A0, *rest])) * dt.itemsize
            for (A0, _, *rest), dt in state_shapes)

    # ------------------------------------------------------------------
    # allocator surface
    # ------------------------------------------------------------------
    def blocks_for(self, total_tokens: int) -> int:
        return max(1, math.ceil(total_tokens / self.block_size))

    @property
    def free_capacity(self) -> int:
        """Blocks the allocator can hand out without failing: the free
        list plus every reclaimable (ref-0 cached) block."""
        return len(self._free_blocks) + len(self._idle_cached)

    def can_alloc(self, total_tokens: int, *, shared: Sequence[int] = (),
                  reserve: int = 0) -> bool:
        """Admission feasibility.  ``shared`` lists the cached blocks a
        prefix hit would stitch in: they lower the demand for fresh blocks,
        and idle ones leave the reclaimable supply (the hit revives them).
        ``reserve`` asks for extra claimable headroom (the divergence copy a
        partial-tail share will need)."""
        shared = list(shared)
        idle_shared = sum(1 for b in shared if b in self._idle_cached)
        claimable = (len(self._free_blocks) + len(self._idle_cached)
                     - idle_shared)
        return (bool(self._free_slots)
                and (self.blocks_for(total_tokens) - len(shared) + reserve
                     <= claimable)
                and total_tokens <= self.slot_tokens)

    def _reclaim_lru_block(self) -> None:
        """Return the least recently released idle cached block to the free
        list.  The block is appended before the hook fires: the hook's
        ``unregister`` calls (subtree drops) must see it freed already, or
        they would append it twice."""
        blk, _ = self._idle_cached.popitem(last=False)
        self._cached.discard(blk)
        self.cached_evictions += 1
        self._free_blocks.append(blk)
        if self.evict_hook is not None:
            self.evict_hook(blk)

    def _claim_blocks(self, n: int) -> List[int]:
        """Pop ``n`` blocks off the free list, reclaiming idle cached
        blocks in LRU order when it runs short."""
        while len(self._free_blocks) < n and self._idle_cached:
            self._reclaim_lru_block()
        if len(self._free_blocks) < n:
            raise RuntimeError("arena out of blocks")
        return [self._free_blocks.pop(0) for _ in range(n)]

    def alloc(self, total_tokens: int, slot: Optional[int] = None, *,
              shared: Sequence[int] = ()) -> int:
        """Claim a slot and its token blocks for a request whose lifetime
        needs ``total_tokens`` (prompt + generation budget).  ``shared``
        stitches resident physical blocks (a cached prompt prefix) into the
        front of the slot's table in place of fresh ones: each one's
        refcount rises, and idle cached ones leave the LRU."""
        if total_tokens > self.slot_tokens:
            raise ValueError(
                f"request needs {total_tokens} tokens > arena slot budget "
                f"{self.slot_tokens} (raise max_seq_len)")
        n = self.blocks_for(total_tokens)
        shared = list(shared)
        if len(shared) > n:
            raise ValueError(
                f"{len(shared)} shared prefix blocks exceed the request's "
                f"{n}-block budget")
        # incref the shared prefix first, so that the claim below can never
        # reclaim a block the hit is about to use
        for b in shared:
            if self._block_refs[b] == 0:
                self._idle_cached.pop(b, None)
            self._block_refs[b] += 1
        try:
            fresh = self._claim_blocks(n - len(shared))
        except RuntimeError:
            for b in shared:          # undo the increfs; the caller requeues
                self._release_block(b)
            raise
        if slot is None:
            if not self._free_slots:
                for b in shared:
                    self._release_block(b)
                self._free_blocks.extend(fresh)
                raise RuntimeError("arena out of slots")
            slot = self._free_slots.pop(0)
        else:
            self._free_slots.remove(slot)
        for b in fresh:
            self._block_refs[b] = 1
        blocks = shared + fresh
        self._slot_blocks[slot] = blocks
        row = np.full((self.blocks_per_slot,), self.trash_block, np.int32)
        row[:n] = blocks
        self._block_tables[slot] = row
        self._occ[slot] = True
        self._tables_dev = self._occ_dev = None
        return slot

    def reset_len(self, slot: int) -> None:
        """Zero a slot's device-side length: chunked admissions call this
        after ``alloc`` so the first chunk starts at 0, not at the previous
        tenant's length."""
        self.set_len(slot, 0)

    def set_len(self, slot: int, n: int) -> None:
        """Set a slot's device-side length; a prefix hit admits with the
        hit's token count, so chunked prefill resumes past it."""
        self.lens[slot] = n

    def _release_block(self, block: int) -> None:
        """Drop one slot reference; a ref-0 block joins the idle LRU if a
        prefix index still holds it, else returns to the free list."""
        self._block_refs[block] -= 1
        if self._block_refs[block] > 0:
            return
        self._block_refs[block] = 0
        if block in self._cached:
            self._idle_cached.pop(block, None)
            self._idle_cached[block] = None       # most recently released
        else:
            self._free_blocks.append(block)

    def free(self, slot: int) -> None:
        """Release a slot: pure free-list bookkeeping, zero device work.
        Blocks shared with other slots, or held by a prefix index, stay;
        only the last reference returns a block to circulation."""
        if not self._occ[slot]:
            return
        for b in self._slot_blocks.pop(slot):
            self._release_block(b)
        self._block_tables[slot] = self.trash_block
        self._occ[slot] = False
        self._free_slots.append(slot)
        self._tables_dev = self._occ_dev = None
        self._enforce_retention()

    # ------------------------------------------------------------------
    # preemption: block-table parking
    # ------------------------------------------------------------------
    @property
    def parkable(self) -> bool:
        """Parking freezes only a slot's blocks; per-slot state rows are
        overwritten by the slot's next tenant, so a layout with any cannot
        park."""
        return not self.state

    def park(self, slot: int) -> List[int]:
        """Free a live slot without releasing its blocks: the caller now
        holds the slot's references and the K/V stays resident.  A resume
        hands them back through ``alloc(total, shared=blocks)`` and then
        ``release_parked``, which leaves the refcounts as they were."""
        if not self._occ[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        if not self.parkable:
            raise ValueError(
                "arena carries per-slot state leaves; parking would "
                "destroy them on slot reuse")
        blocks = self._slot_blocks.pop(slot)
        self._block_tables[slot] = self.trash_block
        self._occ[slot] = False
        self._free_slots.append(slot)
        self._tables_dev = self._occ_dev = None
        self.parks += 1
        self.parked_blocks += len(blocks)
        return blocks

    def release_parked(self, blocks: Sequence[int]) -> None:
        """Drop a parked hold: after a resume's ``alloc(shared=blocks)``,
        or to abandon a parked request (cached blocks then join the idle
        LRU, private ones the free list)."""
        for b in blocks:
            self._release_block(b)
        self.parked_blocks -= len(blocks)
        self._enforce_retention()

    # ------------------------------------------------------------------
    # prefix-cache surface: registration, retention, copy-on-write
    # ------------------------------------------------------------------
    def register(self, block: int) -> None:
        """Mark a block as held by a prefix index: its content is frozen
        (writers copy first) and it outlives its slots on the idle LRU
        until reclaimed or shared again."""
        self._cached.add(block)

    def unregister(self, block: int) -> None:
        """The prefix index dropped its entry: an idle block returns to the
        free list, a live one only stops being frozen."""
        self._cached.discard(block)
        if block in self._idle_cached:
            del self._idle_cached[block]
            self._free_blocks.append(block)

    def _enforce_retention(self) -> None:
        """Cap the idle cached blocks at ``cache_retention`` (the
        category's knob)."""
        if self.cache_retention is None:
            return
        while len(self._idle_cached) > self.cache_retention:
            self._reclaim_lru_block()

    def block_ref(self, block: int) -> int:
        return int(self._block_refs[block])

    def is_cached(self, block: int) -> bool:
        return block in self._cached

    def cow_block(self, slot: int, logical: int) -> bool:
        """Give ``slot`` a private copy of its ``logical``-th block if that
        block is shared with another slot or frozen by a prefix index.
        True when a copy happened."""
        return self.cow_blocks([(slot, logical)]) > 0

    def cow_blocks(self, pairs: Sequence[Tuple[int, int]]) -> int:
        """Copy-on-write for several (slot, logical block) targets at once:
        one indexed copy over every pool tensor, an int8 pool's scales with
        its values.  Blocks a slot owns alone and unfrozen are skipped.
        Returns the number of blocks copied."""
        # decide without mutating: which targets need a private copy (two
        # sharers of one source both do)
        needed: List[Tuple[int, int, int]] = []   # (slot, logical, phys)
        for slot, logical in pairs:
            phys = int(self._block_tables[slot][logical])
            if phys == self.trash_block:
                raise ValueError(f"slot {slot} logical block {logical} is "
                                 f"unallocated")
            if self._block_refs[phys] <= 1 and phys not in self._cached:
                continue
            needed.append((slot, logical, phys))
        if not needed:
            return 0
        # claim every destination before any table changes, so that an
        # exhausted arena raises with its bookkeeping whole (the sources
        # have live references, so the claim cannot reclaim them)
        fresh_blocks = self._claim_blocks(len(needed))
        todo: List[Tuple[int, int]] = []          # (phys, fresh)
        for (slot, logical, phys), fresh in zip(needed, fresh_blocks):
            self._block_refs[fresh] = 1
            blocks = self._slot_blocks[slot]
            blocks[blocks.index(phys)] = fresh
            self._block_tables[slot][logical] = fresh
            todo.append((phys, fresh))
        src = torch.tensor([s for s, _ in todo], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([d for _, d in todo], dtype=torch.long,
                           device=self.device)
        for pool in self.pages:
            for p in ((pool.values, pool.scales)
                      if isinstance(pool, QuantPages) else (pool,)):
                p[:, dst] = p[:, src]
        self._tables_dev = None
        for phys, _ in todo:
            self._release_block(phys)  # sole-ref cached sources go idle...
        self._enforce_retention()      # ...so the retention bound applies
        self.cow_copies += len(todo)
        self.cow_calls += 1
        return len(todo)

    def ensure_writable(self, slot: int, start: int, n_tokens: int = 1
                        ) -> int:
        """Copy-on-write every block that the write ``[start, start +
        n_tokens)`` touches and the slot does not own alone: a host check,
        free when nothing in the pool is shared or frozen, and one batched
        ``cow_blocks`` otherwise.  Returns the blocks copied."""
        if not self._cached and not (self._block_refs > 1).any():
            return 0
        lo = max(0, start) // self.block_size
        hi = max(0, start + n_tokens - 1) // self.block_size
        pairs = [(slot, logical)
                 for logical in range(lo, min(hi, self.blocks_per_slot - 1)
                                      + 1)
                 if self._block_tables[slot][logical] != self.trash_block]
        return self.cow_blocks(pairs)

    def block_tables(self) -> np.ndarray:
        """(capacity, blocks_per_slot) logical->physical block map."""
        return self._block_tables.copy()

    def occupancy(self) -> np.ndarray:
        return self._occ.copy()

    def device_block_tables(self) -> torch.Tensor:
        """Device copy of the block table, re-uploaded only after a table
        changes (alloc, free, park, copy-on-write)."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._block_tables).to(
                self.device)
        return self._tables_dev

    def device_occupancy(self) -> torch.Tensor:
        if self._occ_dev is None:
            self._occ_dev = torch.from_numpy(self._occ).to(self.device)
        return self._occ_dev

    @property
    def live(self) -> int:
        return int(self._occ.sum())

    def slot_bytes(self, prompt_len: int) -> int:
        """Bytes a one-shot admission writes: the prompt's pages (whole
        blocks) plus the slot's fixed state."""
        blocks = self.blocks_for(max(1, prompt_len))
        return (blocks * self.block_size * self.token_bytes
                + self.state_slot_bytes)

    def chunk_bytes(self, n_tokens: int) -> int:
        """Bytes one chunked-prefill call writes: exactly the chunk's token
        rows plus the slot's fixed state row."""
        return n_tokens * self.token_bytes + self.state_slot_bytes

    # ------------------------------------------------------------------
    # per-slot state
    # ------------------------------------------------------------------
    def slot_state(self, slot: int) -> List[torch.Tensor]:
        """Views ``(layers, 1, ...)`` of one slot's state rows: a step that
        writes into them writes into the arena."""
        return [s[:, slot:slot + 1] for s in self.state]

    def zero_state(self, slot: int) -> None:
        """Fresh state for a slot's first chunk, so a reused slot does not
        carry its previous tenant's recurrence."""
        for s in self.state:
            s[:, slot].zero_()

    # ------------------------------------------------------------------
    # cache dict <-> pools and state
    # ------------------------------------------------------------------
    def assemble(self, pages, state, lens: torch.Tensor) -> Dict[str, Any]:
        """The family's cache dict over the page pools and state tensors,
        with per-slot lengths ``lens``."""
        its = {_PAGED: iter(pages), _STATE: iter(state)}
        return {key: lens if tag == _LEN else next(its[tag])
                for key, tag in zip(self._keys, self._tags)}

    def disassemble(self, cache: Dict[str, Any]
                    ) -> Tuple[List[Any], List[torch.Tensor]]:
        """The cache dict's (page pools, state tensors)."""
        pick = lambda t: [cache[key] for key, tag in
                          zip(self._keys, self._tags) if tag == t]
        return pick(_PAGED), pick(_STATE)

    # ------------------------------------------------------------------
    # one-shot admission and the dense-view steps
    # ------------------------------------------------------------------
    def write_prefill(self, slot: int, cache: Dict[str, Any],
                      prompt_len: int) -> int:
        """Scatter one freshly prefilled single-request cache (batch 1, its
        sequence axis at least the prompt's blocks) into the slot's pages
        and state row, in place.  Only the blocks the prompt occupies are
        written (quantized on write for an int8 pool); positions past the
        prompt are garbage until a step reaches them, and the per-slot
        length masks them everywhere.  The slot's length becomes the
        cache's own ``len``.  Returns the bytes written (admission-copy
        accounting)."""
        n_blocks = self.blocks_for(max(1, prompt_len))
        rows = n_blocks * self.block_size
        bt_row = torch.from_numpy(
            self._block_tables[slot][:n_blocks].astype(np.int64)).to(
            self.device)
        pages, state = iter(self.pages), iter(self.state)
        cache_len = None
        for key, tag in zip(self._keys, self._tags):
            leaf = cache[key]
            if tag == _LEN:
                if cache_len is None:
                    cache_len = leaf.reshape(-1)[0]
            elif tag == _PAGED:
                pool = next(pages)
                A0, _, _, *rest = leaf.shape
                blocks = leaf[:, 0, :rows].reshape(A0, n_blocks,
                                                   self.block_size, *rest)
                if isinstance(pool, QuantPages):
                    qv, qs = quantize(blocks)
                    pool.values[:, bt_row] = qv
                    pool.scales[:, bt_row] = qs
                else:
                    pool[:, bt_row] = blocks.to(pool.dtype)
            else:
                st = next(state)
                st[:, slot] = leaf[:, 0].to(st.dtype)
        self.lens[slot] = prompt_len if cache_len is None else cache_len
        return self.slot_bytes(prompt_len)

    def dense_view(self, pages, block_tables: torch.Tensor
                   ) -> List[torch.Tensor]:
        """Gather each page pool through ``block_tables`` (B, nblk) into a
        contiguous ``(layers, B, slot_tokens, ...)`` view in the leaf's own
        dtype; an int8 pool's values and scales are dequantized.  The views
        are the arena's buffers for B rows, gathered into in place layer by
        layer: the next ``dense_view`` of B rows overwrites them, and no
        other copy of the pools is made."""
        B = block_tables.shape[0]
        flat = block_tables.reshape(-1).long()
        views = self._views.get(B)
        if views is None:
            views = [torch.empty((A0, B, self.slot_tokens, *rest), dtype=dt,
                                 device=self.device)
                     for (A0, _, _, *rest), dt in self._paged_shapes]
            self._views[B] = views
        for pool, view in zip(pages, views):
            for layer in range(view.shape[0]):
                out = view[layer].view(flat.shape[0], self.block_size,
                                       *view.shape[3:])
                if isinstance(pool, QuantPages):
                    out.copy_(dequantize(
                        pool.values[layer].index_select(0, flat),
                        pool.scales[layer].index_select(0, flat),
                        view.dtype))
                else:
                    torch.index_select(pool[layer], 0, flat, out=out)
        return views

    def append_rows(self, pages, dense_new, lens: torch.Tensor,
                    live: torch.Tensor, block_tables: torch.Tensor, *,
                    n_tokens: int = 1, valid_tokens=None) -> None:
        """Write each live slot's newly produced cache rows from the dense
        view ``dense_new`` back into its pages, in place: ``n_tokens``
        consecutive rows per slot starting at ``lens`` (B,), of which the
        first ``valid_tokens`` (B,) (default all) are real.  Rows of dead
        slots and padding rows route to the trash block, the only place
        two rows can land on; an int8 pool quantizes the rows on write."""
        cap = lens.shape[0]
        bs = self.block_size
        dev = lens.device
        offs = torch.arange(n_tokens, device=dev)
        pos = (lens.long()[:, None] + offs[None]).clamp(
            0, self.slot_tokens - 1)                          # (cap, T)
        blk = torch.gather(block_tables.long(), 1, pos // bs)
        flat = blk * bs + pos % bs
        ok = live.bool()[:, None].expand(cap, n_tokens)
        if valid_tokens is not None:
            ok = ok & (offs[None] < valid_tokens.reshape(-1, 1))
        flat = torch.where(ok, flat, self.trash_block * bs).reshape(-1)
        slots = torch.arange(cap, device=dev)[:, None].expand(cap, n_tokens)
        for pool, d in zip(pages, dense_new):
            A0, P1, _, *rest = pool.shape
            row = d[:, slots, pos].reshape(A0, cap * n_tokens, *rest)
            if isinstance(pool, QuantPages):
                qv, qs = quantize(row)
                pool.values.view(A0, P1 * bs, *rest)[:, flat] = qv
                pool.scales.view(A0, P1 * bs, *rest[:-1])[:, flat] = qs
            else:
                pool.view(A0, P1 * bs, *rest)[:, flat] = row.to(pool.dtype)

    def merge_state(self, state, state_new, live: torch.Tensor) -> None:
        """Commit a step's per-slot state for the live slots only, in place.
        The port's steps write their state in place and keep dead slots'
        rows themselves, so a leaf they return as the arena's own tensor is
        already committed; any other is copied in under the mask."""
        for old, new in zip(state, state_new):
            if new is old:
                continue
            mask = live.bool().reshape(1, self.capacity,
                                       *([1] * (old.ndim - 2)))
            old.copy_(torch.where(mask, new.to(old.dtype), old))
