"""Radix prefix cache: shared-prefix KV reuse over the paged arena.

EPARA's frequency-sensitive category is dominated by periodic requests
repeating the same system/prompt prefix (sensor pipelines, templated LLM
calls); re-prefilling that prefix on every admission wastes the dominant
share of prompt compute.  ``RadixPrefixCache`` indexes the arena's
physical blocks by their *token content* so a new admission can stitch
the longest cached prefix straight into its block table and start chunked
prefill after the hit boundary.

Structure
---------
* **Radix tree keyed on block-aligned token runs.**  Each node is one
  FULL block of ``block_size`` prompt tokens; a node's children are keyed
  by the next block's token tuple (the dict hash is the "block-aligned
  token hash"; the stored tuple disambiguates collisions exactly).  A
  path root→node therefore spells a block-aligned prompt prefix and
  carries the physical block ids holding its KV.
* **Partial tails.**  A prompt's final sub-block run (``len % block_size``
  tokens) is indexed on its deepest full-block node.  A lookup may match
  into a partial tail; the sharer then *must* copy-on-write that block
  before its own writes land in it (``KVArena.ensure_writable``), because
  other slots — or the frozen cache entry itself — still read it.  This
  is the divergence-point COW: two prompts that agree mid-block share the
  block read-only and fork private copies the moment they diverge.
* **Lifetime.**  The cache never owns device memory: blocks belong to the
  arena.  ``insert`` registers live slots' prompt blocks
  (``arena.register`` freezes them — any writer COWs); when the last slot
  referencing a block dies the block parks on the arena's LRU of
  idle-but-cached blocks, and the allocator reclaims LRU-first under
  pressure, calling back ``_on_evict`` so the index drops the evicted
  block's node *and its whole subtree* (a chain with a missing interior
  block is unreachable and would pin memory).

Safety
------
Only cache layouts whose paged content is a pure function of the prompt
token ids may share blocks: families with per-slot state leaves (SSM /
hybrid conv state, enc-dec cross-KV) or non-token inputs (VLM image
prefix, audio embeddings) are rejected by the engine's gate.  Blocks
holding *generated* tokens are never indexed.  A full-prompt hit is
capped at ``len(prompt) - 1`` tokens so at least one token is always
computed — the final chunk's logits seed the first sampled token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TokenRun = Tuple[int, ...]


@dataclasses.dataclass
class PrefixHit:
    """Result of one lookup: the physical blocks to stitch into the new
    slot's table (full-block matches first, then at most one partial-tail
    block), and how many prompt tokens they cover."""
    blocks: List[int]
    tokens: int                  # hit boundary: cached prompt tokens
    full_blocks: int             # leading entries of ``blocks`` fully used
    partial_valid: int           # matched tokens inside the trailing
    #                              partial block (0 = no partial share)


class _Node:
    __slots__ = ("tokens", "block", "children", "partials", "parent")

    def __init__(self, tokens: TokenRun, block: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.block = block                      # physical arena block
        self.parent = parent
        self.children: Dict[TokenRun, "_Node"] = {}
        self.partials: Dict[TokenRun, int] = {}  # tail tokens -> block


class RadixPrefixCache:
    """Prefix index for ONE ``KVArena`` (one DP replica group).

    The cache installs itself as the arena's ``evict_hook`` and sets the
    arena's idle-cache retention bound (the ``ParallelPlan.prefix_cache``
    category knob: latency plans bound retention, frequency plans retain
    aggressively)."""

    def __init__(self, arena, *, retention_blocks: Optional[int] = None):
        self.arena = arena
        self.block_size = int(arena.block_size)
        self.root = _Node((), -1, None)
        # physical block -> ("full", node) | ("partial", node, tail_key)
        self._by_block: Dict[int, tuple] = {}
        arena.evict_hook = self._on_evict
        arena.cache_retention = retention_blocks
        # telemetry
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.inserted_blocks = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._by_block)

    @staticmethod
    def _toks(tokens: Sequence[int]) -> TokenRun:
        return tuple(int(t) for t in tokens)

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> PrefixHit:
        """Longest cached prefix of ``tokens``, capped at
        ``len(tokens) - 1`` so the admission always computes at least the
        final prompt position (its logits seed sampling)."""
        bs = self.block_size
        toks = self._toks(tokens)
        cap = len(toks) - 1
        node, blocks, pos = self.root, [], 0
        while pos + bs <= cap:
            child = node.children.get(toks[pos:pos + bs])
            if child is None:
                break
            node = child
            blocks.append(child.block)
            pos += bs
        full = len(blocks)
        partial_valid = 0
        if pos < cap and node.partials:
            rest = toks[pos:]
            best_key, best_m = None, 0
            for key, blk in node.partials.items():
                m = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    m += 1
                m = min(m, cap - pos)
                if m > best_m:
                    best_key, best_m = key, m
            if best_key is not None:
                blocks.append(node.partials[best_key])
                partial_valid = best_m
        return PrefixHit(blocks=blocks, tokens=full * bs + partial_valid,
                         full_blocks=full, partial_valid=partial_valid)

    def record(self, hit: Optional[PrefixHit], prompt_len: int) -> None:
        """Telemetry for one ADMITTED request (lookups are pure so a
        requeued admission does not double-count)."""
        self.lookups += 1
        tokens = hit.tokens if hit is not None else 0
        if tokens > 0:
            self.hits += 1
            self.hit_tokens += tokens
        self.miss_tokens += prompt_len - tokens

    def note_resume(self, cache_tokens: int) -> None:
        """Telemetry for a preempted request resuming onto its parked
        blocks (serving/admission.py): the whole parked content — prompt
        AND generated KV — is served from resident blocks, the cache's
        best case.  Counted as a full hit so the reuse telemetry (and the
        engine's hit-rate EWMA inputs) reflect what parking saved."""
        self.lookups += 1
        self.hits += 1
        self.hit_tokens += cache_tokens

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], block_row: "np.ndarray", *,
               include_partial: bool = True) -> int:
        """Index a fully prefilled prompt: walk/extend the radix chain for
        its full blocks and register its partial tail (if any) on the
        deepest node.  ``block_row`` is the slot's block-table row — entry
        ``i`` physically holds prompt tokens ``[i*bs, (i+1)*bs)``.  If a
        chain node already exists for some block's tokens (another prompt
        cached the same content first) the existing block wins and ours
        stays a private, uncached copy.  Returns newly indexed blocks.

        ``include_partial=False`` indexes only the full blocks: the engine
        uses it at prefill completion, when the owner's generation is
        still going to append INTO the partial tail block — registering it
        then would force the owner to COW its own tail.  The tail is
        indexed by a second insert at slot eviction, once its content is
        final."""
        bs = self.block_size
        toks = self._toks(tokens)
        node, pos, bi, added = self.root, 0, 0, 0
        while pos + bs <= len(toks):
            key = toks[pos:pos + bs]
            child = node.children.get(key)
            if child is None:
                blk = int(block_row[bi])
                child = _Node(key, blk, node)
                node.children[key] = child
                self._by_block[blk] = ("full", child)
                self.arena.register(blk)
                self.inserted_blocks += 1
                added += 1
            node = child
            pos += bs
            bi += 1
        rem = toks[pos:]
        if include_partial and rem and rem not in node.partials:
            blk = int(block_row[bi])
            if blk not in self._by_block:
                node.partials[rem] = blk
                self._by_block[blk] = ("partial", node, rem)
                self.arena.register(blk)
                self.inserted_blocks += 1
                added += 1
        return added

    # ------------------------------------------------------------------
    # eviction (arena -> cache callback)
    # ------------------------------------------------------------------
    def _on_evict(self, block: int) -> None:
        """The arena reclaimed ``block`` off the idle-cached LRU.  Drop
        its index entry; for a full-chain node the whole subtree below it
        becomes unreachable (its prefix chain is broken) and is
        unregistered too — live sharers keep their slots' references, the
        blocks simply stop being index-reachable."""
        ent = self._by_block.pop(block, None)
        if ent is None:
            return
        if ent[0] == "partial":
            _, node, key = ent
            node.partials.pop(key, None)
            return
        node = ent[1]
        if node.parent is not None:
            node.parent.children.pop(node.tokens, None)
        self._drop_subtree(node)

    def _drop_subtree(self, node: _Node) -> None:
        """Unregister every index entry below ``node`` (the node's own
        block was already detached by the arena's eviction sweep)."""
        stack = [node]
        while stack:
            n = stack.pop()
            for blk in n.partials.values():
                self._by_block.pop(blk, None)
                self.arena.unregister(blk)
            n.partials.clear()
            for child in n.children.values():
                self._by_block.pop(child.block, None)
                self.arena.unregister(child.block)
                stack.append(child)
            n.children.clear()
