"""Live serving engine: continuous-batching decode over persistent slots,
driven by an EPARA ``ParallelPlan`` (the port of the reference package's
``serving/engine.py``).

``ServiceRuntime`` owns one service's params and its DP replica groups.
The default ``mode="continuous"`` keeps a persistent batch of decode slots
per group; each ``step()``:

  (a) evicts slots whose request hit EOS or its own ``max_new_tokens``;
  (b) admits queued requests from the BS/MF composer into the free slots
      (``compose(limit=free)``);
  (b2) advances chunked prefill: in-progress prompts are split into
      bucket-sized chunks, at most ``prefill_chunk`` tokens per group per
      step, so a long prompt never stalls live decode slots for more than
      one chunk;
  (c) runs one fused decode step over every slot, with per-slot lengths
      and an occupancy mask, then greedy sampling.

A radix prefix cache (``serving/prefix_cache.py``) stands in front of (b)
for the prefix-cacheable families: an admission looks up the longest
cached prefix of its prompt and stitches its blocks into the new slot's
table (``arena.alloc(shared=...)``), so (b2) starts past the hit.  A write
into a shared or frozen block copies it first (``arena.ensure_writable``;
a wave's divergence copies go in one ``arena.cow_blocks``).  Retention
follows the task category (``ParallelPlan.prefix_cache``), and the hit,
copy and eviction counts go into ``StepStats``.

Two cache data planes back the slot loop (``kvcache_impl``):

* ``"paged"`` (default): a fixed-capacity ``KVArena`` per group.
  Attention families step paged-native (``prefill_chunk_paged``/
  ``decode_step_paged`` read and write the page pools in place through the
  block tables).  The others step over a dense view: pure-SSM families
  (all per-slot state), ring (sliding-window) layouts, whose window is per
  slot state and whose prompts prefill in one shot at admission
  (``ring_fallback``), and ``paged_native=False``, the reference's test
  oracle for the native step.  The dense-view step gathers the slots'
  pages (``arena.dense_view``), runs the family's dense ``prefill_chunk``
  (the dense chunk-attention kernel) or ``decode_step`` on it, and writes
  the new rows back (``arena.append_rows``).  ``chunked_prefill=False``
  prefills each admission in one shot and scatters its pages
  (``arena.write_prefill``).
* ``"dense"``: the pre-arena path.  Each admission prefills in one shot
  and ``kvcache.merge`` copies the whole live cache to join it; eviction
  compacts it with ``kvcache.select_slots``.

``mode="sync"`` is the run-to-completion baseline: each step composes one
batch, left-pads its prompts with token 0 (no mask: a short prompt attends
to its pads, as in the reference), prefills it in one shot and decodes it
to its longest request's budget.

Stateful plans (``plan.sticky``) pin each session to one DP group from its
admission until its last request leaves.  The first chunk of a request
starts from zeroed state rows; for the audio family it also carries the
request's frame embeddings (``extras["embeddings"]``), from which the
encoder-decoder projects the slot's cross-attention K/V state.

Not ported (constructor arguments that ask for them raise, naming the
``ROADMAP.md`` item): SDF admission and parking preemption, speculative
decoding and n-way forks, stochastic sampling.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.allocator import DPGroupRouter, ParallelPlan
from repro_torch.device import resolve_device
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi, model_api

from . import kvcache
from .arena import KVArena
from .batching import ComposedBatch, QueuedItem, make_composer
from .prefix_cache import PrefixHit, RadixPrefixCache
from .sampler import SamplerConfig, sample_per_slot

DEFAULT_MAX_SEQ_LEN = 256
DEFAULT_BLOCK_SIZE = 32

# Families whose paged K/V is a pure function of the prompt's token ids,
# which cross-request block sharing needs: SSM and hybrid carry per-slot
# recurrent state a shared prefix cannot rebuild, and the encoder-decoder
# and VLM caches depend on inputs other than tokens.
PREFIX_CACHEABLE_FAMILIES = ("dense", "moe")


@dataclasses.dataclass
class GenerationRequest:
    rid: int
    tokens: np.ndarray               # prompt (L,) int32
    max_new_tokens: int = 16
    stream: int = 0
    extras: Optional[Dict[str, Any]] = None   # e.g. frame embeddings
    eos_token: Optional[int] = None  # evict the slot early on this token
    seed: Optional[int] = None       # sampling stream seed (None -> rid)
    n_samples: int = 1               # > 1 (n-way forks) is not ported yet


@dataclasses.dataclass
class GenerationResult:
    rid: int
    tokens: np.ndarray               # generated ids (n,)
    prefill_s: float                 # this request's own prefill wall time
    decode_s: float                  # first token -> finish wall time
    group: int
    admitted_s: float = 0.0          # logical clock at admission
    finished_s: float = 0.0          # logical clock at eviction
    decode_steps: int = 0            # fused steps this request took part in


@dataclasses.dataclass
class StepStats:
    """One scheduling round's telemetry (the fields this path fills)."""
    results: List[GenerationResult]
    now: float = 0.0
    admitted: int = 0                # requests admitted this step
    evicted: int = 0                 # slots released this step
    in_flight: int = 0               # occupied slots after the step
    pending: int = 0                 # queued requests after the step
    queue_time_s: float = 0.0        # est. wait for a new arrival
    admission_copy_bytes: int = 0    # cache bytes copied by admissions and
    #                                  the dense impl's eviction compaction
    chunk_write_bytes: int = 0       # cache bytes written by chunked prefill
    whole_cache_copies: int = 0      # live-batch copies (dense merge or
    #                                  select_slots compaction)
    decode_steps: int = 0            # fused decode invocations this step
    prefill_chunk_tokens: int = 0    # prompt tokens prefilled this step
    oneshot_prefills: int = 0        # admissions prefilled in one shot
    moe_dropped_tokens: float = 0.0  # MoE expert-capacity drops this step
    #                                  (token-assignments past capacity;
    #                                  nonzero under binding capacity, where
    #                                  chunked prefill may diverge)
    prefix_lookups: int = 0          # prefix-cache lookups this step
    prefix_hits: int = 0             # admissions that reused cached blocks
    prefix_hit_tokens: int = 0       # prompt tokens served from the cache
    prefix_evicted_blocks: int = 0   # cached blocks reclaimed (LRU) this step
    prefix_cow_blocks: int = 0       # copy-on-write block copies this step


class _Slot:
    """One in-flight request occupying a decode slot (``slot_id`` is its
    arena slot, its row in the block table).  It starts with
    ``prefilling=True`` while ``consumed`` prompt tokens are written chunk
    by chunk, and flips into decoding via ``begin_decode`` when the final
    chunk's logits yield the first token."""
    __slots__ = ("req", "emitted", "done", "prefill_s", "admit_wall",
                 "decode_start_wall", "finish_wall", "admitted_s", "steps",
                 "slot_id", "prefilling", "consumed")

    def __init__(self, req: GenerationRequest, admit_wall: float,
                 admitted_s: float, slot_id: int):
        self.req = req
        self.prefill_s = 0.0
        self.admit_wall = admit_wall
        self.decode_start_wall = admit_wall
        self.finish_wall = 0.0
        self.admitted_s = admitted_s
        self.steps = 0
        self.slot_id = slot_id
        self.consumed = 0                   # prompt tokens prefilled so far
        #                                     (a prefix hit starts past 0)
        self.prefilling = True
        self.emitted: List[int] = []
        self.done = False

    def begin_decode(self, first_token: int, wall: float) -> None:
        """First token sampled: prefill completed at ``wall``."""
        self.prefilling = False
        self.emitted = [first_token]
        self.decode_start_wall = wall
        self.done = (len(self.emitted) >= self.req.max_new_tokens
                     or (self.req.eos_token is not None
                         and first_token == self.req.eos_token))
        if self.done:
            self.finish_wall = wall

    def push(self, token: int) -> None:
        self.emitted.append(token)
        if (len(self.emitted) >= self.req.max_new_tokens
                or (self.req.eos_token is not None
                    and token == self.req.eos_token)):
            self.done = True
            self.finish_wall = time.perf_counter()


class _GroupState:
    """Persistent in-flight state of one DP replica group: its slots and
    either a ``KVArena`` (paged, with its prefix index when the cache is
    on) or a compacted cache dict (dense)."""
    __slots__ = ("slots", "arena", "prefix", "cache")

    def __init__(self):
        self.arena: Optional[KVArena] = None
        self.prefix: Optional[RadixPrefixCache] = None
        self.cache: Optional[Dict[str, Any]] = None   # dense impl only
        self.slots: List[_Slot] = []

    @property
    def live(self) -> int:
        return len(self.slots)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md Queue 1 "
        f"{item})")


class ServiceRuntime:
    """One deployed service: params + plan + DP groups of decode slots.

    ``params`` must lie on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, cfg: ModelConfig, params, plan: ParallelPlan, *,
                 sampler: SamplerConfig = SamplerConfig(),
                 mode: str = "continuous", kvcache_impl: str = "paged",
                 max_seq_len: int = DEFAULT_MAX_SEQ_LEN,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 pool_blocks: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[Any] = None,
                 paged_native: Optional[bool] = None,
                 admission_policy: Optional[str] = None,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 speculate: Optional[int] = None, device=None):
        if mode not in ("continuous", "sync"):
            raise ValueError(f"mode must be continuous|sync, got {mode!r}")
        if kvcache_impl not in ("paged", "dense"):
            raise ValueError(
                f"kvcache_impl must be paged|dense, got {kvcache_impl!r}")
        # dense caches are never quantized: an EXPLICIT int8 ask on a dense
        # engine is a config error, the category's default keeps the
        # model's dtype there
        if plan.kv_dtype == "int8" and kvcache_impl != "paged":
            raise ValueError(
                "kv_dtype='int8' requires kvcache_impl='paged' (only page "
                "pools are block-quantized); dense caches keep the model's "
                "native dtype")
        self.api: ModelApi = model_api(cfg)
        if (admission_policy or plan.admission) != "fifo":
            raise _not_ported("admission policy "
                              f"{admission_policy or plan.admission!r}",
                              "item 3")
        if (draft_params is not None or draft_cfg is not None
                or (speculate or 0) > 0 or plan.speculate > 0):
            raise _not_ported("speculative decoding", "item 4")
        if sampler.temperature > 0.0:
            raise _not_ported("stochastic sampling", "item 7")
        self.device = resolve_device(device)
        leaf = params["embed"]["embedding"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params lie on {leaf.device}, runtime device "
                             f"is {self.device}")
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.mode = mode
        self.kvcache_impl = kvcache_impl
        self.kv_dtype = (plan.resolved_kv_dtype() if kvcache_impl == "paged"
                         else "bf16")
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.pool_blocks = pool_blocks
        self.sampler = sampler
        self.router = DPGroupRouter(plan)
        self.composer = make_composer(plan)
        self.groups: Dict[int, _GroupState] = {
            g: _GroupState() for g in range(max(1, plan.dp))}
        self.decode_steps = 0        # fused decode invocations (all groups)
        self.admission_copy_bytes = 0  # cache bytes copied by admissions
        self.chunk_write_bytes = 0   # fresh rows appended by chunked prefill
        self.whole_cache_copies = 0  # admissions/evictions that copied the
        #                              live batch (dense impl)
        self.prefill_chunk_calls = 0  # chunk invocations (all groups)
        self.prefill_tokens_computed = 0  # prompt tokens run through prefill
        self.oneshot_prefills = 0    # admissions via one-shot prefill
        self._session_refs: Dict[int, int] = {}  # sticky session -> requests
        self._service_ewma_s = 0.0   # EWMA of per-request service time
        self._prefix_hit_ewma = 0.0  # EWMA of cached-prompt-token fraction
        self._moe_stats = None
        if cfg.family == "moe":
            # expert-capacity drop observability: chunked prefill changes
            # the routing-group granularity, so divergence under binding
            # capacity shows up as a nonzero drop counter (global per
            # process; read once per step, see models/moe.py)
            moe.enable_drop_counter(True)
            self._moe_stats = moe.MOE_DROP_STATS

        # ring (sliding-window) layouts: a window shorter than the slot
        # budget is a per-slot ring of the last ``window`` tokens, which
        # the linear chunk writes do not model, so they keep one-shot
        # admission prefill and the dense-view step
        ring = (cfg.sliding_window is not None
                and cfg.sliding_window < self.slot_token_budget)
        # attention families step paged-native; pure-SSM families (all
        # per-slot state) and ring layouts keep the dense-view step, and
        # ``paged_native=False`` forces it on an attention family: the
        # ORACLE the native step is held against
        native_ok = (mode == "continuous" and kvcache_impl == "paged"
                     and self.api.decode_step_paged is not None and not ring)
        if paged_native is None:
            paged_native = native_ok
        elif paged_native and not native_ok:
            raise ValueError(
                "paged_native requires mode='continuous', "
                "kvcache_impl='paged', a family with paged-native entry "
                f"points (not {cfg.family!r} with ring={ring}): pure-SSM "
                "families and ring (sliding-window) layouts keep the "
                "state/dense-view path")
        self.paged_native = bool(paged_native)
        if chunked_prefill is None:
            chunked_prefill = (mode == "continuous"
                               and kvcache_impl == "paged" and not ring)
        elif chunked_prefill:
            if mode != "continuous" or kvcache_impl != "paged":
                raise ValueError("chunked_prefill requires "
                                 "mode='continuous' + kvcache_impl='paged'")
            if ring:
                raise ValueError("chunked_prefill does not support ring "
                                 "(sliding-window) cache layouts")
        self.chunked_prefill = bool(chunked_prefill)
        # ring layouts take the one-shot path: an explicit, counted state
        # (StepStats.oneshot_prefills)
        self.ring_fallback = bool(ring and mode == "continuous"
                                  and kvcache_impl == "paged"
                                  and not self.chunked_prefill)

        explicit_chunk = (prefill_chunk if prefill_chunk is not None
                          else (plan.prefill_chunk or None))
        if explicit_chunk is not None:
            chunk = int(explicit_chunk)
            if chunk <= 0 or chunk % block_size:
                raise ValueError(
                    f"prefill_chunk must be a positive multiple of "
                    f"block_size={block_size}, got {chunk}")
        else:
            chunk = plan.prefill_chunk_tokens(block_size)
        self.prefill_chunk_tokens = min(chunk, self.slot_token_budget)
        self.chunk_buckets = self._derive_buckets(self.prefill_chunk_tokens)

        # -- prefix cache: -1 = the category's retention, 0 = off, > 0 =
        # that many idle cached blocks.  The plan's value is a default that
        # a path which cannot cache turns off; an explicit ask raises there
        if prefix_cache is None:
            knob = plan.prefix_cache
            explicit_prefix = False
        else:
            knob = (-1 if prefix_cache is True
                    else 0 if prefix_cache is False else int(prefix_cache))
            if knob < -1:
                raise ValueError(
                    f"prefix_cache must be -1 (category default), 0 "
                    f"(disabled) or a positive retention block count; got "
                    f"{knob}")
            explicit_prefix = knob != 0
        cacheable = (mode == "continuous" and kvcache_impl == "paged"
                     and self.chunked_prefill
                     and cfg.family in PREFIX_CACHEABLE_FAMILIES)
        if explicit_prefix and not cacheable:
            raise ValueError(
                "prefix_cache requires mode='continuous', "
                "kvcache_impl='paged', chunked prefill (so hits resume "
                f"mid-prompt) and a family in {PREFIX_CACHEABLE_FAMILIES} "
                "(paged KV must be a pure function of prompt tokens); got "
                f"family={cfg.family!r}, mode={mode!r}, "
                f"kvcache_impl={kvcache_impl!r}, "
                f"chunked_prefill={self.chunked_prefill}")
        self._prefix_knob = knob
        self.prefix_cache_enabled = bool(cacheable and knob != 0)

    @property
    def slot_token_budget(self) -> int:
        """Cache tokens one arena slot can hold (block-rounded
        ``max_seq_len``); a request's prompt + max_new must fit."""
        blocks = max(1, -(-self.max_seq_len // self.block_size))
        return blocks * self.block_size

    def _derive_buckets(self, chunk: int):
        """Static chunk shapes: power-of-two multiples of ``block_size`` up
        to the category's chunk size.  The smallest bucket is always one
        block, so a final partial chunk never overshoots the slot budget."""
        buckets, b = [], self.block_size
        while b < chunk:
            buckets.append(b)
            b *= 2
        buckets.append(chunk)
        return tuple(sorted(set(buckets)))

    def _pick_bucket(self, remaining: int,
                     budget: Optional[int] = None) -> Optional[int]:
        """Largest bucket that fits the remaining prompt, else the smallest
        (one-block) bucket for the final partial chunk, never exceeding
        the step's remaining token ``budget`` (None when the budget cannot
        afford even the smallest bucket: the chunk waits a step)."""
        affordable = (self.chunk_buckets if budget is None else
                      [b for b in self.chunk_buckets if b <= budget])
        if not affordable:
            return None
        for b in reversed(affordable):
            if b <= remaining:
                return b
        return affordable[0]

    # -- queue ------------------------------------------------------------
    def submit(self, req: GenerationRequest, now: float = 0.0) -> None:
        if req.n_samples > 1:
            raise _not_ported("n-way parallel sampling", "item 4")
        if self.cfg.family == "audio":
            want = (self.cfg.encoder_len, self.cfg.d_model)
            emb = (req.extras or {}).get("embeddings")
            if emb is None or tuple(np.shape(emb)) != want:
                raise ValueError(
                    f"audio request {req.rid} needs extras['embeddings'] of "
                    f"shape {want}, got "
                    f"{None if emb is None else tuple(np.shape(emb))}")
        if self.kvcache_impl == "paged" and self.mode == "continuous":
            # reject over-budget requests at the door: raising later, mid-
            # admission, would drop the composed batch's other members
            total = (len(req.tokens) + self._extra_cache_tokens()
                     + req.max_new_tokens)
            if total > self.slot_token_budget:
                raise ValueError(
                    f"request {req.rid} needs {total} cache tokens > "
                    f"per-slot budget {self.slot_token_budget}; raise "
                    f"max_seq_len")
        if self.plan.sticky and req.stream:
            self._session_refs[req.stream] = \
                self._session_refs.get(req.stream, 0) + 1
        self.composer.add(QueuedItem(payload=req, stream=req.stream,
                                     enqueued_s=now, rid=req.rid))

    def pending(self) -> int:
        return len(self.composer)

    def in_flight(self) -> int:
        return sum(g.live for g in self.groups.values())

    def total_slots(self) -> int:
        return self.plan.max_in_flight * len(self.groups)

    # -- shared helpers ---------------------------------------------------
    def _pad_prompts(self, reqs: Sequence[GenerationRequest]):
        """Left-pad the prompts with token 0 to the longest: (B, L) int32 on
        the device.  No mask goes with them: a short prompt attends to its
        pads, as in the reference."""
        L = max(len(r.tokens) for r in reqs)
        toks = np.zeros((len(reqs), L), np.int32)
        for i, r in enumerate(reqs):
            toks[i, L - len(r.tokens):] = r.tokens
        return torch.from_numpy(toks).to(self.device)

    def _build_batch(self, reqs: Sequence[GenerationRequest], toks):
        batch: Dict[str, Any] = {"tokens": toks}
        if self.cfg.family == "audio":
            batch["embeddings"] = torch.from_numpy(np.stack(
                [np.asarray(r.extras["embeddings"], np.float32)
                 for r in reqs])).to(self.device)
        return batch

    def _extra_cache_tokens(self) -> int:
        """Cache positions a request takes beyond its text prompt: the VLM
        family's image prefix (0 for every family ported so far)."""
        return self.cfg.prefix_len if self.cfg.family == "vlm" else 0

    def _req_seed(self, req: GenerationRequest) -> int:
        return req.rid if req.seed is None else int(req.seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _note_service_time(self, res: GenerationResult) -> None:
        t = max(1e-6, res.prefill_s + max(0.0, res.decode_s))
        self._service_ewma_s = (t if self._service_ewma_s == 0.0
                                else 0.8 * self._service_ewma_s + 0.2 * t)

    def queue_time_estimate(self) -> float:
        """Expected wait before a newly queued request starts decoding:
        queued request waves plus, under chunked prefill, the prompt
        backlog (queued and admitted-but-unconsumed prompt tokens drain at
        most one chunk budget per group per step).  With the prefix cache
        on, the queued prompt tokens are discounted by the observed hit
        rate; admitted ones already start past their hits."""
        if self._service_ewma_s <= 0.0:
            return 0.0
        waves = self.pending() / max(1, self.total_slots())
        if self.chunked_prefill and self.prefill_chunk_tokens > 0:
            queued = self.composer.pending_prefill_tokens()
            if self.prefix_cache_enabled:
                queued *= max(0.0, 1.0 - self._prefix_hit_ewma)
            backlog = queued + sum(len(s.req.tokens) - s.consumed
                                   for g in self.groups.values()
                                   for s in g.slots if s.prefilling)
            chunk_steps = backlog / (self.prefill_chunk_tokens
                                     * max(1, len(self.groups)))
            waves += chunk_steps / max(1, self.total_slots())
        return waves * self._service_ewma_s

    # ------------------------------------------------------------------
    # continuous mode: slot admit / chunked prefill / fused decode / evict
    # ------------------------------------------------------------------
    def _free_slots(self) -> int:
        return sum(max(0, self.plan.bs - g.live)
                   for g in self.groups.values())

    def _evict(self, group: int, state: _GroupState,
               now: float) -> List[GenerationResult]:
        """(a) Release every slot whose request finished.  Paged: a
        free-list operation per slot.  Dense: compact the cache's batch
        axis with ``select_slots`` (a whole-batch copy)."""
        keep = [i for i, s in enumerate(state.slots) if not s.done]
        if len(keep) == len(state.slots):
            return []
        results = []
        for s in state.slots:
            if not s.done:
                continue
            res = GenerationResult(
                rid=s.req.rid, tokens=np.asarray(s.emitted, np.int32),
                prefill_s=s.prefill_s,
                decode_s=max(0.0, s.finish_wall - s.decode_start_wall),
                group=group, admitted_s=s.admitted_s, finished_s=now,
                decode_steps=s.steps)
            results.append(res)
            self._note_service_time(res)
            if state.arena is not None:
                if state.prefix is not None and not s.prefilling:
                    # the slot writes no more: its partial tail block's
                    # prompt rows are final and can join the index
                    # (sharers mask the generated rows past the entry's
                    # valid count and copy before writing)
                    state.prefix.insert(s.req.tokens,
                                        state.arena._block_tables[s.slot_id])
                state.arena.free(s.slot_id)
            self._release_session(s.req)
        state.slots = [state.slots[i] for i in keep]
        if state.arena is None:
            state.cache = (kvcache.select_slots(state.cache, keep)
                           if keep else None)
            if keep:                 # compaction re-materialized the batch
                self.whole_cache_copies += 1
                self.admission_copy_bytes += kvcache.cache_bytes(state.cache)
        return results

    def _release_session(self, req: GenerationRequest) -> None:
        """Drop a sticky session's group pin once no request of it is
        queued or in flight."""
        if not (self.plan.sticky and req.stream):
            return
        left = self._session_refs.get(req.stream, 1) - 1
        if left <= 0:
            self._session_refs.pop(req.stream, None)
            self.router.release(req.stream)
        else:
            self._session_refs[req.stream] = left

    def _ensure_arena(self, state: _GroupState) -> KVArena:
        if state.arena is None:
            state.arena = KVArena(
                self.cfg, self.api.init_cache,
                capacity=self.plan.max_in_flight,
                max_seq_len=self.max_seq_len, block_size=self.block_size,
                pool_blocks=self.pool_blocks, kv_dtype=self.kv_dtype,
                device=self.device)
            if self.prefix_cache_enabled:
                state.prefix = RadixPrefixCache(
                    state.arena,
                    retention_blocks=self.plan.prefix_cache_blocks(
                        state.arena.pool_blocks, override=self._prefix_knob))
        return state.arena

    def _admit_one(self, req: GenerationRequest, state: _GroupState,
                   now: float, pending_cows: List) -> bool:
        """(b) Claim a slot for one admission.  Chunked paged: a prefix
        lookup and an arena ``alloc``; the prompt is prefilled chunk by
        chunk in (b2), from the hit on.  One-shot paged: prefill, then
        ``write_prefill`` scatters the prompt's pages and the slot's state.
        Dense: prefill, then ``kvcache.merge`` copies the live batch to
        join it.  False when the arena is out of blocks (the caller
        requeues).  ``pending_cows`` collects the wave's divergence copies
        (partial-tail hits), which ``_admit`` makes in one
        ``arena.cow_blocks`` after the wave."""
        extra = self._extra_cache_tokens()
        if self.kvcache_impl == "paged":
            arena = self._ensure_arena(state)
            total = len(req.tokens) + extra + req.max_new_tokens
            if total > arena.slot_tokens:
                raise ValueError(
                    f"request {req.rid} needs {total} tokens > per-slot "
                    f"budget {arena.slot_tokens}; raise max_seq_len")
            if self.chunked_prefill:
                return self._admit_chunked(req, state, arena, total, now,
                                           pending_cows)
            if not arena.can_alloc(total):
                return False
            # the prefill's cache lands exactly on the slot's rows
            cache_size = arena.slot_tokens - extra
        else:
            cache_size = int(len(req.tokens) + req.max_new_tokens)

        t0 = time.perf_counter()
        batch = self._build_batch([req], self._pad_prompts([req]))
        logits, cache = self.api.prefill(self.params, self.cfg, batch,
                                         cache_size=cache_size)
        first = int(sample_per_slot(logits, [self._req_seed(req)], [0], [0],
                                    self.sampler)[0])
        t1 = time.perf_counter()
        self.oneshot_prefills += 1
        self.prefill_tokens_computed += len(req.tokens)
        if self.kvcache_impl == "paged":
            slot_id = arena.alloc(total)
            self.admission_copy_bytes += arena.write_prefill(
                slot_id, cache, prompt_len=len(req.tokens) + extra)
        else:
            slot_id = len(state.slots)
            cache = kvcache.with_lens(cache, kvcache.lens(cache))
            self.admission_copy_bytes += kvcache.cache_bytes(cache)
            if state.cache is None:
                state.cache = cache
            else:
                # the merge copies the entire live batch to admit one row
                self.admission_copy_bytes += kvcache.cache_bytes(state.cache)
                self.whole_cache_copies += 1
                state.cache = kvcache.merge([state.cache, cache])
        slot = _Slot(req, admit_wall=t0, admitted_s=now, slot_id=slot_id)
        slot.prefill_s = t1 - t0
        slot.begin_decode(first, t1)
        state.slots.append(slot)
        return True

    def _admit_chunked(self, req: GenerationRequest, state: _GroupState,
                       arena: KVArena, total: int, now: float,
                       pending_cows: List) -> bool:
        """A chunked admission: stitch the longest cached prefix of the
        prompt into the new slot's table, so that its chunks start past the
        hit."""
        hit: Optional[PrefixHit] = None
        pc = state.prefix
        looked = pc is not None and len(req.tokens) > 1
        if looked:
            h = pc.lookup(req.tokens)
            if h.tokens > 0:
                hit = h
        # blocks promised to this wave's deferred copies stay claimable
        # until the flush
        reserved = len(pending_cows)
        if hit is not None and hit.partial_valid:
            # a partial-tail share always needs its divergence copy (the
            # first computed row lands in that block): admit it only with
            # room for the copy, else fall back to the full-block hit
            if not arena.can_alloc(total, shared=hit.blocks,
                                   reserve=1 + reserved):
                hit = (PrefixHit(blocks=hit.blocks[:-1],
                                 tokens=hit.full_blocks * arena.block_size,
                                 full_blocks=hit.full_blocks,
                                 partial_valid=0)
                       if hit.full_blocks else None)
        shared = hit.blocks if hit is not None else ()
        if not arena.can_alloc(total, shared=shared, reserve=reserved):
            return False
        slot_id = arena.alloc(total, shared=shared)
        if hit is not None:
            arena.set_len(slot_id, hit.tokens)
            if hit.partial_valid:
                # the divergence copy, deferred to the wave's flush (room
                # was reserved above; ensure_writable in the chunk and
                # decode paths stays as the invariant's guard)
                pending_cows.append((slot_id, hit.full_blocks))
        else:
            arena.reset_len(slot_id)
        slot = _Slot(req, admit_wall=time.perf_counter(), admitted_s=now,
                     slot_id=slot_id)
        if hit is not None:
            slot.consumed = hit.tokens
        if looked:
            pc.record(hit, len(req.tokens))
        if pc is not None:
            # over every admission (a 1-token prompt counts as a miss), so
            # that the queue-time discount stays honest
            frac = (hit.tokens / len(req.tokens)) if hit is not None else 0.0
            self._prefix_hit_ewma = 0.8 * self._prefix_hit_ewma + 0.2 * frac
        state.slots.append(slot)
        return True

    def _route_admission(self, item: QueuedItem) -> Optional[int]:
        """A DP group with a free slot; a sticky session must land on its
        pinned group or wait."""
        g = self.router.route(session=item.stream)
        if self.groups[g].live < self.plan.bs:
            return g
        if self.plan.sticky and item.stream:
            return None          # session pinned to a full group: requeue
        for alt, state in self.groups.items():
            if state.live < self.plan.bs:
                return alt
        return None

    def _admit(self, now: float, max_wait_s: float) -> int:
        free = self._free_slots()
        if free <= 0 or not len(self.composer):
            return 0
        composed = self.composer.compose(limit=free, now=now,
                                         max_wait_s=max_wait_s)
        if composed is None:
            return 0
        admitted = 0
        unplaced = []
        pending_cows: Dict[int, List] = {g: [] for g in self.groups}
        for item in composed.items:
            g = self._route_admission(item)
            if g is None or not self._admit_one(item.payload,
                                                self.groups[g], now,
                                                pending_cows[g]):
                unplaced.append(item)
                continue
            admitted += 1
        # the wave's divergence copies: one batched copy per group
        for g, pairs in pending_cows.items():
            if pairs:
                arena = self.groups[g].arena
                copied = arena.cow_blocks(pairs)
                self.admission_copy_bytes += (copied * arena.block_size
                                              * arena.token_bytes)
        for item in reversed(unplaced):   # push_front in reverse keeps FIFO
            self.composer.push_front(item)
        return admitted

    def _run_chunk(self, arena: KVArena, s: _Slot, T: int):
        """Advance one slot's prefill by one ``T``-bucket chunk; returns
        the chunk's logits (only the final chunk's are consumed).
        Paged-native: the step writes the chunk's K/V rows into the pools
        through the slot's block-table row.  Otherwise: the slot's dense
        view is gathered, the family's dense ``prefill_chunk`` runs on it,
        and the rows it wrote go back to the pages (``append_rows``).
        Either way the slot's state rows are written in place."""
        rem = len(s.req.tokens) - s.consumed
        n_valid = min(rem, T)
        toks = np.zeros((1, T), np.int32)
        toks[0, :n_valid] = s.req.tokens[s.consumed:s.consumed + n_valid]
        dev = self.device
        sid = s.slot_id
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if s.consumed == 0:
            # a FIRST chunk (start == 0) must see fresh per-slot state, not
            # the slot's previous tenant's; the enc-dec's first chunk also
            # runs the encoder over the request's frame embeddings
            arena.zero_state(sid)
            if self.cfg.family == "audio":
                batch["embeddings"] = torch.from_numpy(np.asarray(
                    s.req.extras["embeddings"])[None]).to(dev)
        # copy-on-write before the chunk lands: a hit into a partial block
        # shares it read-only, and the first write past the divergence
        # point needs a private copy
        copied = arena.ensure_writable(sid, s.consumed, n_valid)
        if copied:
            self.admission_copy_bytes += (copied * arena.block_size
                                          * arena.token_bytes)
        start = arena.lens[sid:sid + 1]
        chunk_len = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        bt_row = torch.from_numpy(arena._block_tables[sid:sid + 1]).to(dev)
        if self.paged_native:
            cache = arena.assemble(arena.pages, arena.slot_state(sid), start)
            logits, new_cache = self.api.prefill_chunk_paged(
                self.params, self.cfg, batch, cache, bt_row,
                chunk_len=chunk_len, block_size=arena.block_size)
        else:
            dense = arena.dense_view(arena.pages, bt_row)
            cache = arena.assemble(dense, arena.slot_state(sid), start)
            logits, new_cache = self.api.prefill_chunk(
                self.params, self.cfg, batch, cache, chunk_len=chunk_len)
            new_dense, _ = arena.disassemble(new_cache)
            arena.append_rows(arena.pages, new_dense, start,
                              torch.ones((1,), dtype=torch.bool, device=dev),
                              bt_row, n_tokens=T,
                              valid_tokens=new_cache["len"] - start)
        arena.lens[sid] = new_cache["len"][0]
        s.consumed += n_valid
        self.prefill_chunk_calls += 1
        self.prefill_tokens_computed += n_valid
        self.chunk_write_bytes += arena.chunk_bytes(n_valid)
        return logits, n_valid

    def _prefill_chunks(self, state: _GroupState) -> int:
        """(b2) Advance in-progress prefills, at most ``prefill_chunk``
        tokens per group per step.  The final chunk's logits seed the
        request's first sampled token."""
        if state.arena is None or not self.chunked_prefill:
            return 0
        budget = self.prefill_chunk_tokens
        done_tokens = 0
        for s in state.slots:
            if budget <= 0:
                break
            while s.prefilling and budget > 0:
                T = self._pick_bucket(len(s.req.tokens) - s.consumed,
                                      budget)
                if T is None:        # budget can't afford another bucket
                    budget = 0
                    break
                t0 = time.perf_counter()
                logits, n_valid = self._run_chunk(state.arena, s, T)
                budget -= T
                done_tokens += n_valid
                if s.consumed >= len(s.req.tokens):
                    first = int(sample_per_slot(
                        logits, [self._req_seed(s.req)], [0], [0],
                        self.sampler)[0])
                    t1 = time.perf_counter()
                    s.prefill_s += t1 - t0
                    s.begin_decode(first, t1)
                    if state.prefix is not None:
                        # every full prompt block is written: index the
                        # chain.  The partial tail is not indexed yet:
                        # generation appends into it, and freezing it now
                        # would make the owner copy its own tail; eviction
                        # indexes it once it is final
                        state.prefix.insert(
                            s.req.tokens,
                            state.arena._block_tables[s.slot_id],
                            include_partial=False)
                else:
                    self._sync()
                    s.prefill_s += time.perf_counter() - t0
        return done_tokens

    def _decode_group_paged(self, state: _GroupState) -> None:
        """(c) One fused decode step over every slot of the arena.
        Paged-native: attention reads the pools in place and writes each
        live slot's new row.  Otherwise: the dense view of every slot is
        gathered, the family's dense ``decode_step`` runs on it (dense
        decode attention), and each live slot's new row goes back to its
        pages.  Both commit only live slots: dead slots keep their state
        and their length."""
        arena = state.arena
        cap = arena.capacity
        tokens = np.zeros((cap,), np.int32)
        live = np.zeros((cap,), bool)
        seeds = np.zeros((cap,), np.uint32)
        offs = np.zeros((cap,), np.uint32)
        for s in state.slots:
            if s.done or s.prefilling:
                continue
            sid = s.slot_id
            tokens[sid] = s.emitted[-1]
            live[sid] = True
            seeds[sid] = np.uint32(self._req_seed(s.req) & 0xFFFFFFFF)
            offs[sid] = len(s.emitted)
            # the append position can sit in a block the prefix index froze
            # or another slot shares: copy first (free when nothing in the
            # pool is shared)
            pos = (len(s.req.tokens) + self._extra_cache_tokens()
                   + len(s.emitted) - 1)
            copied = arena.ensure_writable(sid, pos, 1)
            if copied:
                self.admission_copy_bytes += (copied * arena.block_size
                                              * arena.token_bytes)
        if not live.any():
            return
        dev = self.device
        live_dev = torch.from_numpy(live).to(dev)
        tokens_dev = torch.from_numpy(tokens).to(dev)
        tables = arena.device_block_tables()
        if self.paged_native:
            cache = arena.assemble(arena.pages, arena.state, arena.lens)
            logits, new_cache = self.api.decode_step_paged(
                self.params, self.cfg, tokens_dev, cache, tables, live_dev,
                block_size=arena.block_size)
        else:
            dense = arena.dense_view(arena.pages, tables)
            cache = arena.assemble(dense, arena.state, arena.lens)
            logits, new_cache = self.api.decode_step(
                self.params, self.cfg, tokens_dev, cache, live=live_dev)
            new_dense, new_state = arena.disassemble(new_cache)
            arena.append_rows(arena.pages, new_dense, arena.lens, live_dev,
                              tables)
            arena.merge_state(arena.state, new_state, live_dev)
        arena.lens = new_cache["len"]
        toks = sample_per_slot(
            logits, seeds, np.zeros((cap,), np.uint32), offs, self.sampler,
            live=live_dev, occupancy=arena.device_occupancy()).cpu().numpy()
        self.decode_steps += 1
        for slot in state.slots:
            if slot.done or slot.prefilling or not live[slot.slot_id]:
                continue
            slot.steps += 1
            slot.push(int(toks[slot.slot_id]))

    def _decode_group_dense(self, state: _GroupState) -> None:
        """(c) The dense impl's fused decode over its compacted cache (every
        row steps; finished rows await eviction and emit nothing)."""
        live = np.array([not s.done for s in state.slots])
        if not live.any():
            return               # everything awaits eviction
        dev = self.device
        cur = torch.tensor([s.emitted[-1] if not s.done else 0
                            for s in state.slots], dtype=torch.int32,
                           device=dev)
        logits, state.cache = self.api.decode_step(self.params, self.cfg,
                                                   cur, state.cache)
        toks = sample_per_slot(
            logits, [self._req_seed(s.req) for s in state.slots],
            [0] * len(state.slots), [len(s.emitted) for s in state.slots],
            self.sampler, live=torch.from_numpy(live).to(dev)).cpu().numpy()
        self.decode_steps += 1
        for i, slot in enumerate(state.slots):
            if slot.done:
                continue
            slot.steps += 1
            slot.push(int(toks[i]))

    def _decode_group(self, state: _GroupState) -> None:
        if not state.slots:
            return
        if state.arena is not None:
            self._decode_group_paged(state)
        else:
            self._decode_group_dense(state)

    # -- prefix-cache telemetry (summed across DP groups) ---------------
    def _prefix_totals(self):
        lk = ht = hits = ev = cow = 0
        for g in self.groups.values():
            if g.prefix is not None:
                lk += g.prefix.lookups
                hits += g.prefix.hits
                ht += g.prefix.hit_tokens
            if g.arena is not None:
                ev += g.arena.cached_evictions
                cow += g.arena.cow_copies
        return lk, hits, ht, ev, cow

    @property
    def prefix_hit_tokens(self) -> int:
        return self._prefix_totals()[2]

    @property
    def prefix_hits(self) -> int:
        return self._prefix_totals()[1]

    @property
    def prefix_evictions(self) -> int:
        return self._prefix_totals()[3]

    @property
    def prefix_cow_copies(self) -> int:
        return self._prefix_totals()[4]

    def _step_continuous(self, now: float, max_wait_s: float) -> StepStats:
        copy0, whole0 = self.admission_copy_bytes, self.whole_cache_copies
        chunkw0, steps0 = self.chunk_write_bytes, self.decode_steps
        one0 = self.oneshot_prefills
        pfx0 = self._prefix_totals()
        results: List[GenerationResult] = []
        for group, state in self.groups.items():
            results.extend(self._evict(group, state, now))
        admitted = self._admit(now, max_wait_s)
        chunk_tokens = 0
        for state in self.groups.values():
            chunk_tokens += self._prefill_chunks(state)
            self._decode_group(state)
        pfx1 = self._prefix_totals()
        return StepStats(
            results=results, now=now, admitted=admitted,
            evicted=len(results), in_flight=self.in_flight(),
            pending=self.pending(),
            queue_time_s=self.queue_time_estimate(),
            admission_copy_bytes=self.admission_copy_bytes - copy0,
            chunk_write_bytes=self.chunk_write_bytes - chunkw0,
            whole_cache_copies=self.whole_cache_copies - whole0,
            decode_steps=self.decode_steps - steps0,
            prefill_chunk_tokens=chunk_tokens,
            oneshot_prefills=self.oneshot_prefills - one0,
            prefix_lookups=pfx1[0] - pfx0[0],
            prefix_hits=pfx1[1] - pfx0[1],
            prefix_hit_tokens=pfx1[2] - pfx0[2],
            prefix_evicted_blocks=pfx1[3] - pfx0[3],
            prefix_cow_blocks=pfx1[4] - pfx0[4])

    # ------------------------------------------------------------------
    # sync mode: run-to-completion batches (the pre-slot baseline)
    # ------------------------------------------------------------------
    def run_batch(self, composed: ComposedBatch, *,
                  now: float = 0.0) -> List[GenerationResult]:
        """Prefill one composed batch in one shot (left-padded prompts) and
        decode it to its longest request's budget; each request keeps its
        own first ``max_new_tokens`` tokens.  Every member is charged the
        batch's prefill and decode wall time."""
        reqs = [item.payload for item in composed.items]
        group = self.router.route(session=reqs[0].stream)
        toks = self._pad_prompts(reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        cache_size = int(toks.shape[1] + max_new)

        t0 = time.perf_counter()
        batch = self._build_batch(reqs, toks)
        logits, cache = self.api.prefill(self.params, self.cfg, batch,
                                         cache_size=cache_size)
        self._sync()
        t1 = time.perf_counter()
        self.oneshot_prefills += len(reqs)
        self.prefill_tokens_computed += sum(len(r.tokens) for r in reqs)

        seeds = [self._req_seed(r) for r in reqs]
        zeros = [0] * len(reqs)
        cur = sample_per_slot(logits, seeds, zeros, zeros, self.sampler)
        outs = [cur]
        for i in range(max_new - 1):
            logits, cache = self.api.decode_step(self.params, self.cfg, cur,
                                                 cache)
            cur = sample_per_slot(logits, seeds, zeros, [i + 1] * len(reqs),
                                  self.sampler)
            outs.append(cur)
            self.decode_steps += 1
        gen = torch.stack(outs, dim=1).cpu().numpy()      # (B, max_new)
        t2 = time.perf_counter()
        results = []
        for i, r in enumerate(reqs):
            results.append(GenerationResult(
                rid=r.rid, tokens=gen[i, :r.max_new_tokens],
                prefill_s=t1 - t0, decode_s=t2 - t1, group=group,
                admitted_s=now, finished_s=now,
                decode_steps=max_new - 1))
            self._release_session(r)
        return results

    def _step_sync(self, now: float, max_wait_s: float) -> StepStats:
        steps0 = self.decode_steps
        composed = self.composer.compose(now=now, max_wait_s=max_wait_s)
        results = ([] if composed is None
                   else self.run_batch(composed, now=now))
        return StepStats(results=results, now=now, admitted=len(results),
                         evicted=len(results), in_flight=self.in_flight(),
                         pending=self.pending(),
                         queue_time_s=self.queue_time_estimate(),
                         decode_steps=self.decode_steps - steps0)

    def step(self, now: float = 0.0,
             max_wait_s: float = float("inf")) -> StepStats:
        """Advance the data plane by one scheduling round.  Continuous
        mode: evict, admit, chunked prefill, one fused decode step.  Sync
        mode: compose one batch and run it to completion."""
        moe0 = 0.0
        if self._moe_stats is not None:
            # drops of MoE calls made since the last step (outside any
            # step) go to the totals, not to this step
            self._moe_stats.flush()
            moe0 = self._moe_stats.dropped
        stats = (self._step_sync(now, max_wait_s) if self.mode == "sync"
                 else self._step_continuous(now, max_wait_s))
        if self._moe_stats is not None:
            self._moe_stats.flush()
            stats.moe_dropped_tokens = self._moe_stats.dropped - moe0
        return stats

    def drain(self, now: float = 0.0,
              max_wait_s: float = 0.0) -> List[GenerationResult]:
        """Step until queue and slots are empty; returns all results."""
        out: List[GenerationResult] = []
        while self.pending() or self.in_flight():
            before = (self.pending(), self.in_flight(), self.decode_steps,
                      self.prefill_chunk_calls)
            stats = self.step(now=now, max_wait_s=max_wait_s)
            out.extend(stats.results)
            if (self.pending(), self.in_flight(), self.decode_steps,
                    self.prefill_chunk_calls) == before \
                    and not stats.results:
                break            # no progress possible (e.g. empty compose)
        return out


class EparaServingEngine:
    """Multi-service front door: submits requests to ServiceRuntimes by
    service name.  The per-service ``StepStats`` of the latest round are
    kept in ``last_stats``."""

    def __init__(self):
        self.runtimes: Dict[str, ServiceRuntime] = {}
        self.last_stats: Dict[str, StepStats] = {}
        self._results: List[GenerationResult] = []

    def deploy(self, name: str, runtime: ServiceRuntime) -> None:
        self.runtimes[name] = runtime

    def submit(self, service: str, req: GenerationRequest,
               now: float = 0.0) -> None:
        self.runtimes[service].submit(req, now)

    def step(self, now: float = 0.0,
             max_wait_s: float = 0.0) -> List[GenerationResult]:
        """One scheduling round across every deployed runtime."""
        out: List[GenerationResult] = []
        for name, rt in self.runtimes.items():
            stats = rt.step(now=now, max_wait_s=max_wait_s)
            self.last_stats[name] = stats
            out.extend(stats.results)
        self._results.extend(out)
        return out

    def drain(self, now: float = 0.0,
              max_wait_s: float = 0.0) -> List[GenerationResult]:
        """Step every runtime round-robin until none can make progress."""
        out: List[GenerationResult] = []
        progress = True
        while progress:
            progress = False
            for name, rt in self.runtimes.items():
                if not (rt.pending() or rt.in_flight()):
                    continue
                stats = rt.step(now=now, max_wait_s=max_wait_s)
                self.last_stats[name] = stats
                out.extend(stats.results)
                if (stats.results or stats.admitted or stats.decode_steps
                        or stats.prefill_chunk_tokens):
                    progress = True
        self._results.extend(out)
        return out
