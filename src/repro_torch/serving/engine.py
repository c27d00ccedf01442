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
encoder-decoder projects the slot's cross-attention K/V state, and for
the VLM family its image embeddings, the bidirectional prefix that the
first chunk writes into the cache ahead of the text.

Observability (``repro_torch/obs``, verbatim copies of the reference's)
is off by default: ``tracer=`` records each request's lifecycle spans
(``request`` > ``queued``, ``prefill`` with its ``prefill_chunk`` events,
``decode``, and a ``parked`` span between two ``decode`` spans for a
preempted request; a fork decodes on its own ``rid.sample`` lane) and the
engine's phase spans (``evict``, ``preempt`` under sdf, ``admit``,
``chunk``, ``fused_decode``, ``sample``, ``step``), and ``metrics=``
folds every ``StepStats`` and each finished request's TTFT, TPOT and
queue wait into a registry.  Spans are host wall times.  On the card the model's launches
are asynchronous, so a span that only queues device work closes before
the device has done it, and that time lands where the host next waits
for the device: the decode model's in the ``sample`` span (the read-back
of the tokens), a non-final chunk's after its ``prefill_chunk`` span,
inside the ``chunk`` phase (the wait that times the request's prefill).
TTFT is exact: a slot's decode starts after its first token was read
back.

Sampling is greedy, or stochastic on per-slot counter streams
(``serving/sampler.py``): each drawn token is a pure function of (request
seed, sample index, stream, emitted offset), never of batch composition,
step count or park and resume history, and equals the reference's.

Deadline-aware admission (``serving/admission.py``, a verbatim copy of the
reference's): under ``admission_policy="sdf"`` each step orders the queue
by deadline slack, sheds the requests that cannot make their deadlines
with a verdict (``StepStats.rejected``), and when the most urgent request
would miss waiting for a slot parks the laziest live decode slot: its
blocks stay in the arena (``KVArena.park``), and its later re-admission
stitches them back as a whole-content prefix hit and resumes decoding
where it stopped.  ``"fifo"`` (the default) keeps the controller inert.

n-way parallel sampling (``GenerationRequest.n_samples``, capped by the
plan's ``resolved_n_samples``): when a primary's prompt is prefilled, n-1
sibling slots fork off its prompt blocks by refcount, draw their first
tokens from the same logits on their own sample streams, and diverge by
copy-on-write.

Speculative decoding (latency services, ``draft_params``/``draft_cfg``
and ``speculate``, or the plan's category default): a same-family draft
model shadows each primary slot in a draft ``KVArena`` of its own (bf16,
the same slot ids as the target's).  Catch-up chunks, under the same
chunk budget as target prefill, bring the draft's cache to two rows
behind the known tokens while the slot decodes normally; then each round
runs k+1 fused draft decode steps and one fused verify launch
(``verify_step_paged`` over every slot, T = k+1 rows for the speculating
slots and 0 for the rest, through the paged chunk kernel), accepts with
``sampler.speculative_verify``, commits 1..k+1 tokens a slot and rolls the
draft back to the new lag.  A slot whose draft cannot be allocated, whose
round would pass its table width, or that is parked degrades to plain
decode (``spec_degraded``); forks never speculate.  Greedy output is the
target's own greedy chain whatever the draft (the plain engine's on the
CPU; on the card the verify kernel rounds bf16 otherwise than the decode
kernel, so a chain can take the other of two tied top logits);
stochastic output is a pure function of the counter streams.
``draft_params=SELF_DRAFT`` makes the target its own draft; a
head-sharded target then runs its self-draft through its own sharded
step over a draft arena split as its own (a draft of another config runs
whole on the runtime's device).

``evacuate`` strips every queued, in-flight and parked request out (a
crash of this data plane) and returns them for resubmission.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.allocator import DPGroupRouter, ParallelPlan
from repro_torch.core.categories import Outcome
from repro_torch.device import resolve_device
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ModelApi, model_api
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.roofline import op_cost

from . import kvcache
from .admission import AdmissionController, AdmissionReject, ParkedEntry
from .arena import KVArena
from .batching import ComposedBatch, QueuedItem, make_composer
from .prefix_cache import PrefixHit, RadixPrefixCache
from .sampler import (STREAM_DECODE, STREAM_DRAFT, SamplerConfig, prng_key,
                      sample_per_slot, speculative_verify)

DEFAULT_MAX_SEQ_LEN = 256
DEFAULT_BLOCK_SIZE = 32

# Families whose paged K/V is a pure function of the prompt's token ids,
# which cross-request block sharing needs: SSM and hybrid carry per-slot
# recurrent state a shared prefix cannot rebuild, and the encoder-decoder
# and VLM caches depend on inputs other than tokens.
PREFIX_CACHEABLE_FAMILIES = ("dense", "moe")
# families whose requests carry ``extras["embeddings"]`` (rows, d_model),
# by the config field that counts the rows: the audio encoder's frames and
# the VLM's image prefix
_EMBEDDING_ROWS = {"audio": "encoder_len", "vlm": "prefix_len"}
# ``draft_params=SELF_DRAFT``: the target's own weights are the draft (a
# head-sharded runtime made with ``params=None`` has no whole tree to pass)
SELF_DRAFT = "target"


@dataclasses.dataclass
class GenerationRequest:
    rid: int
    tokens: np.ndarray               # prompt (L,) int32
    max_new_tokens: int = 16
    stream: int = 0
    extras: Optional[Dict[str, Any]] = None   # e.g. frame embeddings
    submitted_s: float = 0.0
    eos_token: Optional[int] = None  # evict the slot early on this token
    deadline_s: float = 0.0          # absolute deadline in the caller's
    #                                  clock (0 = none); the admission
    #                                  controller's slack/verdict input
    seed: Optional[int] = None       # sampling stream seed (None -> rid):
    #                                  every token this request draws is a
    #                                  pure function of (seed, sample_idx,
    #                                  emitted offset), never of the batch
    n_samples: int = 1               # n-way parallel sampling: n-1 forks
    #                                  share the prompt's blocks and
    #                                  diverge by copy-on-write (capped by
    #                                  the plan's resolved_n_samples())


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
    sample: int = 0                  # which of the request's n parallel
    #                                  samples this result is (0 = primary)


@dataclasses.dataclass
class StepStats:
    """One scheduling round's telemetry: the reference's fields in its
    order, so that ``obs.metrics.step_stat_sums`` folds the same series."""
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
    prefix_lookups: int = 0          # prefix-cache lookups this step
    prefix_hits: int = 0             # admissions that reused cached blocks
    prefix_hit_tokens: int = 0       # prompt tokens served from the cache
    prefix_evicted_blocks: int = 0   # cached blocks reclaimed (LRU) this step
    prefix_cow_blocks: int = 0       # copy-on-write block copies this step
    moe_dropped_tokens: float = 0.0  # MoE expert-capacity drops this step
    #                                  (token-assignments past capacity;
    #                                  nonzero under binding capacity, where
    #                                  chunked prefill may diverge)
    rejected: List[AdmissionReject] = dataclasses.field(
        default_factory=list)        # requests shed this step, each with
    #                                  an explicit verdict
    deadline_missed: int = 0         # DEADLINE_MISSED verdicts this step
    congestion_rejects: int = 0      # CONGESTION verdicts this step
    offload_verdicts: int = 0        # OFFLOAD verdicts this step
    failed_rejects: int = 0          # FAILED verdicts this step
    evacuated: int = 0               # requests stripped out by ``evacuate``
    #                                  since the last step
    preempted: int = 0               # live slots parked this step
    resumed: int = 0                 # parked requests re-admitted this step
    parked: int = 0                  # parked requests outstanding after
    #                                  the step (KV frozen in the arena)
    draft_steps: int = 0             # fused draft decode steps this step
    verify_launches: int = 0         # fused verify launches this step
    accepted_tokens: int = 0         # target tokens committed by verify
    #                                  (acceptance rate = accepted_tokens
    #                                  / verify_launches / (k+1))
    spec_slots: int = 0              # live slots speculating after the step
    forks_spawned: int = 0           # n>1 sibling slots forked this step
    fork_shortfall: int = 0          # requested forks not spawned (slot or
    #                                  block pressure; primary still runs)
    spec_degraded: int = 0           # slots that fell back to plain decode
    #                                  this step (draft alloc failure, a
    #                                  round past the table, parking)


class _Slot:
    """One in-flight request occupying a decode slot (``slot_id`` is its
    arena slot, its row in the block table).  It starts with
    ``prefilling=True`` while ``consumed`` prompt tokens are written chunk
    by chunk, and flips into decoding via ``begin_decode`` when the final
    chunk's logits yield the first token."""
    __slots__ = ("req", "emitted", "done", "prefill_s", "admit_wall",
                 "decode_start_wall", "finish_wall", "admitted_s", "steps",
                 "slot_id", "prefilling", "consumed", "sample_idx", "spec",
                 "draft_len")

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
        self.sample_idx = 0                 # 0 = primary; >0 = n>1 fork
        self.spec = False                   # draft slot allocated + chasing
        self.draft_len = 0                  # draft-cache rows written so far
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
    on, and the draft model's arena when it speculates) or a compacted
    cache dict (dense)."""
    __slots__ = ("slots", "arena", "prefix", "cache", "draft")

    def __init__(self):
        self.arena: Optional[KVArena] = None
        self.prefix: Optional[RadixPrefixCache] = None
        self.cache: Optional[Dict[str, Any]] = None   # dense impl only
        self.draft: Optional[KVArena] = None   # the draft model's arena
        self.slots: List[_Slot] = []

    @property
    def live(self) -> int:
        return len(self.slots)


class ServiceRuntime:
    """One deployed service: params + plan + DP groups of decode slots.

    ``params`` must lie on ``device`` (the card unless ``"cpu"``).  A
    ``paged_step_builder`` (``launch/steps.py`` ``paged_decode_builder``)
    splits the service by heads over a mesh's model axis on the paged
    continuous path (sync and the dense cache run whole); built with the
    shards of ``init_sharded``, it serves with ``params=None``.
    ``draft_params=SELF_DRAFT`` (``draft_cfg`` None or ``cfg``) makes the
    target its own draft."""

    def __init__(self, cfg: ModelConfig, params, plan: ParallelPlan, *,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 mode: str = "continuous", kvcache_impl: str = "paged",
                 max_seq_len: int = DEFAULT_MAX_SEQ_LEN,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 pool_blocks: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[Any] = None,
                 paged_native: Optional[bool] = None,
                 admission_policy: Optional[str] = None,
                 preempt: bool = True,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 speculate: Optional[int] = None, device=None,
                 paged_step_builder: Optional[Callable] = None,
                 tracer=None, metrics=None, obs_name: Optional[str] = None):
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
        self.device = resolve_device(device)
        named_self = draft_params is SELF_DRAFT
        if named_self:
            if draft_cfg not in (None, cfg):
                raise ValueError("a self-draft's draft_cfg is the target's")
            draft_cfg, draft_params = cfg, params
        self_draft = named_self or (
            draft_params is not None and draft_params is params
            and draft_cfg == cfg)
        for name, tree in (("params", params), ("draft_params", draft_params)):
            if tree is None:
                continue
            leaf = tree["embed"]["embedding"]
            if leaf.device.type != self.device.type:
                raise ValueError(f"{name} lie on {leaf.device}, runtime "
                                 f"device is {self.device}")
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
        self._key = prng_key(seed, self.device)
        # -- observability (repro_torch/obs): off by default.  Every call
        # site tests ``trace.enabled`` or ``metrics is not None`` before it
        # builds arguments or reads a clock, and neither layer touches a
        # tensor, so turning them on changes no token and no launch
        self.trace = NULL_TRACER if tracer is None else tracer
        self.metrics = metrics
        self._obs_named = obs_name is not None
        self.obs_name = obs_name if obs_name is not None else cfg.name
        self.prefill_seconds = 0.0   # summed per-request prefill wall time
        #                              (calibration's prefill_token_s)
        self._submit_wall: Dict[int, float] = {}  # rid -> submit wall time
        self._queue_wait: Dict[int, float] = {}   # rid -> measured wait
        # the reference's XLA compile counts: the port compiles nothing, so
        # they stay 0 where the reference's read 1
        self.decode_traces = 0
        self.prefill_traces = 0
        self.evacuations = 0         # ``evacuate`` calls
        self.evacuated_requests = 0  # requests stripped out across them
        self._evacuated_pending = 0  # delta reported by the next StepStats
        self.router = DPGroupRouter(plan)
        self.composer = make_composer(plan)
        self.groups: Dict[int, _GroupState] = {
            g: _GroupState() for g in range(max(1, plan.dp))}
        # deadline-aware admission control: policy from the plan's knob
        # unless overridden; "fifo" (the default) keeps the controller
        # inert
        self.admission = AdmissionController(self, admission_policy,
                                             preempt=preempt)
        if self.admission.active and mode != "continuous":
            raise ValueError(
                "admission policy 'sdf' requires mode='continuous' (slack "
                "ordering and preemption act on the slot loop)")
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

        # -- speculative decoding (draft/verify) --------------------------
        # latency services trade draft compute for fewer serial target
        # launches: a small draft proposes k tokens and the target scores
        # all k+1 in one fused verify launch.  Greedy acceptance emits the
        # target's own argmax chain; stochastic acceptance is exact
        # leave-one-out rejection sampling (serving/sampler.py)
        if (draft_params is None) != (draft_cfg is None) and not named_self:
            raise ValueError("draft_params and draft_cfg come together")
        have_draft = draft_cfg is not None
        knob_k = (plan.resolved_speculate(have_draft) if speculate is None
                  else int(speculate))
        if knob_k > 0 and not have_draft:
            raise ValueError(
                f"speculate={knob_k} requires a draft model (draft_params "
                "+ draft_cfg); the category default degrades to 0 without "
                "one, an explicit ask does not")
        if knob_k > 0:
            draft_ring = (draft_cfg.sliding_window is not None
                          and draft_cfg.sliding_window
                          < self.slot_token_budget)
            spec_ok = (mode == "continuous" and kvcache_impl == "paged"
                       and self.paged_native and self.chunked_prefill
                       and cfg.family in PREFIX_CACHEABLE_FAMILIES
                       and draft_cfg.family == cfg.family
                       and draft_cfg.vocab_size == cfg.vocab_size
                       and self.api.verify_step_paged is not None
                       and not draft_ring)
            if not spec_ok:
                raise ValueError(
                    "speculative decoding requires mode='continuous', "
                    "kvcache_impl='paged', paged_native, chunked_prefill, "
                    f"a family in {PREFIX_CACHEABLE_FAMILIES} with a "
                    "verify entry point, and a same-family same-vocab "
                    "non-ring draft; got "
                    f"family={cfg.family!r}/{draft_cfg.family!r}, "
                    f"vocab={cfg.vocab_size}/{draft_cfg.vocab_size}, "
                    f"mode={mode!r}, kvcache_impl={kvcache_impl!r}, "
                    f"paged_native={self.paged_native}, "
                    f"chunked_prefill={self.chunked_prefill}, "
                    f"draft_ring={draft_ring}")
        self.speculate_k = knob_k
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_api: Optional[ModelApi] = (
            model_api(draft_cfg) if have_draft else None)
        self.draft_steps = 0         # fused draft decode invocations
        self.verify_launches = 0     # fused verify invocations
        self.accepted_tokens = 0     # target tokens committed by verify
        self.spec_degraded = 0       # speculation fallbacks
        self.draft_prefill_tokens = 0  # known tokens chunked into drafts
        # the reference's compile counts of the draft and verify steps
        # (0: the port compiles nothing)
        self.verify_traces = 0
        self.draft_decode_traces = 0
        self.draft_prefill_traces = 0

        # -- n>1 parallel sampling (refcounted prompt-block forks) --------
        self.forks_spawned = 0
        self.fork_shortfall = 0
        self._sibling_refs: Dict[int, int] = {}   # rid -> live siblings
        self.n_samples_cap = (plan.resolved_n_samples()
                              if (mode == "continuous"
                                  and kvcache_impl == "paged"
                                  and self.chunked_prefill) else 1)

        # -- model parallelism: a launcher's builder (``launch/steps.py``
        # ``paged_decode_builder``) splits the service over a mesh's model
        # axis; the paged decode and chunk steps then run shard by shard
        # and the arena's pools split by kv head (None: one device).  As
        # in the reference, whose builder wraps the paged decode step
        # alone, only the paged continuous path builds it: sync and the
        # dense cache run whole on the runtime's device.
        # ``params=None``: the builder holds the shards alone (no device
        # keeps the whole tree)
        paged_loop = mode == "continuous" and kvcache_impl == "paged"
        if params is None and (paged_step_builder is None
                               or not paged_loop):
            raise ValueError(
                "params=None serves a head-sharded runtime "
                "(paged_step_builder with its shards, on the paged "
                "continuous path) only")
        self.sharded_step = (paged_step_builder(self)
                             if paged_step_builder is not None
                             and paged_loop else None)
        # the step that runs the draft: a head-sharded target's own for its
        # self-draft (the same shard trees, a draft arena split alike);
        # None: the draft runs whole on the runtime's device
        self.sharded_draft = (self.sharded_step
                              if have_draft and self_draft else None)
        if have_draft and self.sharded_draft is None \
                and draft_params is None:
            raise ValueError("a draft of another config than a head-sharded "
                             "target's runs whole: pass its draft_params")

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
        if self.cfg.family in _EMBEDDING_ROWS:
            want = (getattr(self.cfg, _EMBEDDING_ROWS[self.cfg.family]),
                    self.cfg.d_model)
            emb = (req.extras or {}).get("embeddings")
            if emb is None or tuple(np.shape(emb)) != want:
                raise ValueError(
                    f"{self.cfg.family} request {req.rid} needs "
                    f"extras['embeddings'] of shape {want}, got "
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
        if self.metrics is not None or self.trace.enabled:
            self._submit_wall[req.rid] = time.perf_counter()
        tr = self.trace
        if tr.enabled:
            tid = str(req.rid)
            tr.begin(self.obs_name, tid, "request",
                     prompt_tokens=len(req.tokens),
                     max_new=req.max_new_tokens, n_samples=req.n_samples)
            tr.begin(self.obs_name, tid, "queued")
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
        if self.cfg.family in _EMBEDDING_ROWS:
            batch["embeddings"] = torch.from_numpy(np.stack(
                [np.asarray(r.extras["embeddings"], np.float32)
                 for r in reqs])).to(self.device)
        return batch

    def _extra_cache_tokens(self) -> int:
        """Cache positions a request takes beyond its text prompt: the VLM
        family's image prefix (its ``prefill`` budgets ``cache_size`` in
        text tokens and adds the prefix itself)."""
        return self.cfg.prefix_len if self.cfg.family == "vlm" else 0

    def _req_seed(self, req: GenerationRequest) -> int:
        """The request's sampling-stream seed (``rid`` unless the caller
        pinned one)."""
        return req.rid if req.seed is None else int(req.seed)

    def _sample(self, logits, seeds, sample_ids, offsets, live=None,
                occupancy=None, stream: int = STREAM_DECODE):
        """Per-slot counter-based sampling on the runtime's device: row
        ``i``'s key folds (seed, sample index, stream, offset) into the
        runtime's base key, so its tokens are the same alone, in any batch
        mix, and across park and resume."""
        return sample_per_slot(
            logits, self._key, np.asarray(seeds, np.int64) & 0xFFFFFFFF,
            np.asarray(sample_ids, np.int64),
            np.asarray(offsets, np.int64), self.sampler, stream=stream,
            live=live, occupancy=occupancy)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _obs_admitted(self, req: GenerationRequest, group: int,
                      next_span: str, **args) -> None:
        """Observability at admission: record the measured queue wait
        (submit -> admission), close the request's ``queued`` span and open
        the next lifecycle span."""
        if self._submit_wall:
            t = self._submit_wall.pop(req.rid, None)
            if t is not None:
                self._queue_wait[req.rid] = max(
                    0.0, time.perf_counter() - t)
        tr = self.trace
        if tr.enabled:
            tid = str(req.rid)
            tr.end(self.obs_name, tid, group=group)
            tr.begin(self.obs_name, tid, next_span, **args)

    def _slot_tid(self, s: _Slot) -> str:
        """The slot's trace timeline: the request id, with n>1 sampling
        forks on their own ``rid.sample`` lane."""
        return (str(s.req.rid) if s.sample_idx == 0
                else f"{s.req.rid}.{s.sample_idx}")

    def _finish_request(self, req: GenerationRequest) -> None:
        """Bookkeeping whenever a request leaves the data plane (eviction,
        sync-batch completion, evacuation): its observability state, its
        trace timeline (closed whatever is still open) and its sticky
        session's group pin, dropped once no request of the session is
        queued or in flight."""
        self._submit_wall.pop(req.rid, None)
        self._queue_wait.pop(req.rid, None)
        if self.trace.enabled:
            self.trace.close(self.obs_name, str(req.rid), outcome="served")
        if not (self.plan.sticky and req.stream):
            return
        left = self._session_refs.get(req.stream, 1) - 1
        if left <= 0:
            self._session_refs.pop(req.stream, None)
            self.router.release(req.stream)
        else:
            self._session_refs[req.stream] = left

    def _finish_sibling(self, req: GenerationRequest) -> None:
        """Eviction-side bookkeeping for n>1 sampling: a forked request
        leaves the data plane once, when its last sibling slot does."""
        refs = self._sibling_refs.get(req.rid)
        if refs is None or refs <= 1:
            self._sibling_refs.pop(req.rid, None)
            self._finish_request(req)
        else:
            self._sibling_refs[req.rid] = refs - 1

    def _note_service_time(self, res: GenerationResult) -> None:
        if res.sample == 0:
            # forks carry the primary's prefill_s but paid no prefill
            # compute: count the wall time once
            self.prefill_seconds += max(0.0, res.prefill_s)
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
                decode_steps=s.steps, sample=s.sample_idx)
            results.append(res)
            self._note_service_time(res)
            self.admission.observe(res)
            if self.trace.enabled:
                self.trace.end(self.obs_name, self._slot_tid(s),
                               tokens=len(s.emitted), steps=s.steps)
            if self.metrics is not None:
                n = len(s.emitted)
                self.metrics.observe_request(
                    self.obs_name,
                    ttft_s=max(0.0, s.decode_start_wall - s.admit_wall),
                    tpot_s=(res.decode_s / (n - 1)) if n > 1 else None,
                    queue_wait_s=self._queue_wait.get(s.req.rid, 0.0),
                    new_tokens=n)
            if state.arena is not None:
                self._drop_draft(state, s)
                if state.prefix is not None and not s.prefilling:
                    # the slot writes no more: its partial tail block's
                    # prompt rows are final and can join the index
                    # (sharers mask the generated rows past the entry's
                    # valid count and copy before writing)
                    state.prefix.insert(s.req.tokens,
                                        state.arena._block_tables[s.slot_id])
                state.arena.free(s.slot_id)
            self._finish_sibling(s.req)
        state.slots = [state.slots[i] for i in keep]
        if state.arena is None:
            state.cache = (kvcache.select_slots(state.cache, keep)
                           if keep else None)
            if keep:                 # compaction re-materialized the batch
                self.whole_cache_copies += 1
                self.admission_copy_bytes += kvcache.cache_bytes(state.cache)
        return results

    def _new_arena(self, meta: bool = False) -> KVArena:
        """A group's arena on the runtime's devices, or with ``meta`` one of
        the same shapes that allocates nothing."""
        sharded = self.sharded_step
        devices = None if sharded is None else sharded.devices
        if meta:
            devices = None if devices is None else ["meta"] * len(devices)
        return KVArena(
            self.cfg, self.api.init_cache, capacity=self.plan.max_in_flight,
            max_seq_len=self.max_seq_len, block_size=self.block_size,
            pool_blocks=self.pool_blocks, kv_dtype=self.kv_dtype,
            device="meta" if meta else self.device, shard_devices=devices,
            state_split=None if sharded is None else sharded.state_split)

    def _ensure_arena(self, state: _GroupState) -> KVArena:
        if state.arena is None:
            sharded = self.sharded_step
            state.arena = self._new_arena()
            if sharded is not None:
                sharded.check_arena(state.arena)
            if self.prefix_cache_enabled:
                state.prefix = RadixPrefixCache(
                    state.arena,
                    retention_blocks=self.plan.prefix_cache_blocks(
                        state.arena.pool_blocks, override=self._prefix_knob))
        return state.arena

    def _admit_one(self, req: GenerationRequest, group: int,
                   state: _GroupState, now: float,
                   pending_cows: List) -> bool:
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
            entry = self.admission.parked.get(req.rid)
            if entry is not None:
                return self._resume_parked(req, state, entry, total,
                                           pending_cows)
            if self.chunked_prefill:
                return self._admit_chunked(req, group, state, arena, total,
                                           now, pending_cows)
            if not arena.can_alloc(total):
                return False
            # the prefill's cache lands exactly on the slot's rows
            cache_size = arena.slot_tokens - extra
        else:
            cache_size = int(len(req.tokens) + req.max_new_tokens)

        self._obs_admitted(req, group, "prefill", oneshot=True)
        t0 = time.perf_counter()
        batch = self._build_batch([req], self._pad_prompts([req]))
        if self.sharded_step is not None:
            # one cache a shard, each of its kv heads (write_prefill)
            logits, cache = self.sharded_step.prefill(batch, cache_size)
        else:
            logits, cache = self.api.prefill(self.params, self.cfg, batch,
                                             cache_size=cache_size)
        first = int(self._sample(logits, [self._req_seed(req)], [0], [0])[0])
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
        tr = self.trace
        if tr.enabled:
            tid = str(req.rid)
            tr.end(self.obs_name, tid, tokens_computed=len(req.tokens))
            tr.instant(self.obs_name, tid, "first_token")
            tr.begin(self.obs_name, tid, "decode")
        return True

    def _admit_chunked(self, req: GenerationRequest, group: int,
                       state: _GroupState, arena: KVArena, total: int,
                       now: float, pending_cows: List) -> bool:
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
        self._obs_admitted(req, group, "prefill", hit_tokens=slot.consumed)
        return True

    def _resume_parked(self, req: GenerationRequest, state: _GroupState,
                       entry: ParkedEntry, total: int,
                       pending_cows: List) -> bool:
        """Re-admit a preempted request onto its parked blocks: alloc with
        ``shared=blocks`` re-increfs every block (a whole-content prefix
        hit, generated tokens included), then the parked hold drops, so
        the refcounts are unchanged, with no prefill and no copy.  The
        slot resumes at the device length and emitted tokens of park
        time."""
        arena = state.arena
        if not arena.can_alloc(total, shared=entry.blocks,
                               reserve=len(pending_cows)):
            return False
        slot_id = arena.alloc(total, shared=entry.blocks)
        arena.release_parked(entry.blocks)
        arena.set_len(slot_id, entry.cache_len)
        slot = _Slot(req, admit_wall=entry.admit_wall,
                     admitted_s=entry.admitted_s, slot_id=slot_id)
        slot.prefill_s = entry.prefill_s
        slot.prefilling = False
        slot.emitted = list(entry.emitted)
        slot.decode_start_wall = entry.decode_start_wall
        slot.steps = entry.steps
        slot.consumed = entry.consumed
        state.slots.append(slot)
        self.admission.pop_parked(req.rid)
        self.admission.note_resume()
        if state.prefix is not None:
            # the whole parked content (prompt and generated K/V) is served
            # from resident blocks: the prefix cache's hit telemetry counts
            # it
            state.prefix.note_resume(entry.cache_len)
        self._obs_admitted(req, entry.group, "decode", resumed=True)
        return True

    def _park_slot(self, group: int, state: _GroupState, s: _Slot,
                   now: float) -> None:
        """Preempt one live decode slot by block-table parking: freeze its
        blocks in the arena (the K/V stays resident, its references held
        by the ``ParkedEntry``), free the slot, and re-queue the request;
        its later compose resumes it through ``_resume_parked``."""
        arena = state.arena
        if s.spec:
            # the draft cache can be rebuilt from the tokens, but chasing it
            # again after the resume is not worth its chunks: a parked
            # request resumes without speculation (only the telemetry
            # shows it)
            self._drop_draft(state, s)
            self.spec_degraded += 1
        entry = ParkedEntry(
            req=s.req, group=group,
            blocks=[], cache_len=int(arena.lens[s.slot_id]),
            emitted=list(s.emitted), consumed=s.consumed, steps=s.steps,
            prefill_s=s.prefill_s, admit_wall=s.admit_wall,
            decode_start_wall=s.decode_start_wall,
            admitted_s=s.admitted_s, parked_s=now)
        entry.blocks = arena.park(s.slot_id)
        state.slots.remove(s)
        self.admission.note_park(entry)
        tr = self.trace
        if tr.enabled:
            tid = str(s.req.rid)
            tr.end(self.obs_name, tid, reason="park", tokens=len(s.emitted))
            tr.begin(self.obs_name, tid, "parked")
        self.composer.add(QueuedItem(payload=s.req, stream=s.req.stream,
                                     enqueued_s=now, rid=s.req.rid))

    def _maybe_preempt(self, now: float) -> None:
        """Park the laziest live decode slot when the most urgent pending
        request would otherwise miss its deadline waiting.  One victim per
        step bounds the churn; the controller's guard ensures the victim
        can afford the round trip."""
        ctrl = self.admission
        if not (ctrl.active and ctrl.preempt
                and self.kvcache_impl == "paged"):
            return
        if self._free_slots() > 0 or len(ctrl.parked) >= ctrl.max_parked:
            return
        head = self.composer.peek()
        if head is None:
            return
        urgent_slack = ctrl.slack(head.payload, now)
        if not 0.0 <= urgent_slack < float("inf"):
            return                   # doomed (shed next round) or lax
        if urgent_slack >= ctrl.wait_estimate(now):
            return                   # it can afford to wait its turn
        candidates = []
        for g, state in self.groups.items():
            arena = state.arena
            if arena is None or not arena.parkable:
                continue             # per-slot state can't survive parking
            for s in state.slots:
                if s.done or s.prefilling or s.req.rid == head.rid:
                    continue
                if s.req.rid in self._sibling_refs:
                    # n>1 siblings share one request identity: parking one
                    # fork would re-queue the rid while the others keep
                    # decoding it, and its resume would admit it twice
                    continue
                candidates.append((ctrl.slot_slack(s, now),
                                   ctrl.remaining_estimate(s),
                                   (g, state, s)))
        victim = ctrl.pick_victim(urgent_slack, candidates)
        if victim is not None:
            self._park_slot(*victim, now)

    def _shed_rejected(self, now: float) -> List[AdmissionReject]:
        """Run the controller's shed pass and finalize each reject: parked
        blocks go back to the arena (cached ones to the idle LRU), the
        session pin drops, and the request leaves the data plane carrying
        its verdict."""
        rejects: List[AdmissionReject] = []
        for item, verdict in self.admission.shed(now):
            req = item.payload
            entry = self.admission.pop_parked(item.rid)
            if entry is not None:
                self.groups[entry.group].arena.release_parked(entry.blocks)
            if self.trace.enabled:
                # the verdict lands on the outermost ("request") span;
                # _finish_request's close then finds nothing open
                self.trace.close(self.obs_name, str(req.rid),
                                 verdict=verdict.name)
            self._finish_request(req)
            rejects.append(AdmissionReject(req=req, verdict=verdict,
                                           now=now))
        return rejects

    def _route_admission(self, item: QueuedItem) -> Optional[int]:
        """A DP group with a free slot; a sticky session must land on its
        pinned group or wait, and a parked request on the group whose
        arena holds its blocks."""
        pg = self.admission.parked_group(item.rid)
        if pg is not None:
            return pg if self.groups[pg].live < self.plan.bs else None
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
            if g is None or not self._admit_one(item.payload, g,
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
        self.admission.note_admit(admitted)
        return admitted

    def _chunk_step(self, arena: KVArena, sid: int, toks: np.ndarray,
                    n_valid: int, *, draft: bool = False,
                    embeddings=None):
        """One chunk into slot ``sid`` of ``arena`` from the slot's length
        on: ``toks`` (1, T), the first ``n_valid`` real.  The target model,
        or with ``draft`` the draft model over its own arena (always
        paged-native), through the sharded step where there is one (the
        draft's: ``sharded_draft``).  Paged-native: the step writes the
        chunk's K/V rows into the pools through the slot's block-table
        row.  Otherwise: the slot's dense view is gathered, the family's
        dense ``prefill_chunk`` runs on it, and the rows it wrote go back
        to the pages (``append_rows``).  Either way the slot's state rows are
        written in place and its length advances.  Returns the chunk's
        logits."""
        api, cfg, params = ((self.draft_api, self.draft_cfg,
                             self.draft_params) if draft
                            else (self.api, self.cfg, self.params))
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if embeddings is not None:
            batch["embeddings"] = embeddings
        start = arena.lens[sid:sid + 1]
        chunk_len = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        bt_row = torch.from_numpy(arena._block_tables[sid:sid + 1]).to(dev)
        # cache rows the step writes: the bucket, and on a VLM's first
        # chunk the image prefix ahead of it
        n_rows = toks.shape[1] + (cfg.prefix_len if embeddings is not None
                                  and cfg.family == "vlm" else 0)
        step = self.sharded_draft if draft else self.sharded_step
        if step is not None:
            logits, new_len = step.chunk(
                arena, sid, batch["tokens"], start, chunk_len,
                embeddings=embeddings, draft=draft)
            arena.lens[sid] = new_len[0]
            return logits
        if draft or self.paged_native:
            cache = arena.assemble(arena.pages, arena.slot_state(sid), start)
            logits, new_cache = api.prefill_chunk_paged(
                params, cfg, batch, cache, bt_row, chunk_len=chunk_len,
                block_size=arena.block_size)
        else:
            dense = arena.dense_view(arena.pages, bt_row)
            cache = arena.assemble(dense, arena.slot_state(sid), start)
            logits, new_cache = api.prefill_chunk(params, cfg, batch, cache,
                                                  chunk_len=chunk_len)
            new_dense, _ = arena.disassemble(new_cache)
            arena.append_rows(arena.pages, new_dense, start,
                              torch.ones((1,), dtype=torch.bool, device=dev),
                              bt_row, n_tokens=n_rows,
                              valid_tokens=new_cache["len"] - start)
        arena.lens[sid] = new_cache["len"][0]
        return logits

    def _run_chunk(self, arena: KVArena, s: _Slot, T: int):
        """Advance one slot's prefill by one ``T``-bucket chunk; returns
        the chunk's logits (only the final chunk's are consumed)."""
        rem = len(s.req.tokens) - s.consumed
        n_valid = min(rem, T)
        toks = np.zeros((1, T), np.int32)
        toks[0, :n_valid] = s.req.tokens[s.consumed:s.consumed + n_valid]
        sid = s.slot_id
        embeddings = None
        if s.consumed == 0:
            # a FIRST chunk (start == 0) must see fresh per-slot state, not
            # the slot's previous tenant's; the enc-dec's first chunk also
            # runs the encoder over the request's frame embeddings, and the
            # VLM's carries its image prefix
            arena.zero_state(sid)
            if self.cfg.family in _EMBEDDING_ROWS:
                embeddings = torch.from_numpy(np.asarray(
                    s.req.extras["embeddings"])[None]).to(self.device)
        # copy-on-write before the chunk lands: a hit into a partial block
        # shares it read-only, and the first write past the divergence
        # point needs a private copy
        copied = arena.ensure_writable(sid, s.consumed, n_valid)
        if copied:
            self.admission_copy_bytes += (copied * arena.block_size
                                          * arena.token_bytes)
        logits = self._chunk_step(arena, sid, toks, n_valid,
                                  embeddings=embeddings)
        s.consumed += n_valid
        self.prefill_chunk_calls += 1
        self.prefill_tokens_computed += n_valid
        # chunk writes are appends of fresh rows, the VLM's image prefix
        # among them on its first chunk
        rows = n_valid + (self._extra_cache_tokens() if embeddings is not None
                          else 0)
        self.chunk_write_bytes += arena.chunk_bytes(rows)
        return logits, n_valid

    def _prefill_chunks(self, state: _GroupState) -> int:
        """(b2) Advance in-progress prefills, at most ``prefill_chunk``
        tokens per group per step.  The final chunk's logits seed the
        request's first sampled token."""
        if state.arena is None or not self.chunked_prefill:
            return 0
        tr = self.trace
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
                ct0 = tr.clock() if tr.enabled else 0.0
                logits, n_valid = self._run_chunk(state.arena, s, T)
                budget -= T
                done_tokens += n_valid
                if tr.enabled:
                    tr.complete(self.obs_name, str(s.req.rid),
                                "prefill_chunk", ct0, tokens=n_valid,
                                bucket=T)
                if s.consumed >= len(s.req.tokens):
                    first = int(self._sample(
                        logits, [self._req_seed(s.req)], [s.sample_idx],
                        [0])[0])
                    t1 = time.perf_counter()
                    s.prefill_s += t1 - t0
                    s.begin_decode(first, t1)
                    self._enable_spec(state, s)
                    self._spawn_forks(state, s, logits, t1)
                    if tr.enabled:
                        tid = str(s.req.rid)
                        tr.end(self.obs_name, tid,
                               tokens_computed=s.consumed)
                        tr.instant(self.obs_name, tid, "first_token")
                        tr.begin(self.obs_name, tid, "decode")
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

    # -- speculative decoding: the draft arena and the fused verify ------
    def _spec_goal(self, s: _Slot) -> int:
        """Draft-cache rows a slot needs before it can run a round: the
        draft lags the known tokens by two rows, so that every round's step
        0 feeds ``known[-2]`` (catching up; its output is dropped) and step
        1 feeds ``emitted[-1]`` to propose the first draft: one uniform
        round of k+1 steps."""
        return len(s.req.tokens) + len(s.emitted) - 2

    def _ensure_draft(self, state: _GroupState) -> KVArena:
        if state.draft is None:
            # the draft's K/V keeps the native precision: int8 would change
            # which tokens are proposed from run to run; a sharded draft's
            # pools split by kv head as the target's
            step = self.sharded_draft
            state.draft = KVArena(
                self.draft_cfg, self.draft_api.init_cache,
                capacity=self.plan.max_in_flight,
                max_seq_len=self.max_seq_len, block_size=self.block_size,
                kv_dtype="bf16", device=self.device,
                shard_devices=None if step is None else step.devices,
                state_split=None if step is None else step.state_split)
            if step is not None:
                step.check_arena(state.draft)
        return state.draft

    def _enable_spec(self, state: _GroupState, s: _Slot) -> None:
        """Arm speculation for a slot that just finished prefill: claim the
        same slot id in the group's draft arena (the two block tables stay
        aligned) and start the draft's chase, which ``_draft_chunks``
        advances while the slot decodes normally; rounds start once it
        reaches the lag goal.  A draft that cannot be allocated degrades to
        plain decode (counted, never fatal).  Forks never speculate: their
        divergence is the point, and greedy drafts would collapse them."""
        if self.speculate_k <= 0 or s.sample_idx != 0 or s.done:
            return
        draft = self._ensure_draft(state)
        # draft rows run k past the known tokens in a round
        total = min(len(s.req.tokens) + s.req.max_new_tokens
                    + self.speculate_k, draft.slot_tokens)
        if not draft.can_alloc(total):
            self.spec_degraded += 1
            return
        draft.alloc(total, slot=s.slot_id)
        draft.reset_len(s.slot_id)
        s.spec = True
        s.draft_len = 0

    def _drop_draft(self, state: _GroupState, s: _Slot) -> None:
        """Free a speculating slot's draft slot; it decodes plainly from
        here on."""
        if s.spec:
            state.draft.free(s.slot_id)
            s.spec = False
            s.draft_len = 0

    def _draft_chunks(self, state: _GroupState) -> int:
        """Chase each speculating slot's draft cache toward its lag goal,
        at most one chunk budget per group per step (target prefill's
        bound).  The goal moves one row a plain decode step while the chase
        runs; the smallest bucket is a whole block, so the chase gains."""
        if state.draft is None:
            return 0
        draft = state.draft
        budget = self.prefill_chunk_tokens
        done_tokens = 0
        for s in state.slots:
            if budget <= 0:
                break
            if not s.spec or s.prefilling or s.done:
                continue
            goal = self._spec_goal(s)
            while s.draft_len < goal and budget > 0:
                T = self._pick_bucket(goal - s.draft_len, budget)
                if T is None:
                    budget = 0
                    break
                n_valid = min(goal - s.draft_len, T)
                known = np.concatenate([np.asarray(s.req.tokens, np.int32),
                                        np.asarray(s.emitted, np.int32)])
                toks = np.zeros((1, T), np.int32)
                toks[0, :n_valid] = known[s.draft_len:s.draft_len + n_valid]
                self._chunk_step(draft, s.slot_id, toks, n_valid, draft=True)
                s.draft_len += n_valid
                budget -= T
                done_tokens += n_valid
                self.draft_prefill_tokens += n_valid
        return done_tokens

    def _spec_round(self, state: _GroupState,
                    spec_slots: List[_Slot]) -> None:
        """One draft/verify round for every slot whose draft has caught up:
        k+1 fused draft decode steps (step 0 feeds ``known[-2]`` to close
        the lag, steps 1..k propose drafts on the ``STREAM_DRAFT``
        streams), then one fused target verify launch, which commits up to
        k+1 tokens a slot.  The draft then rolls back to the new lag goal
        (the rows of rejected proposals lie past its length; the next round
        overwrites them).  Acceptance runs on the speculating rows only:
        each row's tokens depend only on its own logits and keys."""
        arena, draft = state.arena, state.draft
        cap = arena.capacity
        k = self.speculate_k
        dev = self.device
        tr = self.trace
        rt0 = tr.clock() if tr.enabled else 0.0
        live = np.zeros((cap,), bool)
        seeds = np.zeros((cap,), np.int64)
        sids = np.zeros((cap,), np.int64)
        offs = np.zeros((cap,), np.int64)
        for s in spec_slots:
            sid = s.slot_id
            live[sid] = True
            seeds[sid] = self._req_seed(s.req) & 0xFFFFFFFF
            sids[sid] = s.sample_idx
            offs[sid] = len(s.emitted)
        live_dev = torch.from_numpy(live).to(dev)
        rows = np.flatnonzero(live)               # speculating slot ids
        rows_dev = torch.from_numpy(rows).to(dev)
        drafts = np.zeros((cap, k), np.int32)
        dlogits = []
        for j in range(k + 1):
            tokens = np.zeros((cap,), np.int32)
            for s in spec_slots:
                if j == 0:
                    # the catch-up row: the second-to-last known token
                    # (its output re-predicts a token already known)
                    tokens[s.slot_id] = (s.emitted[-2] if len(s.emitted) >= 2
                                         else s.req.tokens[-1])
                elif j == 1:
                    tokens[s.slot_id] = s.emitted[-1]
                else:
                    tokens[s.slot_id] = drafts[s.slot_id, j - 2]
            logits = self._paged_decode(draft, torch.from_numpy(tokens).to(
                dev), live_dev, draft=True)
            self.draft_steps += 1
            if j >= 1:
                dlogits.append(logits[rows_dev])
                drafts[:, j - 1] = self._sample(
                    logits, seeds, sids, offs + (j - 1), live=live_dev,
                    stream=STREAM_DRAFT).cpu().numpy()
        vtok = np.zeros((cap, k + 1), np.int32)
        for s in spec_slots:
            sid = s.slot_id
            vtok[sid, 0] = s.emitted[-1]
            vtok[sid, 1:] = drafts[sid]
            # copy-on-write over the whole verify span (a tail the prefix
            # index froze, a prompt block shared with another slot)
            start = len(s.req.tokens) + len(s.emitted) - 1
            copied = arena.ensure_writable(sid, start, k + 1)
            if copied:
                self.admission_copy_bytes += (copied * arena.block_size
                                              * arena.token_bytes)
        tv0 = tr.clock() if tr.enabled else 0.0
        vtok_dev = torch.from_numpy(vtok).to(dev)
        vlen = torch.where(live_dev, k + 1, 0).to(torch.int32)
        if self.sharded_step is not None:
            logits, _ = self.sharded_step.verify(arena, vtok_dev, vlen)
        else:
            cache = arena.assemble(arena.pages, arena.state, arena.lens)
            logits, _ = self.api.verify_step_paged(
                self.params, self.cfg, {"tokens": vtok_dev}, cache,
                arena.device_block_tables(), chunk_len=vlen,
                block_size=arena.block_size)
        out, n_emit = speculative_verify(
            logits[rows_dev], torch.stack(dlogits, dim=1),
            torch.from_numpy(drafts[rows]).to(dev), self._key, seeds[rows],
            sids[rows], offs[rows], self.sampler)
        arena.lens = arena.lens.index_add(0, rows_dev, n_emit)
        self.verify_launches += 1
        if tr.enabled:
            tr.complete(self.obs_name, "engine", "verify", tv0,
                        slots=len(spec_slots), k=k)
        out_h, nem = out.cpu().numpy(), n_emit.cpu().numpy()
        row_of = {int(sid): i for i, sid in enumerate(rows)}
        for s in spec_slots:
            i = row_of[s.slot_id]
            n = int(nem[i])
            s.steps += 1
            for t in out_h[i, :n]:
                # count only the tokens the request keeps: verify can
                # commit past max_new or EOS, and eviction drops those
                self.accepted_tokens += 1
                s.push(int(t))
                if s.done:
                    break
            # roll the draft back to the new lag goal
            dl = self._spec_goal(s)
            draft.set_len(s.slot_id, dl)
            s.draft_len = dl
            if tr.enabled:
                tr.complete(self.obs_name, str(s.req.rid), "spec_round",
                            rt0, k=k, accepted=n)

    def _spawn_forks(self, state: _GroupState, s: _Slot, logits,
                     wall: float) -> None:
        """Fork ``n_samples - 1`` sibling slots off a primary that just
        finished prefill: each fork allocs with ``shared=`` the primary's
        prompt blocks (refcount bumps, no prefill compute and no copy),
        draws its first token from the same final-chunk logits on its own
        ``sample_idx`` stream, and diverges from the shared tail block by
        copy-on-write on its first append.  Slot or block pressure spawns
        fewer than asked (counted as shortfall); the primary always
        runs."""
        if s.sample_idx != 0:
            return
        asked = int(getattr(s.req, "n_samples", 1)) - 1
        want = min(asked + 1, self.n_samples_cap) - 1
        if want <= 0:
            # shortfall counts every sibling asked for but denied, by the
            # category's cap as by alloc failures
            self.fork_shortfall += max(0, asked)
            return
        arena = state.arena
        P = len(s.req.tokens) + self._extra_cache_tokens()
        total = P + s.req.max_new_tokens
        shared = list(arena._block_tables[s.slot_id][:arena.blocks_for(P)])
        seed = self._req_seed(s.req)
        first = self._sample(
            logits.reshape(1, -1).expand(want, logits.shape[-1]),
            [seed] * want, list(range(1, want + 1)), [0] * want).cpu()
        spawned = 0
        for i in range(want):
            if (state.live >= self.plan.bs
                    or not arena.can_alloc(total, shared=shared)):
                break
            sid = arena.alloc(total, shared=shared)
            arena.set_len(sid, P)
            fork = _Slot(s.req, admit_wall=s.admit_wall,
                         admitted_s=s.admitted_s, slot_id=sid)
            fork.prefill_s = s.prefill_s
            fork.consumed = len(s.req.tokens)
            fork.sample_idx = i + 1
            fork.begin_decode(int(first[i]), wall)
            state.slots.append(fork)
            spawned += 1
            if self.trace.enabled:
                # forks live on their own "rid.sample" lane carrying only
                # a decode span: no prefill is the point
                ftid = self._slot_tid(fork)
                self.trace.begin(self.obs_name, ftid, "decode", fork=True)
                self.trace.instant(self.obs_name, ftid, "first_token")
        self.forks_spawned += spawned
        self.fork_shortfall += asked - spawned
        if spawned:
            self._sibling_refs[s.req.rid] = spawned + 1

    def _paged_decode(self, arena: KVArena, tokens, live, *,
                      draft: bool = False):
        """One fused decode step over every slot of ``arena``: the target
        model, or with ``draft`` the draft model over its arena (always
        paged-native), through the sharded step where there is one.
        Paged-native: attention reads the pools in place and writes each
        live slot's new row.  Otherwise: the dense view of
        every slot is gathered, the family's dense ``decode_step`` runs on
        it (dense decode attention), and each live slot's new row goes back
        to its pages.  Both commit only live slots: dead slots keep their
        state and their length.  Returns the logits (capacity, V)."""
        api, cfg, params = ((self.draft_api, self.draft_cfg,
                             self.draft_params) if draft
                            else (self.api, self.cfg, self.params))
        step = self.sharded_draft if draft else self.sharded_step
        if step is not None:
            logits, arena.lens = step.decode(arena, tokens, live, draft=draft)
            return logits
        tables = arena.device_block_tables()
        if draft or self.paged_native:
            cache = arena.assemble(arena.pages, arena.state, arena.lens)
            logits, new_cache = api.decode_step_paged(
                params, cfg, tokens, cache, tables, live,
                block_size=arena.block_size)
        else:
            dense = arena.dense_view(arena.pages, tables)
            cache = arena.assemble(dense, arena.state, arena.lens)
            logits, new_cache = api.decode_step(params, cfg, tokens, cache,
                                                live=live)
            new_dense, new_state = arena.disassemble(new_cache)
            arena.append_rows(arena.pages, new_dense, arena.lens, live,
                              tables)
            arena.merge_state(arena.state, new_state, live)
        arena.lens = new_cache["len"]
        return logits

    def decode_cost_analysis(self, group: int = 0) -> Dict[str, Any]:
        """FLOPs and bytes of the fused decode step at the group's current
        arena shapes, counted by ``roofline/op_cost.py`` where the
        reference asks XLA for the cost of a throwaway lowering.  The step
        runs under ``FakeTensorMode`` on fake CPU copies of the
        parameters, pools, lengths and block tables, with every slot live
        (the reference's lowering feeds ``live`` all ones): nothing is
        launched, allocated or written, the arena and the runtime's
        counters stay as they were (the ``*_traces`` gauges stay 0), and
        each kernel's work counts every slot at its table's full width, as
        a static step's cost analysis does.  Returns op_cost's counts
        (``"flops"``, ``"bytes accessed"``, per-kernel FLOPs, bytes and
        calls) and, for a head-sharded step, the bytes its mesh reductions
        move.  A group without an arena yet is priced at its arena's
        shapes on the ``meta`` device."""
        arena = self.groups[group].arena or self._new_arena(meta=True)
        mode = op_cost.FakeTensorMode()
        fake = lambda t: op_cost.fake_copy(t, mode)
        rt, shadow = copy.copy(self), copy.copy(arena)
        shadow.shard_pages = [fake(p) for p in arena.shard_pages]
        shadow.pages = shadow.shard_pages[0]
        shadow.shard_state = [fake(st) for st in arena.shard_state]
        shadow.state, shadow.lens = shadow.shard_state[0], fake(arena.lens)
        shadow._views = {}
        cpu = torch.device("cpu")
        shadow._tables_dev = {cpu: fake(arena.device_block_tables())}
        shadow.device = cpu
        mesh = None
        if self.sharded_step is not None:
            rt.sharded_step = sharded = copy.copy(self.sharded_step)
            sharded.mesh = mesh = copy.copy(sharded.mesh)
            sharded.devices = [cpu] * sharded.tp
            sharded.shards = [dataclasses.replace(sh, params=fake(sh.params))
                              for sh in sharded.shards]
        else:
            rt.params = fake(self.params)
        with mode:
            tokens = torch.zeros((arena.capacity,), dtype=torch.int32)
            live = torch.ones((arena.capacity,), dtype=torch.bool)
        with mode, torch.no_grad(), moe.drops_uncounted(), \
                op_cost.count(mesh) as cost:
            ServiceRuntime._paged_decode(rt, shadow, tokens, live)
        return cost.to_dict()

    def _decode_group_paged(self, state: _GroupState) -> None:
        """(c) One fused decode step over every slot of the arena for the
        decoding slots, then one speculation round for the slots whose
        draft has caught up."""
        arena = state.arena
        cap = arena.capacity
        k = self.speculate_k
        tokens = np.zeros((cap,), np.int32)
        live = np.zeros((cap,), bool)
        seeds = np.zeros((cap,), np.int64)
        sids = np.zeros((cap,), np.int64)
        offs = np.zeros((cap,), np.int64)
        spec_round: List[_Slot] = []
        for s in state.slots:
            if s.done or s.prefilling:
                continue
            if s.spec:
                if (len(s.req.tokens) + len(s.emitted) + k
                        > arena.slot_tokens):
                    # the tail of generation: a full round would write past
                    # the slot's table, so it finishes with plain decode
                    self._drop_draft(state, s)
                    self.spec_degraded += 1
                elif s.draft_len >= self._spec_goal(s):
                    spec_round.append(s)
                    continue
                # else: the draft is still chasing; decode normally
            sid = s.slot_id
            tokens[sid] = s.emitted[-1]
            live[sid] = True
            seeds[sid] = self._req_seed(s.req) & 0xFFFFFFFF
            sids[sid] = s.sample_idx
            offs[sid] = len(s.emitted)
            # the append position can sit in a block the prefix index froze
            # or another slot (an n>1 sibling) shares: copy first (free
            # when nothing in the pool is shared)
            pos = (len(s.req.tokens) + self._extra_cache_tokens()
                   + len(s.emitted) - 1)
            copied = arena.ensure_writable(sid, pos, 1)
            if copied:
                self.admission_copy_bytes += (copied * arena.block_size
                                              * arena.token_bytes)
        if live.any():
            dev = self.device
            live_dev = torch.from_numpy(live).to(dev)
            logits = self._paged_decode(arena, torch.from_numpy(tokens).to(
                dev), live_dev)
            tr = self.trace
            ts0 = tr.clock() if tr.enabled else 0.0
            toks = self._sample(
                logits, seeds, sids, offs, live=live_dev,
                occupancy=arena.device_occupancy()).cpu().numpy()
            if tr.enabled:
                tr.complete(self.obs_name, "engine", "sample", ts0,
                            live=int(live.sum()))
            self.decode_steps += 1
            for slot in state.slots:
                if slot.done or slot.prefilling or not live[slot.slot_id]:
                    continue
                slot.steps += 1
                slot.push(int(toks[slot.slot_id]))
        if spec_round:
            self._spec_round(state, spec_round)

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
        toks = self._sample(
            logits, [self._req_seed(s.req) for s in state.slots],
            [s.sample_idx for s in state.slots],
            [len(s.emitted) for s in state.slots],
            live=torch.from_numpy(live).to(dev)).cpu().numpy()
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

    def _phase_mark(self, name: str, start: float, **args) -> float:
        """Emit one engine-phase complete event ending now and return that
        end, the next phase's start (a contiguous phase track)."""
        end = self.trace.clock()
        self.trace.complete(self.obs_name, "engine", name, start, end,
                            **args)
        return end

    def _take_evacuated(self) -> int:
        """Evacuations since the last step, folded into ``StepStats``."""
        n = self._evacuated_pending
        self._evacuated_pending = 0
        return n

    def evacuate(self, now: float = 0.0) -> List[GenerationRequest]:
        """Crash this runtime's data plane: strip every queued, in-flight
        and parked request out and return them, one per rid, for
        resubmission.  Live slots free their arena slots with no prefix
        insert (the slot died mid-flight), and parked entries release their
        frozen blocks; the warm prefix index is kept, so a resubmission
        here re-prefills from it as it stands."""
        out: Dict[int, GenerationRequest] = {}
        # (1) queued work, including the rids _park_slot re-queued
        for item, _ in self.composer.shed(lambda item: True):
            out.setdefault(item.payload.rid, item.payload)
        # (2) live slots free their draft and arena slots.  Slot rids are
        # finished here (through the sibling refcount, once per rid) and
        # skipped in the last pass; queued and parked rids never overlap
        # live slots
        slot_rids = set()
        for state in self.groups.values():
            for s in state.slots:
                self._drop_draft(state, s)
                if state.arena is not None:
                    state.arena.free(s.slot_id)
                if self.trace.enabled:
                    self.trace.close(self.obs_name, self._slot_tid(s),
                                     outcome="evacuated")
                out.setdefault(s.req.rid, s.req)
                slot_rids.add(s.req.rid)
                self._finish_sibling(s.req)
            state.slots = []
            if state.arena is None:
                state.cache = None
        # (3) parked entries: their frozen blocks go back to the arena (the
        # rid itself is already in ``out`` through the composer drain)
        for rid in list(self.admission.parked):
            entry = self.admission.pop_parked(rid)
            if entry is None:
                continue
            arena = self.groups[entry.group].arena
            if arena is not None:
                arena.release_parked(entry.blocks)
            out.setdefault(entry.req.rid, entry.req)
        for req in out.values():
            if req.rid in slot_rids:
                continue
            if self.trace.enabled:
                self.trace.close(self.obs_name, str(req.rid),
                                 outcome="evacuated")
            self._finish_request(req)
        self.evacuations += 1
        self.evacuated_requests += len(out)
        self._evacuated_pending += len(out)
        return list(out.values())

    def _step_continuous(self, now: float, max_wait_s: float) -> StepStats:
        tr = self.trace
        t_phase = step_t0 = tr.clock() if tr.enabled else 0.0
        copy0, whole0 = self.admission_copy_bytes, self.whole_cache_copies
        chunkw0, steps0 = self.chunk_write_bytes, self.decode_steps
        one0 = self.oneshot_prefills
        draft0, ver0 = self.draft_steps, self.verify_launches
        acc0, deg0 = self.accepted_tokens, self.spec_degraded
        fk0, fs0 = self.forks_spawned, self.fork_shortfall
        pfx0 = self._prefix_totals()
        results: List[GenerationResult] = []
        for group, state in self.groups.items():
            results.extend(self._evict(group, state, now))
        if tr.enabled:
            t_phase = self._phase_mark("evict", t_phase,
                                       evicted=len(results))
        # admission control (inert under "fifo"): learn the caller's clock,
        # order by slack, shed with verdicts, then park a victim if the
        # urgent head can't wait, all before compose, so that the freed
        # slot goes to the strictest deadline
        ctrl = self.admission
        rejected: List[AdmissionReject] = []
        preempt0, resume0 = ctrl.preemptions, ctrl.resumes
        if ctrl.active:
            ctrl.note_step(now)
            ctrl.order(now)          # slack order first: shed walks it
            rejected = self._shed_rejected(now)
            self._maybe_preempt(now)
            if tr.enabled:
                t_phase = self._phase_mark(
                    "preempt", t_phase, shed=len(rejected),
                    parked=ctrl.preemptions - preempt0)
        admitted = self._admit(now, max_wait_s)
        if tr.enabled:
            t_phase = self._phase_mark("admit", t_phase, admitted=admitted)
        chunk_tokens = 0
        for state in self.groups.values():
            n = self._prefill_chunks(state)
            chunk_tokens += n
            self._draft_chunks(state)
            if tr.enabled:
                t_phase = self._phase_mark("chunk", t_phase, tokens=n)
            self._decode_group(state)
            if tr.enabled:
                t_phase = self._phase_mark("fused_decode", t_phase)
        pfx1 = self._prefix_totals()
        if tr.enabled:
            tr.complete(self.obs_name, "engine", "step", step_t0,
                        admitted=admitted, evicted=len(results),
                        in_flight=self.in_flight(),
                        pending=self.pending())
        verdict_count = lambda v: sum(1 for r in rejected
                                      if r.verdict is v)
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
            prefix_cow_blocks=pfx1[4] - pfx0[4],
            rejected=rejected,
            deadline_missed=verdict_count(Outcome.DEADLINE_MISSED),
            congestion_rejects=verdict_count(Outcome.CONGESTION),
            offload_verdicts=verdict_count(Outcome.OFFLOAD),
            failed_rejects=verdict_count(Outcome.FAILED),
            evacuated=self._take_evacuated(),
            preempted=ctrl.preemptions - preempt0,
            resumed=ctrl.resumes - resume0,
            parked=len(ctrl.parked),
            draft_steps=self.draft_steps - draft0,
            verify_launches=self.verify_launches - ver0,
            accepted_tokens=self.accepted_tokens - acc0,
            spec_slots=sum(1 for g in self.groups.values()
                           for s in g.slots if s.spec and not s.done),
            forks_spawned=self.forks_spawned - fk0,
            fork_shortfall=self.fork_shortfall - fs0,
            spec_degraded=self.spec_degraded - deg0)

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
        cur = self._sample(logits, seeds, zeros, zeros)
        outs = [cur]
        for i in range(max_new - 1):
            logits, cache = self.api.decode_step(self.params, self.cfg, cur,
                                                 cache)
            cur = self._sample(logits, seeds, zeros, [i + 1] * len(reqs))
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
            self._finish_request(r)
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
        if self.metrics is not None:
            self.metrics.observe_step(self.obs_name, stats, runtime=self)
        return stats

    def drain(self, now: float = 0.0,
              max_wait_s: float = 0.0) -> List[GenerationResult]:
        """Step until queue and slots are empty; returns all results."""
        out: List[GenerationResult] = []
        while self.pending() or self.in_flight():
            before = (self.pending(), self.in_flight(), self.decode_steps,
                      self.prefill_chunk_calls, self.verify_launches,
                      self.draft_prefill_tokens)
            stats = self.step(now=now, max_wait_s=max_wait_s)
            out.extend(stats.results)
            if (self.pending(), self.in_flight(), self.decode_steps,
                    self.prefill_chunk_calls, self.verify_launches,
                    self.draft_prefill_tokens) == before \
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
        if not runtime._obs_named:
            # observability labels follow the deployed name (two services
            # can share a ModelConfig), unless the caller pinned one
            runtime.obs_name = name
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
        return self.serve_until_idle(now=now, max_wait_s=max_wait_s)

    def serve_until_idle(self, now: float = 0.0, max_wait_s: float = 0.0,
                         on_stats: Optional[Callable] = None,
                         clock: Optional[Callable[[], float]] = None
                         ) -> List[GenerationResult]:
        """Step every runtime round-robin until none can make progress,
        calling ``on_stats(service, stats)`` after each round.  ``clock``
        (when given) supplies each round's ``now``: a live clock is what
        makes the admission controller's deadlines bite (a frozen ``now``
        never expires anything)."""
        out: List[GenerationResult] = []
        progress = True
        while progress:
            progress = False
            for name, rt in self.runtimes.items():
                if not (rt.pending() or rt.in_flight()):
                    continue
                stats = rt.step(now=clock() if clock is not None else now,
                                max_wait_s=max_wait_s)
                self.last_stats[name] = stats
                out.extend(stats.results)
                if on_stats is not None:
                    on_stats(name, stats)
                if (stats.results or stats.admitted or stats.decode_steps
                        or stats.prefill_chunk_tokens or stats.rejected
                        or stats.verify_launches or stats.draft_steps):
                    progress = True
        self._results.extend(out)
        return out
