"""Deadline-aware admission control: the request-granularity layer EPARA's
categorization implies but FIFO admission throws away.

The controller sits between the composers (``batching.py``) and the slot
engine (``engine.py``) and does three things, all in the CALLER'S clock
(the ``now`` passed to ``step()`` — wall time in the launcher, a logical
clock in benchmarks; every estimate below is learned from observed
``now`` deltas, so the two never mix):

* **Slack-ordered admission** (``StrictestDeadlineFirst``): pending
  ``QueuedItem``s are reordered by deadline slack — the remaining budget
  after subtracting the request's own estimated prefill + decode cost —
  so the next free slot always goes to the request closest to missing.
  The legacy FIFO order stays available as the ``ParallelPlan.admission``
  baseline knob ("fifo", the default: the controller is inert and the
  engine behaves exactly as before).

* **Explicit verdicts** — every request that does NOT get a slot carries
  exactly one ``Outcome`` verdict (no verdict-less drops):

  - ``DEADLINE_MISSED``: the slack estimate says it cannot finish
    anywhere in time (deadline passed, or its own service time alone
    exceeds the remaining budget) — shed before burning capacity;
  - ``OFFLOAD``: positive slack, but the local queue would burn it — a
    peer could still make the deadline, so the distributed handler
    (``core/handler.py``) should route it with its existing
    ``Outcome``/``Decision`` machinery;
  - ``CONGESTION``: hard local backpressure — the queue is beyond the
    congestion bound, shed from the laziest tail (this is the only
    verdict deadline-less requests can draw);
  - ``FAILED`` (issued by ``serving/failover.py``, never by this
    controller): the request was lost to a fault and every recovery
    avenue — timeout retries, peer re-routes, the bounded attempt
    budget — was exhausted.  Listed here because it shares the same
    ``AdmissionReject`` envelope and verdict accounting.

  Rejects surface per step through ``StepStats.rejected`` /
  ``StepStats.deadline_missed``/``congestion_rejects``/
  ``offload_verdicts``.

* **Preemption by block-table parking**: under pressure (zero free
  slots, an urgent head that would miss while waiting), the engine
  parks the laziest live decode slot — ``KVArena.park`` pops the slot's
  blocks WITHOUT releasing their references, so the KV stays resident
  while the slot itself frees.  The victim's request re-queues; its
  later re-admission stitches the parked blocks back via
  ``alloc(shared=...)`` — effectively a 100% prefix hit — restores the
  emitted tokens and device length, and continues bit-identically
  (greedy sampling; the PRNG key is unused at temperature 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.categories import Outcome
from .batching import QueuedItem

POLICY_FIFO = "fifo"
POLICY_SDF = "sdf"
ADMISSION_POLICIES = (POLICY_FIFO, POLICY_SDF)

_INF = float("inf")


@dataclasses.dataclass
class AdmissionReject:
    """One rejected request + its verdict (``StepStats.rejected`` entry).
    The launcher feeds OFFLOAD verdicts back into the control plane's
    handler so the request is forwarded instead of silently dropped."""
    req: Any                         # the GenerationRequest (or payload)
    verdict: Outcome
    now: float
    reason: str = ""
    attempts: int = 0                # placement attempts consumed before
    #                                  the verdict (failover retries)


@dataclasses.dataclass
class ParkedEntry:
    """Everything needed to resume a preempted request bit-identically:
    the frozen block list (one owned reference per block), the emitted
    tokens so far, and the device-side cache length at park time."""
    req: Any
    group: int                       # blocks are physical ids in THIS
    #                                  group's arena — resume must land here
    blocks: List[int]
    emitted: List[int]
    cache_len: int                   # device lens[slot] at park time
    consumed: int                    # prompt tokens prefilled at park time
    steps: int
    prefill_s: float
    admit_wall: float
    decode_start_wall: float
    admitted_s: float
    parked_s: float


class AdmissionController:
    """Slack accounting + verdict policy for one ``ServiceRuntime``.

    The controller owns the POLICY (who goes first, who is shed, who is
    preempted); the engine owns the MECHANISM (slots, arena, composer).
    All time estimates are EWMAs over the caller's clock:

    * ``_round_dt`` — ``now`` delta between consecutive engine steps (one
      fused decode round);
    * ``_svc_logical`` — admission→finish duration of completed requests.

    Before the first completion both are 0, so every estimate collapses
    to "free": a cold controller admits exactly like FIFO and only
    starts shedding/preempting once it has observed real service times —
    conservative by construction.
    """

    def __init__(self, runtime, policy: Optional[str] = None, *,
                 preempt: bool = True, congestion_factor: float = 8.0,
                 max_parked: Optional[int] = None):
        if policy is None:
            policy = getattr(runtime.plan, "admission", POLICY_FIFO)
        if policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission policy must be one of {ADMISSION_POLICIES}, "
                f"got {policy!r}")
        self.rt = runtime
        self.policy = policy
        self.preempt = bool(preempt)
        self.congestion_factor = float(congestion_factor)
        self._max_parked = max_parked
        self.parked: Dict[int, ParkedEntry] = {}     # rid -> entry
        self.verdicts: Dict[str, int] = {}           # cumulative, by value
        self.preemptions = 0                         # slots parked
        self.resumes = 0                             # parked re-admissions
        self._round_dt = 0.0
        self._svc_logical = 0.0
        self._last_now: Optional[float] = None

    # -- policy state ------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.policy == POLICY_SDF

    @property
    def max_parked(self) -> int:
        if self._max_parked is not None:
            return self._max_parked
        return self.rt.total_slots()

    def _count(self, outcome: Outcome) -> None:
        self.verdicts[outcome.value] = \
            self.verdicts.get(outcome.value, 0) + 1

    # -- clock-agnostic cost model ----------------------------------------
    def note_step(self, now: float) -> None:
        """Learn the caller's per-round clock advance (0 under a frozen
        clock — then every estimate is 0 and the policy never sheds on
        prediction, only on already-expired deadlines)."""
        if self._last_now is not None and now > self._last_now:
            dt = now - self._last_now
            self._round_dt = (dt if self._round_dt == 0.0
                              else 0.8 * self._round_dt + 0.2 * dt)
        self._last_now = now

    def observe(self, res) -> None:
        """Feed one completed ``GenerationResult``'s logical duration."""
        t = res.finished_s - res.admitted_s
        if t <= 0.0:
            return
        self._svc_logical = (t if self._svc_logical == 0.0
                             else 0.8 * self._svc_logical + 0.2 * t)

    def _rounds(self, req) -> float:
        """Engine rounds one queued request needs: its chunked-prefill
        rounds plus one fused decode round per new token."""
        rounds = float(getattr(req, "max_new_tokens", 1))
        chunk = getattr(self.rt, "prefill_chunk_tokens", 0)
        toks = getattr(req, "tokens", None)
        if chunk and toks is not None:
            rounds += -(-len(toks) // chunk)
        return rounds

    def service_estimate(self, req) -> float:
        """This request's own unavoidable service time (caller clock).  A
        parked request only owes its REMAINING decode rounds — its KV is
        resident, resume costs no prefill."""
        entry = self.parked.get(getattr(req, "rid", -1))
        if entry is not None:
            remaining = (getattr(req, "max_new_tokens", 1)
                         - len(entry.emitted))
            return max(0, remaining) * self._round_dt
        return self._rounds(req) * self._round_dt

    def slack(self, req, now: float) -> float:
        """Deadline budget left AFTER the request's own service time.
        ``inf`` for deadline-less requests (never shed on slack)."""
        deadline = getattr(req, "deadline_s", 0.0)
        if not deadline:
            return _INF
        return deadline - now - self.service_estimate(req)

    def wait_estimate(self, now: float, position: int = 0) -> float:
        """Expected queue wait before the request at slack-order
        ``position`` starts, in the caller's clock.  Under SDF the head
        does NOT wait out the whole queue — it takes the next slot that
        frees (~one slot-turn of the observed service time); position k
        waits k more slot-turns.  This is what makes OFFLOAD verdicts
        position-aware: the head is rescued locally (by waiting or by
        preemption), the deep tail is forwarded while a peer can still
        make its deadline."""
        turns = (position + 1) / max(1, self.rt.total_slots())
        return turns * self._svc_logical

    def slot_slack(self, slot, now: float) -> float:
        """Victim-selection slack of a LIVE decode slot: budget left after
        its remaining decode rounds.  Deadline-less slots are infinitely
        lazy — the preferred preemption victims."""
        deadline = getattr(slot.req, "deadline_s", 0.0)
        if not deadline:
            return _INF
        return deadline - now - self.remaining_estimate(slot)

    def remaining_estimate(self, slot) -> float:
        remaining = slot.req.max_new_tokens - len(slot.emitted)
        return max(0, remaining) * self._round_dt

    # -- the StrictestDeadlineFirst pass ----------------------------------
    def order(self, now: float) -> None:
        """Reorder pending admissions: strictest (least-slack) deadline
        first; deadline-less requests keep FIFO order among themselves at
        the back."""
        if not self.active:
            return
        self.rt.composer.reorder(
            lambda it: (self.slack(it.payload, now), it.enqueued_s))

    def shed(self, now: float) -> List[Tuple[QueuedItem, Outcome]]:
        """Walk the queue once and shed, with verdicts:

        * ``DEADLINE_MISSED`` — negative slack (cannot finish anywhere);
        * ``OFFLOAD`` — positive slack the local wait would burn (parked
          requests are exempt: their KV is local, forwarding loses it);
        * ``CONGESTION`` — survivors beyond ``congestion_factor × slots``,
          laziest first.

        Returns (item, verdict) pairs; the ENGINE releases parked blocks
        / session pins and builds the ``AdmissionReject`` records.
        """
        if not self.active or not len(self.rt.composer):
            return []
        survivors: List[Tuple[float, float]] = []

        def pred(item: QueuedItem) -> Optional[Outcome]:
            sl = self.slack(item.payload, now)
            if sl < 0.0:
                return Outcome.DEADLINE_MISSED
            # the caller reorders BEFORE shedding, so the walk runs in
            # slack order and len(survivors) is this item's queue
            # position.  Exemptions from OFFLOAD: parked requests (their
            # KV is local — forwarding loses it) and, when preemption is
            # on, the HEAD (position 0): parking a lazy victim is its
            # local rescue path, and preemption frees one slot per step —
            # exactly one head's worth.
            if sl != _INF and item.rid not in self.parked \
                    and not (self.preempt and not survivors) \
                    and self.wait_estimate(now, len(survivors)) > sl:
                return Outcome.OFFLOAD
            survivors.append((sl, item.enqueued_s))
            return None

        dropped = self.rt.composer.shed(pred)
        bound = int(self.congestion_factor
                    * max(1, self.rt.total_slots()))
        if len(survivors) > bound:
            cutoff = sorted(survivors)[bound - 1]

            def congest(item: QueuedItem) -> Optional[Outcome]:
                key = (self.slack(item.payload, now), item.enqueued_s)
                return Outcome.CONGESTION if key > cutoff else None

            dropped.extend(self.rt.composer.shed(congest))
        for _, verdict in dropped:
            self._count(verdict)
        return dropped

    # -- preemption bookkeeping (mechanism lives in the engine) -----------
    def pick_victim(self, urgent_slack: float, candidates) -> Optional[Any]:
        """Choose the laziest live slot worth parking for an urgent head.
        A victim must (a) be strictly lazier than the urgent request and
        (b) afford the round trip — its slack must cover the urgent
        request's slack plus its own remaining work (deadline-less slots
        always qualify).  Prefers the laziest, then the longest-remaining
        (frees capacity for longest).  ``candidates`` yields
        ``(slot_slack, remaining_estimate, token)`` triples."""
        best = None
        for vslack, vrem, token in candidates:
            if vslack <= urgent_slack:
                continue
            if vslack != _INF and vslack < urgent_slack + vrem:
                continue
            key = (vslack, vrem)
            if best is None or key > best[0]:
                best = (key, token)
        return None if best is None else best[1]

    def note_park(self, entry: ParkedEntry) -> None:
        self.parked[entry.req.rid] = entry
        self.preemptions += 1

    def pop_parked(self, rid: int) -> Optional[ParkedEntry]:
        return self.parked.pop(rid, None)

    def parked_group(self, rid: int) -> Optional[int]:
        entry = self.parked.get(rid)
        return None if entry is None else entry.group

    def note_resume(self) -> None:
        self.resumes += 1

    def note_admit(self, n: int = 1) -> None:
        """Count ADMIT verdicts (resumed re-admissions included — the
        engine's ``admitted`` tally already covers them)."""
        if self.active and n > 0:
            self.verdicts[Outcome.ADMIT.value] = \
                self.verdicts.get(Outcome.ADMIT.value, 0) + n
