"""BS / MF batch composition (§3.1 operators, Eq. 5).

* BS: group up to ``bs`` same-service requests per batch.
* MF (multi-frame): for frequency tasks, take an IDENTICAL number of frames
  (``mf``) from each of ``inter_request_count = floor(bs / mf)`` concurrent
  homogeneous streams, filling the batch even when single streams are
  bursty/uneven — the request-level trick that lifts GPU utilization.

Both composers implement the single ``Composer`` protocol: ``add`` /
``push_front`` / ``__len__`` / ``compose(*, limit, now, max_wait_s)``.
``compose`` is **capacity-aware** (``limit=k`` fills at most ``k`` items so
the continuous-batching engine can top up only the decode slots that are
actually free, instead of composing a full ``bs`` batch behind a barrier)
and takes the clock uniformly — BS simply ignores ``now``/``max_wait_s``,
so the engine and the simulator never special-case the composer family.
``push_front`` returns an item to the head of its queue (used when sticky
DP routing finds the session's replica group full).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import (Any, Callable, Deque, Dict, List, Optional, Protocol,
                    Tuple, runtime_checkable)

from repro_torch.core.allocator import ParallelPlan


@dataclasses.dataclass
class QueuedItem:
    payload: Any                 # tokens / frame embedding reference
    stream: int = 0              # stream/session id (MF groups by stream)
    enqueued_s: float = 0.0
    rid: int = 0


def _prefill_cost(item: QueuedItem) -> int:
    """Prompt tokens one queued item brings to the chunked-prefill phase
    (0 for payloads without a token prompt, e.g. simulator stand-ins)."""
    toks = getattr(item.payload, "tokens", None)
    return 0 if toks is None else len(toks)


@dataclasses.dataclass
class ComposedBatch:
    items: List[QueuedItem]
    mf: int                      # frames actually taken per stream (max)
    streams: Tuple[int, ...]     # which streams contributed
    frames_per_stream: Dict[int, int] = dataclasses.field(
        default_factory=dict)    # actual frames taken from each stream

    @property
    def size(self) -> int:
        return len(self.items)


@runtime_checkable
class Composer(Protocol):
    """What the slot engine requires of a batch composer.  One signature
    for every family: BS ignores the clock arguments, MF uses them for
    its overdue partial-flush semantics."""

    def add(self, item: QueuedItem) -> None: ...

    def push_front(self, item: QueuedItem) -> None: ...

    def __len__(self) -> int: ...

    def compose(self, *, limit: Optional[int] = None, now: float = 0.0,
                max_wait_s: float = float("inf")
                ) -> Optional[ComposedBatch]: ...

    def pending_prefill_tokens(self) -> int: ...

    # admission-control surface (serving/admission.py): the controller
    # reorders pending items by deadline slack, sheds the doomed ones with
    # explicit verdicts, and peeks the most urgent head to decide whether
    # preempting a live slot is worth it.
    def peek(self) -> Optional[QueuedItem]: ...

    def reorder(self, key: Callable[[QueuedItem], Any]) -> None: ...

    def shed(self, pred: Callable[[QueuedItem], Optional[Any]]
             ) -> List[Tuple[QueuedItem, Any]]: ...


def _frame_counts(items: List[QueuedItem]) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for it in items:
        counts[it.stream] = counts.get(it.stream, 0) + 1
    return counts


class BSComposer:
    """Latency tasks: plain FIFO batching up to ``bs`` (or ``limit``)."""

    def __init__(self, plan: ParallelPlan):
        self.plan = plan
        self.queue: Deque[QueuedItem] = collections.deque()

    def add(self, item: QueuedItem) -> None:
        self.queue.append(item)

    def push_front(self, item: QueuedItem) -> None:
        self.queue.appendleft(item)

    def __len__(self) -> int:
        return len(self.queue)

    def pending_prefill_tokens(self) -> int:
        """Queued prompt tokens — the chunked-prefill backlog the engine
        folds into its queue-time estimate."""
        return sum(_prefill_cost(it) for it in self.queue)

    def peek(self) -> Optional[QueuedItem]:
        return self.queue[0] if self.queue else None

    def reorder(self, key: Callable[[QueuedItem], Any]) -> None:
        """Re-sort the whole queue (slack-ordered admission); compose then
        pops in the new order."""
        self.queue = collections.deque(sorted(self.queue, key=key))

    def shed(self, pred: Callable[[QueuedItem], Optional[Any]]
             ) -> List[Tuple[QueuedItem, Any]]:
        """Drop every queued item for which ``pred`` returns a verdict
        (non-None); returns the (item, verdict) pairs in queue order."""
        kept: Deque[QueuedItem] = collections.deque()
        dropped: List[Tuple[QueuedItem, Any]] = []
        for it in self.queue:
            v = pred(it)
            if v is None:
                kept.append(it)
            else:
                dropped.append((it, v))
        self.queue = kept
        return dropped

    def compose(self, *, limit: Optional[int] = None, now: float = 0.0,
                max_wait_s: float = float("inf")
                ) -> Optional[ComposedBatch]:
        cap = self.plan.bs if limit is None else min(self.plan.bs, limit)
        if not self.queue or cap <= 0:
            return None
        items = []
        while self.queue and len(items) < cap:
            items.append(self.queue.popleft())
        counts = _frame_counts(items)
        return ComposedBatch(items=items, mf=max(counts.values()),
                             streams=tuple(counts),
                             frames_per_stream=counts)


class MFComposer:
    """Frequency tasks: per-stream queues; a batch takes exactly ``mf``
    frames from each of up to ``inter_request_count`` streams (Eq. 5).
    Falls back to fewer streams / partial mf when starved so frames never
    wait past their latency budget.  The composed batch reports the frames
    ACTUALLY taken per stream (a starved partial flush takes fewer than the
    plan's ``mf``)."""

    def __init__(self, plan: ParallelPlan):
        self.plan = plan
        self.streams: Dict[int, Deque[QueuedItem]] = {}
        self._key: Optional[Callable[[QueuedItem], Any]] = None

    def add(self, item: QueuedItem) -> None:
        self.streams.setdefault(item.stream, collections.deque()).append(item)

    def push_front(self, item: QueuedItem) -> None:
        self.streams.setdefault(item.stream,
                                collections.deque()).appendleft(item)

    def __len__(self) -> int:
        return sum(len(q) for q in self.streams.values())

    def pending_prefill_tokens(self) -> int:
        return sum(_prefill_cost(it) for q in self.streams.values()
                   for it in q)

    def peek(self) -> Optional[QueuedItem]:
        heads = [q[0] for q in self.streams.values() if q]
        if not heads:
            return None
        key = self._key or (lambda it: it.enqueued_s)
        return min(heads, key=key)

    def reorder(self, key: Callable[[QueuedItem], Any]) -> None:
        """MF keeps frames in per-stream FIFO order (frames of one stream
        are totally ordered); slack ordering applies ACROSS streams — the
        stored key decides which streams a composed batch draws from
        first."""
        self._key = key

    def shed(self, pred: Callable[[QueuedItem], Optional[Any]]
             ) -> List[Tuple[QueuedItem, Any]]:
        dropped: List[Tuple[QueuedItem, Any]] = []
        for s in list(self.streams):
            kept: Deque[QueuedItem] = collections.deque()
            for it in self.streams[s]:
                v = pred(it)
                if v is None:
                    kept.append(it)
                else:
                    dropped.append((it, v))
            if kept:
                self.streams[s] = kept
            else:
                del self.streams[s]
        return dropped

    def compose(self, *, limit: Optional[int] = None, now: float = 0.0,
                max_wait_s: float = float("inf")
                ) -> Optional[ComposedBatch]:
        mf = max(1, self.plan.mf)
        irc = self.plan.inter_request_count
        cap = self.plan.bs if limit is None else min(self.plan.bs, limit)
        if cap <= 0:
            return None
        if cap < mf:             # few free slots: admit a partial mf rather
            mf = cap             # than stalling admission entirely
        irc = max(1, min(irc, cap // mf))
        ready = [s for s, q in self.streams.items() if len(q) >= mf]
        overdue = any(q and now - q[0].enqueued_s >= max_wait_s
                      for q in self.streams.values())
        if len(ready) < 1 and not overdue:
            return None
        if not ready and overdue:
            # partial-mf flush: take whatever the oldest streams have
            ready = sorted((s for s, q in self.streams.items() if q),
                           key=lambda s: self.streams[s][0].enqueued_s)
        elif self._key is not None:
            # slack-ordered admission: most urgent stream head first
            ready.sort(key=lambda s: self._key(self.streams[s][0]))
        take_streams = ready[:irc]
        items: List[QueuedItem] = []
        budget = cap
        for s in take_streams:
            q = self.streams[s]
            take = min(mf, len(q), budget)
            for _ in range(take):
                items.append(q.popleft())
            budget -= take
            if budget <= 0:
                break
        for s in list(self.streams):
            if not self.streams[s]:
                del self.streams[s]
        if not items:
            return None
        counts = _frame_counts(items)
        return ComposedBatch(items=items, mf=max(counts.values()),
                             streams=tuple(s for s in take_streams
                                           if s in counts),
                             frames_per_stream=counts)


def make_composer(plan: ParallelPlan) -> Composer:
    from repro_torch.core.categories import Sensitivity
    if plan.category.sensitivity == Sensitivity.FREQUENCY and plan.mf > 1:
        return MFComposer(plan)
    return BSComposer(plan)
