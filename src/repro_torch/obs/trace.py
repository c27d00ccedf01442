"""Span-based request-lifecycle + engine-phase tracer.

Zero-dependency, host-side only: the tracer never touches a jax array or
a compiled function, so enabling it cannot change emitted tokens or
compile counts — it wall-clocks and annotates what the engine already
does.  Two kinds of timelines share one bounded ring buffer:

* **per-request lifecycle** — one logical thread per request id
  (``tid=str(rid)``; n>1 sampling forks get ``"rid.sample"``), with a
  properly nested span stack::

      request                      submit -> finish/verdict
        queued                     submit -> admission (or verdict)
        prefill                    admission -> first token
          prefill_chunk ...        one complete event per (b2) chunk
        decode                     first token -> done
          spec_round ...           one complete event per verify round
        parked                     preemption park -> resume
        decode                     resume -> done (re-opened)

* **per-step engine phases** — complete events on ``tid="engine"``
  (``step`` / ``evict`` / ``admit`` / ``preempt`` / ``chunk`` /
  ``fused_decode`` / ``verify`` / ``sample``), so a Perfetto track shows
  where each scheduling round's wall time went.

The ring buffer (``capacity`` finished events; oldest dropped, counted
in ``dropped``) bounds memory on long serves.  ``chrome_trace()``
exports the Chrome trace-event JSON (``ph``/``ts``/``dur``/``pid``/
``tid`` complete+instant+metadata events) that Perfetto/chrome://tracing
load directly; ``span_tree()`` rebuilds the nested span forest of one
timeline for programmatic checks (the tests' balance/monotonicity
invariants).

A module-level ``NULL_TRACER`` no-ops every method with ``enabled =
False`` — the engine holds it by default so the disabled layer costs one
predicate per call site and allocates nothing.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# event record layout (tuples, not dicts: the ring buffer holds many)
_COMPLETE, _INSTANT = "X", "i"


@dataclasses.dataclass
class Span:
    """One reconstructed span of a timeline's tree (``span_tree``)."""
    name: str
    start: float                 # tracer-clock seconds
    end: float
    args: Dict[str, Any]
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def dur(self) -> float:
        return self.end - self.start


class _NullTracer:
    """The disabled layer: every method is a no-op, ``enabled`` is
    False so call sites can skip building args entirely."""
    enabled = False

    def begin(self, *a, **k):
        pass

    def end(self, *a, **k):
        pass

    def complete(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def close(self, *a, **k):
        pass

    def clock(self) -> float:
        return 0.0


NULL_TRACER = _NullTracer()


class Tracer:
    """Bounded-ring span recorder with Chrome trace-event export."""

    enabled = True

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.clock = time.perf_counter if clock is None else clock
        self._events: deque = deque(maxlen=capacity)
        self._stacks: Dict[Tuple[str, str], List] = {}
        self.dropped = 0
        self.emitted = 0

    # -- recording ------------------------------------------------------
    def _push(self, rec) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(rec)
        self.emitted += 1

    def begin(self, pid: str, tid: str, name: str,
              ts: Optional[float] = None, **args) -> None:
        """Open a nested span on the (pid, tid) timeline."""
        ts = self.clock() if ts is None else ts
        self._stacks.setdefault((pid, tid), []).append([name, ts, args])

    def end(self, pid: str, tid: str, ts: Optional[float] = None,
            **args) -> None:
        """Close the innermost open span of the timeline (no-op when
        nothing is open, so lifecycle teardown paths can close
        defensively)."""
        stack = self._stacks.get((pid, tid))
        if not stack:
            return
        ts = self.clock() if ts is None else ts
        name, t0, a0 = stack.pop()
        if args:
            a0 = {**a0, **args}
        self._push((_COMPLETE, pid, tid, name, t0, max(ts, t0), a0))
        if not stack:
            self._stacks.pop((pid, tid), None)

    def close(self, pid: str, tid: str, **args) -> None:
        """End EVERY open span of the timeline (innermost first) — the
        request-teardown hook that keeps trees balanced no matter which
        state (queued / prefill / decode / parked) the request dies in.
        Extra ``args`` (e.g. an admission verdict) land on the outermost
        span."""
        stack = self._stacks.get((pid, tid))
        while stack:
            self.end(pid, tid, **(args if len(stack) == 1 else {}))
            stack = self._stacks.get((pid, tid))

    def complete(self, pid: str, tid: str, name: str, start: float,
                 end: Optional[float] = None, **args) -> None:
        """Record an already-timed span (phase timings, chunk calls)."""
        end = self.clock() if end is None else end
        self._push((_COMPLETE, pid, tid, name, start, max(end, start),
                    args))

    def instant(self, pid: str, tid: str, name: str,
                ts: Optional[float] = None, **args) -> None:
        ts = self.clock() if ts is None else ts
        self._push((_INSTANT, pid, tid, name, ts, ts, args))

    # -- introspection / export ----------------------------------------
    def open_spans(self, pid: str, tid: str) -> List[str]:
        return [e[0] for e in self._stacks.get((pid, tid), [])]

    def events(self) -> List[Tuple]:
        return list(self._events)

    def timelines(self) -> List[Tuple[str, str]]:
        seen: Dict[Tuple[str, str], None] = {}
        for rec in self._events:
            seen.setdefault((rec[1], rec[2]))
        return list(seen)

    def span_tree(self, pid: str, tid: str
                  ) -> Tuple[List[Span], List[Span]]:
        """Rebuild one timeline's nested span forest from its finished
        complete events.  Returns ``(roots, instants)``; instants are
        zero-duration leaves reported separately.  Reconstruction is the
        standard interval-stack replay — valid because the recording API
        only ever closes the innermost span, so finished events of one
        timeline are properly nested by construction."""
        spans = []
        instants = []
        for rec in self._events:
            kind, p, t, name, t0, t1, args = rec
            if (p, t) != (pid, tid):
                continue
            if kind == _INSTANT:
                instants.append(Span(name, t0, t1, dict(args)))
            else:
                spans.append(Span(name, t0, t1, dict(args)))
        # sort outer-first: by start asc, then end desc (parent before
        # child when they share a start timestamp)
        spans.sort(key=lambda s: (s.start, -s.end))
        roots: List[Span] = []
        stack: List[Span] = []
        for s in spans:
            while stack and s.start >= stack[-1].end:
                stack.pop()
            if stack:
                stack[-1].children.append(s)
            else:
                roots.append(s)
            stack.append(s)
        return roots, instants

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON dict (load in Perfetto or
        chrome://tracing).  pids/tids are dense ints with
        ``process_name`` / ``thread_name`` metadata events carrying the
        service / request names; ``ts``/``dur`` are microseconds."""
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}
        out: List[Dict[str, Any]] = []
        for rec in self._events:
            kind, p, t, name, t0, t1, args = rec
            pid = pids.setdefault(p, len(pids) + 1)
            tid = tids.setdefault((p, t), len(tids) + 1)
            ev: Dict[str, Any] = {
                "name": name, "cat": "obs", "ph": kind, "pid": pid,
                "tid": tid, "ts": round(t0 * 1e6, 3)}
            if kind == _COMPLETE:
                ev["dur"] = round((t1 - t0) * 1e6, 3)
            else:
                ev["s"] = "t"
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        meta: List[Dict[str, Any]] = []
        for p, pid in pids.items():
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": p}})
        for (p, t), tid in tids.items():
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": pids[p], "tid": tid, "args": {"name": t}})
        return {"traceEvents": meta + out,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "emitted_events": self.emitted}}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def validate_chrome_trace(doc: Any) -> int:
    """Structural check of an exported trace document: well-formed
    ``traceEvents`` with the mandatory ``ph``/``ts``/``pid`` fields
    (``dur`` on complete events).  Returns the event count; raises
    ``ValueError`` on the first malformed event — the CI smoke gate."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must carry a traceEvents list")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        if ev.get("ph") == "M":
            if "name" not in ev or "pid" not in ev:
                raise ValueError(f"metadata event {i} lacks name/pid")
            continue
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} lacks {field!r}: {ev}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event {i} lacks dur: {ev}")
        if ev["ph"] == "X" and ev["dur"] < 0:
            raise ValueError(f"event {i} has negative dur: {ev}")
    return len(events)
