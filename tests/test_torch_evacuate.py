"""Crash evacuation (``ServiceRuntime.evacuate``) on the port against the
JAX reference.

A request wave runs in lockstep on the reference's ``ServiceRuntime``
(``impl="ref"``) and the port's, on the float32 toy config with the
reference's weights carried over by the bridge, each traced on a tick
clock (each read returns the next integer) and metered.  After a fixed
step, chosen so that some requests are queued, some mid-prefill and some
decoding, both runtimes are evacuated.  The returned requests (the same
rids in the same order), the counters, the next ``StepStats.evacuated``,
the arena (free list, idle cached blocks, refcounts, live slots), the
sticky-session pins and the warm prefix index must equal the reference's.
The returned requests are then resubmitted to the same runtime and served
to idle: their tokens equal the reference's and those of an uninterrupted
run, the event streams are equal event for event (a resubmitted rid's
timeline holds two ``request`` roots, the first closed with
``outcome="evacuated"``), and so are the count-valued metrics.  Every
comparison is exact.  One case evacuates an sdf runtime that holds a
parked request and a forked one (two sibling slots) at temperature 0.8:
the parked entry's blocks go back to the arena and each rid comes back
once.  The first test mirrors ``tests/test_faults.py``'s
``test_evacuate_strips_queued_and_inflight`` on the port.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.models.registry import model_api as jmodel_api
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import Tracer as JTracer
from repro.obs import parse_prometheus_text
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.models.config import ModelConfig
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

_CFG = toy_config()
KW = dict(max_seq_len=48, block_size=8, prefill_chunk=16)
# (runtime kwargs, plan kwargs, step after which the runtime is evacuated)
CASES = {
    "paged": ({}, {}, 2),
    "dense_view": (dict(paged_native=False), {}, 2),
    "oneshot": (dict(chunked_prefill=False), {}, 2),
    "dense": (dict(kvcache_impl="dense"), {}, 2),
    "sync": (dict(mode="sync"), {}, 1),
    "sticky": ({}, dict(bs=2, dp=2, sticky=True), 2),
}
WAVE = [(6, 5), (9, 4), (7, 6), (30, 3), (3, 7), (25, 5), (12, 4)]


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _ticks():
    n = itertools.count()
    return lambda: float(next(n))


@pytest.fixture(scope="module")
def weights():
    params = jmodel_api(_CFG).init(jax.random.PRNGKey(5), _CFG)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     _mirror(_CFG), "cpu")
    return params, tparams


def _runtimes(weights, kw, plan_kw, sens="latency", obs=True):
    plan_kw = dict(dict(bs=4), **plan_kw)
    jplan = JPlan(service="toy", category=JCat(JSens(sens), False),
                  **plan_kw)
    tplan = ParallelPlan(service="toy",
                         category=TaskCategory(Sensitivity(sens), False),
                         **plan_kw)
    kw = dict(KW, **kw)
    jobs = dict(tracer=JTracer(clock=_ticks()), metrics=JMetrics()) \
        if obs else {}
    tobs = dict(tracer=Tracer(clock=_ticks()), metrics=MetricsRegistry()) \
        if obs else {}
    return (JRuntime(_CFG, weights[0], jplan, impl="ref", **kw, **jobs),
            ServiceRuntime(_mirror(_CFG), weights[1], tplan, device="cpu",
                           **kw, **tobs))


def _prompts(seed=8, template=None):
    rng = np.random.default_rng(seed)
    out = []
    for n, new in WAVE:
        p = rng.integers(1, _CFG.vocab_size, n).astype(np.int32)
        if template is not None:
            p = np.concatenate([template, p[:8]])
        out.append((p, new))
    return out


def _submit(rt, request_cls, prompts):
    for rid, (prompt, new) in enumerate(prompts):
        rt.submit(request_cls(rid=rid, tokens=prompt, max_new_tokens=new,
                              stream=rid))


def _tokens(results):
    return {r.rid: tuple(int(x) for x in r.tokens) for r in results}


def _assert_same_arenas(jrt, trt):
    for g, tstate in trt.groups.items():
        ja, ta = jrt.groups[g].arena, tstate.arena
        assert (ja is None) == (ta is None)
        if ta is None:
            continue
        assert ta.live == ja.live == 0
        assert ta._free_blocks == ja._free_blocks
        assert list(ta._idle_cached) == list(ja._idle_cached)
        np.testing.assert_array_equal(ta._block_refs, ja._block_refs)
        assert ta.free_capacity == ja.free_capacity == ta.pool_blocks
        assert ta.parked_blocks == 0


def _count_series(text):
    return {k: v for k, v in parse_prometheus_text(text).items()
            if "seconds" not in k.split("{")[0]
            or k.split("{")[0].endswith("_seconds_count")}


def test_evacuate_strips_queued_and_inflight(weights):
    """``tests/test_faults.py``'s case on the port (and the reference):
    two in flight, three queued; all five come back, the delta shows once
    in ``StepStats``, and the runtime serves again."""
    jrt, trt = _runtimes(weights, {}, dict(bs=2), obs=False)
    for rt, cls in ((jrt, JRequest), (trt, GenerationRequest)):
        for i in range(5):
            rt.submit(cls(rid=i, tokens=np.arange(1, 7, dtype=np.int32),
                          max_new_tokens=6, stream=i), now=0.0)
        rt.step(now=1.0)
        assert rt.in_flight() and rt.pending()
    reqs = trt.evacuate(now=2.0)
    assert [r.rid for r in reqs] == [r.rid for r in jrt.evacuate(now=2.0)]
    assert sorted(r.rid for r in reqs) == [0, 1, 2, 3, 4]
    assert trt.pending() == 0 and trt.in_flight() == 0
    assert trt.evacuations == 1 and trt.evacuated_requests == 5
    _assert_same_arenas(jrt, trt)
    assert trt.step(now=3.0).evacuated == jrt.step(now=3.0).evacuated == 5
    assert trt.step(now=4.0).evacuated == 0
    trt.submit(GenerationRequest(rid=100, tokens=np.arange(
        1, 7, dtype=np.int32), max_new_tokens=4, stream=100), now=5.0)
    assert [r.rid for r in trt.drain(now=5.0)] == [100]


@pytest.mark.parametrize("case", sorted(CASES))
def test_evacuate_matches_reference(weights, case):
    kw, plan_kw, at = CASES[case]
    prompts = _prompts()
    _, clean = _runtimes(weights, kw, plan_kw, obs=False)
    _submit(clean, GenerationRequest, prompts)
    uninterrupted = _tokens(clean.drain())
    jrt, trt = _runtimes(weights, kw, plan_kw)
    _submit(jrt, JRequest, prompts)
    _submit(trt, GenerationRequest, prompts)
    served = {}
    for _ in range(at):
        jst, tst = jrt.step(), trt.step()
        assert _tokens(tst.results) == _tokens(jst.results)
        served.update(_tokens(tst.results))
    slots = [s for g in trt.groups.values() for s in g.slots]
    assert trt.pending() > 0
    if case in ("paged", "dense_view", "sticky"):
        assert any(s.prefilling for s in slots)
        assert any(not s.prefilling and not s.done for s in slots)
    assert (trt.router.sessions() > 0) == (case == "sticky")
    jback, tback = jrt.evacuate(), trt.evacuate()
    assert [r.rid for r in tback] == [r.rid for r in jback]
    assert len(tback) == len(prompts) - len(served)
    assert trt.pending() == trt.in_flight() == 0
    assert (trt.evacuations, trt.evacuated_requests) \
        == (jrt.evacuations, jrt.evacuated_requests) == (1, len(tback))
    assert trt.router.sessions() == jrt.router.sessions() == 0
    _assert_same_arenas(jrt, trt)
    jst, tst = jrt.step(), trt.step()
    # the reference's sync step reports no evacuations in its StepStats
    assert tst.evacuated == jst.evacuated \
        == (0 if case == "sync" else len(tback))
    assert trt.step().evacuated == jrt.step().evacuated == 0
    for r in jback:
        jrt.submit(r)
    for r in tback:
        trt.submit(r)
    again, jagain = _tokens(trt.drain()), _tokens(jrt.drain())
    assert again == jagain
    assert {**served, **again} == uninterrupted
    assert trt.trace.events() == jrt.trace.events()
    got = _count_series(trt.metrics.prometheus_text())
    want = _count_series(jrt.metrics.prometheus_text())
    for k in [k for k in want if "_compiles{" in k]:
        assert got.pop(k) == 0.0        # the port compiles nothing
        want.pop(k)
    assert got == want
    assert got.get('epara_step_evacuated_total{service="toy"}', 0.0) \
        == (0 if case == "sync" else len(tback))
    for r in tback:
        roots, _ = trt.trace.span_tree("toy", str(r.rid))
        assert [s.name for s in roots] == ["request", "request"]
        assert roots[0].args["outcome"] == "evacuated"
        assert roots[1].args["outcome"] == "served"


def test_evacuate_keeps_the_warm_prefix_index(weights):
    """The prefix index outlives the crash: requests on a served donor's
    template hit it when they are resubmitted to the same runtime, as on
    the reference."""
    rng = np.random.default_rng(3)
    template = rng.integers(1, _CFG.vocab_size, 24).astype(np.int32)
    prompts = _prompts(seed=9, template=template)
    jrt, trt = _runtimes(weights, {}, {}, sens="frequency")
    for rt, cls in ((jrt, JRequest), (trt, GenerationRequest)):
        assert rt.prefix_cache_enabled
        rt.submit(cls(rid=99, tokens=template, max_new_tokens=2))
        rt.drain()
        _submit(rt, cls, prompts)
        rt.step()
    hits0 = trt.prefix_hits
    jback, tback = jrt.evacuate(), trt.evacuate()
    assert [r.rid for r in tback] == [r.rid for r in jback]
    _assert_same_arenas(jrt, trt)
    assert any(g.prefix.root.children for g in trt.groups.values())
    for rt, back in ((jrt, jback), (trt, tback)):
        for r in back:
            rt.submit(r)
    assert _tokens(trt.drain()) == _tokens(jrt.drain())
    assert trt.prefix_hits == jrt.prefix_hits
    assert trt.prefix_hits - hits0 >= len(tback)
    assert trt.prefill_tokens_computed == jrt.prefill_tokens_computed


def test_evacuate_releases_parked_entries_and_forks(weights):
    """An sdf runtime (3 slots, up to 2 samples a request, temperature 0.8)
    holds a forked request on two sibling slots, a parked lazy request
    and a queued one when it is evacuated: the returned rids (each once),
    the arena (no parked block, no live slot), the controller, the
    sibling refcounts and the event streams equal the reference's, and
    the resubmitted requests are served with the reference's tokens."""
    from repro.serving.sampler import SamplerConfig as JSampler
    from repro_torch.serving.sampler import SamplerConfig
    kw = dict(bs=3, admission="sdf", n_samples=2)
    jplan = JPlan(service="toy", category=JCat(JSens.LATENCY, False), **kw)
    tplan = ParallelPlan(service="toy", category=TaskCategory(
        Sensitivity.LATENCY, False), **kw)
    rts = (JRuntime(_CFG, weights[0], jplan, impl="ref",
                    sampler=JSampler(0.8, 40),
                    tracer=JTracer(clock=_ticks()), **KW),
           ServiceRuntime(_mirror(_CFG), weights[1], tplan, device="cpu",
                          sampler=SamplerConfig(0.8, 40),
                          tracer=Tracer(clock=_ticks()), **KW))
    backs, served = [], []
    for rt, cls in zip(rts, (JRequest, GenerationRequest)):
        t = 0.0
        for rid in (100, 101):
            rt.submit(cls(rid=rid, tokens=np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=4), now=t)
        done = []
        while rt.pending() or rt.in_flight():
            done += rt.step(now=t).results
            t += 1.0
        rt.submit(cls(rid=10, tokens=np.arange(2, 8, dtype=np.int32),
                      max_new_tokens=20, n_samples=2), now=t)
        rt.submit(cls(rid=11, tokens=np.arange(3, 9, dtype=np.int32),
                      max_new_tokens=30), now=t)
        for _ in range(2):
            done += rt.step(now=t).results
            t += 1.0
        rt.submit(cls(rid=7, tokens=np.arange(1, 5, dtype=np.int32),
                      max_new_tokens=4, deadline_s=t + 12.0), now=t)
        for _ in range(9):          # the park comes on the 8th step
            done += rt.step(now=t).results
            t += 1.0
        rt.submit(cls(rid=8, tokens=np.arange(4, 9, dtype=np.int32),
                      max_new_tokens=3), now=t)
        assert list(rt.admission.parked) == [11]
        assert rt._sibling_refs == {10: 2}
        assert rt.groups[0].arena.parked_blocks > 0
        back = rt.evacuate(now=t)
        arena = rt.groups[0].arena
        assert (arena.parked_blocks, arena.live) == (0, 0)
        assert not rt.admission.parked and not rt._sibling_refs
        assert rt.pending() == rt.in_flight() == 0
        backs.append([r.rid for r in back])
        for r in back:
            rt.submit(r, now=t)
        shed = []
        while rt.pending() or rt.in_flight():
            st = rt.step(now=t)
            done += st.results
            shed += [(r.req.rid, r.verdict.value) for r in st.rejected]
            t += 1.0
        served.append(({(r.rid, r.sample): tuple(int(x) for x in r.tokens)
                        for r in done}, shed))
    assert backs[1] == backs[0] and sorted(backs[1]) == [7, 8, 10, 11]
    # resubmitted, rid 7 has passed its deadline and is shed with a
    # verdict, and rid 10's fork finds no free slot beside the others (a
    # shortfall), as in the reference
    assert served[1] == served[0]
    assert sorted(served[1][0]) == [(8, 0), (10, 0), (11, 0), (100, 0),
                                    (101, 0)]
    assert served[1][1] == [(7, "deadline_missed")]
    jrt, trt = rts
    _assert_same_arenas(jrt, trt)
    assert trt.trace.events() == jrt.trace.events()
    assert (trt.admission.preemptions, trt.evacuated_requests) == (1, 4)
    roots, _ = trt.trace.span_tree("toy", "11")
    assert roots[0].args["outcome"] == "evacuated"
    assert [c.name for c in roots[0].children][-1] == "parked"
