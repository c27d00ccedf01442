"""Deadline-aware admission control on the port against the JAX reference.

* The controller: ``repro_torch/serving/admission.py`` is a verbatim copy
  of the reference's (``tests/test_torch_prefix_cache.py`` diffs it).
  ``tests/test_admission.py``'s unit tests of the policy knob, the cold
  controller, the cost model learned from the caller's clock, the parked
  request's remaining cost and the victim guards run on both copies, over
  the same stub runtime and the same composer.
* The arena: parking keeps the blocks and frees the slot, a parked hold
  released returns the blocks, and a per-slot-state arena refuses to park,
  on the port's ``KVArena`` (the reference's op-by-op twin is
  ``tests/test_torch_prefix_cache.py``).
* The engine, on the float32 toy config with the reference's weights
  carried over by the bridge: expired deadlines draw verdicts (fifo serves
  them); the preemption scenario under fifo, sdf and sdf with
  ``preempt=False``; a stochastic request parked and resumed whose chain
  equals its never-parked chain; the hypothesis interleavings of
  ``tests/test_admission.py`` (5 examples); and the reference's goodput
  overload trace (``profile_step.goodput_trace``), greedy and at
  temperature 0.8, int8 and bf16 KV.  Each runs on the reference's
  ``ServiceRuntime`` (``impl="ref"``) and the port's: verdicts, preemptions,
  resumes, every ``finished_s`` and every token are equal, exactly.
* The CPU launcher serves with ``--admission-policy sdf``, ``--deadline-s``
  and ``--n-samples`` and prints its admission line.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import toy_config
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import REJECT_VERDICTS as J_REJECT
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.models import transformer as jtransformer
from repro.serving import admission as jadmission
from repro.serving.batching import BSComposer as JBSComposer
from repro.serving.batching import QueuedItem as JQueuedItem
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import REJECT_VERDICTS, Outcome, Sensitivity
from repro_torch.core.categories import TaskCategory
from repro_torch.launch import serve
from repro_torch.launch.profile_step import goodput_trace
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import admission
from repro_torch.serving.arena import KVArena
from repro_torch.serving.batching import BSComposer, QueuedItem
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
from repro_torch.serving.sampler import SamplerConfig

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

_CFG = toy_config()


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# the controller on both copies
# ---------------------------------------------------------------------------

SIDES = {
    "reference": (jadmission, JPlan, JCat, JSens, JBSComposer, JQueuedItem,
                  JRequest),
    "port": (admission, ParallelPlan, TaskCategory, Sensitivity, BSComposer,
             QueuedItem, GenerationRequest)}


class _Stub:
    """``tests/test_admission.py``'s stub runtime on one side's modules."""

    def __init__(self, side, slots=2, policy="sdf"):
        self.mod, plan, cat, sens, comp, self.item, self.req_cls = \
            SIDES[side]
        self.plan = plan(service="t", category=cat(sens.LATENCY, False),
                         bs=slots, admission=policy)
        self.composer = comp(self.plan)
        self.prefill_chunk_tokens = 4
        self._slots = slots

    def total_slots(self):
        return self._slots

    def req(self, rid, max_new=4, deadline=0.0, prompt=4):
        return self.req_cls(rid=rid, tokens=np.arange(1, 1 + prompt,
                                                      dtype=np.int32),
                            max_new_tokens=max_new, deadline_s=deadline)


def _controller_record(side):
    """Every probe of test_admission.py's controller tests, recorded."""
    out = []
    mod = SIDES[side][0]
    with pytest.raises(ValueError, match="admission policy"):
        mod.AdmissionController(_Stub(side, policy="edf"))
    out.append(mod.ADMISSION_POLICIES)
    out.append(mod.AdmissionController(_Stub(side, policy="fifo")).active)
    # cold controller: only an already-expired deadline sheds
    stub = _Stub(side)
    ctrl = mod.AdmissionController(stub)
    live, dead = stub.req(0, deadline=10.0), stub.req(1, deadline=3.0)
    for rid, r in ((0, live), (1, dead)):
        stub.composer.add(stub.item(payload=r, rid=rid))
    out += [ctrl.service_estimate(live), ctrl.wait_estimate(now=5.0),
            [(it.rid, v.value) for it, v in ctrl.shed(now=5.0)],
            dict(ctrl.verdicts)]
    # the cost model learns the caller's clock
    ctrl = mod.AdmissionController(_Stub(side))
    for t in (0.0, 2.0, 4.0):
        ctrl.note_step(t)

    class _Res:
        admitted_s, finished_s = 1.0, 11.0
    ctrl.observe(_Res())
    out += [ctrl._round_dt, ctrl._svc_logical,
            ctrl.service_estimate(stub.req(0)),
            ctrl.slack(stub.req(0, deadline=30.0), now=5.0),
            ctrl.slack(stub.req(0), now=5.0),
            ctrl.wait_estimate(0.0, position=0),
            ctrl.wait_estimate(0.0, position=3)]
    # a parked request owes only its remaining decode
    ctrl = mod.AdmissionController(_Stub(side))
    ctrl.note_step(0.0)
    ctrl.note_step(1.0)
    req = stub.req(9, max_new=6)
    ctrl.note_park(mod.ParkedEntry(
        req=req, group=0, blocks=[1, 2], emitted=[5, 6], cache_len=6,
        consumed=4, steps=2, prefill_s=0.0, admit_wall=0.0,
        decode_start_wall=0.0, admitted_s=0.0, parked_s=2.0))
    out += [ctrl.service_estimate(req), ctrl.parked_group(9),
            ctrl.pop_parked(9).blocks, ctrl.pop_parked(9)]
    # victim guards
    inf = float("inf")
    out += [ctrl.pick_victim(2.0, [(inf, 3.0, "a"), (inf, 7.0, "b")]),
            ctrl.pick_victim(5.0, [(4.0, 1.0, "a")]),
            ctrl.pick_victim(2.0, [(5.0, 4.0, "a")]),
            ctrl.pick_victim(2.0, [(6.0, 4.0, "a")])]
    return out


def test_controller_matches_reference_and_its_figures():
    got, want = _controller_record("port"), _controller_record("reference")
    assert got == want
    assert got == [("fifo", "sdf"), False, 0.0, 0.0,
                   [(1, "deadline_missed")], {"deadline_missed": 1},
                   2.0, 10.0, 10.0, 15.0, float("inf"), 5.0, 20.0,
                   4.0, 0, [1, 2], None, "b", None, None, "a"]
    assert set(REJECT_VERDICTS) == {Outcome.DEADLINE_MISSED,
                                    Outcome.CONGESTION, Outcome.OFFLOAD,
                                    Outcome.FAILED}
    assert {v.value for v in REJECT_VERDICTS} == {v.value for v in J_REJECT}


# ---------------------------------------------------------------------------
# arena block-table parking on the port
# ---------------------------------------------------------------------------

def test_arena_park_keeps_blocks_and_frees_slot():
    a = KVArena(_mirror(_CFG), transformer.init_cache, capacity=2,
                max_seq_len=32, block_size=8, device="cpu")
    assert a.parkable
    s0 = a.alloc(20)
    a.alloc(32)
    blocks = list(a._slot_blocks[s0])
    parked = a.park(s0)
    assert parked == blocks and a.parks == 1 and a.parked_blocks == 3
    assert not a.occupancy()[s0]
    assert (a.block_tables()[s0] == a.trash_block).all()
    assert all(a.block_ref(b) == 1 for b in parked)
    s1 = a.alloc(20, shared=parked)
    a.release_parked(parked)
    assert a.parked_blocks == 0
    assert list(a._slot_blocks[s1]) == blocks
    assert all(a.block_ref(b) == 1 for b in parked)
    a.set_len(s1, 13)
    assert int(a.lens[s1]) == 13
    parked = a.park(s1)
    free0 = a.free_capacity
    a.release_parked(parked)
    assert a.free_capacity == free0 + len(parked)
    with pytest.raises(ValueError):
        a.park(s1)                       # not occupied


def test_stateful_arena_is_not_parkable():
    cfg = _mirror(toy_config(family="ssm", name="toy-ssm", ssm_state=4,
                             ssm_headdim=16))
    a = KVArena(cfg, tssm.init_cache, capacity=2, max_seq_len=32,
                block_size=8, device="cpu")
    assert a.state and not a.parkable
    with pytest.raises(ValueError):
        a.park(a.alloc(16))


# ---------------------------------------------------------------------------
# the engine on both sides
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jp = jtransformer.init(jax.random.PRNGKey(0), _CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), _mirror(_CFG),
                                "cpu")
    return jp, tp


def _runtime(weights, port, policy, bs=2, sampler=(0.0, 0), **kw):
    if port:
        plan = ParallelPlan(service="t", category=TaskCategory(
            Sensitivity.LATENCY, False), bs=bs, admission=policy)
        return ServiceRuntime(_mirror(_CFG), weights[1], plan, device="cpu",
                              sampler=SamplerConfig(*sampler), **kw)
    plan = JPlan(service="t", category=JCat(JSens.LATENCY, False), bs=bs,
                 admission=policy)
    return JRuntime(_CFG, weights[0], plan, impl="ref",
                    sampler=JSampler(*sampler), **kw)


def _req(port, rid, max_new=4, deadline=0.0, prompt=4, stream=0):
    cls = GenerationRequest if port else JRequest
    return cls(rid=rid, tokens=np.arange(1, 1 + prompt, dtype=np.int32),
               max_new_tokens=max_new, deadline_s=deadline, stream=stream)


def _drain(rt, t, results, rejects, limit=2000.0):
    preempted = resumed = 0
    while rt.pending() or rt.in_flight():
        st_ = rt.step(now=t)
        results += st_.results
        rejects += st_.rejected
        preempted += st_.preempted
        resumed += st_.resumed
        t += 1.0
        assert t < limit, "engine failed to drain"
    return t, preempted, resumed


def _summary(results, rejects, rt, *extra):
    return ({r.rid: (list(map(int, r.tokens)), r.finished_s)
             for r in results},
            sorted((r.req.rid, r.verdict.value) for r in rejects),
            dict(rt.admission.verdicts), rt.admission.preemptions,
            rt.admission.resumes, *extra)


def _expired(weights, port, policy):
    rt = _runtime(weights, port, policy)
    results, rejects = [], []
    for i in range(4):
        rt.submit(_req(port, i, deadline=1.0), now=5.0)
    _drain(rt, 5.0, results, rejects)
    return _summary(results, rejects, rt)


def test_expired_deadlines_get_verdicts_on_both_engines(weights):
    for policy in ("sdf", "fifo"):
        got = _expired(weights, True, policy)
        assert got == _expired(weights, False, policy)
    sdf = _expired(weights, True, "sdf")
    assert not sdf[0] and sdf[1] == [(i, "deadline_missed")
                                     for i in range(4)]
    assert sdf[2] == {"deadline_missed": 4}
    fifo = _expired(weights, True, "fifo")
    assert len(fifo[0]) == 4 and not fifo[1]


def _run_policy(weights, port, policy, preempt=True, sampler=(0.0, 0)):
    """tests/test_admission.py's preemption scenario: two lazy long decodes
    fill both slots, then an urgent request arrives (logical clock)."""
    rt = _runtime(weights, port, policy, preempt=preempt, sampler=sampler)
    results, rejects, t = [], [], 0.0
    for i in range(2):
        rt.submit(_req(port, 100 + i), now=t)
    t, _, _ = _drain(rt, t, results, rejects)
    for i in range(2):
        rt.submit(_req(port, i, max_new=30, prompt=6), now=t)
    for _ in range(2):
        rt.step(now=t)
        t += 1.0
    rt.submit(_req(port, 7, deadline=t + 12.0), now=t)
    t, preempted, resumed = _drain(rt, t, results, rejects)
    arenas = [g.arena for g in rt.groups.values()]
    return _summary(results, rejects, rt, preempted, resumed,
                    sum(a.parks for a in arenas),
                    [(a.parked_blocks, a.live) for a in arenas],
                    dict(rt.admission.parked))


@pytest.mark.parametrize("sampler", [(0.0, 0), (0.8, 40)],
                         ids=["greedy", "stochastic"])
def test_sdf_preempts_parks_and_resumes_like_the_reference(weights,
                                                           sampler):
    runs = {}
    for policy in ("fifo", "sdf"):
        got = _run_policy(weights, True, policy, sampler=sampler)
        assert got == _run_policy(weights, False, policy, sampler=sampler)
        runs[policy] = got
    fifo, sdf = runs["fifo"], runs["sdf"]
    assert fifo[3:7] == (0, 0, 0, 0) and not fifo[1]
    pre, res, parks = sdf[5], sdf[6], sdf[7]
    assert pre >= 1 and res == pre == parks and not sdf[1]
    # the urgent request makes its deadline under sdf, misses under fifo
    assert sdf[0][7][1] <= 16.0 < fifo[0][7][1]
    # parked-then-resumed chains equal never-parked ones, greedy or not
    assert {r: v[0] for r, v in sdf[0].items()} \
        == {r: v[0] for r, v in fifo[0].items()}
    assert sdf[8] == [(0, 0)] and not sdf[9]


def test_no_preempt_disables_parking_like_the_reference(weights):
    got = _run_policy(weights, True, "sdf", preempt=False)
    assert got == _run_policy(weights, False, "sdf", preempt=False)
    assert got[5] == 0 and got[7] == 0
    assert all(v in {o.value for o in REJECT_VERDICTS} for _, v in got[1])


# ---------------------------------------------------------------------------
# property: random overload interleavings never corrupt another slot
# ---------------------------------------------------------------------------

_EXAMPLES = int(os.environ.get("ADMISSION_EXAMPLES", "5"))

spec = st.tuples(
    st.integers(min_value=2, max_value=8),     # prompt tokens
    st.integers(min_value=1, max_value=8),     # max_new_tokens
    st.integers(min_value=0, max_value=4),     # arrival tick
    st.one_of(st.none(),                       # deadline budget from arrival
              st.floats(min_value=2.0, max_value=60.0)),
)
_WEIGHTS = []


def _interleave(port, policy, specs):
    if not _WEIGHTS:
        jp = jtransformer.init(jax.random.PRNGKey(0), _CFG)
        _WEIGHTS.append((jp, bridge.params_from_jax(
            jax.tree.map(np.asarray, jp), _mirror(_CFG), "cpu")))
    rt = _runtime(_WEIGHTS[0], port, policy)
    results, rejects, t = [], [], 0.0
    rt.submit(_req(port, 1000), now=t)
    t, _, _ = _drain(rt, t, results, rejects)
    tick = 0
    pending = sorted(enumerate(specs), key=lambda x: x[1][2])
    while pending or rt.pending() or rt.in_flight():
        while pending and pending[0][1][2] <= tick:
            rid, (prompt, max_new, _, budget) = pending.pop(0)
            rt.submit(_req(port, rid, max_new=max_new, prompt=prompt,
                           deadline=0.0 if budget is None else t + budget),
                      now=t)
        st_ = rt.step(now=t)
        results += st_.results
        rejects += st_.rejected
        t += 1.0
        tick += 1
        assert t < 3000.0, "engine failed to drain"
    arenas = [g.arena for g in rt.groups.values() if g.arena is not None]
    return _summary(results, rejects, rt,
                    [(a.parked_blocks, a.live) for a in arenas],
                    dict(rt.admission.parked))


@settings(max_examples=_EXAMPLES, deadline=None)
@given(specs=st.lists(spec, min_size=3, max_size=10))
def test_random_interleavings_match_the_reference(specs):
    """Arbitrary admit/shed/park/resume/evict interleavings on an
    overloaded 2-slot engine: the port's tokens, verdicts, preemptions,
    resumes and finish times equal the reference's; every request is
    served or rejected with one verdict; the completed chains equal the
    inert-fifo oracle's; nothing stays parked."""
    oracle = _interleave(True, "fifo", specs)
    got = _interleave(True, "sdf", specs)
    assert got == _interleave(False, "sdf", specs)
    assert not oracle[1]
    served, rejected = got[0], got[1]
    assert len(served) + len(rejected) == len(specs) + 1
    assert set(served) | {r for r, _ in rejected} \
        == set(range(len(specs))) | {1000}
    assert all(v in {o.value for o in REJECT_VERDICTS}
               for _, v in rejected)
    for rid, (tokens, _) in served.items():
        assert tokens == oracle[0][rid][0], rid
    assert all(p == (0, 0) for p in got[5]) and not got[6]


# ---------------------------------------------------------------------------
# the goodput overload trace
# ---------------------------------------------------------------------------

def _goodput(weights, port, policy, sampler, kv_dtype):
    def make():
        if port:
            plan = ParallelPlan(service="toy", category=TaskCategory(
                Sensitivity.LATENCY, False), bs=2, admission=policy,
                kv_dtype=kv_dtype)
            return ServiceRuntime(_mirror(_CFG), weights[1], plan,
                                  device="cpu",
                                  sampler=SamplerConfig(*sampler))
        plan = JPlan(service="toy", category=JCat(JSens.LATENCY, False),
                     bs=2, admission=policy, kv_dtype=kv_dtype)
        return JRuntime(_CFG, weights[0], plan, impl="ref",
                        sampler=JSampler(*sampler))
    return goodput_trace(make, _CFG.vocab_size,
                         None if port else JRequest)


GOODPUT_CASES = [((0.0, 0), "bf16"), ((0.8, 0), "bf16"), ((0.0, 0), "int8")]


@pytest.mark.parametrize("sampler,kv_dtype", GOODPUT_CASES,
                         ids=["greedy-bf16", "stochastic-bf16",
                              "greedy-int8"])
def test_goodput_trace_matches_reference(weights, sampler, kv_dtype):
    """benchmarks/continuous_batching.py's goodput overload trace: sdf's
    on-time count at least 1.3x fifo's, at least one preemption with as
    many resumes and arena parks, identical chains under both policies,
    every request served or verdicted, the arenas empty at the end; every
    figure, chain and finish time equal to the reference's."""
    runs = {}
    for policy in ("fifo", "sdf"):
        got = _goodput(weights, True, policy, sampler, kv_dtype)
        assert got == _goodput(weights, False, policy, sampler, kv_dtype)
        assert got["completed"] + got["rejected"] == got["submitted"] == 12
        assert got["parked_blocks"] == got["live_slots"] == 0
        runs[policy] = got
    fifo, sdf = runs["fifo"], runs["sdf"]
    assert sdf["goodput_ontime"] >= 1.3 * fifo["goodput_ontime"]
    assert sdf["preemptions"] >= 1
    assert sdf["resumes"] == sdf["preemptions"] == sdf["arena_parks"]
    both = set(fifo["tokens"]) & set(sdf["tokens"])
    assert both and all(fifo["tokens"][k] == sdf["tokens"][k] for k in both)
    # the figures chip_smoke.py phase 11 (c) expects at full width
    assert (fifo["goodput_ontime"], sdf["goodput_ontime"]) == (4, 12)
    assert (sdf["preemptions"], sdf["verdicts"]) == (1, {"admit": 13})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_sdf_with_deadlines_and_forks(capsys):
    # under sdf the supervisor's retry timeouts run on the wall clock, as
    # in the reference: a long one keeps a slow machine from re-placing a
    # request that is still decoding (a duplicate that forks again)
    rc = serve.main(["--device", "cpu", "--requests", "4",
                     "--max-new-tokens", "3", "--max-seq-len", "32",
                     "--admission-policy", "sdf", "--deadline-s", "600",
                     "--n-samples", "2", "--retry-timeout-s", "3600"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out
    line = [ln for ln in out.splitlines() if ln.startswith("admission (")]
    assert len(line) == 1 and line[0].startswith("admission (sdf):")
    assert "0 final rejects" in line[0]
    forks = [ln for ln in out.splitlines()
             if ln.startswith("parallel sampling (n=2)")]
    assert forks and "4 forks spawned" in forks[0]


@pytest.mark.parametrize("argv,msg", [
    (["--admission-policy", "edf"], "invalid choice"),
    (["--admission-policy", "sdf", "--mode", "sync"], "requires --mode"),
    (["--deadline-s", "-1"], "--deadline-s must be >= 0"),
    (["--n-samples", "0"], "--n-samples must be >= 1")])
def test_launcher_validates_admission_flags(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
