"""Observability on the port's serving path against the JAX reference.

The same request wave (seven requests over four slots, three of them on a
shared 20-token template so that the prefix cache hits) goes through the
reference's ``ServiceRuntime`` (``impl="ref"``) and the port's, on the
float32 toy config with the reference's weights carried over by the
bridge, each with its own package's ``Tracer`` and ``MetricsRegistry``.

* Byte-inertness: the port's greedy tokens and counters are the same with
  obs on and off, and its tokens equal the reference's.
* Spans: both tracers run on a tick clock (each read returns the next
  integer), so the port's event stream must equal the reference's event
  for event, timestamps included: the same spans, in the same order, with
  the same arguments, and the same clock reads between them.  This holds
  on the continuous paged path (native and dense view), the one-shot,
  dense-cache and sync paths, and with speculation (``tests/test_obs.py``'s
  ``spec_run``: the ``verify`` and ``spec_round`` spans, the count-valued
  metrics and the calibration's ``spec_accept_rate`` equal too).  On the
  real clock each request's span tree is balanced, rooted at ``request``
  with ``queued``, ``prefill`` and ``decode`` children, and ends with
  ``outcome="served"``.
* Metrics: the Prometheus series names are equal; every count-valued
  series has the same value; of the ``*_seconds`` series only the
  histogram counts are compared (their values are wall times).  The
  ``decode_compiles`` and ``prefill_compiles`` gauges read 0 on the port,
  which compiles nothing, where the reference's read its XLA traces (a
  deviation the port keeps, ROADMAP.md Queue 3).
* The reference's ``repro.obs`` reads the port's artifacts unchanged (its
  ``validate_chrome_trace``, ``parse_prometheus_text`` and
  ``telemetry_from_snapshot``), and the calibration's prefix hit rate on a
  templated wave equals the reference's.
* The copied simulator's ``run_comparison`` gives the reference's result,
  field for field, on a small scenario.
* A supervised cluster (``tests/test_faults.py``'s three toy servers,
  speculating, forking, sdf) under all five fault kinds: the tick-clock
  event streams, the ``cluster`` instants ``crash``, ``restart`` and
  ``failover`` among them, and the count-valued series, the six
  ``cluster_*`` series among them, equal the reference's.
* The CPU launcher writes valid artifacts for ``--trace-out``,
  ``--metrics-out`` (Prometheus text or JSONL) and ``--calibrate-out``.

Every comparison is exact except the prefill seconds of a snapshot, which
go through JSON and are held to pytest's default relative 1e-6.
"""
import dataclasses
import itertools
import json

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
from repro.obs import calibrate as jcalibrate
from repro.obs import parse_prometheus_text as jparse_prometheus_text
from repro.obs import telemetry_from_runtime as jtelemetry_from_runtime
from repro.obs import telemetry_from_snapshot as jtelemetry_from_snapshot
from repro.obs import validate_chrome_trace as jvalidate_chrome_trace
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro.serving.engine import StepStats as JStepStats
from repro.simulator import engine as jsim
from repro.simulator import workload as jworkload
from repro_torch import bridge
from repro_torch.core import categories
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.obs import (MetricsRegistry, Tracer, calibrate,
                             telemetry_from_runtime, telemetry_from_steps)
from repro_torch.serving.engine import (GenerationRequest, ServiceRuntime,
                                        StepStats)
from repro_torch.simulator import engine as sim
from repro_torch.simulator import workload

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

_CFG = toy_config()
KW = dict(max_seq_len=48, block_size=8)
MODES = {"paged": {}, "dense_view": dict(paged_native=False),
         "oneshot": dict(chunked_prefill=False),
         "dense": dict(kvcache_impl="dense"), "sync": dict(mode="sync")}
# telemetry fields that count (the rest, prefill_seconds, is a wall time)
COUNT_FIELDS = ("spec_k", "accepted_tokens", "verify_launches",
                "prefix_hit_tokens", "prefill_tokens_computed",
                "decode_steps")


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _ticks():
    n = itertools.count()
    return lambda: float(next(n))


def _wave(cfg, seed=8):
    """Seven (prompt, max_new) pairs; 0, 2 and 4 share a 20-token
    template."""
    rng = np.random.default_rng(seed)
    template = rng.integers(1, cfg.vocab_size, 20).astype(np.int32)
    out = []
    for rid, (n, new) in enumerate([(6, 5), (9, 4), (7, 6), (30, 3),
                                    (3, 7), (25, 5), (12, 4)]):
        tail = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        prompt = np.concatenate([template, tail]) if rid in (0, 2, 4) \
            else tail
        out.append((prompt, new))
    return out


def _plans(sens="latency", bs=4):
    return (JPlan(service="toy", category=JCat(JSens(sens), False), bs=bs),
            ParallelPlan(service="toy",
                         category=TaskCategory(Sensitivity(sens), False),
                         bs=bs))


@pytest.fixture(scope="module")
def weights():
    params = jmodel_api(_CFG).init(jax.random.PRNGKey(3), _CFG)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     _mirror(_CFG), "cpu")
    return params, tparams


def _runtimes(weights, mode="paged", *, obs=True, sens="latency", **kw):
    """The reference's runtime and the port's, each with its own tracer (on
    a tick clock) and registry when ``obs``."""
    jplan, tplan = _plans(sens)
    kw = dict(KW, **MODES[mode], **kw)
    jobs = dict(tracer=JTracer(clock=_ticks()), metrics=JMetrics()) \
        if obs else {}
    tobs = dict(tracer=Tracer(clock=_ticks()), metrics=MetricsRegistry()) \
        if obs else {}
    jrt = JRuntime(_CFG, weights[0], jplan, impl="ref", **kw, **jobs)
    trt = ServiceRuntime(_mirror(_CFG), weights[1], tplan, device="cpu",
                         **kw, **tobs)
    return jrt, trt


def _drive(rt, request_cls, wave):
    """Submit the wave and step to idle; returns (tokens by rid, steps)."""
    for rid, (prompt, new) in enumerate(wave):
        rt.submit(request_cls(rid=rid, tokens=prompt, max_new_tokens=new,
                              stream=rid))
    steps = []
    while rt.pending() or rt.in_flight():
        steps.append(rt.step(max_wait_s=0.0))
    toks = {r.rid: tuple(int(x) for x in r.tokens)
            for st in steps for r in st.results}
    return toks, steps


@pytest.fixture(scope="module")
def runs(weights):
    """The wave on the paged path: the reference and the port with obs on,
    and the port with obs off."""
    wave = _wave(_CFG)
    jrt, trt = _runtimes(weights)
    jtoks, jsteps = _drive(jrt, JRequest, wave)
    ttoks, tsteps = _drive(trt, GenerationRequest, wave)
    _, off = _runtimes(weights, obs=False)
    otoks, _ = _drive(off, GenerationRequest, wave)
    return dict(jrt=jrt, trt=trt, off=off, jtoks=jtoks, ttoks=ttoks,
                otoks=otoks, jsteps=jsteps, tsteps=tsteps)


def _tree(span):
    return (span.name, span.args, [_tree(c) for c in span.children])


def test_obs_is_byte_inert_and_tokens_match_reference(runs):
    assert runs["ttoks"] == runs["otoks"] == runs["jtoks"]
    assert sorted(runs["ttoks"]) == list(range(7))
    trt, off = runs["trt"], runs["off"]
    for name in ("decode_steps", "prefill_chunk_calls",
                 "prefill_tokens_computed", "admission_copy_bytes",
                 "chunk_write_bytes", "prefix_hits", "prefix_hit_tokens",
                 "prefix_cow_copies"):
        assert getattr(trt, name) == getattr(off, name) \
            == getattr(runs["jrt"], name), name
    assert trt.prefix_hits > 0          # the template's requests hit


def test_step_stats_have_the_reference_fields():
    assert [f.name for f in dataclasses.fields(StepStats)] \
        == [f.name for f in dataclasses.fields(JStepStats)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_event_stream_matches_reference(weights, runs, mode):
    if mode == "paged":
        jrt, trt = runs["jrt"], runs["trt"]
    else:
        wave = _wave(_CFG)
        jrt, trt = _runtimes(weights, mode)
        jtoks, _ = _drive(jrt, JRequest, wave)
        ttoks, _ = _drive(trt, GenerationRequest, wave)
        assert ttoks == jtoks
    assert trt.trace.events() == jrt.trace.events()
    assert trt.trace.dropped == jrt.trace.dropped == 0
    for rid in range(7):
        assert trt.trace.open_spans("toy", str(rid)) == []


def _sdf_run(rt, request_cls):
    """An sdf run with one park, one resume and a fork lane (logical
    clock): two warmup requests teach the controller the clock; a request
    of two samples (its fork on lane "10.1") and a lazy long decode fill
    the three slots; an urgent request then parks the lazy one (siblings
    are never parked), which resumes once a slot frees."""
    tokens, t = {}, 0.0

    def drain():
        nonlocal t
        while rt.pending() or rt.in_flight():
            st = rt.step(now=t)
            tokens.update({(r.rid, r.sample): tuple(int(x) for x in r.tokens)
                           for r in st.results})
            t += 1.0

    for rid in (100, 101):
        rt.submit(request_cls(rid=rid, tokens=np.arange(1, 5, dtype=np.int32),
                              max_new_tokens=4), now=t)
    drain()
    rt.submit(request_cls(rid=10, tokens=np.arange(2, 8, dtype=np.int32),
                          max_new_tokens=20, n_samples=2), now=t)
    rt.submit(request_cls(rid=11, tokens=np.arange(3, 9, dtype=np.int32),
                          max_new_tokens=30), now=t)
    for _ in range(2):
        rt.step(now=t)
        t += 1.0
    rt.submit(request_cls(rid=7, tokens=np.arange(1, 5, dtype=np.int32),
                          max_new_tokens=4, deadline_s=t + 12.0), now=t)
    drain()
    return tokens


def test_event_stream_matches_reference_under_sdf(weights):
    """The tick-clock event streams are equal on an sdf run that parks,
    resumes and forks, at temperature 0.8: the ``preempt`` phase spans,
    the parked request's ``decode`` > ``parked`` > ``decode`` spans and the
    fork's own ``rid.sample`` lane."""
    from repro.serving.sampler import SamplerConfig as JSampler
    from repro_torch.serving.sampler import SamplerConfig
    kw = dict(bs=3, admission="sdf", n_samples=2)
    jplan = JPlan(service="toy", category=JCat(JSens.LATENCY, False), **kw)
    tplan = ParallelPlan(service="toy", category=TaskCategory(
        Sensitivity.LATENCY, False), **kw)
    jrt = JRuntime(_CFG, weights[0], jplan, impl="ref",
                   sampler=JSampler(0.8, 40), tracer=JTracer(clock=_ticks()),
                   metrics=JMetrics(), **KW)
    trt = ServiceRuntime(_mirror(_CFG), weights[1], tplan, device="cpu",
                         sampler=SamplerConfig(0.8, 40),
                         tracer=Tracer(clock=_ticks()),
                         metrics=MetricsRegistry(), **KW)
    want, got = _sdf_run(jrt, JRequest), _sdf_run(trt, GenerationRequest)
    assert got == want and len(got) == 6 and (10, 1) in got
    assert (trt.admission.preemptions, trt.admission.resumes,
            trt.forks_spawned) == (1, 1, 1)
    assert trt.trace.events() == jrt.trace.events()
    roots, _ = trt.trace.span_tree("toy", "11")
    assert [c.name for c in roots[0].children] \
        == ["queued", "prefill", "decode", "parked", "decode"]
    fork, _ = trt.trace.span_tree("toy", "10.1")
    assert [r.name for r in fork] == ["decode"] and fork[0].args["fork"]
    phases = {e[3] for e in trt.trace.events() if e[2] == "engine"}
    assert "preempt" in phases
    got_m = _split_series(jparse_prometheus_text(
        trt.metrics.prometheus_text()))
    want_m = _split_series(jparse_prometheus_text(
        jrt.metrics.prometheus_text()))
    for k in [k for k in want_m if "_compiles{" in k]:
        assert got_m.pop(k) == 0.0      # the port compiles nothing
        want_m.pop(k)
    assert got_m == want_m
    assert got_m['epara_step_preempted_total{service="toy"}'] == 1


def test_event_stream_matches_reference_with_speculation(weights):
    """``tests/test_obs.py``'s ``spec_run`` (three requests, a self-draft,
    k = 3) on both engines: the tick-clock event streams are equal, the
    ``verify`` engine spans and the per-request ``spec_round`` spans among
    them, and so are the count-valued metrics and the calibration's
    ``spec_accept_rate``."""
    jplan, tplan = _plans()
    jrt = JRuntime(_CFG, weights[0], jplan, impl="ref",
                   draft_params=weights[0], draft_cfg=_CFG, speculate=3,
                   tracer=JTracer(clock=_ticks()), metrics=JMetrics())
    trt = ServiceRuntime(_mirror(_CFG), weights[1], tplan, device="cpu",
                         draft_params=weights[1], draft_cfg=_mirror(_CFG),
                         speculate=3, tracer=Tracer(clock=_ticks()),
                         metrics=MetricsRegistry())
    toks = []
    for rt, cls in ((jrt, JRequest), (trt, GenerationRequest)):
        rng = np.random.default_rng(3)
        for i in range(3):
            rt.submit(cls(rid=i, tokens=rng.integers(
                1, _CFG.vocab_size, 6 + 2 * i).astype(np.int32),
                max_new_tokens=8))
        out = {}
        while rt.pending() or rt.in_flight():
            out.update({r.rid: tuple(int(x) for x in r.tokens)
                        for r in rt.step().results})
        toks.append(out)
    assert toks[0] == toks[1] and len(toks[1]) == 3
    assert trt.verify_launches == jrt.verify_launches > 0
    assert trt.trace.events() == jrt.trace.events()
    names = {e[3] for e in trt.trace.events()}
    assert {"verify", "spec_round"} <= names
    got_m = _split_series(jparse_prometheus_text(
        trt.metrics.prometheus_text()))
    want_m = _split_series(jparse_prometheus_text(
        jrt.metrics.prometheus_text()))
    for k in [k for k in want_m if "_compiles{" in k]:
        assert got_m.pop(k) == 0.0      # the port compiles nothing
        want_m.pop(k)
    assert got_m == want_m
    rate = calibrate({"toy": telemetry_from_runtime("toy", trt)})
    want = jcalibrate({"toy": jtelemetry_from_runtime("toy", jrt)})
    assert rate.spec_accept_rate == want.spec_accept_rate > 0.5


def test_request_span_trees_match_reference(runs):
    jtr, ttr = runs["jrt"].trace, runs["trt"].trace
    for rid, tokens in runs["ttoks"].items():
        tid = str(rid)
        roots, instants = ttr.span_tree("toy", tid)
        jroots, jinstants = jtr.span_tree("toy", tid)
        assert [_tree(r) for r in roots] == [_tree(r) for r in jroots]
        assert [i.name for i in instants] == [i.name for i in jinstants] \
            == ["first_token"]
        assert len(roots) == 1 and roots[0].name == "request"
        assert [c.name for c in roots[0].children] \
            == ["queued", "prefill", "decode"]
        assert roots[0].args["outcome"] == "served"
        assert roots[0].children[-1].args["tokens"] == len(tokens)
        hit = roots[0].children[1].args["hit_tokens"]
        assert (hit > 0) == (rid == 4)    # 0 and 2 share the first wave


def test_engine_timeline_matches_reference(runs):
    def phases(tr):
        return [(e[3], e[6]) for e in tr.events() if e[2] == "engine"]

    got, want = phases(runs["trt"].trace), phases(runs["jrt"].trace)
    assert got == want
    names = [n for n, _ in got]
    assert names.count("step") == len(runs["tsteps"])
    assert {"evict", "admit", "chunk", "fused_decode", "sample"} \
        <= set(names)


def test_span_trees_on_the_wall_clock_are_well_formed(weights):
    """The tick clock makes streams comparable; here the real clock: every
    timeline balanced, each child inside its parent."""
    tracer = Tracer()
    _, tplan = _plans()
    rt = ServiceRuntime(_mirror(_CFG), weights[1], tplan, device="cpu",
                        tracer=tracer, **KW)
    toks, _ = _drive(rt, GenerationRequest, _wave(_CFG))

    def check(s, lo, hi):
        assert lo <= s.start <= s.end <= hi
        for c in s.children:
            check(c, s.start, s.end)

    for rid in toks:
        roots, instants = tracer.span_tree("toy", str(rid))
        assert tracer.open_spans("toy", str(rid)) == []
        assert len(roots) == 1 and roots[0].args["outcome"] == "served"
        check(roots[0], -np.inf, np.inf)
        prefill, decode = roots[0].children[1:]
        assert prefill.end <= instants[0].start <= decode.start


def _split_series(parsed):
    """Series whose values count, and the ``*_seconds`` histograms'
    counts; wall-time values are dropped."""
    out = {}
    for series, v in parsed.items():
        name = series.split("{", 1)[0]
        if "seconds" in name and not name.endswith("_seconds_count"):
            continue
        out[series] = v
    return out


def test_prometheus_series_match_reference(runs):
    jrt, trt = runs["jrt"], runs["trt"]
    got = jparse_prometheus_text(trt.metrics.prometheus_text())
    want = jparse_prometheus_text(jrt.metrics.prometheus_text())
    assert sorted(got) == sorted(want)
    got, want = _split_series(got), _split_series(want)
    for gauge in ("decode_compiles", "prefill_compiles"):
        key = f'epara_{gauge}{{service="toy"}}'
        assert got.pop(key) == 0.0 and want.pop(key) >= 1.0
    assert got == want
    assert got['epara_ttft_seconds_count{service="toy"}'] == 7
    assert got['epara_requests_finished_total{service="toy"}'] == 7


def test_compile_gauges_stay_zero_on_the_port(runs):
    """The port compiles nothing: its compile counts (the reference's XLA
    traces) stay 0, a deviation kept on purpose (ROADMAP.md Queue 3)."""
    trt, jrt = runs["trt"], runs["jrt"]
    assert trt.decode_traces == trt.prefill_traces == 0
    assert jrt.decode_traces == 1 and jrt.prefill_traces >= 1
    snap = trt.metrics.snapshot()["metrics"]
    for gauge in ("epara_decode_compiles", "epara_prefill_compiles"):
        assert snap[gauge]["values"] == [
            {"labels": {"service": "toy"}, "value": 0.0}]


def test_reference_reads_the_port_artifacts(runs, tmp_path):
    trt = runs["trt"]
    path = tmp_path / "trace.json"
    trt.trace.export(str(path))
    doc = json.loads(path.read_text())
    assert jvalidate_chrome_trace(doc) == len(doc["traceEvents"])
    names = {ev["args"]["name"] for ev in doc["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "thread_name"}
    assert {str(r) for r in range(7)} | {"engine"} <= names
    snap = tmp_path / "metrics.jsonl"
    trt.metrics.append_jsonl(str(snap))
    tel = jtelemetry_from_snapshot(json.loads(snap.read_text()))["toy"]
    mine = telemetry_from_runtime("toy", trt)
    for f in COUNT_FIELDS:
        assert getattr(tel, f) == getattr(mine, f), f
    assert tel.prefill_seconds == pytest.approx(mine.prefill_seconds)
    assert mine.prefill_seconds > 0.0
    ref = jtelemetry_from_runtime("toy", runs["jrt"])
    for f in COUNT_FIELDS:
        assert getattr(mine, f) == getattr(ref, f), f


def test_calibration_from_steps_and_runtime_agree(runs):
    trt = runs["trt"]
    a = telemetry_from_steps("toy", runs["tsteps"])
    b = telemetry_from_runtime("toy", trt)
    assert a.decode_steps == b.decode_steps == trt.decode_steps
    assert a.prefix_hit_tokens == b.prefix_hit_tokens
    assert a.prefill_tokens_computed == b.prefill_tokens_computed
    assert a.prefill_seconds == pytest.approx(b.prefill_seconds)


def test_calibration_prefix_hit_rate_matches_reference(weights):
    """``tests/test_obs.py``'s templated wave on both engines (frequency
    category, int8 KV): a warm request, then four on its 64-token
    prefix."""
    kw = dict(max_seq_len=160, block_size=16)
    jplan, tplan = _plans("frequency")
    jrt = JRuntime(_CFG, weights[0], jplan, impl="ref", **kw)
    trt = ServiceRuntime(_mirror(_CFG), weights[1], tplan, device="cpu",
                         **kw)
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, _CFG.vocab_size, 64).astype(np.int32)
    for rids in ([0], range(1, 5)):
        for i in rids:
            prompt = np.concatenate([prefix, rng.integers(
                1, _CFG.vocab_size, 16).astype(np.int32)])
            jrt.submit(JRequest(rid=i, tokens=prompt, max_new_tokens=4))
            trt.submit(GenerationRequest(rid=i, tokens=prompt,
                                         max_new_tokens=4))
        jrt.drain()
        trt.drain()
    tel, jtel = (telemetry_from_runtime("toy", trt),
                 jtelemetry_from_runtime("toy", jrt))
    assert trt.prefix_hit_tokens > 0
    for f in COUNT_FIELDS:
        assert getattr(tel, f) == getattr(jtel, f), f
    assert tel.prefix_hit_rate == jtel.prefix_hit_rate
    base = sim.SimConfig(prefill_token_s=2e-4)
    cal = calibrate({"toy": tel}, base=base)
    jcal = jcalibrate({"toy": jtel},
                      base=jsim.SimConfig(prefill_token_s=2e-4))
    assert cal.prefix_hit_rates == jcal.prefix_hit_rates
    assert 0.0 < cal.prefix_hit_rates["toy"] < 1.0


def test_simulator_run_comparison_matches_reference():
    from repro.core.categories import EDGE_P100 as JEDGE
    from repro.core.categories import ServerSpec as JServer

    def scenario(wl_mod, server_cls, gpu):
        services = wl_mod.table1_services()
        servers = [server_cls(sid=i, num_gpus=1, gpu=gpu) for i in range(3)]
        events = wl_mod.generate_requests(
            services, len(servers),
            wl_mod.WorkloadConfig(horizon_s=10.0, load_scale=10.0, seed=5))
        return servers, services, events

    names = ["EPARA", "InterEdge", "Galaxy", "SERV-P"]
    got = sim.run_comparison(
        *scenario(workload, categories.ServerSpec, categories.EDGE_P100),
        names, sim.SimConfig(horizon_s=10.0), seed=2)
    want = jsim.run_comparison(*scenario(jworkload, JServer, JEDGE), names,
                               jsim.SimConfig(horizon_s=10.0), seed=2)
    assert list(got) == names
    for name in names:
        assert dataclasses.asdict(got[name]) \
            == dataclasses.asdict(want[name]), name
    assert got["EPARA"].handled > 0


@pytest.mark.parametrize("suffix", [".prom", ".jsonl"])
def test_launcher_writes_valid_artifacts(tmp_path, capsys, suffix):
    out = {k: str(tmp_path / f"obs_{k}") for k in ("trace", "calibration")}
    out["metrics"] = str(tmp_path / f"obs_metrics{suffix}")
    rc = serve.main(["--device", "cpu", "--requests", "6",
                     "--max-new-tokens", "4", "--trace-out", out["trace"],
                     "--metrics-out", out["metrics"],
                     "--calibrate-out", out["calibration"]])
    assert rc == 0
    printed = capsys.readouterr().out
    for head in ("trace:", "metrics:", "calibration:"):
        assert any(ln.startswith(head) for ln in printed.splitlines())
    doc = json.load(open(out["trace"]))
    assert jvalidate_chrome_trace(doc) > 0
    text = open(out["metrics"]).read()
    if suffix == ".prom":
        series = jparse_prometheus_text(text)
        assert series['epara_requests_finished_total{service="minicpm-2b"}'] \
            == 6
    else:
        tel = jtelemetry_from_snapshot(json.loads(text))["minicpm-2b"]
        assert tel.prefill_tokens_computed == 36      # six 6-token prompts
    cal = json.load(open(out["calibration"]))
    assert cal["sim_config_overrides"]["prefix_hit_rates"] \
        == {"minicpm-2b": 0.0}
    assert cal["telemetry"]["minicpm-2b"]["decode_steps"] > 0


def _cluster_run(side, weights):
    """``tests/test_faults.py``'s toy cluster (three servers, the "chat"
    service on each) driven by one side's ``ClusterSupervisor`` through a
    schedule of all five fault kinds (two dropped handoffs to server 1, a
    straggling server 2, a corrupted digest, a crash of server 0 at 2.0
    and its restart at 8.0), with one tracer on a
    tick clock and one registry shared by the runtimes and the supervisor.
    Every runtime speculates with a self-draft (k = 2) under sdf admission
    at temperature 0.8, and each request asks for two samples, so that the
    crash evacuates speculating slots and forks."""
    import repro.core as jcore
    from repro.core import faults as jfaults
    from repro.serving import engine as jengine
    from repro.serving import failover as jfailover
    from repro.serving.sampler import SamplerConfig as JSampler
    from repro_torch import core as tcore
    from repro_torch.core import faults as tfaults
    from repro_torch.serving import engine as tengine
    from repro_torch.serving import failover as tfailover
    from repro_torch.serving.sampler import SamplerConfig
    ref = side == "ref"
    core, faults, engine, failover = (
        (jcore, jfaults, jengine, jfailover) if ref
        else (tcore, tfaults, tengine, tfailover))
    cfg, params = (_CFG, weights[0]) if ref else (_mirror(_CFG), weights[1])
    tracer = (JTracer if ref else Tracer)(clock=_ticks())
    metrics = (JMetrics if ref else MetricsRegistry)()
    specs = {"chat": core.ServiceSpec("chat", flops_per_request=1e10,
                                      weights_bytes=2e8, vram_bytes=5e8,
                                      slo_latency_s=100.0)}
    servers = [core.ServerSpec(sid=i, num_gpus=2) for i in range(3)]
    cp = core.EdgeCloudControlPlane(servers, specs)
    cp.run_placement({("chat", i): 10.0 for i in range(3)})
    plan = dataclasses.replace(cp.plans["chat"], bs=4, n_samples=2,
                               admission="sdf")
    kw = dict(sampler=(JSampler if ref else SamplerConfig)(0.8, 40),
              speculate=2, draft_params=params, draft_cfg=cfg,
              max_seq_len=64, block_size=8, tracer=tracer, metrics=metrics,
              **(dict(impl="ref") if ref else dict(device="cpu")))
    engines = {s.sid: engine.EparaServingEngine() for s in servers}
    for sid in engines:
        engines[sid].deploy("chat", engine.ServiceRuntime(cfg, params, plan,
                                                          **kw))
    cp.publish_all(0.0)
    for _ in range(3):
        cp.sync_step(0.0)
    spec = faults.FaultSpec(events=(
        faults.FaultEvent(at_s=0.5, kind="drop_offload", sid=1, count=2),
        faults.FaultEvent(at_s=1.0, kind="straggle", sid=2, duration_s=4.0,
                          factor=2.0),
        faults.FaultEvent(at_s=1.5, kind="corrupt", sid=1, factor=4.0),
        faults.FaultEvent(at_s=2.0, kind="crash", sid=0),
        faults.FaultEvent(at_s=8.0, kind="restart", sid=0)))
    sup = failover.ClusterSupervisor(
        cp, engines, retry=failover.RetryPolicy(base_timeout_s=4.0),
        injector=faults.FaultInjector(spec), metrics=metrics, tracer=tracer)
    rng = np.random.default_rng(1)
    for rid in range(12):
        sup.submit("chat", engine.GenerationRequest(
            rid=rid, tokens=rng.integers(1, _CFG.vocab_size,
                                         6 + rid).astype(np.int32),
            max_new_tokens=6, stream=rid, n_samples=2),
            at_server=rid % 3, now=0.0)
    rep = sup.run_until_idle()
    rts = [rt for e in engines.values() for rt in e.runtimes.values()]
    return dict(
        tokens={(r.rid, r.sample): tuple(int(x) for x in r.tokens)
                for r in rep.results},
        report=(rep.outcomes, rep.rounds, rep.failovers,
                rep.offload_retries, rep.duplicates, rep.evacuated,
                rep.accounted, rep.dropped_offloads, rep.heartbeat_misses),
        runtimes=[(rt.evacuated_requests, rt.verify_launches,
                   rt.forks_spawned) for rt in rts],
        events=tracer.events(), metrics=metrics)


def test_cluster_crash_events_and_series_match_reference(weights):
    """A supervised crash on the toy cluster: the report, the tokens of
    every ``(rid, sample)``, the tick-clock event streams (the ``cluster``
    instants ``crash``, ``restart`` and ``failover`` among them) and the
    count-valued Prometheus series (the six ``cluster_*`` series among
    them) equal the reference's."""
    want, got = _cluster_run("ref", weights), _cluster_run("port", weights)
    assert got["tokens"] == want["tokens"]
    assert got["report"] == want["report"]
    assert got["runtimes"] == want["runtimes"]
    (_, _, failovers, _, duplicates, evacuated, accounted, dropped,
     misses) = got["report"]
    assert accounted == 12 and failovers > 0 and evacuated > 0
    assert dropped > 0 and misses > 0
    assert any(k[1] == 1 for k in got["tokens"])          # forks served
    evac, verify, forks = zip(*got["runtimes"])
    assert evac[0] == evacuated and sum(verify) > 0 and sum(forks) > 0
    assert got["events"] == want["events"]
    instants = [e[3] for e in got["events"] if e[1] == "cluster"]
    assert {"crash", "restart", "failover"} <= set(instants)
    # a failover instant marks every re-placement, off the crash or after
    # a timeout
    assert instants.count("failover") >= failovers
    got_m = _split_series(jparse_prometheus_text(
        got["metrics"].prometheus_text()))
    want_m = _split_series(jparse_prometheus_text(
        want["metrics"].prometheus_text()))
    for k in [k for k in want_m if "_compiles{" in k]:
        assert got_m.pop(k) == 0.0      # the port compiles nothing
        want_m.pop(k)
    assert got_m == want_m
    cluster = {k for k in got_m if k.startswith("epara_cluster_")}
    assert cluster == {"epara_cluster_failovers_total",
                       "epara_cluster_offload_retries_total",
                       "epara_cluster_duplicate_results_total",
                       "epara_cluster_dropped_offloads_total",
                       "epara_cluster_heartbeat_misses_total",
                       "epara_cluster_servers_down"}
    assert got_m["epara_cluster_failovers_total"] == failovers
    assert got_m["epara_cluster_duplicate_results_total"] == duplicates
    assert got_m["epara_cluster_servers_down"] == 0.0
