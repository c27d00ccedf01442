"""The multi-server control plane on the port against the JAX reference.

``tests/test_faults.py``'s toy cluster (one "chat" service deployed on
three servers of 2 GPUs, placed at demand 10.0, ``toy_config`` with the
reference's weights carried over by the bridge) is built twice: over the
reference's ``ServiceRuntime`` (``impl="ref"``) with its
``ClusterSupervisor``, and over the port's (``device="cpu"``) with the
port's.  The same submissions (seeded 6-token prompts, so that every
request's tokens differ) and the same ``FaultSpec`` go through both, on
the supervisor's logical clock.  Every ``ClusterReport`` field must be
equal (outcomes, rounds, failovers, offload retries, duplicates, dropped
offloads, heartbeat misses, evacuated), and so must each served
``(rid, sample)``'s greedy tokens, each reject's verdict, reason and
attempts, and the servers left down.  The scenarios are the reference's:
a crash mid-burst with a restart, dropped handoffs recovered by timeout,
``FAILED`` when no host is left, a straggler, and random schedules from
``random_fault_spec`` (``FAULTS_EXAMPLES`` examples).  Served tokens must
also equal a failure-free run's.

The launcher is run on the CPU through the supervisor at one and three
servers (its ``placements:`` and ``fault schedule`` lines equal what the
reference's control plane and ``random_fault_spec`` give for the same
flags), its argument errors are the reference's, its card sizing refuses
three servers of minicpm-2b on an 80 GB card and takes two, and the
copied simulator replays a ``FaultSpec`` as the reference's does.  Every
comparison is exact.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
from conftest import toy_config
from repro.core import faults as jfaults
from repro.models import transformer as jtransformer
from repro.serving import engine as jengine
from repro.serving import failover as jfailover
from repro_torch import bridge
from repro_torch import core as tcore
from repro_torch.core import categories
from repro_torch.core import faults as tfaults
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.serving import engine as tengine
from repro_torch.serving import failover as tfailover

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

_EXAMPLES = int(os.environ.get("FAULTS_EXAMPLES", "3"))
_CFG = toy_config()
# (core, faults, engine, failover) of each side
SIDES = {"ref": (jcore, jfaults, jengine, jfailover),
         "port": (tcore, tfaults, tengine, tfailover)}


@functools.lru_cache(maxsize=1)
def _weights():
    params = jtransformer.init(jax.random.PRNGKey(0), _CFG)
    tcfg = ModelConfig(**dataclasses.asdict(_CFG))
    return params, tcfg, bridge.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _cluster(side, n_servers=3):
    """``tests/test_faults.py``'s toy control plane, with the "chat"
    service deployed on every server of one side."""
    core, _, engine, _ = SIDES[side]
    params, tcfg, tparams = _weights()
    specs = {"chat": core.ServiceSpec("chat", flops_per_request=1e10,
                                      weights_bytes=2e8, vram_bytes=5e8,
                                      slo_latency_s=100.0)}
    servers = [core.ServerSpec(sid=i, num_gpus=2) for i in range(n_servers)]
    cp = core.EdgeCloudControlPlane(servers, specs)
    cp.run_placement({("chat", i): 10.0 for i in range(n_servers)})

    def runtime():
        if side == "ref":
            return engine.ServiceRuntime(_CFG, params, cp.plans["chat"],
                                         impl="ref")
        return engine.ServiceRuntime(tcfg, tparams, cp.plans["chat"],
                                     device="cpu")

    engines = {s.sid: engine.EparaServingEngine() for s in servers}
    for svc, sid in cp.placements:
        if sid >= 0 and svc not in engines[sid].runtimes:
            engines[sid].deploy(svc, runtime())
    for sid in engines:
        if "chat" not in engines[sid].runtimes:
            engines[sid].deploy("chat", runtime())
    cp.publish_all(0.0)
    for _ in range(n_servers):
        cp.sync_step(0.0)
    return cp, engines


def _prompt(rid):
    return np.random.default_rng(100 + rid).integers(
        1, _CFG.vocab_size, 6).astype(np.int32)


def _supervise(side, n_requests, events=(), base_timeout_s=4.0, at=None,
               start=0.0):
    """Submit ``n_requests`` (at server ``rid % 3``, or all at ``at``) at
    ``start`` and run the cluster to idle under ``events``; returns the
    supervisor and what the run produced, in plain values."""
    _, faults, engine, failover = SIDES[side]
    cp, engines = _cluster(side)
    spec = faults.FaultSpec(events=tuple(
        faults.FaultEvent(**ev) for ev in events))
    sup = failover.ClusterSupervisor(
        cp, engines, injector=faults.FaultInjector(spec) if events else None,
        retry=failover.RetryPolicy(base_timeout_s=base_timeout_s))
    if start:
        sup.step(start)                 # arm a drop budget first
    for rid in range(n_requests):
        sup.submit("chat", engine.GenerationRequest(
            rid=rid, tokens=_prompt(rid), max_new_tokens=4, stream=rid),
            at_server=rid % 3 if at is None else at, now=start)
    rep = sup.run_until_idle(now=start)
    out = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
           if f.name not in ("results", "rejects")}
    out["tokens"] = {(r.rid, r.sample): tuple(int(x) for x in r.tokens)
                     for r in rep.results}
    out["rejects"] = [(r.req.rid, r.verdict.value, r.reason, r.attempts)
                      for r in rep.rejects]
    out["accounted"] = rep.accounted
    out["down"] = sorted(sup.down)
    out["rt_evacuated"] = [rt.evacuated_requests for e in engines.values()
                           for rt in e.runtimes.values()]
    return out


@functools.lru_cache(maxsize=None)
def _oracle(n_requests):
    """The port's failure-free run: greedy tokens by rid."""
    got = _supervise("port", n_requests)
    assert got["accounted"] == n_requests and not got["rejects"]
    return {rid: t for (rid, s), t in got["tokens"].items() if s == 0}


def _same_as_oracle(got, n_requests):
    want = _oracle(n_requests)
    for (rid, sample), toks in got["tokens"].items():
        assert sample == 0 and toks == want[rid], rid


# (events, submissions, base timeout, submitted at, start)
SCENARIOS = {
    "crash_midburst": ((dict(at_s=2.0, kind="crash", sid=0),
                        dict(at_s=8.0, kind="restart", sid=0)),
                       12, 4.0, None, 0.0),
    "dropped_offload": ((dict(at_s=0.5, kind="drop_offload", sid=1,
                              count=2),), 4, 2.0, 1, 1.0),
    "no_host": (tuple(dict(at_s=1.5, kind="crash", sid=s)
                      for s in range(3)), 6, 4.0, None, 0.0),
    "straggler": ((dict(at_s=0.5, kind="straggle", sid=0, duration_s=6.0,
                        factor=3.0),), 9, 4.0, None, 0.0),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_supervisor_matches_reference(case):
    events, n, base, at, start = SCENARIOS[case]
    want = _supervise("ref", n, events, base, at, start)
    got = _supervise("port", n, events, base, at, start)
    assert got == want
    assert got["accounted"] == n
    if case == "crash_midburst":
        assert got["evacuated"] > 0 and got["failovers"] > 0
        assert got["down"] == []            # restarted and rejoined
        assert not got["rejects"]
    elif case == "dropped_offload":
        assert got["dropped_offloads"] == 2
        assert got["offload_retries"] >= 2 and not got["rejects"]
    elif case == "no_host":
        assert got["rejects"] and not got["tokens"]
        assert all(v == "failed" and a >= 1
                   for _, v, _, a in got["rejects"])
    else:
        assert got["heartbeat_misses"] > 0 and not got["rejects"]
    if case != "no_host":
        _same_as_oracle(got, n)


@settings(max_examples=_EXAMPLES, deadline=None, derandomize=True)
@given(chaos_seed=st.integers(min_value=0, max_value=10**6),
       n_requests=st.integers(min_value=4, max_value=10),
       crashes=st.integers(min_value=0, max_value=2),
       drops=st.integers(min_value=0, max_value=2))
def test_random_fault_schedules_match_reference(chaos_seed, n_requests,
                                                crashes, drops):
    """``tests/test_faults.py``'s property on both supervisors: for a
    seed-generated schedule the two runs are equal, every rid is
    accounted, and each served request's tokens equal the failure-free
    run's."""
    spec = tfaults.random_fault_spec(
        [0, 1, 2], 12.0, seed=chaos_seed, crashes=crashes, stragglers=1,
        corruptions=1, dropped_offloads=drops, min_alive=1)
    assert spec.to_json() == jfaults.random_fault_spec(
        [0, 1, 2], 12.0, seed=chaos_seed, crashes=crashes, stragglers=1,
        corruptions=1, dropped_offloads=drops, min_alive=1).to_json()
    events = tuple(dataclasses.asdict(e) for e in spec.events)
    want = _supervise("ref", n_requests, events, 3.0)
    got = _supervise("port", n_requests, events, 3.0)
    assert got == want, spec.to_json()
    assert got["accounted"] == n_requests
    _same_as_oracle(got, n_requests)


def test_simulator_replays_faults_as_the_reference():
    """``tests/test_faults.py``'s simulator schedule through the copied
    simulator with the port's ``FaultSpec``, against the reference's
    simulator with the reference's spec."""
    from repro.core.categories import EDGE_P100 as JEDGE
    from repro.simulator import baselines as jbaselines
    from repro.simulator import engine as jsim
    from repro.simulator import workload as jworkload
    from repro_torch.simulator import baselines, engine as sim, workload

    def run(faults, sim_mod, wl_mod, base_mod, server_cls, gpu):
        services = wl_mod.table1_services()
        servers = [server_cls(sid=i, num_gpus=1, gpu=gpu) for i in range(4)]
        events = wl_mod.generate_requests(services, len(servers),
                                          wl_mod.WorkloadConfig(
                                              horizon_s=30.0,
                                              load_scale=20.0, seed=3))
        spec = faults.FaultSpec(events=(
            faults.FaultEvent(at_s=8.0, kind="crash", sid=1),
            faults.FaultEvent(at_s=16.0, kind="restart", sid=1),
            faults.FaultEvent(at_s=5.0, kind="drop_offload", sid=2,
                              count=3),
            faults.FaultEvent(at_s=10.0, kind="straggle", sid=3,
                              duration_s=5.0, factor=4.0)))
        return sim_mod.Simulation(
            servers, services,
            base_mod.make_scheduler("EPARA", services, gpu, seed=1),
            events, sim_mod.SimConfig(horizon_s=30.0, fault_spec=spec)).run()

    got = run(tfaults, sim, workload, baselines, categories.ServerSpec,
              categories.EDGE_P100)
    want = run(jfaults, jsim, jworkload, jbaselines, jcore.ServerSpec, JEDGE)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.crashes == 1 and got.dropped_offloads == 3
    assert got.failover_resubmits >= got.dropped_offloads


def _reference_lines(servers, chaos_seed, archs=("minicpm-2b",)):
    """The reference's ``placements:`` and ``fault schedule`` lines for
    these flags, from its control plane and ``random_fault_spec``."""
    from repro.configs import get_config
    from repro.launch.serve import service_spec_for
    sids = list(range(servers))
    cp = jcore.EdgeCloudControlPlane(
        [jcore.ServerSpec(sid=i, num_gpus=4) for i in sids],
        {a: service_spec_for(get_config(a)) for a in archs})
    lines = [f"placements: {cp.run_placement({(a, s): 4.0 for a in archs for s in sids})}"]
    if chaos_seed >= 0:
        spec = jfaults.random_fault_spec(sids, 20.0, seed=chaos_seed)
        lines.append(f"fault schedule ({len(spec.events)} events): "
                     + ", ".join(f"{e.kind}@{e.at_s:.1f}s->s{e.sid}"
                                 for e in spec.events))
    return lines


def _count(line, label):
    return int(line.split(label)[0].rsplit(None, 1)[-1].strip(", "))


@pytest.mark.parametrize("servers, chaos_seed, argv", [
    (1, -1, ["--requests", "3", "--max-new-tokens", "3",
             "--max-seq-len", "32"]),
    (3, 1, [])])
def test_launcher_routes_through_the_supervisor(capsys, servers, chaos_seed,
                                                argv):
    rc = serve.main(["--device", "cpu", "--servers", str(servers),
                     "--chaos-seed", str(chaos_seed), *argv])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    n = 3 if argv else 24
    served = [ln for ln in out if ln.startswith("served ")]
    assert len(served) == 1 and served[0].startswith(f"served {n}/{n} ")
    assert f"outcomes={{'local': {n}}}" in served[0]
    for want in _reference_lines(servers, chaos_seed):
        assert want in out
    admission = next(ln for ln in out if ln.startswith("admission (fifo):"))
    assert admission.endswith("offload/timeout retries, 0 final rejects")
    tolerance = [ln for ln in out if ln.startswith("fault tolerance:")]
    if chaos_seed < 0:
        assert not tolerance
        return
    assert len(tolerance) == 1
    assert _count(tolerance[0], "crash failovers") > 0
    assert _count(tolerance[0], "requests evacuated") > 0


@pytest.mark.parametrize("argv", [
    ["--fault-spec", "x.json", "--chaos-seed", "1"],
    ["--retry-timeout-s", "0"], ["--retry-max-attempts", "0"]])
def test_launcher_argument_errors_match_reference(capsys, argv):
    from repro.launch import serve as jserve
    errors = []
    for main in (jserve.main, serve.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.splitlines()[-1])
    assert errors[1] == errors[0] and "error:" in errors[0]


def test_launcher_sizes_the_cluster_for_the_card(monkeypatch):
    """Three servers of minicpm-2b at the plan's 512 slots take 82.48 GB
    of weights and arenas, over an 80 GB card with the headroom; two take
    56.80 GB.  On the card the launcher refuses the first before it
    allocates anything, naming the count that fits."""
    card = 80 * 2 ** 30
    sizes = {}
    for n in (1, 2, 3):
        args = serve._parser().parse_args(["--servers", str(n)])
        weights, arenas = serve.footprint(args)
        assert weights == 2 * 2_724_878_592             # 5.45 GB, once
        assert arenas == n * 25_675_409_408             # int8 pages+scales
        sizes[n] = weights + arenas + serve.HEADROOM_BYTES
    assert sizes[2] < card < sizes[3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("Props", (), {
                            "total_memory": card})())

    def no_runtime(*args, **kwargs):
        raise AssertionError("allocated before the memory check")

    monkeypatch.setattr(serve, "ServiceRuntime", no_runtime)
    monkeypatch.setattr(serve, "EparaServingEngine", no_runtime)
    with pytest.raises(RuntimeError, match=r"^the run needs 82\.48 GB") as e:
        serve.main(["--servers", "3"])
    assert "--servers 2 fits" in str(e.value)
