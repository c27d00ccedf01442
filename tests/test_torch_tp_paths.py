"""Speculation, the dense-view step and one-shot prefill split by heads
(``launch/steps.py`` ``ShardedPagedStep`` under ``--pjit-decode``) on the
CPU, on meshes that list the CPU ``tp`` times.

A float32 toy dense config (8 query heads on 4 kv heads, a 256-token
vocabulary) and ``reduced(mixtral-8x7b)`` in float32 (4 query and 4 kv
heads, 4 experts, a 64-token window):

* ``verify_step_paged_tp``, ``decode_step_tp``, ``prefill_chunk_tp`` and
  ``prefill_tp`` at tp = 1 equal the unsharded functions bit for bit; at
  tp = 2 and 4 their logits lie within 1e-5 of their norm of tp = 1's,
  and the K/V they write, put back side by side, within float32 fuzz;
* a wave with a self-draft (k = 4), a reduced-mixtral wave over a slot
  budget above its window (the ring: one-shot prefill and the dense-view
  step) and the ``paged_native=False`` oracle equal the reference's own
  ``ServiceRuntime(paged_step_builder=paged_decode_builder(mesh))`` over
  a (1, 4) mesh of four XLA host devices (one reference run for the file,
  in a subprocess started when the module's first test starts): greedy
  chains, verify launches, accepted tokens and draft steps;
* the copy-on-write over a verify span into a shared prefix block copies
  every shard's pools; the launcher's ``--pjit-decode --draft-arch`` and
  ``--no-chunked-prefill`` over two CPU shards.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import toy_config
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve, steps
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import pool_sections, take_shard
from repro_torch.serving.engine import (SELF_DRAFT, GenerationRequest,
                                        ServiceRuntime)

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAT = TaskCategory(Sensitivity.LATENCY, False)
_JCFG = toy_config(num_heads=8, num_kv_heads=4, vocab_size=256)
_CFG = ModelConfig(**dataclasses.asdict(_JCFG))
KW = dict(max_seq_len=48, block_size=8)
# above reduced mixtral-8x7b's 64-token window: a ring of per-slot K/V
RING_KW = dict(max_seq_len=96, block_size=8)
TOL = 1e-5


def _moe_cfg():
    return dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                               dtype="float32", param_dtype="float32")


def _requests(n, vocab, seed=0, longest=30, new=6):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, tokens=rng.integers(1, vocab, int(rng.integers(
        3, longest))).tolist(), n=new) for i in range(n)]


# each scenario: the config (the toy's fields, or an arch reduced), the
# runtime's knobs and the requests
SCENARIOS = {
    "draft": dict(arch=None, kw={**KW, "draft": True},
                  requests=_requests(6, 256)),
    "oracle": dict(arch=None, kw={**KW, "paged_native": False},
                   requests=_requests(6, 256)),
    "ring": dict(arch="mixtral-8x7b", kw=RING_KW,
                 requests=_requests(6, 512, longest=80, new=8)),
}

# the reference's runtime under its pjit builder on a (1, 4) mesh of XLA
# host devices, one run a scenario: its chains and speculation counters,
# and each config's weights
REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro import configs
from repro.core.allocator import ParallelPlan
from repro.core.categories import Sensitivity, TaskCategory
from repro.launch.steps import paged_decode_builder
from repro.models.config import ModelConfig
from repro.models.registry import model_api
from repro.serving.engine import GenerationRequest, ServiceRuntime

spec = json.loads(open(sys.argv[1]).read())
# the mesh of the reference's own code, with the automatic sharding its
# pjit builder was written for (this JAX's ``make_mesh`` defaults to
# explicit axes)
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out, weights = {}, {}
for name, sc in spec["scenarios"].items():
    cfg = (ModelConfig(**spec["toy"]) if sc["arch"] is None else
           dataclasses.replace(configs.reduced(configs.get_config(
               sc["arch"])), dtype="float32", param_dtype="float32"))
    params = model_api(cfg).init(jax.random.PRNGKey(0), cfg)
    weights[sc["arch"] or "toy"] = params
    kw = dict(sc["kw"])
    if kw.pop("draft", False):
        kw.update(draft_params=params, draft_cfg=cfg)
    rt = ServiceRuntime(cfg, params, ParallelPlan(
        service="t", category=TaskCategory(Sensitivity.LATENCY, False),
        bs=4), paged_step_builder=paged_decode_builder(mesh), **kw)
    for r in sc["requests"]:
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"]))
    out[name] = dict(
        tokens={str(r.rid): [int(t) for t in r.tokens] for r in rt.drain()},
        verify=rt.verify_launches, accepted=rt.accepted_tokens,
        draft_steps=rt.draft_steps, oneshot=rt.oneshot_prefills,
        ring=rt.ring_fallback, native=rt.paged_native)
flat = {}
for key, params in weights.items():
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat[key + "|" + "/".join(str(k.key) for k in path)] = \
            np.asarray(leaf)
np.savez(sys.argv[2], runs=json.dumps(out), devices=jax.device_count(),
         **flat)
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference run, started with the module's first test so that
    the port's own tests run beside it."""
    tmp = tmp_path_factory.mktemp("ref")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps(dict(toy=dataclasses.asdict(_JCFG),
                                    scenarios=SCENARIOS)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = tmp / "ref.npz"
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(spec),
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def reference(_reference_run):
    """The reference's runs by scenario and each config's weights bridged
    to the port."""
    proc, out = _reference_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    z = np.load(out)
    assert int(z["devices"]) == 4
    weights = {}
    for key, cfg in (("toy", _CFG), ("mixtral-8x7b", _moe_cfg())):
        flat = {k.split("|", 1)[1]: z[k] for k in z.files
                if k.startswith(key + "|")}
        weights[key] = bridge.params_from_jax(_unflatten(flat), cfg, "cpu")
    return dict(runs=json.loads(str(z["runs"])), weights=weights)


def _mesh(tp):
    return meshlib.make_mesh((1, tp), ("data", "model"), ["cpu"] * tp)


def _runtime(cfg, params, tp=None, *, bs=4, **kw):
    builder = None if tp is None else steps.paged_decode_builder(_mesh(tp))
    return ServiceRuntime(cfg, params, ParallelPlan(
        service="t", category=LAT, bs=bs), device="cpu",
        paged_step_builder=builder, **kw)


def _serve(cfg, params, reqs, tp=None, **kw):
    rt = _runtime(cfg, params, tp, **kw)
    for r in reqs:
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"]))
    return rt, {str(r.rid): [int(t) for t in r.tokens] for r in rt.drain()}


# ---------------------------------------------------------------------------
# the four functions, at tp = 1 bit for bit, at tp = 2 and 4 to 1e-5
# ---------------------------------------------------------------------------

def _family(name):
    cfg = _CFG if name == "dense" else _moe_cfg()
    return cfg, model_api(cfg).init(7, cfg, "cpu")


def _inputs(cfg, seed=3):
    """Seeded operands of the four steps: dense caches, page pools and
    their block tables, tokens and lengths."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)
    L, H, D, V = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, \
        cfg.vocab_size
    B, S, bs, nblk = 3, 40, 8, 5
    pools = (L, B * nblk + 1, bs, H, D)
    tables = rng.permutation(B * nblk).reshape(B, nblk)
    return dict(
        prompt=t(rng.integers(1, V, (2, 20)), torch.int32),
        dense_k=t(rng.standard_normal((L, B, S, H, D))),
        dense_v=t(rng.standard_normal((L, B, S, H, D))),
        dense_len=t([3, 17, 0], torch.int32),
        token=t(rng.integers(1, V, B), torch.int32),
        live=t([True, True, False], torch.bool),
        chunk=t(rng.integers(1, V, (B, 8)), torch.int32),
        chunk_len=t([8, 5, 0], torch.int32),
        pool_k=t(rng.standard_normal(pools)),
        pool_v=t(rng.standard_normal(pools)),
        tables=t(tables, torch.int32),
        pool_len=t([5, 17, 0], torch.int32),
        fed=t(rng.integers(1, V, (B, 5)), torch.int32),
        fed_len=t([5, 0, 5], torch.int32))


def _whole(parts):
    """Shards' K/V (heads on axis 3) put back side by side."""
    return torch.cat(parts, dim=3)


def _unsharded_steps(cfg, params, x):
    api = model_api(cfg)
    logits_p, cache = api.prefill(params, cfg, {"tokens": x["prompt"]},
                                  cache_size=24)
    dk, dv = x["dense_k"].clone(), x["dense_v"].clone()
    logits_d, out = api.decode_step(
        params, cfg, x["token"], {"k": dk, "v": dv, "len": x["dense_len"]},
        live=x["live"])
    ck, cv = x["dense_k"].clone(), x["dense_v"].clone()
    logits_c, cout = api.prefill_chunk(
        params, cfg, {"tokens": x["chunk"]},
        {"k": ck, "v": cv, "len": x["dense_len"]}, chunk_len=x["chunk_len"])
    pk, pv = x["pool_k"].clone(), x["pool_v"].clone()
    logits_v, _ = api.verify_step_paged(
        params, cfg, {"tokens": x["fed"]},
        {"k": pk, "v": pv, "len": x["pool_len"]}, x["tables"],
        chunk_len=x["fed_len"], block_size=8)
    return dict(prefill=logits_p, prefill_k=cache["k"], prefill_v=cache["v"],
                decode=logits_d, decode_len=out["len"], decode_k=dk,
                decode_v=dv, chunk=logits_c, chunk_len=cout["len"],
                chunk_k=ck, chunk_v=cv, verify=logits_v, verify_k=pk,
                verify_v=pv)


def _sharded_steps(cfg, params, x, tp):
    step = _runtime(cfg, params, tp, **KW).sharded_step
    api, shards, mesh = step.api, step.shards, step.mesh
    each = lambda t: [t] * tp
    split = lambda t: [take_shard(t, 3, j, tp, pool_sections(
        cfg.num_kv_heads)).clone() for j in range(tp)]
    logits_p, caches = api.prefill_tp(shards, cfg, each(x["prompt"]), 24,
                                      mesh=mesh)
    dk, dv = split(x["dense_k"]), split(x["dense_v"])
    logits_d, dlen = api.decode_step_tp(
        shards, cfg, each(x["token"]),
        [{"k": k, "v": v, "len": x["dense_len"]} for k, v in zip(dk, dv)],
        each(x["live"]), mesh=mesh)
    ck, cv = split(x["dense_k"]), split(x["dense_v"])
    logits_c, clen = api.prefill_chunk_tp(
        shards, cfg, each(x["chunk"]),
        [{"k": k, "v": v, "len": x["dense_len"]} for k, v in zip(ck, cv)],
        each(x["chunk_len"]), mesh=mesh)
    pk, pv = split(x["pool_k"]), split(x["pool_v"])
    logits_v, vlen = api.verify_step_paged_tp(
        shards, cfg, each(x["fed"]),
        [{"k": k, "v": v, "len": x["pool_len"]} for k, v in zip(pk, pv)],
        each(x["tables"]), each(x["fed_len"]), block_size=8, mesh=mesh)
    assert torch.equal(vlen, x["pool_len"])
    return dict(prefill=logits_p,
                prefill_k=_whole([c["k"] for c in caches]),
                prefill_v=_whole([c["v"] for c in caches]),
                decode=logits_d, decode_len=dlen, decode_k=_whole(dk),
                decode_v=_whole(dv), chunk=logits_c, chunk_len=clen,
                chunk_k=_whole(ck), chunk_v=_whole(cv), verify=logits_v,
                verify_k=_whole(pk), verify_v=_whole(pv))


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_sharded_functions_equal_the_unsharded_ones(family, tp):
    cfg, params = _family(family)
    x = _inputs(cfg)
    base = _unsharded_steps(cfg, params, x)
    got = _sharded_steps(cfg, params, x, tp)
    assert got.keys() == base.keys()
    live = x["live"]
    for key in base:
        a, b = got[key], base[key]
        if key == "decode":
            # a dead slot's logits are garbage on both sides
            a, b = a[live], b[live]
        if tp == 1:
            assert torch.equal(a, b), key
        elif key.endswith("_len"):
            assert torch.equal(a, b), key
        elif key in ("prefill", "decode", "chunk", "verify"):
            assert _rel(a, b) <= TOL, (key, _rel(a, b))
        else:
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# copy-on-write over a verify span, the launcher
# ---------------------------------------------------------------------------

def test_verify_span_copies_a_shared_block_on_every_shard():
    """A slot sharing its first three blocks with another (a prefix hit)
    writes a verify span into the third: ``ensure_writable`` gives it a
    private copy of that block on every shard, and the verify then writes
    each shard's copy, leaving the shared block as it was."""
    params = model_api(_CFG).init(1, _CFG, "cpu")
    rt = _runtime(_CFG, params, 2, draft_params=SELF_DRAFT, **KW)
    step, arena = rt.sharded_step, rt._ensure_arena(rt.groups[0])
    gen = torch.Generator().manual_seed(0)
    for j in range(2):
        for t in arena._tensors_on(j):
            t.copy_(torch.randn(t.shape, generator=gen))
    a = arena.alloc(24)
    arena.set_len(a, 20)
    shared = [int(b) for b in arena._block_tables[a][:3]]
    b = arena.alloc(40, shared=shared)
    arena.set_len(b, 18)
    before = [[t.clone() for t in arena._tensors_on(j)] for j in range(2)]
    assert arena.ensure_writable(b, 18, 5) == 1
    fresh = int(arena._block_tables[b][2])
    assert fresh != shared[2] and arena.block_ref(shared[2]) == 1
    for j in range(2):
        for t, old in zip(arena._tensors_on(j), before[j]):
            assert torch.equal(t[:, fresh], old[:, shared[2]])
    cap, k = arena.capacity, 4
    fed = torch.zeros((cap, k + 1), dtype=torch.int32)
    fed[b] = torch.tensor([5, 6, 7, 8, 9])
    chunk_len = torch.zeros((cap,), dtype=torch.int32)
    chunk_len[b] = k + 1
    step.verify(arena, fed, chunk_len)
    for j in range(2):
        for t, old in zip(arena._tensors_on(j), before[j]):
            assert torch.equal(t[:, shared[2]], old[:, shared[2]])
            # rows 2..6 of the copy are the span's; rows 0..1 the hit's
            assert torch.equal(t[:, fresh, :2], old[:, shared[2], :2])
            assert not torch.equal(t[:, fresh, 2:7], old[:, shared[2], 2:7])


def _launch(capsys, monkeypatch, tp, argv):
    if tp > 1:
        monkeypatch.setattr(serve, "service_mesh", lambda device: (
            meshlib.make_mesh((1, tp), ("data", "model"), [device] * tp)))
    assert serve.main(["--device", "cpu", "--pjit-decode", "--requests",
                       "4", "--max-new-tokens", "4", "--max-seq-len",
                       "32", *argv]) == 0
    out = capsys.readouterr().out
    assert f"(tp={tp})" in out
    # the served and speculation lines without their wall times
    return {line.split()[0]: re.sub(r" in \S+s \(\S+ tok/s,", "", line)
            for line in out.splitlines()
            if line.startswith(("served", "speculative"))}


@pytest.mark.parametrize("case", ["draft", "oneshot"])
def test_launcher_serves_a_draft_and_oneshot_over_cpu_shards(
        capsys, monkeypatch, case):
    """``--pjit-decode --draft-arch`` (minitron-4b's self-draft shares
    its shards; minicpm-2b, of the same family and reduced vocabulary,
    takes minitron-4b's whole tree as its draft) and
    ``--no-chunked-prefill`` over two CPU shards serve what the (1, 1)
    mesh serves: the served tokens and speculation counters agree."""
    argv = (["--archs", "minicpm-2b,minitron-4b", "--draft-arch",
             "minitron-4b"] if case == "draft" else
            ["--archs", "minicpm-2b", "--no-chunked-prefill"])
    one = _launch(capsys, monkeypatch, 1, argv)
    two = _launch(capsys, monkeypatch, 2, argv)
    assert two == one
    assert "served 4/4 requests" in two["served"]
    if case == "draft":
        assert " 0 verify launches" not in two["speculative"]
    else:
        assert "4 one-shot prefills" in two["served"]


# ---------------------------------------------------------------------------
# waves against the reference's pjit builder
# ---------------------------------------------------------------------------

def _ref_weights(reference, name):
    arch = SCENARIOS[name]["arch"]
    cfg = _CFG if arch is None else _moe_cfg()
    return cfg, reference["weights"][arch or "toy"]


@pytest.mark.parametrize("tp", [2, 4])
def test_self_draft_wave_equals_the_reference(reference, tp):
    cfg, params = _ref_weights(reference, "draft")
    want = reference["runs"]["draft"]
    rt, got = _serve(cfg, params, SCENARIOS["draft"]["requests"], tp,
                     draft_params=SELF_DRAFT, **KW)
    assert got == want["tokens"]
    assert (rt.verify_launches, rt.accepted_tokens, rt.draft_steps) == (
        want["verify"], want["accepted"], want["draft_steps"])
    assert rt.verify_launches > 0
    # the self-draft runs through the target's step over a split arena
    assert rt.sharded_draft is rt.sharded_step
    draft = rt.groups[0].draft
    assert len(draft.shard_pages) == tp
    assert draft.shard_pages[1][0].shape[3] == cfg.num_kv_heads // tp


@pytest.mark.parametrize("tp", [2, 4])
def test_ring_wave_equals_the_reference(reference, tp):
    cfg, params = _ref_weights(reference, "ring")
    want = reference["runs"]["ring"]
    assert want["ring"] and not want["native"]
    rt, got = _serve(cfg, params, SCENARIOS["ring"]["requests"], tp,
                     **RING_KW)
    assert rt.ring_fallback and rt.sharded_step.dense
    assert got == want["tokens"]
    assert rt.oneshot_prefills == want["oneshot"] == 6
    # the ring's K/V is per-slot state split by kv head; nothing paged
    arena = rt.groups[0].arena
    assert arena.state_keys == ["k", "v"] and not arena.pages
    assert arena.shard_state[1][0].shape[3] == cfg.num_kv_heads // tp
    # the dense-view step's kernel work is the unsharded step's, split
    base = _runtime(cfg, params, **RING_KW)
    cost, cost1 = rt.decode_cost_analysis(), base.decode_cost_analysis()
    assert cost["kernel_flops"] == cost1["kernel_flops"]
    assert cost["kernel_calls"]["decode_attention"] == \
        tp * cost1["kernel_calls"]["decode_attention"] == \
        tp * cfg.num_layers


def test_oracle_wave_equals_the_reference(reference):
    cfg, params = _ref_weights(reference, "oracle")
    want = reference["runs"]["oracle"]
    rt, got = _serve(cfg, params, SCENARIOS["oracle"]["requests"], 2,
                     paged_native=False, **KW)
    assert rt.sharded_step.dense and not want["native"]
    assert got == want["tokens"]
    _, native = _serve(cfg, params, SCENARIOS["oracle"]["requests"], 2,
                       **KW)
    assert native == got
