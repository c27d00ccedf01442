"""One-shot prefill and the dense-view step split by heads for the SSM,
audio, hybrid and VLM families, and sync and the dense cache under the
head-sharded builder (``launch/steps.py`` ``paged_decode_builder``,
``--pjit-decode``), on the CPU, on meshes that list the CPU ``tp`` times.

Each family runs its reference's reduced config in float32:
``reduced(mamba2-2.7b)`` (16 SSD heads, one group),
``reduced(whisper-large-v3)`` (4 heads, a 64-frame encoder),
``reduced(zamba2-7b, num_layers=5)`` (16 SSD heads, the shared block's 4
heads applied twice) and ``reduced(paligemma-3b)`` (4 query heads on one
kv head, replicated on every shard, a 16-row image prefix):

* each family's new ``*_tp`` functions (``prefill_tp``;
  ``decode_step_tp`` and ``prefill_chunk_tp`` of the three with
  attention) equal the unsharded ones bit for bit at tp = 1, and at tp =
  2 and 4 their logits lie within 1e-5 of their norm of tp = 1's and the
  caches they write, put back together, within float32 fuzz;
* one-shot waves (``chunked_prefill=False``, the four families), oracle
  waves (``paged_native=False``, the three with attention), a sync wave
  and a dense-cache wave at tp = 2 and 4 give the greedy chains of the
  reference's own ``ServiceRuntime(paged_step_builder=
  paged_decode_builder(mesh))`` over a (1, 4) ``AxisType.Auto`` mesh of
  four XLA host devices (the reference's runs in two subprocesses
  started with the module's first test; paligemma's under
  ``impl="ref"``: the Pallas flash drops prefix keys past the query
  tile); sync and the dense cache build no sharded step and equal the
  unsharded port;
* every shard receives an audio request's frames and a VLM request's
  image rows, one-shot and on the dense view's first chunk;
* the launcher's ``--pjit-decode`` with ``--no-chunked-prefill``,
  ``--mode sync`` and ``--kvcache-impl dense`` over two CPU shards.
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

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve, steps
from repro_torch.models import encdec, vlm
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import pool_sections, section_parts, take_shard
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAT = TaskCategory(Sensitivity.LATENCY, False)
ARCHS = {"ssm": ("mamba2-2.7b", {}), "audio": ("whisper-large-v3", {}),
         "hybrid": ("zamba2-7b", {"num_layers": 5}),
         "vlm": ("paligemma-3b", {})}
# a slot holds the VLM's 16 prefix rows, a prompt of up to 23 tokens and
# 6 new ones
KW = dict(max_seq_len=48, block_size=8)
TOL = 1e-5


def _cfg(family):
    arch, over = ARCHS[family]
    return dataclasses.replace(reduced(get_config(arch), **over),
                               dtype="float32", param_dtype="float32")


def _requests(family, seed=0, n=5):
    """``n`` requests of two prompt lengths (the reference compiles its
    one-shot prefill once a length), one longer than a chunk bucket."""
    cfg = _cfg(family)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = {"audio": cfg.encoder_len, "vlm": cfg.prefix_len}.get(family)
        extras = None if rows is None else {"embeddings": rng.standard_normal(
            (rows, cfg.d_model)).astype(np.float32).tolist()}
        out.append(dict(rid=i, tokens=rng.integers(
            1, cfg.vocab_size, (5, 21)[i % 2]).tolist(), n=6, extras=extras))
    return out


# each scenario: its family and the runtime's knobs
SCENARIOS = {
    **{f"oneshot_{f}": dict(family=f, kw={"chunked_prefill": False})
       for f in ARCHS},
    **{f"oracle_{f}": dict(family=f, kw={"paged_native": False})
       for f in ("audio", "hybrid", "vlm")},
    "sync": dict(family="ssm", kw={"mode": "sync"}),
    "dense_cache": dict(family="vlm", kw={"kvcache_impl": "dense"}),
}

# the reference's runtime under its pjit builder on a (1, 4) mesh of XLA
# host devices, one run a scenario: its chains; and each family's weights
REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro import configs
from repro.core.allocator import ParallelPlan
from repro.core.categories import Sensitivity, TaskCategory
from repro.launch.steps import paged_decode_builder
from repro.models.registry import model_api
from repro.serving.engine import GenerationRequest, ServiceRuntime

spec = json.loads(open(sys.argv[1]).read())
# the mesh of the reference's own code, with the automatic sharding its
# pjit builder was written for (this JAX's ``make_mesh`` defaults to
# explicit axes)
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
weights, out = {}, {}
for family, (arch, over) in spec["archs"].items():
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch),
                                              **over),
                              dtype="float32", param_dtype="float32")
    weights[family] = (cfg, model_api(cfg).init(jax.random.PRNGKey(0), cfg))
for name, sc in spec["scenarios"].items():
    cfg, params = weights[sc["family"]]
    # paligemma's reference runs its plain attention: the Pallas flash
    # kernel drops prefix keys past the query tile
    impl = "ref" if sc["family"] == "vlm" else None
    rt = ServiceRuntime(cfg, params, ParallelPlan(
        service="t", category=TaskCategory(Sensitivity.LATENCY, False),
        bs=4), impl=impl, paged_step_builder=paged_decode_builder(mesh),
        **spec["kw"], **sc["kw"])
    for r in spec["requests"][sc["family"]]:
        extras = None if r["extras"] is None else {
            "embeddings": np.asarray(r["extras"]["embeddings"], np.float32)}
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"], extras=extras))
    out[name] = dict(
        tokens={str(r.rid): [int(t) for t in r.tokens] for r in rt.drain()},
        oneshot=rt.oneshot_prefills, native=rt.paged_native)
flat = {}
for family, (_, params) in weights.items():
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat[family + "|" + "/".join(str(k.key) for k in path)] = \
            np.asarray(leaf)
np.savez(sys.argv[2], runs=json.dumps(out), devices=jax.device_count(),
         **flat)
"""


# the reference runs in two subprocesses started together, the one-shot
# scenarios in one and the rest in the other
GROUPS = ([n for n in SCENARIOS if n.startswith("oneshot")],
          [n for n in SCENARIOS if not n.startswith("oneshot")])


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference runs, started with the module's first test so that
    the port's own tests run beside them."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    runs = []
    for i, names in enumerate(GROUPS):
        spec = tmp / f"spec{i}.json"
        spec.write_text(json.dumps(dict(
            archs=ARCHS, kw=KW,
            scenarios={n: SCENARIOS[n] for n in names},
            requests={f: _requests(f) for f in ARCHS})))
        out = tmp / f"ref{i}.npz"
        runs.append((subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(spec), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), out))
    yield runs
    for proc, _ in runs:
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
    """The reference's runs by scenario and each family's weights bridged
    to the port."""
    runs, weights = {}, {}
    for proc, out in _reference_run:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        z = np.load(out)
        assert int(z["devices"]) == 4
        runs.update(json.loads(str(z["runs"])))
    # both runs draw the same weights from PRNGKey(0): the last one's
    for family in ARCHS:
        flat = {k.split("|", 1)[1]: z[k] for k in z.files
                if k.startswith(family + "|")}
        weights[family] = bridge.params_from_jax(_unflatten(flat),
                                                 _cfg(family), "cpu")
    return dict(runs=runs, weights=weights)


def _mesh(tp):
    return meshlib.make_mesh((1, tp), ("data", "model"), ["cpu"] * tp)


def _runtime(cfg, params, tp=None, **kw):
    builder = None if tp is None else steps.paged_decode_builder(_mesh(tp))
    return ServiceRuntime(cfg, params, ParallelPlan(
        service="t", category=LAT, bs=4), device="cpu",
        paged_step_builder=builder, **{**KW, **kw})


def _serve(cfg, params, reqs, tp=None, **kw):
    rt = _runtime(cfg, params, tp, **kw)
    for r in reqs:
        extras = None if r["extras"] is None else {
            "embeddings": np.asarray(r["extras"]["embeddings"], np.float32)}
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"], extras=extras))
    return rt, {str(r.rid): [int(t) for t in r.tokens] for r in rt.drain()}


# ---------------------------------------------------------------------------
# the new functions, at tp = 1 bit for bit, at tp = 2 and 4 to 1e-5
# ---------------------------------------------------------------------------

def _inputs(cfg, family, seed=3):
    """Seeded operands: a prompt (with its frames or image rows), and a
    dense cache of three slots (every leaf random, the SSD state too)
    with lengths, a token a slot, a live mask and a chunk."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)
    B, S, V = 3, 40, cfg.vocab_size
    probe = model_api(cfg).init_cache(cfg, B, S, device="meta")
    cache = {k: t(rng.standard_normal(tuple(v.shape)) * 0.5)
             for k, v in probe.items() if k != "len"}
    x = dict(prompt=t(rng.integers(1, V, (2, 20)), torch.int32),
             cache=cache, len=t([3, 17, 0], torch.int32),
             token=t(rng.integers(1, V, B), torch.int32),
             live=t([True, True, False], torch.bool),
             chunk=t(rng.integers(1, V, (B, 8)), torch.int32),
             chunk_len=t([8, 5, 0], torch.int32))
    rows = {"audio": cfg.encoder_len, "vlm": cfg.prefix_len}.get(family)
    if rows is not None:
        x["prompt_emb"] = t(rng.standard_normal((2, rows, cfg.d_model)))
        x["chunk_emb"] = t(rng.standard_normal((B, rows, cfg.d_model)))
    return x


def _splits(cfg, keys):
    """Each cache leaf's split over the shards: the per-slot state by
    ``steps.state_split``, the K/V (the hybrid's ``attn_k``/``attn_v``)
    on their kv heads."""
    return {k: (steps.state_split(cfg, k) if k not in ("attn_k", "attn_v")
                else (3, pool_sections(cfg.num_kv_heads))) for k in keys}


def _split(cache, splits, tp):
    return [{k: take_shard(v, splits[k][0], j, tp, splits[k][1]).clone()
             for k, v in cache.items()} for j in range(tp)]


def _join(parts, dim, sections):
    """The whole tensor from its shards' ``parts``: each section's parts
    from the first shard holding each."""
    n, pieces, at = len(parts), [], 0
    for size, split in sections:
        m = section_parts(split, n)
        pieces.extend(parts[p * n // m].narrow(dim, at, size // m)
                      for p in range(m))
        at += size // m
    return torch.cat(pieces, dim=dim)


def _whole(caches, splits):
    return {k: _join([c[k] for c in caches], *splits[k]) for k in splits}


def _with_len(cache, n):
    return {**cache, "len": n}


def _unsharded(cfg, family, params, x):
    api = model_api(cfg)
    out = {}
    batch = {"tokens": x["prompt"]}
    if "prompt_emb" in x:
        batch["embeddings"] = x["prompt_emb"]
    out["prefill"], cache = api.prefill(params, cfg, batch, cache_size=24)
    out["prefill_cache"] = {k: v for k, v in cache.items() if k != "len"}
    if family == "ssm":
        return out
    c = {k: v.clone() for k, v in x["cache"].items()}
    out["decode"], dc = api.decode_step(params, cfg, x["token"],
                                        _with_len(c, x["len"]),
                                        live=x["live"])
    out["decode_len"], out["decode_cache"] = dc["len"], c
    c = {k: v.clone() for k, v in x["cache"].items()}
    batch = {"tokens": x["chunk"]}
    if "chunk_emb" in x:
        batch["embeddings"] = x["chunk_emb"]
    out["chunk"], cc = api.prefill_chunk(params, cfg, batch,
                                         _with_len(c, x["len"]),
                                         chunk_len=x["chunk_len"])
    out["chunk_len"], out["chunk_cache"] = cc["len"], c
    return out


def _sharded(cfg, family, params, x, tp):
    step = _runtime(cfg, params, tp).sharded_step
    api, shards, mesh = step.api, step.shards, step.mesh
    each = lambda t: [t] * tp
    emb = lambda k: {} if k not in x else {"embeddings": each(x[k])}
    out = {}
    out["prefill"], caches = api.prefill_tp(
        shards, cfg, each(x["prompt"]), 24, mesh=mesh, **emb("prompt_emb"))
    keys = [k for k in caches[0] if k != "len"]
    out["prefill_cache"] = _whole(caches, _splits(cfg, keys))
    if family == "ssm":
        return out
    splits = _splits(cfg, list(x["cache"]))
    parts = _split(x["cache"], splits, tp)
    out["decode"], out["decode_len"] = api.decode_step_tp(
        shards, cfg, each(x["token"]),
        [_with_len(c, x["len"]) for c in parts], each(x["live"]), mesh=mesh)
    out["decode_cache"] = _whole(parts, splits)
    parts = _split(x["cache"], splits, tp)
    out["chunk"], out["chunk_len"] = api.prefill_chunk_tp(
        shards, cfg, each(x["chunk"]),
        [_with_len(c, x["len"]) for c in parts], each(x["chunk_len"]),
        mesh=mesh, **emb("chunk_emb"))
    out["chunk_cache"] = _whole(parts, splits)
    return out


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_sharded_functions_equal_the_unsharded_ones(family, tp):
    cfg = _cfg(family)
    params = model_api(cfg).init(7, cfg, "cpu")
    x = _inputs(cfg, family)
    base = _unsharded(cfg, family, params, x)
    got = _sharded(cfg, family, params, x, tp)
    assert got.keys() == base.keys()
    live = x["live"]
    for key in base:
        a, b = got[key], base[key]
        if key == "decode":
            # a dead slot's logits are garbage on both sides
            a, b = a[live], b[live]
        if key.endswith("_cache"):
            assert a.keys() == b.keys(), key
            for k in b:
                if tp == 1:
                    assert torch.equal(a[k], b[k]), (key, k)
                else:
                    torch.testing.assert_close(a[k], b[k], atol=2e-5,
                                               rtol=2e-5)
        elif tp == 1 or key.endswith("_len"):
            assert torch.equal(a, b), key
        else:
            assert _rel(a, b) <= TOL, (key, _rel(a, b))


# ---------------------------------------------------------------------------
# waves against the reference's pjit builder
# ---------------------------------------------------------------------------

def _scenario(reference, name, tp):
    sc = SCENARIOS[name]
    family = sc["family"]
    cfg, params = _cfg(family), reference["weights"][family]
    rt, got = _serve(cfg, params, _requests(family), tp, **sc["kw"])
    return rt, got, reference["runs"][name]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_oneshot_wave_equals_the_reference(reference, family, tp):
    rt, got, want = _scenario(reference, f"oneshot_{family}", tp)
    assert got == want["tokens"]
    assert rt.oneshot_prefills == want["oneshot"] == 5
    assert rt.prefill_chunk_calls == 0 and rt.sharded_step.tp == tp


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["audio", "hybrid", "vlm"])
def test_oracle_wave_equals_the_reference(reference, family, tp):
    rt, got, want = _scenario(reference, f"oracle_{family}", tp)
    assert rt.sharded_step.dense and not want["native"]
    assert got == want["tokens"]
    # the oracle's dense-view steps give the native steps' chains
    _, native = _serve(_cfg(family), reference["weights"][family],
                       _requests(family), tp)
    assert native == got


@pytest.mark.parametrize("name", ["sync", "dense_cache"])
def test_sync_and_dense_cache_run_whole_under_the_builder(reference, name):
    """The builder is handed to a sync and a dense-cache runtime, as the
    reference's launcher hands it: no sharded step is built, the service
    runs whole on its device and gives the unsharded port's chains and
    the reference's."""
    sc = SCENARIOS[name]
    cfg, params = _cfg(sc["family"]), reference["weights"][sc["family"]]
    reqs = _requests(sc["family"])
    rt, got = _serve(cfg, params, reqs, 2, **sc["kw"])
    assert rt.sharded_step is None
    _, base = _serve(cfg, params, reqs, **sc["kw"])
    assert got == base == reference["runs"][name]["tokens"]
    assert steps.tp_refusal(cfg, 3, draft=False, **{
        "mode": "continuous", "kvcache_impl": "paged", **sc["kw"]}) is None
    with pytest.raises(ValueError, match="paged continuous path"):
        _runtime(cfg, None, 2, **sc["kw"])


@pytest.mark.parametrize("family", ["audio", "vlm"])
def test_every_shard_gets_the_frames_or_image_rows(monkeypatch, family):
    """Each of four shards receives the request's frames (whisper) or
    image rows (paligemma), not zeros, in the one-shot prefill and in the
    dense view's first chunk: the encoder's and the VLM's input rows are
    recorded shard by shard and held against the request's."""
    cfg = _cfg(family)
    params = model_api(cfg).init(2, cfg, "cpu")
    reqs = _requests(family, n=2)
    seen = []
    if family == "audio":
        inner = encdec._encode_tp

        def spy(shards, cfg_, frames, mesh):
            seen.append([f.clone() for f in frames])
            return inner(shards, cfg_, frames, mesh)

        monkeypatch.setattr(encdec, "_encode_tp", spy)
    else:
        inner = vlm._inputs_tp

        def spy(shards, cfg_, tokens, mesh, embeddings):
            seen.append([e.clone() for e in embeddings])
            return inner(shards, cfg_, tokens, mesh, embeddings)

        monkeypatch.setattr(vlm, "_inputs_tp", spy)
    embs = [torch.tensor(r["extras"]["embeddings"]) for r in reqs]
    for kw in ({"chunked_prefill": False}, {"paged_native": False}):
        seen.clear()
        _serve(cfg, params, reqs, 4, **kw)
        # one prefill, or one first chunk, a request
        assert len(seen) == len(reqs), kw
        for parts in seen:
            assert len(parts) == 4
            for p in parts:
                assert any(torch.equal(p[0], e) for e in embs), kw


# ---------------------------------------------------------------------------
# the launcher over two CPU shards
# ---------------------------------------------------------------------------

def _launch(capsys, monkeypatch, tp, argv):
    if tp > 1:
        monkeypatch.setattr(serve, "service_mesh", lambda device: (
            meshlib.make_mesh((1, tp), ("data", "model"), [device] * tp)))
    assert serve.main(["--device", "cpu", "--pjit-decode", "--requests",
                       "4", "--max-new-tokens", "3", "--max-seq-len",
                       "40", *argv]) == 0
    out = capsys.readouterr().out
    assert f"(tp={tp})" in out
    return out, {line.split()[0]: re.sub(r" in \S+s \(\S+ tok/s,", "", line)
                 for line in out.splitlines() if line.startswith("served")}


@pytest.mark.parametrize("case", ["oneshot", "sync", "dense"])
def test_launcher_serves_oneshot_sync_and_dense_over_cpu_shards(
        capsys, monkeypatch, case):
    """``--pjit-decode`` with ``--no-chunked-prefill`` (whisper and
    mamba2 split by heads), ``--mode sync`` and ``--kvcache-impl dense``
    (whole on the first shard's device, a note saying so) over two CPU
    shards serve 4/4, as the (1, 1) mesh does."""
    archs = {"oneshot": "whisper-large-v3,mamba2-2.7b",
             "sync": "zamba2-7b,paligemma-3b",
             "dense": "whisper-large-v3,zamba2-7b"}[case]
    flag = {"oneshot": ["--no-chunked-prefill"], "sync": ["--mode", "sync"],
            "dense": ["--kvcache-impl", "dense"]}[case]
    argv = ["--archs", archs, *flag]
    _, one = _launch(capsys, monkeypatch, 1, argv)
    out, two = _launch(capsys, monkeypatch, 2, argv)
    assert two == one and "served 4/4 requests" in two["served"]
    assert ("runs whole on cpu" in out) == (case != "oneshot")
    if case == "oneshot":
        assert "4 one-shot prefills" in two["served"]


@pytest.mark.parametrize("flag", [["--mode", "sync"],
                                  ["--kvcache-impl", "dense"]])
def test_launcher_refuses_a_whole_service_over_the_card(monkeypatch, flag):
    """Under ``--pjit-decode`` over four cards a sync or dense-cache
    service runs whole on the first: its whole weights and its dense
    caches (the plan's 512 slots of ``--max-seq-len`` 256, 48.32 GB for
    minicpm-2b) count there.  Two servers' caches (96.64 GB) exceed an
    80 GB card, so the launcher refuses the run before allocating
    anything, naming the server count that fits; one server's fits."""
    card = 80 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("Props", (), {
                            "total_memory": card})())

    def no_runtime(*args, **kwargs):
        raise AssertionError("allocated before the memory check")

    monkeypatch.setattr(serve, "ServiceRuntime", no_runtime)
    monkeypatch.setattr(serve, "EparaServingEngine", no_runtime)
    argv = ["--pjit-decode", "--archs", "minicpm-2b", *flag]
    args = serve._parser().parse_args([*argv, "--servers", "2"])
    mesh = meshlib.make_mesh((1, 4), ("data", "model"))
    cp = serve.control_plane(["minicpm-2b"], 2)
    weights, caches = serve.footprint(args, cp, mesh)
    cfg = get_config("minicpm-2b")
    assert weights == cfg.param_count() * 2
    assert caches == 2 * 512 * 256 * (
        cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2)
    with pytest.raises(RuntimeError, match=r"^the run needs 102\.") as e:
        serve.main([*argv, "--servers", "2"])
    assert "--servers 1 fits" in str(e.value)
    one = serve._parser().parse_args([*argv, "--servers", "1"])
    serve._refuse_what_does_not_fit(one, ["minicpm-2b"],
                                    serve.control_plane(["minicpm-2b"], 1),
                                    card, mesh)
