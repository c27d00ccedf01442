"""Head-sharded paged serving (``launch/steps.py`` ``paged_decode_builder``,
``--pjit-decode``) on the CPU, on meshes that list the CPU ``tp`` times.

A float32 toy dense config (8 query heads on 4 kv heads, a 256-token
vocabulary, so that heads and vocabulary split over 2 and 4 shards):

* at tp = 1 the sharded runtime equals the unsharded one bit for bit
  (every step's logits, the chains, the pools);
* at tp = 2 and 4 its greedy chains equal the unsharded port's and the
  reference's own ``ServiceRuntime(paged_step_builder=
  paged_decode_builder(mesh))`` over a (1, 4) mesh of four XLA host
  devices (one reference run for the file, in a subprocess: the
  device count is fixed when JAX starts), and every step's logits of
  the live rows lie within float32 fuzz of both;
* int8 KV, a templated wave that copies on write, the fused wqkv with
  its bias; the refusals; the launcher; ``decode_cost_analysis``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve, steps
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAT = TaskCategory(Sensitivity.LATENCY, False)
FREQ = TaskCategory(Sensitivity.FREQUENCY, False)
_JCFG = toy_config(num_heads=8, num_kv_heads=4, vocab_size=256)
_CFG = ModelConfig(**dataclasses.asdict(_JCFG))
KW = dict(max_seq_len=48, block_size=8)
ITEM = "ROADMAP.md Queue 1 item 15"

# the reference's runtime under its pjit builder on a (1, 4) mesh of XLA
# host devices; every fused decode step's logits and live mask recorded
REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.core.allocator import ParallelPlan
from repro.core.categories import Sensitivity, TaskCategory
from repro.launch.steps import paged_decode_builder
from repro.models import transformer
from repro.models.config import ModelConfig
from repro.serving.engine import GenerationRequest, ServiceRuntime

spec = json.loads(sys.argv[1])
cfg = ModelConfig(**spec["cfg"])
params = transformer.init(jax.random.PRNGKey(0), cfg)
# the mesh of the reference's own code, with the automatic sharding its
# pjit builder was written for (this JAX's ``make_mesh`` defaults to
# explicit axes, under which the engine's host updates of the step's
# sharded outputs raise)
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
inner = paged_decode_builder(mesh)
steps = []

def builder(rt, arena):
    fn = inner(rt, arena)
    def call(*a):
        out = fn(*a)
        steps.append((np.asarray(out[0]), np.asarray(a[5])))
        return out
    return call

rt = ServiceRuntime(cfg, params, ParallelPlan(
    service="t", category=TaskCategory(Sensitivity.LATENCY, False),
    bs=spec["bs"]), paged_step_builder=builder, **spec["kw"])
for r in spec["requests"]:
    rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
        r["tokens"], np.int32), max_new_tokens=r["n"]))
toks = {str(r.rid): [int(t) for t in r.tokens] for r in rt.drain()}
flat = {"/".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf
        in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(sys.argv[2], tokens=json.dumps(toks), devices=jax.device_count(),
         logits=np.stack([s[0] for s in steps]),
         live=np.stack([s[1] for s in steps]),
         **{"p/" + k: v for k, v in flat.items()})
"""


def _requests(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, tokens=rng.integers(
        1, 256, int(rng.integers(3, 30))).tolist(), n=6) for i in range(n)]


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
def reference(tmp_path_factory):
    """The reference run: its chains, every step's logits and live mask,
    and its weights bridged to the port."""
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    spec = dict(cfg=dataclasses.asdict(_JCFG), bs=4, kw=KW,
                requests=_requests())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          json.dumps(spec), str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    z = np.load(out)
    assert int(z["devices"]) == 4
    params = bridge.params_from_jax(
        _unflatten({k[2:]: z[k] for k in z.files if k.startswith("p/")}),
        _CFG, "cpu")
    return dict(tokens={int(k): v for k, v in
                        json.loads(str(z["tokens"])).items()},
                logits=z["logits"], live=z["live"], params=params)


def _mesh(tp):
    return meshlib.make_mesh((1, tp), ("data", "model"), ["cpu"] * tp)


def _serve(cfg, params, reqs, tp=None, *, bs=4, category=LAT, **kw):
    """Serve ``reqs`` (dicts) unsharded (tp None) or over ``tp`` shards;
    returns (runtime, chains, every decode step's (logits, live))."""
    builder = None if tp is None else steps.paged_decode_builder(_mesh(tp))
    rt = ServiceRuntime(cfg, params, ParallelPlan(
        service="t", category=category, bs=bs), device="cpu",
        paged_step_builder=builder, **{**KW, **kw})
    log = []
    decode = rt._paged_decode

    def recorded(arena, tokens, live, **k):
        logits = decode(arena, tokens, live, **k)
        log.append((logits.clone(), live.clone()))
        return logits

    rt._paged_decode = recorded
    for r in reqs:
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"]))
    return rt, {r.rid: list(r.tokens) for r in rt.drain()}, log


def _pools(rt):
    """The arena's pools with the shards' heads put back side by side."""
    arena = rt.groups[0].arena
    return [torch.cat([s[i] for s in arena.shard_pages], dim=3)
            for i in range(len(arena.pages))]


def test_tp1_is_bit_identical_to_the_unsharded_runtime(reference):
    params = reference["params"]
    _, base, base_log = _serve(_CFG, params, _requests())
    rt, got, log = _serve(_CFG, params, _requests(), tp=1)
    assert rt.sharded_step.tp == 1 and got == base
    assert len(log) == len(base_log)
    for (a, la), (b, lb) in zip(log, base_log):
        assert torch.equal(la, lb) and torch.equal(a, b)
    rt0, _, _ = _serve(_CFG, params, _requests())
    for a, b in zip(_pools(rt), _pools(rt0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_chains_and_logits_equal_the_unsharded_port_and_reference(
        reference, tp):
    params = reference["params"]
    rt0, base, base_log = _serve(_CFG, params, _requests())
    rt, got, log = _serve(_CFG, params, _requests(), tp=tp)
    assert got == base == reference["tokens"]
    assert len(log) == len(base_log) == len(reference["logits"])
    for (a, live), (b, _), ref, ref_live in zip(
            log, base_log, reference["logits"], reference["live"]):
        assert np.array_equal(live.numpy(), ref_live)
        torch.testing.assert_close(a[live], b[live], atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(a[live].numpy(), ref[ref_live],
                                   atol=2e-5, rtol=2e-5)
    for a, b in zip(_pools(rt), _pools(rt0)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
    # every shard holds its kv heads' pools; the reductions ran
    arena = rt.groups[0].arena
    assert len(arena.shard_pages) == tp
    assert arena.shard_pages[0][0].shape[3] == _CFG.num_kv_heads // tp
    assert rt.sharded_step.mesh.reduce_calls > 0


def test_fused_wqkv_with_bias_splits_by_heads():
    cfg = dataclasses.replace(_CFG, fused_projections=True, qkv_bias=True)
    params = transformer.init(3, cfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    params["blocks"]["attn"]["bqkv"] = torch.randn(
        params["blocks"]["attn"]["bqkv"].shape, generator=gen)
    _, base, base_log = _serve(cfg, params, _requests(2))
    for tp in (2, 4):
        rt, got, log = _serve(cfg, params, _requests(2), tp=tp)
        assert got == base
        for (a, live), (b, _) in zip(log, base_log):
            torch.testing.assert_close(a[live], b[live], atol=2e-5,
                                       rtol=2e-5)
    # shard 1's q, k and v columns are heads 4..7, 2..3 and 2..3 of each
    # section, not a contiguous quarter of the fused columns
    hd, w = cfg.head_dim, params["blocks"]["attn"]["wqkv"]
    shard = rt.sharded_step.shards[1].params["blocks"]["attn"]["wqkv"]
    q, k, v = w.split([8 * hd, 4 * hd, 4 * hd], dim=-1)
    want = torch.cat([q[..., 2 * hd:4 * hd], k[..., hd:2 * hd],
                      v[..., hd:2 * hd]], dim=-1)
    assert torch.equal(shard, want)


def test_int8_kv_splits_values_and_scales_by_kv_head(reference):
    params = reference["params"]
    _, base, base_log = _serve(_CFG, params, _requests(), category=FREQ)
    rt, got, log = _serve(_CFG, params, _requests(), tp=2, category=FREQ)
    assert rt.kv_dtype == "int8" and got == base
    pool = rt.groups[0].arena.shard_pages[1][0]
    assert pool.values.shape[3] == 2 and pool.scales.shape[3] == 2
    for (a, live), (b, _) in zip(log, base_log):
        torch.testing.assert_close(a[live], b[live], atol=1e-4, rtol=1e-4)


def test_templated_wave_copies_on_write_in_every_shard(reference):
    params = reference["params"]
    rng = np.random.default_rng(2)
    template = rng.integers(1, 256, 20).tolist()    # 2 blocks + a tail
    wave = [dict(rid=0, tokens=template, n=2)] + [
        dict(rid=i, tokens=template + rng.integers(1, 256, 4).tolist(),
             n=4) for i in range(1, 5)]
    rt0, base, _ = _serve(_CFG, params, wave, bs=2)
    rt, got, _ = _serve(_CFG, params, wave, tp=2, bs=2)
    assert got == base
    assert rt.prefix_cow_copies == rt0.prefix_cow_copies > 0
    assert rt.prefix_hits == rt0.prefix_hits > 0
    for a, b in zip(_pools(rt), _pools(rt0)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def _refusal_dense(**kw):
    params = transformer.init(0, _CFG, "cpu")
    if kw.pop("draft", False):
        kw.update(draft_params=params, draft_cfg=_CFG)
    return _CFG, params, _mesh(kw.pop("tp", 2)), kw


def _refusal_family(arch, tp=2):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import model_api
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              param_dtype="float32")
    return cfg, model_api(cfg).init(0, cfg, "cpu"), _mesh(tp), {}


# each case: (its setup, the words its refusal names, or None where the
# head-sharded step now serves it, or where the service runs whole)
REFUSALS = {
    # sync and the dense cache run whole on the mesh's first device: the
    # runtime builds no sharded step there, as the reference's engine
    # calls its builder on the paged continuous path alone
    "sync": (lambda: _refusal_dense(mode="sync"), None),
    "dense_view": (lambda: _refusal_dense(paged_native=False), None),
    "dense_cache": (lambda: _refusal_dense(kvcache_impl="dense"), None),
    "draft": (lambda: _refusal_dense(draft=True), None),
    # reduced zamba2-7b's 16 SSD heads (and 4 kv heads) over 3 shards
    "hybrid": (lambda: _refusal_family("zamba2-7b", 3),
               "16 SSD heads over tp=3"),
    # reduced paligemma-3b's one kv head would replicate on 3 shards, but
    # its 4 query heads do not split over them
    "vlm": (lambda: _refusal_family("paligemma-3b", 3),
            "1 kv heads and 4 query heads over tp=3"),
    # 4 kv heads over 3 shards: the reference's rule would cut head_dim
    # (its pool spec puts ``model`` on D); the port refuses on purpose
    "head_dim": (lambda: _refusal_dense(tp=3), "not head_dim"),
}


def _fsdp_specs_and_chains_match():
    """``paged_decode_builder(fsdp_params=True)``, the reference's flag:
    on a service mesh (its batch axis 1) the FSDP rule places nothing
    differently for any config, and the runtime's chains and every
    decode step's logits are bit-identical to ``fsdp_params=False``'s."""
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ARCH_IDS:
        params = steps.abstract_params(get_config(arch))
        for tp in (2, 4):
            assert meshlib.param_specs(_fake(tp), params, fsdp=True) == \
                meshlib.param_specs(_fake(tp), params, fsdp=False), arch
    params = transformer.init(0, _CFG, "cpu")
    runs = []
    for fsdp in (False, True):
        rt = ServiceRuntime(_CFG, params, ParallelPlan(
            service="t", category=LAT, bs=4), device="cpu",
            paged_step_builder=steps.paged_decode_builder(
                _mesh(2), fsdp_params=fsdp), **KW)
        log = []
        decode = rt._paged_decode

        def recorded(*a, decode=decode, log=log, **k):
            log.append(decode(*a, **k))
            return log[-1]

        rt._paged_decode = recorded
        for r in _requests(4):
            rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
                r["tokens"], np.int32), max_new_tokens=r["n"]))
        runs.append(({r.rid: list(r.tokens) for r in rt.drain()}, log))
    (base, base_log), (got, log) = runs
    assert got == base and len(log) == len(base_log) > 0
    assert all(torch.equal(a, b) for a, b in zip(log, base_log))


# each path of the paged continuous loop, and the two that run whole:
# (mode, kvcache_impl, the entry points the head-sharded step calls)
PATHS = {"paged_native": ("continuous", "paged", ("decode_step_paged_tp",
                                                  "prefill_chunk_paged_tp")),
         "dense_view": ("continuous", "paged", ("decode_step_tp",
                                                "prefill_chunk_tp")),
         "oneshot": ("continuous", "paged", ("prefill_tp",)),
         "sync": ("sync", "paged", ()),
         "dense_cache": ("continuous", "dense", ())}


def _every_config_is_served_on_every_path():
    """Every config of ``configs/`` at tp 1, 2 and 4 on each path: no
    refusal, the family registers the path's head-sharded entry points
    (the SSM's state step stands for its dense view), and its split plan
    holds; a draft is refused only outside the dense and MoE families."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.registry import model_api
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        api = model_api(cfg)
        params = steps.abstract_params(cfg)
        for tp in (1, 2, 4):
            steps._split_plan(cfg, meshlib.param_specs(
                _fake(tp), params, fsdp=False), tp)
            for path, (mode, impl, entries) in PATHS.items():
                assert steps.tp_refusal(cfg, tp, mode=mode,
                                        kvcache_impl=impl,
                                        draft=False) is None, (arch, path)
                if path == "dense_view" and cfg.family == "ssm":
                    continue
                assert all(getattr(api, e) is not None for e in entries), \
                    (arch, path)
            why = steps.tp_refusal(cfg, tp, mode="continuous",
                                   kvcache_impl="paged", draft=True)
            assert (why is None) == (cfg.family in ("dense", "moe")), arch
            assert why is None or ("a draft model" in why and ITEM in why)


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["fsdp",
                                                     "every_config"])
def test_refusals_name_their_item(case):
    if case == "fsdp":
        _fsdp_specs_and_chains_match()
        pool = torch.empty((2, 9, 8, 4, 48), device="meta")
        assert tuple(steps._paged_leaf_spec(_fake(3), pool)) == \
            (None, None, None, None, "model")
        assert tuple(steps._paged_leaf_spec(_fake(2), pool)) == \
            (None, None, None, "model", None)
        return
    if case == "every_config":
        _every_config_is_served_on_every_path()
        return
    setup, what = REFUSALS[case]
    cfg, params, mesh, kw = setup()
    plan = ParallelPlan(service="t", category=LAT, bs=2)
    build = lambda: ServiceRuntime(
        cfg, params, plan, device="cpu",
        paged_step_builder=steps.paged_decode_builder(mesh),
        **{**KW, "max_seq_len": 32, **kw})
    if what is None:
        mode = kw.get("mode", "continuous")
        impl = kw.get("kvcache_impl", "paged")
        assert steps.tp_refusal(cfg, 2, mode=mode, kvcache_impl=impl,
                                draft="draft_params" in kw) is None
        rt = build()
        if (mode, impl) != ("continuous", "paged"):
            # served whole on the runtime's device: no sharded step
            assert rt.sharded_step is None and rt.params is params
            return
        # a draft and the dense-view step are served over the shards
        assert rt.sharded_step.tp == 2
        assert (rt.speculate_k > 0) == ("draft_params" in kw)
        assert rt.sharded_step.dense == (case == "dense_view")
        return
    with pytest.raises(ValueError, match=ITEM) as e:
        build()
    assert what in str(e.value)


def _fake(tp):
    return meshlib.make_mesh((1, tp), ("data", "model"))


@pytest.mark.parametrize("archs", [
    "minicpm-2b,minitron-4b", "mamba2-2.7b", "whisper-large-v3",
    "mixtral-8x7b", "zamba2-7b", "paligemma-3b"])
def test_launcher_serves_with_pjit_decode_and_refuses_other_families(
        capsys, archs):
    n = 4 if archs == "minicpm-2b,minitron-4b" else 2
    argv = ["--device", "cpu", "--pjit-decode", "--requests", str(n),
            "--max-new-tokens", "3", "--max-seq-len", "32", "--archs",
            archs]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "service mesh: {'data': 1, 'model': 1}" in out
    if archs == "mixtral-8x7b":
        # the control plane places it on no server (its plan needs 16
        # GPUs, over a server's 4), as without --pjit-decode
        assert "placements: []" in out and f"served 0/{n} requests" in out
    else:
        assert f"served {n}/{n} requests" in out


def test_decode_cost_analysis_counts_without_touching_anything(reference):
    params = reference["params"]
    rt, _, _ = _serve(_CFG, params, _requests(), tp=2)
    rt0, _, _ = _serve(_CFG, params, _requests())
    arena = rt.groups[0].arena
    lens, pools = arena.lens.clone(), [p.clone() for p in _pools(rt)]
    calls = rt.sharded_step.mesh.reduce_calls
    got, base = rt.decode_cost_analysis(), rt0.decode_cost_analysis()
    assert rt.decode_traces == rt.prefill_traces == 0
    assert torch.equal(arena.lens, lens)
    assert all(torch.equal(a, b) for a, b in zip(_pools(rt), pools))
    assert rt.sharded_step.mesh.reduce_calls == calls
    # the same work split in two: the kernels run twice as often on half
    # the heads each; the matmuls' FLOPs are the same
    cap, L = arena.capacity, _CFG.num_layers
    assert got["kernel_calls"] == {"paged_decode_attention": 2 * L}
    assert base["kernel_calls"] == {"paged_decode_attention": L}
    assert got["kernel_flops"] == base["kernel_flops"]
    assert got["aten_flops"] == base["aten_flops"]
    # 2 reductions a layer and the embedding's, the logits' gather
    assert got["reduce_calls"] == 2 * L + 2 and got["reduce_bytes"] > 0
    # every slot live at the table's full width
    width = arena.blocks_per_slot * arena.block_size
    assert base["kernel_flops"]["paged_decode_attention"] == \
        4 * _CFG.head_dim * _CFG.num_heads * cap * width * L
    # a runtime that has served nothing prices the same step on an arena
    # of the same shapes on ``meta``, and builds no arena of its own
    fresh = ServiceRuntime(_CFG, params, ParallelPlan(
        service="t", category=LAT, bs=4), device="cpu",
        paged_step_builder=steps.paged_decode_builder(_mesh(2)), **KW)
    assert fresh.decode_cost_analysis() == got
    assert fresh.groups[0].arena is None


def test_init_sharded_serves_without_the_whole_tree():
    """``init_sharded`` draws the shards a layer at a time: the values of
    splitting ``transformer.init``'s tree, and a runtime given only them
    (``params=None``) serves the whole tree's chains, with chunked
    prefill and with one-shot prefill (``prefill_tp``: each shard's K/V
    heads written into its pools)."""
    cfg = dataclasses.replace(_CFG, fused_projections=True, qkv_bias=True)
    whole = transformer.init(4, cfg, "cpu")
    mesh = _mesh(2)
    shards = steps.init_sharded(4, cfg, mesh)
    want = steps.shard_params(whole, cfg, meshlib.param_specs(
        mesh, whole, fsdp=False), mesh.devices)
    for a, b in zip(shards, want):
        fa = dict(meshlib.tree_flatten_with_path(a))
        fb = dict(meshlib.tree_flatten_with_path(b))
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    _, base, _ = _serve(cfg, whole, _requests(3))
    rt = ServiceRuntime(cfg, None, ParallelPlan(
        service="t", category=LAT, bs=4), device="cpu",
        paged_step_builder=steps.paged_decode_builder(mesh, shards=shards),
        **KW)
    for r in _requests(3):
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"]))
    assert {r.rid: list(r.tokens) for r in rt.drain()} == base
    _, base1, _ = _serve(cfg, whole, _requests(3), chunked_prefill=False)
    rt = ServiceRuntime(cfg, None, ParallelPlan(
        service="t", category=LAT, bs=4), device="cpu",
        chunked_prefill=False,
        paged_step_builder=steps.paged_decode_builder(mesh, shards=shards),
        **KW)
    for r in _requests(3):
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"]))
    assert {r.rid: list(r.tokens) for r in rt.drain()} == base1
    assert rt.oneshot_prefills == len(base1)


def test_launcher_sizes_a_card_by_its_share_of_the_shards():
    """Over a service mesh of 4 model shards the launcher's footprint is
    the first card's share: a quarter of mistral-large-123b's 245 GB of
    weights (its vocabulary and heads split 4 ways), no whole tree; and
    ``--no-chunked-prefill`` (one-shot prefill split by heads) passes the
    refusal check, and so does ``--mode sync``, which runs whole on the
    first card: its whole weights and its dense cache count there."""
    mesh = meshlib.make_mesh((1, 4), ("data", "model"))
    args = serve._parser().parse_args(["--archs", "minicpm-2b",
                                       "--pjit-decode"])
    cp = serve.control_plane(["minicpm-2b"], 1)
    whole, arenas = serve.footprint(args, cp)
    share, arenas4 = serve.footprint(args, cp, mesh)
    # minicpm-2b's 122,753-token vocabulary does not split: its embedding
    # stays whole on every shard
    emb = 122753 * 2304 * 2
    assert share == pytest.approx((whole - emb) / 4 + emb, rel=1e-3)
    assert arenas4 == pytest.approx(arenas / 4, rel=1e-3)
    from repro_torch.configs import get_config
    big = get_config("mistral-large-123b")
    assert serve._shard_weight_bytes(big, mesh) == pytest.approx(
        big.param_count() * 2 / 4, rel=1e-3)
    cfgs = {"minicpm-2b": get_config("minicpm-2b")}
    oneshot = serve._parser().parse_args(["--pjit-decode",
                                          "--no-chunked-prefill"])
    serve._refuse_what_tp_cannot_serve(oneshot, cfgs, cp, mesh, None)
    # sync runs whole on the first card: its whole weights and its dense
    # cache at the plan's 512 slots and --max-seq-len count there
    sync = serve._parser().parse_args(["--pjit-decode", "--mode", "sync"])
    serve._refuse_what_tp_cannot_serve(sync, cfgs, cp, mesh, None)
    weights, cache = serve.footprint(sync, cp, mesh)
    assert weights == get_config("minicpm-2b").param_count() * 2
    assert cache == serve.footprint(sync, cp)[1] == 512 * 256 * (
        40 * 2 * 36 * 64 * 2)
