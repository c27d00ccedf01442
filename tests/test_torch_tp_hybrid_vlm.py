"""Head-sharded paged serving of the hybrid and VLM families
(``launch/steps.py`` ``paged_decode_builder``) on the CPU, on meshes that
list the CPU ``tp`` times.

Each family runs its reference's reduced config in float32:
``reduced(zamba2-7b, num_layers=5)`` (16 SSD heads of 16 channels, 4
query and 4 kv heads in the shared block, applied twice: ``attn_every =
2``, so each application's own pools are held apart) and
``reduced(paligemma-3b)`` (4 query heads on ONE kv head, a 16-row image
prefix, tied embeddings).  Paligemma's kv head is replicated on every
shard (the Megatron rule: the reference's rules would cut head_dim, which
the port refuses), its query heads split:

* at tp = 1 the sharded runtime equals the unsharded one bit for bit
  (every step's logits, the chains, the pools and per-slot state);
* at tp = 2 and 4 its greedy chains equal the unsharded port's and the
  reference's own ``ServiceRuntime(paged_step_builder=
  paged_decode_builder(mesh))`` over a (1, 4) ``AxisType.Auto`` mesh of
  four XLA host devices (one reference run a family, in a subprocess, the
  two started together), and every step's logits of the live rows lie
  within float32 fuzz of both;
* int8 pools (zamba2 is a frequency service), their scales split with
  their values and replicated with them; the replicated kv head's pools
  identical on every shard after the waves' writes, a park and resume
  and a copy-on-write; the image prefix reaching every shard;
  ``init_sharded``; ``decode_cost_analysis`` counting the repeated K/V
  projection and the B and C columns once a further shard; the
  launcher's share of the pools (``tests/test_torch_tp.py`` runs the
  launcher itself on both).
"""
import dataclasses
import json
import os
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
from repro_torch.kernels.quant import QuantPages
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve, steps
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import pool_sections, section_parts
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAT = TaskCategory(Sensitivity.LATENCY, False)
ARCHS = {"hybrid": ("zamba2-7b", {"num_layers": 5}),
         "vlm": ("paligemma-3b", {})}
# a slot holds the VLM's 16 prefix rows, a prompt of up to 29 tokens and
# 6 new ones
KW = dict(max_seq_len=56, block_size=8)
TOL = 2e-5


def _cfg(family):
    arch, over = ARCHS[family]
    return dataclasses.replace(reduced(get_config(arch), **over),
                               dtype="float32", param_dtype="float32")


def _requests(family, seed=0, n=6):
    cfg = _cfg(family)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        extras = None
        if family == "vlm":
            extras = {"embeddings": rng.standard_normal(
                (cfg.prefix_len, cfg.d_model)).astype(np.float32).tolist()}
        out.append(dict(rid=i, tokens=rng.integers(
            1, cfg.vocab_size, int(rng.integers(3, 30))).tolist(), n=6,
            extras=extras))
    return out


# the reference's runtime under its pjit builder on a (1, 4) mesh of XLA
# host devices; every fused decode step's logits and live mask recorded
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
cfg = dataclasses.replace(
    configs.reduced(configs.get_config(spec["arch"]), **spec["over"]),
    dtype="float32", param_dtype="float32")
params = model_api(cfg).init(jax.random.PRNGKey(0), cfg)
# the mesh of the reference's own code, with the automatic sharding its
# pjit builder was written for (this JAX's ``make_mesh`` defaults to
# explicit axes)
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
    extras = None if r["extras"] is None else {
        "embeddings": np.asarray(r["extras"]["embeddings"], np.float32)}
    rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
        r["tokens"], np.int32), max_new_tokens=r["n"], extras=extras))
toks = {str(r.rid): [int(t) for t in r.tokens] for r in rt.drain()}
flat = {"/".join(str(k.key) for k in path): np.asarray(leaf) for path, leaf
        in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(sys.argv[2], tokens=json.dumps(toks), devices=jax.device_count(),
         logits=np.stack([s[0] for s in steps]),
         live=np.stack([s[1] for s in steps]),
         **{"p/" + k: v for k, v in flat.items()})
"""


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
def references(tmp_path_factory):
    """The two reference runs, started together: each family's chains,
    every step's logits and live mask, and its weights bridged to the
    port."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for family, (arch, over) in ARCHS.items():
        spec = tmp / f"{family}.json"
        spec.write_text(json.dumps(dict(arch=arch, over=over, bs=4, kw=KW,
                                        requests=_requests(family))))
        runs[family] = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(spec),
             str(tmp / f"{family}.npz")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for family, run in runs.items():
        _, err = run.communicate(timeout=300)
        assert run.returncode == 0, err[-3000:]
        z = np.load(tmp / f"{family}.npz")
        assert int(z["devices"]) == 4
        params = bridge.params_from_jax(
            _unflatten({k[2:]: z[k] for k in z.files
                        if k.startswith("p/")}), _cfg(family), "cpu")
        out[family] = dict(tokens={int(k): v for k, v in
                                   json.loads(str(z["tokens"])).items()},
                           logits=z["logits"], live=z["live"],
                           params=params)
    return out


def _mesh(tp):
    return meshlib.make_mesh((1, tp), ("data", "model"), ["cpu"] * tp)


def _submit(rt, reqs):
    for r in reqs:
        extras = None if r["extras"] is None else {
            "embeddings": np.asarray(r["extras"]["embeddings"], np.float32)}
        rt.submit(GenerationRequest(rid=r["rid"], tokens=np.asarray(
            r["tokens"], np.int32), max_new_tokens=r["n"], extras=extras))


def _runtime(cfg, params, tp=None, *, bs=4, shards=None, kv_dtype=-1,
             **kw):
    builder = (None if tp is None
               else steps.paged_decode_builder(_mesh(tp), shards=shards))
    return ServiceRuntime(cfg, params, ParallelPlan(
        service="t", category=LAT, bs=bs, kv_dtype=kv_dtype), device="cpu",
        paged_step_builder=builder, **{**KW, **kw})


def _serve(cfg, params, reqs, tp=None, **kw):
    """Serve ``reqs`` unsharded (tp None) or over ``tp`` shards; returns
    (runtime, chains, every decode step's (logits, live))."""
    rt = _runtime(cfg, params, tp, **kw)
    log = []
    decode = rt._paged_decode

    def recorded(arena, tokens, live, **k):
        logits = decode(arena, tokens, live, **k)
        log.append((logits.clone(), live.clone()))
        return logits

    rt._paged_decode = recorded
    _submit(rt, reqs)
    return rt, {r.rid: list(r.tokens) for r in rt.drain()}, log


def _join(parts, dim, sections):
    """The whole tensor from its shards' ``parts``, split along ``dim``
    by ``sections``: each section's parts from the first shard holding
    each."""
    n, pieces, at = len(parts), [], 0
    for size, split in sections:
        m = section_parts(split, n)
        pieces.extend(parts[p * n // m].narrow(dim, at, size // m)
                      for p in range(m))
        at += size // m
    return torch.cat(pieces, dim=dim)


def _tensors(pool):
    return (pool.values, pool.scales) if isinstance(pool, QuantPages) \
        else (pool,)


def _whole(rt):
    """The arena's pools (an int8 pool's values and scales) and per-slot
    state with the shards' parts put back together by the split rules."""
    arena = rt.groups[0].arena
    heads = pool_sections(rt.cfg.num_kv_heads)
    pools = [_join(list(ts), 3, heads) for i in range(len(arena.pages))
             for ts in zip(*[_tensors(s[i]) for s in arena.shard_pages])]
    state = []
    for i, split in enumerate(arena._state_splits):
        parts = [st[i] for st in arena.shard_state]
        state.append(parts[0] if split is None
                     else _join(parts, split[0], split[1]))
    return pools + state


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_tp1_is_bit_identical_to_the_unsharded_runtime(references, family):
    cfg, params = _cfg(family), references[family]["params"]
    rt0, base, base_log = _serve(cfg, params, _requests(family))
    rt, got, log = _serve(cfg, params, _requests(family), tp=1)
    assert rt.sharded_step.tp == 1 and got == base
    assert len(log) == len(base_log) > 0
    for (a, la), (b, lb) in zip(log, base_log):
        assert torch.equal(la, lb) and torch.equal(a, b)
    for a, b in zip(_whole(rt), _whole(rt0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_tp_chains_and_logits_equal_the_unsharded_port_and_reference(
        references, family, tp):
    ref, cfg = references[family], _cfg(family)
    rt0, base, base_log = _serve(cfg, ref["params"], _requests(family))
    rt, got, log = _serve(cfg, ref["params"], _requests(family), tp=tp)
    assert got == base == ref["tokens"]
    assert len(log) == len(base_log) == len(ref["logits"])
    for (a, live), (b, _), want, ref_live in zip(
            log, base_log, ref["logits"], ref["live"]):
        assert np.array_equal(live.numpy(), ref_live)
        torch.testing.assert_close(a[live], b[live], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(a[live].numpy(), want[ref_live],
                                   atol=TOL, rtol=TOL)
    for a, b in zip(_whole(rt), _whole(rt0)):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    arena = rt.groups[0].arena
    assert len(arena.shard_pages) == tp
    if family == "hybrid":
        # each application's pools (n_apps, pages, bs, Hkv/tp, D), the SSD
        # state split on its heads
        assert arena.shard_pages[1][0].shape[0] == 2
        assert arena.shard_pages[1][0].shape[3] == cfg.num_kv_heads // tp
        assert arena.shard_state[1][arena.state_keys.index("ssd")].shape[2] \
            == cfg.ssm_nheads // tp
    else:
        # the one kv head whole on every shard, a query head share each
        assert arena.shard_pages[1][0].shape[3] == 1
        assert rt.sharded_step.plan.cfg_shard.num_heads == \
            cfg.num_heads // tp
        assert rt.sharded_step.shards[1].params["blocks"]["attn"][
            "wk"].shape[-1] == cfg.head_dim
    assert rt.sharded_step.mesh.reduce_calls > 0


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_int8_pools_split_or_replicate_their_scales_with_their_values(
        references, family):
    """int8 pools at tp = 2: the chains equal the unsharded int8 run's,
    the values and scales put back together equal its pools, and a
    replicated kv head's values and scales are the same on both
    shards."""
    cfg, params = _cfg(family), references[family]["params"]
    reqs = _requests(family)[:4]
    rt0, base, _ = _serve(cfg, params, reqs, kv_dtype="int8")
    rt, got, _ = _serve(cfg, params, reqs, tp=2, kv_dtype="int8")
    assert got == base
    arena = rt.groups[0].arena
    assert all(isinstance(p, QuantPages) for s in arena.shard_pages
               for p in s)
    for a, b in zip(_whole(rt), _whole(rt0)):
        if a.dtype == torch.int8:
            assert (a.int() - b.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    if family == "vlm":
        first, second = arena.shard_pages
        for p, q in zip(first, second):
            assert torch.equal(p.values, q.values)
            assert torch.equal(p.scales, q.scales)


def test_replicated_kv_pools_agree_after_writes_parks_and_copy_on_write(
        references):
    """Paligemma at tp = 4: its one kv head's pools are the same tensor
    values on all four shards after a wave (every shard computed and
    wrote its own copy of each K/V row, image prefix included), after a
    slot is parked and resumed, and after a copy-on-write of a shared
    block; and they equal the unsharded run's pools."""
    cfg, params = _cfg("vlm"), references["vlm"]["params"]
    reqs = _requests("vlm")[:3]
    rt0, _, _ = _serve(cfg, params, reqs)
    rt, _, _ = _serve(cfg, params, reqs, tp=4)
    arena = rt.groups[0].arena

    def agree():
        for pools in zip(*arena.shard_pages):
            assert all(torch.equal(pools[0], p) for p in pools[1:])

    agree()
    for a, b in zip(_whole(rt), _whole(rt0)):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    slot = arena.alloc(20)
    arena.set_len(slot, 20)
    blocks = arena.park(slot)
    resumed = arena.alloc(20, shared=blocks)
    arena.release_parked(blocks)
    assert list(arena._block_tables[resumed][:len(blocks)]) == blocks
    agree()
    # a second slot sharing the first block: writing it copies first
    sharer = arena.alloc(8, shared=blocks[:1])
    for pools in arena.shard_pages:
        pools[0][:, blocks[0]] = torch.arange(
            pools[0][:, blocks[0]].numel(), dtype=torch.float32).reshape(
                pools[0][:, blocks[0]].shape)
    assert arena.ensure_writable(sharer, 0, 1) == 1
    fresh = int(arena._block_tables[sharer][0])
    assert fresh != blocks[0] and arena.cow_copies == 1
    for pools in arena.shard_pages:
        assert torch.equal(pools[0][:, fresh], pools[0][:, blocks[0]])
    agree()


def test_the_image_prefix_reaches_every_shard(references):
    """A first chunk's image rows go to each of the four shards: after the
    prefill, each shard's pool rows of the slot (the prefix and the
    prompt) are the unsharded run's; a chunk that zeroes them on the
    shards past the first gives other rows there (so a missing prefix
    shows)."""
    cfg, params = _cfg("vlm"), references["vlm"]["params"]
    req = _requests("vlm")[:1]
    n_rows = cfg.prefix_len + len(req[0]["tokens"])
    api = model_api(cfg)

    def first_only(*a, embeddings=None, **k):
        if embeddings is not None:
            embeddings = embeddings[:1] + [torch.zeros_like(e)
                                           for e in embeddings[1:]]
        return api.prefill_chunk_paged_tp(*a, embeddings=embeddings, **k)

    def prefilled_rows(tp, step_api=None):
        """Each shard's K pool rows of the one slot once its prefill is
        done (its first decode step taken, the slot still live)."""
        rt = _runtime(cfg, params, tp)
        if step_api is not None:
            rt.sharded_step.api = dataclasses.replace(
                api, prefill_chunk_paged_tp=step_api)
        _submit(rt, req)
        while rt.decode_steps == 0:
            rt.step(max_wait_s=0.0)
        arena = rt.groups[0].arena
        slot = int(np.flatnonzero(arena.occupancy())[0])
        table = torch.as_tensor(arena._block_tables[slot]).long()
        return [pools[0][:, table].flatten(1, 2)[:, :n_rows]
                for pools in arena.shard_pages]

    want, = prefilled_rows(None)
    assert float(want[:, :cfg.prefix_len].abs().max()) > 0
    for got in prefilled_rows(4):
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    # the first layer's rows come from each shard's own input rows alone
    bad = prefilled_rows(4, first_only)
    torch.testing.assert_close(bad[0][0], want[0], atol=TOL, rtol=TOL)
    assert not torch.allclose(bad[3][0], want[0], atol=1e-3)


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_init_sharded_equals_shard_params_of_the_whole_init(family):
    """``init_sharded`` draws each family a layer at a time (the hybrid's
    shared block after its mamba stack): the values of splitting the
    family's ``init`` tree, and a runtime given only them
    (``params=None``) serves the whole tree's chains."""
    cfg = _cfg(family)
    whole = model_api(cfg).init(4, cfg, "cpu")
    mesh = _mesh(2)
    shards = steps.init_sharded(4, cfg, mesh)
    want = steps.shard_params(whole, cfg, meshlib.param_specs(
        mesh, whole, fsdp=False), mesh.devices)
    for a, b in zip(shards, want):
        fa = dict(meshlib.tree_flatten_with_path(a))
        fb = dict(meshlib.tree_flatten_with_path(b))
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    reqs = _requests(family)[:3]
    _, base, _ = _serve(cfg, whole, reqs)
    _, got, _ = _serve(cfg, None, reqs, tp=2, shards=shards)
    assert got == base


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_decode_cost_analysis_counts_the_repeated_work_once(references,
                                                            family):
    """At tp = 4 the kernels run 4 times as often on a quarter of the
    query heads each, with the same FLOPs; the matmuls' FLOPs are tp =
    1's plus the work each further shard repeats on whole operands:
    Mamba-2's B and C columns of in_proj in every mamba layer (the
    hybrid), the replicated kv head's K and V projections in every layer
    (paligemma)."""
    cfg, params = _cfg(family), references[family]["params"]
    rt0, _, _ = _serve(cfg, params, _requests(family)[:2])
    rt, _, _ = _serve(cfg, params, _requests(family)[:2], tp=4)
    base, got = rt0.decode_cost_analysis(), rt.decode_cost_analysis()
    assert got["kernel_flops"] == base["kernel_flops"]
    assert got["kernel_calls"] == {k: 4 * n for k, n in
                                   base["kernel_calls"].items()}
    cap, L, d = rt.groups[0].arena.capacity, cfg.num_layers, cfg.d_model
    if family == "hybrid":
        repeated = 2 * cap * d * 2 * cfg.ssm_ngroups * cfg.ssm_state
    else:
        repeated = 2 * (2 * cap * d * cfg.num_kv_heads * cfg.head_dim)
    assert got["aten_flops"] == base["aten_flops"] + 3 * L * repeated
    assert got["reduce_calls"] > 0 and got["reduce_bytes"] > 0


def test_launcher_sizes_a_card_by_its_share_of_the_pools():
    """Over a service mesh of 4 model shards the launcher's arena share
    is a quarter of zamba2-7b's pools and SSD state, and the whole of
    paligemma-3b's pools (its one kv head replicated on each card); the
    weights are the head split's, paligemma's K and V projections whole
    on every shard."""
    mesh = meshlib.make_mesh((1, 4), ("data", "model"))
    ratio = {"zamba2-7b": 1 / 4, "paligemma-3b": 1.0}
    for arch in ratio:
        args = serve._parser().parse_args(["--archs", arch, "--pjit-decode",
                                           "--max-seq-len", "512"])
        cp = serve.control_plane([arch], 1)
        _, arenas = serve.footprint(args, cp)
        _, arenas4 = serve.footprint(args, cp, mesh)
        assert arenas4 == pytest.approx(arenas * ratio[arch], rel=0.02)
    cfg = get_config("paligemma-3b")
    kv = cfg.num_layers * 2 * cfg.d_model * cfg.head_dim * 2
    assert serve._shard_weight_bytes(cfg, mesh) == pytest.approx(
        (cfg.param_count() * 2 - kv) / 4 + kv, rel=1e-3)
