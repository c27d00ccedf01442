"""Head-sharded paged serving of the MoE, SSM and audio families
(``launch/steps.py`` ``paged_decode_builder``) on the CPU, on meshes that
list the CPU ``tp`` times.

Each family runs its reference's reduced config in float32
(``reduced(mixtral-8x7b)``: 4 query and 4 kv heads, 4 experts;
``reduced(mamba2-2.7b)``: 16 SSD heads of 16 channels, one group;
``reduced(whisper-large-v3)``: 4 heads, a 64-frame encoder), so that heads
and vocabulary split over 2 and 4 shards:

* at tp = 1 the sharded runtime equals the unsharded one bit for bit
  (every step's logits, the chains, the pools and per-slot state);
* at tp = 2 and 4 its greedy chains equal the unsharded port's and the
  reference's own ``ServiceRuntime(paged_step_builder=
  paged_decode_builder(mesh))`` over a (1, 4) mesh of four XLA host
  devices (one reference run a family, in a subprocess, the three started
  together), and every step's logits of the live rows lie within float32
  fuzz of both;
* the gated RMSNorm's split, the MoE drops counted once, the arena's
  state split and reset on every shard, evacuation, ``init_sharded`` and
  ``decode_cost_analysis``.
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
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import serve, steps
from repro_torch.models import layers, moe, ssm
from repro_torch.models.registry import model_api
from repro_torch.serving.arena import KVArena, take_shard
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAT = TaskCategory(Sensitivity.LATENCY, False)
ARCHS = {"moe": "mixtral-8x7b", "ssm": "mamba2-2.7b",
         "audio": "whisper-large-v3"}
# under reduced(mixtral-8x7b)'s 64-token window: no ring
KW = dict(max_seq_len=48, block_size=8)
TOL = 2e-5


def _cfg(family):
    return dataclasses.replace(reduced(get_config(ARCHS[family])),
                               dtype="float32", param_dtype="float32")


def _requests(family, seed=0, n=6):
    cfg = _cfg(family)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        extras = None
        if family == "audio":
            extras = {"embeddings": rng.standard_normal(
                (cfg.encoder_len, cfg.d_model)).astype(np.float32).tolist()}
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
cfg = dataclasses.replace(configs.reduced(configs.get_config(spec["arch"])),
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
    """The three reference runs, started together: each family's chains,
    every step's logits and live mask, and its weights bridged to the
    port."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for family, arch in ARCHS.items():
        spec = tmp / f"{family}.json"
        spec.write_text(json.dumps(dict(arch=arch, bs=4, kw=KW,
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


def _runtime(cfg, params, tp=None, *, bs=4, shards=None):
    builder = (None if tp is None
               else steps.paged_decode_builder(_mesh(tp), shards=shards))
    return ServiceRuntime(cfg, params, ParallelPlan(
        service="t", category=LAT, bs=bs), device="cpu",
        paged_step_builder=builder, **KW)


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


def _whole(rt):
    """The arena's pools and per-slot state with the shards' parts put
    back together by the split rules."""
    arena = rt.groups[0].arena
    n = len(arena.shard_pages)
    pools = [torch.cat([s[i] for s in arena.shard_pages], dim=3)
             for i in range(len(arena.pages))]
    state = []
    for i, split in enumerate(arena._state_splits):
        parts = [st[i] for st in arena.shard_state]
        if split is None:
            state.append(parts[0])
            continue
        dim, sections = split
        pieces, at = [], 0
        for size, cut in sections:
            part = size // n if cut else size
            if cut:
                pieces.append(torch.cat([p.narrow(dim, at, part)
                                         for p in parts], dim=dim))
            else:
                pieces.append(parts[0].narrow(dim, at, part))
            at += part
        state.append(torch.cat(pieces, dim=dim))
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
    assert len(arena.shard_pages) == len(arena.shard_state) == tp
    if family == "ssm":
        assert arena.shard_state[1][arena.state_keys.index("ssd")].shape[2] \
            == cfg.ssm_nheads // tp
    else:
        assert arena.shard_pages[1][0].shape[3] == cfg.num_kv_heads // tp
    assert rt.sharded_step.mesh.reduce_calls > 0


def test_gated_norm_reduces_its_sum_of_squares_over_the_shards():
    """Mamba-2's gated RMSNorm spans the whole ``d_inner``: four shards
    that reduce their sums of squares give the whole norm's output, and
    four that normalize their own heads would not."""
    cfg, tp = _cfg("ssm"), 4
    gen = torch.Generator().manual_seed(3)
    H, P, d = cfg.ssm_nheads, cfg.ssm_headdim, cfg.d_model
    y, z = (torch.randn((5, H * P), generator=gen) for _ in range(2))
    # heads of very different scales, so a per-shard norm shows
    y = y * torch.linspace(0.1, 4.0, H).repeat_interleave(P)
    lp = {"gate_ln": {"w": 1 + 0.1 * torch.randn((H * P,), generator=gen)},
          "out_proj": torch.randn((H * P, d), generator=gen) / 8}
    whole = ssm._gated_out(lp, cfg, y, z)
    parts = [{"gate_ln": {"w": take_shard(lp["gate_ln"]["w"], 0, s, tp)},
              "out_proj": take_shard(lp["out_proj"], 0, s, tp)}
             for s in range(tp)]
    cut = lambda t: [take_shard(t, 1, s, tp) for s in range(tp)]
    mesh = _mesh(tp)
    got = ssm._gated_out_tp(parts, cfg, cut(y), cut(z), mesh)
    assert mesh.reduce_calls == 2
    for g in got:
        torch.testing.assert_close(g, whole, atol=1e-5, rtol=1e-5)
    own = sum(layers.linear(layers.rms_norm(
        ys * torch.nn.functional.silu(zs), p["gate_ln"]["w"], cfg.rms_eps),
        p["out_proj"]) for p, ys, zs in zip(parts, cut(y), cut(z)))
    assert (own - whole).abs().max() > 0.1 * whole.abs().max()


def test_moe_drops_are_counted_once_at_tp4(references):
    """A capacity factor that binds on the chunks: the tp = 4 run counts
    every step's drops once, as the unsharded run does."""
    cfg = dataclasses.replace(_cfg("moe"), moe_capacity_factor=0.5)
    params = references["moe"]["params"]
    counts = {}
    for tp in (None, 4):
        stats = moe.MOE_DROP_STATS
        stats.flush()
        d0, a0 = stats.dropped, stats.assigned
        rt = _runtime(cfg, params, tp)
        _submit(rt, _requests("moe"))
        per_step = []
        while rt.pending() or rt.in_flight():
            per_step.append(rt.step(max_wait_s=0.0).moe_dropped_tokens)
        stats.flush()
        counts[tp] = (stats.dropped - d0, stats.assigned - a0, per_step)
    assert counts[None][0] > 0
    assert counts[4] == counts[None]


def test_sharded_arena_splits_writes_and_resets_state_on_every_shard():
    """The SSM arena over two shards: the SSD state split on H, the conv
    tail's x channels by head with B and C whole on each shard; a one-shot
    write lands each shard's part, a reset zeroes every shard, the state's
    share counts in ``shard_bytes``, and parking stays refused (a slot's
    state would be overwritten by its next tenant).  A window ring's K/V
    (reduced mixtral-8x7b over a slot budget above its 64-token window)
    splits on its kv heads."""
    cfg = _cfg("ssm")
    split = lambda key: steps.state_split(cfg, key)
    arena = KVArena(cfg, ssm.init_cache, capacity=3, max_seq_len=32,
                    block_size=8, device="cpu", shard_devices=["cpu"] * 2,
                    state_split=split)
    conv, ssd = (arena.state_keys.index(k) for k in ("conv", "ssd"))
    di, gn, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    for st in arena.shard_state:
        assert st[conv].shape[3] == di // 2 + 2 * gn
        assert st[ssd].shape[2] == H // 2
    gen = torch.Generator().manual_seed(0)
    cache = {k: (torch.randn(v.shape, generator=gen) if v.ndim else v)
             for k, v in ssm.init_cache(cfg, 1, 32, device="cpu").items()}
    slot = arena.alloc(10)
    arena.write_prefill(slot, cache, prompt_len=10)
    for j, st in enumerate(arena.shard_state):
        for i, key in enumerate(arena.state_keys):
            dim, sections = split(key)
            assert torch.equal(st[i][:, slot], take_shard(
                cache[key], dim, j, 2, sections)[:, 0])
    # shard 1's B and C channels are the whole cache's, not a half
    assert torch.equal(arena.shard_state[1][conv][:, slot, :, di // 2:],
                       cache["conv"][:, 0, :, di:])
    arena.zero_state(slot)
    assert all(float(t[:, slot].abs().sum()) == 0
               for st in arena.shard_state for t in st)
    per_slot = arena.capacity * (cfg.num_layers * 3 * (di // 2 + 2 * gn)
                                 * 4 + cfg.num_layers * (H // 2)
                                 * cfg.ssm_headdim * cfg.ssm_state * 4)
    assert arena.shard_bytes(1) == per_slot
    assert arena.shard_bytes(0) == per_slot + arena.lens.numel() * 4
    assert not arena.parkable
    with pytest.raises(ValueError, match="per-slot state"):
        arena.park(slot)
    ring_cfg = _cfg("moe")
    ring = KVArena(ring_cfg, model_api(ring_cfg).init_cache, capacity=2,
                   max_seq_len=96, block_size=8, device="cpu",
                   shard_devices=["cpu"] * 2,
                   state_split=lambda k: steps.state_split(ring_cfg, k))
    assert ring.state_keys == ["k", "v"] and not ring.pages
    assert ring.shard_state[1][0].shape == (
        ring_cfg.num_layers, 2, 64, ring_cfg.num_kv_heads // 2,
        ring_cfg.head_dim)


def test_sharded_arena_parks_and_resumes_pools_on_every_shard(references):
    """A head-sharded MoE arena (pools only) parks a slot and resumes it:
    the parked blocks keep every shard's K/V, and the resumed slot's
    table points at them again."""
    cfg, params = _cfg("moe"), references["moe"]["params"]
    rt, _, _ = _serve(cfg, params, _requests("moe")[:2], tp=2)
    arena = rt.groups[0].arena
    before = [p.clone() for p in _whole(rt)]
    slot = arena.alloc(20)
    arena.set_len(slot, 20)
    blocks = arena.park(slot)
    resumed = arena.alloc(20, shared=blocks)
    arena.release_parked(blocks)
    assert list(arena._block_tables[resumed][:len(blocks)]) == blocks
    assert arena.parks == 1 and arena.parked_blocks == 0
    assert all(torch.equal(a, b) for a, b in zip(_whole(rt), before))


@pytest.mark.parametrize("family", ["audio", "ssm"])
def test_evacuated_requests_resume_from_fresh_state_on_every_shard(
        references, family):
    """Two steps into a tp = 2 wave the runtime is evacuated and every
    request resubmitted: each slot is prefilled again from state zeroed on
    every shard, and the chains equal the uninterrupted run's."""
    cfg, params = _cfg(family), references[family]["params"]
    reqs = _requests(family)[:4]
    _, base, _ = _serve(cfg, params, reqs, tp=2)
    rt = _runtime(cfg, params, 2)
    _submit(rt, reqs)
    for _ in range(2):
        rt.step(max_wait_s=0.0)
    back = rt.evacuate()
    assert sorted(r.rid for r in back) == [r["rid"] for r in reqs]
    for r in back:
        rt.submit(r)
    assert {r.rid: list(r.tokens) for r in rt.drain()} == base
    assert rt.evacuations == 1


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_init_sharded_equals_shard_params_of_the_whole_init(family):
    """``init_sharded`` draws each family a layer at a time: the values of
    splitting the family's ``init`` tree, and a runtime given only them
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
def test_decode_cost_analysis_counts_the_split_work_once(references,
                                                         family):
    """At tp = 4 the kernels run 4 times as often on a quarter of the
    heads each, with the same FLOPs; the matmuls' FLOPs are tp = 1's plus
    the work every shard repeats on whole operands (the MoE router and
    its combine einsum; Mamba-2's B and C columns of in_proj), and the
    new reductions move bytes."""
    cfg, params = _cfg(family), references[family]["params"]
    rt0, _, _ = _serve(cfg, params, _requests(family)[:2])
    rt, _, _ = _serve(cfg, params, _requests(family)[:2], tp=4)
    base, got = rt0.decode_cost_analysis(), rt.decode_cost_analysis()
    assert got["kernel_flops"] == base["kernel_flops"]
    assert got["kernel_calls"] == {k: 4 * n for k, n in
                                   base["kernel_calls"].items()}
    cap, L, d = rt.groups[0].arena.capacity, cfg.num_layers, cfg.d_model
    if family == "moe":
        # the router (d x E) and the combine einsum, one token a routing
        # group at capacity C (the dispatch einsum contracts that one row,
        # which torch computes as a product, counted as no FLOPs)
        C = max(1, int(cfg.moe_capacity_factor * cfg.experts_per_token
                       / cfg.num_experts))
        repeated = 2 * cap * d * cfg.num_experts * (1 + C)
    elif family == "ssm":
        repeated = 2 * cap * d * 2 * cfg.ssm_ngroups * cfg.ssm_state
    else:
        repeated = 0
    assert got["aten_flops"] == base["aten_flops"] + 3 * L * repeated
    assert got["reduce_calls"] > 0 and got["reduce_bytes"] > 0
    assert "reduce_calls" not in base or base["reduce_calls"] == 0


def test_launcher_sizes_a_card_by_its_share_of_the_state():
    """Over a service mesh of 4 model shards the launcher's arena
    footprint is the first card's share of whisper-large-v3's cross K/V
    and mamba2-2.7b's SSD state, and its weights the head split's."""
    mesh = meshlib.make_mesh((1, 4), ("data", "model"))
    for arch in ("whisper-large-v3", "mamba2-2.7b"):
        args = serve._parser().parse_args(["--archs", arch,
                                           "--pjit-decode"])
        cp = serve.control_plane([arch], 1)
        _, arenas = serve.footprint(args, cp)
        _, arenas4 = serve.footprint(args, cp, mesh)
        assert arenas4 == pytest.approx(arenas / 4, rel=0.02)
    cfg = get_config("mamba2-2.7b")
    # in_proj's and the conv's B and C stay whole on every shard
    bc = cfg.num_layers * 2 * cfg.ssm_state * (cfg.d_model + 4 + 1) * 2
    assert serve._shard_weight_bytes(cfg, mesh) == pytest.approx(
        (cfg.param_count() * 2 - bc) / 4 + bc, rel=1e-3)
