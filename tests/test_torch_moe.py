"""Mixture-of-Experts parity between the PyTorch port and the JAX reference.

The models are ``reduced(mixtral-8x7b)`` (sliding window 64) and
``reduced(grok-1-314b)``: 2 layers, d_model 128, 4 experts, top-2, in
float32.  Weights are built by the reference (``moe.init``) and carried
over with ``repro_torch.bridge.params_from_jax``; inputs are made with
numpy from a seed.  On the CPU the port runs its plain versions.

Tolerances: the grouped GEMM against the Pallas kernel in interpret mode
as the reference's own kernel test states them (f32 rtol 1e-4, atol 1e-3;
bf16 3e-2); the dispatch's combine and aux loss to 1e-6 (the same f32
operations), its drop count exactly; MoE outputs, per-step logits and page
pools to atol = rtol = 1e-4 (the frameworks sum in other orders); greedy
token chains and per-step drop counts exactly.  Routing is an argmax, so
f32 noise between the frameworks (~1e-7) could flip a near-tie; on these
seeds none does, and exact ties are pinned by a constructed case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.kernels import ref as jref
from repro.kernels.moe_gemm import grouped_matmul_pallas
from repro.models import moe as jmoe
from repro.serving.arena import KVArena as JArena
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.serving.arena import KVArena
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

TOL = 1e-4
ARCHS = ("mixtral-8x7b", "grok-1-314b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _cfg(arch="mixtral-8x7b", **over):
    return dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config(arch)), dtype="float32",
        param_dtype="float32", **over)


def _params(cfg, seed=5):
    params = jmoe.init(jax.random.PRNGKey(seed), cfg)
    return params, bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                          _mirror(cfg), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,K,N", [(4, 50, 70, 33), (2, 128, 64, 128),
                                     (8, 10, 200, 16)])
def test_grouped_matmul_matches_pallas(dtype, E, C, K, N):
    """The plain version (what ``ops.grouped_matmul`` runs on a CPU
    tensor) against the Pallas kernel in interpret mode, on the same
    values, at the reference kernel test's shapes and tiles."""
    rng = np.random.default_rng(0)
    jl = jnp.asarray(rng.standard_normal((E, C, K), np.float32), dtype)
    jr = jnp.asarray(rng.standard_normal((E, K, N), np.float32), dtype)
    want = grouped_matmul_pallas(jl, jr, block_c=16, block_n=16,
                                 block_k=32, interpret=True)
    tdt = getattr(torch, dtype)
    tl = _t(np.asarray(jl, np.float32)).to(tdt)
    tr = _t(np.asarray(jr, np.float32)).to(tdt)
    before = dict(gmm.launches)
    got = ops.grouped_matmul(tl, tr)
    assert got.dtype == tdt and tuple(got.shape) == (E, C, N)
    assert gmm.launches == before            # a CPU tensor runs no kernel
    torch.testing.assert_close(got, ref.grouped_matmul_ref(tl, tr),
                               atol=0, rtol=0)
    tol = dict(rtol=1e-4, atol=1e-3) if dtype == "float32" \
        else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.grouped_matmul_ref(jl, jr), np.float32), **tol)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _tie_probs():
    """Rows with exact ties at the top, in the second place and across the
    top-2 boundary: both frameworks pick the lowest expert index."""
    rows = [[0.25, 0.25, 0.25, 0.25], [0.4, 0.4, 0.1, 0.1],
            [0.1, 0.3, 0.3, 0.3], [0.2, 0.3, 0.2, 0.3],
            [0.5, 0.1, 0.2, 0.2], [0.1, 0.1, 0.4, 0.4]]
    p = np.asarray(rows * 3, np.float32)                  # 18 tokens
    return p.reshape(2, 9, 4)


@pytest.mark.parametrize("case", ["tight", "loose", "ties"])
def test_top_k_dispatch_matches_reference(case):
    """combine, aux loss and drop count: with a binding capacity (drops
    happen), a capacity nothing exceeds, and exact ties at capacity 2."""
    rng = np.random.default_rng(7)
    if case == "ties":
        probs, capacity = _tie_probs(), 2
    else:
        logits = rng.standard_normal((3, 16, 4)).astype(np.float32) * 2
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        capacity = 3 if case == "tight" else 16
    jc, jaux, jdrop = jmoe._top_k_dispatch(jnp.asarray(probs), 2, capacity)
    tc, taux, tdrop = moe._top_k_dispatch(_t(probs), 2, capacity)
    _close(tc, jc, 1e-6)
    _close(taux, jaux, 1e-6)
    assert float(tdrop) == float(jdrop)
    if case == "loose":
        assert float(tdrop) == 0
    else:
        assert float(tdrop) > 0


def test_moe_mlp_matches_reference():
    cfg = _cfg()
    jp, tp = _params(cfg)
    jl = jax.tree.map(lambda a: a[1], jp["blocks"]["moe"])
    tl = {k: v[1] for k, v in tp["blocks"]["moe"].items()}
    x = np.random.default_rng(2).normal(size=(2, 21, cfg.d_model)).astype(
        np.float32)
    want, jaux = jmoe.moe_mlp(jl, cfg, jnp.asarray(x), impl="ref")
    got, taux = moe.moe_mlp(tl, _mirror(cfg), _t(x))
    _close(got, want)
    _close(taux, jaux)


def test_moe_mlp_splits_long_sequences_into_routing_groups():
    """A sequence longer than MAX_ROUTING_GROUP at a tiny width: two
    routing groups, the second zero-padded, capacity from the group."""
    assert moe.MAX_ROUTING_GROUP == jmoe.MAX_ROUTING_GROUP == 2048
    cfg = _cfg(d_model=16, d_ff=32, num_heads=2, num_kv_heads=2,
               head_dim=8)
    jp, tp = _params(cfg, seed=3)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tl = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    x = np.random.default_rng(4).normal(
        size=(1, moe.MAX_ROUTING_GROUP + 100, cfg.d_model)).astype(
        np.float32)
    want, jaux = jmoe.moe_mlp(jl, cfg, jnp.asarray(x), impl="ref")
    got, taux = moe.moe_mlp(tl, _mirror(cfg), _t(x))
    assert tuple(got.shape) == x.shape
    _close(got, want)
    _close(taux, jaux)


def test_drop_counter_reads_the_device_once_per_flush():
    stats = moe._MoeDropStats()
    for n in (3.0, 0.0, 4.0):
        stats.note(torch.tensor(n), 10)
    assert stats.dropped == 0.0 and stats.assigned == 30.0
    stats.flush()
    assert stats.dropped == 7.0 and stats.drop_rate == 7.0 / 30.0
    stats.flush()
    assert stats.dropped == 7.0


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------

def test_init_keeps_reference_tree():
    cfg = _cfg()
    jp = jax.tree.map(np.asarray, jmoe.init(jax.random.PRNGKey(0), cfg))
    tp = moe.init(0, _mirror(cfg), device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))
                           for k, v in
                           jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(tp) == shapes(jp)
    w = tp["blocks"]["moe"]["w_gate"]
    assert tuple(w.shape) == (cfg.num_layers, cfg.num_experts, cfg.d_model,
                              cfg.d_ff)
    assert not torch.equal(w[0], w[1])           # every layer drawn


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunks_then_decode_match_reference(arch, impl):
    """Two ragged chunks, then three fused decode steps, against the
    reference's paged-native steps.  Slot 2 never gets a prompt (chunk
    length 0) and is dead in every decode step: only the live rows'
    logits are compared, and the trash page is left out of the pools."""
    cfg = _cfg(arch)
    tcfg = _mirror(cfg)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(1)
    B, bs, nblk = 3, 8, 8                  # 64 tokens a slot: the window
    P1 = B * nblk + 1
    tables = rng.permutation(B * nblk).reshape(B, nblk).astype(np.int32)
    pool = (cfg.num_layers, P1, bs, cfg.num_kv_heads, cfg.head_dim)
    jcache = {"k": jnp.zeros(pool), "v": jnp.zeros(pool),
              "len": jnp.zeros((B,), jnp.int32)}
    tcache = {"k": torch.zeros(pool), "v": torch.zeros(pool),
              "len": torch.zeros((B,), dtype=torch.int32)}
    jbt, tbt = jnp.asarray(tables), _t(tables)

    def same(jl, tl):
        _close(tl[:2], np.asarray(jl)[:2])
        for n in ("k", "v"):
            _close(tcache[n][:, :-1], np.asarray(jcache[n])[:, :-1])
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))

    for T, cl in ((16, [16, 9, 0]), (8, [8, 5, 0])):
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jl, jcache = jmoe.prefill_chunk_paged(
            jp, cfg, {"tokens": jnp.asarray(toks)}, jcache, jbt,
            chunk_len=jnp.asarray(cl, jnp.int32), block_size=bs, impl=impl)
        tl, tcache = moe.prefill_chunk_paged(
            tp, tcfg, {"tokens": _t(toks)}, tcache, tbt,
            chunk_len=torch.tensor(cl, dtype=torch.int32), block_size=bs)
        same(jl, tl)
    live = np.array([True, True, False])
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jcache = jmoe.decode_step_paged(
            jp, cfg, jnp.asarray(tok), jcache, jbt, jnp.asarray(live),
            block_size=bs, impl=impl)
        tl, tcache = moe.decode_step_paged(
            tp, tcfg, _t(tok), tcache, tbt, _t(live), block_size=bs)
        same(jl, tl)
    assert tcache["len"].tolist() == [16 + 8 + 3, 9 + 5 + 3, 0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_arena_pages_kv_at_a_budget_equal_to_the_window():
    """reduced(mixtral-8x7b) has a 64-token window.  At a 64-token slot
    budget the K/V leaves are sequence leaves: the port's arena pages them.
    The reference's arena probes the budget and one block past it, where a
    window-capped leaf does not grow, and keeps them as per-slot state
    (ROADMAP.md Queue 3)."""
    cfg = _cfg()
    kw = dict(capacity=2, max_seq_len=64, block_size=8)
    ta = KVArena(_mirror(cfg), moe.init_cache, device="cpu", **kw)
    assert len(ta.pages) == 2 and ta.state == []
    assert tuple(ta.pages[0].shape) == (cfg.num_layers, 2 * 8 + 1, 8,
                                        cfg.num_kv_heads, cfg.head_dim)
    ja = JArena(cfg, jmoe.init_cache, **kw)
    assert len(ja.pages) == 0 and len(ja.state) == 2

WAVE = [(3, 6), (9, 5), (17, 8), (30, 4), (8, 7), (25, 6), (12, 5)]


def _runtimes(capacity_factor, arch="mixtral-8x7b"):
    cfg = _cfg(arch, moe_capacity_factor=capacity_factor)
    jp, tp = _params(cfg)
    args = dict(bs=4, dp=1, kv_dtype="bf16")
    jplan = JPlan(service=arch, category=JCat(JSens.LATENCY, True), **args)
    tplan = ParallelPlan(service=arch,
                         category=TaskCategory(Sensitivity.LATENCY, True),
                         **args)
    kw = dict(max_seq_len=56, block_size=8)
    return (cfg, JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0, **kw),
            ServiceRuntime(_mirror(cfg), tp, tplan, device="cpu",
                           prefix_cache=0, **kw))


def _lockstep_wave(cfg, jrt, trt):
    """Submits WAVE to both runtimes and steps them in lockstep until they
    drain; asserts equal per-step drops and equal greedy tokens.  Returns
    the per-step drops."""
    rng = np.random.default_rng(3)
    for rid, (n, new) in enumerate(WAVE):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        jrt.submit(JRequest(rid=rid, tokens=prompt, max_new_tokens=new,
                            stream=rid))
        trt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                     max_new_tokens=new, stream=rid))
    want, got, drops = {}, {}, []
    for _ in range(200):
        if not (jrt.pending() or jrt.in_flight()):
            break
        js = jrt.step(max_wait_s=0.0)
        ts = trt.step(max_wait_s=0.0)
        assert ts.moe_dropped_tokens == js.moe_dropped_tokens
        drops.append(ts.moe_dropped_tokens)
        want.update({r.rid: r for r in js.results})
        got.update({r.rid: r for r in ts.results})
    assert not (trt.pending() or trt.in_flight())
    assert sorted(got) == sorted(want) == list(range(len(WAVE)))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
    return drops


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_request_wave_matches_reference(capacity_factor):
    """7 requests over 4 slots at a 56-token budget, one block below the
    reduced window (at a budget equal to it the reference's arena takes
    the K/V for per-slot state and its chunk step fails: see
    ``test_arena_pages_kv_at_a_budget_equal_to_the_window``): slots are
    evicted and reused, chunk buckets (8, 16).  The runtimes step
    in lockstep: every step's expert-capacity drops are equal (nonzero at
    capacity factor 1.25, none at 8.0), and so are the greedy tokens and
    the host counters."""
    cfg, jrt, trt = _runtimes(capacity_factor)
    drops = _lockstep_wave(cfg, jrt, trt)
    assert trt.paged_native
    assert trt.chunk_buckets == jrt.chunk_buckets == (8, 16)
    for name in ("decode_steps", "prefill_chunk_calls",
                 "prefill_tokens_computed", "chunk_write_bytes"):
        assert getattr(trt, name) == getattr(jrt, name), name
    assert (sum(drops) > 0) == (capacity_factor == 1.25)


def test_drops_of_calls_outside_a_step_stay_out_of_its_count():
    """``moe_mlp`` called outside any step, with the counter on (a MoE
    runtime turns it on), leaves its drops pending on the device.  They
    go to the process totals, as the reference's do, but no step reports
    them: every step's drops still equal the reference runtime's."""
    cfg, jrt, trt = _runtimes(1.25)
    stats = moe.MOE_DROP_STATS
    stats.flush()
    total0 = stats.dropped
    # zero rows tie on every expert: all go to experts 0 and 1, far past
    # the capacity of 40 (1.25 * 2 * 64 / 4)
    lp = {k: v[0] for k, v in _params(cfg)[1]["blocks"]["moe"].items()}
    moe.moe_mlp(lp, _mirror(cfg), torch.zeros(1, 64, cfg.d_model))
    assert stats.dropped == total0            # pending, not read yet
    drops = _lockstep_wave(cfg, jrt, trt)
    assert sum(drops) > 0
    assert stats.dropped == total0 + 48 + sum(drops)


def test_grok_request_wave_matches_reference():
    """reduced(grok-1-314b) (no window) through the same lockstep wave."""
    cfg, jrt, trt = _runtimes(1.25, arch="grok-1-314b")
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
            for n, new in WAVE[:4]]
    for rid, (prompt, new) in enumerate(reqs):
        jrt.submit(JRequest(rid=rid, tokens=prompt, max_new_tokens=new))
        trt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                     max_new_tokens=new))
    want = {r.rid: r for r in jrt.drain()}
    got = {r.rid: r for r in trt.drain()}
    assert sorted(got) == sorted(want) == list(range(4))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
