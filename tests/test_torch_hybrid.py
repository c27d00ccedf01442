"""The hybrid family (zamba2-7b: a Mamba-2 backbone with one shared
attention+MLP block over concat(h, h0)) of the PyTorch port against the
JAX reference.

The config is reduced zamba2-7b with a tail, ``reduced(cfg, num_layers=5,
attn_every=2)`` (two applications of the shared block, then one tail
mamba layer), in float32, served at 8-token pages.  Weights are built by
the reference once and carried over with
``repro_torch.bridge.params_from_jax``; tokens are made with numpy from a
seed.  The reference runs ``impl="ref"``; the plain attention versions at
zamba2-7b's head dim (D = 112) are held to the reference's Pallas kernels
in interpret mode.  On the CPU the port runs its plain versions.

Tolerances: logits, states and float pages to atol = rtol = 1e-4 (the
frameworks sum in other orders; 2e-3 on int8 pages, whose values may
differ by one rounding step); the plain attention against the Pallas
kernels to 2e-5 (the reference's own kernel tests); greedy token chains,
lengths and host counters exactly.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.kernels import ops as jops
from repro.kernels.decode_attention import (
    chunk_prefill_attention_pallas, decode_attention_pallas,
    paged_chunk_prefill_attention_pallas, paged_decode_attention_pallas)
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.quant import QuantPages as JQuantPages
from repro.models import hybrid as jhybrid
from repro.models.config import reduced as jreduced
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quant import QuantPages, quantize
from repro_torch.launch import serve
from repro_torch.models import hybrid
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import family_api
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1e-4
# the reference's steps, jitted once: called eagerly, each call traces and
# compiles its layer scans anew
J = {name: jax.jit(getattr(jhybrid, name), static_argnums=1,
                   static_argnames=statics)
     for name, statics in (("prefill_chunk", ("impl",)),
                           ("decode_step", ("impl",)),
                           ("prefill_chunk_paged", ("block_size", "impl")),
                           ("decode_step_paged", ("block_size", "impl")))}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfg(**over):
    return jreduced(jget_config("zamba2-7b"), num_layers=5, attn_every=2,
                    dtype="float32", param_dtype="float32", **over)


_PARAMS = {}


def _setup():
    """(reference cfg, port cfg, reference params, port params), once."""
    if not _PARAMS:
        cfg = _cfg()
        # jitted: the eager init dispatches each leaf's draws one by one
        jp = jax.jit(jhybrid.init, static_argnums=1)(jax.random.PRNGKey(3),
                                                      cfg)
        tcfg = ModelConfig(**dataclasses.asdict(cfg))
        _PARAMS["h"] = (cfg, tcfg, jp, bridge.params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _PARAMS["h"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_config_has_two_applications_and_a_tail():
    cfg, tcfg, _, _ = _setup()
    assert (hybrid._n_apps(tcfg), hybrid._tail_layers(tcfg)) == (
        jhybrid._n_apps(cfg), jhybrid._tail_layers(cfg)) == (2, 1)
    groups, tail = hybrid._split_groups(tcfg)
    assert [(list(idx), g) for idx, g in groups] == [([0, 1], 0),
                                                     ([2, 3], 1)]
    assert list(tail) == [4]


def test_init_keeps_reference_tree():
    """The tree ``embed`` / ``mamba`` (stacked) / ``shared`` / ``ln_f``:
    the bridge carries every leaf across under its reference key path, and
    the port's own init draws the same shapes (the shared block's q/k/v
    read 2 * d_model)."""
    cfg, tcfg, jp, tp = _setup()
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))
                           for k, v in
                           jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = shapes(jax.tree.map(np.asarray, jp))
    assert shapes(tp) == want
    assert shapes(hybrid.init(0, tcfg, device="cpu")) == want
    assert tp["shared"]["attn"]["wq"].shape[0] == 2 * cfg.d_model
    assert tp["mamba"]["in_proj"].shape[0] == cfg.num_layers


@pytest.mark.parametrize("window", [None, 8], ids=["full", "ring"])
def test_prefill_matches_reference(window):
    """One-shot prefill of 11 tokens into a cache budgeted at 20: logits,
    every layer's conv tail and SSD state, each application's K/V (with a
    sliding window of 8, the ring of its last 8 rows, rolled as the
    reference rolls it) and the length."""
    cfg, tcfg, jp, tp = _setup()
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = jhybrid.prefill(jp, cfg, {"tokens": jnp.asarray(toks)},
                             cache_size=20, impl="ref")
    tl, tc = hybrid.prefill(tp, tcfg, {"tokens": _t(toks)}, cache_size=20)
    _close(tl, jl)
    assert sorted(tc) == sorted(jc)
    S = 20 if window is None else window
    assert tc["attn_k"].shape == (2, 2, S, cfg.num_kv_heads, cfg.head_dim)
    for n in ("conv", "ssd", "attn_k", "attn_v"):
        assert tc[n].shape == jc[n].shape, n
        assert str(tc[n].dtype) == f"torch.{jc[n].dtype}", n
        _close(tc[n], jc[n])
    assert int(tc["len"]) == int(jc["len"]) == 11


def _chunk_plan():
    """Three ragged 8-token chunks for 3 slots: slot 2 is empty in the
    first and idle in the last."""
    return ((8, (8, 5, 0)), (8, (6, 8, 3)), (8, (4, 2, 0)))


def _zero_state(cfg, B):
    c = jhybrid.init_cache(cfg, B, 8)
    return {n: np.zeros(c[n].shape, np.float32) for n in ("conv", "ssd")}


def test_dense_chunks_then_decode_match_reference():
    """``prefill_chunk`` over a dense cache (three ragged chunks), then
    three ``decode_step``s: logits of the live rows, lengths, and every
    state and cache leaf held."""
    cfg, tcfg, jp, tp = _setup()
    rng = np.random.default_rng(4)
    B, S = 3, 40
    jc = jhybrid.init_cache(cfg, B, S)
    jc["len"] = jnp.zeros((B,), jnp.int32)
    tc = hybrid.init_cache(tcfg, B, S, device="cpu")
    tc["len"] = torch.zeros((B,), dtype=torch.int32)
    for T, cl in _chunk_plan():
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        cl = np.asarray(cl, np.int32)
        jl, jc = J["prefill_chunk"](jp, cfg, {"tokens": jnp.asarray(toks)},
                                    jc, chunk_len=jnp.asarray(cl),
                                    impl="ref")
        tl, tc = hybrid.prefill_chunk(tp, tcfg, {"tokens": _t(toks)}, tc,
                                      chunk_len=_t(cl))
        live = cl > 0
        _close(tl[live], np.asarray(jl)[live])
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].tolist() == [18, 15, 3]
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jc = J["decode_step"](jp, cfg, jnp.asarray(tok), jc, impl="ref")
        tl, tc = hybrid.decode_step(tp, tcfg, _t(tok), tc)
        _close(tl, jl)
    for n in ("conv", "ssd", "attn_k", "attn_v"):
        _close(tc[n], jc[n])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _pools(cfg, quant, *, B, nblk, bs):
    """Zero pools (n_apps, P, bs, Hkv, D), int8 with unit scales, for both
    frameworks, and shuffled block tables."""
    P = B * nblk + 1
    shape = (jhybrid._n_apps(cfg), P, bs, cfg.num_kv_heads, cfg.head_dim)
    bt = np.random.default_rng(6).permutation(P - 1).reshape(
        B, nblk).astype(np.int32)
    if quant:
        vals, scl = np.zeros(shape, np.int8), np.ones(shape[:-1], np.float32)
        return ({n: JQuantPages(jnp.asarray(vals), jnp.asarray(scl))
                 for n in ("attn_k", "attn_v")},
                {n: QuantPages(_t(vals), _t(scl))
                 for n in ("attn_k", "attn_v")}, bt)
    zeros = np.zeros(shape, np.float32)
    return ({n: jnp.asarray(zeros) for n in ("attn_k", "attn_v")},
            {n: _t(zeros) for n in ("attn_k", "attn_v")}, bt)


def _parts(pool):
    """A pool's tensors as numpy: values and scales of int8 pages."""
    parts = ([pool.values, pool.scales]
             if isinstance(pool, (QuantPages, JQuantPages)) else [pool])
    return [np.asarray(a) for a in parts]


def _through_tables(pool, bt):
    """(n_apps, B, nblk * bs, ...) of each slot's rows, read through its
    block table (values and scales for int8 pages)."""
    out = []
    for a in _parts(pool):
        g = a[:, bt]                                # (A, B, nblk, bs, ...)
        out.append(g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:]))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_chunks_then_decode_match_reference(quant):
    """``prefill_chunk_paged`` through block tables of 8-token pages (three
    ragged chunks), then three ``decode_step_paged``s with slot 1 not
    live: logits of the live rows, lengths, the live slots' state and
    every slot's rows read through its table held.  The dead slot's conv
    tail, SSD state and page rows are untouched by the decode steps (the
    reference advances its state and the engine drops it; the port never
    writes it), and nothing but its rows and the trash page changes."""
    cfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(7)
    B, nblk, bs = 3, 4, 8
    jp, tp, bt = _pools(cfg, quant, B=B, nblk=nblk, bs=bs)
    st = _zero_state(cfg, B)
    js = {n: jnp.asarray(a) for n, a in st.items()}
    ts = {n: _t(a) for n, a in st.items()}
    tol = 2e-3 if quant else TOL
    start = np.zeros(B, np.int32)
    for T, cl in _chunk_plan():
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        cl = np.asarray(cl, np.int32)
        jl, jc = J["prefill_chunk_paged"](
            jparams, cfg, {"tokens": jnp.asarray(toks)},
            {**jp, **js, "len": jnp.asarray(start)}, jnp.asarray(bt),
            chunk_len=jnp.asarray(cl), block_size=bs, impl="ref")
        tl, tc = hybrid.prefill_chunk_paged(
            tparams, tcfg, {"tokens": _t(toks)},
            {**tp, **ts, "len": _t(start)}, _t(bt), chunk_len=_t(cl),
            block_size=bs)
        live = cl > 0
        _close(tl[live], np.asarray(jl)[live], tol)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        assert all(tc[n] is ts[n] for n in ts)         # state in place
        jp = {n: jc[n] for n in jp}
        js = {n: jc[n] for n in js}
        start = np.asarray(jc["len"])
    assert start.tolist() == [18, 15, 3]
    for n in ts:
        _close(ts[n], js[n], tol)
    live = np.array([True, False, True])
    dead_state = {n: ts[n][:, 1].clone() for n in ts}
    dead_rows = [p.copy() for n in tp for p in _parts(tp[n])]
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jc = J["decode_step_paged"](
            jparams, cfg, jnp.asarray(tok),
            {**jp, **js, "len": jnp.asarray(start)}, jnp.asarray(bt),
            jnp.asarray(live), block_size=bs, impl="ref")
        tl, tc = hybrid.decode_step_paged(
            tparams, tcfg, _t(tok), {**tp, **ts, "len": _t(start)}, _t(bt),
            _t(live), block_size=bs)
        _close(tl[live], np.asarray(jl)[live], tol)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        jp = {n: jc[n] for n in jp}
        # the reference advanced the dead slot's state: the engine's
        # merge_state drops it, as the port never writes it
        js = {n: jnp.asarray(np.where(
            live.reshape(1, B, *([1] * (jc[n].ndim - 2))), np.asarray(jc[n]),
            np.asarray(js[n]))) for n in js}
        start = np.asarray(jc["len"])
    for n in ts:
        assert torch.equal(ts[n][:, 1], dead_state[n]), n
        _close(ts[n], js[n], tol)
    written = np.zeros(B * nblk + 1, bool)        # pages the steps wrote
    written[bt[live].ravel()] = True
    written[-1] = True                            # the trash page
    after = [p for n in tp for p in _parts(tp[n])]
    for a, b in zip(after, dead_rows):
        np.testing.assert_array_equal(a[:, ~written], b[:, ~written])
    rows = np.arange(nblk * bs)[None] < start[:, None]       # (B, S)
    for n in tp:
        for g, w in zip(_through_tables(tp[n], bt),
                        _through_tables(jp[n], bt)):
            g, w = g[:, rows], w[:, rows]
            if g.dtype == np.int8:                # one rounding step at most
                assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
            else:                                 # float pages, or scales
                ptol = tol if quant else 1e-5
                np.testing.assert_allclose(g, w, atol=ptol, rtol=ptol)


# zamba2-7b's attention head dim at tiny sizes: the plain versions the card
# holds each D = 112 route to, against the reference's Pallas kernels
def _paged_inputs(seed, *, B=3, T=6, Hq=4, Hkv=2, D=112, bs=8, nblk=3):
    rng = np.random.default_rng(seed)
    P = B * nblk + 1
    kp, vp = (rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(P - 1).reshape(B, nblk).astype(np.int32)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    return q, kp, vp, bt


def _alive(out, chunk_len):
    rows = np.arange(out.shape[1])[None] < np.asarray(chunk_len)[:, None]
    return np.where(rows[..., None, None], out, 0.0)


def _quant(p):
    return (JQuantPages(*(jnp.asarray(np.asarray(a)) for a in quantize(
        _t(p)))), QuantPages(*quantize(_t(p))))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_decode_plain_matches_pallas_at_d112(quant):
    """The plain paged decode at D = 112 (GQA 4/2, a dead slot, a slot
    whose keys fill its table) against the reference's Pallas paged decode
    kernel in interpret mode."""
    q, kp, vp, bt = _paged_inputs(12)
    q = q[:, 0]
    lens = np.asarray([17, 0, 24], np.int32)
    if quant:
        (jk, tk), (jv, tv) = _quant(kp), _quant(vp)
        want = jops.paged_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
            impl="pallas_interpret")
        got = ops.paged_decode_attention(_t(q), tk, tv, _t(bt), _t(lens))
    else:
        want = paged_decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens), interpret=True)
        got = ref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                             _t(lens))
    np.testing.assert_allclose(got.numpy()[lens > 0],
                               np.asarray(want)[lens > 0], atol=2e-5,
                               rtol=2e-5)
    assert not got[1].any()


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_chunk_plain_matches_pallas_at_d112(quant):
    """The plain paged chunk at D = 112 (ragged starts and chunk lengths,
    a dead slot) against the reference's Pallas paged chunk kernel in
    interpret mode; rows past chunk_len are zeros in the port."""
    q, kp, vp, bt = _paged_inputs(13)
    start, cl = np.asarray([0, 10, 5], np.int32), np.asarray([6, 4, 0],
                                                             np.int32)
    if quant:
        (jk, tk), (jv, tv) = _quant(kp), _quant(vp)
        want = jops.paged_chunk_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(start),
            jnp.asarray(cl), impl="pallas_interpret")
        got = ops.paged_chunk_attention(_t(q), tk, tv, _t(bt), _t(start),
                                        _t(cl))
    else:
        want = paged_chunk_prefill_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(start), jnp.asarray(cl),
            interpret=True)
        got = ref.paged_chunk_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                            _t(start), _t(cl))
    np.testing.assert_allclose(_alive(got.numpy(), cl),
                               _alive(np.asarray(want), cl), atol=2e-5,
                               rtol=2e-5)
    assert not got[2].any()


def test_dense_decode_and_chunk_plain_match_pallas_at_d112():
    """The plain dense decode (ragged lengths, an empty slot) and dense
    chunk (per-slot starts, an empty row) at D = 112, GQA 4/2, against the
    reference's Pallas kernels in interpret mode."""
    rng = np.random.default_rng(14)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    B, S, Hq, Hkv, D = 3, 40, 4, 2, 112
    kc, vc = f(B, S, Hkv, D), f(B, S, Hkv, D)
    q1 = f(B, Hq, D)
    lens = np.asarray([40, 0, 17], np.int32)
    want = decode_attention_pallas(jnp.asarray(q1), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(lens),
                                   k_block=16, interpret=True)
    got = ref.decode_attention_ref(_t(q1), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert not got[1].any()
    qc = f(B, 7, Hq, D)
    st, n = np.asarray([0, 20, 33], np.int32), np.asarray([7, 0, 7],
                                                          np.int32)
    want = chunk_prefill_attention_pallas(
        jnp.asarray(qc), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(st),
        jnp.asarray(n), interpret=True)
    got = ref.chunk_attention_ref(_t(qc), _t(kc), _t(vc), _t(st), _t(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert not got[1].any()


def test_flash_plain_matches_pallas_at_d112():
    """The plain flash forward at D = 112, causal, GQA 4/2, lengths off the
    Pallas blocks: output and log-sum-exp."""
    rng = np.random.default_rng(15)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = f(1, 40, 4, 112), f(1, 40, 2, 112), f(1, 40, 2, 112)
    got, got_lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=True)
    want, want_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=16,
        k_block=16, return_lse=True, interpret=True, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=2e-5)


# (prompt tokens, new tokens): 3 requests over 2 slots (one reused), one
# prompt length (the reference compiles its one-shot prefill once a
# length)
WAVE = [(9, 3), (9, 2), (9, 4)]
COUNTERS = ("decode_steps", "prefill_chunk_calls", "prefill_tokens_computed",
            "chunk_write_bytes", "oneshot_prefills", "whole_cache_copies",
            "admission_copy_bytes")
RUNTIME_CASES = {"paged_native_bf16": dict(kv_dtype="bf16"),
                 "paged_native_int8": dict(kv_dtype="int8"),
                 "dense_view": dict(kv_dtype="bf16", paged_native=False),
                 "oneshot": dict(kv_dtype="bf16", chunked_prefill=False),
                 "sync": dict(kv_dtype="bf16", mode="sync"),
                 "dense_cache": dict(kv_dtype="bf16", kvcache_impl="dense")}


def _lockstep(jrt, trt, cfg):
    """Submits WAVE to both runtimes and steps them in lockstep until they
    drain; holds every step's admissions, evictions, one-shot prefills,
    cache copies and decode steps, the greedy tokens and the host counters
    equal."""
    rng = np.random.default_rng(10)
    for rid, (n, new) in enumerate(WAVE):
        prompt = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        jrt.submit(JRequest(rid=rid, tokens=prompt, max_new_tokens=new,
                            stream=rid))
        trt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                     max_new_tokens=new, stream=rid))
    want, got = {}, {}
    for _ in range(300):
        if not (jrt.pending() or jrt.in_flight()):
            break
        js = jrt.step(max_wait_s=0.0)
        ts = trt.step(max_wait_s=0.0)
        assert (ts.admitted, ts.evicted, ts.oneshot_prefills,
                ts.whole_cache_copies, ts.decode_steps) == (
            js.admitted, js.evicted, js.oneshot_prefills,
            js.whole_cache_copies, js.decode_steps)
        want.update({r.rid: r for r in js.results})
        got.update({r.rid: r for r in ts.results})
    assert not (trt.pending() or trt.in_flight())
    assert sorted(got) == sorted(want) == list(range(len(WAVE)))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].decode_steps == want[rid].decode_steps
    for name in COUNTERS:
        assert getattr(trt, name) == getattr(jrt, name), name


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_wave_matches_reference(case):
    """One request wave through the reference's ``ServiceRuntime`` and the
    port's: paged-native in bf16 and int8 pages, the dense-view oracle,
    one-shot prefill into the pages, sync and the dense cache, at 8-token
    pages and 24 slot tokens.  A slot is evicted and reused; its first
    chunk starts from fresh state, not its previous tenant's."""
    cfg, tcfg, jp, tp = _setup()
    kw = dict(RUNTIME_CASES[case])
    plan_args = dict(bs=2, mf=2, dp=1, kv_dtype=kw.pop("kv_dtype"))
    jplan = JPlan(service="hybrid", category=JCat(JSens.FREQUENCY, False),
                  **plan_args)
    tplan = ParallelPlan(service="hybrid", category=TaskCategory(
        Sensitivity.FREQUENCY, False), **plan_args)
    kw.update(max_seq_len=24, block_size=8)
    jrt = JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0, **kw)
    trt = ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=0, **kw)
    assert (trt.paged_native, trt.chunked_prefill, trt.mode,
            trt.kvcache_impl) == (jrt.paged_native, jrt.chunked_prefill,
                                  jrt.mode, jrt.kvcache_impl)
    _lockstep(jrt, trt, cfg)


def test_registry_serves_hybrid_without_training():
    """(The name predates its training.)  hybrid resolves with every
    dense-cache and paged-native entry point, no speculative verify, and
    its training forward (ROADMAP.md Queue 1 item 12)."""
    api = family_api("hybrid")
    assert api.decode_step_paged is hybrid.decode_step_paged
    assert api.prefill_chunk_paged is hybrid.prefill_chunk_paged
    assert api.verify_step_paged is None
    assert api.forward_hidden is hybrid.forward_hidden


def _served(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("served "))
    m = re.match(r"served (\d+)/(\d+) requests, (\d+) tokens .*?(\d+) fused "
                 r"decode steps", line)
    return tuple(int(x) for x in m.groups())


def test_launcher_serves_zamba2_like_the_reference(capsys):
    """``--archs zamba2-7b`` on the reduced config: both launchers serve
    every request, with the same tokens and fused decode steps."""
    from repro.launch import serve as jserve
    argv = ["--archs", "zamba2-7b", "--servers", "1", "--requests", "2",
            "--max-new-tokens", "2", "--max-seq-len", "32"]
    assert jserve.main(argv) == 0
    want = _served(capsys.readouterr().out)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    got = _served(capsys.readouterr().out)
    assert got == want and got[:2] == (2, 2)
