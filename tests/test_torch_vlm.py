"""The VLM family (paligemma-3b's decoder behind its bidirectional image
prefix) of the PyTorch port against the JAX reference.

The config is the float32 toy of ``conftest`` as a VLM with a 16-row image
prefix, geglu, tied embeddings and one kv head (paligemma-3b's features at
toy width), served at block sizes under 16 so that the prefix spans
pages.  Weights are built by the reference and carried over with
``repro_torch.bridge.params_from_jax``; tokens and image embeddings are
made with numpy from a seed.  The reference runs ``impl="ref"``: its
Pallas flash kernel drops prefix keys past its query tile (``ROADMAP.md``
Queue 3), while its Pallas paged chunk kernel masks the prefix as the
plain version does, so the plain paged chunk is held to that kernel in
interpret mode.  On the CPU the port runs its plain versions.

Tolerances: logits and float pages to atol = rtol = 1e-4 (the frameworks
sum in other orders; 2e-3 on int8 pages, whose values may differ by one
rounding step); the plain chunk against the Pallas kernel to 2e-5 (the
reference's own kernel test); greedy token chains, lengths and host
counters exactly.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.kernels import ops as jops
from repro.kernels.decode_attention import (
    paged_chunk_prefill_attention_pallas)
from repro.kernels.quant import QuantPages as JQuantPages
from repro.kernels.quant import quantize as jquantize
from repro.models import vlm as jvlm
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quant import QuantPages, quantize
from repro_torch.launch import serve
from repro_torch.models import vlm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1e-4
PREFIX = 16
# the reference's steps, jitted once: called eagerly, each call traces and
# compiles its layer scan anew
J = {name: jax.jit(getattr(jvlm, name), static_argnums=1,
                   static_argnames=statics)
     for name, statics in (("prefill_chunk", ("impl",)),
                           ("decode_step", ("impl",)),
                           ("prefill_chunk_paged", ("block_size", "impl")),
                           ("decode_step_paged", ("block_size", "impl")))}


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _cfg():
    return toy_config(family="vlm", prefix_len=PREFIX, activation="geglu",
                      tie_embeddings=True, num_kv_heads=1)


_PARAMS = {}


def _setup():
    """(reference cfg, port cfg, reference params, port params), once."""
    if not _PARAMS:
        cfg = _cfg()
        # jitted: the eager init dispatches each leaf's draws one by one
        jp = jax.jit(jvlm.init, static_argnums=1)(jax.random.PRNGKey(3), cfg)
        _PARAMS["v"] = (cfg, _mirror(cfg), jp, bridge.params_from_jax(
            jax.tree.map(np.asarray, jp), _mirror(cfg), "cpu"))
    return _PARAMS["v"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _embeddings(cfg, B, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)


def test_init_keeps_reference_tree():
    """The VLM's tree is the dense decoder's with tied embeddings: the
    bridge carries every leaf across under its reference key path."""
    cfg, tcfg, jp, tp = _setup()
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))
                           for k, v in
                           jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(tp) == shapes(jax.tree.map(np.asarray, jp))
    assert shapes(vlm.init(0, tcfg, device="cpu")) == shapes(tp)
    assert "unembed" not in tp["embed"]


def test_prefill_matches_reference():
    """One-shot prefill of the prefix and 11 text tokens into a cache
    budgeted at 20 text tokens: logits, the prefix-plus-text K/V and the
    length (prefix included)."""
    cfg, tcfg, jp, tp = _setup()
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    emb = _embeddings(cfg, 2, 2)
    jl, jc = jvlm.prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                    "embeddings": jnp.asarray(emb)},
                          cache_size=20, impl="ref")
    tl, tc = vlm.prefill(tp, tcfg, {"tokens": _t(toks),
                                    "embeddings": _t(emb)}, cache_size=20)
    _close(tl, jl)
    for n in "kv":
        assert tc[n].shape == jc[n].shape == (
            cfg.num_layers, 2, 20 + PREFIX, 1, cfg.head_dim)
        _close(tc[n], jc[n])
    assert int(tc["len"]) == int(jc["len"]) == PREFIX + 11


def _chunk_plan():
    """Three ragged 8-token chunks for 3 slots: the first carries the
    embeddings; slot 2 is empty in the first and idle in the last."""
    return ((8, (8, 5, 0), True), (8, (6, 8, 3), False),
            (8, (4, 2, 0), False))


def test_dense_chunks_then_decode_match_reference():
    """``prefill_chunk`` over a dense cache: a first chunk with the image
    prefix (T + 16 rows written), two text chunks, then three
    ``decode_step``s; logits of the live rows, lengths and the caches
    held."""
    cfg, tcfg, jp, tp = _setup()
    rng = np.random.default_rng(4)
    B, S = 3, 48
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    emb = _embeddings(cfg, B, 5)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
          "len": jnp.zeros((B,), jnp.int32)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape),
          "len": torch.zeros((B,), dtype=torch.int32)}
    for T, cl, first in _chunk_plan():
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
        if first:
            jb["embeddings"], tb["embeddings"] = jnp.asarray(emb), _t(emb)
        cl = np.asarray(cl, np.int32)
        jl, jc = J["prefill_chunk"](jp, cfg, jb, jc,
                                    chunk_len=jnp.asarray(cl), impl="ref")
        tl, tc = vlm.prefill_chunk(tp, tcfg, tb, tc, chunk_len=_t(cl))
        live = cl > 0
        _close(tl[live], np.asarray(jl)[live])
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].tolist() == [PREFIX + 8 + 6 + 4, PREFIX + 5 + 8 + 2,
                                  PREFIX + 3]
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jc = J["decode_step"](jp, cfg, jnp.asarray(tok), jc,
                                  impl="ref")
        tl, tc = vlm.decode_step(tp, tcfg, _t(tok), tc)
        _close(tl, jl)
    for n in "kv":
        _close(tc[n], jc[n])


def _pools(cfg, quant, *, B, nblk, bs):
    """Zero pools (int8 with unit scales) for both frameworks and shuffled
    block tables."""
    P = B * nblk + 1
    shape = (cfg.num_layers, P, bs, cfg.num_kv_heads, cfg.head_dim)
    bt = np.random.default_rng(6).permutation(P - 1).reshape(
        B, nblk).astype(np.int32)
    if quant:
        vals, scl = np.zeros(shape, np.int8), np.ones(shape[:-1], np.float32)
        return ({n: JQuantPages(jnp.asarray(vals), jnp.asarray(scl))
                 for n in "kv"},
                {n: QuantPages(_t(vals), _t(scl)) for n in "kv"}, bt)
    zeros = np.zeros(shape, np.float32)
    return ({n: jnp.asarray(zeros) for n in "kv"},
            {n: _t(zeros) for n in "kv"}, bt)


def _through_tables(pool, bt):
    """(layers, B, nblk * bs, ...) of each slot's rows, read through its
    block table (values and scales for int8 pages)."""
    parts = ([pool.values, pool.scales]
             if isinstance(pool, (QuantPages, JQuantPages)) else [pool])
    out = []
    for a in parts:
        a = np.asarray(a.float() if isinstance(a, torch.Tensor)
                       and a.dtype != torch.int8 else a)
        g = a[:, bt]                                # (L, B, nblk, bs, ...)
        out.append(g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:]))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_chunks_then_decode_match_reference(quant):
    """``prefill_chunk_paged`` through block tables of 8-token pages (the
    16-row prefix spans two): a first chunk with the embeddings, two text
    chunks, then three ``decode_step_paged``s with one slot not live.
    Logits of the live rows, lengths and every slot's rows read through
    its table are held."""
    cfg, tcfg, jparams, tparams = _setup()
    rng = np.random.default_rng(7)
    B, nblk, bs = 3, 6, 8
    jp, tp, bt = _pools(cfg, quant, B=B, nblk=nblk, bs=bs)
    emb = _embeddings(cfg, B, 8)
    tol = 2e-3 if quant else TOL
    start = np.zeros(B, np.int32)
    for T, cl, first in _chunk_plan():
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
        if first:
            jb["embeddings"], tb["embeddings"] = jnp.asarray(emb), _t(emb)
        cl = np.asarray(cl, np.int32)
        jl, jc = J["prefill_chunk_paged"](
            jparams, cfg, jb, {**jp, "len": jnp.asarray(start)},
            jnp.asarray(bt), chunk_len=jnp.asarray(cl), block_size=bs,
            impl="ref")
        tl, tc = vlm.prefill_chunk_paged(
            tparams, tcfg, tb, {**tp, "len": _t(start)}, _t(bt),
            chunk_len=_t(cl), block_size=bs)
        live = cl > 0
        _close(tl[live], np.asarray(jl)[live], tol)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        jp = {n: jc[n] for n in "kv"}
        start = np.asarray(jc["len"])
    assert start.tolist() == [PREFIX + 8 + 6 + 4, PREFIX + 5 + 8 + 2,
                              PREFIX + 3]
    live = np.array([True, False, True])
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jl, jc = J["decode_step_paged"](
            jparams, cfg, jnp.asarray(tok), {**jp, "len": jnp.asarray(start)},
            jnp.asarray(bt), jnp.asarray(live), block_size=bs, impl="ref")
        tl, tc = vlm.decode_step_paged(
            tparams, tcfg, _t(tok), {**tp, "len": _t(start)}, _t(bt),
            _t(live), block_size=bs)
        _close(tl[live], np.asarray(jl)[live], tol)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        jp = {n: jc[n] for n in "kv"}
        start = np.asarray(jc["len"])
    rows = np.arange(nblk * bs)[None] < start[:, None]       # (B, S)
    for n in "kv":
        for g, w in zip(_through_tables(tp[n], bt),
                        _through_tables(jp[n], bt)):
            g, w = g[:, rows], w[:, rows]
            if g.dtype == np.int8:                # one rounding step at most
                assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


# paligemma-3b's attention shape at tiny T: 8 query heads on one kv head at
# D = 256 over 8-token pages.  A first chunk (start 0) whose first 4 rows
# are the prefix, and a text chunk past it; slot 2 dead
PAGED_CASES = {"first_chunk": ((0, 0, 0), (6, 5, 0), 4),
               "text_chunk": ((10, 7, 3), (6, 3, 0), 0)}


def _paged_chunk_inputs(case, seed):
    start, cl, prefix = PAGED_CASES[case]
    rng = np.random.default_rng(seed)
    B, T, Hq, D, bs, nblk = 3, 6, 8, 256, 8, 3
    P = B * nblk + 1
    kp, vp = (rng.normal(size=(P, bs, 1, D)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(P - 1).reshape(B, nblk).astype(np.int32)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    return (q, kp, vp, bt, np.asarray(start, np.int32),
            np.asarray(cl, np.int32), prefix)


def _alive(out, chunk_len):
    rows = np.arange(out.shape[1])[None] < np.asarray(chunk_len)[:, None]
    return np.where(rows[..., None, None], out, 0.0)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_chunk_plain_matches_pallas_at_d256(case, quant):
    """The plain paged chunk attention with ``prefix_len`` at paligemma's
    heads (G = 8, Hkv = 1, D = 256) against the reference's Pallas paged
    chunk kernel in interpret mode (``ops.*(impl="pallas_interpret")``
    for int8 pages); rows past chunk_len are zeros in the port."""
    q, kp, vp, bt, start, cl, prefix = _paged_chunk_inputs(case, 9)
    if quant:
        jk, jv = (JQuantPages(*jquantize(jnp.asarray(p))) for p in (kp, vp))
        tk, tv = (QuantPages(*quantize(_t(p))) for p in (kp, vp))
        want = jops.paged_chunk_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(start),
            jnp.asarray(cl), prefix_len=prefix, impl="pallas_interpret")
        got = ops.paged_chunk_attention(_t(q), tk, tv, _t(bt), _t(start),
                                        _t(cl), prefix_len=prefix)
    else:
        want = paged_chunk_prefill_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(start), jnp.asarray(cl),
            prefix_len=prefix, interpret=True)
        got = ref.paged_chunk_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                            _t(start), _t(cl),
                                            prefix_len=prefix)
    np.testing.assert_allclose(_alive(got.numpy(), cl),
                               _alive(np.asarray(want), cl), atol=2e-5,
                               rtol=2e-5)
    assert not got[2].any()


# (prompt tokens, new tokens): 3 requests over 2 slots (one reused), two
# prompt lengths (the reference compiles its one-shot prefill once a
# length)
WAVE = [(9, 6), (11, 5), (9, 8)]
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
    """Submits WAVE, each request with its own image embeddings, to both
    runtimes and steps them in lockstep until they drain; holds every
    step's admissions, evictions, one-shot prefills, cache copies and
    decode steps, the greedy tokens and the host counters equal."""
    rng = np.random.default_rng(10)
    for rid, (n, new) in enumerate(WAVE):
        prompt = rng.integers(1, cfg.vocab_size, n).astype(np.int32)
        extras = {"embeddings": rng.normal(
            size=(cfg.prefix_len, cfg.d_model)).astype(np.float32)}
        jrt.submit(JRequest(rid=rid, tokens=prompt, max_new_tokens=new,
                            stream=rid, extras=extras))
        trt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                     max_new_tokens=new, stream=rid,
                                     extras=extras))
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
    pages and 56 slot tokens (20 prompt + 16 prefix + 8 new at most).  A slot is evicted and reused; a reused slot's first chunk
    carries its new tenant's prefix."""
    cfg, tcfg, jp, tp = _setup()
    kw = dict(RUNTIME_CASES[case])
    plan_args = dict(bs=2, mf=2, dp=1, kv_dtype=kw.pop("kv_dtype"))
    jplan = JPlan(service="vlm", category=JCat(JSens.LATENCY, False),
                  **plan_args)
    tplan = ParallelPlan(service="vlm", category=TaskCategory(
        Sensitivity.LATENCY, False), **plan_args)
    kw.update(max_seq_len=56, block_size=8)
    jrt = JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0, **kw)
    trt = ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=0, **kw)
    assert (trt.paged_native, trt.chunked_prefill, trt.mode,
            trt.kvcache_impl) == (jrt.paged_native, jrt.chunked_prefill,
                                  jrt.mode, jrt.kvcache_impl)
    _lockstep(jrt, trt, cfg)


def test_submit_rejects_vlm_requests_without_embeddings():
    cfg, tcfg, _, tp = _setup()
    plan = ParallelPlan(service="vlm", category=TaskCategory(
        Sensitivity.LATENCY, False), bs=2, mf=1, dp=1)
    rt = ServiceRuntime(tcfg, tp, plan, device="cpu", max_seq_len=56,
                        block_size=8)
    prompt = np.arange(5, dtype=np.int32)
    for extras in (None, {}, {"embeddings": np.zeros((3, cfg.d_model))}):
        with pytest.raises(ValueError, match="embeddings"):
            rt.submit(GenerationRequest(rid=0, tokens=prompt,
                                        max_new_tokens=2, extras=extras))
    assert rt.pending() == 0


def _served(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("served "))
    m = re.match(r"served (\d+)/(\d+) requests, (\d+) tokens .*?(\d+) fused "
                 r"decode steps", line)
    return tuple(int(x) for x in m.groups())


def test_launcher_serves_whisper_and_paligemma_like_the_reference(capsys):
    """``--archs whisper-large-v3,paligemma-3b`` on the reduced configs:
    both launchers serve every request, with the same tokens and fused
    decode steps."""
    from repro.launch import serve as jserve
    argv = ["--archs", "whisper-large-v3,paligemma-3b", "--servers", "1",
            "--requests", "2", "--max-new-tokens", "2", "--max-seq-len", "48"]
    assert jserve.main(argv) == 0
    want = _served(capsys.readouterr().out)
    assert serve.main(argv + ["--device", "cpu"]) == 0
    got = _served(capsys.readouterr().out)
    assert got == want and got[:2] == (2, 2)


def test_launcher_refuses_requests_over_the_slot_budget():
    """paligemma-3b's full-width requests take 6 prompt + 256 prefix + 8
    new = 270 tokens: at the default --max-seq-len of 256 the launcher
    refuses before it allocates, naming the flag; 512 fits.  On the CPU
    the reduced config's 16-row prefix is refused at --max-seq-len 16."""
    full = {"paligemma-3b": get_config("paligemma-3b")}
    args = serve._parser().parse_args(["--archs", "paligemma-3b"])
    with pytest.raises(ValueError, match="--max-seq-len 270"):
        serve._refuse_requests_over_the_budget(args, full)
    args = serve._parser().parse_args(["--archs", "paligemma-3b",
                                       "--max-seq-len", "512"])
    serve._refuse_requests_over_the_budget(args, full)
    with pytest.raises(ValueError, match="--max-seq-len"):
        serve.main(["--device", "cpu", "--archs", "paligemma-3b",
                    "--max-seq-len", "16"])
