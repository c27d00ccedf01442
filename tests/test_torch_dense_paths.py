"""The sync and dense-cache serving paths of the PyTorch port against the
JAX reference: the dense chunked-prefill attention's plain version, the
dense attention layers, every ported family's one-shot ``prefill`` and
dense ``prefill_chunk``/``decode_step``, ``kvcache``, the arena's one-shot
and dense-view writes, and ``ServiceRuntime`` in ``mode="sync"``,
``kvcache_impl="dense"``, ``chunked_prefill=False``, ``paged_native=False``
and over a ring (sliding-window) layout.

Configs are the float32 toy config of ``conftest`` and the reduced
mixtral-8x7b (window 64), whisper-large-v3 and mamba2-2.7b in float32.
Weights are built by the reference and carried over with
``repro_torch.bridge.params_from_jax``; inputs are made with numpy from a
seed.  On the CPU the port runs its plain versions.

Tolerances: the chunk attention's plain version against the Pallas kernel
in interpret mode to atol = rtol = 2e-5 (the reference's own kernel test);
layer outputs, caches and per-step logits to atol = rtol = 1e-4 (the
frameworks sum in other orders); ``kvcache`` results and the arena's pools
exactly (the same copies and the same bit-identical int8 quantize); greedy
token chains, lengths and host counters exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro import configs as jconfigs
from repro.core.allocator import ParallelPlan as JPlan
from repro.core.categories import Sensitivity as JSens
from repro.core.categories import TaskCategory as JCat
from repro.kernels.decode_attention import chunk_prefill_attention_pallas
from repro.models import layers as jlayers
from repro.models.registry import model_api as jmodel_api
from repro.serving import kvcache as jkv
from repro.serving.arena import KVArena as JArena
from repro.serving.engine import GenerationRequest as JRequest
from repro.serving.engine import ServiceRuntime as JRuntime
from repro_torch import bridge
from repro_torch.core.allocator import ParallelPlan
from repro_torch.core.categories import Sensitivity, TaskCategory
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import model_api
from repro_torch.serving import kvcache
from repro_torch.serving.arena import KVArena
from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _reduced(arch):
    return dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                               dtype="float32", param_dtype="float32")


CONFIGS = {"dense": lambda: toy_config(),
           "moe": lambda: _reduced("mixtral-8x7b"),
           "audio": lambda: _reduced("whisper-large-v3"),
           "ssm": lambda: _reduced("mamba2-2.7b")}
_PARAMS = {}


def _setup(family):
    """(reference cfg, port cfg, reference params, port params), built
    once per family."""
    if family not in _PARAMS:
        cfg = CONFIGS[family]()
        jp = jmodel_api(cfg).init(jax.random.PRNGKey(5), cfg)
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    _mirror(cfg), "cpu")
        _PARAMS[family] = (cfg, _mirror(cfg), jp, tp)
    return _PARAMS[family]


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

CHUNK_CASES = {
    # (B, S, T, Hq, Hkv, D), start, chunk_len, prefix_len
    "gqa": ((2, 40, 8, 4, 2, 16), [5, 17], [8, 3], 0),
    "per_row_one_empty": ((3, 37, 13, 8, 2, 32), [0, 11, 24], [13, 0, 9], 0),
    "prefix_past_the_tile": ((2, 70, 13, 4, 4, 16), [20, 3], [13, 7], 45),
    "odd_t_and_s": ((1, 29, 5, 6, 3, 8), [21], [5], 0),
    # more than one 64-row and 64-key tile of the card's kernel: 130 rows
    # at start 63 over S = 200, a ragged second slot, a prefix of 100
    "multi_tile": ((2, 200, 130, 4, 2, 16), [63, 0], [130, 77], 100),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_attention_ref_matches_pallas(case):
    """``ref.chunk_attention_ref`` (and ``ops.chunk_attention`` on CPU
    tensors) against ``chunk_prefill_attention_pallas`` in interpret mode:
    GQA, a bidirectional prefix past the first rows, per-row start and
    chunk_len with an empty row, T and S off every tile size."""
    (B, S, T, Hq, Hkv, D), start, cl, prefix = CHUNK_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    st, n = np.array(start, np.int32), np.array(cl, np.int32)
    want = chunk_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
        jnp.asarray(n), prefix_len=prefix, interpret=True)
    got = ref.chunk_attention_ref(_t(q), _t(k), _t(v), _t(st), _t(n),
                                  prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert torch.equal(ops.chunk_attention(_t(q), _t(k), _t(v), _t(st),
                                           _t(n), prefix_len=prefix), got)
    for b in range(B):
        assert not got[b, n[b]:].any()


# ---------------------------------------------------------------------------
# the dense attention layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["full", "window", "ring"])
def test_attention_decode_matches_reference(case):
    """One decode token per slot against dense caches: a full cache, a
    cache longer than the window (window mask), and a ring of exactly the
    window (lengths past it wrap); the new rows land at ring slot
    (len - 1) % S in place."""
    cfg, tcfg, jp, tp = _setup("dense")
    jl = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    tl = {k: v[1] for k, v in tp["blocks"]["attn"].items()}
    S, window, lens = {"full": (24, None, [5, 13, 24]),
                       "window": (24, 8, [5, 13, 24]),
                       "ring": (8, None, [3, 12, 30])}[case]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, S, 2, 16)).astype(np.float32)
              for _ in range(2))
    lens = np.array(lens, np.int32)
    want, jk, jv = jlayers.attention_decode(
        jl, cfg, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens), window=window, impl="ref")
    tk, tv = _t(kc), _t(vc)
    got, gk, gv = layers.attention_decode(tl, tcfg, _t(x), tk, tv,
                                          _t(lens), window=window)
    assert gk is tk and gv is tv
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)


def test_attention_decode_keeps_dead_slots():
    """With ``live``, a dead slot's cache rows are not written and its row
    attends to nothing; the live slots match the reference."""
    cfg, tcfg, jp, tp = _setup("dense")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tl = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, 16, 2, 16)).astype(np.float32)
              for _ in range(2))
    lens = np.array([4, 9, 16], np.int32)
    want, jk, _ = jlayers.attention_decode(
        jl, cfg, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens), impl="ref")
    tk = _t(kc)
    got, _, _ = layers.attention_decode(
        tl, tcfg, _t(x), tk, _t(vc), _t(lens),
        live=torch.tensor([True, False, True]))
    _close(got[[0, 2]], np.asarray(want)[[0, 2]])
    _close(tk[[0, 2]], np.asarray(jk)[[0, 2]])
    assert torch.equal(tk[1], _t(kc)[1])


def test_attention_chunk_matches_reference():
    """A right-padded chunk appended at per-slot offsets (one slot's chunk
    ragged, one reaching the cache's end), then causal attention through
    ``ops.chunk_attention``; a ring layout raises as in the reference."""
    cfg, tcfg, jp, tp = _setup("dense")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tl = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
              for _ in range(2))
    start, cl = np.array([3, 18], np.int32), np.array([5, 6], np.int32)
    want, jk, jv = jlayers.attention_chunk(
        jl, cfg, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(start), jnp.asarray(cl), impl="ref")
    tk, tv = _t(kc), _t(vc)
    got, _, _ = layers.attention_chunk(tl, tcfg, _t(x), tk, tv, _t(start),
                                       _t(cl))
    for b in range(2):
        _close(got[b, :cl[b]], np.asarray(want)[b, :cl[b]])
    _close(tk, jk)
    _close(tv, jv)
    with pytest.raises(NotImplementedError, match="ring"):
        layers.attention_chunk(tl, tcfg, _t(x), tk, tv, _t(start), _t(cl),
                               window=8)


def test_cross_attention_decode_matches_reference():
    cfg, tcfg, jp, tp = _setup("audio")
    jl = jax.tree.map(lambda a: a[0], jp["dec_blocks"]["cross_attn"])
    tl = {k: v[0] for k, v in tp["dec_blocks"]["cross_attn"].items()}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)
    want = jlayers.cross_attention_decode(jl, cfg, jnp.asarray(x),
                                          jnp.asarray(mem), impl="ref")
    _close(layers.cross_attention_decode(tl, tcfg, _t(x), _t(mem)), want)


# ---------------------------------------------------------------------------
# the families' dense entry points
# ---------------------------------------------------------------------------

def _batch(cfg, rng, B, L, embeddings):
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, L)).astype(
        np.int32)}
    if embeddings:
        batch["embeddings"] = rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


def _close_cache(got, want):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_one_shot_prefill_and_decode_match_reference(family):
    """One-shot ``prefill`` of a 2 x 11 batch into a 20-row cache (zero
    padding), then three ``decode_step``s: logits and every cache leaf."""
    cfg, tcfg, jp, tp = _setup(family)
    japi, tapi = jmodel_api(cfg), model_api(tcfg)
    rng = np.random.default_rng(8)
    jb, tb = _both(_batch(cfg, rng, 2, 11, family == "audio"))
    jl, jc = japi.prefill(jp, cfg, jb, cache_size=20, impl="ref")
    tl, tc = tapi.prefill(tp, tcfg, tb, cache_size=20)
    _close(tl, jl)
    _close_cache(tc, jc)
    for step in range(3):
        tok = rng.integers(1, cfg.vocab_size, 2).astype(np.int32)
        jl, jc = japi.decode_step(jp, cfg, jnp.asarray(tok), jc, impl="ref")
        tl, tc = tapi.decode_step(tp, tcfg, _t(tok), tc)
        _close(tl, jl)
        _close_cache(tc, jc)


@pytest.mark.parametrize("family", ["dense", "moe", "audio"])
def test_dense_chunks_then_decode_match_reference(family):
    """Two right-padded chunks at per-slot offsets into a dense cache (the
    first carries the frame embeddings for the audio family), then two
    decode steps with per-slot lengths: logits and caches."""
    cfg, tcfg, jp, tp = _setup(family)
    japi, tapi = jmodel_api(cfg), model_api(tcfg)
    rng = np.random.default_rng(9)
    jc = jax.tree.map(lambda a: a, japi.init_cache(cfg, 2, 40))
    tc = tapi.init_cache(tcfg, 2, 40, device="cpu")
    jc["len"] = jnp.zeros((2,), jnp.int32)
    tc["len"] = torch.zeros(2, dtype=torch.int32)
    for i, cl in enumerate(([8, 5], [4, 8])):
        jb, tb = _both(_batch(cfg, rng, 2, 8, family == "audio" and i == 0))
        cl = np.array(cl, np.int32)
        jl, jc = japi.prefill_chunk(jp, cfg, jb, jc,
                                    chunk_len=jnp.asarray(cl), impl="ref")
        tl, tc = tapi.prefill_chunk(tp, tcfg, tb, tc, chunk_len=_t(cl))
        _close(tl, jl)
        _close_cache(tc, jc)
    for step in range(2):
        tok = rng.integers(1, cfg.vocab_size, 2).astype(np.int32)
        jl, jc = japi.decode_step(jp, cfg, jnp.asarray(tok), jc, impl="ref")
        tl, tc = tapi.decode_step(tp, tcfg, _t(tok), tc)
        _close(tl, jl)
        _close_cache(tc, jc)
    assert tc["len"].tolist() == [14, 15]


def test_ring_prefill_and_decode_match_reference():
    """reduced(mixtral-8x7b) has a 64-token window: a 70-token prompt
    asked for 80 rows keeps the last 64 in ring order, and decode wraps
    around the ring."""
    cfg, tcfg, jp, tp = _setup("moe")
    japi, tapi = jmodel_api(cfg), model_api(tcfg)
    rng = np.random.default_rng(10)
    jb, tb = _both(_batch(cfg, rng, 1, 70, False))
    jl, jc = japi.prefill(jp, cfg, jb, cache_size=80, impl="ref")
    tl, tc = tapi.prefill(tp, tcfg, tb, cache_size=80)
    assert tuple(tc["k"].shape[2:3]) == (64,)
    _close(tl, jl)
    _close_cache(tc, jc)
    for step in range(3):
        tok = rng.integers(1, cfg.vocab_size, 1).astype(np.int32)
        jl, jc = japi.decode_step(jp, cfg, jnp.asarray(tok), jc, impl="ref")
        tl, tc = tapi.decode_step(tp, tcfg, _t(tok), tc)
        _close(tl, jl)
        _close_cache(tc, jc)


# ---------------------------------------------------------------------------
# kvcache and the arena's one-shot and dense-view writes
# ---------------------------------------------------------------------------

def _caches():
    rng = np.random.default_rng(11)
    a = {"k": rng.normal(size=(2, 3, 5, 2, 4)).astype(np.float32),
         "ssd": rng.normal(size=(2, 3, 4, 4)).astype(np.float32),
         "len": np.array(5, np.int32)}
    b = {"k": rng.normal(size=(2, 1, 9, 2, 4)).astype(np.float32),
         "ssd": rng.normal(size=(2, 1, 4, 4)).astype(np.float32),
         "len": np.array([7], np.int32)}
    return a, b


def _same(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_kvcache_matches_reference():
    a, b = _caches()
    ja, jb = ({k: jnp.asarray(v) for k, v in c.items()} for c in (a, b))
    ta, tb = ({k: _t(v) for k, v in c.items()} for c in (a, b))
    assert kvcache.batch_size(ta) == jkv.batch_size(ja) == 3
    np.testing.assert_array_equal(kvcache.lens(ta).numpy(), jkv.lens(ja))
    _same(kvcache.with_lens(ta, [1, 2, 3]), jkv.with_lens(ja, [1, 2, 3]))
    _same(kvcache.select_slots(ta, [2, 0]), jkv.select_slots(ja, [2, 0]))
    _same(kvcache.pad_to(tb, {"k": (2, 1, 12, 2, 4), "ssd": (2, 1, 4, 4),
                              "len": (1,)}),
          jkv.pad_to(jb, {"k": (2, 1, 12, 2, 4), "ssd": (2, 1, 4, 4),
                          "len": (1,)}))
    merged = kvcache.merge([ta, tb])
    _same(merged, jkv.merge([ja, jb]))
    assert merged["len"].tolist() == [5, 5, 5, 7]
    _same(kvcache.concat([ta, ta]), jkv.concat([ja, ja]))
    _same(kvcache.merge([tb]), jkv.merge([jb]))
    assert kvcache.cache_bytes(merged) == jkv.cache_bytes(jkv.merge([ja, jb]))
    _same(kvcache.map_batch(ta, lambda x, ax: x * 2),
          jkv.map_batch(ja, lambda x, ax: x * 2))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_arena_one_shot_and_dense_view_writes_match_reference(kv_dtype):
    """``write_prefill`` of the same prefilled cache, ``dense_view``
    through the block tables, and ``append_rows`` of one decode row per
    live slot and of a ragged multi-token chunk: pools, lengths and views
    equal the reference's (int8 pools quantize on write)."""
    cfg, tcfg, jp, tp = _setup("dense")
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer
    kw = dict(capacity=3, max_seq_len=24, block_size=8, kv_dtype=kv_dtype)
    ja = JArena(cfg, jtransformer.init_cache, **kw)
    ta = KVArena(tcfg, transformer.init_cache, device="cpu", **kw)
    rng = np.random.default_rng(12)
    for n in (13, 5):
        jb, tb = _both(_batch(cfg, rng, 1, n, False))
        _, jc = jtransformer.prefill(jp, cfg, jb, cache_size=24, impl="ref")
        _, tc = transformer.prefill(tp, tcfg, tb, cache_size=24)
        js, ts = ja.alloc(n + 4), ta.alloc(n + 4)
        assert js == ts
        assert ja.write_prefill(js, jc, n) == ta.write_prefill(ts, tc, n)

    def same_pools():
        for jpool, tpool in zip(ja.pages, ta.pages):
            if kv_dtype == "int8":
                np.testing.assert_array_equal(tpool.values.numpy(),
                                              np.asarray(jpool.values))
                _close(tpool.scales, jpool.scales)
            else:
                _close(tpool, jpool)
        np.testing.assert_array_equal(ta.lens.numpy(), np.asarray(ja.lens))

    same_pools()
    tables = ta.block_tables()
    for jv, tv in zip(ja.dense_view(ja.pages, jnp.asarray(tables)),
                      ta.dense_view(ta.pages, _t(tables))):
        _close(tv, jv)
    new = [rng.normal(size=(cfg.num_layers, 3, 24, 2, 16)).astype(np.float32)
           for _ in range(2)]
    live = np.array([True, False, True])
    ja.pages = ja.append_rows(ja.pages, [jnp.asarray(d) for d in new],
                              ja.lens, jnp.asarray(live), jnp.asarray(tables))
    ta.append_rows(ta.pages, [_t(d) for d in new], ta.lens, _t(live),
                   _t(tables))
    same_pools()
    row = tables[1:2]
    start, valid = np.array([5], np.int32), np.array([6], np.int32)
    ja.pages = ja.append_rows(ja.pages, [jnp.asarray(d[:, 1:2]) for d in new],
                              jnp.asarray(start), jnp.ones((1,), bool),
                              jnp.asarray(row), n_tokens=8,
                              valid_tokens=jnp.asarray(valid))
    ta.append_rows(ta.pages, [_t(d[:, 1:2]) for d in new], _t(start),
                   torch.ones(1, dtype=torch.bool), _t(row), n_tokens=8,
                   valid_tokens=_t(valid))
    same_pools()


# ---------------------------------------------------------------------------
# ServiceRuntime: sync, dense, one-shot, dense-view and ring serving
# ---------------------------------------------------------------------------

# two prompt lengths: the reference compiles its one-shot prefill once a
# length, and the dense impl its decode once a batch size
WAVE = [(9, 6), (20, 5), (9, 8), (20, 4), (9, 7), (20, 6), (9, 5)]
COUNTERS = ("decode_steps", "prefill_chunk_calls", "prefill_tokens_computed",
            "chunk_write_bytes", "oneshot_prefills", "whole_cache_copies",
            "admission_copy_bytes")


def _plans(sensitivity="LATENCY", **args):
    jplan = JPlan(service="t", category=JCat(getattr(JSens, sensitivity),
                                              False), **args)
    tplan = ParallelPlan(service="t", category=TaskCategory(
        getattr(Sensitivity, sensitivity), False), **args)
    return jplan, tplan


def _wave(cfg, wave, seed=3):
    rng = np.random.default_rng(seed)
    reqs = []
    for rid, (n, new) in enumerate(wave):
        extras = None
        if cfg.family == "audio":
            extras = {"embeddings": rng.normal(
                size=(cfg.encoder_len, cfg.d_model)).astype(np.float32)}
        reqs.append((rid, rng.integers(1, cfg.vocab_size, n).astype(
            np.int32), new, extras))
    return reqs


def _lockstep(jrt, trt, reqs):
    """Submits ``reqs`` to both runtimes and steps them in lockstep until
    they drain; asserts equal greedy tokens, equal per-step admissions and
    results, and equal host counters."""
    for rid, prompt, new, extras in reqs:
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
    assert sorted(got) == sorted(want) == [r[0] for r in reqs]
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].decode_steps == want[rid].decode_steps
    for name in COUNTERS:
        assert getattr(trt, name) == getattr(jrt, name), name
    return got


MODES = {"sync": dict(mode="sync"), "dense": dict(kvcache_impl="dense"),
         "oneshot": dict(chunked_prefill=False),
         "dense_view": dict(paged_native=False)}
RUNTIME_CASES = [("dense", m) for m in sorted(MODES)] + [
    ("moe", "dense_view"), ("audio", "dense_view"), ("ssm", "sync")]


@pytest.mark.parametrize("family,mode", RUNTIME_CASES,
                         ids=[f"{f}-{m}" for f, m in RUNTIME_CASES])
def test_runtime_modes_match_reference(family, mode):
    """The same request wave through the reference's ``ServiceRuntime`` and
    the port's in each mode: 7 requests (4 for the other families) over 4
    slots (sync: batches of 4, left-padded, decoded to the batch's longest
    budget), slots evicted and reused.  Greedy tokens, per-step telemetry
    and host counters equal."""
    cfg, tcfg, jp, tp = _setup(family)
    jplan, tplan = _plans(bs=4, kv_dtype="bf16")
    kw = dict(max_seq_len=56, block_size=8, **MODES[mode])
    jrt = JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0, **kw)
    trt = ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=0,
                         **kw)
    assert (trt.paged_native, trt.chunked_prefill) == (
        jrt.paged_native, jrt.chunked_prefill)
    _lockstep(jrt, trt, _wave(cfg, WAVE if family == "dense" else WAVE[:4]))


def test_sync_mode_attends_to_left_pads():
    """Sync mode left-pads with token 0 and masks nothing: a short prompt
    alone and in a batch with a long one gives the batch's tokens only
    in the batch (the reference's behaviour, reproduced)."""
    cfg, tcfg, jp, tp = _setup("dense")
    jplan, tplan = _plans(bs=2, kv_dtype="bf16")
    reqs = _wave(cfg, [(3, 5), (20, 5)], seed=4)
    kw = dict(max_seq_len=56, block_size=8, mode="sync")
    got = _lockstep(JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0,
                             **kw),
                    ServiceRuntime(tcfg, tp, tplan, device="cpu",
                                   prefix_cache=0, **kw),
                    reqs)
    alone = ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=0,
                           **kw)
    rid, prompt, new, _ = reqs[0]
    alone.submit(GenerationRequest(rid=rid, tokens=prompt,
                                   max_new_tokens=new))
    assert alone.drain()[0].tokens.tolist() != got[rid].tokens.tolist()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_step_equals_dense_view_oracle(kv_dtype, seed):
    """Random schedules (prompt lengths, budgets, slot counts) through the
    port's paged-native runtime and its own ``paged_native=False`` oracle:
    identical greedy tokens and final lengths, as the reference holds its
    native step to its oracle."""
    cfg, tcfg, jp, tp = _setup("dense")
    rng = np.random.default_rng(seed)
    bs = int(rng.integers(1, 4))
    wave = [(int(rng.integers(1, 25)), int(rng.integers(1, 9)))
            for _ in range(5)]
    _, tplan = _plans(bs=bs, kv_dtype=kv_dtype)
    out = {}
    for native in (True, False):
        rt = ServiceRuntime(tcfg, tp, tplan, device="cpu", max_seq_len=40,
                            block_size=8, paged_native=native)
        for rid, prompt, new, _ in _wave(cfg, wave, seed):
            rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                        max_new_tokens=new))
        res = rt.drain()
        out[native] = ({r.rid: r.tokens.tolist() for r in res},
                       rt.groups[0].arena.lens.tolist(), rt.decode_steps,
                       rt.prefill_chunk_calls)
    assert out[True] == out[False]
    assert {rid: len(t) for rid, t in out[True][0].items()} == {
        rid: new for rid, (_, new) in enumerate(wave)}


def test_mixtral_serves_past_its_window_like_the_reference():
    """reduced(mixtral-8x7b) at a 128-token slot budget, twice its 64-token
    window: the K/V is a per-slot ring, prompts prefill in one shot, and
    requests run past the window.  Tokens equal the reference's."""
    cfg, tcfg, jp, tp = _setup("moe")
    jplan, tplan = _plans(bs=2, kv_dtype="bf16")
    kw = dict(max_seq_len=128, block_size=8)
    jrt = JRuntime(cfg, jp, jplan, impl="ref", prefix_cache=0, **kw)
    trt = ServiceRuntime(tcfg, tp, tplan, device="cpu", prefix_cache=0,
                         **kw)
    assert trt.ring_fallback and jrt.ring_fallback
    assert not trt.paged_native and not trt.chunked_prefill
    arena_state = [tuple(s.shape) for s in
                   KVArena(tcfg, model_api(tcfg).init_cache, capacity=2,
                           max_seq_len=128, block_size=8,
                           device="cpu").state]
    assert arena_state == [(cfg.num_layers, 2, 64, cfg.num_kv_heads,
                            cfg.head_dim)] * 2
    _lockstep(jrt, trt, _wave(cfg, [(50, 30), (70, 20), (20, 60)], seed=5))
