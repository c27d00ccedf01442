"""Dense-model parity between the PyTorch port and the JAX reference.

Weights are built by the reference (``model_api(cfg).init``) and carried
over with ``repro_torch.bridge.params_from_jax``; inputs are made with
numpy from a seed.  Layers agree to float fuzz; the paged steps' logits to
1e-4 and their f32 page pools to 1e-6 (the two frameworks sum matrix
products in different orders).  int8 pools hold quantized rows, and one
row whose f32 input differs by that fuzz can land on the other side of a
rounding boundary: the values then differ by one step (``scale``) and the
logits move by up to about ``|q| * scale`` per such key, so int8 logits
are held to 2e-3 and int8 values to one step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import toy_config
from repro import configs as jconfigs
from repro.kernels.quant import QuantPages as JQuantPages
from repro.kernels.quant import quantize as jq
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.registry import model_api as jmodel_api
from repro_torch import bridge, configs
from repro_torch.kernels.quant import QuantPages
from repro_torch.kernels.quant import quantize as tq
from repro_torch.models import layers, transformer
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.registry import model_api

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mirror(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_mirror_matches_reference(arch):
    for jcfg, tcfg in ((jconfigs.get_config(arch), configs.get_config(arch)),
                       (jconfigs.reduced(jconfigs.get_config(arch)),
                        reduced(configs.get_config(arch)))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
    assert configs.get_config(arch).compute_dtype == torch.bfloat16


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    cfg = toy_config()
    x = rng.normal(size=(3, 5, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(cfg.d_model,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-6, rtol=1e-6)
    heads = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rope(_t(heads), _t(pos), 10_000.0).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(heads), jnp.asarray(pos),
                                10_000.0)), atol=1e-5, rtol=1e-5)
    for act in ("swiglu", "geglu", "gelu_mlp"):
        c = toy_config(activation=act)
        p = jlayers.init_mlp(jax.random.PRNGKey(1), c)
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, p), _mirror(c),
                                    "cpu")
        np.testing.assert_allclose(
            layers.mlp(tp, _mirror(c), _t(x)).numpy(),
            np.asarray(jlayers.mlp(p, c, jnp.asarray(x))), atol=1e-5,
            rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_insert_rows_matches_reference(quant):
    """Valid rows land at their positions through the table; dead rows go
    to the trash page (the last one) and nowhere else."""
    rng = np.random.default_rng(2)
    P, bs, Hkv, D = 9, 4, 2, 8
    pages = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    rows = rng.normal(size=(2, 6, Hkv, D)).astype(np.float32)
    bt = np.array([[3, 0, 5, 8], [1, 7, 8, 8]], np.int32)
    pos = np.array([[2, 3, 4, 5, 6, 7], [4, 5, 6, 7, 8, 9]], np.int32)
    valid = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    if quant:
        jpages = JQuantPages(*jq(jnp.asarray(pages)))
        tpages = QuantPages(*tq(_t(pages)))
    else:
        jpages, tpages = jnp.asarray(pages), _t(pages)
    want = jlayers.paged_insert_rows(jpages, jnp.asarray(rows),
                                     jnp.asarray(bt), jnp.asarray(pos),
                                     jnp.asarray(valid), block_size=bs)
    got = layers.paged_insert_rows(tpages, _t(rows), _t(bt), _t(pos),
                                   _t(valid), block_size=bs)
    assert got is tpages                         # updated in place
    pairs = ([(got.values, want.values), (got.scales, want.scales)]
             if quant else [(got, want)])
    for g, w in pairs:
        # every page but the trash page is exact; dead rows all target the
        # trash page's first row, so its content is whichever lands last
        np.testing.assert_array_equal(g[:-1].numpy(), np.asarray(w)[:-1])
        dead = (tq(_t(rows))[0] if g.dtype == torch.int8
                else tq(_t(rows))[1] if quant else _t(rows))[~valid]
        assert any(torch.equal(g[-1, 0], d) for d in dead)


@pytest.mark.parametrize("quant", [False, True])
def test_attention_decode_paged_dead_slots(quant):
    """Live slots' outputs and the pools match the reference layer; a dead
    slot (here a freed one, with a stale length and a table of trash
    pages) attends to no key and its output is zero."""
    cfg = toy_config()
    tcfg = _mirror(cfg)
    p = jlayers.init_attention(jax.random.PRNGKey(7), cfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    rng = np.random.default_rng(8)
    B, nblk, bs = 3, 4, 8
    P = B * nblk + 1
    shape = (P, bs, cfg.num_kv_heads, cfg.head_dim)
    pools = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    bt = rng.permutation(P - 1).reshape(B, nblk).astype(np.int32)
    bt[2] = P - 1
    lens = np.array([5, 17, 20], np.int32)
    live = np.array([True, True, False])
    x = rng.normal(size=(B, cfg.d_model)).astype(np.float32)
    if quant:
        jk, jv = (JQuantPages(*jq(jnp.asarray(pools[n]))) for n in "kv")
        tk, tv = (QuantPages(*tq(_t(pools[n]))) for n in "kv")
    else:
        jk, jv = (jnp.asarray(pools[n]) for n in "kv")
        tk, tv = (_t(pools[n]) for n in "kv")
    want, jk, jv = jlayers.attention_decode_paged(
        p, cfg, jnp.asarray(x), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        jnp.asarray(live), block_size=bs, impl="ref")
    got, tk, tv = layers.attention_decode_paged(
        tp, tcfg, _t(x), tk, tv, _t(bt), _t(lens), _t(live), block_size=bs)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-5, rtol=1e-5)
    assert not got[~torch.from_numpy(live)].any()
    for g, w in zip(_pool_arrays(tk) + _pool_arrays(tv),
                    _pool_arrays(jk) + _pool_arrays(jv)):
        if g.dtype == np.int8:                   # one rounding step at most
            assert np.abs(g[:-1].astype(int) - w[:-1].astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g[:-1], w[:-1], atol=1e-6, rtol=1e-5)


def _step_inputs(cfg, quant, *, B=3, nblk=4, bs=8):
    """Shared pools (zeros, or zero int8 pools with unit scales) and
    shuffled per-slot block tables, for both frameworks."""
    P = B * nblk + 1
    shape = (cfg.num_layers, P, bs, cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(3)
    bt = rng.permutation(P - 1).reshape(B, nblk).astype(np.int32)
    if quant:
        vals = np.zeros(shape, np.int8)
        scl = np.ones(shape[:-1], np.float32)
        j = {n: JQuantPages(jnp.asarray(vals), jnp.asarray(scl))
             for n in "kv"}
        t = {n: QuantPages(_t(vals), _t(scl)) for n in "kv"}
    else:
        zeros = np.zeros(shape, np.float32)
        j = {n: jnp.asarray(zeros, cfg.compute_dtype) for n in "kv"}
        t = {n: _t(zeros).to(_mirror(cfg).compute_dtype) for n in "kv"}
    return j, t, bt, bs


def _pool_arrays(pool):
    if isinstance(pool, (QuantPages, JQuantPages)):
        return [np.asarray(pool.values), np.asarray(pool.scales)]
    return [np.asarray(pool.float() if isinstance(pool, torch.Tensor)
                       else pool.astype(jnp.float32))]


@pytest.mark.parametrize("quant", [False, True])
def test_paged_steps_match_reference(quant):
    """Two chunked-prefill calls (ragged per-slot chunks, one slot idle in
    the second) then three fused decode steps (one slot not live)."""
    cfg = toy_config()
    tcfg = _mirror(cfg)
    params = jmodel_api(cfg).init(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     tcfg, "cpu")
    jp, tp, bt, bs = _step_inputs(cfg, quant)
    rng = np.random.default_rng(4)
    start = np.zeros(3, np.int32)
    logit_tol = 2e-3 if quant else 1e-4
    for cl in ((8, 5, 3), (6, 8, 0)):
        toks = rng.integers(0, cfg.vocab_size, size=(3, 8)).astype(np.int32)
        cl = np.asarray(cl, np.int32)
        jl, jc = jtransformer.prefill_chunk_paged(
            params, cfg, {"tokens": jnp.asarray(toks)},
            {"k": jp["k"], "v": jp["v"], "len": jnp.asarray(start)},
            jnp.asarray(bt), chunk_len=jnp.asarray(cl), block_size=bs,
            impl="ref")
        tl, tc = transformer.prefill_chunk_paged(
            tparams, tcfg, {"tokens": _t(toks)},
            {"k": tp["k"], "v": tp["v"], "len": _t(start)}, _t(bt),
            chunk_len=_t(cl), block_size=bs)
        live = cl > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=logit_tol, rtol=0)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
        jp = {"k": jc["k"], "v": jc["v"]}
        start = np.asarray(jc["len"])
    live = np.array([True, True, False])
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, size=(3,)).astype(np.int32)
        jl, jc = jtransformer.decode_step_paged(
            params, cfg, jnp.asarray(tok),
            {"k": jp["k"], "v": jp["v"], "len": jnp.asarray(start)},
            jnp.asarray(bt), jnp.asarray(live), block_size=bs, impl="ref")
        tl, tc = transformer.decode_step_paged(
            tparams, tcfg, _t(tok),
            {"k": tp["k"], "v": tp["v"], "len": _t(start)}, _t(bt),
            _t(live), block_size=bs)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=logit_tol, rtol=0)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
        jp = {"k": jc["k"], "v": jc["v"]}
        start = np.asarray(jc["len"])
    for n in "kv":
        assert tc[n] is tp[n]                    # pools updated in place
        for g, w in zip(_pool_arrays(tp[n]), _pool_arrays(jp[n])):
            if g.dtype == np.int8:               # one rounding step at most
                assert np.abs(g[:, :-1].astype(int)
                              - w[:, :-1].astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(g[:, :-1], w[:, :-1], atol=1e-6,
                                           rtol=1e-5)


def test_bf16_steps_match_reference():
    """bf16 weights and pools.  The first layer's K/V rows come from the
    same bf16 embedding, norm and projection in both frameworks and agree
    exactly.  From the second layer on, the frameworks round the first
    layer's attention and MLP activations to bf16 at different places, so
    rows and logits differ by a few bf16 steps (2**-6 at magnitude 2):
    held to 6e-2."""
    cfg = toy_config(dtype="bfloat16", param_dtype="bfloat16")
    tcfg = _mirror(cfg)
    params = jmodel_api(cfg).init(jax.random.PRNGKey(5), cfg)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                     tcfg, "cpu")
    assert tparams["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    jp, tp, bt, bs = _step_inputs(cfg, False)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(3, 8)).astype(np.int32)
    cl = np.asarray((8, 3, 6), np.int32)
    start = np.zeros(3, np.int32)
    jl, jc = jtransformer.prefill_chunk_paged(
        params, cfg, {"tokens": jnp.asarray(toks)},
        {"k": jp["k"], "v": jp["v"], "len": jnp.asarray(start)},
        jnp.asarray(bt), chunk_len=jnp.asarray(cl), block_size=bs,
        impl="ref")
    tl, _ = transformer.prefill_chunk_paged(
        tparams, tcfg, {"tokens": _t(toks)},
        {"k": tp["k"], "v": tp["v"], "len": _t(start)}, _t(bt),
        chunk_len=_t(cl), block_size=bs)
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)),
                               atol=6e-2, rtol=0)
    for n in "kv":
        g = tp[n].float().numpy()[:, :-1]
        w = np.asarray(jc[n].astype(jnp.float32))[:, :-1]
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_allclose(g[1:], w[1:], atol=6e-2, rtol=0)


def test_registry_unported_families_raise():
    """(The name predates the hybrid port.)  Every family of the reference
    resolves, hybrid too; an unknown family still raises."""
    assert model_api(toy_config()) is not None
    for fam in ("ssm", "audio", "moe", "vlm", "hybrid"):
        assert model_api(_mirror(toy_config(family=fam))) is not None
    with pytest.raises(KeyError, match="unknown model family"):
        model_api(_mirror(toy_config(family="retnet")))


def test_init_keeps_reference_tree():
    cfg = toy_config()
    jp = jax.tree.map(np.asarray, jmodel_api(cfg).init(
        jax.random.PRNGKey(0), cfg))
    tp = transformer.init(0, _mirror(cfg), device="cpu")
    jpaths = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    tpaths = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert tpaths == jpaths
    assert tp["blocks"]["attn"]["wq"].shape[0] == cfg.num_layers
