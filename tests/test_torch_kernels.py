"""Paged-attention parity between the PyTorch port and the JAX reference.

The port's plain versions of its four kernels (``repro_torch.kernels.ref``,
what the CPU path runs) are held against the reference's Pallas kernels,
run as the reference's own tests run them on the CPU: ``interpret=True``
for the bf16-page pair and ``ops.*(impl="pallas_interpret")`` for the int8
pair.  Both sides get the same pages, tables and int8 + scale pools, made
with numpy from a seed; outputs agree to 1e-5 in f32 (the two frameworks
sum in different orders).  The CUDA kernels themselves need the card:
``test_torch_cuda.py`` holds them against the same plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels.decode_attention import (
    paged_chunk_prefill_attention_pallas, paged_decode_attention_pallas)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quant import QuantPages, dequantize, quantize

ATOL = 1e-5


def _pools(seed, *, B=3, nblk=4, bs=8, Hkv=2, D=16, lens):
    """Pages (P, bs, Hkv, D) with a trash page last; each slot's table
    holds its own shuffled pages for the blocks below ``lens`` and the
    trash page past them."""
    rng = np.random.default_rng(seed)
    P = B * nblk + 1
    kp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    phys = rng.permutation(P - 1).reshape(B, nblk).astype(np.int32)
    used = -(-np.asarray(lens) // bs)
    bt = np.where(np.arange(nblk)[None] < used[:, None], phys, P - 1)
    return kp, vp, bt.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant_both(x):
    """The same int8 pool for both sides: the reference's quantize, whose
    values and scales the port receives verbatim."""
    qv, qs = jquant.quantize(jnp.asarray(x))
    jq = jquant.QuantPages(qv, qs)
    tq = QuantPages(_t(np.asarray(qv)), _t(np.asarray(qs)))
    return jq, tq


LENS = (5, 17, 32)          # ragged: inside, across and at page boundaries


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_plain_matches_pallas(seed):
    kp, vp, bt = _pools(seed, lens=LENS)
    q = np.random.default_rng(seed + 7).normal(size=(3, 4, 16)).astype(
        np.float32)
    lens = np.asarray(LENS, np.int32)
    want = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True)
    got = ref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                         _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    # ops dispatch on CPU tensors is exactly the plain version
    via_ops = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                         _t(lens))
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_quant_plain_matches_pallas(seed):
    kp, vp, bt = _pools(seed, lens=LENS)
    q = np.random.default_rng(seed + 7).normal(size=(3, 4, 16)).astype(
        np.float32)
    lens = np.asarray(LENS, np.int32)
    jk, tk = _quant_both(kp)
    jv, tv = _quant_both(vp)
    want = jops.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        impl="pallas_interpret")
    got = ops.paged_decode_attention(_t(q), tk, tv, _t(bt), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


# The edges the card's decode kernels must get right, held here on the
# plain version the card compares them with (nblk * bs = 32): one query
# head per kv head, an odd group (6 over 2), a dead slot, a slot that fills
# its whole table, a slot of one key.  id: (Hq, Hkv, lens).
DECODE_EDGES = {
    "g1": (2, 2, LENS),
    "g3": (6, 2, LENS),
    "dead_slot": (4, 2, (5, 0, 32)),
    "full_budget": (4, 2, (32, 32, 17)),
    "one_key": (4, 2, (1, 9, 1)),
}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(DECODE_EDGES))
def test_paged_decode_edges_plain_matches_pallas(case, quant):
    Hq, Hkv, lens = DECODE_EDGES[case]
    kp, vp, bt = _pools(9, Hkv=Hkv, lens=lens)
    q = np.random.default_rng(17).normal(size=(3, Hq, 16)).astype(
        np.float32)
    lens = np.asarray(lens, np.int32)
    if quant:
        jk, tk = _quant_both(kp)
        jv, tv = _quant_both(vp)
        want = jops.paged_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
            impl="pallas_interpret")
    else:
        tk, tv = _t(kp), _t(vp)
        want = paged_decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lens), interpret=True)
    got = ops.paged_decode_attention(_t(q), tk, tv, _t(bt), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    # a dead slot's rows are zeros on both sides, not NaN
    assert not got[lens == 0].any()


# start + chunk_len crosses pages; slot 2 has chunk_len 0 (a dead row of
# the verify contract)
CHUNK = dict(start=(4, 11, 9), chunk_len=(8, 6, 0), T=8)


def _chunk_inputs(seed):
    end = np.add(CHUNK["start"], CHUNK["chunk_len"])
    kp, vp, bt = _pools(seed, lens=np.maximum(end, 1))
    q = np.random.default_rng(seed + 11).normal(
        size=(3, CHUNK["T"], 4, 16)).astype(np.float32)
    return (q, kp, vp, bt, np.asarray(CHUNK["start"], np.int32),
            np.asarray(CHUNK["chunk_len"], np.int32))


def _alive(out, chunk_len):
    """Rows at or past chunk_len are dead: callers discard them."""
    rows = np.arange(out.shape[1])[None] < np.asarray(chunk_len)[:, None]
    return np.where(rows[..., None, None], out, 0.0)


@pytest.mark.parametrize("prefix_len", [0, 6])
def test_paged_chunk_plain_matches_pallas(prefix_len):
    q, kp, vp, bt, start, cl = _chunk_inputs(3)
    want = paged_chunk_prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(start), jnp.asarray(cl), prefix_len=prefix_len,
        interpret=True)
    got = ref.paged_chunk_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                        _t(start), _t(cl),
                                        prefix_len=prefix_len)
    np.testing.assert_allclose(_alive(got.numpy(), cl),
                               _alive(np.asarray(want), cl), atol=ATOL,
                               rtol=ATOL)
    # the port defines dead rows as zeros (no NaN), like the reference ref
    assert not got[2].any()
    via_ops = ops.paged_chunk_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                        _t(start), _t(cl),
                                        prefix_len=prefix_len)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("prefix_len", [0, 6])
def test_paged_chunk_quant_plain_matches_pallas(prefix_len):
    q, kp, vp, bt, start, cl = _chunk_inputs(4)
    jk, tk = _quant_both(kp)
    jv, tv = _quant_both(vp)
    want = jops.paged_chunk_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(start),
        jnp.asarray(cl), prefix_len=prefix_len, impl="pallas_interpret")
    got = ops.paged_chunk_attention(_t(q), tk, tv, _t(bt), _t(start),
                                    _t(cl), prefix_len=prefix_len)
    np.testing.assert_allclose(_alive(got.numpy(), cl),
                               _alive(np.asarray(want), cl), atol=ATOL,
                               rtol=ATOL)


def test_paged_verify_requires_per_slot_lengths():
    q, kp, vp, bt, start, cl = _chunk_inputs(5)
    got = ops.paged_verify_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(start), _t(cl))
    want = ops.paged_chunk_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(start), _t(cl))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="per-slot"):
        ops.paged_verify_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                   _t(start), 4)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_quantize_is_bit_identical_to_reference(scale):
    rng = np.random.default_rng(int(scale * 10))
    x = (rng.normal(size=(64, 16)) * scale).astype(np.float32)
    x[0] = 0.0                                   # the EPS floor
    x[1, :] = 0.5 * np.float32(scale)            # exact .5 multiples: ties
    x[1, 0] = 127 * np.float32(scale)
    jv, js = jquant.quantize(jnp.asarray(x))
    tv, ts = quantize(_t(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize(tv, ts).numpy(), np.asarray(jquant.dequantize(jv, js)))


def test_quant_pages_index_and_proxy_shape():
    qp = QuantPages(*quantize(torch.ones(3, 5, 4, 2, 8)))
    assert qp.shape == (3, 5, 4, 2, 8) and qp.ndim == 5
    assert qp.dtype == torch.int8
    layer = qp[1]
    assert layer.shape == (5, 4, 2, 8) and layer.scales.shape == (5, 4, 2)
    layer.values.zero_()                         # a view into the pool
    assert not qp.values[1].any() and qp.values[0].all()


# Shapes the chunk kernel's 64-row tiles and 64-key tiles meet off their
# edges on the card (tests/test_torch_cuda.py), at toy size here: T off
# any tile, starts off the 8-token page, a dead slot among four, a prefix
# past the first rows, GQA 4/2.
CHUNK_ODD = {
    "t13_prefix10": dict(T=13, start=(5, 13, 0, 19), chunk_len=(13, 9, 0, 2),
                         prefix_len=10),
    "t17_no_prefix": dict(T=17, start=(0, 3, 0, 11), chunk_len=(17, 17, 0, 5),
                          prefix_len=0),
}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CHUNK_ODD))
def test_paged_chunk_odd_shapes_plain_matches_pallas(case, quant):
    c = CHUNK_ODD[case]
    start = np.asarray(c["start"], np.int32)
    cl = np.asarray(c["chunk_len"], np.int32)
    kp, vp, bt = _pools(5, B=4, lens=np.maximum(start + cl, 1))
    q = np.random.default_rng(13).normal(size=(4, c["T"], 4, 16)).astype(
        np.float32)
    kw = dict(prefix_len=c["prefix_len"])
    if quant:
        jk, tk = _quant_both(kp)
        jv, tv = _quant_both(vp)
        want = jops.paged_chunk_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(start),
            jnp.asarray(cl), impl="pallas_interpret", **kw)
    else:
        tk, tv = _t(kp), _t(vp)
        want = paged_chunk_prefill_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(start), jnp.asarray(cl),
            interpret=True, **kw)
    got = ops.paged_chunk_attention(_t(q), tk, tv, _t(bt), _t(start),
                                    _t(cl), **kw)
    np.testing.assert_allclose(_alive(got.numpy(), cl),
                               _alive(np.asarray(want), cl), atol=ATOL,
                               rtol=ATOL)
    for b, n in enumerate(cl):
        assert not got[b, n:].any()
