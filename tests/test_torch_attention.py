"""Flash attention (forward) and dense decode attention: the PyTorch
port's plain versions against the JAX reference's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as the reference's
own tests run them; inputs are made with numpy from a seed.  Everything is
float32, compared at atol = rtol = 1e-5 (the frameworks sum in other
orders; the Pallas kernels also block the keys).  On the CPU ``ops``
dispatches to these plain versions, which ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernels against on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1e-5


def _qkv(B, Lq, Lk, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(B, Lq, Hq, D), f(B, Lk, Hkv, D), f(B, Lk, Hkv, D)


def _t(a):
    return torch.from_numpy(np.array(a))


FLASH_CASES = {
    # id: ((B, Lq, Lk, Hq, Hkv, D), mask options)
    "causal": ((2, 40, 40, 4, 4, 16), dict(causal=True)),
    "full_ragged_blocks": ((1, 37, 53, 4, 4, 16), dict(causal=False)),
    "gqa": ((2, 33, 33, 6, 2, 16), dict(causal=True)),
    "window": ((1, 50, 50, 4, 2, 16), dict(causal=True, window=7)),
    "prefix": ((1, 50, 50, 4, 2, 16), dict(causal=True, prefix_len=12)),
    "window_prefix": ((1, 50, 50, 4, 2, 16),
                      dict(causal=True, window=5, prefix_len=12)),
    "q_offset_kv_len": ((1, 20, 60, 4, 2, 16),
                        dict(causal=True, q_offset=30, kv_len=45)),
    "masked_rows": ((1, 30, 24, 4, 4, 16),
                    dict(causal=True, window=4, kv_len=10)),
    "cross_shape": ((1, 24, 64, 4, 4, 32), dict(causal=False)),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_ref_matches_pallas(case):
    """Every mask option, GQA, lengths that are not multiples of the
    Pallas blocks (16 here), and rows that see no key (out 0, lse
    -NEG_INF).  Both the output and the log-sum-exp."""
    shape, kw = FLASH_CASES[case]
    q, k, v = _qkv(*shape, seed=len(case))
    got, got_lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw)
    want, want_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=16,
        k_block=16, return_lse=True, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)
    exact = jref.mha_exact(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exact), atol=TOL,
                               rtol=TOL)
    if case == "masked_rows":
        dead = 10 - 1 + 4                  # rows at or past this see nothing
        assert not got[:, dead:].any()
        assert (got_lse[:, dead:] == -ref.NEG_INF).all()
        assert got[:, :dead].abs().sum(-1).min() > 0
    torch.testing.assert_close(
        ops.flash_attention(_t(q), _t(k), _t(v), **kw), got, atol=0, rtol=0)


def test_flash_attention_prefix_past_the_query_tile_follows_mha_exact():
    """A prefix that reaches past the last row of a Pallas query tile: the
    Pallas block test (flash_attention.py:58) skips that key block, so the
    Pallas kernel drops prefix keys that its own oracle ``mha_exact`` sees.
    The port follows the element mask, i.e. ``mha_exact``."""
    q, k, v = _qkv(1, 48, 48, 2, 1, 16, seed=5)
    kw = dict(causal=True, prefix_len=40)
    got, _ = ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw)
    exact = jref.mha_exact(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exact), atol=TOL,
                               rtol=TOL)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_block=16, k_block=16,
                                    interpret=True, **kw)
    assert np.abs(np.asarray(pallas)[:, :16] - got.numpy()[:, :16]).max() \
        > 1e-3
    np.testing.assert_allclose(got.numpy()[:, 32:],
                               np.asarray(pallas)[:, 32:], atol=TOL,
                               rtol=TOL)


DECODE_CASES = {
    # id: (B, S, Hq, Hkv, D, lengths, window)
    "ragged_with_empty": (4, 70, 4, 4, 16, [70, 1, 0, 33], None),
    "gqa": (3, 50, 8, 2, 16, [17, 50, 4], None),
    "window": (3, 64, 4, 2, 16, [64, 10, 0], 9),
    "scalar_len": (2, 40, 4, 4, 32, 25, None),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_ref_matches_pallas(case):
    """Ragged per-slot lengths, a zero length (zeros out), a trailing
    window, GQA, a scalar length for every slot."""
    B, S, Hq, Hkv, D, lens, window = DECODE_CASES[case]
    rng = np.random.default_rng(len(case))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, kc, vc = f(B, Hq, D), f(B, S, Hkv, D), f(B, S, Hkv, D)
    lens_np = np.asarray(lens, np.int32)
    got = ref.decode_attention_ref(_t(q), _t(kc), _t(vc), _t(lens_np),
                                   window=window)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(lens_np),
                                   window=window, k_block=16,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if lens_np.ndim:
        assert not got[lens_np == 0].any()
    torch.testing.assert_close(
        ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens_np),
                             window=window), got, atol=0, rtol=0)
