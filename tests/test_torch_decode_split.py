"""The dense decode kernel's split over keys, on the CPU: the wrapper's
split planner (``decode_attention.plan_splits``) and a plain emulation of
the kernel's split and merge (``ref.decode_attention_split_ref``) against
the plain version and the reference's Pallas kernel in interpret mode.

The emulation computes a partial state (m, l, acc) per split over its
visible keys and merges the splits that overlap a slot's visible range in
ascending split order, as ``csrc/decode_attention.cu`` does; the cases put
a window's lower edge inside a split, splits wholly before or past a
slot's visible keys, slots of length 0, G = 1, 4, 8 and 16 and D = 64,
112, 128 and 256.  Inputs are made with numpy from a seed; everything is
float32, compared at atol = rtol = 1e-5 (the merge sums in another order
than one softmax over all keys; the Pallas kernel also blocks the keys).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import decode_attention, ref

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1e-5
H100_SMS = 132

# (B, Hkv, S, D): the served shapes (PERF.md §6, #5) and small and odd ones
PLAN_SHAPES = [
    (8, 2, 4096, 128),        # mixtral's ring, tp = 4 shard
    (8, 8, 4096, 128),        # the ring at tp = 1
    (512, 1, 512, 256),       # paligemma-3b's MQA dense view
    (128, 5, 1500, 64),       # whisper's cross-attention, tp = 4 shard
    (128, 20, 1500, 64),      # whisper's cross-attention, tp = 1
    (128, 32, 256, 112),      # zamba2-7b's dense view
    (16, 8, 700, 128), (1, 1, 1, 64), (1, 1, 0, 64), (3, 2, 33, 112),
    (1, 1, 100_000, 256), (2, 3, 257, 64), (64, 4, 8192, 128),
    (4096, 1, 64, 64), (1, 16, 4095, 256),
]


@pytest.mark.parametrize("sms", [1, 16, H100_SMS])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_splits_covers_the_keys_once(shape, sms):
    """nsplit splits of split_len keys cover [0, S) exactly once (the last
    may be short, none is empty), each a whole number of TILE-key tiles and
    at least SPLIT_BYTES of K and V when there is more than one; the count
    is 1 where B * Hkv alone gives the card FILL_PER_SM items an SM."""
    B, Hkv, S, D = shape
    nsplit, split_len = decode_attention.plan_splits(B, Hkv, S, D, sms)
    assert nsplit >= 1 and split_len >= 1
    covered = np.zeros(max(S, 1), np.int64)
    for i in range(nsplit):
        lo, hi = i * split_len, min((i + 1) * split_len, max(S, 1))
        assert lo < hi, f"split {i} of {nsplit} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if nsplit > 1:
        assert split_len % decode_attention.TILE == 0
        assert 4 * D * split_len >= decode_attention.SPLIT_BYTES
    else:
        assert split_len == max(S, 1)
    if B * Hkv >= decode_attention.FILL_PER_SM * sms:
        assert nsplit == 1


def test_plan_splits_is_a_function_of_the_shapes_alone():
    """The planner takes B, Hkv, S, D and the SM count and nothing of the
    slots' lengths, so a call needs no device-to-host read and can be
    captured in a CUDA graph; the served shapes split as PERF.md states."""
    params = list(inspect.signature(decode_attention.plan_splits).parameters)
    assert params == ["B", "Hkv", "S", "D", "sms"]
    plan = lambda *s: decode_attention.plan_splits(*s, H100_SMS)
    assert plan(8, 2, 4096, 128) == (32, 128)
    assert plan(8, 8, 4096, 128) == (32, 128)
    assert plan(512, 1, 512, 256) == (8, 64)
    assert plan(128, 5, 1500, 64) == (5, 320)
    assert plan(128, 20, 1500, 64) == (1, 1500)
    assert plan(128, 32, 256, 112) == (1, 256)


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(B, Hq, D), f(B, S, Hkv, D), f(B, S, Hkv, D)


def _t(a):
    return torch.from_numpy(np.array(a))


SPLIT_CASES = {
    # id: (B, S, Hq, Hkv, D, lengths, window, nsplit, split_len)
    # a window's lower edge inside a split, lengths inside splits
    "window_edge_in_split": (4, 100, 4, 2, 64, [100, 70, 45, 33], 40, 4, 32),
    # splits wholly past a short slot's keys and wholly before a window
    "splits_outside_range": (3, 128, 4, 4, 64, [5, 128, 96], 20, 4, 32),
    # slots of length 0 beside full ones: zeros, no NaN
    "empty_slots": (4, 64, 8, 2, 128, [0, 64, 0, 1], None, 2, 32),
    # lengths one below, at and one above a split boundary
    "split_boundaries": (4, 96, 16, 1, 112, [31, 32, 33, 64], None, 3, 32),
    "mqa_d256": (3, 80, 8, 1, 256, [80, 17, 0], None, 3, 32),
    "gqa16_d128_window": (2, 70, 16, 1, 128, [70, 40], 25, 3, 32),
    "g1_d112": (3, 50, 2, 2, 112, [50, 0, 13], None, 2, 32),
    "one_split": (2, 40, 4, 1, 64, [40, 9], 7, 1, 40),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_merge_emulation_matches_plain(case):
    """The split-and-merge emulation equals the one-softmax plain version,
    empty slots give zeros, and nothing is NaN."""
    B, S, Hq, Hkv, D, lens, window, nsplit, split_len = SPLIT_CASES[case]
    q, kc, vc = _inputs(B, S, Hq, Hkv, D, seed=len(case))
    lens_t = _t(np.asarray(lens, np.int32))
    got = ref.decode_attention_split_ref(_t(q), _t(kc), _t(vc), lens_t,
                                         nsplit=nsplit, split_len=split_len,
                                         window=window)
    want = ref.decode_attention_ref(_t(q), _t(kc), _t(vc), lens_t,
                                    window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert not got[lens_t == 0].any()


# each head dim once: D = 64 (G = 2), 128 (G = 4), 112 (G = 16), 256 (G = 8)
PALLAS_CASES = ["window_edge_in_split", "empty_slots", "split_boundaries",
                "mqa_d256"]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_split_merge_emulation_matches_pallas(case):
    """The emulation against the reference's Pallas decode kernel in
    interpret mode (16-key blocks), on the same float32 inputs."""
    B, S, Hq, Hkv, D, lens, window, nsplit, split_len = SPLIT_CASES[case]
    q, kc, vc = _inputs(B, S, Hq, Hkv, D, seed=len(case))
    lens_np = np.asarray(lens, np.int32)
    got = ref.decode_attention_split_ref(_t(q), _t(kc), _t(vc), _t(lens_np),
                                         nsplit=nsplit, split_len=split_len,
                                         window=window)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(lens_np),
                                   window=window, k_block=16,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("shape", [(2, 1, 512, 8, 256), (3, 2, 900, 4, 64),
                                   (2, 2, 700, 16, 128)], ids=str)
def test_planned_splits_match_plain(shape):
    """The planner's own splits on an H100's SM count (several splits at
    these item counts), with ragged lengths and a window."""
    B, Hkv, S, G, D = shape
    nsplit, split_len = decode_attention.plan_splits(B, Hkv, S, D, H100_SMS)
    assert nsplit > 1
    q, kc, vc = _inputs(B, S, G * Hkv, Hkv, D, seed=S)
    lens = _t(np.linspace(0, S, B).astype(np.int32))
    for window in (None, split_len + 5):
        got = ref.decode_attention_split_ref(_t(q), _t(kc), _t(vc), lens,
                                             nsplit=nsplit,
                                             split_len=split_len,
                                             window=window)
        want = ref.decode_attention_ref(_t(q), _t(kc), _t(vc), lens,
                                        window=window)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
