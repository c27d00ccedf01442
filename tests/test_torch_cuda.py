"""The port's CUDA kernels against their plain versions, on the card.

Skips on a machine without an NVIDIA GPU (the kernels have no CPU mode).
This file imports neither JAX nor ``conftest`` (which imports JAX), so a
machine with a card and without JAX runs it with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Outputs are compared in f32 with atol = rtol = 1.6e-2, about two bf16
steps of the output: the kernels read bf16 (or int8) K/V and write bf16,
and sum in another order than the plain version.  The SSD scan's f32
final state is held to atol = rtol = 1e-3 of its largest magnitude (f32
sums in another order over up to 256-token chunks), on both of its copy
routes (16-byte copies for rows that start on 16 bytes, 4-byte copies
otherwise), each case checking the route it takes.  Flash attention's
f32 log-sum-exp is held to 1e-3 of its magnitude (atol = rtol = 1e-3;
rows that see nothing must hold -NEG_INF), and its bf16 output also at
every sequence position to 1e-2 of that position's norm plus 1e-5 an
element, as the backward's gradients below.  The grouped GEMM's bf16 output
is held to the f32 product of the same bf16 values with atol = rtol =
1.6e-2 (one rounding to bf16, sums in another order), on both of its
routes (TMA with wgmma, and mma.sync), each case checking the route it
takes; its float32 instance to atol = rtol = 1e-3 (f32 sums over up to
14,336 terms in another order).  The paged chunk kernels are also held
at every row to 1e-2 of that row's norm plus 1e-5 an element, and the
paged and dense decode kernels at every (slot, head) row the same way.
The dense chunked-prefill kernel's bf16 output is held to its plain
version on the same bf16 inputs with atol = rtol = 1.6e-2 and, at every
row, to 1e-2 of that row's norm plus 1e-5 an element.
The flash backward's bf16 dq, dk and dv are held to its plain version on
the same bf16 inputs (which rounds dS and P to bf16 where the kernel
does) with atol = rtol = 1.6e-2: sums in another order over up to a few
hundred keys or queries, and one more bf16 rounding on output.  They are
also held at every sequence position to 1e-2 of that position's norm (over
the batch, heads and head dim) plus 1e-5 an element, which scales with the
gradients' size where atol does not.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (build, chunk_attention, decode_attention,
                                 flash_attention, flash_attention_bwd,
                                 grouped_matmul, ops, paged_attention, ref,
                                 ssd_scan)
from repro_torch.kernels.quant import QuantPages, quantize

# one intra-op thread: xdist runs six workers, each of which would
# otherwise start a pool the size of the machine
torch.set_num_threads(1)

TOL = 1.6e-2
LSE_TOL = 1e-3
ROW_REL_TOL = 1e-2
ROW_FLOOR = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _pools(gen, *, B, nblk, bs, Hkv, D, lens, quant):
    P1 = B * nblk + 1
    pools = []
    for _ in range(2):
        x = torch.randn(P1, bs, Hkv, D, generator=gen, device=gen.device)
        pools.append(QuantPages(*quantize(x)) if quant
                     else x.to(torch.bfloat16))
    rng = np.random.default_rng(0)
    phys = rng.permutation(P1 - 1).reshape(B, nblk)
    used = -(-np.asarray(lens) // bs)
    bt = np.where(np.arange(nblk)[None] < used[:, None], phys, P1 - 1)
    return (pools[0], pools[1],
            torch.from_numpy(bt.astype(np.int32)).to(gen.device))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads", [(36, 36, 64), (24, 8, 128)],
                         ids=["minicpm", "gqa"])
def test_cuda_kernels_match_plain(cuda_device, quant, heads):
    Hq, Hkv, D = heads
    B, nblk, bs = 4, 8, 32
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    lens = (1, 45, 200, 256)        # in, across and at page boundaries
    k, v, tables = _pools(gen, B=B, nblk=nblk, bs=bs, Hkv=Hkv, D=D,
                          lens=lens, quant=quant)
    before = dict(paged_attention.launches)
    q = torch.randn(B, Hq, D, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = ops.paged_decode_attention(q, k, v, tables, cache_len)
    want = ref.paged_decode_attention_ref(q.float(), k, v, tables,
                                          cache_len)
    torch.testing.assert_close(got.float(), want, atol=TOL, rtol=TOL)
    T = 40
    qc = torch.randn(B, T, Hq, D, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    start = torch.tensor((0, 5, 160, 216), dtype=torch.int32,
                         device=cuda_device)
    cl = torch.tensor((1, 40, 0, 40), dtype=torch.int32, device=cuda_device)
    for prefix_len in (0, 20):
        got = ops.paged_chunk_attention(qc, k, v, tables, start, cl,
                                        prefix_len=prefix_len)
        want = ref.paged_chunk_attention_ref(qc.float(), k, v, tables,
                                             start, cl,
                                             prefix_len=prefix_len)
        torch.testing.assert_close(got.float(), want, atol=TOL, rtol=TOL)
        assert not got[2].any()                   # the dead slot: zeros
    torch.cuda.synchronize()
    kind = "_quant" if quant else ""
    after = paged_attention.launches
    assert after["paged_decode_attention" + kind] \
        == before["paged_decode_attention" + kind] + 1
    assert after["paged_chunk_prefill_attention" + kind] \
        == before["paged_chunk_prefill_attention" + kind] + 2
    print({n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
           for n, log in build.build_log.items()})


PAGED_CHUNK_ODD = {    # (B, T, Hq, Hkv, D), start, chunk_len, prefix_len
    "t13": ((4, 13, 36, 36, 64), [5, 37, 0, 77], [13, 13, 0, 9], 0),
    "t65": ((4, 65, 36, 36, 64), [3, 37, 0, 130], [65, 60, 0, 1], 0),
    "prefix_100": ((4, 128, 36, 36, 64), [0, 40, 100, 120], [128, 90, 0, 56],
                   100),
    "gqa_32_8_d128": ((4, 65, 32, 8, 128), [37, 0, 0, 100], [65, 64, 0, 20],
                      20),
    "one_slot_path": ((1, 128, 36, 36, 64), [64], [128], 0),
    # prefix-cache hits: chunks from mid-page (a 150-token template's
    # partial tail) and a full-prompt hit's one row in a 32-row bucket
    "prefix_hit": ((4, 32, 36, 36, 64), [150, 150, 0, 189], [32, 8, 0, 1],
                   0),
}


def _verify_starts():
    """512 ragged starts with room for 5 rows, the first 8 around page
    ends."""
    start = np.random.default_rng(2).integers(0, 252, 512)
    start[:8] = (0, 27, 28, 31, 32, 60, 100, 251)
    return start.tolist()


# speculative decoding's verify launch: 512 slots, T = k + 1 = 5 rows,
# minitron-4b's 24/8 heads at D = 128; 32 slots speculating (chunk_len 5,
# the rest 0), then all 512
PAGED_CHUNK_ODD.update({
    "verify_32_of_512": ((512, 5, 24, 8, 128), _verify_starts(),
                         [5 if b % 16 == 0 else 0 for b in range(512)], 0),
    "verify_512_of_512": ((512, 5, 24, 8, 128), _verify_starts(),
                          [5] * 512, 0),
})

# paligemma-3b's chunks (8 query heads on 1 kv head, D = 256): first chunks
# carry the 256-row image prefix with a text bucket (T = 288 and 320 from
# start 0, prefix_len 256, one of them ragged), a text chunk from 288 and
# a ragged 13-row one past the prefix, with a dead slot
PAGED_CHUNK_ODD.update({
    "vlm_first_t288": ((2, 288, 8, 1, 256), [0, 0], [288, 262], 256),
    "vlm_first_t320": ((1, 320, 8, 1, 256), [0], [320], 256),
    "vlm_text_t64": ((2, 64, 8, 1, 256), [288, 300], [64, 40], 0),
    "vlm_t13": ((3, 13, 8, 1, 256), [288, 0, 450], [13, 0, 9], 0),
})

# zamba2-7b's shared attention (32 query heads on 32 kv heads, D = 112, an
# instance of its own): a 128-row chunk from 0 and one from mid-page, a
# ragged 13-row one with a dead slot, and GQA 8/2 with a prefix
# the head-sharded step's shards: phase 3's 128-row bucket at 9 and 18
# heads (minicpm-2b over 4 and 2 shards) and mistral-large-123b's 24/2 at
# D = 128 (over 4)
PAGED_CHUNK_ODD.update({
    "tp4_minicpm_t128": ((1, 128, 9, 9, 64), [64], [128], 0),
    "tp2_minicpm_t128": ((1, 128, 18, 18, 64), [64], [128], 0),
    "tp4_mistral_t65": ((2, 65, 24, 2, 128), [37, 0], [65, 64], 0),
})

PAGED_CHUNK_ODD.update({
    "zamba_t128_d112": ((2, 128, 32, 32, 112), [0, 70], [128, 100], 0),
    "zamba_t13_d112": ((3, 13, 32, 32, 112), [5, 0, 200], [13, 0, 9], 0),
    "gqa_8_2_d112": ((2, 65, 8, 2, 112), [37, 0], [65, 64], 20),
})


def _paged_chunk_case(dev, case, quant, seed):
    (B, T, Hq, Hkv, D), start, cl, prefix = PAGED_CHUNK_ODD[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    end = np.add(start, cl)
    nblk = max(8, -(-int(end.max()) // 32))
    k, v, tables = _pools(gen, B=B, nblk=nblk, bs=32, Hkv=Hkv, D=D,
                          lens=np.maximum(end, 1), quant=quant)
    q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(
        torch.bfloat16)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    n = torch.tensor(cl, dtype=torch.int32, device=dev)
    run = lambda: ops.paged_chunk_attention(q, k, v, tables, st, n,
                                            prefix_len=prefix)
    want = ref.paged_chunk_attention_ref(q.float(), k, v, tables, st, n,
                                         prefix_len=prefix)
    return run, want, cl


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(PAGED_CHUNK_ODD))
def test_cuda_paged_chunk_odd_shapes_match_plain(cuda_device, case, quant):
    """The chunk kernels (64-row, 64-key tiles; 32-key at D = 256) off
    their tiles: T = 13 and 65, starts off the 32-token page and off 64, a
    dead slot among four, a prefix past the first row tile, GQA 32/8 at
    D = 128, the verify launch's 512 slots of 5 rows, and paligemma-3b's
    MQA at D = 256 with its 256-row prefix; held by atol and at every row
    by its norm; rows past chunk_len are zeros."""
    run, want, cl = _paged_chunk_case(cuda_device, case, quant, 11)
    kind = "_quant" if quant else ""
    before = paged_attention.launches["paged_chunk_prefill_attention" + kind]
    out = run()
    torch.cuda.synchronize()
    assert paged_attention.launches["paged_chunk_prefill_attention" + kind] \
        == before + 1
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    _assert_rows_close("out", out, want)
    for b, c in enumerate(cl):
        assert not out[b, c:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_cuda_paged_chunk_is_bit_reproducible(cuda_device, quant):
    """Repeated launches on the same inputs give bit-identical outputs:
    each row has one owner block and a fixed order of sums."""
    for case in ("gqa_32_8_d128", "vlm_first_t288", "zamba_t128_d112"):
        run, _, _ = _paged_chunk_case(cuda_device, case, quant, 12)
        first = run()
        assert all(torch.equal(first, run()) for _ in range(3))


def _path_lens(B):
    """Phase 3's decode lengths: B slots, the first 32 live at their
    lengths half-way through generation (26-220 keys), the rest empty."""
    lens = np.zeros(B, np.int64)
    lens[:32] = np.linspace(6, 200, 32).astype(int) + 20
    return tuple(lens.tolist())


def _vlm_lens(B):
    """paligemma-3b's decode lengths: B slots, the first 32 live at
    262-496 keys (the 256-row prefix, a prompt and the tokens so far), the
    rest empty."""
    lens = np.zeros(B, np.int64)
    lens[:32] = np.linspace(262, 496, 32).astype(int)
    return tuple(lens.tolist())


def _two_pass_lens():
    """1,100 slots, more than one 512-slot pass of the kernel's length
    scan: live slots at both ends of each pass, the rest empty."""
    lens = np.zeros(1100, np.int64)
    lens[[0, 511, 512, 1023, 1024, 1099]] = (64, 1, 33, 17, 64, 50)
    return tuple(lens.tolist())


EDGE_LENS = (0, 1, 31, 32, 33, 256)     # 256 = nblk * bs: the whole budget
# id: (B, Hq, Hkv, D, nblk, bs), lengths.  Blocks past each length map to
# the trash page.
PAGED_DECODE_CASES = {
    **{f"g{G}_d{D}": ((6, Hq, Hkv, D, 8, 32), EDGE_LENS)
       for G, Hq, Hkv in ((1, 16, 16), (3, 24, 8), (4, 32, 8), (16, 32, 2))
       for D in (64, 128)},
    "path_512_32_live": ((512, 36, 36, 64, 8, 32), _path_lens(512)),
    "mixtral_512_32_live": ((512, 32, 8, 128, 8, 32), _path_lens(512)),
    # enough live slots that the int8 kernel serves kv head pairs
    **{f"pairs_g{G}_edges": ((512, Hq, Hkv, 64, 8, 32), EDGE_LENS * 85 + (7, 9))
       for G, Hq, Hkv in ((1, 16, 16), (3, 24, 8), (4, 32, 8))},
    "bs5_g2": ((6, 8, 4, 64, 40, 5), (0, 1, 4, 5, 6, 200)),
    "table_spans_bs1": ((3, 4, 1, 128, 1100, 1), (0, 513, 1100)),
    "two_scan_passes": ((1100, 8, 2, 64, 2, 32), _two_pass_lens()),
    # D = 256 (paligemma-3b's 8/1 heads), at most 8 query heads a kv head
    **{f"g{G}_d256": ((6, Hq, Hkv, 256, 8, 32), EDGE_LENS)
       for G, Hq, Hkv in ((1, 4, 4), (3, 6, 2), (8, 8, 1))},
    "vlm_512_32_live": ((512, 8, 1, 256, 16, 32), _vlm_lens(512)),
    # D = 112 (zamba2-7b's 32/32 heads): the D = 128 width over rows of
    # 112, G = 1, 3, 4 and 16, and the plan's 256 slots with 32 live
    **{f"g{G}_d112": ((6, Hq, Hkv, 112, 8, 32), EDGE_LENS)
       for G, Hq, Hkv in ((1, 16, 16), (3, 24, 8), (4, 32, 8))},
    "zamba_256_32_live": ((256, 32, 32, 112, 8, 32), _path_lens(256)),
    # the head-sharded step's shards (--pjit-decode): minicpm-2b's 36
    # heads over 4 and 2 shards, mistral-large-123b's 96 on 8 kv heads
    # over 4 (G = 12 at D = 128)
    "tp4_minicpm_512": ((512, 9, 9, 64, 8, 32), _path_lens(512)),
    "tp2_minicpm_512": ((512, 18, 18, 64, 8, 32), _path_lens(512)),
    "tp4_mistral_512": ((512, 24, 2, 128, 8, 32), _path_lens(512)),
    "tp4_mistral_edges": ((6, 24, 2, 128, 8, 32), EDGE_LENS),
}


def _paged_decode_case(dev, case, quant, seed):
    (B, Hq, Hkv, D, nblk, bs), lens = PAGED_DECODE_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k, v, tables = _pools(gen, B=B, nblk=nblk, bs=bs, Hkv=Hkv, D=D,
                          lens=lens, quant=quant)
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    run = lambda: ops.paged_decode_attention(q, k, v, tables, cl)
    want = ref.paged_decode_attention_ref(q.float(), k, v, tables, cl)
    return run, want, cl


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(PAGED_DECODE_CASES))
def test_cuda_paged_decode_matches_plain(cuda_device, case, quant):
    """The decode kernels at G = 1, 3, 4 and 16, D = 64 and 128, G = 1, 3
    and 4 at D = 112, G = 1, 3 and 8 at D = 256, lengths 0, 1, 31, 32, 33 and the whole budget, also with 512 slots, enough
    live ones that int8 pages are served in kv head pairs; phase 3's,
    mixtral's and paligemma-3b's 512 slots with 32 live, zamba2-7b's 256
    with 32 live; pages of 5 and of 1 token; more
    slots than one pass of the kernel's length scan.  Held by atol and at
    every (slot, head) row by its norm; dead slots are zeros."""
    run, want, cl = _paged_decode_case(cuda_device, case, quant, 21)
    kind = "_quant" if quant else ""
    before = paged_attention.launches["paged_decode_attention" + kind]
    out = run()
    torch.cuda.synchronize()
    assert paged_attention.launches["paged_decode_attention" + kind] \
        == before + 1
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    D = out.shape[-1]
    _assert_rows_close("out", out.reshape(1, -1, D), want.reshape(1, -1, D))
    assert not out[cl == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_cuda_paged_decode_is_bit_reproducible(cuda_device, quant):
    """Repeated launches on the same inputs give bit-identical outputs:
    each item has one owner block, its warps' tiles and merge a fixed
    order."""
    for case in ("path_512_32_live", "g3_d128", "vlm_512_32_live",
                 "zamba_256_32_live"):
        run, _, _ = _paged_decode_case(cuda_device, case, quant, 22)
        first = run()
        assert all(torch.equal(first, run()) for _ in range(3))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 4, 96, dtype=torch.bfloat16, device=cuda_device)
    pages = torch.zeros(5, 32, 4, 96, dtype=torch.bfloat16,
                        device=cuda_device)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention.paged_decode_attention(q, pages, pages, bt, lens)
    # D = 256 takes at most 8 query heads a kv head
    q16 = torch.zeros(2, 16, 256, dtype=torch.bfloat16, device=cuda_device)
    pages256 = torch.zeros(5, 32, 1, 256, dtype=torch.bfloat16,
                           device=cuda_device)
    with pytest.raises(ValueError, match="exceeds 8"):
        paged_attention.paged_decode_attention(q16, pages256, pages256, bt,
                                               lens)
    # and D = 112 at most 4
    q8 = torch.zeros(2, 8, 112, dtype=torch.bfloat16, device=cuda_device)
    pages112 = torch.zeros(5, 32, 1, 112, dtype=torch.bfloat16,
                           device=cuda_device)
    with pytest.raises(ValueError, match="exceeds 4"):
        paged_attention.paged_decode_attention(q8, pages112, pages112, bt,
                                               lens)
    with pytest.raises(ValueError, match="bf16"):
        paged_attention.paged_decode_attention(q.float(), pages, pages, bt,
                                               lens)


# id: (P, N), Bb, L, H, G, chunk, extra projection columns.  The cases
# "L-chunk-PpNn" read x, B and C from a projection 6 columns wider than
# they need (rows 4-byte aligned: the "vec4" copy route); the others from
# one whose rows start on 16 bytes, as the model's (the "vec16" route).
SSD_CASES = {
    f"{L}-{chunk}-P{P}N{N}": ((P, N), 2, L, 4, 2, chunk, 6)
    for P, N in ssd_scan.SHAPES
    for L, chunk in ((5, 256), (300, 256), (70, 32), (257, 256))
}
SSD_CASES.update({
    "path_128-256-P64N128": ((64, 128), 1, 128, 80, 1, 256, 0),
    "aligned_300-128-P64N128": ((64, 128), 2, 300, 4, 2, 128, 0),
    "aligned_70-32-P16N16": ((16, 16), 2, 70, 4, 2, 32, 0),
})


def _ssd_case(dev, case, seed=1):
    (P, N), Bb, L, H, G, chunk, extra = SSD_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
    width = H * P + 2 * G * N + extra
    proj = rand(Bb, L, width).to(torch.bfloat16)
    proj[..., H * P:] *= 0.3
    x = proj[..., :H * P].unflatten(-1, (H, P))
    Bm = proj[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = proj[..., H * P + G * N:H * P + 2 * G * N].unflatten(-1, (G, N))
    dt = torch.nn.functional.softplus(rand(Bb, L, H)) * 0.5
    A = -torch.exp(rand(H) * 0.5)
    D = rand(H)
    h0 = rand(Bb, H, P, N)
    run = lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                               initial_state=h0)
    want = lambda: ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(),
                                       Cm.float(), D, chunk=chunk,
                                       initial_state=h0)
    return run, want, ssd_scan.route(x, Bm, Cm, h0), extra


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_cuda_ssd_scan_matches_plain(cuda_device, case):
    """Strided x, B and C (slices of one wider projection, as the model
    passes them), two groups, an initial state; L shorter than 8, two
    chunks with a ragged tail (L = 257 at Q = 256: one token in the
    second), several small chunks (the two-stage ring), and mamba2-2.7b's
    chunk-call shape (80 heads, one group, 128 tokens); each on the copy
    route its projection's alignment gives, counted under it."""
    run, want, route, extra = _ssd_case(cuda_device, case)
    assert route == ("vec4" if extra % 8 else "vec16")
    before = ssd_scan.launches["ssd_scan"]
    before_route = ssd_scan.route_launches[route]
    y, h = run()
    wy, wh = want()
    torch.cuda.synchronize()
    assert ssd_scan.launches["ssd_scan"] == before + 1
    assert ssd_scan.route_launches[route] == before_route + 1
    torch.testing.assert_close(y.float(), wy, atol=TOL, rtol=TOL)
    scale = wh.abs().max().item()
    torch.testing.assert_close(h, wh, atol=1e-3 * scale, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path_128-256-P64N128",
                                  "300-256-P64N128", "70-32-P16N16"])
def test_cuda_ssd_scan_is_bit_reproducible(cuda_device, case):
    """Repeated launches give bit-identical y and state: every output has
    one owner block and a fixed order of sums, no atomics."""
    run, _, _, _ = _ssd_case(cuda_device, case, seed=2)
    y0, h0 = run()
    for _ in range(3):
        y, h = run()
        assert torch.equal(y, y0) and torch.equal(h, h0)


FLASH_CASES = {
    # id: ((B, Lq, Lk, Hq, Hkv, D), mask options)
    "encoder_like": ((1, 150, 150, 4, 4, 64), dict(causal=False)),
    "cross_chunk": ((1, 40, 150, 4, 4, 64), dict(causal=False)),
    "causal_gqa": ((2, 100, 100, 8, 2, 64), dict(causal=True)),
    "window_prefix": ((1, 130, 130, 4, 2, 128),
                      dict(causal=True, window=17, prefix_len=70)),
    "q_offset_kv_len": ((1, 33, 200, 4, 4, 128),
                        dict(causal=True, q_offset=150, kv_len=170)),
    "masked_rows_d256": ((1, 70, 60, 2, 2, 256),
                         dict(causal=True, window=5, kv_len=20)),
    # several key and query tiles: the diagonal inside a tile and a ragged
    # last tile; 28 keys past the last full tile of 64; a window whose
    # lower edge crosses tile boundaries; a prefix past the first query
    # tile; GQA 8/2; D = 128 and D = 256 (32-key tiles) over many tiles
    "causal_300": ((1, 300, 300, 4, 4, 64), dict(causal=True)),
    "noncausal_128x1500": ((1, 128, 1500, 4, 4, 64), dict(causal=False)),
    "noncausal_1500": ((1, 1500, 1500, 2, 2, 64), dict(causal=False)),
    "window_crosses_tiles": ((1, 300, 300, 4, 4, 64),
                             dict(causal=True, window=100)),
    "prefix_past_tile": ((1, 200, 200, 4, 4, 64),
                         dict(causal=True, prefix_len=100)),
    "gqa_8_2_tiles": ((2, 200, 200, 8, 2, 64), dict(causal=True)),
    "d128_tiles": ((1, 260, 260, 4, 4, 128), dict(causal=True, window=70)),
    "d256_tiles": ((1, 200, 230, 4, 2, 256), dict(causal=False)),
    # D = 112 (zamba2-7b's one-shot prefill): 7 k-steps and 14 n-tiles
    "d112_causal_tiles": ((2, 260, 260, 32, 32, 112), dict(causal=True)),
    "d112_gqa_window": ((1, 130, 200, 8, 2, 112),
                        dict(causal=True, window=40, q_offset=70)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_cuda_flash_attention_matches_plain(cuda_device, case):
    """q, k and v sliced from one (B, L, 3, H, D) tensor (strided, as a
    fused projection would give them), every mask option, GQA, D = 64,
    112, 128 and 256, rows that see nothing."""
    (B, Lq, Lk, Hq, Hkv, D), kw = FLASH_CASES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    q = torch.randn(B, Lq, 2, Hq, D, generator=gen, device=cuda_device).to(
        torch.bfloat16)[:, :, 1]
    kv = torch.randn(B, Lk, 2, Hkv, D, generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = flash_attention.launches["flash_attention"]
    out, lse = flash_attention.flash_attention(q, k, v, **kw)
    want, want_lse = ref.flash_attention_ref(q.float(), k.float(),
                                             v.float(), **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=LSE_TOL)
    _assert_rows_close("out", out, want)


DENSE_DECODE_CASES = {
    # id: (B, S, Hq, Hkv, D, window, lengths); lengths None: linspace(0, S)
    "cross": (8, 1500, 20, 20, 64, None, None),
    "gqa_window": (6, 300, 32, 4, 128, 40, None),
    "d128": (5, 77, 16, 16, 128, None, None),
    "d256": (4, 90, 16, 2, 256, None, None),
    "d112": (6, 300, 32, 32, 112, None, None),
    "d112_gqa_window": (5, 120, 16, 4, 112, 50, None),
    # mixtral's ring at its tp = 4 shard (32 splits of 128 keys)
    "ring_tp4": (8, 4096, 8, 2, 128, 4096, None),
    # paligemma-3b's MQA dense view at ragged lengths (8 splits of 64 keys)
    "vlm_mqa": (16, 512, 8, 1, 256, None, None),
    # window edges at 1748 and 700, inside splits of 256 keys
    "window_edge_in_split": (4, 2048, 16, 4, 64, 300, [2048, 1000, 700, 0]),
    # one below, at and one above the first two split boundaries
    "split_boundaries": (6, 1024, 16, 1, 112, None, "boundaries"),
}


def _dense_decode_case(dev, case, seed):
    """A case's inputs (caches sliced from a wider tensor) and its launch."""
    B, S, Hq, Hkv, D, window, lens = DENSE_DECODE_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn(B, S, 2, Hkv, D, generator=gen,
                     device=dev).to(torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if lens is None:
        lens = torch.linspace(0, S, B, device=dev).to(torch.int32)
    else:
        if lens == "boundaries":
            nsplit, L = decode_attention.plan_splits(
                B, Hkv, S, D, decode_attention.sm_count(dev))
            assert nsplit > 2
            lens = [L - 1, L, L + 1, 2 * L - 1, 2 * L + 1, 0]
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    run = lambda: decode_attention.decode_attention(q, k, v, lens,
                                                    window=window)
    return run, (q, k, v, lens, window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DENSE_DECODE_CASES))
def test_cuda_decode_attention_matches_plain(cuda_device, case):
    """Ragged lengths with empty slots (zeros), a window, GQA and MQA, each
    head dim, the ring's and paligemma's shard shapes (keys split over
    warps, merged), a window's edge inside a split and lengths at split
    boundaries, against caches sliced from a wider tensor.  One launch a
    call, whatever the split count; every (slot, head) row held to its
    norm."""
    run, (q, k, v, lens, window) = _dense_decode_case(cuda_device, case, 3)
    before = decode_attention.launches["decode_attention"]
    out = run()
    want = ref.decode_attention_ref(q.float(), k.float(), v.float(), lens,
                                    window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches["decode_attention"] == before + 1
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    D = out.shape[-1]
    _assert_rows_close("out", out.reshape(1, -1, D), want.reshape(1, -1, D))
    assert not out[lens == 0].any()


@pytest.mark.cuda
def test_cuda_decode_attention_is_bit_reproducible(cuda_device):
    """Repeated launches give bit-identical outputs on split shapes: each
    split has one owner warp and the merge a fixed order (no atomics)."""
    for case in ("ring_tp4", "vlm_mqa", "window_edge_in_split", "cross"):
        run, _ = _dense_decode_case(cuda_device, case, 23)
        first = run()
        assert all(torch.equal(first, run()) for _ in range(3))


GMM_CASES = {                       # (E, C, K, N, extra K, extra N)
    "odd": (4, 50, 70, 33, 0, 0),
    "narrow_n": (8, 10, 200, 16, 0, 0),
    "one_row": (3, 1, 64, 128, 0, 0),
    "strided": (2, 70, 256, 200, 8, 16),
    "strided_unaligned": (2, 33, 96, 64, 3, 5),
    "chunk": (8, 20, 4096, 14336, 0, 0),
    "decode_down": (8, 512, 14336, 4096, 0, 0),
    "c1": (4, 1, 512, 264, 0, 0),
    "c63": (4, 63, 512, 264, 0, 0),
    "c64": (4, 64, 512, 264, 0, 0),
    "c65": (4, 65, 512, 264, 0, 0),
    "c200": (4, 200, 512, 264, 0, 0),
    "lhs_row_strided": (3, 70, 256, 200, 24, 0),
}
# the route each case takes in bf16 (float32 always takes mma_sync)
GMM_ROUTES = {case: "mma_sync" if case in ("odd", "strided_unaligned")
              else "tma" for case in GMM_CASES}


def _gmm_operands(dev, case, dt, seed):
    E, C, K, N, xk, xn = GMM_CASES[case]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lhs = torch.randn(E, C, K + xk, generator=gen, device=dev).to(
        dt)[:, :, :K]
    rhs = torch.randn(E, K, N + xn, generator=gen, device=dev).to(
        dt)[:, :, :N]
    return lhs, rhs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_cuda_grouped_matmul_matches_plain(cuda_device, case, dtype):
    """Ragged C, K and N (zero-filled tiles), C = 1, operands sliced from
    wider tensors (read in place, with 16-byte-aligned and unaligned
    strides), and mixtral's chunk and decode shapes."""
    E, C, K, N, xk, xn = GMM_CASES[case]
    dt = getattr(torch, dtype)
    lhs, rhs = _gmm_operands(cuda_device, case, dt, 4)
    route = GMM_ROUTES[case] if dt == torch.bfloat16 else "mma_sync"
    assert grouped_matmul.route(lhs, rhs) == route
    before = grouped_matmul.launches["grouped_matmul"]
    before_route = grouped_matmul.route_launches[route]
    out = ops.grouped_matmul(lhs, rhs)
    want = ref.grouped_matmul_ref(lhs.float(), rhs.float())
    torch.cuda.synchronize()
    assert grouped_matmul.launches["grouped_matmul"] == before + 1
    assert grouped_matmul.route_launches[route] == before_route + 1
    assert out.dtype == dt and tuple(out.shape) == (E, C, N)
    tol = 1.6e-2 if dt == torch.bfloat16 else 1e-3
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode_down", "c65", "strided_unaligned"])
def test_cuda_grouped_matmul_is_bit_reproducible(cuda_device, case):
    """Repeated launches give bit-identical outputs on both routes: no
    split-K and no atomics, one owner block and one order of sums per
    output tile."""
    lhs, rhs = _gmm_operands(cuda_device, case, torch.bfloat16, 5)
    first = ops.grouped_matmul(lhs, rhs)
    assert all(torch.equal(first, ops.grouped_matmul(lhs, rhs))
               for _ in range(3))


@pytest.mark.cuda
def test_cuda_grouped_matmul_rejects_what_it_does_not_take(cuda_device):
    a = torch.zeros(2, 4, 8, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="both be bfloat16"):
        grouped_matmul.grouped_matmul(a, a.float().transpose(1, 2))
    with pytest.raises(ValueError, match="both be bfloat16"):
        grouped_matmul.grouped_matmul(a.half(), a.half().transpose(1, 2))
    with pytest.raises(ValueError, match=r"rhs must be \(2, 8, N\)"):
        grouped_matmul.grouped_matmul(a, a)


FLASH_BWD_CASES = {
    # id: ((B, Lq, Lk, Hq, Hkv, D), mask options)
    "causal_d64": ((1, 256, 256, 4, 4, 64), dict(causal=True)),
    "gqa4_d128": ((2, 100, 100, 8, 2, 128), dict(causal=True)),
    "d256_ragged": ((1, 70, 90, 2, 1, 256), dict(causal=True)),
    "window": ((1, 130, 130, 4, 2, 64), dict(causal=True, window=17)),
    "noncausal_lq_ne_lk": ((1, 40, 150, 4, 4, 64), dict(causal=False)),
    "q_offset_kv_len": ((1, 33, 200, 4, 4, 128),
                        dict(causal=True, q_offset=150, kv_len=170)),
    "prefix_past_tile": ((1, 150, 150, 2, 2, 64),
                         dict(causal=True, prefix_len=100)),
    "masked_rows": ((1, 70, 60, 2, 2, 64),
                    dict(causal=True, window=5, kv_len=20)),
    # several tiles of both kernels' streamed loops (see FLASH_CASES)
    "causal_300": ((1, 300, 300, 4, 4, 64), dict(causal=True)),
    "noncausal_128x1500": ((1, 128, 1500, 2, 2, 64), dict(causal=False)),
    "noncausal_1500": ((1, 1500, 1500, 1, 1, 64), dict(causal=False)),
    "window_crosses_tiles": ((1, 300, 300, 4, 4, 64),
                             dict(causal=True, window=100)),
    "prefix_past_first_tile": ((1, 200, 200, 4, 4, 64),
                               dict(causal=True, prefix_len=100)),
    "gqa_8_2_tiles": ((2, 200, 200, 8, 2, 64), dict(causal=True)),
    "d256_tiles": ((1, 200, 230, 4, 2, 256), dict(causal=True)),
    # zamba2-7b's shared block trains at D = 112: causal over several
    # tiles, and ragged GQA lengths
    "d112_causal": ((1, 300, 300, 4, 4, 112), dict(causal=True)),
    "d112_ragged": ((2, 70, 90, 4, 2, 112), dict(causal=True)),
}


def _assert_rows_close(name, got, want):
    """At every sequence position (axis 1 of (B, L, H, D)), the norm of
    got - want over the other axes is at most ROW_REL_TOL of want's norm
    there plus ROW_FLOOR an element (the noise of a position whose true
    value is 0, such as dq of a row that sees one key)."""
    g = got.float().transpose(0, 1).flatten(1)
    w = want.float().transpose(0, 1).flatten(1)
    limit = ROW_REL_TOL * w.norm(dim=1) + ROW_FLOOR * w.shape[1] ** 0.5
    share = (g - w).norm(dim=1) / limit
    assert (share <= 1).all(), (name, share.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_cuda_flash_attention_bwd_matches_plain(cuda_device, case):
    """q, k, v and dout sliced from wider tensors (strided, read in
    place), the forward kernel's out and lse, every mask option, GQA,
    D = 64, 112, 128 and 256, lengths that are not multiples of the tiles, a
    prefix reaching past the first query tile, rows that see nothing."""
    (B, Lq, Lk, Hq, Hkv, D), kw = FLASH_BWD_CASES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    rand = lambda *s: torch.randn(*s, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q, dout = rand(B, Lq, 2, Hq, D).unbind(2)
    k, v = rand(B, Lk, 2, Hkv, D).unbind(2)
    out, lse = flash_attention.flash_attention(q, k, v, **kw)
    before = flash_attention_bwd.launches["flash_attention_bwd"]
    got = flash_attention_bwd.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches["flash_attention_bwd"] == before + 1
    for name, g, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape, name
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), atol=TOL, rtol=TOL,
                                   msg=lambda m: f"{name}: {m}")
        _assert_rows_close(name, g, w)
    if case == "masked_rows":
        assert not got[1][:, 20:].any() and not got[2][:, 20:].any()
    print({n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
           for n, log in build.build_log.items()
           if n == "flash_attention_bwd"})


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_refuses_d112(cuda_device):
    """(The name predates the backward's D = 112 instance.)  The backward
    launches at D = 112, zamba2-7b's head dim, and its wrapper refuses a
    head dim with no instance (96) before it launches."""
    dev = cuda_device
    q = torch.zeros(1, 8, 2, 112, dtype=torch.bfloat16, device=dev)
    out, lse = flash_attention.flash_attention(q, q, q, causal=True)
    before = flash_attention_bwd.launches["flash_attention_bwd"]
    dq, dk, dv = flash_attention_bwd.flash_attention_bwd(q, q, q, out, lse,
                                                         q, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches["flash_attention_bwd"] == before + 1
    assert not (dq.any() or dk.any() or dv.any())
    q96 = q[..., :96].contiguous()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd.flash_attention_bwd(q96, q96, q96, q96, lse,
                                                q96, causal=True)
    assert flash_attention_bwd.launches["flash_attention_bwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal_300", "gqa_8_2_tiles",
                                  "d256_tiles", "d112_ragged"])
def test_cuda_flash_attention_is_bit_reproducible(cuda_device, case):
    """Two launches on the same inputs give bit-identical out and lse, and
    bit-identical dq, dk and dv: every sum has one owner and a fixed
    order (no atomics)."""
    (B, Lq, Lk, Hq, Hkv, D), kw = FLASH_BWD_CASES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    rand = lambda *s: torch.randn(*s, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q, dout = rand(B, Lq, Hq, D), rand(B, Lq, Hq, D)
    k, v = rand(B, Lk, Hkv, D), rand(B, Lk, Hkv, D)
    runs = []
    for _ in range(2):
        out, lse = flash_attention.flash_attention(q, k, v, **kw)
        runs.append((out, lse, *flash_attention_bwd.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw)))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_flash_attention_autograd_runs_both_kernels(cuda_device):
    """Gradients through ``ops.flash_attention`` on the card launch the
    forward kernel once and the backward kernel once, and equal the plain
    backward's on the same residuals."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(6)
    rand = lambda *s: torch.randn(*s, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q, k, v, dout = (rand(2, 96, 4, 64) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    counts = ops.launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    out.backward(dout)
    grown = {n: c - counts[n] for n, c in ops.launch_counts().items()}
    assert grown["flash_attention"] == 1 and grown["flash_attention_bwd"] == 1
    o, lse = flash_attention.flash_attention(q.detach(), k.detach(),
                                             v.detach())
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       o, lse, dout)
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        torch.testing.assert_close(t.grad.float(), w.float(), atol=TOL,
                                   rtol=TOL)
        _assert_rows_close(name, t.grad, w)


CHUNK_CASES = {       # (B, T, S, Hq, Hkv, D), start, chunk_len, prefix_len
    "minicpm_path": ((1, 128, 256, 36, 36, 64), [64], [128], 0),
    "gqa_d128_ragged": ((3, 13, 300, 32, 8, 128), [0, 40, 287], [13, 0, 13],
                        40),
    "ragged_s": ((2, 128, 200, 36, 36, 64), [0, 100], [128, 77], 0),
    "mqa_prefix": ((1, 40, 97, 8, 1, 64), [57], [40], 20),
    "all_dead": ((2, 16, 64, 4, 2, 64), [5, 9], [0, 0], 0),
    # more than one 64-row or 64-key tile: 130 rows over three row tiles
    # at start 63; S = 700 over eleven key tiles; GQA 32/8 at D = 128 with
    # a prefix of 100 past the first row tile
    "t130_start63": ((2, 130, 256, 36, 36, 64), [63, 0], [130, 101], 0),
    "s700": ((2, 64, 700, 36, 36, 64), [636, 300], [64, 64], 0),
    "gqa_d128_prefix100": ((2, 128, 400, 32, 8, 128), [0, 200], [128, 90],
                           100),
    # paligemma-3b's dense-view chunks: MQA 8/1 at D = 256 (32-key tiles),
    # a first chunk with the 256-row prefix, then a text chunk at 288
    "vlm_first_d256": ((2, 288, 512, 8, 1, 256), [0, 0], [288, 270], 256),
    "vlm_text_d256": ((1, 64, 512, 8, 1, 256), [288], [64], 0),
    # zamba2-7b's dense-view chunks: 32/32 heads at D = 112, from 0 and
    # from mid-tile; GQA 8/2 with a prefix past the first row tile
    "zamba_d112": ((2, 128, 256, 32, 32, 112), [0, 100], [128, 90], 0),
    "gqa_d112_prefix100": ((2, 128, 300, 8, 2, 112), [0, 150], [128, 77],
                           100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_cuda_chunk_attention_matches_plain(cuda_device, case):
    """The dense chunked-prefill kernel on K and V read in place from a
    wider (B, S, 2 * Hkv, D) buffer: GQA and MQA, D = 64, 112, 128 and 256,
    per-row
    start and chunk_len with empty rows, a prefix past the first tile, T
    and S off the tiles; rows past chunk_len are zeros."""
    (B, T, S, Hq, Hkv, D), start, cl, prefix = CHUNK_CASES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(9)
    rand = lambda *s: torch.randn(*s, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q, kv = rand(B, T, Hq, D), rand(B, S, 2 * Hkv, D)
    k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
    st = torch.tensor(start, dtype=torch.int32, device=cuda_device)
    n = torch.tensor(cl, dtype=torch.int32, device=cuda_device)
    before = chunk_attention.launches["chunk_prefill_attention"]
    out = ops.chunk_attention(q, k, v, st, n, prefix_len=prefix)
    want = ref.chunk_attention_ref(q.float(), k.float(), v.float(), st, n,
                                   prefix_len=prefix)
    torch.cuda.synchronize()
    assert chunk_attention.launches["chunk_prefill_attention"] == before + 1
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    _assert_rows_close("out", out, want)
    for b, c in enumerate(cl):
        assert not out[b, c:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gqa_d128_prefix100", "t130_start63",
                                  "vlm_first_d256", "zamba_d112"])
def test_cuda_chunk_attention_is_bit_reproducible(cuda_device, case):
    """Repeated launches on the same inputs give bit-identical outputs:
    each row has one owner block and a fixed order of sums."""
    (B, T, S, Hq, Hkv, D), start, cl, prefix = CHUNK_CASES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(10)
    rand = lambda *s: torch.randn(*s, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q, kv = rand(B, T, Hq, D), rand(B, S, 2 * Hkv, D)
    k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
    st = torch.tensor(start, dtype=torch.int32, device=cuda_device)
    n = torch.tensor(cl, dtype=torch.int32, device=cuda_device)
    run = lambda: ops.chunk_attention(q, k, v, st, n, prefix_len=prefix)
    first = run()
    assert all(torch.equal(first, run()) for _ in range(3))


@pytest.mark.cuda
def test_cuda_chunk_attention_rejects_what_it_does_not_take(cuda_device):
    dev = cuda_device
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=dev)
    cache = torch.zeros(1, 32, 2, 64, dtype=torch.bfloat16, device=dev)
    wide = torch.zeros(1, 32, 2, 68, dtype=torch.bfloat16, device=dev)
    st = torch.zeros(1, dtype=torch.int32, device=dev)
    before = dict(chunk_attention.launches)
    calls = {
        "head dim": lambda: chunk_attention.chunk_prefill_attention(
            q[..., :32].contiguous(), cache[..., :32].contiguous(),
            cache[..., :32].contiguous(), st, st),
        "bf16": lambda: chunk_attention.chunk_prefill_attention(
            q.float(), cache, cache, st, st),
        "contiguous": lambda: chunk_attention.chunk_prefill_attention(
            q.transpose(1, 2), cache, cache, st, st),
        "multiples of 8": lambda: chunk_attention.chunk_prefill_attention(
            q, wide[..., 4:], cache, st, st),
        "CUDA tensor": lambda: chunk_attention.chunk_prefill_attention(
            q, cache, cache, st.cpu(), st),
        "int32": lambda: chunk_attention.chunk_prefill_attention(
            q, cache, cache, st.long(), st),
    }
    for msg, call in calls.items():
        with pytest.raises(ValueError, match=msg):
            call()
    assert chunk_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cuda_obs_is_byte_inert(cuda_device, kv_dtype):
    """A request wave at toy width (2 layers, 4 heads of D = 64) on the
    card, once untraced and once with a ``Tracer`` and a
    ``MetricsRegistry``: the greedy tokens are identical, and so are the
    paged kernels' launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.allocator import ParallelPlan
    from repro_torch.core.categories import Sensitivity, TaskCategory
    from repro_torch.models import transformer
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2,
                              d_model=256, num_heads=4, num_kv_heads=4,
                              d_ff=512, vocab_size=1024)
    params = transformer.init(0, cfg, device=cuda_device)
    plan = ParallelPlan(service="toy", category=TaskCategory(
        Sensitivity.FREQUENCY, False), bs=8, mf=2, kv_dtype=kv_dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 40, 70, 13, 100, 33, 9, 64, 21, 90)]

    def run(**obs):
        rt = ServiceRuntime(cfg, params, plan, device=cuda_device,
                            max_seq_len=160, block_size=16, **obs)
        for rid, p in enumerate(prompts):
            rt.submit(GenerationRequest(rid=rid, tokens=p, max_new_tokens=12,
                                        stream=rid))
        before = dict(paged_attention.launches)
        toks = {r.rid: r.tokens.tolist() for r in rt.drain()}
        return toks, {k: v - before[k]
                      for k, v in paged_attention.launches.items()}

    plain = run()
    tracer, metrics = Tracer(), MetricsRegistry()
    traced = run(tracer=tracer, metrics=metrics)
    assert sorted(plain[0]) == list(range(len(prompts)))
    assert traced == plain
    assert sum(plain[1].values()) > 0
    assert metrics.histogram("ttft_seconds").value(
        service="minicpm-2b")["count"] == len(prompts)
    for rid in range(len(prompts)):
        roots, _ = tracer.span_tree("minicpm-2b", str(rid))
        assert [c.name for c in roots[0].children] \
            == ["queued", "prefill", "decode"]


@pytest.mark.cuda
def test_cuda_grouped_matmul_autograd_launches_dx_and_dw(cuda_device):
    """Gradients through ``ops.grouped_matmul`` on the card launch the
    kernel three times, all on the TMA route: the forward, dX = dY W^T
    and dW = X^T dY (transposed copies of W and X), each held to the f32
    product of the same bf16 values as the forward is."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(8)
    rand = lambda *s: torch.randn(*s, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    lhs, rhs, dout = rand(8, 96, 256), rand(8, 256, 520), rand(8, 96, 520)
    lhs.requires_grad_(True)
    rhs.requires_grad_(True)
    before = dict(grouped_matmul.route_launches)
    out = ops.grouped_matmul(lhs, rhs)
    out.backward(dout)
    torch.cuda.synchronize()
    grown = {r: n - before[r]
             for r, n in grouped_matmul.route_launches.items()}
    assert grown == {"tma": 3, "mma_sync": 0}, grown
    want_dx = ref.grouped_matmul_ref(dout.float(),
                                     rhs.detach().float().transpose(1, 2))
    want_dw = ref.grouped_matmul_ref(lhs.detach().float().transpose(1, 2),
                                     dout.float())
    for name, got, want in (("dX", lhs.grad, want_dx),
                            ("dW", rhs.grad, want_dw)):
        assert got.dtype == torch.bfloat16, name
        torch.testing.assert_close(got.float(), want, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_cuda_ssd_scan_autograd_matches_cpu(cuda_device):
    """Gradients through ``ops.ssd_scan`` on the card (the forward kernel,
    once; the backward a recompute of the plain scan) against the same
    inputs on the CPU (plain forward and backward): x, B and C in bf16,
    dt, A and D in f32, chunks of 32 over 100 steps.  Both backward
    passes differentiate the same plain scan in f32, so the gradients
    agree to 1e-3 of each one's largest magnitude (bf16 x, B and C
    gradients: to atol = rtol = 1.6e-2)."""
    rng = np.random.default_rng(9)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    Bb, L, H, P, G, N = 2, 100, 4, 16, 1, 16
    inputs = [f(Bb, L, H, P).bfloat16(),
              torch.nn.functional.softplus(f(Bb, L, H) - 1.0),
              -torch.exp(0.5 * f(H)), f(Bb, L, G, N).bfloat16(),
              f(Bb, L, G, N).bfloat16(), f(H)]
    dy = f(Bb, L, H, P).bfloat16()
    grads = {}
    for dev in ("cpu", "cuda"):
        ts = [t.detach().to(dev).requires_grad_(True) for t in inputs]
        before = ssd_scan.launches["ssd_scan"]
        y, _ = ops.ssd_scan(*ts, chunk=32)
        y.backward(dy.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ssd_scan.launches["ssd_scan"] == before + 1
        grads[dev] = [t.grad.float().cpu() for t in ts]
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D"), grads["cuda"],
                          grads["cpu"]):
        assert torch.isfinite(g).all(), name
        if name in ("x", "B", "C"):
            torch.testing.assert_close(g, w, atol=TOL, rtol=TOL,
                                       msg=lambda m: f"d{name}: {m}")
        else:
            scale = w.abs().max().item()
            torch.testing.assert_close(g, w, atol=1e-3 * scale, rtol=1e-3,
                                       msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cuda_tp_wave_matches_the_unsharded_runtime(cuda_device, kv_dtype):
    """A request wave at toy width on the card, unsharded and split by
    heads over ``[cuda] * tp`` (``--pjit-decode``'s builder) at tp = 1, 2
    and 4: tp = 1 gives the unsharded chains and launches exactly; at tp =
    2 and 4 every kernel launch of the paged path is made tp times (once a
    shard) and the first tokens are the unsharded run's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.allocator import ParallelPlan
    from repro_torch.core.categories import Sensitivity, TaskCategory
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.steps import paged_decode_builder
    from repro_torch.models import transformer
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime

    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2,
                              d_model=256, num_heads=8, num_kv_heads=4,
                              d_ff=512, vocab_size=1024)
    params = transformer.init(0, cfg, device=cuda_device)
    plan = ParallelPlan(service="toy", category=TaskCategory(
        Sensitivity.FREQUENCY, False), bs=8, mf=2, kv_dtype=kv_dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 40, 70, 13, 100, 33, 9, 64)]

    def run(tp=None):
        builder = None if tp is None else paged_decode_builder(
            meshlib.make_mesh((1, tp), ("data", "model"),
                              [torch.device("cuda", 0)] * tp))
        rt = ServiceRuntime(cfg, params, plan, device=cuda_device,
                            max_seq_len=160, block_size=16,
                            paged_step_builder=builder)
        for rid, p in enumerate(prompts):
            rt.submit(GenerationRequest(rid=rid, tokens=p, max_new_tokens=12,
                                        stream=rid))
        before = dict(paged_attention.launches)
        toks = {r.rid: r.tokens.tolist() for r in rt.drain()}
        return toks, {k: v - before[k]
                      for k, v in paged_attention.launches.items()}

    base, launches = run()
    assert sum(launches.values()) > 0
    assert run(1) == (base, launches)
    for tp in (2, 4):
        toks, grown = run(tp)
        assert {k: tp * v for k, v in launches.items()} == grown
        assert all(toks[r][0] == base[r][0] for r in base)

