#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's serving paths (minicpm-2b, mamba2-2.7b, whisper-large-v3
and mixtral-8x7b, full width, random weights from a seed), its training
path (minicpm-2b), its sync and dense-cache serving paths and its prefix
cache (minicpm-2b) in nine phases, then its observability and crash
evacuation (minicpm-2b) in a tenth, its stochastic sampling, deadline
admission with parking and n-way forks (minicpm-2b) in an eleventh, and
its speculative decoding (minitron-4b, mixtral-8x7b) in a twelfth; any
failure exits non-zero.  The serving
phases run at the launcher's defaults, the prefix cache among them at the
category's retention (minicpm-2b, a frequency service, keeps the whole
pool; mixtral-8x7b, a latency service, a quarter), and print its counters:

1. the kernels against their plain PyTorch versions
   (``repro_torch.kernels.ref``) on random inputs, compared in f32 with
   atol = rtol = 1.6e-2 (about two bf16 steps of the output), and timed
   (kernel and library: CUDA-graph replay, so the host cannot pace the
   launches; plain versions: CUDA events) beside the plain version and the
   bound of the work:
   the four paged-attention kernels at minicpm-2b's shapes and at one GQA
   shape (minitron-4b's heads), beside ``scaled_dot_product_attention`` on
   the gathered dense view (a yardstick the port never calls), the two
   decode kernels also held by ``check_rows`` at every (slot, head) row,
   their dead slots zeros and repeated launches bit-identical, timed also
   at 32 slots all live with the path's 32 lengths (the dead-slot
   yardstick) and with all 512 slots live, each record with its share of
   the bound and its instances' ``ptxas`` registers and spills; the two
   chunk kernels also at odd shapes (T = 13 and 65, starts that are
   multiples of neither 64 nor the page, prefix-cache hit starts (150,
   mid-page, and a full-prompt hit's one row), prefixes of 20 and 100, a dead
   slot among four, mixtral's 32/8 heads at D = 128), every chunk case
   also held by ``check_rows``, its rows past chunk_len zeros, and
   repeated launches bit-identical, and at speculative decoding's verify
   launch (512 slots, T = 5, minitron-4b's 24/8 heads at D = 128, ragged
   starts; 32 slots speculating, then all 512), timed; the SSD
   scan at mamba2-2.7b's chunk-call shapes (80 heads, P = 64, N = 128, one
   group), its f32 final state held to atol = rtol = 1e-3 of its largest
   magnitude (no single PyTorch call computes the scan), on the 16-byte
   copy route, repeated launches bit-identical; flash attention
   at whisper-large-v3's encoder shape (1500 x 1500, 20 heads, D = 64) and
   cross-attention chunk shape (128 rows x 1500 keys) and one small case
   per mask option, its f32 log-sum-exp held to atol = rtol = 1e-3, its
   output also at every sequence position to 1e-2 of that position's norm
   (``check_rows``), and timed at the training shape (1 x 4096 x 4096, 36 heads, D = 64,
   causal); the flash backward at the training shape, timed, and at odd
   shapes (GQA, D = 128 and 256, a window, Lq != Lk, kv_len, q_offset,
   ragged tiles), its bf16 dq, dk and dv held to the plain version on the
   same bf16 inputs, also by ``check_rows``, beside the backward of ``scaled_dot_product_attention``
   (``torch.autograd.grad`` on a saved graph; CUDA events); dense
   decode attention at the cross-attention decode shape (128 slots, 1500
   keys, 20 heads), 32 and 128 slots live, and a windowed GQA case; both
   beside ``scaled_dot_product_attention`` on the same tensors; the
   grouped GEMM at mixtral-8x7b's decode shapes ((8, 512, 4096) @
   (8, 4096, 14336) and its down projection) and chunk shape (20 rows an
   expert), its bf16 output held to the f32 product of the same operands
   (also by ``check_rows``, repeated launches bit-identical), beside
   ``torch.bmm`` on the same tensors, each record with its route, its
   achieved TFLOP/s and its share of the bound, and at odd shapes (an
   unaligned one on the ``mma.sync`` route; on the TMA route ragged
   tiles, C = 1, 63, 64, 65 and 200, an lhs row stride above K); the bf16
   paged decode kernel at mixtral's
   attention shape (512 slots, 32 live, 32 heads over 8 KV heads, D = 128);
   and the dense chunked-prefill kernel at minicpm-2b's dense-view chunk
   shape (one slot, 128 rows at offset 64, S = 256, 36 heads, D = 64),
   beside ``scaled_dot_product_attention`` with the same boolean mask, and
   at odd shapes (GQA 32/8 at D = 128, per-row start and chunk_len with an
   empty row, a prefix past the first tile, T = 13, S = 300, T = 130 over
   three row tiles at start 63, S = 700 over eleven key tiles, K/V read in
   place from a wider buffer), also held by ``check_rows``, repeated
   launches bit-identical; the SSD scan's and the dense chunk kernel's
   records also carry their share of the bound and their ``ptxas``
   registers and spills; each timed
   flash record also carries its achieved TFLOP/s (the operations the
   function needs over its graph-replay time) and the share of its bound
   it reaches, and the build prints every kernel's ``ptxas`` register and
   spill lines by kernel;
2. the launcher, ``repro_torch.launch.serve.main``: 8 requests, 16 new
   tokens, int8 KV (the plan's default for this frequency service);
3. a request wave through ``ServiceRuntime`` with prompts of 6-200 tokens
   and 40 new tokens each, once with int8 KV and once with bf16 KV;
4. the same wave through mamba2-2.7b's state path at 128 slots (the
   allocator's own ``user_bs``: its default 512 slots of SSD state would
   take 86 GB), every SSD scan launch on the 16-byte copy route;
5. the same wave through whisper-large-v3's encoder-decoder path at 128
   slots (its default 512 slots of cross K/V would take 125.8 GB), each
   request with seeded random frame embeddings, int8 self-attention KV;
6. the same wave through mixtral-8x7b's MoE path at the plan's 512 slots
   and bf16 KV, at full width and 16 of its 32 layers (all 32 layers'
   bf16 weights, 93.4 GB, do not fit the card; 16 take 46.96 GB), the
   expert FFN through the grouped GEMM kernel, every launch on its TMA
   route, capacity factor 1.25;
7. training through ``repro_torch.launch.train``: minicpm-2b at full
   width, bf16, AdamW at lr 1e-3, batch 2 x 4096 tokens in 2 microbatches,
   4 steps (finite losses and grad norms, the last loss below the first,
   exactly 160 flash forward and 80 flash backward launches a step: 40
   layers' forward and checkpointed recompute, and backward, per
   microbatch), then the second step of a fresh trainer under
   ``torch.profiler``;
8. the sync and dense-cache paths of minicpm-2b at full width: (a) the
   launcher with ``--mode sync``, ``--kvcache-impl dense`` and
   ``--no-chunked-prefill``, 8 requests of 16 new tokens each; (b) phase
   3's wave through the dense-view step (``paged_native=False``, the
   reference's oracle) at 128 slots and bf16 KV, exactly one dense chunk
   kernel launch a layer in each chunk and one dense decode launch a layer
   in each decode step; (c) the native step's logits (paged kernels #3
   and #1) against the dense-view step's (#6 and #5) over three chunks and
   three decode steps of one slot, to 2**-5 of their norm (each path's
   distance from its plain versions on the card, the chain's own bf16
   noise, printed beside it), and the three chunk steps' logits identical
   (#3 and #6 run one body); (d) phase 3's wave in sync mode;
9. the prefix cache on minicpm-2b at full width and the plan's 512 slots
   (``max_seq_len`` 256): 64 requests, each a 150-token template (4 full
   pages and a 22-token partial tail) plus a tail of its own of 1-40
   tokens, 24 new tokens each (``profile_step.templated_wave``).  A donor
   is served to its eviction first, which indexes the template's partial
   tail; the other 63 are then submitted together.  In int8 and in bf16
   KV, with the cache on (-1) and off (0): on, at least 62 of the 63
   lookups hit, each hit reuses at least 128 tokens, at least 63 blocks are
   copied on write, and at least 63 x 128 fewer prompt tokens are computed
   than off.  Then two alternating templates at 8 retained blocks, on and
   off, where the LRU evicts.  In every pair each request's final-chunk
   logits agree to 2**-5 of their norm (phase 8 (c)'s rule for two correct
   bf16 chains) and the greedy chains that agree in full are counted; the
   tok/s, prefill chunks, prompt tokens computed and host wall per step
   (all steps, and decode-only steps) are printed on against off, then the
   idle share of the on run's first 5 steps under ``torch.profiler``, and
   copy-on-write on the card is checked exact (``torch.equal``) on
   minicpm-2b's int8 pools (values and scales) and bf16 pools;
10. observability and crash evacuation on minicpm-2b at full width and the
   plan's 512 slots: (a) the launcher with ``make obs-smoke``'s flags (6
   requests, 4 new tokens, ``--trace-out``, ``--metrics-out``,
   ``--calibrate-out`` into a temporary directory), its trace and metrics
   read back by the port's ``validate_chrome_trace`` and
   ``parse_prometheus_text``, the calibration's overrides printed; (b)
   phase 3's int8 wave untraced, traced (a ``Tracer`` and a
   ``MetricsRegistry``), traced, untraced: every greedy chain equal to
   phase 3's, the paged-attention launches equal to phase 3's, the
   untraced and traced final-chunk logits identical, every request's
   timeline balanced (``request`` > ``queued``, ``prefill``, ``decode``,
   served), the TTFT, TPOT and queue-wait histograms counting all 32; it
   prints their median and p99 (interpolated in the histograms' buckets,
   as Prometheus does) and mean, and the tok/s and host wall per step of
   each run; (c) phase 3's int8 wave, traced, evacuated after
   ``EVACUATE_AFTER`` steps (queued, mid-prefill and decoding requests
   present), its requests resubmitted to the same runtime and served:
   the counters, ``StepStats.evacuated``, an arena with no live slot whose
   free and idle cached blocks are the pool, and two ``request`` roots in
   each resubmitted timeline (the first ``outcome="evacuated"``) are
   checked, the chains equal to phase 3's counted, and each resubmitted
   request's final-chunk logits held to phase 3's to 2**-5 of their norm
   where its chain differs;
11. threefry sampling, SDF admission and forks on minicpm-2b at full width
   (int8 KV and the launcher's defaults unless named): (a) the sampler on
   the card against the port's CPU sampler on identical float32 logits
   (512 rows of the 122,753-token vocabulary, seeds the row ids): counter
   keys, threefry words (int64) and uniforms bit-identical, every row's
   token equal with 32 and 512 rows live at temperature 0.8 and top_k 0
   and 50 (a differing row is printed with its top-two perturbed-score
   margin and passes only within twice its noise difference),
   ``speculative_verify`` at k = 4 greedy and stochastic equal, and the
   device time of each sampling call (CUDA events); (b) phase 3's int8
   wave at temperature 0.8 and top_k 50 twice (chains identical, tokens
   differing from phase 3's greedy chains counted: random weights put the
   last token's logit far above the rest, so none do at 0.8), once at
   temperature ``HOT_T`` (tokens must differ), and 4 requests of 4
   samples at ``HOT_T`` twice (12 forks sharing their prompt blocks, no
   prefill for forks, 12 copy-on-write copies, sibling chains distinct
   and repeatable); (c) the reference's goodput overload trace
   (``profile_step.goodput_trace``: the trace's 2-slot latency plan, bf16
   KV, a logical clock) under fifo and sdf, greedy and at 0.8, then greedy
   with int8 KV: sdf on time at least 1.3x fifo, at least one preemption
   and as many resumes, chains identical across the policies, every
   request served or verdicted, the arenas empty at the end, the counts
   held beside the CPU test's on the toy config; (d) the launcher with
   ``--admission-policy sdf --deadline-s 30 --requests 8``;
12. speculative decoding (k = 4) on minitron-4b at full width and its
   plan (512 slots, bf16 KV, the prefix cache at a quarter's retention):
   (a) one ``verify_step_paged`` (#3, T = 5) against five
   ``decode_step_paged`` (#1) on copies of the same pools, 8 live slots
   of 512 at ragged lengths: logits and the K/V rows each wrote held to
   2**-5 of their norm at every row, nothing written outside the live
   rows but the trash page, the lengths returned unchanged; (b) phase
   3's wave plain, with a self-draft (the target's own tensors) and with
   a 4-layer draft (views of the target's first 4 blocks, embedding,
   final norm and head): both launch verify, #3 grows by at least a
   verify launch's 32 layers a launch, the self-draft commits at least 4
   tokens a slot-round, the 4-layer draft rolls back, every chain that
   splits from the plain run's does so where the plain run's top-two
   gap is below (a)'s largest logit difference (each split printed with
   its gap), and the two drafts' chains are identical; (c) the 4-layer
   draft at temperature 0.8 twice on the wave's first 8 requests
   (identical chains and verify launches); (d) the launcher with
   ``--archs minicpm-2b,minitron-4b --draft-arch minitron-4b`` (every
   request served, minicpm-2b's non-speculative note, verify launches);
   (e) mixtral-8x7b at full width and 2 of 32 layers with a self-draft,
   at its capacity factor 1.25 (the verify's drops and the splits
   printed) and at 8 (no drops, (a) repeated, the splits printed, a
   1-layer draft's chains identical to the self-draft's); each run's
   tok/s, speculation counters, launches and peak memory printed;

and a small-input check of each model's logits on the card against the
same model on the CPU (the plain versions): the paged steps, and the
dense ``prefill``/``prefill_chunk``/``decode_step`` of minicpm-2b,
mixtral-8x7b (and a ring of its window) and whisper-large-v3 and
mamba2-2.7b's one-shot prefill; of one sync-mode wave's tokens; of one
training step's loss and gradients, and of one attention layer's
gradients.

The paged-attention launch counts are zeroed just before phase 2 and read
just after phase 3; the SSD scan's just before and after phase 4; every
count again just before phase 5, and flash and decode attention's read
just after it; every count again just before phase 6, and the grouped
GEMM's read just after it; every count again just before phase 7, and the
flash kernels' read just after it (the forward's record sums phases 5 and
7); every count again just before phase 8 (b), and the dense chunk
kernel's read just after it; every count again just before phase 9's
runs, whose paged-attention counts are read just after each run (and
printed, not put in the kernels' record); phase 10 (b) reads the
paged-attention counts before and after each of its runs and holds them
to phase 3's int8 wave's (printed, not put in the record); phase 11 (b)
and (c) print the paged-attention counts of their runs (the resumed and
forked slots' decode and chunk launches), not put in the record; every
count is zeroed just before phase 12 and read just after it (printed,
not put in the record), and phase 12 fails unless #1, #3 and #9
launched.
The last two lines are the card (``nvidia-smi``'s name and power limit)
and ``{"ok": true, "device": ...}``; the line before them is the kernels'
JSON record.  Without a card, or without the repository around it, the
script fails before printing any result.
"""
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
TOL = 1.6e-2
TRAIN_LR = "1e-3"
TRAIN_SHAPE = dict(B=1, Lq=4096, Lk=4096, Hq=36, Hkv=36, D=64)
SOURCES = {"paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu",
           "chunk_prefill_attention":
               "src/repro_torch/kernels/csrc/chunk_attention.cu",
           "grouped_matmul": "src/repro_torch/kernels/csrc/grouped_matmul.cu"}
SSD_STATE_TOL = 1e-3
LSE_TOL = 1e-3
ROW_REL_TOL = 1e-2
ROW_FLOOR = 1e-5
PARITY_TOL = 2 ** -5
RECORD_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:466",
    "paged_decode_attention_quant":
        "src/repro/kernels/decode_attention.py:581",
    "paged_chunk_prefill_attention":
        "src/repro/kernels/decode_attention.py:305",
    "paged_chunk_prefill_attention_quant":
        "src/repro/kernels/decode_attention.py:675",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:85",
    "flash_attention": "src/repro/kernels/flash_attention.py:108",
    "flash_attention_bwd": "src/repro/kernels/flash_attention_bwd.py:156",
    "decode_attention": "src/repro/kernels/decode_attention.py:92",
    "chunk_prefill_attention": "src/repro/kernels/decode_attention.py:208",
    "grouped_matmul": "src/repro/kernels/moe_gemm.py:41",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters=10, reps=5):
    """Median over ``reps`` of the mean time of ``iters`` launches (CUDA
    events, after one warm-up call).  Launches shorter than the host's
    time to issue them are paced by the host: ``graph_ms`` is the device's
    own time."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def graph_ms(fn, iters=20, reps=5):
    """The device's time per launch: ``iters`` launches captured in one
    CUDA graph, replayed between CUDA events ``reps`` times; the median.
    The host issues one replay, so it cannot pace the launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pools(gen, rng, *, B, nblk, bs, Hkv, D, lens, quant):
    """A pool of B*nblk pages plus the trash page, each slot's table
    holding shuffled pages for its blocks below ``lens`` and the trash page
    past them."""
    import torch
    from repro_torch.kernels.quant import QuantPages, quantize
    P1 = B * nblk + 1
    pools = []
    for _ in range(2):
        x = torch.randn(P1, bs, Hkv, D, generator=gen, device="cuda")
        pools.append(QuantPages(*quantize(x)) if quant
                     else x.to(torch.bfloat16))
        del x
    phys = rng.permutation(P1 - 1).reshape(B, nblk)
    used = -(-np.asarray(lens) // bs)
    bt = np.where(np.arange(nblk)[None] < used[:, None], phys, P1 - 1)
    return pools[0], pools[1], torch.from_numpy(bt.astype(np.int32)).cuda()


def kv_bytes(keys, Hkv, D, quant):
    """Bytes of K and V rows (plus int8 scales) for ``keys`` tokens."""
    per = Hkv * D * (1 if quant else 2) + (Hkv * 4 if quant else 0)
    return 2 * keys * per


def bound(nbytes, flops):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def dense_view(pages, tables):
    """(B, Hkv, S, D) bf16 view gathered through the tables, for SDPA."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import QuantPages, dequantize
    if isinstance(pages, QuantPages):
        g = dequantize(ref.paged_gather_ref(pages.values, tables),
                       ref.paged_gather_ref(pages.scales, tables),
                       torch.bfloat16)
    else:
        g = ref.paged_gather_ref(pages, tables)
    return g.transpose(1, 2).contiguous()


def sdpa_fn(q, k, v, mask, Hq):
    """SDPA over (B, H, L, D) with GQA heads repeated up front."""
    import torch
    import torch.nn.functional as F
    rep = Hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decode_case(gen, rng, *, B, Hq, Hkv, D, lens, quant, timed):
    import torch
    from repro_torch.kernels import ops, ref
    bs, nblk = 32, 8
    lens = np.asarray(lens, np.int32)
    k, v, tables = make_pools(gen, rng, B=B, nblk=nblk, bs=bs, Hkv=Hkv,
                              D=D, lens=lens, quant=quant)
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    cl = torch.from_numpy(lens).cuda()
    kernel = lambda: ops.paged_decode_attention(q, k, v, tables, cl)
    out = kernel()
    want = ref.paged_decode_attention_ref(q.float(), k, v, tables, cl)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    check(not out[cl == 0].any(), "paged decode attention: a dead slot's "
          "rows are not zero")
    check(all(torch.equal(out, kernel()) for _ in range(2)),
          "paged decode attention: repeated launches differ")
    # every (slot, head) row held to its own norm
    rec = {"max_abs_err": err, **check_rows("out", out.reshape(1, -1, D),
                                            want.reshape(1, -1, D))}
    if not timed:
        return rec
    S = nblk * bs
    kd, vd = dense_view(k, tables), dense_view(v, tables)
    mask = (torch.arange(S, device="cuda")[None] < cl[:, None])[:, None,
                                                                 None]
    # what this data needs: q and table entries of the slots that hold
    # keys, their K/V once, every slot's length and output row
    keys = int(lens.sum())
    live = int((lens > 0).sum())
    nbytes = (live * Hq * D * 2 + q.numel() * 2 + B * 4
              + int((-(-lens // bs)).sum()) * 4
              + kv_bytes(keys, Hkv, D, quant))
    b_ms, b_by = bound(nbytes, 4 * D * Hq * keys)
    rec.update({"ms": graph_ms(kernel), "host_paced_ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: ref.paged_decode_attention_ref(
                    q, k, v, tables, cl), iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(sdpa_fn(q[:, :, None], kd, vd, mask,
                                               Hq))})
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def chunk_case(gen, rng, *, B, T, Hq, Hkv, D, start, chunk_len, prefix_len,
               quant, timed):
    import torch
    from repro_torch.kernels import ops, ref
    bs, nblk = 32, 8
    start = np.asarray(start, np.int32)
    chunk_len = np.asarray(chunk_len, np.int32)
    end = start + chunk_len
    k, v, tables = make_pools(gen, rng, B=B, nblk=nblk, bs=bs, Hkv=Hkv,
                              D=D, lens=np.maximum(end, 1), quant=quant)
    q = torch.randn(B, T, Hq, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    st, cl = torch.from_numpy(start).cuda(), torch.from_numpy(
        chunk_len).cuda()
    kernel = lambda: ops.paged_chunk_attention(q, k, v, tables, st, cl,
                                               prefix_len=prefix_len)
    out = kernel()
    want = ref.paged_chunk_attention_ref(q.float(), k, v, tables, st, cl,
                                         prefix_len=prefix_len)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    for b, n in enumerate(chunk_len.tolist()):
        check(not out[b, n:].any(), "paged chunk attention: a row past "
              "chunk_len is not zero")
    check(all(torch.equal(out, kernel()) for _ in range(2)),
          "paged chunk attention: repeated launches differ")
    rec = {"max_abs_err": err, **check_rows("out", out, want)}
    if not timed:
        return rec
    # what this data needs: per slot, the keys some live row can see (and
    # their table entries), the visible (row, key) pairs, the live rows' q,
    # every row's output and every slot's start and length
    keys = pairs = entries = 0
    for s, c in zip(start.tolist(), chunk_len.tolist()):
        if c:
            keys += s + c
            entries += -(-(s + c) // bs)
            pairs += sum(min(s + c, max(s + i + 1, prefix_len))
                         for i in range(c))
    nbytes = (int(chunk_len.sum()) * Hq * D * 2 + q.numel() * 2
              + entries * 4 + 2 * B * 4 + kv_bytes(keys, Hkv, D, quant))
    b_ms, b_by = bound(nbytes, 4 * D * Hq * pairs)
    S = nblk * bs
    kpos = torch.arange(S, device="cuda")
    qpos = st[:, None] + torch.arange(T, device="cuda")[None]
    vis = (kpos[None, None] <= qpos[..., None]) | (kpos < prefix_len)
    vis &= kpos[None, None] < (st + cl)[:, None, None]
    kd, vd = dense_view(k, tables), dense_view(v, tables)
    rec.update({"ms": graph_ms(kernel), "host_paced_ms": time_ms(kernel),
                "plain_ms": time_ms(lambda: ref.paged_chunk_attention_ref(
                    q, k, v, tables, st, cl, prefix_len=prefix_len),
                    iters=3, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(sdpa_fn(q.transpose(1, 2), kd, vd,
                                               vis[:, None], Hq))})
    return rec


def ssd_case(gen, *, Bb, L, H=80, P=64, G=1, N=128, chunk=256, timed):
    """The SSD scan on x, B and C sliced from one projection (as the model
    passes them) with a nonzero initial state."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, ssd_scan
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    proj = rand(Bb, L, H * P + 2 * G * N).to(torch.bfloat16)
    x = proj[..., :H * P].reshape(Bb, L, H, P)
    Bm = proj[..., H * P:H * P + G * N].reshape(Bb, L, G, N)
    Cm = proj[..., H * P + G * N:].reshape(Bb, L, G, N)
    dt = F.softplus(rand(Bb, L, H) - 2.0)
    A = -torch.exp(rand(H) * 0.5)
    D = rand(H)
    h0 = rand(Bb, H, P, N)
    run = lambda: ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                               initial_state=h0)
    plain = lambda: ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                        initial_state=h0)
    route = ssd_scan.route(x, Bm, Cm, h0)
    check(route == "vec16", f"ssd_scan {(Bb, L)}: the model's projection "
          f"took the {route} copy route")
    before = ssd_scan.route_launches[route]
    y, h = run()
    check(ssd_scan.route_launches[route] == before + 1,
          f"ssd_scan {(Bb, L)} did not count its {route} launch")
    wy, wh = ref.ssd_chunked_ref(x.float(), dt, A, Bm.float(), Cm.float(),
                                 D, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
          "ssd_scan: non-finite output")
    err = (y.float() - wy).abs().max().item()
    torch.testing.assert_close(y.float(), wy, atol=TOL, rtol=TOL)
    scale = wh.abs().max().item()
    torch.testing.assert_close(h, wh, atol=SSD_STATE_TOL * scale,
                               rtol=SSD_STATE_TOL)
    check(all(torch.equal(y, y2) and torch.equal(h, h2)
              for y2, h2 in (run() for _ in range(2))),
          "ssd_scan: repeated launches differ")
    rec = {"max_abs_err": err,
           "state_max_rel_err": (h - wh).abs().max().item() / scale,
           "ssd_route": route, "bit_identical_repeats": True}
    if not timed:
        return rec
    # what the function needs: x, dt, B, C, A, D and the initial state
    # read once, y and the final state written once; per chunk of q
    # tokens, C.B and M.x over the q(q+1)/2 causal pairs, C.h and the
    # state update over q*P*N each, 2 flops a multiply-add
    Q = min(chunk, max(8, L))
    pairs = qpn = 0
    for c0 in range(0, L, Q):
        q = min(Q, L - c0)
        pairs += q * (q + 1) // 2
        qpn += 2 * q * P * N
    flops = 2 * Bb * H * (pairs * (N + P) + qpn)
    nbytes = (Bb * L * (2 * H * P * 2 + H * 4 + 2 * G * N * 2)
              + 2 * Bb * H * P * N * 4 + 2 * H * 4)
    b_ms, b_by = bound(nbytes, flops)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(plain, iters=3, reps=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def check_rows(name, got, want, rel=ROW_REL_TOL):
    """Holds ``got`` to ``want`` at every sequence position (axis 1 of
    (B, L, ...)): the norm of the difference over the other axes is at
    most ``rel`` (ROW_REL_TOL unless given) of ``want``'s norm there, plus
    ROW_FLOOR per element
    (the rounding noise of a position whose true value is 0, such as dq of
    a row that sees one key).  Unlike atol it scales with each position's
    own size: at 4096 causal keys the late rows' out and the late keys' dk
    and dv are of the order of 1e-2, as large as TOL.  Returns the
    record's entries for ``name``: the normwise error of the whole
    tensor, the worst position's error as a share of its limit, and
    ``want``'s norm and largest magnitude."""
    g = got.float().transpose(0, 1).flatten(1)
    w = want.float().transpose(0, 1).flatten(1)
    diff = g - w
    limit = rel * w.norm(dim=1) + ROW_FLOOR * w.shape[1] ** 0.5
    worst = (diff.norm(dim=1) / limit).max().item()
    check(worst <= 1, f"{name}: a sequence position differs by {worst} of "
          f"its limit ({rel} of its norm + {ROW_FLOOR} an element)")
    return {f"{name}_rel_l2": (diff.norm() / w.norm()).item(),
            f"{name}_worst_row_of_limit": worst,
            f"{name}_ref_norm": w.norm().item(),
            f"{name}_ref_max": w.abs().max().item()}


def flash_case(gen, *, B, Lq, Lk, Hq, Hkv, D, timed, **mask):
    """Flash attention on q, k, v of the model's layout (B, L, H, D), out
    and lse against the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = rand(B, Lq, Hq, D), rand(B, Lk, Hkv, D), rand(B, Lk, Hkv, D)
    run = lambda: flash_attention.flash_attention(q, k, v, **mask)
    plain = lambda: ref.flash_attention_ref(q, k, v, **mask)
    out, lse = run()
    want, want_lse = ref.flash_attention_ref(q.float(), k.float(),
                                             v.float(), **mask)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
          "flash_attention: non-finite output")
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=LSE_TOL)
    lse_err = (lse - want_lse).abs().max().item()
    rec = {"max_abs_err": err, "lse_max_abs_err": lse_err,
           **check_rows("out", out, want)}
    if not timed:
        return rec
    causal = mask.get("causal", True)
    # what the function needs: q, k, v read once, out and lse written
    # once; 4*D flops for each visible (row, key) pair of each query head
    pairs = B * Hq * visible_pairs(Lq, Lk, causal, mask)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, 4 * D * pairs)
    qt, kt, vt = sdpa_layout(q, k, v)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(plain, iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal))})
    rec.update(achieved(4 * D * pairs, rec))
    return rec


def achieved(flops, rec):
    """A timed record's achieved rate (the function's needed operations
    over its graph-replay time) and the share of its bound it reaches."""
    return {"tflops": flops / (rec["ms"] * 1e-3) / 1e12,
            "bound_share": rec["bound_ms"] / rec["ms"]}


def visible_pairs(Lq, Lk, causal, mask):
    """(row, key) pairs a timed flash case computes: all of them, or the
    causal triangle of a square case with no other mask."""
    if not causal:
        return Lq * Lk
    check(Lq == Lk and set(mask) == {"causal"},
          "only unmasked or plain causal square cases are timed")
    return Lq * (Lq + 1) // 2


def sdpa_layout(*ts):
    """(B, L, H, D) tensors -> contiguous (B, H, L, D), GQA heads repeated
    to the first tensor's count, for ``scaled_dot_product_attention``."""
    Hq = ts[0].shape[2]
    return [t.transpose(1, 2).repeat_interleave(Hq // t.shape[2], dim=1)
            .contiguous() for t in ts]


def flash_bwd_case(gen, *, B, Lq, Lk, Hq, Hkv, D, timed, **mask):
    """The flash backward on q, k, v and dout of the model's layout and the
    forward kernel's out and lse, against the plain version on the same
    bf16 inputs (which rounds dS and P to bf16 where the kernel does)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, dout = rand(B, Lq, Hq, D), rand(B, Lq, Hq, D)
    k, v = rand(B, Lk, Hkv, D), rand(B, Lk, Hkv, D)
    out, lse = flash_attention.flash_attention(q, k, v, **mask)
    run = lambda: flash_attention_bwd.flash_attention_bwd(
        q, k, v, out, lse, dout, **mask)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                **mask)
    got, want = run(), plain()
    torch.cuda.synchronize()
    errs, rows = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g).all()),
              f"flash_attention_bwd: non-finite {name}")
        torch.testing.assert_close(g.float(), w.float(), atol=TOL, rtol=TOL)
        errs[name] = (g.float() - w.float()).abs().max().item()
        rows.update(check_rows(name, g, w))
    rec = {"max_abs_err": max(errs.values()), **{f"{n}_max_abs_err": e
                                                 for n, e in errs.items()},
           **rows}
    del got, want
    if not timed:
        return rec
    causal = mask.get("causal", True)
    # what the function needs: q, k, v, out, dout and lse read once, dq,
    # dk and dv written once; five products of 2*D flops for each visible
    # (row, key) pair of each query head (S, dP, dV, dK, dQ: P is not
    # stored, so S is part of the work)
    pairs = B * Hq * visible_pairs(Lq, Lk, causal, mask)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + out.numel() + dout.numel()) + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, 5 * 2 * D * pairs)
    qt, kt, vt = (t.requires_grad_(True) for t in sdpa_layout(q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = sdpa_layout(dout)[0]
    library = lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                          retain_graph=True)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(plain, iters=1, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(library)})
    rec.update(achieved(5 * 2 * D * pairs, rec))
    return rec


def training_kernels(gen):
    """The flash backward's record at the training path's shape, with
    max_abs_err over every case, and the flash forward timed at that
    shape (printed)."""
    import torch
    fwd = flash_case(gen, causal=True, timed=True, **TRAIN_SHAPE)
    print(f"  flash_attention, training shape (1 x 4096 x 4096, 36 heads, "
          f"D = 64, causal): {fwd}")
    rec = flash_bwd_case(gen, causal=True, timed=True, **TRAIN_SHAPE)
    errs = [rec["max_abs_err"]]
    small = dict(B=2, Lq=100, Lk=100, Hq=4, Hkv=4, D=64)
    cases = [
        dict(small, Hq=8, Hkv=2, D=128, causal=True),
        dict(small, Lq=70, Lk=90, Hq=2, Hkv=1, D=256, causal=True),
        dict(small, causal=True, window=17),
        dict(small, Lq=40, Lk=150, causal=False),
        dict(small, Lq=33, Lk=200, D=128, causal=True, q_offset=150,
             kv_len=170),
        dict(small, Lq=150, Lk=150, causal=True, prefix_len=100),
        dict(small, Lq=70, Lk=60, causal=True, window=5, kv_len=20),
        # several tiles of both kernels' streamed loops
        dict(small, B=1, Lq=300, Lk=300, causal=True),
        dict(small, B=1, Lq=300, Lk=300, causal=True, window=100),
        dict(small, B=1, Lq=200, Lk=230, Hq=4, Hkv=2, D=256, causal=True),
    ]
    worst = 0.0
    for case in cases:
        odd = flash_bwd_case(gen, timed=False, **case)
        errs.append(odd["max_abs_err"])
        worst = max(worst, *(odd[f"{n}_worst_row_of_limit"]
                             for n in ("dq", "dk", "dv")))
    rec["max_abs_err"] = max(errs)
    rec["odd_shapes_worst_row_of_limit"] = worst
    torch.cuda.empty_cache()
    return fwd, rec


def dense_decode_case(gen, *, B, S, Hq, Hkv, D, lens, timed, window=None):
    """Dense decode attention against the plain version, on caches laid
    out as the model's cross K/V state (B, S, Hkv, D)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = rand(B, Hq, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)
    cl = torch.as_tensor(np.asarray(lens, np.int32)).cuda()
    run = lambda: decode_attention.decode_attention(q, k, v, cl,
                                                    window=window)
    out = run()
    want = ref.decode_attention_ref(q.float(), k.float(), v.float(), cl,
                                    window=window)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    check(not out[cl == 0].any(), "decode_attention: an empty slot's row "
          "is not zero")
    rec = {"max_abs_err": err}
    if not timed:
        return rec
    check(window is None, "only unwindowed cases are timed")
    # what this data needs: q of the slots with keys, their visible K/V
    # rows once, every slot's length and output row
    keys = int(np.minimum(np.asarray(lens), S).sum())
    live = int((np.asarray(lens) > 0).sum())
    nbytes = (live * Hq * D * 2 + B * 4 + q.numel() * 2
              + 2 * keys * Hkv * D * 2)
    b_ms, b_by = bound(nbytes, 4 * D * Hq * keys)
    mask = (torch.arange(S, device="cuda")[None] < cl[:, None])[:, None,
                                                                 None]
    rep = Hq // Hkv
    kt = k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(lambda: ref.decode_attention_ref(
                    q, k, v, cl), iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kt, vt, attn_mask=mask))})
    return rec


def whisper_kernels(gen):
    """Records of flash and decode attention at whisper-large-v3's
    main-path shapes; max_abs_err over every case of the kernel."""
    import torch
    whisper = dict(Hq=20, Hkv=20, D=64)
    records = {}
    # the encoder's self-attention (the record) and a decoder chunk's
    # cross-attention, a 128-row bucket against the 1500 frames
    rec = flash_case(gen, B=1, Lq=1500, Lk=1500, causal=False, timed=True,
                     **whisper)
    cross = flash_case(gen, B=1, Lq=128, Lk=1500, causal=False, timed=True,
                       **whisper)
    print(f"  flash_attention, cross-attention chunk shape: {cross}")
    errs, lse_errs = [rec["max_abs_err"], cross["max_abs_err"]], \
        [rec["lse_max_abs_err"], cross["lse_max_abs_err"]]
    small = dict(B=2, Lq=100, Lk=100, Hq=4, Hkv=4, D=64)
    cases = [
        dict(small, causal=True),
        dict(small, causal=True, window=17),
        dict(small, causal=True, prefix_len=70),
        dict(small, causal=True, window=9, prefix_len=30),
        dict(small, Lq=33, Lk=200, causal=True, q_offset=150, kv_len=170),
        dict(small, Hq=8, Hkv=2, causal=True),
        dict(small, Lq=70, Lk=150, D=128, causal=False),
        dict(small, Lq=70, Lk=150, D=256, Hkv=2, causal=True),
        dict(small, Lq=40, Lk=30, causal=True, window=4, kv_len=10),
        # several key and query tiles: the diagonal inside a tile, a
        # window's lower edge across tiles, a prefix past the first query
        # tile, D = 128 and 256 (32-key tiles)
        dict(small, B=1, Lq=300, Lk=300, causal=True),
        dict(small, B=1, Lq=300, Lk=300, causal=True, window=100),
        dict(small, B=1, Lq=200, Lk=200, causal=True, prefix_len=100),
        dict(small, B=1, Lq=260, Lk=260, D=128, causal=True, window=70),
        dict(small, B=1, Lq=200, Lk=230, Hkv=2, D=256, causal=False),
    ]
    for case in cases:
        r = flash_case(gen, timed=False, **case)
        errs.append(r["max_abs_err"])
        lse_errs.append(r["lse_max_abs_err"])
    rec["max_abs_err"], rec["lse_max_abs_err"] = max(errs), max(lse_errs)
    records["flash_attention"] = rec
    # phase 5's cross-attention decode: 128 slots, 32 live at the
    # encoder's 1500 keys (dead slots get length 0), then every slot live
    lens = np.zeros(128, np.int64)
    lens[:32] = 1500
    rec = dense_decode_case(gen, B=128, S=1500, lens=lens, timed=True,
                            **whisper)
    full = dense_decode_case(gen, B=128, S=1500, lens=np.full(128, 1500),
                             timed=True, **whisper)
    print(f"  decode_attention, all 128 slots live: {full}")
    gqa = dense_decode_case(gen, B=16, S=700, Hq=32, Hkv=8, D=128,
                            lens=np.linspace(0, 700, 16).astype(int),
                            window=100, timed=False)
    rec["max_abs_err"] = max(rec["max_abs_err"], full["max_abs_err"],
                             gqa["max_abs_err"])
    records["decode_attention"] = rec
    torch.cuda.empty_cache()
    return records


def dense_chunk_case(gen, *, B, T, S, Hq, Hkv, D, start, chunk_len,
                     prefix_len=0, timed=False):
    """The dense chunked-prefill kernel against the plain version on the
    same bf16 inputs, held by ``check_rows`` and atol = rtol = TOL; rows
    past chunk_len must be zeros.  Untimed cases read K and V in place
    from one wider (B, S, 2 * Hkv, D) buffer (head and sequence strides
    that are not the tensor's own); the timed one is one layer of the
    serving path's stacked dense view, contiguous."""
    import torch
    from repro_torch.kernels import chunk_attention, ops, ref
    rand = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(
        torch.bfloat16)
    q = rand(B, T, Hq, D)
    if timed:
        k, v = rand(B, S, Hkv, D), rand(B, S, Hkv, D)
    else:
        kv = rand(B, S, 2 * Hkv, D)
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
    start = np.asarray(start, np.int32)
    chunk_len = np.asarray(chunk_len, np.int32)
    st, cl = (torch.from_numpy(a).cuda() for a in (start, chunk_len))
    out = ops.chunk_attention(q, k, v, st, cl, prefix_len=prefix_len)
    want = ref.chunk_attention_ref(q.float(), k.float(), v.float(), st, cl,
                                   prefix_len=prefix_len)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    for b, n in enumerate(chunk_len.tolist()):
        check(not out[b, n:].any(), "chunk_prefill_attention: a row past "
              "chunk_len is not zero")
    check(all(torch.equal(out, ops.chunk_attention(
        q, k, v, st, cl, prefix_len=prefix_len)) for _ in range(2)),
        "chunk_prefill_attention: repeated launches differ")
    rec = {"max_abs_err": err, "bit_identical_repeats": True,
           **check_rows("out", out, want)}
    if not timed:
        return rec
    # what this data needs: per slot, the K/V rows some live row can see,
    # read once, the live rows' q, every row's output, start and length;
    # 4*D flops for each visible (row, key) pair of each query head
    keys = pairs = 0
    for s0, c in zip(start.tolist(), chunk_len.tolist()):
        if c:
            keys += s0 + c
            pairs += sum(min(s0 + c, max(s0 + i + 1, prefix_len))
                         for i in range(c))
    nbytes = (int(chunk_len.sum()) * Hq * D * 2 + q.numel() * 2
              + 2 * B * 4 + 2 * keys * Hkv * D * 2)
    b_ms, b_by = bound(nbytes, 4 * D * Hq * pairs)
    kpos = torch.arange(S, device="cuda")
    qpos = st[:, None] + torch.arange(T, device="cuda")[None]
    vis = (kpos[None, None] <= qpos[..., None]) | (kpos < prefix_len)
    vis &= kpos[None, None] < (st + cl)[:, None, None]
    run = lambda: chunk_attention.chunk_prefill_attention(
        q, k, v, st, cl, prefix_len=prefix_len)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(lambda: ref.chunk_attention_ref(
                    q, k, v, st, cl, prefix_len=prefix_len), iters=3,
                    reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(sdpa_fn(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    vis[:, None], Hq))})
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def chunk_kernels(gen):
    """The dense chunk kernel's record at minicpm-2b's chunk shape in the
    dense-view step (one slot, a 128-row bucket at offset 64, S = 256, 36
    heads, D = 64), beside SDPA with the same boolean mask; then odd
    shapes: mixtral's GQA 32/8 at D = 128 over B = 3 with per-row start
    and chunk_len (one row empty), a prefix of 40, T = 13 and S = 300 (not
    a multiple of the 64-key tile); minicpm's heads at S = 200 with a
    ragged row; MQA with a prefix; and more than one tile: T = 130 over
    three 64-row tiles at start 63, S = 700 over eleven key tiles, GQA
    32/8 at D = 128 with a prefix of 100.  max_abs_err and the worst row's
    share of its limit over every case; every case's repeated launches
    are bit-identical."""
    import torch
    rec = dense_chunk_case(gen, B=1, T=128, S=256, Hq=36, Hkv=36, D=64,
                           start=[64], chunk_len=[128], timed=True)
    cases = [
        dict(B=3, T=13, S=300, Hq=32, Hkv=8, D=128, start=[0, 40, 287],
             chunk_len=[13, 0, 13], prefix_len=40),
        dict(B=2, T=128, S=200, Hq=36, Hkv=36, D=64, start=[0, 100],
             chunk_len=[128, 77]),
        dict(B=1, T=40, S=97, Hq=8, Hkv=1, D=64, start=[57],
             chunk_len=[40], prefix_len=20),
        dict(B=2, T=130, S=256, Hq=36, Hkv=36, D=64, start=[63, 0],
             chunk_len=[130, 101]),
        dict(B=2, T=64, S=700, Hq=36, Hkv=36, D=64, start=[636, 300],
             chunk_len=[64, 64]),
        dict(B=2, T=128, S=400, Hq=32, Hkv=8, D=128, start=[0, 200],
             chunk_len=[128, 90], prefix_len=100),
    ]
    worst = rec["out_worst_row_of_limit"]
    for case in cases:
        r = dense_chunk_case(gen, **case)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        worst = max(worst, r["out_worst_row_of_limit"])
    rec["odd_shapes_worst_row_of_limit"] = worst
    torch.cuda.empty_cache()
    return rec


def gmm_case(gen, *, E, C, K, N, timed, route=None, lhs_pad=0):
    """The grouped GEMM on bf16 operands against the plain version on their
    f32 copies (what the kernel sums before its one rounding to bf16),
    held by atol = rtol = TOL and, at every row, by ``check_rows``;
    repeated launches must give identical outputs.  ``route``: the route
    the operands must take; ``lhs_pad`` > 0 reads lhs in place from a
    wider (E, C, K + lhs_pad) buffer (a row stride above K).  A timed
    record also carries its achieved TFLOP/s and share of the bound."""
    import torch
    from repro_torch.kernels import grouped_matmul, ref
    lhs = torch.randn(E, C, K + lhs_pad, generator=gen, device="cuda").to(
        torch.bfloat16)[:, :, :K]
    rhs = torch.randn(E, K, N, generator=gen, device="cuda").to(
        torch.bfloat16)
    which = grouped_matmul.route(lhs, rhs)
    check(route is None or which == route,
          f"grouped_matmul {(E, C, K, N)}: route {which}, not {route}")
    before = dict(grouped_matmul.route_launches)
    run = lambda: grouped_matmul.grouped_matmul(lhs, rhs)
    out = run()
    check(grouped_matmul.route_launches[which] == before[which] + 1,
          f"grouped_matmul {(E, C, K, N)} did not count its {which} launch")
    want = ref.grouped_matmul_ref(lhs.float(), rhs.float())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "grouped_matmul: non-finite output")
    err = (out.float() - want).abs().max().item()
    torch.testing.assert_close(out.float(), want, atol=TOL, rtol=TOL)
    check(all(torch.equal(out, run()) for _ in range(2)),
          f"grouped_matmul {(E, C, K, N)}: repeated launches differ")
    # rows of (E, C, N): position c over experts and columns
    rec = {"max_abs_err": err, "gemm_route": which,
           "out_max_abs": want.abs().max().item(),
           **check_rows("out", out, want)}
    del out, want
    if not timed:
        return rec
    # what the function needs: both operands read once, the output written
    # once; 2 flops a multiply-add over every (expert, row, column, k)
    flops = 2 * E * C * K * N
    nbytes = 2 * (lhs.numel() + rhs.numel() + E * C * N)
    b_ms, b_by = bound(nbytes, flops)
    rec.update({"ms": graph_ms(run), "host_paced_ms": time_ms(run),
                "plain_ms": time_ms(lambda: ref.grouped_matmul_ref(
                    lhs, rhs), iters=2, reps=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(lambda: torch.bmm(lhs, rhs))})
    rec.update(achieved(flops, rec))
    return rec


def mixtral_kernels(gen, rng):
    """The grouped GEMM's record at mixtral-8x7b's decode shape (every slot
    its own routing group: 512 rows an expert, gate/up projection), with
    max_abs_err over every case; and the bf16 paged decode and chunk
    kernels at mixtral's attention shapes, whose errors join those
    kernels' records."""
    import torch
    rec = gmm_case(gen, E=8, C=512, K=4096, N=14336, timed=True,
                   route="tma")
    errs = [rec["max_abs_err"]]
    for name, shape in (("decode down projection", (8, 512, 14336, 4096)),
                        ("chunk, 20 rows an expert", (8, 20, 4096, 14336))):
        E, C, K, N = shape
        r = gmm_case(gen, E=E, C=C, K=K, N=N, timed=True, route="tma")
        print(f"  grouped_matmul, {name} {shape}: {r}")
        errs.append(r["max_abs_err"])
        torch.cuda.empty_cache()
    # odd shapes: the unaligned one on the mma.sync route, the rest on the
    # TMA route (C around the 128-row tile, a ragged 256-column N tile, an
    # lhs row stride above K)
    odd = [((4, 50, 70, 33), "mma_sync", 0), ((8, 10, 200, 16), "tma", 0),
           ((4, 1, 256, 384), "tma", 0)]
    odd += [((4, C, 512, 264), "tma", 0) for C in (1, 63, 64, 65, 200)]
    odd += [((3, 70, 256, 200), "tma", 24)]
    for (E, C, K, N), route, pad in odd:
        r = gmm_case(gen, E=E, C=C, K=K, N=N, timed=False, route=route,
                     lhs_pad=pad)
        errs.append(r["max_abs_err"])
        rec["odd_shapes_worst_row_of_limit"] = max(
            rec.get("odd_shapes_worst_row_of_limit", 0.0),
            r["out_worst_row_of_limit"])
    rec["max_abs_err"] = max(errs)
    torch.cuda.empty_cache()
    # phase 6's decode attention: 512 slots, 32 live half-way through
    # generation, GQA 32 heads over 8 KV heads, D = 128
    lens = np.zeros(512, np.int64)
    lens[:32] = np.linspace(6, 200, 32).astype(int) + 20
    attn = decode_case(gen, rng, B=512, lens=lens, quant=False, timed=True,
                       Hq=32, Hkv=8, D=128)
    print(f"  paged_decode_attention, mixtral-8x7b shape (512 slots, 32 "
          f"live, 32/8 heads, D = 128): {attn}")
    # phase 6's chunked prefill: one slot a call, a 64-row bucket timed and
    # a ragged 32-row one checked, same heads
    mixtral = dict(Hq=32, Hkv=8, D=128, prefix_len=0, quant=False)
    chunk = chunk_case(gen, rng, B=1, T=64, start=[64], chunk_len=[64],
                       timed=True, **mixtral)
    print(f"  paged_chunk_prefill_attention, mixtral-8x7b shape (one slot, "
          f"64 rows, 32/8 heads, D = 128): {chunk}")
    chunk_err = max(chunk["max_abs_err"], chunk_case(
        gen, rng, B=1, T=32, start=[0], chunk_len=[19], timed=False,
        **mixtral)["max_abs_err"])
    torch.cuda.empty_cache()
    return rec, attn["max_abs_err"], chunk_err


def chunk_odd_cases(minicpm, gqa):
    """(heads, case) pairs of the paged chunk kernels' odd shapes: ragged
    slots with a dead one among four, a prefix of 0, 20 and 100 (past the
    first 64-row tile), T = 13 and 65 (ragged row tiles), starts that are
    multiples of neither 64 nor the 32-token page, chunks that start at a
    prefix-cache hit (mid-page, and a full-prompt hit's one valid row), at
    minicpm's heads, a GQA shape, and mixtral's 32/8 heads at D = 128."""
    mixtral = dict(Hq=32, Hkv=8, D=128)
    for shape in (minicpm, gqa, mixtral):
        for prefix_len in (0, 20, 100):
            yield shape, dict(B=4, T=128, start=[0, 40, 100, 200],
                              chunk_len=[128, 90, 0, 56],
                              prefix_len=prefix_len)
        yield shape, dict(B=4, T=13, start=[5, 37, 0, 77],
                          chunk_len=[13, 13, 0, 9], prefix_len=100)
        yield shape, dict(B=4, T=65, start=[3, 37, 0, 130],
                          chunk_len=[65, 60, 0, 1], prefix_len=0)
        # prefix-cache hits (phase 9): chunks from mid-page, after a
        # 150-token template, and a full-prompt hit's one row
        yield shape, dict(B=4, T=32, start=[150, 150, 0, 189],
                          chunk_len=[32, 8, 0, 1], prefix_len=0)


def verify_cases(rec, quant, heads):
    """The chunk kernel at phase 12's verify launch: 512 slots, T = SPEC_K
    + 1 = 5 rows (a 64-row tile holds 5 live rows), minitron-4b's 24/8
    heads at D = 128, ragged starts crossing pages; chunk_len 5 for 32
    slots and 0 for the rest, then for all 512.  Each case is held as the
    odd shapes are, timed, and put in ``rec`` under its name (its own
    generators, so that the other cases draw what they drew before)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rng = np.random.default_rng(2)
    T = SPEC_K + 1
    start = rng.integers(0, 256 - T + 1, 512)
    start[:8] = (0, 27, 28, 31, 32, 60, 100, 251)     # around page ends
    spec = np.zeros(512, np.int32)
    spec[::16] = T
    for name, cl in (("verify_32_of_512", spec),
                     ("verify_512_of_512", np.full(512, T, np.int32))):
        r = chunk_case(gen, rng, B=512, T=T, start=start, chunk_len=cl,
                       prefix_len=0, quant=quant, timed=True, **heads)
        rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
        rec["odd_shapes_worst_row_of_limit"] = max(
            rec["odd_shapes_worst_row_of_limit"],
            r["out_worst_row_of_limit"])
        rec[name] = {key: r[key] for key in (
            "ms", "host_paced_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "out_worst_row_of_limit")}
        rec[name]["bound_share"] = r["bound_ms"] / r["ms"]
        print(f"  paged_chunk_prefill_attention{'_quant' if quant else ''}"
              f", {name}: {rec[name]}")


def phase_kernels():
    """Returns {kernel name: record} at minicpm-2b's main-path shapes, with
    max_abs_err over every case of that kernel."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    minicpm = dict(Hq=36, Hkv=36, D=64)
    gqa = dict(Hq=24, Hkv=8, D=128)
    records = {}
    # phase 3's decode: 512 slots (the plan's capacity), 32 live at their
    # lengths half-way through generation, the other slots empty
    path_lens = np.zeros(512, np.int64)
    path_lens[:32] = np.linspace(6, 200, 32).astype(int) + 20
    decode_ptxas = {kern: r for kern, r in ptxas_record(
        "paged_attention").items() if kern.startswith("paged_decode")}
    for quant in (False, True):
        tag = "_quant" if quant else ""
        rec = decode_case(gen, rng, B=512, lens=path_lens, quant=quant,
                          timed=True, **minicpm)
        # every slot live, ragged lengths over the slot budget crossing
        # page boundaries, trash past each length
        lens = rng.integers(1, 257, 512)
        lens[:4] = (1, 32, 33, 256)
        full = decode_case(gen, rng, B=512, lens=lens, quant=quant,
                           timed=True, **minicpm)
        print(f"  paged_decode_attention{tag}, all 512 slots live: {full}")
        rec["all_live"] = {key: full[key] for key in (
            "ms", "bound_ms", "bound_share", "library_ms", "max_abs_err",
            "out_worst_row_of_limit")}
        rec["gqa_err"] = max(full["max_abs_err"], decode_case(
            gen, rng, B=64, lens=rng.integers(0, 257, 64), quant=quant,
            timed=False, **gqa)["max_abs_err"])
        # the dead-slot yardstick: the same 32 lengths, 32 slots all live
        # (its own generators, so that every other case draws what it drew
        # before the yardstick was added)
        few_gen = torch.Generator(device="cuda")
        few_gen.manual_seed(1)
        few = decode_case(few_gen, np.random.default_rng(1), B=32,
                          lens=path_lens[:32], quant=quant, timed=True,
                          **minicpm)
        rec["gqa_err"] = max(rec["gqa_err"], few["max_abs_err"])
        rec["live32_of_32_ms"] = few["ms"]
        rec["ms_over_live32_of_32"] = rec["ms"] / few["ms"]
        rec["ptxas"] = {kern: r for kern, r in decode_ptxas.items()
                        if ("int8" in kern) == quant}
        records["paged_decode_attention" + tag] = rec
        # chunked prefill: the path's shape (one slot, a 128-row bucket)
        # timed; then odd shapes, each also held by check_rows
        rec = chunk_case(gen, rng, B=1, T=128, start=[64], chunk_len=[128],
                         prefix_len=0, quant=quant, timed=True, **minicpm)
        rec["odd_shapes_worst_row_of_limit"] = rec["out_worst_row_of_limit"]
        for shape, case in chunk_odd_cases(minicpm, gqa):
            r = chunk_case(gen, rng, quant=quant, timed=False, **shape,
                           **case)
            rec["max_abs_err"] = max(rec["max_abs_err"], r["max_abs_err"])
            rec["odd_shapes_worst_row_of_limit"] = max(
                rec["odd_shapes_worst_row_of_limit"],
                r["out_worst_row_of_limit"])
        verify_cases(rec, quant, gqa)
        records["paged_chunk_prefill_attention" + tag] = rec
        torch.cuda.empty_cache()
    for rec in records.values():
        rec["max_abs_err"] = max(rec["max_abs_err"], rec.pop("gqa_err", 0.0))
    # SSD scan at mamba2-2.7b's chunk-call shapes: one slot, a 32- and a
    # 128-token bucket (one chunk each); the timed record is the 128 one.
    # Then two slots of 300 tokens in chunks of 256: two chunks, the second
    # ragged
    short = ssd_case(gen, Bb=1, L=32, timed=True)
    print(f"  ssd_scan, one slot, 32 tokens: {short}")
    rec = ssd_case(gen, Bb=1, L=128, timed=True)
    long = ssd_case(gen, Bb=2, L=300, timed=False)
    for key in ("max_abs_err", "state_max_rel_err"):
        rec[key] = max(rec[key], short[key], long[key])
    rec["ptxas"] = ptxas_record("ssd_scan")
    records["ssd_scan"] = rec
    records.update(whisper_kernels(gen))
    records["chunk_prefill_attention"] = chunk_kernels(gen)
    records["chunk_prefill_attention"]["ptxas"] = ptxas_record(
        "chunk_attention")
    _, records["flash_attention_bwd"] = training_kernels(gen)
    records["grouped_matmul"], attn_err, chunk_err = mixtral_kernels(gen,
                                                                    rng)
    for name, e in (("paged_decode_attention", attn_err),
                    ("paged_chunk_prefill_attention", chunk_err)):
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], e)
    return records


# ---------------------------------------------------------------------------
# phases 2 and 3: the serving main path
# ---------------------------------------------------------------------------

def prefix_counters(rt):
    """A runtime's prefix-cache totals, as the launcher prints them."""
    return (f"prefix cache {'on' if rt.prefix_cache_enabled else 'off'}: "
            f"{rt.prefix_hits} hits, {rt.prefix_hit_tokens} prompt tokens "
            f"reused, {rt.prefill_tokens_computed} computed, "
            f"{rt.prefix_cow_copies} COW copies, {rt.prefix_evictions} LRU "
            f"evictions")


def phase_launcher():
    from repro_torch.launch import serve
    rc = serve.main(["--archs", "minicpm-2b", "--requests", "8",
                     "--max-new-tokens", "16"])
    check(rc == 0, f"launcher exited {rc}")


def wave(kv_dtype, n_requests=32, new_tokens=40):
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    cfg, rt = wave_runtime(kv_dtype, n_requests, new_tokens)
    launches0 = dict(paged_attention.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(len(results) == n_requests,
          f"{kv_dtype} wave served {len(results)}/{n_requests}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    n_tok = sum(len(t) for t in toks.values())
    grown = {k: paged_attention.launches[k] - launches0[k]
             for k in paged_attention.launches}
    print(f"phase 3 ({kv_dtype} KV): served {len(results)}/{n_requests}, "
          f"{n_tok} tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s, "
          f"{rt.decode_steps} decode steps, {rt.prefill_chunk_calls} "
          f"prefill chunks, launches {grown}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
          f"{prefix_counters(rt)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return toks, grown, n_tok / dt


def wave_mamba2(n_requests=32, new_tokens=40):
    """Phase 4: the request wave through mamba2-2.7b's state path."""
    import torch
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime(-1, n_requests, new_tokens, arch="mamba2-2.7b")
    mem_weights = torch.cuda.memory_allocated()
    check(rt.plan.max_in_flight == 128 and rt.plan.sticky,
          f"unexpected mamba2-2.7b plan {rt.plan}")
    ssd_scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = ssd_scan.launches["ssd_scan"]
    routes = dict(ssd_scan.route_launches)
    check(len(results) == n_requests,
          f"mamba2-2.7b wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    arena = rt.groups[0].arena
    # layer by layer: isfinite over a whole 21.5 GB stack would allocate
    # more than the stack itself
    check(all(bool(torch.isfinite(layer).all()) for st in arena.state
              for layer in st), "non-finite SSM state")
    check(launches > 0, "the mamba2-2.7b wave never launched ssd_scan")
    check(routes["vec16"] == launches,
          f"a mamba2-2.7b scan left the 16-byte copy route: {routes}")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 4 (mamba2-2.7b, {arena.capacity} slots, "
          f"{arena.state_slot_bytes / 1e6:.1f} MB of state a slot): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.decode_steps} decode steps, "
          f"{rt.prefill_chunk_calls} prefill chunks, ssd_scan launches "
          f"{launches} (by copy route {routes}), memory (GB) before "
          f"{mem0 / 1e9:.2f}, with weights "
          f"{mem_weights / 1e9:.2f}, after "
          f"{torch.cuda.memory_allocated() / 1e9:.2f}, peak {peak / 1e9:.2f}, "
          f"{prefix_counters(rt)}")
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def wave_whisper(n_requests=32, new_tokens=40):
    """Phase 5: the request wave through whisper-large-v3's encoder-decoder
    path; every launch count is zeroed just before it and read just after.
    Returns the counts."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.kernels.ops import launch_counts
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime(-1, n_requests, new_tokens,
                           arch="whisper-large-v3")
    mem_weights = torch.cuda.memory_allocated()
    check(rt.plan.max_in_flight == 128 and rt.kv_dtype == "int8",
          f"unexpected whisper-large-v3 plan {rt.plan}")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"whisper-large-v3 wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    arena = rt.groups[0].arena
    check(arena.state_slot_bytes == 245_760_000,
          f"cross K/V state is {arena.state_slot_bytes} B a slot")
    # layer by layer: isfinite over a whole 15.7 GB stack would allocate
    # more than the stack itself
    check(all(bool(torch.isfinite(layer).all()) for st in arena.state
              for layer in st), "non-finite cross K/V state")
    for name in ("flash_attention", "decode_attention",
                 "paged_decode_attention_quant",
                 "paged_chunk_prefill_attention_quant"):
        check(launches[name] > 0,
              f"the whisper-large-v3 wave never launched {name}: {launches}")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 5 (whisper-large-v3, {arena.capacity} slots, "
          f"{arena.state_slot_bytes / 1e6:.2f} MB of cross K/V a slot, "
          f"{rt.kv_dtype} KV): served {len(results)}/{n_requests}, {n_tok} "
          f"tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s, "
          f"{rt.decode_steps} decode steps, {rt.prefill_chunk_calls} "
          f"prefill chunks, launches {launches}, memory (GB) before "
          f"{mem0 / 1e9:.2f}, with weights {mem_weights / 1e9:.2f}, after "
          f"{torch.cuda.memory_allocated() / 1e9:.2f}, peak {peak / 1e9:.2f}, "
          f"{prefix_counters(rt)}")
    print("phase 5 greedy tokens: " + json.dumps(
        [np.asarray(r.tokens).tolist() for r in
         sorted(results, key=lambda r: r.rid)]))
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def wave_mixtral(n_requests=32, new_tokens=40):
    """Phase 6: the request wave through mixtral-8x7b's MoE path at 16 of
    its 32 layers; every launch count is zeroed just before it and read
    just after.  Returns the counts."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.kernels import grouped_matmul
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models import moe
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime(-1, n_requests, new_tokens, arch="mixtral-8x7b")
    mem_weights = torch.cuda.memory_allocated()
    check((cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts,
           cfg.moe_capacity_factor) == (16, 4096, 14336, 8, 1.25)
          and rt.plan.max_in_flight == 512 and rt.kv_dtype == "bf16",
          f"unexpected mixtral-8x7b wave {cfg} {rt.plan}")
    stats = moe.MOE_DROP_STATS
    stats.flush()
    drop0, assigned0 = stats.dropped, stats.assigned
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, step_drops = [], []
    for _ in range(10_000):
        if not (rt.pending() or rt.in_flight()):
            break
        st = rt.step(max_wait_s=0.0)
        results.extend(st.results)
        step_drops.append(st.moe_dropped_tokens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    routes = dict(grouped_matmul.route_launches)
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"mixtral-8x7b wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    calls = rt.decode_steps + rt.prefill_chunk_calls
    check(launches["grouped_matmul"] == 3 * cfg.num_layers * calls,
          f"grouped_matmul launched {launches['grouped_matmul']} times, "
          f"not 3 a layer in each of {calls} steps and chunks")
    check(routes["tma"] == launches["grouped_matmul"],
          f"a grouped GEMM launch of the wave left the TMA route: {routes}")
    for name in ("grouped_matmul", "paged_decode_attention",
                 "paged_chunk_prefill_attention"):
        check(launches[name] > 0,
              f"the mixtral-8x7b wave never launched {name}: {launches}")
    arena = rt.groups[0].arena
    check(all(bool(torch.isfinite(layer).all()) for pool in arena.pages
              for layer in pool), "non-finite K/V pools")
    dropped = stats.dropped - drop0
    assigned = stats.assigned - assigned0
    check(dropped == sum(step_drops), "per-step drops do not add up")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 6 (mixtral-8x7b, {cfg.num_layers} of 32 layers, "
          f"{arena.capacity} slots, {rt.kv_dtype} KV): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.decode_steps} decode steps, "
          f"{rt.prefill_chunk_calls} prefill chunks, launches {launches}, "
          f"grouped GEMM routes {routes}, "
          f"expert-capacity drops {dropped:.0f} of {assigned:.0f} "
          f"assignments ({dropped / max(assigned, 1.0):.4f}), memory (GB) "
          f"before {mem0 / 1e9:.2f}, with weights {mem_weights / 1e9:.2f}, "
          f"after {torch.cuda.memory_allocated() / 1e9:.2f}, peak "
          f"{peak / 1e9:.2f}, {prefix_counters(rt)}")
    print("phase 6 greedy tokens: " + json.dumps(
        [np.asarray(r.tokens).tolist() for r in
         sorted(results, key=lambda r: r.rid)]))
    del rt, arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8: the sync and dense-cache paths
# ---------------------------------------------------------------------------

def phase_dense_launchers():
    """Phase 8 (a): the launcher at full width in sync mode, with the dense
    cache, and with one-shot prefill."""
    import torch
    from repro_torch.launch import serve
    for flags in (["--mode", "sync"], ["--kvcache-impl", "dense"],
                  ["--no-chunked-prefill"]):
        rc = serve.main(["--archs", "minicpm-2b", "--requests", "8",
                         "--max-new-tokens", "16", *flags])
        check(rc == 0, f"launcher {flags} exited {rc}")
        gc.collect()
        torch.cuda.empty_cache()


def wave_oracle(n_requests=32, new_tokens=40):
    """Phase 8 (b): phase 3's wave through the dense-view step
    (``paged_native=False``, the reference's oracle) at 128 slots, bf16
    KV; every launch count is zeroed just before it and read just after.
    Returns (the counts, tokens by rid)."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    cfg, rt = wave_runtime("bf16", n_requests, new_tokens, bs=128,
                           paged_native=False)
    check(rt.plan.max_in_flight == 128 and not rt.paged_native
          and rt.chunked_prefill and rt.kv_dtype == "bf16",
          f"unexpected oracle runtime {rt.plan}")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"oracle wave served {len(results)}/{n_requests}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    check(launches["chunk_prefill_attention"]
          == cfg.num_layers * rt.prefill_chunk_calls > 0,
          f"chunk_prefill_attention launched "
          f"{launches['chunk_prefill_attention']} times, not "
          f"{cfg.num_layers} in each of {rt.prefill_chunk_calls} chunks")
    check(launches["decode_attention"] == cfg.num_layers * rt.decode_steps
          > 0, f"decode_attention launched {launches['decode_attention']} "
          f"times, not {cfg.num_layers} in each of {rt.decode_steps} steps")
    check(not any(n for k, n in launches.items() if k.startswith("paged")),
          f"the oracle launched a paged kernel: {launches}")
    n_tok = sum(len(t) for t in toks.values())
    print(f"phase 8 (b) oracle wave (minicpm-2b, dense-view step, "
          f"{rt.plan.max_in_flight} slots, bf16 KV): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.decode_steps} decode steps, "
          f"{rt.prefill_chunk_calls} prefill chunks, launches {launches}, "
          f"memory (GB) before {mem0 / 1e9:.2f}, peak {peak / 1e9:.2f}, "
          f"{prefix_counters(rt)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, toks


def parity_logits(cfg, params, chunks=(64, 64, 37), steps=3):
    """One slot of two in two bf16 arenas: a prompt of ``chunks`` (64-row
    buckets, the last ragged) through ``prefill_chunk_paged`` and through
    ``prefill_chunk`` on the arena's dense view (the rows written back by
    ``append_rows``), then ``steps`` decode steps through
    ``decode_step_paged`` and ``decode_step`` on the dense view, both fed
    the native step's greedy token; the second slot is dead.  Returns each
    step's (native, dense-view) f32 logits (1, V) and both arenas'
    lengths."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving.arena import KVArena
    prompt = np.random.default_rng(17).integers(0, cfg.vocab_size,
                                                sum(chunks))
    arenas = [KVArena(cfg, transformer.init_cache, capacity=2,
                      max_seq_len=256, block_size=32, kv_dtype="bf16",
                      device="cuda") for _ in range(2)]
    for a in arenas:
        a.reset_len(a.alloc(256))
        a.reset_len(a.alloc(256))
    native, dense = arenas
    bt = native.device_block_tables()[:1]
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    rows, pos = [], 0
    for c in chunks:
        toks = np.zeros((1, 64), np.int64)
        toks[0, :c] = prompt[pos:pos + c]
        batch = {"tokens": torch.from_numpy(toks).cuda()}
        cl = torch.tensor([c], dtype=torch.int32, device="cuda")
        lg_n, nc = transformer.prefill_chunk_paged(
            params, cfg, batch, native.assemble(native.pages, [],
                                                native.lens[:1]),
            bt, chunk_len=cl, block_size=32)
        native.lens[0] = nc["len"][0]
        st = dense.lens[:1]
        view = dense.dense_view(dense.pages, bt)
        lg_d, dc = transformer.prefill_chunk(
            params, cfg, batch, dense.assemble(view, [], st), chunk_len=cl)
        dense.append_rows(dense.pages, dense.disassemble(dc)[0], st, one,
                          bt, n_tokens=64, valid_tokens=dc["len"] - st)
        dense.lens[0] = dc["len"][0]
        rows.append((lg_n.float(), lg_d.float()))
        pos += c
    live = torch.tensor([True, False], device="cuda")
    tables = native.device_block_tables()
    for _ in range(steps):
        tok = torch.zeros(2, dtype=torch.int32, device="cuda")
        tok[0] = rows[-1][0][0].argmax()
        lg_n, nc = transformer.decode_step_paged(
            params, cfg, tok, native.assemble(native.pages, [], native.lens),
            tables, live, block_size=32)
        native.lens = nc["len"]
        view = dense.dense_view(dense.pages, tables)
        lg_d, dc = transformer.decode_step(
            params, cfg, tok, dense.assemble(view, [], dense.lens),
            live=live)
        dense.append_rows(dense.pages, dense.disassemble(dc)[0], dense.lens,
                          live, tables)
        dense.lens = dc["len"]
        rows.append((lg_n[:1].float(), lg_d[:1].float()))
    torch.cuda.synchronize()
    return rows, native.lens.tolist(), dense.lens.tolist()


@contextlib.contextmanager
def plain_attention():
    """Within the block the models' attention calls (paged and dense chunk
    and decode) run the plain versions on the card's tensors, f32 math
    with a bf16 output: the yardstick for the noise of a full-width bf16
    chain."""
    from repro_torch.kernels import ops, ref
    swap = {"paged_chunk_attention": ref.paged_chunk_attention_ref,
            "paged_decode_attention": ref.paged_decode_attention_ref,
            "chunk_attention": ref.chunk_attention_ref,
            "decode_attention": ref.decode_attention_ref}
    saved = {name: getattr(ops, name) for name in swap}
    for name, fn in swap.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def logits_parity(chunks=(64, 64, 37), steps=3):
    """Phase 8 (c): ``parity_logits`` on minicpm-2b at full width in bf16:
    the native path runs the paged kernels #3 and #1, the dense-view path
    #6 and #5.  Each step's logits agree to PARITY_TOL of their norm.  The
    limit comes from the noise of the chain itself: 40 layers of random
    bf16 weights amplify one bf16 rounding that two correct kernels place
    differently into a few percent of the logits' norm, so the same steps
    also run with the plain versions on the card, and each path's distance
    from its plain run (the floor) is printed beside the limit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models import transformer
    cfg = get_config("minicpm-2b")
    params = transformer.init(1, cfg, "cuda")
    reset_launches()
    rows, lens_n, lens_d = parity_logits(cfg, params, chunks, steps)
    grown = launch_counts()
    n = len(chunks) * cfg.num_layers
    for name, want in (("paged_chunk_prefill_attention", n),
                       ("chunk_prefill_attention", n),
                       ("paged_decode_attention", steps * cfg.num_layers),
                       ("decode_attention", steps * cfg.num_layers)):
        check(grown[name] == want, f"logits parity launched {grown}")
    check(lens_n == lens_d == [sum(chunks) + steps, 0],
          f"lengths {lens_n} vs {lens_d}")
    with plain_attention():
        plain, _, _ = parity_logits(cfg, params, chunks, steps)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    report = []
    for i, ((a, b), (pa, pb)) in enumerate(zip(rows, plain)):
        check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
              "non-finite logits")
        report.append({"step": i, "max_abs_diff": (a - b).abs().max().item(),
                       "norm": b.norm().item(), "rel_l2": rel(a, b),
                       "floor": max(rel(a, pa), rel(b, pb)),
                       "identical": torch.equal(a, b)})
    print(f"phase 8 (c) logits, native (kernels #3, #1) vs dense view "
          f"(#6, #5), minicpm-2b full width, limit {PARITY_TOL} of the "
          f"norm (floor: each path against its plain versions): {report}")
    print(f"phase 8 (c) the {len(chunks)} chunk steps' rel_l2 (#3 and #6 "
          f"share one body, so 0): "
          f"{[r['rel_l2'] for r in report[:len(chunks)]]}")
    for r in report:
        check(r["rel_l2"] <= PARITY_TOL,
              f"native vs dense-view logits at step {r['step']}: "
              f"|diff| / |logits| = {r['rel_l2']} > {PARITY_TOL}")
    # #3 and #6 run one body (chunk_tiles.cuh) in one tile and sum order,
    # and the dense view holds the pages' values, so until the first
    # decode step (#1 against #5) the two chains are one computation
    for r in report[:len(chunks)]:
        check(r["identical"], f"native vs dense-view logits at chunk step "
              f"{r['step']} differ (rel_l2 {r['rel_l2']}): the chunk "
              f"kernels share one body and must agree bit for bit")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def wave_sync(n_requests=32, new_tokens=40):
    """Phase 8 (d): phase 3's wave in sync mode (run-to-completion
    batches, left-padded prompts, a dense bf16 cache a batch); returns its
    tokens per second and peak memory."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_runtime
    torch.cuda.reset_peak_memory_stats()
    cfg, rt = wave_runtime("bf16", n_requests, new_tokens, mode="sync")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == n_requests,
          f"sync wave served {len(results)}/{n_requests}")
    for r in results:
        t = np.asarray(r.tokens)
        check(len(t) == new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    check(launches["flash_attention"] > 0 and launches["decode_attention"]
          > 0, f"the sync wave did not launch flash and decode attention: "
          f"{launches}")
    n_tok = sum(len(r.tokens) for r in results)
    print(f"phase 8 (d) sync wave (minicpm-2b, bf16 dense cache): served "
          f"{len(results)}/{n_requests}, {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s, {rt.oneshot_prefills} one-shot "
          f"prefills, {rt.decode_steps} decode steps, launches {launches}, "
          f"peak memory {peak / 1e9:.2f} GB, {prefix_counters(rt)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the prefix cache on templated requests
# ---------------------------------------------------------------------------

def keep_final_logits(rt):
    """Wraps ``rt._run_chunk`` to keep each request's last final-chunk
    logits; returns the dict they go into."""
    final = {}
    run_chunk = rt._run_chunk

    def keep_final(arena, s, T):
        logits, n = run_chunk(arena, s, T)
        if s.consumed >= len(s.req.tokens):
            final[s.req.rid] = logits[0].clone()
        return logits, n
    rt._run_chunk = keep_final
    return final


def templated_run(kv_dtype, prefix_cache, params, templates=1):
    """One run of phase 9: ``profile_step.templated_wave`` at full width
    (the plan's 512 slots, ``max_seq_len`` 256), its donors served to
    their eviction, then the other requests submitted together and stepped
    until they drain.  Returns the run's record: tokens and final-chunk
    logits by rid, the hit each lookup after the donors found, counters
    and step walls (each step ends in a host read of the sampled tokens,
    so its wall includes the device's work)."""
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import serve_donors, templated_wave
    # the last run's runtime lives in reference cycles (its wrapped chunk
    # step, the prefix index's hooks): collect it before the next arena
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt, donors, others = templated_wave(kv_dtype, prefix_cache,
                                             templates, params=params)
    check(rt.plan.max_in_flight == 512 and rt.max_seq_len == 256
          and rt.kv_dtype == kv_dtype and rt.paged_native
          and rt.prefix_cache_enabled == (prefix_cache != 0),
          f"unexpected templated runtime {rt.plan}")
    final = keep_final_logits(rt)
    results = list(serve_donors(rt, donors))
    hits = []
    pc = rt.groups[0].prefix
    if pc is not None:
        record = pc.record
        pc.record = lambda hit, n: (
            hits.append(0 if hit is None else hit.tokens), record(hit, n))
    before = dict(computed=rt.prefill_tokens_computed,
                  chunks=rt.prefill_chunk_calls, steps=rt.decode_steps,
                  hits=rt.prefix_hits, cow=rt.prefix_cow_copies,
                  evictions=rt.prefix_evictions)
    launches0 = dict(paged_attention.launches)
    for req in others:
        rt.submit(req)
    walls, decode_only = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10_000):
        if not (rt.pending() or rt.in_flight()):
            break
        ts = time.perf_counter()
        st = rt.step(max_wait_s=0.0)
        walls.append(time.perf_counter() - ts)
        if st.decode_steps and not st.prefill_chunk_tokens:
            decode_only.append(walls[-1])
        results.extend(st.results)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(len(results) == len(donors) + len(others),
          f"templated wave served {len(results)}/"
          f"{len(donors) + len(others)}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == others[0].max_new_tokens and t.min() >= 0
              and t.max() < cfg.vocab_size, "token ids out of range")
    check(sorted(final) == sorted(toks), "a request's final chunk is missing")
    for rid, lg in final.items():
        check(bool(torch.isfinite(lg).all()), f"non-finite logits, rid {rid}")
    n_tok = sum(len(toks[r.rid]) for r in others)
    rec = {"kv": kv_dtype, "prefix_cache": prefix_cache,
           "templates": templates, "enabled": rt.prefix_cache_enabled,
           "requests": len(results), "tok_s": n_tok / dt, "wall_s": dt,
           "steps": len(walls),
           "host_wall_ms_per_step": 1e3 * float(np.mean(walls)),
           "median_wall_ms_per_step": 1e3 * float(np.median(walls)),
           "decode_only_steps": len(decode_only),
           "decode_only_wall_ms": (1e3 * float(np.mean(decode_only))
                                   if decode_only else None),
           "lookups": len(hits), "hits": sum(h > 0 for h in hits),
           "min_hit_tokens": min((h for h in hits if h), default=0),
           "computed": rt.prefill_tokens_computed - before["computed"],
           "chunks": rt.prefill_chunk_calls - before["chunks"],
           "decode_steps": rt.decode_steps - before["steps"],
           "hit_tokens": rt.prefix_hit_tokens,
           "cow": rt.prefix_cow_copies - before["cow"],
           "evictions": rt.prefix_evictions,
           "evictions_in_wave": rt.prefix_evictions - before["evictions"],
           "launches": {k: paged_attention.launches[k] - launches0[k]
                        for k in paged_attention.launches}}
    print(f"phase 9 run ({kv_dtype} KV, prefix_cache={prefix_cache}, "
          f"{templates} template(s)): {rec}, {prefix_counters(rt)}")
    return rec, toks, final


def cow_exact():
    """Copy-on-write on the card is an exact copy: a minicpm-2b arena
    (int8, then bf16 pools) with random pages, two registered blocks of one
    slot shared into another and copied by one ``cow_blocks``; the copies'
    values (and int8 scales) equal the sources' bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.arena import KVArena
    from repro_torch.kernels.quant import QuantPages
    cfg = get_config("minicpm-2b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    out = {}
    for kv in ("int8", "bf16"):
        a = KVArena(cfg, transformer.init_cache, capacity=2, max_seq_len=256,
                    block_size=32, kv_dtype=kv, device="cuda")
        tensors = [t for p in a.pages for t in (
            (p.values, p.scales) if isinstance(p, QuantPages) else (p,))]
        for t in tensors:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
            else:
                t.copy_(torch.rand(t.shape, generator=gen, device="cuda"))
        src_slot = a.alloc(256)
        src = a._slot_blocks[src_slot][3:5]
        for b in a._slot_blocks[src_slot][:5]:
            a.register(b)
        dst_slot = a.alloc(256, shared=a._slot_blocks[src_slot][:5])
        copied = a.cow_blocks([(dst_slot, 3), (dst_slot, 4)])
        torch.cuda.synchronize()
        dst = a._slot_blocks[dst_slot][3:5]
        check(copied == 2 and a.cow_calls == 1 and not set(src) & set(dst),
              f"{kv} copy-on-write copied {copied} in {a.cow_calls} calls")
        exact = all(torch.equal(t[:, dst], t[:, src]) for t in tensors)
        check(exact, f"{kv} copy-on-write is not an exact copy")
        out[kv] = {"tensors": len(tensors), "blocks": copied, "exact": exact}
        del a, tensors
    torch.cuda.empty_cache()
    print(f"phase 9 copy-on-write on the card (minicpm-2b pools, values and "
          f"int8 scales compared with torch.equal): {out}")


def phase_templated():
    """Phase 9: minicpm-2b's templated wave with the prefix cache on (the
    category's -1) and off (0), in int8 and bf16 KV, then two alternating
    templates at 8 retained blocks, on and off; each request's final-chunk
    logits are held to the cache-off run's to PARITY_TOL of their norm
    (two correct bf16 chains, as in phase 8 (c)); then the on run's first
    steps under ``torch.profiler``, and the copy-on-write check.  Every
    launch count is zeroed just before the runs and read just after.
    Returns the counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import profile_step
    from repro_torch.models.registry import model_api
    cfg = get_config("minicpm-2b")
    params = model_api(cfg).init(1, cfg, "cuda")
    rel = lambda a, b: ((a.float() - b.float()).norm()
                        / b.float().norm()).item()
    reset_launches()
    for kv, knob, templates in (("int8", -1, 1), ("bf16", -1, 1),
                                ("int8", 8, 2)):
        on, on_toks, on_lg = templated_run(kv, knob, params, templates)
        off, off_toks, off_lg = templated_run(kv, 0, params, templates)
        rels = sorted(rel(on_lg[r], off_lg[r]) for r in off_lg)
        worst = rels[-1]
        same = sum(bool(np.array_equal(on_toks[r], off_toks[r]))
                   for r in off_toks)
        others = on["requests"] - templates
        print(f"phase 9 {kv} KV, {templates} template(s), prefix_cache="
              f"{knob}: on vs off tok/s {on['tok_s']:.1f} vs "
              f"{off['tok_s']:.1f}, prefill chunks {on['chunks']} vs "
              f"{off['chunks']}, prompt tokens computed {on['computed']} vs "
              f"{off['computed']}, host wall per step "
              f"{on['host_wall_ms_per_step']:.3f} vs "
              f"{off['host_wall_ms_per_step']:.3f} ms ({on['steps']} vs "
              f"{off['steps']} steps; decode-only steps "
              f"{on['decode_only_wall_ms']} vs {off['decode_only_wall_ms']} "
              f"ms), hits {on['hits']}/{on['lookups']} (fewest tokens "
              f"{on['min_hit_tokens']}), COW copies {on['cow']}, LRU "
              f"evictions {on['evictions']}; final-chunk logits "
              f"|on - off| / |off| median {rels[len(rels) // 2]}, worst "
              f"{worst} (limit {PARITY_TOL}); greedy chains equal in full "
              f"{same}/{len(off_toks)}")
        print(f"phase 9 {kv} KV, {templates} template(s): every request's "
              f"final-chunk |on - off| / |off|, sorted: {rels}")
        check(worst <= PARITY_TOL, f"{kv} templated final-chunk logits with "
              f"the cache differ from without: {worst} > {PARITY_TOL}")
        check(off["hits"] == off["lookups"] == off["cow"] == 0,
              f"the cache-off run used the cache: {off}")
        if templates == 1:
            check(on["lookups"] == others and on["hits"] >= others - 1
                  and on["min_hit_tokens"] >= 128,
                  f"{kv}: {on['hits']} of {on['lookups']} lookups hit, the "
                  f"smallest {on['min_hit_tokens']} tokens")
            check(on["computed"] <= off["computed"] - others * 128,
                  f"{kv}: {on['computed']} prompt tokens computed with the "
                  f"cache, {off['computed']} without")
            check(on["cow"] >= others, f"{kv}: {on['cow']} COW copies")
        else:
            check(on["evictions"] > 0, f"no LRU eviction at 8 retained "
                  f"blocks: {on}")
        for name, n in on["launches"].items():
            check(n > 0 or ("quant" in name) != (kv == "int8"),
                  f"the {kv} templated wave never launched {name}")
    launches = launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    _, rt, donors, others = profile_step.templated_wave(-1, -1,
                                                        params=params)
    profile_step.serve_donors(rt, donors)
    for req in others:
        rt.submit(req)
    prof = profile_step.window(lambda: rt.step(max_wait_s=0.0), 5,
                               "phase 9 profiled templated wave (int8, "
                               "prefix cache on), first 5 steps", 8)
    rt.drain()
    print(f"phase 9 profiled on run: idle share {prof['idle_share']:.3f}, "
          f"{prof}")
    del rt, params
    gc.collect()
    torch.cuda.empty_cache()
    cow_exact()
    return launches


# ---------------------------------------------------------------------------
# phase 10: observability and crash evacuation
# ---------------------------------------------------------------------------

def phase_obs_smoke():
    """Phase 10 (a): the launcher with ``make obs-smoke``'s flags, its
    trace, metrics and calibration written to a temporary directory and
    read back by the port's own ``validate_chrome_trace`` and
    ``parse_prometheus_text``."""
    import tempfile
    from repro_torch.launch import serve
    from repro_torch.obs import parse_prometheus_text, validate_chrome_trace
    with tempfile.TemporaryDirectory() as d:
        trace, prom, cal = (str(Path(d) / n) for n in (
            "obs_trace.json", "obs_metrics.prom", "obs_calibration.json"))
        rc = serve.main(["--archs", "minicpm-2b", "--requests", "6",
                         "--max-new-tokens", "4", "--trace-out", trace,
                         "--metrics-out", prom, "--calibrate-out", cal])
        check(rc == 0, f"obs-smoke launcher exited {rc}")
        n_events = validate_chrome_trace(json.loads(Path(trace).read_text()))
        series = parse_prometheus_text(Path(prom).read_text())
        overrides = json.loads(Path(cal).read_text())["sim_config_overrides"]
    check(series['epara_requests_finished_total{service="minicpm-2b"}']
          == 6, f"obs-smoke metrics: {series}")
    print(f"phase 10 (a) obs-smoke: {n_events} trace events, {len(series)} "
          f"series, overrides: {overrides}")


def hist_quantile(hist, q):
    """Prometheus' ``histogram_quantile`` over ``Histogram.value()``: the
    q-th observation's value, interpolated linearly inside its bucket (the
    largest finite bound where it falls in the +Inf bucket)."""
    rank = q * hist["count"]
    lo, below = 0.0, 0
    for le, cum in hist["buckets"].items():
        if cum >= rank:
            if le == "+Inf":
                return lo
            return lo + (float(le) - lo) * (rank - below) / max(cum - below, 1)
        lo, below = float(le), cum
    return lo


def obs_wave(tracer=None, metrics=None):
    """Phase 3's int8 wave (``profile_step.wave_runtime``) with an optional
    tracer and registry, stepped to idle as ``drain`` steps it.  Returns
    tokens and final-chunk logits by rid, tok/s, the mean host wall per
    step (each step ends in a host read of the sampled tokens) and the
    paged-attention launches of the run."""
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import wave_runtime
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt = wave_runtime("int8", tracer=tracer, metrics=metrics)
    final = keep_final_logits(rt)
    launches0 = dict(paged_attention.launches)
    results, walls = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while rt.pending() or rt.in_flight():
        ts = time.perf_counter()
        results.extend(rt.step(max_wait_s=0.0).results)
        walls.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    rec = {"obs": tracer is not None, "tok_s": sum(map(len, toks.values()))
           / dt, "steps": len(walls),
           "host_wall_ms_per_step": 1e3 * float(np.mean(walls)),
           "launches": {k: paged_attention.launches[k] - launches0[k]
                        for k in paged_attention.launches}}
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return toks, final, rec


def phase_obs_wave(phase3_toks, phase3_launches):
    """Phase 10 (b): phase 3's int8 wave untraced, traced (a ``Tracer``
    and a ``MetricsRegistry``), traced, untraced.  Every run's greedy
    chains equal phase 3's and so do its paged-attention launches; the
    untraced and traced runs' final-chunk logits are identical; every
    request's timeline is balanced, ``request`` > ``queued``, ``prefill``,
    ``decode``, served; the TTFT, TPOT and queue-wait histograms count every
    request.  Returns the first traced run's final-chunk logits."""
    import torch
    from repro_torch.obs import MetricsRegistry, Tracer
    runs, logits = [], []
    for traced in (False, True, True, False):
        tracer, metrics = ((Tracer(), MetricsRegistry()) if traced
                           else (None, None))
        toks, final, rec = obs_wave(tracer, metrics)
        check(sorted(toks) == sorted(phase3_toks)
              and all(np.array_equal(toks[r], phase3_toks[r])
                      for r in phase3_toks),
              f"a greedy chain differs from phase 3's (obs={traced})")
        check(rec["launches"] == phase3_launches,
              f"launches {rec['launches']} != phase 3's {phase3_launches}")
        runs.append(rec)
        logits.append(final)
        if len(runs) == 2:              # the first traced run
            svc = "minicpm-2b"
            for rid in toks:
                tid = str(rid)
                roots, instants = tracer.span_tree(svc, tid)
                check(tracer.open_spans(svc, tid) == [] and len(roots) == 1
                      and [c.name for c in roots[0].children]
                      == ["queued", "prefill", "decode"]
                      and roots[0].args.get("outcome") == "served"
                      and [i.name for i in instants] == ["first_token"],
                      f"request {rid}'s timeline: {roots} {instants}")
            hists = {n: metrics.histogram(n).value(service=svc)
                     for n in ("ttft_seconds", "tpot_seconds",
                               "queue_wait_seconds")}
            check(all(h["count"] == len(toks) for h in hists.values()),
                  f"histogram counts {[h['count'] for h in hists.values()]}")
            lat = {n: {"median": hist_quantile(h, 0.5),
                       "p99": hist_quantile(h, 0.99),
                       "mean": h["sum"] / h["count"], "count": h["count"]}
                   for n, h in hists.items()}
            print(f"phase 10 (b) latency from the histograms (bucket-"
                  f"interpolated median and p99, exact mean, seconds): {lat}; "
                  f"{tracer.emitted} trace events, {tracer.dropped} dropped")
    check(sorted(logits[0]) == sorted(logits[1]) == sorted(phase3_toks)
          and all(torch.equal(logits[0][r], logits[1][r])
                  for r in logits[0]),
          "the final-chunk logits differ with obs on")
    off = [r for r in runs if not r["obs"]]
    on = [r for r in runs if r["obs"]]
    print(f"phase 10 (b) int8 wave, obs off, on, on, off: tok/s "
          f"{[r['tok_s'] for r in runs]}, host wall ms per step "
          f"{[r['host_wall_ms_per_step'] for r in runs]} ({runs[0]['steps']} "
          f"steps); mean on vs off: tok/s "
          f"{np.mean([r['tok_s'] for r in on])} vs "
          f"{np.mean([r['tok_s'] for r in off])}, host wall per step "
          f"{np.mean([r['host_wall_ms_per_step'] for r in on])} vs "
          f"{np.mean([r['host_wall_ms_per_step'] for r in off])} ms; every "
          f"chain equals phase 3's, launches {runs[0]['launches']}")
    return logits[1]


EVACUATE_AFTER = 2      # steps before the crash: 24 of the 32 requests
#                         admitted (12 a step), so queued, mid-prefill and
#                         decoding requests are all present (checked below)


def phase_evacuate(phase3_toks, phase3_final):
    """Phase 10 (c): phase 3's int8 wave, traced, evacuated after
    ``EVACUATE_AFTER`` steps, its requests resubmitted to the same runtime
    and served to idle.  Checks the counters, the arena (no live slot, free
    plus idle cached blocks are the pool), the two ``request`` roots of
    each resubmitted timeline; counts the chains equal to phase 3's and
    holds every resubmitted request's final-chunk logits to phase 3's
    (phase 10 (b)'s traced run) within PARITY_TOL of their norm."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.obs import MetricsRegistry, Tracer
    gc.collect()
    torch.cuda.empty_cache()
    tracer = Tracer()
    cfg, rt = wave_runtime("int8", tracer=tracer, metrics=MetricsRegistry())
    final = keep_final_logits(rt)
    results = []
    for _ in range(EVACUATE_AFTER):
        results.extend(rt.step(max_wait_s=0.0).results)
    slots = [s for g in rt.groups.values() for s in g.slots]
    state = {"queued": rt.pending(),
             "waiting_prefill": sum(s.prefilling and s.consumed == 0
                                    for s in slots),
             "mid_prefill": sum(s.prefilling and s.consumed > 0
                                for s in slots),
             "decoding": sum(not s.prefilling for s in slots),
             "finished": len(results)}
    check(state["queued"] and state["mid_prefill"] and state["decoding"],
          f"after {EVACUATE_AFTER} steps not every state is present: {state}")
    hits0 = rt.prefix_hits
    back = rt.evacuate()
    arena = rt.groups[0].arena
    check(rt.evacuations == 1 and rt.evacuated_requests == len(back)
          == len(phase3_toks) - len(results),
          f"evacuation counters {rt.evacuations} {rt.evacuated_requests} "
          f"{len(back)}")
    check(rt.pending() == rt.in_flight() == arena.live == 0,
          "a request survived the evacuation")
    check(len(arena._free_blocks) + len(arena._idle_cached)
          == arena.free_capacity == arena.pool_blocks,
          f"arena after evacuation: {len(arena._free_blocks)} free + "
          f"{len(arena._idle_cached)} idle cached of {arena.pool_blocks}")
    for req in back:
        rt.submit(req)
    stats = [rt.step(max_wait_s=0.0)]
    while rt.pending() or rt.in_flight():
        stats.append(rt.step(max_wait_s=0.0))
    check(stats[0].evacuated == len(back)
          and all(st.evacuated == 0 for st in stats[1:]),
          f"StepStats.evacuated {[st.evacuated for st in stats[:3]]}")
    for st in stats:
        results.extend(st.results)
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    check(sorted(toks) == sorted(phase3_toks),
          f"served {len(toks)}/{len(phase3_toks)} after the evacuation")
    rel = {r.rid: ((final[r.rid].float() - phase3_final[r.rid].float()).norm()
                   / phase3_final[r.rid].float().norm()).item() for r in back}
    same = [r.rid for r in back
            if np.array_equal(toks[r.rid], phase3_toks[r.rid])]
    worst = max(rel.values())
    check(all(np.array_equal(toks[r], phase3_toks[r]) for r in toks
              if r not in rel), "a request served before the crash changed")
    check(all(rel[r] <= PARITY_TOL for r in rel if r not in same),
          f"a differing chain's final-chunk logits are off: {rel}")
    for req in back:
        tid = str(req.rid)
        roots, _ = tracer.span_tree("minicpm-2b", tid)
        check(tracer.open_spans("minicpm-2b", tid) == []
              and [s.name for s in roots] == ["request", "request"]
              and roots[0].args.get("outcome") == "evacuated"
              and roots[1].args.get("outcome") == "served",
              f"request {req.rid}'s timeline after resubmission: {roots}")
    print(f"phase 10 (c) evacuation after {EVACUATE_AFTER} steps: {state}; "
          f"{len(back)} requests evacuated and resubmitted, StepStats."
          f"evacuated {stats[0].evacuated}, arena {arena.pool_blocks} "
          f"blocks free or idle cached, prefix hits on resubmission "
          f"{rt.prefix_hits - hits0}; chains equal to phase 3's "
          f"{len(same)}/{len(back)}; final-chunk |resubmitted - phase 3| / "
          f"|phase 3| sorted: {sorted(rel.values())} (worst {worst}, "
          f"limit {PARITY_TOL} where a chain differs)")
    del rt
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: threefry sampling, SDF admission with parking, n-way forks
# ---------------------------------------------------------------------------

STOCH_T, STOCH_K = 0.8, 50      # phase 11's stochastic sampler
# random weights put the last token's logit ~200 above the next (tied
# embeddings), so at 0.8 every draw is the argmax; forks and the check
# that sampling changes tokens run at a temperature that flattens that gap
HOT_T = 100.0
SAMPLER_ROWS = 512              # the plan's slots (phase 3's capacity)


def cuda_ms(fn, reps=5):
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_sampler():
    """Phase 11 (a): the port's sampler on the card against the port's own
    CPU sampler, on identical float32 logits (512 rows of minicpm-2b's
    vocabulary, seeds = row ids, offsets = row ids mod 40).  The counter
    keys, the threefry words (int64) and the uniforms of every drawn row
    must be bit-identical; the Gumbel noise is counted where it differs
    (float64 logarithms on both sides); with 32 and with 512 rows live and
    top_k 0 and 50, every row's token must be equal, and a differing row
    is printed with its CPU top-two perturbed-score margin and passes only
    where that margin is within twice the noise difference of its row.
    ``speculative_verify`` at k = 4, greedy and stochastic: tokens and
    n_emit equal.  Times each sampling call on the card (CUDA events)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import sampler as S
    V = get_config("minicpm-2b").vocab_size
    B = SAMPLER_ROWS
    gen = torch.Generator().manual_seed(11)
    logits = torch.randn(B, V, generator=gen) * 4.0
    dlogits = logits.cuda()
    seeds, sids, offs = np.arange(B), np.zeros(B, np.int64), np.arange(B) % 40
    kc, kd = S.prng_key(0), S.prng_key(0, "cuda")
    keys = S.slot_keys(kc, seeds, sids, offs)
    check(torch.equal(keys, S.slot_keys(kd, seeds, sids, offs).cpu()),
          "the counter keys differ on the card")
    live_sets = {32: np.arange(B) % (B // 32) == 0, B: np.ones(B, bool)}
    rec = {"rows": B, "vocab": V}
    for n_live, live in live_sets.items():
        rows = np.flatnonzero(live)
        bits = S.random_bits(keys[rows], (V,))
        dbits = S.random_bits(keys[rows].cuda(), (V,))
        check(torch.equal(bits, dbits.cpu()),
              f"threefry words differ on the card ({n_live} live)")
        u = S.uniform_from_bits(bits, S._TINY)
        check(torch.equal(u.view(torch.int32), S.uniform_from_bits(
            dbits, S._TINY).cpu().view(torch.int32)),
            f"uniforms differ on the card ({n_live} live)")
        g, dg = S.gumbel_from_bits(bits), S.gumbel_from_bits(dbits).cpu()
        noise_diff = (g - dg).abs().amax(dim=-1)
        rec[f"gumbel_differ_{n_live}"] = int((g != dg).sum())
        del bits, dbits, u, dg
        for top_k in (0, STOCH_K):
            cfg = S.SamplerConfig(STOCH_T, top_k)
            mask = torch.from_numpy(live)
            want = S.sample_per_slot(logits, kc, seeds, sids, offs, cfg,
                                     live=mask, fill_token=-1)
            dmask = mask.cuda()
            got = S.sample_per_slot(dlogits, kd, seeds, sids, offs, cfg,
                                    live=dmask, fill_token=-1).cpu()
            differ = torch.nonzero(got != want).flatten().tolist()
            scores = g + S._filtered(logits[rows], cfg)
            top2 = scores.topk(2, dim=-1).values
            margins = (top2[:, 0] - top2[:, 1])
            row_of = {int(r): i for i, r in enumerate(rows)}
            for r in differ:
                i = row_of[r]
                print(f"phase 11 (a) row {r} ({n_live} live, top_k "
                      f"{top_k}): card {int(got[r])} vs CPU {int(want[r])}, "
                      f"CPU top-two margin {float(margins[i])}, noise "
                      f"difference {float(noise_diff[i])}")
                check(float(margins[i]) <= 2 * float(noise_diff[i]),
                      f"row {r}'s token differs beyond a near tie")
            ms = cuda_ms(lambda: S.sample_per_slot(
                dlogits, kd, seeds, sids, offs, cfg, live=dmask))
            rec[f"live{n_live}_k{top_k}"] = {
                "rows_differ": len(differ), "ms": ms,
                "min_margin": float(margins.min())}
        del g
    # speculative_verify at k = 4 over the first 32 rows
    k, Bv = 4, 32
    gen = torch.Generator().manual_seed(12)
    tl = torch.randn(Bv, k + 1, V, generator=gen) * 4.0
    dl = tl[:, :k] + torch.randn(Bv, k, V, generator=gen)
    drafts = dl.argmax(-1)
    flip = torch.rand(Bv, k, generator=gen) < 0.3
    drafts = torch.where(flip, torch.randint(0, V, (Bv, k), generator=gen),
                         drafts)
    for temp in (0.0, STOCH_T):
        cfg = S.SamplerConfig(temp, STOCH_K)
        want = S.speculative_verify(tl, dl, drafts, kc, seeds[:Bv],
                                    sids[:Bv], offs[:Bv], cfg)
        got = S.speculative_verify(tl.cuda(), dl.cuda(), drafts.cuda(), kd,
                                   seeds[:Bv], sids[:Bv], offs[:Bv], cfg)
        check(torch.equal(want[0], got[0].cpu())
              and torch.equal(want[1], got[1].cpu()),
              f"speculative_verify differs on the card (temperature {temp})")
        rec[f"verify_t{temp}_n_emit"] = np.bincount(
            want[1].numpy(), minlength=k + 2).tolist()
    print(f"phase 11 (a) sampler, card vs CPU: keys, threefry words and "
          f"uniforms bit-identical; {json.dumps(rec)}")
    del dlogits
    torch.cuda.empty_cache()
    return rec


def stochastic_wave(temperature, n_requests=32, new_tokens=40):
    """Phase 3's int8 wave at ``temperature``, top_k STOCH_K.  Returns the
    chains, tok/s and the median top-two gap of the final-chunk logits."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt = wave_runtime("int8", n_requests, new_tokens,
                           sampler=SamplerConfig(temperature, STOCH_K))
    final = keep_final_logits(rt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    check(len(toks) == n_requests and all(
        len(t) == new_tokens and t.min() >= 0 and t.max() < cfg.vocab_size
        for t in toks.values()), f"stochastic wave served {len(toks)}")
    gaps = [float(v) for v in (torch.stack(list(final.values())).float()
                               .topk(2, dim=-1).values.diff(dim=-1)
                               .neg().flatten())]
    del rt, final
    return toks, sum(map(len, toks.values())) / dt, statistics.median(gaps)


def fork_run(n_requests=4, n_samples=4, new_tokens=40):
    """minicpm-2b at full width (512 slots, int8 KV) serving ``n_requests``
    requests of ``n_samples`` samples each at temperature HOT_T: after
    the step that forks them, each request's siblings share its full
    prompt blocks.  Returns chains by (rid, sample) and the counters."""
    import torch
    from repro_torch.launch.profile_step import wave_runtime
    from repro_torch.serving.engine import GenerationRequest
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg, rt = wave_runtime("int8", 0, sampler=SamplerConfig(HOT_T,
                                                            STOCH_K))
    rng = np.random.default_rng(5)
    lens = [45, 90, 137, 190]           # none a multiple of the page
    for rid, n in enumerate(lens[:n_requests]):
        rt.submit(GenerationRequest(
            rid=rid, tokens=rng.integers(0, cfg.vocab_size, n).astype(
                np.int32), max_new_tokens=new_tokens, stream=rid,
            n_samples=n_samples))
    results, shared = [], None
    while rt.pending() or rt.in_flight():
        results.extend(rt.step(max_wait_s=0.0).results)
        if shared is None and rt.forks_spawned == n_requests * (
                n_samples - 1):
            arena, shared = rt.groups[0].arena, {}
            for rid, n in enumerate(lens[:n_requests]):
                rows = [arena._block_tables[s.slot_id][:n // 32].tolist()
                        for s in rt.groups[0].slots if s.req.rid == rid]
                shared[rid] = (len(rows), all(r == rows[0] for r in rows),
                               min(arena.block_ref(b) for b in rows[0]))
    rec = {"forks_spawned": rt.forks_spawned,
           "fork_shortfall": rt.fork_shortfall,
           "prefill_tokens_computed": rt.prefill_tokens_computed,
           "prompt_tokens": sum(lens[:n_requests]),
           "cow_copies": rt.prefix_cow_copies, "shared": shared}
    chains = {(r.rid, r.sample): np.asarray(r.tokens) for r in results}
    del rt
    return chains, rec


def phase_stochastic(phase3_toks, phase3_tok_s):
    """Phase 11 (b): phase 3's int8 wave at temperature 0.8, top_k 50, run
    twice (32/32 served, chains identical across the runs, tokens that
    differ from phase 3's greedy chains counted, the final-chunk logits'
    median top-two gap printed); once at HOT_T, where tokens must differ
    from the greedy chains; then 4 requests of 4 samples at HOT_T, twice
    (forks share the prompt blocks, copy-on-write copies counted, sibling
    chains differ, each the same across the runs)."""
    from repro_torch.kernels import paged_attention
    l0 = dict(paged_attention.launches)
    (a, tok_s_a, gap), (b, tok_s_b, _) = (stochastic_wave(STOCH_T)
                                          for _ in range(2))
    check(sorted(a) == sorted(b) and all(np.array_equal(a[r], b[r])
                                         for r in a),
          "the stochastic wave's chains differ between two runs")
    total = sum(len(t) for t in a.values())
    differ = sum(int((a[r] != phase3_toks[r]).sum()) for r in a)
    hot, tok_s_hot, _ = stochastic_wave(HOT_T)
    differ_hot = sum(int((hot[r] != phase3_toks[r]).sum()) for r in hot)
    check(differ_hot > 0, f"the wave at temperature {HOT_T} drew phase "
          f"3's greedy chains")
    (fa, rec), (fb, _) = (fork_run() for _ in range(2))
    check(sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k])
                                           for k in fa),
          "a sibling's chain differs between two fork runs")
    check(len(fa) == 16 and rec["forks_spawned"] == 12
          and rec["prefill_tokens_computed"] == rec["prompt_tokens"]
          and rec["cow_copies"] >= 12, f"fork run: {rec}")
    check(rec["shared"] and all(n == 4 and same and ref >= 4
                                for n, same, ref in rec["shared"].values()),
          f"forks do not share their prompt blocks: {rec['shared']}")
    for rid in range(4):
        sib = {tuple(fa[(rid, s)].tolist()) for s in range(4)}
        check(len(sib) == 4, f"request {rid}'s sibling chains coincide")
    grown = {k: paged_attention.launches[k] - l0[k]
             for k in paged_attention.launches}
    print(f"phase 11 (b) stochastic int8 wave (T {STOCH_T}, top_k "
          f"{STOCH_K}), two runs: 32/32 served, chains identical; tok/s "
          f"{tok_s_a}, {tok_s_b} (phase 3 greedy {phase3_tok_s}); "
          f"{differ}/{total} tokens differ from phase 3's greedy chains "
          f"(final-chunk logits' median top-two gap {gap}); at T {HOT_T}: "
          f"{differ_hot}/{total} differ, {tok_s_hot} tok/s; 4 requests x 4 "
          f"samples at T {HOT_T}, two runs: {rec}, sibling chains distinct "
          f"and repeatable; launches {grown}")
    return {"tok_s": [tok_s_a, tok_s_b], "differ": differ,
            "differ_hot": differ_hot, "gap": gap, "forks": rec,
            "launches": grown}


# phase 11 (c)'s plan: the trace's own (latency category, 2 slots, bf16
# KV by the category unless kv_dtype says otherwise)
GOODPUT_EXPECTED = {"fifo": 4, "sdf": 12, "preemptions": 1}


def phase_goodput():
    """Phase 11 (c): the reference's goodput overload trace
    (``profile_step.goodput_trace``) on minicpm-2b at full width under a
    logical clock, fifo and sdf, greedy and at temperature 0.8 (bf16 KV),
    then greedy with int8 KV.  sdf's on-time count at least 1.3x fifo's,
    at least one preemption and as many resumes, identical chains for
    every request completed under both policies, every request served or
    verdicted with one verdict, the arenas left with no parked block and
    no live slot; the counts are held beside the CPU test's on the toy
    config."""
    import dataclasses as dc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.allocator import ParallelPlan
    from repro_torch.core.categories import Sensitivity, TaskCategory
    from repro_torch.kernels import paged_attention
    from repro_torch.launch.profile_step import goodput_trace
    from repro_torch.models.registry import model_api
    from repro_torch.serving.engine import ServiceRuntime
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("minicpm-2b")
    params = model_api(cfg).init(1, cfg, "cuda")
    plan = ParallelPlan(service="minicpm-2b",
                        category=TaskCategory(Sensitivity.LATENCY, False),
                        bs=2)
    out = {}
    for label, temp, kv in (("greedy bf16", 0.0, -1),
                            ("stochastic bf16", STOCH_T, -1),
                            ("greedy int8", 0.0, "int8")):
        runs = {}
        l0 = dict(paged_attention.launches)
        for policy in ("fifo", "sdf"):
            def make():
                return ServiceRuntime(
                    cfg, params, dc.replace(plan, admission=policy,
                                            kv_dtype=kv),
                    sampler=SamplerConfig(temp, 0), device="cuda")
            t0 = time.perf_counter()
            r = goodput_trace(make, cfg.vocab_size)
            r["wall_s"] = time.perf_counter() - t0
            check(r["completed"] + r["rejected"] == r["submitted"]
                  and len(r["reject_verdicts"]) == r["rejected"],
                  f"{label} {policy}: a request left without a verdict")
            check(r["parked_blocks"] == r["live_slots"] == 0,
                  f"{label} {policy}: arena not empty at the end")
            runs[policy] = r
        fifo, sdf = runs["fifo"], runs["sdf"]
        check(sdf["goodput_ontime"] >= 1.3 * fifo["goodput_ontime"],
              f"{label}: sdf on-time {sdf['goodput_ontime']} < 1.3 x fifo "
              f"{fifo['goodput_ontime']}")
        check(sdf["preemptions"] >= 1
              and sdf["resumes"] == sdf["preemptions"],
              f"{label}: preemptions {sdf['preemptions']}, resumes "
              f"{sdf['resumes']}")
        both = set(fifo["tokens"]) & set(sdf["tokens"])
        check(both and all(fifo["tokens"][k] == sdf["tokens"][k]
                           for k in both),
              f"{label}: a chain differs between fifo and sdf")
        grown = {k: paged_attention.launches[k] - l0[k]
                 for k in paged_attention.launches}
        summary = {p: {k: r[k] for k in (
            "goodput_ontime", "completed", "rejected", "submitted",
            "preemptions", "resumes", "arena_parks", "verdicts", "wall_s")}
            for p, r in runs.items()}
        same = (fifo["goodput_ontime"] == GOODPUT_EXPECTED["fifo"]
                and sdf["goodput_ontime"] == GOODPUT_EXPECTED["sdf"]
                and sdf["preemptions"] == GOODPUT_EXPECTED["preemptions"])
        print(f"phase 11 (c) goodput trace, {label}: {json.dumps(summary)}; "
              f"{len(both)} chains identical across policies; counts equal "
              f"the CPU toy trace's {GOODPUT_EXPECTED}: {same}; launches "
              f"{grown}")
        out[label] = {"summary": summary, "same_as_cpu": same,
                      "launches": grown}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sdf_launcher():
    """Phase 11 (d): the launcher with ``--admission-policy sdf
    --deadline-s 30 --requests 8``: exits 0 and prints its admission
    line."""
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--archs", "minicpm-2b", "--admission-policy",
                         "sdf", "--deadline-s", "30", "--requests", "8"])
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"sdf launcher exited {rc}")
    check(any(ln.startswith("admission (sdf):")
              for ln in text.splitlines()), "no admission line printed")


def phase_sampling_admission(phase3_toks, phase3_tok_s):
    t0 = time.perf_counter()
    rec = {"sampler": phase_sampler()}
    rec["stochastic"] = phase_stochastic(phase3_toks, phase3_tok_s)
    rec["goodput"] = phase_goodput()
    phase_sdf_launcher()
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 12: speculative decoding on minitron-4b (and mixtral-8x7b)
# ---------------------------------------------------------------------------

SPEC_ARCH = "minitron-4b"
SPEC_K = 4                    # SPECULATE_BY_SENSITIVITY[LATENCY]
DRAFT_LAYERS = 4              # (b)'s small draft: the target's first blocks
# (a)'s live slots: ragged lengths (in, across and at page boundaries), at
# slot ids spread over the 512
VERIFY_LENS = (1, 30, 32, 33, 64, 100, 150, 200)
VERIFY_SLOTS = (0, 63, 64, 130, 255, 300, 411, 511)
MOE_LAYERS = 2                # (e): mixtral-8x7b at full width, 2 of 32
STOCH_SPEC_REQUESTS = 8       # (c)'s wave: the first 8 of phase 3's 32


def verify_vs_decode(cfg, params, label):
    """Phase 12 (a): ``verify_step_paged`` (T = SPEC_K + 1, chunk kernel
    #3) against SPEC_K + 1 successive ``decode_step_paged`` calls (#1) fed
    the same tokens, on a copy of the same pools and lengths: 8 live slots
    of VERIFY_LENS tokens (prefilled by one ``prefill_chunk_paged``) at
    VERIFY_SLOTS among 512, the other 504 dead.  Each (slot, position)
    row's logits are held to PARITY_TOL of its norm, and so are the K/V
    rows the two wrote (``check_rows``; both are the ends of two correct
    bf16 chains through every layer, phase 8 (c)'s rule); the verify
    writes nothing outside its slots' rows but the trash page, and returns
    ``len`` unchanged.  Returns the record (its ``max_abs_diff`` is the
    largest logit difference)."""
    import torch
    from repro_torch.models.registry import model_api
    from repro_torch.serving.arena import KVArena
    api = model_api(cfg)
    cap, T, bs = 512, SPEC_K + 1, 32
    lens = np.asarray(VERIFY_LENS)
    sids = list(VERIFY_SLOTS)
    need = sum(-(-(n + T) // bs) for n in lens)
    arena = KVArena(cfg, api.init_cache, capacity=cap, max_seq_len=256,
                    block_size=bs, pool_blocks=need, kv_dtype="bf16",
                    device="cuda")
    for sid, n in zip(sids, lens):
        arena.alloc(int(n) + T, slot=sid)
        arena.reset_len(sid)
    tables = arena.device_block_tables()
    rng = np.random.default_rng(21)
    toks = np.zeros((len(sids), int(lens.max())), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    rows = torch.tensor(sids, device="cuda")
    _, c = api.prefill_chunk_paged(
        params, cfg, {"tokens": torch.from_numpy(toks).cuda()},
        arena.assemble(arena.pages, [], arena.lens[rows]), tables[rows],
        chunk_len=torch.from_numpy(lens.astype(np.int32)).cuda(),
        block_size=bs)
    arena.lens[rows] = c["len"]
    live = torch.zeros(cap, dtype=torch.bool, device="cuda")
    live[rows] = True
    vt = torch.zeros(cap, T, dtype=torch.int64, device="cuda")
    vt[rows] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (len(sids), T))).cuda()
    pre = [p.clone() for p in arena.pages]
    lens0 = arena.lens.clone()
    dec_pages, dec_lens = [p.clone() for p in pre], lens0.clone()
    logits_v, cv = api.verify_step_paged(
        params, cfg, {"tokens": vt},
        arena.assemble(arena.pages, [], arena.lens), tables,
        chunk_len=torch.where(live, T, 0).to(torch.int32), block_size=bs)
    check(torch.equal(cv["len"], lens0), "verify changed the lengths")
    steps = []
    for j in range(T):
        lg, c = api.decode_step_paged(
            params, cfg, vt[:, j].to(torch.int32),
            {"k": dec_pages[0], "len": dec_lens, "v": dec_pages[1]}, tables,
            live, block_size=bs)
        dec_lens = c["len"]
        steps.append(lg[rows].float())
    torch.cuda.synchronize()
    check(torch.equal(dec_lens, lens0 + live.int() * T),
          "the decode steps' lengths")
    got, want = logits_v[rows].float(), torch.stack(steps, 1)
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite verify or decode logits")
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    rec = {"max_abs_diff": (got - want).abs().max().item(),
           "worst_row_rel_l2": rel,
           "logit_ref_max": want.abs().max().item(),
           "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "rows": got.shape[0] * got.shape[1]}
    # the K/V rows each path wrote: positions len..len+T-1 of each slot
    bt = arena.block_tables()
    pos = [(int(bt[s, p // bs]), p % bs) for s, n in zip(sids, lens)
           for p in range(int(n), int(n) + T)]
    blk = torch.tensor([b for b, _ in pos], device="cuda")
    off = torch.tensor([o for _, o in pos], device="cuda")
    for name, vp, dp, p0 in zip("kv", arena.pages, dec_pages, pre):
        rec.update(check_rows(f"{name}_rows", vp[:, blk, off],
                              dp[:, blk, off], rel=PARITY_TOL))
        # the first layer's rows are projections of the embeddings alone
        rec[f"{name}_rows_layer0_max_abs_diff"] = (
            vp[0, blk, off].float() - dp[0, blk, off].float()).abs().max(
            ).item()
        changed = (vp != p0).flatten(3).any(-1).any(0)   # (pages, bs)
        changed[blk, off] = False
        changed[-1] = False                            # the trash page
        check(not bool(changed.any()), f"verify wrote {name} rows outside "
              f"its slots' rows and the trash page")
    check(rel <= PARITY_TOL, f"verify vs decode logits: a row differs by "
          f"{rel} of its norm > {PARITY_TOL}")
    print(f"phase 12 {label} verify_step_paged (T = {T}, #3) vs {T} "
          f"decode_step_paged (#1), {cfg.name} full width, "
          f"{cfg.num_layers} layers, 8 live of 512 slots: "
          f"{json.dumps(rec)}")
    del arena, pre, dec_pages
    return rec


def next_token_gap(cfg, params, tokens):
    """The top-two gap of the next-token logits after ``tokens``, computed
    as a decode step computes it: all but the last token as one paged
    chunk, then the last through ``decode_step_paged``, on a bf16 arena of
    one slot."""
    import torch
    from repro_torch.models.registry import model_api
    from repro_torch.serving.arena import KVArena
    api = model_api(cfg)
    n = len(tokens)
    arena = KVArena(cfg, api.init_cache, capacity=1, max_seq_len=n + 1,
                    block_size=32, kv_dtype="bf16", device="cuda")
    sid = arena.alloc(n + 1)
    arena.reset_len(sid)
    bt = arena.device_block_tables()
    head = torch.from_numpy(np.asarray(tokens[:-1], np.int64)[None]).cuda()
    _, c = api.prefill_chunk_paged(
        params, cfg, {"tokens": head},
        arena.assemble(arena.pages, [], arena.lens), bt,
        chunk_len=torch.tensor([n - 1], dtype=torch.int32, device="cuda"),
        block_size=32)
    lg, _ = api.decode_step_paged(
        params, cfg, torch.tensor([int(tokens[-1])], dtype=torch.int32,
                                  device="cuda"),
        arena.assemble(arena.pages, [], c["len"]), bt,
        torch.ones(1, dtype=torch.bool, device="cuda"), block_size=32)
    top = lg[0].float().topk(2).values
    return (top[0] - top[1]).item()


def chain_splits(cfg, params, plain, spec):
    """Each chain of ``spec`` that differs from ``plain``: its request,
    the first position where they differ, and the plain run's top-two
    logit gap there (``next_token_gap``)."""
    from repro_torch.launch.profile_step import wave_prompts
    prompts = wave_prompts(cfg.vocab_size)
    out = []
    for rid in sorted(plain):
        a, b = plain[rid], spec[rid]
        if np.array_equal(a, b):
            continue
        p = int(np.argmax(a != b))
        out.append({"rid": rid, "pos": p, "gap": next_token_gap(
            cfg, params, np.concatenate([prompts[rid], a[:p]]))})
    return out


def spec_wave(label, cfg, params, sampler=None, n_requests=32, **kw):
    """Phase 3's wave (prompts of 6-200 tokens, 40 new), its first
    ``n_requests`` of 32, on ``cfg`` (``params``) at the plan of its full
    config (512 slots, the category's KV and prefix cache), with the
    runtime arguments ``kw`` (a draft, ``speculate``).  Returns
    the chains and the run's record: tok/s, wall, the speculation
    counters, each speculating slot's commits a round (from the rounds
    themselves), launches per kernel, MoE drops and peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch.profile_step import wave_prompts
    from repro_torch.launch.serve import plan_for
    from repro_torch.models import moe
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
    from repro_torch.serving.sampler import SamplerConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rt = ServiceRuntime(cfg, params, plan_for(get_config(cfg.name)),
                        sampler=sampler or SamplerConfig(), device="cuda",
                        **kw)
    for rid, prompt in enumerate(wave_prompts(cfg.vocab_size)[:n_requests]):
        rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                    max_new_tokens=40, stream=rid))
    commits = []
    spec_round = rt._spec_round

    def counted_round(state, slots):
        before = [len(s.emitted) for s in slots]
        spec_round(state, slots)
        commits.extend(len(s.emitted) - n for s, n in zip(slots, before)
                       if not s.done)

    rt._spec_round = counted_round
    moe.MOE_DROP_STATS.flush()
    drops0 = moe.MOE_DROP_STATS.dropped
    l0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = rt.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moe.MOE_DROP_STATS.flush()
    check(len(results) == n_requests,
          f"{label}: served {len(results)}/{n_requests}")
    toks = {r.rid: np.asarray(r.tokens) for r in results}
    for t in toks.values():
        check(len(t) == 40 and t.min() >= 0 and t.max() < cfg.vocab_size,
              f"{label}: token ids out of range")
    n_tok = sum(len(t) for t in toks.values())
    ver = rt.verify_launches
    rec = {"tok_s": n_tok / dt, "wall_s": dt, "decode_steps":
           rt.decode_steps, "prefill_chunks": rt.prefill_chunk_calls,
           "verify_launches": ver, "accepted_tokens": rt.accepted_tokens,
           "accepted_per_launch": rt.accepted_tokens / ver if ver else 0.0,
           "slot_rounds": len(commits),
           "commits_per_slot_round": (float(np.mean(commits)) if commits
                                      else 0.0),
           "commit_hist": np.bincount(commits, minlength=SPEC_K + 2)[
               1:].tolist() if commits else [],
           "draft_steps": rt.draft_steps,
           "draft_prefill_tokens": rt.draft_prefill_tokens,
           "spec_degraded": rt.spec_degraded,
           "moe_dropped_tokens": moe.MOE_DROP_STATS.dropped - drops0,
           "launches": {k: v - l0[k] for k, v in launch_counts().items()
                        if v - l0[k]},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prefix": prefix_counters(rt)}
    print(f"phase 12 {label} ({n_requests} requests): {json.dumps(rec)}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return toks, rec


def draft_view(cfg, params, n):
    """A draft of the target's first ``n`` blocks, embedding, final norm
    and head: views of the target's tensors, no copy."""
    import dataclasses
    from repro_torch.models.transformer import layer_params
    blocks = layer_params(params["blocks"], slice(0, n))
    return dataclasses.replace(cfg, num_layers=n), {
        "embed": params["embed"], "blocks": blocks, "ln_f": params["ln_f"]}


def hold_chains(label, cfg, params, plain, spec, limit):
    """A speculative run's greedy chains against the plain run's: a chain
    may split from the plain one only where the plain run's top-two logit
    gap is below ``limit``, the verify-vs-decode logit difference (a)
    measured (bf16 rounds otherwise in the verify kernel than in the
    decode kernel, and bf16 logits of a 256,000-token vocabulary tie often
    at the top).  Every split is recorded with its gap.  Returns them."""
    splits = chain_splits(cfg, params, plain, spec)
    print(f"phase 12 {label}: {32 - len(splits)}/32 chains equal the plain "
          f"run's; splits (first differing position, plain top-two gap; "
          f"limit {limit}): {splits}")
    check(all(s["gap"] < limit for s in splits),
          f"{label}: a chain splits from the plain run's where its top-two "
          f"gap is not below {limit}: {splits}")
    return splits


def same_chains(label, a, b):
    """Greedy speculative tokens are the target's: two runs with other
    drafts must give the same chains."""
    same = sum(np.array_equal(a[r], b[r]) for r in a)
    check(sorted(a) == sorted(b) and same == len(a),
          f"{label}: only {same}/{len(a)} chains equal")


def phase_moe_verify():
    """Phase 12 (e): mixtral-8x7b at full width and MOE_LAYERS of its 32
    layers, phase 3's wave greedy, plain and with a self-draft.  At the
    config's capacity factor (1.25; the grouped GEMM at its real shapes)
    each slot's 5 verify rows are one routing group with a capacity of one
    row an expert, so the verify drops assignments that decode (a group a
    token) keeps: the drops and splits are recorded.  At capacity factor
    8 nothing drops: (a) is repeated for mixtral, the splits from the
    plain run's chains are recorded with their gaps (a router's near tie
    can send a token to another expert, which moves a logit by more than
    (a)'s rounding noise), and a 1-layer draft's chains must equal the
    self-draft's."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("mixtral-8x7b")
    rec = {}
    for cf in (full.moe_capacity_factor, 8.0):
        cfg = dataclasses.replace(full, num_layers=MOE_LAYERS,
                                  moe_capacity_factor=cf)
        params = moe.init(1, cfg, "cuda")
        tag = f"(e) mixtral cf {cf}"
        r = rec[cf] = {}
        if cf != full.moe_capacity_factor:
            r["verify"] = verify_vs_decode(cfg, params, f"{tag} (a)")
        plain, r["plain"] = spec_wave(f"{tag} plain", cfg, params,
                                      speculate=0)
        spec, r["self_draft"] = spec_wave(
            f"{tag} self-draft", cfg, params, draft_params=params,
            draft_cfg=cfg)
        check(r["self_draft"]["verify_launches"] > 0,
              f"{tag}: no verify launched")
        splits = r["self_draft"]["splits"] = chain_splits(cfg, params,
                                                          plain, spec)
        print(f"phase 12 {tag}: {32 - len(splits)}/32 chains equal the "
              f"plain run's, verify drops "
              f"{r['self_draft']['moe_dropped_tokens']} (plain "
              f"{r['plain']['moe_dropped_tokens']}); splits (first "
              f"differing position, plain top-two gap): {splits}")
        if "verify" in r:
            check(r["self_draft"]["moe_dropped_tokens"] == 0,
                  f"{tag}: the verify dropped assignments")
            dcfg, dparams = draft_view(cfg, params, 1)
            one, r["draft1"] = spec_wave(
                f"{tag} 1-layer draft", cfg, params, draft_params=dparams,
                draft_cfg=dcfg)
            same_chains(f"{tag} self-draft vs 1-layer draft", spec, one)
            del dparams
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return {str(cf): r for cf, r in rec.items()}


def phase_speculative():
    """Phase 12 (a)-(e): speculative decoding at full width.  Every count
    is zeroed just before it and read just after; returns them."""
    import contextlib as ctx
    import dataclasses
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving.sampler import SamplerConfig
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    cfg = get_config(SPEC_ARCH)
    params = transformer.init(1, cfg, "cuda")
    rec = {"verify": verify_vs_decode(cfg, params, "(a)")}
    limit = rec["verify"]["max_abs_diff"]
    # (b) greedy: plain, self-draft (the same tensors), a 4-layer draft
    plain, rec["plain"] = spec_wave("(b) plain", cfg, params, speculate=0)
    selfd, rec["self_draft"] = spec_wave(
        "(b) self-draft", cfg, params, draft_params=params, draft_cfg=cfg)
    dcfg, dparams = draft_view(cfg, params, DRAFT_LAYERS)
    small, rec["draft4"] = spec_wave(
        f"(b) {DRAFT_LAYERS}-layer draft", cfg, params, draft_params=dparams,
        draft_cfg=dcfg)
    for name in ("self_draft", "draft4"):
        r = rec[name]
        check(r["verify_launches"] > 0, f"(b) {name} launched no verify")
        grown = (r["launches"].get("paged_chunk_prefill_attention", 0)
                 - rec["plain"]["launches"].get(
                     "paged_chunk_prefill_attention", 0))
        check(grown >= r["verify_launches"] * cfg.num_layers,
              f"(b) {name}: #3 grew {grown} < verify launches x layers")
    check(rec["self_draft"]["commits_per_slot_round"] >= SPEC_K,
          f"(b) the self-draft commits "
          f"{rec['self_draft']['commits_per_slot_round']} a slot-round")
    check(min(c for c in range(1, SPEC_K + 2)
              if rec["draft4"]["commit_hist"][c - 1]) < SPEC_K + 1,
          "(b) the 4-layer draft never rolled back")
    rec["self_draft"]["splits"] = hold_chains(
        "(b) self-draft", cfg, params, plain, selfd, limit)
    rec["draft4"]["splits"] = hold_chains(
        f"(b) {DRAFT_LAYERS}-layer draft", cfg, params, plain, small, limit)
    same_chains(f"(b) self-draft vs {DRAFT_LAYERS}-layer draft", selfd,
                small)
    rec["seconds_ab"] = time.perf_counter() - t0
    # (c) stochastic, the 4-layer draft, twice, on the wave's first
    # STOCH_SPEC_REQUESTS requests (the script's time limit)
    hot = SamplerConfig(STOCH_T, STOCH_K)
    (a, ra), (b, rb) = (spec_wave(f"(c) T {STOCH_T} run {i}", cfg, params,
                                  sampler=hot, n_requests=STOCH_SPEC_REQUESTS,
                                  draft_params=dparams, draft_cfg=dcfg)
                        for i in (1, 2))
    check(all(np.array_equal(a[r], b[r]) for r in a)
          and ra["verify_launches"] == rb["verify_launches"] > 0,
          "(c) the stochastic speculative runs differ")
    rec["stochastic"] = {"tok_s": [ra["tok_s"], rb["tok_s"]],
                         "verify_launches": ra["verify_launches"],
                         "differ_from_greedy": sum(
                             int((a[r] != small[r]).sum()) for r in a)}
    rec["seconds_abc"] = time.perf_counter() - t0
    del dparams, a, b
    # (d) the launcher
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = io.StringIO()
    with ctx.redirect_stdout(out):
        rc = serve.main(["--archs", "minicpm-2b,minitron-4b",
                         "--draft-arch", SPEC_ARCH])
    text = out.getvalue()
    print(text, end="")
    line = next((ln for ln in text.splitlines()
                 if ln.startswith(f"speculative (draft={SPEC_ARCH})")), "")
    check(rc == 0 and "served 24/24" in text, f"(d) launcher exited {rc}")
    check("note: minicpm-2b incompatible with draft" in text,
          "(d) no non-speculative note for minicpm-2b")
    check(line and int(line.split(":")[1].split()[0]) > 0,
          f"(d) no verify launches: {line!r}")
    rec["seconds_abcd"] = time.perf_counter() - t0
    # (e) MoE verify: mixtral-8x7b at full width, 2 layers, self-draft
    rec["moe"] = phase_moe_verify()
    counts = launch_counts()
    for name in ("paged_decode_attention", "paged_chunk_prefill_attention",
                 "grouped_matmul"):
        check(counts[name] > 0, f"phase 12 never launched {name}")
    rec["launches"] = {k: v for k, v in counts.items() if v}
    rec["seconds"] = time.perf_counter() - t0
    print(f"phase 12 record: {json.dumps(rec)}")
    print(f"phase 12: {rec['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def reset_launches():
    from repro_torch.kernels import ops
    ops.reset_launches()


def phase_train(steps=4):
    """Phase 7: minicpm-2b's training path at full width through the
    launcher's ``run``; every launch count is zeroed just before it and
    read just after.  Then the second step of a fresh trainer under
    ``torch.profiler``.  Returns the counts."""
    import torch
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.launch import profile_step, train
    argv = ["--arch", "minicpm-2b", "--batch", "2", "--seq", "4096",
            "--microbatches", "2", "--lr", TRAIN_LR, "--log-every", "1"]
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    result = train.run(argv + ["--steps", str(steps)])
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, norms = result["losses"], result["grad_norms"]
    check(len(losses) == steps and all(np.isfinite(losses))
          and all(np.isfinite(norms)),
          f"non-finite training losses or grad norms: {losses} {norms}")
    check(losses[-1] < losses[0],
          f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    for i, grown in enumerate(result["launches"]):
        want = {n: 0 for n in grown}
        want.update(flash_attention=160, flash_attention_bwd=80)
        check(grown == want, f"training step {i} launched {grown}")
    tokens = 2 * 4096
    print(f"phase 7 (minicpm-2b training, 40 layers, bf16, AdamW lr "
          f"{TRAIN_LR}, 2 x 4096 tokens in 2 microbatches): losses "
          f"{losses}, grad norms {norms}, step wall (s) {result['step_s']}, "
          f"tok/s {[tokens / s for s in result['step_s']]}, launches a step "
          f"{result['launches'][-1]}, {dt:.3f} s in all, memory (GB) "
          f"before {mem0 / 1e9:.2f}, peak {peak / 1e9:.2f}")
    del result
    gc.collect()
    steps_it = train.train_steps(argv + ["--steps", "2"])
    next(steps_it)
    profile_step.window(lambda: next(steps_it), 1,
                        "phase 7 profiled training step", 10)
    steps_it.close()
    del steps_it
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def small_input_check():
    """The models on the card (CUDA kernels) against the same models and
    weights on the CPU (plain versions), in bf16 at a reduced width: one
    ragged chunked-prefill call and two decode steps each, for minicpm-2b
    (head dim 64, bf16 and int8 pools), mamba2-2.7b (P = N = 16),
    whisper-large-v3 (head dim 64, encoder_len 64, int8 pools) and
    mixtral-8x7b (head dim 64, 4 experts, bf16 pools), and one MoE layer
    of it with a random router.  The
    two devices round bf16 matrix products differently, so logits agree to
    2**-6 of the largest logit's magnitude (about two bf16 steps
    there)."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.quant import QuantPages
    from repro_torch.models import transformer
    cfg = reduced(get_config("minicpm-2b"), head_dim=64)
    params = transformer.init(3, cfg, "cpu")
    B, nblk, bs = 2, 4, 32
    P1 = B * nblk + 1
    tables = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    rng = np.random.default_rng(4)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 32)))
    errs = {}
    for quant in (False, True):
        outs = {}
        for dev in ("cpu", "cuda"):
            p = tree_to(params, dev)
            shape = (cfg.num_layers, P1, bs, cfg.num_kv_heads, cfg.head_dim)
            if quant:
                pools = {n: QuantPages(
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.ones(shape[:-1], device=dev)) for n in "kv"}
            else:
                pools = {n: torch.zeros(shape, dtype=torch.bfloat16,
                                        device=dev) for n in "kv"}
            bt = tables.to(dev)
            cl = torch.tensor([32, 19], dtype=torch.int32, device=dev)
            logits = []
            lg, cache = transformer.prefill_chunk_paged(
                p, cfg, {"tokens": chunk.to(dev)},
                {**pools, "len": torch.zeros(B, dtype=torch.int32,
                                             device=dev)}, bt,
                chunk_len=cl, block_size=bs)
            logits.append(lg.float().cpu())
            live = torch.tensor([True, True], device=dev)
            for step in range(2):
                tok = torch.tensor([7 + step, 11 + step], device=dev)
                lg, cache = transformer.decode_step_paged(
                    p, cfg, tok, cache, bt, live, block_size=bs)
                logits.append(lg.float().cpu())
            outs[dev] = torch.stack(logits)
        errs["int8" if quant else "bf16"] = compare_logits(outs)
    errs["mamba2"] = compare_logits(small_mamba2())
    errs["whisper"] = compare_logits(small_whisper())
    # phase 6's runtime turned the process-wide drop counter on; these
    # direct calls switch devices outside any step and read no drops
    from repro_torch.models import moe
    moe.enable_drop_counter(False)
    errs["mixtral"] = compare_logits(small_mixtral())
    errs["mixtral_moe_layer"] = compare_logits(small_moe_layer())
    for arch, seed in (("minicpm-2b", 21), ("mixtral-8x7b", 22),
                       ("whisper-large-v3", 23)):
        errs[f"{arch} dense steps"] = compare_logits(
            small_dense_steps(arch, seed))
    errs["mixtral-8x7b ring"] = compare_logits(small_ring())
    errs["mamba2-2.7b one-shot prefill"] = compare_logits(
        small_ssm_prefill())
    print(f"small-input check: card vs CPU logits (max |diff|, "
          f"tolerance) {errs}")
    print(f"small-input check: sync-mode wave, card vs CPU greedy tokens "
          f"agree at {small_sync_wave()} of the positions")
    small_train_step()


def small_train_step():
    """One training step's loss and gradients of reduced minicpm-2b with
    head dim 64, in bf16, on the card (flash kernels) and on the CPU (plain
    versions), from the same weights and batch.  The devices round bf16 at
    other places (the matrix products, the forward kernel's output), so
    the loss agrees to 2**-7 of itself, the grad norm to 2**-5 of itself,
    and each leaf's gradient to 2**-6 of its largest magnitude (on the CPU
    the bf16 step differs from the same step in f32 by at most 2.7e-4 of
    the loss, 6e-5 of the norm and 1.1e-2 of a leaf's largest gradient:
    the logits are of the order of 100, where a bf16 step is 0.5).  The
    attention's gradients alone are held tighter by
    ``small_attention_grads``."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models import transformer
    from repro_torch.training import train_step
    from repro_torch.training.tree import tree_paths
    cfg = reduced(get_config("minicpm-2b"), head_dim=64)
    params = transformer.init(11, cfg, "cpu")
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65)))
    loss_fn = train_step.make_loss_fn(cfg)
    outs = {}
    for dev in ("cpu", "cuda"):
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        before = launch_counts()
        (loss, _), grads = train_step.value_and_grad(
            loss_fn, tree_to(params, dev), batch)
        grown = {n: c - before[n] for n, c in launch_counts().items()}
        if dev == "cuda":
            check(grown["flash_attention"] == 2 * cfg.num_layers
                  and grown["flash_attention_bwd"] == cfg.num_layers,
                  f"the card's train step launched {grown}")
        flat = {k: g.float().cpu() for k, g in tree_paths(grads).items()}
        norm = torch.sqrt(sum(g.square().sum() for g in flat.values()))
        outs[dev] = (loss.item(), norm.item(), flat)
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = outs["cpu"], outs["cuda"]
    check(np.isfinite([l_gpu, n_gpu]).all(), "non-finite card train step")
    check(abs(l_gpu - l_cpu) <= 2 ** -7 * abs(l_cpu),
          f"card vs CPU train loss {l_gpu} vs {l_cpu}")
    check(abs(n_gpu - n_cpu) <= 2 ** -5 * n_cpu,
          f"card vs CPU grad norm {n_gpu} vs {n_cpu}")
    worst, rel_l2 = 0.0, {}
    for key, g in g_cpu.items():
        err = (g_gpu[key] - g).abs().max().item()
        scale = g.abs().max().item()
        check(err <= 2 ** -6 * scale,
              f"card vs CPU gradient of {key}: {err} > 2**-6 * {scale}")
        worst = max(worst, err / max(scale, 1e-30))
        rel_l2[key] = ((g_gpu[key] - g).norm() / g.norm()).item()
    print(f"small-input check: one train step, card vs CPU: loss {l_gpu} vs "
          f"{l_cpu}, grad norm {n_gpu} vs {n_cpu}, worst leaf max |diff| / "
          f"max |grad| {worst}, each leaf's |diff| / |grad| {rel_l2}")
    small_attention_grads()


def small_attention_grads():
    """The gradients of one attention layer of reduced minicpm-2b (head
    dim 64, bf16, 2 x 200 tokens: ragged tiles, rope) on the card (the
    flash kernels, through autograd in the model's layout) against the
    same layer, weights and inputs on the CPU (the plain versions).  With
    no deep chain of bf16 roundings between them, each weight's gradient
    agrees to 1e-2 of its norm and the input's gradient at every position
    to ``check_rows``'s limit: the projections round to bf16 in another
    order, and the kernels round P and dS to bf16 where the plain versions
    do."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models import layers, transformer
    cfg = reduced(get_config("minicpm-2b"), head_dim=64)
    attn = {k: w[0] for k, w in transformer.init(
        13, cfg, "cpu")["blocks"]["attn"].items()}
    rng = np.random.default_rng(14)
    x0, dout = (torch.from_numpy(rng.standard_normal(
        (2, 200, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
        for _ in range(2))
    grads = {}
    for dev in ("cpu", "cuda"):
        p = {k: w.detach().to(dev).requires_grad_(True)
             for k, w in attn.items()}
        x = x0.detach().to(dev).requires_grad_(True)
        before = launch_counts()
        out, _ = layers.attention_with_kv(p, cfg, x)
        out.backward(dout.to(dev))
        grown = {n: c - before[n] for n, c in launch_counts().items()}
        if dev == "cuda":
            check(grown["flash_attention"] == 1
                  and grown["flash_attention_bwd"] == 1,
                  f"the card's attention layer launched {grown}")
        grads[dev] = {"x": x.grad, **{k: w.grad for k, w in p.items()}}
    rel = {}
    for key, g in grads["cpu"].items():
        got = grads["cuda"][key].float().cpu()
        check(bool(torch.isfinite(got).all()), f"non-finite d{key}")
        if key == "x":
            rel.update(check_rows("dx", got, g))
            continue
        rel[key] = ((got - g.float()).norm() / g.float().norm()).item()
        check(rel[key] <= ROW_REL_TOL, f"card vs CPU attention gradient of "
              f"{key}: |diff| / |grad| = {rel[key]} > {ROW_REL_TOL}")
    print(f"small-input check: one attention layer's gradients, card vs CPU "
          f"(|diff| / |grad|, limit {ROW_REL_TOL}): {rel}")


def compare_logits(outs):
    import torch
    check(bool(torch.isfinite(outs["cuda"]).all()), "non-finite logits")
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    tol = 2 ** -6 * outs["cpu"].abs().max().item()
    check(err <= tol, f"card vs CPU logits differ by {err} > {tol}")
    return err, tol


def small_mamba2():
    """reduced(mamba2-2.7b) in bf16 on both devices: a ragged chunk of 32
    then two decode steps; returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm
    cfg = reduced(get_config("mamba2-2.7b"))
    params = ssm.init(5, cfg, "cpu")
    B = 2
    chunk = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 32)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        cache = ssm.init_cache(cfg, B, 64, device=dev)
        cache["len"] = torch.zeros(B, dtype=torch.int32, device=dev)
        before = ssd_scan.launches["ssd_scan"]
        lg, cache = ssm.prefill_chunk(
            p, cfg, {"tokens": chunk.to(dev)}, cache,
            chunk_len=torch.tensor([32, 19], dtype=torch.int32, device=dev))
        if dev == "cuda":
            check(ssd_scan.launches["ssd_scan"] == before + cfg.num_layers,
                  "the card's chunk did not run the ssd_scan kernel")
        logits = [lg.float().cpu()]
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = ssm.decode_step(p, cfg, tok, cache)
            logits.append(lg.float().cpu())
        outs[dev] = torch.stack(logits)
    return outs


def small_whisper():
    """reduced(whisper-large-v3) with head dim 64 in bf16 on both devices:
    a ragged first chunk of 32 with frame embeddings (encoder, cross K/V
    projection, cross-attention chunk), then two decode steps over int8
    pools; returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels.quant import QuantPages
    from repro_torch.models import encdec
    cfg = reduced(get_config("whisper-large-v3"), head_dim=64)
    params = encdec.init(7, cfg, "cpu")
    B, nblk, bs = 2, 4, 32
    rng = np.random.default_rng(8)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 32)))
    emb = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_len, cfg.d_model), dtype=np.float32))
    tables = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        cache = encdec.init_cache(cfg, B, 1, device=dev)
        shape = (cfg.num_layers, B * nblk + 1, bs, cfg.num_kv_heads,
                 cfg.head_dim)
        for n in "kv":
            cache[n] = QuantPages(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(shape[:-1], device=dev))
        cache["len"] = torch.zeros(B, dtype=torch.int32, device=dev)
        bt = tables.to(dev)
        before = (flash_attention.launches["flash_attention"],
                  decode_attention.launches["decode_attention"])
        lg, cache = encdec.prefill_chunk_paged(
            p, cfg, {"tokens": chunk.to(dev), "embeddings": emb.to(dev)},
            cache, bt, chunk_len=torch.tensor([32, 19], dtype=torch.int32,
                                              device=dev), block_size=bs)
        logits = [lg.float().cpu()]
        live = torch.tensor([True, True], device=dev)
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = encdec.decode_step_paged(p, cfg, tok, cache, bt,
                                                 live, block_size=bs)
            logits.append(lg.float().cpu())
        if dev == "cuda":
            layers = cfg.encoder_layers + cfg.num_layers
            check((flash_attention.launches["flash_attention"],
                   decode_attention.launches["decode_attention"])
                  == (before[0] + layers, before[1] + 2 * cfg.num_layers),
                  "the card's whisper steps did not run the flash and "
                  "decode attention kernels")
        outs[dev] = torch.stack(logits)
    return outs


def small_mixtral():
    """reduced(mixtral-8x7b) with head dim 64 in bf16 on both devices: a
    ragged chunk of 32 (each slot its own routing group of capacity 20)
    then two decode steps over bf16 pools; returns the stacked logits per
    device.  The router's weights are zeros, so every router probability
    is exactly 1/4 on both devices and both route each token to experts 0
    and 1 (the lowest index wins a tie): the two devices' bf16 roundings,
    which differ, cannot flip an argmax that a random router leaves within
    their noise.  The capacity drops 12 of each group's 32 first and 32
    second choices, so the drop path runs too; routing with random
    weights is held to the reference in tests/test_torch_moe.py and runs
    at full size in phase 6."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import grouped_matmul
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral-8x7b"), head_dim=64)
    params = moe.init(9, cfg, "cpu")
    params["blocks"]["moe"]["router"].zero_()
    B, nblk, bs = 2, 2, 32                 # 64 tokens a slot: the window
    chunk = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (B, 32)))
    tables = torch.arange(B * nblk, dtype=torch.int32).reshape(B, nblk)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        shape = (cfg.num_layers, B * nblk + 1, bs, cfg.num_kv_heads,
                 cfg.head_dim)
        cache = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                 for n in "kv"}
        cache["len"] = torch.zeros(B, dtype=torch.int32, device=dev)
        bt = tables.to(dev)
        before = grouped_matmul.launches["grouped_matmul"]
        lg, cache = moe.prefill_chunk_paged(
            p, cfg, {"tokens": chunk.to(dev)}, cache, bt,
            chunk_len=torch.tensor([32, 19], dtype=torch.int32, device=dev),
            block_size=bs)
        logits = [lg.float().cpu()]
        live = torch.tensor([True, True], device=dev)
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = moe.decode_step_paged(p, cfg, tok, cache, bt, live,
                                              block_size=bs)
            logits.append(lg.float().cpu())
        if dev == "cuda":
            check(grouped_matmul.launches["grouped_matmul"]
                  == before + 3 * 3 * cfg.num_layers,
                  "the card's mixtral steps did not run the grouped GEMM "
                  "kernel")
        outs[dev] = torch.stack(logits)
    return outs


def small_dense_steps(arch, seed):
    """reduced(arch) with head dim 64 in bf16 on both devices: a one-shot
    ``prefill`` of 2 x 20 tokens into a 48-row cache and two decode steps,
    then two ragged chunks into a fresh dense cache (``prefill_chunk``,
    one dense chunk kernel launch a layer on the card; the first chunk
    carries frame embeddings for whisper) and two decode steps.  A MoE
    router is zeroed (see ``small_mixtral``).  Returns the stacked logits
    per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import chunk_attention
    from repro_torch.models.registry import model_api
    cfg = reduced(get_config(arch), head_dim=64)
    api = model_api(cfg)
    params = api.init(seed, cfg, "cpu")
    if cfg.family == "moe":
        params["blocks"]["moe"]["router"].zero_()
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20)))
    chunks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, T)))
              for T in (32, 16)]
    emb = None
    if cfg.family == "audio":
        emb = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_len, cfg.d_model), dtype=np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        batch = {"tokens": prompt.to(dev)}
        if emb is not None:
            batch["embeddings"] = emb.to(dev)
        lg, cache = api.prefill(p, cfg, batch, cache_size=48)
        logits = [lg]
        for step in range(2):
            tok = torch.tensor([7 + step, 11 + step], device=dev)
            lg, cache = api.decode_step(p, cfg, tok, cache)
            logits.append(lg)
        cache = api.init_cache(cfg, 2, 48, device=dev)
        cache["len"] = torch.zeros(2, dtype=torch.int32, device=dev)
        before = chunk_attention.launches["chunk_prefill_attention"]
        for i, (chunk, cl) in enumerate(zip(chunks, ([32, 19], [16, 9]))):
            batch = {"tokens": chunk.to(dev)}
            if emb is not None and i == 0:
                batch["embeddings"] = emb.to(dev)
            lg, cache = api.prefill_chunk(
                p, cfg, batch, cache,
                chunk_len=torch.tensor(cl, dtype=torch.int32, device=dev))
            logits.append(lg)
        if dev == "cuda":
            check(chunk_attention.launches["chunk_prefill_attention"]
                  == before + 2 * cfg.num_layers,
                  f"the card's {arch} chunks did not run the dense chunk "
                  f"kernel")
        for step in range(2):
            tok = torch.tensor([3 + step, 5 + step], device=dev)
            lg, cache = api.decode_step(p, cfg, tok, cache)
            logits.append(lg)
        outs[dev] = torch.stack([x.float().cpu() for x in logits])
    return outs


def small_ring():
    """reduced(mixtral-8x7b) (router zeroed) in bf16 on both devices: a
    70-token prompt prefilled for a 128-token slot budget, twice the
    64-token window, keeps a ring of the last 64 rows; three decode steps
    wrap around it.  Returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral-8x7b"), head_dim=64)
    params = moe.init(9, cfg, "cpu")
    params["blocks"]["moe"]["router"].zero_()
    prompt = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (1, 70)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        lg, cache = moe.prefill(p, cfg, {"tokens": prompt.to(dev)},
                                cache_size=128)
        check(cache["k"].shape[2] == 64, "the ring is not the window")
        logits = [lg]
        for step in range(3):
            lg, cache = moe.decode_step(p, cfg, torch.tensor(
                [5 + step], device=dev), cache)
            logits.append(lg)
        outs[dev] = torch.stack([x.float().cpu() for x in logits])
    return outs


def small_ssm_prefill():
    """reduced(mamba2-2.7b) in bf16 on both devices: a one-shot
    ``ssm.prefill`` of 2 x 40 tokens (one SSD scan launch a layer on the
    card) and two decode steps.  Returns the stacked logits per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm
    cfg = reduced(get_config("mamba2-2.7b"))
    params = ssm.init(19, cfg, "cpu")
    prompt = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (2, 40)))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_to(params, dev)
        before = ssd_scan.launches["ssd_scan"]
        lg, cache = ssm.prefill(p, cfg, {"tokens": prompt.to(dev)})
        if dev == "cuda":
            check(ssd_scan.launches["ssd_scan"] == before + cfg.num_layers,
                  "the card's one-shot prefill did not run the ssd_scan "
                  "kernel")
        logits = [lg]
        for step in range(2):
            lg, cache = ssm.decode_step(p, cfg, torch.tensor(
                [7 + step, 11 + step], device=dev), cache)
            logits.append(lg)
        outs[dev] = torch.stack([x.float().cpu() for x in logits])
    return outs


def small_sync_wave():
    """One sync-mode wave of reduced(minicpm-2b) (head dim 64, bf16, 6
    requests of 5-30 tokens, 8 new each, batches of 4) on both devices.
    Greedy chains in bf16 can part at a near-tie that the devices' other
    rounding order flips, after which the rest of the chain differs, so
    the tokens are held to agreement at 0.75 of the positions (the logits
    themselves are held by ``small_dense_steps``).  Returns the share of
    positions that agree."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import plan_for
    from repro_torch.models import transformer
    from repro_torch.serving.engine import GenerationRequest, ServiceRuntime
    full = get_config("minicpm-2b")
    cfg = reduced(full, head_dim=64)
    params = transformer.init(20, cfg, "cpu")
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 12, 21, 8, 17)]
    toks = {}
    for dev in ("cpu", "cuda"):
        rt = ServiceRuntime(cfg, tree_to(params, dev),
                            plan_for(full, "bf16", 4), mode="sync",
                            device=dev)
        for rid, prompt in enumerate(prompts):
            rt.submit(GenerationRequest(rid=rid, tokens=prompt,
                                        max_new_tokens=8, stream=rid))
        res = rt.drain()
        check(len(res) == len(prompts), f"sync wave on {dev} served "
              f"{len(res)}/{len(prompts)}")
        toks[dev] = {r.rid: np.asarray(r.tokens) for r in res}
    same = sum(int((toks["cpu"][r] == toks["cuda"][r]).sum())
               for r in toks["cpu"])
    share = same / sum(len(t) for t in toks["cpu"].values())
    check(share >= 0.75, f"card vs CPU sync-wave tokens agree at only "
          f"{share} of the positions")
    return share


def small_moe_layer():
    """Layer 0's MoE FFN of the same reduced(mixtral-8x7b), with its random
    router, on the same bf16 input on both devices: two routing groups of
    32 tokens, capacity 20.  The router's f32 products differ by float
    noise only, and on this input (seed 15) every token's first, second
    and third router probabilities lie more than 0.008 apart, so the
    devices route alike; 2 assignments are dropped on both.  Returns the
    outputs per device."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral-8x7b"), head_dim=64)
    params = moe.init(9, cfg, "cpu")
    layer = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 32, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    outs, drops = {}, {}
    for dev in ("cpu", "cuda"):
        p = tree_to(layer, dev)
        probs = torch.softmax(x.to(dev).float() @ p["router"].float(), -1)
        drops[dev] = moe._top_k_dispatch(probs, cfg.experts_per_token,
                                         20)[2].item()
        y, _ = moe.moe_mlp(p, cfg, x.to(dev))
        outs[dev] = y.float().cpu()
    check(drops["cpu"] == drops["cuda"] == 2,
          f"MoE layer drops differ across devices: {drops}")
    return outs


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def ptxas_lines(log):
    """(kernel, line) for each register and spill line of ``ptxas -v``'s
    output, the kernel named by the mangled name of the entry function the
    line belongs to, with its integer template arguments
    (``flash_fwd_kernel<64>``)."""
    import re
    kernel = "?"
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(_Z\w+)", line)
        if entry:
            kernel = demangle(entry[1])
        elif "registers" in line or "spill" in line:
            yield kernel, line.replace("ptxas info    :", "").strip()


def ptxas_record(source):
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} of one
    source's ``ptxas -v`` output in this run's build (empty where this run
    found the library built)."""
    import re
    from repro_torch.kernels import build
    out = {}
    for kernel, line in ptxas_lines(build.build_log.get(source, "")):
        k = out.setdefault(kernel, {"registers": None, "spill_bytes": 0})
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            k["registers"] = int(regs[1])
        k["spill_bytes"] += sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", line))
    return out


def demangle(mangled):
    """The last name of an Itanium-mangled function and its template
    arguments, integers and types: ``_ZN..16flash_fwd_kernelILi64EE..`` ->
    ``flash_fwd_kernel<64>``, ``..18paged_chunk_kernelIaLi64EE..`` ->
    ``paged_chunk_kernel<int8, 64>``."""
    import re
    builtin = {"a": "int8", "h": "uint8", "i": "int", "f": "float"}
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while True:
        num = re.match(r"\d+", mangled[i:])
        if num is None:
            break
        j = i + num.end()
        name, i = mangled[j:j + int(num[0])], j + int(num[0])
    if not mangled[i:].startswith("I"):
        return name
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        lit = re.match(r"L[a-z](-?\d+)E", mangled[i:])
        typ = re.match(r"(\d+)", mangled[i:])
        if lit:
            args.append(lit[1])
            i += lit.end()
        elif typ:
            j = i + typ.end()
            args.append(mangled[j:j + int(typ[1])].strip("_"))
            i = j + int(typ[1])
        elif mangled[i] in builtin:
            args.append(builtin[mangled[i]])
            i += 1
        else:
            break
    return f"{name}<{', '.join(args)}>"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "runs on the card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build, paged_attention

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_ROOT})")
    for name, log in build.build_log.items():
        for kernel, line in ptxas_lines(log):
            print(f"  ptxas {name} {kernel}: {line}")

    print("phase 1: kernels against their plain versions "
          f"(atol = rtol = {TOL})")
    records = phase_kernels()
    for name, rec in records.items():
        print(f"  {name}: {rec}")

    reset_launches()
    print("phase 2: launcher, minicpm-2b full width")
    phase_launcher()
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 3: request wave, prompts of 6-200 tokens, 40 new each")
    int8_toks, int8_grown, int8_tok_s = wave("int8")
    bf16_toks, bf16_grown, _ = wave("bf16")
    launches = dict(paged_attention.launches)
    check(int8_grown["paged_decode_attention_quant"] > 0
          and int8_grown["paged_chunk_prefill_attention_quant"] > 0,
          f"int8 wave did not launch the int8 kernels: {int8_grown}")
    check(bf16_grown["paged_decode_attention"] > 0
          and bf16_grown["paged_chunk_prefill_attention"] > 0,
          f"bf16 wave did not launch the bf16 kernels: {bf16_grown}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    for kv, toks in (("int8", int8_toks), ("bf16", bf16_toks)):
        print(f"phase 3 {kv} greedy tokens: "
              + json.dumps([toks[r].tolist() for r in sorted(toks)]))
    same = sum(int((int8_toks[r] == bf16_toks[r]).sum()) for r in int8_toks)
    total = sum(len(t) for t in int8_toks.values())
    print(f"phase 3 int8 vs bf16 greedy tokens: {same}/{total} positions "
          f"agree ({same / total:.3f})")
    print("phase 4: request wave, mamba2-2.7b full width, 128 slots")
    launches["ssd_scan"] = wave_mamba2()
    print("phase 5: request wave, whisper-large-v3 full width, 128 slots")
    whisper_launches = wave_whisper()
    for name in ("flash_attention", "decode_attention"):
        launches[name] = whisper_launches[name]
    print("phase 6: request wave, mixtral-8x7b full width, 16 of 32 layers, "
          "512 slots")
    launches["grouped_matmul"] = wave_mixtral()["grouped_matmul"]
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 7: training, minicpm-2b full width, batch 2 x 4096, "
          "2 microbatches")
    train_launches = phase_train()
    launches["flash_attention"] += train_launches["flash_attention"]
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 8: the sync and dense-cache paths, minicpm-2b full width")
    phase_dense_launchers()
    oracle_launches, oracle_toks = wave_oracle()
    launches["chunk_prefill_attention"] = \
        oracle_launches["chunk_prefill_attention"]
    same = sum(int((oracle_toks[r] == bf16_toks[r]).sum())
               for r in oracle_toks)
    print(f"phase 8 (b) oracle vs phase 3 native bf16 greedy tokens: "
          f"{same}/{sum(len(t) for t in oracle_toks.values())} positions "
          f"agree")
    logits_parity()
    wave_sync()
    print("phase 9: the prefix cache, minicpm-2b full width, 512 slots, "
          "64 requests sharing a 150-token template, 24 new each")
    templated_launches = phase_templated()
    print(f"phase 9 launches: {templated_launches}")
    print("phase 10: observability and evacuation, minicpm-2b full width, "
          "512 slots")
    phase_obs_smoke()
    gc.collect()
    torch.cuda.empty_cache()
    phase3_final = phase_obs_wave(int8_toks, int8_grown)
    phase_evacuate(int8_toks, phase3_final)
    del phase3_final
    print("phase 11: threefry sampling, SDF admission with parking, n-way "
          "forks, minicpm-2b full width")
    phase_sampling_admission(int8_toks, int8_tok_s)
    print("phase 12: speculative decoding, minitron-4b full width, 512 "
          "slots, k = 4; mixtral-8x7b full width, 2 of 32 layers")
    phase_speculative()
    small_input_check()

    kernels = []
    for name, rec in records.items():
        source = SOURCES[name if name in SOURCES else "paged_attention"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        **{k: rec[k] for k in RECORD_KEYS}})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s, build included")
    check(len(kernels) == 10, f"expected ten kernels, got {len(kernels)}")
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel of the main paths never launched: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
