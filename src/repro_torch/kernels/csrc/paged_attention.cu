// Paged attention over the serving arena's page pools, written by hand for
// Hopper (sm_90a), with a plain C interface bound by ctypes
// (kernels/paged_attention.py).
//
// Replaces four Pallas TPU kernels of the reference package,
// src/repro/kernels/decode_attention.py:
//   paged_decode_attention_pallas               :466  (body :425)
//   paged_decode_attention_quant_pallas         :581  (body :538)
//   paged_chunk_prefill_attention_pallas        :305  (body :276, :153)
//   paged_chunk_prefill_attention_quant_pallas  :675  (body :644, :153)
// Two algorithms (one-token decode, chunked prefill), each templated on the
// page type: bf16 pages, or int8 pages with one f32 scale per (token, head).
// Both read the pool in place, (P, bs, Hkv, D) with the caller's strides,
// through the slot's own block-table row; it is never transposed or copied
// (the Pallas wrappers transpose the whole pool on every call), and no key
// at or past the slot's visible range is read: the last tile's rows past it
// are zero-filled, matching the Pallas @pl.when gates.  Rows finalize with
// acc / max(l, 1e-37), so a row that sees no key yields zeros, not NaN.
//
// Decode (the `attend` body).  What bounds it on this card: bytes.  It does
// 4*D flops per (query head, key) against 2*D bytes of bf16 K/V per
// (kv head, key): with a query group of G heads that is G flops per byte,
// far below the ~295 the H100 needs before its tensor cores, not its
// 3.35 TB/s of HBM, are the limit.  So it spends nothing on flops and
// everything on moving each live K/V byte once:
//   * one block per (slot, kv head) serves all G query heads of that group
//     from one staged tile, so a GQA group reads its K/V once, not G times
//     (the Pallas grid (B*Hq, nk) streams it again for every query head);
//   * keys in 32-key f32 tiles, 16-byte loads into shared memory; int8
//     pages are dequantized in registers while the tile is staged
//     (float(v) * scale), so the pool never exists in float;
//   * one warp per query head, one lane per key for the scores, each thread
//     owning (head, dim) pairs of P V; plain FMA, no mma;
//   * the single query is kept as one row per head: the TPU's 8-sublane
//     broadcast of it (_SUB) has no counterpart here.
//
// Chunked prefill (paged_chunk_kernel).  At the serving path's shape (one
// slot, at most 128 rows, 36 heads, D = 64, at most 192 visible keys) it is
// bytes-bound too on paper (0.15 GFLOP against ~3.5 MB: ~40 flops a byte),
// but it is small, so what bounds it in practice is latency: the chain of
// steps one block takes.  The design shortens that chain and puts the
// products on the tensor cores, in the shape of the flash forward
// (flash_attention.cu), with the tiles of mma_tiles.cuh:
//   * one block per (slot, query head, 64 query rows), 4 warps of 16 rows
//     (phase 3's chunk: 72 blocks for 132 SMs; 32-row blocks of 2 warps,
//     144 blocks, were the slower in a side-by-side build on the H100); a
//     tile whose rows are all dead writes zeros and returns before it
//     reads anything;
//   * the live rows of q are copied once by 16-byte cp.async and held as
//     ldmatrix A fragments;
//   * keys come 64 at a time, gathered row by row through the block-table
//     row with 16-byte cp.async (a tile may span pages and end inside one),
//     through a two-stage ring: tile j + 1's copy is issued before tile j's
//     products;
//   * S = Q K^T and O += P V on mma.sync.m16n8k16 bf16 -> f32, the online
//     softmax on the accumulator fragments (ex2.approx in the log2
//     domain), the element mask (causal, prefix, chunk end, dead rows) only
//     on a tile that crosses an edge; P is rounded to bf16 for P V, the row
//     sums taken from the f32 P, as in the flash forward;
//   * int8 pages: the raw int8 K and V rows and their f32 scales are staged
//     (cp.async, 16 and 4 bytes), then widened to bf16 in shared memory,
//     exactly (|v| <= 127); S's column j is multiplied by k_scale[j] in f32
//     after Q K^T, and v_scale[j] folds into P's column j after the row sums
//     and before P is rounded to bf16.  So the products are the plain
//     version's dequantize products (q . (k * k_scale), p . (v * v_scale))
//     with only P's rounding to bf16 added; the pool never exists in float;
//   * GQA: a block serves one query head and reads its kv head's tiles (a
//     group's heads read them through L2).
// Not done yet: wgmma, TMA, packing a GQA group's heads into one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                 // decode: keys per staged tile, one per lane
constexpr int kMaxRows = 16;              // decode: query heads one block serves
constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // -0.7 * FLT_MAX

template <typename PageT>
struct Page;

template <>
struct Page<__nv_bfloat16> {
  static constexpr int kVec = 8;          // elements per 16-byte load
  __device__ static void load(const __nv_bfloat16* src, float, float* dst) {
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = __bfloat162float(h[e]);
  }
};

template <>
struct Page<int8_t> {
  static constexpr int kVec = 16;
  __device__ static void load(const int8_t* src, float scale, float* dst) {
    int4 raw = *reinterpret_cast<const int4*>(src);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = static_cast<float>(v[e]) * scale;
  }
};

// One layer's K and V pools, read in place.  Strides are in elements; the
// head stride is D for values and 1 for scales (checked by the wrapper).
struct Pool {
  const void* k;
  const void* v;
  const float* ks;                        // int8 only: (P, bs, Hkv) scales
  const float* vs;
  long long page_stride, tok_stride;
  long long spage_stride, stok_stride;
  const int* tables;                      // (B, nblk) logical -> physical
  int nblk, bs;
};

template <int D>
struct Smem {
  float q[kMaxRows][D];
  float k[kKeys][D + 1];                  // +1: lane j reads row j, no conflicts
  float v[kKeys][D];
  float p[kMaxRows][kKeys];
  float m[kMaxRows], l[kMaxRows], alpha[kMaxRows];
  int qpos[kMaxRows], alive[kMaxRows];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The shared body: ``nrows`` query rows (already in sm.q, with their
// absolute positions in sm.qpos and liveness in sm.alive) attend over keys
// [0, kend) of slot ``b``, kv head ``kvh``.  A key at kpos is visible to
// row r iff the row is alive and (kpos <= qpos[r] or kpos < prefix_len);
// the caller guarantees that no visible key lies at or past ``kend``.
// Writes row r of the result to out + r * out_row_stride.
template <typename PageT, int D>
__device__ void attend(Smem<D>& sm, const Pool& pool, int b, int kvh,
                       int kend, int nrows, int prefix_len, float scale,
                       __nv_bfloat16* out, long long out_row_stride) {
  constexpr int kVec = Page<PageT>::kVec;
  constexpr int kParts = D / kVec;                 // 16-byte loads per row
  constexpr int kOwn = kMaxRows * D / kThreads;    // (row, dim) pairs per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* table = pool.tables + static_cast<long long>(b) * pool.nblk;
  const PageT* kbase = static_cast<const PageT*>(pool.k) + kvh * D;
  const PageT* vbase = static_cast<const PageT*>(pool.v) + kvh * D;

  float acc[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = 0.f;
  if (tid < kMaxRows) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < kend; t0 += kKeys) {
    // 1. stage keys t0 .. t0+31 (f32, dequantized); rows at or past kend
    //    are zeros and never read from the pool
    for (int c = tid; c < kKeys * kParts; c += kThreads) {
      const int j = c / kParts, col = (c % kParts) * kVec;
      const int kpos = t0 + j;
      float kv[kVec], vv[kVec];
      if (kpos < kend) {
        const long long page = table[kpos / pool.bs];
        const long long off = kpos % pool.bs;
        const long long e = page * pool.page_stride + off * pool.tok_stride + col;
        float ksc = 1.f, vsc = 1.f;
        if (pool.ks != nullptr) {
          const long long se = page * pool.spage_stride + off * pool.stok_stride + kvh;
          ksc = pool.ks[se];
          vsc = pool.vs[se];
        }
        Page<PageT>::load(kbase + e, ksc, kv);
        Page<PageT>::load(vbase + e, vsc, vv);
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x) kv[x] = vv[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < kVec; ++x) {
        sm.k[j][col + x] = kv[x];
        sm.v[j][col + x] = vv[x];
      }
    }
    __syncthreads();

    // 2. scores and the online-softmax update: one warp per row, one lane
    //    per key (the order of the Pallas tile: mask, max, rescale, sum)
    for (int r = warp; r < nrows; r += kWarps) {
      const float m_prev = sm.m[r];
      const int kpos = t0 + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += sm.q[r][d] * sm.k[lane][d];
      s *= scale;
      const bool ok = sm.alive[r] && kpos < kend &&
                      (kpos <= sm.qpos[r] || kpos < prefix_len);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      sm.p[r][lane] = p;
      if (lane == 0) {
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * alpha + psum;
        sm.alpha[r] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ V, each thread owning (row, dim) pairs
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int idx = tid + i * kThreads, r = idx / D, d = idx % D;
      if (r < nrows) {
        float a = acc[i] * sm.alpha[r];
#pragma unroll 8
        for (int j = 0; j < kKeys; ++j) a += sm.p[r][j] * sm.v[j][d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int idx = tid + i * kThreads, r = idx / D, d = idx % D;
    if (r < nrows)
      out[r * out_row_stride + d] = __float2bfloat16(acc[i] / fmaxf(sm.l[r], 1e-37f));
  }
}

// Decode: block (slot b, kv head kvh) serves query heads kvh*G .. kvh*G+G-1,
// which attend to keys [0, cache_len[b]).
template <typename PageT, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    __nv_bfloat16* __restrict__ out, Pool pool,
                    const int* __restrict__ cache_len, int Hq, int Hkv,
                    float scale) {
  __shared__ Smem<D> sm;
  const int b = blockIdx.x, kvh = blockIdx.y, G = Hq / Hkv;
  const int len = cache_len[b];
  const long long row0 = static_cast<long long>(b) * Hq + static_cast<long long>(kvh) * G;
  if (len <= 0) {                          // an empty (or dead) slot sees no key
    for (int c = threadIdx.x; c < G * D; c += kThreads)
      out[row0 * D + c] = __float2bfloat16(0.f);
    return;
  }
  const __nv_bfloat16* qb = q + row0 * D;
  for (int c = threadIdx.x; c < G * D; c += kThreads)
    sm.q[c / D][c % D] = __bfloat162float(qb[c]);
  if (threadIdx.x < kMaxRows) {
    sm.qpos[threadIdx.x] = len - 1;        // kpos <= len - 1  <=>  kpos < len
    sm.alive[threadIdx.x] = 1;
  }
  __syncthreads();
  const int kend = max(0, min(len, pool.nblk * pool.bs));
  attend<PageT, D>(sm, pool, b, kvh, kend, G, 0, scale, out + row0 * D, D);
}

// ---------------------------------------------------------------------------
// Chunked prefill on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kChunkWarps = 4;            // each serves 16 query rows
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kChunkRows = 16 * kChunkWarps;   // query rows a block serves
constexpr int kChunkKeys = 64;            // keys per staged tile

template <typename PageT, int D>
struct ChunkCfg {
  static constexpr bool kQuant = sizeof(PageT) == 1;
  static constexpr int LD = D + kPad;                    // bf16 tile row stride
  static constexpr int kTile = kChunkKeys * LD;          // bf16 per K or V tile
  // bf16 pages land in a two-stage ring of bf16 tiles; int8 pages in a
  // two-stage ring of raw tiles and their scales, widened into one bf16
  // tile each for the products
  static constexpr int kStages16 = kQuant ? 1 : 2;
  static constexpr int kSmemBytes =
      (kChunkRows * LD + 2 * kStages16 * kTile) * 2 +
      (kQuant ? 2 * 2 * kChunkKeys * (D + 4) : 0);
};

// Start copying keys [t0, t0 + 64) of kv head ``kvh``, gathered row by row
// from the pages that the slot's block-table row ``table`` names, into
// shared memory: K and V rows (destination row stride ``ld`` elements)
// and, for int8 pages, their f32 scales.  Keys at or past ``kend`` become
// zeros and are not read.  The caller commits the group.
template <typename PageT, int D>
__device__ __forceinline__ void stage_keys(const Pool& pool, const int* table,
                                           int kvh, int t0, int kend,
                                           PageT* dk, PageT* dv, int ld,
                                           float* dks, float* dvs) {
  constexpr int kVec = 16 / sizeof(PageT);             // elements a copy
  constexpr int kParts = D / kVec;
  const PageT* kb = static_cast<const PageT*>(pool.k) + kvh * D;
  const PageT* vb = static_cast<const PageT*>(pool.v) + kvh * D;
  for (int c = threadIdx.x; c < kChunkKeys * kParts; c += kChunkThreads) {
    const int j = c / kParts, col = (c % kParts) * kVec;
    const int kpos = t0 + j;
    const bool ok = kpos < kend;
    long long e = 0;
    if (ok)
      e = static_cast<long long>(table[kpos / pool.bs]) * pool.page_stride +
          (kpos % pool.bs) * pool.tok_stride + col;
    cp_async16(dk + j * ld + col, kb + e, ok ? 16 : 0);
    cp_async16(dv + j * ld + col, vb + e, ok ? 16 : 0);
  }
  if constexpr (sizeof(PageT) == 1) {
    for (int j = threadIdx.x; j < kChunkKeys; j += kChunkThreads) {
      const int kpos = t0 + j;
      const bool ok = kpos < kend;
      long long e = 0;
      if (ok)
        e = static_cast<long long>(table[kpos / pool.bs]) * pool.spage_stride +
            (kpos % pool.bs) * pool.stok_stride + kvh;
      cp_async4(dks + j, pool.ks + e, ok ? 4 : 0);
      cp_async4(dvs + j, pool.vs + e, ok ? 4 : 0);
    }
  }
}

// int8 rows (64 x D, row stride D) -> bf16 rows (row stride D + kPad),
// exactly: |v| <= 127 fits bf16's 8-bit significand
template <int D>
__device__ __forceinline__ void widen(bf16* dst, const int8_t* src) {
  constexpr int kParts = D / 16;
  for (int c = threadIdx.x; c < kChunkKeys * kParts; c += kChunkThreads) {
    const int j = c / kParts, col = (c % kParts) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + j * D + col);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
      w[x] = pack_bf16(static_cast<float>(v[2 * x]),
                       static_cast<float>(v[2 * x + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + j * (D + kPad) + col);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// Chunked prefill: block (slot b, query head h, tile z of 64 rows), warp w
// serving rows 16 w .. 16 w + 15 of the tile; row i sits at absolute
// position start[b] + i and is alive iff i < chunk_len[b].  It sees a key
// at kpos iff (kpos <= start + i or kpos < prefix_len) and
// kpos < start + chunk_len.
template <typename PageT, int D>
__global__ void __launch_bounds__(kChunkThreads)
paged_chunk_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                   Pool pool, const int* __restrict__ start,
                   const int* __restrict__ chunk_len, int T, int Hq, int Hkv,
                   int prefix_len, float scale) {
  using C = ChunkCfg<PageT, D>;
  constexpr int BM = kChunkRows, BN = kChunkKeys, LD = C::LD;
  constexpr bool kQuant = C::kQuant;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + BM * LD;                     // stage s at sk + s * kTile
  bf16* sv = sk + C::kStages16 * C::kTile;
  // int8: raw stage s at rk + s * BN * D, its scales at sks + s * BN
  PageT* rk = reinterpret_cast<PageT*>(sv + C::kStages16 * C::kTile);
  PageT* rv = rk + 2 * BN * D;
  float* sks = reinterpret_cast<float*>(rv + 2 * BN * D);
  float* svs = sks + 2 * BN;

  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * BM;
  const int kvh = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int st = start[b], cl = chunk_len[b];
  const int nrows = min(BM, T - i0);
  const int alive = max(0, min(nrows, cl - i0));  // rows i0 .. i0+alive-1
  constexpr int kParts = D / 8;                    // 16-byte pieces a row
  const long long row_stride = static_cast<long long>(Hq) * D;
  const long long row0 = (static_cast<long long>(b) * T + i0) * Hq + h;
  bf16* ob = out + row0 * D;
  if (alive == 0) {                        // every row of the tile is dead
    for (int c = threadIdx.x; c < nrows * kParts; c += kChunkThreads)
      *reinterpret_cast<uint4*>(ob + (c / kParts) * row_stride +
                                (c % kParts) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }
  // keys a live row of this tile can see: below its position + 1 or the
  // prefix, and always below start + chunk_len (and the table's end)
  const int end = min(st + cl, pool.nblk * pool.bs);
  const int kend = max(0, min(end, max(st + i0 + alive, prefix_len)));
  const int* table = pool.tables + static_cast<long long>(b) * pool.nblk;
  auto issue = [&](int s, int t0) {
    if constexpr (kQuant)
      stage_keys<PageT, D>(pool, table, kvh, t0, kend, rk + s * BN * D,
                           rv + s * BN * D, D, sks + s * BN, svs + s * BN);
    else
      stage_keys<PageT, D>(pool, table, kvh, t0, kend, sk + s * C::kTile,
                           sv + s * C::kTile, LD, nullptr, nullptr);
  };

  // group 1: the live rows of q (dead rows are zeros, never read);
  // group 2: the first key tile, into stage 0
  stage<D, kChunkThreads>(sq, q + row0 * D, row_stride, 0, BM, alive);
  cp_async_commit();
  if (kend > 0) issue(0, 0);
  cp_async_commit();

  bf16* wq = sq + warp * 16 * LD;              // this warp's 16 rows of q
  uint32_t qf[D / 16][4];
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) load_a<D>(qf[kd], wq, kd * 16, lane);

  // this thread's rows of the chunk: row and row + 8
  const int row = i0 + warp * 16 + g;
  const float sl2 = scale * kLog2e;
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int s = 0, t0 = 0; t0 < kend; s ^= 1, t0 += BN) {
    // issue the next tile's copy into the other stage, then wait for this one
    if (t0 + BN < kend) issue(s ^ 1, t0 + BN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = sk + s * C::kTile;
    const bf16* vt = sv + s * C::kTile;
    if constexpr (kQuant) {
      widen<D>(sk, rk + s * BN * D);
      widen<D>(sv, rv + s * BN * D);
      kt = sk;
      vt = sv;
      __syncthreads();
    }

    // 1. S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    frags_dot_rows<D, BN>(sc, qf, kt, lane);

    // 2. into the log2 domain (int8: times the key's scale); the element
    //    mask only where some live row does not see the whole tile: a dead
    //    row in the tile, the chunk's end, or the diagonal past the prefix
    const int k_hi = t0 + BN - 1;
    const bool edge = alive < nrows || k_hi >= end ||
                      (k_hi >= prefix_len && k_hi > st + i0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        float x = sc[j][e] * sl2;
        if constexpr (kQuant) x *= sks[s * BN + col];
        if (edge) {
          const int i = row + 8 * (e >> 1), kpos = t0 + col;
          if (!(i < cl && kpos < end && (kpos <= st + i || kpos < prefix_len)))
            x = -INFINITY;
        }
        sc[j][e] = x;
      }

    // 3. the online softmax; int8: the value's scale folds into P's column
    //    after the row sums and before P is rounded to bf16
    online_softmax<BN, D>(sc, m, l, o);
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] *= svs[s * BN + j * 8 + 2 * t + (e & 1)];
    }

    // 4. O += P V
    regs_dot_tile<D, BN, D>(o, sc, vt, 0, lane);
    __syncthreads();                           // this stage's readers are done
  }
  cp_async_wait<0>();
  __syncthreads();                             // q's copies landed everywhere

  // O / l through this warp's own rows of the q tile as 16-byte stores;
  // a row that saw no key (dead, or no visible key) is zeros
  finalize_rows<D>(wq, o, l, lane);
#pragma unroll
  for (int c = lane; c < 16 * kParts; c += 32) {
    const int r = c / kParts, col = (c % kParts) * 8;
    if (warp * 16 + r < nrows)
      *reinterpret_cast<uint4*>(ob + (warp * 16 + r) * row_stride + col) =
          *reinterpret_cast<const uint4*>(wq + r * LD + col);
  }
}

Pool make_pool(const void* kp, const void* vp, const void* ks, const void* vs,
               const void* tables, int nblk, int bs, long long page_stride,
               long long tok_stride, long long spage_stride,
               long long stok_stride) {
  Pool p;
  p.k = kp;
  p.v = vp;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.page_stride = page_stride;
  p.tok_stride = tok_stride;
  p.spage_stride = spage_stride;
  p.stok_stride = stok_stride;
  p.tables = static_cast<const int*>(tables);
  p.nblk = nblk;
  p.bs = bs;
  return p;
}

template <typename PageT>
int launch_decode(const void* q, void* out, const Pool& pool,
                  const void* cache_len, int B, int Hq, int Hkv, int D,
                  float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, Hkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const auto* lens = static_cast<const int*>(cache_len);
  if (D == 64)
    paged_decode_kernel<PageT, 64><<<grid, kThreads, 0, s>>>(qq, oo, pool, lens, Hq, Hkv, scale);
  else if (D == 128)
    paged_decode_kernel<PageT, 128><<<grid, kThreads, 0, s>>>(qq, oo, pool, lens, Hq, Hkv, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename PageT, int D>
int launch_chunk_d(const bf16* q, bf16* out, const Pool& pool, const int* st,
                   const int* cl, int B, int T, int Hq, int Hkv,
                   int prefix_len, float scale, cudaStream_t s) {
  using C = ChunkCfg<PageT, D>;
  static unsigned long long opted = 0;       // bit per device ordinal
  const cudaError_t err =
      opt_in(paged_chunk_kernel<PageT, D>, C::kSmemBytes, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hq, (T + kChunkRows - 1) / kChunkRows);
  paged_chunk_kernel<PageT, D><<<grid, kChunkThreads, C::kSmemBytes, s>>>(
      q, out, pool, st, cl, T, Hq, Hkv, prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename PageT>
int launch_chunk(const void* q, void* out, const Pool& pool,
                 const void* start, const void* chunk_len, int B, int T,
                 int Hq, int Hkv, int D, int prefix_len, float scale,
                 void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv ||
      (T + kChunkRows - 1) / kChunkRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const bf16*>(q);
  auto* oo = static_cast<bf16*>(out);
  const auto* st = static_cast<const int*>(start);
  const auto* cl = static_cast<const int*>(chunk_len);
  if (D == 64)
    return launch_chunk_d<PageT, 64>(qq, oo, pool, st, cl, B, T, Hq, Hkv,
                                     prefix_len, scale, s);
  if (D == 128)
    return launch_chunk_d<PageT, 128>(qq, oo, pool, st, cl, B, T, Hq, Hkv,
                                      prefix_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// q/out are bf16; tables, cache_len, start and chunk_len are int32.

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* cache_len, void* out, int B, int Hq,
    int Hkv, int D, int bs, int nblk, long long page_stride,
    long long tok_stride, float scale, void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, nullptr, nullptr, tables, nblk,
                              bs, page_stride, tok_stride, 0, 0);
  return launch_decode<__nv_bfloat16>(q, out, pool, cache_len, B, Hq, Hkv, D,
                                      scale, stream);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* cache_len, void* out, int B, int Hq, int Hkv, int D, int bs,
    int nblk, long long page_stride, long long tok_stride,
    long long spage_stride, long long stok_stride, float scale,
    void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, k_scales, v_scales, tables,
                              nblk, bs, page_stride, tok_stride, spage_stride,
                              stok_stride);
  return launch_decode<int8_t>(q, out, pool, cache_len, B, Hq, Hkv, D, scale,
                               stream);
}

extern "C" int paged_chunk_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* start, const void* chunk_len, void* out,
    int B, int T, int Hq, int Hkv, int D, int bs, int nblk,
    long long page_stride, long long tok_stride, int prefix_len, float scale,
    void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, nullptr, nullptr, tables, nblk,
                              bs, page_stride, tok_stride, 0, 0);
  return launch_chunk<__nv_bfloat16>(q, out, pool, start, chunk_len, B, T, Hq,
                                     Hkv, D, prefix_len, scale, stream);
}

extern "C" int paged_chunk_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* start, const void* chunk_len, void* out, int B, int T,
    int Hq, int Hkv, int D, int bs, int nblk, long long page_stride,
    long long tok_stride, long long spage_stride, long long stok_stride,
    int prefix_len, float scale, void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, k_scales, v_scales, tables,
                              nblk, bs, page_stride, tok_stride, spage_stride,
                              stok_stride);
  return launch_chunk<int8_t>(q, out, pool, start, chunk_len, B, T, Hq, Hkv, D,
                              prefix_len, scale, stream);
}
