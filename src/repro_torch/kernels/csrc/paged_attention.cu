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
// (flash_attention.cu): the body of chunk_tiles.cuh, which the dense chunk
// kernel (chunk_attention.cu) shares, here with keys gathered row by row
// through the slot's block-table row (a 64-key tile may span pages and end
// inside one):
//   * one block per (slot, query head, 64 query rows), 4 warps of 16 rows
//     (phase 3's chunk: 72 blocks for 132 SMs; 32-row blocks of 2 warps,
//     144 blocks, were the slower in a side-by-side build on the H100);
//   * q held as ldmatrix fragments, keys through a two-stage 16-byte
//     cp.async ring, S = Q K^T and O += P V on mma.sync.m16n8k16, the
//     online softmax on the fragments, the element mask only on a tile
//     that crosses an edge;
//   * int8 pages: the raw rows and scales are staged and widened to bf16
//     in shared memory, exactly; k_scale multiplies S's columns and
//     v_scale folds into P after the row sums, so the products are the
//     plain version's dequantize products with only P's rounding to bf16
//     added; the pool never exists in float;
//   * GQA: a block serves one query head and reads its kv head's tiles (a
//     group's heads read them through L2).
// Not done yet: wgmma, TMA, packing a GQA group's heads into one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "chunk_tiles.cuh"

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
// Chunked prefill on the tensor cores: the body of chunk_tiles.cuh, with
// keys gathered through the slot's block-table row
// ---------------------------------------------------------------------------

// The pages of one (slot, kv head): key kpos lies at offset kpos % bs of
// page table[kpos / bs], read through the kernel's ``Pool`` argument.
template <typename PageT, int D>
struct PagedKeys {
  typedef PageT T;
  const Pool& pool;
  int b, kvh;

  __device__ __forceinline__ long long page(int kpos) const {
    return pool.tables[static_cast<long long>(b) * pool.nblk + kpos / pool.bs];
  }
  __device__ __forceinline__ void rows(int kpos, const PageT** kr,
                                       const PageT** vr) const {
    const long long e = page(kpos) * pool.page_stride +
                        (kpos % pool.bs) * pool.tok_stride + kvh * D;
    *kr = static_cast<const PageT*>(pool.k) + e;
    *vr = static_cast<const PageT*>(pool.v) + e;
  }
  __device__ __forceinline__ void scales(int kpos, const float** kr,
                                         const float** vr) const {
    const long long e = page(kpos) * pool.spage_stride +
                        (kpos % pool.bs) * pool.stok_stride + kvh;
    *kr = pool.ks + e;
    *vr = pool.vs + e;
  }
  __device__ __forceinline__ const PageT* any() const {
    return static_cast<const PageT*>(pool.k);
  }
  __device__ __forceinline__ const float* any_scale() const { return pool.ks; }
};

template <typename PageT, int D>
__global__ void __launch_bounds__(kChunkThreads)
paged_chunk_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                   Pool pool, const int* __restrict__ start,
                   const int* __restrict__ chunk_len, int T, int Hq, int Hkv,
                   int prefix_len, float scale) {
  const int b = blockIdx.x;
  const PagedKeys<PageT, D> src{pool, b, static_cast<int>(blockIdx.y) / (Hq / Hkv)};
  chunk_tile<D>(q, out, src, start[b], chunk_len[b], pool.nblk * pool.bs, T,
                Hq, prefix_len, scale);
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
  static unsigned long long opted = 0;       // bit per device ordinal
  return launch_chunk_grid<PageT, D>(paged_chunk_kernel<PageT, D>, &opted, B,
                                     T, Hq, s, q, out, pool, st, cl, T, Hq,
                                     Hkv, prefix_len, scale);
}

template <typename PageT>
int launch_chunk(const void* q, void* out, const Pool& pool,
                 const void* start, const void* chunk_len, int B, int T,
                 int Hq, int Hkv, int D, int prefix_len, float scale,
                 void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv)
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
