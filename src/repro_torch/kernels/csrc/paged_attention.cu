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
//
// What bounds it on this card: bytes.  Decode does 4*D flops per (query
// head, key) against 2*D bytes of bf16 K/V per (kv head, key): with a
// query group of G heads that is G flops per byte, far below the ~295 the
// H100 needs before its tensor cores, not its 3.35 TB/s of HBM, are the
// limit.  Chunked prefill at the serving path's shapes (one slot, at most
// 128 rows) is small and bytes-bound too.  So the design spends nothing on
// flops and everything on moving each live K/V byte once:
//   * the pool is read in place, (P, bs, Hkv, D) with the caller's strides,
//     through the slot's own block-table row; it is never transposed or
//     copied (the Pallas wrappers transpose the whole pool on every call);
//   * keys at or past the slot's visible range are never read: the loop
//     stops at ceil(len / 32) tiles, and the last tile loads only rows
//     below the length (zeros above), matching the Pallas @pl.when gates;
//   * decode runs one block per (slot, kv head) and serves all G query
//     heads of that group from one staged tile, so a GQA group reads its
//     K/V once, not G times (the Pallas grid (B*Hq, nk) streams it again
//     for every query head);
//   * int8 pages are dequantized in registers while the tile is staged
//     (float(v) * scale), so the pool never exists in float;
//   * the single decode query is kept as one row per head: the TPU's
//     8-sublane broadcast of it (_SUB) has no counterpart here.
// The online softmax and the accumulator are f32; rows finalize with
// acc / max(l, 1e-37), so a row that sees no key yields zeros, not NaN.
// A simple kernel: 16-byte loads into shared memory, plain FMA, no TMA, no
// wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                 // keys per staged tile: one per lane
constexpr int kMaxRows = 16;              // query rows one block serves
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

// Chunked prefill: block (slot b, query head h, tile z of 16 rows); row i
// sits at absolute position start[b] + i and is alive iff i < chunk_len[b].
template <typename PageT, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   __nv_bfloat16* __restrict__ out, Pool pool,
                   const int* __restrict__ start,
                   const int* __restrict__ chunk_len, int T, int Hq, int Hkv,
                   int prefix_len, float scale) {
  __shared__ Smem<D> sm;
  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * kMaxRows;
  const int kvh = h / (Hq / Hkv);
  const int st = start[b], cl = chunk_len[b];
  const int nrows = min(kMaxRows, T - i0);
  // keys any alive row of this tile can see: below the row's position + 1
  // or the prefix, and always below start + chunk_len
  const int end = min(st + cl, pool.nblk * pool.bs);
  const int last = min(i0 + nrows, cl);   // one past the last alive row
  const int kend = last > i0 ? max(0, min(end, max(st + last, prefix_len))) : 0;
  const long long row0 = (static_cast<long long>(b) * T + i0) * Hq + h;
  const long long row_stride = static_cast<long long>(Hq) * D;
  const __nv_bfloat16* qb = q + row0 * D;
  for (int c = threadIdx.x; c < nrows * D; c += kThreads)
    sm.q[c / D][c % D] = __bfloat162float(qb[(c / D) * row_stride + c % D]);
  if (threadIdx.x < kMaxRows) {
    sm.qpos[threadIdx.x] = st + i0 + threadIdx.x;
    sm.alive[threadIdx.x] = (i0 + static_cast<int>(threadIdx.x)) < cl;
  }
  __syncthreads();
  attend<PageT, D>(sm, pool, b, kvh, kend, nrows, prefix_len, scale,
                   out + row0 * D, row_stride);
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

template <typename PageT>
int launch_chunk(const void* q, void* out, const Pool& pool,
                 const void* start, const void* chunk_len, int B, int T,
                 int Hq, int Hkv, int D, int prefix_len, float scale,
                 void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, Hq, (T + kMaxRows - 1) / kMaxRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const auto* st = static_cast<const int*>(start);
  const auto* cl = static_cast<const int*>(chunk_len);
  if (D == 64)
    paged_chunk_kernel<PageT, 64><<<grid, kThreads, 0, s>>>(qq, oo, pool, st, cl, T, Hq, Hkv, prefix_len, scale);
  else if (D == 128)
    paged_chunk_kernel<PageT, 128><<<grid, kThreads, 0, s>>>(qq, oo, pool, st, cl, T, Hq, Hkv, prefix_len, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
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
