// Chunked-prefill attention over a dense cache, written by hand for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (kernels/chunk_attention.py).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/decode_attention.py:
//   chunk_prefill_attention_pallas  :208  (pallas_call :246, body
//   _chunk_kernel :183, tile _chunk_tile :153)
// q (B, T, Hq, D) attends to a dense (B, S, Hkv, D) cache that already
// holds the chunk's own K/V at [start, start + chunk_len).  Row i of slot b
// sits at position start[b] + i and is alive iff i < chunk_len[b]; it sees
// a key at kpos iff (kpos <= start + i or kpos < prefix_len) and
// kpos < start + chunk_len.  Dead rows are zeros.  GQA: query head h reads
// kv head h / (Hq / Hkv).  The math of the paged chunk kernel
// (csrc/paged_attention.cu, paged_chunk_kernel), on a dense cache.
//
// What bounds it on this card: bytes.  Each visible (row, key) pair costs
// 4*D flops per query head; at the serving path's shape (one slot, a
// 128-row bucket, 36 heads, D = 64, S = 256) that is 0.15 GFLOP against
// 3.5 MB of q, K, V and output: ~40 flops a byte, under the ~295 a byte
// where the H100's tensor cores, not its 3.35 TB/s, set the limit.  So the
// design moves each needed byte once and spends nothing on flops:
//   * the cache is read in place with the caller's batch, sequence and
//     head strides (a layer slice of the stacked (layers, B, S, Hkv, D)
//     view is such a cache); the Pallas wrapper pads S and transposes the
//     whole cache to (B*Hkv, S_p, D) on every call;
//   * no key at or past start + chunk_len is read: the key loop stops at
//     the tile's last visible key, and the last 32-key tile loads only the
//     rows below it (zeros above), as the Pallas kernel's @pl.when skips
//     blocks past the end;
//   * no row at or past chunk_len is computed: a 16-row tile whose rows
//     are all dead writes zeros and returns before it reads anything, and
//     a ragged tile scores only its live rows;
//   * S need not be a multiple of the key tile, and T of the row tile.
// One block per (slot, query head, 16-row tile), 4 warps: 16-byte loads of
// K and V into shared memory, one warp per row and one lane per key for the
// scores and the f32 online softmax, each thread accumulating its own
// (row, dim) pairs of P @ V in registers.  Rows finalize with
// acc / max(l, 1e-37).  A simple kernel: no mma, no cp.async, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                 // keys per staged tile: one per lane
constexpr int kRows = 16;                 // query rows one block serves
constexpr int kVec = 8;                   // bf16 values per 16-byte load
constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // -0.7 * FLT_MAX

// The cache, read in place.  Strides are in elements; the head dim is dense.
struct Cache {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long kb, ks, kh;                   // k: batch, sequence, head strides
  long long vb, vs, vh;
  int S;
};

template <int D>
struct Smem {
  float q[kRows][D];
  float k[kKeys][D + 1];                  // +1: lane j reads row j, no conflicts
  float v[kKeys][D];
  float p[kRows][kKeys];
  float m[kRows], l[kRows], alpha[kRows];
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

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) dst[e] = __bfloat162float(h[e]);
}

// Block (slot b, query head h, tile z of 16 rows).
template <int D>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const __nv_bfloat16* __restrict__ q,
             __nv_bfloat16* __restrict__ out, Cache c,
             const int* __restrict__ start, const int* __restrict__ chunk_len,
             int T, int Hq, int Hkv, int prefix_len, float scale) {
  constexpr int kParts = D / kVec;                 // 16-byte loads per row
  constexpr int kOwn = kRows * D / kThreads;       // (row, dim) pairs a thread
  __shared__ Smem<D> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * kRows;
  const int kvh = h / (Hq / Hkv);
  const int st = start[b], cl = chunk_len[b];
  const int nrows = min(kRows, T - i0);
  const int alive = max(0, min(nrows, cl - i0));  // rows i0 .. i0+alive-1
  const long long row_stride = static_cast<long long>(Hq) * D;
  const long long row0 = (static_cast<long long>(b) * T + i0) * Hq + h;
  __nv_bfloat16* ob = out + row0 * D;
  if (alive == 0) {                        // every row of the tile is dead
    for (int e = tid; e < nrows * D; e += kThreads)
      ob[(e / D) * row_stride + e % D] = __float2bfloat16(0.f);
    return;
  }
  // keys a live row of this tile can see: below its position + 1 or the
  // prefix, and always below start + chunk_len (and the cache's end)
  const int end = min(st + cl, c.S);
  const int kend = max(0, min(end, max(st + i0 + alive, prefix_len)));
  const __nv_bfloat16* qb = q + row0 * D;
  for (int e = tid; e < alive * D; e += kThreads)
    sm.q[e / D][e % D] = __bfloat162float(qb[(e / D) * row_stride + e % D]);
  if (tid < kRows) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
    sm.alpha[tid] = 1.f;
  }
  float acc[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = 0.f;
  const __nv_bfloat16* kbase = c.k + b * c.kb + kvh * c.kh;
  const __nv_bfloat16* vbase = c.v + b * c.vb + kvh * c.vh;
  __syncthreads();

  for (int t0 = 0; t0 < kend; t0 += kKeys) {
    // 1. stage keys t0 .. t0+31 in f32; rows at or past kend are zeros and
    //    never read from the cache
    for (int e = tid; e < kKeys * kParts; e += kThreads) {
      const int j = e / kParts, col = (e % kParts) * kVec;
      const int kpos = t0 + j;
      float kv[kVec], vv[kVec];
      if (kpos < kend) {
        load8(kbase + kpos * c.ks + col, kv);
        load8(vbase + kpos * c.vs + col, vv);
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

    // 2. scores and the online-softmax update of the live rows: one warp
    //    per row, one lane per key (the Pallas tile's order: mask, max,
    //    rescale, sum)
    for (int r = warp; r < alive; r += kWarps) {
      const float m_prev = sm.m[r];
      const int kpos = t0 + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += sm.q[r][d] * sm.k[lane][d];
      s *= scale;
      const bool ok = kpos < kend &&
                      (kpos <= st + i0 + r || kpos < prefix_len);
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

    // 3. acc = acc * alpha + p @ V over the live rows
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int e = tid + i * kThreads, r = e / D, d = e % D;
      if (r < alive) {
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
    const int e = tid + i * kThreads, r = e / D, d = e % D;
    if (r < nrows) {
      const float o = r < alive ? acc[i] / fmaxf(sm.l[r], 1e-37f) : 0.f;
      ob[r * row_stride + d] = __float2bfloat16(o);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = ok).  q/out are bf16
// (B, T, Hq, D) contiguous; start and chunk_len are int32 (B,).
extern "C" int chunk_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* start, const void* chunk_len, void* out, int B, int T,
    int Hq, int Hkv, int D, int S, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, int prefix_len, float scale,
    void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq % Hkv || prefix_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cache c;
  c.k = static_cast<const __nv_bfloat16*>(k_cache);
  c.v = static_cast<const __nv_bfloat16*>(v_cache);
  c.kb = kb;
  c.ks = ks;
  c.kh = kh;
  c.vb = vb;
  c.vs = vs;
  c.vh = vh;
  c.S = S;
  const dim3 grid(B, Hq, (T + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const auto* st = static_cast<const int*>(start);
  const auto* cl = static_cast<const int*>(chunk_len);
  if (D == 64)
    chunk_kernel<64><<<grid, kThreads, 0, s>>>(qq, oo, c, st, cl, T, Hq, Hkv, prefix_len, scale);
  else if (D == 128)
    chunk_kernel<128><<<grid, kThreads, 0, s>>>(qq, oo, c, st, cl, T, Hq, Hkv, prefix_len, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
