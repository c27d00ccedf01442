// Flash attention, forward, written by hand for Hopper (sm_90a), with a
// plain C interface bound by ctypes (kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/flash_attention.py:
//   flash_attention_pallas  :108  (pallas_call :143, body _flash_kernel :36)
// It computes the forward pass and always writes the per-row log-sum-exp
// (f32, (B, Lq, Hq)) that a recomputing backward reads.
//
// Masks, element by element exactly as in _flash_kernel: a key at kpos is
// visible to the query row at qpos = q_offset + i iff kpos < kv_len and,
// when causal, kpos <= qpos (and kpos > qpos - window when window >= 0) or
// kpos < prefix_len.  GQA: query head h reads kv head h / (Hq / Hkv).
// A row that sees no key writes out = 0 and lse = -NEG_INF.  Whole key
// tiles that no row of the block can see are skipped.  (The Pallas block
// test at :58 also skips a key block past the q tile's last row when
// prefix_len reaches into it, and so drops prefix keys that its own oracle
// ref.mha_exact sees; this kernel follows the element mask.)
//
// What bounds it on this card: operations, at the serving path's encoder
// shape (1500 x 1500 keys, 20 heads, D = 64: 11.5 GFLOP against 15.5 MB),
// and bytes at its cross-attention chunk shape (at most 128 rows against
// 1500 keys).  This first kernel spends its operations on the CUDA cores in
// f32, not on the tensor cores: far from the bf16 bound, but simple.
// What the design does:
//   * q, k and v are read in place in their (B, L, H, D) layout with the
//     caller's batch, sequence and head strides; the Pallas wrapper's pad
//     and (B, L, H, D) -> (B*H, L, D) transpose copies do not exist here;
//   * one block per (batch * query head, tile of 64 query rows; 32 at
//     D = 256), 128 threads; the q tile and each 64-key K/V tile are
//     staged in shared memory as f32 (rows padded by one word, so the
//     reads below hit 32 distinct banks);
//   * thread (ty, tx) of a 16 x 8 grid owns 4 (2 at D = 256) query rows and
//     the keys tx, tx + 8, ... of a tile for the scores, and the same rows
//     and the dims tx, tx + 8, ... of the output: 32 multiply-adds per 12
//     shared-memory reads in both products;
//   * the online softmax keeps (m, l) per row in registers, reduced across
//     the row's 8 threads with warp shuffles, in the order of the Pallas
//     tile (mask, max, rescale, sum), all in f32; rows finalize with
//     acc / max(l, 1e-37).
// No TMA, no wgmma, no mma.sync: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTx = 8;                         // threads across keys / dims
constexpr int kTy = kThreads / kTx;            // row groups
constexpr int kBlockN = 64;                    // keys per staged tile
constexpr int kKeysPer = kBlockN / kTx;        // keys per thread per tile
constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // -0.7 * FLT_MAX

template <int D>
struct Cfg {
  static constexpr int kRows = D <= 128 ? 4 : 2;         // rows per thread
  static constexpr int kBlockM = kTy * kRows;             // rows per block
  static constexpr int kDims = D / kTx;                   // out dims per thread
  static constexpr int kQStride = D + 1;
  static constexpr int kKStride = D + 1;
  static constexpr int kVStride = D;
  static constexpr int kPStride = kBlockN + 1;
  static constexpr int kSmemBytes =
      (kBlockM * kQStride + kBlockN * kKStride + kBlockN * kVStride +
       kBlockM * kPStride) * static_cast<int>(sizeof(float));
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;                          // (B, Lq, Hq, D) contiguous
  float* lse;                                  // (B, Lq, Hq) contiguous
  long long q_sb, q_sl, q_sh;                  // strides, in elements
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int B, Lq, Lk, Hq, Hkv;
  int causal, window, prefix_len, q_offset, kv_len;   // window < 0: none
  float scale;
};

// Stage rows [row0, row0 + rows) of a (L, D) bf16 slab with row stride
// ``ld`` into shared memory as f32 with row stride ``stride``; rows at or
// past ``nvalid`` are zeros and are not read.
template <int D>
__device__ void stage(float* dst, int stride, const __nv_bfloat16* src,
                      long long ld, int row0, int rows, int nvalid) {
  constexpr int kParts = D / 8;                // 16-byte loads per row
  for (int c = threadIdx.x; c < rows * kParts; c += kThreads) {
    const int r = c / kParts, col = (c % kParts) * 8;
    float* d = dst + r * stride + col;
    if (row0 + r < nvalid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * ld + col);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = __bfloat162float(h[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int RM = C::kRows, BM = C::kBlockM, ND = C::kDims;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BM * C::kQStride;
  float* sv = sk + kBlockN * C::kKStride;
  float* sp = sv + kBlockN * C::kVStride;

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  // keys any row of this block can see lie in [k_begin, k_end)
  const int rows_here = min(BM, p.Lq - m0);
  const int q_lo = p.q_offset + m0, q_hi = q_lo + rows_here - 1;
  const int kv_lim = min(p.Lk, p.kv_len);
  int k_end = kv_lim;
  int k_begin = 0;
  if (p.causal) {
    k_end = min(k_end, max(q_hi + 1, p.prefix_len));
    if (p.window >= 0 && p.prefix_len <= 0) k_begin = max(0, q_lo - p.window + 1);
  }

  stage<D>(sq, C::kQStride, qb, p.q_sl, m0, BM, p.Lq);

  float m_i[RM], l_i[RM], acc[RM][ND];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = (k_begin / kBlockN) * kBlockN; t0 < k_end; t0 += kBlockN) {
    // a tile wholly before every row's window (and past the prefix) is
    // skipped; the test is uniform over the block
    if (p.causal && p.window >= 0 && t0 + kBlockN - 1 <= q_lo - p.window &&
        t0 >= p.prefix_len)
      continue;
    __syncthreads();                           // the last tile's readers are done
    stage<D>(sk, C::kKStride, kb, p.k_sl, t0, kBlockN, k_end);
    stage<D>(sv, C::kVStride, vb, p.v_sl, t0, kBlockN, k_end);
    __syncthreads();

    // 1. scores of this thread's RM rows x kKeysPer keys
    float s[RM][kKeysPer];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[kKeysPer];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = sq[(ty * RM + i) * C::kQStride + d];
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) kv[c] = sk[(tx + kTx * c) * C::kKStride + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < kKeysPer; ++c) s[i][c] += qv[i] * kv[c];
    }

    // 2. mask and the online-softmax update; a row's 8 threads are 8
    //    neighbouring lanes of one warp
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty * RM + i;
      const int qpos = q_lo + row;
      bool ok[kKeysPer];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const int kpos = t0 + tx + kTx * c;
        ok[c] = kpos < kv_lim &&
                (!p.causal || kpos < p.prefix_len ||
                 (kpos <= qpos && (p.window < 0 || kpos > qpos - p.window)));
        s[i][c] = ok[c] ? s[i][c] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 1; o < kTx; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const float pv = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sp[row * C::kPStride + tx + kTx * c] = pv;
        psum += pv;
      }
#pragma unroll
      for (int o = 1; o < kTx; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_i[i] = l_i[i] * alpha + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

    // 3. acc += P @ V over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float pj[RM], vj[ND];
#pragma unroll
      for (int i = 0; i < RM; ++i) pj[i] = sp[(ty * RM + i) * C::kPStride + j];
#pragma unroll
      for (int e = 0; e < ND; ++e) vj[e] = sv[j * C::kVStride + tx + kTx * e];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[i][e] += pj[i] * vj[e];
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty * RM + i;
    if (row >= p.Lq) continue;
    const long long o = (static_cast<long long>(b) * p.Lq + row) * p.Hq + h;
    const float l = fmaxf(l_i[i], 1e-37f);
#pragma unroll
    for (int e = 0; e < ND; ++e)
      p.out[o * D + tx + kTx * e] = __float2bfloat16(acc[i][e] / l);
    if (tx == 0)
      p.lse[o] = l_i[i] > 0.f ? m_i[i] + logf(l) : -kNegInf;
  }
}

template <int D>
int launch(const Params& p, cudaStream_t s) {
  using C = Cfg<D>;
  if ((p.Lq + C::kBlockM - 1) / C::kBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // more than 48 KB of dynamic shared memory needs an opt-in, once per
  // device (done before any CUDA-graph capture: the wrapper's first call)
  static unsigned long long opted_in = 0;    // bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(opted_in >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in |= 1ULL << dev;
  }
  const dim3 grid(p.B * p.Hq, (p.Lq + C::kBlockM - 1) / C::kBlockM);
  flash_fwd_kernel<D><<<grid, kThreads, C::kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = ok).  q, k, v and out
// are bf16, lse f32; strides are in elements; window < 0 means none.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int Lq, int Lk, int Hq, int Hkv, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    int causal, int window, int prefix_len, int q_offset, int kv_len,
    float scale, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv ||
      static_cast<long long>(B) * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.Hq = Hq; p.Hkv = Hkv;
  p.causal = causal; p.window = window; p.prefix_len = prefix_len;
  p.q_offset = q_offset; p.kv_len = kv_len;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
