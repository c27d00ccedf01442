// Dense single-token decode attention, written by hand for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (kernels/decode_attention.py).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/decode_attention.py:
//   decode_attention_pallas  :92  (pallas_call :122, body _decode_kernel :45)
// q (B, Hq, D) attends to a dense (B, S, Hkv, D) cache: slot b sees keys
// kpos with max(0, len - window) <= kpos < min(len, S), len = cache_len[b]
// (no lower bound without a window).  GQA: query head h reads kv head
// h / (Hq / Hkv).  A slot that sees no key writes zeros and reads nothing
// of its cache.
//
// What bounds it on this card: bytes.  Each visible key costs 4*D flops per
// query head against 4*D bytes of bf16 K and V per kv head: G flops a byte
// for a query group of G heads, far below the ~295 a byte where the H100's
// tensor cores, not its 3.35 TB/s of HBM, become the limit.  At the serving
// path's shape (whisper's cross-attention: 128 slots, 20 heads, G = 1,
// S = 1500, D = 64) a live slot streams 7.68 MB a layer.  So the design
// moves each live K/V byte once and nothing else:
//   * the cache is read in place with the caller's strides (the Pallas
//     wrapper pads and transposes the whole cache on every call, and
//     broadcasts each query over 8 sublanes);
//   * one block per (slot, kv head) serves all G query heads of the group,
//     so a GQA group reads its K/V once, not G times;
//   * a dead slot (length 0) returns before it reads anything: the decoder
//     passes length 0 for slots without a request;
//   * the block's 4 warps split the slot's keys into interleaved 32-key
//     tiles, each warp with its own f32 online softmax; lane j scores key
//     j of its tile from the K row it loads with 16-byte reads, and every
//     lane accumulates its D/32 output dims from coalesced V rows, the
//     probabilities passed by warp shuffles; the four partial results are
//     merged through shared memory at the end (the usual split-K merge,
//     inside one block);
//   * D = 112 (zamba2-7b's shared attention): a K row is two batches of
//     seven 16-byte loads, and 28 lanes own 4 output dims each (8-byte V
//     reads); the other 4 lanes score keys, repeat the 28th lane's V reads
//     (the same addresses: no bytes) and write nothing out.
// No shared-memory staging of K or V, no cp.async, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                      // keys per warp tile: one a lane
constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // -0.7 * FLT_MAX

// query heads one block serves: the group G, rounded up to a power of two
// (the kernel is instantiated for each, so G = 1 carries one row)
template <int D>
constexpr int max_rows() { return D <= 128 ? 16 : 8; }

template <int N>
struct Vec;                                    // N bf16 values in one load
template <> struct Vec<2> { using T = uint32_t; };
template <> struct Vec<4> { using T = uint2; };
template <> struct Vec<8> { using T = uint4; };

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

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ cache_len,
              __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int S,
              long long k_sb, long long k_sl, long long k_sh,
              long long v_sb, long long v_sl, long long v_sh, int window,
              float scale) {
  // output dims a lane owns, and the lanes that own some: all 32, or at
  // D = 112 (zamba2-7b) the first 28, 4 dims each
  constexpr int ND = (D + 31) / 32;
  constexpr int kVLanes = D / ND;
  // K row columns a lane's batch of 16-byte loads covers: 64, or half the
  // row at D = 112 (7 loads of 8 columns)
  constexpr int kStep = D % 64 == 0 ? 64 : D / 2;
  constexpr int kP = kStep / 8;
  static_assert(D % kStep == 0 && kStep % 8 == 0 && kVLanes * ND == D,
                "head dim");
  __shared__ float sq[R][D];
  __shared__ float sm[kWarps][R], sl[kWarps][R];
  __shared__ float sacc[kWarps][R][D];

  const int b = blockIdx.x, kvh = blockIdx.y, G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = static_cast<long long>(b) * Hq + static_cast<long long>(kvh) * G;
  const int len = cache_len[b];
  const int hi = min(len, S);
  const int lo = window >= 0 ? max(0, len - window) : 0;
  if (hi <= lo) {                              // sees no key: zeros
    for (int c = tid; c < G * D; c += kThreads)
      out[row0 * D + c] = __float2bfloat16(0.f);
    return;
  }
  // rows G .. R-1 (R is G rounded up to a power of two) are zeros: they
  // score every key 0 and are never written out
  for (int c = tid; c < R * D; c += kThreads)
    sq[c / D][c % D] = c < G * D ? __bfloat162float(q[row0 * D + c]) : 0.f;
  __syncthreads();

  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  // lanes past the row (D = 112) read the last lane's dims again, which
  // costs no bytes, and never write them out
  int vlane = lane;
  if constexpr (kVLanes < 32) vlane = min(lane, kVLanes - 1);
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh + vlane * ND;
  float m[R], l[R], acc[R][ND];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = lo + warp * kKeys; t0 < hi; t0 += kWarps * kKeys) {
    // 1. lane j scores key t0 + j against every query head of the group
    const int kpos = t0 + lane;
    const bool ok = kpos < hi;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    if (ok) {
      const __nv_bfloat16* kr = kb + kpos * k_sl;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += kStep) {
        uint4 raw[kP];
#pragma unroll
        for (int part = 0; part < kP; ++part)
          raw[part] = *reinterpret_cast<const uint4*>(kr + c0 + part * 8);
#pragma unroll
        for (int part = 0; part < kP; ++part) {
          const __nv_bfloat16* hk = reinterpret_cast<const __nv_bfloat16*>(&raw[part]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float kf = __bfloat162float(hk[e]);
#pragma unroll
            for (int r = 0; r < R; ++r) s[r] += sq[r][c0 + part * 8 + e] * kf;
          }
        }
      }
    }
    // 2. the online-softmax update, one row at a time (the order of the
    //    Pallas tile: mask, max, rescale, sum)
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= G) break;
      const float sc = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      p[r] = ok ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[r][e] *= alpha;
    }
    // 3. acc += p @ V: every lane reads its ND dims of each key's V row
    const int nk = min(kKeys, hi - t0);
#pragma unroll 8
    for (int j = 0; j < nk; ++j) {
      const typename Vec<ND>::T raw =
          *reinterpret_cast<const typename Vec<ND>::T*>(vb + (t0 + j) * v_sl);
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= G) break;
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < ND; ++e) acc[r][e] += pj * __bfloat162float(hv[e]);
      }
    }
  }

  // 4. merge the four warps' partial softmax states
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= G) break;
    if (lane == 0) {
      sm[warp][r] = m[r];
      sl[warp][r] = l[r];
    }
    if constexpr (kVLanes == 32) {
#pragma unroll
      for (int e = 0; e < ND; ++e) sacc[warp][r][lane * ND + e] = acc[r][e];
    } else if (lane < kVLanes) {
#pragma unroll
      for (int e = 0; e < ND; ++e) sacc[warp][r][lane * ND + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int c = tid; c < G * D; c += kThreads) {
    const int r = c / D, d = c % D;
    float mx = sm[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm[w][r] - mx);
      lsum += sl[w][r] * f;
      a += sacc[w][r][d] * f;
    }
    out[row0 * D + c] = __float2bfloat16(a / fmaxf(lsum, 1e-37f));
  }
}

template <int D, int R>
int launch_rows(const void* q, const void* k, const void* v, const void* lens,
                void* out, int B, int Hq, int Hkv, int S, long long k_sb,
                long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                long long v_sh, int window, float scale, cudaStream_t s) {
  decode_kernel<D, R><<<dim3(B, Hkv), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, S, k_sb, k_sl, k_sh, v_sb,
      v_sl, v_sh, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, int B, int Hq, int Hkv, int S, long long k_sb,
           long long k_sl, long long k_sh, long long v_sb, long long v_sl,
           long long v_sh, int window, float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
#define ROWS(R)                                                              \
  if (G <= R)                                                                \
    return launch_rows<D, R>(q, k, v, lens, out, B, Hq, Hkv, S, k_sb, k_sl,  \
                             k_sh, v_sb, v_sl, v_sh, window, scale, s);
  ROWS(1) ROWS(2) ROWS(4) ROWS(8)
  if constexpr (max_rows<D>() >= 16) { ROWS(16) }
#undef ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = ok).  q and out are
// bf16 (B, Hq, D) contiguous, the caches bf16 with strides in elements,
// cache_len int32 (B,); window < 0 means none.
extern "C" int decode_attention_dense(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, int B, int Hq, int Hkv, int S, int D, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, int window, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, cache_len, out, B, Hq, Hkv, S, k_sb, k_sl,
                        k_sh, v_sb, v_sl, v_sh, window, scale, s);
    case 128:
      return launch<128>(q, k, v, cache_len, out, B, Hq, Hkv, S, k_sb, k_sl,
                         k_sh, v_sb, v_sl, v_sh, window, scale, s);
    case 256:
      return launch<256>(q, k, v, cache_len, out, B, Hq, Hkv, S, k_sb, k_sl,
                         k_sh, v_sb, v_sl, v_sh, window, scale, s);
    case 112:
      return launch<112>(q, k, v, cache_len, out, B, Hq, Hkv, S, k_sb, k_sl,
                         k_sh, v_sb, v_sl, v_sh, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
