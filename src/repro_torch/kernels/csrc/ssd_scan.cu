// Mamba-2 SSD chunked scan, written by hand for Hopper (sm_90a), with a
// plain C interface bound by ctypes (kernels/ssd_scan.py).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/ssd_scan.py:
//   ssd_scan_pallas  :85  (pallas_call :117, :122, body _ssd_kernel :33)
// It computes what _ssd_kernel computes.  The sequence of one (batch, head)
// is cut into chunks of Q tokens, Q = min(chunk, max(8, L)) as in the
// Pallas wrapper, and within a chunk, with cum the inclusive cumsum of
// dt * A:
//   M[t,s] = exp(cum_t - cum_s) * (C_t . B_s) * dt_s        for s <= t
//   y      = M x + exp(cum) * (C h^T) + D * x
//   h     <- exp(cum_last) * h + sum_s exp(cum_last - cum_s) dt_s x_s B_s^T
// Tokens past L are identity steps (dt = 0), so the last chunk simply stops
// at L.  The D skip term, which the Pallas wrapper adds outside the call,
// is fused into the epilogue here.
//
// What bounds it on this card: bytes, at the serving path's shape (one
// chunk call is Bb = 1, L = T <= 128, H = 80, P = 64, G = 1, N = 128: about
// 8 MB moved against 0.84 GFLOP, 2.4 us against 0.85 us at the tensor-core
// peak).  The first kernel did all four products in f32 on the CUDA cores
// (67 TFLOP/s, not 989), one block of 8 warps per (batch, head), M in
// 32-row strips through shared memory behind block barriers, and the
// cumsum on one warp: 46x its bound (NVIDIA H100 80GB HBM3, 700 W, by
// chip_smoke.py).  The design:
//   * one block of 8 warps per (batch, head), which owns the head's y and
//     state: 80 blocks for 132 SMs at the path's shape.  Splitting P across
//     blocks (32 columns a block, 160 blocks; 16 columns, 320) fills the
//     card but makes every block recompute the chunk's C B^T (at G = 1 the
//     same for every head and column block; only the decay differs), and
//     both splits, with 4 or 8 warps a block, lost to the unsplit 8-warp
//     block in a side-by-side build on the H100 at the path's shape, at 32
//     tokens and at 2 x 300 tokens; so did the unsplit block with 4 warps;
//   * the four products run on mma.sync.m16n8k16, bf16 in and f32 sums,
//     with the tiles of mma_tiles.cuh; a warp owns 16-row strips of the
//     chunk (strips dealt out in a snake so that the triangle's work is
//     even) and walks its strip's 16-column blocks s <= t:
//       G = C B^T for the block (C's strip held as ldmatrix fragments, B
//       rows from shared memory); the decay exp(cum_t - cum_s) * dt_s and
//       the mask s <= t applied on the accumulator fragments (the mask only
//       on the diagonal block), as the flash forward turns S into P; then
//       y += M x with M's fragments turned into A operands in registers
//       (acc_to_a) and x as the B operand (ldmatrix.trans): M never touches
//       shared memory;
//     y_inter = exp(cum_t) * (C h^T), with h an operand from a
//     copy of the f32 state in shared memory, into the same accumulators
//     before M x;
//   * the state update h' = exp(cum_last) h + (x w)^T B, w_s =
//     exp(cum_last - cum_s) dt_s, keeps h in f32 registers (accumulator
//     fragments) across chunks;
//   * the three operands that are not bf16 inputs (M, h and x w) are split
//     into bf16 hi + lo (lo = bf16(v - hi), good to ~2^-17) and run as two
//     bf16 products into the same f32 sums, so every product keeps f32-grade
//     accuracy: by estimate, one rounding of x w to bf16 would cost ~3e-3
//     of the state at 128 unit-scale tokens (the limit is 1e-3), and one
//     rounding of M or h ~4e-3 and ~1.3e-2 of y at unit-scale x, B, C and
//     h0, where y's limit near zero is 1.6e-2.  C and B are bf16 already,
//     so C B^T is exact;
//   * loads: x, B, C and dt of a chunk go to shared memory by cp.async,
//     the next chunk's through a two-stage ring when L > Q and two stages
//     fit (Q <= 128 at N = 128); with 16-byte copies when every row of x,
//     B and C and the initial state start on 16 bytes (the "vec16"
//     route), else 4-byte copies (the "vec4" route; the wrapper takes rows
//     that are only 4-byte aligned with even strides).  The route is
//     chosen per launch from the pointers and strides (ssd_scan.route
//     mirrors the rule); it is not a fallback.  h0 is read and the final
//     state written once, in 16-byte vectors (two lanes swap halves of
//     their fragments), h0 in 4-byte pieces on the vec4 route;
//   * every output has one owner block and a fixed order of sums: no
//     atomics, and repeated launches give bit-identical y and state.
// What holds it back now: latency, one block's serial chain (copy, cumsum,
// then per strip C h^T and the walk over its column blocks, then the state
// update) on 80 of 132 SMs; at G = 1 every head's block computes the same
// C B^T.  Sharing C B^T across a cluster's blocks (distributed shared
// memory), which would let P be split without recomputing it, is untried.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQMax = 256;                // largest chunk
constexpr int kSmemMax = 232448;          // an H100 block's opt-in limit

struct Args {
  const bf16* x;                          // (Bb, L, H, P), strided
  const float* dt;                        // (Bb, L, H), strided
  const float* A;                         // (H,)
  const bf16* B;                          // (Bb, L, G, N), strided
  const bf16* C;                          // (Bb, L, G, N), strided
  const float* D;                         // (H,) or null
  const float* h0;                        // (Bb, H, P, N) or null
  bf16* y;                                // (Bb, L, H, P), contiguous
  float* hout;                            // (Bb, H, P, N), contiguous
  int L, H, G, Q;
  long long sxb, sxt, sdb, sdt, sBb, sBt, sCb, sCt;   // element strides
};

// Shared memory of one block for chunks of up to qr rows (qr a multiple
// of 16), rows padded by kPad bf16 so that ldmatrix is free of bank
// conflicts: per stage, x's rows xs[qr][P + kPad], B and C
// bs, cs[qr][N + kPad] (bf16) and dt[qr] (f32); then the state as bf16
// hi + lo, hb[2][P][N + kPad], and, per token, cum * log2(e) and the
// state weights w (f32).
template <int P, int N>
__host__ __device__ constexpr int stage_bytes(int qr) {
  return qr * ((P + kPad) + 2 * (N + kPad)) * 2 + qr * 4;
}

template <int P, int N>
__host__ __device__ constexpr int smem_bytes(int qr, int stages) {
  return stages * stage_bytes<P, N>(qr) + 2 * P * (N + kPad) * 2 + 2 * qr * 4;
}

// Copy rows [0, nr) of a chunk's (rows x W) bf16 slab into shared memory
// (row stride W + kPad) with 16- or 4-byte cp.async; rows at or past
// ``nq`` become zeros and are not read.  The caller commits the group.
template <int W, bool kVec16>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long ld, int nq, int nr) {
  constexpr int kE = kVec16 ? 8 : 2;      // bf16 a copy
  constexpr int kParts = W / kE;
  for (int c = threadIdx.x; c < nr * kParts; c += kThreads) {
    const int r = c / kParts, col = (c % kParts) * kE;
    const bool ok = r < nq;
    const bf16* s = ok ? src + r * ld + col : src;
    if constexpr (kVec16)
      cp_async16(dst + r * (W + kPad) + col, s, ok ? 16 : 0);
    else
      cp_async4(dst + r * (W + kPad) + col, s, ok ? 4 : 0);
  }
}

// Two lanes of a quad (t even, t + 1) hold, in one 16 x 8 accumulator
// tile, rows g and g + 8 at columns 2t, 2t + 1 and 2t + 2, 2t + 3: the
// even lane's 16-byte vector is row g at column 2t, the odd lane's row
// g + 8 at column 2t - 2.  These swap halves so that each lane reads or
// writes one 16-byte vector of a row-major f32 matrix with row stride
// ``ld``, at this offset from the tile's first element.
__device__ __forceinline__ int quad_vec(int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return (t & 1) ? (g + 8) * ld + 2 * t - 2 : g * ld + 2 * t;
}

__device__ __forceinline__ void vec_to_frag(float (&v)[4], float4 a,
                                            int lane) {
  const bool odd = lane & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a.x : a.z, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a.y : a.w, 1);
  v[0] = odd ? r0 : a.x;
  v[1] = odd ? r1 : a.y;
  v[2] = odd ? a.z : r0;
  v[3] = odd ? a.w : r1;
}

__device__ __forceinline__ float4 frag_to_vec(const float (&v)[4], int lane) {
  const bool odd = lane & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
  return odd ? make_float4(r0, r1, v[2], v[3])
             : make_float4(v[0], v[1], r0, r1);
}

// (a, b) f32 as bf16 hi + lo, lo = bf16((a, b) - hi): the pair to ~2^-17
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// (v0, v1) bf16 of x, times (w0, w1), as bf16 hi + lo
__device__ __forceinline__ void split_scaled(uint32_t v, float2 w,
                                             uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split2(f.x * w.x, f.y * w.y, hi, lo);
}

// acc_to_a (mma_tiles.cuh) as bf16 hi + lo
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&c0)[4],
                                               const float (&c1)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// the warp that owns 16-row strip i: a snake over the warps, so that the
// triangle's strips (strip i walks i + 1 column blocks) even out
__device__ __forceinline__ int strip_owner(int i) {
  const int r = i % (2 * kWarps);
  return r < kWarps ? r : 2 * kWarps - 1 - r;
}

template <int P, int N, bool kVec16>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Args a, const int qr, const int stages) {
  constexpr int LDX = P + kPad, LDN = N + kPad;
  // the state's (P x N) fragments: kMT row tiles of 16, each split over
  // kWN warps of kSC columns
  constexpr int kMT = P / 16;
  constexpr int kWN = kWarps / kMT < N / 16 ? kWarps / kMT : N / 16;
  constexpr int kSC = N / kWN;
  static_assert(P % 16 == 0 && N % 16 == 0 && kSC % 16 == 0,
                "P and N must tile by 16");

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H, grp = h / (a.H / a.G);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sbytes = stage_bytes<P, N>(qr);
  auto xs_of = [&](int s) {
    return reinterpret_cast<bf16*>(smem_raw + s * sbytes);
  };
  auto bs_of = [&](int s) { return xs_of(s) + qr * LDX; };
  auto cs_of = [&](int s) { return bs_of(s) + qr * LDN; };
  auto dts_of = [&](int s) {
    return reinterpret_cast<float*>(cs_of(s) + qr * LDN);
  };
  bf16* hb = reinterpret_cast<bf16*>(smem_raw + stages * sbytes);  // hi, lo
  float* cl2 = reinterpret_cast<float*>(hb + 2 * P * LDN);    // cum log2(e)
  float* wv = cl2 + qr;                                    // state weights

  const bf16* xb = a.x + b * a.sxb + h * P;
  const bf16* Bb = a.B + b * a.sBb + grp * N;
  const bf16* Cb = a.C + b * a.sCb + grp * N;
  const float* dtb = a.dt + b * a.sdb + h;
  const int nchunk = (a.L + a.Q - 1) / a.Q;
  auto issue = [&](int ci, int s) {
    const int c0 = ci * a.Q, nq = min(a.Q, a.L - c0);
    const int nr = (nq + 15) / 16 * 16;
    stage_rows<P, kVec16>(xs_of(s), xb + c0 * a.sxt, a.sxt, nq, nr);
    stage_rows<N, kVec16>(bs_of(s), Bb + c0 * a.sBt, a.sBt, nq, nr);
    stage_rows<N, kVec16>(cs_of(s), Cb + c0 * a.sCt, a.sCt, nq, nr);
    float* dts = dts_of(s);
    for (int t = threadIdx.x; t < nr; t += kThreads) {
      const bool ok = t < nq;
      cp_async4(dts + t, ok ? dtb + (c0 + t) * a.sdt : dtb, ok ? 4 : 0);
    }
  };
  if (nchunk > 0) issue(0, 0);
  cp_async_commit();

  // the state: this warp's kSC / 8 accumulator tiles of rows
  // 16 mt .. 16 mt + 15 and columns c0s .. c0s + kSC - 1 of the head's
  // (P x N) state, from h0 (or zeros), and its bf16 hi + lo copy
  const bool state_warp = warp < kMT * kWN;
  const int mt = warp % kMT, c0s = (warp / kMT) * kSC;
  const long long hrow0 = (static_cast<long long>(bh) * P + 16 * mt) * N;
  float hs[kSC / 8][4];
#pragma unroll
  for (int j = 0; j < kSC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hs[j][e] = 0.f;
  if (state_warp && a.h0 != nullptr) {
    const float* h0 = a.h0 + hrow0 + c0s;
#pragma unroll
    for (int j = 0; j < kSC / 8; ++j) {
      if constexpr (kVec16) {
        const float4 v = *reinterpret_cast<const float4*>(
            h0 + 8 * j + quad_vec(N, lane));
        vec_to_frag(hs[j], v, lane);
      } else {
        const float* r = h0 + 8 * j + g * N + 2 * tq;
        hs[j][0] = r[0];
        hs[j][1] = r[1];
        hs[j][2] = r[8 * N];
        hs[j][3] = r[8 * N + 1];
      }
    }
  }
  auto write_hb = [&]() {
    if (!state_warp) return;
#pragma unroll
    for (int j = 0; j < kSC / 8; ++j) {
      bf16* r = hb + (16 * mt + g) * LDN + c0s + 8 * j + 2 * tq;
      uint32_t* hi = reinterpret_cast<uint32_t*>(r);
      uint32_t* lo = reinterpret_cast<uint32_t*>(r + P * LDN);
      split2(hs[j][0], hs[j][1], hi[0], lo[0]);
      split2(hs[j][2], hs[j][3], hi[4 * LDN], lo[4 * LDN]);
    }
  };
  write_hb();

  const float A2 = a.A[h] * kLog2e;
  const float Dh = a.D ? a.D[h] : 0.f;
  for (int ci = 0; ci < nchunk; ++ci) {
    const int s = stages == 2 ? ci & 1 : 0;
    const int c0 = ci * a.Q, nq = min(a.Q, a.L - c0);
    const int nstrip = (nq + 15) / 16;
    // the next chunk's copy into the other stage, then wait for this one
    if (stages == 2 && ci + 1 < nchunk) issue(ci + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xs = xs_of(s);
    const bf16* bs = bs_of(s);
    const bf16* cs = cs_of(s);
    const float* dts = dts_of(s);

    // 1. the inclusive cumsum of dt * A (log2 domain) on warp 0, then
    //    the state weights w_t = exp(cum_last - cum_t) * dt_t
    if (warp == 0) {
      constexpr int kPer = kQMax / 32;
      float v[kPer];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int t = lane * kPer + e;
        run += t < nq ? dts[t] * A2 : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int t = lane * kPer + e;
        if (t < 16 * nstrip) cl2[t] = v[e] + incl - run;
      }
      __syncwarp();
      const float last = cl2[nq - 1];
      for (int t = lane; t < 16 * nstrip; t += 32)
        wv[t] = t < nq ? exp2_approx(last - cl2[t]) * dts[t] : 0.f;
    }
    __syncthreads();
    const float last = cl2[nq - 1];

    // 2. y for this warp's strips
    for (int i = 0; i < nstrip; ++i) {
      if (strip_owner(i) != warp) continue;
      const int t_lo = 16 * i + g, t_hi = t_lo + 8;
      uint32_t cf[N / 16][4];
#pragma unroll
      for (int kd = 0; kd < N / 16; ++kd)
        load_a<N>(cf[kd], cs + 16 * i * LDN, kd * 16, lane);
      // y_inter = exp(cum_t) (C h^T), h as bf16 hi + lo
      float acc[P / 8][4];
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      frags_dot_rows<N, P>(acc, cf, hb + P * LDN, lane);
      frags_dot_rows<N, P>(acc, cf, hb, lane);
      const float c_lo = cl2[t_lo], c_hi = cl2[t_hi];
      const float e_lo = exp2_approx(c_lo), e_hi = exp2_approx(c_hi);
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        acc[j][0] *= e_lo;
        acc[j][1] *= e_lo;
        acc[j][2] *= e_hi;
        acc[j][3] *= e_hi;
      }
      // y_intra = M x over the strip's column blocks s <= t
      for (int kk = 0; kk <= i; ++kk) {
        float gt[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gt[j][e] = 0.f;
        frags_dot_rows<N, 16>(gt, cf, bs + 16 * kk * LDN, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s0 = 16 * kk + 8 * j + 2 * tq;
          const float2 cs2 = *reinterpret_cast<const float2*>(cl2 + s0);
          const float2 d2 = *reinterpret_cast<const float2*>(dts + s0);
          gt[j][0] *= exp2_approx(c_lo - cs2.x) * d2.x;
          gt[j][1] *= exp2_approx(c_lo - cs2.y) * d2.y;
          gt[j][2] *= exp2_approx(c_hi - cs2.x) * d2.x;
          gt[j][3] *= exp2_approx(c_hi - cs2.y) * d2.y;
          if (kk == i) {                  // the diagonal block: s <= t
            if (s0 > t_lo) gt[j][0] = 0.f;
            if (s0 + 1 > t_lo) gt[j][1] = 0.f;
            if (s0 > t_hi) gt[j][2] = 0.f;
            if (s0 + 1 > t_hi) gt[j][3] = 0.f;
          }
        }
        uint32_t mhi[4], mlo[4];
        acc_to_a_split(mhi, mlo, gt[0], gt[1]);
#pragma unroll
        for (int dp = 0; dp < P / 16; ++dp) {
          uint32_t bt[4];
          ldmatrix_x4_trans(bt, xs + (16 * kk + (lane & 15)) * LDX + dp * 16 +
                                    (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], mlo, bt[0], bt[1]);
          mma_bf16(acc[2 * dp], mhi, bt[0], bt[1]);
          mma_bf16(acc[2 * dp + 1], mlo, bt[2], bt[3]);
          mma_bf16(acc[2 * dp + 1], mhi, bt[2], bt[3]);
        }
      }
      // + D x, rounded to bf16, for the strip's rows below nq
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        const int col = 8 * j + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = half ? t_hi : t_lo;
          if (t >= nq) continue;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + t * LDX + col));
          const long long row =
              (static_cast<long long>(b) * a.L + c0 + t) * a.H + h;
          *reinterpret_cast<uint32_t*>(a.y + row * P + col) =
              pack_bf16(acc[j][2 * half] + Dh * xv.x,
                        acc[j][2 * half + 1] + Dh * xv.y);
        }
      }
    }

    // 3. the state update: h = exp(cum_last) h + (x w)^T B, with x w as
    //    bf16 hi + lo
    if (state_warp) {
      const float decay = exp2_approx(last);
#pragma unroll
      for (int j = 0; j < kSC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[j][e] *= decay;
      for (int kk = 0; kk < nstrip; ++kk) {
        uint32_t ax[4], hi[4], lo[4];
        ldmatrix_x4_trans(ax, xs + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) *
                                      LDX + 16 * mt + ((lane >> 3) & 1) * 8);
        const float2 w0 = *reinterpret_cast<const float2*>(wv + 16 * kk + 2 * tq);
        const float2 w8 =
            *reinterpret_cast<const float2*>(wv + 16 * kk + 8 + 2 * tq);
        split_scaled(ax[0], w0, hi[0], lo[0]);
        split_scaled(ax[1], w0, hi[1], lo[1]);
        split_scaled(ax[2], w8, hi[2], lo[2]);
        split_scaled(ax[3], w8, hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < kSC / 16; ++dp) {
          uint32_t bt[4];
          ldmatrix_x4_trans(bt, bs + (16 * kk + (lane & 15)) * LDN + c0s +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(hs[2 * dp], lo, bt[0], bt[1]);
          mma_bf16(hs[2 * dp], hi, bt[0], bt[1]);
          mma_bf16(hs[2 * dp + 1], lo, bt[2], bt[3]);
          mma_bf16(hs[2 * dp + 1], hi, bt[2], bt[3]);
        }
      }
    }
    __syncthreads();                      // every reader of hb and the stage
    if (ci + 1 < nchunk) {
      write_hb();
      if (stages == 1) issue(ci + 1, 0);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the final state, once, in 16-byte vectors
  if (state_warp) {
    float* ho = a.hout + hrow0 + c0s;
#pragma unroll
    for (int j = 0; j < kSC / 8; ++j)
      *reinterpret_cast<float4*>(ho + 8 * j + quad_vec(N, lane)) =
          frag_to_vec(hs[j], lane);
  }
}

// ---- host side ----

template <int P, int N, bool kVec16>
int launch(const Args& a, int Bb, cudaStream_t s) {
  static unsigned long long opted = 0;    // bit per device ordinal
  const cudaError_t err =
      opt_in(ssd_scan_kernel<P, N, kVec16>, kSmemMax, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qr = (a.Q + 15) / 16 * 16;
  const int stages =
      a.L > a.Q && smem_bytes<P, N>(qr, 2) <= kSmemMax ? 2 : 1;
  const long long blocks = static_cast<long long>(Bb) * a.H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_scan_kernel<P, N, kVec16>
      <<<static_cast<int>(blocks), kThreads, smem_bytes<P, N>(qr, stages), s>>>(
          a, qr, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int N>
int launch_route(const Args& a, int Bb, bool vec16, cudaStream_t s) {
  return vec16 ? launch<P, N, true>(a, Bb, s) : launch<P, N, false>(a, Bb, s);
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for a (P, N) pair that is not instantiated or a
// chunk outside 1..256.  x, B, C and y are bf16; dt, A, D, h0 and hout
// f32.  D and h0 may be null (no skip term; a zero initial state).  The
// copy route: 16-byte copies iff x, B, C (and h0, if given) start on 16
// bytes and the batch and time strides of x, B and C are multiples of 8
// elements (kernels/ssd_scan.py, ``route``), else 4-byte copies.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, void* y, void* hout,
    int Bb, int L, int H, int G, int P, int N, int Q, long long sxb,
    long long sxt, long long sdb, long long sdt, long long sBb,
    long long sBt, long long sCb, long long sCt, void* stream) {
  if (Q < 1 || Q > kQMax || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(x),
               static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const bf16*>(B),
               static_cast<const bf16*>(C),
               static_cast<const float*>(D),
               static_cast<const float*>(h0),
               static_cast<bf16*>(y),
               static_cast<float*>(hout),
               L, H, G, Q, sxb, sxt, sdb, sdt, sBb, sBt, sCb, sCt};
  const bool vec16 = on16(x) && on16(B) && on16(C) &&
                     (h0 == nullptr || on16(h0)) && sxb % 8 == 0 &&
                     sxt % 8 == 0 && sBb % 8 == 0 && sBt % 8 == 0 &&
                     sCb % 8 == 0 && sCt % 8 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128) return launch_route<64, 128>(a, Bb, vec16, s);
  if (P == 64 && N == 64) return launch_route<64, 64>(a, Bb, vec16, s);
  if (P == 16 && N == 16) return launch_route<16, 16>(a, Bb, vec16, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
