// Mamba-2 SSD chunked scan, written by hand for Hopper (sm_90a), with a
// plain C interface bound by ctypes (kernels/ssd_scan.py).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/ssd_scan.py:
//   ssd_scan_pallas  :85  (pallas_call :117, body _ssd_kernel :33)
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
// peak).  This first kernel is a simple one that does its arithmetic in f32
// on the CUDA cores (67 TFLOP/s, not 989), so in practice the arithmetic,
// not the bytes, sets its time.  What the design does:
//   * the TPU's sequential "arbitrary" chunk axis becomes a loop over
//     chunks inside one block per (batch, head); the block carries the
//     (P, N) f32 state in shared memory from chunk to chunk (32 KB at
//     64 x 128) and writes it out once;
//   * x, dt, B and C are read in place with the caller's batch and time
//     strides: no transpose to (B*H, L, .), and B and C are read from head
//     h's group directly, never repeated H/G times (the Pallas wrapper
//     materialises them 80x at G = 1);
//   * the (Q x Q) matrix M is never whole: at Q = 256 it would take 256 KB
//     of f32.  It is built in strips of 32 rows (only the columns s <= t
//     of the strip), applied to x, and dropped;
//   * each chunk's x and B stay in shared memory as bf16 (their input
//     type, so nothing is lost) for the strips and the state update; at
//     Q = 256, P = 64, N = 128 the block takes 178 KB of dynamic shared
//     memory, one block per SM.
// Later work: wgmma tiles for C B^T, M x and the state update; computing
// C B^T once per group rather than once per head; splitting P across
// blocks, since at the path's shape the grid is 80 blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;                // rows of M built at a time
constexpr int kQMax = 256;                // largest chunk
constexpr int kColGroups = kQMax / 32;    // lane column groups of a strip

struct Args {
  const __nv_bfloat16* x;                 // (Bb, L, H, P), strided
  const float* dt;                        // (Bb, L, H), strided
  const float* A;                         // (H,)
  const __nv_bfloat16* B;                 // (Bb, L, G, N), strided
  const __nv_bfloat16* C;                 // (Bb, L, G, N), strided
  const float* D;                         // (H,) or null
  const float* h0;                        // (Bb, H, P, N) or null
  __nv_bfloat16* y;                       // (Bb, L, H, P), contiguous
  float* hout;                            // (Bb, H, P, N), contiguous
  int L, H, G, Q;
  long long sxb, sxt, sdb, sdt, sBb, sBt, sCb, sCt;   // element strides
};

// Shared memory of one block for chunks of up to qr rows (qr a multiple
// of 32), in this order: the state transposed, hT[N][P + 2] (f32); one strip
// of M, ms[kStrip][qr + 1] (f32); per-token cum, dt, exp(cum) and the
// state weights exp(cum_last - cum) * dt (f32, qr each); the chunk's x,
// xs[qr][P], and B, bs[qr][N + 2], and the strip's C, cs[kStrip][N]
// (bf16).  The paddings keep column reads free of bank conflicts.
template <int P, int N>
__host__ __device__ constexpr size_t smem_floats(int qr) {
  return size_t(N) * (P + 2) + size_t(kStrip) * (qr + 1) + 4 * size_t(qr);
}

template <int P, int N>
__host__ __device__ constexpr size_t smem_bytes(int qr) {
  return smem_floats<P, N>(qr) * 4 +
         (size_t(qr) * P + size_t(qr) * (N + 2) + size_t(kStrip) * N) * 2;
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Args a, const int qr) {
  static_assert(P % 2 == 0 && N % 4 == 0, "P even, N a multiple of 4");
  constexpr int kPP = P / 2;              // p pairs: threads along p
  constexpr int kTR = kThreads / kPP;     // thread rows
  static_assert(kThreads % kPP == 0 && kStrip % kTR == 0,
                "P must tile the block");
  constexpr int kRows = kStrip / kTR;     // y rows per thread
  constexpr int kNs = (N + kTR - 1) / kTR;  // state columns per thread
  constexpr int kMRows = kStrip / kWarps; // M rows per warp
  constexpr int kHS = P + 2;              // hT row stride (f32)
  constexpr int kBS = N + 2;              // bs row stride (bf16)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const int ms_stride = qr + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hT = reinterpret_cast<float*>(smem_raw);
  float* ms = hT + N * kHS;
  float* cum = ms + kStrip * ms_stride;
  float* dtv = cum + qr;
  float* ecum = dtv + qr;
  float* wv = ecum + qr;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(wv + qr);
  __nv_bfloat16* bs = xs + qr * P;
  __nv_bfloat16* cs = bs + qr * kBS;

  const float A = a.A[h];
  const float Dh = a.D ? a.D[h] : 0.f;
  const float* h0 = a.h0 ? a.h0 + size_t(bh) * P * N : nullptr;
  for (int i = tid; i < P * N; i += kThreads)
    hT[(i % N) * kHS + i / N] = h0 ? h0[i] : 0.f;

  const int pp = tid % kPP, tr = tid / kPP;
  for (int c0 = 0; c0 < a.L; c0 += a.Q) {
    const int nq = min(a.Q, a.L - c0);
    __syncthreads();                      // the last state update is done
    for (int t = tid; t < nq; t += kThreads)
      dtv[t] = a.dt[b * a.sdb + (c0 + t) * a.sdt + h];
    for (int i = tid; i < nq * kPP; i += kThreads) {
      const int t = i / kPP, j = 2 * (i % kPP);
      *reinterpret_cast<__nv_bfloat162*>(xs + t * P + j) =
          *reinterpret_cast<const __nv_bfloat162*>(
              a.x + b * a.sxb + (c0 + t) * a.sxt + h * P + j);
    }
    for (int i = tid; i < nq * (N / 2); i += kThreads) {
      const int t = i / (N / 2), j = 2 * (i % (N / 2));
      *reinterpret_cast<__nv_bfloat162*>(bs + t * kBS + j) =
          *reinterpret_cast<const __nv_bfloat162*>(
              a.B + b * a.sBb + (c0 + t) * a.sBt + g * N + j);
    }
    __syncthreads();
    if (warp == 0) {                      // inclusive cumsum of dt * A
      constexpr int kPer = kQMax / 32;
      float v[kPer];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int t = lane * kPer + e;
        run += t < nq ? dtv[t] * A : 0.f;
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
        if (t < nq) cum[t] = v[e] + incl - run;
      }
    }
    __syncthreads();
    const float last = cum[nq - 1];
    for (int t = tid; t < nq; t += kThreads) {
      ecum[t] = expf(cum[t]);
      wv[t] = expf(last - cum[t]) * dtv[t];
    }

    for (int t0 = 0; t0 < nq; t0 += kStrip) {
      const int nr = min(kStrip, nq - t0);   // rows of this strip
      const int ncol = t0 + nr;              // columns s < ncol
      const int nk = (ncol + 31) / 32;
      __syncthreads();                    // the last strip's readers are done
      for (int i = tid; i < nr * (N / 2); i += kThreads) {
        const int r = i / (N / 2), j = 2 * (i % (N / 2));
        *reinterpret_cast<__nv_bfloat162*>(cs + r * N + j) =
            *reinterpret_cast<const __nv_bfloat162*>(
                a.C + b * a.sCb + (c0 + t0 + r) * a.sCt + g * N + j);
      }
      __syncthreads();

      // M strip: warp w builds rows w*kMRows.., lane the columns
      // lane + 32k; C rows are broadcast, B rows padded to odd words
      {
        float acc[kMRows][kColGroups];
#pragma unroll
        for (int i = 0; i < kMRows; ++i)
#pragma unroll
          for (int k = 0; k < kColGroups; ++k) acc[i][k] = 0.f;
        const int r0 = warp * kMRows;
        for (int n = 0; n < N; n += 2) {
          float2 c[kMRows];
#pragma unroll
          for (int i = 0; i < kMRows; ++i) c[i] = ld2(cs + (r0 + i) * N + n);
#pragma unroll
          for (int k = 0; k < kColGroups; ++k) {
            if (k < nk) {
              const float2 bb = ld2(bs + (lane + 32 * k) * kBS + n);
#pragma unroll
              for (int i = 0; i < kMRows; ++i)
                acc[i][k] += c[i].x * bb.x + c[i].y * bb.y;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kMRows; ++i) {
          const int r = r0 + i, t = t0 + r;
          if (r >= nr) continue;
#pragma unroll
          for (int k = 0; k < kColGroups; ++k) {
            const int s = lane + 32 * k;
            if (k < nk)
              ms[r * ms_stride + s] =
                  s <= t ? acc[i][k] * expf(cum[t] - cum[s]) * dtv[s] : 0.f;
          }
        }
      }
      __syncthreads();

      // y strip: thread (tr, pp) owns rows tr + kTR*i and p = 2pp, 2pp+1
      {
        float2 intra[kRows], inter[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) intra[i] = inter[i] = make_float2(0.f, 0.f);
        for (int s = 0; s < ncol; ++s) {
          const float2 xv = ld2(xs + s * P + 2 * pp);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float m = ms[(tr + kTR * i) * ms_stride + s];
            intra[i].x += m * xv.x;
            intra[i].y += m * xv.y;
          }
        }
        for (int n = 0; n < N; n += 2) {
          const float2 h0v = *reinterpret_cast<const float2*>(hT + n * kHS + 2 * pp);
          const float2 h1v = *reinterpret_cast<const float2*>(hT + (n + 1) * kHS + 2 * pp);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float2 c = ld2(cs + (tr + kTR * i) * N + n);
            inter[i].x += c.x * h0v.x + c.y * h1v.x;
            inter[i].y += c.x * h0v.y + c.y * h1v.y;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = tr + kTR * i, t = t0 + r;
          if (r >= nr) continue;
          const float2 xv = ld2(xs + t * P + 2 * pp);
          const float e = ecum[t];
          const float y0 = intra[i].x + e * inter[i].x + Dh * xv.x;
          const float y1 = intra[i].y + e * inter[i].y + Dh * xv.y;
          *reinterpret_cast<__nv_bfloat162*>(
              a.y + ((size_t(b) * a.L + c0 + t) * a.H + h) * P + 2 * pp) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
    __syncthreads();

    // state update: thread (tr, pp) owns columns n = tr + kTR*k of rows
    // p = 2pp, 2pp+1 of h
    {
      const float decay = expf(last);
      float2 acc[kNs];
#pragma unroll
      for (int k = 0; k < kNs; ++k) {
        const int n = tr + kTR * k;
        acc[k] = make_float2(0.f, 0.f);
        if (n < N) {
          const float2 hv = *reinterpret_cast<const float2*>(hT + n * kHS + 2 * pp);
          acc[k] = make_float2(decay * hv.x, decay * hv.y);
        }
      }
      for (int s = 0; s < nq; ++s) {
        float2 xv = ld2(xs + s * P + 2 * pp);
        xv.x *= wv[s];
        xv.y *= wv[s];
#pragma unroll
        for (int k = 0; k < kNs; ++k) {
          const int n = tr + kTR * k;
          if (n < N) {
            const float bv = __bfloat162float(bs[s * kBS + n]);
            acc[k].x += xv.x * bv;
            acc[k].y += xv.y * bv;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kNs; ++k) {
        const int n = tr + kTR * k;
        if (n < N) *reinterpret_cast<float2*>(hT + n * kHS + 2 * pp) = acc[k];
      }
    }
  }
  __syncthreads();
  float* hout = a.hout + size_t(bh) * P * N;
  for (int i = tid; i < P * N; i += kThreads) hout[i] = hT[(i % N) * kHS + i / N];
}

// ---- host side ----

template <int P, int N>
int launch(const Args& a, int Bb, cudaStream_t s) {
  static bool configured = false;         // once per (P, N)
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<P, N>(kQMax)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int qr = (a.Q + 31) / 32 * 32;
  ssd_scan_kernel<P, N><<<Bb * a.H, kThreads, smem_bytes<P, N>(qr), s>>>(a, qr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = ok), or
// cudaErrorInvalidValue for a (P, N) pair that is not instantiated or a
// chunk outside 1..256.  x, B, C and y are bf16; dt, A, D, h0 and hout
// f32.  D and h0 may be null (no skip term; a zero initial state).
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* h0, void* y, void* hout,
    int Bb, int L, int H, int G, int P, int N, int Q, long long sxb,
    long long sxt, long long sdb, long long sdt, long long sBb,
    long long sBt, long long sCb, long long sCt, void* stream) {
  if (Q < 1 || Q > kQMax || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const __nv_bfloat16*>(B),
               static_cast<const __nv_bfloat16*>(C),
               static_cast<const float*>(D),
               static_cast<const float*>(h0),
               static_cast<__nv_bfloat16*>(y),
               static_cast<float*>(hout),
               L, H, G, Q, sxb, sxt, sdb, sdt, sBb, sBt, sCb, sCt};
  const auto s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128) return launch<64, 128>(a, Bb, s);
  if (P == 64 && N == 64) return launch<64, 64>(a, Bb, s);
  if (P == 16 && N == 16) return launch<16, 16>(a, Bb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
