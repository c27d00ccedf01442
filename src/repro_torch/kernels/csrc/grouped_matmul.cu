// Grouped (per-expert) matrix product, written by hand for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (kernels/grouped_matmul.py).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/moe_gemm.py:
//   grouped_matmul_pallas  :41  (pallas_call :60, body _gemm_kernel :25)
// out[e] = lhs[e] @ rhs[e] for every expert e: lhs (E, C, K), rhs (E, K, N),
// out (E, C, N) in lhs's dtype, every product summed in f32 over the whole
// K loop and rounded once on output (the Pallas kernel's VMEM acc_ref).
//
// What bounds it on this card.  At the MoE serving path's shapes (mixtral:
// K, N in {4096, 14336}, 8 experts) a decode step routes every slot as its
// own group, so C = 512 slots and each launch is 481 GFLOP against 1.1 GB:
// ~440 flops a byte, above the ~295 where the H100's 989 TFLOP/s of bf16
// tensor cores, not its 3.35 TB/s of HBM, become the limit (operations
// bound, 0.486 ms).  A prefill chunk has C = 10 or 20 and is bound by the
// 939.5 MB of expert weights it streams (0.280 ms).  So the products run on
// the tensor cores and each weight byte is read from HBM about once:
//   * one block per (C tile, N tile, expert), the C tiles of one N strip
//     adjacent in the grid so they read the strip's weights through L2
//     together;
//   * 256 threads (8 warps as 2 x 4), a BM x 128 output tile (BM = 32, 64
//     or 128 by C, so a chunk's C = 10 does not compute 118 dead rows), the
//     f32 accumulators in registers for the whole K loop;
//   * K in steps of 32: bf16 tiles of lhs and rhs staged in shared memory
//     through a 4-deep cp.async ring (16-byte copies that zero-fill the
//     ragged edges, so nothing is padded in HBM), read into registers with
//     ldmatrix (.trans for rhs, stored K-major) and multiplied with
//     mma.sync.m16n8k16 bf16 -> f32;
//   * rows padded by 8 bf16 in shared memory so ldmatrix is free of bank
//     conflicts.
// When K or N is not a multiple of 8, or a pointer or stride is not
// 16-byte aligned, the tiles are staged element by element instead (same
// products).  A float32 instance does plain f32 FMAs over 64 x 64 tiles:
// the reference takes both types; only bf16 is on the serving path.
// Not done yet: wgmma, TMA, and skipping the rows no token was routed to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;                    // output columns per block
constexpr int kBK = 32;                     // K per pipeline stage
constexpr int kStages = 4;
constexpr int kPad = 8;                     // bf16 of padding per smem row
constexpr int kLdA = kBK + kPad;            // lhs tile row stride (40)
constexpr int kLdB = kBN + kPad;            // rhs tile row stride (136)

struct Params {
  const void* lhs;
  const void* rhs;
  void* out;
  int C, K, N;
  long long a_se, a_sc;                     // lhs strides (elements)
  long long b_se, b_sk;                     // rhs strides (elements)
};

template <int BM>
struct Tile {
  static constexpr int kA = BM * kLdA;      // bf16 per lhs stage
  static constexpr int kB = kBK * kLdB;     // bf16 per rhs stage
  static constexpr int kSmemBytes = kStages * (kA + kB) * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) * b (16 x 8, k-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the K slice [k0, k0 + 32) of the block's lhs rows [m0, m0 + BM)
// and rhs columns [n0, n0 + 128) into one ring slot; whatever lies past C,
// K or N becomes zeros.  kAligned: 16-byte cp.async copies (K and N
// multiples of 8, pointers and strides 16-byte aligned); else element by
// element through registers.
template <int BM, bool kAligned>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* sa, __nv_bfloat16* sb, const __nv_bfloat16* a,
    const __nv_bfloat16* b, const Params& p, int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (kAligned) {
    // lhs: BM rows x 4 chunks of 8
    for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < p.C && k < p.K;
      const __nv_bfloat16* src = ok ? a + m * p.a_sc + k : a;
      cp_async16(sa + r * kLdA + kc, src, ok ? 16 : 0);
    }
    // rhs: 32 rows (k) x 16 chunks of 8 (n)
    for (int c = tid; c < kBK * (kBN / 8); c += kThreads) {
      const int r = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const int k = k0 + r, n = n0 + nc;
      const bool ok = k < p.K && n < p.N;
      const __nv_bfloat16* src = ok ? b + k * p.b_sk + n : b;
      cp_async16(sb + r * kLdB + nc, src, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int c = tid; c < BM * kBK; c += kThreads) {
      const int r = c / kBK, kk = c % kBK;
      const int m = m0 + r, k = k0 + kk;
      sa[r * kLdA + kk] = (m < p.C && k < p.K) ? a[m * p.a_sc + k] : zero;
    }
    for (int c = tid; c < kBK * kBN; c += kThreads) {
      const int r = c / kBN, nn = c % kBN;
      const int k = k0 + r, n = n0 + nn;
      sb[r * kLdB + nn] = (k < p.K && n < p.N) ? b[k * p.b_sk + n] : zero;
    }
  }
}

// One block: the (BM x 128) tile at (blockIdx.x, blockIdx.y) of expert
// blockIdx.z.  Warp w covers rows (w / 4) * BM / 2 .. + BM / 2 and columns
// (w % 4) * 32 .. + 32: MT = BM / 32 row tiles of 16 by 4 column tiles of
// 8, MT * 16 f32 accumulators a thread.
template <int BM, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
grouped_gemm_bf16(Params p) {
  constexpr int MT = BM / 32;
  using T = Tile<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sa0 = smem;                       // kStages lhs tiles
  __nv_bfloat16* sb0 = smem + kStages * T::kA;     // kStages rhs tiles

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const __nv_bfloat16* a =
      static_cast<const __nv_bfloat16*>(p.lhs) + e * p.a_se;
  const __nv_bfloat16* b =
      static_cast<const __nv_bfloat16*>(p.rhs) + e * p.b_se;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * (BM / 2), wn = (warp & 3) * 32;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int nk = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<BM, kAligned>(sa0 + s * T::kA, sb0 + s * T::kB, a, b, p,
                               m0, n0, s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed (at most kStages - 2 younger groups in flight),
    // and every warp is done with the slot the prefetch below overwrites
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pf = kt + kStages - 1;
    if (pf < nk)
      load_stage<BM, kAligned>(sa0 + (pf % kStages) * T::kA,
                               sb0 + (pf % kStages) * T::kB, a, b, p, m0,
                               n0, pf * kBK);
    cp_async_commit();

    const __nv_bfloat16* sa = sa0 + (kt % kStages) * T::kA;
    const __nv_bfloat16* sb = sb0 + (kt % kStages) * T::kB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], sa + (wm + i * 16 + (lane & 15)) * kLdA + kk +
                               (lane >> 4) * 8);
      uint32_t bf[2][4];                 // [pair of n8 tiles][b0 b1 b0 b1]
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bf[j], sb + (kk + (lane & 15)) * kLdB + wn +
                                     j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                   bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) +
                       static_cast<long long>(e) * p.C * p.N;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        const int n = n0 + wn + j * 8 + 2 * t;
        if (m >= p.C || n >= p.N) continue;
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        __nv_bfloat16* o = out + static_cast<long long>(m) * p.N + n;
        if (pairs) {                     // n even and N even: n + 1 < N
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
        } else {
          o[0] = __float2bfloat16(x0);
          if (n + 1 < p.N) o[1] = __float2bfloat16(x1);
        }
      }
}

// float32: 64 x 64 output tile, 256 threads with 4 x 4 outputs each, K in
// steps of 16 staged in shared memory (lhs stored K-major), f32 FMAs
constexpr int kF32Tile = 64;
constexpr int kF32K = 16;

__global__ void __launch_bounds__(kThreads)
grouped_gemm_f32(Params p) {
  __shared__ float sa[kF32K][kF32Tile + 4];
  __shared__ float sb[kF32K][kF32Tile];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kF32Tile, n0 = blockIdx.y * kF32Tile;
  const float* a = static_cast<const float*>(p.lhs) + e * p.a_se;
  const float* b = static_cast<const float*>(p.rhs) + e * p.b_se;
  const int tid = threadIdx.x;
  const int tm = (tid / 16) * 4, tn = (tid % 16) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kF32K) {
    for (int c = tid; c < kF32Tile * kF32K; c += kThreads) {
      const int r = c / kF32K, kk = c % kF32K;
      const int m = m0 + r, k = k0 + kk;
      sa[kk][r] = (m < p.C && k < p.K) ? a[m * p.a_sc + k] : 0.f;
    }
    for (int c = tid; c < kF32K * kF32Tile; c += kThreads) {
      const int r = c / kF32Tile, nn = c % kF32Tile;
      const int k = k0 + r, n = n0 + nn;
      sb[r][nn] = (k < p.K && n < p.N) ? b[k * p.b_sk + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sa[kk][tm + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sb[kk][tn + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(p.out) +
               static_cast<long long>(e) * p.C * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tm + i, n = n0 + tn + j;
      if (m < p.C && n < p.N)
        out[static_cast<long long>(m) * p.N + n] = acc[i][j];
    }
}

// more than 48 KB of dynamic shared memory needs an opt-in, once per
// device and instance (done before any CUDA-graph capture: the wrapper's
// first call at each row tile)
template <int BM, bool kAligned>
cudaError_t launch_bf16(const Params& p, int E, cudaStream_t s) {
  static unsigned long long opted_in = 0;    // bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted_in >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(grouped_gemm_bf16<BM, kAligned>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<BM>::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in |= 1ULL << dev;
  }
  const dim3 grid((p.C + BM - 1) / BM, (p.N + kBN - 1) / kBN, E);
  grouped_gemm_bf16<BM, kAligned>
      <<<grid, kThreads, Tile<BM>::kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

template <bool kAligned>
cudaError_t dispatch_rows(const Params& p, int E, cudaStream_t s) {
  if (p.C <= 32) return launch_bf16<32, kAligned>(p, E, s);
  if (p.C <= 64) return launch_bf16<64, kAligned>(p, E, s);
  return launch_bf16<128, kAligned>(p, E, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = ok).  lhs (E, C, K) and
// rhs (E, K, N) with unit stride on their last axis and the given strides
// (elements) on the others; out (E, C, N) contiguous.  dtype 0 = bf16,
// 1 = float32 (lhs, rhs and out alike).
extern "C" int grouped_matmul(const void* lhs, const void* rhs, void* out,
                              int E, int C, int K, int N, long long a_se,
                              long long a_sc, long long b_se, long long b_sk,
                              int dtype, void* stream) {
  if (E < 1 || C < 1 || K < 0 || N < 1 || E > 65535 ||
      (N + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{lhs, rhs, out, C, K, N, a_se, a_sc, b_se, b_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((C + kF32Tile - 1) / kF32Tile,
                    (N + kF32Tile - 1) / kF32Tile, E);
    grouped_gemm_f32<<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = K % 8 == 0 && N % 8 == 0 && aligned16(lhs) &&
                       aligned16(rhs) && a_se % 8 == 0 && a_sc % 8 == 0 &&
                       b_se % 8 == 0 && b_sk % 8 == 0;
  return static_cast<int>(aligned ? dispatch_rows<true>(p, E, s)
                                  : dispatch_rows<false>(p, E, s));
}
