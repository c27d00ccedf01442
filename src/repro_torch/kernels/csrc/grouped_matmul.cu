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
// No split-K and no atomics: each output tile has one owner block and one
// order of sums, so repeated launches give bit-identical outputs.
//
// What bounds it on this card.  At the MoE serving path's shapes (mixtral:
// K, N in {4096, 14336}, 8 experts) a decode step routes every slot as its
// own group, so C = 512 slots and each launch is 481 GFLOP against 1.1 GB:
// ~440 flops a byte, above the ~295 where the H100's 989 TFLOP/s of bf16
// tensor cores, not its 3.35 TB/s of HBM, become the limit (operations
// bound, 0.486 ms).  A prefill chunk has C = 10 or 20 and is bound by the
// 939.5 MB of expert weights it streams (0.280 ms).
//
// Two routes, chosen by the wrapper from dtype, shapes, strides and
// pointers alone (grouped_matmul.route):
//
// TMA route (grouped_gemm_tma; bf16, K and N multiples of 8, 16-byte-
// aligned pointers and strides: what a tensor map can describe).  Only
// wgmma, reading both operands from shared memory, reaches the tensor
// cores' full rate, and TMA takes the copies off the threads:
//   * output tiles of 128 rows (C) by 256 columns (N) of one expert,
//     ordered C tile fastest, then N tile, then expert, and dealt in turn
//     to one persistent block an SM (or, when C fits one tile, one block a
//     tile): the C tiles of one N strip run side by side and read the
//     strip's weights through L2 together;
//   * a producer warp issues TMA loads of K slices of 64 into a 4-stage
//     ring (full / empty mbarriers): the lhs tile (C rows x 64, K-major,
//     read in place) and the rhs tile (64 x 256, N-major, read in place as
//     four 64-column boxes), both with the 128-byte swizzle; each operand
//     is described by a 3-D tensor map (inner dim, rows, expert), so a
//     ragged C, K or N edge is zero-filled inside one expert and never
//     reads the next expert's rows; nothing is padded or transposed in HBM;
//   * each of two consumer warpgroups runs wgmma.m64n256k16 (rhs read with
//     the transpose bit) on its 64 rows, 128 f32 sums a thread in registers
//     over the whole K loop, one group of 4 in flight while the next
//     slice's barrier is awaited; setmaxnreg moves registers from the
//     producer (40) to the consumers (232);
//   * the epilogue rounds once to bf16 and stores rows < C, columns < N,
//     while the producer already fills the ring with the block's next
//     tile.  (In a side-by-side build on the H100 the persistent grid was
//     the faster at the decode shape and the slower at the chunk shape,
//     so a single C tile keeps a block a tile.)
//
// mma.sync route (grouped_gemm_bf16 / grouped_gemm_f32; float32 operands,
// and bf16 that a tensor map cannot describe): 256 threads (8 warps as
// 2 x 4), a BM x 128 output tile (BM = 32, 64 or 128 by C), K in steps of
// 32 staged element by element into a 4-slot shared-memory ring (rows
// padded by 8 bf16), ldmatrix and mma.sync.m16n8k16 bf16 -> f32; float32 does
// plain f32 FMAs over 64 x 64 tiles.  The reference takes both types; only
// aligned bf16, the TMA route, is on the serving path.
// Not done yet: skipping the rows no token was routed to (a change to the
// MoE dispatch, not to this kernel), an epilogue through shared memory
// and TMA stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;                    // output columns per block
constexpr int kBK = 32;                     // K per pipeline stage
constexpr int kStages = 4;
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

// ---------------------------------------------------------------------------
// mma.sync route
// ---------------------------------------------------------------------------

// Stage the K slice [k0, k0 + 32) of the block's lhs rows [m0, m0 + BM)
// and rhs columns [n0, n0 + 128) into one ring slot, element by element
// through registers; whatever lies past C, K or N becomes zeros.
template <int BM>
__device__ __forceinline__ void load_stage(bf16* sa, bf16* sb, const bf16* a,
                                           const bf16* b, const Params& p,
                                           int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.f);
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

// One block: the (BM x 128) tile at (blockIdx.x, blockIdx.y) of expert
// blockIdx.z.  Warp w covers rows (w / 4) * BM / 2 .. + BM / 2 and columns
// (w % 4) * 32 .. + 32: MT = BM / 32 row tiles of 16 by 4 column tiles of
// 8, MT * 16 f32 accumulators a thread.
template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
grouped_gemm_bf16(Params p) {
  constexpr int MT = BM / 32;
  using T = Tile<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* sa0 = smem;                       // kStages lhs tiles
  bf16* sb0 = smem + kStages * T::kA;     // kStages rhs tiles

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const bf16* a = static_cast<const bf16*>(p.lhs) + e * p.a_se;
  const bf16* b = static_cast<const bf16*>(p.rhs) + e * p.b_se;
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
  for (int s = 0; s < kStages - 1; ++s)
    if (s < nk)
      load_stage<BM>(sa0 + s * T::kA, sb0 + s * T::kB, a, b, p, m0, n0,
                     s * kBK);

  for (int kt = 0; kt < nk; ++kt) {
    // tile kt's stores are visible, and every warp is done with the slot
    // the prefetch below overwrites
    __syncthreads();
    const int pf = kt + kStages - 1;
    if (pf < nk)
      load_stage<BM>(sa0 + (pf % kStages) * T::kA,
                     sb0 + (pf % kStages) * T::kB, a, b, p, m0, n0,
                     pf * kBK);

    const bf16* sa = sa0 + (kt % kStages) * T::kA;
    const bf16* sb = sb0 + (kt % kStages) * T::kB;
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

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
  bf16* out = static_cast<bf16*>(p.out) + static_cast<long long>(e) * p.C * p.N;
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
        bf16* o = out + static_cast<long long>(m) * p.N + n;
        if (pairs) {                     // n even and N even: n + 1 < N
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(x0, x1);
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


// ---------------------------------------------------------------------------
// TMA route: wgmma fed by TMA, warp-specialized
// ---------------------------------------------------------------------------

constexpr int kTmaBN = 256;                 // output columns per block
constexpr int kTmaBK = 64;                  // K per stage: one 128-byte row
constexpr int kTmaStages = 4;
constexpr int kSlab = 64 * kTmaBK;          // bf16 in one 64 x 64 box (8 KB)

// one producer warpgroup, then two consumer warpgroups of 64 rows each
struct TmaCfg {
  static constexpr int kRows = 128;                      // C rows per block
  static constexpr int kThreads = 384;
  static constexpr int kStageBytes = (kRows + kTmaBN) * kTmaBK * 2;
  // the stages, 1024 bytes of slack to align them, then the barriers
  static constexpr int kSmemBytes =
      kTmaStages * kStageBytes + 1024 + 2 * kTmaStages * 8;
};

__global__ void __launch_bounds__(TmaCfg::kThreads, 1)
grouped_gemm_tma(const __grid_constant__ CUtensorMap lhs_map,
                 const __grid_constant__ CUtensorMap rhs_map, bf16* out,
                 int E, int C, int K, int N) {
  using Cfg = TmaCfg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kTmaStages * Cfg::kStageBytes);
  uint64_t* empty = full + kTmaStages;
  auto stage_a = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * Cfg::kStageBytes);
  };
  auto stage_b = [&](int s) { return stage_a(s) + Cfg::kRows * kTmaBK; };

  // output tiles in the order (C tile, N tile, expert), C tile fastest,
  // dealt to the persistent blocks in turn
  const int mt = (C + Cfg::kRows - 1) / Cfg::kRows;
  const int nt = (N + kTmaBN - 1) / kTmaBN;
  const long long tiles = static_cast<long long>(mt) * nt * E;
  const int wg = threadIdx.x / 128;
  const int nk = (K + kTmaBK - 1) / kTmaBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // ``it`` counts K slices over all of the block's tiles: slice it uses
  // stage it % kTmaStages in round it / kTmaStages
  if (wg == 0) {
    // producer: one thread keeps the ring full, running ahead into the
    // next tile while the consumers store this one
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = static_cast<int>(tile % mt) * Cfg::kRows;
        const int n0 = static_cast<int>(tile / mt % nt) * kTmaBN;
        const int e = static_cast<int>(tile / (static_cast<long long>(mt) * nt));
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kTmaStages;
          mbar_wait(&empty[s], ((it / kTmaStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], Cfg::kStageBytes);
          tma_load_3d(stage_a(s), &lhs_map, &full[s], kt * kTmaBK, m0, e);
#pragma unroll
          for (int c = 0; c < kTmaBN / 64; ++c)
            tma_load_3d(stage_b(s) + c * kSlab, &rhs_map, &full[s],
                        n0 + 64 * c, kt * kTmaBK, e);
        }
      }
    }
  } else {
    // consumer warpgroup cw: rows 64 cw .. 64 cw + 63 of each tile
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int g = lane >> 2, t = lane & 3;
    int it = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = static_cast<int>(tile % mt) * Cfg::kRows;
      const int n0 = static_cast<int>(tile / mt % nt) * kTmaBN;
      const int e = static_cast<int>(tile / (static_cast<long long>(mt) * nt));
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kTmaStages;
        mbar_wait(&full[s], (it / kTmaStages) & 1);
        const bf16* a = stage_a(s) + cw * 64 * kTmaBK;
        const bf16* b = stage_b(s);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTmaBK / 16; ++kk)
          wgmma_m64n256k16(acc, wgmma_desc(a + kk * 16, 16, 1024),
                           wgmma_desc(b + kk * 16 * 64, kSlab * 2, 1024));
        wgmma_commit();
        fence_regs(acc);
        // the previous slice's products are done: hand its stage back
        wgmma_wait<1>();
        if (kt > 0 && lane == 0)
          mbar_arrive(&empty[(it - 1) % kTmaStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kTmaStages]);

      // acc[4 j + 2 h + x]: row 16 warp + g + 8 h, column 8 j + 2 t + x
      bf16* o = out + static_cast<long long>(e) * C * N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + cw * 64 + warp * 16 + g + 8 * h;
        if (m >= C) continue;
        bf16* orow = o + static_cast<long long>(m) * N;
#pragma unroll
        for (int j = 0; j < kTmaBN / 8; ++j) {
          const int n = n0 + j * 8 + 2 * t;  // N is even: n < N means n + 1 < N
          if (n < N)
            *reinterpret_cast<__nv_bfloat162*>(orow + n) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime
// (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (E, rows, inner) tensor with unit inner stride and the given
// outer strides (elements), in boxes of (64, box_rows, 1) with the
// 128-byte swizzle; out-of-bounds elements read as zeros
bool encode(CUtensorMap* map, const void* base, int inner, int rows, int E,
            long long row_stride, long long e_stride, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(e_stride) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_tma(const Params& p, int E, cudaStream_t s) {
  using Cfg = TmaCfg;
  CUtensorMap lhs_map, rhs_map;
  if (!encode(&lhs_map, p.lhs, p.K, p.C, E, p.a_sc, p.a_se, Cfg::kRows) ||
      !encode(&rhs_map, p.rhs, p.N, p.K, E, p.b_sk, p.b_se, kTmaBK))
    return cudaErrorInvalidValue;
  static unsigned long long opted = 0;      // bit per device ordinal
  cudaError_t err = opt_in(grouped_gemm_tma, Cfg::kSmemBytes, &opted);
  if (err != cudaSuccess) return err;
  // Several C tiles (decode: C = 512): one persistent block an SM (the
  // ring takes most of its shared memory), each tile's epilogue
  // overlapping the next tile's loads.  One C tile (a prefill chunk's
  // C = 10 or 20, bound by streaming the weights): a block a tile, which
  // the hardware deals to the SMs as they free up.
  const int mt = (p.C + Cfg::kRows - 1) / Cfg::kRows;
  const long long tiles =
      static_cast<long long>(mt) * ((p.N + kTmaBN - 1) / kTmaBN) * E;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(mt > 1 && tiles > sms ? sms : tiles);
  grouped_gemm_tma<<<grid, Cfg::kThreads, Cfg::kSmemBytes, s>>>(
      lhs_map, rhs_map, static_cast<bf16*>(p.out), E, p.C, p.K, p.N);
  return cudaGetLastError();
}

// more than 48 KB of dynamic shared memory needs an opt-in, once per
// device and instance (done before any CUDA-graph capture: the wrapper's
// first call at each row tile)
template <int BM>
cudaError_t launch_bf16(const Params& p, int E, cudaStream_t s) {
  static unsigned long long opted = 0;      // bit per device ordinal
  const cudaError_t err =
      opt_in(grouped_gemm_bf16<BM>, Tile<BM>::kSmemBytes, &opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.C + BM - 1) / BM, (p.N + kBN - 1) / kBN, E);
  grouped_gemm_bf16<BM><<<grid, kThreads, Tile<BM>::kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// lhs (E, C, K) and rhs (E, K, N) with unit stride on their last axis and
// the given strides (elements) on the others; out (E, C, N) contiguous.

// The mma.sync route.  dtype 0 = bf16, 1 = float32 (lhs, rhs and out alike).
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
  if (C <= 32) return static_cast<int>(launch_bf16<32>(p, E, s));
  if (C <= 64) return static_cast<int>(launch_bf16<64>(p, E, s));
  return static_cast<int>(launch_bf16<128>(p, E, s));
}

// The TMA route: bf16 only, K and N multiples of 8, pointers and strides
// 16-byte aligned and positive (what a tensor map can describe).
extern "C" int grouped_matmul_tma(const void* lhs, const void* rhs, void* out,
                                  int E, int C, int K, int N, long long a_se,
                                  long long a_sc, long long b_se,
                                  long long b_sk, void* stream) {
  if (E < 1 || C < 1 || K < 1 || N < 1 || E > 65535 || K % 8 || N % 8 ||
      (N + kTmaBN - 1) / kTmaBN > 65535 || !aligned16(lhs) ||
      !aligned16(rhs) || !aligned16(out) || a_se < 1 || a_sc < 1 ||
      b_se < 1 || b_sk < 1 || a_se % 8 || a_sc % 8 || b_se % 8 || b_sk % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{lhs, rhs, out, C, K, N, a_se, a_sc, b_se, b_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_tma(p, E, s));
}
