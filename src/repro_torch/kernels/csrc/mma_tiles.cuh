// Tile helpers shared by the attention kernels on mma.sync
// (flash_attention.cu, flash_attention_bwd.cu, the chunk kernel of
// paged_attention.cu) and the grouped GEMM's mma.sync route
// (grouped_matmul.cu): 16-byte cp.async copies that zero-fill the
// ragged edge, ldmatrix fragment loads, mma.sync.m16n8k16 bf16 -> f32, and
// the two products the kernels are built from, on tiles stored row-major in
// shared memory with rows padded by kPad bf16 (so ldmatrix is free of bank
// conflicts), the online-softmax step and the row finalization on the
// accumulator fragments, plus the element and tile masks of the
// reference's flash kernels.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t holds rows g and
// g + 8 of a 16 x 8 accumulator, columns 2 t and 2 t + 1; an A operand
// (16 x 16) is four 8 x 8 matrices (rows 0-7 / 8-15 by columns 0-7 / 8-15)
// and a B operand (16 x 8, k-major) two.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;                        // bf16 of padding per smem row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte global -> shared copy; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand (16 x 16) of a product along an accumulator's columns:
// accumulator tiles c[j], c[j + 1] (16 x 8 each) side by side, as bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The A operand of 16 rows (``rows``, row stride D + kPad) at head-dim
// columns [kd, kd + 16).
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* rows,
                                       int kd, int lane) {
  ldmatrix_x4(a, rows + (lane & 15) * (D + kPad) + kd + (lane >> 4) * 8);
}

// S += A B^T over head-dim columns [kd, kd + 16), with A's fragment ``a``
// (16 rows) in registers and B's N rows stored row-major (N x D) in shared
// memory from ``b_rows``: N / 8 accumulator tiles of 16 x 8.
template <int D, int N>
__device__ __forceinline__ void a_dot_rows(float (&s)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           const bf16* b_rows, int kd,
                                           int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int jp = 0; jp < N / 16; ++jp) {
    uint32_t b[4];
    ldmatrix_x4(b, b_rows + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kd + ((lane >> 3) & 1) * 8);
    mma_bf16(s[2 * jp], a, b[0], b[1]);
    mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
  }
}

// S += A (16 rows at ``a_rows``) B^T over the head dim, where both tiles
// are stored row-major (rows x D) in shared memory.
template <int D, int N>
__device__ __forceinline__ void rows_dot_rows(float (&s)[N / 8][4],
                                              const bf16* a_rows,
                                              const bf16* b_rows, int lane) {
#pragma unroll
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t a[4];
    load_a<D>(a, a_rows, kd, lane);
    a_dot_rows<D, N>(s, a, b_rows, kd, lane);
  }
}

// S += A B^T over the head dim, with A's D / 16 fragments in registers.
template <int D, int N>
__device__ __forceinline__ void frags_dot_rows(float (&s)[N / 8][4],
                                               const uint32_t (&a)[D / 16][4],
                                               const bf16* b_rows, int lane) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    a_dot_rows<D, N>(s, a[kd], b_rows, kd * 16, lane);
}

// acc (16 x W, columns [c0, c0 + W) of the head dim) += X (16 x K, in
// registers as K / 8 f32 accumulator tiles, rounded to bf16 here) B, where
// B (K x D) is stored row-major in shared memory: the product runs along
// B's rows.
template <int D, int K, int W>
__device__ __forceinline__ void regs_dot_tile(float (&acc)[W / 8][4],
                                              const float (&x)[K / 8][4],
                                              const bf16* b, int c0,
                                              int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < W / 16; ++dp) {
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, b + (kk * 16 + (lane & 15)) * LD + c0 + dp * 16 +
                                (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a, bt[0], bt[1]);
      mma_bf16(acc[2 * dp + 1], a, bt[2], bt[3]);
    }
  }
}

// The online-softmax step of a warp's 16 rows over one key tile, in the
// log2 domain: s (16 x BN scores, -inf where masked) becomes
// p = 2^(s - m_new); the row maxima m (reduced over the quad by shuffles)
// and this thread's partial row sums l (of the f32 p, before any rounding)
// are updated and the output o (16 x D) rescaled.  A row that has seen
// nothing yet keeps p = 0 and alpha = 0.
template <int BN, int D>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 8][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[D / 8][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
    const float alpha = exp2_approx(m[i] - base[i]);
    m[i] = mx[i];
    l[i] *= alpha;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][2 * i] *= alpha;
      o[j][2 * i + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(s[j][e] - base[e >> 1]);
      l[e >> 1] += s[j][e];
    }
}

// Finalize a warp's 16 rows: the quad's partial row sums, then
// o / max(l, 1e-37) rounded to bf16 into ``rows`` (16 rows of the warp's
// own, row stride D + kPad, in shared memory), from where the caller
// stores them.  Leaves l as the full row sums.
template <int D>
__device__ __forceinline__ void finalize_rows(bf16* rows, float (&o)[D / 8][4],
                                              float (&l)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8 * i) * (D + kPad) +
                                         j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
  __syncwarp();
}

// Start copying rows [row0, row0 + rows) of a (L, D) bf16 slab with row
// stride ``ld`` into shared memory (row stride D + kPad) with the block's
// NT threads; rows at or past ``nvalid`` become zeros and are not read.
// The caller commits the group.
template <int D, int NT>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long ld,
                                      int row0, int rows, int nvalid) {
  constexpr int kParts = D / 8;                // 16-byte copies per row
  for (int c = threadIdx.x; c < rows * kParts; c += NT) {
    const int r = c / kParts, col = (c % kParts) * 8;
    const bool ok = row0 + r < nvalid;
    const bf16* s = ok ? src + static_cast<long long>(row0 + r) * ld + col : src;
    cp_async16(dst + r * (D + kPad) + col, s, ok ? 16 : 0);
  }
}

// The masks, element by element exactly as the reference's _mask_tile: a
// key at kpos is visible to the query at qpos iff kpos < kv_lim and, when
// causal, kpos <= qpos (and kpos > qpos - window when window >= 0) or
// kpos < prefix_len.  ``P`` holds causal, window, prefix_len and kv_lim.
template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  if (kpos >= p.kv_lim) return false;
  if (!p.causal || kpos < p.prefix_len) return true;
  return kpos <= qpos && (p.window < 0 || kpos > qpos - p.window);
}

// may some query at [q_lo, q_hi] see some key at [k_lo, k_hi]?
template <class P>
__device__ __forceinline__ bool tile_visible(const P& p, int q_lo, int q_hi,
                                             int k_lo, int k_hi) {
  if (k_lo >= p.kv_lim) return false;
  if (!p.causal || k_lo < p.prefix_len) return true;
  if (k_lo > q_hi) return false;
  return p.window < 0 || k_hi > q_lo - p.window;
}

// does some (query, key) pair of the tile differ from the rest in
// visibility, so that it needs the element mask?  (A visible tile that
// crosses no edge is seen whole.)
template <class P>
__device__ __forceinline__ bool tile_crosses_edge(const P& p, int q_lo,
                                                  int q_hi, int k_lo,
                                                  int k_hi) {
  if (k_hi >= p.kv_lim) return true;
  if (!p.causal || k_hi < p.prefix_len) return false;
  return k_hi > q_lo || (p.window >= 0 && k_lo <= q_hi - p.window);
}

// the keys that the queries [q_lo, q_hi] may see lie in [*k_begin, *k_end)
template <class P>
__device__ __forceinline__ void key_range(const P& p, int q_lo, int q_hi,
                                          int* k_begin, int* k_end) {
  *k_begin = 0;
  *k_end = p.kv_lim;
  if (p.causal) {
    *k_end = min(*k_end, max(q_hi + 1, p.prefix_len));
    if (p.window >= 0 && p.prefix_len <= 0)
      *k_begin = max(0, q_lo - p.window + 1);
  }
}

// the first tile of BN keys at or after ``t0`` that the queries
// [q_lo, q_hi] may see, or k_end
template <int BN, class P>
__device__ __forceinline__ int next_tile(const P& p, int q_lo, int q_hi,
                                         int t0, int k_end) {
  while (t0 < k_end && !tile_visible(p, q_lo, q_hi, t0, t0 + BN - 1))
    t0 += BN;
  return t0;
}

// more than 48 KB of dynamic shared memory needs an opt-in, once per device
// and kernel (done before any CUDA-graph capture: the wrapper's first call)
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(*done >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    *done |= 1ULL << dev;
  }
  return cudaSuccess;
}

}  // namespace
