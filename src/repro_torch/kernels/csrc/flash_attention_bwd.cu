// Flash attention, backward, written by hand for Hopper (sm_90a), with a
// plain C interface bound by ctypes (kernels/flash_attention_bwd.py).
//
// Replaces the Pallas TPU kernels of the reference package,
// src/repro/kernels/flash_attention_bwd.py:
//   flash_attention_bwd_pallas  :156  (pallas_call :200, body _dq_kernel
//   :75; pallas_call :224, body _dkdv_kernel :112)
// From the forward's residuals (q, k, v, its log-sum-exp lse) and the
// output gradient dout it computes dq, dk and dv: per tile it recomputes
// P = exp(S * scale - lse) and takes dS = P (dP - delta) scale, with
// dP = dout v^T and delta = rowsum(dout * out) (one f32 PyTorch op in the
// wrapper, as the reference computes it in jnp outside its kernels).
//
// Masks, element by element exactly as in flash_attention.cu and the
// reference's _mask_tile: a key at kpos is visible to the query row at
// qpos = q_offset + i iff kpos < kv_len and, when causal, kpos <= qpos (and
// kpos > qpos - window when window >= 0) or kpos < prefix_len.  GQA: query
// head h reads kv head h / (Hq / Hkv).  Whole tiles that no pair can see
// are skipped.  (The Pallas block test, _block_visible :50, also skips a
// key block past the q tile's last row when prefix_len reaches into it,
// and so drops gradient through prefix keys that its own oracle sees; this
// kernel follows the element mask.)
//
// Two kernels, launched one after the other on the caller's stream.  The
// TPU runs each grid in order and carries dq (or dk and dv) in VMEM over
// the sequential axis; here blocks run in parallel in no order, so each
// output tile is owned by one block that loops over the other axis:
//   * dq:   one block per (batch * query head, 64 query rows), looping over
//           the key tiles the rows can see; dq += dS K.
//   * dkdv: one block per (batch * kv head, 64 keys), looping over every
//           query head of the GQA group and every query tile that can see
//           the keys; dv += P^T dout, dk += dS^T q.
// Neither writes what the other reads, so there are no atomics and the
// sums are in a fixed order.  S and dP are computed twice (once in each
// kernel): 7 products per tile pair instead of 5, for no atomics.
//
// What bounds it on this card: operations.  At the training path's shape
// (q = k = v = (1, 4096, 36, 64) bf16, causal) the function does 5 products
// of 2 * 4096^2 * 64 per head, halved by causality: 193 GFLOP against 8
// tensors of 18.9 MB (0.045 ms of bytes; 0.196 ms of bf16 tensor-core
// time).  So the products run on the tensor cores: q, k, v and dout tiles
// are staged in shared memory as bf16 with 16-byte cp.async copies that
// zero-fill the ragged edge (read in place with the caller's (B, L, H, D)
// strides: the Pallas wrapper's pads and (B*H, L, D) transposes do not
// exist), read into registers with ldmatrix (.trans where the product
// runs along the tile's rows) and multiplied with mma.sync.m16n8k16 bf16
// -> f32.  Each warp owns 16 rows of the output tile; S, dP, P and dS stay
// in its registers (an m16n8 accumulator pair is the A operand of the next
// product), rounded to bf16 as the reference's oracle rounds them.  Rows
// are padded by 8 bf16 in shared memory so ldmatrix is free of bank
// conflicts.  At D = 128 and 256 the key tile of dq and the query tile of
// dkdv shrink to 32, and at D = 256 dkdv's warps split the head dim in two
// halves (each recomputing the warp's S and dP), to stay in registers.
// Not done yet: wgmma, TMA, double-buffered tiles, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 8;                        // bf16 of padding per smem row
constexpr int kRows = 64;                      // dq's query tile, dkdv's key tile

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;                            // (B, Lq, Hq) contiguous
  const float* delta;                          // (B, Lq, Hq) contiguous
  bf16* dq;                                    // (B, Lq, Hq, D) contiguous
  bf16* dk;                                    // (B, Lk, Hkv, D) contiguous
  bf16* dv;
  long long q_sb, q_sl, q_sh;                  // strides, in elements
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;                  // dout's
  int B, Lq, Lk, Hq, Hkv;
  int causal, window, prefix_len, q_offset;    // window < 0: none
  int kv_lim;                                  // min(kv_len, Lk)
  float scale;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// S += A (16 rows at ``a_rows``) B^T over the head dim, where both tiles
// are stored row-major (rows x D) in shared memory: N / 8 accumulator tiles
// of 16 x 8.  ``b_rows`` points at the first of the N rows of B.
template <int D, int N>
__device__ __forceinline__ void rows_dot_rows(float (&s)[N / 8][4],
                                              const bf16* a_rows,
                                              const bf16* b_rows, int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kd = 0; kd < D; kd += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + (lane & 15) * LD + kd + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < N / 16; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, b_rows + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kd + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jp], a, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x W, columns [c0, c0 + W) of the head dim) += X (16 x K, in
// registers as K / 8 accumulator tiles) B, where B (K x D) is stored
// row-major in shared memory: the product runs along B's rows.
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

// Stage rows [row0, row0 + rows) of a (L, D) bf16 slab with row stride
// ``ld`` into shared memory (row stride D + kPad); rows at or past
// ``nvalid`` become zeros and are not read.
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

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  if (kpos >= p.kv_lim) return false;
  if (!p.causal || kpos < p.prefix_len) return true;
  return kpos <= qpos && (p.window < 0 || kpos > qpos - p.window);
}

// may some query at [q_lo, q_hi] see some key at [k_lo, k_hi]?
__device__ __forceinline__ bool tile_visible(const Params& p, int q_lo,
                                             int q_hi, int k_lo, int k_hi) {
  if (k_lo >= p.kv_lim) return false;
  if (!p.causal || k_lo < p.prefix_len) return true;
  if (k_lo > q_hi) return false;
  return p.window < 0 || k_hi > q_lo - p.window;
}

// ---------------------------------------------------------------------------
// dq: block (batch * query head, 64 query rows), 4 warps of 16 rows; key
// tiles of BC.  Heavy (late, when causal) query tiles are scheduled first.
// ---------------------------------------------------------------------------

template <int D, int BC>
struct DqCfg {
  static constexpr int kThreads = 128;
  static constexpr int kSmemBytes = (2 * kRows + 2 * BC) * (D + kPad) * 2;
};

template <int D, int BC>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const Params p) {
  constexpr int NT = 128, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kRows * LD;
  bf16* sk = sdo + kRows * LD;
  bf16* sv = sk + BC * LD;

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* ob = p.dout + b * p.o_sb + h * p.o_sh;
  const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  stage<D, NT>(sq, qb, p.q_sl, m0, kRows, p.Lq);
  stage<D, NT>(sdo, ob, p.o_sl, m0, kRows, p.Lq);
  cp_async_commit();

  // this thread's rows: warp * 16 + g and + 8
  int qpos[2];
  bool live[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + warp * 16 + g + 8 * i;
    live[i] = row < p.Lq;
    qpos[i] = p.q_offset + row;
    const long long o = (static_cast<long long>(b) * p.Lq + row) * p.Hq + h;
    lse2[i] = live[i] ? p.lse[o] * kLog2e : 0.f;
    dlt[i] = live[i] ? p.delta[o] : 0.f;
  }
  const float sl2 = p.scale * kLog2e;

  // keys any row of this block can see lie in [k_begin, k_end)
  const int q_lo = p.q_offset + m0;
  const int q_hi = q_lo + min(kRows, p.Lq - m0) - 1;
  int k_end = p.kv_lim, k_begin = 0;
  if (p.causal) {
    k_end = min(k_end, max(q_hi + 1, p.prefix_len));
    if (p.window >= 0 && p.prefix_len <= 0)
      k_begin = max(0, q_lo - p.window + 1);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n0 = (k_begin / BC) * BC; n0 < k_end; n0 += BC) {
    if (!tile_visible(p, q_lo, q_hi, n0, n0 + BC - 1)) continue;
    __syncthreads();                           // the last tile's readers are done
    stage<D, NT>(sk, kb, p.k_sl, n0, BC, p.kv_lim);
    stage<D, NT>(sv, vb, p.v_sl, n0, BC, p.kv_lim);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_dot_rows<D, BC>(s, sq + warp * 16 * LD, sk, lane);
    rows_dot_rows<D, BC>(dp, sdo + warp * 16 * LD, sv, lane);
    // dS = P (dP - delta) scale, into s
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kpos = n0 + j * 8 + 2 * t + (e & 1);
        const bool ok = live[i] && visible(p, qpos[i], kpos);
        const float pv = ok ? exp2f(s[j][e] * sl2 - lse2[i]) : 0.f;
        s[j][e] = pv * (dp[j][e] - dlt[i]) * p.scale;
      }
    regs_dot_tile<D, BC, D>(acc, s, sk, 0, lane);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int row = m0 + warp * 16 + g + 8 * i;
    bf16* o = p.dq + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: block (batch * kv head, 64 keys), 4 * WD warps: warp w owns keys
// (w % 4) * 16 .. + 16 and head-dim columns (w / 4) * D / WD .. + D / WD of
// dk and dv; query tiles of BR.
// ---------------------------------------------------------------------------

template <int D, int BR, int WD>
struct DkdvCfg {
  static constexpr int kThreads = 128 * WD;
  static constexpr int kSmemBytes =
      (2 * kRows + 2 * BR) * (D + kPad) * 2 + 2 * BR * 4;
};

template <int D, int BR, int WD>
__global__ void __launch_bounds__(128 * WD)
flash_bwd_dkdv_kernel(const Params p) {
  constexpr int NT = 128 * WD, LD = D + kPad, DW = D / WD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kRows * LD;
  bf16* sq = sv + kRows * LD;
  bf16* sdo = sq + BR * LD;
  float* slse = reinterpret_cast<float*>(sdo + BR * LD);   // lse * log2(e)
  float* sdlt = slse + BR;

  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int n0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = warp & 3, c0 = (warp >> 2) * DW;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * kLog2e;

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (n0 < p.kv_lim) {                         // uniform over the block
    stage<D, NT>(sk, p.k + b * p.k_sb + kvh * p.k_sh, p.k_sl, n0, kRows,
                 p.kv_lim);
    stage<D, NT>(sv, p.v + b * p.v_sb + kvh * p.v_sh, p.v_sl, n0, kRows,
                 p.kv_lim);
    cp_async_commit();
    const int kpos[2] = {n0 + wk * 16 + g, n0 + wk * 16 + g + 8};
    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
      const bf16* ob = p.dout + b * p.o_sb + h * p.o_sh;
      for (int m0 = 0; m0 < p.Lq; m0 += BR) {
        const int q_lo = p.q_offset + m0;
        const int q_hi = q_lo + min(BR, p.Lq - m0) - 1;
        if (!tile_visible(p, q_lo, q_hi, n0, n0 + kRows - 1)) continue;
        __syncthreads();                       // the last tile's readers are done
        stage<D, NT>(sq, qb, p.q_sl, m0, BR, p.Lq);
        stage<D, NT>(sdo, ob, p.o_sl, m0, BR, p.Lq);
        cp_async_commit();
        for (int r = threadIdx.x; r < BR; r += NT) {
          const int row = m0 + r;
          const bool ok = row < p.Lq;
          const long long o = (static_cast<long long>(b) * p.Lq + row) * p.Hq + h;
          slse[r] = ok ? p.lse[o] * kLog2e : 0.f;
          sdlt[r] = ok ? p.delta[o] : 0.f;
        }
        cp_async_wait_all();
        __syncthreads();

        // S^T and dP^T: this warp's 16 keys x BR queries
        float st[BR / 8][4], dpt[BR / 8][4];
#pragma unroll
        for (int j = 0; j < BR / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
        rows_dot_rows<D, BR>(st, sk + wk * 16 * LD, sq, lane);
        rows_dot_rows<D, BR>(dpt, sv + wk * 16 * LD, sdo, lane);
        // P^T into st, dS^T into dpt
#pragma unroll
        for (int j = 0; j < BR / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = j * 8 + 2 * t + (e & 1);
            const bool ok = m0 + r < p.Lq &&
                            visible(p, q_lo + r, kpos[e >> 1]);
            const float pv = ok ? exp2f(st[j][e] * sl2 - slse[r]) : 0.f;
            st[j][e] = pv;
            dpt[j][e] = pv * (dpt[j][e] - sdlt[r]) * p.scale;
          }
        regs_dot_tile<D, BR, DW>(dv, st, sdo, c0, lane);
        regs_dot_tile<D, BR, DW>(dk, dpt, sq, c0, lane);
      }
    }
    cp_async_wait_all();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = n0 + wk * 16 + g + 8 * i;
    if (key >= p.Lk) continue;
    const long long o =
        ((static_cast<long long>(b) * p.Lk + key) * p.Hkv + kvh) * D + c0;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + o + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + o + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
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

template <int D, int BC, int BR, int WD>
int launch(const Params& p, cudaStream_t s) {
  using Q = DqCfg<D, BC>;
  using K = DkdvCfg<D, BR, WD>;
  const int nq = (p.Lq + kRows - 1) / kRows, nk = (p.Lk + kRows - 1) / kRows;
  if (nq > 65535 || nk > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long dq_opted = 0, dkdv_opted = 0;   // bit per device
  cudaError_t err = opt_in(flash_bwd_dq_kernel<D, BC>, Q::kSmemBytes,
                           &dq_opted);
  if (err == cudaSuccess)
    err = opt_in(flash_bwd_dkdv_kernel<D, BR, WD>, K::kSmemBytes,
                 &dkdv_opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D, BC>
      <<<dim3(p.B * p.Hq, nq), Q::kThreads, Q::kSmemBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<D, BR, WD>
      <<<dim3(p.B * p.Hkv, nk), K::kThreads, K::kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = ok).  q, k, v, dout,
// dq, dk and dv are bf16, lse and delta f32 (B, Lq, Hq) contiguous; dq, dk
// and dv are contiguous; strides are in elements; window < 0 means none.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int B, int Lq, int Lk, int Hq, int Hkv, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    int causal, int window, int prefix_len, int q_offset, int kv_len,
    float scale, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv ||
      static_cast<long long>(B) * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sh = o_sh;
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.Hq = Hq; p.Hkv = Hkv;
  p.causal = causal; p.window = window; p.prefix_len = prefix_len;
  p.q_offset = q_offset;
  p.kv_lim = kv_len < Lk ? kv_len : Lk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64, 64, 64, 1>(p, s);
    case 128: return launch<128, 32, 32, 1>(p, s);
    case 256: return launch<256, 32, 32, 2>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
