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
// What bounds it on this card: operations, at the training path's shape
// (1 x 4096 x 4096, 36 heads, D = 64, causal: 77 GFLOP against 75 MB) and
// the serving path's encoder shape (1500 x 1500 keys, 20 heads: 11.5 GFLOP
// against 15.5 MB); bytes at its cross-attention chunk shape (at most 128
// rows against 1500 keys).  So both products run on the tensor cores, in
// the FlashAttention-2 shape:
//   * one block per (batch * query head, tile of 64 query rows), 4 warps of
//     16 rows each; late query tiles (the heavy ones when causal) are
//     scheduled first;
//   * q, k and v are read in place in their (B, L, H, D) layout with the
//     caller's batch, sequence and head strides (the Pallas wrapper's pad
//     and transpose copies do not exist here) by 16-byte cp.async copies
//     into shared memory, rows padded by 8 bf16 (ldmatrix is then free of
//     bank conflicts), the ragged edge zero-filled;
//   * the q tile is copied once and, at D <= 128, held in registers as
//     ldmatrix A fragments; at D = 256 those fragments (64 registers) beside
//     the output (128) would not fit in 255, so each warp re-reads its 16
//     rows of q from shared memory for every key tile;
//   * key tiles (64 keys; 32 at D = 256) stream through a two-stage
//     cp.async ring: tile j + 1's copy is issued before tile j's products
//     and waited for (wait_group 1) only when tile j + 1 is next;
//   * S = Q K^T on mma.sync.m16n8k16 bf16 -> f32, K read by ldmatrix; the
//     online softmax runs on the accumulator fragments in registers (a
//     thread holds rows g and g + 8, reduced over its quad by shuffles),
//     with ex2.approx and scale * log2(e) applied once per score; only a tile
//     that crosses an edge (the diagonal, the window's lower edge, kv_len,
//     the prefix) takes the element mask;
//   * O += P V: P is packed to bf16 pairs in registers (an m16n8
//     accumulator pair is the A operand), V read by ldmatrix.trans, O held
//     in f32 registers; the row sums l are taken from the f32 P before it
//     is rounded, so lse keeps f32 accuracy.  Rounding P to bf16 for the
//     product is the one numerical change from the plain f32 version (the
//     backward rounds P the same way);
//   * rows finalize with O / max(l, 1e-37) and leave through shared memory
//     as 16-byte stores; lse = m + log(l).
// ptxas gives 124 registers at D = 64 (4 blocks, 16 warps an SM), 171 at
// D = 128 and 243 at D = 256, without spills.  Measured slower on the H100
// than this design: 128-key tiles at D = 64, two groups of 16 rows a warp
// (each K and V fragment read once for both, but half the warps an SM),
// and a __launch_bounds__ minimum of blocks (ptxas then takes more
// registers than it needs, or spills).
// Not done yet: wgmma, TMA, splitting the keys of a short query tile over
// several blocks (the cross chunk, 128 rows, gives 40 blocks for 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;                  // 4 warps
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // -0.7 * FLT_MAX

template <int D>
struct Cfg {
  static constexpr int kBlockM = 64;                     // query rows per block
  static constexpr int kBlockN = D <= 128 ? 64 : 32;     // keys per tile
  static constexpr bool kQInRegs = D <= 128;
  // the q tile, then two stages of k and of v
  static constexpr int kSmemBytes = (kBlockM + 4 * kBlockN) * (D + kPad) * 2;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;                                   // (B, Lq, Hq, D) contiguous
  float* lse;                                  // (B, Lq, Hq) contiguous
  long long q_sb, q_sl, q_sh;                  // strides, in elements
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int B, Lq, Lk, Hq, Hkv;
  int causal, window, prefix_len, q_offset;    // window < 0: none
  int kv_lim;                                  // min(kv_len, Lk)
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int BM = C::kBlockM, BN = C::kBlockN, LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + BM * LD;                     // stage s at sk + s * BN * LD
  bf16* sv = sk + 2 * BN * LD;

  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  const int q_lo = p.q_offset + m0;
  const int q_hi = q_lo + min(BM, p.Lq - m0) - 1;
  int k_begin, k_end;
  key_range(p, q_lo, q_hi, &k_begin, &k_end);

  // group 1: the q tile; group 2: the first key tile, into stage 0
  stage<D, kThreads>(sq, qb, p.q_sl, m0, BM, p.Lq);
  cp_async_commit();
  int t0 = next_tile<BN>(p, q_lo, q_hi, (k_begin / BN) * BN, k_end);
  if (t0 < k_end) {
    stage<D, kThreads>(sk, kb, p.k_sl, t0, BN, k_end);
    stage<D, kThreads>(sv, vb, p.v_sl, t0, BN, k_end);
  }
  cp_async_commit();

  bf16* wq = sq + warp * 16 * LD;              // this warp's 16 rows of q
  uint32_t qf[C::kQInRegs ? D / 16 : 1][4];
  if constexpr (C::kQInRegs) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) load_a<D>(qf[kd], wq, kd * 16, lane);
  }

  // this thread's rows: warp * 16 + g and + 8
  const int qpos0 = q_lo + warp * 16 + g;
  const float sl2 = p.scale * kLog2e;
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int st = 0; t0 < k_end; st ^= 1) {
    // issue the next tile's copy into the other stage, then wait for this one
    const int tn = next_tile<BN>(p, q_lo, q_hi, t0 + BN, k_end);
    if (tn < k_end) {
      stage<D, kThreads>(sk + (st ^ 1) * BN * LD, kb, p.k_sl, tn, BN, k_end);
      stage<D, kThreads>(sv + (st ^ 1) * BN * LD, vb, p.v_sl, tn, BN, k_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = sk + st * BN * LD;
    const bf16* vt = sv + st * BN * LD;

    // 1. S = Q K^T for this warp's 16 rows and the tile's BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (C::kQInRegs)
      frags_dot_rows<D, BN>(s, qf, kt, lane);
    else
      rows_dot_rows<D, BN>(s, wq, kt, lane);

    // 2. into the log2 domain; the element mask only where the tile
    //    crosses an edge (uniform over the block)
    const bool edge = tile_crosses_edge(p, q_lo, q_hi, t0, t0 + BN - 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sl2;
        if (edge && !visible(p, qpos0 + 8 * (e >> 1),
                             t0 + j * 8 + 2 * t + (e & 1)))
          s[j][e] = -INFINITY;
      }

    // 3. the online softmax: new row maxima over the quad, rescale
    online_softmax<BN, D>(s, m, l, o);

    // 4. O += P V
    regs_dot_tile<D, BN, D>(o, s, vt, 0, lane);
    __syncthreads();                           // this stage's readers are done
    t0 = tn;
  }
  cp_async_wait<0>();
  __syncthreads();                             // q's copies landed everywhere

  // finalize: O / l through this warp's own rows of the q tile (no other
  // warp reads them) as 16-byte stores
  finalize_rows<D>(wq, o, l, lane);
  constexpr int kParts = D / 8;                // 16-byte pieces per row
#pragma unroll
  for (int c = lane; c < 16 * kParts; c += 32) {
    const int r = c / kParts, col = (c % kParts) * 8;
    const int row = m0 + warp * 16 + r;
    if (row < p.Lq)
      *reinterpret_cast<uint4*>(
          p.out + ((static_cast<long long>(b) * p.Lq + row) * p.Hq + h) * D +
          col) = *reinterpret_cast<const uint4*>(wq + r * LD + col);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + warp * 16 + g + 8 * i;
      if (row >= p.Lq) continue;
      p.lse[(static_cast<long long>(b) * p.Lq + row) * p.Hq + h] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : -kNegInf;
    }
  }
}

template <int D>
int launch(const Params& p, cudaStream_t s) {
  using C = Cfg<D>;
  const int nq = (p.Lq + C::kBlockM - 1) / C::kBlockM;
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long opted = 0;         // bit per device ordinal
  const cudaError_t err = opt_in(flash_fwd_kernel<D>, C::kSmemBytes, &opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<D>
      <<<dim3(p.B * p.Hq, nq), kThreads, C::kSmemBytes, s>>>(p);
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
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.B = B; p.Lq = Lq; p.Lk = Lk; p.Hq = Hq; p.Hkv = Hkv;
  p.causal = causal; p.window = window; p.prefix_len = prefix_len;
  p.q_offset = q_offset;
  p.kv_lim = kv_len < Lk ? kv_len : Lk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, s);
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
