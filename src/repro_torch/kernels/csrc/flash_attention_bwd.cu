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
// sums are in a fixed order: two launches on the same inputs give
// bit-identical gradients.  S and dP are computed twice (once in each
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
// The streamed tiles (dq's K and V, dkdv's q and dout with their lse and
// delta rows) pass through a two-stage cp.async ring: the next tile's copy
// is issued before this tile's products and waited for only when it is
// next.  dkdv's query loop starts at the first query tile that can see the
// block's keys (causal: tile floor((n0 - q_offset) / BR), unless the keys
// lie in the prefix), and only tiles that cross a mask edge take the
// element mask.  Registers decide how many warps hide the copies and the
// ldmatrix latency, so each staged tile is taken 16 keys (dq) or 16
// queries (dkdv) at a time: only 2 accumulator tiles each of S and dP are
// live beside the f32 output.  At D = 64 the operands that stay fixed for
// the whole loop (dq's q and dout rows, dkdv's k and v rows) are held as
// ldmatrix A fragments, and __launch_bounds__ asks for 4 (dq) and 3 (dkdv)
// blocks an SM, 16 and 12 warps; at D = 128, 3 and 3 (dkdv spills a few
// bytes there).  The helpers are shared with the forward (mma_tiles.cuh).
// Not done yet: wgmma, TMA, a persistent schedule; one 5-product kernel
// (S and dP once, dq by f32 atomics) would trade the fixed summation
// order, and so bit-reproducible gradients, for 2 fewer products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// dq: block (batch * query head, 64 query rows), 4 warps of 16 rows; key
// tiles of BC through the two-stage ring.  Heavy (late, when causal) query
// tiles are scheduled first.
// ---------------------------------------------------------------------------

template <int D, int BC>
struct DqCfg {
  static constexpr int kThreads = 128;
  // keys of a staged tile taken at once: S and dP of BS keys are live
  static constexpr int kSub = 16;
  // q and dout held as A fragments in registers for the whole loop
  static constexpr bool kFragsInRegs = D == 64;
  // blocks an SM should hold (caps a thread's registers)
  static constexpr int kMinBlocks = D == 64 ? 4 : D == 128 ? 3 : 2;
  // the q and dout tiles, then two stages of k and of v
  static constexpr int kSmemBytes = (2 * kRows + 4 * BC) * (D + kPad) * 2;
};

template <int D, int BC>
__global__ void __launch_bounds__(128, DqCfg<D, BC>::kMinBlocks)
flash_bwd_dq_kernel(const Params p) {
  using C = DqCfg<D, BC>;
  constexpr int NT = 128, LD = D + kPad, BS = C::kSub;
  constexpr bool FR = C::kFragsInRegs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kRows * LD;
  bf16* sk = sdo + kRows * LD;                 // stage s at sk + s * BC * LD
  bf16* sv = sk + 2 * BC * LD;

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

  const int q_lo = p.q_offset + m0;
  const int q_hi = q_lo + min(kRows, p.Lq - m0) - 1;
  int k_begin, k_end;
  key_range(p, q_lo, q_hi, &k_begin, &k_end);

  // group 1: the q and dout tiles; group 2: the first key tile, stage 0
  stage<D, NT>(sq, qb, p.q_sl, m0, kRows, p.Lq);
  stage<D, NT>(sdo, ob, p.o_sl, m0, kRows, p.Lq);
  cp_async_commit();
  int n0 = next_tile<BC>(p, q_lo, q_hi, (k_begin / BC) * BC, k_end);
  if (n0 < k_end) {
    stage<D, NT>(sk, kb, p.k_sl, n0, BC, k_end);
    stage<D, NT>(sv, vb, p.v_sl, n0, BC, k_end);
  }
  cp_async_commit();

  const bf16* wq = sq + warp * 16 * LD;        // this warp's 16 rows
  const bf16* wdo = sdo + warp * 16 * LD;
  uint32_t qf[FR ? D / 16 : 1][4], of[FR ? D / 16 : 1][4];
  if constexpr (FR) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      load_a<D>(qf[kd], wq, kd * 16, lane);
      load_a<D>(of[kd], wdo, kd * 16, lane);
    }
  }

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

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int st = 0; n0 < k_end; st ^= 1) {
    // issue the next tile's copy into the other stage, then wait for this one
    const int nn = next_tile<BC>(p, q_lo, q_hi, n0 + BC, k_end);
    if (nn < k_end) {
      stage<D, NT>(sk + (st ^ 1) * BC * LD, kb, p.k_sl, nn, BC, k_end);
      stage<D, NT>(sv + (st ^ 1) * BC * LD, vb, p.v_sl, nn, BC, k_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = sk + st * BC * LD;
    const bf16* vt = sv + st * BC * LD;

    // the element mask only where the tile crosses an edge (uniform over
    // the block)
    const bool edge = tile_crosses_edge(p, q_lo, q_hi, n0, n0 + BC - 1);
#pragma unroll 1
    for (int c0 = 0; c0 < BC; c0 += BS) {
      // S and dP of this warp's 16 rows and the BS keys from c0
      float s[BS / 8][4], dp[BS / 8][4];
#pragma unroll
      for (int j = 0; j < BS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      if constexpr (FR) {
        frags_dot_rows<D, BS>(s, qf, kt + c0 * LD, lane);
        frags_dot_rows<D, BS>(dp, of, vt + c0 * LD, lane);
      } else {
        rows_dot_rows<D, BS>(s, wq, kt + c0 * LD, lane);
        rows_dot_rows<D, BS>(dp, wdo, vt + c0 * LD, lane);
      }
      // dS = P (dP - delta) scale, into s
#pragma unroll
      for (int j = 0; j < BS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kpos = n0 + c0 + j * 8 + 2 * t + (e & 1);
          float pv = exp2f(s[j][e] * sl2 - lse2[i]);
          if (edge && !(live[i] && visible(p, qpos[i], kpos))) pv = 0.f;
          s[j][e] = pv * (dp[j][e] - dlt[i]) * p.scale;
        }
      regs_dot_tile<D, BS, D>(acc, s, kt + c0 * LD, 0, lane);
    }
    __syncthreads();                           // this stage's readers are done
    n0 = nn;
  }
  cp_async_wait<0>();

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
// dk and dv; query tiles of BR, with their lse and delta rows, through the
// two-stage ring, over every query head of the GQA group.
// ---------------------------------------------------------------------------

template <int D, int BR, int WD>
struct DkdvCfg {
  static constexpr int kThreads = 128 * WD;
  // query rows of a staged tile taken at once: S^T and dP^T of BS rows are
  // live in registers
  static constexpr int kSub = 16;
  // k and v held as A fragments in registers for the whole loop
  static constexpr bool kFragsInRegs = D == 64;
  // blocks an SM should hold (caps a thread's registers)
  static constexpr int kMinBlocks = D <= 128 ? 3 : 1;
  // one stage: q and dout tiles, lse and delta rows (bytes; a multiple of 16)
  static constexpr int kStageBytes = 2 * BR * (D + kPad) * 2 + 2 * BR * 4;
  // the block's k and v tiles, then two stages
  static constexpr int kSmemBytes = 2 * kRows * (D + kPad) * 2 + 2 * kStageBytes;
};

// Advance (gi, mt) to the first (query head of the group, query tile) pair
// at or after it whose tile may see the keys [n0, n0 + kRows); gi = G when
// none is left.  A new head starts again at tile mt_first.
template <int BR>
__device__ __forceinline__ void next_pair(const Params& p, int n0, int G,
                                          int mt_first, int& gi, int& mt) {
  const int nmt = (p.Lq + BR - 1) / BR;
  for (; gi < G; ++gi, mt = mt_first)
    for (; mt < nmt; ++mt) {
      const int q_lo = p.q_offset + mt * BR;
      if (tile_visible(p, q_lo, q_lo + min(BR, p.Lq - mt * BR) - 1, n0,
                       n0 + kRows - 1))
        return;
    }
}

template <int D, int BR, int WD>
__global__ void __launch_bounds__(DkdvCfg<D, BR, WD>::kThreads,
                                  DkdvCfg<D, BR, WD>::kMinBlocks)
flash_bwd_dkdv_kernel(const Params p) {
  using C = DkdvCfg<D, BR, WD>;
  constexpr int NT = C::kThreads, LD = D + kPad, DW = D / WD, BS = C::kSub;
  constexpr bool FR = C::kFragsInRegs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kRows * LD;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sv + kRows * LD);
  // stage s: q (BR x LD), dout (BR x LD), lse (BR), delta (BR)
  auto sq_of = [&](int s) {
    return reinterpret_cast<bf16*>(ring + s * C::kStageBytes);
  };
  auto slse_of = [&](int s) {
    return reinterpret_cast<float*>(sq_of(s) + 2 * BR * LD);
  };

  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int n0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = warp & 3, c0 = (warp >> 2) * DW;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * kLog2e;

  // start copying query tile mt of query head kvh * G + gi into stage s
  auto issue = [&](int gi, int mt, int s) {
    const int h = kvh * G + gi, m0 = mt * BR;
    bf16* sq = sq_of(s);
    float* slse = slse_of(s);
    stage<D, NT>(sq, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, m0, BR, p.Lq);
    stage<D, NT>(sq + BR * LD, p.dout + b * p.o_sb + h * p.o_sh, p.o_sl, m0,
                 BR, p.Lq);
    for (int r = threadIdx.x; r < BR; r += NT) {
      const int row = m0 + r;
      const bool ok = row < p.Lq;
      const long long o =
          ok ? (static_cast<long long>(b) * p.Lq + row) * p.Hq + h : 0;
      cp_async4(slse + r, p.lse + o, ok ? 4 : 0);
      cp_async4(slse + BR + r, p.delta + o, ok ? 4 : 0);
    }
  };

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  if (n0 < p.kv_lim) {                         // uniform over the block
    // group 1: the block's k and v tiles; group 2: the first query tile
    stage<D, NT>(sk, p.k + b * p.k_sb + kvh * p.k_sh, p.k_sl, n0, kRows,
                 p.kv_lim);
    stage<D, NT>(sv, p.v + b * p.v_sb + kvh * p.v_sh, p.v_sl, n0, kRows,
                 p.kv_lim);
    cp_async_commit();
    // causal keys past the prefix are seen from query row n0 - q_offset on
    const int mt_first = p.causal && n0 >= p.prefix_len
                             ? max(0, n0 - p.q_offset) / BR : 0;
    int gi = 0, mt = mt_first;
    next_pair<BR>(p, n0, G, mt_first, gi, mt);
    if (gi < G) issue(gi, mt, 0);
    cp_async_commit();
    const bf16* wk_rows = sk + wk * 16 * LD;   // this warp's 16 keys
    const bf16* wv_rows = sv + wk * 16 * LD;
    uint32_t kf[FR ? D / 16 : 1][4], vf[FR ? D / 16 : 1][4];
    if constexpr (FR) {
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        load_a<D>(kf[kd], wk_rows, kd * 16, lane);
        load_a<D>(vf[kd], wv_rows, kd * 16, lane);
      }
    }

    const int kpos[2] = {n0 + wk * 16 + g, n0 + wk * 16 + g + 8};
    for (int s = 0; gi < G; s ^= 1) {
      // issue the next pair's copy into the other stage, then wait for this
      int ngi = gi, nmt = mt + 1;
      next_pair<BR>(p, n0, G, mt_first, ngi, nmt);
      if (ngi < G) issue(ngi, nmt, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* sq = sq_of(s);
      const bf16* sdo = sq + BR * LD;
      const float* slse = slse_of(s);
      const float* sdlt = slse + BR;
      const int m0 = mt * BR, q_lo = p.q_offset + m0;

      // the element mask only where the tile crosses an edge or the query
      // rows end (uniform over the block)
      const bool edge = m0 + BR > p.Lq ||
                        tile_crosses_edge(p, q_lo, q_lo + BR - 1, n0,
                                          n0 + kRows - 1);
#pragma unroll 1
      for (int r0 = 0; r0 < BR; r0 += BS) {
        // S^T and dP^T: this warp's 16 keys x BS queries from row r0
        float st[BS / 8][4], dpt[BS / 8][4];
#pragma unroll
        for (int j = 0; j < BS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
        if constexpr (FR) {
          frags_dot_rows<D, BS>(st, kf, sq + r0 * LD, lane);
          frags_dot_rows<D, BS>(dpt, vf, sdo + r0 * LD, lane);
        } else {
          rows_dot_rows<D, BS>(st, wk_rows, sq + r0 * LD, lane);
          rows_dot_rows<D, BS>(dpt, wv_rows, sdo + r0 * LD, lane);
        }
        // P^T into st, dS^T into dpt
#pragma unroll
        for (int j = 0; j < BS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + j * 8 + 2 * t + (e & 1);
            float pv = exp2f(st[j][e] * sl2 - slse[r] * kLog2e);
            if (edge &&
                !(m0 + r < p.Lq && visible(p, q_lo + r, kpos[e >> 1])))
              pv = 0.f;
            st[j][e] = pv;
            dpt[j][e] = pv * (dpt[j][e] - sdlt[r]) * p.scale;
          }
        regs_dot_tile<D, BS, DW>(dv, st, sdo + r0 * LD, c0, lane);
        regs_dot_tile<D, BS, DW>(dk, dpt, sq + r0 * LD, c0, lane);
      }
      __syncthreads();                         // this stage's readers are done
      gi = ngi;
      mt = nmt;
    }
    cp_async_wait<0>();
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
