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
// h / G, G = Hq / Hkv <= 16 (8 at D = 256).  A slot that sees no key
// writes zeros and reads nothing of its cache.
//
// What bounds it on this card: bytes.  Each visible key costs 4*D flops per
// query head against 4*D bytes of bf16 K and V per kv head: G flops a byte,
// far below the ~295 a byte at which the H100's tensor cores, not its 3.35
// TB/s of HBM, become the limit.  The served shapes range from a few long
// rows (mixtral's ring at its tp = 4 shard: 16 (slot, kv head) items of
// 4096 keys) through MQA (paligemma-3b: 1 kv head, 32 of 512 slots live)
// to thousands of short items (whisper's cross-attention, zamba2-7b), so
// the design moves each live K/V byte once, with enough of them in flight
// on every SM whatever the shape:
//   * Keys split over warps (the first design's grid was one block per
//     (slot, kv head), no split: 16 blocks for 132 SMs at the ring).  The
//     work is (slot, kv head, split) items of one warp each; the wrapper
//     picks the split count from the shapes alone (decode_attention.py,
//     plan_splits: never from cache_len, so a call is free of syncs and
//     can be captured in a CUDA graph).  With one split the warp writes
//     its rows directly; with more, each split's f32 partial state (m, l,
//     acc) goes to a workspace and decode_merge_kernel combines a row's
//     splits in ascending split order.  No float atomics: repeats are
//     bit-identical.
//   * A persistent grid (as many 4-warp blocks as the card holds at once):
//     warp w of block c takes items c + w * C, then every W-th (C blocks,
//     W warps), 32 at a time: lane j loads item j's length, a ballot names
//     the live items, and a dead slot's item, or a split wholly outside its
//     slot's visible range, costs that one load.  Neighbouring items (a
//     slot's splits, live slots side by side) land on different SMs: dealt
//     to a block's four warps in turn, paligemma's 128 live items filled 32
//     SMs.  Dead items write nothing (the merge recomputes which splits
//     overlap the range and reads only those), except with one split, where
//     the warp writes their zero rows with 16-byte stores.  (The first
//     design dispatched a block for each of paligemma's 480 dead slots.)
//   * Staging (the first design had none: each lane read a whole K row by
//     itself from global memory): each warp streams its item's keys through
//     its own three-stage ring of 16-byte cp.async copies, coalesced rows
//     of K and V into shared memory (rows padded by 8 bf16 so that ldmatrix
//     is free of bank conflicts), two tiles in flight while one is scored.
//     A tile is 16 keys (32 at D = 64): 8 KB of K and V at D <= 128, 16 KB
//     at D = 256.  Keys past the range are zero-filled and read nothing.
//   * Products on mma.sync.m16n8k16 (the first design's P V was a serial
//     loop of one shuffle per key per query row).  S = Q K^T with the G
//     query heads of the group as the 16 rows of A (q held as fragments in
//     registers, rows past G zeros) and the tile's keys from shared memory
//     as B, so a GQA or MQA group reads its K/V once; then O^T += V^T P^T,
//     V^T by ldmatrix.trans and P^T straight from S's accumulator (lane 4g
//     + t holds head g's probabilities of keys 2t, 2t + 1: B's fragment).
//     P is split into bf16 hi + lo parts (two products), so P V keeps f32
//     probabilities to ~2^-16 rather than bf16's 2^-8; the tensor cores
//     have the room (G <= 16 flops a byte).  Q K^T sums even and odd
//     16-dim steps in two accumulators: a warp alone on its SM waits on
//     the chain of dependent products.  The online softmax runs on the
//     fragments in the log2 domain (ex2.approx), one quad shuffle pair a
//     tile for the row maxima and one shuffle pair for O^T's rescale.
//   * No in-block merge (the first design merged four warps' states in 40
//     KB of static shared memory at D = 256): a warp owns its item, so
//     warps need no barrier and the only shared memory is the rings (92-
//     203 KB a block, dynamic, opted in with cudaFuncSetAttribute).  The
//     merge kernel issues the loads of 16 / kC splits before summing them:
//     one load at a time, its chain of round trips took nearly as long as
//     the ring's split kernel.
//   * D = 112 (zamba2-7b) is an instance at its own width: 7 k-steps of 16
//     for Q K^T and 7 m-tiles of 16 dims for V^T P^T, rows of 120 bf16 in
//     shared memory; nothing is padded in memory.
// Tried side by side on the card and dropped: a four-stage ring at D = 128
// (no faster at the ring); 16 or 64 splits at the ring's tp = 4 shard
// instead of 32 (both slower; 16 was faster at tp = 1, the planner keeps
// one rule); 4 splits at paligemma instead of 8 (slower); splitting
// whisper's tp = 1 row in 2 (slower).  Not built: folding the merge into
// the split kernel through per-item counters (the merge is its own launch
// and a short chain of loads; chip_smoke.py --decode-attention times it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 4;                      // a block's warps
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // -0.7 * FLT_MAX

// One instance: head dim D and R query rows a warp serves (R = 8 or 16: the
// group G <= R; rows past G are zeros and never written out).
template <int D, int R>
struct Cfg {
  static constexpr int kKeys = D == 64 ? 32 : 16;        // keys a tile
  static constexpr int kStages = 3;                      // the warp's ring
  static constexpr int kLd = D + kPad;                   // smem row (bf16)
  static constexpr int kTile = kKeys * kLd;              // bf16 of K (or V)
  static constexpr int kStage = 2 * kTile;               // K then V
  static constexpr int kWarpBytes = kStages * kStage * 2;
  static constexpr int kSmemBytes = kWarps * kWarpBytes;
  static constexpr int kKd = D / 16;                     // 16-dim steps
  static constexpr int kNt = R / 8;                      // 8-head n-tiles
  static constexpr int kChunks = D / 8;                  // 16-byte chunks a row
  static constexpr int kIssue = kKeys * kChunks / 32;    // copies a lane, each of K and V
  static_assert(D % 16 == 0 && (R == 8 || R == 16), "instance");
  static_assert(kKeys * kChunks % 32 == 0, "a tile's copies over the warp");
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* cache_len;
  bf16* out;
  float* ws_acc;                 // (B * Hq, nsplit, D) f32, nsplit > 1 only
  float* ws_ml;                  // (B * Hq, nsplit, 2) f32: m (log2), l
  long long k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  int B, Hq, Hkv, S, window, nsplit, split_len;
  float scale_log2;
};

// Copies of keys [t0, t0 + kKeys) of one (slot, kv head) into a stage:
// K rows then V rows; keys at or past ``end`` are zero-filled and read
// nothing.
template <int D, int R>
__device__ __forceinline__ void issue_tile(bf16* stage, const bf16* kb,
                                           const bf16* vb, long long k_sl,
                                           long long v_sl, int t0, int end,
                                           int lane) {
  using C = Cfg<D, R>;
#pragma unroll
  for (int i = 0; i < C::kIssue; ++i) {
    const int idx = i * 32 + lane, r = idx / C::kChunks;
    const int col = (idx % C::kChunks) * 8;
    const bool ok = t0 + r < end;
    const long long kp = t0 + r;
    cp_async16(stage + r * C::kLd + col, ok ? kb + kp * k_sl + col : kb,
               ok ? 16 : 0);
    cp_async16(stage + C::kTile + r * C::kLd + col,
               ok ? vb + kp * v_sl + col : vb, ok ? 16 : 0);
  }
}

// The group's q rows as A fragments of S = Q K^T: lane 4g + t holds head
// g's (a0, a2) and head g + 8's (a1, a3) dims kd*16 + 2t, +1 and
// kd*16 + 8 + 2t, +1; heads past G are zeros.
template <int D, int R>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4],
                                       const bf16* qrows, int G, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(qrows + g * D);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(qrows + (g + 8) * D);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    qa[kd][0] = g < G ? __ldg(lo + kd * 8 + t) : 0u;
    qa[kd][2] = g < G ? __ldg(lo + kd * 8 + 4 + t) : 0u;
    if constexpr (R == 16) {
      qa[kd][1] = g + 8 < G ? __ldg(hi + kd * 8 + t) : 0u;
      qa[kd][3] = g + 8 < G ? __ldg(hi + kd * 8 + 4 + t) : 0u;
    } else {
      qa[kd][1] = 0u;
      qa[kd][3] = 0u;
    }
  }
}

// x0, x1 as bf16 pairs hi + lo with hi + lo = x to ~2^-16 of x
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// A warp's online-softmax state over its item: per head g (i = 0) and
// g + 8 (i = 1) the running max m (log2 domain, equal in the quad) and this
// lane's share of the row sum l; O^T's accumulators (m-tile mt of 16 dims,
// n-tile i of 8 heads): lane 4g + t holds dims 16mt + g (0, 1) and + 8
// (2, 3) of heads 8i + 2t (0, 2) and 8i + 2t + 1 (1, 3).
template <int D, int R>
struct State {
  float m[2], l[2];
  float o[D / 16][R / 8][4];

  __device__ __forceinline__ void reset() {
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
      for (int i = 0; i < R / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][i][e] = 0.f;
  }
};

// Tile of keys [t0, t0 + kKeys), visible below ``end``, from ``stage``
// into the warp's state.
template <int D, int R>
__device__ __forceinline__ void attend_tile(const bf16* stage,
                                            const uint32_t (&qa)[D / 16][4],
                                            int t0, int end, float scale_log2,
                                            State<D, R>& w, int lane) {
  using C = Cfg<D, R>;
  constexpr int kJ = C::kKeys / 8;             // 8-key n-tiles of S
  const int t = lane & 3;
  // 1. S = Q K^T: element e of n-tile j is head g (e < 2) or g + 8 against
  //    key t0 + 8j + 2t + (e & 1)
  //    (even and odd 16-dim steps in two accumulators: two shorter chains
  //    of dependent products, for a warp that is alone on its SM)
  float s[kJ][4], s2[kJ][4];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < C::kKd; kd += 2) {
    a_dot_rows<D, C::kKeys>(s, qa[kd], stage, kd * 16, lane);
    if (kd + 1 < C::kKd)
      a_dot_rows<D, C::kKeys>(s2, qa[kd + 1], stage, kd * 16 + 16, lane);
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
  const bool edge = t0 + C::kKeys > end;
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = !edge || t0 + 8 * j + 2 * t + (e & 1) < end
                    ? s[j][e] * scale_log2 : kNegInf;
  // 2. the online softmax, per head row (the quad's max, then p = 2^(s - m)
  //    and this lane's share of the sum); every tile holds a visible key,
  //    so m is finite after it and masked keys get p = 0
#pragma unroll
  for (int i = 0; i < C::kNt; ++i) {
    float mx = w.m[i];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2_approx(w.m[i] - mx);
    w.m[i] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        s[j][e] = exp2_approx(s[j][e] - mx);
        sum += s[j][e];
      }
    w.l[i] = w.l[i] * alpha + sum;
    // O^T's heads 8i + 2t and 8i + 2t + 1 take their alpha from lanes 8t
    // and 8t + 4 (heads g = 2t and 2t + 1)
    const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * t);
    const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
    for (int mt = 0; mt < C::kKd; ++mt) {
      w.o[mt][i][0] *= a0;
      w.o[mt][i][1] *= a1;
      w.o[mt][i][2] *= a0;
      w.o[mt][i][3] *= a1;
    }
  }
  // 3. O^T += V^T P^T, 16 keys at a time: V^T's fragment by ldmatrix.trans
  //    of the tile's V rows, P^T's (keys 2t, 2t + 1 and 2t + 8, 2t + 9 of
  //    head g) straight from S, as hi and lo bf16 parts
  const bf16* sv = stage + C::kTile;
#pragma unroll
  for (int kk = 0; kk < C::kKeys / 16; ++kk) {
    uint32_t ph[C::kNt][2], pl[C::kNt][2];
#pragma unroll
    for (int i = 0; i < C::kNt; ++i) {
      split_bf16(s[2 * kk][2 * i], s[2 * kk][2 * i + 1], ph[i][0], pl[i][0]);
      split_bf16(s[2 * kk + 1][2 * i], s[2 * kk + 1][2 * i + 1], ph[i][1],
                 pl[i][1]);
    }
    const bf16* vrow = sv + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::kLd +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < C::kKd; ++mt) {
      uint32_t va[4];
      ldmatrix_x4_trans(va, vrow + mt * 16);
#pragma unroll
      for (int i = 0; i < C::kNt; ++i) {
        mma_bf16(w.o[mt][i], va, ph[i][0], ph[i][1]);
        mma_bf16(w.o[mt][i], va, pl[i][0], pl[i][1]);
      }
    }
  }
}

// One item: slot b, kv head kvh, keys [a, e) (a < e) of split ``split``,
// streamed through the warp's ring; then the G rows (one split) or the
// split's partial state (more).
template <int D, int R>
__device__ __forceinline__ void run_item(const Params& p, bf16* ring, int b,
                                         int kvh, int split, int a, int e,
                                         int lane) {
  using C = Cfg<D, R>;
  const int G = p.Hq / p.Hkv;
  const long long row0 = static_cast<long long>(b) * p.Hq +
                         static_cast<long long>(kvh) * G;
  const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  constexpr int kAhead = C::kStages - 1;       // tiles in flight
  const int n = (e - a + C::kKeys - 1) / C::kKeys;
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < n)
      issue_tile<D, R>(ring + i * C::kStage, kb, vb, p.k_sl, p.v_sl,
                       a + i * C::kKeys, e, lane);
    cp_async_commit();
  }
  uint32_t qa[C::kKd][4];
  load_q<D, R>(qa, p.q + row0 * D, G, lane);
  State<D, R> w;
  w.reset();
  int st = 0;                                  // tile i's stage
  for (int i = 0; i < n; ++i) {
    if (i + kAhead < n) {                      // into the stage tile i - 1 left
      const int nx = st == 0 ? kAhead : st - 1;
      issue_tile<D, R>(ring + nx * C::kStage, kb, vb, p.k_sl, p.v_sl,
                       a + (i + kAhead) * C::kKeys, e, lane);
    }
    cp_async_commit();
    cp_async_wait<kAhead>();
    __syncwarp();
    attend_tile<D, R>(ring + st * C::kStage, qa, a + i * C::kKeys, e,
                      p.scale_log2, w, lane);
    __syncwarp();
    st = st == kAhead ? 0 : st + 1;
  }
  // the row sums over the quad; lane 4g + t writes dims 16mt + g (+ 8) of
  // heads 8i + 2t and 8i + 2t + 1, whose sums lanes 8t and 8t + 4 hold
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < C::kNt; ++i) {
    w.l[i] += __shfl_xor_sync(0xffffffffu, w.l[i], 1);
    w.l[i] += __shfl_xor_sync(0xffffffffu, w.l[i], 2);
  }
  if (p.nsplit == 1) {
#pragma unroll
    for (int i = 0; i < C::kNt; ++i) {
      const float d0 = fmaxf(__shfl_sync(0xffffffffu, w.l[i], 8 * t), 1e-37f);
      const float d1 = fmaxf(__shfl_sync(0xffffffffu, w.l[i], 8 * t + 4), 1e-37f);
      const int h0 = 8 * i + 2 * t;
      bf16* o0 = p.out + (row0 + h0) * D + g;
#pragma unroll
      for (int mt = 0; mt < C::kKd; ++mt) {
        if (h0 < G) {
          o0[mt * 16] = __float2bfloat16(w.o[mt][i][0] / d0);
          o0[mt * 16 + 8] = __float2bfloat16(w.o[mt][i][2] / d0);
        }
        if (h0 + 1 < G) {
          o0[D + mt * 16] = __float2bfloat16(w.o[mt][i][1] / d1);
          o0[D + mt * 16 + 8] = __float2bfloat16(w.o[mt][i][3] / d1);
        }
      }
    }
    return;
  }
  const int ns = p.nsplit;
#pragma unroll
  for (int i = 0; i < C::kNt; ++i) {
    const int h0 = 8 * i + 2 * t;
    float* a0 = p.ws_acc + ((row0 + h0) * ns + split) * D + g;
    float* a1 = a0 + static_cast<long long>(ns) * D;     // head h0 + 1
#pragma unroll
    for (int mt = 0; mt < C::kKd; ++mt) {
      if (h0 < G) {
        a0[mt * 16] = w.o[mt][i][0];
        a0[mt * 16 + 8] = w.o[mt][i][2];
      }
      if (h0 + 1 < G) {
        a1[mt * 16] = w.o[mt][i][1];
        a1[mt * 16 + 8] = w.o[mt][i][3];
      }
    }
    if (t == 0 && 8 * i + g < G) {
      float* ml = p.ws_ml + ((row0 + 8 * i + g) * ns + split) * 2;
      ml[0] = w.m[i];
      ml[1] = w.l[i];
    }
  }
}

// The split kernel: a persistent grid of warps over the (slot, kv head,
// split) items, item j = ((b * Hkv) + kvh) * nsplit + split.  Warp w of
// block c is warp c + w * gridDim.x of the grid, so that neighbouring
// items (a live slot's splits, live slots side by side) land on different
// SMs.
template <int D, int R>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const Params p) {
  using C = Cfg<D, R>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* ring = reinterpret_cast<bf16*>(smem + warp * C::kWarpBytes);
  const int G = p.Hq / p.Hkv, ns = p.nsplit;
  const long long items = static_cast<long long>(p.B) * p.Hkv * ns;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long base = blockIdx.x + static_cast<long long>(warp) * gridDim.x;
       base < items; base += 32 * stride) {
    // lane j finds item base + j * stride's visible keys [a, e)
    const long long j = base + lane * stride;
    int a = 0, e = 0;
    if (j < items) {
      const long long bh = j / ns;
      const int split = static_cast<int>(j - bh * ns);
      const int len = __ldg(p.cache_len + bh / p.Hkv);
      const int hi = min(len, p.S);
      const int lo = p.window >= 0 ? max(0, len - p.window) : 0;
      a = max(lo, split * p.split_len);
      e = min(hi, (split + 1) * p.split_len);
    }
    unsigned live = __ballot_sync(0xffffffffu, j < items && a < e);
    if (ns == 1) {
      // the G rows of items that see no key: zeros, 16 bytes a lane
      unsigned dead = __ballot_sync(0xffffffffu, j < items && a >= e);
      while (dead) {
        const int src = __ffs(dead) - 1;
        dead &= dead - 1;
        uint4* o = reinterpret_cast<uint4*>(
            p.out + (base + static_cast<long long>(src) * stride) * G * D);
        for (int c = lane; c < G * D / 8; c += 32) o[c] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const long long item = base + static_cast<long long>(src) * stride;
      const long long bh = item / ns;
      run_item<D, R>(p, ring, static_cast<int>(bh / p.Hkv),
                     static_cast<int>(bh % p.Hkv), static_cast<int>(item - bh * ns),
                     __shfl_sync(0xffffffffu, a, src),
                     __shfl_sync(0xffffffffu, e, src), lane);
    }
  }
}

// The merge: one warp a (slot, query head) row combines the partial states
// of the splits that overlap its slot's visible range, in ascending split
// order, and writes acc / max(l, 1e-37); a row that sees no key is zeros.
// Lane j reads split j's (m, l) of each pass of 32 splits and passes its
// weight 2^(m - max m) by shuffle; each lane sums its 4-dim columns of the
// splits' acc, the loads of 16 / kC splits issued before their sums.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const Params p) {
  constexpr int kC = (D / 4 + 31) / 32;        // float4 columns a lane
  constexpr int kBatch = 16 / kC;              // splits' loads in flight
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(p.B) * p.Hq) return;
  const int len = __ldg(p.cache_len + row / p.Hq);
  const int hi = min(len, p.S);
  const int lo = p.window >= 0 ? max(0, len - p.window) : 0;
  bf16* o = p.out + row * D;
  if (hi <= lo) {
    for (int c = lane; c < D / 8; c += 32)
      reinterpret_cast<uint4*>(o)[c] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int ns = p.nsplit;
  const int s0 = lo / p.split_len, n = (hi - 1) / p.split_len - s0 + 1;
  const float* ml = p.ws_ml + (row * ns + s0) * 2;
  const float4* acc = reinterpret_cast<const float4*>(p.ws_acc + (row * ns + s0) * D);
  float mx = kNegInf;
  for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ml[2 * j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float4 x[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) x[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  float lsum = 0.f;
  for (int b0 = 0; b0 < n; b0 += 32) {
    // lanes past the row's splits carry f = l = 0, so a batch's tail adds
    // zeros
    float f = 0.f, l = 0.f;
    if (b0 + lane < n) {
      f = exp2_approx(ml[2 * (b0 + lane)] - mx);
      l = ml[2 * (b0 + lane) + 1];
    }
    const int cnt = min(32, n - b0);
    for (int u0 = 0; u0 < cnt; u0 += kBatch) {
      float4 y[kBatch][kC];
#pragma unroll
      for (int v = 0; v < kBatch; ++v)
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          const int c = lane + 32 * k;
          y[v][k] = u0 + v < cnt && c < D / 4
                        ? acc[static_cast<long long>(b0 + u0 + v) * (D / 4) + c]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int v = 0; v < kBatch; ++v) {
        const float fu = __shfl_sync(0xffffffffu, f, u0 + v);
        lsum += __shfl_sync(0xffffffffu, l, u0 + v) * fu;
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          x[k].x += fu * y[v][k].x;
          x[k].y += fu * y[v][k].y;
          x[k].z += fu * y[v][k].z;
          x[k].w += fu * y[v][k].w;
        }
      }
    }
  }
  const float den = fmaxf(lsum, 1e-37f);
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int c = lane + 32 * k;
    if (c < D / 4) {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(o + 4 * c);
      o2[0] = __floats2bfloat162_rn(x[k].x / den, x[k].y / den);
      o2[1] = __floats2bfloat162_rn(x[k].z / den, x[k].w / den);
    }
  }
}

template <int D, int R>
int launch_rows(const Params& p, cudaStream_t s) {
  using C = Cfg<D, R>;
  auto kernel = decode_split_kernel<D, R>;
  static unsigned long long opted = 0;         // bit per device ordinal
  static int resident[64] = {};                // blocks a card holds at once
  cudaError_t err = opt_in(kernel, C::kSmemBytes, &opted);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, C::kSmemBytes);
    if (err == cudaSuccess) resident[dev] = (per_sm > 1 ? per_sm : 1) * sms;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(p.B) * p.Hkv * p.nsplit;
  const long long blocks = (items + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(blocks < resident[dev] ? blocks : resident[dev]);
  kernel<<<grid, kThreads, C::kSmemBytes, s>>>(p);
  if (p.nsplit > 1) {
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const long long rows = static_cast<long long>(p.B) * p.Hq;
    decode_merge_kernel<D><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                             kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Params& p, cudaStream_t s) {
  const int G = p.Hq / p.Hkv;
  if (G <= 8) return launch_rows<D, 8>(p, s);
  if constexpr (D <= 128) {
    if (G <= 16) return launch_rows<D, 16>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns cudaGetLastError() after the last launch (0 = ok).  q and out are
// bf16 (B, Hq, D) contiguous, the caches bf16 with strides in elements,
// cache_len int32 (B,); window < 0 means none.  nsplit splits of split_len
// keys cover [0, S) (nsplit = ceil(S / split_len)); with nsplit > 1,
// ws_acc holds B * Hq * nsplit * D floats and ws_ml B * Hq * nsplit * 2.
extern "C" int decode_attention_dense(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, int B, int Hq, int Hkv, int S, int D, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, int window, float scale, int nsplit, int split_len,
    void* ws_acc, void* ws_ml, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || nsplit < 1 || split_len < 1 ||
      (nsplit > 1 && (ws_acc == nullptr || ws_ml == nullptr ||
                      static_cast<long long>(nsplit - 1) * split_len >= S ||
                      static_cast<long long>(nsplit) * split_len < S)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.cache_len = static_cast<const int*>(cache_len);
  p.out = static_cast<bf16*>(out);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.S = S; p.window = window;
  p.nsplit = nsplit;
  p.split_len = nsplit == 1 ? (S > split_len ? S : split_len) : split_len;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(p, s);
    case 112: return launch<112>(p, s);
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
