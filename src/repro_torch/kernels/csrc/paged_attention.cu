// Paged attention over the serving arena's page pools, written by hand for
// Hopper (sm_90a), with a plain C interface bound by ctypes
// (kernels/paged_attention.py).
//
// Replaces four Pallas TPU kernels of the reference package,
// src/repro/kernels/decode_attention.py:
//   paged_decode_attention_pallas               :466  (body :425)
//   paged_decode_attention_quant_pallas         :581  (body :538)
//   paged_chunk_prefill_attention_pallas        :305  (body :276, :153)
//   paged_chunk_prefill_attention_quant_pallas  :675  (body :644, :153)
// Two algorithms (one-token decode, chunked prefill), each templated on the
// page type: bf16 pages, or int8 pages with one f32 scale per (token, head).
// Both read the pool in place, (P, bs, Hkv, D) with the caller's strides,
// through the slot's own block-table row; it is never transposed or copied
// (the Pallas wrappers transpose the whole pool on every call), and no key
// at or past the slot's visible range is read: the last tile's rows past it
// are zero-filled, matching the Pallas @pl.when gates.  Rows finalize with
// acc / max(l, 1e-37), so a row that sees no key yields zeros, not NaN.
//
// Decode (paged_decode_kernel).  What bounds it on this card: bytes.  It
// does 4*D flops per (query head, key) against 2*D bytes of bf16 K/V (D
// bytes of int8 and 8 of scales) per (kv head, key): with a query group of
// G heads that is about G flops a byte, far below the ~295 at which the
// H100's tensor cores, not its 3.35 TB/s of HBM, become the limit.  So it
// uses no tensor cores and spends everything on moving each live K/V byte
// once with enough of them in flight; what Hopper gives it is 16-byte
// cp.async and the 50 MB L2 that holds the scale sectors neighbouring heads
// share.  At the serving path's shape (512 slots, 32 live at 26-220 keys,
// 36 heads, G = 1, D = 64) the live work is 1,152 (slot, kv head) items of
// 3-28 KB each beside 17,280 dead ones.
//   * Dead slots cost nothing: a persistent grid (as many 128-thread blocks
//     as the card holds at once) in which every block scans the lengths,
//     512 slots a pass, and compacts the live slots in shared memory; the
//     dead slots' rows are written as zeros with 16-byte stores spread over
//     the grid, and only live items are dealt out, round-robin.
//   * Every warp works at G = 1: the block's 4 warps split each item's
//     tiles (tile t of item k to warp (k + t) mod 4), each with its own
//     online softmax (ex2.approx in the log2 domain).  A warp's partial
//     state goes to one of two merge slots; the item's last warp to arrive
//     merges them in a fixed order (no atomics on data, so repeats are
//     bit-identical), and no block-wide barrier separates items.  The G
//     query heads of a group share each tile, so a GQA group reads its K/V
//     once; per-row registers are sized by G rounded up to a power of two.
//   * Bytes in flight while the math runs: each warp runs one two-stage
//     16-byte cp.async ring of raw K and V tiles on across its items
//     (tile i + 1's copies are issued before tile i's scores), looks up the
//     block-table entry a tile needs one tile earlier still, and loads an
//     item's q while the tile before its first is scored.  A tile is 32
//     tokens (16 of a bf16 row of D = 128, split over 2 lanes), at most 4 KB
//     of K and 4 KB of V; chunks are XOR-swizzled so the lanes' reads are
//     free of bank conflicts.
//   * K and V stay in their stored type until the FMA: bf16 is widened by a
//     shift, int8 by a byte permute (exact).  Each (token, head) scale is
//     copied once: the score takes scale * k_scale once per key, v_scale
//     folds into p after the row sum.
//   * int8 rows of D = 64 are half a 128-byte line and a scale 4 bytes of
//     one, and the lines a warp instruction touches, not its bytes, bound
//     int8 tiles.  So when live slots give every block an item even in
//     pairs (live * Hkv / 2 >= grid; Hkv even, G <= 4), a pass serves kv
//     head pairs: a tile holds 16 tokens of two adjacent heads, one line of
//     K, of V and of scales each a token.  Fewer live slots keep single
//     heads, whose items are half as long.
// Tried side by side on the card and not adopted: the (slot, kv head) grid
// with this body, whose 17,280 dead blocks still cost their dispatch; one
// block-wide barrier per item, with the table row staged in shared memory
// (no overlap between items); head pairs on every pass, and with 8 warps a
// block; a three-stage ring; split score accumulators; other int8
// widenings (shift and mask, I2F).  Not built: splitting a slot's keys
// across blocks, which needs a workspace and a second pass to shorten
// chains of at most 2-4 tiles a warp at the path's shape.  Not done yet:
// int8 at the path's shape is held by its chain of dependent round trips
// (length scan, table entry, tile), not by bytes.
//
// Chunked prefill (paged_chunk_kernel).  At the serving path's shape (one
// slot, at most 128 rows, 36 heads, D = 64, at most 192 visible keys) it is
// bytes-bound too on paper (0.15 GFLOP against ~3.5 MB: ~40 flops a byte),
// but it is small, so what bounds it in practice is latency: the chain of
// steps one block takes.  The design shortens that chain and puts the
// products on the tensor cores, in the shape of the flash forward
// (flash_attention.cu): the body of chunk_tiles.cuh, which the dense chunk
// kernel (chunk_attention.cu) shares, here with keys gathered row by row
// through the slot's block-table row (a 64-key tile may span pages and end
// inside one):
//   * one block per (slot, query head, 64 query rows), 4 warps of 16 rows
//     (phase 3's chunk: 72 blocks for 132 SMs; 32-row blocks of 2 warps,
//     144 blocks, were the slower in a side-by-side build on the H100);
//   * q held as ldmatrix fragments, keys through a two-stage 16-byte
//     cp.async ring, S = Q K^T and O += P V on mma.sync.m16n8k16, the
//     online softmax on the fragments, the element mask only on a tile
//     that crosses an edge;
//   * int8 pages: the raw rows and scales are staged and widened to bf16
//     in shared memory, exactly; k_scale multiplies S's columns and
//     v_scale folds into P after the row sums, so the products are the
//     plain version's dequantize products with only P's rounding to bf16
//     added; the pool never exists in float;
//   * GQA: a block serves one query head and reads its kv head's tiles (a
//     group's heads read them through L2).
// Not done yet: wgmma, TMA, packing a GQA group's heads into one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "chunk_tiles.cuh"

namespace {

// One layer's K and V pools, read in place.  Strides are in elements; the
// head stride is D for values and 1 for scales (checked by the wrapper).
struct Pool {
  const void* k;
  const void* v;
  const float* ks;                        // int8 only: (P, bs, Hkv) scales
  const float* vs;
  long long page_stride, tok_stride;
  long long spage_stride, stok_stride;
  const int* tables;                      // (B, nblk) logical -> physical
  int nblk, bs;
};

// ---------------------------------------------------------------------------
// Decode: a persistent grid over the live (slot, kv head) items
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 4;              // a block's warps
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecStages = 2;             // cp.async ring depth of each warp
constexpr int kMaxGroup = 16;             // query heads per kv head
constexpr int kSlotPass = 512;            // slots one pass of the length scan takes
constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // -0.7 * FLT_MAX

// One instance: page type, head dim D, R, the query group G rounded up to a
// power of two (q rows G .. R-1 of a head are zeros and never written out),
// and H, the kv heads one item serves: 1, or 2 (head pairs) for int8 pages
// of D = 64, whose rows are half a 128-byte line (paged_decode_kernel says
// when).  A token's H rows are adjacent in the pool and stay so in the
// tile.
template <typename PageT, int D, int R, int H>
struct DecodeCfg {
  static constexpr bool kQuant = sizeof(PageT) == 1;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(PageT));
  static constexpr int kVec = 16 / static_cast<int>(sizeof(PageT));  // a chunk
  static constexpr int kChunks = kRowBytes / 16;          // 16-byte chunks a row
  static constexpr int kTokBytes = H * kRowBytes;         // a token's H rows
  static constexpr int kTokChunks = H * kChunks;
  static constexpr int kLanes = 32 / H;                   // lanes serving a head
  // lanes that score one key: a bf16 row of D = 128 is split over 2 lanes,
  // so that a tile is at most 4 KB of K and 4 KB of V
  static constexpr int kLpk = kRowBytes > 128 ? 2 : 1;
  static constexpr int kKeys = kLanes / kLpk;             // tokens a warp tile
  static constexpr int kLaneChunks = kChunks / kLpk;      // chunks a lane scores
  static constexpr int kIssue = kKeys * kTokChunks / 32;  // copies a lane issues
  // P V: a lane owns kOwn dims of its head's output; kLpr lanes cover a V
  // row, so one warp-wide read covers kKpr tokens of each head
  static constexpr int kLpr = R <= 4 ? D / 8 : kLanes;
  static constexpr int kOwn = D / kLpr;
  static constexpr int kKpr = kLanes / kLpr;
  static constexpr int kRows = H * R;                     // q rows a warp holds
  static constexpr int kQld = D + 4 * (kLpk - 1);        // q row stride (f32)
  static constexpr int kPart = kRows * D + 2 * kRows;     // acc, then m, l
  static constexpr int kTileBytes = kKeys * kTokBytes;
  static constexpr int kScales = kQuant ? 2 * kKeys * H : 0;   // f32 a stage
  static constexpr int kStageBytes = 2 * kTileBytes + 4 * kScales;
  static constexpr int kWarpBytes = kDecStages * kStageBytes;
  static constexpr int kRingBytes = kDecWarps * kWarpBytes;
  static_assert(kTokChunks == 4 || kTokChunks == 8 || kTokChunks == 16, "row size");
  static_assert(kLpk == 1 || H == 1, "a split row serves one head");
  static_assert(H == 1 || (R <= 4 && kRowBytes == 64), "head pairs: 64-byte rows");
};

// The kernel's shared memory, for single heads and, with kPairs, head pairs
// too (a pass takes one or the other): each warp's ring, each warp's q
// rows, two merge slots of the warps' partial states, the pass's slot
// lists and the counters.  A head-pair stage holds as many bytes as a
// single-head one (half the tokens, two rows each).
template <typename PageT, int D, int R, bool kPairs>
struct DecodeSmem {
  using C1 = DecodeCfg<PageT, D, R, 1>;
  using C2 = DecodeCfg<PageT, D, R, kPairs ? 2 : 1>;
  static_assert(C1::kWarpBytes == C2::kWarpBytes, "one ring for both");
  static constexpr int kQFloats = C2::kRows * C2::kQld;      // a warp's q rows
  static constexpr int kPart = C2::kPart;                    // a warp's partials
  static constexpr int kBytes = C1::kRingBytes + kDecWarps * kQFloats * 4 +
                                2 * kDecWarps * kPart * 4 +
                                (2 * kSlotPass + kDecWarps + 4) * 4;
};

// Where 16-byte chunk c of tile token r lies: chunks are XOR-swizzled within
// the token's rows so that 8 lanes reading 8 tokens' chunk c, or one
// token's 8 chunks, hit 8 distinct bank groups.  For head pairs of 64-byte
// rows (8 chunks a token) the key also flips the row halves between
// neighbouring tokens, so that 16 lanes reading one head's rows of two
// tokens (8 bytes each) do not conflict either.
template <int kTokChunks, int H>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (H == 2 && kTokChunks == 8)
    return c ^ (((r >> 1) & 3) | ((r & 1) << 2));
  constexpr int kShift = kTokChunks >= 8 ? 0 : 1;
  return c ^ ((r >> kShift) & (kTokChunks - 1));
}

// int8 byte k of w as a float, exactly: (b + 128) + 2^23 is a float whose
// mantissa is b + 128
__device__ __forceinline__ float int8_at(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | k)) -
         8388736.f;
}

// N elements of PageT packed in 32-bit words, widened to f32
template <typename PageT, int N>
__device__ __forceinline__ void widen_words(const uint32_t* w, float* f) {
  if constexpr (sizeof(PageT) == 2) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = int8_at(w[i / 4], i % 4);
  }
}

// N elements of PageT from shared memory (N * sizeof(PageT) bytes, aligned
// to that size, at most 16), widened to f32
template <typename PageT, int N>
__device__ __forceinline__ void load_widen(const unsigned char* p, float* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(PageT));
  uint32_t w[kBytes >= 4 ? kBytes / 4 : 1];
  if constexpr (kBytes == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (kBytes == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else if constexpr (kBytes == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
  widen_words<PageT, N>(w, f);
}

// 8-byte global -> shared copy; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// max and sum over groups of W lanes (W a power of two, the group's lanes
// adjacent)
template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The online-softmax state of one warp for its current item: per row of
// the lane's head, the running max m (log2 domain, equal in the head's
// lanes), this lane's share of the row sum l, and this lane's kOwn output
// dims (a partial sum over the lanes that share them).
template <typename PageT, int D, int R, int H>
struct WarpState {
  float m[R], l[R], acc[R][DecodeCfg<PageT, D, R, H>::kOwn];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < DecodeCfg<PageT, D, R, H>::kOwn; ++e) acc[r][e] = 0.f;
    }
  }
};

// A place in a warp's stream of tiles: tile t (tokens t * kKeys ..) of the
// block's k-th item of the pass, which serves slot b, kv heads kvh ..
// kvh + H - 1, keys [0, kend); k < 0 past the end.
struct Pos {
  int k, t, b, kvh, kend;
};

// The block's items of one pass of the length scan: the live items j of
// [first, end) of the launch's (live slot, kv head group) order with j =
// start (mod grid); item k is j = start + k * grid.  Tile t of item k
// belongs to warp (k + t) mod 4, so that one-tile items do not all fall
// to warp 0.
struct Items {
  const int* slot;                        // the pass's live slots
  const int* slen;                        // and their visible lengths
  long long first, end, start, grid;
  int groups, H;                          // kv head groups a slot, heads a group
};

template <int kKeys>
__device__ __forceinline__ int ntiles(int kend) {
  return (kend + kKeys - 1) / kKeys;
}

// The first place at or after item k where warp w has a tile.
template <int kKeys>
__device__ __forceinline__ Pos first_tile(const Items& it, int k, int w) {
  for (;; ++k) {
    const long long j = it.start + k * it.grid;
    if (j >= it.end) return Pos{-1, 0, 0, 0, 0};
    const int jl = static_cast<int>(j - it.first), s = jl / it.groups;
    const int t = (w - k) & (kDecWarps - 1);
    if (t < ntiles<kKeys>(it.slen[s]))
      return Pos{k, t, it.slot[s], (jl % it.groups) * it.H, it.slen[s]};
  }
}

template <int kKeys>
__device__ __forceinline__ Pos next_tile(const Items& it, Pos p, int w) {
  if (p.k < 0) return p;
  if (p.t + kDecWarps < ntiles<kKeys>(p.kend)) {
    p.t += kDecWarps;
    return p;
  }
  return first_tile<kKeys>(it, p.k + 1, w);
}

// The page of token t * kKeys + lane % kKeys of tile p (its block-table
// entry), or 0 past the visible keys.
template <int kKeys>
__device__ __forceinline__ int load_page(const Pool& pool, const Pos& p) {
  const int kpos = p.t * kKeys + (threadIdx.x & 31) % kKeys;
  if (p.k < 0 || kpos >= p.kend) return 0;
  return __ldg(pool.tables + static_cast<long long>(p.b) * pool.nblk + kpos / pool.bs);
}

// Issue the copies of tile p into ``stage``, one stage of this warp's
// ring: the raw K and V rows of its tokens' H heads, and for int8 their
// scales; tokens at or past kend are zero-filled and read nothing.
// ``page`` is the page of token lane % kKeys (load_page).
template <typename PageT, int D, int R, int H>
__device__ __forceinline__ void issue_tile(unsigned char* stage,
                                           const Pool& pool, const Pos& p,
                                           int page) {
  using C = DecodeCfg<PageT, D, R, H>;
  const int lane = threadIdx.x & 31;
  const int t0 = p.t * C::kKeys;
  // lane finds token lane % kKeys's row offset once; the lanes that copy a
  // token's chunks take it by shuffle
  const int kpos = t0 + lane % C::kKeys;
  long long roff = 0, soff = 0;
  if (kpos < p.kend) {
    const long long off = kpos % pool.bs;
    roff = page * pool.page_stride + off * pool.tok_stride;
    if constexpr (C::kQuant)
      soff = page * pool.spage_stride + off * pool.stok_stride + p.kvh;
  }
  const PageT* kb = static_cast<const PageT*>(pool.k) + p.kvh * D;
  const PageT* vb = static_cast<const PageT*>(pool.v) + p.kvh * D;
  unsigned char* sk = stage;
  unsigned char* sv = stage + C::kTileBytes;
#pragma unroll
  for (int i = 0; i < C::kIssue; ++i) {
    const int idx = i * 32 + lane, r = idx / C::kTokChunks, c = idx % C::kTokChunks;
    const long long ro = __shfl_sync(0xffffffffu, roff, r);
    const bool rok = t0 + r < p.kend;
    const int dst = r * C::kTokBytes + swz<C::kTokChunks, H>(r, c) * 16;
    cp_async16(sk + dst, rok ? kb + ro + c * C::kVec : kb, rok ? 16 : 0);
    cp_async16(sv + dst, rok ? vb + ro + c * C::kVec : vb, rok ? 16 : 0);
  }
  if constexpr (C::kQuant) {
    // [K, V][token][head]: lane i copies token i % kKeys's H scales of K
    // (i < kKeys) or of V
    float* sks = reinterpret_cast<float*>(stage + 2 * C::kTileBytes);
#pragma unroll
    for (int i = lane; i < 2 * C::kKeys; i += 32) {
      const int r = i % C::kKeys;
      const long long so = __shfl_sync(0xffffffffu, soff, r);
      const bool rok = t0 + r < p.kend;
      const float* src = (i < C::kKeys ? pool.ks : pool.vs);
      if constexpr (H == 2)
        cp_async8(sks + i * 2, rok ? src + so : src, rok ? 8 : 0);
      else
        cp_async4(sks + i, rok ? src + so : src, rok ? 4 : 0);
    }
  }
}

// Tile p (tokens t0 = p.t * kKeys ..) from ``stage`` into this warp's state.
// Lane = hh * kLanes + key * kLpk + half scores token key of head hh
// against the head's R rows of q, then the online-softmax update over the
// head's lanes, then P V.
template <typename PageT, int D, int R, int H>
__device__ __forceinline__ void attend_tile(const unsigned char* stage,
                                            const float* sq, const Pos& p,
                                            int G, float scale_log2,
                                            WarpState<PageT, D, R, H>& w) {
  using C = DecodeCfg<PageT, D, R, H>;
  const int lane = threadIdx.x & 31;
  const int hh = lane / C::kLanes;
  const int key = lane % C::kLanes / C::kLpk, half = lane % C::kLpk;
  const int t0 = p.t * C::kKeys;
  const bool ok = t0 + key < p.kend;
  const unsigned char* sk = stage;
  const unsigned char* sv = stage + C::kTileBytes;

  // 1. scores: this lane's chunks of its token's K row against q.  The two
  //    halves of a split row walk their chunks in orders 4 apart, and q's
  //    second half sits 16 bytes further on, so neither read conflicts.
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  const unsigned char* krow = sk + key * C::kTokBytes;
  const float* qh = sq + hh * R * C::kQld + 4 * half;
#pragma unroll
  for (int i = 0; i < C::kLaneChunks; ++i) {
    const int c = half * C::kLaneChunks + (i ^ ((half * 4) & (C::kLaneChunks - 1)));
    float kf[C::kVec];
    load_widen<PageT, C::kVec>(
        krow + swz<C::kTokChunks, H>(key, hh * C::kChunks + c) * 16, kf);
    const float* qc = qh + c * C::kVec;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < C::kVec; ++e) s[r] = fmaf(qc[r * C::kQld + e], kf[e], s[r]);
  }
  if constexpr (C::kLpk == 2) {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
  }

  // 2. the online-softmax update, row by row (the order of the Pallas
  //    tile: mask, max, rescale, sum); p carries v_scale into P V
  float mult = scale_log2, vsc = 1.f;
  if constexpr (C::kQuant) {
    const float* sks = reinterpret_cast<const float*>(stage + 2 * C::kTileBytes);
    mult *= sks[key * H + hh];
    vsc = sks[(C::kKeys + key) * H + hh];
  }
  float pv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    pv[r] = 0.f;
    if (r < G) {
      const float x = ok ? s[r] * mult : kNegInf;
      const float m_new = fmaxf(w.m[r], group_max<C::kLanes>(x));
      const float alpha = exp2_approx(w.m[r] - m_new);
      const float pr = ok ? exp2_approx(x - m_new) : 0.f;
      w.l[r] = w.l[r] * alpha + (half == 0 ? pr : 0.f);
      w.m[r] = m_new;
#pragma unroll
      for (int e = 0; e < C::kOwn; ++e) w.acc[r][e] *= alpha;
      pv[r] = pr * vsc;
    }
  }

  // 3. acc += p V: this lane's kOwn dims of head hh's V rows of tokens
  //    j = jj * kKpr + (lane % kLanes) / kLpr
  const int ll = lane % C::kLanes;
  const int db = (ll % C::kLpr) * C::kOwn;
#pragma unroll
  for (int jj = 0; jj < C::kKeys / C::kKpr; ++jj) {
    const int j = jj * C::kKpr + ll / C::kLpr;
    float vf[C::kOwn];
    load_widen<PageT, C::kOwn>(
        sv + j * C::kTokBytes +
            swz<C::kTokChunks, H>(j, hh * C::kChunks + db / C::kVec) * 16 +
            (db % C::kVec) * static_cast<int>(sizeof(PageT)),
        vf);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < G) {
        const float pj = __shfl_sync(0xffffffffu, pv[r], hh * C::kLanes + j * C::kLpk);
#pragma unroll
        for (int e = 0; e < C::kOwn; ++e) w.acc[r][e] = fmaf(pj, vf[e], w.acc[r][e]);
      }
    }
  }
}

// An item's q rows as 16-byte vectors in this warp's registers, in the
// order of the warp's f32 copy (head hh's row r at row hh * R + r, rows
// r >= G zeros): vector c = i * 32 + lane in qr[i]
template <typename PageT, int D, int R, int H>
__device__ __forceinline__ void load_q(
    uint4 (&qr)[(DecodeCfg<PageT, D, R, H>::kRows * D / 8 + 31) / 32],
    const bf16* q, const Pos& p, int G, int Hq) {
  constexpr int kV = D / 8;                       // vectors a row
  const int lane = threadIdx.x & 31;
  const uint4* src = reinterpret_cast<const uint4*>(
      q + (static_cast<long long>(p.b) * Hq + static_cast<long long>(p.kvh) * G) * D);
#pragma unroll
  for (int i = 0; i < (H * R * kV + 31) / 32; ++i) {
    const int c = i * 32 + lane, row = c / kV, hh = row / R, r = row % R;
    qr[i] = c < H * R * kV && r < G ? __ldg(src + (hh * G + r) * kV + c % kV)
                                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The q rows into this warp's f32 copy (q's second half 16 bytes on when a
// key's row is split over two lanes)
template <typename PageT, int D, int R, int H>
__device__ __forceinline__ void store_q(
    float* sq, const uint4 (&qr)[(DecodeCfg<PageT, D, R, H>::kRows * D / 8 + 31) / 32]) {
  using C = DecodeCfg<PageT, D, R, H>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < (C::kRows * D / 8 + 31) / 32; ++i) {
    const int c = i * 32 + lane;
    if (c < C::kRows * D / 8) {
      const uint32_t w[4] = {qr[i].x, qr[i].y, qr[i].z, qr[i].w};
      float f[8];
      widen_words<bf16, 8>(w, f);
      const int row = c / (D / 8), d = (c % (D / 8)) * 8;
      float* dst = sq + row * C::kQld + d + (C::kLpk == 2 && d >= D / 2 ? 4 : 0);
      reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// This warp is done with its tiles of item p.k: its partial state goes to
// the item's merge slot, and the last of the item's warps to arrive merges
// them into the H * G output rows.  Merge slots alternate by item parity; a
// slot is reused by item k + 2 only after item k's merge (gen), so no
// block-wide barrier is needed between items.
template <typename PageT, int D, int R, int H, int kPart>
__device__ __forceinline__ void finish_item(float* merge, int* done, int* gen,
                                            const Pos& p, int G, int Hq,
                                            bf16* out,
                                            WarpState<PageT, D, R, H>& w) {
  using C = DecodeCfg<PageT, D, R, H>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hh = lane / C::kLanes, ll = lane % C::kLanes;
  const int slotp = p.k & 1;
  // the row sums over the head's lanes; each output dim over the lanes
  // sharing it
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= G) break;
    w.l[r] = group_sum<C::kLanes>(w.l[r]);
#pragma unroll
    for (int e = 0; e < C::kOwn; ++e)
#pragma unroll
      for (int o = C::kLpr; o < C::kLanes; o <<= 1)
        w.acc[r][e] += __shfl_xor_sync(0xffffffffu, w.acc[r][e], o);
  }
  if (lane == 0) {
    const volatile int* g = gen;
    while (g[slotp] != p.k) __nanosleep(32);
  }
  __syncwarp();
  float* part = merge + (slotp * kDecWarps + warp) * kPart;
  const int db = (ll % C::kLpr) * C::kOwn;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= G) break;
    if (ll < C::kLpr) {
#pragma unroll
      for (int e = 0; e < C::kOwn; ++e) part[(hh * R + r) * D + db + e] = w.acc[r][e];
    }
    if (ll == 0) {
      part[C::kRows * D + hh * R + r] = w.m[r];
      part[C::kRows * D + C::kRows + hh * R + r] = w.l[r];
    }
  }
  __threadfence_block();
  __syncwarp();
  const int nw = min(kDecWarps, ntiles<C::kKeys>(p.kend));
  int last = 0;
  if (lane == 0) last = atomicAdd(done + slotp, 1) == nw - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence_block();
  // the merge, in the fixed order of the warps: warp v took tiles
  // t = (v - k) mod 4 + 4i, so it holds a partial iff that t < ntiles
  const float* mp = merge + slotp * kDecWarps * kPart;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
      out + (static_cast<long long>(p.b) * Hq + static_cast<long long>(p.kvh) * G) * D);
  for (int c = lane; c < H * G * D / 2; c += 32) {
    const int o = 2 * c / D, d = 2 * c % D;
    const int row = o / G * R + o % G;            // head o / G, its row o % G
    float mx = kNegInf;
#pragma unroll
    for (int v = 0; v < kDecWarps; ++v)
      if (((v - p.k) & (kDecWarps - 1)) < nw)
        mx = fmaxf(mx, mp[v * kPart + C::kRows * D + row]);
    float lsum = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int v = 0; v < kDecWarps; ++v) {
      if (((v - p.k) & (kDecWarps - 1)) >= nw) continue;
      const float* pw = mp + v * kPart;
      const float f = exp2_approx(pw[C::kRows * D + row] - mx);
      lsum += pw[C::kRows * D + C::kRows + row] * f;
      a0 += pw[row * D + d] * f;
      a1 += pw[row * D + d + 1] * f;
    }
    const float den = fmaxf(lsum, 1e-37f);
    o2[c] = __floats2bfloat162_rn(a0 / den, a1 / den);
  }
  __syncwarp();
  if (lane == 0) {
    done[slotp] = 0;
    __threadfence_block();
    *static_cast<volatile int*>(gen + slotp) = p.k + 2;
  }
}

// One warp's stream: its tiles of the block's items in order, through a
// two-stage cp.async ring that runs on across items.  Tile i + 1's copies
// are in flight while tile i is scored, tile i + 2's table entries one
// step earlier, and an item's q rows are loaded while the tile before its
// first is scored.
template <typename PageT, int D, int R, int H, int kPart>
__device__ __forceinline__ void warp_stream(unsigned char* ring, float* sq,
                                            float* merge, int* done, int* gen,
                                            const Items& it, const bf16* q,
                                            bf16* out, const Pool& pool,
                                            int G, int Hq, float scale_log2) {
  using C = DecodeCfg<PageT, D, R, H>;
  const int warp = threadIdx.x >> 5;
  Pos cur = first_tile<C::kKeys>(it, 0, warp);
  if (cur.k < 0) return;
  Pos nxt = next_tile<C::kKeys>(it, cur, warp);
  Pos nx2 = next_tile<C::kKeys>(it, nxt, warp);
  uint4 qr[(C::kRows * D / 8 + 31) / 32];
  load_q<PageT, D, R, H>(qr, q, cur, G, Hq);
  issue_tile<PageT, D, R, H>(ring, pool, cur, load_page<C::kKeys>(pool, cur));
  cp_async_commit();
  int page = load_page<C::kKeys>(pool, nxt);
  WarpState<PageT, D, R, H> w;
  w.reset();
  for (int st = 0; cur.k >= 0; st ^= 1) {
    if (nxt.k >= 0)
      issue_tile<PageT, D, R, H>(ring + (st ^ 1) * C::kStageBytes, pool, nxt, page);
    cp_async_commit();
    page = load_page<C::kKeys>(pool, nx2);
    if (cur.t < kDecWarps) {              // this warp's first tile of the item
      store_q<PageT, D, R, H>(sq, qr);
      __syncwarp();
    }
    if (nxt.k >= 0 && nxt.t < kDecWarps) load_q<PageT, D, R, H>(qr, q, nxt, G, Hq);
    cp_async_wait<1>();
    __syncwarp();
    attend_tile<PageT, D, R, H>(ring + st * C::kStageBytes, sq, cur, G,
                                scale_log2, w);
    __syncwarp();
    if (cur.t + kDecWarps >= ntiles<C::kKeys>(cur.kend)) {
      finish_item<PageT, D, R, H, kPart>(merge, done, gen, cur, G, Hq, out, w);
      w.reset();
    }
    cur = nxt;
    nxt = nx2;
    nx2 = next_tile<C::kKeys>(it, nx2, warp);
  }
  cp_async_wait<0>();
}

// Decode: query heads kvh*G .. kvh*G+G-1 of slot b attend to keys
// [0, min(cache_len[b], nblk * bs)).  A persistent grid: every block scans
// the lengths (kSlotPass slots a pass), zero-fills its share of the dead
// slots' rows, and serves the live items j = blockIdx.x (mod gridDim.x) of
// the launch's (live slot, kv head group) order, each warp its share of
// their tiles.  With kPairs, a pass serves head pairs when they still give
// every block an item (live * Hkv / 2 >= gridDim.x), single heads when
// not: pairs halve the lines an int8 tile touches, single heads halve each
// item's chain of tiles.
template <typename PageT, int D, int R, bool kPairs>
__global__ void __launch_bounds__(kDecThreads, 1)
paged_decode_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                    Pool pool, const int* __restrict__ cache_len, int B,
                    int Hq, int Hkv, float scale_log2) {
  using S = DecodeSmem<PageT, D, R, kPairs>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem + S::C1::kRingBytes);
  float* merge = sq + kDecWarps * S::kQFloats;
  int* slot = reinterpret_cast<int*>(merge + 2 * kDecWarps * S::kPart);
  int* slen = slot + kSlotPass;            // the live slots' visible lengths
  int* nwarp = slen + kSlotPass;           // live slots a warp found
  int* done = nwarp + kDecWarps;           // warps done with the item, by parity
  int* gen = done + 2;                     // the item a merge slot is free for
  constexpr int kPer = kSlotPass / kDecThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = Hq / Hkv, limit = pool.nblk * pool.bs;
  const long long vecs = static_cast<long long>(Hq) * D / 8;   // 16 B a slot
  const long long grid = gridDim.x;
  long long before = 0;                    // live slots of earlier passes
  for (int s0 = 0; s0 < B; s0 += kSlotPass) {
    const int n = min(kSlotPass, B - s0);
    if (tid < 2) {
      done[tid] = 0;
      gen[tid] = tid;
    }
    // 1. this pass's live slots, compacted in slot order (live ones from
    //    the front of ``slot``, dead ones from the back)
    int len[kPer], cnt = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = tid * kPer + i;
      len[i] = s < n ? min(__ldg(cache_len + s0 + s), limit) : 0;
      cnt += len[i] > 0;
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) nwarp[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, live = 0;
#pragma unroll
    for (int v = 0; v < kDecWarps; ++v) {
      pos += v < warp ? nwarp[v] : 0;
      live += nwarp[v];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = tid * kPer + i;
      if (s < n && len[i] > 0) {
        slot[pos] = s0 + s;
        slen[pos++] = len[i];
      } else if (s < n) {
        slot[kSlotPass - 1 - (s - pos)] = s0 + s;
      }
    }
    __syncthreads();
    // 2. dead slots' rows: zeros, 16-byte stores over the whole grid
    const long long zeros = (n - live) * vecs;
    for (long long i = blockIdx.x * static_cast<long long>(kDecThreads) + tid;
         i < zeros; i += grid * kDecThreads) {
      const long long d = i / vecs;
      reinterpret_cast<uint4*>(out + slot[kSlotPass - 1 - d] * vecs * 8)[i - d * vecs] =
          make_uint4(0u, 0u, 0u, 0u);
    }
    // 3. live items, dealt round-robin over the grid
    const bool pairs = kPairs && static_cast<long long>(live) * (Hkv / 2) >= grid;
    Items it;
    it.slot = slot;
    it.slen = slen;
    it.H = pairs ? 2 : 1;
    it.groups = Hkv / it.H;
    it.first = before * it.groups;
    it.end = it.first + static_cast<long long>(live) * it.groups;
    it.start = it.first + (blockIdx.x - it.first % grid + grid) % grid;
    it.grid = grid;
    unsigned char* ring = smem + warp * S::C1::kWarpBytes;
    float* wq = sq + warp * S::kQFloats;
    if constexpr (kPairs) {
      if (pairs)
        warp_stream<PageT, D, R, 2, S::kPart>(ring, wq, merge, done, gen, it,
                                              q, out, pool, G, Hq, scale_log2);
    }
    if (!pairs)
      warp_stream<PageT, D, R, 1, S::kPart>(ring, wq, merge, done, gen, it, q,
                                            out, pool, G, Hq, scale_log2);
    before += live;
    __syncthreads();                       // every item merged; lists rebuilt next
  }
}

// ---------------------------------------------------------------------------
// Chunked prefill on the tensor cores: the body of chunk_tiles.cuh, with
// keys gathered through the slot's block-table row
// ---------------------------------------------------------------------------

// The pages of one (slot, kv head): key kpos lies at offset kpos % bs of
// page table[kpos / bs], read through the kernel's ``Pool`` argument.
template <typename PageT, int D>
struct PagedKeys {
  typedef PageT T;
  const Pool& pool;
  int b, kvh;

  __device__ __forceinline__ long long page(int kpos) const {
    return pool.tables[static_cast<long long>(b) * pool.nblk + kpos / pool.bs];
  }
  __device__ __forceinline__ void rows(int kpos, const PageT** kr,
                                       const PageT** vr) const {
    const long long e = page(kpos) * pool.page_stride +
                        (kpos % pool.bs) * pool.tok_stride + kvh * D;
    *kr = static_cast<const PageT*>(pool.k) + e;
    *vr = static_cast<const PageT*>(pool.v) + e;
  }
  __device__ __forceinline__ void scales(int kpos, const float** kr,
                                         const float** vr) const {
    const long long e = page(kpos) * pool.spage_stride +
                        (kpos % pool.bs) * pool.stok_stride + kvh;
    *kr = pool.ks + e;
    *vr = pool.vs + e;
  }
  __device__ __forceinline__ const PageT* any() const {
    return static_cast<const PageT*>(pool.k);
  }
  __device__ __forceinline__ const float* any_scale() const { return pool.ks; }
};

template <typename PageT, int D>
__global__ void __launch_bounds__(kChunkThreads)
paged_chunk_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                   Pool pool, const int* __restrict__ start,
                   const int* __restrict__ chunk_len, int T, int Hq, int Hkv,
                   int prefix_len, float scale) {
  const int b = blockIdx.x;
  const PagedKeys<PageT, D> src{pool, b, static_cast<int>(blockIdx.y) / (Hq / Hkv)};
  chunk_tile<D>(q, out, src, start[b], chunk_len[b], pool.nblk * pool.bs, T,
                Hq, prefix_len, scale);
}

Pool make_pool(const void* kp, const void* vp, const void* ks, const void* vs,
               const void* tables, int nblk, int bs, long long page_stride,
               long long tok_stride, long long spage_stride,
               long long stok_stride) {
  Pool p;
  p.k = kp;
  p.v = vp;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.page_stride = page_stride;
  p.tok_stride = tok_stride;
  p.spage_stride = spage_stride;
  p.stok_stride = stok_stride;
  p.tables = static_cast<const int*>(tables);
  p.nblk = nblk;
  p.bs = bs;
  return p;
}

template <typename PageT, int D, int R, bool kPairs>
int launch_decode_rows(const bf16* q, bf16* out, const Pool& pool,
                       const int* lens, int B, int Hq, int Hkv, float scale,
                       cudaStream_t s) {
  constexpr int kBytes = DecodeSmem<PageT, D, R, kPairs>::kBytes;
  auto kernel = paged_decode_kernel<PageT, D, R, kPairs>;
  static unsigned long long opted = 0;       // bit per device ordinal
  static int resident[64] = {};              // blocks a card holds at once
  cudaError_t err = opt_in(kernel, kBytes, &opted);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kDecThreads, kBytes);
    if (err == cudaSuccess) resident[dev] = (per_sm > 1 ? per_sm : 1) * sms;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(B) * Hkv;
  const int grid = static_cast<int>(items < resident[dev] ? items : resident[dev]);
  kernel<<<grid, kDecThreads, kBytes, s>>>(q, out, pool, lens, B, Hq, Hkv,
                                           scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Head pairs (H = 2) may serve int8 pages of D = 64 when Hkv is even, G <= 4
// and the scales sit on 8 bytes (a pair's two scales are one 8-byte copy).
template <typename PageT, int D>
int launch_decode_d(const bf16* q, bf16* out, const Pool& pool,
                    const int* lens, int B, int Hq, int Hkv, float scale,
                    cudaStream_t s) {
  const int G = Hq / Hkv;
  const bool pairs = sizeof(PageT) == 1 && D == 64 && Hkv % 2 == 0 && G <= 4 &&
                     (reinterpret_cast<uintptr_t>(pool.ks) |
                      reinterpret_cast<uintptr_t>(pool.vs)) % 8 == 0;
#define ROWS(R, P)                                                           \
  if (G <= R)                                                                \
    return launch_decode_rows<PageT, D, R, P>(q, out, pool, lens, B, Hq,     \
                                              Hkv, scale, s);
  if constexpr (sizeof(PageT) == 1 && D == 64) {
    if (pairs) { ROWS(1, true) ROWS(2, true) ROWS(4, true) }
  }
  ROWS(1, false) ROWS(2, false) ROWS(4, false) ROWS(8, false) ROWS(16, false)
#undef ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename PageT>
int launch_decode(const void* q, void* out, const Pool& pool,
                  const void* cache_len, int B, int Hq, int Hkv, int D,
                  float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const bf16*>(q);
  auto* oo = static_cast<bf16*>(out);
  const auto* lens = static_cast<const int*>(cache_len);
  if (D == 64)
    return launch_decode_d<PageT, 64>(qq, oo, pool, lens, B, Hq, Hkv, scale, s);
  if (D == 128)
    return launch_decode_d<PageT, 128>(qq, oo, pool, lens, B, Hq, Hkv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename PageT, int D>
int launch_chunk_d(const bf16* q, bf16* out, const Pool& pool, const int* st,
                   const int* cl, int B, int T, int Hq, int Hkv,
                   int prefix_len, float scale, cudaStream_t s) {
  static unsigned long long opted = 0;       // bit per device ordinal
  return launch_chunk_grid<PageT, D>(paged_chunk_kernel<PageT, D>, &opted, B,
                                     T, Hq, s, q, out, pool, st, cl, T, Hq,
                                     Hkv, prefix_len, scale);
}

template <typename PageT>
int launch_chunk(const void* q, void* out, const Pool& pool,
                 const void* start, const void* chunk_len, int B, int T,
                 int Hq, int Hkv, int D, int prefix_len, float scale,
                 void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const bf16*>(q);
  auto* oo = static_cast<bf16*>(out);
  const auto* st = static_cast<const int*>(start);
  const auto* cl = static_cast<const int*>(chunk_len);
  if (D == 64)
    return launch_chunk_d<PageT, 64>(qq, oo, pool, st, cl, B, T, Hq, Hkv,
                                     prefix_len, scale, s);
  if (D == 128)
    return launch_chunk_d<PageT, 128>(qq, oo, pool, st, cl, B, T, Hq, Hkv,
                                      prefix_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// q/out are bf16; tables, cache_len, start and chunk_len are int32.

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* cache_len, void* out, int B, int Hq,
    int Hkv, int D, int bs, int nblk, long long page_stride,
    long long tok_stride, float scale, void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, nullptr, nullptr, tables, nblk,
                              bs, page_stride, tok_stride, 0, 0);
  return launch_decode<__nv_bfloat16>(q, out, pool, cache_len, B, Hq, Hkv, D,
                                      scale, stream);
}

extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* cache_len, void* out, int B, int Hq, int Hkv, int D, int bs,
    int nblk, long long page_stride, long long tok_stride,
    long long spage_stride, long long stok_stride, float scale,
    void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, k_scales, v_scales, tables,
                              nblk, bs, page_stride, tok_stride, spage_stride,
                              stok_stride);
  return launch_decode<int8_t>(q, out, pool, cache_len, B, Hq, Hkv, D, scale,
                               stream);
}

extern "C" int paged_chunk_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* start, const void* chunk_len, void* out,
    int B, int T, int Hq, int Hkv, int D, int bs, int nblk,
    long long page_stride, long long tok_stride, int prefix_len, float scale,
    void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, nullptr, nullptr, tables, nblk,
                              bs, page_stride, tok_stride, 0, 0);
  return launch_chunk<__nv_bfloat16>(q, out, pool, start, chunk_len, B, T, Hq,
                                     Hkv, D, prefix_len, scale, stream);
}

extern "C" int paged_chunk_attention_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* start, const void* chunk_len, void* out, int B, int T,
    int Hq, int Hkv, int D, int bs, int nblk, long long page_stride,
    long long tok_stride, long long spage_stride, long long stok_stride,
    int prefix_len, float scale, void* stream) {
  const Pool pool = make_pool(k_pages, v_pages, k_scales, v_scales, tables,
                              nblk, bs, page_stride, tok_stride, spage_stride,
                              stok_stride);
  return launch_chunk<int8_t>(q, out, pool, start, chunk_len, B, T, Hq, Hkv, D,
                              prefix_len, scale, stream);
}
