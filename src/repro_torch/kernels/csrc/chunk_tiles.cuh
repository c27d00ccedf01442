// The chunked-prefill attention body on the tensor cores, shared by the
// paged chunk kernels (paged_attention.cu: bf16 and int8 pages, gathered
// through a block-table row) and the dense chunk kernel
// (chunk_attention.cu: a (B, S, Hkv, D) cache read in place).  The body is
// a template over its key source, which says where key kpos's K and V rows
// (and, for int8 pages, their f32 scales) lie; everything else, the tiles,
// the order of the sums and the masks, is one code.  So the dense kernel
// on a dense view of the pages computes what the paged kernel computes,
// bit for bit.
//
// The function: block (slot b, query head h, tile z of 64 rows), warp w
// serving rows 16 w .. 16 w + 15 of the tile; row i sits at absolute
// position start[b] + i and is alive iff i < chunk_len[b].  It sees a key
// at kpos iff (kpos <= start + i or kpos < prefix_len) and
// kpos < min(start + chunk_len, limit), where ``limit`` is the source's
// end (the table's end, or S).  Dead rows are zeros.  Rows finalize with
// O / max(l, 1e-37), so a row that sees no key yields zeros, not NaN.
//
// The design (see paged_attention.cu's note for what bounds it):
//   * 4 warps of 16 query rows; a tile whose rows are all dead writes
//     zeros and returns before it reads anything;
//   * the live rows of q are copied once by 16-byte cp.async and held as
//     ldmatrix A fragments;
//   * keys come 64 at a time, row by row from the source with 16-byte
//     cp.async, through a two-stage ring: tile j + 1's copy is issued
//     before tile j's products; no key at or past the visible end is read
//     (the stager zero-fills instead);
//   * S = Q K^T and O += P V on mma.sync.m16n8k16 bf16 -> f32, the online
//     softmax on the accumulator fragments (ex2.approx in the log2
//     domain), the element mask only on a tile that crosses an edge; P is
//     rounded to bf16 for P V, the row sums taken from the f32 P;
//   * int8 pages: the raw int8 K and V rows and their f32 scales are staged
//     (cp.async, 16 and 4 bytes), then widened to bf16 in shared memory,
//     exactly (|v| <= 127); S's column j is multiplied by k_scale[j] in f32
//     after Q K^T, and v_scale[j] folds into P's column j after the row
//     sums and before P is rounded to bf16.
//
// A key source provides ``T`` (bf16, or int8 for quantized pages) and
//   rows(kpos, &k, &v): the first element of key kpos's K and V rows;
//   scales(kpos, &ks, &vs): for int8 only, where its two f32 scales lie;
//   any(), any_scale(): addresses that are safe to name in a zero-byte
//   copy.
// It reads the kernel's own arguments (parameter space) where it can and
// keeps only the slot and the head in registers: a source that held its
// pointers and strides in registers kept ~10 more live across the key
// loop, and at D = 128 ptxas then fed Q K^T's ldmatrix loads through one
// register group, one at a time, which slowed the paged kernel on the
// H100 more than this form does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kChunkWarps = 4;            // each serves 16 query rows
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kChunkRows = 16 * kChunkWarps;   // query rows a block serves
constexpr int kChunkKeys = 64;            // keys per staged tile

template <typename PageT, int D>
struct ChunkCfg {
  static constexpr bool kQuant = sizeof(PageT) == 1;
  static constexpr int LD = D + kPad;                    // bf16 tile row stride
  static constexpr int kTile = kChunkKeys * LD;          // bf16 per K or V tile
  // bf16 keys land in a two-stage ring of bf16 tiles; int8 pages in a
  // two-stage ring of raw tiles and their scales, widened into one bf16
  // tile each for the products
  static constexpr int kStages16 = kQuant ? 1 : 2;
  static constexpr int kSmemBytes =
      (kChunkRows * LD + 2 * kStages16 * kTile) * 2 +
      (kQuant ? 2 * 2 * kChunkKeys * (D + 4) : 0);
};

// Start copying keys [t0, t0 + 64) from ``src`` into shared memory: K and
// V rows (destination row stride ``ld`` elements) and, for int8 pages,
// their f32 scales.  Keys at or past ``kend`` become zeros and are not
// read.  The caller commits the group.
template <int D, class Src>
__device__ __forceinline__ void stage_keys(const Src& src, int t0, int kend,
                                           typename Src::T* dk,
                                           typename Src::T* dv, int ld,
                                           float* dks, float* dvs) {
  using T = typename Src::T;
  constexpr int kVec = 16 / sizeof(T);                 // elements a copy
  constexpr int kParts = D / kVec;
  for (int c = threadIdx.x; c < kChunkKeys * kParts; c += kChunkThreads) {
    const int j = c / kParts, col = (c % kParts) * kVec;
    const int kpos = t0 + j;
    const bool ok = kpos < kend;
    const T* k = src.any();
    const T* v = k;
    if (ok) {
      src.rows(kpos, &k, &v);
      k += col;
      v += col;
    }
    cp_async16(dk + j * ld + col, k, ok ? 16 : 0);
    cp_async16(dv + j * ld + col, v, ok ? 16 : 0);
  }
  if constexpr (sizeof(T) == 1) {
    for (int j = threadIdx.x; j < kChunkKeys; j += kChunkThreads) {
      const int kpos = t0 + j;
      const bool ok = kpos < kend;
      const float* ks = src.any_scale();
      const float* vs = ks;
      if (ok) src.scales(kpos, &ks, &vs);
      cp_async4(dks + j, ks, ok ? 4 : 0);
      cp_async4(dvs + j, vs, ok ? 4 : 0);
    }
  }
}

// int8 rows (64 x D, row stride D) -> bf16 rows (row stride D + kPad),
// exactly: |v| <= 127 fits bf16's 8-bit significand
template <int D>
__device__ __forceinline__ void widen(bf16* dst, const int8_t* src) {
  constexpr int kParts = D / 16;
  for (int c = threadIdx.x; c < kChunkKeys * kParts; c += kChunkThreads) {
    const int j = c / kParts, col = (c % kParts) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + j * D + col);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
      w[x] = pack_bf16(static_cast<float>(v[2 * x]),
                       static_cast<float>(v[2 * x + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + j * (D + kPad) + col);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// The body of block (slot blockIdx.x, query head blockIdx.y, row tile
// blockIdx.z), with the slot's start ``st``, chunk length ``cl`` and the
// source's end ``limit``; q and out are (B, T, Hq, D) contiguous and the
// dynamic shared memory holds ChunkCfg<T, D>::kSmemBytes.
template <int D, class Src>
__device__ __forceinline__ void chunk_tile(const bf16* __restrict__ q,
                                           bf16* __restrict__ out,
                                           const Src& src, int st, int cl,
                                           int limit, int T, int Hq,
                                           int prefix_len, float scale) {
  using PageT = typename Src::T;
  using C = ChunkCfg<PageT, D>;
  constexpr int BM = kChunkRows, BN = kChunkKeys, LD = C::LD;
  constexpr bool kQuant = C::kQuant;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + BM * LD;                     // stage s at sk + s * kTile
  bf16* sv = sk + C::kStages16 * C::kTile;
  // int8: raw stage s at rk + s * BN * D, its scales at sks + s * BN
  PageT* rk = reinterpret_cast<PageT*>(sv + C::kStages16 * C::kTile);
  PageT* rv = rk + 2 * BN * D;
  float* sks = reinterpret_cast<float*>(rv + 2 * BN * D);
  float* svs = sks + 2 * BN;

  const int b = blockIdx.x, h = blockIdx.y, i0 = blockIdx.z * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nrows = min(BM, T - i0);
  const int alive = max(0, min(nrows, cl - i0));  // rows i0 .. i0+alive-1
  constexpr int kParts = D / 8;                    // 16-byte pieces a row
  const long long row_stride = static_cast<long long>(Hq) * D;
  const long long row0 = (static_cast<long long>(b) * T + i0) * Hq + h;
  bf16* ob = out + row0 * D;
  if (alive == 0) {                        // every row of the tile is dead
    for (int c = threadIdx.x; c < nrows * kParts; c += kChunkThreads)
      *reinterpret_cast<uint4*>(ob + (c / kParts) * row_stride +
                                (c % kParts) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }
  // keys a live row of this tile can see: below its position + 1 or the
  // prefix, and always below start + chunk_len (and the source's end)
  const int end = min(st + cl, limit);
  const int kend = max(0, min(end, max(st + i0 + alive, prefix_len)));
  auto issue = [&](int s, int t0) {
    if constexpr (kQuant)
      stage_keys<D>(src, t0, kend, rk + s * BN * D, rv + s * BN * D, D,
                    sks + s * BN, svs + s * BN);
    else
      stage_keys<D>(src, t0, kend, sk + s * C::kTile, sv + s * C::kTile, LD,
                    nullptr, nullptr);
  };

  // group 1: the live rows of q (dead rows are zeros, never read);
  // group 2: the first key tile, into stage 0
  stage<D, kChunkThreads>(sq, q + row0 * D, row_stride, 0, BM, alive);
  cp_async_commit();
  if (kend > 0) issue(0, 0);
  cp_async_commit();

  bf16* wq = sq + warp * 16 * LD;              // this warp's 16 rows of q
  uint32_t qf[D / 16][4];
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) load_a<D>(qf[kd], wq, kd * 16, lane);

  // this thread's rows of the chunk: row and row + 8
  const int row = i0 + warp * 16 + g;
  const float sl2 = scale * kLog2e;
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int s = 0, t0 = 0; t0 < kend; s ^= 1, t0 += BN) {
    // issue the next tile's copy into the other stage, then wait for this one
    if (t0 + BN < kend) issue(s ^ 1, t0 + BN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = sk + s * C::kTile;
    const bf16* vt = sv + s * C::kTile;
    if constexpr (kQuant) {
      widen<D>(sk, rk + s * BN * D);
      widen<D>(sv, rv + s * BN * D);
      kt = sk;
      vt = sv;
      __syncthreads();
    }

    // 1. S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    frags_dot_rows<D, BN>(sc, qf, kt, lane);

    // 2. into the log2 domain (int8: times the key's scale); the element
    //    mask only where some live row does not see the whole tile: a dead
    //    row in the tile, the chunk's end, or the diagonal past the prefix
    const int k_hi = t0 + BN - 1;
    const bool edge = alive < nrows || k_hi >= end ||
                      (k_hi >= prefix_len && k_hi > st + i0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        float x = sc[j][e] * sl2;
        if constexpr (kQuant) x *= sks[s * BN + col];
        if (edge) {
          const int i = row + 8 * (e >> 1), kpos = t0 + col;
          if (!(i < cl && kpos < end && (kpos <= st + i || kpos < prefix_len)))
            x = -INFINITY;
        }
        sc[j][e] = x;
      }

    // 3. the online softmax; int8: the value's scale folds into P's column
    //    after the row sums and before P is rounded to bf16
    online_softmax<BN, D>(sc, m, l, o);
    if constexpr (kQuant) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] *= svs[s * BN + j * 8 + 2 * t + (e & 1)];
    }

    // 4. O += P V
    regs_dot_tile<D, BN, D>(o, sc, vt, 0, lane);
    __syncthreads();                           // this stage's readers are done
  }
  cp_async_wait<0>();
  __syncthreads();                             // q's copies landed everywhere

  // O / l through this warp's own rows of the q tile as 16-byte stores;
  // a row that saw no key (dead, or no visible key) is zeros
  finalize_rows<D>(wq, o, l, lane);
#pragma unroll
  for (int c = lane; c < 16 * kParts; c += 32) {
    const int r = c / kParts, col = (c % kParts) * 8;
    if (warp * 16 + r < nrows)
      *reinterpret_cast<uint4*>(ob + (warp * 16 + r) * row_stride + col) =
          *reinterpret_cast<const uint4*>(wq + r * LD + col);
  }
}

// Launch ``kernel`` (one of the chunk kernels at head dim D, key type
// PageT) over (B, Hq, T / 64 rounded up) blocks, opting in to its dynamic
// shared memory once per device.
template <typename PageT, int D, typename Kernel, typename... Args>
int launch_chunk_grid(Kernel kernel, unsigned long long* opted, int B, int T,
                      int Hq, cudaStream_t s, Args... args) {
  using C = ChunkCfg<PageT, D>;
  if ((T + kChunkRows - 1) / kChunkRows > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in(kernel, C::kSmemBytes, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hq, (T + kChunkRows - 1) / kChunkRows);
  kernel<<<grid, kChunkThreads, C::kSmemBytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
