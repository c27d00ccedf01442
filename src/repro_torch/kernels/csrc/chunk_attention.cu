// Chunked-prefill attention over a dense cache, written by hand for Hopper
// (sm_90a), with a plain C interface bound by ctypes
// (kernels/chunk_attention.py).
//
// Replaces the Pallas TPU kernel of the reference package,
// src/repro/kernels/decode_attention.py:
//   chunk_prefill_attention_pallas  :208  (pallas_call :246, body
//   _chunk_kernel :183, tile _chunk_tile :153)
// q (B, T, Hq, D) attends to a dense (B, S, Hkv, D) cache that already
// holds the chunk's own K/V at [start, start + chunk_len).  Row i of slot b
// sits at position start[b] + i and is alive iff i < chunk_len[b]; it sees
// a key at kpos iff (kpos <= start + i or kpos < prefix_len) and
// kpos < start + chunk_len.  Dead rows are zeros.  GQA: query head h reads
// kv head h / (Hq / Hkv).
//
// What bounds it on this card: at the serving path's shape (one slot, a
// 128-row bucket at offset 64, 36 heads, D = 64, S = 256) it does 0.15
// GFLOP against ~3.5 MB of q, K, V and output: ~40 flops a byte, under the
// ~295 a byte where the H100's tensor cores, not its 3.35 TB/s, set the
// limit, so bytes on paper; but the work is small, and what bounds it in
// practice is latency, the chain of steps one block takes.  The first
// kernel (one block per 16 rows, f32 staging, one lane per key for the
// scores, a scalar P V loop) re-read each head's 192 visible keys 8 times
// and ran its products on the CUDA cores, 2.7x the time of
// scaled_dot_product_attention on the same inputs (NVIDIA H100 80GB HBM3,
// 700 W, by chip_smoke.py).
//
// The design: the paged chunk kernel's body (chunk_tiles.cuh), which puts
// both products on the tensor cores, with a dense key source: key kpos of
// (slot b, kv head kvh) lies at k + b*kb + kpos*ks + kvh*kh (and likewise
// for v), read in place with the caller's strides (a layer slice of the
// stacked (layers, B, S, Hkv, D) view is such a cache; the Pallas wrapper
// pads S and transposes the whole cache to (B*Hkv, S_p, D) on every call).
//   * a block per 64 query rows of a head, 4 warps of 16 rows, q held as
//     ldmatrix fragments (re-read from shared memory at D = 256); keys 64
//     at a time (32 at D = 256) through a two-stage 16-byte cp.async ring
//     (the wrapper's 16-byte alignment and strides that are multiples of 8
//     elements are what 16-byte copies need);
//   * S = Q K^T and O += P V on mma.sync.m16n8k16, the online softmax on
//     the fragments, the element mask only on tiles that cross an edge;
//   * the key tiles start at 0 in steps of ChunkCfg::kKeys and the sums run
//     in the paged kernel's order, so on a dense view of the pages this kernel
//     gives the paged kernel's output bit for bit;
//   * no key at or past min(start + chunk_len, S) is read (the stager
//     zero-fills instead), no row at or past chunk_len is computed (a tile
//     whose rows are all dead writes zeros and reads nothing), and S and T
//     need not be multiples of 64.
// What holds it back now: launch and one block's serial chain (copy, two
// products, softmax) over at most three key tiles at the path's shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"
#include "chunk_tiles.cuh"

namespace {

// The cache, read in place.  Strides are in elements; the head dim is dense.
struct Cache {
  const bf16* k;
  const bf16* v;
  long long kb, ks, kh;                   // k: batch, sequence, head strides
  long long vb, vs, vh;
  int S;
};

// The dense rows of one (slot, kv head): key kpos lies kpos sequence
// strides past the head's first row, read through the kernel's ``Cache``
// argument.
struct DenseKeys {
  typedef bf16 T;
  const Cache& c;
  int b, kvh;

  __device__ __forceinline__ void rows(int kpos, const bf16** kr,
                                       const bf16** vr) const {
    *kr = c.k + b * c.kb + kvh * c.kh + kpos * c.ks;
    *vr = c.v + b * c.vb + kvh * c.vh + kpos * c.vs;
  }
  __device__ __forceinline__ const bf16* any() const { return c.k; }
};

template <int D>
__global__ void __launch_bounds__(kChunkThreads)
chunk_kernel(const bf16* __restrict__ q, bf16* __restrict__ out, Cache c,
             const int* __restrict__ start, const int* __restrict__ chunk_len,
             int T, int Hq, int Hkv, int prefix_len, float scale) {
  const int b = blockIdx.x;
  const DenseKeys src{c, b, static_cast<int>(blockIdx.y) / (Hq / Hkv)};
  chunk_tile<D>(q, out, src, start[b], chunk_len[b], c.S, T, Hq, prefix_len,
                scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = ok).  q/out are bf16
// (B, T, Hq, D) contiguous; start and chunk_len are int32 (B,).
extern "C" int chunk_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* start, const void* chunk_len, void* out, int B, int T,
    int Hq, int Hkv, int D, int S, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, int prefix_len, float scale,
    void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq % Hkv || prefix_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Cache c;
  c.k = static_cast<const bf16*>(k_cache);
  c.v = static_cast<const bf16*>(v_cache);
  c.kb = kb;
  c.ks = ks;
  c.kh = kh;
  c.vb = vb;
  c.vs = vs;
  c.vh = vh;
  c.S = S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const bf16*>(q);
  auto* oo = static_cast<bf16*>(out);
  const auto* st = static_cast<const int*>(start);
  const auto* cl = static_cast<const int*>(chunk_len);
  // bit per device, a kernel
  static unsigned long long opted64 = 0, opted128 = 0, opted256 = 0,
                            opted112 = 0;
  if (D == 64)
    return launch_chunk_grid<bf16, 64>(chunk_kernel<64>, &opted64, B, T, Hq,
                                       s, qq, oo, c, st, cl, T, Hq, Hkv,
                                       prefix_len, scale);
  if (D == 128)
    return launch_chunk_grid<bf16, 128>(chunk_kernel<128>, &opted128, B, T,
                                        Hq, s, qq, oo, c, st, cl, T, Hq, Hkv,
                                        prefix_len, scale);
  if (D == 256)
    return launch_chunk_grid<bf16, 256>(chunk_kernel<256>, &opted256, B, T,
                                        Hq, s, qq, oo, c, st, cl, T, Hq, Hkv,
                                        prefix_len, scale);
  if (D == 112)
    return launch_chunk_grid<bf16, 112>(chunk_kernel<112>, &opted112, B, T,
                                        Hq, s, qq, oo, c, st, cl, T, Hq, Hkv,
                                        prefix_len, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}
