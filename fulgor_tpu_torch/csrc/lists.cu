// K9 first_set_bits: each result row's first T colour ids, ascending, and
// its colour count.
//
// Replaces fulgor_tpu/ops/intersect.py first_set_bits (:220), the list
// compaction of query_fi_lists_packed (fulgor_tpu/ops/pipeline.py:249) and
// of query_tu_lists_packed (:264). Bit j of word w of a row is colour
// 32 w + j. For row b: count[b] is the row's popcount (it may exceed T);
// lists[b, t] for t < min(count[b], T) is its t-th colour, and 0 past that.
// Plain version: fulgor_tpu_torch/ops/intersect.py first_set_bits_plain.
//
// What bounds it: bytes. It reads the (B, C32) words once and writes T + 1
// int32 a row; at B = 32,768, C32 = 143, T = 64 that is 18.7 MB read and
// 8.5 MB written. The work a word is a popcount and a few shuffles.
//
// Design: one warp per row, kWarps rows a block. The warp walks its row in
// chunks of 32 words, one word a lane, so each chunk is one coalesced
// 128-byte load. A warp scan of the lanes' popcounts (__shfl_up_sync)
// gives each word the rank of its first set bit; a lane whose rank is
// below T writes its word's set bits in order (__ffs, then clear the
// lowest bit) until the rank reaches T. The chunk's total, from lane 31,
// carries to the next chunk. Then the warp writes the count and zeroes the
// slots past min(count, T). The TPU version's cumulative sums and 5-step
// binary search over a (B, T) index are not carried over: a lane expands
// its own word directly.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;

__global__ void first_set_bits_kernel(const uint32_t* __restrict__ bits,
                                      int B, int C32, int T,
                                      int32_t* __restrict__ count,
                                      int32_t* __restrict__ lists) {
  const int lane = threadIdx.x & 31;
  const size_t b =
      static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= static_cast<size_t>(B)) return;  // the whole warp leaves together
  const uint32_t* row = bits + b * C32;
  int32_t* out = lists + b * T;
  int base = 0;  // set bits in the earlier chunks
  for (int w0 = 0; w0 < C32; w0 += 32) {
    const int w = w0 + lane;
    uint32_t v = w < C32 ? __ldg(row + w) : 0u;
    const int pc = __popc(v);
    int incl = pc;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    int r = base + incl - pc;
    while (v != 0u && r < T) {
      out[r++] = 32 * w + (__ffs(v) - 1);
      v &= v - 1u;
    }
    base += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) count[b] = base;
  for (int t = (base < T ? base : T) + lane; t < T; t += 32) out[t] = 0;
}

}  // namespace

extern "C" int fulgor_first_set_bits(const void* bits, int B, int C32, int T,
                                     void* count, void* lists, void* stream) {
  if (B <= 0 || C32 <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  first_set_bits_kernel<<<blocks, 32 * kWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), B, C32, T,
      static_cast<int32_t*>(count), static_cast<int32_t*>(lists));
  return static_cast<int>(cudaGetLastError());
}
