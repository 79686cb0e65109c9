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
// Design: one warp per row, kWarps rows a block, nothing in shared memory.
// Lane l holds word 32 i + l of chunk i, and every load of a row is issued
// before any is consumed: all of its chunks at once, in groups of up to
// kMaxChunks for wider rows, the next group's loads issued before the
// current group is consumed. A chunk's set bits are ranked by one warp scan
// of the lanes' popcounts; its total, broadcast from lane 31, carries to
// the next chunk. Its slots below T are then written by whichever of two
// loops takes fewer steps, chosen for the warp by one ballot and one
// __reduce_max_sync: walking the words that hold them (one shuffle a word,
// lane l writing bit l where it is set: a dense row fills 64 slots from
// two or three words), or each lane writing its own word's bits (a sparse
// row's words hold a few bits each). Either way a step is a store of up to
// 32 consecutive or nearly consecutive slots. Once the count reaches T, the
// remaining chunks are only counted: a popcount a lane, summed by one
// __reduce_add_sync at the end of the row. Then the slots from the count to
// T are zeroed. The TPU function's slot-by-slot search (for each slot, its
// word by a search over the ranks and its bit by a 5-step popcount search)
// is not carried over: it costs tens of instructions a group of 32 slots,
// and at 32,768 rows the kernel is held by its instructions as much as by
// its bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// chunks of 32 words loaded at once: a row of C32 <= 256 in one group
constexpr int kMaxChunks = 8;

// Lane `lane`'s word of chunks first .. first + NC - 1 (0 past C32), all
// loads issued together.
template <int NC>
__device__ __forceinline__ void load_chunks(const uint32_t* __restrict__ row,
                                            int C32, int lane, int first,
                                            uint32_t (&v)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int w = 32 * (first + j) + lane;
    v[j] = w < C32 ? __ldg(row + w) : 0u;
  }
}

// Chunk `i` (lane's word v) of a row with `base` set bits before it, base
// < T: writes the chunk's slots below T and returns its set bits.
__device__ __forceinline__ int expand_chunk(uint32_t v, int i, int base, int T,
                                            int lane,
                                            int32_t* __restrict__ out) {
  const int pc = __popc(v);
  int incl = pc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  const int tot = __shfl_sync(kFull, incl, 31);
  const int need = min(tot, T - base);  // the slots this chunk fills
  const int ex = incl - pc;
  const bool holds = pc > 0 && ex < need;
  const unsigned words = __ballot_sync(kFull, holds);
  const int mine = holds ? min(pc, need - ex) : 0;  // its word's slots
  const int most = static_cast<int>(__reduce_max_sync(kFull, mine));
  if (__popc(words) <= most) {  // walk the words: lane l writes bit l
    const unsigned below = (1u << lane) - 1u;
    unsigned rest = words;
    int r = base;
    while (rest != 0u) {
      const int k = __ffs(rest) - 1;
      rest &= rest - 1u;
      const uint32_t w = __shfl_sync(kFull, v, k);
      const int t = r + __popc(w & below);
      if (((w >> lane) & 1u) && t < T) out[t] = 32 * (32 * i + k) + lane;
      r += __popc(w);
    }
  } else {  // each lane writes its own word's bits
    int32_t* o = out + base + ex;
    const int c0 = 32 * (32 * i + lane);
    for (int j = 0; j < mine; ++j) {
      o[j] = c0 + __ffs(v) - 1;
      v &= v - 1u;
    }
  }
  return tot;
}

template <int NC>
__global__ void __launch_bounds__(kThreads) first_set_bits_kernel(
    const uint32_t* __restrict__ bits, int B, int C32, int T,
    int32_t* __restrict__ count, int32_t* __restrict__ lists) {
  const int lane = threadIdx.x & 31;
  const size_t b =
      static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= static_cast<size_t>(B)) return;  // the whole warp leaves together
  const uint32_t* row = bits + b * C32;
  int32_t* out = lists + b * T;
  const int nc = (C32 + 31) >> 5;
  int base = 0;  // set bits of the chunks expanded
  int rest = 0;  // this lane's set bits of the chunks past T
  uint32_t v[NC];
  load_chunks<NC>(row, C32, lane, 0, v);
  for (int g = 0; g < nc; g += NC) {
    uint32_t vn[NC] = {};
    if (g + NC < nc) load_chunks<NC>(row, C32, lane, g + NC, vn);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (g + j >= nc) break;
      if (base < T)  // warp-uniform
        base += expand_chunk(v[j], g + j, base, T, lane, out);
      else
        rest += __popc(v[j]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) v[j] = vn[j];
  }
  for (int t = base + lane; t < T; t += 32) out[t] = 0;
  const int total = base + static_cast<int>(__reduce_add_sync(kFull, rest));
  if (lane == 0) count[b] = total;
}

// A row's chunks at once: the instance of NC = min(ceil(C32 / 32),
// kMaxChunks), NC a template argument so that the chunks stay in registers.
template <int NC = 1>
void launch(int nc, int blocks, cudaStream_t s, const uint32_t* bits, int B,
            int C32, int T, int32_t* count, int32_t* lists) {
  if constexpr (NC < kMaxChunks) {
    if (nc > NC)
      return launch<NC + 1>(nc, blocks, s, bits, B, C32, T, count, lists);
  }
  first_set_bits_kernel<NC><<<blocks, kThreads, 0, s>>>(bits, B, C32, T,
                                                        count, lists);
}

}  // namespace

extern "C" int fulgor_first_set_bits(const void* bits, int B, int C32, int T,
                                     void* count, void* lists, void* stream) {
  if (B <= 0 || C32 <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (C32 + 31) / 32;
  launch(nc < kMaxChunks ? nc : kMaxChunks, (B + kWarps - 1) / kWarps,
         static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(bits),
         B, C32, T, static_cast<int32_t*>(count),
         static_cast<int32_t*>(lists));
  return static_cast<int>(cudaGetLastError());
}
