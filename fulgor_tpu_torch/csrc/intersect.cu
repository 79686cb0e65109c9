// K3 fi_and: full intersection of the colour-set bit rows of each read's
// positive windows.
//
// Replaces fulgor_tpu/ops/intersect.py full_intersection_windows (:91), its
// one-hot twin full_intersection_onehot (:68) and the AND of
// compact_runs (:188) -> full_intersection_runs (:254); the plain version
// is fulgor_tpu_torch/ops/intersect.py fi_and_plain.
//
// What bounds it: bytes. It reads hit and csid once (5 B per window), one
// C32-word bit row per run of equal csids, and writes C32 words per read.
// With runs of a few windows on clonal pangenomes the row reads are a
// small multiple of the output; rows come from a dense matrix (1.4 MB at
// 256 genomes) that stays in L2.
//
// What held the first design back (one block a read, threads over the
// C32 words, each walking every window through shared memory): at the
// main path's C32 = 16 a block was one warp with half its lanes idle, and
// each thread spent ~130 branchy iterations and one dependent row load a
// run on ~4 runs a read.
//
// Design: one warp a read, kWarps reads a block. Each lane takes kPer
// consecutive windows (kPer = ceil(Wk / 32), at most 8, a template
// argument: a read of up to 256 windows is one pass) and marks run starts:
// window w is positive and not (w - 1 positive with the same csid),
// compared in registers; the window before a lane's first comes from the
// lane below by shuffle, and lane 0's from the last pass. A scan of the
// lanes' start counts places the starts' csids, in window order, in the
// warp's slice of shared memory. AND is idempotent, so the AND over these
// starts' rows equals the AND over every positive window's: a csid that
// recurs after a miss or another run is ANDed again, which changes
// nothing, with no run budget and no overflow (the JAX runs path needed
// both). Then every lane loads rows:
//   C32 <= 32: the lanes split into 32 / P groups of P lanes (P the power of
//     two at or above C32); group g takes runs g, g + G, ..., lane j of a
//     group word j, so several rows are in flight at once; the groups' ANDs
//     meet by xor shuffles.
//   C32 > 32: the lanes take words, 32 at a time, and loop over the runs.
// The read's C32 words are written coalesced, 0 for a read with no
// positive window. The one-hot matmul trick of the TPU version is not
// carried over: the card gathers rows directly.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWk = 1024;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int kPer, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32) fi_and_kernel(
    const uint32_t* __restrict__ dense, int C32, int P,
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int B,
    int Wk, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t starts[];  // kWarps x Wk run-start csids
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // the whole warp
  uint32_t* run = starts + warp * Wk;
  const uint8_t* hrow = hit + b * Wk;
  const uint32_t* crow = csid + b * Wk;

  // the run starts, compacted in window order: lane l takes kPer windows
  // in a row, l * kPer onwards, of each pass of 32 * kPer
  int nr = 0;
  bool ph = false;  // the window before this pass: positive,
  uint32_t pc = 0;  // and its csid
  for (int w0 = 0; w0 < Wk; w0 += 32 * kPer) {
    const int w = w0 + lane * kPer;
    uint32_t c[kPer];
    uint32_t hm = 0;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const bool in = w + t < Wk;
      c[t] = in ? __ldg(crow + w + t) : 0u;
      hm |= static_cast<uint32_t>(in && __ldg(hrow + w + t)) << t;
    }
    bool hp = __shfl_up_sync(kFull, (hm >> (kPer - 1)) & 1, 1);
    uint32_t cp = __shfl_up_sync(kFull, c[kPer - 1], 1);
    if (lane == 0) {
      hp = ph;
      cp = pc;
    }
    uint32_t sm = 0;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const bool h = (hm >> t) & 1;
      sm |= static_cast<uint32_t>(h && !(hp && cp == c[t])) << t;
      hp = h;
      cp = c[t];
    }
    const int ns = __popc(sm);
    int incl = ns;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    int pos = nr + incl - ns;
#pragma unroll
    for (int t = 0; t < kPer; ++t)
      if ((sm >> t) & 1) run[pos++] = c[t];
    nr += __shfl_sync(kFull, incl, 31);
    ph = __shfl_sync(kFull, (hm >> (kPer - 1)) & 1, 31);
    pc = __shfl_sync(kFull, c[kPer - 1], 31);
  }
  __syncwarp();

  uint32_t* orow = out + b * C32;
  if constexpr (kNarrow) {
    const int G = 32 / P;
    const int g = lane / P, j = lane & (P - 1);
    uint32_t acc = kFull;
    if (j < C32) {
#pragma unroll 4
      for (int r = g; r < nr; r += G)
        acc &= __ldg(dense + static_cast<size_t>(run[r]) * C32 + j);
    }
    for (int off = P; off < 32; off <<= 1)
      acc &= __shfl_xor_sync(kFull, acc, off);
    if (lane < C32) orow[lane] = nr ? acc : 0u;
  } else {
    for (int j = lane; j < C32; j += 32) {
      uint32_t acc = kFull;
#pragma unroll 4
      for (int r = 0; r < nr; ++r)
        acc &= __ldg(dense + static_cast<size_t>(run[r]) * C32 + j);
      orow[j] = nr ? acc : 0u;
    }
  }
}

}  // namespace

extern "C" int fulgor_fi_and(const void* dense, int C32, const void* hit,
                             const void* csid, int B, int Wk, void* out,
                             void* stream) {
  if (B <= 0 || C32 <= 0 || Wk <= 0 || Wk > kMaxWk)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(kWarps) * Wk * sizeof(uint32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* d = static_cast<const uint32_t*>(dense);
  const uint8_t* h = static_cast<const uint8_t*>(hit);
  const uint32_t* c = static_cast<const uint32_t*>(csid);
  uint32_t* o = static_cast<uint32_t*>(out);
  // windows a lane takes a pass: a read's windows in one pass up to 256
  const int per = Wk > 224 ? 8 : (Wk + 31) / 32;
  int P = 1;
  while (P < C32 && P < 32) P <<= 1;
  auto kernel = fi_and_kernel<1, true>;
  switch (per) {
#define FULGOR_FI_AND_CASE(N)                                          \
  case N:                                                              \
    kernel = C32 <= 32 ? fi_and_kernel<N, true> : fi_and_kernel<N, false>; \
    break;
    FULGOR_FI_AND_CASE(1)
    FULGOR_FI_AND_CASE(2)
    FULGOR_FI_AND_CASE(3)
    FULGOR_FI_AND_CASE(4)
    FULGOR_FI_AND_CASE(5)
    FULGOR_FI_AND_CASE(6)
    FULGOR_FI_AND_CASE(7)
    FULGOR_FI_AND_CASE(8)
#undef FULGOR_FI_AND_CASE
  }
  kernel<<<blocks, kWarps * 32, smem, s>>>(d, C32, P, h, c, B, Wk, o);
  return static_cast<int>(cudaGetLastError());
}
