// K10 staged_probe: the staged dictionary probe's compaction, ranking,
// gathers and merge around three launches of K2 (probe.cu).
//
// Replaces fulgor_tpu/ops/minidict2.py _probe_staged (:1356), the probe of
// lookup_minidict2_staged_packed (:1326), with its mask_positions
// compactions (ops/intersect.py:152); the plain version is
// fulgor_tpu_torch/ops/staged.py minidict2_staged_probe_plain. The launch
// sequence (ops/staged.py minidict2_staged_probe):
//
//   stage A   K2 stage1 at vb1 on every (B, Wk) lane -> hitA, valA, cnt,
//             need_sec; a window is undecided where it is usable, missed
//             and either had more than vb1 candidates or needs the skew
//             table;
//   split     (this file) one warp a read, 32 reads a block: the read's
//             undecided mask (one bit a window), heavy = more than RU
//             undecided windows (one bit a read, a word a block); a light
//             read's undecided windows compacted into its RU lanes of tier
//             B1, their ten K2 inputs gathered;
//   gather    (this file) every block scans the batch's heavy words (the
//             h-th heavy read in read order is posH[h]) and takes its own
//             rows of tier B2, the first BH = max(1, B / 8) heavy reads, a
//             warp a row: the heavy read's inputs, usable where the window
//             is undecided; block 0 also writes each heavy word's prefix
//             count;
//   B1, B2    K2 at (vb2, sc) on the (B, RU) and (BH, Wk) lanes;
//   merge     (this file) one warp a read: stage A's result, B1's lane,
//             B2's row, or ovf for a heavy read past BH.
//
// What bounds it: bytes. Stage A reads the prep and the slot rows as K2
// does; the split reads stage A's 7 B a window once, and gathers the
// undecided windows of light reads; the gather reads the heavy reads'
// inputs; the merge reads stage A's hit and csid and the tiers' lanes of
// undecided windows, and writes 6 B a window. B1 and B2 add K2 passes over
// B RU + BH Wk lanes whether or not they are used, as in the reference.
// Every step runs on the card, and no size is read back: all shapes are
// fixed by (B, Wk, RU).
//
// What held the first design back: the split read stage A's four
// arrays twice (one pass counted, one ranked) and wrote a 4 B tag a
// window; the batch's heavy ranks came from one block whose threads each
// walked B / 1,024 reads in series with byte loads and strided stores;
// the gather and merge took a thread a window with 64-bit divisions.
//
// Design (K3-K5's warp a read): a lane takes a window, the four stage A
// loads of up to kGroup passes of 32 windows out together; word c of a
// read's undecided mask is kept by lane c (Wk <= 1,024), so a window's
// rank among the read's undecided windows is a prefix popcount, and a
// lane takes a B1 lane, its window the r-th set bit (warp_select), so B1
// is written coalesced. The cross-batch rank of a heavy read is its
// word's prefix plus a popcount, from one coalesced scan of B / 32 words
// that each gather block repeats (4 KB at B = 32,768, from L2), so that
// the rank needs no launch of its own and heavy reads keep read order
// (atomics would not); a warp takes a B2 row. Lanes that are not usable
// get only their usable flag written: K2 reads nothing else of them.
//
// What holds it now: the split's and the merge's trips to memory, one or
// two a read, with few reads a wave in flight; the gather's blocks each
// scanning the heavy words before their row.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "probe.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// the split: a read a warp, a heavy word a block
constexpr int kSplitThreads = 1024;

// the window's four stage A values loaded together, not one after another
__device__ __forceinline__ bool undecided(const uint8_t* usable,
                                          const uint8_t* hit,
                                          const int32_t* cnt,
                                          const uint8_t* need, long long i,
                                          int vb1) {
  const uint8_t u = __ldg(usable + i), h = __ldg(hit + i), n = __ldg(need + i);
  const int32_t c = __ldg(cnt + i);
  return u && !h && (c > vb1 || n);
}

__global__ void __launch_bounds__(kSplitThreads) staged_probe_split_kernel(
    fulgor::Lanes in, const uint8_t* __restrict__ hitA,
    const int32_t* __restrict__ cnt, const uint8_t* __restrict__ need,
    int B, int Wk, int vb1, int RU, fulgor::Lanes outU,
    uint32_t* __restrict__ umask, uint32_t* __restrict__ heavy) {
  __shared__ int heavy_sh[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + warp;
  bool hv = false;
  if (b < B) {  // the whole warp; no early return before the barrier
    const int nw = (Wk + 31) >> 5;
    const long long row = static_cast<long long>(b) * Wk;
    uint32_t uw = 0;  // lane c keeps word c of the undecided mask
    for (int c0 = 0; c0 < nw; c0 += fulgor::kGroup) {
      bool u[fulgor::kGroup];
#pragma unroll
      for (int g = 0; g < fulgor::kGroup; ++g) {
        const int w = (c0 + g) * 32 + lane;
        u[g] = w < Wk &&
               undecided(in.usable(), hitA, cnt, need, row + w, vb1);
      }
#pragma unroll
      for (int g = 0; g < fulgor::kGroup; ++g) {
        if (c0 + g >= nw) break;  // the whole warp
        const uint32_t bal = __ballot_sync(kFull, u[g]);
        if (lane == c0 + g) uw = bal;
      }
    }
    int nU;
    const int pre = fulgor::warp_exclusive_sum(__popc(uw), &nU);
    hv = nU > RU;
    const long long lanes = static_cast<long long>(b) * RU;
    if (!hv) {  // a lane a tier B1 lane: its window the r-th undecided
      for (int r0 = 0; r0 < nU; r0 += 32) {
        const int r = r0 + lane;
        const int w = fulgor::warp_select(uw, pre, nw, r < nU ? r : 0);
        if (r < nU) {
          outU.take(in, row + w, lanes + r);
          outU.usable()[lanes + r] = 1;
        }
      }
    }
    for (int r = (hv ? 0 : nU) + lane; r < RU; r += 32)
      outU.usable()[lanes + r] = 0;
    if (lane < nw) umask[static_cast<long long>(b) * nw + lane] = uw;
  }
  if (lane == 0) heavy_sh[warp] = hv;
  __syncthreads();
  if (warp == 0) {
    const uint32_t word = __ballot_sync(kFull, heavy_sh[lane] != 0);
    if (lane == 0) heavy[blockIdx.x] = word;
  }
}

// each block: the batch's heavy words scanned, then its kWarps rows of
// tier B2 gathered, a warp a row; block 0 writes hpre, each heavy
// word's prefix count
__global__ void __launch_bounds__(kThreads) staged_probe_gather_kernel(
    fulgor::Lanes in, const uint32_t* __restrict__ umask,
    const uint32_t* __restrict__ heavy, int B, int Wk, int BH,
    fulgor::Lanes outH, int32_t* __restrict__ hpre) {
  __shared__ int warp_sum[kWarps];
  __shared__ int pos[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nh = (B + 31) >> 5;
  const int per = (nh + kThreads - 1) / kThreads;
  const int lo = t * per, hi = lo + per < nh ? lo + per : nh;
  int local = 0;
  for (int j = lo; j < hi; ++j) local += __popc(heavy[j]);
  int wsum;
  const int excl = fulgor::warp_exclusive_sum(local, &wsum);
  if (lane == 0) warp_sum[warp] = wsum;
  __syncthreads();
  int before = 0, total = 0;
  for (int x = 0; x < kWarps; ++x) {
    before += x < warp ? warp_sum[x] : 0;
    total += warp_sum[x];
  }
  // this block's rows: the heavy reads ranked h0 .. h0 + kWarps - 1
  const int h0 = blockIdx.x * kWarps;
  int p = before + excl;
  for (int j = lo; j < hi; ++j) {
    uint32_t word = heavy[j];
    const int n = __popc(word);
    if (blockIdx.x == 0) hpre[j] = p;
    if (p < h0 + kWarps && p + n > h0) {
      for (int r = p; word; ++r, word &= word - 1)
        if (r >= h0 && r < h0 + kWarps)
          pos[r - h0] = j * 32 + __ffs(word) - 1;
    }
    p += n;
  }
  __syncthreads();

  const int nw = (Wk + 31) >> 5;
  // this warp's row: the heavy read ranked h0 + warp, or none past the
  // batch's heavy reads
  const int h = h0 + warp;
  if (h >= BH) return;
  const long long o = static_cast<long long>(h) * Wk;
  if (h >= total) {
    for (int w = lane; w < Wk; w += 32) outH.usable()[o + w] = 0;
    return;
  }
  const int b = pos[warp];
  const long long s = static_cast<long long>(b) * Wk;
  const uint32_t uw =
      lane < nw ? umask[static_cast<long long>(b) * nw + lane] : 0u;
#pragma unroll 4
  for (int c = 0; c < nw; ++c) {
    const uint32_t wc = __shfl_sync(kFull, uw, c);
    const int w = c * 32 + lane;
    if (w >= Wk) break;
    const bool u = (wc >> lane) & 1;
    if (u) outH.take(in, s + w, o + w);
    outH.usable()[o + w] = u;
  }
}

// one warp a read: the staged probe's result
__global__ void __launch_bounds__(kThreads) staged_probe_merge_kernel(
    const uint8_t* __restrict__ hitA, const uint32_t* __restrict__ valA,
    const uint32_t* __restrict__ umask, const uint32_t* __restrict__ heavy,
    const int32_t* __restrict__ hpre, const uint8_t* __restrict__ hitU,
    const uint32_t* __restrict__ valU, const uint8_t* __restrict__ ovfU,
    const uint8_t* __restrict__ hitH, const uint32_t* __restrict__ valH,
    const uint8_t* __restrict__ ovfH, int B, int Wk, int RU, int BH,
    uint8_t* __restrict__ hit, uint32_t* __restrict__ csid,
    uint8_t* __restrict__ ovf) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int nw = (Wk + 31) >> 5;
  const uint32_t uw =
      lane < nw ? umask[static_cast<long long>(b) * nw + lane] : 0u;
  int nU;
  const int pre = fulgor::warp_exclusive_sum(__popc(uw), &nU);
  const uint32_t hw = heavy[b >> 5], hb = 1u << (b & 31);
  const bool hv = hw & hb;
  const int hr = hv ? hpre[b >> 5] + __popc(hw & (hb - 1u)) : 0;
  const long long row = static_cast<long long>(b) * Wk;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < nw; ++c) {
    const uint32_t wc = __shfl_sync(kFull, uw, c);
    const int p0 = __shfl_sync(kFull, pre, c);
    const int w = c * 32 + lane;
    if (w >= Wk) break;
    const long long i = row + w;
    // stage A's result (INVALID where it missed), or the window's tier's
    bool h = __ldg(hitA + i), o = false;
    uint32_t v = __ldg(valA + i);
    if ((wc >> lane) & 1) {
      long long j = -1;
      if (!hv)
        j = static_cast<long long>(b) * RU + p0 + __popc(wc & below);
      else if (hr < BH)
        j = static_cast<long long>(hr) * Wk + w;
      const uint8_t* th = hv ? hitH : hitU;
      const uint32_t* tv = hv ? valH : valU;
      const uint8_t* to = hv ? ovfH : ovfU;
      h = j >= 0 && th[j];
      v = j >= 0 ? tv[j] : fulgor::kInvalid;
      o = j < 0 || to[j];
    }
    hit[i] = h;
    csid[i] = h ? v : fulgor::kInvalid;
    ovf[i] = o;
  }
}

bool bad_shape(int B, int Wk) {
  return B <= 0 || Wk <= 0 || Wk > fulgor::kMaxWk ||
         static_cast<long long>(B) * Wk >= (1LL << 31);
}

}  // namespace

// split + gather: everything between stage A and tiers B1/B2.
// in/outU/outH: ten pointers each in K2's order (ops/probe.py
// probe_lanes); outU (B, RU), outH (BH, Wk); umask (B, ceil(Wk / 32)) u32,
// the undecided masks; heavy (ceil(B / 32),) u32, the heavy reads' bits;
// hpre (ceil(B / 32),) int32, the heavy reads before each word.
extern "C" int fulgor_staged_split(void* const* in, const void* hitA,
                                   const void* cnt, const void* need, int B,
                                   int Wk, int vb1, int RU, int BH,
                                   void* const* outU, void* const* outH,
                                   void* umask, void* heavy, void* hpre,
                                   void* stream) {
  if (bad_shape(B, Wk) || RU <= 0 || RU > Wk || BH <= 0 || vb1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const fulgor::Lanes lin = fulgor::make_lanes(in);
  staged_probe_split_kernel<<<(B + 31) / 32, kSplitThreads, 0, s>>>(
      lin, static_cast<const uint8_t*>(hitA), static_cast<const int32_t*>(cnt),
      static_cast<const uint8_t*>(need), B, Wk, vb1, RU,
      fulgor::make_lanes(outU), static_cast<uint32_t*>(umask),
      static_cast<uint32_t*>(heavy));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  staged_probe_gather_kernel<<<(BH + kWarps - 1) / kWarps, kThreads, 0,
                               s>>>(
      lin, static_cast<const uint32_t*>(umask),
      static_cast<const uint32_t*>(heavy), B, Wk, BH, fulgor::make_lanes(outH),
      static_cast<int32_t*>(hpre));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fulgor_staged_merge(const void* hitA, const void* valA,
                                   const void* umask, const void* heavy,
                                   const void* hpre, const void* hitU,
                                   const void* valU, const void* ovfU,
                                   const void* hitH, const void* valH,
                                   const void* ovfH, int B, int Wk, int RU,
                                   int BH, void* hit, void* csid, void* ovf,
                                   void* stream) {
  if (bad_shape(B, Wk) || RU <= 0 || BH <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  staged_probe_merge_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hitA), static_cast<const uint32_t*>(valA),
      static_cast<const uint32_t*>(umask), static_cast<const uint32_t*>(heavy),
      static_cast<const int32_t*>(hpre), static_cast<const uint8_t*>(hitU),
      static_cast<const uint32_t*>(valU), static_cast<const uint8_t*>(ovfU),
      static_cast<const uint8_t*>(hitH), static_cast<const uint32_t*>(valH),
      static_cast<const uint8_t*>(ovfH), B, Wk, RU, BH,
      static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
