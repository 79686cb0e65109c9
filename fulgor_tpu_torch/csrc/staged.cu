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
//   split     (this file) one warp a read: nU = its undecided windows,
//             heavy = nU > RU; each window's tag (-1 decided, its rank
//             among the read's undecided windows in a light read, -2 in a
//             heavy one); a light read's undecided windows compacted into
//             its RU lanes of tier B1, their ten K2 inputs gathered;
//   rank      (this file) one block: hrank = the exclusive prefix count of
//             heavy over the batch, in read order, and posH, the first
//             BH = max(1, B / 8) heavy reads;
//   gather    (this file) a thread a (row, window) of tier B2: the heavy
//             read's inputs, usable where the window is undecided;
//   B1, B2    K2 at (vb2, sc) on the (B, RU) and (BH, Wk) lanes;
//   merge     (this file) a thread a window: stage A's result, B1's lane,
//             B2's row, or ovf for a heavy read past BH.
//
// What bounds it: bytes. Stage A reads the prep and the slot rows as K2
// does; the split reads stage A's 10 B a window twice (the second pass
// hits L1/L2) and writes a 4 B tag; B1 and B2 add K2 passes over
// B RU + BH Wk lanes whether or not they are used, as in the reference.
// Every step runs on the card, and no size is read back: all shapes are
// fixed by (B, Wk, RU).
//
// Design: the reference's popcount ranks (mask_positions) become warp
// ballots, one warp a read; the cross-batch rank is one block's scan, so
// that heavy reads keep read order (atomics would not); the merge is a
// gather from the tag, no scatter. Lanes that are not usable get only
// their usable flag written: K2 reads nothing else of them.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "probe.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = 256;
constexpr int kRankThreads = 1024;
constexpr int kDecided = -1;
constexpr int kHeavy = -2;

__device__ __forceinline__ bool undecided(const uint8_t* usable,
                                          const uint8_t* hit,
                                          const int32_t* cnt,
                                          const uint8_t* need, long long i,
                                          int vb1) {
  return usable[i] && !hit[i] && (cnt[i] > vb1 || need[i]);
}

__global__ void __launch_bounds__(kThreads) staged_probe_split_kernel(
    fulgor::Lanes in, const uint8_t* __restrict__ hitA,
    const int32_t* __restrict__ cnt, const uint8_t* __restrict__ need,
    int B, int Wk, int vb1, int RU, fulgor::Lanes outU,
    int32_t* __restrict__ tag, uint8_t* __restrict__ heavy) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const long long row = b * Wk;
  int nU = 0;
  for (int w0 = 0; w0 < Wk; w0 += 32) {
    const int w = w0 + lane;
    const bool u = w < Wk && undecided(in.usable(), hitA, cnt, need, row + w, vb1);
    nU += __popc(__ballot_sync(kFull, u));
  }
  const bool hv = nU > RU;
  if (lane == 0) heavy[b] = hv;
  int r0 = 0;
  for (int w0 = 0; w0 < Wk; w0 += 32) {
    const int w = w0 + lane;
    const bool u = w < Wk && undecided(in.usable(), hitA, cnt, need, row + w, vb1);
    const unsigned bal = __ballot_sync(kFull, u);
    const int r = r0 + __popc(bal & ((1u << lane) - 1u));
    r0 += __popc(bal);
    if (w < Wk) tag[row + w] = !u ? kDecided : (hv ? kHeavy : r);
    if (u && !hv) {
      const long long d = b * RU + r;
      outU.take(in, row + w, d);
      outU.usable()[d] = 1;
    }
  }
  for (int r = (hv ? 0 : nU) + lane; r < RU; r += 32)
    outU.usable()[b * RU + r] = 0;
}

// one block: hrank[b] = heavy reads before b; posH[h] = the h-th heavy
// read for h < min(total, BH), 0 past it; *totH = total
__global__ void __launch_bounds__(kRankThreads) staged_probe_rank_kernel(
    const uint8_t* __restrict__ heavy, int B, int BH,
    int32_t* __restrict__ hrank, int32_t* __restrict__ posH,
    int32_t* __restrict__ totH) {
  __shared__ int warp_sum[kRankThreads / 32];
  __shared__ int total;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int per = (B + kRankThreads - 1) / kRankThreads;
  const int lo = t * per, hi = min(B, lo + per);
  int local = 0;
  for (int b = lo; b < hi; ++b) local += heavy[b];
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sum[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int s = lane < kRankThreads / 32 ? warp_sum[lane] : 0;
    int si = s;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, si, d);
      if (lane >= d) si += up;
    }
    if (lane < kRankThreads / 32) warp_sum[lane] = si - s;  // exclusive
    if (lane == 31) total = si;
  }
  __syncthreads();
  int r = warp_sum[wid] + incl - local;
  for (int b = lo; b < hi; ++b) {
    hrank[b] = r;
    if (heavy[b]) {
      if (r < BH) posH[r] = b;
      ++r;
    }
  }
  for (int h = total + t; h < BH; h += kRankThreads) posH[h] = 0;
  if (t == 0) *totH = total;
}

// a thread a (row h, window w) of tier B2
__global__ void __launch_bounds__(kThreads) staged_probe_gather_kernel(
    fulgor::Lanes in, const int32_t* __restrict__ tag,
    const int32_t* __restrict__ posH, const int32_t* __restrict__ totH,
    int Wk, int BH, fulgor::Lanes outH) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(BH) * Wk) return;
  const long long h = i / Wk, w = i % Wk;
  if (h >= *totH) {
    outH.usable()[i] = 0;
    return;
  }
  const long long s = static_cast<long long>(posH[h]) * Wk + w;
  outH.take(in, s, i);
  outH.usable()[i] = tag[s] == kHeavy;
}

// a thread a window: the staged probe's result
__global__ void __launch_bounds__(kThreads) staged_probe_merge_kernel(
    const uint8_t* __restrict__ hitA, const uint32_t* __restrict__ valA,
    const int32_t* __restrict__ tag, const int32_t* __restrict__ hrank,
    const uint8_t* __restrict__ hitU, const uint32_t* __restrict__ valU,
    const uint8_t* __restrict__ ovfU, const uint8_t* __restrict__ hitH,
    const uint32_t* __restrict__ valH, const uint8_t* __restrict__ ovfH,
    int B, int Wk, int RU, int BH, uint8_t* __restrict__ hit,
    uint32_t* __restrict__ csid, uint8_t* __restrict__ ovf) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(B) * Wk) return;
  const long long b = i / Wk, w = i % Wk;
  const int t = tag[i];
  bool h = false, o = false;
  uint32_t v = fulgor::kInvalid;
  if (t == kDecided) {
    h = hitA[i];
    v = valA[i];  // INVALID where stage A missed
  } else if (t >= 0) {
    const long long j = b * RU + t;
    h = hitU[j];
    v = valU[j];
    o = ovfU[j];
  } else {
    const int r = hrank[b];
    if (r < BH) {
      const long long j = static_cast<long long>(r) * Wk + w;
      h = hitH[j];
      v = valH[j];
      o = ovfH[j];
    } else {
      o = true;
    }
  }
  hit[i] = h;
  csid[i] = h ? v : fulgor::kInvalid;
  ovf[i] = o;
}

}  // namespace

// split + rank + gather: everything between stage A and tiers B1/B2.
// in/outU/outH: ten pointers each in K2's order (ops/probe.py
// probe_lanes); outU (B, RU), outH (BH, Wk).
extern "C" int fulgor_staged_split(void* const* in, const void* hitA,
                                   const void* cnt, const void* need, int B,
                                   int Wk, int vb1, int RU, int BH,
                                   void* const* outU, void* const* outH,
                                   void* tag, void* heavy, void* hrank,
                                   void* posH, void* totH, void* stream) {
  if (B <= 0 || Wk <= 0 || RU <= 0 || RU > Wk || BH <= 0 || vb1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const fulgor::Lanes lin = fulgor::make_lanes(in);
  staged_probe_split_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      lin, static_cast<const uint8_t*>(hitA), static_cast<const int32_t*>(cnt),
      static_cast<const uint8_t*>(need), B, Wk, vb1, RU,
      fulgor::make_lanes(outU), static_cast<int32_t*>(tag),
      static_cast<uint8_t*>(heavy));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  staged_probe_rank_kernel<<<1, kRankThreads, 0, s>>>(
      static_cast<const uint8_t*>(heavy), B, BH, static_cast<int32_t*>(hrank),
      static_cast<int32_t*>(posH), static_cast<int32_t*>(totH));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(BH) * Wk;
  staged_probe_gather_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                     kThreads),
                               kThreads, 0, s>>>(
      lin, static_cast<const int32_t*>(tag),
      static_cast<const int32_t*>(posH), static_cast<const int32_t*>(totH),
      Wk, BH, fulgor::make_lanes(outH));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fulgor_staged_merge(const void* hitA, const void* valA,
                                   const void* tag, const void* hrank,
                                   const void* hitU, const void* valU,
                                   const void* ovfU, const void* hitH,
                                   const void* valH, const void* ovfH, int B,
                                   int Wk, int RU, int BH, void* hit,
                                   void* csid, void* ovf, void* stream) {
  if (B <= 0 || Wk <= 0 || RU <= 0 || BH <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * Wk;
  staged_probe_merge_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                    kThreads),
                              kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hitA), static_cast<const uint32_t*>(valA),
      static_cast<const int32_t*>(tag), static_cast<const int32_t*>(hrank),
      static_cast<const uint8_t*>(hitU), static_cast<const uint32_t*>(valU),
      static_cast<const uint8_t*>(ovfU), static_cast<const uint8_t*>(hitH),
      static_cast<const uint32_t*>(valH), static_cast<const uint8_t*>(ovfH), B,
      Wk, RU, BH, static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
