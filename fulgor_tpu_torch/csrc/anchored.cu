// K11 anchored_probe: the run-anchored dictionary probe's anchor ranking,
// extension and merge around two launches of K2 (probe.cu).
//
// Replaces fulgor_tpu/ops/minidict2.py _probe_anchored (:1500), the probe
// of lookup_minidict2_anchored_packed (:1489) and
// lookup_minidict2_batch_anchored (:1451), with its mask_positions
// compactions (ops/intersect.py:152); the plain version is
// fulgor_tpu_torch/ops/anchored.py minidict2_anchored_probe_plain. A run is
// a maximal stretch of usable windows with the same (pL, pR), the absolute
// positions of the leftmost and rightmost minimal m-mer (K1 writes them);
// within a run the candidate text position moves by one a window. The
// launch sequence (ops/anchored.py minidict2_anchored_probe):
//
//   anchors   (this file) one warp a read: run starts and ends, the first
//             RA of each ranked (posS, posE) and their ten K2 inputs
//             gathered into (B, 2 RA) lanes, usable where
//             validS | probeE (probeE = validS & posE > posS);
//   probe     K2 want_entry at the default budgets on those lanes: each
//             anchor's hit, csid, ovf and winning entry (q, rc, wlo, sp);
//   extend    (this file) one warp a read, a lane a window: runid = the
//             inclusive prefix count of run starts - 1, in_run = usable &
//             runid < RA; round 1 verifies the start anchor's predicted
//             text position with one extract, round 2 the end anchor's
//             where round 1 missed and dE >= 0; then dec_miss, anch_ovf
//             and undec, the first RU undecided windows compacted into
//             (B, RU) lanes and each window's rank among them written;
//   reprobe   K2 at the default budgets on those lanes;
//   merge     (this file) a thread a window: the reprobe's result for
//             undecided windows, ovf past RU.
//
// ovf = the reprobe's | anch_ovf | (usable & ~in_run).
//
// What bounds it: bytes. The prep is read by the anchor and extension
// passes, each window makes one or two 16 B text reads, and K2 runs on
// B (2 RA + RU) lanes instead of B Wk. Every step runs on the card, and no
// size is read back: all shapes follow from (B, Wk, RA, RU).
//
// Design: the reference's popcount ranks and take_along gathers become
// warp ballots over 32 windows at a time, one warp a read, so the ranks
// come in read order with no scatter; the extension reads its run's two
// anchor lanes directly by runid. Lanes that are not usable get only their
// usable flag written: K2 reads nothing else of them.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "probe.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = 256;

// window w continues window w - 1's run (both usable, same pL and pR)
__device__ __forceinline__ bool continues(const uint8_t* usable,
                                          const int32_t* pL,
                                          const int32_t* pR, long long row,
                                          int w) {
  return w > 0 && usable[row + w] && usable[row + w - 1] &&
         pL[row + w] == pL[row + w - 1] && pR[row + w] == pR[row + w - 1];
}

__device__ __forceinline__ void run_bounds(const uint8_t* usable,
                                           const int32_t* pL,
                                           const int32_t* pR, long long row,
                                           int w, int Wk, bool* start,
                                           bool* end) {
  const bool u = w < Wk && usable[row + w];
  *start = u && !continues(usable, pL, pR, row, w);
  *end = u && !(w + 1 < Wk && continues(usable, pL, pR, row, w + 1));
}

__global__ void __launch_bounds__(kThreads) anchored_probe_anchors_kernel(
    fulgor::Lanes in, const int32_t* __restrict__ pL,
    const int32_t* __restrict__ pR, int B, int Wk, int RA,
    fulgor::Lanes outA, int32_t* __restrict__ posS,
    int32_t* __restrict__ posE) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const long long row = b * Wk, lanes = b * 2LL * RA, ranks = b * RA;
  const unsigned below = (1u << lane) - 1u;
  int nS = 0, nE = 0;
  for (int w0 = 0; w0 < Wk; w0 += 32) {
    const int w = w0 + lane;
    bool s, e;
    run_bounds(in.usable(), pL, pR, row, w, Wk, &s, &e);
    const unsigned bs = __ballot_sync(kFull, s), be = __ballot_sync(kFull, e);
    const int rs = nS + __popc(bs & below), re = nE + __popc(be & below);
    if (s && rs < RA) {
      posS[ranks + rs] = w;
      outA.take(in, row + w, lanes + rs);
    }
    if (e && re < RA) {
      posE[ranks + re] = w;
      outA.take(in, row + w, lanes + RA + re);
    }
    nS += __popc(bs);
    nE += __popc(be);
  }
  __syncwarp();  // posS/posE written by other lanes of this warp
  for (int r = lane; r < RA; r += 32) {
    const bool valid = r < nS;
    if (!valid) {
      posS[ranks + r] = 0;
      posE[ranks + r] = 0;
    }
    outA.usable()[lanes + r] = valid;
    outA.usable()[lanes + RA + r] =
        valid && posE[ranks + r] > posS[ranks + r];
  }
}

struct Anchor {  // one anchor lane's K2 want_entry outputs
  const uint8_t *hit, *ovf, *rc;
  const uint32_t* val;
  const int32_t *q, *wlo, *sp;
};

// the anchor's predicted text position for a window d windows on; ok when
// the anchor hit, the position lies in its entry's span and the text there
// is the window's k-mer in the anchor's orientation
__device__ __forceinline__ bool extend_from(const Anchor& a, long long j,
                                            int d, const fulgor::Text& text,
                                            uint32_t flo, uint32_t fhi,
                                            uint32_t rlo, uint32_t rhi) {
  if (!a.hit[j]) return false;
  const bool rc = a.rc[j];
  const int qw = rc ? a.q[j] - d : a.q[j] + d;
  const int wlo = a.wlo[j];
  if (qw < wlo || qw >= wlo + a.sp[j]) return false;
  return rc ? text.verify(qw, rlo, rhi) : text.verify(qw, flo, fhi);
}

__global__ void __launch_bounds__(kThreads) anchored_probe_extend_kernel(
    fulgor::Text text, fulgor::Lanes in, const int32_t* __restrict__ pL,
    const int32_t* __restrict__ pR, const int32_t* __restrict__ posS,
    const int32_t* __restrict__ posE, Anchor anc, int B, int Wk, int RA,
    int RU, fulgor::Lanes outU, uint8_t* __restrict__ hit,
    uint32_t* __restrict__ csid, uint8_t* __restrict__ ovf,
    int32_t* __restrict__ urank) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const long long row = b * Wk, lanes = b * 2LL * RA, ranks = b * RA;
  const unsigned below = (1u << lane) - 1u;
  int runs = 0, nU = 0;
  for (int w0 = 0; w0 < Wk; w0 += 32) {
    const int w = w0 + lane;
    const long long i = row + w;
    bool is_start, is_end;
    run_bounds(in.usable(), pL, pR, row, w, Wk, &is_start, &is_end);
    const unsigned bs = __ballot_sync(kFull, is_start);
    const int runid = runs + __popc(bs & (below | (1u << lane))) - 1;
    runs += __popc(bs);
    const bool us = w < Wk && in.usable()[i];
    const bool in_run = us && runid >= 0 && runid < RA;
    bool hit0 = false, undec = false, anch_ovf = false;
    uint32_t val0 = fulgor::kInvalid;
    if (in_run) {
      const long long jS = lanes + runid, jE = lanes + RA + runid;
      const int pS = posS[ranks + runid], pE = posE[ranks + runid];
      const bool probeE = pE > pS;
      const uint32_t f_lo = in.w[3][i], f_hi = in.w[4][i];
      const uint32_t r_lo = in.w[5][i], r_hi = in.w[6][i];
      const bool ok1 =
          extend_from(anc, jS, w - pS, text, f_lo, f_hi, r_lo, r_hi);
      const int dE = (probeE ? pE : 0) - w;
      const bool ok2 = !ok1 && dE >= 0 &&
                       extend_from(anc, jE, -dE, text, f_lo, f_hi, r_lo, r_hi);
      hit0 = ok1 || ok2;
      val0 = ok1 ? anc.val[jS] : anc.val[jE];
      const bool hS = anc.hit[jS], oS = anc.ovf[jS];
      const bool hE = anc.hit[jE], oE = anc.ovf[jE];
      const bool dec_miss =
          (is_start && !oS && !hS) || (is_end && probeE && !oE && !hE);
      anch_ovf = ((is_start && oS) || (is_end && probeE && oE)) && !hit0;
      undec = !hit0 && !dec_miss && !anch_ovf;
    }
    const unsigned bu = __ballot_sync(kFull, undec);
    const int ru = nU + __popc(bu & below);
    nU += __popc(bu);
    if (w < Wk) {
      hit[i] = hit0;
      csid[i] = hit0 ? val0 : fulgor::kInvalid;
      ovf[i] = anch_ovf || (us && !in_run);
      urank[i] = undec ? ru : -1;
    }
    if (undec && ru < RU) {
      const long long d = b * RU + ru;
      outU.take(in, i, d);
      outU.usable()[d] = 1;
    }
  }
  for (int r = (nU < RU ? nU : RU) + lane; r < RU; r += 32)
    outU.usable()[b * RU + r] = 0;
}

// a thread a window: the reprobe's result where the window was undecided
__global__ void __launch_bounds__(kThreads) anchored_probe_merge_kernel(
    const int32_t* __restrict__ urank, const uint8_t* __restrict__ hitU,
    const uint32_t* __restrict__ valU, const uint8_t* __restrict__ ovfU,
    int B, int Wk, int RU, uint8_t* __restrict__ hit,
    uint32_t* __restrict__ csid, uint8_t* __restrict__ ovf) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(B) * Wk) return;
  const int t = urank[i];
  if (t < 0) return;
  if (t >= RU) {
    ovf[i] = 1;
    return;
  }
  const long long j = (i / Wk) * RU + t;
  const bool h = hitU[j];
  hit[i] = h;
  csid[i] = h ? valU[j] : fulgor::kInvalid;
  ovf[i] = ovfU[j];
}

}  // namespace

// in/outA: ten pointers each in K2's order (ops/probe.py probe_lanes);
// outA (B, 2 RA), posS/posE (B, RA).
extern "C" int fulgor_anchored_anchors(void* const* in, const void* pL,
                                       const void* pR, int B, int Wk, int RA,
                                       void* const* outA, void* posS,
                                       void* posE, void* stream) {
  if (B <= 0 || Wk <= 0 || RA <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  anchored_probe_anchors_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      fulgor::make_lanes(in), static_cast<const int32_t*>(pL),
      static_cast<const int32_t*>(pR), B, Wk, RA, fulgor::make_lanes(outA),
      static_cast<int32_t*>(posS), static_cast<int32_t*>(posE));
  return static_cast<int>(cudaGetLastError());
}

// hitA..spA: K2 want_entry's seven outputs on the (B, 2 RA) anchor lanes;
// outU: ten pointers, (B, RU); hit/csid/ovf/urank (B, Wk).
extern "C" int fulgor_anchored_extend(
    const void* text32, long long N, void* const* in, const void* pL,
    const void* pR, const void* posS, const void* posE, const void* hitA,
    const void* valA, const void* ovfA, const void* qA, const void* rcA,
    const void* wloA, const void* spA, int B, int Wk, int RA, int RU, int k,
    void* const* outU, void* hit, void* csid, void* ovf, void* urank,
    void* stream) {
  if (B <= 0 || Wk <= 0 || RA <= 0 || RU <= 0 || N <= 0 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Anchor anc{static_cast<const uint8_t*>(hitA),
                   static_cast<const uint8_t*>(ovfA),
                   static_cast<const uint8_t*>(rcA),
                   static_cast<const uint32_t*>(valA),
                   static_cast<const int32_t*>(qA),
                   static_cast<const int32_t*>(wloA),
                   static_cast<const int32_t*>(spA)};
  anchored_probe_extend_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      fulgor::make_text(text32, N, k), fulgor::make_lanes(in),
      static_cast<const int32_t*>(pL), static_cast<const int32_t*>(pR),
      static_cast<const int32_t*>(posS), static_cast<const int32_t*>(posE),
      anc, B, Wk, RA, RU, fulgor::make_lanes(outU),
      static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf), static_cast<int32_t*>(urank));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fulgor_anchored_merge(const void* urank, const void* hitU,
                                     const void* valU, const void* ovfU,
                                     int B, int Wk, int RU, void* hit,
                                     void* csid, void* ovf, void* stream) {
  if (B <= 0 || Wk <= 0 || RU <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * Wk;
  anchored_probe_merge_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                      kThreads),
                                kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(urank), static_cast<const uint8_t*>(hitU),
      static_cast<const uint32_t*>(valU), static_cast<const uint8_t*>(ovfU), B,
      Wk, RU, static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
