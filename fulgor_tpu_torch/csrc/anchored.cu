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
//   anchors   (this file) one warp a read: each read's run-start and
//             run-end masks (one bit a window, ceil(Wk / 32) words each),
//             and the ten K2 inputs of its first RA run starts and ends
//             gathered into (B, 2 RA) lanes, usable where validS | probeE
//             (probeE = validS & the run is longer than one window);
//   probe     K2 want_entry at the default budgets on those lanes: each
//             anchor's hit, csid, ovf and winning entry (q, rc, wlo, sp);
//   extend    (this file) one warp a read, a lane a window: runid = the
//             inclusive prefix count of run starts - 1, in_run = usable &
//             runid < RA; round 1 verifies the start anchor's predicted
//             text position with one extract, round 2 the end anchor's
//             where round 1 missed and the run is longer than one window;
//             then dec_miss, anch_ovf and undec; the first RU undecided
//             windows compacted into (B, RU) lanes, ovf set on those past
//             RU, and the read's undecided mask written;
//   reprobe   K2 at the default budgets on those lanes;
//   merge     (this file) one warp a read: the reprobe's result on each of
//             the read's first RU undecided windows.
//
// ovf = the reprobe's | anch_ovf | (usable & ~in_run) | undecided past RU.
//
// What bounds it: bytes. The anchors pass reads usable, pL and pR once
// (9 B a window) and gathers the anchor lanes' 30 B; the extension reads
// the masks, the anchors' results, flo..rhi of the windows in a run and
// one 16 B text row a verify (a run's windows read neighbouring rows), and
// writes hit, csid and ovf (6 B a window); the merge reads the undecided
// masks and the reprobe's lanes of undecided windows only. K2 runs on
// B (2 RA + RU) lanes instead of B Wk. Every step runs on the card, and no
// size is read back: all shapes follow from (B, Wk, RA, RU).
//
// What held the first design back: each window read usable, pL and
// pR of itself and of both neighbours from global memory, twice (anchors
// and extension), the anchors' positions went through global memory and
// back, every window of a run made up to 14 scattered loads of the same
// two anchor lanes, a 4 B rank was written for every window and the merge
// took a thread a window with 64-bit divisions.
//
// Design (K3-K5's warp a read): a lane takes a window, 32 at a time,
// loaded coalesced, the loads of up to kGroup passes out together; the
// window before comes from the lane below by shuffle, lane 0's from the
// last pass. Word c of a read's masks is kept by lane c (Wk <= 1,024), so
// a run's end (a usable window whose next window is not usable or starts
// a run) and every rank is a shift, a shuffle and a prefix popcount of
// those words, with no pass over memory. Then a lane takes a run: its
// start and end are the q-th set bits of the masks (warp_select), and
// both anchors' inputs are loaded before either is stored, so the anchor
// lanes are written coalesced. The extension stages the read's used
// anchor results in the warp's slice of dynamic shared memory with
// coalesced loads, finds each window's run start and end from the masks,
// loads the next pass's flo..rhi while this pass waits on its text rows,
// and reads the end anchor's row beside the start anchor's rather than
// after it; the merge visits undecided windows only. Lanes that are not
// usable get only their usable flag written: K2 reads nothing else of
// them.
//
// What holds it now: the anchors kernel's gathers, whose anchors touch
// nearly every 32-byte sector of the prep's rows (an anchor every 3.5
// windows, 8 windows a sector), and the extension's dependent trip to the
// text rows each pass of 32 windows.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "probe.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// a block's dynamic shared memory past which the extension takes fewer
// warps a block (the card's 227 KB)
constexpr size_t kMaxSmem = 232448;

// kG: words of windows whose loads go out together (ceil(Wk / 32), at
// most fulgor::kGroup)
template <int kG>
__global__ void __launch_bounds__(kThreads, 4) anchored_probe_anchors_kernel(
    fulgor::Lanes in, const int32_t* __restrict__ pL,
    const int32_t* __restrict__ pR, int B, int Wk, int RA,
    fulgor::Lanes outA, uint32_t* __restrict__ smask,
    uint32_t* __restrict__ emask) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int nw = (Wk + 31) >> 5;
  const long long row = static_cast<long long>(b) * Wk;
  const long long lanes = static_cast<long long>(b) * 2 * RA;
  const uint8_t* use = in.usable() + row;
  const int32_t* l = pL + row;
  const int32_t* r = pR + row;

  // usable and run-start ballots; word c kept by lane c; the loads of kG
  // words of windows go out together
  uint32_t uw = 0, sw = 0;
  int pu = 0, pl = 0, pr = 0;  // the window before this pass's first
  for (int c0 = 0; c0 < nw; c0 += kG) {
    int u[kG], a[kG], z[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int w = (c0 + g) * 32 + lane;
      const bool in = w < Wk;
      u[g] = in ? __ldg(use + w) : 0;
      a[g] = in ? __ldg(l + w) : 0;
      z[g] = in ? __ldg(r + w) : 0;
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int c = c0 + g;
      if (c >= nw) break;  // the whole warp
      int qu = __shfl_up_sync(kFull, u[g], 1);
      int qa = __shfl_up_sync(kFull, a[g], 1);
      int qz = __shfl_up_sync(kFull, z[g], 1);
      if (lane == 0) {
        qu = pu;
        qa = pl;
        qz = pr;
      }
      const bool s = u[g] && !(qu && qa == a[g] && qz == z[g]);
      const uint32_t bu = __ballot_sync(kFull, u[g]);
      const uint32_t bs = __ballot_sync(kFull, s);
      if (lane == c) {
        uw = bu;
        sw = bs;
      }
      pu = __shfl_sync(kFull, u[g], 31);
      pl = __shfl_sync(kFull, a[g], 31);
      pr = __shfl_sync(kFull, z[g], 31);
    }
  }
  // a run ends at a usable window whose next is not usable or starts a run
  uint32_t un = __shfl_down_sync(kFull, uw, 1);
  uint32_t sn = __shfl_down_sync(kFull, sw, 1);
  if (lane == 31) un = sn = 0;
  const uint32_t nxt_u = (uw >> 1) | (un << 31);
  const uint32_t nxt_s = (sw >> 1) | (sn << 31);
  const uint32_t ew = uw & ~(nxt_u & ~nxt_s);
  if (lane < nw) {
    smask[static_cast<long long>(b) * nw + lane] = sw;
    emask[static_cast<long long>(b) * nw + lane] = ew;
  }
  int nS, nE;  // nE = nS: a run has one start and one end
  const int preS = fulgor::warp_exclusive_sum(__popc(sw), &nS);
  const int preE = fulgor::warp_exclusive_sum(__popc(ew), &nE);

  // the first RA runs, a lane a run: run q's start and end are the q-th
  // set bits of the masks; its end lane is probed where the run is longer
  // than its start (probeE)
  const int nA = nS < RA ? nS : RA;
  for (int q0 = 0; q0 < nA; q0 += 32) {
    const int q = q0 + lane;
    const int ws = fulgor::warp_select(sw, preS, nw, q < nA ? q : 0);
    const int we = fulgor::warp_select(ew, preE, nw, q < nA ? q : 0);
    if (q < nA) {  // both anchors' loads out before any store
      const bool probeE = we > ws;
      fulgor::Lane vs, ve;
      vs.load(in, row + ws);
      if (probeE) ve.load(in, row + we);
      vs.store(outA, lanes + q);
      if (probeE) ve.store(outA, lanes + RA + q);
      outA.usable()[lanes + q] = 1;
      outA.usable()[lanes + RA + q] = probeE;
    }
  }
  for (int q = nA + lane; q < RA; q += 32) {
    outA.usable()[lanes + q] = 0;
    outA.usable()[lanes + RA + q] = 0;
  }
}

// One anchor lane's K2 want_entry outputs.
struct Anchor {
  const uint8_t *hit, *ovf, *rc;
  const uint32_t* val;
  const int32_t *q, *wlo, *sp;
};

// flags of a staged anchor
constexpr uint8_t kHit = 1, kOvf = 2, kRc = 4;

// the anchor's predicted text position *q for a window d windows on;
// true where the anchor hit and *q lies in its entry's span [wlo, wlo +
// sp): the window verifies where the text there is its k-mer in the
// anchor's orientation
__device__ __forceinline__ bool predicted(const int4& a, uint8_t f, int d,
                                          int* q) {
  *q = f & kRc ? a.y - d : a.y + d;
  return (f & kHit) && *q >= a.z && *q < a.w;
}

// a window's flo, fhi, rlo and rhi (0 past Wk)
__device__ __forceinline__ void fields(const fulgor::Lanes& in,
                                       long long row, int w, int Wk,
                                       uint32_t* v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = w < Wk ? __ldg(in.w[3 + j] + row + w) : 0u;
}

// stage: anchors per side in the warp's slice of shared memory (min(RA,
// Wk): a read has at most Wk runs); each anchor (val, q, wlo, wlo + sp)
// and its flags
__global__ void __launch_bounds__(kThreads, 5) anchored_probe_extend_kernel(
    fulgor::Text text, fulgor::Lanes in, const uint32_t* __restrict__ smask,
    const uint32_t* __restrict__ emask, Anchor anc, int B, int Wk, int RA,
    int RU, int stage, fulgor::Lanes outU, uint8_t* __restrict__ hit,
    uint32_t* __restrict__ csid, uint8_t* __restrict__ ovf,
    uint32_t* __restrict__ umask) {
  extern __shared__ int4 staged[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;  // the whole warp leaves together
  int4* ent = staged + warp * 2 * stage;
  uint8_t* flg = reinterpret_cast<uint8_t*>(staged + warps * 2 * stage) +
                 warp * 2 * stage;
  const int nw = (Wk + 31) >> 5;
  const long long row = static_cast<long long>(b) * Wk;
  const long long lanes = static_cast<long long>(b) * 2 * RA;
  const unsigned below = (1u << lane) - 1u, self = 1u << lane;

  uint32_t sw = 0, ew = 0;
  if (lane < nw) {
    sw = smask[static_cast<long long>(b) * nw + lane];
    ew = emask[static_cast<long long>(b) * nw + lane];
  }
  int nS, nE;
  const int preS = fulgor::warp_exclusive_sum(__popc(sw), &nS);
  const int preE = fulgor::warp_exclusive_sum(__popc(ew), &nE);

  // the read's used anchors, start side at [r], end side at [stage + r]
  const int nA = nS < RA ? nS : RA;
  for (int q = lane; q < 2 * nA; q += 32) {
    const int side = q >= nA, r = q - side * nA;
    const long long j = lanes + side * RA + r;
    const int lo = anc.wlo[j];
    ent[side * stage + r] =
        make_int4(static_cast<int>(anc.val[j]), anc.q[j], lo, lo + anc.sp[j]);
    flg[side * stage + r] = (anc.hit[j] ? kHit : 0) |
                            (anc.ovf[j] ? kOvf : 0) | (anc.rc[j] ? kRc : 0);
  }
  __syncwarp();

  int last_s = 0;  // the last run start before this pass
  int nU = 0;
  uint32_t uw = 0;  // lane c keeps word c of the undecided mask
  // flo..rhi of this pass's windows; the next pass's are loaded while this
  // pass waits on its text rows
  uint32_t cur[4];
  fields(in, row, lane, Wk, cur);
  for (int c = 0; c < nw; ++c) {
    uint32_t nxt[4] = {0, 0, 0, 0};
    if (c + 1 < nw) fields(in, row, (c + 1) * 32 + lane, Wk, nxt);
    const uint32_t sc = __shfl_sync(kFull, sw, c);
    const uint32_t ec = __shfl_sync(kFull, ew, c);
    const int s0 = __shfl_sync(kFull, preS, c), e0 = __shfl_sync(kFull, preE, c);
    // the first run end in a later word, for runs that go on past this pass
    const unsigned later = __ballot_sync(kFull, lane > c && ew != 0);
    const int jl = later ? __ffs(later) - 1 : 0;
    const uint32_t wl = __shfl_sync(kFull, ew, jl);
    const int next_e = later ? jl * 32 + __ffs(wl) - 1 : Wk;

    const int w = c * 32 + lane;
    const long long i = row + w;
    const bool is_start = sc & self, is_end = ec & self;
    const int runid = s0 + __popc(sc & (below | self)) - 1;
    // usable: inside run runid, whose end is not before w
    const bool us = runid >= 0 && runid == e0 + __popc(ec & below);
    const bool in_run = us && runid < RA;
    bool hit0 = false, undec = false, anch_ovf = false;
    uint32_t val0 = fulgor::kInvalid;
    if (in_run) {
      const uint32_t hs = sc & (below | self), he = ec & ~below;
      const int pS = hs ? c * 32 + 31 - __clz(hs) : last_s;
      const int pE = he ? c * 32 + __ffs(he) - 1 : next_e;
      const bool probeE = pE > pS;
      const int4 aS = ent[runid], aE = ent[stage + runid];
      const uint8_t fS = flg[runid], fE = probeE ? flg[stage + runid] : 0;
      const uint32_t f_lo = cur[0], f_hi = cur[1];
      const uint32_t r_lo = cur[2], r_hi = cur[3];
      // both anchors' text rows are read together, the end's whether or
      // not the start's verifies
      int qS, qE;
      const bool tS = predicted(aS, fS, w - pS, &qS);
      const bool tE = predicted(aE, fE, w - pE, &qE);
      const uint4 none = make_uint4(0, 0, 0, 0);
      const uint4 rowS = tS ? text.row(qS) : none;
      const uint4 rowE = tE ? text.row(qE) : none;
      const bool ok1 = tS && text.match(rowS, qS, fS & kRc ? r_lo : f_lo,
                                        fS & kRc ? r_hi : f_hi);
      const bool ok2 = !ok1 && tE &&
                       text.match(rowE, qE, fE & kRc ? r_lo : f_lo,
                                  fE & kRc ? r_hi : f_hi);
      hit0 = ok1 || ok2;
      val0 = static_cast<uint32_t>(ok1 ? aS.x : aE.x);
      const bool hS = fS & kHit, oS = fS & kOvf;
      const bool hE = fE & kHit, oE = fE & kOvf;  // 0 unless probeE
      const bool dec_miss =
          (is_start && !oS && !hS) || (is_end && probeE && !oE && !hE);
      anch_ovf = ((is_start && oS) || (is_end && oE)) && !hit0;
      undec = !hit0 && !dec_miss && !anch_ovf;
    }
    const unsigned bu = __ballot_sync(kFull, undec);
    const int ru = nU + __popc(bu & below);
    nU += __popc(bu);
    if (lane == c) uw = bu;
    if (w < Wk) {
      hit[i] = hit0;
      csid[i] = hit0 ? val0 : fulgor::kInvalid;
      ovf[i] = anch_ovf || (us && !in_run) || (undec && ru >= RU);
    }
    if (undec && ru < RU) {
      const long long d = static_cast<long long>(b) * RU + ru;
      outU.take(in, i, d);
      outU.usable()[d] = 1;
    }
    if (sc) last_s = c * 32 + 31 - __clz(sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
  }
  if (lane < nw) umask[static_cast<long long>(b) * nw + lane] = uw;
  for (int r = (nU < RU ? nU : RU) + lane; r < RU; r += 32)
    outU.usable()[static_cast<long long>(b) * RU + r] = 0;
}

// one warp a read: the reprobe's result on its first RU undecided windows
__global__ void __launch_bounds__(kThreads) anchored_probe_merge_kernel(
    const uint32_t* __restrict__ umask, const uint8_t* __restrict__ hitU,
    const uint32_t* __restrict__ valU, const uint8_t* __restrict__ ovfU,
    int B, int Wk, int RU, uint8_t* __restrict__ hit,
    uint32_t* __restrict__ csid, uint8_t* __restrict__ ovf) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int nw = (Wk + 31) >> 5;
  const uint32_t uw =
      lane < nw ? umask[static_cast<long long>(b) * nw + lane] : 0u;
  int nU;
  const int pre = fulgor::warp_exclusive_sum(__popc(uw), &nU);
  const long long row = static_cast<long long>(b) * Wk;
  const long long lanes = static_cast<long long>(b) * RU;
  for (int c = 0; c < nw; ++c) {
    const int p0 = __shfl_sync(kFull, pre, c);
    if (p0 >= RU) break;
    const uint32_t uc = __shfl_sync(kFull, uw, c);
    const int r = p0 + __popc(uc & ((1u << lane) - 1u));
    if (!((uc >> lane) & 1) || r >= RU) continue;
    const long long i = row + c * 32 + lane, j = lanes + r;
    const bool h = hitU[j];
    hit[i] = h;
    csid[i] = h ? valU[j] : fulgor::kInvalid;
    ovf[i] = ovfU[j];
  }
}

// the extension's warps a block and dynamic shared memory for `stage`
// anchors a side
void extend_shape(int stage, int* warps, size_t* smem) {
  const size_t per = 2 * static_cast<size_t>(stage) * (sizeof(int4) + 1);
  int wp = kWarps;
  while (wp > 1 && wp * per > kMaxSmem) --wp;
  *warps = wp;
  *smem = (wp * per + 15) & ~static_cast<size_t>(15);
}

bool bad_shape(int B, int Wk) {
  return B <= 0 || Wk <= 0 || Wk > fulgor::kMaxWk ||
         static_cast<long long>(B) * Wk >= (1LL << 31);
}

}  // namespace

// in/outA: ten pointers each in K2's order (ops/probe.py probe_lanes);
// outA (B, 2 RA); smask/emask (B, ceil(Wk / 32)) u32, the run-start and
// run-end masks.
extern "C" int fulgor_anchored_anchors(void* const* in, const void* pL,
                                       const void* pR, int B, int Wk, int RA,
                                       void* const* outA, void* smask,
                                       void* emask, void* stream) {
  if (bad_shape(B, Wk) || RA <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = anchored_probe_anchors_kernel<fulgor::kGroup>;
  switch ((Wk + 31) / 32) {
    case 1: kernel = anchored_probe_anchors_kernel<1>; break;
    case 2: kernel = anchored_probe_anchors_kernel<2>; break;
    case 3: kernel = anchored_probe_anchors_kernel<3>; break;
    case 4: kernel = anchored_probe_anchors_kernel<4>; break;
    case 5: kernel = anchored_probe_anchors_kernel<5>; break;
    case 6: kernel = anchored_probe_anchors_kernel<6>; break;
    case 7: kernel = anchored_probe_anchors_kernel<7>; break;
  }
  kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      fulgor::make_lanes(in), static_cast<const int32_t*>(pL),
      static_cast<const int32_t*>(pR), B, Wk, RA, fulgor::make_lanes(outA),
      static_cast<uint32_t*>(smask), static_cast<uint32_t*>(emask));
  return static_cast<int>(cudaGetLastError());
}

// hitA..spA: K2 want_entry's seven outputs on the (B, 2 RA) anchor lanes;
// outU: ten pointers, (B, RU); hit/csid/ovf (B, Wk); umask (B, ceil(Wk /
// 32)) u32, the undecided mask.
extern "C" int fulgor_anchored_extend(
    const void* text32, long long N, void* const* in, const void* smask,
    const void* emask, const void* hitA, const void* valA, const void* ovfA,
    const void* qA, const void* rcA, const void* wloA, const void* spA, int B,
    int Wk, int RA, int RU, int k, void* const* outU, void* hit, void* csid,
    void* ovf, void* umask, void* stream) {
  if (bad_shape(B, Wk) || RA <= 0 || RU <= 0 || N <= 0 || k > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Anchor anc{static_cast<const uint8_t*>(hitA),
                   static_cast<const uint8_t*>(ovfA),
                   static_cast<const uint8_t*>(rcA),
                   static_cast<const uint32_t*>(valA),
                   static_cast<const int32_t*>(qA),
                   static_cast<const int32_t*>(wloA),
                   static_cast<const int32_t*>(spA)};
  const int stage = RA < Wk ? RA : Wk;
  int warps;
  size_t smem;
  extend_shape(stage, &warps, &smem);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        anchored_probe_extend_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  anchored_probe_extend_kernel<<<(B + warps - 1) / warps, warps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      fulgor::make_text(text32, N, k), fulgor::make_lanes(in),
      static_cast<const uint32_t*>(smask), static_cast<const uint32_t*>(emask),
      anc, B, Wk, RA, RU, stage, fulgor::make_lanes(outU),
      static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf), static_cast<uint32_t*>(umask));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fulgor_anchored_merge(const void* umask, const void* hitU,
                                     const void* valU, const void* ovfU,
                                     int B, int Wk, int RU, void* hit,
                                     void* csid, void* ovf, void* stream) {
  if (bad_shape(B, Wk) || RU <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  anchored_probe_merge_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(umask), static_cast<const uint8_t*>(hitU),
      static_cast<const uint32_t*>(valU), static_cast<const uint8_t*>(ovfU), B,
      Wk, RU, static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
