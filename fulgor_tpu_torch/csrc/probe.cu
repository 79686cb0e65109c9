// K2 minidict2_probe: minimizer-dictionary probe with the skew route, one
// thread per window lane.
//
// Replaces fulgor_tpu/ops/minidict2.py _probe_entries (:1126),
// skew_probe_device (:826) and _make_extract33 (:804), with mix32
// (ops/lookup.py:28) and mulhi32 (ops/lookup.py:103, here __umulhi); the
// plain version is fulgor_tpu_torch/ops/probe.py minidict2_probe_plain.
//
// What bounds it: bytes, as dependent random gathers. Each usable lane
// reads its 31 B of prep once, one 96 B slot row, one 16 B text row per
// verified candidate, and on the gated skew route two 32 B pointer rows
// plus one 12 B entry and one 16 B text row per chased pointer; it writes
// 6 B. The tables (65 MB at 256 genomes) fit the 50 MB L2 only in part,
// so most gathers are DRAM sectors.
//
// What held the first design back: each lane walked its 8 slots in turn,
// one meta word, then on a fingerprint match the entry and a text row,
// then the next slot, and left at the first hit; every slot cost tens of
// instructions, and a warp took the skew route whenever one of its lanes
// did (about one lane in nine on the main path, so nearly every warp),
// with its pointers kept in local memory. The kernel was held by the
// instructions it issued and its chain of dependent loads, not by bytes.
//
// Design: three dependent rounds of loads on the common path, and few
// instructions a lane. (1) The lane's ten prep fields. (2) Its bucket's
// slot row: SCAN == ROWW, so the slot window is exactly one 96 B row, 16 B
// aligned, read as 16 B vectors; one xor and mask a slot screens the 8 meta
// words for the 15-bit fingerprint into a bit mask (with need_sec and the
// occupied count), and only the matching slots (about one) are walked,
// their entries read again from L1, in the walk order of the JAX version
// (slot order, forward before reverse complement), counting every
// candidate (cnt) and keeping the first two. (3) Those two candidates'
// text rows, issued together; the first that verifies wins, which is
// JAX's "first j wins"; candidates past the second (budgets over 2, rare)
// walk on in order. A hit lane has no ovf and never takes the skew route,
// so the outputs are those of the serial walk; need_sec, cnt and ovf
// follow the JAX definitions exactly (n_occ >= SCAN included). The skew
// route keeps its serial order (pointers over row 1 then row 2 in entry
// order, the first sc chased; `tie` when both orientations of a chased
// pointer were viable and the probed one missed); its two pointer rows are
// read as four 16 B vectors and screened for the 8-bit fingerprint into a
// mask, each chased pointer read again from L1. Row and text indices are
// clamped where JAX clips them. Budgets are launch arguments.
//
// Two modes of _probe_entries' keyword flags, as compile-time variants of
// the one kernel (template flags), so that the default launch keeps its
// code:
//   kStage1 (stage1=True, the staged probe's stage A, csrc/staged.cu):
//     stop after the slot-window verifies; every lane, usable or not,
//     screens its slot row, so that cnt counts every strand-compatible
//     in-span candidate (not capped at vb) and need_sec is that of JAX,
//     unmasked by usable. -> (hit, csid, cnt, need_sec); no skew route.
//   kEntry (want_entry=True, the run-anchored probe, csrc/anchored.cu):
//     the default probe, also writing the winning candidate's (q, rc, wlo,
//     sp) from the slot route or the skew route; 0/false where no
//     candidate won.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;
// lane and row indices are 32-bit (40 registers a thread, 6 blocks an SM)
constexpr long long kMaxLanes = (1LL << 31) - kThreads;
constexpr int kRowVec = 3 * fulgor::kRowW / 4;  // 16 B loads a slot row

static_assert(fulgor::kScan == fulgor::kRowW,
              "the slot window is exactly one row");

using fulgor::Text;

template <bool kStage1, bool kEntry>
__global__ void __launch_bounds__(kThreads) minidict2_probe_kernel(
    const uint32_t* __restrict__ slots, long long R, Text text,
    const uint32_t* __restrict__ skew, long long NR,
    const uint32_t* __restrict__ minval, const int32_t* __restrict__ iL,
    const int32_t* __restrict__ iR, const uint8_t* __restrict__ sigL,
    const uint8_t* __restrict__ sigR, const uint32_t* __restrict__ flo,
    const uint32_t* __restrict__ fhi, const uint32_t* __restrict__ rlo,
    const uint32_t* __restrict__ rhi, const uint8_t* __restrict__ usable,
    uint32_t n, int k, int m, uint32_t num_slots, int vb, int sc,
    uint8_t* __restrict__ hit, uint32_t* __restrict__ csid,
    uint8_t* __restrict__ ovf, int32_t* __restrict__ cnt_out,
    uint8_t* __restrict__ need_out, int32_t* __restrict__ e_q,
    uint8_t* __restrict__ e_rc, int32_t* __restrict__ e_wlo,
    int32_t* __restrict__ e_sp) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // ---- round 1: the lane's ten fields
  const bool use = usable[i];
  const uint32_t mv = minval[i];
  const int il = iL[i], ir = iR[i];
  const bool sl = sigL[i], sr = sigR[i];
  const uint32_t f_lo = flo[i], f_hi = fhi[i], r_lo = rlo[i], r_hi = rhi[i];

  // ---- round 2: the bucket's slot row; a lane that is not usable needs
  // none outside stage1 (which reports need_sec for every lane) and reads
  // row 0, which every such lane shares
  const uint32_t kk = fulgor::mix32(mv);
  const uint32_t fp = kk & 0x7FFF;
  uint32_t rr = __umulhi(kk, num_slots) >> 3;  // ROWW == 8
  rr = rr > R - 1 ? static_cast<uint32_t>(R - 1) : rr;
  if (!kStage1 && !use) rr = 0;
  const uint32_t* erow =
      slots + static_cast<size_t>(rr) * (3 * fulgor::kRowW);
  const uint4* row = reinterpret_cast<const uint4*>(erow);
  uint32_t ent[3 * fulgor::kRowW];
#pragma unroll
  for (int v = 0; v < kRowVec; ++v) {
    const uint4 x = __ldg(row + v);
    ent[4 * v] = x.x;
    ent[4 * v + 1] = x.y;
    ent[4 * v + 2] = x.z;
    ent[4 * v + 3] = x.w;
  }

  // the slot screen on the 8 meta words: the slots whose 15-bit
  // fingerprint matches and which are not covered (fm), need_sec and the
  // occupied count; a lane that is not usable screens nothing
  const uint32_t fpk = fp << 16;
  uint32_t fm = 0;
  int n_occ = 0;
  bool need_sec = false;
#pragma unroll
  for (int s = 0; s < fulgor::kScan; ++s) {
    const uint32_t ms = ent[3 * s + 2];
    const bool fpm = ((ms ^ fpk) & 0x7FFF0000u) == 0;
    const bool cov = ms & 0x8000u;
    need_sec |= cov && fpm;
    n_occ += (ms & 0xFF00u) != 0;  // sp > 0 or covered
    fm |= static_cast<uint32_t>(fpm && !cov) << s;
  }
  need_sec |= n_occ >= fulgor::kScan;
  if (!use) fm = 0;

  // the candidates of the matching slots, in the serial walk's order: slot
  // s forward (candidate 2s), then its reverse complement (2s + 1), their
  // entries read again from L1. cnt counts every candidate; the first two
  // are kept for round 3. A candidate's text position q lies in its
  // entry's span iff 0 <= q - wlo < sp, and q - wlo is the minimizer's
  // offset less the lane's (forward) or plus it, past k - m (reverse).
  int cnt = 0, c0 = 0, c1 = 0, q0 = 0, q1 = 0;
  for (uint32_t f = fm; f != 0; f &= f - 1) {
    const int s = __ffs(f) - 1;
    const int wlo = static_cast<int>(__ldg(erow + 3 * s));
    const uint32_t ms = __ldg(erow + 3 * s + 2);
    const int off = ms & 0xFF;
    const uint32_t sp = (ms >> 8) & 0x7F;
    const bool st = ms >> 31;
    const int df = off - il, dr = off - (k - m) + ir;
    if (sl == st && static_cast<uint32_t>(df) < sp) {
      if (cnt == 0) c0 = 2 * s, q0 = wlo + df;
      if (cnt == 1) c1 = 2 * s, q1 = wlo + df;
      ++cnt;
    }
    if (sr != st && static_cast<uint32_t>(dr) < sp) {
      if (cnt == 0) c0 = 2 * s + 1, q0 = wlo + dr;
      if (cnt == 1) c1 = 2 * s + 1, q1 = wlo + dr;
      ++cnt;
    }
  }

  // ---- round 3: the text rows of the first two candidates together; the
  // first that verifies wins
  bool found = false;
  int win = 0, w_q = 0;
  {
    const bool t0 = cnt > 0 && vb > 0, t1 = cnt > 1 && vb > 1;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const uint4 x0 = t0 ? text.row(q0) : zero;
    const uint4 x1 = t1 ? text.row(q1) : zero;
    if (t0 && text.match(x0, q0, c0 & 1 ? r_lo : f_lo, c0 & 1 ? r_hi : f_hi)) {
      found = true;
      win = c0;
      w_q = q0;
    } else if (t1 && text.match(x1, q1, c1 & 1 ? r_lo : f_lo,
                                c1 & 1 ? r_hi : f_hi)) {
      found = true;
      win = c1;
      w_q = q1;
    }
  }
  // candidates 2 .. min(vb, cnt) - 1 (rare): the walk again
  if (!found && cnt > 2 && vb > 2) {
    int j = 0;
    for (uint32_t f = fm; f != 0 && !found; f &= f - 1) {
      const int s = __ffs(f) - 1;
      const int wlo = static_cast<int>(__ldg(erow + 3 * s));
      const uint32_t ms = __ldg(erow + 3 * s + 2);
      const int off = ms & 0xFF;
      const uint32_t sp = (ms >> 8) & 0x7F;
      const bool st = ms >> 31;
      const int df = off - il, dr = off - (k - m) + ir;
      if (sl == st && static_cast<uint32_t>(df) < sp) {
        if (j >= 2 && j < vb && text.verify(wlo + df, f_lo, f_hi)) {
          found = true;
          win = 2 * s;
          w_q = wlo + df;
        }
        ++j;
      }
      if (!found && sr != st && static_cast<uint32_t>(dr) < sp) {
        if (j >= 2 && j < vb && text.verify(wlo + dr, r_lo, r_hi)) {
          found = true;
          win = 2 * s + 1;
          w_q = wlo + dr;
        }
        ++j;
      }
    }
  }
  uint32_t val = fulgor::kInvalid;
  int w_wlo = 0, w_sp = 0;  // the winner's entry (kEntry)
  bool w_rc = false;
  if (found) {
    const uint32_t* we = erow + 3 * (win >> 1);
    val = __ldg(we + 1);
    w_rc = win & 1;
    if constexpr (kEntry) {
      w_wlo = static_cast<int>(__ldg(we));
      w_sp = (__ldg(we + 2) >> 8) & 0x7F;
    }
  }
  if constexpr (kStage1) {
    hit[i] = found;
    csid[i] = val;
    cnt_out[i] = cnt;
    need_out[i] = need_sec;
    return;
  }

  // ---- skew route, only for usable lanes still missing that need it
  const bool gate = use && !found && need_sec;
  int cnt2 = 0;
  bool tie = false;
  if (gate) {
    const bool take_f = f_hi < r_hi || (f_hi == r_hi && f_lo <= r_lo);
    const uint32_t klo = take_f ? f_lo : r_lo, khi = take_f ? f_hi : r_hi;
    const uint32_t h1 = fulgor::mix32(klo ^ fulgor::mix32(khi ^ fulgor::kSkewSeed1));
    const uint32_t h2 = fulgor::mix32(klo ^ fulgor::mix32(khi ^ fulgor::kSkewSeed2));
    const uint32_t fp8 = h1 & 0xFF;
    const uint32_t NR32 = static_cast<uint32_t>(NR);
    // the pointers of both rows whose 8-bit fingerprint matches, as a mask
    // in (row 1, row 2) entry order; the rows read as 16 B vectors
    const uint32_t* prow[2] = {
        skew + static_cast<long long>(__umulhi(h1, NR32)) * fulgor::kSkewRowW,
        skew + static_cast<long long>(__umulhi(h2, NR32)) * fulgor::kSkewRowW};
    uint32_t pm = 0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(prow[v >> 1]) +
                            (v & 1));
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        pm |= static_cast<uint32_t>(w[t] != 0 && (w[t] & 0xFF) == fp8)
              << (4 * v + t);
    }
    cnt2 = __popc(pm);
    // the first sc of them chased in order, each pointer read again (L1)
    const long long nslot = R * fulgor::kRowW;
    int j = 0;
    for (uint32_t f = pm; f != 0 && j < sc && !found; f &= f - 1, ++j) {
      const int e = __ffs(f) - 1;
      long long sj = static_cast<long long>(
                         __ldg(prow[e >> 3] + (e & 7)) >> 8) - 1;
      sj = sj < 0 ? 0 : (sj > nslot - 1 ? nslot - 1 : sj);
      const uint32_t* ent = slots + sj * 3;
      const int wlo = static_cast<int>(__ldg(ent));
      const uint32_t cs = __ldg(ent + 1), ms = __ldg(ent + 2);
      const int sp = (ms >> 8) & 0x7F;
      const bool st = ms >> 31;
      const int mpos = wlo + static_cast<int>(ms & 0xFF);
      const int qf = mpos - il, qr = mpos - (k - m) + ir;
      const bool cf = sp > 0 && qf >= wlo && qf < wlo + sp && sl == st;
      const bool cr = sp > 0 && qr >= wlo && qr < wlo + sp && sr != st;
      if (!(cf || cr)) continue;
      if (cf ? text.verify(qf, f_lo, f_hi) : text.verify(qr, r_lo, r_hi)) {
        found = true;
        val = cs;
        if constexpr (kEntry) {
          w_q = cf ? qf : qr;
          w_rc = !cf;
          w_wlo = wlo;
          w_sp = sp;
        }
      } else if (cf && cr) {
        tie = true;
      }
    }
  }
  hit[i] = found;
  csid[i] = val;
  ovf[i] = !found && (cnt > vb || (gate && (cnt2 > sc || tie)));
  if constexpr (kEntry) {
    e_q[i] = w_q;
    e_rc[i] = w_rc;
    e_wlo[i] = w_wlo;
    e_sp[i] = w_sp;
  }
}

}  // namespace

// mode 0: the default probe; 1: stage1, x0 = cnt (int32), x1 = need_sec
// (bool), ovf unused; 2: want_entry, x0..x3 = q, rc, wlo, sp.
extern "C" int fulgor_minidict2_probe(
    const void* slots, long long R, const void* text32, long long N,
    const void* skew, long long NR, const void* minval, const void* iL,
    const void* iR, const void* sigL, const void* sigR, const void* flo,
    const void* fhi, const void* rlo, const void* rhi, const void* usable,
    long long n, int k, int m, uint32_t num_slots, int vb, int sc, int mode,
    void* hit, void* csid, void* ovf, void* x0, void* x1, void* x2, void* x3,
    void* stream) {
  // slot, text and skew pointer rows are read as 16 B vectors
  if (n <= 0 || n > kMaxLanes || R <= 0 || N <= 0 || NR <= 0 || vb < 0 ||
      sc < 0 || sc > fulgor::kMaxSkewCand || k > 32 || m > k || mode < 0 ||
      mode > 2 ||
      reinterpret_cast<uintptr_t>(slots) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(text32) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(skew) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Text text = fulgor::make_text(text32, N, k);
  const long long blocks = (n + kThreads - 1) / kThreads;
  auto kernel = mode == 0   ? minidict2_probe_kernel<false, false>
                : mode == 1 ? minidict2_probe_kernel<true, false>
                            : minidict2_probe_kernel<false, true>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(slots), R, text,
      static_cast<const uint32_t*>(skew), NR,
      static_cast<const uint32_t*>(minval), static_cast<const int32_t*>(iL),
      static_cast<const int32_t*>(iR), static_cast<const uint8_t*>(sigL),
      static_cast<const uint8_t*>(sigR), static_cast<const uint32_t*>(flo),
      static_cast<const uint32_t*>(fhi), static_cast<const uint32_t*>(rlo),
      static_cast<const uint32_t*>(rhi), static_cast<const uint8_t*>(usable),
      static_cast<uint32_t>(n), k, m, num_slots, vb, sc,
      static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf),
      // x0 and x1 serve both modes' outputs: each mode writes one group
      static_cast<int32_t*>(x0), static_cast<uint8_t*>(x1),
      static_cast<int32_t*>(x0), static_cast<uint8_t*>(x1),
      static_cast<int32_t*>(x2), static_cast<int32_t*>(x3));
  return static_cast<int>(cudaGetLastError());
}
