// K2 minidict2_probe: minimizer-dictionary probe with the skew route, one
// thread per window lane.
//
// Replaces fulgor_tpu/ops/minidict2.py _probe_entries (:1126),
// skew_probe_device (:826) and _make_extract33 (:804), with mix32
// (ops/lookup.py:28) and mulhi32 (ops/lookup.py:103, here __umulhi); the
// plain version is fulgor_tpu_torch/ops/probe.py minidict2_probe_plain.
//
// What bounds it: bytes, as dependent random gathers. Each usable lane
// reads its 34 B of prep once, one 96 B slot row (3-4 of its 32 B sectors
// are touched per fingerprint screen, all 8 entries' meta words in
// practice), one 16 B text row per verified candidate, and on the gated
// skew route two 32 B pointer rows plus one 12 B entry and one 16 B text
// row per chased pointer; it writes 6 B. The tables (65 MB at 256 genomes)
// fit the 50 MB L2 only in part, so most gathers are DRAM sectors.
//
// Design: the JAX version materialises every one of the `vb` candidate
// slots for every lane and verifies all of them; here each lane walks its
// slot window once, in slot order (forward before reverse complement), and
// verifies each candidate as it finds it while the budget lasts, stopping
// at the first verified hit: the first candidate that verifies is the one
// JAX's "first j wins" selects, a hit lane has no ovf, and a hit lane never
// takes the skew route, so the outputs are identical with fewer gathers.
// need_sec, the candidate count and the skew pointer list follow the JAX
// definitions exactly (n_occ >= SCAN included; pointers taken over row 1
// then row 2 in entry order; `tie` when both orientations of a chased
// pointer were viable and the probed one missed). Row and text indices
// are clamped where JAX clips them. Budgets are launch arguments.
//
// Two modes of _probe_entries' keyword flags, as compile-time variants of
// the one kernel (template flags), so that the default launch keeps its
// code:
//   kStage1 (stage1=True, the staged probe's stage A, csrc/staged.cu):
//     stop after the slot-window verifies; every lane, usable or not,
//     walks all SCAN slots, so that cnt counts every strand-compatible
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
    long long n, int k, int m, uint32_t num_slots, int vb, int sc,
    uint8_t* __restrict__ hit, uint32_t* __restrict__ csid,
    uint8_t* __restrict__ ovf, int32_t* __restrict__ cnt_out,
    uint8_t* __restrict__ need_out, int32_t* __restrict__ e_q,
    uint8_t* __restrict__ e_rc, int32_t* __restrict__ e_wlo,
    int32_t* __restrict__ e_sp) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const bool use = usable[i];
  if (!kStage1 && !use) {
    hit[i] = 0;
    csid[i] = fulgor::kInvalid;
    ovf[i] = 0;
    if constexpr (kEntry) {
      e_q[i] = 0;
      e_rc[i] = 0;
      e_wlo[i] = 0;
      e_sp[i] = 0;
    }
    return;
  }
  const int il = iL[i], ir = iR[i];
  const bool sl = sigL[i], sr = sigR[i];
  const uint32_t f_lo = flo[i], f_hi = fhi[i], r_lo = rlo[i], r_hi = rhi[i];

  // ---- slot screen: first vb candidates in slot order, verified inline
  const uint32_t kk = fulgor::mix32(minval[i]);
  const long long baseR = __umulhi(kk, num_slots) >> 3;  // ROWW == 8
  const uint32_t fp = kk & 0x7FFF;
  int cnt = 0, n_occ = 0;
  bool need_sec = false, found = false;
  uint32_t val = fulgor::kInvalid;
  int w_q = 0, w_wlo = 0, w_sp = 0;  // the winner's entry (kEntry)
  bool w_rc = false;
  for (int s = 0; s < fulgor::kScan && (kStage1 || !found); ++s) {
    long long rr = baseR + s / fulgor::kRowW;
    rr = rr < 0 ? 0 : (rr > R - 1 ? R - 1 : rr);
    const uint32_t* e = slots + rr * (3 * fulgor::kRowW) + 3 * (s % fulgor::kRowW);
    const uint32_t ms = __ldg(e + 2);
    const int sp = (ms >> 8) & 0x7F;
    const bool cov = (ms >> 15) & 1;
    const uint32_t efp = (ms >> 16) & 0x7FFF;
    const bool st = ms >> 31;
    need_sec |= cov && efp == fp;
    n_occ += (sp > 0) || cov;
    if (kStage1 && !use) continue;  // need_sec only
    if (sp == 0 || efp != fp || cov) continue;
    const int wlo = static_cast<int>(__ldg(e));
    const uint32_t cs = __ldg(e + 1);
    const int mpos = wlo + static_cast<int>(ms & 0xFF);
    int q = mpos - il;
    if (sl == st && q >= wlo && q < wlo + sp) {
      if (++cnt <= vb && !found && text.verify(q, f_lo, f_hi)) {
        found = true;
        val = cs;
        if constexpr (kEntry) {
          w_q = q;
          w_rc = false;
          w_wlo = wlo;
          w_sp = sp;
        }
        if constexpr (!kStage1) break;
      }
    }
    q = mpos - (k - m) + ir;
    if (sr != st && q >= wlo && q < wlo + sp) {
      if (++cnt <= vb && !found && text.verify(q, r_lo, r_hi)) {
        found = true;
        val = cs;
        if constexpr (kEntry) {
          w_q = q;
          w_rc = true;
          w_wlo = wlo;
          w_sp = sp;
        }
      }
    }
  }
  need_sec |= n_occ >= fulgor::kScan;
  if constexpr (kStage1) {
    hit[i] = found;
    csid[i] = found ? val : fulgor::kInvalid;
    cnt_out[i] = cnt;
    need_out[i] = need_sec;
    return;
  }

  // ---- skew route, only for lanes still missing that need it
  const bool gate = !found && need_sec;
  int cnt2 = 0;
  bool tie = false;
  if (gate) {
    const bool take_f = f_hi < r_hi || (f_hi == r_hi && f_lo <= r_lo);
    const uint32_t klo = take_f ? f_lo : r_lo, khi = take_f ? f_hi : r_hi;
    const uint32_t h1 = fulgor::mix32(klo ^ fulgor::mix32(khi ^ fulgor::kSkewSeed1));
    const uint32_t h2 = fulgor::mix32(klo ^ fulgor::mix32(khi ^ fulgor::kSkewSeed2));
    const uint32_t fp8 = h1 & 0xFF;
    int sid[fulgor::kMaxSkewCand];
    for (int t = 0; t < 2; ++t) {
      const uint32_t r = __umulhi(t ? h2 : h1, static_cast<uint32_t>(NR));
      const uint32_t* row = skew + static_cast<long long>(r) * fulgor::kSkewRowW;
      for (int e = 0; e < fulgor::kSkewRowW; ++e) {
        const uint32_t v = __ldg(row + e);
        if (v != 0 && (v & 0xFF) == fp8) {
          if (cnt2 < sc) sid[cnt2] = static_cast<int>(v >> 8) - 1;
          ++cnt2;
        }
      }
    }
    const long long nslot = R * fulgor::kRowW;
    for (int j = 0; j < sc && j < cnt2 && !found; ++j) {
      long long sj = sid[j];
      sj = sj < 0 ? 0 : (sj > nslot - 1 ? nslot - 1 : sj);
      const uint32_t* e = slots + sj * 3;
      const int wlo = static_cast<int>(__ldg(e));
      const uint32_t cs = __ldg(e + 1), ms = __ldg(e + 2);
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
  csid[i] = found ? val : fulgor::kInvalid;
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
  if (n <= 0 || R <= 0 || N <= 0 || NR <= 0 || vb < 0 || sc < 0 ||
      sc > fulgor::kMaxSkewCand || k > 32 || m > k || mode < 0 || mode > 2)
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
      static_cast<const uint32_t*>(rhi), static_cast<const uint8_t*>(usable), n,
      k, m, num_slots, vb, sc, static_cast<uint8_t*>(hit),
      static_cast<uint32_t*>(csid), static_cast<uint8_t*>(ovf),
      // x0 and x1 serve both modes' outputs: each mode writes one group
      static_cast<int32_t*>(x0), static_cast<uint8_t*>(x1),
      static_cast<int32_t*>(x0), static_cast<uint8_t*>(x1),
      static_cast<int32_t*>(x2), static_cast<int32_t*>(x3));
  return static_cast<int>(cudaGetLastError());
}
