// K14 minidict_v1_verify: the bucket and candidate loop of the v1
// minimizer dictionary's device lookup.
//
// Replaces fulgor_tpu/ops/minidict.py lookup_minidict_batch (:325), its
// lines 397-446; the plain version is fulgor_tpu_torch/ops/minidict.py
// minidict_v1_verify_plain (and lookup_minidict_batch_plain for the whole
// function).
//
// Design: K14 takes its inputs from kernels that already compute the same
// definitions bit for bit. K8 pack_codes packs the reads and K1
// window_prep gives each window its minimal canonical m-mer hash
// (minval), the offsets of its leftmost and rightmost occurrence (iL, iR),
// its forward and reverse-complement LSB-first packings and `usable` (all
// k bases valid and minval not the poison value): the reference's lines
// 343-395. K1 handles widths up to 1,024 in multiples of 32, so the
// wrapper cuts longer reads into pieces overlapping by k - 1
// (lookup_in_pieces). K14 does the rest, one thread a window, consecutive
// threads on consecutive windows, so that its reads of K1's fields and its
// three output stores are coalesced:
//
//   bucket = minval & (NB - 1); (start, cnt) = bucket_offs[bucket];
//   ovf = usable && cnt > max_candidates (then no hit);
//   for each entry e < cnt in order, forward then reverse complement:
//     q = wlo + moff - iL          (forward)
//     q = wlo + moff - (k - m) + iR (reverse complement)
//     a strand matches iff wlo <= q < wlo + span and the 2k-bit text k-mer
//     at q (text16 row q >> 4, shifted by 2 (q & 15)) equals the packing;
//   the first match wins: hit, csid = the entry's csid; else INVALID.
//
// What bounds it: bytes. A window reads 1 B of usable; a usable one 4 B of
// minval and an 8 B bucket row; one with candidates 24 B more of K1's
// fields, a 12 B entry a candidate examined and a 12 B text row a strand in
// range; it writes 6 B. The bucket, entry and text gathers land at random
// places in tables far larger than L2, so each costs a 32-byte sector;
// the arithmetic (a few shifts and compares a candidate) is small beside
// them.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;

// the 2k-bit text k-mer at base q equals (want_lo, want_hi)
__device__ __forceinline__ bool text_matches(
    const uint32_t* __restrict__ text16, long long nrows, long long q,
    uint32_t want_lo, uint32_t want_hi, uint32_t lo_mask, uint32_t hi_mask) {
  long long r = q >> 4;
  r = r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
  const uint32_t* row = text16 + 3 * r;
  const uint32_t w0 = __ldg(row), w1 = __ldg(row + 1), w2 = __ldg(row + 2);
  const int s = 2 * static_cast<int>(q & 15);
  const uint32_t lo = s ? (w0 >> s) | (w1 << (32 - s)) : w0;
  const uint32_t hi = s ? (w1 >> s) | (w2 << (32 - s)) : w1;
  return (lo & lo_mask) == want_lo && (hi & hi_mask) == want_hi;
}

__global__ void __launch_bounds__(kThreads) minidict_v1_verify_kernel(
    const uint32_t* __restrict__ entries, long long num_entries,
    const uint2* __restrict__ bucket_offs, uint32_t nb_mask,
    const uint32_t* __restrict__ text16, long long nrows,
    const uint32_t* __restrict__ minval, const int32_t* __restrict__ iL,
    const int32_t* __restrict__ iR, const uint32_t* __restrict__ flo,
    const uint32_t* __restrict__ fhi, const uint32_t* __restrict__ rlo,
    const uint32_t* __restrict__ rhi, const uint8_t* __restrict__ usable,
    long long n, int k, int m, int max_cand, uint32_t lo_mask,
    uint32_t hi_mask, uint8_t* __restrict__ hit, uint32_t* __restrict__ csid,
    uint8_t* __restrict__ ovf) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool h = false, of = false;
  uint32_t val = fulgor::kInvalid;
  if (usable[i]) {
    const uint2 bo = __ldg(bucket_offs + (minval[i] & nb_mask));
    of = bo.y > static_cast<uint32_t>(max_cand);
    const long long ne = of ? 0 : static_cast<long long>(bo.y);
    if (ne > 0) {
      const long long jl = iL[i], jr = iR[i];
      const uint32_t f0 = flo[i], f1 = fhi[i], r0 = rlo[i], r1 = rhi[i];
      for (long long e = bo.x, end = bo.x + ne; e < end && !h; ++e) {
        if (e >= num_entries) break;  // a malformed bucket row: no read
        const uint32_t* ent = entries + 3 * e;
        const long long wlo = __ldg(ent);
        const uint32_t cs = __ldg(ent + 1), ms = __ldg(ent + 2);
        const long long mpos = wlo + (ms & 0xFFu), stop = wlo + (ms >> 8);
        long long q = mpos - jl;
        if (q >= wlo && q < stop &&
            text_matches(text16, nrows, q, f0, f1, lo_mask, hi_mask)) {
          h = true;
          val = cs;
          break;
        }
        q = mpos - (k - m) + jr;
        if (q >= wlo && q < stop &&
            text_matches(text16, nrows, q, r0, r1, lo_mask, hi_mask)) {
          h = true;
          val = cs;
        }
      }
    }
  }
  hit[i] = h;
  csid[i] = val;
  ovf[i] = of;
}

}  // namespace

extern "C" int fulgor_minidict_v1_verify(
    const void* entries, long long num_entries, const void* bucket_offs,
    long long nb, const void* text16, long long nrows, const void* minval,
    const void* iL, const void* iR, const void* flo, const void* fhi,
    const void* rlo, const void* rhi, const void* usable, long long n, int k,
    int m, int max_cand, void* hit, void* csid, void* ovf, void* stream) {
  if (n <= 0 || num_entries < 0 || nb < 2 || (nb & (nb - 1)) != 0 ||
      nb > (1ll << 32) || nrows < 1 || m < 1 || m > k || k > 32 ||
      max_cand < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bits = 2 * k;
  const uint32_t lo_mask =
      bits < 32 ? (1u << bits) - 1 : 0xFFFFFFFFu;
  const uint32_t hi_mask =
      bits <= 32 ? 0u : (bits < 64 ? (1u << (bits - 32)) - 1 : 0xFFFFFFFFu);
  const long long blocks = (n + kThreads - 1) / kThreads;
  minidict_v1_verify_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(entries), num_entries,
      static_cast<const uint2*>(bucket_offs),
      static_cast<uint32_t>(nb - 1), static_cast<const uint32_t*>(text16),
      nrows, static_cast<const uint32_t*>(minval),
      static_cast<const int32_t*>(iL), static_cast<const int32_t*>(iR),
      static_cast<const uint32_t*>(flo), static_cast<const uint32_t*>(fhi),
      static_cast<const uint32_t*>(rlo), static_cast<const uint32_t*>(rhi),
      static_cast<const uint8_t*>(usable), n, k, m, max_cand, lo_mask,
      hi_mask, static_cast<uint8_t*>(hit), static_cast<uint32_t*>(csid),
      static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
