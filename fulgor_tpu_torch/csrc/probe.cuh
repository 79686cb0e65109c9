// Shared pieces of the probe kernels: K2 (probe.cu) and the two probes
// built on it, K10 (staged.cu) and K11 (anchored.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fulgor {

// The dictionary's text, 16 bases a u32, four words a row, with the mask
// of a k-mer's two packed halves.
struct Text {
  const uint4* rows;
  long long n;
  uint32_t lo_mask, hi_mask;

  // the 16-byte text row that holds base q's 33-base extract (clamped
  // where _make_extract33 clips)
  __device__ __forceinline__ uint4 row(int q) const {
    long long r = q >> 5;
    r = r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
    return __ldg(rows + r);
  }

  // the 33-base extract of _make_extract33 from its row, compared to a
  // k-mer packing
  __device__ __forceinline__ bool match(const uint4& t, int q,
                                        uint32_t want_lo,
                                        uint32_t want_hi) const {
    const uint32_t sh = 2u * static_cast<uint32_t>(q & 31);
    const bool big = sh >= 32;
    const uint32_t s2 = big ? sh - 32 : sh;
    const uint32_t a0 = big ? t.y : t.x;
    const uint32_t a1 = big ? t.z : t.y;
    const uint32_t a2 = big ? t.w : t.z;
    const uint32_t lo = s2 ? (a0 >> s2) | (a1 << (32 - s2)) : a0;
    const uint32_t hi = s2 ? (a1 >> s2) | (a2 << (32 - s2)) : a1;
    return (lo & lo_mask) == want_lo && (hi & hi_mask) == want_hi;
  }

  __device__ __forceinline__ bool verify(int q, uint32_t want_lo,
                                         uint32_t want_hi) const {
    return match(row(q), q, want_lo, want_hi);
  }
};

inline Text make_text(const void* text32, long long N, int k) {
  const uint32_t lo_mask = 2 * k >= 32 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1;
  const uint32_t hi_mask = 2 * k > 32 ? (1u << (2 * k - 32)) - 1 : 0u;
  return Text{static_cast<const uint4*>(text32), N, lo_mask, hi_mask};
}

// The ten probe inputs of one array of lanes, in K2's argument order
// (minval, iL, iR, sigL, sigR, flo, fhi, rlo, rhi, usable): the 32-bit
// fields in `w` (minval, iL, iR, flo, fhi, rlo, rhi), the flags in `f`
// (sigL, sigR, usable).
struct Lanes;

// One lane's probe inputs but usable, held in registers.
struct Lane {
  uint32_t w[7];
  uint8_t f[2];
  // lane s of `src`, read-only for the kernel (K10's and K11's window
  // prep): the nine loads go out together, ahead of any store
  __device__ __forceinline__ void load(const Lanes& src, long long s);
  __device__ __forceinline__ void store(const Lanes& dst, long long d) const;
};

struct Lanes {
  uint32_t* w[7];
  uint8_t* f[3];

  // copy lane s of `src` into lane d, all but usable
  __device__ __forceinline__ void take(const Lanes& src, long long s,
                                       long long d) const {
    Lane v;
    v.load(src, s);
    v.store(*this, d);
  }
  __device__ __forceinline__ uint8_t* usable() const { return f[2]; }
};

__device__ __forceinline__ void Lane::load(const Lanes& src, long long s) {
#pragma unroll
  for (int j = 0; j < 7; ++j) w[j] = __ldg(src.w[j] + s);
  f[0] = __ldg(src.f[0] + s);
  f[1] = __ldg(src.f[1] + s);
}

__device__ __forceinline__ void Lane::store(const Lanes& dst,
                                            long long d) const {
#pragma unroll
  for (int j = 0; j < 7; ++j) dst.w[j][d] = w[j];
  dst.f[0][d] = f[0];
  dst.f[1][d] = f[1];
}

// Lanes from ten pointers in K2's argument order.
inline Lanes make_lanes(void* const* p) {
  Lanes l;
  const int wi[7] = {0, 1, 2, 5, 6, 7, 8};
  for (int j = 0; j < 7; ++j) l.w[j] = static_cast<uint32_t*>(p[wi[j]]);
  l.f[0] = static_cast<uint8_t*>(p[3]);
  l.f[1] = static_cast<uint8_t*>(p[4]);
  l.f[2] = static_cast<uint8_t*>(p[9]);
  return l;
}

// K10 and K11 keep a read's window masks one 32-bit word a lane: a read
// of at most 32 words of windows.
constexpr int kMaxWk = 1024;

// Words of windows whose loads a warp sends out together.
constexpr int kGroup = 8;

// The position of the r-th set bit (from 0) of a read's mask, kept one
// word a lane (word c in lane c, nw words), with each word's exclusive
// prefix count `pre` in the same lane; every lane of the warp takes part,
// each with its own r below the mask's count.
__device__ __forceinline__ int warp_select(uint32_t word, int pre, int nw,
                                           int r) {
  int c = 0;
  for (int j = 1; j < nw; ++j)
    if (__shfl_sync(0xFFFFFFFFu, pre, j) <= r) c = j;
  const uint32_t wc = __shfl_sync(0xFFFFFFFFu, word, c);
  const int pc = __shfl_sync(0xFFFFFFFFu, pre, c);
  return c * 32 + static_cast<int>(__fns(wc, 0, r - pc + 1));
}

// The warp's exclusive prefix sum of v over its lanes; *total the sum.
__device__ __forceinline__ int warp_exclusive_sum(int v, int* total) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  *total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  return incl - v;
}

}  // namespace fulgor
