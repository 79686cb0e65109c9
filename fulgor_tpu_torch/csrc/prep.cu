// K1 window_prep: per-window k-mer packings and minimizers of a packed read
// batch.
//
// Replaces fulgor_tpu/ops/minidict2.py words_from_packed (:945),
// _extract_all (:962), _extract_bits_all (:987), _rev2_32 (:909) and
// _window_prep_from_words (:1004); the plain version is
// fulgor_tpu_torch/ops/prep.py window_prep_plain.
//
// What bounds it: bytes. Per read it reads W/4 + W/8 bytes and writes
// 12 outputs of 4 or 1 bytes for each of the Wk windows (34 B per window at
// the main path's shapes), so the output stores are ~98% of the traffic;
// the arithmetic (one mix32 pair per m-mer, a w-wide minimum per window)
// is small beside it.
//
// Design: one block per read. The read's 2-bit words and bad-bit words are
// staged in shared memory once (pad words beyond the read are code 0 and
// all-bad, as the JAX version pads them); every m-mer hash and strand bit
// is computed once into shared memory, then each window takes its sliding
// minimum from there (leftmost argmin on a strict <, rightmost on <=). All
// 64-bit packings use native uint64_t and a bit reversal (__brevll) with a
// pair swap in place of the JAX 2-bit butterfly; consecutive threads own
// consecutive windows so every output store is coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kMaxW = 1024;
constexpr int kThreads = 128;

__device__ __forceinline__ uint64_t rev2_64(uint64_t x) {
  // reverse the 32 2-bit groups: reverse all bits, then swap each pair back
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// the 32 bases [q, q + 32) as one LSB-first 64-bit word
__device__ __forceinline__ uint64_t bases64(const uint32_t* words, int q) {
  const int i = q >> 4, s = 2 * (q & 15);
  const uint32_t w0 = words[i], w1 = words[i + 1], w2 = words[i + 2];
  const uint32_t lo = s ? (w0 >> s) | (w1 << (32 - s)) : w0;
  const uint32_t hi = s ? (w1 >> s) | (w2 << (32 - s)) : w1;
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// the 32 bad bits of bases [q, q + 32)
__device__ __forceinline__ uint32_t bits32(const uint32_t* badw, int q) {
  const int i = q >> 5, a = q & 31;
  return a ? (badw[i] >> a) | (badw[i + 1] << (32 - a)) : badw[i];
}

__global__ void __launch_bounds__(kThreads) window_prep_kernel(
    const uint8_t* __restrict__ codes2, const uint8_t* __restrict__ bad,
    int W, int k, int m, uint32_t* __restrict__ minval, int32_t* __restrict__ iL,
    int32_t* __restrict__ iR, int32_t* __restrict__ pL, int32_t* __restrict__ pR,
    uint8_t* __restrict__ sigL, uint8_t* __restrict__ sigR,
    uint32_t* __restrict__ flo, uint32_t* __restrict__ fhi,
    uint32_t* __restrict__ rlo, uint32_t* __restrict__ rhi,
    uint8_t* __restrict__ usable) {
  __shared__ uint32_t words[kMaxW / 16 + 3];
  __shared__ uint32_t badw[kMaxW / 32 + 2];
  __shared__ uint32_t hsh[kMaxW];
  __shared__ uint8_t tf[kMaxW];

  const int b = blockIdx.x;
  const int nw = W / 16, nb = W / 32;
  const int Wk = W - k + 1, Wm = W - m + 1, w = k - m + 1;
  const uint8_t* c2 = codes2 + static_cast<size_t>(b) * (W / 4);
  const uint8_t* bd = bad + static_cast<size_t>(b) * (W / 8);

  for (int j = threadIdx.x; j < nw + 3; j += blockDim.x) {
    uint32_t v = 0;
    if (j < nw)
      v = c2[4 * j] | (c2[4 * j + 1] << 8) | (c2[4 * j + 2] << 16) |
          (static_cast<uint32_t>(c2[4 * j + 3]) << 24);
    words[j] = v;
  }
  for (int j = threadIdx.x; j < nb + 2; j += blockDim.x) {
    uint32_t v = 0xFFFFFFFFu;  // positions past the read are pad: bad
    if (j < nb)
      v = bd[4 * j] | (bd[4 * j + 1] << 8) | (bd[4 * j + 2] << 16) |
          (static_cast<uint32_t>(bd[4 * j + 3]) << 24);
    badw[j] = v;
  }
  __syncthreads();

  // canonical m-mer hash and strand at every m-mer position
  const uint64_t mmask = (1ull << (2 * m)) - 1;  // m < 32
  const uint32_t mbad = (1u << m) - 1;
  for (int q = threadIdx.x; q < Wm; q += blockDim.x) {
    const uint64_t x = bases64(words, q);
    const uint64_t fwd = rev2_64(x) >> (64 - 2 * m);  // big-endian m-mer
    const uint64_t rc = (~x) & mmask;                 // its reverse complement
    const bool take_f = fwd <= rc;
    const uint64_t can = take_f ? fwd : rc;
    uint32_t h = fulgor::mix32(static_cast<uint32_t>(can) ^
                               fulgor::mix32(static_cast<uint32_t>(can >> 32) ^
                                             fulgor::kSeedM));
    if (h == 0xFFFFFFFFu) h = 0xFFFFFFFEu;
    if (bits32(badw, q) & mbad) h = 0xFFFFFFFFu;
    hsh[q] = h;
    tf[q] = take_f;
  }
  __syncthreads();

  const uint64_t kmask = k >= 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const uint32_t kbad = k >= 32 ? 0xFFFFFFFFu : (1u << k) - 1;
  for (int p = threadIdx.x; p < Wk; p += blockDim.x) {
    const uint64_t x = bases64(words, p);
    const uint64_t f = x & kmask;
    const uint64_t r = rev2_64(~x) >> (64 - 2 * k);
    const bool okw = (bits32(badw, p) & kbad) == 0;
    uint32_t v = hsh[p];
    int jl = 0, jr = 0;
    for (int j = 1; j < w; ++j) {
      const uint32_t hj = hsh[p + j];
      if (hj < v) {
        v = hj;
        jl = j;
        jr = j;
      } else if (hj == v) {
        jr = j;
      }
    }
    const size_t o = static_cast<size_t>(b) * Wk + p;
    minval[o] = v;
    iL[o] = jl;
    iR[o] = jr;
    pL[o] = p + jl;
    pR[o] = p + jr;
    sigL[o] = tf[p + jl];
    sigR[o] = tf[p + jr];
    flo[o] = static_cast<uint32_t>(f);
    fhi[o] = static_cast<uint32_t>(f >> 32);
    rlo[o] = static_cast<uint32_t>(r);
    rhi[o] = static_cast<uint32_t>(r >> 32);
    usable[o] = okw && v != 0xFFFFFFFFu;
  }
}

}  // namespace

extern "C" int fulgor_window_prep(
    const void* codes2, const void* bad, int B, int W, int k, int m,
    void* minval, void* iL, void* iR, void* pL, void* pR, void* sigL,
    void* sigR, void* flo, void* fhi, void* rlo, void* rhi, void* usable,
    void* stream) {
  if (B <= 0 || W > kMaxW || W % 32 != 0 || k > 32 || m >= 32 || m > k ||
      k > W)
    return static_cast<int>(cudaErrorInvalidValue);
  window_prep_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes2), static_cast<const uint8_t*>(bad), W,
      k, m, static_cast<uint32_t*>(minval), static_cast<int32_t*>(iL),
      static_cast<int32_t*>(iR), static_cast<int32_t*>(pL),
      static_cast<int32_t*>(pR), static_cast<uint8_t*>(sigL),
      static_cast<uint8_t*>(sigR), static_cast<uint32_t*>(flo),
      static_cast<uint32_t*>(fhi), static_cast<uint32_t*>(rlo),
      static_cast<uint32_t*>(rhi), static_cast<uint8_t*>(usable));
  return static_cast<int>(cudaGetLastError());
}
