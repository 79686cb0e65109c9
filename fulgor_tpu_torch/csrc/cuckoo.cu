// K7 cuckoo_lookup: every k-window of a packed read batch against the
// quotient cuckoo table of a --dict cuckoo index.
//
// Replaces fulgor_tpu/ops/lookup.py unpack_reads (:55), pack_windows (:68),
// _shr62/_mul62/pi62_u32 (:122-142), probe (:145) and lookup_batch (:186),
// dispatched by dict_probe_packed (fulgor_tpu/ops/pipeline.py:107); the
// plain version is fulgor_tpu_torch/ops/lookup.py cuckoo_lookup_plain.
//
// What bounds it: bytes. Per window it reads at most two 16-byte table
// rows (one where the key sits in its first hash choice) and writes 5
// bytes; the table (16 B a bucket, 2^b buckets) is far larger than L2 at a
// real index, so every row is a gather from HBM, and the ~100 integer
// operations a window (the k-mer, two 62-bit permutations) are small
// beside it.
//
// Design: a block takes kReads reads. Their 2-bit words and bad-bit words
// are staged in shared memory once (pad words past the read are code 0 and
// all-bad), then each thread takes one window at a time: the 32 bases from
// the window's start as one LSB-first 64-bit word, the forward k-mer by a
// 2-bit reversal, the reverse complement by a complement and a mask, the
// smaller of the two as the key. The permutations use native 64-bit
// multiplies (the TPU version's u32 limbs are not carried over). Each hash
// choice is one 16-byte read-only vector load; the second is skipped when
// the first row holds the key (a key sits in exactly one slot).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxW = 1024;
constexpr int kReads = 8;
constexpr int kThreads = 256;
constexpr uint64_t kM62 = (1ull << 62) - 1;
constexpr uint64_t kPi1C1 = 0x9E3779B97F4A7C15ull, kPi1C2 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kPi2C1 = 0x94D049BB133111EBull, kPi2C2 = 0xD6E8FEB86659FD93ull;

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

__device__ __forceinline__ uint64_t pi62(uint64_t x, uint64_t c1, uint64_t c2) {
  x ^= x >> 31;
  x = (x * c1) & kM62;
  x ^= x >> 29;
  x = (x * c2) & kM62;
  return x ^ (x >> 31);
}

__global__ void __launch_bounds__(kThreads) cuckoo_lookup_kernel(
    const int4* __restrict__ table, int b, const uint8_t* __restrict__ codes2,
    const uint8_t* __restrict__ bad, int B, int W, int k,
    uint8_t* __restrict__ hit, int32_t* __restrict__ csid) {
  __shared__ uint32_t words[kReads][kMaxW / 16 + 3];
  __shared__ uint32_t badw[kReads][kMaxW / 32 + 2];

  const int r0 = blockIdx.x * kReads;
  const int nr = min(kReads, B - r0);
  const int nw = W / 16, nbw = W / 32;
  for (int t = threadIdx.x; t < nr * (nw + 3); t += blockDim.x) {
    const int r = t / (nw + 3), j = t - r * (nw + 3);
    uint32_t v = 0;
    if (j < nw) {
      const uint8_t* c2 = codes2 + static_cast<size_t>(r0 + r) * (W / 4) + 4 * j;
      v = c2[0] | (c2[1] << 8) | (c2[2] << 16) |
          (static_cast<uint32_t>(c2[3]) << 24);
    }
    words[r][j] = v;
  }
  for (int t = threadIdx.x; t < nr * (nbw + 2); t += blockDim.x) {
    const int r = t / (nbw + 2), j = t - r * (nbw + 2);
    uint32_t v = 0xFFFFFFFFu;  // positions past the read are pad: bad
    if (j < nbw) {
      const uint8_t* bd = bad + static_cast<size_t>(r0 + r) * (W / 8) + 4 * j;
      v = bd[0] | (bd[1] << 8) | (bd[2] << 16) |
          (static_cast<uint32_t>(bd[3]) << 24);
    }
    badw[r][j] = v;
  }
  __syncthreads();

  const int Wk = W - k + 1;
  const uint64_t kmask = (1ull << (2 * k)) - 1;  // k <= 31
  const uint32_t kbad = (1u << k) - 1;
  const int vb = b + 1;
  const uint64_t val_mask = (1ull << vb) - 1;
  const uint64_t rem_mask = (1ull << (62 - b)) - 1;
  for (int t = threadIdx.x; t < nr * Wk; t += blockDim.x) {
    const int r = t / Wk, p = t - r * Wk;
    bool h = false;
    uint32_t val = 0xFFFFFFFFu;
    if ((bits32(badw[r], p) & kbad) == 0) {
      const uint64_t x = bases64(words[r], p);
      const uint64_t f = rev2_64(x) >> (64 - 2 * k);  // base i at 2(k-1-i)
      const uint64_t rc = (~x) & kmask;               // its reverse complement
      const uint64_t key = f < rc ? f : rc;
      for (int which = 0; which < 2 && !h; ++which) {
        const uint64_t pw = which ? pi62(key, kPi2C1, kPi2C2)
                                  : pi62(key, kPi1C1, kPi1C2);
        const uint64_t rem = pw & rem_mask;
        const int4 row = __ldg(table + (pw >> (62 - b)));
        const uint64_t s0 = (static_cast<uint64_t>(static_cast<uint32_t>(row.y)) << 32) |
                            static_cast<uint32_t>(row.x);
        const uint64_t s1 = (static_cast<uint64_t>(static_cast<uint32_t>(row.w)) << 32) |
                            static_cast<uint32_t>(row.z);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint64_t slot = s ? s1 : s0;
          const uint64_t v = slot & val_mask;
          if (v != val_mask && static_cast<int>(slot >> 63) == which &&
              ((slot >> vb) & rem_mask) == rem) {
            h = true;
            val = static_cast<uint32_t>(v);
          }
        }
      }
    }
    const size_t o = static_cast<size_t>(r0 + r) * Wk + p;
    hit[o] = h;
    csid[o] = static_cast<int32_t>(val);
  }
}

}  // namespace

extern "C" int fulgor_cuckoo_lookup(const void* table, int b, const void* codes2,
                                    const void* bad, int B, int W, int k,
                                    void* hit, void* csid, void* stream) {
  if (B <= 0 || W > kMaxW || W % 32 != 0 || k < 1 || k > 31 || k > W ||
      b < 0 || b > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kReads - 1) / kReads;
  cuckoo_lookup_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), b, static_cast<const uint8_t*>(codes2),
      static_cast<const uint8_t*>(bad), B, W, k, static_cast<uint8_t*>(hit),
      static_cast<int32_t*>(csid));
  return static_cast<int>(cudaGetLastError());
}
