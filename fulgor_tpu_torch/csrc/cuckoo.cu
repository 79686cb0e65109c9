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
// real index, so every row is a gather from HBM (a 32-byte sector at
// least), and the ~100 integer operations a window (the k-mer, two 62-bit
// permutations) are small beside it.
//
// What holds it: those gathers, random reads of device memory at the L2's
// fetch size (64 bytes). With a table that L2 holds the same kernel takes
// well under half the time (chip_smoke.py's k7_in_l2); taking 1 to 5
// windows a lane at once, 4 to 16 warps a block, a grid of resident
// blocks only, L1-bypassing or streaming loads, or a 32-byte L2 fetch
// moved its time by a few percent at most. The first design (a block of
// 256 threads staging 8 reads' codes with 1-byte loads behind a block
// barrier, then a thread a window at a time, one gather in flight and the
// second choice waiting on the first) ran as fast.
//
// Design: one warp a read, kWarps reads a block, no block barrier. The warp
// stages its read's 2-bit words and bad-bit words in its slice of shared
// memory with one coalesced 4-byte load a lane a row (pad words past the
// read are code 0 and all-bad). A lane then takes kJ windows at once,
// windows lane, lane + 32, ..: for each, the 32 bases from the window's
// start as one LSB-first 64-bit word, the forward k-mer by a 2-bit
// reversal, the reverse complement by a complement and a mask, the
// smaller of the two as the key. It issues every first-choice row load of
// its kJ windows before it consumes any, computing the second choices
// while they load, then the second-choice loads of the windows whose first
// row does not hold the key, together (a key sits in exactly one slot, so
// the second row is read only where needed). The permutations use native
// 64-bit multiplies (the TPU version's u32 limbs are not carried over).
// Hit bytes and csids are stored a row of 32 windows at a time, coalesced.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxW = 1024;
// reads a block, a warp each
constexpr int kWarps = 8;
// windows a lane takes at once, a row of 32 windows each: the main path's
// Wk = 130 (W = 160, k = 31) in one pass
constexpr int kJ = 5;
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

// The quotient table's geometry: 2^b buckets, a slot [value (b + 1 bits) |
// remainder (62 - b bits) | which (bit 63)].
struct Geometry {
  int b, vb;
  uint64_t val_mask, rem_mask;
};

// Whether row holds the key of remainder rem in hash choice `which`; its
// value into val where it does.
__device__ __forceinline__ bool row_holds(const int4& row, uint64_t rem,
                                          int which, const Geometry& g,
                                          uint32_t& val) {
  bool h = false;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t lo = static_cast<uint32_t>(s ? row.z : row.x);
    const uint32_t hi = static_cast<uint32_t>(s ? row.w : row.y);
    const uint64_t slot = (static_cast<uint64_t>(hi) << 32) | lo;
    const uint64_t v = slot & g.val_mask;
    if (v != g.val_mask && static_cast<int>(slot >> 63) == which &&
        ((slot >> g.vb) & g.rem_mask) == rem) {
      h = true;
      val = static_cast<uint32_t>(v);
    }
  }
  return h;
}

__global__ void __launch_bounds__(kWarps * 32) cuckoo_lookup_kernel(
    const int4* __restrict__ table, int b, const uint8_t* __restrict__ codes2,
    const uint8_t* __restrict__ bad, int B, int W, int k,
    uint8_t* __restrict__ hit, int32_t* __restrict__ csid) {
  __shared__ uint32_t words_all[kWarps][kMaxW / 16 + 3];
  __shared__ uint32_t badw_all[kWarps][kMaxW / 32 + 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= B) return;  // the whole warp
  uint32_t* words = words_all[warp];
  uint32_t* badw = badw_all[warp];
  const int nw = W / 16, nbw = W / 32;
  // rows are 4-byte aligned: W / 4 and W / 8 bytes, W a multiple of 32
  const auto* c2 = reinterpret_cast<const uint32_t*>(codes2 + r * (W / 4));
  const auto* bd = reinterpret_cast<const uint32_t*>(bad + r * (W / 8));
  for (int j = lane; j < nw + 3; j += 32)
    words[j] = j < nw ? __ldg(c2 + j) : 0u;
  // positions past the read are pad: bad
  for (int j = lane; j < nbw + 2; j += 32)
    badw[j] = j < nbw ? __ldg(bd + j) : 0xFFFFFFFFu;
  __syncwarp();

  const int Wk = W - k + 1;
  const uint64_t kmask = (1ull << (2 * k)) - 1;  // k <= 31
  const uint32_t kbad = (1u << k) - 1;
  const Geometry g{b, b + 1, (1ull << (b + 1)) - 1, (1ull << (62 - b)) - 1};
  uint8_t* hrow = hit + r * Wk;
  int32_t* crow = csid + r * Wk;
  for (int p0 = 0; p0 < Wk; p0 += 32 * kJ) {
    // a valid window whose key is not found yet; the remainder of its
    // first choice and its second choice's permuted value
    bool live[kJ];
    uint64_t rem1[kJ], pw2[kJ];
    int4 row[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int p = p0 + 32 * j + lane;
      live[j] = p < Wk && (bits32(badw, p) & kbad) == 0;
      const uint64_t x = live[j] ? bases64(words, p) : 0;
      const uint64_t f = rev2_64(x) >> (64 - 2 * k);  // base i at 2(k-1-i)
      const uint64_t rc = (~x) & kmask;               // its reverse complement
      const uint64_t key = f < rc ? f : rc;
      const uint64_t pw1 = pi62(key, kPi1C1, kPi1C2);
      row[j] = live[j] ? __ldg(table + (pw1 >> (62 - b))) : int4{};
      rem1[j] = pw1 & g.rem_mask;
      pw2[j] = pi62(key, kPi2C1, kPi2C2);  // while the first rows load
    }
    uint32_t val[kJ];
    bool h[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      val[j] = 0xFFFFFFFFu;
      h[j] = live[j] && row_holds(row[j], rem1[j], 0, g, val[j]);
      live[j] = live[j] && !h[j];
      row[j] = live[j] ? __ldg(table + (pw2[j] >> (62 - b))) : int4{};
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int p = p0 + 32 * j + lane;
      if (live[j]) h[j] = row_holds(row[j], pw2[j] & g.rem_mask, 1, g, val[j]);
      if (p < Wk) {
        hrow[p] = h[j];
        crow[p] = static_cast<int32_t>(h[j] ? val[j] : 0xFFFFFFFFu);
      }
    }
  }
}

}  // namespace

extern "C" int fulgor_cuckoo_lookup(const void* table, int b, const void* codes2,
                                    const void* bad, int B, int W, int k,
                                    void* hit, void* csid, void* stream) {
  // the warps load the code and bad rows 4 bytes at a time
  if (B <= 0 || W > kMaxW || W % 32 != 0 || k < 1 || k > 31 || k > W ||
      b < 0 || b > 31 || reinterpret_cast<uintptr_t>(codes2) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(bad) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  cuckoo_lookup_kernel<<<blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), b, static_cast<const uint8_t*>(codes2),
      static_cast<const uint8_t*>(bad), B, W, k, static_cast<uint8_t*>(hit),
      static_cast<int32_t*>(csid));
  return static_cast<int>(cudaGetLastError());
}
