// K8 pack_codes: (B, L) uint8 base codes -> 2-bit words and bad-bit words.
//
// Replaces fulgor_tpu/ops/minidict2.py _device_pack_codes (:919), the first
// step of the array API's unpacked query steps (fulgor_tpu/ops/pipeline.py
// query_full_intersection / query_threshold_union / query_window_csids,
// :178-204); the plain version is fulgor_tpu_torch/ops/prep.py
// pack_codes_plain.
//
//   words (B, ceil(L/16)) u32: 16 bases each, LSB-first, bad bases as 0;
//   badw  (B, ceil(L/32)) u32: one bit a base (code > 3), bits past L set.
//
// At L % 32 == 0 the words viewed as bytes are exactly the host packer's
// codes2 (B, L/4) and bad (B, L/8) (ops/hostpack.py), so K1 and K7 take
// them unchanged.
//
// What bounds it: bytes (one byte read per base, 3/8 of a byte written);
// a handful of operations a base.
//
// Design: one thread for each piece of 32 bases of a row; consecutive
// threads take consecutive pieces, so they read consecutive 32-byte
// segments and write consecutive words. A piece's bytes are read once, for
// its two 2-bit words and its bad word together: by two 16-byte loads where
// L % 16 == 0 and the codes start 16-byte aligned (every row then does),
// else, in the byte-load instance of the same kernel, one byte at a time;
// the shape and the pointer choose the instance. Four bases a 32-bit
// register are packed by SIMD byte operations: __vcmpgtu4 marks the bad
// bytes, the good codes are masked and folded four to a byte by two shifts,
// and the bad bytes' top bits are gathered into the bad word. A piece's
// two words go out in one 8-byte store (two 4-byte ones where a row holds
// an odd count of words) and its bad word in one 4-byte store.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Four codes, a byte each, base i in byte i -> their 2-bit codes in one
// byte (base i at bits 2i, bad bases as 0); bad4 gets one bit a bad base.
__device__ __forceinline__ uint32_t pack4(uint32_t x, uint32_t& bad4) {
  const uint32_t bad = __vcmpgtu4(x, 0x03030303u);  // 0xFF where code > 3
  uint32_t g = x & ~bad & 0x03030303u;
  g |= g >> 6;
  g |= g >> 12;
  const uint32_t top = bad & 0x80808080u;
  bad4 = ((top >> 7) | (top >> 14) | (top >> 21) | (top >> 28)) & 0xFu;
  return g & 0xFFu;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) pack_codes_kernel(
    const uint8_t* __restrict__ codes, int B, int L,
    uint32_t* __restrict__ words, uint32_t* __restrict__ badw) {
  const int nq = (L + 31) >> 5, nw = (L + 15) >> 4;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(B) * nq) return;
  const long long r = t / nq;
  const int q = static_cast<int>(t - r * nq);
  const int m = min(32, L - 32 * q);  // the piece's bases
  const uint8_t* p = codes + r * L + 32 * q;
  uint32_t x[8];
  if (kVec) {  // m is 16 or 32
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 hi = m > 16 ? __ldg(reinterpret_cast<const uint4*>(p) + 1)
                            : make_uint4(0u, 0u, 0u, 0u);
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
  } else {  // bytes past L read as code 0, marked bad below
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * i + k < m) x[i] |= static_cast<uint32_t>(__ldg(p + 4 * i + k))
                                   << (8 * k);
    }
  }
  uint32_t w0 = 0u, w1 = 0u, bad = 0u, b4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w0 |= pack4(x[i], b4) << (8 * i);
    bad |= b4 << (4 * i);
    w1 |= pack4(x[i + 4], b4) << (8 * i);
    bad |= b4 << (4 * i + 16);
  }
  if (m < 32) bad |= ~0u << m;  // past L: bad
  uint32_t* wr = words + r * nw + 2 * q;
  if (m <= 16) {
    wr[0] = w0;  // a row's last piece of at most 16 bases: one word
  } else if ((nw & 1) == 0) {
    *reinterpret_cast<uint2*>(wr) = make_uint2(w0, w1);
  } else {
    wr[0] = w0;
    wr[1] = w1;
  }
  badw[r * nq + q] = bad;
}

}  // namespace

extern "C" int fulgor_pack_codes(const void* codes, int B, int L, void* words,
                                 void* badw, void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * ((L + 31) / 32);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      L % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const auto c = static_cast<const uint8_t*>(codes);
  const auto w = static_cast<uint32_t*>(words);
  const auto bw = static_cast<uint32_t*>(badw);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    pack_codes_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        c, B, L, w, bw);
  else
    pack_codes_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(c, B, L, w, bw);
  return static_cast<int>(cudaGetLastError());
}
