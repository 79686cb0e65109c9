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
// What bounds it: bytes (one byte read per base, 3/16 of a byte written);
// a handful of operations a base. Design: a grid-stride loop with one
// thread per output word, the 2-bit words first and the bad words after;
// consecutive threads take consecutive words of a row, so the 16- or
// 32-byte segments they read are contiguous.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pack_codes_kernel(
    const uint8_t* __restrict__ codes, int B, int L, uint32_t* __restrict__ words,
    uint32_t* __restrict__ badw) {
  const int nw = (L + 15) / 16, nbw = (L + 31) / 32;
  const long long n1 = static_cast<long long>(B) * nw;
  const long long n = n1 + static_cast<long long>(B) * nbw;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (t < n1) {
      const long long r = t / nw;
      const int q0 = 16 * static_cast<int>(t - r * nw);
      const uint8_t* row = codes + r * L + q0;
      const int m = min(16, L - q0);
      uint32_t v = 0;
      for (int i = 0; i < m; ++i) {
        const uint32_t c = __ldg(row + i);
        if (c <= 3) v |= c << (2 * i);
      }
      words[t] = v;
    } else {
      const long long u = t - n1;
      const long long r = u / nbw;
      const int q0 = 32 * static_cast<int>(u - r * nbw);
      const uint8_t* row = codes + r * L + q0;
      const int m = min(32, L - q0);
      uint32_t v = m < 32 ? ~((1u << m) - 1) : 0u;  // past L: bad
      for (int i = 0; i < m; ++i)
        if (__ldg(row + i) > 3) v |= 1u << i;
      badw[u] = v;
    }
  }
}

}  // namespace

extern "C" int fulgor_pack_codes(const void* codes, int B, int L, void* words,
                                 void* badw, void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * ((L + 15) / 16 + (L + 31) / 32);
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  pack_codes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), B, L, static_cast<uint32_t*>(words),
      static_cast<uint32_t*>(badw));
  return static_cast<int>(cudaGetLastError());
}
