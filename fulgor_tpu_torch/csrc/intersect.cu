// K3 fi_and: full intersection of the colour-set bit rows of each read's
// positive windows.
//
// Replaces fulgor_tpu/ops/intersect.py full_intersection_windows (:91), its
// one-hot twin full_intersection_onehot (:68) and the AND of
// compact_runs (:188) -> full_intersection_runs (:254); the plain version
// is fulgor_tpu_torch/ops/intersect.py fi_and_plain.
//
// What bounds it: bytes. It reads hit and csid once (5 B per window), one
// C32-word bit row per run of equal csids, and writes C32 words per read.
// With runs of a few windows on clonal pangenomes the row reads are a
// small multiple of the output; rows come from a dense matrix (1.4 MB at
// 256 genomes) that stays in L2.
//
// Design: one block per read, threads over the C32 words. The read's
// hit/csid windows are staged in shared memory once; each thread walks the
// windows in order and ANDs a row word only where the window is positive
// and its csid differs from the last one it ANDed. AND is idempotent, so
// this in-kernel form of compact_runs is exact with no run budget and no
// overflow (the JAX runs path needed both). The one-hot matmul trick of
// the TPU version is not carried over: the card gathers rows directly.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWk = 1024;

__global__ void fi_and_kernel(const uint32_t* __restrict__ dense, int C32,
                              const uint8_t* __restrict__ hit,
                              const uint32_t* __restrict__ csid, int Wk,
                              uint32_t* __restrict__ out) {
  __shared__ uint32_t cs[kMaxWk];
  __shared__ uint8_t hv[kMaxWk];
  __shared__ int any_hit;
  const size_t b = blockIdx.x;
  if (threadIdx.x == 0) any_hit = 0;
  __syncthreads();
  for (int w = threadIdx.x; w < Wk; w += blockDim.x) {
    const uint8_t h = hit[b * Wk + w];
    hv[w] = h;
    cs[w] = csid[b * Wk + w];
    if (h) any_hit = 1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C32; j += blockDim.x) {
    uint32_t acc = 0xFFFFFFFFu;
    uint32_t last = 0;
    bool have_last = false;
    for (int w = 0; w < Wk; ++w) {
      if (!hv[w]) continue;
      const uint32_t c = cs[w];
      if (have_last && c == last) continue;
      acc &= __ldg(dense + static_cast<size_t>(c) * C32 + j);
      last = c;
      have_last = true;
    }
    out[b * C32 + j] = any_hit ? acc : 0u;
  }
}

}  // namespace

extern "C" int fulgor_fi_and(const void* dense, int C32, const void* hit,
                             const void* csid, int B, int Wk, void* out,
                             void* stream) {
  if (B <= 0 || C32 <= 0 || Wk <= 0 || Wk > kMaxWk)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((C32 + 31) / 32) * 32;
  threads = threads > 256 ? 256 : threads;
  fi_and_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dense), C32,
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), Wk,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
