// K13 pack_hits: each read's window positivity packed into bit words, and,
// when asked, its window csids narrowed to u16 in the same pass.
//
// Replaces fulgor_tpu/ops/pipeline.py _pack_hits (:338) and the u16
// narrowing of query_conservation_packed (:354-357):
//   hitw   (B, ceil(Wk/32)) u32 in pack_bool_bits' layout (bit w & 31 of
//          word w >> 5 is window w; bits past Wk are 0);
//   csid16 (B, Wk) u16: csid where the window is positive, 0xFFFF where not
//          (the low 16 bits of csid: the caller narrows only when every set
//          id fits).
// It serves query_conservation_packed and the mesh's kmer-matches step
// (fulgor_tpu/parallel/mesh.py make_sharded_kmer_matches, :276-277). Plain
// version: fulgor_tpu_torch/ops/intersect.py pack_hits_plain.
//
// What bounds it: bytes (hit read once, csid read and csid16 written once
// when narrowing, one word written per 32 windows); one ballot and a select
// a window. Design: one warp per (read, word) pair in a grid-stride loop,
// lane l on window 32 j + l, so a warp reads 32 consecutive bytes of hit
// (and 128 of csid) and its ballot is the word.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads) pack_hits_kernel(
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int B,
    int Wk, uint32_t* __restrict__ hitw, uint16_t* __restrict__ csid16) {
  const int nw = (Wk + 31) / 32;
  const int lane = threadIdx.x & 31;
  const long long total = static_cast<long long>(B) * nw;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  // t is the same for the 32 lanes of a warp: the ballot sees all of them
  for (long long t = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       t < total; t += warps) {
    const long long r = t / nw;
    const int w = 32 * static_cast<int>(t - r * nw) + lane;
    const long long at = r * Wk + w;
    const bool h = w < Wk && hit[at] != 0;
    const unsigned word = __ballot_sync(kFull, h);
    if (lane == 0) hitw[t] = word;
    if (csid16 != nullptr && w < Wk)
      csid16[at] = h ? static_cast<uint16_t>(csid[at]) : uint16_t{0xFFFF};
  }
}

}  // namespace

// csid and csid16 both null, or both set (the narrowing pass).
extern "C" int fulgor_pack_hits(const void* hit, const void* csid, int B,
                                int Wk, void* hitw, void* csid16,
                                void* stream) {
  if (B <= 0 || Wk <= 0 || (csid == nullptr) != (csid16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(B) * ((Wk + 31) / 32);
  const long long want = (warps * 32 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  pack_hits_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), B,
      Wk, static_cast<uint32_t*>(hitw), static_cast<uint16_t*>(csid16));
  return static_cast<int>(cudaGetLastError());
}
