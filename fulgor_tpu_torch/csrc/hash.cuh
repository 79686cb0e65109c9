// Shared device helpers of the fulgor kernels: the mix32 hash of
// fulgor_tpu/ops/lookup.py and the dictionary's constants
// (fulgor_tpu/ops/minidict.py, ops/minidict2.py).
#pragma once

#include <cstdint>

namespace fulgor {

constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kSeedM = 0x713A9C5Bu;      // minidict.SEED_M
constexpr uint32_t kSkewSeed1 = 0x2545F491u;  // minidict2.SKEW_SEED1
constexpr uint32_t kSkewSeed2 = 0x9E3779B9u;  // minidict2.SKEW_SEED2
constexpr int kScan = 8;                      // minidict2.SCAN
constexpr int kRowW = 8;                      // minidict2.ROWW
constexpr int kSkewRowW = 8;                  // minidict2.SKEW_ROWW
constexpr int kMaxSkewCand = 2 * kSkewRowW;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

}  // namespace fulgor
