// K6 compact_runs: each read's runs of equal csid, compacted into a run list
// of a fixed budget R.
//
// Replaces fulgor_tpu/ops/intersect.py mask_positions (:152), _run_bounds
// (:168), compact_runs (:188) and compact_runs_starts (:206). A run is a
// maximal stretch of consecutive positive windows with equal csid; a csid
// that recurs after another run, or after a miss, starts a new run. For read
// b and run r < min(total, R): run_csid[b, r], run_start[b, r] (its first
// window) and run_len[b, r]; slots past the read's run count hold INVALID, 0,
// 0. total[b] counts every run of the read, not only the first R (overflow is
// total > R, and the first R runs are still written, as in JAX); npos[b]
// counts its positive windows. Plain version:
// fulgor_tpu_torch/ops/intersect.py compact_runs_plain.
//
// What bounds it: bytes. It reads hit and csid once (5 B a window) and
// writes 8 B a run slot (int32 csid, u16 start, u16 length) and 8 B a read.
//
// Design: one warp per read, kWarps reads a block, nothing staged in shared
// memory. Lane l loads window w0 + l of each 32-window chunk. The window
// before comes from the lane below by shuffle (for lane 0, from registers
// carried over from the last chunk); the window after from the lane above
// (lane 31 loads the next chunk's first window itself). Ballots of the run
// starts rank every run: the starts of earlier chunks plus those at or below
// the lane. The lane that ends a run writes its whole record; the run's start
// is the highest start bit at or below that lane or, for a run begun in an
// earlier chunk, the last start carried from there. Then the warp writes its
// read's padding slots, and nothing past R.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr int kWarps = 8;

__global__ void compact_runs_kernel(const uint8_t* __restrict__ hit,
                                    const uint32_t* __restrict__ csid, int B,
                                    int Wk, int R,
                                    uint32_t* __restrict__ run_csid,
                                    uint16_t* __restrict__ run_start,
                                    uint16_t* __restrict__ run_len,
                                    int32_t* __restrict__ total,
                                    int32_t* __restrict__ npos) {
  const int lane = threadIdx.x & 31;
  const size_t b =
      static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= static_cast<size_t>(B)) return;  // the whole warp leaves together
  const uint8_t* h_row = hit + b * Wk;
  const uint32_t* c_row = csid + b * Wk;
  const size_t o = b * R;
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
  int carry_h = 0;          // window w0 - 1: positive?
  uint32_t carry_c = 0;     // and its csid
  int carry_start = 0;      // the last run start of the earlier chunks
  int nstart = 0, np = 0;
  for (int w0 = 0; w0 < Wk; w0 += 32) {
    const int w = w0 + lane;
    const int h = w < Wk && h_row[w] != 0;
    const uint32_t c = h ? c_row[w] : kInvalid;
    int ph = __shfl_up_sync(kFull, h, 1);
    uint32_t pc = __shfl_up_sync(kFull, c, 1);
    int nh = __shfl_down_sync(kFull, h, 1);
    uint32_t nc = __shfl_down_sync(kFull, c, 1);
    if (lane == 0) {
      ph = carry_h;
      pc = carry_c;
    }
    if (lane == 31) {
      nh = w + 1 < Wk && h_row[w + 1] != 0;
      nc = nh ? c_row[w + 1] : kInvalid;
    }
    const bool is_start = h && !(ph && pc == c);
    const bool is_end = h && !(nh && nc == c);
    const unsigned bs = __ballot_sync(kFull, is_start);
    const unsigned bh = __ballot_sync(kFull, h);
    if (is_end) {
      const unsigned mine = bs & upto;
      const int rank = nstart + __popc(mine) - 1;
      const int start = mine ? w0 + 31 - __clz(mine) : carry_start;
      if (rank < R) {
        run_csid[o + rank] = c;
        run_start[o + rank] = static_cast<uint16_t>(start);
        run_len[o + rank] = static_cast<uint16_t>(w - start + 1);
      }
    }
    if (bs) carry_start = w0 + 31 - __clz(bs);
    nstart += __popc(bs);
    np += __popc(bh);
    carry_h = __shfl_sync(kFull, h, 31);
    carry_c = __shfl_sync(kFull, c, 31);
  }
  for (int r = nstart + lane; r < R; r += 32) {
    run_csid[o + r] = kInvalid;
    run_start[o + r] = 0;
    run_len[o + r] = 0;
  }
  if (lane == 0) {
    total[b] = nstart;
    npos[b] = np;
  }
}

}  // namespace

// Starts and lengths are u16: Wk <= 65535.
extern "C" int fulgor_compact_runs(const void* hit, const void* csid, int B,
                                   int Wk, int R, void* run_csid,
                                   void* run_start, void* run_len, void* total,
                                   void* npos, void* stream) {
  if (B <= 0 || Wk <= 0 || Wk > 65535 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  compact_runs_kernel<<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), B,
      Wk, R, static_cast<uint32_t*>(run_csid),
      static_cast<uint16_t*>(run_start), static_cast<uint16_t*>(run_len),
      static_cast<int32_t*>(total), static_cast<int32_t*>(npos));
  return static_cast<int>(cudaGetLastError());
}
