// K6 compact_runs: each read's runs of equal csid, compacted into a run list
// of a fixed budget R, and, in its hit-word instance, the read's window
// positivity as bit words. K13 pack_hits: the positivity words alone, and,
// when asked, the window csids narrowed to u16 in the same pass.
//
// K6 replaces fulgor_tpu/ops/intersect.py mask_positions (:152), _run_bounds
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
// K13 replaces fulgor_tpu/ops/pipeline.py _pack_hits (:338) and the u16
// narrowing of query_conservation_packed (:354-357). Plain version:
// fulgor_tpu_torch/ops/intersect.py pack_hits_plain.
//   hitw   (B, ceil(Wk/32)) u32 in pack_bool_bits' layout (bit w & 31 of
//          word w >> 5 is window w; bits past Wk are 0): K6's hit-word
//          instance writes the same words, which the mesh's kmer-matches step
//          takes (fulgor_tpu/parallel/mesh.py make_sharded_kmer_matches,
//          :272-276, packs them in the step that builds its runs);
//   csid16 (B, Wk) u16: csid where the window is positive, 0xFFFF where not
//          (the low 16 bits of csid: the caller narrows only when every set
//          id fits).
//
// What bounds them: bytes. K6 reads hit and csid once (5 B a window) and
// writes 8 B a run slot (int32 csid, u16 start, u16 length), 8 B a read and,
// with hit words, 4 B a 32 windows; K13 reads hit (and csid) once and writes
// 4 B a 32 windows (and 2 B a window).
//
// Design: one warp per read, kWarps reads a block, nothing staged in shared
// memory, no block barrier. The front end (walk_read) is the two kernels'
// one: lane l holds window 32 i + l of chunk i in registers, and every load
// of a read is issued before any is consumed: the hit bytes and the csids
// (loaded whether the window is positive or not) of all of a read's chunks at
// once, in groups of up to kMaxChunks chunks for longer reads, the next
// group's loads issued before the current group is consumed. A chunk is
// consumed with the next chunk's windows (the window after its last among
// them) in registers. A chunk's ballot of positivity is its hit word; lane i % 8 keeps
// chunk i's, and the words of eight chunks are stored together.
//
// K6 takes two shuffles and two ballots a chunk, every other step on
// ballot words: a chunk's positivity ballot, and its continuation ballot
// (a positive window whose window before is positive with the same csid:
// the csid before by one shuffle up, for lane 0 by one broadcast of the
// chunk before's lane 31). A run starts where a positive window does not
// continue, and ends where the next window, in the next chunk for lane 31,
// does not continue it: so each chunk's ballots are formed one chunk ahead,
// from the next chunk's windows held in registers. The starts' ballots rank
// every run: the starts of earlier chunks plus those at or below the lane.
// The lane that ends a run writes its whole record; the run's start is the
// highest start bit at or below that lane or, for a run begun in an earlier
// chunk, the last start carried from there. Then the warp writes its read's
// padding slots, and nothing past R.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// chunks of 32 windows loaded at once: a read of Wk <= 256 in one group
constexpr int kMaxChunks = 8;

// Lane `lane`'s window of chunks first .. first + NC - 1: its hit byte (0
// past Wk) and, with kCsid, its csid (kInvalid past Wk), all loads issued
// together.
template <int NC, bool kCsid>
__device__ __forceinline__ void load_chunks(const uint8_t* __restrict__ h_row,
                                            const uint32_t* __restrict__ c_row,
                                            int Wk, int lane, int first,
                                            uint32_t (&h)[NC],
                                            uint32_t (&c)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int w = 32 * (first + j) + lane;
    const bool in = w < Wk;
    h[j] = in ? h_row[w] : 0u;
    if (kCsid) c[j] = in ? c_row[w] : kInvalid;
  }
}

// Walks a read's ceil(Wk / 32) chunks in order in groups of NC (NC <
// kMaxChunks only where the read has exactly NC chunks):
// chunk(i, h, c, h1, c1) with the lane's hit byte h and csid c in chunk i,
// and h1, c1 the lane's in chunk i + 1 (0 past the read). The whole warp
// calls it.
template <int NC, bool kCsid, typename F>
__device__ __forceinline__ void walk_read(const uint8_t* __restrict__ h_row,
                                          const uint32_t* __restrict__ c_row,
                                          int Wk, int lane, F&& chunk) {
  const int nw = (Wk + 31) >> 5;
  uint32_t h[NC], c[NC] = {};
  load_chunks<NC, kCsid>(h_row, c_row, Wk, lane, 0, h, c);
  for (int g = 0; g < nw; g += NC) {
    uint32_t hn[NC] = {}, cn[NC] = {};
    const bool more = g + NC < nw;
    if (more) load_chunks<NC, kCsid>(h_row, c_row, Wk, lane, g + NC, hn, cn);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (g + j < nw)
        chunk(g + j, h[j], c[j], j + 1 < NC ? h[j + 1] : hn[0],
              j + 1 < NC ? c[j + 1] : cn[0]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      h[j] = hn[j];
      c[j] = cn[j];
    }
  }
}

// Chunk i's ballot bh into the read's hit words: lane i % 8 keeps it, and
// the words of every eight chunks, and of the read's last, are stored
// together (lane l the word of chunk (i & ~7) + l).
__device__ __forceinline__ void hit_word(uint32_t* __restrict__ row, int i,
                                         int nw, int lane, unsigned bh,
                                         unsigned& word) {
  if (lane == (i & 7)) word = bh;
  if ((i & 7) == 7 || i == nw - 1) {
    if (lane <= (i & 7)) row[(i & ~7) + lane] = word;
  }
}

template <int NC, bool kHits>
__global__ void __launch_bounds__(kThreads) compact_runs_kernel(
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int B,
    int Wk, int R, uint32_t* __restrict__ run_csid,
    uint16_t* __restrict__ run_start, uint16_t* __restrict__ run_len,
    int32_t* __restrict__ total, int32_t* __restrict__ npos,
    uint32_t* __restrict__ hitw) {
  const int lane = threadIdx.x & 31;
  const size_t b =
      static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= static_cast<size_t>(B)) return;  // the whole warp leaves together
  const int nw = (Wk + 31) >> 5;
  const size_t o = b * R;
  uint32_t* const w_row = kHits ? hitw + b * nw : nullptr;
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
  int carry_start = 0;  // the last run start of the earlier chunks
  int nstart = 0, np = 0;
  unsigned word = 0;
  // chunk i's ballots: positive windows, and positive windows that continue
  // the window before (positive, same csid)
  unsigned bh = 0, bc = 0;
  walk_read<NC, true>(
      hit + b * Wk, csid + b * Wk, Wk, lane,
      [&](int i, uint32_t h, uint32_t c, uint32_t h1, uint32_t c1) {
        const int w0 = 32 * i;
        if (i == 0) {
          bh = __ballot_sync(kFull, h != 0);
          const uint32_t up = __shfl_up_sync(kFull, c, 1);
          bc = __ballot_sync(kFull, lane > 0 && h != 0 && up == c) & (bh << 1);
        }
        // chunk i + 1's: its lane 0 follows chunk i's lane 31
        const uint32_t last = __shfl_sync(kFull, c, 31);
        const uint32_t up1 = __shfl_up_sync(kFull, c1, 1);
        const unsigned bh1 = __ballot_sync(kFull, h1 != 0);
        const unsigned bc1 =
            __ballot_sync(kFull, h1 != 0 && (lane ? up1 : last) == c1) &
            (bh1 << 1 | bh >> 31);
        // run starts, and run ends: positive windows whose next window does
        // not continue them
        const unsigned bs = bh & ~bc;
        const unsigned be = bh & ~(bc >> 1 | bc1 << 31);
        if ((be >> lane) & 1u) {
          const unsigned mine = bs & upto;
          const int rank = nstart + __popc(mine) - 1;
          const int start = mine ? w0 + 31 - __clz(mine) : carry_start;
          if (rank < R) {
            run_csid[o + rank] = c;
            run_start[o + rank] = static_cast<uint16_t>(start);
            run_len[o + rank] = static_cast<uint16_t>(w0 + lane - start + 1);
          }
        }
        if (bs) carry_start = w0 + 31 - __clz(bs);
        nstart += __popc(bs);
        np += __popc(bh);
        if (kHits) hit_word(w_row, i, nw, lane, bh, word);
        bh = bh1;
        bc = bc1;
      });
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

template <int NC, bool kNarrow>
__global__ void __launch_bounds__(kThreads) pack_hits_kernel(
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int B,
    int Wk, uint32_t* __restrict__ hitw, uint16_t* __restrict__ csid16) {
  const int lane = threadIdx.x & 31;
  const size_t b =
      static_cast<size_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= static_cast<size_t>(B)) return;  // the whole warp leaves together
  const int nw = (Wk + 31) >> 5;
  const size_t row = b * Wk;
  uint32_t* const w_row = hitw + b * nw;
  unsigned word = 0;
  walk_read<NC, kNarrow>(
      hit + row, kNarrow ? csid + row : nullptr, Wk, lane,
      [&](int i, uint32_t h, uint32_t c, uint32_t, uint32_t) {
        hit_word(w_row, i, nw, lane, __ballot_sync(kFull, h != 0), word);
        const int w = 32 * i + lane;
        if (kNarrow && w < Wk)
          csid16[row + w] = h ? static_cast<uint16_t>(c) : uint16_t{0xFFFF};
      });
}

// One read's chunks at once: the instance of NC = min(ceil(Wk / 32),
// kMaxChunks), NC a template argument so that the chunks stay in registers.
template <bool kHits, int NC = 1>
void launch_runs(int nc, int blocks, cudaStream_t s, const uint8_t* hit,
                 const uint32_t* csid, int B, int Wk, int R,
                 uint32_t* run_csid, uint16_t* run_start, uint16_t* run_len,
                 int32_t* total, int32_t* npos, uint32_t* hitw) {
  if constexpr (NC < kMaxChunks) {
    if (nc > NC)
      return launch_runs<kHits, NC + 1>(nc, blocks, s, hit, csid, B, Wk, R,
                                        run_csid, run_start, run_len, total,
                                        npos, hitw);
  }
  compact_runs_kernel<NC, kHits><<<blocks, kThreads, 0, s>>>(
      hit, csid, B, Wk, R, run_csid, run_start, run_len, total, npos, hitw);
}

template <bool kNarrow, int NC = 1>
void launch_pack(int nc, int blocks, cudaStream_t s, const uint8_t* hit,
                 const uint32_t* csid, int B, int Wk, uint32_t* hitw,
                 uint16_t* csid16) {
  if constexpr (NC < kMaxChunks) {
    if (nc > NC)
      return launch_pack<kNarrow, NC + 1>(nc, blocks, s, hit, csid, B, Wk,
                                          hitw, csid16);
  }
  pack_hits_kernel<NC, kNarrow><<<blocks, kThreads, 0, s>>>(hit, csid, B, Wk,
                                                            hitw, csid16);
}

int chunks(int Wk) {
  const int nw = (Wk + 31) / 32;
  return nw < kMaxChunks ? nw : kMaxChunks;
}

template <bool kHits>
int compact_runs(const void* hit, const void* csid, int B, int Wk, int R,
                 void* run_csid, void* run_start, void* run_len, void* total,
                 void* npos, void* hitw, void* stream) {
  if (B <= 0 || Wk <= 0 || Wk > 65535 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_runs<kHits>(
      chunks(Wk), (B + kWarps - 1) / kWarps,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(hit),
      static_cast<const uint32_t*>(csid), B, Wk, R,
      static_cast<uint32_t*>(run_csid), static_cast<uint16_t*>(run_start),
      static_cast<uint16_t*>(run_len), static_cast<int32_t*>(total),
      static_cast<int32_t*>(npos), static_cast<uint32_t*>(hitw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Starts and lengths are u16: Wk <= 65535.
extern "C" int fulgor_compact_runs(const void* hit, const void* csid, int B,
                                   int Wk, int R, void* run_csid,
                                   void* run_start, void* run_len, void* total,
                                   void* npos, void* stream) {
  return compact_runs<false>(hit, csid, B, Wk, R, run_csid, run_start,
                             run_len, total, npos, nullptr, stream);
}

// The same, and each read's hit words: hitw (B, ceil(Wk/32)) u32.
extern "C" int fulgor_compact_runs_hits(const void* hit, const void* csid,
                                        int B, int Wk, int R, void* run_csid,
                                        void* run_start, void* run_len,
                                        void* total, void* npos, void* hitw,
                                        void* stream) {
  if (hitw == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return compact_runs<true>(hit, csid, B, Wk, R, run_csid, run_start,
                            run_len, total, npos, hitw, stream);
}

// csid and csid16 both null, or both set (the narrowing pass).
extern "C" int fulgor_pack_hits(const void* hit, const void* csid, int B,
                                int Wk, void* hitw, void* csid16,
                                void* stream) {
  if (B <= 0 || Wk <= 0 || (csid == nullptr) != (csid16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto h = static_cast<const uint8_t*>(hit);
  const auto c = static_cast<const uint32_t*>(csid);
  const auto w = static_cast<uint32_t*>(hitw);
  const auto c16 = static_cast<uint16_t*>(csid16);
  if (csid == nullptr)
    launch_pack<false>(chunks(Wk), blocks, s, h, c, B, Wk, w, c16);
  else
    launch_pack<true>(chunks(Wk), blocks, s, h, c, B, Wk, w, c16);
  return static_cast<int>(cudaGetLastError());
}
