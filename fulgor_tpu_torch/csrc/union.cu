// K4 tu_mask and K5 km_scores: threshold-union scores, per read and colour,
// of the read's positive windows.
//
// Both replace fulgor_tpu/ops/intersect.py threshold_union_scores_windows
// (:106), its one-hot twin threshold_union_scores_onehot (:80) and
// compact_runs -> threshold_union_scores_runs (:264): score[b, c] = the
// number of positive windows of read b whose colour set holds c.
//   K4 also replaces the colour stage of fulgor_tpu/ops/pipeline.py
//   query_tu_lists_packed (:273-281): mask = score >= minscore[npos] and
//   npos > 0, packed by pack_bool_bits (intersect.py:59). The (B, C) scores
//   never reach device memory.
//   K5 replaces the colour stage of query_kmer_matches_packed2 (:367-370):
//   the scores as int16, and the positivity bits of _pack_hits (:338).
// Plain versions: fulgor_tpu_torch/ops/intersect.py tu_mask_plain and
// km_scores_plain.
//
// What bounds them: bytes. Each reads hit and csid once (5 B a window) and
// one C32-word bit row per distinct csid (rows stay in L2 at 512 colours);
// K4 writes C32 words a read, K5 two bytes a colour a read (at 512 colours
// most of its bytes).
//
// What held the first design back (one block a read, the windows staged
// in a static shared struct sized for 1,024 windows, warp 0 walking them
// 32 at a time while the other warps waited at block barriers, then each
// thread re-walking every run for its colour, one dependent load a run,
// all 32 lanes of a warp on one word): few reads in flight, each a chain of
// dependent latencies, and at 4,546 colours every run re-read once for
// each of 18 tiles of 256 colours.
//
// What holds this design back: the bit-sliced adds of reads of more than
// kTable runs (about a third of the reads, most of the adds); at 4,546
// colours they lead the time.
//
// Design: one warp a read, kWarps reads a block, no block barrier.
// warp_runs() takes the windows 32 at a time, a lane each, loaded
// coalesced: a window starts a run where it is positive and its csid is not
// the window before's (the lane below's, by shuffle); the ballots of
// starts and of positive windows place each run's csid and its rank among
// the positive windows in the warp's slice of dynamic shared memory, sized
// to Wk, and are K5's hit words. A run is as long as the positive windows
// from its start to the next run's. A csid that recurs after another run
// is a run of its own and counts again: threshold union counts every
// positive window, so K3's AND over run starts alone does not carry over,
// and each run weighs its length.
//   K4, a read of at most kTable (4) runs (about two reads in three at 512
//   colours): a colour passes or not by which of the runs' rows hold it, so
//   16 lanes sum the lengths of the 16 patterns against need =
//   minscore[npos], a ballot is the truth table, and each word of the mask
//   is a multiplexer tree of 15 three-input operations over the runs' row
//   words (table_mask), a lane on a word, two words' rows in flight.
//   K4, more runs: bit-sliced counts. A lane owns one word j of the read's
//   C32 and keeps its 32 colours' counts as bit planes (plane p holds bit p
//   of each count, as many planes as Wk needs); adding a run is a ripple
//   add of length x row word over the planes, and the threshold a
//   bit-sliced compare against need that yields the mask word with no
//   unpacking.
//     C32 <= 32: the lanes split into 32 / P groups of P lanes (P the power
//     of two at or above C32); group g takes runs g, g + G, ..., lane j of a
//     group word j, so several rows are in flight at once; the groups'
//     planes meet by xor shuffles and bit-sliced adds.
//     C32 > 32: the lanes take words 32 at a time and walk the run list
//     (in shared memory) once a pass of 32 words, four rows in flight.
//   K5 counts in registers, in tiles of 512 colours: lane l owns colours
//   8l..8l+7 and 256+8l..256+8l+7 of a tile (8 bits of row words l / 4
//   and 8 + l / 4), two to a register as 16-bit fields; a run adds length x
//   the byte's entry in a 256-entry spread table (its 8 bits as four pairs
//   of fields) to four registers, four runs' rows in flight; each 8
//   colours' int16 scores go out as one 16 B store where the row allows it
//   (C % 8 == 0), so that each of the warp's two stores of a tile writes
//   512 contiguous bytes.

// K12 runs_scores is the first design's block-a-read body over runs that
// arrive built: K6's (csid, count) runs of a read, INVALID-padded, gathered
// from the cells of a mesh row and scored against one colour shard. It
// replaces compact_runs -> threshold_union_scores_runs (fulgor_tpu/ops/
// intersect.py:264) in fulgor_tpu/parallel/mesh.py
// make_sharded_threshold_union(_packed) (:89, :154) and
// make_sharded_kmer_matches (:263): score[b, c] = sum over the valid runs r
// (csid != INVALID) of run_cnt[b, r] x bit c of the run's row. Mask mode
// (the mesh TU) thresholds the scores against minscore[npos[b]] with
// npos > 0, as K4 does, npos the read's positive windows gathered with its
// runs; u16 mode (the mesh kmer-matches) writes the scores as int16 bit
// patterns. Plain versions: ops/intersect.py runs_scores_plain and
// runs_mask_plain. Bound as K4/K5; design the first one of K4/K5: warp 0
// compacts the valid runs into shared memory with ballots, the threads
// then own colours and add count x bit over the runs (score_of).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWk = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
// K4 and K5: reads a block, a warp each
constexpr int kWarps = 8;
// a window that is not positive, in warp_runs (a positive window's csid
// is never INVALID)
constexpr uint32_t kNone = 0xFFFFFFFFu;
// K4's bit planes: enough to count to the most a read scores (Wk), from the
// rows of 32 windows a pass (kRows = ceil(Wk / 32) up to 7, else 8 for Wk
// up to 1,024)
__host__ __device__ constexpr int planes_for(int kRows) {
  return kRows == 1 ? 6 : kRows <= 3 ? 7 : kRows <= 7 ? 8 : 11;
}
// K4 scores a read of at most kTable runs from a truth table of their
// 2^kTable sums
constexpr int kTable = 4;

// Read b's runs of consecutive positive windows with equal csid, in window
// order, into its warp's slice of shared memory: cs[i] the csid of run i,
// rk[i] the positive windows before its first, rk[nr] = npos, so that run
// i is rk[i + 1] - rk[i] windows long (every positive window from one run
// start to the next belongs to the first). The warp takes the windows 32
// at a time, lane l window l of each row, kRows rows a pass, loaded
// coalesced: a window is a start where positive and not the csid of the
// window before (the lane below's by shuffle, lane 0's the last row's
// lane 31's); the ballots of starts and of positive windows place each
// start and rank it. hitw: lane i gets row i's positivity ballot, the
// read's hit word i. -> the run count nr; npos, the read's positive
// windows, on every lane.
template <int kRows>
__device__ __forceinline__ int warp_runs(const uint8_t* __restrict__ hrow,
                                         const uint32_t* __restrict__ crow,
                                         int Wk, int lane, uint32_t* cs,
                                         uint16_t* rk, int& npos,
                                         uint32_t& hitw) {
  const uint32_t below = (1u << lane) - 1u;
  int nr = 0, np = 0;
  uint32_t last = kNone;  // the window before this row: its csid, if positive
  for (int w0 = 0; w0 < Wk; w0 += 32 * kRows) {
    uint32_t v[kRows];  // csid where positive, else kNone
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int w = w0 + 32 * t + lane;
      const bool in = w < Wk;
      const uint32_t c = in ? __ldg(crow + w) : kNone;
      v[t] = in && __ldg(hrow + w) ? c : kNone;
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      uint32_t prev = __shfl_sync(kFull, v[t], (lane + 31) & 31);
      if (lane == 0) prev = last;
      last = __shfl_sync(kFull, v[t], 31);
      const bool pos = v[t] != kNone;
      const bool start = pos && v[t] != prev;
      const uint32_t sb = __ballot_sync(kFull, start);
      const uint32_t hb = __ballot_sync(kFull, pos);
      if (start) {
        const int i = nr + __popc(sb & below);
        cs[i] = v[t];
        rk[i] = static_cast<uint16_t>(np + __popc(hb & below));
      }
      if (lane == (w0 >> 5) + t) hitw = hb;
      nr += __popc(sb);
      np += __popc(hb);
    }
  }
  if (lane == 0) rk[nr] = static_cast<uint16_t>(np);
  __syncwarp();
  npos = np;
  return nr;
}

// Bit-sliced counts of a word's 32 colours (plane p holds bit p of each
// count): add len to the count of each colour whose bit of w is set, a
// ripple add of len x w over the planes.
template <int kNB>
__device__ __forceinline__ void plane_add(uint32_t (&pl)[kNB], uint32_t w,
                                          uint32_t len) {
  uint32_t carry = 0;
#pragma unroll
  for (int p = 0; p < kNB; ++p) {
    const uint32_t b = ((len >> p) & 1u) ? w : 0u;
    const uint32_t a = pl[p];
    pl[p] = a ^ b ^ carry;
    carry = (a & b) | (carry & (a ^ b));
  }
}

// pl += o, colour by colour.
template <int kNB>
__device__ __forceinline__ void planes_add(uint32_t (&pl)[kNB],
                                           const uint32_t (&o)[kNB]) {
  uint32_t carry = 0;
#pragma unroll
  for (int p = 0; p < kNB; ++p) {
    const uint32_t a = pl[p], b = o[p];
    pl[p] = a ^ b ^ carry;
    carry = (a & b) | (carry & (a ^ b));
  }
}

// The colours whose count is at least need, compared from the top plane.
template <int kNB>
__device__ __forceinline__ uint32_t planes_ge(const uint32_t (&pl)[kNB],
                                              int need) {
  if (need <= 0) return kFull;
  if (need >= (1 << kNB)) return 0u;
  uint32_t gt = 0, eq = kFull;
#pragma unroll
  for (int p = kNB - 1; p >= 0; --p) {
    if ((need >> p) & 1) {
      eq &= pl[p];
    } else {
      gt |= eq & pl[p];
      eq &= ~pl[p];
    }
  }
  return gt | eq;
}

// The bits of word j that stand for colours below C.
__device__ __forceinline__ uint32_t colour_bits(int j, int C) {
  const int n = C - 32 * j;
  return n >= 32 ? kFull : n <= 0 ? 0u : (1u << n) - 1u;
}

// Runs r, r + step, ... < nr added to the planes of word j, four rows in
// flight.
template <int kNB>
__device__ __forceinline__ void plane_runs(uint32_t (&pl)[kNB],
                                           const uint32_t* __restrict__ dense,
                                           int C32, int j, const uint32_t* cs,
                                           const uint16_t* rk, int r, int nr,
                                           int step) {
  for (; r + 3 * step < nr; r += 4 * step) {
    uint32_t w[4], len[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = r + u * step;
      w[u] = __ldg(dense + static_cast<size_t>(cs[i]) * C32 + j);
      len[u] = rk[i + 1] - rk[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) plane_add(pl, w[u], len[u]);
  }
  for (; r < nr; r += step)
    plane_add(pl, __ldg(dense + static_cast<size_t>(cs[r]) * C32 + j),
              static_cast<uint32_t>(rk[r + 1] - rk[r]));
}

// The row words of runs 0..nr-1 (at most kTable) at words j, j + 32, ...,
// j + 32 (kJ - 1), 0 past nr or C32.
template <int kJ>
__device__ __forceinline__ void table_words(uint32_t (&b)[kJ][kTable],
                                            const uint32_t* __restrict__ dense,
                                            int C32, const size_t (&row)[kTable],
                                            int nr, int j) {
#pragma unroll
  for (int k = 0; k < kJ; ++k)
#pragma unroll
    for (int r = 0; r < kTable; ++r)
      b[k][r] = r < nr && j + 32 * k < C32
                    ? __ldg(dense + row[r] + j + 32 * k)
                    : 0u;
}

// A read of at most kTable runs: whether a colour passes depends only on
// which of the runs' rows hold it, pattern q (bit r: run r's row). Lane q
// sums the lengths of pattern q's runs against need; the ballot is the
// truth table T, and each word is T looked up colour by colour by a
// multiplexer tree over the runs' row words (15 three-input operations a
// word, in place of a bit-sliced add a run and a compare). A lane loads
// kJ words' rows at once, the first before T is made.
__device__ __forceinline__ void table_mask(
    const uint32_t* __restrict__ dense, int C32, int C, const uint32_t* cs,
    const uint16_t* rk, int nr, int need, int lane,
    uint32_t* __restrict__ orow) {
  constexpr int kJ = 2;
  size_t row[kTable];
#pragma unroll
  for (int r = 0; r < kTable; ++r)
    row[r] = r < nr ? static_cast<size_t>(cs[r]) * C32 : 0;
  uint32_t b[kJ][kTable];
  table_words(b, dense, C32, row, nr, lane);
  const int q = lane & 15;
  int s = 0;
#pragma unroll
  for (int r = 0; r < kTable; ++r)
    if (r < nr && ((q >> r) & 1)) s += rk[r + 1] - rk[r];
  const uint32_t T = __ballot_sync(kFull, s >= need);
  uint32_t L[16];  // the leaves: all ones where pattern q passes
#pragma unroll
  for (int i = 0; i < 16; ++i) L[i] = 0u - ((T >> i) & 1u);
  for (int j = lane; j < C32; j += 32 * kJ) {
    if (j != lane) table_words(b, dense, C32, row, nr, j);
#pragma unroll
    for (int k = 0; k < kJ; ++k) {
      uint32_t n1[8], n2[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        n1[i] = (b[k][0] & L[2 * i + 1]) | (~b[k][0] & L[2 * i]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        n2[i] = (b[k][1] & n1[2 * i + 1]) | (~b[k][1] & n1[2 * i]);
      const uint32_t n3a = (b[k][2] & n2[1]) | (~b[k][2] & n2[0]);
      const uint32_t n3b = (b[k][2] & n2[3]) | (~b[k][2] & n2[2]);
      const int jj = j + 32 * k;
      if (jj < C32)
        orow[jj] = ((b[k][3] & n3b) | (~b[k][3] & n3a)) & colour_bits(jj, C);
    }
  }
}

// K4 on read b, by its warp; cs and rk the warp's run list.
template <int kRows, bool kNarrow>
__device__ __forceinline__ void tu_mask_read(
    const uint32_t* __restrict__ dense, int C32, int P, int C,
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid,
    int Wk, const int32_t* __restrict__ minscore, uint32_t* __restrict__ out,
    long long b, int lane, uint32_t* cs, uint16_t* rk) {
  constexpr int kNB = planes_for(kRows);
  int npos;
  uint32_t hitw;
  const int nr = warp_runs<kRows>(hit + b * Wk, csid + b * Wk, Wk, lane, cs,
                                  rk, npos, hitw);
  uint32_t* orow = out + b * C32;
  if (npos == 0) {
    for (int j = lane; j < C32; j += 32) orow[j] = 0u;
    return;
  }
  const int need = __ldg(minscore + npos);
  if (nr <= kTable) {
    table_mask(dense, C32, C, cs, rk, nr, need, lane, orow);
  } else if constexpr (kNarrow) {
    const int G = 32 / P;
    const int g = lane / P, j = lane & (P - 1);
    uint32_t pl[kNB] = {};
    if (j < C32) plane_runs(pl, dense, C32, j, cs, rk, g, nr, G);
    for (int off = P; off < 32; off <<= 1) {
      uint32_t o[kNB];
#pragma unroll
      for (int p = 0; p < kNB; ++p) o[p] = __shfl_xor_sync(kFull, pl[p], off);
      planes_add(pl, o);
    }
    if (lane < C32) orow[lane] = planes_ge(pl, need) & colour_bits(lane, C);
  } else {
    for (int j = lane; j < C32; j += 32) {
      uint32_t pl[kNB] = {};
      plane_runs(pl, dense, C32, j, cs, rk, 0, nr, 1);
      orow[j] = planes_ge(pl, need) & colour_bits(j, C);
    }
  }
}

template <int kRows, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32) tu_mask_kernel(
    const uint32_t* __restrict__ dense, int C32, int P, int C,
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int B,
    int Wk, const int32_t* __restrict__ minscore, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t runs[];  // kWarps x (Wk csids, Wk + 1 ranks)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* cs = runs + warp * (Wk + (Wk + 2) / 2);
  uint16_t* rk = reinterpret_cast<uint16_t*>(cs + Wk);
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b < B)  // the whole warp
    tu_mask_read<kRows, kNarrow>(dense, C32, P, C, hit, csid, Wk, minscore,
                                 out, b, lane, cs, rk);
}

// K5's spread table: byte x's 8 bits as four words of two 16-bit fields,
// bit 2k in the low field of word k and bit 2k + 1 in the high one, so
// that adding len x entry to four packed counters counts 8 colours.
struct alignas(16) Spread {
  uint32_t v[256 * 4];
};
__host__ __device__ constexpr Spread make_spread() {
  Spread s{};
  for (uint32_t x = 0; x < 256; ++x)
    for (uint32_t k = 0; k < 4; ++k)
      s.v[4 * x + k] = ((x >> (2 * k)) & 1u) | (((x >> (2 * k + 1)) & 1u) << 16);
  return s;
}
__device__ const Spread kSpread = make_spread();

// acc (four words of two 16-bit counts: 8 colours) += len x the spread of
// byte x.
__device__ __forceinline__ void count_byte(uint32_t (&acc)[4], uint32_t x,
                                           uint32_t len) {
  const uint4 e = __ldg(reinterpret_cast<const uint4*>(kSpread.v) + x);
  acc[0] += e.x * len;
  acc[1] += e.y * len;
  acc[2] += e.z * len;
  acc[3] += e.w * len;
}

// 8 colours' scores from c0 on (c0 a multiple of 8), acc as count_byte
// leaves them, as int16: one 16 B store (mode 2: the row and c0 16 B
// aligned), four 4 B stores (mode 1), else one a colour; colours from C
// on are not written.
__device__ __forceinline__ void store_scores(int16_t* __restrict__ srow,
                                             int c0, int C, int mode,
                                             const uint32_t (&acc)[4]) {
  if (c0 + 8 <= C && mode == 2) {
    *reinterpret_cast<uint4*>(srow + c0) =
        make_uint4(acc[0], acc[1], acc[2], acc[3]);
  } else if (c0 + 8 <= C && mode == 1) {
    uint32_t* p = reinterpret_cast<uint32_t*>(srow + c0);
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = acc[k];
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (c0 + t < C)
        srow[c0 + t] = static_cast<int16_t>(acc[t >> 1] >> (16 * (t & 1)));
  }
}

// K5 on read b, by its warp; cs and rk the warp's run list.
template <int kRows>
__device__ __forceinline__ void km_scores_read(
    const uint32_t* __restrict__ dense, int C32, int C,
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int Wk,
    int mode, int16_t* __restrict__ scores, uint32_t* __restrict__ hitw,
    long long b, int lane, uint32_t* cs, uint16_t* rk) {
  const uint8_t* hrow = hit + b * Wk;
  int npos;
  uint32_t mine = 0;
  const int nr = warp_runs<kRows>(hrow, csid + b * Wk, Wk, lane, cs, rk, npos,
                                  mine);
  // the hit words, at most 32 (Wk <= 1,024): lane i stores word i
  const int nw = (Wk + 31) >> 5;
  if (lane < nw) hitw[b * nw + lane] = mine;

  int16_t* srow = scores + b * C;
  const int sh = (lane & 3) * 8;
  for (int j0 = 0; j0 < C32; j0 += 16) {
    const int ja = j0 + (lane >> 2), jb = ja + 8;
    const bool ina = ja < C32, inb = jb < C32;
    uint32_t ca[4] = {}, cb[4] = {};
    // four runs' rows in flight, a batch past nr padded with length 0
    for (int r = 0; r < nr; r += 4) {
      uint32_t wa[4], wb[4], len[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = r + u < nr;
        len[u] = in ? rk[r + u + 1] - rk[r + u] : 0u;
        const size_t row = in ? static_cast<size_t>(cs[r + u]) * C32 : 0;
        wa[u] = in && ina ? __ldg(dense + row + ja) : 0u;
        wb[u] = in && inb ? __ldg(dense + row + jb) : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        count_byte(ca, (wa[u] >> sh) & 0xFFu, len[u]);
        count_byte(cb, (wb[u] >> sh) & 0xFFu, len[u]);
      }
    }
    const int c0 = j0 * 32 + lane * 8;
    store_scores(srow, c0, C, mode, ca);
    store_scores(srow, c0 + 256, C, mode, cb);
  }
}

template <int kRows>
__global__ void __launch_bounds__(kWarps * 32) km_scores_kernel(
    const uint32_t* __restrict__ dense, int C32, int C,
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int B,
    int Wk, int mode, int16_t* __restrict__ scores,
    uint32_t* __restrict__ hitw) {
  extern __shared__ uint32_t runs[];  // kWarps x (Wk csids, Wk + 1 ranks)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* cs = runs + warp * (Wk + (Wk + 2) / 2);
  uint16_t* rk = reinterpret_cast<uint16_t*>(cs + Wk);
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b < B)  // the whole warp
    km_scores_read<kRows>(dense, C32, C, hit, csid, Wk, mode, scores, hitw, b,
                          lane, cs, rk);
}

// K12's runs: the valid (csid, count) runs of one read.
struct WeightedRuns {
  uint32_t run_cs[kMaxWk];
  uint32_t run_len[kMaxWk];
  int nruns;
};

__device__ __forceinline__ uint32_t run_weight(int16_t v) {
  return static_cast<uint16_t>(v);  // K6's u16 lengths
}
__device__ __forceinline__ uint32_t run_weight(int32_t v) {
  return static_cast<uint32_t>(v);
}

template <typename CntT>
__device__ void stage_weighted_runs(const uint32_t* __restrict__ run_csid,
                                    const CntT* __restrict__ run_cnt, int R,
                                    size_t b, WeightedRuns& r) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned below = (1u << lane) - 1u;
    int n = 0;
    for (int i0 = 0; i0 < R; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t c = i < R ? run_csid[b * R + i] : 0xFFFFFFFFu;
      const bool valid = c != 0xFFFFFFFFu;
      const unsigned bv = __ballot_sync(kFull, valid);
      if (valid) {
        const int at = n + __popc(bv & below);
        r.run_cs[at] = c;
        r.run_len[at] = run_weight(run_cnt[b * R + i]);
      }
      n += __popc(bv);
    }
    if (lane == 0) r.nruns = n;
  }
  __syncthreads();
}

// Score of colour (word j, bit) over the staged runs.
template <typename RunList>
__device__ __forceinline__ uint32_t score_of(
    const uint32_t* __restrict__ dense, int C32, int j, int bit,
    const RunList& r) {
  uint32_t s = 0;
  for (int i = 0; i < r.nruns; ++i) {
    const uint32_t word =
        __ldg(dense + static_cast<size_t>(r.run_cs[i]) * C32 + j);
    s += ((word >> bit) & 1u) * r.run_len[i];
  }
  return s;
}

// K12: mask mode (kMask) writes (B, C32) u32 words, else (B, C) int16.
template <bool kMask, typename CntT>
__global__ void runs_scores_kernel(const uint32_t* __restrict__ dense, int C32,
                                   int C, const uint32_t* __restrict__ run_csid,
                                   const CntT* __restrict__ run_cnt, int R,
                                   const int32_t* __restrict__ npos,
                                   const int32_t* __restrict__ minscore,
                                   int n_ms, uint32_t* __restrict__ mask,
                                   int16_t* __restrict__ scores) {
  __shared__ WeightedRuns r;
  const size_t b = blockIdx.x;
  stage_weighted_runs(run_csid, run_cnt, R, b, r);
  if constexpr (kMask) {
    const int np = npos[b];
    // a count past the table passes no colour (the engine's table covers
    // every count a read of its width can have)
    const int need = np < n_ms ? minscore[np] : INT_MAX;
    for (int c0 = 0; c0 < C32 * 32; c0 += blockDim.x) {
      const int c = c0 + threadIdx.x;
      if (c >= C32 * 32) break;
      const int j = c >> 5;
      const bool pass = np > 0 && c < C &&
                        static_cast<int>(score_of(dense, C32, j, c & 31, r)) >=
                            need;
      const unsigned word = __ballot_sync(kFull, pass);
      if ((threadIdx.x & 31) == 0) mask[b * C32 + j] = word;
    }
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      scores[b * C + c] =
          static_cast<int16_t>(score_of(dense, C32, c >> 5, c & 31, r));
  }
}

template <typename CntT>
int launch_runs_scores(const void* dense, int C32, int C, const void* run_csid,
                       const void* run_cnt, int B, int R, const void* npos,
                       const void* minscore, int n_ms, void* out,
                       cudaStream_t stream, int threads) {
  const auto* d = static_cast<const uint32_t*>(dense);
  const auto* rc = static_cast<const uint32_t*>(run_csid);
  const auto* cnt = static_cast<const CntT*>(run_cnt);
  if (minscore != nullptr)
    runs_scores_kernel<true, CntT><<<B, threads, 0, stream>>>(
        d, C32, C, rc, cnt, R, static_cast<const int32_t*>(npos),
        static_cast<const int32_t*>(minscore), n_ms,
        static_cast<uint32_t*>(out), nullptr);
  else
    runs_scores_kernel<false, CntT><<<B, threads, 0, stream>>>(
        d, C32, C, rc, cnt, R, nullptr, nullptr, 0, nullptr,
        static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int threads_for(int C32) {
  const int t = C32 * 32;
  return t > 256 ? 256 : t;
}

bool bad_shape(int B, int C32, int C, int Wk) {
  return B <= 0 || C32 <= 0 || C <= 0 || C > C32 * 32 || Wk <= 0 ||
         Wk > kMaxWk;
}

// K4/K5: rows of 32 windows a pass (a read's windows in one pass up to
// 256), and each block's run lists
int rows_per_pass(int Wk) { return Wk > 224 ? 8 : (Wk + 31) / 32; }

size_t runs_smem(int Wk) {
  return static_cast<size_t>(kWarps) * (Wk + (Wk + 2) / 2) * sizeof(uint32_t);
}

// Past 48 KB (Wk = 1,024) a block's dynamic shared memory must be allowed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int fulgor_tu_mask(const void* dense, int C32, int C,
                              const void* hit, const void* csid, int B, int Wk,
                              const void* minscore, void* out, void* stream) {
  if (bad_shape(B, C32, C, Wk)) return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < C32 && P < 32) P <<= 1;
  auto kernel = tu_mask_kernel<1, true>;
  switch (rows_per_pass(Wk)) {
#define FULGOR_TU_MASK_CASE(N)                                           \
  case N:                                                                \
    kernel = C32 <= 32 ? tu_mask_kernel<N, true> : tu_mask_kernel<N, false>; \
    break;
    FULGOR_TU_MASK_CASE(1)
    FULGOR_TU_MASK_CASE(2)
    FULGOR_TU_MASK_CASE(3)
    FULGOR_TU_MASK_CASE(4)
    FULGOR_TU_MASK_CASE(5)
    FULGOR_TU_MASK_CASE(6)
    FULGOR_TU_MASK_CASE(7)
    FULGOR_TU_MASK_CASE(8)
#undef FULGOR_TU_MASK_CASE
  }
  const size_t smem = runs_smem(Wk);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dense), C32, P, C,
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), B,
      Wk, static_cast<const int32_t*>(minscore), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fulgor_km_scores(const void* dense, int C32, int C,
                                const void* hit, const void* csid, int B,
                                int Wk, void* scores, void* hitw,
                                void* stream) {
  if (bad_shape(B, C32, C, Wk)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = km_scores_kernel<1>;
  switch (rows_per_pass(Wk)) {
#define FULGOR_KM_SCORES_CASE(N) \
  case N:                        \
    kernel = km_scores_kernel<N>; \
    break;
    FULGOR_KM_SCORES_CASE(1)
    FULGOR_KM_SCORES_CASE(2)
    FULGOR_KM_SCORES_CASE(3)
    FULGOR_KM_SCORES_CASE(4)
    FULGOR_KM_SCORES_CASE(5)
    FULGOR_KM_SCORES_CASE(6)
    FULGOR_KM_SCORES_CASE(7)
    FULGOR_KM_SCORES_CASE(8)
#undef FULGOR_KM_SCORES_CASE
  }
  const size_t smem = runs_smem(Wk);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the store width a row allows: 16 B where each row starts 16 B aligned
  const auto at = reinterpret_cast<uintptr_t>(scores);
  const int mode = C % 8 == 0 && at % 16 == 0   ? 2
                   : C % 2 == 0 && at % 4 == 0 ? 1
                                               : 0;
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dense), C32, C,
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), B,
      Wk, mode, static_cast<int16_t*>(scores), static_cast<uint32_t*>(hitw));
  return static_cast<int>(cudaGetLastError());
}

// K12: minscore null -> u16 mode (out (B, C) int16), else mask mode (out
// (B, C32) u32, npos (B,) int32, minscore (n_ms,) int32). cnt_bytes: 2 for
// K6's int16 run lengths, 4 for int32 counts. 0 <= C <= 32 * C32.
extern "C" int fulgor_runs_scores(const void* dense, int C32, int C,
                                  const void* run_csid, const void* run_cnt,
                                  int cnt_bytes, int B, int R, const void* npos,
                                  const void* minscore, int n_ms, void* out,
                                  void* stream) {
  if (B <= 0 || C32 <= 0 || C < 0 || C > C32 * 32 || R <= 0 || R > kMaxWk ||
      (cnt_bytes != 2 && cnt_bytes != 4) || (minscore != nullptr && n_ms <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (cnt_bytes == 2)
    return launch_runs_scores<int16_t>(dense, C32, C, run_csid, run_cnt, B, R,
                                       npos, minscore, n_ms, out, s,
                                       threads_for(C32));
  return launch_runs_scores<int32_t>(dense, C32, C, run_csid, run_cnt, B, R,
                                     npos, minscore, n_ms, out, s,
                                     threads_for(C32));
}
