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

// K12 runs_scores: the same scores over runs that arrive built, K6's
// (csid, count) runs of a read, INVALID-padded, gathered from the cells of
// a mesh row and scored against one colour shard. It replaces compact_runs
// -> threshold_union_scores_runs (fulgor_tpu/ops/intersect.py:264) in
// fulgor_tpu/parallel/mesh.py make_sharded_threshold_union(_packed) (:89,
// :154) and make_sharded_kmer_matches (:263): score[b, c] = sum over the
// valid runs r (csid != INVALID) of run_cnt[b, r] x bit c of the run's row.
// Mask mode (the mesh TU) thresholds the scores against minscore[npos[b]]
// with 0 < npos < the table's length, as K4 does, npos the read's positive
// windows gathered with its runs; u16 mode (the mesh kmer-matches) writes
// the scores as int16 bit patterns (mod 2^16, as the plain version's cast).
// Plain versions: ops/intersect.py runs_scores_plain and runs_mask_plain.
//   Bound: bytes. Each run slot read once (a 4 B csid; the count of a valid
//   one), npos and the table, one C32-word row a distinct csid, and C32
//   words (mask) or 2 B a colour (u16) written a read.
//   Design: K4/K5's; only the front end is its own (weighted_runs): the
//   warp loads the slots 32 at a time, compacts the valid runs in slot
//   order by a ballot into warp_runs' layout and ranks them by a warp scan
//   of their counts, so that a run weighs the difference of its ranks. Mask
//   mode then takes K4's back ends (the truth table for at most kTable
//   runs, else bit planes sized by the read's total count), u16 mode K5's
//   spread-table counters. A read whose counts these cannot hold (a total
//   past 65,535, in mask mode past 2,047 with more than kTable runs, or an
//   int32 count outside [0, 65,535]) is scored colour by colour from its
//   slots in global memory (exact_score), so that no count the C entry
//   accepts wraps. The first design (warp 0 compacting while seven warps
//   waited at a block barrier, then a thread a colour walking every run,
//   one dependent load a run) reached 6% of the bound.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWk = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
// K4, K5 and K12: reads a block, a warp each
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

// The mask words of a read of more than kTable runs, bit-sliced over kNB
// planes (enough for the read's largest count); cs and rk the warp's run
// list.
template <int kNB, bool kNarrow>
__device__ __forceinline__ void plane_mask(
    const uint32_t* __restrict__ dense, int C32, int P, int C,
    const uint32_t* cs, const uint16_t* rk, int nr, int need, int lane,
    uint32_t* __restrict__ orow) {
  if constexpr (kNarrow) {
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

__device__ __forceinline__ void zero_words(uint32_t* __restrict__ orow,
                                           int C32, int lane) {
  for (int j = lane; j < C32; j += 32) orow[j] = 0u;
}

// K4 on read b, by its warp; cs and rk the warp's run list.
template <int kRows, bool kNarrow>
__device__ __forceinline__ void tu_mask_read(
    const uint32_t* __restrict__ dense, int C32, int P, int C,
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid,
    int Wk, const int32_t* __restrict__ minscore, uint32_t* __restrict__ out,
    long long b, int lane, uint32_t* cs, uint16_t* rk) {
  int npos;
  uint32_t hitw;
  const int nr = warp_runs<kRows>(hit + b * Wk, csid + b * Wk, Wk, lane, cs,
                                  rk, npos, hitw);
  uint32_t* orow = out + b * C32;
  if (npos == 0) return zero_words(orow, C32, lane);
  const int need = __ldg(minscore + npos);
  if (nr <= kTable)
    table_mask(dense, C32, C, cs, rk, nr, need, lane, orow);
  else
    plane_mask<planes_for(kRows), kNarrow>(dense, C32, P, C, cs, rk, nr, need,
                                           lane, orow);
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

// A read's int16 scores of colours 0..C-1 into srow, counted as 16-bit
// fields from the spread table (no colour's score may pass 65,535); cs
// and rk the warp's run list, mode as store_scores.
__device__ __forceinline__ void spread_scores(
    const uint32_t* __restrict__ dense, int C32, int C, const uint32_t* cs,
    const uint16_t* rk, int nr, int mode, int16_t* __restrict__ srow,
    int lane) {
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

// K5 on read b, by its warp; cs and rk the warp's run list.
template <int kRows>
__device__ __forceinline__ void km_scores_read(
    const uint32_t* __restrict__ dense, int C32, int C,
    const uint8_t* __restrict__ hit, const uint32_t* __restrict__ csid, int Wk,
    int mode, int16_t* __restrict__ scores, uint32_t* __restrict__ hitw,
    long long b, int lane, uint32_t* cs, uint16_t* rk) {
  int npos;
  uint32_t mine = 0;
  const int nr = warp_runs<kRows>(hit + b * Wk, csid + b * Wk, Wk, lane, cs,
                                  rk, npos, mine);
  // the hit words, at most 32 (Wk <= 1,024): lane i stores word i
  const int nw = (Wk + 31) >> 5;
  if (lane < nw) hitw[b * nw + lane] = mine;
  spread_scores(dense, C32, C, cs, rk, nr, mode, scores + b * C, lane);
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

// K12's run slots loaded at once by weighted_runs: kSlotRows rows of 32
constexpr int kSlotRows = 8;
// the largest weight, and the largest total of a read, that the run lists'
// u16 ranks and K5's 16-bit fields hold; and the largest total that
// K4's 11 bit planes hold. A read past them takes exact_score.
constexpr int kMaxPacked = 0xFFFF;
constexpr int kMaxPlanes = 2047;

// K12's front end: read b's valid run slots (csid not INVALID), in slot
// order, into the warp's slice as warp_runs lays out its runs: cs[i] the
// csid of valid run i, rk[i] the sum of the weights before it and rk[nr]
// their total, so that run i weighs rk[i + 1] - rk[i]. Valid runs may
// stand in any slot (the mesh gathers a row's cells' INVALID-padded lists
// side by side); a csid that recurs is a run of its own and counts again.
// The weight of a slot is its count: K6's int16 lengths as u16 (c16), or
// int32 counts (c32), their low 16 bits where low16 (u16 mode keeps no
// more). The warp loads the slots 32 at a time, a lane each, kSlotRows
// rows at once, coalesced; a ballot of the valid slots places each run's
// csid and weight, then a warp scan over the run list (one a read of at
// most 31 runs) turns the weights into ranks. -> nr; total: the weights'
// sum, or INT_MAX where a valid weight is outside [0, kMaxPacked] (only
// int32 counts in mask mode); the ranks are u16, so they hold only where
// total <= kMaxPacked.
__device__ __forceinline__ int weighted_runs(
    const uint32_t* __restrict__ crow, const uint16_t* __restrict__ c16,
    const int32_t* __restrict__ c32, int R, bool low16, int lane,
    uint32_t* cs, uint16_t* rk, int& total) {
  const uint32_t below = (1u << lane) - 1u;
  int nr = 0;
  bool odd = false;
  for (int i0 = 0; i0 < R; i0 += 32 * kSlotRows) {
    uint32_t c[kSlotRows];
    int32_t x[kSlotRows];
#pragma unroll
    for (int t = 0; t < kSlotRows; ++t) {
      const int i = i0 + 32 * t + lane;
      const bool in = i < R;
      c[t] = in ? __ldg(crow + i) : kNone;
      x[t] = !in  ? 0
             : c16 ? static_cast<int32_t>(__ldg(c16 + i))
                   : __ldg(c32 + i);
    }
#pragma unroll
    for (int t = 0; t < kSlotRows; ++t) {
      if (i0 + 32 * t >= R) break;  // the whole warp
      const bool valid = c[t] != kNone;
      const uint32_t vb = __ballot_sync(kFull, valid);
      if (valid) {
        const int32_t w = low16 ? x[t] & 0xFFFF : x[t];
        const int at = nr + __popc(vb & below);
        cs[at] = c[t];
        rk[at] = static_cast<uint16_t>(w);
        odd = odd || w < 0 || w > kMaxPacked;
      }
      nr += __popc(vb);
    }
  }
  __syncwarp();
  // the weights in rk[0..nr) into ranks, rk[nr] the total
  int sum = 0;
  for (int i0 = 0; i0 <= nr; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t v = i < nr ? rk[i] : 0u;
    uint32_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (i <= nr) rk[i] = static_cast<uint16_t>(sum + incl - v);
    sum += static_cast<int>(__shfl_sync(kFull, incl, 31));
  }
  __syncwarp();
  total = __any_sync(kFull, odd) ? INT_MAX : sum;
  return nr;
}

// The score of colour 32 j + lane over a read's R slots, read again from
// global memory and summed mod 2^32 as the plain version's int32 sums: the
// exact path of a read whose weights the run list's ranks or the packed
// counters cannot hold. Each load serves the whole warp.
__device__ __forceinline__ uint32_t exact_score(
    const uint32_t* __restrict__ dense, int C32, int j, int lane,
    const uint32_t* __restrict__ crow, const uint16_t* __restrict__ c16,
    const int32_t* __restrict__ c32, int R) {
  uint32_t s = 0;
  for (int i = 0; i < R; ++i) {
    const uint32_t c = __ldg(crow + i);
    if (c == kNone) continue;
    const uint32_t w = c16 ? static_cast<uint32_t>(__ldg(c16 + i))
                           : static_cast<uint32_t>(__ldg(c32 + i));
    s += ((__ldg(dense + static_cast<size_t>(c) * C32 + j) >> lane) & 1u) * w;
  }
  return s;
}

// K12's mask mode on one read, by its warp: np its positive windows.
template <bool kNarrow>
__device__ __forceinline__ void runs_mask_read(
    const uint32_t* __restrict__ dense, int C32, int P, int C,
    const uint32_t* __restrict__ crow, const uint16_t* __restrict__ c16,
    const int32_t* __restrict__ c32, int R, int np,
    const int32_t* __restrict__ minscore, int n_ms,
    uint32_t* __restrict__ orow, int lane, uint32_t* cs, uint16_t* rk) {
  // no positive window, or a count past the table: no colour passes
  if (np <= 0 || np >= n_ms) return zero_words(orow, C32, lane);
  const int need = __ldg(minscore + np);
  int total;
  const int nr = weighted_runs(crow, c16, c32, R, false, lane, cs, rk, total);
  // the bit planes sized by the read's total, as K4's by its Wk
  if (total <= kMaxPacked && nr <= kTable)
    table_mask(dense, C32, C, cs, rk, nr, need, lane, orow);
  else if (total < 64)
    plane_mask<6, kNarrow>(dense, C32, P, C, cs, rk, nr, need, lane, orow);
  else if (total < 128)
    plane_mask<7, kNarrow>(dense, C32, P, C, cs, rk, nr, need, lane, orow);
  else if (total < 256)
    plane_mask<8, kNarrow>(dense, C32, P, C, cs, rk, nr, need, lane, orow);
  else if (total <= kMaxPlanes)
    plane_mask<11, kNarrow>(dense, C32, P, C, cs, rk, nr, need, lane, orow);
  else
    for (int j = 0; j < C32; ++j) {
      const uint32_t s = exact_score(dense, C32, j, lane, crow, c16, c32, R);
      const uint32_t w = __ballot_sync(
          kFull, 32 * j + lane < C && static_cast<int>(s) >= need);
      if (lane == 0) orow[j] = w;
    }
}

// K12's u16 mode on one read, by its warp: scores mod 2^16, as the plain
// version's int32 scores cast to int16.
__device__ __forceinline__ void runs_u16_read(
    const uint32_t* __restrict__ dense, int C32, int C,
    const uint32_t* __restrict__ crow, const uint16_t* __restrict__ c16,
    const int32_t* __restrict__ c32, int R, int mode,
    int16_t* __restrict__ srow, int lane, uint32_t* cs, uint16_t* rk) {
  int total;
  const int nr = weighted_runs(crow, c16, c32, R, true, lane, cs, rk, total);
  if (total <= kMaxPacked)
    return spread_scores(dense, C32, C, cs, rk, nr, mode, srow, lane);
  for (int j = 0; j < C32; ++j) {
    const uint32_t s = exact_score(dense, C32, j, lane, crow, c16, c32, R);
    if (32 * j + lane < C) srow[32 * j + lane] = static_cast<int16_t>(s);
  }
}

// K12, a warp a read: mask mode (kMask) writes (B, C32) u32 words, else
// (B, C) int16. One of c16 and c32 is null.
template <bool kMask, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32) runs_scores_kernel(
    const uint32_t* __restrict__ dense, int C32, int P, int C,
    const uint32_t* __restrict__ run_csid, const uint16_t* __restrict__ c16,
    const int32_t* __restrict__ c32, int B, int R,
    const int32_t* __restrict__ npos, const int32_t* __restrict__ minscore,
    int n_ms, int mode, uint32_t* __restrict__ mask,
    int16_t* __restrict__ scores) {
  extern __shared__ uint32_t runs[];  // kWarps x (R csids, R + 1 ranks)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* cs = runs + warp * (R + (R + 2) / 2);
  uint16_t* rk = reinterpret_cast<uint16_t*>(cs + R);
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // the whole warp
  const uint32_t* crow = run_csid + b * R;
  const uint16_t* r16 = c16 ? c16 + b * R : nullptr;
  const int32_t* r32 = c16 ? nullptr : c32 + b * R;
  if constexpr (kMask)
    runs_mask_read<kNarrow>(dense, C32, P, C, crow, r16, r32, R,
                            __ldg(npos + b), minscore, n_ms, mask + b * C32,
                            lane, cs, rk);
  else
    runs_u16_read(dense, C32, C, crow, r16, r32, R, mode, scores + b * C,
                  lane, cs, rk);
}

bool bad_shape(int B, int C32, int C, int Wk) {
  return B <= 0 || C32 <= 0 || C <= 0 || C > C32 * 32 || Wk <= 0 ||
         Wk > kMaxWk;
}

// K4/K5: rows of 32 windows a pass (a read's windows in one pass up to
// 256)
int rows_per_pass(int Wk) { return Wk > 224 ? 8 : (Wk + 31) / 32; }

// each block's run lists, at most Wk (K4/K5) or R (K12) runs a read
size_t runs_smem(int Wk) {
  return static_cast<size_t>(kWarps) * (Wk + (Wk + 2) / 2) * sizeof(uint32_t);
}

// K4 and K12's lane groups of a narrow row: the power of two at or above
// C32, at most 32
int lane_group(int C32) {
  int P = 1;
  while (P < C32 && P < 32) P <<= 1;
  return P;
}

// K5 and K12's store width (store_scores): 16 B where each row starts 16 B
// aligned, 4 B where 4 B aligned, else 2 B
int store_mode(int C, const void* scores) {
  const auto at = reinterpret_cast<uintptr_t>(scores);
  return C % 8 == 0 && at % 16 == 0 ? 2 : C % 2 == 0 && at % 4 == 0 ? 1 : 0;
}

// Past 48 KB (Wk or R = 1,024) a block's dynamic shared memory must be
// allowed.
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
      static_cast<const uint32_t*>(dense), C32, lane_group(C32), C,
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
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dense), C32, C,
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), B,
      Wk, store_mode(C, scores), static_cast<int16_t*>(scores),
      static_cast<uint32_t*>(hitw));
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
  const bool mask = minscore != nullptr;
  auto kernel = runs_scores_kernel<false, false>;
  if (mask)
    kernel = C32 <= 32 ? runs_scores_kernel<true, true>
                       : runs_scores_kernel<true, false>;
  const size_t smem = runs_smem(R);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* c16 = cnt_bytes == 2 ? static_cast<const uint16_t*>(run_cnt)
                                   : nullptr;
  const auto* c32 = cnt_bytes == 4 ? static_cast<const int32_t*>(run_cnt)
                                   : nullptr;
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dense), C32, lane_group(C32), C,
      static_cast<const uint32_t*>(run_csid), c16, c32, B, R,
      static_cast<const int32_t*>(npos), static_cast<const int32_t*>(minscore),
      n_ms, mask ? 0 : store_mode(C, out),
      mask ? static_cast<uint32_t*>(out) : nullptr,
      mask ? nullptr : static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
