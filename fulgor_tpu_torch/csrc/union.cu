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
//   never reach device memory: each warp's ballot is one output word.
//   K5 replaces the colour stage of query_kmer_matches_packed2 (:367-370):
//   the scores as int16, and the positivity bits of _pack_hits (:338).
// Plain versions: fulgor_tpu_torch/ops/intersect.py tu_mask_plain and
// km_scores_plain.
//
// What bounds them: bytes. Each reads hit and csid once (5 B a window) and
// one C32-word bit row per run of equal csids (rows stay in L2); K4 writes
// C32 words a read, K5 two bytes a colour a read.
//
// Design: one block per read. stage_runs() stages the read's windows in
// shared memory, then warp 0 walks them 32 at a time and, with ballots,
// compacts the runs of consecutive positive windows with equal csid into a
// (csid, length) list and counts the positive windows (npos); its hit
// ballots are K5's hitw words. Each thread then owns one colour of a tile
// of blockDim colours and adds, over the runs, length x bit c of the run's
// row; the 32 lanes of a warp read one row word (a broadcast). A csid that
// recurs after another run is counted again: threshold union counts every
// positive window, unlike K3's AND, which may skip repeats.
//
// K12 runs_scores is the same block-a-read body over runs that arrive
// built: K6's (csid, count) runs of a read, INVALID-padded, gathered from
// the cells of a mesh row and scored against one colour shard. It replaces
// compact_runs -> threshold_union_scores_runs (fulgor_tpu/ops/intersect.py
// :264) in fulgor_tpu/parallel/mesh.py make_sharded_threshold_union(_packed)
// (:89, :154) and make_sharded_kmer_matches (:263): score[b, c] =
// sum over the valid runs r (csid != INVALID) of run_cnt[b, r] x bit c of
// the run's row. Mask mode (the mesh TU) thresholds the scores against
// minscore[npos[b]] with npos > 0, as K4 does, npos the read's positive
// windows gathered with its runs; u16 mode (the mesh kmer-matches) writes
// the scores as int16 bit patterns. Plain versions: ops/intersect.py
// runs_scores_plain and runs_mask_plain. Bound and design as K4/K5: warp 0
// compacts the valid runs into shared memory with ballots, the threads
// then own colours and add count x bit over the runs.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWk = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Runs {
  uint32_t cs[kMaxWk];       // window csids
  uint8_t hv[kMaxWk];        // window positivity
  uint16_t start[kMaxWk];    // first window of each run
  uint16_t end[kMaxWk];      // last window of each run
  uint32_t run_cs[kMaxWk];   // csid of each run
  uint32_t run_len[kMaxWk];  // windows in each run
  uint32_t hitw[kMaxWk / 32];
  int nruns;
  int npos;
};

__device__ void stage_runs(const uint8_t* __restrict__ hit,
                           const uint32_t* __restrict__ csid, int Wk,
                           size_t b, Runs& r) {
  for (int w = threadIdx.x; w < Wk; w += blockDim.x) {
    r.hv[w] = hit[b * Wk + w];
    r.cs[w] = csid[b * Wk + w];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned below = (1u << lane) - 1u;
    int nstart = 0, nend = 0, npos = 0;
    for (int w0 = 0; w0 < Wk; w0 += 32) {
      const int w = w0 + lane;
      const bool h = w < Wk && r.hv[w];
      const uint32_t c = h ? r.cs[w] : 0u;
      const bool is_start =
          h && (w == 0 || !r.hv[w - 1] || r.cs[w - 1] != c);
      const bool is_end =
          h && (w + 1 >= Wk || !r.hv[w + 1] || r.cs[w + 1] != c);
      const unsigned bs = __ballot_sync(kFull, is_start);
      const unsigned be = __ballot_sync(kFull, is_end);
      const unsigned bh = __ballot_sync(kFull, h);
      if (is_start) r.start[nstart + __popc(bs & below)] = w;
      if (is_end) r.end[nend + __popc(be & below)] = w;
      if (lane == 0) r.hitw[w0 >> 5] = bh;
      nstart += __popc(bs);
      nend += __popc(be);
      npos += __popc(bh);
    }
    if (lane == 0) {
      r.nruns = nstart;
      r.npos = npos;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r.nruns; i += blockDim.x) {
    r.run_cs[i] = r.cs[r.start[i]];
    r.run_len[i] = r.end[i] - r.start[i] + 1u;
  }
  __syncthreads();
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

__global__ void tu_mask_kernel(const uint32_t* __restrict__ dense, int C32,
                               int C, const uint8_t* __restrict__ hit,
                               const uint32_t* __restrict__ csid, int Wk,
                               const int32_t* __restrict__ minscore,
                               uint32_t* __restrict__ out) {
  __shared__ Runs r;
  const size_t b = blockIdx.x;
  stage_runs(hit, csid, Wk, b, r);
  const int npos = r.npos;
  const int need = minscore[npos];
  // blockDim and C32 * 32 are multiples of 32: a warp is in or out whole,
  // so the ballot below always has all 32 lanes
  for (int c0 = 0; c0 < C32 * 32; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    if (c >= C32 * 32) break;
    const int j = c >> 5;
    const bool pass = npos > 0 && c < C &&
                      static_cast<int>(score_of(dense, C32, j, c & 31, r)) >=
                          need;
    const unsigned word = __ballot_sync(kFull, pass);
    if ((threadIdx.x & 31) == 0) out[b * C32 + j] = word;
  }
}

__global__ void km_scores_kernel(const uint32_t* __restrict__ dense, int C32,
                                 int C, const uint8_t* __restrict__ hit,
                                 const uint32_t* __restrict__ csid, int Wk,
                                 int16_t* __restrict__ scores,
                                 uint32_t* __restrict__ hitw) {
  __shared__ Runs r;
  const size_t b = blockIdx.x;
  stage_runs(hit, csid, Wk, b, r);
  const int nw = (Wk + 31) / 32;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) hitw[b * nw + i] = r.hitw[i];
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    scores[b * C + c] =
        static_cast<int16_t>(score_of(dense, C32, c >> 5, c & 31, r));
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

}  // namespace

extern "C" int fulgor_tu_mask(const void* dense, int C32, int C,
                              const void* hit, const void* csid, int B, int Wk,
                              const void* minscore, void* out, void* stream) {
  if (bad_shape(B, C32, C, Wk)) return static_cast<int>(cudaErrorInvalidValue);
  tu_mask_kernel<<<B, threads_for(C32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dense), C32, C,
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), Wk,
      static_cast<const int32_t*>(minscore), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fulgor_km_scores(const void* dense, int C32, int C,
                                const void* hit, const void* csid, int B,
                                int Wk, void* scores, void* hitw,
                                void* stream) {
  if (bad_shape(B, C32, C, Wk)) return static_cast<int>(cudaErrorInvalidValue);
  km_scores_kernel<<<B, threads_for(C32), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dense), C32, C,
      static_cast<const uint8_t*>(hit), static_cast<const uint32_t*>(csid), Wk,
      static_cast<int16_t*>(scores), static_cast<uint32_t*>(hitw));
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
