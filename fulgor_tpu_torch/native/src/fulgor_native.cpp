// fulgor-tpu native host library.
//
// TPU-native replacement for the reference's native build stack: GGCAT
// (ccdBG construction), SSHash dictionary *construction* (here: bucketed
// cuckoo table build), and the bits codecs' hot decode loops. The query
// compute path lives on TPU (fulgor_tpu/ops); this library only prepares
// dense arrays for it and accelerates host-side build/load.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// All returned buffers are allocated with malloc and must be released with
// fn_free().
//
// Reference behavior being reproduced (see SURVEY.md §2.2):
//  - monochromatic maximal unitigs with per-unitig color sets
//    (include/GGCAT.hpp:79-88 use-site semantics)
//  - canonical k-mers, k odd, k <= 31
//  - deterministic unitig / color-set ordering (ours; the reference's GGCAT
//    stream order is not rebuild-stable, README.md:318)

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <unistd.h>
#include <zlib.h>

#ifdef _OPENMP
#include <parallel/algorithm>
#define PAR_SORT __gnu_parallel::sort
#else
#define PAR_SORT std::sort
#endif

extern "C" void fn_free(void* p) { free(p); }

// host thread budget: FULGOR_THREADS (the CLI's -t flag, reference
// build_configuration.num_threads) caps every std::thread pool here; the
// OpenMP regions honor OMP_NUM_THREADS which the CLI sets alongside it.
static unsigned host_threads() {
    const char* e = getenv("FULGOR_THREADS");
    if (e) {
        long v = atol(e);
        if (v >= 1) return (unsigned)v;
    }
    return std::max(1u, std::thread::hardware_concurrency());
}

// ---------------------------------------------------------------- utilities

static inline uint64_t rev2bits(uint64_t v) {
    v = ((v >> 2) & 0x3333333333333333ULL) | ((v & 0x3333333333333333ULL) << 2);
    v = ((v >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((v & 0x0F0F0F0F0F0F0F0FULL) << 4);
    v = __builtin_bswap64(v);
    return v;
}

static inline uint64_t revcomp(uint64_t kmer, int k) {
    uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    return rev2bits(kmer ^ mask) >> (64 - 2 * k);
}

// ASCII -> 2-bit code, 4 = invalid.
static uint8_t CODE[256];
static bool code_init = []() {
    memset(CODE, 4, sizeof(CODE));
    CODE['A'] = CODE['a'] = 0;
    CODE['C'] = CODE['c'] = 1;
    CODE['G'] = CODE['g'] = 2;
    CODE['T'] = CODE['t'] = 3;
    return true;
}();

// ---------------------------------------------------------------- FASTA/FASTQ

// Streaming FASTA/FASTQ parser over gzFile (zlib transparently handles
// uncompressed files too). Calls `cb(base_code)` per base and
// `record_break()` between records.
template <typename OnBase, typename OnBreak>
static bool stream_fastx(const char* path, OnBase&& on_base, OnBreak&& on_break) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    gzbuffer(f, 1 << 20);
    std::vector<char> buf(1 << 20);
    int state = 0;  // 0=line start, 1=in seq, 2=in header, 3=in fastq plus, 4=in quals
    bool fastq = false;
    int line_type = 0;  // for fastq line cycling: 0 seq,1 plus,2 qual
    (void)line_type;
    int mode = -1;  // -1 unknown, 0 fasta, 1 fastq
    int fq_phase = 0;  // fastq: 0 header,1 seq,2 plus,3 qual
    bool at_line_start = true;
    (void)state;
    (void)fastq;
    int cur = 0;  // fasta: 0 seq or header handled via flag
    bool in_header = false;
    for (;;) {
        int n = gzread(f, buf.data(), (unsigned)buf.size());
        if (n < 0) {
            gzclose(f);
            return false;
        }
        if (n == 0) break;
        for (int i = 0; i < n; ++i) {
            char ch = buf[i];
            if (at_line_start) {
                if (mode == -1) mode = (ch == '@') ? 1 : 0;
                if (mode == 0) {
                    in_header = (ch == '>');
                    if (in_header) on_break();
                } else {
                    // fastq phases advance per line
                    if (fq_phase == 0) on_break();
                }
                at_line_start = false;
                if (ch == '\n') {  // empty line
                    at_line_start = true;
                    if (mode == 1) fq_phase = (fq_phase + 1) & 3;
                    continue;
                }
                if (mode == 0) {
                    if (!in_header) on_base(CODE[(uint8_t)ch]);
                } else if (fq_phase == 1) {
                    on_base(CODE[(uint8_t)ch]);
                }
                continue;
            }
            if (ch == '\n') {
                at_line_start = true;
                if (mode == 1) fq_phase = (fq_phase + 1) & 3;
                else if (mode == 0 && in_header) in_header = false;
                continue;
            }
            if (mode == 0) {
                if (!in_header) on_base(CODE[(uint8_t)ch]);
            } else if (fq_phase == 1) {
                on_base(CODE[(uint8_t)ch]);
            }
        }
        (void)cur;
    }
    gzclose(f);
    on_break();
    return true;
}

// multi-line FASTA records: bases of one record may span lines; a record
// break resets the rolling k-mer window. For FASTA we emit on_break only at
// '>' lines (record start), which is correct; line breaks inside a record do
// NOT reset the window, so the base stream of a record is contiguous.

struct RollingKmers {
    int k;
    uint64_t mask, fwd = 0, rc = 0;
    int run = 0;
    std::vector<uint64_t>* out;
    explicit RollingKmers(int k_, std::vector<uint64_t>* o) : k(k_), out(o) {
        mask = (1ULL << (2 * k)) - 1;
    }
    inline void reset() { run = 0; fwd = rc = 0; }
    inline void push(uint8_t c) {
        if (c >= 4) {
            reset();
            return;
        }
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | ((uint64_t)(3 - c) << (2 * (k - 1)));
        if (++run >= k) out->push_back(fwd < rc ? fwd : rc);
    }
};

// ---------------------------------------------------------------- ccdBG

struct KC {
    uint64_t kmer;
    uint32_t color;
};

struct CcdbgOut {
    uint8_t* unitig_codes;
    int64_t* unitig_offs;
    uint32_t* unitig_cs;
    uint32_t* cs_colors;
    int64_t* cs_offs;
    int64_t num_unitigs, num_color_sets, num_kmers, codes_len, cs_colors_len;
};

struct Graph {
    int k;
    std::vector<uint64_t> kmers;  // sorted distinct canonical
    std::vector<uint32_t> kset;   // intern id per kmer
    // open-addressing index over kmers (linear probing) — the walk makes
    // ~8 membership queries per kmer; binary search would dominate build
    std::vector<uint64_t> hkey;
    std::vector<uint32_t> hval;
    uint64_t hmask = 0;

    void build_hash() {
        uint64_t cap = 1;
        while (cap < kmers.size() * 8 / 5 + 1) cap <<= 1;
        hmask = cap - 1;
        hkey.assign(cap, ~0ULL);
        hval.assign(cap, UINT32_MAX);
        for (size_t i = 0; i < kmers.size(); ++i) {
            uint64_t h = kmers[i] * 0x9E3779B97F4A7C15ULL;
            uint64_t p = (h ^ (h >> 29)) & hmask;
            while (hval[p] != UINT32_MAX) p = (p + 1) & hmask;
            hkey[p] = kmers[i];
            hval[p] = (uint32_t)i;
        }
    }

    inline int64_t find(uint64_t x) const {
        uint64_t h = x * 0x9E3779B97F4A7C15ULL;
        uint64_t p = (h ^ (h >> 29)) & hmask;
        for (;;) {
            if (hval[p] == UINT32_MAX) return -1;
            if (hkey[p] == x) return hval[p];
            p = (p + 1) & hmask;
        }
    }
    inline uint64_t canon(uint64_t x) const {
        uint64_t r = revcomp(x, k);
        return x < r ? x : r;
    }
    // successors of oriented kmer x: fills idx[4], y[4]; returns count
    inline int succs(uint64_t x, int64_t* idx, uint64_t* ys) const {
        uint64_t mask = (1ULL << (2 * k)) - 1;
        uint64_t base = (x << 2) & mask;
        int cnt = 0;
        for (uint64_t c = 0; c < 4; ++c) {
            uint64_t y = base | c;
            int64_t i = find(canon(y));
            if (i >= 0) {
                idx[cnt] = i;
                ys[cnt] = y;
                ++cnt;
            }
        }
        return cnt;
    }
    inline int preds(uint64_t x, int64_t* idx, uint64_t* zs) const {
        uint64_t base = x >> 2;
        int hs = 2 * (k - 1);
        int cnt = 0;
        for (uint64_t c = 0; c < 4; ++c) {
            uint64_t z = base | (c << hs);
            int64_t i = find(canon(z));
            if (i >= 0) {
                idx[cnt] = i;
                zs[cnt] = z;
                ++cnt;
            }
        }
        return cnt;
    }
    inline bool is_start(int64_t idx, uint64_t x) const {
        int64_t pi[4];
        uint64_t pz[4];
        int np = preds(x, pi, pz);
        if (np != 1) return true;
        if (kset[pi[0]] != kset[idx]) return true;
        int64_t si[4];
        uint64_t sy[4];
        if (succs(pz[0], si, sy) != 1) return true;
        return false;
    }
};

// FNV-1a over bytes (build-time color-set interning only)
static inline uint64_t fnv64(const void* data, size_t n) {
    const uint8_t* p = (const uint8_t*)data;
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; ++i) {
        h ^= p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// paths: NUL-separated file list. Returns 0 on success.
// num_passes: RAM-bounding — pass t re-parses every file keeping only
// k-mers whose partition (top bits of a mixed hash-free split: we use the
// kmer's high bits so partitions are sorted-order-preserving) equals t.
// Peak pair memory divides by num_passes at the cost of re-parsing
// (parallel parse makes this cheap; see docs/DESIGN-NOTES.md §4).
extern "C" int fn_build_ccdbg_mp(const char* paths, int num_files, int k, int num_passes,
                                 CcdbgOut* out);

extern "C" int fn_build_ccdbg(const char* paths, int num_files, int k, CcdbgOut* out) {
    return fn_build_ccdbg_mp(paths, num_files, k, 1, out);
}

// disk-spill single-parse variant: parse every input ONCE, spilling each
// key partition's (kmer, color) stream to a temp file under `tmpdir`, then
// process partitions in ascending key order from disk (GGCAT's
// external-memory discipline, include/GGCAT.hpp:42-50 — for corpora where
// re-parsing is slower than the spill IO, e.g. 10^5 gz inputs).
static int build_ccdbg_core(const char* paths, int num_files, int k,
                            int num_passes, const char* tmpdir, CcdbgOut* out);

extern "C" int fn_build_ccdbg_spill(const char* paths, int num_files, int k,
                                    int num_passes, const char* tmpdir,
                                    CcdbgOut* out) {
    return build_ccdbg_core(paths, num_files, k, num_passes, tmpdir, out);
}

extern "C" int fn_build_ccdbg_mp(const char* paths, int num_files, int k, int num_passes,
                                 CcdbgOut* out) {
    return build_ccdbg_core(paths, num_files, k, num_passes, nullptr, out);
}

static int build_ccdbg_core(const char* paths, int num_files, int k, int num_passes,
                            const char* tmpdir, CcdbgOut* out) {
    if (k < 1 || k > 31 || (k % 2) == 0) return 2;
    if (num_passes < 1) num_passes = 1;
    // partition the keyspace into num_passes contiguous ranges (processed
    // ascending, so global sorted order is preserved). Boundaries are NOT
    // a uniform split: canonical k-mers are min(fwd, rc), whose CDF over a
    // uniform keyspace is 1-(1-x)^2 — a uniform split loads pass 0 with
    // ~2/P of ALL pairs (44% at P=4), which is exactly how a 125 GB host
    // got OOM-killed twice at "4 balanced passes". Equal-LOAD boundaries
    // invert the CDF: x_p = 1 - sqrt(1 - p/P). Only consistency matters
    // (every k-mer lands in exactly one range), so double precision is
    // fine.
    const uint64_t key_space_bits = 2 * (uint64_t)k;
    const uint64_t key_space_end = 1ULL << key_space_bits;
    auto pass_bound = [&](int p) -> uint64_t {
        if (p <= 0) return 0;
        if (p >= num_passes) return key_space_end;
        double f = (double)p / (double)num_passes;
        double x = 1.0 - std::sqrt(std::max(0.0, 1.0 - f));
        uint64_t b = (uint64_t)(x * (double)key_space_end);
        return b < key_space_end ? b : key_space_end;
    };
    Graph g;
    g.k = k;
    std::vector<uint32_t> colors_cat;  // interned color sets (appearance order)
    std::vector<int64_t> cs_offs{0};
    std::unordered_map<uint64_t, std::vector<uint32_t>> table;  // hash -> set ids

    std::vector<const char*> files(num_files);
    {
        const char* p = paths;
        for (int i = 0; i < num_files; ++i) {
            files[i] = p;
            p += strlen(p) + 1;
        }
    }

    if (num_passes == 1) tmpdir = nullptr;  // spill == in-memory at 1 pass
    std::vector<FILE*> spill;
    std::vector<std::string> spill_paths;
    if (tmpdir) {
        // single parse: spill each partition's per-genome sorted k-mer
        // slices as [color u32][n u64][n x kmer u64] records
        spill.assign(num_passes, nullptr);
        spill_paths.resize(num_passes);
        for (int p = 0; p < num_passes; ++p) {
            char buf[4096];
            snprintf(buf, sizeof buf, "%s/fulgor_spill_%d_%d.bin", tmpdir,
                     (int)getpid(), p);
            spill_paths[p] = buf;
            spill[p] = fopen(buf, "wb+");
            if (!spill[p]) {
                for (int q = 0; q < p; ++q) {
                    fclose(spill[q]);
                    remove(spill_paths[q].c_str());
                }
                return 3;
            }
        }
        std::vector<std::mutex> fmx(num_passes);
        std::atomic<int> next{0};
        std::atomic<bool> failed{false};
        int nthreads = (int)std::min<size_t>(
            {(size_t)num_files, host_threads(), 16});
        auto work = [&]() {
            for (;;) {
                int color = next.fetch_add(1);
                if (color >= num_files || failed.load()) return;
                std::vector<uint64_t> all;
                RollingKmers rk(k, &all);
                bool ok = stream_fastx(
                    files[color], [&](uint8_t c) { rk.push(c); }, [&]() { rk.reset(); });
                if (!ok) {
                    failed.store(true);
                    return;
                }
                std::sort(all.begin(), all.end());
                all.erase(std::unique(all.begin(), all.end()), all.end());
                size_t a = 0;
                for (int p = 0; p < num_passes && a < all.size(); ++p) {
                    uint64_t hi_key = pass_bound(p + 1);
                    size_t b = (size_t)(std::lower_bound(all.begin() + a, all.end(),
                                                         hi_key) -
                                        all.begin());
                    if (b > a) {
                        uint64_t n = (uint64_t)(b - a);
                        uint32_t col = (uint32_t)color;
                        std::lock_guard<std::mutex> lk(fmx[p]);
                        bool w = fwrite(&col, 4, 1, spill[p]) == 1 &&
                                 fwrite(&n, 8, 1, spill[p]) == 1 &&
                                 fwrite(all.data() + a, 8, n, spill[p]) == n;
                        if (!w) failed.store(true);
                    }
                    a = b;
                }
            }
        };
        std::vector<std::thread> ths;
        for (int t = 0; t < nthreads; ++t) ths.emplace_back(work);
        for (auto& t : ths) t.join();
        if (failed.load()) {
            for (int p = 0; p < num_passes; ++p) {
                fclose(spill[p]);
                remove(spill_paths[p].c_str());
            }
            return 1;
        }
    }

    for (int pass = 0; pass < num_passes; ++pass) {
        // key range [lo, hi) for this pass (equal-LOAD boundaries)
        uint64_t lo_key = pass_bound(pass);
        uint64_t hi_key = pass_bound(pass + 1);

        // pair storage: an UNINITIALIZED raw buffer (new[] on POD leaves
        // pages untouched until written) so peak RSS tracks actual fill,
        // not capacity. Sorting happens bucket-by-bucket IN PLACE — the
        // previous __gnu_parallel::sort allocated a full O(n) merge temp,
        // which (plus a zero-initializing resize) put the real peak near
        // 44 B/pair and OOM-killed a 125 GB host at 4 passes. Peak is now
        // ~16 B/pair plus the per-genome lists being drained.
        std::unique_ptr<KC[]> pbuf;
        size_t pn = 0;
        auto kc_less = [](const KC& a, const KC& b) {
            return a.kmer < b.kmer || (a.kmer == b.kmer && a.color < b.color);
        };
        if (tmpdir) {
            // drain this partition's spill file. Records are per-genome
            // SORTED kmer slices, so the partition assembles with the same
            // bucketed in-place strategy as the re-parse path: pass A
            // streams the file once to count each record's contribution to
            // NB value sub-ranges, pass B streams again copying slices into
            // disjoint bucket regions, then buckets sort independently in
            // place. Peak RSS = the pair buffer alone — the previous
            // __gnu_parallel::sort here allocated an O(n) merge temp (a
            // second ~45 GB for a 22.7 GB partition file), which OOM-killed
            // a 125 GB host mid-drain.
            FILE* f = spill[pass];
            fflush(f);
            const int NB = 128;
            const uint64_t range = hi_key - lo_key;
            std::vector<uint64_t> bval(NB + 1);
            for (int b = 0; b <= NB; ++b)
                bval[b] = lo_key + (uint64_t)(((__uint128_t)range * (unsigned)b) / NB);
            std::vector<size_t> bcount(NB, 0);
            std::vector<uint64_t> tmp;
            uint32_t col;
            uint64_t n;
            rewind(f);
            while (fread(&col, 4, 1, f) == 1) {  // pass A: bucket counts
                if (fread(&n, 8, 1, f) != 1) break;
                tmp.resize(n);
                if (fread(tmp.data(), 8, n, f) != n) break;
                size_t a = 0;
                for (int b = 0; b < NB && a < tmp.size(); ++b) {
                    size_t e = (size_t)(std::lower_bound(tmp.begin() + a,
                                                         tmp.end(), bval[b + 1]) -
                                        tmp.begin());
                    bcount[b] += e - a;
                    a = e;
                }
                pn += n;
            }
            pbuf.reset(new KC[pn ? pn : 1]);
            std::vector<size_t> wcur(NB + 1, 0);
            for (int b = 0; b < NB; ++b) wcur[b + 1] = wcur[b] + bcount[b];
            std::vector<size_t> bbase(wcur.begin(), wcur.end());
            rewind(f);
            while (fread(&col, 4, 1, f) == 1) {  // pass B: bucketed copy
                if (fread(&n, 8, 1, f) != 1) break;
                tmp.resize(n);
                if (fread(tmp.data(), 8, n, f) != n) break;
                size_t a = 0;
                for (int b = 0; b < NB && a < tmp.size(); ++b) {
                    size_t e = (size_t)(std::lower_bound(tmp.begin() + a,
                                                         tmp.end(), bval[b + 1]) -
                                        tmp.begin());
                    size_t dst = wcur[b];
                    for (size_t i = a; i < e; ++i)
                        pbuf[dst + (i - a)] = {tmp[i], col};
                    wcur[b] = dst + (e - a);
                    a = e;
                }
            }
            fclose(f);
            remove(spill_paths[pass].c_str());
            spill[pass] = nullptr;
            tmp.clear();
            tmp.shrink_to_fit();
            {
                std::atomic<int> bnext{0};
                auto swork = [&]() {
                    for (;;) {
                        int b = bnext.fetch_add(1);
                        if (b >= NB) return;
                        std::sort(pbuf.get() + bbase[b],
                                  pbuf.get() + bbase[b + 1], kc_less);
                    }
                };
                std::vector<std::thread> st;
                for (unsigned t = 0; t < host_threads(); ++t)
                    st.emplace_back(swork);
                for (auto& t : st) t.join();
            }
        } else if (lo_key >= hi_key) {
            continue;
        } else {
            std::vector<std::vector<uint64_t>> per_genome(num_files);
            std::atomic<int> next{0};
            std::atomic<bool> failed{false};
            int nthreads = (int)std::min<size_t>(
                {(size_t)num_files, host_threads(), 16});
            auto work = [&]() {
                for (;;) {
                    int color = next.fetch_add(1);
                    if (color >= num_files || failed.load()) return;
                    auto& gk = per_genome[color];
                    std::vector<uint64_t> all;
                    RollingKmers rk(k, &all);
                    bool ok = stream_fastx(
                        files[color], [&](uint8_t c) { rk.push(c); }, [&]() { rk.reset(); });
                    if (!ok) {
                        failed.store(true);
                        return;
                    }
                    for (uint64_t x : all)
                        if (x >= lo_key && x < hi_key) gk.push_back(x);
                    all.clear();
                    all.shrink_to_fit();
                    std::sort(gk.begin(), gk.end());
                    gk.erase(std::unique(gk.begin(), gk.end()), gk.end());
                }
            };
            std::vector<std::thread> ths;
            for (int t = 0; t < nthreads; ++t) ths.emplace_back(work);
            for (auto& t : ths) t.join();
            if (failed.load()) return 1;
            size_t total = 0;
            for (auto& gg : per_genome) total += gg.size();
            // bucketed in-place assembly: split [lo_key, hi_key) into NB
            // value sub-ranges; each sorted per-genome list contributes one
            // contiguous slice per bucket (boundaries by binary search), so
            // every (genome, bucket) copy target is disjoint and the copy
            // parallelizes with no synchronization. Buckets then sort
            // independently in place.
            const int NB = 128;
            const uint64_t range = hi_key - lo_key;
            std::vector<uint64_t> bval(NB + 1);
            for (int b = 0; b <= NB; ++b)
                bval[b] = lo_key + (uint64_t)(((__uint128_t)range * (unsigned)b) / NB);
            std::vector<size_t> gb((size_t)num_files * (NB + 1));
            {
                std::atomic<int> gnext{0};
                auto bwork = [&]() {
                    for (;;) {
                        int gi = gnext.fetch_add(1);
                        if (gi >= num_files) return;
                        auto& gk = per_genome[gi];
                        size_t* row = &gb[(size_t)gi * (NB + 1)];
                        for (int b = 0; b <= NB; ++b)
                            row[b] = (size_t)(std::lower_bound(gk.begin(), gk.end(),
                                                               bval[b]) -
                                              gk.begin());
                    }
                };
                std::vector<std::thread> bt;
                for (unsigned t = 0; t < host_threads(); ++t) bt.emplace_back(bwork);
                for (auto& t : bt) t.join();
            }
            // write offsets: buckets laid out ascending, genomes ascending
            // within a bucket (kc_less ordering needs only the final sort)
            std::vector<size_t> bbase(NB + 1, 0);
            for (int b = 0; b < NB; ++b) {
                size_t tot = 0;
                for (int gi = 0; gi < num_files; ++gi) {
                    size_t* row = &gb[(size_t)gi * (NB + 1)];
                    size_t cnt = row[b + 1] - row[b];
                    // repurpose row[b] as this genome's write offset
                    size_t src_lo = row[b];
                    row[b] = bbase[b] + tot;  // absolute write position
                    tot += cnt;
                    (void)src_lo;
                }
                bbase[b + 1] = bbase[b] + tot;
            }
            // gb[g][b] now holds write positions; source slice boundaries
            // are recoverable as prefix sums of counts — keep a second
            // array of source starts instead (simpler than in-place reuse)
            // NOTE: row[b] was overwritten above; recompute source starts
            // from scratch per genome during the copy (cheap binary search).
            pbuf.reset(new KC[total]);
            pn = total;
            {
                std::atomic<int> gnext{0};
                auto cwork = [&]() {
                    for (;;) {
                        int gi = gnext.fetch_add(1);
                        if (gi >= num_files) return;
                        auto& gk = per_genome[gi];
                        size_t* row = &gb[(size_t)gi * (NB + 1)];
                        size_t src = 0;
                        for (int b = 0; b < NB; ++b) {
                            size_t src_hi = (size_t)(std::lower_bound(
                                                         gk.begin() + src, gk.end(),
                                                         bval[b + 1]) -
                                                     gk.begin());
                            size_t dst = row[b];
                            for (size_t i = src; i < src_hi; ++i)
                                pbuf[dst + (i - src)] = {gk[i], (uint32_t)gi};
                            src = src_hi;
                        }
                        gk.clear();
                        gk.shrink_to_fit();
                    }
                };
                std::vector<std::thread> ct;
                for (unsigned t = 0; t < host_threads(); ++t) ct.emplace_back(cwork);
                for (auto& t : ct) t.join();
            }
            {
                std::atomic<int> bnext{0};
                auto swork = [&]() {
                    for (;;) {
                        int b = bnext.fetch_add(1);
                        if (b >= NB) return;
                        std::sort(pbuf.get() + bbase[b], pbuf.get() + bbase[b + 1],
                                  kc_less);
                    }
                };
                std::vector<std::thread> st;
                for (unsigned t = 0; t < host_threads(); ++t) st.emplace_back(swork);
                for (auto& t : st) t.join();
            }
        }
        KC* const pairs = pbuf.get();

        // intern this pass's kmers (appends in globally sorted order).
        // Phase 1 (parallel): chunk the pair stream at kmer boundaries and
        // collapse each chunk to (kmer, color-list slice, content hash).
        // Phase 2 (sequential, cheap): global set-id dedup over the hashes
        // — only hash lookups plus memcmp on candidates; the per-pair
        // copying happens in phase 1 (reference pipelines its encoding the
        // same way, include/builders/builder.hpp:74-153).
        {
            size_t n = pn;
            int nthreads = (int)std::min<unsigned>(
                host_threads(), 16);
            std::vector<size_t> bounds(nthreads + 1, n);
            bounds[0] = 0;
            for (int t = 1; t < nthreads; ++t) {
                size_t e = n * (size_t)t / nthreads;
                while (e < n && e > 0 && pairs[e].kmer == pairs[e - 1].kmer) ++e;
                bounds[t] = e;
            }
            // colors are read strided out of `pairs` via (start, size) —
            // the earlier contiguous `cat` copy cost another 4 B/pair of
            // peak while pairs were still alive
            struct Chunk {
                std::vector<uint64_t> kmers;
                std::vector<size_t> starts;
                std::vector<uint32_t> sizes;
                std::vector<uint64_t> hashes;
            };
            std::vector<Chunk> chunks(nthreads);
            std::vector<std::thread> ths;
            for (int t = 0; t < nthreads; ++t) {
                ths.emplace_back([&, t]() {
                    Chunk& ck = chunks[t];
                    size_t i = bounds[t], e = bounds[t + 1];
                    std::vector<uint32_t> scratch;
                    while (i < e) {
                        size_t j = i + 1;
                        while (j < e && pairs[j].kmer == pairs[i].kmer) ++j;
                        ck.kmers.push_back(pairs[i].kmer);
                        scratch.resize(j - i);
                        for (size_t q = i; q < j; ++q) scratch[q - i] = pairs[q].color;
                        ck.starts.push_back(i);
                        ck.sizes.push_back((uint32_t)(j - i));
                        ck.hashes.push_back(fnv64(scratch.data(), (j - i) * 4));
                        i = j;
                    }
                });
            }
            for (auto& t : ths) t.join();
            std::vector<uint32_t> scratch;
            for (int t = 0; t < nthreads; ++t) {
                Chunk& ck = chunks[t];
                for (size_t r = 0; r < ck.kmers.size(); ++r) {
                    g.kmers.push_back(ck.kmers[r]);
                    uint32_t sz = ck.sizes[r];
                    size_t st = ck.starts[r];
                    scratch.resize(sz);
                    for (uint32_t q = 0; q < sz; ++q) scratch[q] = pairs[st + q].color;
                    const uint32_t* content = scratch.data();
                    auto& cand = table[ck.hashes[r]];
                    uint32_t sid = UINT32_MAX;
                    for (uint32_t c : cand) {
                        int64_t csz = cs_offs[c + 1] - cs_offs[c];
                        if ((size_t)csz == sz &&
                            memcmp(&colors_cat[cs_offs[c]], content, (size_t)sz * 4) == 0) {
                            sid = c;
                            break;
                        }
                    }
                    if (sid == UINT32_MAX) {
                        sid = (uint32_t)(cs_offs.size() - 1);
                        colors_cat.insert(colors_cat.end(), content, content + sz);
                        cs_offs.push_back((int64_t)colors_cat.size());
                        cand.push_back(sid);
                    }
                    g.kset.push_back(sid);
                }
            }
        }
    }
    table.clear();

    g.build_hash();
    const int64_t nk = (int64_t)g.kmers.size();
    // parallel start classification (read-only on the graph)
    std::vector<uint8_t> start_orient(nk, 0);  // bit0 = fwd start, bit1 = rc start
    {
        int nthreads = (int)std::min<unsigned>(
            host_threads(), 16);
        std::vector<std::thread> ths;
        int64_t step = (nk + nthreads - 1) / nthreads;
        for (int t = 0; t < nthreads; ++t) {
            int64_t lo = t * step, hi = std::min(nk, lo + step);
            ths.emplace_back([&, lo, hi]() {
                for (int64_t idx = lo; idx < hi; ++idx) {
                    uint64_t x0 = g.kmers[idx];
                    uint8_t so = 0;  // bit0 = fwd start, bit1 = rc start
                    if (g.is_start(idx, x0)) so |= 1;
                    if (g.is_start(idx, revcomp(x0, k))) so |= 2;
                    start_orient[idx] = so;
                }
            });
        }
        for (auto& t : ths) t.join();
    }
    // Sequential unitig walk (deterministic: ascending canonical k-mer,
    // forward orientation preferred). A claim-free parallel walk was tried
    // and reverted: inverted repeats (hairpins) make chain extents depend
    // on the `visited` stop, so only a fixed claim order is reproducible.
    // The walk is ~20% of ccdBG time; parsing, sorting, interning and
    // start classification above are the parallel stages.
    std::vector<uint8_t> visited(nk, 0);

    struct Uni {
        uint64_t min_kmer;
        int64_t code_off, code_len;
        uint32_t set;
    };
    std::vector<Uni> unis;
    std::vector<uint8_t> codes;
    codes.reserve((size_t)nk + 1024);

    auto walk_emit = [&](int64_t idx, int o) {
        uint64_t x = g.kmers[idx];
        if (o) x = revcomp(x, k);
        int64_t off = (int64_t)codes.size();
        for (int i = 0; i < k; ++i) codes.push_back((uint8_t)((x >> (2 * (k - 1 - i))) & 3));
        uint64_t mink = g.kmers[idx];
        visited[idx] = 1;
        uint32_t set = g.kset[idx];
        for (;;) {
            int64_t si[4];
            uint64_t sy[4];
            if (g.succs(x, si, sy) != 1) break;
            int64_t yi = si[0];
            uint64_t y = sy[0];
            if (g.kset[yi] != set) break;
            int64_t pi[4];
            uint64_t pz[4];
            if (g.preds(y, pi, pz) != 1) break;
            if (visited[yi]) break;
            codes.push_back((uint8_t)(y & 3));
            visited[yi] = 1;
            if (g.kmers[yi] < mink) mink = g.kmers[yi];
            x = y;
        }
        unis.push_back({mink, off, (int64_t)codes.size() - off, set});
    };

    for (int64_t idx = 0; idx < nk; ++idx) {
        if (visited[idx] || start_orient[idx] == 0) continue;
        walk_emit(idx, (start_orient[idx] & 1) ? 0 : 1);
    }
    for (int64_t idx = 0; idx < nk; ++idx)
        if (!visited[idx]) walk_emit(idx, 0);  // pure cycles

    // deterministic order: ascending min kmer
    std::vector<int64_t> order(unis.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int64_t)i;
    std::sort(order.begin(), order.end(),
              [&](int64_t a, int64_t b) { return unis[a].min_kmer < unis[b].min_kmer; });

    // re-intern color sets by first occurrence over that order
    int64_t nsets = cs_offs.size() - 1;
    std::vector<uint32_t> new_of_old(nsets, UINT32_MAX);
    std::vector<uint32_t> old_of_new;
    old_of_new.reserve(nsets);
    for (int64_t oi : order) {
        uint32_t s = unis[oi].set;
        if (new_of_old[s] == UINT32_MAX) {
            new_of_old[s] = (uint32_t)old_of_new.size();
            old_of_new.push_back(s);
        }
    }
    // group unitigs by new set id, stable within (= min-kmer order)
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return new_of_old[unis[a].set] < new_of_old[unis[b].set];
    });

    // ---- outputs ----
    int64_t nu = (int64_t)unis.size();
    out->num_unitigs = nu;
    out->num_color_sets = (int64_t)old_of_new.size();
    out->unitig_offs = (int64_t*)malloc((nu + 1) * sizeof(int64_t));
    out->unitig_cs = (uint32_t*)malloc(nu * sizeof(uint32_t));
    int64_t total = 0;
    for (int64_t i = 0; i < nu; ++i) total += unis[order[i]].code_len;
    out->codes_len = total;
    out->unitig_codes = (uint8_t*)malloc((size_t)total);
    int64_t pos = 0, nkm = 0;
    out->unitig_offs[0] = 0;
    for (int64_t i = 0; i < nu; ++i) {
        const Uni& u = unis[order[i]];
        memcpy(out->unitig_codes + pos, codes.data() + u.code_off, (size_t)u.code_len);
        pos += u.code_len;
        out->unitig_offs[i + 1] = pos;
        out->unitig_cs[i] = new_of_old[u.set];
        nkm += u.code_len - (k - 1);
    }
    out->num_kmers = nkm;
    out->cs_offs = (int64_t*)malloc((old_of_new.size() + 1) * sizeof(int64_t));
    int64_t clen = 0;
    out->cs_offs[0] = 0;
    for (size_t i = 0; i < old_of_new.size(); ++i) {
        uint32_t o = old_of_new[i];
        clen += cs_offs[o + 1] - cs_offs[o];
        out->cs_offs[i + 1] = clen;
    }
    out->cs_colors_len = clen;
    out->cs_colors = (uint32_t*)malloc((size_t)clen * 4);
    for (size_t i = 0; i < old_of_new.size(); ++i) {
        uint32_t o = old_of_new[i];
        memcpy(out->cs_colors + out->cs_offs[i], &colors_cat[cs_offs[o]],
               (size_t)(cs_offs[o + 1] - cs_offs[o]) * 4);
    }
    return 0;
}

// ---------------------------------------------------------------- cuckoo

// Quotient bucketed cuckoo dictionary (fulgor_tpu/ops/lookup.py must match).
//
// Keys are 62-bit canonical k-mers. Two INVERTIBLE 62-bit permutations
// pi1/pi2 (splitmix-style xorshift-multiply rounds, odd constants, masked
// to 62 bits) map a key to (bucket = top b bits, remainder = low 62-b
// bits); since the permutation is injective, (bucket, remainder, which-
// permutation) uniquely identifies the key — no full key storage, no false
// positives. Slot = u64: [0..b+1) value | [b+1..63) remainder | bit63
// which-hash. Empty slot: value field all-ones (value <= n-1 < 2^(b+1)-1
// by construction). Bucket row = 2 slots = 16 B — the TPU gathers 16 B
// rows ~1.6x faster than 24 B rows (docs/DESIGN-NOTES.md).

static const uint64_t P62_MASK = (1ULL << 62) - 1;
static const uint64_t PI1_C1 = 0x9E3779B97F4A7C15ULL, PI1_C2 = 0xBF58476D1CE4E5B9ULL;
static const uint64_t PI2_C1 = 0x94D049BB133111EBULL, PI2_C2 = 0xD6E8FEB86659FD93ULL;

static inline uint64_t pi62(uint64_t x, uint64_t c1, uint64_t c2) {
    x ^= x >> 31;
    x = (x * c1) & P62_MASK;
    x ^= x >> 29;
    x = (x * c2) & P62_MASK;
    x ^= x >> 31;
    return x;
}

struct QC {
    uint64_t* slots;  // 2 per bucket
    uint64_t nb;      // power of two
    int b;            // log2(nb)
    int val_bits;     // b + 1
    uint64_t val_mask, rem_mask;
};

static int qc_try(const uint64_t* keys, const uint32_t* vals, int64_t n, QC& t) {
    const uint64_t EMPTY = t.val_mask;  // which=0, rem=0, val=all-ones
    for (uint64_t i = 0; i < 2 * t.nb; ++i) t.slots[i] = EMPTY;
    uint64_t rng = 0x243F6A8885A308D3ULL;
    int rem_shift = t.val_bits;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t key = keys[i];
        uint64_t val = vals[i];
        int which = 0;
        int depth = 0;
        uint64_t p1 = pi62(key, PI1_C1, PI1_C2);
        uint64_t p2 = pi62(key, PI2_C1, PI2_C2);
        for (;;) {
            uint64_t pw = which ? p2 : p1;
            uint64_t bkt = pw >> (62 - t.b);
            uint64_t rem = pw & t.rem_mask;
            uint64_t slot_word =
                val | (rem << rem_shift) | ((uint64_t)which << 63);
            uint64_t* row = t.slots + 2 * bkt;
            bool placed = false;
            for (int s = 0; s < 2; ++s) {
                if ((row[s] & t.val_mask) == EMPTY) {
                    row[s] = slot_word;
                    placed = true;
                    break;
                }
            }
            if (placed) break;
            // also try the other hash's bucket before evicting
            uint64_t pw2 = which ? p1 : p2;
            uint64_t bkt2 = pw2 >> (62 - t.b);
            uint64_t rem2 = pw2 & t.rem_mask;
            uint64_t* row2 = t.slots + 2 * bkt2;
            uint64_t slot_word2 =
                val | (rem2 << rem_shift) | ((uint64_t)(1 - which) << 63);
            for (int s = 0; s < 2; ++s) {
                if ((row2[s] & t.val_mask) == EMPTY) {
                    row2[s] = slot_word2;
                    placed = true;
                    break;
                }
            }
            if (placed) break;
            if (++depth > 2000) return 1;
            // evict a pseudo-random victim from the primary bucket
            rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
            int s = (int)((rng >> 33) & 1);
            uint64_t victim = row[s];
            row[s] = slot_word;
            // reconstruct the victim's key from its (bucket, rem, which)
            uint64_t vwhich = victim >> 63;
            uint64_t vrem = (victim >> rem_shift) & t.rem_mask;
            uint64_t vval = victim & t.val_mask;
            uint64_t vperm = (bkt << (62 - t.b)) | vrem;
            // invert pi62
            uint64_t x = vperm;
            x ^= x >> 31;  // inverse of x ^= x>>31 (62-bit: s*2 > 62)
            // inverse multiply mod 2^62: multiply by modular inverse
            // (computed below via Newton iteration)
            uint64_t c2 = vwhich ? PI2_C2 : PI1_C2;
            uint64_t c1 = vwhich ? PI2_C1 : PI1_C1;
            auto inv62 = [](uint64_t c) {
                uint64_t inv = c;  // Newton: inv *= 2 - c*inv, 6 rounds
                for (int it = 0; it < 6; ++it) inv *= 2 - c * inv;
                return inv & P62_MASK;
            };
            x = (x * inv62(c2)) & P62_MASK;
            // inverse of x ^= x>>29 over 62 bits: apply twice+once (29*2=58<62,
            // 29*3 > 62): y = x ^ (x>>29) ^ (x>>58)
            x = x ^ (x >> 29) ^ (x >> 58);
            x = (x * inv62(c1)) & P62_MASK;
            x ^= x >> 31;
            uint64_t vkey = x;
            key = vkey;
            val = vval;
            which = (int)vwhich;  // retry with the SAME hash it was using ->
            which = 1 - which;    // move it to its alternate bucket
            p1 = pi62(key, PI1_C1, PI1_C2);
            p2 = pi62(key, PI2_C1, PI2_C2);
        }
    }
    return 0;
}

// out_table: malloc'd (nb * 4) u32 (viewed as (nb,4) little-endian rows =
// [s0_lo, s0_hi, s1_lo, s1_hi]); returns nb (power of two) or 0 on error.
extern "C" uint64_t fn_cuckoo_build(const uint64_t* keys, const uint32_t* vals, int64_t n,
                         uint32_t** out_table) {
    int b = 1;
    while ((2ULL << b) * 8 < (uint64_t)n * 10) ++b;  // 2*nb*0.8 >= n
    for (;;) {
        QC t;
        t.nb = 1ULL << b;
        t.b = b;
        t.val_bits = b + 1;
        t.val_mask = (1ULL << t.val_bits) - 1;
        t.rem_mask = (1ULL << (62 - b)) - 1;
        t.slots = (uint64_t*)malloc(2 * t.nb * 8);
        if (!t.slots) return 0;
        // sanity: values must fit
        bool fits = true;
        for (int64_t i = 0; i < n; ++i)
            if (vals[i] >= t.val_mask) { fits = false; break; }
        if (fits && qc_try(keys, vals, n, t) == 0) {
            *out_table = (uint32_t*)t.slots;
            return t.nb;
        }
        free(t.slots);
        ++b;
        if (b > 34) return 0;
    }
}

// ---------------------------------------------------------------- bit codecs

struct BitRd {
    const uint64_t* w;
    uint64_t pos;
    inline uint64_t bits(int n) {
        if (n == 0) return 0;
        uint64_t wi = pos >> 6;
        int sh = (int)(pos & 63);
        uint64_t v = w[wi] >> sh;
        int got = 64 - sh;
        if (got < n) v |= w[wi + 1] << got;
        pos += n;
        return n == 64 ? v : (v & ((1ULL << n) - 1));
    }
    inline int unary0() {
        int z = 0;
        for (;;) {
            uint64_t wi = pos >> 6;
            int sh = (int)(pos & 63);
            uint64_t chunk = w[wi] >> sh;
            int width = 64 - sh;
            if (chunk == 0) {
                z += width;
                pos += width;
                continue;
            }
            int tz = __builtin_ctzll(chunk);
            if (tz < width) {
                pos += tz + 1;
                return z + tz;
            }
            z += width;
            pos += width;
        }
    }
    inline uint64_t gamma() {
        int g = unary0();
        return bits(g) | (1ULL << g);
    }
    inline uint64_t delta() {
        int b = (int)gamma() - 1;
        return (bits(b) | (1ULL << b)) - 1;
    }
};

// Decode all hybrid color sets. Layout must match core/hybrid.py.
// outputs: cat (uint32), offs (int64, n_sets+1)
extern "C" int fn_hybrid_decode_all(const uint64_t* words, const uint64_t* bit_offsets,
                         int64_t n_sets, uint32_t num_colors, uint32_t** out_cat,
                         int64_t** out_offs, int64_t* out_len) {
    uint32_t sparse_thr = (uint32_t)(0.25 * num_colors);
    uint32_t dense_thr = (uint32_t)(0.75 * num_colors);
    int64_t* offs = (int64_t*)malloc((n_sets + 1) * sizeof(int64_t));
    if (!offs) return 1;
    offs[0] = 0;
    // pass 1: sizes only (each set's leading delta), then prefix-sum; lets
    // pass 2 decode every set in parallel straight into its output slice
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n_sets; ++i) {
        BitRd r{words, bit_offsets[i]};
        offs[i + 1] = (int64_t)r.delta();
    }
    for (int64_t i = 0; i < n_sets; ++i) offs[i + 1] += offs[i];
    int64_t total = offs[n_sets];
    uint32_t* catp = (uint32_t*)malloc((size_t)total * 4 + 4);
    if (!catp) { free(offs); return 1; }
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint8_t> member(num_colors);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 512)
#endif
        for (int64_t i = 0; i < n_sets; ++i) {
            BitRd r{words, bit_offsets[i]};
            uint64_t size = r.delta();
            uint32_t* p = catp + offs[i];
            if (size < sparse_thr) {
                uint32_t prev = 0;
                for (uint64_t j = 0; j < size; ++j) {
                    uint64_t d = r.delta();
                    prev = (j == 0) ? (uint32_t)d : prev + 1 + (uint32_t)d;
                    *p++ = prev;
                }
            } else if (size < dense_thr) {
                // bitmap: num_colors bits LSB-first from r.pos
                for (uint32_t c = 0; c < num_colors; c += 64) {
                    int nb = (int)std::min<uint32_t>(64, num_colors - c);
                    uint64_t wbits = r.bits(nb);
                    while (wbits) {
                        int t = __builtin_ctzll(wbits);
                        *p++ = c + t;
                        wbits &= wbits - 1;
                    }
                }
            } else {
                uint64_t comp_size = num_colors - size;
                memset(member.data(), 1, num_colors);
                uint32_t prev = 0;
                for (uint64_t j = 0; j < comp_size; ++j) {
                    uint64_t d = r.delta();
                    prev = (j == 0) ? (uint32_t)d : prev + 1 + (uint32_t)d;
                    member[prev] = 0;
                }
                for (uint32_t c = 0; c < num_colors; ++c)
                    if (member[c]) *p++ = c;
            }
        }
    }
    *out_len = total;
    *out_cat = catp;
    *out_offs = offs;
    return 0;
}

// ---------------------------------------------------------------- fastx reads
// Parse a FASTA/FASTQ(.gz) reads file into fixed-width padded code rows for
// the device: row-major (num_reads, max_len) uint8 codes (4 = pad/invalid),
// plus lengths and concatenated names.
extern "C" int fn_parse_reads(const char* path, int64_t max_reads, uint8_t** out_codes,
                   int32_t** out_lens, char** out_names, int64_t** out_name_offs,
                   int64_t* out_num, int32_t* out_maxlen) {
    gzFile f = gzopen(path, "rb");
    if (!f) return 1;
    gzbuffer(f, 1 << 20);
    std::vector<std::vector<uint8_t>> seqs;
    std::vector<std::string> names;
    std::string line;
    line.reserve(1 << 16);
    int mode = -1;  // 0 fasta 1 fastq
    int fq_phase = 0;
    std::vector<char> buf(1 << 20);
    std::string pending;
    auto handle_line = [&](const std::string& ln) {
        if (mode == -1) {
            if (ln.empty()) return;
            mode = (ln[0] == '@') ? 1 : 0;
        }
        if (mode == 1) {
            switch (fq_phase) {
                case 0: {
                    size_t b = ln.empty() ? std::string::npos : ln.find_first_not_of(" \t", 1);
                    if (b == std::string::npos) b = ln.size();
                    size_t sp = ln.find_first_of(" \t", b);
                    names.push_back(
                        ln.substr(b, sp == std::string::npos ? ln.size() - b : sp - b));
                    break;
                }
                case 1: {
                    seqs.emplace_back();
                    auto& s = seqs.back();
                    for (char ch : ln) s.push_back(CODE[(uint8_t)ch]);
                    break;
                }
                default:
                    break;
            }
            fq_phase = (fq_phase + 1) & 3;
            return;
        }
        if (ln.empty()) return;
        if (mode == 0) {
            if (ln[0] == '>') {
                size_t b = ln.find_first_not_of(" \t", 1);  // skip "> " style headers
                if (b == std::string::npos) b = ln.size();
                size_t sp = ln.find_first_of(" \t", b);
                names.push_back(ln.substr(b, sp == std::string::npos ? ln.size() - b : sp - b));
                seqs.emplace_back();
            } else if (!seqs.empty()) {
                auto& s = seqs.back();
                for (char ch : ln) s.push_back(CODE[(uint8_t)ch]);
            }
        }
    };
    for (;;) {
        int n = gzread(f, buf.data(), (unsigned)buf.size());
        if (n < 0) {
            gzclose(f);
            return 1;
        }
        if (n == 0) break;
        int start = 0;
        for (int i = 0; i < n; ++i) {
            if (buf[i] == '\n') {
                pending.append(buf.data() + start, i - start);
                if (!pending.empty() && pending.back() == '\r') pending.pop_back();
                handle_line(pending);
                pending.clear();
                start = i + 1;
                if (max_reads > 0 && (int64_t)seqs.size() >= max_reads) {
                    n = 0;
                    break;
                }
            }
        }
        if (n == 0) break;
        pending.append(buf.data() + start, n - start);
    }
    if (!pending.empty()) handle_line(pending);
    gzclose(f);

    int64_t num = (int64_t)seqs.size();
    int32_t maxlen = 0;
    for (auto& s : seqs) maxlen = std::max<int32_t>(maxlen, (int32_t)s.size());
    uint8_t* codes = (uint8_t*)malloc((size_t)num * maxlen + 1);
    memset(codes, 4, (size_t)num * maxlen + 1);
    int32_t* lens = (int32_t*)malloc(num * sizeof(int32_t) + 4);
    size_t name_bytes = 0;
    for (auto& nmm : names) name_bytes += nmm.size();
    char* nameblob = (char*)malloc(name_bytes + 1);
    int64_t* noffs = (int64_t*)malloc((num + 1) * sizeof(int64_t));
    size_t np = 0;
    noffs[0] = 0;
    for (int64_t i = 0; i < num; ++i) {
        memcpy(codes + (size_t)i * maxlen, seqs[i].data(), seqs[i].size());
        lens[i] = (int32_t)seqs[i].size();
        const std::string& nm = (i < (int64_t)names.size()) ? names[i] : std::string();
        memcpy(nameblob + np, nm.data(), nm.size());
        np += nm.size();
        noffs[i + 1] = (int64_t)np;
    }
    *out_codes = codes;
    *out_lens = lens;
    *out_names = nameblob;
    *out_name_offs = noffs;
    *out_num = num;
    *out_maxlen = maxlen;
    return 0;
}


// ---------------------------------------------------------------- formatting

// ascii pseudoalignment lines: "qid\tn[\tc1\tc2...]\n" (reference
// psa_ascii_formatter, src/ps_utils.cpp:48-83). Returns malloc'd buffer.
extern "C" int fn_format_psa_ascii(const uint32_t* qids, const uint32_t* colors_cat,
                                   const int64_t* offs, int64_t n, char** out_buf,
                                   int64_t* out_len) {
    // fixed part per line is "qid\tcount\n": up to 10+1+10+1 = 22 bytes
    // (qid and count are u32); each color adds "\tc" <= 11 bytes.
    size_t cap = (size_t)(n * 24 + (offs[n] - offs[0]) * 11 + 1024);
    char* buf = (char*)malloc(cap);
    if (!buf) return 1;
    char* p = buf;
    char tmp[16];
    auto put_u32 = [&](uint32_t v) {
        int len = 0;
        do {
            tmp[len++] = (char)('0' + v % 10);
            v /= 10;
        } while (v);
        while (len) *p++ = tmp[--len];
    };
    for (int64_t i = 0; i < n; ++i) {
        put_u32(qids[i]);
        *p++ = '\t';
        int64_t lo = offs[i], hi = offs[i + 1];
        put_u32((uint32_t)(hi - lo));
        for (int64_t j = lo; j < hi; ++j) {
            *p++ = '\t';
            put_u32(colors_cat[j]);
        }
        *p++ = '\n';
    }
    assert((size_t)(p - buf) <= cap);
    *out_buf = buf;
    *out_len = (int64_t)(p - buf);
    return 0;
}

// ---------------------------------------------------------------- streaming reads

// Stateful chunked FASTA/FASTQ reader so parsing overlaps device compute.
struct ReadsStream {
    gzFile f = nullptr;
    int mode = -1;  // 0 fasta, 1 fastq
    int fq_phase = 0;
    std::string pending;
    std::vector<char> buf;
    bool eof = false;
    std::vector<uint8_t> cur_seq;
    std::string cur_name;
    bool have_record = false;  // fasta: a record is open
    // completed records waiting to be handed out
    struct Rec {
        std::vector<uint8_t> seq;
        std::string name;
    };
    std::vector<Rec> ready;
    size_t ready_pos = 0;
};

extern "C" void* fn_reads_open(const char* path) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);
    ReadsStream* rs = new ReadsStream();
    rs->f = f;
    rs->buf.resize(1 << 20);
    return rs;
}

extern "C" void fn_reads_close(void* h) {
    ReadsStream* rs = (ReadsStream*)h;
    if (rs->f) gzclose(rs->f);
    delete rs;
}

static void rs_handle_line(ReadsStream* rs, const std::string& ln) {
    if (rs->mode == -1) {
        if (ln.empty()) return;  // leading blank lines
        rs->mode = (ln[0] == '@') ? 1 : 0;
    }
    auto finish = [&]() {
        rs->ready.push_back({std::move(rs->cur_seq), std::move(rs->cur_name)});
        rs->cur_seq = {};
        rs->cur_name = {};
    };
    if (rs->mode == 1) {
        // fastq: every line (even empty) advances the 4-phase cycle
        switch (rs->fq_phase) {
            case 0: {
                size_t b = ln.empty() ? std::string::npos : ln.find_first_not_of(" \t", 1);
                if (b == std::string::npos) b = ln.size();
                size_t sp = ln.find_first_of(" \t", b);
                rs->cur_name = ln.substr(b, sp == std::string::npos ? ln.size() - b : sp - b);
                break;
            }
            case 1:
                for (char ch : ln) rs->cur_seq.push_back(CODE[(uint8_t)ch]);
                break;
            case 3:
                finish();
                break;
            default:
                break;
        }
        rs->fq_phase = (rs->fq_phase + 1) & 3;
        return;
    }
    if (ln.empty()) return;  // fasta: blank lines are ignorable
    if (rs->mode == 0) {
        if (ln[0] == '>') {
            if (rs->have_record) finish();
            rs->have_record = true;
            size_t b = ln.find_first_not_of(" \t", 1);
            if (b == std::string::npos) b = ln.size();
            size_t sp = ln.find_first_of(" \t", b);
            rs->cur_name = ln.substr(b, sp == std::string::npos ? ln.size() - b : sp - b);
        } else if (rs->have_record) {
            for (char ch : ln) rs->cur_seq.push_back(CODE[(uint8_t)ch]);
        }
    }
}

// Fill up to max_reads rows (fixed width row_len, padded with code 4;
// out_lens reports TRUE lengths — callers route rows with len > row_len to
// a slow path). Returns reads produced; sets *done=1 once fully drained.
// Names never truncate: if the next read's name would overflow names_cap the
// chunk ends early (that read stays queued); if even the FIRST name exceeds
// names_cap, returns -(needed bytes) so the caller can grow the buffer and
// retry.
extern "C" int64_t fn_reads_next(void* h, int64_t max_reads, int32_t row_len,
                                 uint8_t* out_codes, int32_t* out_lens,
                                 char* out_names, int64_t names_cap,
                                 int64_t* out_name_offs, int* done) {
    ReadsStream* rs = (ReadsStream*)h;
    *done = 0;
    // parse until enough records are ready or input is exhausted
    while ((int64_t)(rs->ready.size() - rs->ready_pos) < max_reads && !rs->eof) {
        int n = gzread(rs->f, rs->buf.data(), (unsigned)rs->buf.size());
        if (n <= 0) {
            rs->eof = true;
            if (!rs->pending.empty()) {
                std::string line;
                line.swap(rs->pending);
                if (!line.empty() && line.back() == '\r') line.pop_back();
                rs_handle_line(rs, line);
            }
            if (rs->mode == 0 && rs->have_record) {
                rs->ready.push_back({std::move(rs->cur_seq), std::move(rs->cur_name)});
                rs->have_record = false;
            }
            break;
        }
        int start = 0;
        for (int i = 0; i < n; ++i) {
            if (rs->buf[i] == '\n') {
                rs->pending.append(rs->buf.data() + start, i - start);
                if (!rs->pending.empty() && rs->pending.back() == '\r') rs->pending.pop_back();
                std::string line;
                line.swap(rs->pending);
                rs_handle_line(rs, line);
                start = i + 1;
            }
        }
        rs->pending.append(rs->buf.data() + start, n - start);
    }
    int64_t avail = (int64_t)(rs->ready.size() - rs->ready_pos);
    int64_t take = std::min(avail, max_reads);
    if (take > 0 && rs->ready[rs->ready_pos].name.size() > (size_t)names_cap)
        return -(int64_t)rs->ready[rs->ready_pos].name.size();
    memset(out_codes, 4, (size_t)max_reads * row_len);
    size_t name_pos = 0;
    out_name_offs[0] = 0;
    int64_t taken = 0;
    for (int64_t i = 0; i < take; ++i) {
        auto& r = rs->ready[rs->ready_pos + i];
        size_t nl = r.name.size();
        if (name_pos + nl > (size_t)names_cap) break;  // end chunk early
        int32_t len = (int32_t)r.seq.size();
        memcpy(out_codes + i * row_len, r.seq.data(),
               (size_t)std::min<int64_t>(len, row_len));
        out_lens[i] = len;
        memcpy(out_names + name_pos, r.name.data(), nl);
        name_pos += nl;
        out_name_offs[i + 1] = (int64_t)name_pos;
        ++taken;
    }
    take = taken;
    rs->ready_pos += take;
    if (rs->ready_pos == rs->ready.size()) {
        rs->ready.clear();
        rs->ready_pos = 0;
        if (rs->eof) *done = 1;
    }
    return take;
}

// Stream the reads file once and materialize ONLY the reads whose 0-based
// ids are in `ids` (sorted ascending), as ragged buffers. Used for the
// long-read fallback so a handful of stragglers never forces a dense
// (num_reads x max_len) allocation of the whole file.
extern "C" int fn_reads_select(const char* path, const int64_t* ids, int64_t n_ids,
                               uint8_t** out_seq, int64_t** out_seq_offs,
                               char** out_names, int64_t** out_name_offs) {
    void* h = fn_reads_open(path);
    if (!h) return 1;
    ReadsStream* rs = (ReadsStream*)h;
    std::vector<uint8_t> seqblob;
    std::string nameblob;
    int64_t* soffs = (int64_t*)malloc((n_ids + 1) * 8);
    int64_t* noffs = (int64_t*)malloc((n_ids + 1) * 8);
    soffs[0] = noffs[0] = 0;
    int64_t qid = 0, next = 0;
    while (next < n_ids) {
        // parse more records if the queue is drained
        if (rs->ready_pos == rs->ready.size()) {
            rs->ready.clear();
            rs->ready_pos = 0;
            if (rs->eof) break;
            int n = gzread(rs->f, rs->buf.data(), (unsigned)rs->buf.size());
            if (n <= 0) {
                rs->eof = true;
                if (!rs->pending.empty()) {
                    std::string line;
                    line.swap(rs->pending);
                    if (!line.empty() && line.back() == '\r') line.pop_back();
                    rs_handle_line(rs, line);
                }
                if (rs->mode == 0 && rs->have_record) {
                    rs->ready.push_back({std::move(rs->cur_seq), std::move(rs->cur_name)});
                    rs->have_record = false;
                }
            } else {
                int start = 0;
                for (int i = 0; i < n; ++i) {
                    if (rs->buf[i] == '\n') {
                        rs->pending.append(rs->buf.data() + start, i - start);
                        if (!rs->pending.empty() && rs->pending.back() == '\r')
                            rs->pending.pop_back();
                        std::string line;
                        line.swap(rs->pending);
                        rs_handle_line(rs, line);
                        start = i + 1;
                    }
                }
                rs->pending.append(rs->buf.data() + start, n - start);
            }
            continue;
        }
        auto& r = rs->ready[rs->ready_pos++];
        if (qid == ids[next]) {
            seqblob.insert(seqblob.end(), r.seq.begin(), r.seq.end());
            nameblob.append(r.name);
            soffs[next + 1] = (int64_t)seqblob.size();
            noffs[next + 1] = (int64_t)nameblob.size();
            ++next;
        }
        ++qid;
    }
    fn_reads_close(h);
    if (next < n_ids) {  // requested id past end of file
        free(soffs);
        free(noffs);
        return 2;
    }
    uint8_t* sb = (uint8_t*)malloc(seqblob.size() + 1);
    memcpy(sb, seqblob.data(), seqblob.size());
    char* nb = (char*)malloc(nameblob.size() + 1);
    memcpy(nb, nameblob.data(), nameblob.size());
    *out_seq = sb;
    *out_seq_offs = soffs;
    *out_names = nb;
    *out_name_offs = noffs;
    return 0;
}

// ---------------------------------------------------------------- delta records

// Decode records of the form [delta(hdr_0)..delta(hdr_{H-1}) delta(n)
// delta(first) delta(gap-1)...] — the diff/meta-diff stream layout
// (core/colorstores.encode_delta_lists).
extern "C" int fn_delta_records_decode(const uint64_t* words, const uint64_t* bit_offs,
                                       int64_t n_recs, int num_headers,
                                       int64_t** out_headers, uint32_t** out_cat,
                                       int64_t** out_offs, int64_t* out_len) {
    int64_t* headers = (int64_t*)malloc(std::max<int64_t>(1, n_recs * num_headers) * 8);
    int64_t* offs = (int64_t*)malloc((n_recs + 1) * 8);
    std::vector<uint32_t> cat;
    offs[0] = 0;
    for (int64_t i = 0; i < n_recs; ++i) {
        BitRd r{words, bit_offs[i]};
        for (int j = 0; j < num_headers; ++j) headers[i * num_headers + j] = (int64_t)r.delta();
        uint64_t n = r.delta();
        uint32_t prev = 0;
        for (uint64_t t = 0; t < n; ++t) {
            uint64_t d = r.delta();
            prev = (t == 0) ? (uint32_t)d : prev + 1 + (uint32_t)d;
            cat.push_back(prev);
        }
        offs[i + 1] = (int64_t)cat.size();
    }
    uint32_t* catp = (uint32_t*)malloc(cat.size() * 4 + 4);
    memcpy(catp, cat.data(), cat.size() * 4);
    *out_headers = headers;
    *out_cat = catp;
    *out_offs = offs;
    *out_len = (int64_t)cat.size();
    return 0;
}

// kmer-conservation lines: "name\tn\t(p l i)\t..." (reference
// tools/kmer_conservation.cpp:26-35). Runs given as flat arrays + offsets.
extern "C" int fn_format_kc(const char* names, const int64_t* name_offs,
                            const uint32_t* starts, const uint32_t* lens,
                            const uint32_t* ids, const int64_t* run_offs, int64_t n,
                            char** out_buf, int64_t* out_len) {
    size_t cap = (size_t)(name_offs[n] + n * 8 + (run_offs[n] - run_offs[0]) * 36 + 1024);
    char* buf = (char*)malloc(cap);
    if (!buf) return 1;
    char* p = buf;
    char tmp[16];
    auto put_u32 = [&](uint32_t v) {
        int len = 0;
        do { tmp[len++] = (char)('0' + v % 10); v /= 10; } while (v);
        while (len) *p++ = tmp[--len];
    };
    for (int64_t i = 0; i < n; ++i) {
        memcpy(p, names + name_offs[i], name_offs[i + 1] - name_offs[i]);
        p += name_offs[i + 1] - name_offs[i];
        *p++ = '\t';
        int64_t lo = run_offs[i], hi = run_offs[i + 1];
        put_u32((uint32_t)(hi - lo));
        for (int64_t j = lo; j < hi; ++j) {
            *p++ = '\t'; *p++ = '(';
            put_u32(starts[j]); *p++ = ' ';
            put_u32(lens[j]); *p++ = ' ';
            put_u32(ids[j]); *p++ = ')';
        }
        *p++ = '\n';
    }
    *out_buf = buf;
    *out_len = (int64_t)(p - buf);
    return 0;
}

// kmer-matches lines: "name\tW\tb1..bW\tc1..cC" (reference
// tools/kmer_matches.cpp:29-35); hit bits packed little-endian in u32 words.
template <typename CntT>
static int format_km_impl(const char* names, const int64_t* name_offs,
                          const uint32_t* hit_words, int64_t words_per_row,
                          const int32_t* widths, const CntT* counts,
                          int64_t num_colors, int64_t n, char** out_buf,
                          int64_t* out_len) {
    int64_t maxw = 0;
    for (int64_t i = 0; i < n; ++i) maxw = std::max<int64_t>(maxw, widths[i]);
    size_t cap = (size_t)(name_offs[n] + n * (8 + 2 * maxw + 12 * num_colors) + 1024);
    char* buf = (char*)malloc(cap);
    if (!buf) return 1;
    char* p = buf;
    char tmp[24];
    auto put_u64 = [&](uint64_t v) {
        int len = 0;
        do { tmp[len++] = (char)('0' + v % 10); v /= 10; } while (v);
        while (len) *p++ = tmp[--len];
    };
    for (int64_t i = 0; i < n; ++i) {
        memcpy(p, names + name_offs[i], name_offs[i + 1] - name_offs[i]);
        p += name_offs[i + 1] - name_offs[i];
        *p++ = '\t';
        int64_t w = widths[i];
        put_u64((uint64_t)w);
        const uint32_t* row = hit_words + i * words_per_row;
        for (int64_t b = 0; b < w; ++b) {
            *p++ = '\t';
            *p++ = (char)('0' + ((row[b >> 5] >> (b & 31)) & 1));
        }
        const CntT* cnts = counts + i * num_colors;
        for (int64_t c = 0; c < num_colors; ++c) {
            *p++ = '\t';
            put_u64((uint64_t)cnts[c]);
        }
        *p++ = '\n';
    }
    *out_buf = buf;
    *out_len = (int64_t)(p - buf);
    return 0;
}

extern "C" int fn_format_km(const char* names, const int64_t* name_offs,
                            const uint32_t* hit_words, int64_t words_per_row,
                            const int32_t* widths, const int64_t* counts,
                            int64_t num_colors, int64_t n, char** out_buf,
                            int64_t* out_len) {
    return format_km_impl(names, name_offs, hit_words, words_per_row, widths,
                          counts, num_colors, n, out_buf, out_len);
}

// u16 variant: the device ships per-color match counts as u16 (widths are
// capped well under 65535 on the device path); formatting straight from
// that buffer skips a (batch x num_colors) int64 conversion on the host.
extern "C" int fn_format_km_u16(const char* names, const int64_t* name_offs,
                                const uint32_t* hit_words, int64_t words_per_row,
                                const int32_t* widths, const uint16_t* counts,
                                int64_t num_colors, int64_t n, char** out_buf,
                                int64_t* out_len) {
    return format_km_impl(names, name_offs, hit_words, words_per_row, widths,
                          counts, num_colors, n, out_buf, out_len);
}

// ascii pseudoalignment lines straight from the device bitset rows:
// "qid\tn[\tc1\tc2...]\n" without materializing per-read color lists on the
// Python side (reference psa_ascii_formatter, src/ps_utils.cpp:48-83).
// bits: n rows of c32 uint32 words, LSB-first color order. Returns the
// number of mapped rows (>=1 bit set) in *out_mapped.
// two-digit pair table: the digit emitters below write into RAW buffers
// via pointer bumps (a std::string::push_back per char capped the whole
// ascii stage at ~300 MB/s on the 4,546-color workload — 5.9 GB of output
// per 500k reads made the writer the pipeline's long pole).
static const char kD2[201] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

static inline char* put_u32_fast(char* p, uint32_t v) {
    char tmp[12];
    int len = 0;
    while (v >= 100) {
        unsigned q = v % 100;
        v /= 100;
        tmp[len++] = kD2[2 * q + 1];
        tmp[len++] = kD2[2 * q];
    }
    if (v >= 10) {
        *p++ = kD2[2 * v];
        *p++ = kD2[2 * v + 1];
    } else {
        *p++ = (char)('0' + v);
    }
    while (len) *p++ = tmp[--len];
    return p;
}

// "\tc1\tc2..." for every set bit of row[0..c32): the shared body emitter
// of the psa ascii formatters. Emits tab + decimal per bit via kD2 pairs.
static inline char* put_bits_body(char* p, const uint32_t* row, int32_t c32) {
    for (int32_t w = 0; w < c32; ++w) {
        uint32_t x = row[w];
        uint32_t base = (uint32_t)w * 32;
        while (x) {
            int b = __builtin_ctz(x);
            x &= x - 1;
            *p++ = '\t';
            p = put_u32_fast(p, base + (uint32_t)b);
        }
    }
    return p;
}

extern "C" int fn_format_psa_ascii_bits(const uint32_t* qids, const uint32_t* bits,
                                        int64_t n, int32_t c32, char** out_buf,
                                        int64_t* out_len, int64_t* out_mapped) {
    // thread-parallel: each worker formats a contiguous read range into a
    // local buffer; one concat pass assembles the output. At the primary
    // workload's shape a 32k batch formats ~200-350 MB of ascii — the
    // single-thread loop was a pipeline stage all its own (the reference
    // formats on all of its worker threads; src/ps_utils.cpp:48-83).
    unsigned T = host_threads();
    if (n < 1024) T = 1;
    std::vector<char*> part((size_t)T, nullptr);
    std::vector<size_t> plen((size_t)T, 0);
    std::vector<int64_t> pmapped((size_t)T, 0);
    std::atomic<bool> alloc_failed{false};
#ifdef _OPENMP
#pragma omp parallel num_threads(T)
#endif
    {
#ifdef _OPENMP
        int t = omp_get_thread_num();
#else
        int t = 0;
#endif
        int64_t i0 = n * t / T, i1 = n * (t + 1) / T;
        int64_t tb = 0;
        for (int64_t i = i0 * (int64_t)c32; i < i1 * (int64_t)c32; ++i)
            tb += __builtin_popcount(bits[i]);
        char* a = (char*)malloc((size_t)((i1 - i0) * 24 + tb * 11) + 16);
        char* p = a;
        if (!a) {
            alloc_failed.store(true);
        } else {
            int64_t mapped = 0;
            for (int64_t i = i0; i < i1; ++i) {
                const uint32_t* row = bits + i * c32;
                uint32_t cnt = 0;
                for (int32_t w = 0; w < c32; ++w)
                    cnt += (uint32_t)__builtin_popcount(row[w]);
                p = put_u32_fast(p, qids[i]);
                *p++ = '\t';
                p = put_u32_fast(p, cnt);
                if (cnt) ++mapped;
                p = put_bits_body(p, row, c32);
                *p++ = '\n';
            }
            pmapped[(size_t)t] = mapped;
        }
        part[(size_t)t] = a;
        plen[(size_t)t] = (size_t)(p - a);
    }
    if (alloc_failed.load()) {
        for (auto a : part) free(a);
        return 1;
    }
    size_t total = 0;
    for (auto l : plen) total += l;
    char* buf = (char*)malloc(total + 1);
    if (!buf) {
        for (auto a : part) free(a);
        return 1;
    }
    char* p = buf;
    int64_t mapped = 0;
    for (unsigned t = 0; t < T; ++t) {
        memcpy(p, part[t], plen[t]);
        p += plen[t];
        mapped += pmapped[t];
        free(part[t]);
    }
    *out_buf = buf;
    *out_len = (int64_t)total;
    *out_mapped = mapped;
    return 0;
}

// grouped variant: the runs-fetch pipeline hands each read an index into a
// small set of DISTINCT result rows (many reads share one full-intersection
// result); format each distinct row's "\tcount\tc1\tc2..." body ONCE and
// memcpy it per read. inv: (n,) distinct-row index per read. Both phases
// run thread-parallel (group bodies, then per-read line assembly at exact
// precomputed offsets).
extern "C" int fn_format_psa_ascii_bits_grouped(
    const uint32_t* qids, const uint32_t* rows, const int32_t* inv, int64_t n,
    int64_t G, int32_t c32, char** out_buf, int64_t* out_len,
    int64_t* out_mapped) {
    unsigned T = host_threads();
    if (G < 64) T = 1;
    std::vector<char*> part((size_t)T, nullptr);
    std::vector<int64_t> blen(G);
    std::vector<uint32_t> bcnt(G);
    std::atomic<bool> alloc_failed{false};
    // phase 1: distinct bodies, group ranges per thread (raw buffers +
    // digit pairs — see fn_format_psa_ascii_bits)
#ifdef _OPENMP
#pragma omp parallel num_threads(T)
#endif
    {
#ifdef _OPENMP
        int t = omp_get_thread_num();
#else
        int t = 0;
#endif
        int64_t g0 = G * t / T, g1 = G * (t + 1) / T;
        int64_t tb = 0;
        for (int64_t i = g0 * (int64_t)c32; i < g1 * (int64_t)c32; ++i)
            tb += __builtin_popcount(rows[i]);
        char* a = (char*)malloc((size_t)((g1 - g0) * 12 + tb * 11) + 16);
        char* p = a;
        if (!a) {
            alloc_failed.store(true);
        } else {
            for (int64_t g = g0; g < g1; ++g) {
                char* b0 = p;
                const uint32_t* row = rows + g * c32;
                uint32_t cnt = 0;
                for (int32_t w = 0; w < c32; ++w)
                    cnt += (uint32_t)__builtin_popcount(row[w]);
                bcnt[g] = cnt;
                *p++ = '\t';
                p = put_u32_fast(p, cnt);
                p = put_bits_body(p, row, c32);
                *p++ = '\n';
                blen[g] = (int64_t)(p - b0);
            }
        }
        part[(size_t)t] = a;
    }
    if (alloc_failed.load()) {
        for (auto a : part) free(a);
        return 1;
    }
    // body address per group (part-local offsets -> pointers)
    std::vector<const char*> baddr(G);
    for (unsigned t = 0; t < T; ++t) {
        int64_t g0 = G * t / T, g1 = G * (int64_t)(t + 1) / T;
        const char* base = part[(size_t)t];
        int64_t off = 0;
        for (int64_t g = g0; g < g1; ++g) {
            baddr[g] = base + off;
            off += blen[g];
        }
    }
    // phase 2: per-read line offsets (digits(qid) + body) then parallel fill
    auto digits = [](uint32_t v) {
        int d = 1;
        while (v >= 10) { v /= 10; ++d; }
        return d;
    };
    std::vector<int64_t> lofs((size_t)n + 1);
    lofs[0] = 0;
    for (int64_t i = 0; i < n; ++i)
        lofs[(size_t)i + 1] = lofs[(size_t)i] + digits(qids[i]) + blen[inv[i]];
    char* buf = (char*)malloc((size_t)lofs[(size_t)n] + 1);
    if (!buf) {
        for (auto a : part) free(a);
        return 1;
    }
    int64_t mapped = 0;
#ifdef _OPENMP
#pragma omp parallel for num_threads(T) reduction(+ : mapped) schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        char* p = buf + lofs[(size_t)i];
        p = put_u32_fast(p, qids[i]);
        int32_t g = inv[i];
        memcpy(p, baddr[g], (size_t)blen[g]);
        mapped += bcnt[g] > 0;
    }
    for (auto a : part) free(a);
    *out_buf = buf;
    *out_len = lofs[(size_t)n];
    *out_mapped = mapped;
    return 0;
}

// in-place parallel sort of an int64 array (conversion hot paths sort
// 10^8-element combined-key arrays; gnu parallel sort uses all cores)
// res[seg[i]*W + col[i]/32] |= 1 << (col[i]%32) — the list-intersection
// path's bitset materialization (entries arrive seg-sorted, so the walk
// is cache-friendly; a numpy bitwise_or.at here costs ~100 ns/element)
extern "C" void fn_or_bits_at(uint32_t* res, int64_t W, const int64_t* seg,
                              const int64_t* col, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        res[seg[i] * W + (col[i] >> 5)] |= (1u << (col[i] & 31));
}

extern "C" void fn_sort_i64(int64_t* data, int64_t n) {
    PAR_SORT(data, data + n);
}

// pooled co-occurrence features per COLOR in fixed-point: for every set s
// and color c in s, out[c*D + hs[s]] += wq[s] (u64 accumulation is
// order-independent, so per-thread partials keep the result exact and
// thread-count-invariant; the f64 bincount this replaces was the
// permuter's hot pass). Caller zeroes `out` (C*D).
extern "C" void fn_color_features_fp(const uint32_t* cat, const int64_t* offs,
                                     int64_t S, const uint64_t* wq,
                                     const uint16_t* hs, int32_t D,
                                     int64_t C, uint64_t* out) {
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<uint64_t> local((size_t)C * D, 0);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 2048)
#endif
        for (int64_t s = 0; s < S; ++s) {
            uint64_t w = wq[s];
            int32_t h = hs[s];
            for (int64_t i = offs[s]; i < offs[s + 1]; ++i)
                local[(size_t)cat[i] * D + h] += w;
        }
#ifdef _OPENMP
#pragma omp critical
#endif
        {
            for (size_t i = 0; i < (size_t)C * D; ++i) out[i] += local[i];
        }
    }
}

// apply a color permutation inside every segment and re-sort the segment
// (parallel over segments; replaces a global combined-key sort of
// sid*C+perm[cat] at ~10^8 elements). In-place on `cat`.
extern "C" void fn_permute_sort_segments(uint32_t* cat, const int64_t* offs,
                                         int64_t n, const uint32_t* perm) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 2048)
#endif
    for (int64_t s = 0; s < n; ++s) {
        for (int64_t i = offs[s]; i < offs[s + 1]; ++i) cat[i] = perm[cat[i]];
        std::sort(cat + offs[s], cat + offs[s + 1]);
    }
}

// position-mixed content hashes per partial-set occurrence (the meta
// interner's dedup keys; reference hashes partials with CityHash128,
// meta_builder.hpp:171-217). Two independent 64-bit sums; must match the
// numpy formulas in colorstores.intern_partials exactly.
static inline uint64_t splitmix64_mix(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

extern "C" void fn_hash_partials(const uint32_t* rel, const int64_t* starts,
                                 int64_t n_occ, int64_t total,
                                 uint64_t* h1, uint64_t* h2) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4096)
#endif
    for (int64_t o = 0; o < n_occ; ++o) {
        int64_t lo = starts[o];
        int64_t hi = (o + 1 < n_occ) ? starts[o + 1] : total;
        uint64_t a = 0, b = 0;
        for (int64_t i = lo; i < hi; ++i) {
            uint64_t w = (uint64_t)(i - lo);
            uint64_t r = rel[i];
            a += splitmix64_mix(r ^ (0x9E3779B1ULL * w));
            b += splitmix64_mix((r + 1ULL) * 0xC2B2AE3DULL + w);
        }
        h1[o] = a;
        h2[o] = b;
    }
}

// parallel first-touch of a buffer: demand faulting on virtualized hosts
// runs ~170 MB/s per thread, so a one-shot parallel warm of the reusable
// heap (see fulgor_tpu.__init__._tune_malloc) beats paying serial faults
// scattered through a pipeline.
extern "C" void fn_touch(char* p, int64_t nbytes) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < nbytes; i += 1 << 21) {
        int64_t len = std::min<int64_t>(1 << 21, nbytes - i);
        memset(p + i, 0, (size_t)len);
    }
}

// sequential LSB-first bit-stream pack of (pattern, length) pairs (the
// BitWriter hot loop; np.bitwise_or.at runs ~5M items/s, this ~300M/s).
// `words` must be zeroed with ONE word of slack past the stream end (the
// unconditional spill write ORs 0 there when the last pattern is aligned).
extern "C" void fn_pack_patterns(const uint64_t* pats, const uint64_t* lens,
                                 int64_t n, uint64_t* words) {
    uint64_t pos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t sh = pos & 63;
        int64_t w = (int64_t)(pos >> 6);
        words[w] |= pats[i] << sh;
        if (sh) words[w + 1] |= pats[i] >> (64 - sh);
        pos += lens[i];
    }
}

// one 2-means bisection for the divisive clustering loop (reference
// kmeans submodule semantics; builders/meta_builder.hpp:56-64): seed c0 =
// X[idx[i0]], seed c1 = farthest point, then <= max_iter assignment /
// centroid rounds; returns the assignment and each side's SSE (about its
// own mean). All reductions are fixed-chunk-serial so the result is
// independent of the OpenMP thread count (determinism contract, see
// docs/DESIGN-NOTES.md §5).
// One 2-means bisection. Chunk-serial reductions make the result identical
// whether the chunk loops run parallel (par=true, big clusters) or serial
// (par=false, called from the batch driver with parallelism ACROSS
// clusters) — so the wave-batched k-means below is thread-count- and
// batching-invariant.
static void bisect2_core(const float* X, int32_t D, const int64_t* idx,
                         int64_t m, int64_t i0, int32_t max_iter,
                         uint8_t* assign, double* sse_out, bool par) {
    const int64_t CHUNK = 8192;
    const int64_t nch = (m + CHUNK - 1) / CHUNK;
    std::vector<double> c0(D), c1(D);
    {
        const float* p = X + idx[i0] * (int64_t)D;
        for (int32_t j = 0; j < D; ++j) c0[j] = p[j];
    }
    // farthest point from c0 (first index on ties)
    std::vector<double> cb(nch);
    std::vector<int64_t> ca(nch);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
    for (int64_t c = 0; c < nch; ++c) {
        double best = -1.0;
        int64_t barg = c * CHUNK;
        int64_t hi = std::min((c + 1) * CHUNK, m);
        for (int64_t i = c * CHUNK; i < hi; ++i) {
            const float* x = X + idx[i] * (int64_t)D;
            double d = 0;
            for (int32_t j = 0; j < D; ++j) {
                double t = (double)x[j] - c0[j];
                d += t * t;
            }
            if (d > best) { best = d; barg = i; }
        }
        cb[c] = best;
        ca[c] = barg;
    }
    double best = -1.0;
    int64_t barg = 0;
    for (int64_t c = 0; c < nch; ++c)
        if (cb[c] > best) { best = cb[c]; barg = ca[c]; }
    {
        const float* p = X + idx[barg] * (int64_t)D;
        for (int32_t j = 0; j < D; ++j) c1[j] = p[j];
    }

    std::vector<uint8_t> prev(m, 255);
    std::vector<double> s0((size_t)nch * D), s1((size_t)nch * D);
    std::vector<int64_t> n0(nch), n1(nch);
    for (int32_t it = 0; it < max_iter; ++it) {
        std::vector<double> w(D);
        double q0 = 0, q1 = 0;
        for (int32_t j = 0; j < D; ++j) {
            w[j] = c0[j] - c1[j];
            q0 += c0[j] * c0[j];
            q1 += c1[j] * c1[j];
        }
        double bias = 0.5 * (q0 - q1);
        std::atomic<int> changed{0};
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
        for (int64_t c = 0; c < nch; ++c) {
            int64_t hi = std::min((c + 1) * CHUNK, m);
            int ch = 0;
            for (int64_t i = c * CHUNK; i < hi; ++i) {
                const float* x = X + idx[i] * (int64_t)D;
                double dot = 0;
                for (int32_t j = 0; j < D; ++j) dot += (double)x[j] * w[j];
                uint8_t a = dot < bias ? 1 : 0;
                ch |= (a != prev[i]);
                assign[i] = a;
            }
            if (ch) changed.store(1, std::memory_order_relaxed);
        }
        if (!changed.load()) break;
        memcpy(prev.data(), assign, (size_t)m);
        // centroid update (chunk-serial deterministic sums)
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
        for (int64_t c = 0; c < nch; ++c) {
            double* a0 = s0.data() + (size_t)c * D;
            double* a1 = s1.data() + (size_t)c * D;
            memset(a0, 0, sizeof(double) * D);
            memset(a1, 0, sizeof(double) * D);
            int64_t k0 = 0, k1 = 0;
            int64_t hi = std::min((c + 1) * CHUNK, m);
            for (int64_t i = c * CHUNK; i < hi; ++i) {
                const float* x = X + idx[i] * (int64_t)D;
                double* a = assign[i] ? a1 : a0;
                if (assign[i]) ++k1; else ++k0;
                for (int32_t j = 0; j < D; ++j) a[j] += x[j];
            }
            n0[c] = k0;
            n1[c] = k1;
        }
        std::vector<double> t0(D, 0.0), t1(D, 0.0);
        int64_t k0 = 0, k1 = 0;
        for (int64_t c = 0; c < nch; ++c) {
            for (int32_t j = 0; j < D; ++j) {
                t0[j] += s0[(size_t)c * D + j];
                t1[j] += s1[(size_t)c * D + j];
            }
            k0 += n0[c];
            k1 += n1[c];
        }
        if (k0) for (int32_t j = 0; j < D; ++j) c0[j] = t0[j] / k0;
        if (k1) for (int32_t j = 0; j < D; ++j) c1[j] = t1[j] / k1;
    }

    // per-side SSE about the side's own mean: sum ||x||^2 - k ||mean||^2
    std::vector<double> cr0(nch), cr1(nch);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
    for (int64_t c = 0; c < nch; ++c) {
        double* a0 = s0.data() + (size_t)c * D;
        double* a1 = s1.data() + (size_t)c * D;
        memset(a0, 0, sizeof(double) * D);
        memset(a1, 0, sizeof(double) * D);
        int64_t k0 = 0, k1 = 0;
        double r0 = 0, r1 = 0;
        int64_t hi = std::min((c + 1) * CHUNK, m);
        for (int64_t i = c * CHUNK; i < hi; ++i) {
            const float* x = X + idx[i] * (int64_t)D;
            double* a = assign[i] ? a1 : a0;
            double rr = 0;
            for (int32_t j = 0; j < D; ++j) {
                a[j] += x[j];
                rr += (double)x[j] * x[j];
            }
            if (assign[i]) { ++k1; r1 += rr; } else { ++k0; r0 += rr; }
        }
        n0[c] = k0;
        n1[c] = k1;
        cr0[c] = r0;
        cr1[c] = r1;
    }
    std::vector<double> mean0(D, 0.0), mean1(D, 0.0);
    int64_t k0 = 0, k1 = 0;
    double r0 = 0, r1 = 0;
    for (int64_t c = 0; c < nch; ++c) {
        for (int32_t j = 0; j < D; ++j) {
            mean0[j] += s0[(size_t)c * D + j];
            mean1[j] += s1[(size_t)c * D + j];
        }
        k0 += n0[c];
        k1 += n1[c];
        r0 += cr0[c];
        r1 += cr1[c];
    }
    double m0 = 0, m1 = 0;
    for (int32_t j = 0; j < D; ++j) {
        if (k0) { double v = mean0[j] / k0; m0 += v * v; }
        if (k1) { double v = mean1[j] / k1; m1 += v * v; }
    }
    sse_out[0] = k0 ? r0 - k0 * m0 : 0.0;
    sse_out[1] = k1 ? r1 - k1 * m1 : 0.0;
}

extern "C" void fn_bisect2(const float* X, int32_t D, const int64_t* idx,
                           int64_t m, int64_t i0, int32_t max_iter,
                           uint8_t* assign, double* sse_out) {
    bisect2_core(X, D, idx, m, i0, max_iter, assign, sse_out, true);
}

// Wave-batched bisections: one call bisects every cluster of a divisive
// k-means wave. Parallelism is across clusters for the (many) small ones
// and within the cluster for the few big ones; per-cluster results are
// identical either way (chunk-serial reductions). idx_cat/idx_offs: the
// concatenated per-cluster point-index lists; i0s: per-cluster seed point
// (cluster-local); assign/sse laid out like idx_cat / (ncl, 2).
extern "C" void fn_bisect2_batch(const float* X, int32_t D,
                                 const int64_t* idx_cat, const int64_t* idx_offs,
                                 int64_t ncl, const int64_t* i0s,
                                 int32_t max_iter, uint8_t* assign,
                                 double* sse_out) {
    const int64_t BIG = 65536;  // within-cluster parallelism above this
    for (int64_t c = 0; c < ncl; ++c) {
        int64_t m = idx_offs[c + 1] - idx_offs[c];
        if (m > BIG)
            bisect2_core(X, D, idx_cat + idx_offs[c], m, i0s[c], max_iter,
                         assign + idx_offs[c], sse_out + 2 * c, true);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
    for (int64_t c = 0; c < ncl; ++c) {
        int64_t m = idx_offs[c + 1] - idx_offs[c];
        if (m <= BIG)
            bisect2_core(X, D, idx_cat + idx_offs[c], m, i0s[c], max_iter,
                         assign + idx_offs[c], sse_out + 2 * c, false);
    }
}

// pooled membership features: feature row s counts set s's colors falling
// in each of D equal-width color blocks (the converters' clustering /
// chain-order space; reference sketches instead — build_util.hpp:148-253).
// Parallel over sets (rows are private). `out` (n*D u32) must be zeroed.
extern "C" void fn_pooled_features(const uint32_t* cat, const int64_t* offs,
                                   int64_t n, uint32_t num_colors, int32_t D,
                                   uint32_t* out) {
    uint32_t nc = num_colors ? num_colors : 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1024)
#endif
    for (int64_t s = 0; s < n; ++s) {
        uint32_t* row = out + (size_t)s * (size_t)D;
        for (int64_t i = offs[s]; i < offs[s + 1]; ++i)
            row[(uint64_t)cat[i] * (uint64_t)D / nc]++;
    }
}

// dense (S, W)-u32 bitset matrix from concatenated color lists — the
// query engine's load-time row source (index.dense_color_bits). Parallel
// over sets (rows are private); replaces np.bitwise_or.at, which crawls at
// ~10^7 scatter-ops/s against the ~10^9 incidences of a 4,546-genome
// corpus. `out` (S*W u32) must be zeroed.
// Row s covers cat[starts[s], ends[s]) — arbitrary slices, so the
// on-demand decoder can rasterize a SUBSET of sets without copying them out
// of the concatenated stream first.
extern "C" void fn_dense_bits(const uint32_t* cat, const int64_t* starts,
                              const int64_t* ends, int64_t S, int64_t W,
                              uint32_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4096)
#endif
    for (int64_t s = 0; s < S; ++s) {
        uint32_t* row = out + (size_t)s * (size_t)W;
        for (int64_t i = starts[s]; i < ends[s]; ++i) {
            uint32_t c = cat[i];
            row[c >> 5] |= (1u << (c & 31));
        }
    }
}

// per-segment AND-reduce over rows of a dense (S, W) u32 bitset matrix:
// out[s] = AND of dense[ids[j]] for j in [starts[s], starts[s+1]); empty
// segments zero. The query engine's full-intersection host stage — replaces
// numpy's gather + bitwise_and.reduceat, which materializes a
// (total_ids, W) intermediate (137 MB/batch on pansal4546) and reduces on
// one thread. Popular rows stay cache-hot across segments here.
extern "C" void fn_and_reduce_rows(const uint32_t* dense, int64_t W,
                                   const int64_t* ids, const int64_t* starts,
                                   int64_t nseg, uint32_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1024)
#endif
    for (int64_t s = 0; s < nseg; ++s) {
        uint32_t* o = out + (size_t)s * (size_t)W;
        int64_t j0 = starts[s], j1 = starts[s + 1];
        if (j0 >= j1) {
            memset(o, 0, (size_t)W * 4);
            continue;
        }
        memcpy(o, dense + (size_t)ids[j0] * (size_t)W, (size_t)W * 4);
        for (int64_t j = j0 + 1; j < j1; ++j) {
            const uint32_t* r = dense + (size_t)ids[j] * (size_t)W;
            for (int64_t w = 0; w < W; ++w) o[w] &= r[w];
        }
    }
}

// per-segment symmetric difference of two families of sorted duplicate-free
// u32 lists: out segment s = setxor1d(a_s, b_s), sorted. Two-pointer merges
// parallel over segments — O(total) and cache-coherent, replacing the
// converter's global combined-key sort (chain-diff coding's hot op at
// ~10^8 elements; reference differential coding: differential.hpp:21-99).
// out_offs: (n+1) caller-allocated; *out_cat: malloc'd, release w/ fn_free.
// Indirect variant: each side's segment s is an arbitrary [starts[s],
// ends[s]) slice of its buffer. Lets the chain-diff converter and decoder
// read PARENT segments in place (starts = offs[parent]) instead of
// materializing a ~10^8-element gather index + copy of the parent ints.
extern "C" int fn_symdiff_segments_ind(
    const uint32_t* a, const int64_t* sa, const int64_t* ea,
    const uint32_t* b, const int64_t* sb, const int64_t* eb,
    int64_t n, int64_t* out_offs, uint32_t** out_cat) {
    std::vector<int64_t> cnt((size_t)n);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 2048)
#endif
    for (int64_t s = 0; s < n; ++s) {
        int64_t i = sa[s], ie = ea[s], j = sb[s], je = eb[s];
        int64_t c = 0;
        while (i < ie && j < je) {
            uint32_t x = a[i], y = b[j];
            i += (x <= y);
            j += (y <= x);
            c += (x != y);
        }
        cnt[(size_t)s] = c + (ie - i) + (je - j);
    }
    out_offs[0] = 0;
    for (int64_t s = 0; s < n; ++s) out_offs[s + 1] = out_offs[s] + cnt[(size_t)s];
    uint32_t* out = (uint32_t*)malloc(
        sizeof(uint32_t) * (size_t)std::max<int64_t>(1, out_offs[n]));
    if (!out) return 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 2048)
#endif
    for (int64_t s = 0; s < n; ++s) {
        int64_t i = sa[s], ie = ea[s], j = sb[s], je = eb[s];
        uint32_t* p = out + out_offs[s];
        while (i < ie && j < je) {
            uint32_t x = a[i], y = b[j];
            if (x == y) {
                ++i; ++j;
            } else if (x < y) {
                *p++ = x; ++i;
            } else {
                *p++ = y; ++j;
            }
        }
        while (i < ie) *p++ = a[i++];
        while (j < je) *p++ = b[j++];
    }
    *out_cat = out;
    return 0;
}

extern "C" int fn_symdiff_segments(const uint32_t* a, const int64_t* oa,
                                   const uint32_t* b, const int64_t* ob,
                                   int64_t n, int64_t* out_offs,
                                   uint32_t** out_cat) {
    // contiguous offsets are the special case starts=offs[s], ends=offs[s+1]
    return fn_symdiff_segments_ind(a, oa, oa + 1, b, ob, ob + 1, n, out_offs,
                                   out_cat);
}
