"""Minimizer-positional k-mer dictionary, v2: bucketless robin-hood layout
with a skew pointer table for heavy minimizers.

v1 (ops/minidict.py) stores buckets as an explicit (start, count) array —
8-16 B/entry of pure metadata — and probes up to `cap` candidates with two
text extracts each. v2 removes the bucket array entirely:

  * slot array of M = ceil(NE / LOAD) entry slots, 12 B each, packed ROWW
    to a row (one probe = SCAN/ROWW row gathers covering SCAN slots);
    bucket = fastrange(h, M) (monotone in h, arbitrary M — no power-of-two
    waste);
  * entries sorted by bucket and placed greedily at the first free slot at
    or after their bucket; a minimizer group that cannot fit entirely
    inside the probe's SCAN-slot window is PARKED in arbitrary free slots
    (covered bit set) and reached through the skew table instead;
  * each entry carries a 15-bit fingerprint of the minimizer hash plus a
    STRAND bit (is the text m-mer at the stored minimizer position the
    canonical form?), so the probe screens SCAN slots with pure register
    compares, resolves candidate orientation WITHOUT trying both (odd m:
    no palindromic m-mers, so strand mismatch proves the text compare
    would fail), and text-verifies only the (typically 0-1)
    fingerprint+strand+in-span survivors;
  * heavy minimizer groups (>= COVER_GROUP entries — pangenomes of many
    near-identical genomes produce thousands of these) get one SKEW TABLE
    slot per COVERED K-MER: a u32 (fp8 | primary_slot_id+1) pointer keyed
    by the canonical k-mer, 2-choice rows of 8. The probe routes covered
    windows by full-k-mer hash straight to the right parked entry — the
    SSHash skew-index idea (reference sshash; see SURVEY §2.2) with
    pointers instead of an MPHF. ~4.7 B per covered k-mer vs ~19 B for the
    previous per-k-mer exact table.

Space: 12 B/LOAD per entry + 0.5 B/base text + ~4.7 B per covered k-mer;
at (k=31, m=19) one entry covers ~5-6.5 k-mers => ~3-6 B/k-mer total
(corpus-dependent) vs 19.5 for the cuckoo table and ~1 for SSHash
(reference include/index.hpp:13).

Exactness contract (device + host agree):
  hit  => the k-mer IS in the index and csid is its color-set id
          (always a text-verified 62-bit compare);
  ovf  => the probe ran out of verify/candidate slots before deciding; the
          caller must fall back to the exact host probe (rare: fp8/fp16
          collision pileups, measured well below 0.1% of windows).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import INVALID_U32
from ..core import kmers as K
from .minidict import (
    SEED_M,
    _mix32_np,
    mmer_hashes,
    sliding_min_argmin,
    window_packings_lsb,
)

LOAD = 0.6
SCAN = 8  # slots screened per probe
ROWW = 8  # entries per slot row (power of 2): SCAN/ROWW row gathers per probe
VERIFY_BUDGET = 6  # text verifications per probe (shared across orientations)
COVER_GROUP = 4  # groups with >= this many entries route via the skew table
MAX_SPAN = 127  # span field is 7 bits (bit 15 of the meta word = covered)

# skew table: per-covered-k-mer u32 pointer (fp8 | slot_id+1), keyed by the
# LSB-first canonical packing (min of fwd/rc as (hi, lo) tuples — no
# bit-reversal needed on device). 2-choice rows of SKEW_ROWW slots; probe =
# 2 mix32 hashes + 2 row gathers + <=SKEW_CAND entry gathers + text verify.
SKEW_SEED1 = 0x2545F491
SKEW_SEED2 = 0x9E3779B9
SKEW_LOAD = 0.85
SKEW_ROWW = 8  # u32 slots per row: one 32 B gather
SKEW_CAND = 3  # fp8-matching entries chased per probe (more -> ovf)


def _skew_hash_np(klo, khi, seed):
    return _mix32_np(klo ^ _mix32_np(khi ^ np.uint32(seed)))


def _fastrange_np(h, n):
    return ((h.astype(np.uint64) * np.uint64(n)) >> np.uint64(32)).astype(np.int64)


def canonical_lsb_np(flo, fhi, rlo, rhi):
    take_f = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    return np.where(take_f, flo, rlo), np.where(take_f, fhi, rhi)


def skew_build(klo: np.ndarray, khi: np.ndarray, slot_ids: np.ndarray) -> np.ndarray:
    """Build the (NR, SKEW_ROWW) uint32 pointer table: slot value =
    ((primary_slot_id + 1) << 8) | fp8, 0 = empty. Greedy 2-choice row
    placement (each key targets the emptier of its two rows, round by
    round; the table grows until every key fits — bins of 8 at load 0.85
    virtually always succeed). Keys must be distinct."""
    n = len(slot_ids)
    if n == 0:
        return np.zeros((1, SKEW_ROWW), dtype=np.uint32)
    assert int(slot_ids.max()) + 1 < (1 << 24), (
        "primary slot id exceeds the 24-bit skew pointer; widen the skew "
        "slot layout for indexes beyond ~16M dictionary entries"
    )
    klo = klo.astype(np.uint32)
    khi = khi.astype(np.uint32)
    h1 = _skew_hash_np(klo, khi, SKEW_SEED1)
    h2 = _skew_hash_np(klo, khi, SKEW_SEED2)
    val = ((slot_ids.astype(np.uint32) + np.uint32(1)) << np.uint32(8)) | (
        h1 & np.uint32(0xFF)
    )
    NR = max(2, int(np.ceil(n / SKEW_ROWW / SKEW_LOAD)))
    while True:
        r1 = _fastrange_np(h1, NR)
        r2 = _fastrange_np(h2, NR)
        counts = np.zeros(NR, dtype=np.int32)
        row_of = np.full(n, -1, dtype=np.int64)
        pending = np.arange(n, dtype=np.int64)
        # phase 1: vectorized greedy rounds (emptier of the two rows) —
        # places ~96% of keys at load 0.85; no eviction
        for _round in range(32):
            if not len(pending):
                break
            tgt = np.where(
                counts[r1[pending]] <= counts[r2[pending]], r1[pending], r2[pending]
            )
            order = np.argsort(tgt, kind="stable")
            ts = tgt[order]
            new = np.concatenate([[True], ts[1:] != ts[:-1]])
            starts = np.flatnonzero(new)
            glen = np.diff(np.concatenate([starts, [len(ts)]]))
            rank = np.arange(len(ts)) - np.repeat(starts, glen)
            ok = rank < (SKEW_ROWW - counts[ts])
            row_of[pending[order[ok]]] = ts[ok]
            np.add.at(counts, ts[ok], 1)
            pending = pending[order[~ok]]
            if not ok.any():
                break
        # phase 2: sequential cuckoo eviction for the stragglers whose rows
        # both filled (the tail the greedy phase cannot place)
        occ = np.full(NR * SKEW_ROWW, -1, dtype=np.int64)  # slot -> key
        placed_keys = np.flatnonzero(row_of >= 0)
        pr = row_of[placed_keys]
        order = np.argsort(pr, kind="stable")
        ro = pr[order]
        new = np.concatenate([[True], ro[1:] != ro[:-1]])
        starts = np.flatnonzero(new)
        glen = np.diff(np.concatenate([starts, [len(ro)]]))
        slotpos = np.arange(len(ro)) - np.repeat(starts, glen)
        occ[ro * SKEW_ROWW + slotpos] = placed_keys[order]
        ok_all = True
        for key in pending:
            key = int(key)
            steps = 0
            while True:
                placed = False
                for rr in (int(r1[key]), int(r2[key])):
                    base = rr * SKEW_ROWW
                    for e in range(SKEW_ROWW):
                        if occ[base + e] < 0:
                            occ[base + e] = key
                            placed = True
                            break
                    if placed:
                        break
                if placed:
                    break
                steps += 1
                if steps > 5000:
                    ok_all = False
                    break
                # evict a pseudo-random victim from the first-choice row and
                # take its slot; the victim re-inserts (deterministic walk)
                rr = int(r1[key]) if steps % 2 else int(r2[key])
                e = ((int(h1[key]) ^ (steps * 0x9E3779B9)) >> 7) % SKEW_ROWW
                v = rr * SKEW_ROWW + e
                victim = int(occ[v])
                occ[v] = key
                key = victim
            if not ok_all:
                break
        if ok_all:
            break
        NR = int(NR * 1.2) + 1
    rows = np.zeros((NR, SKEW_ROWW), dtype=np.uint32)
    filled = np.flatnonzero(occ >= 0)
    rows.reshape(-1)[filled] = val[occ[filled]]
    return rows


def upgrade_slots_v2_to_v3(slots: np.ndarray, text32: np.ndarray,
                           m: int) -> np.ndarray:
    """Upgrade a v2 slot array (16-bit fingerprints) to the v3 strand-bit
    layout: the low 15 fingerprint bits are IDENTICAL in both formats
    (fp = key & 0x7FFF), so only bit 31 changes — recomputed as the entry's
    text-strand bit (is the m-mer at wlo+moff canonical?) from the
    dictionary's own text. Tombstones/empty slots get bit 31 = 0."""
    flat = slots.reshape(-1, 3).copy()
    # reconstruct the base codes from the stride-32 overlapping text rows
    words = np.empty(2 * len(text32) + 2, dtype=np.uint32)
    words[: 2 * len(text32) : 2] = text32[:, 0]
    words[1 : 2 * len(text32) : 2] = text32[:, 1]
    words[-2:] = text32[-1, 2:4]
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    codes = ((words[:, None] >> shifts) & np.uint32(3)).astype(np.uint8).ravel()
    km, _v = K.pack_kmers(codes, m)
    # match the build path's tf init (_minimizer_runs: np.ones) so an
    # upgraded index is bit-identical to a fresh v3 build
    tf = np.ones(len(codes), dtype=bool)
    if len(km):
        tf[: len(km)] = km <= K.revcomp_packed(km, m)
    ms = flat[:, 2]
    sp = (ms >> np.uint32(8)) & np.uint32(0x7F)
    real = sp > 0
    mpos = (flat[:, 0] + (ms & np.uint32(0xFF))).astype(np.int64)
    assert not real.any() or (
        int(mpos[real].max()) + m <= len(tf) and int(mpos[real].min()) >= 0
    ), "v2 slot entry minimizer position outside dictionary text (corrupt index)"
    sigma = np.zeros(len(flat), dtype=np.uint32)
    sigma[real] = tf[mpos[real]]
    flat[:, 2] = (ms & np.uint32(0x7FFFFFFF)) | (sigma << np.uint32(31))
    return flat.reshape(slots.shape)


def skew_candidates_host(skew: np.ndarray, klo: np.ndarray, khi: np.ndarray):
    """All fp8-matching (key_index, primary_slot_id) pairs in probe order
    (row1 slots, then row2 slots), plus the per-key match count. Exact host
    paths verify every pair; device-semantics paths cap at SKEW_CAND."""
    NR = len(skew)
    h1 = _skew_hash_np(klo, khi, SKEW_SEED1)
    h2 = _skew_hash_np(klo, khi, SKEW_SEED2)
    fp = h1 & np.uint32(0xFF)
    cnt = np.zeros(len(klo), dtype=np.int32)
    pairs_i: list[np.ndarray] = []
    pairs_s: list[np.ndarray] = []
    for r in (_fastrange_np(h1, NR), _fastrange_np(h2, NR)):
        row = skew[r]
        for e in range(SKEW_ROWW):
            v = row[:, e]
            m = (v != 0) & ((v & np.uint32(0xFF)) == fp)
            sel = np.flatnonzero(m)
            pairs_i.append(sel)
            pairs_s.append((v[sel] >> np.uint32(8)).astype(np.int64) - 1)
            cnt += m.astype(np.int32)
    return cnt, pairs_i, pairs_s


def _fastrange32(h: np.ndarray, M: int) -> np.ndarray:
    return ((h.astype(np.uint64) * np.uint64(M)) >> np.uint64(32)).astype(np.int64)


def probe_key(h: np.ndarray) -> np.ndarray:
    """Minimizer hashes are sliding MINIMA — strongly biased low — so they
    must be re-mixed before fastrange bucketing (and fp extraction)."""
    return _mix32_np(h)


@dataclass
class MiniDict2:
    k: int
    m: int
    slots: np.ndarray  # (MR, 3*ROWW) uint32: ROWW 12 B entries per row
    num_slots: int  # M (fastrange modulus)
    text32: np.ndarray  # (n, 4) uint32: 64 bases per row, stride 32
    sec_table: np.ndarray  # (NR, SKEW_ROWW) u32 skew pointers (fp8|slot+1)
    spill_frac: float  # fraction of k-mers routed via the skew table
    multi_tail: float  # fraction of probe sites with >VERIFY_SLOTS in-span cands

    def num_bytes(self) -> int:
        return int(self.slots.nbytes + self.text32.nbytes + self.sec_table.nbytes)


def text32_from_packed(seq_u64: np.ndarray, total_bases: int) -> np.ndarray:
    """Derive the (n, 4) uint32 text rows from 2-bit packed uint64 words
    (core.kmers.pack2 layout = LSB-first, little-endian), without unpacking
    to bases. Identical to pack_text32(unpack2(seq_u64, total_bases))."""
    w32 = np.asarray(seq_u64, dtype="<u8").view(np.uint32)
    n = int(total_bases)
    nwords = (n + 15) // 16 + 4
    assert len(w32) * 16 >= n, "packed text shorter than total_bases"
    if len(w32) < nwords:
        w32 = np.concatenate([w32, np.zeros(nwords - len(w32), np.uint32)])
    n32 = (nwords - 3) // 2
    return np.stack(
        [w32[0 : 2 * n32 : 2], w32[1 : 2 * n32 + 1 : 2],
         w32[2 : 2 * n32 + 2 : 2], w32[3 : 2 * n32 + 3 : 2]],
        axis=1,
    )


def pack_text32(codes: np.ndarray) -> np.ndarray:
    """Base codes -> (n, 4) uint32 rows covering 64 bases each at 32-base
    stride (LSB-first, 16 bases/word). One 16 B gather yields >=33
    contiguous bases from any position."""
    n = len(codes)
    nwords = (n + 15) // 16 + 4
    c = np.concatenate([codes & 3, np.zeros(nwords * 16 - n, dtype=np.uint8)]).astype(
        np.uint32
    ).reshape(-1, 16)
    words = np.zeros(len(c), dtype=np.uint32)
    for i in range(16):
        words |= c[:, i] << np.uint32(2 * i)
    n32 = (len(words) - 3) // 2
    return np.stack(
        [words[0 : 2 * n32 : 2], words[1 : 2 * n32 + 1 : 2],
         words[2 : 2 * n32 + 2 : 2], words[3 : 2 * n32 + 3 : 2]],
        axis=1,
    )


def extract33_host(text32: np.ndarray, q) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) u32 = 32 bases LSB-first at base position q (vectorized)."""
    q = np.asarray(q, dtype=np.int64)
    row = text32[np.clip(q >> 5, 0, len(text32) - 1)]
    sh = (2 * (q & 31)).astype(np.uint32)
    big = sh >= 32
    s = np.where(big, sh - 32, sh)
    a0 = np.where(big, row[..., 1], row[..., 0])
    a1 = np.where(big, row[..., 2], row[..., 1])
    a2 = np.where(big, row[..., 3], row[..., 2])
    nz = s > 0
    inv = np.where(nz, np.uint32(32) - s, np.uint32(1))
    lo = np.where(nz, (a0 >> s) | (a1 << inv), a0)
    hi = np.where(nz, (a1 >> s) | (a2 << inv), a1)
    return lo.astype(np.uint32), hi.astype(np.uint32)


def _minimizer_runs(unitig_codes, unitig_offs, unitig_cs, k, m):
    """Maximal runs of k-mer positions with constant leftmost-minimizer
    position (split at 255). -> dict of per-entry arrays + per-position
    hash array (the construction of fulgor_tpu's v1 minidict build)."""
    codes = np.asarray(unitig_codes, dtype=np.uint8)
    offs = np.asarray(unitig_offs, dtype=np.int64)
    ucs = np.asarray(unitig_cs, dtype=np.uint32)
    total = int(offs[-1])

    h = np.full(total, 0xFFFFFFFF, dtype=np.uint32)
    hm = mmer_hashes(codes, m)
    h[: len(hm)] = hm
    pos = np.arange(len(hm), dtype=np.int64)
    uid_m = np.searchsorted(offs, pos, side="right") - 1
    cross = (pos + m) > offs[uid_m + 1]
    h[: len(hm)][cross] = np.uint32(0xFFFFFFFF)

    w = k - m + 1
    minval, left, _right = sliding_min_argmin(h, w)
    nkpos = len(minval)
    kpos = np.arange(nkpos, dtype=np.int64)
    uid_k = np.searchsorted(offs, kpos, side="right") - 1
    valid_k = (kpos + k) <= offs[uid_k + 1]

    j = kpos + left
    prev_j = np.concatenate([[-2], j[:-1]])
    prev_valid = np.concatenate([[False], valid_k[:-1]])
    is_new = valid_k & (~prev_valid | (j != prev_j))
    starts = np.flatnonzero(is_new)
    run_id = np.cumsum(is_new) - 1
    counts = np.bincount(run_id[valid_k], minlength=len(starts))

    # split runs at MAX_SPAN (vectorized)
    n_sub = (counts + MAX_SPAN - 1) // MAX_SPAN
    sub_of_run = np.repeat(np.arange(len(starts)), n_sub)
    sub_idx = np.arange(int(n_sub.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(n_sub)])[:-1], n_sub
    )
    wlo = starts[sub_of_run] + MAX_SPAN * sub_idx
    span = np.minimum(counts[sub_of_run] - MAX_SPAN * sub_idx, MAX_SPAN)
    jj = j[starts][sub_of_run]
    moff = jj - wlo
    assert len(wlo) == 0 or ((moff >= 0).all() and (moff <= 255).all())
    # per-entry strand bit: is the TEXT m-mer at the stored minimizer
    # position the canonical form? (probe-side orientation filter)
    km, _mv = K.pack_kmers(codes, m)
    tf = np.ones(total, dtype=bool)
    if len(km):
        tf[: len(km)] = km <= K.revcomp_packed(km, m)
    return dict(
        wlo=wlo.astype(np.int64),
        span=span.astype(np.int64),
        moff=moff.astype(np.int64),
        csid=ucs[uid_k[starts]][sub_of_run],
        hash=h[jj],
        sigma=tf[jj],
        codes=codes,
    )


def build_minidict2(unitig_codes, unitig_offs, unitig_cs, k, m,
                    verbose=False) -> MiniDict2:
    assert m % 2 == 1, (
        "minidict2 requires odd m: the per-entry strand bit relies on "
        "m-mers never being their own reverse complement")
    r = _minimizer_runs(unitig_codes, unitig_offs, unitig_cs, k, m)
    NE = len(r["wlo"])
    M = max(16, int(np.ceil(NE / LOAD)))

    key = probe_key(r["hash"])
    bucket = _fastrange32(key, M)
    order = np.lexsort((r["wlo"], bucket))
    b_s = bucket[order]
    h_s = r["hash"][order]
    key_s = key[order]

    # group = maximal run of equal minimizer hash (consecutive after sort)
    g_new = np.concatenate([[True], h_s[1:] != h_s[:-1]])
    g_id = np.cumsum(g_new) - 1
    g_sizes = np.bincount(g_id)
    g_bucket = b_s[g_new]
    NG = len(g_sizes)

    # sequential first-fit placement: group i goes to the first free slot at
    # or after the row-aligned bucket; whole group spills if it cannot end
    # within [(b & ~(ROWW-1)), + SCAN). Exact greedy (the vectorized
    # fixpoint over-spills under cascades).
    placed = np.ones(NG, dtype=bool)
    start = np.zeros(NG, dtype=np.int64)
    lo_b = (g_bucket & ~np.int64(ROWW - 1))
    cur = 0
    for i in range(NG):
        s0 = max(cur, int(lo_b[i]))
        if s0 + int(g_sizes[i]) <= int(lo_b[i]) + SCAN:
            start[i] = s0
            cur = s0 + int(g_sizes[i])
        else:
            placed[i] = False

    # materialize slots; groups with >= COVER_GROUP entries are also pushed
    # to the secondary and their entries marked covered (bit 15), so the
    # probe can DECIDE windows whose candidate list exceeds the verify
    # budget (secondary miss proves absence for covered entries)
    M_pad = M + SCAN + ROWW
    MR = (M_pad + ROWW - 1) // ROWW + 2
    flat = np.zeros(MR * ROWW * 3, dtype=np.uint32).reshape(MR * ROWW, 3)
    ent_placed = np.repeat(placed, g_sizes)
    g_placed_sizes = np.where(placed, g_sizes, 0)
    within = np.arange(int(g_placed_sizes.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(g_placed_sizes)])[:-1][placed],
        g_sizes[placed],
    )
    slot_of = np.repeat(start[placed], g_sizes[placed]) + within
    sel = np.flatnonzero(ent_placed)
    covered_g = g_sizes >= COVER_GROUP
    ent_covered = np.repeat(covered_g, g_sizes)
    fp = (key_s & np.uint32(0x7FFF)).astype(np.uint32)
    wlo_s = r["wlo"][order]
    span_s = r["span"][order]
    moff_s = r["moff"][order]
    csid_s = r["csid"][order]
    sigma_s = r["sigma"][order]
    flat[slot_of, 0] = wlo_s[sel].astype(np.uint32)
    flat[slot_of, 1] = csid_s[sel]
    flat[slot_of, 2] = (
        moff_s[sel].astype(np.uint32)
        | (span_s[sel].astype(np.uint32) << np.uint32(8))
        | (ent_covered[sel].astype(np.uint32) << np.uint32(15))
        | (fp[sel] << np.uint32(16))
        | (sigma_s[sel].astype(np.uint32) << np.uint32(31))
    )

    # tombstones: every SPILLED group leaves a (sp=0, covered=1, fp) marker
    # in its probe window so the query can gate the skew gathers to the
    # (rare) windows that actually need them — all other windows gather row
    # 0, which coalesces to ~nothing on the memory system. If a window is
    # too full even for the marker, the probe's "window full" rule triggers
    # the skew path instead (see lookup_minidict2_batch).
    occupied = np.zeros(MR * ROWW, dtype=bool)
    occupied[slot_of] = True
    ts_g = np.flatnonzero(~placed)
    ts_fp = (key_s[g_new][ts_g] & np.uint32(0x7FFF)).astype(np.uint32)
    ts_lo = lo_b[ts_g]
    for i in range(len(ts_g)):
        base = int(ts_lo[i])
        for s in range(base, base + SCAN):
            if not occupied[s]:
                occupied[s] = True
                flat[s, 2] = (np.uint32(1) << np.uint32(15)) | (ts_fp[i] << np.uint32(16))
                break

    # park spilled entries in arbitrary free slots (covered bit set so the
    # window scan never treats them as candidates); they are reached only
    # through the skew table, by slot id
    unplaced_sel = np.flatnonzero(~ent_placed)
    free = np.flatnonzero(~occupied)
    if len(free) < len(unplaced_sel):  # pathological; grow the flat array
        extra = len(unplaced_sel) - len(free)
        flat = np.concatenate([flat, np.zeros((extra, 3), np.uint32)])
        free = np.concatenate([free, np.arange(len(occupied), len(flat))])
        MR = (len(flat) + ROWW - 1) // ROWW
        flat = np.concatenate(
            [flat, np.zeros((MR * ROWW - len(flat), 3), np.uint32)]
        )
    park = free[: len(unplaced_sel)]
    flat[park, 0] = wlo_s[unplaced_sel].astype(np.uint32)
    flat[park, 1] = csid_s[unplaced_sel]
    flat[park, 2] = (
        moff_s[unplaced_sel].astype(np.uint32)
        | (span_s[unplaced_sel].astype(np.uint32) << np.uint32(8))
        | (np.uint32(1) << np.uint32(15))
        | (fp[unplaced_sel] << np.uint32(16))
        | (sigma_s[unplaced_sel].astype(np.uint32) << np.uint32(31))
    )
    slots = flat.reshape(-1, 3 * ROWW)

    # skew table: one pointer per k-mer of covered (heavy-minimizer) or
    # parked entries, keyed by the canonical k-mer
    slot_all = np.empty(NE, dtype=np.int64)
    slot_all[ent_placed] = slot_of
    slot_all[~ent_placed] = park
    spill_sel = np.flatnonzero(~ent_placed | ent_covered)
    if len(spill_sel):
        sp_wlo = wlo_s[spill_sel]
        sp_span = span_s[spill_sel]
        sp_slot = slot_all[spill_sel]
        kpos = np.repeat(sp_wlo, sp_span) + (
            np.arange(int(sp_span.sum()))
            - np.repeat(np.concatenate([[0], np.cumsum(sp_span)])[:-1], sp_span)
        )
        kslot = np.repeat(sp_slot, sp_span)
        flo, fhi, rlo, rhi, _okw = window_packings_lsb(r["codes"], k)
        klo, khi = canonical_lsb_np(flo[kpos], fhi[kpos], rlo[kpos], rhi[kpos])
        key64 = (khi.astype(np.uint64) << np.uint64(32)) | klo.astype(np.uint64)
        _, uniq_idx = np.unique(key64, return_index=True)
        sec = skew_build(klo[uniq_idx], khi[uniq_idx], kslot[uniq_idx])
        n_spill_kmers = len(uniq_idx)
    else:
        sec = np.zeros((1, SKEW_ROWW), dtype=np.uint32)
        n_spill_kmers = 0

    nk = int(np.sum(r["span"]))
    spill_frac = n_spill_kmers / max(1, nk)
    d = MiniDict2(
        k=k, m=m, slots=slots, num_slots=M, text32=pack_text32(r["codes"]),
        sec_table=sec, spill_frac=spill_frac, multi_tail=-1.0,
    )
    if verbose:
        print(
            f"[minidict2] NE={NE} M={M} spilled entries="
            f"{len(spill_sel)} ({100 * len(spill_sel) / max(1, NE):.2f}%) "
            f"spilled kmers={n_spill_kmers} ({100 * spill_frac:.3f}%) "
            f"bytes={d.num_bytes() / 1e6:.1f}MB ({d.num_bytes() / max(1, nk):.2f} B/kmer)"
        )
    return d


# --------------------------------------------------------------------------
# host probes
# --------------------------------------------------------------------------


def _window_minimizers(codes: np.ndarray, k: int, m: int):
    h = mmer_hashes(codes, m)
    minval, left, right = sliding_min_argmin(h, k - m + 1)
    return minval, left, right


def _probe_candidates(d: MiniDict2, p, minval, left, right, tf=None):
    """In-slot-order (entry, orientation) candidates for window p:
    fingerprint-matching, in-span, NOT covered (covered entries are reached
    via the skew table). -> (cands [(q, csid, orient)], gated) where gated
    mirrors the device's need_sec rule (covered/marker fp match, or window
    full). Shared by both host probes.

    tf: per-position take_f (fwd m-mer == canonical) array — when given,
    candidates whose orientation is strand-incompatible with the entry's
    stored strand bit are dropped (the device-sem budget filter); the
    exact probe passes None and verifies both orientations."""
    k, m = d.k, d.m
    kk = probe_key(np.array([minval[p]], np.uint32))
    b = int(_fastrange32(kk, d.num_slots)[0])
    fp = np.uint32(int(kk[0]) & 0x7FFF)
    flat = d.slots.reshape(-1, 3)
    base = b & ~(ROWW - 1)
    cands = []
    gated = False
    n_occ = 0
    for sidx in range(base, base + SCAN):
        wlo, cs, ms = flat[sidx]
        sp = (int(ms) >> 8) & 0x7F
        cov = (int(ms) >> 15) & 1
        efp = np.uint32((int(ms) >> 16) & 0x7FFF)
        st = (int(ms) >> 31) & 1
        n_occ += int(sp > 0 or cov)
        if cov and efp == fp:
            gated = True
        if sp == 0 or efp != fp or cov:
            continue
        mo = int(ms) & 0xFF
        mpos = int(wlo) + mo
        qf = mpos - int(left[p])
        if int(wlo) <= qf < int(wlo) + sp and (
                tf is None or int(tf[p + int(left[p])]) == st):
            cands.append((qf, int(cs), 0))
        qr = mpos - (k - m) + int(right[p])
        if int(wlo) <= qr < int(wlo) + sp and (
                tf is None or int(tf[p + int(right[p])]) != st):
            cands.append((qr, int(cs), 1))
    if n_occ >= SCAN:
        gated = True
    return cands, gated


def _verify(d: MiniDict2, q, orient, flo, fhi, rlo, rhi, lo_mask, hi_mask):
    tlo, thi = extract33_host(d.text32, np.array([q]))
    if orient == 0:
        return (tlo[0] & lo_mask) == flo and (thi[0] & hi_mask) == fhi
    return (tlo[0] & lo_mask) == rlo and (thi[0] & hi_mask) == rhi


def _probe_read(d: MiniDict2, codes: np.ndarray, budget):
    """Shared host probe; budget=None -> exact (verify all candidates)."""
    k, m = d.k, d.m
    Wk = len(codes) - k + 1
    hit = np.zeros(max(0, Wk), dtype=bool)
    out = np.full(max(0, Wk), INVALID_U32, dtype=np.uint32)
    ovf = np.zeros(max(0, Wk), dtype=bool)
    if Wk <= 0:
        return hit, out, ovf
    minval, left, right = _window_minimizers(codes, k, m)
    flo, fhi, rlo, rhi, okw = window_packings_lsb(codes, k)
    km_m, _mv = K.pack_kmers(codes, m)
    tf = np.ones(len(codes), dtype=bool)
    if len(km_m):
        tf[: len(km_m)] = km_m <= K.revcomp_packed(km_m, m)
    lo_mask = np.uint32(0xFFFFFFFF) if 2 * k >= 32 else np.uint32((1 << (2 * k)) - 1)
    hi_mask = np.uint32((1 << (2 * k - 32)) - 1) if 2 * k > 32 else np.uint32(0)
    for p in range(Wk):
        if not okw[p] or minval[p] == 0xFFFFFFFF:
            continue
        cands, gated = _probe_candidates(
            d, p, minval, left, right, tf if budget is not None else None)
        nv = len(cands) if budget is None else min(budget, len(cands))
        for q, cs, orient in cands[:nv]:
            if _verify(d, q, orient, flo[p], fhi[p], rlo[p], rhi[p], lo_mask, hi_mask):
                hit[p], out[p] = True, cs
                break
        if not hit[p] and (gated or budget is None):
            # skew route (device gates it on need_sec; ungated windows can
            # never hold a skew key, so the exact path may probe freely)
            klo, khi = canonical_lsb_np(
                flo[p : p + 1], fhi[p : p + 1], rlo[p : p + 1], rhi[p : p + 1]
            )
            cnt2, pairs_i, pairs_s = skew_candidates_host(d.sec_table, klo, khi)
            sids = [int(s) for ps in pairs_s for s in ps]
            if budget is not None:
                sids = sids[:SKEW_CAND]
            flat = d.slots.reshape(-1, 3)
            tie = False
            for sid in sids:
                wlo, cs, ms = flat[sid]
                sp = (int(ms) >> 8) & 0x7F
                mo = int(ms) & 0xFF
                st = (int(ms) >> 31) & 1
                mpos = int(wlo) + mo
                qf = mpos - int(left[p])
                qr = mpos - (k - m) + int(right[p])
                if budget is None:
                    # exact: verify both orientations, no strand filter
                    for orient, q in ((0, qf), (1, qr)):
                        if (sp > 0 and int(wlo) <= q < int(wlo) + sp
                                and not hit[p]):
                            if _verify(d, q, orient, flo[p], fhi[p], rlo[p],
                                       rhi[p], lo_mask, hi_mask):
                                hit[p], out[p] = True, int(cs)
                    if hit[p]:
                        break
                    continue
                # device-sem mirror: strand filter + fused single verify
                # (fwd-derived candidate probed first; an unprobed viable
                # rc on the same candidate reports `tie` -> ovf)
                cand_f = (sp > 0 and int(wlo) <= qf < int(wlo) + sp
                          and int(tf[p + int(left[p])]) == st)
                cand_r = (sp > 0 and int(wlo) <= qr < int(wlo) + sp
                          and int(tf[p + int(right[p])]) != st)
                if not (cand_f or cand_r):
                    continue
                orient, q = (0, qf) if cand_f else (1, qr)
                if _verify(d, q, orient, flo[p], fhi[p], rlo[p], rhi[p],
                           lo_mask, hi_mask):
                    hit[p], out[p] = True, int(cs)
                    break
                if cand_f and cand_r:
                    tie = True
            if (not hit[p] and budget is not None and gated
                    and (int(cnt2[0]) > SKEW_CAND or tie)):
                ovf[p] = True
        if not hit[p] and budget is not None and len(cands) > budget:
            ovf[p] = True
    return hit, out, ovf


def lookup_host_exact(d: MiniDict2, codes: np.ndarray):
    """Exact per-window lookup for one read (unlimited verification; the
    overflow fallback and test oracle). -> (hit, csid)."""
    hit, out, _ = _probe_read(d, codes, budget=None)
    return hit, out


def lookup_host_device_sem(d: MiniDict2, codes: np.ndarray):
    """Host mirror of the DEVICE probe semantics (VERIFY_BUDGET shared
    verify slots): -> (hit, csid, ovf). Must agree with the device kernel
    bit-for-bit; tests compare both against lookup_host_exact."""
    return _probe_read(d, codes, budget=VERIFY_BUDGET)


def probe_windows_host(d: MiniDict2, codes: np.ndarray):
    """Vectorized EXACT lookup over every k-window of a 1-D code array
    (values > 3 invalid). Semantically equal to lookup_host_exact but
    numpy-batched over all windows — the bulk host path (check tooling,
    long-read/overflow fallbacks). -> (hit bool (Wk,), csid u32 (Wk,)).

    NOTE for concatenated multi-unitig text: windows crossing a boundary
    compute minimizers over the concatenation; the caller must mask them."""
    k, m = d.k, d.m
    codes = np.asarray(codes, dtype=np.uint8)
    Wk = len(codes) - k + 1
    hit = np.zeros(max(0, Wk), dtype=bool)
    out = np.full(max(0, Wk), INVALID_U32, dtype=np.uint32)
    if Wk <= 0:
        return hit, out
    minval, left, right = _window_minimizers(codes, k, m)
    flo, fhi, rlo, rhi, okw = window_packings_lsb(codes, k)
    usable = okw & (minval != np.uint32(0xFFFFFFFF))
    lo_mask = np.uint32(0xFFFFFFFF) if 2 * k >= 32 else np.uint32((1 << (2 * k)) - 1)
    hi_mask = np.uint32((1 << (2 * k - 32)) - 1) if 2 * k > 32 else np.uint32(0)

    kk = probe_key(minval)
    base = _fastrange32(kk, d.num_slots) & ~np.int64(ROWW - 1)
    fp = (kk & np.uint32(0x7FFF)).astype(np.uint32)
    flat = d.slots.reshape(-1, 3)
    left64 = left.astype(np.int64)
    right64 = right.astype(np.int64)
    for s in range(SCAN):
        rows = flat[np.minimum(base + s, len(flat) - 1)]
        wlo = rows[:, 0].astype(np.int64)
        cs = rows[:, 1]
        ms = rows[:, 2]
        sp = ((ms >> np.uint32(8)) & np.uint32(0x7F)).astype(np.int64)
        cov = (ms >> np.uint32(15)) & np.uint32(1)
        okc = usable & (sp > 0) & (
            ((ms >> np.uint32(16)) & np.uint32(0x7FFF)) == fp) & (cov == 0)
        mo = (ms & np.uint32(0xFF)).astype(np.int64)
        mpos = wlo + mo
        for q, wl, wh in (
            (mpos - left64, flo, fhi),
            (mpos - (k - m) + right64, rlo, rhi),
        ):
            cand = okc & (q >= wlo) & (q < wlo + sp) & ~hit
            ci = np.flatnonzero(cand)
            if len(ci):
                tlo, thi = extract33_host(d.text32, q[ci])
                ok2 = ((tlo & lo_mask) == wl[ci]) & ((thi & hi_mask) == wh[ci])
                sel = ci[ok2]
                hit[sel] = True
                out[sel] = cs[sel]
    rem = np.flatnonzero(usable & ~hit)
    if len(rem):
        # exact skew route: verify EVERY fp8-matching pointer (the skew
        # table only holds true k-mers, so probing ungated windows is just
        # a guaranteed miss — no gating needed for exactness)
        klo, khi = canonical_lsb_np(flo[rem], fhi[rem], rlo[rem], rhi[rem])
        _cnt2, pairs_i, pairs_s = skew_candidates_host(d.sec_table, klo, khi)
        rhit = np.zeros(len(rem), dtype=bool)
        for pi, ps in zip(pairs_i, pairs_s):
            if not len(pi):
                continue
            act = ~rhit[pi]
            pi, ps = pi[act], ps[act]
            if not len(pi):
                continue
            ent = flat[ps]
            wloe = ent[:, 0].astype(np.int64)
            cse = ent[:, 1]
            mse = ent[:, 2]
            spe = ((mse >> np.uint32(8)) & np.uint32(0x7F)).astype(np.int64)
            moe = (mse & np.uint32(0xFF)).astype(np.int64)
            mpos = wloe + moe
            g = rem[pi]
            for q, wl, wh in (
                (mpos - left64[g], flo[g], fhi[g]),
                (mpos - (k - m) + right64[g], rlo[g], rhi[g]),
            ):
                cand = (spe > 0) & (q >= wloe) & (q < wloe + spe) & ~rhit[pi]
                ci = np.flatnonzero(cand)
                if len(ci):
                    tlo, thi = extract33_host(d.text32, q[ci])
                    ok2 = ((tlo & lo_mask) == wl[ci]) & ((thi & hi_mask) == wh[ci])
                    sel = ci[ok2]
                    rhit[pi[sel]] = True
                    hit[g[sel]] = True
                    out[g[sel]] = cse[sel]
    return hit, out
