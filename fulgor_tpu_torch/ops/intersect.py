"""Colour stage of the query steps: full intersection (kernel K3),
threshold-union scores (kernels K4, K5 and K12), run lists (K6), colour
lists (K9) and hit words (K13).

K3 `fi_and` is the counterpart of fulgor_tpu/ops/intersect.py
full_intersection_windows, its one-hot twin full_intersection_onehot and
its runs twin compact_runs -> full_intersection_runs: all three compute the
AND of the dense bit rows of every positive window of a read, with an
unmapped read (no positive window) all-zero. AND is idempotent, so the
kernel ANDs only the rows of run starts (a positive window whose left
neighbour is not positive with the same csid) — the in-kernel form of
compact_runs, exact with no run budget and no overflow.

K4 `tu_mask` and K5 `km_scores` replace threshold_union_scores_windows
and _onehot: score[b, c] = the number of positive windows of read b whose
colour set holds colour c (every positive window counts, repeats
included). K4 thresholds the scores on the card against a host-made
min-score table, as query_tu_lists_packed does, and packs the mask in
pack_bool_bits' layout; K5 returns the scores as int16 with the windows'
positivity bits, as query_kmer_matches_packed2 does.

K12 `runs_scores` replaces compact_runs -> threshold_union_scores_runs,
the run-weighted form the mesh steps need (parallel/mesh.py): the same
scores from K6's (csid, count) runs, INVALID-padded, gathered from other
cells and scored against a colour shard; `runs_mask` thresholds them as K4
does (the mesh TU), `runs_scores` returns them as int16 (the mesh
kmer-matches).

K6 `compact_runs` replaces mask_positions, _run_bounds, compact_runs and
compact_runs_starts: each read's runs of consecutive positive windows with
equal csid as a run list of a fixed budget R (csid, start, length), with
the read's run count and positive-window count, and, when asked, the read's
hit words in the same launch. It feeds kmer-conservation
(query_conservation_runs_packed), --deduplicate (query_distinct_runs_packed),
query_runs_tu_packed and the mesh's steps (its kmer-matches takes the hit
words).

K9 `first_set_bits` replaces first_set_bits: each (B, C32) result row's
colour count and its first T colour ids, ascending, the lists fetch of
query_fi_lists_packed and query_tu_lists_packed.

K13 `pack_hits` replaces _pack_hits and query_conservation_packed's u16
narrowing: the windows' positivity as bit words, and csid narrowed to u16
(0xFFFF where negative) in the same pass. It shares K6's front end
(csrc/runs.cu).

dense (S, C32), csid (B, Wk) int32 bit patterns, hit (B, Wk) bool. Each
wrapper launches its csrc/ kernel for CUDA tensors and runs the plain
version for CPU tensors; it never falls back.
"""

from __future__ import annotations

import torch

from . import kernels
from .u32 import i32

# the kernels stage one read's windows in shared memory
MAX_WK = 1024
# K6 writes run starts and lengths as u16
MAX_RUN_WK = 65535


def fi_and_plain(dense, hit, csid):
    """Plain PyTorch full intersection (any device): one row gather and AND
    per window."""
    B, Wk = hit.shape
    safe = torch.where(hit, csid.to(torch.int64) & 0xFFFFFFFF, 0)
    out = torch.full((B, dense.shape[1]), -1, dtype=torch.int32,
                     device=dense.device)
    for w in range(Wk):
        out = torch.where(hit[:, w, None], out & dense[safe[:, w]], out)
    return torch.where(hit.any(dim=1)[:, None], out, 0)


def fi_and(dense, hit, csid):
    """AND of the bit rows of each read's positive windows -> (B, C32)."""
    if dense.device.type == "cpu":
        return fi_and_plain(dense, hit, csid)
    if dense.device.type != "cuda":
        raise ValueError(f"fi_and: unsupported device {dense.device}")
    B, Wk = hit.shape
    if (dense.dtype != torch.int32 or csid.dtype != torch.int32
            or hit.dtype != torch.bool or tuple(csid.shape) != (B, Wk)
            or hit.device != dense.device or csid.device != dense.device
            or not (dense.is_contiguous() and hit.is_contiguous()
                    and csid.is_contiguous())):
        raise ValueError("fi_and: dense (S, C32) int32, hit (B, Wk) bool and "
                         "csid (B, Wk) int32, contiguous on one device")
    if not 0 < Wk <= MAX_WK:
        raise ValueError(f"fi_and: needs 0 < Wk <= {MAX_WK} windows a read "
                         f"(the kernel stages them), not {Wk}")
    C32 = dense.shape[1]
    out = torch.empty((B, C32), dtype=torch.int32, device=dense.device)
    if B == 0 or C32 == 0:
        return out.zero_()
    lib = kernels.library()
    rc = lib.fulgor_fi_and(dense.data_ptr(), C32, hit.data_ptr(),
                           csid.data_ptr(), B, Wk, out.data_ptr(),
                           kernels.stream_of(dense))
    kernels.check(rc, "fi_and")
    kernels.launches["fi_and"] += 1
    return out


def pack_bits(mask, words: int):
    """(B, n) bool -> (B, words) int32 bit patterns in pack_bool_bits'
    layout (bit i of a row is bit i & 31 of word i >> 5); bits past n are
    0."""
    B, n = mask.shape
    full = torch.zeros((B, words * 32), dtype=torch.int64, device=mask.device)
    full[:, :n] = mask
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return i32((full.view(B, words, 32) << shifts).sum(dim=2))


def tu_scores_plain(dense, hit, csid, num_colors: int):
    """Plain PyTorch threshold-union scores (any device): per window one
    row gather, unpacked to bits and added where the window is positive.
    -> (B, num_colors) int32."""
    B, Wk = hit.shape
    C32 = dense.shape[1]
    safe = torch.where(hit, csid.to(torch.int64) & 0xFFFFFFFF, 0)
    shifts = torch.arange(32, dtype=torch.int32, device=dense.device)
    acc = torch.zeros((B, C32 * 32), dtype=torch.int32, device=dense.device)
    for w in range(Wk):
        bits = (dense[safe[:, w]][:, :, None] >> shifts) & 1
        acc += bits.reshape(B, C32 * 32) * hit[:, w, None]
    return acc[:, :num_colors]


def tu_mask_plain(dense, hit, csid, minscore, num_colors: int):
    """Plain threshold-union mask: score >= minscore[npos] and npos > 0,
    packed to (B, C32) int32 bit patterns with the pad bits 0."""
    scores = tu_scores_plain(dense, hit, csid, num_colors)
    npos = hit.sum(dim=1)
    need = minscore.to(torch.int64)[npos]
    mask = (scores >= need[:, None]) & (npos > 0)[:, None]
    return pack_bits(mask, dense.shape[1])


def km_scores_plain(dense, hit, csid, num_colors: int):
    """Plain kmer-matches step: (hitw (B, ceil(Wk/32)) int32 bit patterns
    of the windows' positivity, scores (B, num_colors) int16)."""
    Wk = hit.shape[1]
    scores = tu_scores_plain(dense, hit, csid, num_colors)
    return pack_bits(hit, (Wk + 31) // 32), scores.to(torch.int16)


def _check_colour_inputs(name, dense, hit, csid, num_colors):
    B, Wk = hit.shape
    if (dense.dtype != torch.int32 or csid.dtype != torch.int32
            or hit.dtype != torch.bool or tuple(csid.shape) != (B, Wk)
            or hit.device != dense.device or csid.device != dense.device
            or not (dense.is_contiguous() and hit.is_contiguous()
                    and csid.is_contiguous())):
        raise ValueError(f"{name}: dense (S, C32) int32, hit (B, Wk) bool and "
                         "csid (B, Wk) int32, contiguous on one device")
    if not (0 < num_colors <= 32 * dense.shape[1] and 0 < Wk <= MAX_WK):
        raise ValueError(f"{name}: needs 0 < num_colors <= 32 * C32 and "
                         f"0 < Wk <= {MAX_WK}")


def tu_mask(dense, hit, csid, minscore, num_colors: int):
    """Threshold-union mask of each read -> (B, C32) int32 bit patterns:
    colour c is set iff npos > 0 and at least minscore[npos] positive
    windows hold c (npos = the read's positive windows; minscore is the
    (Wk + 1,) int32 table of floor(npos * tau), made on the host)."""
    if dense.device.type == "cpu":
        return tu_mask_plain(dense, hit, csid, minscore, num_colors)
    if dense.device.type != "cuda":
        raise ValueError(f"tu_mask: unsupported device {dense.device}")
    _check_colour_inputs("tu_mask", dense, hit, csid, num_colors)
    B, Wk = hit.shape
    if (minscore.dtype != torch.int32 or tuple(minscore.shape) != (Wk + 1,)
            or minscore.device != dense.device
            or not minscore.is_contiguous()):
        raise ValueError("tu_mask: minscore must be a contiguous (Wk + 1,) "
                         "int32 tensor on the tables' device")
    C32 = dense.shape[1]
    out = torch.empty((B, C32), dtype=torch.int32, device=dense.device)
    if B == 0:
        return out
    lib = kernels.library()
    rc = lib.fulgor_tu_mask(dense.data_ptr(), C32, num_colors, hit.data_ptr(),
                            csid.data_ptr(), B, Wk, minscore.data_ptr(),
                            out.data_ptr(), kernels.stream_of(dense))
    kernels.check(rc, "tu_mask")
    kernels.launches["tu_mask"] += 1
    return out


def km_scores(dense, hit, csid, num_colors: int):
    """kmer-matches colour stage -> (hitw (B, ceil(Wk/32)) int32 bit
    patterns, scores (B, num_colors) int16: positive windows holding each
    colour, at most Wk <= 1024)."""
    if dense.device.type == "cpu":
        return km_scores_plain(dense, hit, csid, num_colors)
    if dense.device.type != "cuda":
        raise ValueError(f"km_scores: unsupported device {dense.device}")
    _check_colour_inputs("km_scores", dense, hit, csid, num_colors)
    B, Wk = hit.shape
    hitw = torch.empty((B, (Wk + 31) // 32), dtype=torch.int32,
                       device=dense.device)
    scores = torch.empty((B, num_colors), dtype=torch.int16,
                         device=dense.device)
    if B == 0:
        return hitw, scores
    lib = kernels.library()
    rc = lib.fulgor_km_scores(dense.data_ptr(), dense.shape[1], num_colors,
                              hit.data_ptr(), csid.data_ptr(), B, Wk,
                              scores.data_ptr(), hitw.data_ptr(),
                              kernels.stream_of(dense))
    kernels.check(rc, "km_scores")
    kernels.launches["km_scores"] += 1
    return hitw, scores


def _first_positions(mask, R: int):
    """Window positions of the first R set lanes of each row of a (B, W)
    bool mask -> (B, R) int64, 0 past the row's count."""
    B, _W = mask.shape
    rank = torch.cumsum(mask, dim=1) - 1
    b, w = (mask & (rank < R)).nonzero(as_tuple=True)
    out = torch.zeros((B, R), dtype=torch.int64, device=mask.device)
    out[b, rank[b, w]] = w
    return out


def compact_runs_plain(hit, csid, R: int, hit_words: bool = False):
    """Plain PyTorch run compaction (any device), as fulgor_tpu's
    _run_bounds computes it: run starts and ends by comparing each window
    with its neighbours, their first R positions by a cumulative-sum rank.
    -> (run_csid (B, R) int32, INVALID-padded; run_start, run_len (B, R)
    int16 bit patterns of u16, 0-padded; total (B,) int32, every run of the
    read; npos (B,) int32), and with hit_words the read's hit words as
    pack_hits_plain packs them ((B, ceil(Wk/32)) int32)."""
    B, Wk = hit.shape
    same = hit[:, 1:] & hit[:, :-1] & (csid[:, 1:] == csid[:, :-1])
    cont = torch.zeros_like(hit)
    cont[:, 1:] = same  # window w continues window w - 1's run
    ends = torch.zeros_like(hit)
    ends[:, :-1] = same  # window w + 1 continues window w's run
    is_start, is_end = hit & ~cont, hit & ~ends
    total = is_start.sum(dim=1, dtype=torch.int32)
    spos = _first_positions(is_start, R)
    epos = _first_positions(is_end, R)
    valid = (torch.arange(R, device=hit.device)[None, :] < total[:, None])
    run_csid = torch.where(valid, csid.gather(1, spos.clamp(max=Wk - 1)), -1)
    out = (run_csid, torch.where(valid, spos, 0).to(torch.int16),
           torch.where(valid, epos - spos + 1, 0).to(torch.int16), total,
           hit.sum(dim=1, dtype=torch.int32))
    return out + (pack_hits_plain(hit)[0],) if hit_words else out


def compact_runs(hit, csid, R: int, hit_words: bool = False):
    """Each read's runs of equal csid, the first R of them -> (run_csid
    (B, R) int32, run_start (B, R) int16, run_len (B, R) int16, total (B,)
    int32, npos (B,) int32), and with hit_words the read's hit words
    ((B, ceil(Wk/32)) int32, from the same launch), as compact_runs_plain.
    Overflow is total > R. 1 <= R; R may exceed Wk (fulgor_tpu's
    --deduplicate budget is up to 2 * Wk)."""
    if hit.device.type == "cpu":
        return compact_runs_plain(hit, csid, R, hit_words)
    if hit.device.type != "cuda":
        raise ValueError(f"compact_runs: unsupported device {hit.device}")
    B, Wk = hit.shape
    if (csid.dtype != torch.int32 or hit.dtype != torch.bool
            or tuple(csid.shape) != (B, Wk) or csid.device != hit.device
            or not (hit.is_contiguous() and csid.is_contiguous())):
        raise ValueError("compact_runs: hit (B, Wk) bool and csid (B, Wk) "
                         "int32, contiguous on one device")
    if not (0 < Wk <= MAX_RUN_WK and R >= 1):
        raise ValueError(f"compact_runs: needs 0 < Wk <= {MAX_RUN_WK} and "
                         "R >= 1")
    dev = hit.device
    run_csid = torch.empty((B, R), dtype=torch.int32, device=dev)
    run_start = torch.empty((B, R), dtype=torch.int16, device=dev)
    run_len = torch.empty((B, R), dtype=torch.int16, device=dev)
    total = torch.empty(B, dtype=torch.int32, device=dev)
    npos = torch.empty(B, dtype=torch.int32, device=dev)
    out = (run_csid, run_start, run_len, total, npos)
    if hit_words:
        out += (torch.empty((B, (Wk + 31) // 32), dtype=torch.int32,
                            device=dev),)
    if B == 0:
        return out
    lib = kernels.library()
    args = (hit.data_ptr(), csid.data_ptr(), B, Wk, R,
            *(t.data_ptr() for t in out))
    rc = (lib.fulgor_compact_runs_hits if hit_words
          else lib.fulgor_compact_runs)(*args, kernels.stream_of(hit))
    kernels.check(rc, "compact_runs")
    kernels.launches["compact_runs"] += 1
    return out


def _popcount(x):
    """Set bits of each u32 held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def first_set_bits_plain(bits, T: int):
    """Plain PyTorch first_set_bits (any device), as fulgor_tpu computes it,
    in int64: the words' popcounts and their cumulative sum; for each slot
    t the word holding the row's t-th set bit (the count of cumulative sums
    <= t) and the bit's place in that word by a 5-step binary search.
    -> (count (B,) int32, lists (B, T) int32, 0 past the count)."""
    B, C32 = bits.shape
    dev = bits.device
    if C32 == 0:
        return (torch.zeros(B, dtype=torch.int32, device=dev),
                torch.zeros((B, T), dtype=torch.int32, device=dev))
    words = bits.to(torch.int64) & 0xFFFFFFFF
    pc = _popcount(words)
    cum = torch.cumsum(pc, dim=1)
    total = cum[:, -1]
    t = torch.arange(T, dtype=torch.int64, device=dev).expand(B, T)
    widx = torch.searchsorted(cum, t.contiguous(), right=True).clamp(
        max=C32 - 1)
    w = words.gather(1, widx)
    j = t - (cum - pc).gather(1, widx)
    posn = torch.zeros_like(w)
    for width in (16, 8, 4, 2, 1):
        low = (1 << width) - 1
        c = _popcount(w & low)
        hi = j >= c
        j = torch.where(hi, j - c, j)
        posn = posn + torch.where(hi, width, 0)
        w = torch.where(hi, w >> width, w & low)
    lists = torch.where(t < total[:, None], widx * 32 + posn, 0)
    return total.to(torch.int32), lists.to(torch.int32)


def first_set_bits(bits, T: int):
    """Each row's colour count and first T colour ids, ascending ->
    (count (B,) int32, may exceed T; lists (B, T) int32, 0 past the
    count). bits: (B, C32) int32 bit patterns of u32 words."""
    if bits.device.type == "cpu":
        return first_set_bits_plain(bits, T)
    if bits.device.type != "cuda":
        raise ValueError(f"first_set_bits: unsupported device {bits.device}")
    if bits.dim() != 2 or bits.dtype != torch.int32 or not bits.is_contiguous():
        raise ValueError("first_set_bits: bits must be a contiguous (B, C32) "
                         "int32 tensor")
    if T < 1:
        raise ValueError("first_set_bits: needs T >= 1")
    B, C32 = bits.shape
    count = torch.empty(B, dtype=torch.int32, device=bits.device)
    lists = torch.empty((B, T), dtype=torch.int32, device=bits.device)
    if B == 0 or C32 == 0:
        return count.zero_(), lists.zero_()
    lib = kernels.library()
    rc = lib.fulgor_first_set_bits(bits.data_ptr(), B, C32, T,
                                   count.data_ptr(), lists.data_ptr(),
                                   kernels.stream_of(bits))
    kernels.check(rc, "first_set_bits")
    kernels.launches["first_set_bits"] += 1
    return count, lists


def _run_weights(run_cnt):
    """K6's int16 run lengths (u16 bit patterns) or int32 counts -> int32."""
    if run_cnt.dtype == torch.int16:
        return run_cnt.to(torch.int32) & 0xFFFF
    return run_cnt.to(torch.int32)


def runs_scores_plain(dense, run_csid, run_cnt, num_colors: int):
    """Plain PyTorch run-weighted scores (any device), as fulgor_tpu's
    threshold_union_scores_runs: per run column one row gather, unpacked to
    bits and added times the run's count where the run is valid (csid not
    INVALID). -> (B, num_colors) int32."""
    B, _R = run_csid.shape
    C32 = dense.shape[1]
    valid = run_csid != -1
    safe = torch.where(valid, run_csid.to(torch.int64) & 0xFFFFFFFF, 0)
    w = torch.where(valid, _run_weights(run_cnt), 0)
    shifts = torch.arange(32, dtype=torch.int32, device=dense.device)
    acc = torch.zeros((B, C32 * 32), dtype=torch.int32, device=dense.device)
    for r in valid.any(dim=0).nonzero().flatten().tolist():
        bits = (dense[safe[:, r]][:, :, None] >> shifts) & 1
        acc += bits.reshape(B, C32 * 32) * w[:, r, None]
    return acc[:, :num_colors]


def runs_mask_plain(dense, run_csid, run_cnt, npos, minscore,
                    num_colors: int):
    """Plain run-weighted threshold-union mask: score >= minscore[npos] and
    npos > 0 (a count past the table passes nothing), packed to (B, C32)
    int32 bit patterns with the colours from num_colors on 0."""
    scores = runs_scores_plain(dense, run_csid, run_cnt, num_colors)
    npos = npos.to(torch.int64)
    n_ms = minscore.shape[0]
    need = torch.where(npos < n_ms,
                       minscore.to(torch.int64)[npos.clamp(max=n_ms - 1)],
                       1 << 40)
    mask = (scores >= need[:, None]) & (npos > 0)[:, None]
    return pack_bits(mask, dense.shape[1])


def _check_runs_inputs(name, dense, run_csid, run_cnt, num_colors):
    B, R = run_csid.shape
    if (dense.dtype != torch.int32 or run_csid.dtype != torch.int32
            or run_cnt.dtype not in (torch.int16, torch.int32)
            or tuple(run_cnt.shape) != (B, R)
            or run_csid.device != dense.device
            or run_cnt.device != dense.device
            or not (dense.is_contiguous() and run_csid.is_contiguous()
                    and run_cnt.is_contiguous())):
        raise ValueError(f"{name}: dense (S, C32) int32, run_csid (B, R) int32 "
                         "and run_cnt (B, R) int16 or int32, contiguous on "
                         "one device")
    if not (0 <= num_colors <= 32 * dense.shape[1] and 0 < R <= MAX_WK):
        raise ValueError(f"{name}: needs 0 <= num_colors <= 32 * C32 and "
                         f"0 < R <= {MAX_WK}")


def _launch_runs_scores(dense, run_csid, run_cnt, num_colors, npos, minscore,
                        out):
    lib = kernels.library()
    B, R = run_csid.shape
    rc = lib.fulgor_runs_scores(
        dense.data_ptr(), dense.shape[1], num_colors, run_csid.data_ptr(),
        run_cnt.data_ptr(), run_cnt.element_size(), B, R,
        None if npos is None else npos.data_ptr(),
        None if minscore is None else minscore.data_ptr(),
        0 if minscore is None else minscore.shape[0], out.data_ptr(),
        kernels.stream_of(dense))
    kernels.check(rc, "runs_scores")
    kernels.launches["runs_scores"] += 1
    return out


def runs_scores(dense, run_csid, run_cnt, num_colors: int):
    """Run-weighted scores of each read (K12, u16 mode) -> (B, num_colors)
    int16 bit patterns of u16: over the read's valid runs, the run's count
    where its colour set holds the colour. The counts of one read sum to at
    most its window count."""
    if dense.device.type == "cpu":
        return runs_scores_plain(dense, run_csid, run_cnt,
                                 num_colors).to(torch.int16)
    if dense.device.type != "cuda":
        raise ValueError(f"runs_scores: unsupported device {dense.device}")
    _check_runs_inputs("runs_scores", dense, run_csid, run_cnt, num_colors)
    out = torch.empty((run_csid.shape[0], num_colors), dtype=torch.int16,
                      device=dense.device)
    if out.numel() == 0:
        return out
    return _launch_runs_scores(dense, run_csid, run_cnt, num_colors, None,
                               None, out)


def runs_mask(dense, run_csid, run_cnt, npos, minscore, num_colors: int):
    """Run-weighted threshold-union mask (K12, mask mode) -> (B, C32) int32
    bit patterns: colour c < num_colors is set iff npos > 0 and its
    run-weighted score reaches minscore[npos] (npos (B,) int32, the read's
    positive windows; minscore 1-D int32, floor(npos * tau) made on the
    host)."""
    if dense.device.type == "cpu":
        return runs_mask_plain(dense, run_csid, run_cnt, npos, minscore,
                               num_colors)
    if dense.device.type != "cuda":
        raise ValueError(f"runs_mask: unsupported device {dense.device}")
    _check_runs_inputs("runs_mask", dense, run_csid, run_cnt, num_colors)
    B = run_csid.shape[0]
    if (tuple(npos.shape) != (B,) or minscore.dim() != 1
            or minscore.shape[0] == 0
            or any(t.dtype != torch.int32 or t.device != dense.device
                   or not t.is_contiguous() for t in (npos, minscore))):
        raise ValueError("runs_mask: npos (B,) and minscore (n > 0,) must be "
                         "contiguous int32 tensors on the tables' device")
    out = torch.empty((B, dense.shape[1]), dtype=torch.int32,
                      device=dense.device)
    if B == 0:
        return out
    return _launch_runs_scores(dense, run_csid, run_cnt, num_colors, npos,
                               minscore, out)


def pack_hits_plain(hit, csid=None):
    """Plain hit words (any device): (hitw (B, ceil(Wk/32)) int32 in
    pack_bool_bits' layout, csid16 (B, Wk) int16 bit patterns of u16 —
    csid's low 16 bits where hit, 0xFFFF where not — or None without
    csid)."""
    Wk = hit.shape[1]
    hitw = pack_bits(hit, (Wk + 31) // 32)
    if csid is None:
        return hitw, None
    v = torch.where(hit, csid, 0xFFFF) & 0xFFFF
    return hitw, torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16)


def pack_hits(hit, csid=None):
    """Each read's window positivity as bit words, and with csid its window
    csids narrowed to u16 in the same pass (K13) -> (hitw (B, ceil(Wk/32))
    int32, csid16 (B, Wk) int16 or None), as pack_hits_plain."""
    if hit.device.type == "cpu":
        return pack_hits_plain(hit, csid)
    if hit.device.type != "cuda":
        raise ValueError(f"pack_hits: unsupported device {hit.device}")
    B, Wk = hit.shape
    if (hit.dtype != torch.bool or not hit.is_contiguous()
            or (csid is not None
                and (csid.dtype != torch.int32 or tuple(csid.shape) != (B, Wk)
                     or csid.device != hit.device
                     or not csid.is_contiguous()))):
        raise ValueError("pack_hits: hit (B, Wk) bool and csid (B, Wk) int32, "
                         "contiguous on one device")
    hitw = torch.empty((B, (Wk + 31) // 32), dtype=torch.int32,
                       device=hit.device)
    csid16 = (None if csid is None else
              torch.empty((B, Wk), dtype=torch.int16, device=hit.device))
    if B == 0 or Wk == 0:
        return hitw.zero_(), csid16
    lib = kernels.library()
    rc = lib.fulgor_pack_hits(hit.data_ptr(),
                              None if csid is None else csid.data_ptr(), B, Wk,
                              hitw.data_ptr(),
                              None if csid16 is None else csid16.data_ptr(),
                              kernels.stream_of(hit))
    kernels.check(rc, "pack_hits")
    kernels.launches["pack_hits"] += 1
    return hitw, csid16
