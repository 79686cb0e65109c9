"""Query steps (counterparts of fulgor_tpu/ops/pipeline.py's jitted steps).

Plain Python functions that launch the kernels in order on the tensors'
device; on CPU tensors every step runs its plain version. For a mini index
`table` is the (slots, text32, skew) triple of Index.device_tables and
`dparams` the static (m, num_slots) of Index.device_dict; for a cuckoo index
`table` is the (nb, 4) table tensor and `dparams` None, as in fulgor_tpu.

The packed steps take host-packed (codes2, bad) batches (ops/hostpack.py);
the unpacked ones (the array API's) take (B, L) uint8 codes and pack them on
the device with K8 first.

The mini probe of every step goes through query_window_csids_packed, which
picks it as fulgor_tpu's dict_probe_packed does (pipeline.py:107-141):
the run-anchored probe K11 whenever ANCHORED_PROBE is set, whatever the
budget; else the staged probe K10 for a 4-tuple budget (vb1, vb2, sc, RU);
else the one-pass K2 at a 2-tuple (vb, sc) or the default budgets.
"""

from __future__ import annotations

import os

import torch

from .anchored import minidict2_anchored_probe
from .intersect import (
    compact_runs, fi_and, first_set_bits, km_scores, pack_hits, tu_mask,
)
from .lookup import cuckoo_lookup
from .minidict2 import SKEW_CAND, VERIFY_BUDGET
from .prep import pack_codes, window_prep
from .probe import minidict2_probe
from .staged import minidict2_staged_probe

# FULGOR_ANCHORED_PROBE=1: every mini probe is the run-anchored one, the
# deferred redo's included. Read once at import, as fulgor_tpu reads it
# (pipeline.py:23); a caller may set the attribute itself.
ANCHORED_PROBE = os.environ.get("FULGOR_ANCHORED_PROBE", "0") == "1"


def query_window_csids_packed(table, codes2, bad, *, k: int, width: int,
                              dparams, probe_budget=None):
    """K1 -> K2, K10 or K11 (mini), or K7 (cuckoo, dparams None), over a
    packed batch -> (hit, csid, ovf), each (B, Wk) (fulgor_tpu
    pipeline.py:232 and dict_probe_packed :107); the cuckoo table never
    overflows, so its ovf is all false and probe_budget does not apply.
    Also the deferred redo's probe."""
    if dparams is None:
        hit, csid = cuckoo_lookup(table, codes2, bad, width=width, k=k)
        return hit, csid, torch.zeros_like(hit)
    m, num_slots = dparams
    slots, text32, skew = table
    prep = window_prep(codes2, bad, width=width, k=k, m=m)
    kw = dict(k=k, m=m, num_slots=num_slots)
    if ANCHORED_PROBE:
        return minidict2_anchored_probe(slots, text32, skew, prep, **kw)
    if probe_budget is not None and len(probe_budget) == 4:
        vb1, vb2, sc, ru = probe_budget
        return minidict2_staged_probe(slots, text32, skew, prep, vb1=vb1,
                                      vb2=vb2, sc=sc, RU=ru, **kw)
    vb, sc = probe_budget or (VERIFY_BUDGET, SKEW_CAND)
    return minidict2_probe(slots, text32, skew, prep, vb=vb, sc=sc, **kw)


def query_full_intersection_packed(table, dense_bits, codes2, bad, *, k: int,
                                   width: int, dparams, probe_budget=None):
    """K1 -> K2 -> K3 -> (result bits (B, C32) int32, ovf (B,) bool)
    (fulgor_tpu pipeline.py:208). A read maps iff its row is non-empty;
    ovf reads need the exact redo."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    return fi_and(dense_bits, hit, csid), ovf.any(dim=1)


def query_tu_bits_packed(table, dense_bits, codes2, bad, minscore_tab, *,
                         k: int, width: int, num_colors: int, dparams,
                         probe_budget=None):
    """K1 -> K2 -> K4 -> (maskbits (B, C32) int32, ovf (B,) bool): threshold
    union with the >= min-score comparison on the card, the counterpart of
    fulgor_tpu pipeline.py:264 query_tu_lists_packed without its
    first_set_bits lists. minscore_tab: (Wk + 1,) int32, floor(npos * tau)
    made on the host in f64 (the reference rule,
    src/ps_threshold_union.cpp:389)."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    return (tu_mask(dense_bits, hit, csid, minscore_tab, num_colors),
            ovf.any(dim=1))


def query_fi_lists_packed(table, dense_bits, codes2, bad, *, k: int,
                          width: int, T: int, dparams, probe_budget=None):
    """K1 -> K2 (or K7) -> K3 -> K9 -> (count (B,) int32, lists (B, T)
    int32 ascending, 0 past the count, bits (B, C32) int32, ovf (B,) bool)
    (fulgor_tpu pipeline.py:249): full intersection with each read's first
    T colours compacted on the card; the caller fetches `bits` rows only
    for reads whose count passes T."""
    bits, ovf = query_full_intersection_packed(
        table, dense_bits, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    count, lists = first_set_bits(bits, T)
    return count, lists, bits, ovf


def query_tu_lists_packed(table, dense_bits, codes2, bad, minscore_tab, *,
                          k: int, width: int, num_colors: int, T: int,
                          dparams, probe_budget=None):
    """K1 -> K2 (or K7) -> K4 -> K9 -> (count (B,) int32, lists (B, T)
    int32, maskbits (B, C32) int32, ovf (B,) bool) (fulgor_tpu
    pipeline.py:264): threshold union with the passing colours' first T
    ids compacted on the card."""
    maskbits, ovf = query_tu_bits_packed(
        table, dense_bits, codes2, bad, minscore_tab, k=k, width=width,
        num_colors=num_colors, dparams=dparams, probe_budget=probe_budget)
    count, lists = first_set_bits(maskbits, T)
    return count, lists, maskbits, ovf


def query_threshold_union_packed(table, dense_bits, codes2, bad, *, k: int,
                                 width: int, num_colors: int, dparams,
                                 probe_budget=None):
    """K1 -> K2 (or K7) -> K5 -> (scores (B, C) int16, npos (B,) int32, ovf
    (B,) bool) (fulgor_tpu pipeline.py:218): each colour's count of the
    read's positive windows, u16 carried as int16 bit patterns (at most
    Wk <= 1024), and the count of positive windows, for the host to
    threshold."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    _hitw, scores = km_scores(dense_bits, hit, csid, num_colors)
    return scores, hit.sum(dim=1, dtype=torch.int32), ovf.any(dim=1)


def query_kmer_matches_packed2(table, dense_bits, codes2, bad, *, k: int,
                               width: int, num_colors: int, dparams,
                               probe_budget=None):
    """K1 -> K2 -> K5 -> (hitw (B, ceil(Wk/32)) int32, scores (B, C) int16,
    ovf (B,) bool) (fulgor_tpu pipeline.py:363). scores are u16 counts
    carried as int16 bit patterns (at most Wk <= 1024)."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    hitw, scores = km_scores(dense_bits, hit, csid, num_colors)
    return hitw, scores, ovf.any(dim=1)


def query_conservation_runs_packed(table, codes2, bad, *, k: int, width: int,
                                   R: int, dparams, probe_budget=None):
    """K1 -> K2 -> K6 -> (run_csid (B, R) int32, run_start (B, R) int16,
    run_len (B, R) int16, ovf (B,) bool) (fulgor_tpu pipeline.py:287):
    kmer-conservation's (start, length, csid) records, start and length as
    int16 bit patterns of u16; ovf = more than R runs or any probe overflow
    of the read."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    run_csid, run_start, run_len, total, _npos = compact_runs(hit, csid, R)
    return run_csid, run_start, run_len, (total > R) | ovf.any(dim=1)


def query_runs_tu_packed(table, codes2, bad, *, k: int, width: int, R: int,
                         dparams, probe_budget=None):
    """K1 -> K2 -> K6 -> (run_csid (B, R) int32, run_cnt (B, R) int32,
    npos (B,) int32, ovf (B,) bool) (fulgor_tpu pipeline.py:305): the
    threshold-union fetch without device colour data, for the host to
    score; ovf = run or probe overflow."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    run_csid, _start, run_len, total, npos = compact_runs(hit, csid, R)
    return (run_csid, run_len.to(torch.int32), npos,
            (total > R) | ovf.any(dim=1))


def query_distinct_runs_packed(table, codes2, bad, *, k: int, width: int,
                               R: int, dparams, probe_budget=None):
    """K1 -> K2 -> K6 -> (run_csid (B, R) int32, probe_ovf (B,) bool,
    run_ovf (B,) bool, csid (B, Wk) int32) (fulgor_tpu pipeline.py:320):
    --deduplicate's fetch. The two overflows stay apart: a run-overflowed
    read has every window decided, so its row of csid (INVALID where
    negative, left on the device) is exact; a probe-overflowed read needs
    the re-probe."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    run_csid, _start, _len, total, _npos = compact_runs(hit, csid, R)
    return run_csid, ovf.any(dim=1), total > R, csid


def query_conservation_packed(table, codes2, bad, *, k: int, width: int,
                              small_csid: bool, dparams, probe_budget=None):
    """K1 -> K2 (or K7) -> K13 -> (hitw (B, ceil(Wk/32)) int32, csid (B, Wk)
    int32 or, with small_csid, (B, Wk) int16 bit patterns of u16 with 0xFFFF
    where negative, ovf (B,) bool) (fulgor_tpu pipeline.py:347): the
    windows' positivity as bit words and their csids, narrowed when every
    set id fits 16 bits. No engine path of either package calls it."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    hitw, csid16 = pack_hits(hit, csid if small_csid else None)
    return hitw, csid16 if small_csid else csid, ovf.any(dim=1)


# --------------------------------------------------------------------------
# Unpacked steps (the array API): K8 packs the (B, L) codes on the device;
# its words, viewed as bytes, are the host packer's codes2/bad, so the
# packed steps take them unchanged. L is padded with bad bases to a
# multiple of 32 first (bucket widths already are), and the per-window
# outputs are cut back to L - k + 1.
# --------------------------------------------------------------------------


def pack_unpacked(codes):
    """(B, L) uint8 codes -> (codes2, bad, padded width) via K8."""
    B, L = codes.shape
    W = -(-L // 32) * 32
    if W != L:
        codes = torch.cat([codes, codes.new_full((B, W - L), 4)], dim=1)
    words, badw = pack_codes(codes)
    return words.view(torch.uint8), badw.view(torch.uint8), W


def query_window_csids(table, codes, *, k: int, dparams, probe_budget=None):
    """K8 -> K1 -> K2 (or K8 -> K7) -> (hit, csid, ovf), each (B, L-k+1)
    (fulgor_tpu pipeline.py:200)."""
    codes2, bad, W = pack_unpacked(codes)
    Wk = codes.shape[1] - k + 1
    return tuple(t[:, :Wk] for t in query_window_csids_packed(
        table, codes2, bad, k=k, width=W, dparams=dparams,
        probe_budget=probe_budget))


def query_full_intersection(table, dense_bits, codes, *, k: int, dparams,
                            probe_budget=None):
    """K8 -> K1 -> K2 (or K7) -> K3 -> (result bits (B, C32) int32, ovf
    (B,) bool) (fulgor_tpu pipeline.py:179)."""
    codes2, bad, W = pack_unpacked(codes)
    return query_full_intersection_packed(
        table, dense_bits, codes2, bad, k=k, width=W, dparams=dparams,
        probe_budget=probe_budget)


def query_threshold_union(table, dense_bits, codes, *, k: int,
                          num_colors: int, dparams, probe_budget=None):
    """K8 -> K1 -> K2 (or K7) -> K5 -> (scores (B, C) int16 bit patterns of
    u16 counts, npos (B,) int32, ovf (B,) bool) (fulgor_tpu pipeline.py:190,
    whose scores are the same counts as f32)."""
    codes2, bad, W = pack_unpacked(codes)
    return query_threshold_union_packed(
        table, dense_bits, codes2, bad, k=k, width=W, num_colors=num_colors,
        dparams=dparams, probe_budget=probe_budget)
