"""Query steps (counterparts of fulgor_tpu/ops/pipeline.py's jitted steps).

Plain Python functions that launch the kernels in order on the tensors'
device; on CPU tensors every step runs its plain version. `table` is the
(slots, text32, skew) triple of Index.device_tables and `dparams` the
static (m, num_slots) of Index.device_dict, as in fulgor_tpu.
"""

from __future__ import annotations

import torch

from .intersect import compact_runs, fi_and, km_scores, tu_mask
from .minidict2 import SKEW_CAND, VERIFY_BUDGET
from .prep import window_prep
from .probe import minidict2_probe


def query_window_csids_packed(table, codes2, bad, *, k: int, width: int,
                              dparams, probe_budget=None):
    """K1 -> K2 over a packed batch -> (hit, csid, ovf), each (B, Wk)
    (fulgor_tpu pipeline.py:232). Also the deferred redo's probe."""
    m, num_slots = dparams
    vb, sc = probe_budget or (VERIFY_BUDGET, SKEW_CAND)
    slots, text32, skew = table
    prep = window_prep(codes2, bad, width=width, k=k, m=m)
    return minidict2_probe(slots, text32, skew, prep, k=k, m=m,
                           num_slots=num_slots, vb=vb, sc=sc)


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
