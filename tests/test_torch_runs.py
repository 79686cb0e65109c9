"""Run compaction (kernel K6): the port's plain PyTorch version against
fulgor_tpu's compact_runs and compact_runs_starts, bit-exact (tolerance 0),
at widths around the 32-window chunk of the kernel and its group of eight
chunks, and at run budgets from 1 to twice the window count; its hit words
(the mesh's kmer-matches takes them) against fulgor_tpu's _pack_hits and
the mesh step's padded pack_bool_bits.

Each batch holds all-miss rows, one-csid rows, runs that cross the
32-window boundary, a csid that recurs after another run and after a miss,
and rows with more than R runs (whose first R runs must match).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import intersect as J
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu_torch.ops.intersect import compact_runs

from tests.test_torch_threads import one_thread  # noqa: F401

B = 64
INV = np.uint32(0xFFFFFFFF)
CASES = [(wk, r, words) for wk in (1, 31, 32, 33, 130, 257)
         for r in sorted({1, 2, 16, wk, 2 * wk}) for words in (False, True)]


def _inputs(Wk, seed):
    rng = np.random.default_rng(seed)
    csid = np.empty((B, Wk), np.uint32)
    for b in range(B):
        run = rng.integers(1, 3 if b % 4 == 0 else 20, size=Wk)
        vals = rng.integers(0, 3 if b % 2 else 1000, size=Wk)
        csid[b] = np.repeat(vals, run)[:Wk]
    hit = rng.random((B, Wk)) < 0.8
    hit[:3] = False  # unmapped reads
    hit[3:6] = True
    csid[3] = 7  # one run over the whole read
    csid[4, : Wk // 2], csid[4, Wk // 2:] = 5, 9
    if Wk > 33:  # runs across the window-32 boundary, a csid that recurs
        csid[5, 20:40], csid[5, 40:50], csid[5, 50:70] = 11, 12, 11
        hit[6, 28:36] = True
        csid[6, 28:36] = 13
        hit[6, 31] = False  # 13 again right after a miss
    csid[~hit] = INV
    return hit, csid


@pytest.mark.parametrize("Wk,R,words", CASES)
def test_compact_runs_matches_jax(Wk, R, words):
    hit, csid = _inputs(Wk, seed=Wk * 1000 + R)
    got = [t.numpy() for t in compact_runs(torch.from_numpy(hit),
                                           torch.from_numpy(csid.view(np.int32)),
                                           R, words)]
    assert len(got) == 5 + words
    run_csid, run_start, run_len, total, npos = got[:5]
    if words:  # (B, ceil(Wk/32)) words, bits past Wk clear
        hitw = got[5].view(np.uint32)
        assert hitw.shape == (B, (Wk + 31) // 32)
        np.testing.assert_array_equal(
            hitw, np.asarray(JP._pack_hits(jnp.asarray(hit))))
        padded = np.pad(hit, ((0, 0), (0, (-Wk) % 32)))
        np.testing.assert_array_equal(
            hitw, np.asarray(J.pack_bool_bits(jnp.asarray(padded))))
    assert run_csid.shape == run_start.shape == run_len.shape == (B, R)
    jh, jc = jnp.asarray(hit), jnp.asarray(csid)
    rc, cnt, ovf = (np.asarray(a) for a in J.compact_runs(jh, jc, R))
    rc2, spos, ln, ovf2 = (np.asarray(a)
                           for a in J.compact_runs_starts(jh, jc, R))
    np.testing.assert_array_equal(run_csid.view(np.uint32), rc)
    np.testing.assert_array_equal(run_csid.view(np.uint32), rc2)
    np.testing.assert_array_equal(run_len.view(np.uint16), cnt)
    np.testing.assert_array_equal(run_len.view(np.uint16), ln)
    np.testing.assert_array_equal(run_start.view(np.uint16), spos)
    np.testing.assert_array_equal(total > R, ovf)
    np.testing.assert_array_equal(total > R, ovf2)
    np.testing.assert_array_equal(npos, hit.sum(axis=1))
    # total counts every run, also past R: the starts of runs
    starts = hit.copy()
    starts[:, 1:] &= ~(hit[:, :-1] & (csid[:, 1:] == csid[:, :-1]))
    np.testing.assert_array_equal(total, starts.sum(axis=1))
    assert (total[:3] == 0).all() and (run_csid[:3] == -1).all()
    assert total[3] == 1 and run_len[3, 0] == Wk
    if R < Wk:
        assert (total > R).any() and (total <= R).any()
    if Wk > 33 and R >= max(total[5], total[6]):
        recs = [list(zip(run_start[b].tolist(), run_len[b].tolist(),
                         run_csid[b].tolist())) for b in (5, 6)]
        i = recs[0].index((20, 20, 11))
        assert recs[0][i + 1: i + 3] == [(40, 10, 12), (50, 20, 11)]
        assert (28, 3, 13) in recs[1] and (32, 4, 13) in recs[1]


def test_wrapper_refuses_other_devices():
    hit, csid = _inputs(33, seed=0)
    with pytest.raises(ValueError, match="unsupported device"):
        compact_runs(torch.from_numpy(hit).to("meta"),
                     torch.from_numpy(csid.view(np.int32)).to("meta"), 16)
