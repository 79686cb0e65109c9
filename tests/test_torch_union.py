"""Threshold-union scores (kernels K4 and K5): the port's plain PyTorch
versions against fulgor_tpu, bit-exact (tolerance 0).

- scores against threshold_union_scores_windows, _onehot and compact_runs
  -> threshold_union_scores_runs (on rows without run overflow);
- K4's mask against `scores >= table[npos] & npos > 0` -> pack_bool_bits,
  composed as fulgor_tpu's query_tu_lists_packed composes it, at C = 70
  (a ragged last word) and tau down to 0.01 (every colour of a mapped read
  passes, pad bits must stay 0);
- K5's positivity words against _pack_hits;
- both at the kernels' edge shapes (C32 1, 8, 143 with a ragged C; Wk 1,
  33, 1,024; a read scoring 1,024), with a numpy model of K4's bit-sliced
  counts (a ripple add of run length x row word over 11 bit planes, the
  threshold a compare from the top plane) held against the same scores;
- K12's plain versions at its edge shapes (C32 1, 8, 72, 143 x R 1 to
  1,024 run slots) against threshold_union_scores_runs, thresholded and
  packed as the mesh does, with numpy models of its front end (the ballot
  compaction of the valid slots, ranks as prefixes of the counts), its
  truth table, its bit planes sized by a read's total and its spread
  counters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import intersect as J
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu_torch.ops.intersect import (
    km_scores, runs_mask, runs_scores, runs_scores_plain, tu_mask,
)

from tests.test_torch_threads import one_thread  # noqa: F401

S, C, B, WK = 300, 70, 48, 130
C32 = (C + 31) // 32
RUN_BUDGET = 40
TAUS = [0.01, 0.5, 0.7, 0.8, 1.0]
# read 4 has 90 positive windows and colour 0 scores 62 = floor(90 * 0.7)
# in f64; the f32 product 90 * 0.7f rounds up to 63.0
READ_90 = 4


def _inputs(seed=7):
    """Dense rows of mixed density with random pad bits, reads made of
    runs of equal csids (a csid may recur after another run) with gaps of
    negative windows, reads 0-3 unmapped, read 4 built for tau = 0.7."""
    rng = np.random.default_rng(seed)
    dense = rng.integers(0, 1 << 32, size=(S, C32), dtype=np.uint64)
    dense |= rng.integers(0, 1 << 32, size=(S, C32), dtype=np.uint64)
    dense = dense.astype(np.uint32)
    dense[: S // 4] = 0xFFFFFFFF
    csid = np.empty((B, WK), np.uint32)
    for b in range(B):
        run = rng.integers(1, 12, size=WK)
        vals = rng.integers(0, 40 if b % 2 else S, size=WK)
        csid[b] = np.repeat(vals, run)[:WK]
    hit = rng.random((B, WK)) < 0.7
    hit[:4] = False
    hit[8:12] = rng.random((4, WK)) < 0.98  # reads of 120+ positive windows
    dense[S - 2, 0] |= 1
    dense[S - 1, 0] &= ~np.uint32(1)
    hit[READ_90] = False
    hit[READ_90, 10:100] = True
    csid[READ_90, 10:72] = S - 2
    csid[READ_90, 72:100] = S - 1
    csid[~hit] = 0xFFFFFFFF
    return dense, hit, csid


def _torch(dense, hit, csid):
    return (torch.from_numpy(dense.view(np.int32)), torch.from_numpy(hit),
            torch.from_numpy(csid.view(np.int32)))


def _table(tau, Wk=WK):
    """fulgor_tpu's min-score table: floor(npos * tau) in f64."""
    npos = np.arange(Wk + 1, dtype=np.float64)
    return (npos * tau).astype(np.int64).astype(np.int32)


@pytest.mark.parametrize("ref", ["windows", "onehot", "runs"])
def test_scores_match_jax(ref):
    dense, hit, csid = _inputs()
    jd, jh, jc = jnp.asarray(dense), jnp.asarray(hit), jnp.asarray(csid)
    _hitw, got = km_scores(*_torch(dense, hit, csid), C)
    got = got.numpy().astype(np.int64)
    rows = np.ones(B, dtype=bool)
    if ref == "windows":
        want = J.threshold_union_scores_windows(jd, jh, jc, C)
    elif ref == "onehot":
        want = J.threshold_union_scores_onehot(jd, jh, jc, C)
    else:
        run_csid, run_cnt, rovf = J.compact_runs(jh, jc, RUN_BUDGET)
        want = J.threshold_union_scores_runs(jd, run_csid, run_cnt, C)
        rows = ~np.asarray(rovf)
        assert rows.sum() >= B // 4 and (~rows).any()
    want = np.asarray(want).astype(np.int64)
    np.testing.assert_array_equal(got[rows], want[rows])
    assert got[:4].sum() == 0 and got.max() >= 90


@pytest.mark.parametrize("tau", TAUS)
def test_mask_matches_jax(tau):
    dense, hit, csid = _inputs()
    tab = _table(tau)
    got = tu_mask(*_torch(dense, hit, csid), torch.from_numpy(tab), C)
    got = got.numpy().view(np.uint32)
    # query_tu_lists_packed's composition (fulgor_tpu pipeline.py:274-281)
    jh = jnp.asarray(hit)
    scores = J.threshold_union_scores_windows(
        jnp.asarray(dense), jh, jnp.asarray(csid), C)
    npos = jnp.sum(jh.astype(jnp.int32), axis=1)
    ms = jnp.take(jnp.asarray(tab), npos, axis=0)
    mask = (scores >= ms[:, None].astype(scores.dtype)) & (npos > 0)[:, None]
    mask = jnp.pad(mask, ((0, 0), (0, (-C) % 32)))
    want = np.asarray(J.pack_bool_bits(mask))
    np.testing.assert_array_equal(got, want)
    assert not (got[:, -1] >> np.uint32(C % 32)).any()  # pad bits stay 0
    assert got[:4].sum() == 0
    if tau == 0.01:  # floor(npos * 0.01) == 0 up to npos 99: all colours
        full = np.uint32((1 << (C % 32)) - 1)
        assert got[READ_90, -1] == full
        assert (got[READ_90, :-1] == 0xFFFFFFFF).all()


def test_tau_07_floors_in_f64():
    """At npos = 90, tau = 0.7: the f64 table says 62, an f32 product 63;
    read 4's colour 0 scores exactly 62 and passes."""
    assert _table(0.7)[90] == 62
    assert int(np.floor(np.float32(90) * np.float32(0.7))) == 63
    dense, hit, csid = _inputs()
    assert hit[READ_90].sum() == 90
    t = _torch(dense, hit, csid)
    _hitw, scores = km_scores(*t, C)
    assert int(scores[READ_90, 0]) == 62
    got = tu_mask(*t, torch.from_numpy(_table(0.7)), C).numpy().view(np.uint32)
    assert got[READ_90, 0] & 1


def test_hitw_matches_pack_hits():
    dense, hit, csid = _inputs()
    hitw, _scores = km_scores(*_torch(dense, hit, csid), C)
    assert hitw.shape == (B, (WK + 31) // 32)
    np.testing.assert_array_equal(hitw.numpy().view(np.uint32),
                                  np.asarray(JP._pack_hits(jnp.asarray(hit))))


def test_wrappers_refuse_other_devices():
    dense, hit, csid = (t.to("meta") for t in _torch(*_inputs()))
    with pytest.raises(ValueError, match="unsupported device"):
        km_scores(dense, hit, csid, C)
    with pytest.raises(ValueError, match="unsupported device"):
        tu_mask(dense, hit, csid, torch.zeros(WK + 1, dtype=torch.int32,
                                              device="meta"), C)


PLANES = 11  # K4's bit planes: counts up to 2,047 >= Wk
TABLE_RUNS = 4  # K4 takes a read of at most 4 runs by its truth table


def _edge_inputs(c32, wk, reads=16):
    """reads x wk windows over 400 rows of c32 words (a third holding every
    colour, pad bits included): runs of 1-11 windows of csids from a pool
    of four a read (a csid recurs after other runs), broken by misses that
    keep the run's csid or hold INVALID; reads 0-2 unmapped; read 3
    positive in every window with csid 0 (score wk in every colour); reads
    4-7 of one to four long runs (K4's truth-table reads)."""
    rng = np.random.default_rng(c32 * 7 + wk)
    rows = 400
    dense = (rng.integers(0, 1 << 32, (rows, c32), dtype=np.uint64)
             | rng.integers(0, 1 << 32, (rows, c32), dtype=np.uint64))
    dense[: rows // 3] = 0xFFFFFFFF
    pick = np.repeat(rng.integers(0, 4, reads * wk),
                     rng.integers(1, 12, reads * wk))[: reads * wk]
    csid = np.take_along_axis(rng.integers(0, rows, (reads, 4)),
                              pick.reshape(reads, wk), axis=1)
    csid = csid.astype(np.uint32)
    hit = rng.random((reads, wk)) < 0.8
    hit[:3] = False
    csid[~hit & (rng.random((reads, wk)) < 0.5)] = 0xFFFFFFFF
    hit[3] = True
    csid[3] = 0
    for b in range(4, 8):
        cuts = np.sort(rng.choice(np.arange(1, wk), min(b - 4, wk - 1),
                                  replace=False)) if wk > 1 else []
        hit[b] = True
        csid[b] = np.repeat(rng.integers(0, rows, len(cuts) + 1),
                            np.diff([0, *cuts, wk]))
    return dense.astype(np.uint32), hit, csid


def _runs(hit, csid):
    """The kernels' run lists: a run starts at a positive window whose
    csid is not the window before's where that one is positive, and is as
    long as the positive windows from its start to the next run's.
    -> (run_cs (B, R) int64, run_len (B, R) uint32, nr (B,))."""
    B = hit.shape[0]
    prev = np.zeros_like(hit)
    prev[:, 1:] = hit[:, :-1] & hit[:, 1:] & (csid[:, :-1] == csid[:, 1:])
    starts = hit & ~prev
    rank = np.cumsum(hit, axis=1) - hit  # positive windows before each
    nr = starts.sum(axis=1)
    R = max(int(nr.max()), 1)
    run_cs = np.zeros((B, R), np.int64)
    run_len = np.zeros((B, R), np.uint32)
    for b in range(B):
        s = np.flatnonzero(starts[b])
        ranks = np.append(rank[b, s], hit[b].sum())
        run_cs[b, : len(s)] = csid[b, s]
        run_len[b, : len(s)] = np.diff(ranks)
    return run_cs, run_len, nr


def _bitsliced_counts(dense, hit, csid):
    """K4's counting in numpy: each run adds its length to the count of
    every colour of its row, the counts of a word's 32 colours kept as
    PLANES bit planes and the length added by a ripple add of len x row
    word. -> planes (B, C32, PLANES) uint32."""
    run_cs, run_len, _nr = _runs(hit, csid)
    return _plane_counts(dense, run_cs, run_len, PLANES)


def _plane_counts(dense, run_cs, run_len, nplanes):
    """_bitsliced_counts over given run lists (run_len 0 past a read's
    runs) and nplanes planes -> (B, C32, nplanes) uint32."""
    planes = np.zeros((run_cs.shape[0], dense.shape[1], nplanes), np.uint32)
    for r in range(run_cs.shape[1]):
        w = dense[run_cs[:, r]]
        carry = np.zeros_like(w)
        for p in range(nplanes):
            bit = ((run_len[:, r] >> p) & 1).astype(bool)[:, None]
            add = np.where(bit, w, 0).astype(np.uint32)
            a = planes[:, :, p].copy()
            planes[:, :, p] = a ^ add ^ carry
            carry = (a & add) | (carry & (a ^ add))
    return planes


def _planes_ge(planes, need):
    """Per word, the colours whose bit-sliced count is at least need[b]:
    compared from the top plane (greater where the count has a 1 and need
    a 0 with every plane above equal)."""
    B, C32, nplanes = planes.shape
    gt = np.zeros((B, C32), np.uint32)
    eq = np.full((B, C32), 0xFFFFFFFF, np.uint32)
    for p in range(nplanes - 1, -1, -1):
        one = ((need >> p) & 1).astype(bool)[:, None]
        pl = planes[:, :, p]
        gt = np.where(one, gt, gt | (eq & pl))
        eq = np.where(one, eq & pl, eq & ~pl)
    return np.where((need <= 0)[:, None], np.uint32(0xFFFFFFFF), gt | eq)


def _table_mask(dense, hit, csid, need):
    """K4's truth table for a read of at most TABLE_RUNS runs: T[q] says
    whether the runs of pattern q (bit r: run r) reach need, and each
    word is T looked up colour by colour by a multiplexer tree over the
    runs' row words. -> (words (B, C32) uint32, which reads it serves)."""
    run_cs, run_len, nr = _runs(hit, csid)
    out, served = _table_words(dense, run_cs, run_len, nr, need)
    return out, served & (nr > 0)


def _table_words(dense, run_cs, run_len, nr, need):
    """_table_mask over given run lists: every read of at most TABLE_RUNS
    runs (none included). -> (words (B, C32) uint32, served)."""
    served = nr <= TABLE_RUNS
    out = np.zeros((len(nr), dense.shape[1]), np.uint32)
    for b in np.flatnonzero(served):
        q = np.arange(16)
        s = sum((((q >> r) & 1) * int(run_len[b, r]) for r in range(nr[b])),
                np.zeros(16, np.int64))
        leaves = [np.uint32(0xFFFFFFFF) if t else np.uint32(0)
                  for t in s >= need[b]]
        x = [dense[run_cs[b, r]] if r < nr[b] else np.zeros_like(dense[0])
             for r in range(TABLE_RUNS)]
        level = [np.full_like(x[0], v) for v in leaves]
        for r in range(TABLE_RUNS):  # b0 selects between leaves 2k, 2k + 1
            level = [(x[r] & level[2 * k + 1]) | (~x[r] & level[2 * k])
                     for k in range(len(level) // 2)]
        out[b] = level[0]
    return out, served


def _spread_counts(dense, hit, csid, C):
    """K5's counting in numpy: two colours' counts a 32-bit word as 16-bit
    fields, a run adding len x the spread of each byte of its row (bit 2k
    to the low field of word k, bit 2k + 1 to the high one). -> (B, C)."""
    run_cs, run_len, _nr = _runs(hit, csid)
    return _spread_runs(dense, run_cs, run_len, C)


def _spread_runs(dense, run_cs, run_len, C):
    """_spread_counts over given run lists -> (B, C) int64, each score
    mod 2^16 where no score passes 65,535."""
    B, C32 = run_cs.shape[0], dense.shape[1]
    x = np.arange(256, dtype=np.uint32)[:, None]
    k = np.arange(4, dtype=np.uint32)[None, :]
    spread = ((x >> (2 * k)) & 1) | (((x >> (2 * k + 1)) & 1) << 16)
    acc = np.zeros((B, C32 * 4, 4), np.uint32)  # (byte of the row, word k)
    for r in range(run_cs.shape[1]):
        row = dense[run_cs[:, r]]
        byte = (row[:, :, None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF
        acc += spread[byte.reshape(B, -1)] * run_len[:, r, None, None]
    lo, hi = acc & 0xFFFF, acc >> 16
    return np.stack([lo, hi], axis=-1).reshape(B, -1)[:, :C].astype(np.int64)


@pytest.mark.parametrize("c32", [1, 8, 143])
@pytest.mark.parametrize("wk", [1, 33, 1024])
def test_edge_shapes(c32, wk):
    """The kernels' edge shapes: C32 of one word, a mesh shard's 8 and the
    4,546-colour index's 143, each with a ragged C = 32 C32 - 5; one
    window, a window past a warp and the kernels' 1,024. Plain K5 against
    threshold_union_scores_windows and _pack_hits, plain K4 at tau 0.01
    (need 0 below 100 positive windows), 0.8 and 1.0 against
    query_tu_lists_packed's composition; and numpy models of the kernels'
    arithmetic against the same scores and masks: K5's packed spread
    counts, K4's bit-sliced counts and compare, and K4's truth table on
    the reads of at most four runs."""
    C = 32 * c32 - 5
    dense, hit, csid = _edge_inputs(c32, wk)
    scores = np.asarray(J.threshold_union_scores_windows(
        jnp.asarray(dense), jnp.asarray(hit), jnp.asarray(csid), C))
    scores = scores.astype(np.int64)
    t = _torch(dense, hit, csid)
    hitw, got = km_scores(*t, C)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), scores)
    np.testing.assert_array_equal(hitw.numpy().view(np.uint32),
                                  np.asarray(JP._pack_hits(jnp.asarray(hit))))
    assert not scores[:3].any() and (scores[3] == wk).all()
    np.testing.assert_array_equal(_spread_counts(dense, hit, csid, C), scores)

    planes = _bitsliced_counts(dense, hit, csid)
    weights = (1 << np.arange(PLANES, dtype=np.int64))
    unpacked = (planes[:, :, None, :] >> np.arange(32, dtype=np.uint32)[
        None, None, :, None]) & 1
    model = (unpacked.astype(np.int64) * weights).sum(axis=3)
    np.testing.assert_array_equal(model.reshape(len(hit), -1)[:, :C], scores)

    npos = hit.sum(axis=1)
    pad = np.zeros((len(hit), 32 * c32), dtype=bool)
    colour = np.array([(1 << min(max(C - 32 * j, 0), 32)) - 1
                       for j in range(c32)], np.uint64).astype(np.uint32)
    for tau in (0.01, 0.8, 1.0):
        tab = _table(tau, wk)
        need = tab[npos].astype(np.int64)
        pad[:, :C] = (scores >= need[:, None]) & (npos > 0)[:, None]
        want = np.asarray(J.pack_bool_bits(jnp.asarray(pad)))
        got = tu_mask(*t, torch.from_numpy(tab), C).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)
        ge = _planes_ge(planes, need) & colour
        np.testing.assert_array_equal(
            np.where((npos > 0)[:, None], ge, np.uint32(0)), want)
        table, served = _table_mask(dense, hit, csid, need)
        assert served[3:8].all()
        np.testing.assert_array_equal((table & colour)[served], want[served])
        if tau == 0.01 and wk < 100:  # need 0: every colour below C
            assert (want[npos > 0] == colour).all()


# K12's edge shapes (C32, R): one word, a mesh shard's 8 and the 4,546-colour
# index's 72-word shard and 143 words; one slot, a slot past a warp, the
# (2, 2) grid's 130 and the kernel's 1,024
K12_SHAPES = [(1, 1), (1, 1024), (8, 33), (8, 130), (72, 130), (143, 1024)]
NPOS_MAX = 3000  # the npos table's last entry in these batches
INVALID = 0xFFFFFFFF


def _slot_inputs(c32, R, reads=24):
    """reads x R run slots over 400 rows of c32 words (a third all ones,
    pad bits included), as the mesh gathers them: each read's valid runs
    scattered among INVALID slots, csids from a pool of four a read (a
    csid recurs). Reads 0-2 hold no valid run, 3-7 one to four, the rest
    any number up to R; int32 counts by read mod 4: 1-11, summing to
    1,024, 100-3,000 (totals past 2,047), 0-8,191 (totals past 65,535 and
    below 2^23, where fulgor_tpu's f32 sums are exact), and -8,191 to -1
    in reads 11 and 19 (a run at least). npos: the total clipped to [1,
    NPOS_MAX],
    but 0 in reads 0-1, 50 in read 2 (positive windows, no valid run) and
    past the table in reads 8 and 16. -> (dense u32, run_csid u32, counts
    int32, npos int32)."""
    rng = np.random.default_rng(c32 * 13 + R)
    rows = 400
    dense = (rng.integers(0, 1 << 32, (rows, c32), dtype=np.uint64)
             | rng.integers(0, 1 << 32, (rows, c32), dtype=np.uint64))
    dense[: rows // 3] = 0xFFFFFFFF
    nvalid = rng.integers(0, R + 1, reads)
    nvalid[:3] = 0
    nvalid[3:8] = np.minimum(np.arange(5) % 4 + 1, R)
    nvalid[[11, 19]] = np.maximum(nvalid[[11, 19]], 1)
    rc = np.full((reads, R), INVALID, np.uint32)
    cnt = np.zeros((reads, R), np.int32)
    for b in range(reads):
        n = int(nvalid[b])
        slots = rng.choice(R, n, replace=False)
        rc[b, slots] = rng.integers(0, rows, 4)[rng.integers(0, 4, n)]
        if b in (11, 19):
            c = -rng.integers(1, 8192, n)
        elif b % 4 == 0:
            c = rng.integers(1, 12, n)
        elif b % 4 == 1 and n:
            cuts = np.sort(rng.choice(np.arange(1, 1024), n - 1,
                                      replace=False))
            c = np.diff([0, *cuts, 1024])
        elif b % 4 == 2:
            c = rng.integers(100, 3001, n)
        else:
            c = rng.integers(0, 8192, n)
        cnt[b, slots] = c
    npos = np.clip(cnt.astype(np.int64).sum(axis=1), 1, NPOS_MAX)
    npos[:2] = 0
    npos[2] = 50
    npos[[8, 16]] = NPOS_MAX + 1 + np.arange(2)
    return dense.astype(np.uint32), rc, cnt, npos.astype(np.int32)


def _slot_runs(rc, weights):
    """K12's front end in numpy: the slots taken 32 at a time; a ballot of
    the valid ones places each at the runs so far plus its valid lanes
    below, and an inclusive scan of the weights (0 where invalid) ranks
    it. -> (run_cs (B, R) int64 and run_len (B, R) int64 in slot order, 0
    past the runs; nr (B,); total (B,))."""
    B, R = rc.shape
    run_cs = np.zeros((B, R), np.int64)
    rank = np.zeros((B, R + 1), np.int64)
    nr = np.zeros(B, np.int64)
    total = np.zeros(B, np.int64)
    for i0 in range(0, R, 32):
        valid = rc[:, i0:i0 + 32] != INVALID
        v = np.where(valid, weights[:, i0:i0 + 32], 0).astype(np.int64)
        incl = np.cumsum(v, axis=1)
        below = np.cumsum(valid, axis=1) - valid
        for b in range(B):
            at = nr[b] + below[b][valid[b]]
            run_cs[b, at] = rc[b, i0:i0 + 32][valid[b]]
            rank[b, at] = (total[b] + incl[b] - v[b])[valid[b]]
        nr += valid.sum(axis=1)
        total += incl[:, -1]
    rank[np.arange(B), nr] = total
    run_len = np.diff(rank, axis=1)
    run_len[np.arange(R)[None, :] >= nr[:, None]] = 0
    return run_cs, run_len, nr, total


@pytest.mark.parametrize("c32, R", K12_SHAPES)
def test_runs_edge_shapes(c32, R):
    """K12's edge shapes (C32 x R with a ragged C = 32 C32 - 5; reads of no
    valid run, of 1-4 and of more; valid runs scattered among INVALID
    slots; a csid that recurs; counts summing to 1,024 and past 2,047 and
    65,535, negative int32 ones; npos 0 and past the table): plain K12 in
    u16 mode (int32 and K6's int16 counts) against threshold_union_scores_
    runs, and in mask mode at tau 0.01, 0.8 and 1.0 against those scores
    thresholded and packed as the mesh does; then numpy models of the
    kernel's arithmetic against the same scores and words: the ballot
    compaction in slot order with ranks as prefixes of the counts, the
    truth table on reads of at most four runs, bit planes sized by the
    read's total (counts up to 2,047), and the spread counters of u16 mode
    (totals up to 65,535)."""
    C = 32 * c32 - 5
    dense, rc, cnt, npos = _slot_inputs(c32, R)
    jd, jrc = jnp.asarray(dense), jnp.asarray(rc)
    want = np.asarray(J.threshold_union_scores_runs(
        jd, jrc, jnp.asarray(cnt), C)).astype(np.int64)
    low16 = cnt & 0xFFFF
    want16 = np.asarray(J.threshold_union_scores_runs(
        jd, jrc, jnp.asarray(low16), C)).astype(np.int64)
    d_t, rc_t = torch.from_numpy(dense.view(np.int32)), torch.from_numpy(
        rc.view(np.int32))
    c32_t = torch.from_numpy(cnt)
    c16_t = torch.from_numpy(low16.astype(np.uint16).view(np.int16))
    np.testing.assert_array_equal(
        runs_scores_plain(d_t, rc_t, c32_t, C).numpy(), want)
    # K6's int16 counts weigh as u16: the int32 sums of the low 16 bits,
    # fulgor_tpu's f32 sums exact where the total is below 2^24
    got16 = runs_scores_plain(d_t, rc_t, c16_t, C).numpy()
    np.testing.assert_array_equal(got16, runs_scores_plain(
        d_t, rc_t, torch.from_numpy(low16), C).numpy())
    exact = low16.astype(np.int64).sum(axis=1) < 1 << 24
    np.testing.assert_array_equal(got16[exact], want16[exact])
    for c_t, w in ((c32_t, want), (c16_t, got16)):  # u16 mode: mod 2^16
        got = runs_scores(d_t, rc_t, c_t, C).numpy()
        np.testing.assert_array_equal(got, (w & 0xFFFF).astype(np.uint16)
                                      .view(np.int16))
    assert not want[:3].any() and (want[[11, 19]] < 0).any()

    run_cs, run_len, nr, total = _slot_runs(rc, cnt)
    for b in range(len(rc)):  # slot order; each weighs its count
        valid = rc[b] != INVALID
        np.testing.assert_array_equal(run_cs[b, : nr[b]], rc[b][valid])
        np.testing.assert_array_equal(run_len[b, : nr[b]], cnt[b][valid])
    assert (nr[3:8] == np.minimum(np.arange(5) % 4 + 1, R)).all()

    colour = np.array([(1 << min(max(C - 32 * j, 0), 32)) - 1
                       for j in range(c32)], np.uint64).astype(np.uint32)
    simple = (run_len >= 0).all(axis=1)  # no negative count
    for tau in (0.01, 0.8, 1.0):
        tab = (np.arange(NPOS_MAX + 1, dtype=np.float64) * tau).astype(
            np.int32)
        inside = (npos > 0) & (npos <= NPOS_MAX)
        need = np.where(inside, tab[np.minimum(npos, NPOS_MAX)], 0).astype(
            np.int64)
        mask = np.zeros((len(rc), 32 * c32), dtype=bool)
        mask[:, :C] = (want >= need[:, None]) & inside[:, None]
        words = np.asarray(J.pack_bool_bits(jnp.asarray(mask)))
        got = runs_mask(d_t, rc_t, c32_t, torch.from_numpy(npos),
                        torch.from_numpy(tab), C).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, words)
        table, served = _table_words(dense, run_cs, run_len, nr, need)
        served &= inside & simple & (total <= 65535)
        np.testing.assert_array_equal((table & colour)[served],
                                      words[served])
        for nplanes, lo, hi in ((6, 0, 63), (7, 64, 127), (8, 128, 255),
                                (11, 256, 2047)):
            rows = simple & (total >= lo) & (total <= hi)
            planes = _plane_counts(dense, run_cs[rows], run_len[rows],
                                   nplanes)
            counts = (planes[:, :, None, :] >> np.arange(
                32, dtype=np.uint32)[None, None, :, None]) & 1
            counts = (counts.astype(np.int64)
                      * (1 << np.arange(nplanes))).sum(axis=3)
            np.testing.assert_array_equal(
                counts.reshape(len(counts), 32 * c32)[:, :C], want[rows])
            ge = _planes_ge(planes, need[rows]) & colour
            sel = inside[rows]
            np.testing.assert_array_equal(ge[sel], words[rows][sel])
    assert served.any()

    run_cs16, run_len16, _nr, total16 = _slot_runs(rc, low16)
    rows = total16 <= 65535
    np.testing.assert_array_equal(
        _spread_runs(dense, run_cs16[rows], run_len16[rows].astype(np.uint32),
                     C), want16[rows])
    assert rows.any()
    if R > 8:  # totals past 65,535 take the exact path
        assert (want > 65535).any() and not rows.all()
