"""Threshold-union scores (kernels K4 and K5): the port's plain PyTorch
versions against fulgor_tpu, bit-exact (tolerance 0).

- scores against threshold_union_scores_windows, _onehot and compact_runs
  -> threshold_union_scores_runs (on rows without run overflow);
- K4's mask against `scores >= table[npos] & npos > 0` -> pack_bool_bits,
  composed as fulgor_tpu's query_tu_lists_packed composes it, at C = 70
  (a ragged last word) and tau down to 0.01 (every colour of a mapped read
  passes, pad bits must stay 0);
- K5's positivity words against _pack_hits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import intersect as J
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu_torch.ops.intersect import km_scores, tu_mask

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
