"""Full intersection (kernel K3): the port's plain PyTorch version against
fulgor_tpu's three versions of the same function — per-window gather,
one-hot matmul, and compact_runs -> full_intersection_runs (on rows
without run overflow) — bit-exact (tolerance 0), also at the kernel's edge
shapes; and the kernel's exactness argument: the AND over the rows of run
starts alone (a positive window whose left neighbour is not positive with
the same csid) equals the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import intersect as J
from fulgor_tpu_torch.ops.intersect import fi_and

from tests.test_torch_threads import one_thread  # noqa: F401

S, C32, B, WK = 300, 3, 48, 50
RUN_BUDGET = 12


def _inputs(seed):
    """Dense rows of mixed density, reads made of runs of equal csids with
    gaps of negative windows, some reads entirely unmapped."""
    rng = np.random.default_rng(seed)
    dense = rng.integers(0, 1 << 32, size=(S, C32), dtype=np.uint64)
    dense |= rng.integers(0, 1 << 32, size=(S, C32), dtype=np.uint64)
    dense = dense.astype(np.uint32)
    dense[: S // 4] = 0xFFFFFFFF  # near-core sets keep intersections non-empty
    csid = np.empty((B, WK), np.uint32)
    for b in range(B):
        run = rng.integers(1, 12, size=WK)
        vals = rng.integers(0, S, size=WK)
        csid[b] = np.repeat(vals, run)[:WK]
    hit = rng.random((B, WK)) < 0.8
    hit[:4] = False
    csid[~hit] = 0xFFFFFFFF
    return dense, hit, csid


def _port(dense, hit, csid):
    out = fi_and(torch.from_numpy(dense.view(np.int32)), torch.from_numpy(hit),
                 torch.from_numpy(csid.view(np.int32)))
    return out.numpy().view(np.uint32)


def _run_start_and(dense, hit, csid):
    """The AND over each read's run-start rows only, as the K3 kernel
    computes it (0 for a read with no positive window)."""
    prev = np.zeros_like(hit)
    prev[:, 1:] = hit[:, :-1] & (csid[:, :-1] == csid[:, 1:])
    start = hit & ~prev
    out = np.zeros((hit.shape[0], dense.shape[1]), np.uint32)
    for b in range(hit.shape[0]):
        rows = dense[csid[b][start[b]]]
        if len(rows):
            out[b] = np.bitwise_and.reduce(rows, axis=0)
    return out


def _edge_inputs(seed, c32, wk, reads=24):
    """Reads of wk windows over 400 rows of c32 words: runs of 1-11
    windows of csids from a pool of four a read (a csid recurs after other
    runs, and the AND stays non-empty), broken by misses that keep the
    run's csid or hold INVALID; the first three reads with no positive
    window."""
    rng = np.random.default_rng(seed)
    S = 400
    dense = (rng.integers(0, 1 << 32, (S, c32), dtype=np.uint64)
             | rng.integers(0, 1 << 32, (S, c32), dtype=np.uint64))
    dense[: S // 3] = 0xFFFFFFFF
    pick = np.repeat(rng.integers(0, 4, reads * wk),
                     rng.integers(1, 12, reads * wk))[: reads * wk]
    csid = np.take_along_axis(rng.integers(0, S, (reads, 4)),
                              pick.reshape(reads, wk), axis=1)
    csid = csid.astype(np.uint32)
    hit = rng.random((reads, wk)) < 0.8
    hit[:3] = False
    csid[~hit & (rng.random((reads, wk)) < 0.5)] = 0xFFFFFFFF
    return dense.astype(np.uint32), hit, csid


@pytest.mark.parametrize("ref", ["windows", "onehot", "runs", "starts"])
def test_fi_and_matches_jax(ref):
    dense, hit, csid = _inputs(7)
    jd, jh, jc = jnp.asarray(dense), jnp.asarray(hit), jnp.asarray(csid)
    got = _port(dense, hit, csid)
    rows = np.ones(B, dtype=bool)
    if ref == "windows":
        want = J.full_intersection_windows(jd, jh, jc)
    elif ref == "starts":
        want = _run_start_and(dense, hit, csid)
        np.testing.assert_array_equal(
            want, np.asarray(J.full_intersection_windows(jd, jh, jc)))
    elif ref == "onehot":
        want = J.full_intersection_onehot(jd, jh, jc)
    else:
        run_csid, _cnt, rovf = J.compact_runs(jh, jc, RUN_BUDGET)
        want = J.full_intersection_runs(jd, run_csid, jnp.any(jh, axis=1))
        rows = ~np.asarray(rovf)
        assert rows.sum() >= B // 4 and (~rows).any()
    np.testing.assert_array_equal(got[rows], np.asarray(want)[rows])
    assert got[:4].sum() == 0 and got[rows].any()


@pytest.mark.parametrize("c32", [1, 8, 143])
@pytest.mark.parametrize("wk", [1, 33, 1024])
def test_fi_and_edge_shapes(c32, wk):
    """The kernel's edge shapes: C32 of one word, a mesh shard's 8 and the
    4,546-colour index's 143; one window, a window past a warp and the
    kernel's 1,024: the plain version and the AND over run starts against
    full_intersection_windows."""
    dense, hit, csid = _edge_inputs(c32 * 7 + wk, c32, wk)
    want = np.asarray(J.full_intersection_windows(
        jnp.asarray(dense), jnp.asarray(hit), jnp.asarray(csid)))
    np.testing.assert_array_equal(_port(dense, hit, csid), want)
    np.testing.assert_array_equal(_run_start_and(dense, hit, csid), want)
    assert not want[:3].any() and want[3:].any(axis=1).sum() > 12
