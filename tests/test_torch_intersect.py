"""Full intersection (kernel K3): the port's plain PyTorch version against
fulgor_tpu's three versions of the same function — per-window gather,
one-hot matmul, and compact_runs -> full_intersection_runs (on rows
without run overflow) — bit-exact (tolerance 0)."""

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


@pytest.mark.parametrize("ref", ["windows", "onehot", "runs"])
def test_fi_and_matches_jax(ref):
    dense, hit, csid = _inputs(7)
    jd, jh, jc = jnp.asarray(dense), jnp.asarray(hit), jnp.asarray(csid)
    got = _port(dense, hit, csid)
    rows = np.ones(B, dtype=bool)
    if ref == "windows":
        want = J.full_intersection_windows(jd, jh, jc)
    elif ref == "onehot":
        want = J.full_intersection_onehot(jd, jh, jc)
    else:
        run_csid, _cnt, rovf = J.compact_runs(jh, jc, RUN_BUDGET)
        want = J.full_intersection_runs(jd, run_csid, jnp.any(jh, axis=1))
        rows = ~np.asarray(rovf)
        assert rows.sum() >= B // 4 and (~rows).any()
    np.testing.assert_array_equal(got[rows], np.asarray(want)[rows])
    assert got[:4].sum() == 0 and got[rows].any()
