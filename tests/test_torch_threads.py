"""One host thread for each of the port's test modules.

The plain versions of the port's kernels run many small tensor ops, and
the native host libraries run OpenMP regions and std::thread pools sized
to every core. Under the parallel test run (`pytest -n 6`) each worker
would start a pool of all the host's cores, some fifty threads a worker,
and the pools' barriers then cost far more than the work. Every
tests/test_torch_*.py module imports `one_thread`, an autouse fixture that
holds the module to one thread and restores the counts after it:

  * torch's intra-op pool (torch.set_num_threads);
  * the OpenMP runtime of the port's native library, which need not be
    torch's (fulgor_tpu_torch.native.lib.omp_threads);
  * FULGOR_THREADS, read by both packages' native libraries at every call
    to size their std::thread pools and explicitly sized regions.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

from fulgor_tpu_torch.native import lib as native


@contextlib.contextmanager
def single_thread():
    """Hold torch, the native library's OpenMP and FULGOR_THREADS to one
    thread inside the block; restore them after."""
    keep_torch = torch.get_num_threads()
    keep_omp = native.omp_threads(1)
    keep_env = os.environ.get("FULGOR_THREADS")
    torch.set_num_threads(1)
    os.environ["FULGOR_THREADS"] = "1"
    try:
        yield
    finally:
        if keep_env is None:
            os.environ.pop("FULGOR_THREADS", None)
        else:
            os.environ["FULGOR_THREADS"] = keep_env
        native.omp_threads(keep_omp)
        torch.set_num_threads(keep_torch)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with single_thread():
        yield


def test_one_thread_in_force():
    assert torch.get_num_threads() == 1
    assert native.omp_threads() == 1
    assert os.environ["FULGOR_THREADS"] == "1"


def test_native_runs_under_one_thread():
    """A native OpenMP and std::thread path gives the same answer at one
    thread as numpy's sort does."""
    rng = np.random.default_rng(5)
    a = rng.integers(-(1 << 40), 1 << 40, size=50_000, dtype=np.int64)
    np.testing.assert_array_equal(native.sort_i64(a.copy()), np.sort(a))


def test_counts_restored_after_the_block():
    """Set to three threads beforehand (one count: the two OpenMP runtimes
    may be one), the block restores three."""
    keep = os.environ.get("FULGOR_THREADS")
    os.environ.pop("FULGOR_THREADS", None)
    try:
        torch.set_num_threads(3)
        native.omp_threads(3)
        with single_thread():
            assert torch.get_num_threads() == 1
            assert native.omp_threads() == 1
            assert os.environ["FULGOR_THREADS"] == "1"
        assert torch.get_num_threads() == 3
        assert native.omp_threads() == 3
        assert "FULGOR_THREADS" not in os.environ
    finally:
        torch.set_num_threads(1)
        native.omp_threads(1)
        if keep is not None:
            os.environ["FULGOR_THREADS"] = keep
