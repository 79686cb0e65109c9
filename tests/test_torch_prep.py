"""Window prep (kernel K1): the port's plain PyTorch version against
fulgor_tpu's _window_prep_from_words(words_from_packed(...)), bit-exact
(tolerance 0: every output is an integer or a flag)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import minidict2 as J
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.ops.prep import PREP_FIELDS, window_prep

from tests.test_torch_threads import one_thread  # noqa: F401


def _batch(rng, B, W, k):
    """Random reads of ragged length (padding), with scattered N bases."""
    chunk = rng.integers(0, 4, size=(B, W)).astype(np.uint8)
    lens = rng.integers(k - 3, W + 1, size=B)
    for b in range(B):
        chunk[b, lens[b]:] = 4
        chunk[b, rng.integers(0, W, size=rng.integers(0, 3))] = 4
    chunk[0, :] = 4  # all-N read
    return chunk


@pytest.mark.parametrize("W", [64, 160])
@pytest.mark.parametrize("k,m", [(15, 9), (31, 19)])
def test_prep_matches_jax(k, m, W):
    rng = np.random.default_rng(100 * k + W)
    codes2, bad = pack_reads_host(_batch(rng, 32, W, k))
    ref = J._window_prep_from_words(
        *J.words_from_packed(jnp.asarray(codes2), jnp.asarray(bad)), W, k, m)
    got = window_prep(torch.from_numpy(codes2), torch.from_numpy(bad),
                      width=W, k=k, m=m)
    assert len(got) == len(PREP_FIELDS) == len(ref)
    for name, r, g in zip(PREP_FIELDS, ref, got):
        r = np.asarray(r)
        g = g.numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == r.shape, name
        np.testing.assert_array_equal(g.astype(r.dtype), r, err_msg=name)


def test_pack_reads_host_matches_jax():
    from fulgor_tpu.ops.lookup import pack_reads_host as jax_pack

    chunk = _batch(np.random.default_rng(3), 16, 96, 15)
    for a, b in zip(pack_reads_host(chunk), jax_pack(chunk)):
        np.testing.assert_array_equal(a, b)
