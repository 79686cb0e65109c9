"""The run-anchored probe (kernel K11, FULGOR_ANCHORED_PROBE=1) on the CPU:
the port's plain versions against fulgor_tpu on the same seeded inputs,
bit-exact (tolerance 0):

- K2's want_entry mode against _probe_entries(want_entry=True): hit, csid,
  ovf and the winning entry (q, rc, wlo, sp), from the slot route and the
  skew route;
- the anchored probe against lookup_minidict2_anchored_packed at the
  default (RA, RU) and at (4, 2) and (2, 1), where reads pass the lane
  budgets; and its contract: hit and ovf never both, csid equal to the
  one-pass probe's wherever both hit.

The engine under the anchored probe is tested in tests/test_torch_staged.py,
beside the engine under the staged one: both share one corpus and one set
of fulgor_tpu reference files, built once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import minidict2 as J
from fulgor_tpu_torch.ops import anchored as A
from fulgor_tpu_torch.ops.probe import minidict2_probe
from tests.test_torch_staged import W, _np, probe_inputs
from tests.test_torch_threads import one_thread  # noqa: F401

ANCHORED = [(None, None), (4, 2), (2, 1)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    k, m = 15, 9
    return (k, m) + probe_inputs(k, m, 23, tmp_path_factory.mktemp("anchored"))


def test_want_entry_matches_jax(case):
    k, m, d, jprep, tprep, tabs, _c2, _bad = case
    (minval, iL, iR, _pL, _pR, sigL, sigR, flo, fhi, rlo, rhi, usable) = jprep
    hit, val, ovf, entry = J._probe_entries(
        jnp.asarray(d.slots), jnp.asarray(d.text32), jnp.asarray(d.sec_table),
        minval, iL, iR, sigL, sigR, flo, fhi, rlo, rhi, usable, k=k, m=m,
        num_slots=d.num_slots, want_entry=True)
    want = (hit, val, ovf) + tuple(entry)
    got = minidict2_probe(*tabs, tprep, k=k, m=m, num_slots=d.num_slots,
                          want_entry=True)
    assert len(got) == 7
    for name, g, w in zip(("hit", "csid", "ovf", "q", "rc", "wlo", "sp"),
                          got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(_np(g).view(w.dtype), w, err_msg=name)
    # both routes win somewhere: the skew route's winners are the hits a
    # probe without it misses
    noskew = minidict2_probe(*tabs, tprep, k=k, m=m, num_slots=d.num_slots,
                             sc=0)[0].numpy()
    h, rc = np.asarray(hit), np.asarray(entry[1])
    assert (h & ~noskew).any() and rc[h].any() and not rc[h].all()


@pytest.mark.parametrize("budget", ANCHORED, ids=str)
def test_anchored_matches_jax(case, budget):
    k, m, d, _jprep, tprep, tabs, codes2, bad = case
    RA, RU = budget
    want = [np.asarray(t) for t in J.lookup_minidict2_anchored_packed(
        jnp.asarray(d.slots), jnp.asarray(d.text32), jnp.asarray(d.sec_table),
        jnp.asarray(codes2), jnp.asarray(bad), width=W, k=k, m=m,
        num_slots=d.num_slots, RA=RA, RU=RU)]
    got = [_np(t) for t in A.minidict2_anchored_probe(
        *tabs, tprep, k=k, m=m, num_slots=d.num_slots, RA=RA, RU=RU)]
    for name, g, w in zip(("hit", "csid", "ovf"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    hit1, cs1, _ovf1 = (_np(t) for t in minidict2_probe(
        *tabs, tprep, k=k, m=m, num_slots=d.num_slots))
    hit, cs, ovf = got
    assert hit.any() and not (hit & ovf).any()
    both = hit & hit1
    np.testing.assert_array_equal(cs[both], cs1[both])
    if RA is not None:  # reads past the lane budgets
        assert ovf.any()
