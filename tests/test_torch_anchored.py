"""The run-anchored probe (kernel K11, FULGOR_ANCHORED_PROBE=1) on the CPU:
the port's plain versions against fulgor_tpu on the same seeded inputs,
bit-exact (tolerance 0):

- K2's want_entry mode against _probe_entries(want_entry=True): hit, csid,
  ovf and the winning entry (q, rc, wlo, sp), from the slot route and the
  skew route;
- the anchored probe against lookup_minidict2_anchored_packed at the
  default (RA, RU) and at (4, 2) and (2, 1), where reads pass the lane
  budgets; and its contract: hit and ovf never both, csid equal to the
  one-pass probe's wherever both hit;
- csrc/anchored.cu's index arithmetic modelled in numpy (anchored_model:
  run-start and run-end masks as words, ranks and runid by prefix
  popcount, a window's run start and end from the words, the undecided
  mask and its ranks) against the plain version's cumulative-sum
  intermediates, and composed around the plain K2 against fulgor_tpu's
  _probe_anchored, at edge shapes: reads cut to Wk 1, 33 and 130, B 1 and
  7, (RA, RU) (1, 1) and (Wk, Wk).

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
from fulgor_tpu_torch.ops.intersect import _first_positions
from fulgor_tpu_torch.ops.probe import (
    _extract33, _masks, minidict2_probe, prep_of_lanes, probe_lanes,
)
from fulgor_tpu_torch.ops.u32 import u32
from tests.test_torch_staged import (
    W, _np, bit_words, bits_before, edge_batch, probe_inputs, word_bit,
)
from tests.test_torch_threads import one_thread  # noqa: F401

ANCHORED = [(None, None), (4, 2), (2, 1)]
EDGE_ANCHORED = [(7, 1, (1, 1)), (7, 33, (None, None)), (7, 33, (33, 33)),
                 (1, 130, (None, None)), (7, 130, (1, 1))]


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


def _highest(x):
    """The highest set bit of each uint32, -1 where none."""
    x = x.astype(np.uint64)
    return np.where(x > 0, np.floor(np.log2(np.maximum(x, 1))), -1).astype(
        np.int64)


def _lowest(x):
    """The lowest set bit of each uint32, -1 where none."""
    x = x.astype(np.int64)
    return _highest((x & -x).astype(np.uint64))


def anchored_model(tabs, tprep, *, k, m, num_slots, RA, RU):
    """csrc/anchored.cu's index arithmetic in numpy around the plain K2:
    the anchors kernel's run-start words (a window against the one before)
    and run-end words (a usable window whose next is not usable or starts a
    run: a shift of the words), run q's start and end as the q-th set
    bits; the extension's runid and usable by prefix popcounts, a window's
    run start (the highest start bit at or below it, else the last one of
    the words before) and end (the lowest end bit at or above it, else the
    first of the words after), the undecided words and their ranks; the
    merge by those ranks. -> ((hit, csid, ovf), intermediates)."""
    (_minval, _iL, _iR, pL, pR, _sigL, _sigR, flo, fhi, rlo, rhi,
     usable) = (t.numpy() for t in tprep)
    B, Wk = usable.shape
    RA, RU = A._budgets(Wk, k, m, RA, RU)
    nw = -(-Wk // 32)
    kw = dict(k=k, m=m, num_slots=num_slots)
    same = np.zeros_like(usable)
    same[:, 1:] = (usable[:, :-1] & (pL[:, 1:] == pL[:, :-1])
                   & (pR[:, 1:] == pR[:, :-1]))
    uw, sw = bit_words(usable), bit_words(usable & ~same)

    def nxt(words):  # each window's next: bit 31 from the next word
        later = np.zeros_like(words)
        later[:, :-1] = words[:, 1:]
        return (words >> np.uint32(1)) | (later << np.uint32(31))

    ew = uw & ~(nxt(uw) & ~nxt(sw))
    starts, ends = word_bit(sw, Wk), word_bit(ew, Wk)
    rs, re = bits_before(sw, Wk), bits_before(ew, Wk)
    nA = np.minimum(np.bitwise_count(sw).astype(np.int64).sum(axis=1), RA)
    posS = np.zeros((B, RA), dtype=np.int64)
    posE = np.zeros((B, RA), dtype=np.int64)
    b, w = np.nonzero(starts & (rs < RA))
    posS[b, rs[b, w]] = w
    b, w = np.nonzero(ends & (re < RA))
    posE[b, re[b, w]] = w
    validS = np.arange(RA)[None, :] < nA[:, None]
    probeE = validS & (posE > posS)
    lanes = probe_lanes(tprep)
    posA = torch.from_numpy(np.concatenate([posS, posE], axis=1))
    laneok = torch.from_numpy(np.concatenate([validS, probeE], axis=1))
    hitA, valA, ovfA, qA, rcA, wloA, spA = (t.numpy() for t in minidict2_probe(
        *tabs, prep_of_lanes([a.gather(1, posA) for a in lanes[:-1]]
                             + [laneok]), want_entry=True, **kw))

    # the extension
    runid = rs + starts - 1
    us = (runid >= 0) & (runid == re)
    in_run = us & (runid < RA)
    wpos = np.arange(Wk)
    word, bit = wpos // 32, (wpos % 32).astype(np.uint64)
    le = ((np.uint64(2) << bit) - np.uint64(1)).astype(np.uint32)
    hs = sw[:, word] & le
    top = np.where(sw != 0, np.arange(nw) * 32 + _highest(sw), 0)
    last = np.maximum.accumulate(top, axis=1)  # the kernel's last_s
    before = np.zeros_like(last)
    before[:, 1:] = last[:, :-1]
    pS = np.where(hs != 0, word * 32 + _highest(hs), before[:, word])
    he = ew[:, word] & ~(le >> np.uint32(1))
    first = np.where(ew != 0, np.arange(nw) * 32 + _lowest(ew), Wk)
    nextw = np.minimum.accumulate(first[:, ::-1], axis=1)[:, ::-1]
    after = np.full_like(nextw, Wk)
    after[:, :-1] = nextw[:, 1:]
    pE = np.where(he != 0, word * 32 + _lowest(he), after[:, word])

    rid = np.clip(runid, 0, RA - 1)
    text = u32(tabs[1])
    lo_mask, hi_mask = _masks(k)
    want = [u32(torch.from_numpy(a)) for a in (flo, fhi, rlo, rhi)]

    def verify(side, d):  # the side's anchor predicts q for d windows on
        j = rid + side * RA
        h, rc = np.take_along_axis(hitA, j, 1), np.take_along_axis(rcA, j, 1)
        q0 = np.take_along_axis(qA, j, 1)
        lo = np.take_along_axis(wloA, j, 1)
        q = np.where(rc, q0 - d, q0 + d)
        ok = h & (q >= lo) & (q < lo + np.take_along_axis(spA, j, 1))
        tlo, thi = _extract33(text, torch.from_numpy(np.where(ok, q, 0)))
        rct = torch.from_numpy(rc)
        return ok & ((tlo & lo_mask) == torch.where(rct, want[2], want[0])
                     ).numpy() & ((thi & hi_mask) == torch.where(
                         rct, want[3], want[1])).numpy()

    eprb = pE > pS
    ok1 = in_run & verify(0, wpos - pS)
    ok2 = in_run & ~ok1 & eprb & verify(1, wpos - pE)
    hit0 = ok1 | ok2
    val0 = np.where(ok1, np.take_along_axis(valA, rid, 1),
                    np.take_along_axis(valA, rid + RA, 1))
    hS, oS = (np.take_along_axis(a, rid, 1) for a in (hitA, ovfA))
    hE, oE = (np.take_along_axis(a, rid + RA, 1) & eprb
              for a in (hitA, ovfA))
    dec_miss = in_run & ((starts & ~oS & ~hS) | (ends & eprb & ~oE & ~hE))
    anch_ovf = in_run & ((starts & oS) | (ends & oE)) & ~hit0
    undec = in_run & ~hit0 & ~dec_miss & ~anch_ovf
    vw = bit_words(undec)
    ru = bits_before(vw, Wk)
    b, w = np.nonzero(undec & (ru < RU))
    posU = np.zeros((B, RU), dtype=np.int64)
    posU[b, ru[b, w]] = w
    validU = np.arange(RU)[None, :] < np.bitwise_count(vw).astype(
        np.int64).sum(axis=1)[:, None]
    hitU, valU, ovfU = (t.numpy() for t in minidict2_probe(
        *tabs, prep_of_lanes([a.gather(1, torch.from_numpy(posU))
                              for a in lanes[:-1]]
                             + [torch.from_numpy(validU)]), **kw))
    # the merge: the reprobe's lane of each of the first RU undecided
    hit, csid = hit0.copy(), np.where(hit0, val0, -1)
    ovf = anch_ovf | (us & ~in_run) | (undec & (ru >= RU))
    hit[b, w], csid[b, w] = hitU[b, ru[b, w]], np.where(
        hitU[b, ru[b, w]], valU[b, ru[b, w]], -1)
    ovf[b, w] = ovfU[b, ru[b, w]]
    mid = dict(starts=starts, ends=ends, posS=posS, posE=posE, runid=runid,
               us=us, in_run=in_run, pS=pS, pE=pE, undec=undec, ru=ru)
    return (hit, csid.astype(np.int32).view(np.uint32), ovf), mid


@pytest.mark.parametrize("shape", EDGE_ANCHORED, ids=str)
def test_anchored_index_arithmetic(case, shape):
    """The anchors kernel's, extension's and merge's index arithmetic
    (numpy, anchored_model) against the plain version's cumulative-sum
    intermediates, and composed around the plain K2 against fulgor_tpu's
    _probe_anchored and the plain anchored probe, at edge shapes."""
    k, m, d = case[:3]
    tabs = case[5]
    B, Wk, (RA, RU) = shape
    jprep, tprep = edge_batch(k, m, 23, B, Wk)
    kw = dict(k=k, m=m, num_slots=d.num_slots)
    got, mid = anchored_model(tabs, tprep, RA=RA, RU=RU, **kw)
    usable, pL, pR = tprep[-1], tprep[3], tprep[4]
    is_start, is_end = A._run_bounds(usable, pL, pR)
    np.testing.assert_array_equal(mid["starts"], is_start.numpy())
    np.testing.assert_array_equal(mid["ends"], is_end.numpy())
    ra, _ru = A._budgets(Wk, k, m, RA, RU)
    posS, posE = (_first_positions(x, ra).numpy()
                  for x in (is_start, is_end))
    np.testing.assert_array_equal(mid["posS"], posS)
    np.testing.assert_array_equal(mid["posE"], posE)
    runid = torch.cumsum(is_start, dim=1).numpy() - 1
    np.testing.assert_array_equal(mid["runid"], runid)
    np.testing.assert_array_equal(mid["us"], usable.numpy())
    inr = mid["in_run"]
    rid = np.clip(runid, 0, ra - 1)
    np.testing.assert_array_equal(mid["pS"][inr],
                                  np.take_along_axis(posS, rid, 1)[inr])
    np.testing.assert_array_equal(mid["pE"][inr],
                                  np.take_along_axis(posE, rid, 1)[inr])
    undec = mid["undec"]
    np.testing.assert_array_equal(mid["ru"][undec],
                                  (np.cumsum(undec, axis=1) - 1)[undec])
    want = [np.asarray(t) for t in J._probe_anchored(
        jnp.asarray(d.slots), jnp.asarray(d.text32),
        jnp.asarray(d.sec_table), jprep, k, m, d.num_slots, RA, RU)]
    plain = [_np(t) for t in A.minidict2_anchored_probe(
        *tabs, tprep, RA=RA, RU=RU, **kw)]
    for name, g, p, w in zip(("hit", "csid", "ovf"), got, plain, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(p, w, err_msg=name)
    if RA == 1 and B > 1 and Wk > 1:  # reads past the lane budgets
        assert (is_start.sum(dim=1) > 1).any() and got[2].any()
