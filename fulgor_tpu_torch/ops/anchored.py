"""Run-anchored dictionary probe (kernel K11), FULGOR_ANCHORED_PROBE=1.

Counterpart of fulgor_tpu/ops/minidict2.py _probe_anchored (the probe of
lookup_minidict2_anchored_packed and lookup_minidict2_batch_anchored).
Given a window prep (ops/prep.py):

  1. runs are maximal stretches of usable windows with the same (pL, pR);
     within one, the candidate text position moves by +1 a window forward
     and -1 in reverse complement. The first RA run starts and ends of each
     read are ranked and their probe inputs gathered into (B, 2 RA) lanes,
     probed at the default budgets by K2 in its want_entry mode;
  2. every window of the first RA runs verifies one predicted text position
     from its run's start anchor and, where that misses, one from its end
     anchor;
  3. windows still undecided (the anchor missed and the prediction failed)
     are compacted into (B, RU) lanes and probed again at the default
     budgets.

ovf = the reprobe's ovf | an anchor lane's own ovf on a window the
prediction did not decide | usable windows past RA runs | undecided windows
past RU. A hit is text-verified, so hit and ovf never meet, and the csid of
a hit equals the one-pass probe's. RA and RU default to anchor_budget and
reprobe_budget of (Wk, k, m). -> (hit bool, csid int32 bit pattern, ovf
bool), each (B, Wk). `minidict2_anchored_probe` launches csrc/anchored.cu's
three kernels around two K2 launches for CUDA tensors (reads of at most
MAX_WK = 1,024 windows: the engine's widths stop there), and runs the plain
version for CPU tensors. No size is read back to the host.
"""

from __future__ import annotations

import torch

from . import kernels
from .intersect import _first_positions
from .minidict2 import anchor_budget, reprobe_budget
from .probe import (
    MAX_WK, _extract33, _masks, check_probe_inputs, empty_lanes,
    minidict2_probe, minidict2_probe_plain, prep_of_lanes, probe_lanes,
)
from .u32 import u32


def _budgets(Wk: int, k: int, m: int, RA, RU):
    RA = anchor_budget(Wk, k, m) if RA is None else RA
    RU = reprobe_budget(Wk, k, m) if RU is None else RU
    if RA < 1 or RU < 1:
        raise ValueError(f"anchored probe: unsupported budget ({RA}, {RU})")
    return RA, RU


def _run_bounds(usable, pL, pR):
    """-> (is_start, is_end), (B, Wk) bool: the first and last windows of
    each run."""
    cont = torch.zeros_like(usable)
    cont[:, 1:] = (usable[:, 1:] & usable[:, :-1] & (pL[:, 1:] == pL[:, :-1])
                   & (pR[:, 1:] == pR[:, :-1]))
    nxt = torch.zeros_like(usable)
    nxt[:, :-1] = cont[:, 1:]
    return usable & ~cont, usable & ~nxt


def minidict2_anchored_probe_plain(slots, text32, skew, prep, *, k: int,
                                   m: int, num_slots: int, RA=None, RU=None):
    """Plain PyTorch anchored probe (any device), the reference's
    formulation: cumulative-sum ranks and gathers."""
    (minval, iL, iR, pL, pR, sigL, sigR, flo, fhi, rlo, rhi, usable) = prep
    B, Wk = minval.shape
    RA, RU = _budgets(Wk, k, m, RA, RU)
    kw = dict(k=k, m=m, num_slots=num_slots)
    dev = usable.device
    lanes = probe_lanes(prep)
    is_start, is_end = _run_bounds(usable, pL, pR)
    posS = _first_positions(is_start, RA)
    posE = _first_positions(is_end, RA)
    validS = (torch.arange(RA, device=dev)[None, :]
              < is_start.sum(dim=1, keepdim=True))
    probeE = validS & (posE > posS)
    posA = torch.cat([posS, posE], dim=1)
    laneok = torch.cat([validS, probeE], dim=1)
    hitA, valA, ovfA, qA, rcA, wloA, spA = minidict2_probe_plain(
        slots, text32, skew,
        prep_of_lanes([a.gather(1, posA) for a in lanes[:-1]] + [laneok]),
        want_entry=True, **kw)

    runid = torch.cumsum(is_start, dim=1) - 1
    in_run = usable & (runid >= 0) & (runid < RA)
    rid = runid.clamp(0, RA - 1)

    def bS(a):
        return a[:, :RA].gather(1, rid)

    def bE(a):
        return a[:, RA:].gather(1, rid)

    text = u32(text32)
    lo_mask, hi_mask = _masks(k)
    flo, fhi, rlo, rhi = map(u32, (flo, fhi, rlo, rhi))
    pos = torch.arange(Wk, device=dev)[None, :]

    def verify(ext, qw, rc):
        tlo, thi = _extract33(text, torch.where(ext, qw, 0))
        return (ext & ((tlo & lo_mask) == torch.where(rc, rlo, flo))
                & ((thi & hi_mask) == torch.where(rc, rhi, fhi)))

    hS, vS, qS, rcS, wS, sS, ovfS = map(bS, (hitA, valA, qA, rcA, wloA, spA,
                                             ovfA))
    dS = pos - torch.where(validS, posS, 0).gather(1, rid)
    qwS = torch.where(rcS, qS - dS, qS + dS)
    ok1 = verify(in_run & hS & (qwS >= wS) & (qwS < wS + sS), qwS, rcS)
    hE, vE, qE, rcE, wE, sE, ovfE = map(bE, (hitA, valA, qA, rcA, wloA, spA,
                                             ovfA))
    dE = torch.where(probeE, posE, 0).gather(1, rid) - pos
    qwE = torch.where(rcE, qE + dE, qE - dE)
    ok2 = verify(in_run & ~ok1 & hE & (dE >= 0) & (qwE >= wE)
                 & (qwE < wE + sE), qwE, rcE)
    hit0 = ok1 | ok2
    val0 = torch.where(ok1, vS, vE)

    eprb = probeE.gather(1, rid)
    dec_miss = ((is_start & in_run & ~ovfS & ~hS)
                | (is_end & in_run & eprb & ~ovfE & ~hE))
    anch_ovf = ((is_start & in_run & ovfS)
                | (is_end & in_run & eprb & ovfE)) & ~hit0

    undec = usable & in_run & ~hit0 & ~dec_miss & ~anch_ovf
    posU = _first_positions(undec, RU)
    validU = (torch.arange(RU, device=dev)[None, :]
              < undec.sum(dim=1, keepdim=True))
    hitU, valU, ovfU = minidict2_probe_plain(
        slots, text32, skew,
        prep_of_lanes([a.gather(1, posU) for a in lanes[:-1]] + [validU]),
        **kw)
    urank = torch.cumsum(undec, dim=1) - 1
    in_ru = undec & (urank < RU)
    ur = urank.clamp(0, RU - 1)
    hitU_w = hitU.gather(1, ur) & in_ru
    ovfU_w = (ovfU.gather(1, ur) & in_ru) | (undec & (urank >= RU))
    csid = torch.where(hit0, val0, torch.where(hitU_w, valU.gather(1, ur),
                                               -1))
    return hit0 | hitU_w, csid, ovfU_w | anch_ovf | (usable & ~in_run)


def minidict2_anchored_probe(slots, text32, skew, prep, *, k: int, m: int,
                             num_slots: int, RA=None, RU=None):
    """The run-anchored probe of every window lane of `prep` against the
    device tables -> (hit, csid, ovf), each (B, Wk), as
    minidict2_anchored_probe_plain."""
    if slots.device.type == "cpu":
        return minidict2_anchored_probe_plain(
            slots, text32, skew, prep, k=k, m=m, num_slots=num_slots, RA=RA,
            RU=RU)
    check_probe_inputs("anchored_probe", slots, text32, skew, prep)
    pL, pR = prep[3], prep[4]
    if any(t.dtype != torch.int32 or not t.is_contiguous()
           or t.shape != prep[0].shape or t.device != slots.device
           for t in (pL, pR)):
        raise ValueError("anchored_probe: pL and pR must be contiguous "
                         "int32 of the prep's shape")
    if prep[0].shape[1] > MAX_WK:
        raise ValueError(f"anchored_probe: at most {MAX_WK} windows a read")
    return _anchored_kernels(slots, text32, skew, prep, k=k, m=m,
                             num_slots=num_slots, RA=RA, RU=RU)


def _anchored_kernels(slots, text32, skew, prep, *, k, m, num_slots,
                      RA=None, RU=None):
    """csrc/anchored.cu's three kernels around K2's two launches, on the
    checked inputs of minidict2_anchored_probe."""
    B, Wk = prep[0].shape
    RA, RU = _budgets(Wk, k, m, RA, RU)
    kw = dict(k=k, m=m, num_slots=num_slots)
    dev = slots.device
    nw = (Wk + 31) // 32
    lanes = probe_lanes(prep)
    lanesA = empty_lanes(lanes, (B, 2 * RA))
    smask = torch.empty((B, nw), dtype=torch.int32, device=dev)
    emask = torch.empty((B, nw), dtype=torch.int32, device=dev)
    lib = kernels.library()
    stream = kernels.stream_of(slots)
    rc = lib.fulgor_anchored_anchors(
        kernels.pointers(lanes), prep[3].data_ptr(), prep[4].data_ptr(), B,
        Wk, RA, kernels.pointers(lanesA), smask.data_ptr(), emask.data_ptr(),
        stream)
    kernels.check(rc, "anchored_probe")
    kernels.launches["anchored_probe"] += 1
    anchors = minidict2_probe(slots, text32, skew, prep_of_lanes(lanesA),
                              want_entry=True, **kw)
    lanesU = empty_lanes(lanes, (B, RU))
    hit = torch.empty((B, Wk), dtype=torch.bool, device=dev)
    csid = torch.empty((B, Wk), dtype=torch.int32, device=dev)
    ovf = torch.empty((B, Wk), dtype=torch.bool, device=dev)
    umask = torch.empty((B, nw), dtype=torch.int32, device=dev)
    rc = lib.fulgor_anchored_extend(
        text32.data_ptr(), text32.shape[0], kernels.pointers(lanes),
        smask.data_ptr(), emask.data_ptr(),
        *(t.data_ptr() for t in anchors), B, Wk, RA, RU, k,
        kernels.pointers(lanesU), hit.data_ptr(), csid.data_ptr(),
        ovf.data_ptr(), umask.data_ptr(), stream)
    kernels.check(rc, "anchored_probe")
    kernels.launches["anchored_probe"] += 1
    hitU, valU, ovfU = minidict2_probe(slots, text32, skew,
                                       prep_of_lanes(lanesU), **kw)
    rc = lib.fulgor_anchored_merge(
        umask.data_ptr(), hitU.data_ptr(), valU.data_ptr(), ovfU.data_ptr(),
        B, Wk, RU, hit.data_ptr(), csid.data_ptr(), ovf.data_ptr(), stream)
    kernels.check(rc, "anchored_probe")
    kernels.launches["anchored_probe"] += 1
    return hit, csid, ovf
