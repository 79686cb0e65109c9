"""Staged dictionary probe (kernel K10), FULGOR_PROBE_BUDGET=vb1,vb2,sc,RU.

Counterpart of fulgor_tpu/ops/minidict2.py _probe_staged (the probe of
lookup_minidict2_staged_packed). Given a window prep (ops/prep.py):

  stage A   K2 in its stage1 mode at vb1 verifies on every lane, no skew
            route; undecided = usable & ~hit & (cnt > vb1 | need_sec);
            a read is heavy when it has more than RU = min(RU, Wk)
            undecided windows;
  tier B1   each light read's undecided windows, compacted into (B, RU)
            lanes, take the full probe at (vb2, sc);
  tier B2   the first BH = max(1, B // 8) heavy reads, in read order across
            the batch, are gathered whole into (BH, Wk) and take the full
            probe on their undecided windows; heavy reads past BH report
            ovf on every undecided window;
  merge     hit = stage A's | B1's | B2's, csid by that priority (INVALID
            where no hit), ovf = B1's | B2's: stage A's own lanes never
            carry ovf.

A hit is text-verified and a miss without ovf exhausted every candidate, so
the staged probe equals the one-pass probe at (vb2, sc) wherever its ovf is
false. -> (hit bool, csid int32 bit pattern, ovf bool), each (B, Wk).
`minidict2_staged_probe` launches K2 three times and csrc/staged.cu's
three kernels between them for CUDA tensors (reads of at most MAX_WK =
1,024 windows: the engine's widths stop there), and runs the plain version
for CPU tensors. No size is read back to the host: every shape follows
from (B, Wk, RU).
"""

from __future__ import annotations

import torch

from . import kernels
from .intersect import _first_positions
from .probe import (
    MAX_WK, check_probe_inputs, empty_lanes, minidict2_probe,
    minidict2_probe_plain, prep_of_lanes, probe_lanes,
)


def _budgets(B: int, Wk: int, vb1: int, vb2: int, sc: int, RU: int):
    if min(vb1, vb2, sc) < 0 or RU < 1:
        raise ValueError(f"staged probe: unsupported budget "
                         f"({vb1}, {vb2}, {sc}, {RU})")
    return min(RU, Wk), max(1, B // 8)


def minidict2_staged_probe_plain(slots, text32, skew, prep, *, k: int, m: int,
                                 num_slots: int, vb1: int, vb2: int, sc: int,
                                 RU: int):
    """Plain PyTorch staged probe (any device), the reference's
    formulation: cumulative-sum ranks and gathers."""
    B, Wk = prep[0].shape
    RU, BH = _budgets(B, Wk, vb1, vb2, sc, RU)
    kw = dict(k=k, m=m, num_slots=num_slots)
    usable = prep[-1]
    hit, val, cnt, need = minidict2_probe_plain(slots, text32, skew, prep,
                                                vb=vb1, stage1=True, **kw)
    undec = usable & ~hit & ((cnt > vb1) | need)
    heavy = undec.sum(dim=1) > RU
    light = undec & ~heavy[:, None]
    dev = usable.device

    # tier B1: each light read's undecided windows in (B, RU) lanes
    posU = _first_positions(light, RU)
    validU = (torch.arange(RU, device=dev)[None, :]
              < light.sum(dim=1, keepdim=True))
    lanesU = [a.gather(1, posU) for a in probe_lanes(prep)[:-1]] + [validU]
    hitU, valU, ovfU = minidict2_probe_plain(
        slots, text32, skew, prep_of_lanes(lanesU), vb=vb2, sc=sc, **kw)
    ur = (torch.cumsum(light, dim=1) - 1).clamp(0, RU - 1)
    hitU_w = hitU.gather(1, ur) & light
    valU_w = valU.gather(1, ur)
    ovfU_w = ovfU.gather(1, ur) & light

    # tier B2: the first BH heavy reads, whole
    posH = _first_positions(heavy[None, :], BH)[0]
    validH = torch.arange(BH, device=dev) < heavy.sum()
    lanesH = ([a[posH] for a in probe_lanes(prep)[:-1]]
              + [undec[posH] & validH[:, None]])
    hitH, valH, ovfH = minidict2_probe_plain(
        slots, text32, skew, prep_of_lanes(lanesH), vb=vb2, sc=sc, **kw)
    hrank = torch.cumsum(heavy, dim=0) - 1
    hr = hrank.clamp(0, BH - 1)
    sel_h = (heavy & (hrank < BH))[:, None] & undec
    hitH_w = hitH[hr] & sel_h
    ovfH_w = (ovfH[hr] & sel_h) | ((heavy & (hrank >= BH))[:, None] & undec)

    out_hit = hit | hitU_w | hitH_w
    csid = torch.where(hit, val, torch.where(
        hitU_w, valU_w, torch.where(hitH_w, valH[hr], -1)))
    return out_hit, csid, ovfU_w | ovfH_w


def minidict2_staged_probe(slots, text32, skew, prep, *, k: int, m: int,
                           num_slots: int, vb1: int, vb2: int, sc: int,
                           RU: int):
    """The staged probe of every window lane of `prep` against the device
    tables -> (hit, csid, ovf), each (B, Wk), as
    minidict2_staged_probe_plain."""
    if slots.device.type == "cpu":
        return minidict2_staged_probe_plain(
            slots, text32, skew, prep, k=k, m=m, num_slots=num_slots,
            vb1=vb1, vb2=vb2, sc=sc, RU=RU)
    check_probe_inputs("staged_probe", slots, text32, skew, prep)
    if prep[0].shape[1] > MAX_WK:
        raise ValueError(f"staged_probe: at most {MAX_WK} windows a read")
    return _staged_kernels(slots, text32, skew, prep, k=k, m=m,
                           num_slots=num_slots, vb1=vb1, vb2=vb2, sc=sc,
                           RU=RU)


def _staged_kernels(slots, text32, skew, prep, *, k, m, num_slots, vb1, vb2,
                    sc, RU):
    """K2's three launches and csrc/staged.cu's three kernels between them,
    on the checked inputs of minidict2_staged_probe."""
    B, Wk = prep[0].shape
    RU, BH = _budgets(B, Wk, vb1, vb2, sc, RU)
    kw = dict(k=k, m=m, num_slots=num_slots)
    dev = slots.device
    lanes = probe_lanes(prep)
    hitA, valA, cnt, need = minidict2_probe(slots, text32, skew, prep,
                                            vb=vb1, stage1=True, **kw)
    lanesU = empty_lanes(lanes, (B, RU))
    lanesH = empty_lanes(lanes, (BH, Wk))
    umask = torch.empty((B, (Wk + 31) // 32), dtype=torch.int32, device=dev)
    heavy = torch.empty((B + 31) // 32, dtype=torch.int32, device=dev)
    hpre = torch.empty((B + 31) // 32, dtype=torch.int32, device=dev)
    lib = kernels.library()
    stream = kernels.stream_of(slots)
    rc = lib.fulgor_staged_split(
        kernels.pointers(lanes), hitA.data_ptr(), cnt.data_ptr(),
        need.data_ptr(), B, Wk, vb1, RU, BH, kernels.pointers(lanesU),
        kernels.pointers(lanesH), umask.data_ptr(), heavy.data_ptr(),
        hpre.data_ptr(), stream)
    kernels.check(rc, "staged_probe")
    kernels.launches["staged_probe"] += 2  # split, gather
    hitU, valU, ovfU = minidict2_probe(slots, text32, skew,
                                       prep_of_lanes(lanesU), vb=vb2, sc=sc,
                                       **kw)
    hitH, valH, ovfH = minidict2_probe(slots, text32, skew,
                                       prep_of_lanes(lanesH), vb=vb2, sc=sc,
                                       **kw)
    hit = torch.empty((B, Wk), dtype=torch.bool, device=dev)
    csid = torch.empty((B, Wk), dtype=torch.int32, device=dev)
    ovf = torch.empty((B, Wk), dtype=torch.bool, device=dev)
    rc = lib.fulgor_staged_merge(
        hitA.data_ptr(), valA.data_ptr(), umask.data_ptr(), heavy.data_ptr(),
        hpre.data_ptr(), hitU.data_ptr(), valU.data_ptr(), ovfU.data_ptr(),
        hitH.data_ptr(), valH.data_ptr(), ovfH.data_ptr(), B, Wk, RU, BH,
        hit.data_ptr(), csid.data_ptr(), ovf.data_ptr(), stream)
    kernels.check(rc, "staged_probe")
    kernels.launches["staged_probe"] += 1
    return hit, csid, ovf
