"""Minimizer-dictionary probe with the skew route (kernel K2).

Counterpart of fulgor_tpu/ops/minidict2.py _probe_entries,
skew_probe_device and _make_extract33, with mix32/mulhi32 of
ops/lookup.py. Per window lane, given the window prep (ops/prep.py):

  1. bucket = fastrange(mix32(minval), num_slots); screen the SCAN slots of
     its row for entries with the window's 15-bit fingerprint, in span and
     strand-compatible; take candidates in slot order (forward before
     reverse complement within a slot) and text-verify the first `vb`
     against the 62-bit k-mer (3 u32 words of text per extract);
  2. lanes still missing whose fingerprint hits a covered entry or a full
     window (need_sec) route through the skew table: two rows of 8
     pointers keyed by the canonical k-mer, the first `sc` fp8 matches in
     (row 1, row 2) entry order, one oriented text verify each;
  3. ovf = candidates left over, or the skew route overflowed or tied.

-> (hit bool, csid int32 bit pattern, INVALID where no hit; ovf bool),
each (B, Wk). `minidict2_probe` launches csrc/probe.cu for CUDA tensors
and runs the plain version for CPU tensors. Budgets may be trimmed: a
trimmed probe stays exact where it decides and only raises ovf more often.
"""

from __future__ import annotations

import torch

from ..constants import INVALID_U32
from . import kernels
from .minidict2 import (
    ROWW, SCAN, SKEW_CAND, SKEW_ROWW, SKEW_SEED1, SKEW_SEED2, VERIFY_BUDGET,
)
from .u32 import M32, i32, mix32, mulhi32, u32

MAX_SKEW_CAND = 2 * SKEW_ROWW  # the kernel keeps at most this many pointers


def _masks(k: int):
    lo_mask = M32 if 2 * k >= 32 else (1 << (2 * k)) - 1
    hi_mask = (1 << (2 * k - 32)) - 1 if 2 * k > 32 else 0
    return lo_mask, hi_mask


def _extract33(text: torch.Tensor, q: torch.Tensor):
    """(lo, hi) = the 32 LSB-first bases of the text at base position q."""
    row = text[torch.clamp(q >> 5, 0, text.shape[0] - 1)]
    sh = 2 * (q & 31)
    big = sh >= 32
    s2 = torch.where(big, sh - 32, sh)
    a0 = torch.where(big, row[..., 1], row[..., 0])
    a1 = torch.where(big, row[..., 2], row[..., 1])
    a2 = torch.where(big, row[..., 3], row[..., 2])
    nz = s2 > 0
    inv = torch.where(nz, 32 - s2, 1)
    lo = torch.where(nz, ((a0 >> s2) | (a1 << inv)) & M32, a0)
    hi = torch.where(nz, ((a1 >> s2) | (a2 << inv)) & M32, a1)
    return lo, hi


def minidict2_probe_plain(slots, text32, skew, prep, *, k: int, m: int,
                          num_slots: int, vb: int = VERIFY_BUDGET,
                          sc: int = SKEW_CAND):
    """Plain PyTorch probe (any device), the JAX formulation in int64."""
    (minval, iL, iR, _pL, _pR, sigL, sigR, flo, fhi, rlo, rhi,
     use) = prep
    minval, flo, fhi, rlo, rhi = map(u32, (minval, flo, fhi, rlo, rhi))
    iL, iR = iL.to(torch.int64), iR.to(torch.int64)
    slots, text, skew = u32(slots), u32(text32), u32(skew)
    lo_mask, hi_mask = _masks(k)
    z = torch.zeros_like(minval)

    kk = mix32(minval)
    baseR = mulhi32(kk, num_slots) >> (ROWW.bit_length() - 1)
    fp = kk & 0x7FFF
    rows = [slots[torch.clamp(baseR + j, 0, slots.shape[0] - 1)]
            for j in range(SCAN // ROWW)]

    cnt = z.clone()
    n_occ = z.clone()
    need_sec = torch.zeros_like(use)
    q_sel = [z.clone() for _ in range(vb)]
    o_sel = [torch.zeros_like(use) for _ in range(vb)]
    cs_sel = [z.clone() for _ in range(vb)]
    for s in range(SCAN):
        row = rows[s // ROWW]
        off = 3 * (s % ROWW)
        wlo, cs, ms = row[..., off], row[..., off + 1], row[..., off + 2]
        sp = (ms >> 8) & 0x7F
        cov = ((ms >> 15) & 1) == 1
        efp = (ms >> 16) & 0x7FFF
        st = (ms >> 31) == 1
        need_sec |= cov & (efp == fp)
        n_occ += (sp > 0) | cov
        okc = use & (sp > 0) & (efp == fp) & ~cov
        mpos = wlo + (ms & 0xFF)
        for orient, q, sok in ((False, mpos - iL, sigL == st),
                               (True, mpos - (k - m) + iR, sigR != st)):
            cand = okc & sok & (q >= wlo) & (q < wlo + sp)
            for j in range(vb):
                upd = cand & (cnt == j)
                q_sel[j] = torch.where(upd, q, q_sel[j])
                o_sel[j] = torch.where(upd, orient, o_sel[j])
                cs_sel[j] = torch.where(upd, cs, cs_sel[j])
            cnt += cand
    need_sec |= n_occ >= SCAN

    hit = torch.zeros_like(use)
    val = torch.full_like(minval, INVALID_U32)
    for j in range(vb):
        has = cnt > j
        tlo, thi = _extract33(text, torch.where(has, q_sel[j], 0))
        okv = (has & ((tlo & lo_mask) == torch.where(o_sel[j], rlo, flo))
               & ((thi & hi_mask) == torch.where(o_sel[j], rhi, fhi)))
        val = torch.where(okv & ~hit, cs_sel[j], val)
        hit |= okv

    # skew route, gathered only where gated
    gate = use & ~hit & need_sec
    take_f = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    klo = torch.where(take_f, flo, rlo)
    khi = torch.where(take_f, fhi, rhi)
    h1 = mix32(klo ^ mix32(khi ^ SKEW_SEED1))
    h2 = mix32(klo ^ mix32(khi ^ SKEW_SEED2))
    fp8 = h1 & 0xFF
    cnt2 = z.clone()
    sid = [z.clone() for _ in range(sc)]
    for h in (h1, h2):
        srow = skew[torch.where(gate, mulhi32(h, skew.shape[0]), 0)]
        for e in range(SKEW_ROWW):
            v = srow[..., e]
            mca = gate & (v != 0) & ((v & 0xFF) == fp8)
            for j in range(sc):
                sid[j] = torch.where(mca & (cnt2 == j), (v >> 8) - 1, sid[j])
            cnt2 += mca
    flat = slots.reshape(-1, 3)
    tie = torch.zeros_like(use)
    for j in range(sc):
        has = gate & (cnt2 > j) & ~hit
        ent = flat[torch.where(has, sid[j], 0)]
        wlo, cs, ms = ent[..., 0], ent[..., 1], ent[..., 2]
        sp = (ms >> 8) & 0x7F
        st = (ms >> 31) == 1
        mpos = wlo + (ms & 0xFF)
        q_f = mpos - iL
        q_r = mpos - (k - m) + iR
        span_ok = has & (sp > 0)
        cand_f = span_ok & (q_f >= wlo) & (q_f < wlo + sp) & (sigL == st)
        cand_r = span_ok & (q_r >= wlo) & (q_r < wlo + sp) & (sigR != st)
        cand1 = cand_f | cand_r
        tlo, thi = _extract33(
            text, torch.where(cand1, torch.where(cand_f, q_f, q_r), 0))
        okv = (cand1 & ((tlo & lo_mask) == torch.where(cand_f, flo, rlo))
               & ((thi & hi_mask) == torch.where(cand_f, fhi, rhi)))
        tie |= cand_f & cand_r & ~okv
        val = torch.where(okv & ~hit, cs, val)
        hit |= okv

    ovf = (use & ~hit & (cnt > vb)) | (gate & ~hit & ((cnt2 > sc) | tie))
    val = torch.where(hit, val, INVALID_U32)
    return hit, i32(val), ovf


def minidict2_probe(slots, text32, skew, prep, *, k: int, m: int,
                    num_slots: int, vb: int = VERIFY_BUDGET,
                    sc: int = SKEW_CAND):
    """Probe every window lane of `prep` (ops/prep.window_prep output)
    against the device tables (Index.device_tables: slots, text32, skew as
    int32 bit patterns). -> (hit, csid, ovf), each (B, Wk)."""
    if slots.device.type == "cpu":
        return minidict2_probe_plain(slots, text32, skew, prep, k=k, m=m,
                                     num_slots=num_slots, vb=vb, sc=sc)
    if slots.device.type != "cuda":
        raise ValueError(f"minidict2_probe: unsupported device {slots.device}")
    if not (0 <= vb and 0 <= sc <= MAX_SKEW_CAND and 0 < num_slots < 1 << 32):
        raise ValueError(f"minidict2_probe: unsupported budget ({vb}, {sc})")
    tabs = (slots, text32, skew)
    if (any(t.dtype != torch.int32 or not t.is_contiguous()
            or t.device != slots.device for t in tabs)
            or slots.shape[1] != 3 * ROWW or text32.shape[1] != 4
            or skew.shape[1] != SKEW_ROWW):
        raise ValueError("minidict2_probe: tables must be contiguous int32 "
                         "(R, 24), (N, 4), (NR, 8) on one device")
    (minval, iL, iR, _pL, _pR, sigL, sigR, flo, fhi, rlo, rhi,
     usable) = prep
    lanes = (minval, iL, iR, sigL, sigR, flo, fhi, rlo, rhi, usable)
    shape = tuple(minval.shape)
    if any(tuple(t.shape) != shape or not t.is_contiguous()
           or t.device != slots.device for t in lanes):
        raise ValueError("minidict2_probe: prep tensors must be contiguous "
                         "and of one shape on the tables' device")
    dev = slots.device
    hit = torch.empty(shape, dtype=torch.bool, device=dev)
    csid = torch.empty(shape, dtype=torch.int32, device=dev)
    ovf = torch.empty(shape, dtype=torch.bool, device=dev)
    n = minval.numel()
    if n == 0:
        return hit, csid, ovf
    lib = kernels.library()
    rc = lib.fulgor_minidict2_probe(
        slots.data_ptr(), slots.shape[0], text32.data_ptr(), text32.shape[0],
        skew.data_ptr(), skew.shape[0], *(t.data_ptr() for t in lanes),
        n, k, m, num_slots, vb, sc,
        hit.data_ptr(), csid.data_ptr(), ovf.data_ptr(),
        kernels.stream_of(slots))
    kernels.check(rc, "minidict2_probe")
    kernels.launches["minidict2_probe"] += 1
    return hit, csid, ovf
