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

Two modes, _probe_entries' keyword flags (compile-time variants of the
kernel):

  stage1=True      stop after step 1 -> (hit, csid, cnt int32, need_sec
                   bool): cnt counts every strand-compatible in-span
                   candidate over all SCAN slots (not capped at vb), and
                   need_sec is not masked by usable (the staged probe's
                   stage A, ops/staged.py);
  want_entry=True  also the winning candidate's (q int32, rc bool, wlo
                   int32, sp int32), from either route, 0/False where none
                   won (the run-anchored probe, ops/anchored.py).

fulgor_tpu's `gate` needs no mode: a lane outside it reports no hit and no
ovf, as a lane that is not usable does, so callers pass usable & gate.
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
MAX_LANES = (1 << 31) - 256  # the kernel's lane index is 32-bit
# K10 and K11 keep a read's window masks one 32-bit word a lane
# (csrc/probe.cuh kMaxWk)
MAX_WK = 1024


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
                          sc: int = SKEW_CAND, stage1: bool = False,
                          want_entry: bool = False):
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
    w_sel = [z.clone() for _ in range(vb)]
    s_sel = [z.clone() for _ in range(vb)]
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
                if want_entry:
                    w_sel[j] = torch.where(upd, wlo, w_sel[j])
                    s_sel[j] = torch.where(upd, sp, s_sel[j])
            cnt += cand
    need_sec |= n_occ >= SCAN

    hit = torch.zeros_like(use)
    val = torch.full_like(minval, INVALID_U32)
    entry = (z.clone(), torch.zeros_like(use), z.clone(), z.clone())

    def won(new, q, rc, wlo, sp):
        """The winning candidate's (q, rc, wlo, sp) where `new` hits."""
        if not want_entry:
            return entry
        return tuple(torch.where(new, a, e)
                     for a, e in zip((q, rc, wlo, sp), entry))

    for j in range(vb):
        has = cnt > j
        tlo, thi = _extract33(text, torch.where(has, q_sel[j], 0))
        okv = (has & ((tlo & lo_mask) == torch.where(o_sel[j], rlo, flo))
               & ((thi & hi_mask) == torch.where(o_sel[j], rhi, fhi)))
        val = torch.where(okv & ~hit, cs_sel[j], val)
        entry = won(okv & ~hit, q_sel[j], o_sel[j], w_sel[j], s_sel[j])
        hit |= okv
    if stage1:
        return hit, i32(val), cnt.to(torch.int32), need_sec

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
        entry = won(okv & ~hit, torch.where(cand_f, q_f, q_r), ~cand_f, wlo,
                    sp)
        hit |= okv

    ovf = (use & ~hit & (cnt > vb)) | (gate & ~hit & ((cnt2 > sc) | tie))
    val = torch.where(hit, val, INVALID_U32)
    if want_entry:
        q, rc, wlo, sp = entry
        return (hit, i32(val), ovf, q.to(torch.int32), rc,
                wlo.to(torch.int32), sp.to(torch.int32))
    return hit, i32(val), ovf


def probe_lanes(prep):
    """The ten fields of a window prep that the probe reads, in the
    kernel's argument order: (minval, iL, iR, sigL, sigR, flo, fhi, rlo,
    rhi, usable)."""
    (minval, iL, iR, _pL, _pR, sigL, sigR, flo, fhi, rlo, rhi,
     usable) = prep
    return (minval, iL, iR, sigL, sigR, flo, fhi, rlo, rhi, usable)


def prep_of_lanes(lanes):
    """A window prep made of probe_lanes' ten fields; its pL and pR, which
    the probe does not read, are iL and iR."""
    minval, iL, iR, sigL, sigR, flo, fhi, rlo, rhi, usable = lanes
    return (minval, iL, iR, iL, iR, sigL, sigR, flo, fhi, rlo, rhi, usable)


def empty_lanes(lanes, shape):
    """Uninitialised tensors of `shape` with the dtypes of probe_lanes'
    fields, on their device (the compacted lanes of K10 and K11)."""
    return [torch.empty(shape, dtype=t.dtype, device=t.device)
            for t in lanes]


def check_probe_inputs(name, slots, text32, skew, prep):
    """Raise unless the tables and the prep's probe fields are contiguous
    CUDA tensors of the kernels' dtypes and shapes, on one device, and the
    tables start 16-byte aligned."""
    if slots.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {slots.device}")
    tabs = (slots, text32, skew)
    if (any(t.dtype != torch.int32 or not t.is_contiguous()
            or t.device != slots.device for t in tabs)
            or slots.shape[1] != 3 * ROWW or text32.shape[1] != 4
            or skew.shape[1] != SKEW_ROWW):
        raise ValueError(f"{name}: tables must be contiguous int32 "
                         "(R, 24), (N, 4), (NR, 8) on one device")
    if any(t.data_ptr() % 16 for t in tabs):
        raise ValueError(f"{name}: the kernels read slot, text and skew "
                         "rows as 16-byte vectors: the tables must start "
                         "16-byte aligned")
    shape = tuple(prep[0].shape)
    dtypes = (torch.int32,) * 3 + (torch.bool,) * 2 + (torch.int32,) * 4 + (
        torch.bool,)
    if len(shape) != 2 or any(
            tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != slots.device or t.dtype != d
            for t, d in zip(probe_lanes(prep), dtypes)):
        raise ValueError(f"{name}: prep tensors must be contiguous, of one "
                         "(B, Wk) shape and of window_prep's dtypes on the "
                         "tables' device")


def minidict2_probe(slots, text32, skew, prep, *, k: int, m: int,
                    num_slots: int, vb: int = VERIFY_BUDGET,
                    sc: int = SKEW_CAND, stage1: bool = False,
                    want_entry: bool = False):
    """Probe every window lane of `prep` (ops/prep.window_prep output)
    against the device tables (Index.device_tables: slots, text32, skew as
    int32 bit patterns). -> (hit, csid, ovf), each (B, Wk); with stage1
    (hit, csid, cnt, need_sec), with want_entry (hit, csid, ovf, q, rc,
    wlo, sp)."""
    if stage1 and want_entry:
        raise ValueError("minidict2_probe: stage1 and want_entry exclude "
                         "each other")
    if slots.device.type == "cpu":
        return minidict2_probe_plain(slots, text32, skew, prep, k=k, m=m,
                                     num_slots=num_slots, vb=vb, sc=sc,
                                     stage1=stage1, want_entry=want_entry)
    check_probe_inputs("minidict2_probe", slots, text32, skew, prep)
    if not (0 <= vb and 0 <= sc <= MAX_SKEW_CAND and 0 < num_slots < 1 << 32):
        raise ValueError(f"minidict2_probe: unsupported budget ({vb}, {sc})")
    lanes = probe_lanes(prep)
    minval = lanes[0]
    shape = tuple(minval.shape)
    dev = slots.device

    def out(dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    hit, csid = out(torch.bool), out(torch.int32)
    ovf = None if stage1 else out(torch.bool)
    if stage1:
        mode, extra = 1, (out(torch.int32), out(torch.bool))
    elif want_entry:
        mode, extra = 2, (out(torch.int32), out(torch.bool),
                          out(torch.int32), out(torch.int32))
    else:
        mode, extra = 0, ()
    outs = tuple(t for t in (hit, csid, ovf) if t is not None) + extra
    n = minval.numel()
    if n == 0:
        return outs
    if n > MAX_LANES:
        raise ValueError(f"minidict2_probe: at most {MAX_LANES} lanes a "
                         f"launch, not {n}")
    ptrs = [t.data_ptr() for t in extra] + [None] * (4 - len(extra))
    lib = kernels.library()
    rc = lib.fulgor_minidict2_probe(
        slots.data_ptr(), slots.shape[0], text32.data_ptr(), text32.shape[0],
        skew.data_ptr(), skew.shape[0], *(t.data_ptr() for t in lanes),
        n, k, m, num_slots, vb, sc, mode, hit.data_ptr(), csid.data_ptr(),
        None if ovf is None else ovf.data_ptr(), *ptrs,
        kernels.stream_of(slots))
    kernels.check(rc, "minidict2_probe")
    kernels.launches["minidict2_probe"] += 1
    return outs
