"""Minimizer-positional k-mer dictionary, v1 (fulgor_tpu's ops/minidict.py):
the shared definitions of the minimizer dictionaries, the v1 host build and
host query, and its device lookup (kernel K14).

The v1 dictionary stores one 12-byte entry per maximal run of k-mer
positions whose leftmost minimizer position is constant, bucket ranges of
the entries by minimizer hash, and overlapping rows of the unitig text it
verifies against: a few bytes a k-mer. No index or engine builds it: its path is
this module's API (build_minidict, lookup_minidict_host,
lookup_minidict_batch), as in fulgor_tpu.

Definitions (host build and device query MUST agree exactly):

* m-mer order: Hm = mix32(lo ^ mix32(hi ^ SEED_M)) of the CANONICAL m-mer
  (min of fwd/rc packings) — symmetric under reverse complement.
* window minimizer of the k-mer at position p: min of Hm over offsets
  [0, k-m]; the LEFTMOST and RIGHTMOST argmin are the window's
  distinguished occurrences (reversing a window maps its rightmost
  minimizer occurrence to the leftmost of the reverse complement).
* k-mer packings: LSB-first 2-bit, forward and reverse complement, split
  into u32 halves.
* v1 entry per run: (wlo u32, csid u32, moff u8 | span u8 << 8), wlo the
  run's first k-mer position in the text, span its length (<= 255, longer
  runs split), moff = minimizer position - wlo. bucket = Hm & (NB - 1).
* v1 verification of a window with leftmost argmin offset iL and rightmost
  iR against an entry: forward q = wlo + moff - iL, reverse complement
  q = wlo + moff - (k - m) + iR; a strand matches iff q lies in
  [wlo, wlo + span) and the 2k-bit text k-mer at q equals the window's
  packing of that strand. Entries in bucket order, forward before reverse:
  the first match wins. A window whose bucket holds more than
  max_candidates entries is ovf (no hit; the exact host query decides).

The device lookup runs K8 pack_codes -> K1 window_prep (ops/prep.py), which
compute the same minimizers and packings bit for bit, then K14
minidict_v1_verify (csrc/minidict.cu), the bucket and candidate loop.
`lookup_minidict_batch` launches them for CUDA tensors and runs the plain
version `lookup_minidict_batch_plain` for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import INVALID_U32
from ..core import kmers as K
from . import kernels
from .u32 import M32, i32, mix32, u32

SEED_M = 0x713A9C5B
MAX_CANDIDATES = 8
MAX_SPAN = 255  # a v1 entry's span is one byte


# --------------------------------------------------------------------------
# shared scalar helpers (numpy)
# --------------------------------------------------------------------------


def _mix32_np(x):
    x = x.astype(np.uint32, copy=True)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def mmer_hashes(codes: np.ndarray, m: int):
    """Canonical m-mer hash per position of a code array; invalid positions
    (non-ACGT) get 0xFFFFFFFF. -> uint32 (len-m+1,)."""
    km, valid = K.pack_kmers(codes, m)
    if len(km) == 0:
        return np.empty(0, np.uint32)
    can = K.canonicalize(km, m)
    lo = (can & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (can >> np.uint64(32)).astype(np.uint32)
    h = _mix32_np(lo ^ _mix32_np(hi ^ np.uint32(SEED_M)))
    # 0xFFFFFFFF is the poison value for invalid positions; remap natural
    # collisions so a valid window can never look poisoned
    h[h == np.uint32(0xFFFFFFFF)] = np.uint32(0xFFFFFFFE)
    h[~valid] = np.uint32(0xFFFFFFFF)
    return h


def sliding_min_argmin(h: np.ndarray, w: int):
    """min + LEFTMOST and RIGHTMOST argmin over each window of length w.
    -> (minval (n,), left (n,), right (n,)) with n = len(h)-w+1."""
    n = len(h) - w + 1
    if n <= 0:
        return (np.empty(0, np.uint32),) * 3
    # log-step tournament keeping (value, pos); ties prefer smaller pos for
    # left, larger pos for right
    valL = h.astype(np.uint64) << np.uint64(32)
    valL |= np.arange(len(h), dtype=np.uint64)  # tie -> smaller pos wins min
    valR = h.astype(np.uint64) << np.uint64(32)
    valR |= np.uint64(0xFFFFFFFF) - np.arange(len(h), dtype=np.uint64)
    span = 1
    aL, aR = valL.copy(), valR.copy()
    while span < w:
        step = min(span, w - span)
        aL[: len(aL) - step] = np.minimum(aL[: len(aL) - step], aL[step:])
        aR[: len(aR) - step] = np.minimum(aR[: len(aR) - step], aR[step:])
        span += step
    aL, aR = aL[:n], aR[:n]
    minval = (aL >> np.uint64(32)).astype(np.uint32)
    left = (aL & np.uint64(0xFFFFFFFF)).astype(np.int64) - np.arange(n)
    right = (
        np.uint64(0xFFFFFFFF) - (aR & np.uint64(0xFFFFFFFF))
    ).astype(np.int64) - np.arange(n)
    return minval, left.astype(np.int32), right.astype(np.int32)


def window_packings_lsb(codes: np.ndarray, k: int):
    """fwd and rc LSB-first 62-bit packings of every k-window.
    -> (flo, fhi, rlo, rhi, valid) each (n,)."""
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return (np.empty(0, np.uint32),) * 4 + (np.empty(0, bool),)
    c = codes.astype(np.uint32)
    flo = np.zeros(n, np.uint32)
    fhi = np.zeros(n, np.uint32)
    rlo = np.zeros(n, np.uint32)
    rhi = np.zeros(n, np.uint32)
    ok = np.ones(n, bool)
    for i in range(k):
        ci = c[i : i + n]
        ok &= ci <= 3
        if 2 * i < 32:
            flo |= (ci & 3) << np.uint32(2 * i)
        else:
            fhi |= (ci & 3) << np.uint32(2 * i - 32)
        cj = (3 - c[k - 1 - i : k - 1 - i + n]) & np.uint32(3)
        if 2 * i < 32:
            rlo |= cj << np.uint32(2 * i)
        else:
            rhi |= cj << np.uint32(2 * i - 32)
    return flo, fhi, rlo, rhi, ok



def extract_text_kmer(text16: np.ndarray, q, k: int):
    """LSB-first 2k-bit k-mer at base position q from overlapping text rows.
    text16: (nrows, 3) uint32, row i = packed bases [16i, 16i+48).
    -> (lo u32, hi u32). Vectorized over q."""
    q = np.asarray(q, dtype=np.int64)
    row = text16[np.clip(q >> 4, 0, len(text16) - 1)]
    sh = (2 * (q & 15)).astype(np.uint32)
    w0, w1, w2 = row[..., 0], row[..., 1], row[..., 2]
    nz = sh > 0
    inv = np.where(nz, np.uint32(32) - sh, np.uint32(1))
    lo = np.where(nz, (w0 >> sh) | (w1 << inv), w0)
    hi = np.where(nz, (w1 >> sh) | (w2 << inv), w1)
    bits = 2 * k
    if bits <= 32:
        return lo & np.uint32((1 << bits) - 1) if bits < 32 else lo, np.zeros_like(hi)
    return lo, hi & np.uint32((1 << (bits - 32)) - 1)


def pack_text16(codes: np.ndarray):
    """Base codes -> overlapping (n, 3) uint32 rows, 16 bases/u32 LSB-first."""
    n = len(codes)
    nwords = (n + 15) // 16 + 2
    c = np.concatenate([codes & 3, np.zeros(nwords * 16 - n, dtype=np.uint8)]).astype(
        np.uint32
    )
    c = c.reshape(-1, 16)
    words = np.zeros(len(c), dtype=np.uint32)
    for i in range(16):
        words |= c[:, i] << np.uint32(2 * i)
    return np.stack([words[:-2], words[1:-1], words[2:]], axis=1)


# --------------------------------------------------------------------------
# v1 build
# --------------------------------------------------------------------------


@dataclass
class MiniDict:
    k: int
    m: int
    entries: np.ndarray  # (NE, 3) uint32 [wlo, csid, moff | span<<8]
    bucket_offs: np.ndarray  # (NB, 2) uint32 [start, count]
    text16: np.ndarray  # (nrows, 3) uint32 overlapping packed text

    def num_bytes(self) -> int:
        return int(self.entries.nbytes + self.bucket_offs.nbytes + self.text16.nbytes)

    def to(self, device=None) -> "MiniDictTables":
        """The three tables on `device` once, as int32 bit patterns: the
        card unless the caller names another device; raises where no card
        is available (the CPU only when asked for)."""
        from ..query.engine import resolve_device

        dev = resolve_device(device)
        t = [torch.from_numpy(a.view(np.int32)).to(dev)
             for a in (self.entries, self.bucket_offs, self.text16)]
        return MiniDictTables(self.k, self.m, *t)


@dataclass(frozen=True)
class MiniDictTables:
    """A MiniDict's tables on one device (MiniDict.to)."""
    k: int
    m: int
    entries: torch.Tensor  # (NE, 3) int32
    bucket_offs: torch.Tensor  # (NB, 2) int32
    text16: torch.Tensor  # (nrows, 3) int32

    def lookup(self, codes, *, max_candidates: int = 4):
        """lookup_minidict_batch of a (B, L) uint8 code batch on the
        tables' device."""
        return lookup_minidict_batch(
            self.entries, self.bucket_offs, self.text16, codes, k=self.k,
            m=self.m, max_candidates=max_candidates)


def build_minidict(unitig_codes, unitig_offs, unitig_cs, k, m) -> MiniDict:
    """The v1 dictionary of a ccdBG's unitigs: one entry per minimizer run
    (runs split at MAX_SPAN), entries sorted by bucket (stable), NB the
    least power of two >= max(2, NE)."""
    # minidict2 imports this module: its run construction is imported here
    from .minidict2 import _minimizer_runs

    r = _minimizer_runs(unitig_codes, unitig_offs, unitig_cs, k, m,
                        max_span=MAX_SPAN)
    NE = len(r["wlo"])
    NB = 1
    while NB < max(2, NE):
        NB <<= 1
    bucket = r["hash"] & np.uint32(NB - 1)
    order = np.argsort(bucket, kind="stable")
    meta = r["moff"] | (r["span"] << 8)
    entries = np.stack([r["wlo"][order], r["csid"][order], meta[order]],
                       axis=1).astype(np.uint32)
    cnt = np.bincount(bucket, minlength=NB)
    start = np.concatenate([[0], np.cumsum(cnt)])[:-1]
    bucket_offs = np.stack([start, cnt], axis=1).astype(np.uint32)
    return MiniDict(k, m, entries, bucket_offs, pack_text16(r["codes"]))


# --------------------------------------------------------------------------
# v1 host query (the oracle)
# --------------------------------------------------------------------------


def lookup_minidict_host(d: MiniDict, codes: np.ndarray):
    """Window lookup for one read -> (hit bool (Wk,), csid u32, overflow
    bool (Wk,)). Overflowed windows (bucket larger than MAX_CANDIDATES)
    report ovf=True and hit=False."""
    k, m = d.k, d.m
    L = len(codes)
    Wk = L - k + 1
    hit = np.zeros(max(0, Wk), dtype=bool)
    out = np.full(max(0, Wk), INVALID_U32, dtype=np.uint32)
    ovf = np.zeros(max(0, Wk), dtype=bool)
    if Wk <= 0:
        return hit, out, ovf
    h = mmer_hashes(codes, m)
    minval, left, right = sliding_min_argmin(h, k - m + 1)
    flo, fhi, rlo, rhi, okw = window_packings_lsb(codes, k)
    NB = len(d.bucket_offs)
    for p in range(Wk):
        if not okw[p] or minval[p] == 0xFFFFFFFF:
            continue
        b = int(minval[p]) & (NB - 1)
        start, cnt = d.bucket_offs[b]
        if cnt > MAX_CANDIDATES:
            ovf[p] = True
            continue
        for e in range(int(cnt)):
            wlo, cs, ms = d.entries[start + e]
            mo, sp = int(ms) & 0xFF, int(ms) >> 8
            mpos = int(wlo) + mo
            # forward, then reverse complement
            for q, wl, wh in ((mpos - int(left[p]), flo[p], fhi[p]),
                              (mpos - (k - m) + int(right[p]), rlo[p],
                               rhi[p])):
                if int(wlo) <= q < int(wlo) + sp:
                    tlo, thi = extract_text_kmer(d.text16, np.array([q]), k)
                    if tlo[0] == wl and thi[0] == wh:
                        hit[p] = True
                        out[p] = cs
                        break
            if hit[p]:
                break
    return hit, out, ovf


# --------------------------------------------------------------------------
# v1 device query: plain PyTorch version, K14 and the wrapper
# --------------------------------------------------------------------------


def _text_kmer(text16, q, k: int):
    """extract_text_kmer on int64-held u32 rows: text16 (nrows, 3) int32
    bit patterns, q int64 -> (lo, hi) int64."""
    row = u32(text16[(q >> 4).clamp(0, text16.shape[0] - 1)])
    sh = 2 * (q & 15)
    w0, w1, w2 = row[..., 0], row[..., 1], row[..., 2]
    nz = sh > 0
    inv = torch.where(nz, 32 - sh, 1)
    lo = torch.where(nz, (w0 >> sh) | ((w1 << inv) & M32), w0)
    hi = torch.where(nz, (w1 >> sh) | ((w2 << inv) & M32), w1)
    bits = 2 * k
    if bits <= 32:
        return lo & ((1 << bits) - 1), torch.zeros_like(hi)
    return lo, hi & ((1 << (bits - 32)) - 1)


def minidict_v1_verify_plain(entries, bucket_offs, text16, prep, *, k: int,
                             m: int, max_candidates: int = 4):
    """Plain PyTorch version of K14 (any device): the bucket and candidate
    loop of fulgor_tpu's lookup_minidict_batch (:397-446) over window
    minimizers and packings. prep: (minval, iL, iR, flo, fhi, rlo, rhi,
    usable), each (B, Wk), u32 as int32 bit patterns, usable bool.
    -> (hit bool, csid int32 (INVALID_U32 where no hit), ovf bool)."""
    minval, iL, iR, flo, fhi, rlo, rhi, usable = prep
    NB = bucket_offs.shape[0]
    iL, iR = iL.to(torch.int64), iR.to(torch.int64)
    brow = u32(bucket_offs[u32(minval) & (NB - 1)])
    start, cnt = brow[..., 0], brow[..., 1]
    ovf = usable & (cnt > max_candidates)
    hit = torch.zeros_like(usable)
    val = torch.full(usable.shape, INVALID_U32, dtype=torch.int64,
                     device=usable.device)
    packs = ((u32(flo), u32(fhi)), (u32(rlo), u32(rhi)))
    for e in range(max_candidates if entries.shape[0] else 0):
        has = usable & (e < cnt)
        ent = u32(entries[torch.where(has, start + e, 0)])
        wlo, cs, ms = ent[..., 0], ent[..., 1], ent[..., 2]
        sp = ms >> 8
        mpos = wlo + (ms & 0xFF)
        for q, (wl, wh) in zip((mpos - iL, mpos - (k - m) + iR), packs):
            inb = has & (q >= wlo) & (q < wlo + sp)
            tlo, thi = _text_kmer(text16, torch.where(inb, q, 0), k)
            match = inb & (tlo == wl) & (thi == wh)
            val = torch.where(match & ~hit, cs, val)
            hit = hit | match
    hit = hit & ~ovf
    return hit, i32(torch.where(hit, val, INVALID_U32)), ovf


def _window_minimizers_plain(codes, *, k: int, m: int):
    """fulgor_tpu's lookup_minidict_batch (:343-395) on int64 tensors: the
    canonical m-mer hashes (poisoned where a base is invalid), the sliding
    minimum with its leftmost and rightmost argmin by a log-step
    tournament, and the LSB-first window packings.
    -> prep as minidict_v1_verify_plain takes it."""
    B, L = codes.shape
    dev = codes.device
    Wk, Wm, w = L - k + 1, L - m + 1, k - m + 1
    c = codes.to(torch.int64)
    ok = c <= 3
    # canonical m-mers, big-endian (base i at bits 2(m-1-i)): 2m <= 62 bits
    fwd = torch.zeros((B, Wm), dtype=torch.int64, device=dev)
    rc = torch.zeros_like(fwd)
    ok_m = torch.ones((B, Wm), dtype=torch.bool, device=dev)
    for i in range(m):
        ci = c[:, i:i + Wm]
        fwd |= (ci & 3) << (2 * (m - 1 - i))
        rc |= ((3 - c[:, m - 1 - i:m - 1 - i + Wm]) & 3) << (2 * (m - 1 - i))
        ok_m &= ok[:, i:i + Wm]
    can = torch.minimum(fwd, rc)
    h = mix32((can & M32) ^ mix32((can >> 32) ^ SEED_M))
    h = torch.where(h == M32, M32 - 1, h)
    h = torch.where(ok_m, h, M32)

    pos = torch.arange(Wm, device=dev).expand(B, Wm)
    vL, pL, vR, pR = h, pos, h, pos
    span = 1
    while span < w:
        step = min(span, w - span)
        n = vL.shape[1] - step
        bv, bp, av, ap = vL[:, step:], pL[:, step:], vL[:, :n], pL[:, :n]
        take = (bv < av) | ((bv == av) & (bp < ap))
        vL, pL = torch.where(take, bv, av), torch.where(take, bp, ap)
        bv, bp, av, ap = vR[:, step:], pR[:, step:], vR[:, :n], pR[:, :n]
        take = (bv < av) | ((bv == av) & (bp > ap))
        vR, pR = torch.where(take, bv, av), torch.where(take, bp, ap)
        span += step
    minval = vL[:, :Wk]
    kpos = torch.arange(Wk, device=dev)
    iL, iR = pL[:, :Wk] - kpos, pR[:, :Wk] - kpos

    z = torch.zeros((B, Wk), dtype=torch.int64, device=dev)
    flo, fhi, rlo, rhi = z.clone(), z.clone(), z.clone(), z.clone()
    okw = torch.ones((B, Wk), dtype=torch.bool, device=dev)
    for i in range(k):
        ci = c[:, i:i + Wk]
        cj = (3 - c[:, k - 1 - i:k - 1 - i + Wk]) & 3
        okw &= ok[:, i:i + Wk]
        if 2 * i < 32:
            flo |= (ci & 3) << (2 * i)
            rlo |= cj << (2 * i)
        else:
            fhi |= (ci & 3) << (2 * i - 32)
            rhi |= cj << (2 * i - 32)
    usable = okw & (minval != M32)
    return (i32(minval), iL.to(torch.int32), iR.to(torch.int32), i32(flo),
            i32(fhi), i32(rlo), i32(rhi), usable)


def lookup_minidict_batch_plain(entries, bucket_offs, text16, codes, *,
                                k: int, m: int, max_candidates: int = 4):
    """Plain PyTorch version of fulgor_tpu's lookup_minidict_batch (any
    device). entries (NE, 3), bucket_offs (NB, 2), text16 (nrows, 3) int32
    bit patterns; codes (B, L) uint8 (0..3, >= 4 invalid or pad).
    -> (hit (B, Wk) bool, csid (B, Wk) int32, INVALID_U32 where no hit,
    ovf (B, Wk) bool), Wk = L - k + 1."""
    _check_shape(codes, k, m)
    prep = _window_minimizers_plain(codes, k=k, m=m)
    return minidict_v1_verify_plain(entries, bucket_offs, text16, prep, k=k,
                                    m=m, max_candidates=max_candidates)


def _check_shape(codes, k: int, m: int):
    if codes.dim() != 2 or codes.shape[1] < k or not 1 <= m <= k <= 32:
        raise ValueError(f"minidict v1 lookup: codes (B, L >= k) with "
                         f"1 <= m <= k <= 32, got {tuple(codes.shape)}, "
                         f"k={k}, m={m}")


def lookup_in_pieces(codes, *, k: int, piece: int, run):
    """A (B, L) batch's window lookup through pieces of `piece` bases that
    overlap by k - 1: run((N, piece) codes) -> (hit, csid, ovf), each
    (N, piece - k + 1). Each window's answer depends on its own k bases
    only, so the pieces' windows, concatenated, are the read's. Bases past
    L are code 4 (pad). -> (hit, csid, ovf), each (B, L - k + 1)."""
    B, L = codes.shape
    Wk, step = L - k + 1, piece - k + 1
    if step < 1:
        raise ValueError(f"lookup_in_pieces: piece {piece} < k {k}")
    n = -(-Wk // step)
    full = codes.new_full((B, (n - 1) * step + piece), 4)
    full[:, :L] = codes
    rows = full.unfold(1, piece, step).reshape(B * n, piece)
    return tuple(o.reshape(B, n * step)[:, :Wk].contiguous()
                 for o in run(rows.contiguous()))


def minidict_v1_verify(entries, bucket_offs, text16, prep, *, k: int, m: int,
                       max_candidates: int = 4):
    """K14 on K1's window fields: prep = (minval, iL, iR, flo, fhi, rlo,
    rhi, usable), each (N, Wk), on the tables' device. -> (hit bool, csid
    int32, ovf bool), each (N, Wk). For CPU tensors, the plain version."""
    if entries.device.type == "cpu":
        return minidict_v1_verify_plain(entries, bucket_offs, text16, prep,
                                        k=k, m=m, max_candidates=max_candidates)
    if entries.device.type != "cuda":
        raise ValueError(f"minidict_v1_verify: unsupported device "
                         f"{entries.device}")
    NB = bucket_offs.shape[0]
    shape = tuple(prep[0].shape)
    tables_ok = (
        entries.dim() == 2 and entries.shape[1] == 3
        and tuple(bucket_offs.shape) == (NB, 2) and NB >= 2
        and NB & (NB - 1) == 0 and text16.dim() == 2
        and text16.shape[1] == 3 and text16.shape[0] >= 1
        and all(t.dtype == torch.int32 and t.is_contiguous()
                and t.device == entries.device
                for t in (entries, bucket_offs, text16)))
    prep_ok = len(prep) == 8 and all(
        tuple(t.shape) == shape and t.is_contiguous()
        and t.device == entries.device
        and t.dtype == (torch.bool if i == 7 else torch.int32)
        for i, t in enumerate(prep))
    if not (tables_ok and prep_ok and len(shape) == 2
            and 1 <= m <= k <= 32 and 0 <= max_candidates < 256):
        raise ValueError(
            "minidict_v1_verify: entries (NE, 3), bucket_offs (NB, 2) with NB "
            "a power of two, text16 (nrows, 3), int32; prep eight (N, Wk) "
            "tensors (int32, usable bool), contiguous on one card; "
            "1 <= m <= k <= 32, 0 <= max_candidates < 256")
    dev = entries.device
    hit = torch.empty(shape, dtype=torch.bool, device=dev)
    csid = torch.empty(shape, dtype=torch.int32, device=dev)
    ovf = torch.empty(shape, dtype=torch.bool, device=dev)
    n = shape[0] * shape[1]
    if n == 0:
        return hit, csid, ovf
    lib = kernels.library()
    rc = lib.fulgor_minidict_v1_verify(
        entries.data_ptr(), entries.shape[0], bucket_offs.data_ptr(), NB,
        text16.data_ptr(), text16.shape[0], *(t.data_ptr() for t in prep),
        n, k, m, max_candidates, hit.data_ptr(), csid.data_ptr(),
        ovf.data_ptr(), kernels.stream_of(entries))
    kernels.check(rc, "minidict_v1_verify")
    kernels.launches["minidict_v1_verify"] += 1
    return hit, csid, ovf


# K1's fields that K14 reads, in its order
V1_FIELDS = ("minval", "iL", "iR", "flo", "fhi", "rlo", "rhi", "usable")


def lookup_by_kernels(entries, bucket_offs, text16, codes, *, k: int,
                      m: int, max_candidates: int = 4, max_width=None):
    """The card path of lookup_minidict_batch: the reads in pieces of at
    most max_width bases (K1's MAX_WIDTH by default), each rounded up to a
    multiple of 32 (lookup_in_pieces), then K8 pack_codes, K1 window_prep
    and K14 minidict_v1_verify, one launch each for the whole batch. Each
    of the three wrappers takes its plain version for CPU tensors, so on
    the CPU this is the same composition of plain versions."""
    from .prep import MAX_WIDTH, PREP_FIELDS, pack_codes, window_prep

    B, L = codes.shape
    piece = min(max_width or MAX_WIDTH, -(-L // 32) * 32)
    take = [PREP_FIELDS.index(f) for f in V1_FIELDS]

    def run(rows):
        words, badw = pack_codes(rows)
        prep = window_prep(words.view(torch.uint8), badw.view(torch.uint8),
                           width=piece, k=k, m=m)
        return minidict_v1_verify(entries, bucket_offs, text16,
                                  tuple(prep[i] for i in take), k=k, m=m,
                                  max_candidates=max_candidates)

    if B == 0:
        Wk = L - k + 1
        return (codes.new_zeros((0, Wk), dtype=torch.bool),
                codes.new_zeros((0, Wk), dtype=torch.int32),
                codes.new_zeros((0, Wk), dtype=torch.bool))
    return lookup_in_pieces(codes, k=k, piece=piece, run=run)


def lookup_minidict_batch(entries, bucket_offs, text16, codes, *, k: int,
                          m: int, max_candidates: int = 4):
    """Batched v1 lookup: codes (B, L) uint8 (0..3, >= 4 invalid or pad)
    and the three tables (int32 bit patterns, MiniDict.to) on one device.
    -> (hit (B, Wk) bool, csid (B, Wk) int32, INVALID_U32 where no hit,
    ovf (B, Wk) bool). Windows whose bucket holds more than max_candidates
    entries report ovf (the exact host query decides them). CUDA tensors
    take lookup_by_kernels (K8, K1, K14), CPU tensors the plain version."""
    if codes.device.type == "cpu":
        return lookup_minidict_batch_plain(
            entries, bucket_offs, text16, codes, k=k, m=m,
            max_candidates=max_candidates)
    if codes.device.type != "cuda":
        raise ValueError(f"lookup_minidict_batch: unsupported device "
                         f"{codes.device}")
    _check_shape(codes, k, m)
    if codes.dtype != torch.uint8 or codes.device != entries.device:
        raise ValueError("lookup_minidict_batch: codes must be uint8 on the "
                         "tables' device")
    return lookup_by_kernels(entries, bucket_offs, text16, codes, k=k, m=m,
                             max_candidates=max_candidates)
