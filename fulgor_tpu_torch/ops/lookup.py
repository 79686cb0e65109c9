"""Cuckoo lookup (kernel K7): every k-window of a packed read batch against
the quotient cuckoo table of a --dict cuckoo index.

Counterpart of fulgor_tpu/ops/lookup.py unpack_reads, pack_windows,
_shr62/_mul62/pi62_u32, probe and lookup_batch. For every window p of every
read of a host-packed batch (ops/hostpack.py):

  valid    none of its k bases is bad (pad counts as bad);
  key      the canonical k-mer: the smaller of the forward k-mer (base i at
           bits 2(k-1-i)) and its reverse complement, a 62-bit value;
  probe    for which in (0, 1): p = pi62(key, PI1 or PI2), bucket =
           p >> (62-b), rem = p & (2^(62-b) - 1), one 16-byte row of two
           u64 slots [value (b+1 bits) | rem (62-b bits) | which (bit 63)];
           a slot hits iff its value field is not all ones (empty), its
           which bit and its remainder match;
  ->       hit bool (B, Wk), csid int32 (B, Wk), -1 (INVALID_U32) where no
           hit. The cuckoo table never overflows.

The plain version keeps 62-bit values in int64 (every key and permuted
value is below 2^62) and multiplies in 31-bit limbs so that no product
passes 2^63; the kernel uses native 64-bit arithmetic. `cuckoo_lookup`
launches csrc/cuckoo.cu for CUDA tensors and runs `cuckoo_lookup_plain` for
CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .prep import MAX_WIDTH, _unpack
from .u32 import M32, i32

M62 = (1 << 62) - 1
L31 = (1 << 31) - 1
# the two invertible 62-bit permutations (native fn_cuckoo_build)
PI1 = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)
PI2 = (0x94D049BB133111EB, 0xD6E8FEB86659FD93)
MAX_K = 31


def _mul62(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^62 for int64-held x in [0, 2^62) and a 64-bit constant
    c, in 31-bit limbs: each partial product is below 2^62, each sum below
    2^63."""
    c &= M62
    c0, c1 = c & L31, c >> 31
    x0, x1 = x & L31, x >> 31
    mid = (x0 * c1 + x1 * c0) & L31
    return (x0 * c0 + (mid << 31)) & M62


def pi62(x: torch.Tensor, consts) -> torch.Tensor:
    """fulgor_tpu's pi62 (native and host_lookup) on int64-held 62-bit
    values."""
    x = x ^ (x >> 31)
    x = _mul62(x, consts[0])
    x = x ^ (x >> 29)
    x = _mul62(x, consts[1])
    return x ^ (x >> 31)


def _check_table(table: torch.Tensor) -> int:
    """-> b = log2(nb) of a (nb, 4) int32 table."""
    nb = table.shape[0]
    b = nb.bit_length() - 1
    if table.dim() != 2 or table.shape[1] != 4 or nb != 1 << b:
        raise ValueError("cuckoo table must be (nb, 4) with nb a power of two")
    return b


def _keys_plain(codes2, bad, *, width: int, k: int):
    """-> (canonical k-mer int64 (B, Wk), valid bool (B, Wk))."""
    codes, badb = _unpack(codes2, bad, width)
    Wk = width - k + 1
    fwd = torch.zeros((codes.shape[0], Wk), dtype=torch.int64,
                      device=codes.device)
    rc = torch.zeros_like(fwd)
    valid = torch.ones_like(fwd, dtype=torch.bool)
    for i in range(k):
        ci = codes[:, i:i + Wk]
        fwd |= ci << (2 * (k - 1 - i))
        rc |= (3 - ci) << (2 * i)
        valid &= ~badb[:, i:i + Wk]
    return torch.minimum(fwd, rc), valid


def _probe_plain(table, key, valid):
    """-> (hit bool, val int64 in [0, 2^32), first bool: the key sits in
    its first hash choice's row)."""
    b = _check_table(table)
    vb = b + 1
    val_mask, rem_mask = (1 << vb) - 1, (1 << (62 - b)) - 1
    t = table.to(torch.int64) & M32
    hit = torch.zeros_like(valid)
    first = torch.zeros_like(valid)
    val = torch.full_like(key, M32)
    for which, consts in ((0, PI1), (1, PI2)):
        p = pi62(key, consts)
        rows = t[p >> (62 - b)]  # (B, Wk, 4)
        rem = p & rem_mask
        for s in range(2):
            lo, hi = rows[..., 2 * s], rows[..., 2 * s + 1]
            low63 = lo | ((hi & 0x7FFFFFFF) << 32)  # the slot but bit 63
            v = low63 & val_mask
            h = ((v != val_mask) & ((hi >> 31) == which)
                 & (((low63 >> vb) & rem_mask) == rem))
            hit |= h
            val = torch.where(h, v, val)
            if which == 0:
                first |= h
    hit &= valid
    return hit, torch.where(hit, val, M32), first & valid


def cuckoo_lookup_plain(table, codes2, bad, *, width: int, k: int):
    """Plain PyTorch cuckoo lookup (any device). table: (nb, 4) int32 bit
    patterns of the index's u32 rows; codes2 (B, W/4), bad (B, W/8) uint8
    -> (hit bool (B, Wk), csid int32 (B, Wk), -1 where no hit)."""
    key, valid = _keys_plain(codes2, bad, width=width, k=k)
    hit, val, _first = _probe_plain(table, key, valid)
    return hit, i32(val)


def cuckoo_row_gathers(table, codes2, bad, *, width: int, k: int) -> int:
    """Table rows a lookup of this batch must read: one for every valid
    window, and a second for those whose key is not in its first hash
    choice's row (K7 stops at the first hit). For chip_smoke's bound."""
    key, valid = _keys_plain(codes2, bad, width=width, k=k)
    _hit, _val, first = _probe_plain(table, key, valid)
    return int(valid.sum()) + int((valid & ~first).sum())


def cuckoo_lookup(table, codes2, bad, *, width: int, k: int):
    """Cuckoo lookup of a packed batch: codes2 (B, W/4) uint8, bad (B, W/8)
    uint8, table (nb, 4) int32 -> (hit bool, csid int32), each (B, W-k+1)."""
    if codes2.device.type == "cpu":
        return cuckoo_lookup_plain(table, codes2, bad, width=width, k=k)
    if codes2.device.type != "cuda":
        raise ValueError(f"cuckoo_lookup: unsupported device {codes2.device}")
    B = codes2.shape[0]
    if not (width % 32 == 0 and 1 <= k <= MAX_K and k <= width
            and width <= MAX_WIDTH):
        raise ValueError(f"cuckoo_lookup: unsupported width={width} k={k}")
    if (codes2.dtype != torch.uint8 or bad.dtype != torch.uint8
            or tuple(codes2.shape) != (B, width // 4)
            or tuple(bad.shape) != (B, width // 8)
            or table.dtype != torch.int32 or bad.device != codes2.device
            or table.device != codes2.device):
        raise ValueError("cuckoo_lookup: codes2/bad must be uint8 (B, W/4) "
                         "and (B, W/8), the table int32, on one device")
    b = _check_table(table)
    codes2, bad, table = codes2.contiguous(), bad.contiguous(), table.contiguous()
    if codes2.data_ptr() % 4 or bad.data_ptr() % 4 or table.data_ptr() % 16:
        raise ValueError("cuckoo_lookup: codes2 and bad must start 4-byte "
                         "aligned, the table 16-byte aligned")
    Wk = width - k + 1
    hit = torch.empty((B, Wk), dtype=torch.bool, device=codes2.device)
    csid = torch.empty((B, Wk), dtype=torch.int32, device=codes2.device)
    if B == 0:
        return hit, csid
    lib = kernels.library()
    rc = lib.fulgor_cuckoo_lookup(
        table.data_ptr(), b, codes2.data_ptr(), bad.data_ptr(), B, width, k,
        hit.data_ptr(), csid.data_ptr(), kernels.stream_of(codes2))
    kernels.check(rc, "cuckoo_lookup")
    kernels.launches["cuckoo_lookup"] += 1
    return hit, csid
