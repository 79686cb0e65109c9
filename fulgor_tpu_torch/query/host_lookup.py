"""Host (numpy) mirror of the quotient-cuckoo probe (counterpart of
fulgor_tpu/query/host_lookup.py): the oracle for ops/lookup.py and the exact
host path of a --dict cuckoo index (long reads, build-time checks). The
permutations and slot layout must match native/src/fulgor_native.cpp
(pi62 / fn_cuckoo_build), ops/lookup.py and csrc/cuckoo.cu exactly."""

from __future__ import annotations

import numpy as np

from ..constants import INVALID_U32

P62_MASK = np.uint64((1 << 62) - 1)
PI1 = (np.uint64(0x9E3779B97F4A7C15), np.uint64(0xBF58476D1CE4E5B9))
PI2 = (np.uint64(0x94D049BB133111EB), np.uint64(0xD6E8FEB86659FD93))


def pi62(x: np.ndarray, c: tuple) -> np.ndarray:
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(31)
    x = (x * c[0]) & P62_MASK
    x ^= x >> np.uint64(29)
    x = (x * c[1]) & P62_MASK
    x ^= x >> np.uint64(31)
    return x


def table_params(nb: int):
    b = int(nb).bit_length() - 1
    assert (1 << b) == nb, "bucket count must be a power of two"
    val_bits = b + 1
    return b, val_bits, np.uint64((1 << val_bits) - 1), np.uint64((1 << (62 - b)) - 1)


def lookup_host(table: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """keys: uint64 canonical k-mers -> uint32 values (INVALID_U32 = miss).
    table: (nb, 4) uint32 rows = two little-endian u64 slots."""
    keys = np.asarray(keys, dtype=np.uint64)
    nb = table.shape[0]
    b, val_bits, val_mask, rem_mask = table_params(nb)
    slots = np.ascontiguousarray(table).view(np.uint64).reshape(nb, 2)
    out = np.full(len(keys), INVALID_U32, dtype=np.uint32)
    for which, c in ((0, PI1), (1, PI2)):
        p = pi62(keys, c)
        bkt = (p >> np.uint64(62 - b)).astype(np.int64)
        rem = p & rem_mask
        rows = slots[bkt]  # (n, 2)
        for s in range(2):
            sw = rows[:, s]
            v = sw & val_mask
            r = (sw >> np.uint64(val_bits)) & rem_mask
            w = (sw >> np.uint64(63)).astype(np.int64)
            hit = (v != val_mask) & (w == which) & (r == rem)
            out[hit] = v[hit].astype(np.uint32)
    return out
