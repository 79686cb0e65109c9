"""Shared definitions of the minimizer dictionary (fulgor_tpu's
ops/minidict.py, reduced to what the port's v3 dictionary in minidict2.py
uses; the v1 dictionary itself is not part of fulgor_tpu_torch).

Definitions (host build and device query MUST agree exactly):

* m-mer order: Hm = mix32(lo ^ mix32(hi ^ SEED_M)) of the CANONICAL m-mer
  (min of fwd/rc packings) — symmetric under reverse complement.
* window minimizer of the k-mer at position p: min of Hm over offsets
  [0, k-m]; the LEFTMOST and RIGHTMOST argmin are the window's
  distinguished occurrences (reversing a window maps its rightmost
  minimizer occurrence to the leftmost of the reverse complement).
* k-mer packings: LSB-first 2-bit, forward and reverse complement, split
  into u32 halves.
"""

from __future__ import annotations

import numpy as np

from ..core import kmers as K

SEED_M = 0x713A9C5B


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

