"""Succinct-bit primitives (numpy, host side).

Replaces the subset of the reference's `bits` library that the index formats
need (SURVEY.md L0): an LSB-first bit stream with Elias-delta codes, raw
bitmaps, and Elias-Fano monotone sequences.

Stream convention: bit position p lives in word p>>6 at bit p&63 of a uint64
array ("LSB-first"). Codes (ours — only internal compatibility required):

* gamma(v), v>=1: with g = floor(log2 v): g zero bits, a '1' bit, then the
  low g bits of v (LSB-first). Length 2g+1.
* delta(x), x>=0: with n = x+1, b = floor(log2 n): gamma(b+1), then the low
  b bits of n (LSB-first). Length 2*floor(log2(b+1)) + 1 + b.

These match the asymptotics of the reference's `bits::util::write_delta`
(used by every color-set codec) without copying its exact bit layout.
"""

from __future__ import annotations

import numpy as np


def _msb(n: np.ndarray) -> np.ndarray:
    """floor(log2(n)) for uint64 n >= 1, exact (n < 2^53)."""
    n = np.asarray(n, dtype=np.uint64)
    assert n.size == 0 or int(n.max()) < (1 << 53)
    return (np.frexp(n.astype(np.float64))[1] - 1).astype(np.uint64)


def seg_ids(lens: np.ndarray) -> np.ndarray:
    """np.repeat(arange(len(lens)), lens) via one cumsum — np.repeat with
    ragged counts runs at ~15M elems/s; this runs at memory speed."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    out = np.zeros(total, dtype=np.int64)
    ends = np.cumsum(lens)[:-1]
    np.add.at(out, ends[ends < total], 1)  # duplicates handle 0-length segs
    return np.cumsum(out)


def seg_gather_idx(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices covering [starts[i], starts[i]+lens[i]) segment
    by segment (== np.repeat(starts, lens) + within-segment arange), via
    one cumsum."""
    lens = np.asarray(lens, dtype=np.int64)
    nz = lens > 0
    s = np.asarray(starts, dtype=np.int64)[nz]
    l = lens[nz]
    total = int(l.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    d = np.ones(total, dtype=np.int64)
    d[0] = s[0]
    if len(s) > 1:
        d[np.cumsum(l)[:-1]] = s[1:] - (s[:-1] + l[:-1] - 1)
    return np.cumsum(d)


def delta_patterns(xs: np.ndarray):
    """Vectorized Elias-delta: values -> (bit patterns u64, lengths u64).

    Each encoded value must fit in 64 bits of pattern (true for x < 2^53-ish;
    we assert x < 2^48 to keep total length <= 64).
    """
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.size == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    assert int(xs.max()) < (1 << 48)
    n = xs + np.uint64(1)
    b = _msb(n)
    v = b + np.uint64(1)  # gamma argument
    g = _msb(v)
    one = np.uint64(1)
    low_v = v & ((one << g) - one)
    gamma_pat = (one << g) | (low_v << (g + one))
    gamma_len = np.uint64(2) * g + one
    low_n = n & ((one << b) - one)
    pat = gamma_pat | (low_n << gamma_len)
    length = gamma_len + b
    assert int(length.max()) <= 64
    return pat, length


class BitWriter:
    """Accumulates (pattern, length) pairs; packs once at finalize()."""

    def __init__(self):
        self._pats: list[np.ndarray] = []
        self._lens: list[np.ndarray] = []
        self._num_bits = 0

    @property
    def num_bits(self) -> int:
        return self._num_bits

    def append_patterns(self, pats: np.ndarray, lens: np.ndarray):
        pats = np.asarray(pats, dtype=np.uint64)
        lens = np.asarray(lens, dtype=np.uint64)
        if pats.size:
            self._pats.append(pats)
            self._lens.append(lens)
            self._num_bits += int(lens.sum())

    def append_deltas(self, xs: np.ndarray):
        self.append_patterns(*delta_patterns(xs))

    def append_bits(self, bits: np.ndarray):
        """Append a raw bitmap (bool array), first element = first bit."""
        bits = np.asarray(bits, dtype=bool)
        nb = len(bits)
        if nb == 0:
            return
        pad = (-nb) % 64
        padded = np.concatenate([bits, np.zeros(pad, dtype=bool)])
        bytes_ = np.packbits(padded.reshape(-1, 8)[:, ::-1].reshape(-1))
        words = bytes_.view(np.uint64)  # little-endian: LSB-first within word
        lens = np.full(len(words), 64, dtype=np.uint64)
        if pad:
            lens[-1] = 64 - pad
        self.append_patterns(words, lens)

    def append_fixed(self, xs: np.ndarray, width: int):
        """Append each value using `width` bits, LSB-first. width <= 64."""
        xs = np.asarray(xs, dtype=np.uint64)
        assert width <= 64
        if width == 64:
            mask = np.uint64(0xFFFFFFFFFFFFFFFF)
        else:
            mask = np.uint64((1 << width) - 1)
        self.append_patterns(xs & mask, np.full(len(xs), width, dtype=np.uint64))

    def finalize(self) -> np.ndarray:
        """Pack into a uint64 word array (LSB-first)."""
        total = self._num_bits
        if not self._pats:
            return np.zeros((total + 63) // 64, dtype=np.uint64)
        pats = np.concatenate(self._pats)
        lens = np.concatenate(self._lens)
        from ..native import lib as _native

        return _native.pack_patterns(pats, lens, total)


class BitReader:
    """Sequential reader over an LSB-first uint64 word stream."""

    def __init__(self, words: np.ndarray, pos: int = 0):
        self.words = np.asarray(words, dtype=np.uint64)
        self.pos = pos

    def read_bits(self, n: int) -> int:
        """Read n <= 64 bits LSB-first."""
        if n == 0:
            return 0
        p, w = self.pos, int(self.pos >> 6)
        sh = p & 63
        val = int(self.words[w]) >> sh
        got = 64 - sh
        if got < n:
            val |= int(self.words[w + 1]) << got
        self.pos = p + n
        return val & ((1 << n) - 1)

    def read_unary_zeros(self) -> int:
        """Count zero bits until (and consuming) the next set bit."""
        z = 0
        while True:
            w = int(self.pos >> 6)
            sh = self.pos & 63
            chunk = int(self.words[w]) >> sh
            width = 64 - sh
            if chunk == 0:
                z += width
                self.pos += width
                continue
            tz = (chunk & -chunk).bit_length() - 1
            if tz < width:
                z += tz
                self.pos += tz + 1  # consume the terminating 1
                return z
            z += width
            self.pos += width

    def read_gamma(self) -> int:
        g = self.read_unary_zeros()
        low = self.read_bits(g)
        return low | (1 << g)

    def read_delta(self) -> int:
        b = self.read_gamma() - 1
        low = self.read_bits(b)
        return (low | (1 << b)) - 1

    def read_bitmap(self, n: int) -> np.ndarray:
        """Read n bits as a bool array (vectorized)."""
        start, end = self.pos, self.pos + n
        w0, w1 = start >> 6, (end + 63) >> 6
        chunk = self.words[w0:w1]
        bits = np.unpackbits(chunk.view(np.uint8)).reshape(-1, 8)[:, ::-1].reshape(-1)
        self.pos = end
        return bits[start - 64 * w0 : start - 64 * w0 + n].astype(bool)


class EliasFano:
    """Monotone non-decreasing uint sequence, Elias-Fano encoded."""

    def __init__(self, low_words, high_words, n, u, l):
        self.low_words = np.asarray(low_words, dtype=np.uint64)
        self.high_words = np.asarray(high_words, dtype=np.uint64)
        self.n = int(n)
        self.u = int(u)
        self.l = int(l)

    @classmethod
    def encode(cls, values: np.ndarray) -> "EliasFano":
        values = np.asarray(values, dtype=np.uint64)
        n = len(values)
        u = int(values[-1]) + 1 if n else 1
        l = max(0, int(np.floor(np.log2(max(1, u // max(1, n))))))
        bw_low = BitWriter()
        if l:
            bw_low.append_fixed(values, l)
        highs = (values >> np.uint64(l)).astype(np.int64)
        nb_high = n + (int(highs[-1]) if n else 0) + 1
        bits = np.zeros(nb_high, dtype=bool)
        bits[highs + np.arange(n)] = True
        bw_high = BitWriter()
        bw_high.append_bits(bits)
        return cls(bw_low.finalize(), bw_high.finalize(), n, u, l)

    def decode_all(self) -> np.ndarray:
        if self.n == 0:
            return np.empty(0, dtype=np.uint64)
        hb = np.unpackbits(self.high_words.view(np.uint8)).reshape(-1, 8)[:, ::-1].reshape(-1)
        ones = np.flatnonzero(hb)[: self.n]
        highs = (ones - np.arange(self.n)).astype(np.uint64)
        if self.l == 0:
            return highs
        r = BitReader(self.low_words)
        # vectorized fixed-width unpack
        offs = (np.arange(self.n, dtype=np.uint64)) * np.uint64(self.l)
        widx = (offs >> np.uint64(6)).astype(np.int64)
        sh = offs & np.uint64(63)
        w = self.low_words
        lo = w[widx] >> sh
        need_hi = (sh + np.uint64(self.l)) > np.uint64(64)
        nxt = np.where(widx + 1 < len(w), np.minimum(widx + 1, len(w) - 1), widx)
        hi = np.where(need_hi, w[nxt] << (np.uint64(64) - np.maximum(sh, 1)), 0).astype(np.uint64)
        lows = (lo | hi) & np.uint64((1 << self.l) - 1)
        return (highs << np.uint64(self.l)) | lows

    def num_bytes(self) -> int:
        return self.low_words.nbytes + self.high_words.nbytes + 24
