"""Host-side k-mer packing / canonicalization (numpy, vectorized).

Conventions (ours, TPU-first — the reference delegates this to SSHash):

* 2-bit codes A=0, C=1, G=2, T=3; complement(x) = 3 - x.
* A k-mer (k <= 31) packs into a uint64 with the LEFTMOST base in the most
  significant 2-bit group, so numeric order == lexicographic string order.
* canonical(kmer) = min(kmer, revcomp(kmer)) — orientation-invariant key.
* Any window containing a non-ACGT character is invalid (reference treats
  such k-mers as negative lookups).
"""

from __future__ import annotations

import numpy as np

MAX_K = 31

# ASCII -> 2-bit code; non-ACGT (incl. N) -> 4.
_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i  # lowercase

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)


def seq_to_codes(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 code array (4 = invalid base)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if not isinstance(seq, np.ndarray) else seq
    return _LUT[arr]


def codes_to_seq(codes: np.ndarray) -> str:
    return "".join("ACGTN"[c] for c in codes)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    out = (3 - codes[::-1].astype(np.int16)).astype(np.uint8)
    out[codes[::-1] >= 4] = 4
    return out


def reverse_2bit_groups(v: np.ndarray | np.uint64) -> np.ndarray:
    """Reverse the order of all 32 2-bit groups in a uint64."""
    v = np.asarray(v, dtype=np.uint64)
    v = ((v >> np.uint64(2)) & _M2) | ((v & _M2) << np.uint64(2))
    v = ((v >> np.uint64(4)) & _M4) | ((v & _M4) << np.uint64(4))
    return v.byteswap()


def revcomp_packed(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of big-endian 2-bit packed k-mers (vectorized)."""
    mask = np.uint64((1 << (2 * k)) - 1)
    comp = np.asarray(kmers, dtype=np.uint64) ^ mask  # 3-b per group
    return reverse_2bit_groups(comp) >> np.uint64(64 - 2 * k)


def pack_kmers(codes: np.ndarray, k: int):
    """All k-length windows of a code array, packed.

    Returns (kmers, valid): kmers uint64 (L-k+1,), valid bool (L-k+1,)
    where valid[p] is False if window p touches a non-ACGT base.
    Empty arrays if len(codes) < k.
    """
    assert 1 <= k <= MAX_K
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    c = codes.astype(np.uint64)
    kmers = np.zeros(n, dtype=np.uint64)
    for i in range(k):
        kmers |= (c[i : i + n] & np.uint64(3)) << np.uint64(2 * (k - 1 - i))
    bad = (codes >= 4).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return kmers, valid


def canonicalize(kmers: np.ndarray, k: int) -> np.ndarray:
    rc = revcomp_packed(kmers, k)
    return np.minimum(kmers, rc)


def kmer_to_str(kmer: int, k: int) -> str:
    return "".join("ACGT"[(int(kmer) >> (2 * (k - 1 - i))) & 3] for i in range(k))


def str_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        v = (v << 2) | int(_LUT[ord(ch)])
    return v


def pack2(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) into uint64 words, 32 bases/word, LSB-first
    (base i occupies bits 2i..2i+1 of word i//32)."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    pad = (-n) % 32
    c = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)]).astype(np.uint64)
    c = c.reshape(-1, 32)
    words = np.zeros(len(c), dtype=np.uint64)
    for i in range(32):
        words |= c[:, i] << np.uint64(2 * i)
    return words


def unpack2(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack2."""
    words = np.asarray(words, dtype=np.uint64)
    shifts = (np.uint64(2) * np.arange(32, dtype=np.uint64))[None, :]
    codes = ((words[:, None] >> shifts) & np.uint64(3)).astype(np.uint8)
    return codes.reshape(-1)[:n]


def split_u64(kmers: np.ndarray):
    """uint64 -> (lo32, hi32) uint32 pair for device consumption."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (kmers >> np.uint64(32)).astype(np.uint32)
    return lo, hi
