"""Colored compacted de Bruijn graph construction (GGCAT equivalent).

The reference shells out to GGCAT (Rust) to build monochromatic unitigs with
per-unitig color sets (include/GGCAT.hpp:42-88). We build the same object
ourselves: nodes are distinct canonical k-mers; unitigs are maximal
non-branching paths further split so that every k-mer of a unitig has the
same color set ("monochromatic").

This module holds the *Python reference implementation* — exact but slow,
used for tests and as the oracle for the native C++ builder
(fulgor_tpu_torch/native). Both produce a `CCDBG`:

    unitig_codes : uint8 concat of 2-bit base codes of all unitigs
    unitig_offs  : int64 (num_unitigs+1,) base offsets
    unitig_cs    : uint32 per-unitig color-set id (intern order)
    cs_colors    : uint32 concat of color ids per set (sorted increasing)
    cs_offs      : int64 (num_sets+1,) offsets into cs_colors

Determinism: unitigs are emitted in ascending order of their smallest
canonical k-mer, and color sets are interned in first-occurrence order over
that emission; the index builder then groups unitigs by color-set id with a
stable sort. This pins `color_set_id` values independent of thread count or
input sharding (the reference inherits GGCAT's stream order instead, which
is explicitly not stable across rebuilds — README.md:318).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import kmers as K


@dataclass
class CCDBG:
    k: int
    num_colors: int
    unitig_codes: np.ndarray
    unitig_offs: np.ndarray
    unitig_cs: np.ndarray
    cs_colors: np.ndarray
    cs_offs: np.ndarray

    @property
    def num_unitigs(self) -> int:
        return len(self.unitig_offs) - 1

    @property
    def num_color_sets(self) -> int:
        return len(self.cs_offs) - 1

    @property
    def num_kmers(self) -> int:
        lens = self.unitig_offs[1:] - self.unitig_offs[:-1]
        return int((lens - (self.k - 1)).sum())

    def unitig_seq(self, i: int) -> str:
        return K.codes_to_seq(self.unitig_codes[self.unitig_offs[i] : self.unitig_offs[i + 1]])

    def color_set(self, cs_id: int) -> np.ndarray:
        return self.cs_colors[self.cs_offs[cs_id] : self.cs_offs[cs_id + 1]]


def distinct_canonical_kmers(seqs, k: int) -> np.ndarray:
    """Distinct canonical k-mers over an iterable of sequences (str/bytes)."""
    chunks = []
    for s in seqs:
        codes = K.seq_to_codes(s)
        km, valid = K.pack_kmers(codes, k)
        if len(km):
            chunks.append(K.canonicalize(km[valid], k))
    if not chunks:
        return np.empty(0, dtype=np.uint64)
    return np.unique(np.concatenate(chunks))


def kmer_color_table(genomes_seqs: list, k: int):
    """-> (kmers sorted unique u64, color lists per kmer as (cat u32, offs)).

    genomes_seqs: list (per color, in color-id order) of sequence lists.
    """
    kms = []
    cols = []
    for color, seqs in enumerate(genomes_seqs):
        u = distinct_canonical_kmers(seqs, k)
        kms.append(u)
        cols.append(np.full(len(u), color, dtype=np.uint32))
    allk = np.concatenate(kms) if kms else np.empty(0, np.uint64)
    allc = np.concatenate(cols) if cols else np.empty(0, np.uint32)
    order = np.lexsort((allc, allk))
    allk, allc = allk[order], allc[order]
    kmers, starts = np.unique(allk, return_index=True)
    offs = np.concatenate([starts, [len(allk)]]).astype(np.int64)
    return kmers, allc, offs


def intern_color_sets(colors_cat: np.ndarray, offs: np.ndarray):
    """Assign a set id to each kmer; ids in first-occurrence order.

    -> (kset u32 per kmer, cs_colors, cs_offs)
    """
    n = len(offs) - 1
    kset = np.empty(n, dtype=np.uint32)
    seen: dict[bytes, int] = {}
    sets: list[np.ndarray] = []
    for i in range(n):
        key = colors_cat[offs[i] : offs[i + 1]].tobytes()
        sid = seen.get(key)
        if sid is None:
            sid = len(sets)
            seen[key] = sid
            sets.append(colors_cat[offs[i] : offs[i + 1]])
        kset[i] = sid
    sizes = np.array([len(s) for s in sets], dtype=np.int64)
    cs_offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    cs_colors = (
        np.concatenate(sets).astype(np.uint32) if sets else np.empty(0, np.uint32)
    )
    return kset, cs_colors, cs_offs


class _Walker:
    """Unitig walker over a sorted canonical k-mer array."""

    def __init__(self, kmers: np.ndarray, kset: np.ndarray, k: int):
        assert k % 2 == 1, "even k (palindromic k-mers) not supported"
        self.kmers = kmers
        self.kset = kset
        self.k = k
        self.mask = (1 << (2 * k)) - 1
        self.visited = np.zeros(len(kmers), dtype=bool)

    def find(self, km: int) -> int:
        i = int(np.searchsorted(self.kmers, np.uint64(km)))
        if i < len(self.kmers) and int(self.kmers[i]) == km:
            return i
        return -1

    def canon(self, x: int):
        rc = int(K.revcomp_packed(np.array([x], dtype=np.uint64), self.k)[0])
        return (x, 0) if x <= rc else (rc, 1)

    def orient(self, idx: int, o: int) -> int:
        u = int(self.kmers[idx])
        if o == 0:
            return u
        return int(K.revcomp_packed(np.array([u], dtype=np.uint64), self.k)[0])

    def succs(self, x: int):
        """Oriented successors of oriented kmer x: [(idx, oriented_y, char)]."""
        out = []
        base = (x << 2) & self.mask
        for c in range(4):
            y = base | c
            cy, _ = self.canon(y)
            i = self.find(cy)
            if i >= 0:
                out.append((i, y, c))
        return out

    def preds(self, x: int):
        out = []
        base = x >> 2
        hs = 2 * (self.k - 1)
        for c in range(4):
            z = base | (c << hs)
            cz, _ = self.canon(z)
            i = self.find(cz)
            if i >= 0:
                out.append((i, z, c))
        return out

    def is_start(self, idx: int, x: int) -> bool:
        """Is oriented kmer x (canonical index idx) a left-blocked start?"""
        ps = self.preds(x)
        if len(ps) != 1:
            return True
        pi, pz, _ = ps[0]
        if self.kset[pi] != self.kset[idx]:
            return True
        if len(self.succs(pz)) != 1:
            return True
        return False

    def walk(self, idx: int, o: int):
        """Walk right from start (idx, o); returns (codes list, kmer indices)."""
        x = self.orient(idx, o)
        k = self.k
        codes = [(x >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        path = [idx]
        self.visited[idx] = True
        while True:
            ss = self.succs(x)
            if len(ss) != 1:
                break
            yi, y, c = ss[0]
            if self.kset[yi] != self.kset[idx]:
                break
            if len(self.preds(y)) != 1:
                break
            if self.visited[yi]:
                break
            codes.append(c)
            path.append(yi)
            self.visited[yi] = True
            x = y
        return codes, path


def build_unitigs(kmers: np.ndarray, kset: np.ndarray, k: int):
    """-> (unitig_codes u8 concat, unitig_offs i64, unitig_kset u32).

    Unitigs are emitted in ascending order of smallest member kmer (see
    module docstring for the determinism rule)."""
    w = _Walker(kmers, kset, k)
    emitted: list[tuple[int, list, int]] = []  # (min_kmer, codes, set_id)

    def emit(idx, o):
        codes, path = w.walk(idx, o)
        mink = int(kmers[np.array(path, dtype=np.int64)].min())
        emitted.append((mink, codes, int(kset[idx])))

    for idx in range(len(kmers)):
        if w.visited[idx]:
            continue
        if w.is_start(idx, w.orient(idx, 0)):
            emit(idx, 0)
        elif w.is_start(idx, w.orient(idx, 1)):
            emit(idx, 1)
    # remaining: pure cycles
    for idx in range(len(kmers)):
        if not w.visited[idx]:
            emit(idx, 0)

    emitted.sort(key=lambda t: t[0])
    lens = np.array([len(c) for _, c, _ in emitted], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    codes = np.concatenate(
        [np.array(c, dtype=np.uint8) for _, c, _ in emitted]
    ) if emitted else np.empty(0, np.uint8)
    uset = np.array([s for _, _, s in emitted], dtype=np.uint32)
    return codes, offs, uset


def reintern_by_first_occurrence(unitig_cs: np.ndarray, cs_colors, cs_offs):
    """Renumber color sets in first-occurrence order over the unitig stream
    and return the permuted set store."""
    old_ids, first = np.unique(unitig_cs, return_index=True)
    order = old_ids[np.argsort(first)]  # old id per new id
    new_of_old = np.empty(len(old_ids), dtype=np.uint32)
    new_of_old[order] = np.arange(len(old_ids), dtype=np.uint32)
    new_cs = new_of_old[unitig_cs]
    sizes = (cs_offs[1:] - cs_offs[:-1])[order]
    new_offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    chunks = [cs_colors[cs_offs[o] : cs_offs[o + 1]] for o in order]
    new_colors = np.concatenate(chunks) if chunks else np.empty(0, np.uint32)
    return new_cs, new_colors, new_offs


def build_ccdbg_py(genomes_seqs: list, k: int) -> CCDBG:
    """Exact reference builder (slow): genomes_seqs[color] = list of seqs."""
    kmers, colors_cat, offs = kmer_color_table(genomes_seqs, k)
    kset, cs_colors, cs_offs = intern_color_sets(colors_cat, offs)
    codes, uoffs, ucs = build_unitigs(kmers, kset, k)
    ucs, cs_colors, cs_offs = reintern_by_first_occurrence(ucs, cs_colors, cs_offs)
    # group unitigs by color-set id (stable) — reference keeps unitigs of one
    # color set adjacent (u2c bitmap, include/builders/builder.hpp:116)
    order = np.argsort(ucs, kind="stable")
    lens = uoffs[1:] - uoffs[:-1]
    new_offs = np.concatenate([[0], np.cumsum(lens[order])]).astype(np.int64)
    new_codes = np.concatenate(
        [codes[uoffs[i] : uoffs[i + 1]] for i in order]
    ) if len(order) else np.empty(0, np.uint8)
    return CCDBG(
        k=k,
        num_colors=len(genomes_seqs),
        unitig_codes=new_codes,
        unitig_offs=new_offs,
        unitig_cs=ucs[order],
        cs_colors=cs_colors,
        cs_offs=cs_offs,
    )
