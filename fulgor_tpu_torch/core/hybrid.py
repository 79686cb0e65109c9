"""Hybrid color-set codec (host side, numpy-vectorized).

Behavioral contract (reference: include/color_sets/hybrid.hpp:37-95):
each color set of size s over N colors is stored as

    delta(s) ++ payload

where payload is chosen by density:
    s < floor(0.25 * N)  -> delta(c0), delta(gap_i - 1) ...      (sparse)
    s < floor(0.75 * N)  -> N-bit bitmap                          (bitmap)
    else                 -> delta codes of the COMPLEMENT set     (complement)

Per-set bit offsets are kept Elias-Fano-coded next to the stream. The exact
bit layout of our delta codes is ours (core/bitsx.py) — only sizes, not bits,
are comparable with the reference.

The encoder is vectorized across sets in chunks: per chunk it materializes
the (pattern, length) item sequence for ALL sets at once and appends it in
set order, so encode cost is O(total payload) numpy work, no per-set Python.
"""

from __future__ import annotations

import numpy as np

from .bitsx import BitReader, BitWriter, delta_patterns
from ..constants import (
    ENC_BITMAP,
    ENC_COMPLEMENT_DELTA_GAPS,
    ENC_DELTA_GAPS,
)


def thresholds(num_colors: int):
    """(sparse, very_dense) size thresholds; float-mult truncation mirrors
    the reference's `uint32 = 0.25 * N` member initialization."""
    return int(0.25 * num_colors), int(0.75 * num_colors)


def encoding_kinds(sizes: np.ndarray, num_colors: int) -> np.ndarray:
    sparse_thr, dense_thr = thresholds(num_colors)
    kinds = np.full(len(sizes), ENC_BITMAP, dtype=np.uint8)
    kinds[sizes < sparse_thr] = ENC_DELTA_GAPS
    kinds[sizes >= dense_thr] = ENC_COMPLEMENT_DELTA_GAPS
    return kinds


def _gap_values(colors: np.ndarray, starts: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Per-set [c0, c1-c0-1, c2-c1-1, ...] over concatenated color lists."""
    vals = np.empty(len(colors), dtype=np.uint64)
    if len(colors) == 0:
        return vals
    c = colors.astype(np.int64)
    vals[1:] = (c[1:] - c[:-1] - 1).astype(np.uint64)
    nz = starts[sizes > 0]  # zero-size payloads (e.g. full sets) have no items
    vals[nz] = colors[nz]
    return vals


class HybridEncoder:
    """Streaming multi-chunk encoder. Call add_sets() repeatedly in set-id
    order, then finalize()."""

    def __init__(self, num_colors: int, chunk_sets: int | None = None):
        self.num_colors = int(num_colors)
        self.writer = BitWriter()
        self.bit_offsets: list[np.ndarray] = [np.zeros(1, dtype=np.uint64)]
        self.num_sets = 0
        self.num_total_ints = 0
        self.chunk_sets = chunk_sets or max(256, (1 << 25) // max(1, num_colors))

    def add_sets(self, colors_concat: np.ndarray, set_offsets: np.ndarray):
        """colors_concat: uint32 sorted-increasing per set; set_offsets:
        int64 (n+1,) boundaries into colors_concat."""
        n = len(set_offsets) - 1
        for lo in range(0, n, self.chunk_sets):
            hi = min(n, lo + self.chunk_sets)
            self._add_chunk(
                colors_concat[set_offsets[lo] : set_offsets[hi]],
                (set_offsets[lo : hi + 1] - set_offsets[lo]).astype(np.int64),
            )

    def _add_chunk(self, colors: np.ndarray, offs: np.ndarray):
        N = self.num_colors
        n = len(offs) - 1
        sizes = (offs[1:] - offs[:-1]).astype(np.int64)
        assert sizes.min() >= 1, "empty color sets are not allowed"
        kinds = encoding_kinds(sizes, N)
        sparse = kinds == ENC_DELTA_GAPS
        bitmap = kinds == ENC_BITMAP
        comp = kinds == ENC_COMPLEMENT_DELTA_GAPS
        wpr = (N + 63) // 64  # bitmap words per set

        counts = np.ones(n, dtype=np.int64)  # the delta(size) item
        counts[sparse] += sizes[sparse]
        counts[bitmap] += wpr
        counts[comp] += N - sizes[comp]
        item_offs = np.concatenate([[0], np.cumsum(counts)])
        total_items = int(item_offs[-1])
        pats = np.zeros(total_items, dtype=np.uint64)
        lens = np.zeros(total_items, dtype=np.uint64)

        # item 0 of every set: delta(size)
        p, l = delta_patterns(sizes.astype(np.uint64))
        pats[item_offs[:-1]] = p
        lens[item_offs[:-1]] = l

        from .bitsx import seg_gather_idx, seg_ids

        sid = seg_ids(sizes)

        # --- sparse payloads ---
        if sparse.any():
            sel = sparse[sid]
            scolors = colors[sel]
            ssizes = sizes[sparse]
            sstarts = np.concatenate([[0], np.cumsum(ssizes)])[:-1]
            vals = _gap_values(scolors, sstarts, ssizes)
            p, l = delta_patterns(vals)
            dest = seg_gather_idx(item_offs[:-1][sparse] + 1, ssizes)
            pats[dest] = p
            lens[dest] = l

        # --- bitmap payloads ---
        if bitmap.any():
            nb = int(bitmap.sum())
            bidx = np.flatnonzero(bitmap)
            remap = np.full(n, -1, dtype=np.int64)
            remap[bidx] = np.arange(nb)
            sel = bitmap[sid]
            rows = remap[sid[sel]]
            cols = colors[sel].astype(np.int64)
            mat = np.zeros((nb, wpr * 64), dtype=bool)
            mat[rows, cols] = True
            bytes_ = np.packbits(mat.reshape(-1, 8)[:, ::-1].reshape(nb, -1), axis=1)
            words = np.ascontiguousarray(bytes_).view(np.uint64)
            assert words.shape == (nb, wpr)
            wlens = np.full((nb, wpr), 64, dtype=np.uint64)
            wlens[:, -1] = N - 64 * (wpr - 1)
            dest = item_offs[:-1][bitmap][:, None] + 1 + np.arange(wpr)[None, :]
            pats[dest.reshape(-1)] = words.reshape(-1)
            lens[dest.reshape(-1)] = wlens.reshape(-1)

        # --- complement payloads ---
        if comp.any():
            nc = int(comp.sum())
            cidx = np.flatnonzero(comp)
            remap = np.full(n, -1, dtype=np.int64)
            remap[cidx] = np.arange(nc)
            sel = comp[sid]
            rows = remap[sid[sel]]
            cols = colors[sel].astype(np.int64)
            member = np.zeros((nc, N), dtype=bool)
            member[rows, cols] = True
            crows, ccols = np.nonzero(~member)  # sorted by (row, col)
            csizes = (N - sizes[comp]).astype(np.int64)
            cstarts = np.concatenate([[0], np.cumsum(csizes)])[:-1]
            vals = _gap_values(ccols.astype(np.uint32), cstarts, csizes)
            if len(vals):
                p, l = delta_patterns(vals)
                dest = seg_gather_idx(item_offs[:-1][comp] + 1, csizes)
                pats[dest] = p
                lens[dest] = l

        base = self.writer.num_bits
        self.writer.append_patterns(pats, lens)
        per_set_bits = np.add.reduceat(lens, item_offs[:-1])
        self.bit_offsets.append(base + np.cumsum(per_set_bits).astype(np.uint64))
        self.num_sets += n
        self.num_total_ints += int(sizes.sum())

    def finalize(self):
        """-> (stream_words u64, bit_offsets u64 (num_sets+1,))"""
        words = self.writer.finalize()
        offsets = np.concatenate(self.bit_offsets)
        assert len(offsets) == self.num_sets + 1
        return words, offsets


def encode_color_sets(colors_concat, set_offsets, num_colors):
    enc = HybridEncoder(num_colors)
    enc.add_sets(np.asarray(colors_concat, dtype=np.uint32), np.asarray(set_offsets))
    return enc.finalize()


def decode_set(words: np.ndarray, bit_offset: int, num_colors: int) -> np.ndarray:
    """Decode one color set -> sorted uint32 colors (reference impl)."""
    r = BitReader(words, int(bit_offset))
    size = r.read_delta()
    sparse_thr, dense_thr = thresholds(num_colors)
    if size < sparse_thr:
        out = np.empty(size, dtype=np.uint32)
        prev = -1
        for i in range(size):
            d = r.read_delta()
            prev = d if i == 0 else prev + 1 + d
            out[i] = prev
        return out
    if size < dense_thr:
        bits = r.read_bitmap(num_colors)
        return np.flatnonzero(bits).astype(np.uint32)
    comp_size = num_colors - size
    comp = np.empty(comp_size, dtype=np.int64)
    prev = -1
    for i in range(comp_size):
        d = r.read_delta()
        prev = d if i == 0 else prev + 1 + d
        comp[i] = prev
    member = np.ones(num_colors, dtype=bool)
    member[comp] = False
    return np.flatnonzero(member).astype(np.uint32)


def decode_set_size(words: np.ndarray, bit_offset: int) -> int:
    return BitReader(words, int(bit_offset)).read_delta()


def decode_all(words: np.ndarray, bit_offsets: np.ndarray, num_colors: int):
    """Decode every set -> (colors_concat u32, set_offsets i64). Prefers the
    native C++ decoder when available; falls back to Python."""
    try:
        from ..native import lib as _native

        return _native.hybrid_decode_all(words, bit_offsets, num_colors)
    except Exception:
        chunks = [decode_set(words, off, num_colors) for off in bit_offsets[:-1]]
        sizes = np.array([len(c) for c in chunks], dtype=np.int64)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        cat = np.concatenate(chunks) if chunks else np.empty(0, np.uint32)
        return cat.astype(np.uint32), offs
