"""Pseudoalignment output formatters (reference: src/ps_utils.cpp:48-243).

Formats:
  ascii      : "qid\tn[\tc1\tc2...]\n" per read (README.md:199-220)
  binary     : u32 qid, u32 n, u32 colors[n], little-endian
  compressed : u64 num_colors header; then flush frames [u64 num_bits,
               8-byte-aligned bitstream] of per-result records
               delta(qid) delta(n) hybrid-style payload. Bit codes are ours
               (core/bitsx.py), framing mirrors the reference.

The ascii writers time the native formatting as the tracing span
`write.format` and the file's write as `write.emit` (native/lib.py), and
count the bytes formatted (`write_bytes`).
"""

from __future__ import annotations

import numpy as np

from .. import tracing
from ..core.bitsx import BitWriter
from ..core.hybrid import thresholds


class AsciiFormatter:
    def __init__(self, path: str):
        self.f = open(path, "wb", buffering=1 << 20)

    def write_batch(self, qids, colors_per_read):
        import numpy as np

        from ..native import lib as native

        qarr = np.fromiter(qids, dtype=np.uint32, count=len(colors_per_read))
        sizes = np.fromiter(
            (len(c) for c in colors_per_read), dtype=np.int64, count=len(colors_per_read)
        )
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        cat = (
            np.concatenate(colors_per_read).astype(np.uint32)
            if offs[-1]
            else np.empty(0, np.uint32)
        )
        # bound the native buffer: a redo batch of tens of thousands of
        # near-all-colors results would otherwise format into one multi-GB
        # allocation (each color costs <=11 bytes of ascii)
        MAXC = 32 << 20
        i = 0
        while i < len(qarr):
            j = i
            base = offs[i]
            while j < len(qarr) and offs[j + 1] - base <= MAXC:
                j += 1
            j = max(j, i + 1)
            with tracing.span("write.format"):
                block = native.format_psa_ascii(
                    qarr[i:j], cat[offs[i]: offs[j]],
                    (offs[i: j + 1] - offs[i]).astype(np.int64))
            tracing.count("write_bytes", len(block))
            with tracing.span("write.emit"):
                self.f.write(block)
            i = j

    def write_batch_bits(self, qids: np.ndarray, bits: np.ndarray) -> int:
        """Write a batch straight from (n, C32) u32 bitset rows (the
        device's native result layout) -> number of mapped reads. Skips
        the bits->lists expansion entirely."""
        from ..native import lib as native

        _nbytes, mapped = native.format_psa_ascii_bits(
            qids, bits, sink=self.f.write)
        return mapped

    def write_batch_bits_grouped(self, qids, rows, inv) -> int:
        """Like write_batch_bits, but read i's result is DISTINCT row
        inv[i] of `rows`: each distinct body formats once (the runs-fetch
        pipeline's dedup structure, reference tools/pseudoalign.cpp:91-226)."""
        from ..native import lib as native

        _nbytes, mapped = native.format_psa_ascii_bits_grouped(
            qids, rows, inv, sink=self.f.write)
        return mapped

    def close(self):
        self.f.close()


class BinaryFormatter:
    def __init__(self, path: str):
        self.f = open(path, "wb", buffering=1 << 20)

    def write_batch(self, qids, colors_per_read):
        sizes = np.array([len(c) for c in colors_per_read], dtype=np.uint32)
        total = 2 * len(qids) + int(sizes.sum())
        buf = np.empty(total, dtype=np.uint32)
        pos = 0
        for qid, cols in zip(qids, colors_per_read):
            buf[pos] = qid
            buf[pos + 1] = len(cols)
            buf[pos + 2 : pos + 2 + len(cols)] = cols
            pos += 2 + len(cols)
        self.f.write(buf.tobytes())

    def close(self):
        self.f.close()


class CompressedFormatter:
    def __init__(self, path: str, num_colors: int):
        self.f = open(path, "wb", buffering=1 << 20)
        self.num_colors = num_colors
        self.f.write(np.uint64(num_colors).tobytes())
        self.sparse_thr, self.dense_thr = thresholds(num_colors)

    def write_batch(self, qids, colors_per_read):
        w = BitWriter()
        N = self.num_colors
        for qid, cols in zip(qids, colors_per_read):
            n = len(cols)
            w.append_deltas(np.array([qid, n], dtype=np.uint64))
            if n == 0:
                continue
            if n < self.sparse_thr:
                vals = np.empty(n, dtype=np.uint64)
                vals[0] = cols[0]
                vals[1:] = (cols[1:].astype(np.int64) - cols[:-1] - 1).astype(np.uint64)
                w.append_deltas(vals)
            elif n < self.dense_thr:
                bits = np.zeros(N, dtype=bool)
                bits[np.asarray(cols, dtype=np.int64)] = True
                w.append_bits(bits)
            else:
                member = np.zeros(N, dtype=bool)
                member[np.asarray(cols, dtype=np.int64)] = True
                comp = np.flatnonzero(~member)
                if len(comp):
                    vals = np.empty(len(comp), dtype=np.uint64)
                    vals[0] = comp[0]
                    vals[1:] = (comp[1:] - comp[:-1] - 1).astype(np.uint64)
                    w.append_deltas(vals)
        nbits = w.num_bits
        self.f.write(np.uint64(nbits).tobytes())
        self.f.write(w.finalize().tobytes())

    def close(self):
        self.f.close()


def compressed_psa_num_colors(path: str) -> int:
    """Read just the u64 num_colors header of a compressed psa file."""
    with open(path, "rb") as f:
        head = f.read(8)
    assert len(head) == 8, "truncated compressed file (missing header)"
    return int(np.frombuffer(head, dtype=np.uint64)[0])


def iter_compressed_psa(path: str, num_colors: int | None = None):
    """Stream (qid, sorted uint32 color array) records from a
    CompressedFormatter file frame-at-a-time — bounded memory regardless
    of file size (records are self-delimiting; frame framing mirrors the
    reference's src/ps_utils.cpp:149-243)."""
    from ..core.bitsx import BitReader

    if num_colors is None:
        num_colors = compressed_psa_num_colors(path)
    sparse_thr, dense_thr = thresholds(num_colors)
    with open(path, "rb") as f:
        f.seek(8)
        while True:
            head = f.read(8)
            if not head:
                return
            assert len(head) == 8, "truncated frame header"
            nbits = int(np.frombuffer(head, dtype=np.uint64)[0])
            nbytes = 8 * ((nbits + 63) // 64)
            body = f.read(nbytes)
            assert len(body) == nbytes, "truncated frame body"
            words = np.frombuffer(body, dtype=np.uint64)
            r = BitReader(words)
            while r.pos < nbits:
                qid = r.read_delta()
                n = r.read_delta()
                if n == 0:
                    yield qid, np.empty(0, dtype=np.uint32)
                    continue
                if n < sparse_thr:
                    vals = np.empty(n, dtype=np.int64)
                    vals[0] = r.read_delta()
                    for i in range(1, n):
                        vals[i] = vals[i - 1] + r.read_delta() + 1
                    yield qid, vals.astype(np.uint32)
                elif n < dense_thr:
                    bits = r.read_bitmap(num_colors)
                    yield qid, np.flatnonzero(bits).astype(np.uint32)
                else:
                    nc = num_colors - n
                    member = np.ones(num_colors, dtype=bool)
                    if nc:
                        prev = r.read_delta()
                        member[prev] = False
                        for _ in range(nc - 1):
                            prev = prev + r.read_delta() + 1
                            member[prev] = False
                    yield qid, np.flatnonzero(member).astype(np.uint32)


def read_compressed_psa(path: str):
    """Decode a CompressedFormatter file back to per-read color lists — the
    consumable counterpart the reference defines for its compressed output
    (src/ps_utils.cpp:149-243: u64 num_colors header, then flush frames of
    [u64 num_bits | bitstream] with per-result delta(qid) delta(n) and a
    hybrid sparse/bitmap/complement payload).

    -> (num_colors, dict qid -> sorted uint32 color array)."""
    num_colors = compressed_psa_num_colors(path)
    return num_colors, dict(iter_compressed_psa(path, num_colors))


def make_formatter(fmt: str, path: str, num_colors: int):
    if fmt == "ascii":
        return AsciiFormatter(path)
    if fmt == "binary":
        return BinaryFormatter(path)
    if fmt == "compressed":
        return CompressedFormatter(path, num_colors)
    raise ValueError(f"unknown output format: {fmt} (ascii|binary|compressed)")
