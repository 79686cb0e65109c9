"""Single-file index container.

Replaces the reference's `essentials` visitor serialization (SURVEY.md L1)
with a flat, mmap-friendly layout:

    [0:8]    magic  b"FULGTPU1"
    [8:16]   uint64 header length H
    [16:16+H] JSON header {format_version, kind, meta, extra,
                           arrays: {name: {dtype, shape, offset, nbytes}}}
    ...      64-byte-aligned little-endian array blobs

Arrays are read back with np.memmap-like zero-copy (np.frombuffer on a
mmapped file) so index load is O(header) + page faults.
"""

from __future__ import annotations

import json
import mmap
import os

import numpy as np

MAGIC = b"FULGTPU1"
ALIGN = 64


def save(path: str, *, kind: str, meta: dict, extra: dict, arrays: dict[str, np.ndarray]):
    manifest = {}
    blobs = []
    # header size depends on offsets; two-pass: build manifest with dummy
    # offsets to measure header, then fix up.
    def header_bytes(man):
        h = json.dumps(
            {
                "format_version": 1,
                "kind": kind,
                "meta": meta,
                "extra": extra,
                "arrays": man,
            },
            sort_keys=True,
        ).encode()
        return h

    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        manifest[name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": 0,
            "nbytes": arr.nbytes,
        }
        blobs.append((name, arr))

    # iterate until offsets stable (header length can change with offsets)
    for _ in range(4):
        h = header_bytes(manifest)
        pos = 16 + len(h)
        changed = False
        for name, arr in blobs:
            pos = (pos + ALIGN - 1) // ALIGN * ALIGN
            if manifest[name]["offset"] != pos:
                manifest[name]["offset"] = pos
                changed = True
            pos += arr.nbytes
        if not changed:
            break

    h = header_bytes(manifest)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(h)).tobytes())
        f.write(h)
        for name, arr in blobs:
            f.seek(manifest[name]["offset"])
            f.write(arr.tobytes())
    os.replace(tmp, path)


class Container:
    def __init__(self, path: str):
        self.path = path
        f = open(path, "rb")
        self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        f.close()
        assert self._mm[:8] == MAGIC, f"not a fulgor-tpu index: {path}"
        hlen = int(np.frombuffer(self._mm[8:16], dtype=np.uint64)[0])
        hdr = json.loads(self._mm[16 : 16 + hlen].decode())
        self.kind = hdr["kind"]
        self.meta = hdr["meta"]
        self.extra = hdr["extra"]
        self._manifest = hdr["arrays"]

    def array(self, name: str) -> np.ndarray:
        m = self._manifest[name]
        arr = np.frombuffer(self._mm, dtype=np.dtype(m["dtype"]), count=int(np.prod(m["shape"], dtype=np.int64)) if m["shape"] else 1, offset=m["offset"])
        return arr.reshape(m["shape"])

    def names(self):
        return list(self._manifest)

    def nbytes(self, name: str) -> int:
        return self._manifest[name]["nbytes"]

    def close(self):
        self._mm.close()
