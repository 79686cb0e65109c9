"""Host-side 2-bit packing of read batches (fulgor_tpu ops/lookup.py:38)."""

from __future__ import annotations

import numpy as np


def pack_reads_host(chunk: np.ndarray):
    """(B, W) uint8 codes (0..3, >=4 invalid/pad; W % 32 == 0) ->
    (codes2 (B, W//4) uint8, four bases per byte LSB-first with invalid
    bases as 0; bad (B, W//8) uint8, one bit per base, little-endian). This
    wire format is also the window-prep kernel's input."""
    B, W = chunk.shape
    assert W % 32 == 0
    bad = chunk >= 4
    c = np.where(bad, 0, chunk).astype(np.uint8)
    codes2 = (
        c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    ).astype(np.uint8)
    badm = np.packbits(bad, axis=1, bitorder="little")
    return codes2, badm
