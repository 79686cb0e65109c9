"""The plain reference of a pseudoalignment record, in PyTorch (on the
card after the window, or on the CPU in the tests). It imports nothing of
the program: it works each read's colours out again from the corpus's own
codes (corpus.py) and the read's codes.

A window of a read is its k-mer at one position; it is positive where
some genome of the corpus holds that k-mer, either strand (its canonical
key, the smaller of the forward and reverse-complement 2-bit codes). For
each read r and genome g, counts[r, g] is the number of r's positive
windows whose k-mer g holds, and npos[r] the number of r's positive
windows. Then with colour c standing for genome c % G:

    FI:  the colours whose genome holds every positive window
         (counts == npos), none where npos == 0;
    TU:  the colours whose genome holds at least int(npos * tau) of them,
         int() of the float64 product, none where npos == 0.

`fingerprint_bits` keys the k-mers by that many bits of a multiplicative
hash instead of their whole code: the control (control.py), which breaks
the guarantee that a k-mer counts only where the corpus holds it.
"""

from __future__ import annotations

import numpy as np
import torch

SEP = 4
GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15 as an int64


def window_keys(codes: torch.Tensor, k: int):
    """Every k-window of a 1-D int64 code tensor -> (canonical keys int64,
    valid bool): a window that holds a code above 3 is not valid."""
    n = codes.numel()
    m = n - k + 1
    if m <= 0:
        e = torch.empty(0, dtype=torch.int64, device=codes.device)
        return e, e.bool()
    bad = codes > 3
    x = torch.where(bad, torch.zeros_like(codes), codes)
    fw = torch.zeros(m, dtype=torch.int64, device=codes.device)
    rc = torch.zeros(m, dtype=torch.int64, device=codes.device)
    for j in range(k):
        seg = x[j: j + m]
        fw = (fw << 2) | seg
        rc = rc | ((3 - seg) << (2 * j))
    cb = torch.zeros(n + 1, dtype=torch.int64, device=codes.device)
    cb[1:] = torch.cumsum(bad.to(torch.int64), 0)
    valid = (cb[k:] - cb[:m]) == 0
    return torch.minimum(fw, rc), valid


def fingerprint(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """The top `bits` bits of keys * GOLDEN mod 2**64."""
    return ((keys * GOLDEN) >> (64 - bits)) & ((1 << bits) - 1)


def genome_counts(codes: np.ndarray, genome_offs: np.ndarray,
                  reads: np.ndarray, k: int, device,
                  fingerprint_bits: int | None = None,
                  block_bases: int = 1 << 28, block_cells: int = 1 << 30):
    """(npos (R,) int64, counts (R, G) int32) of the reads (R, L) u8
    against the corpus (codes, genome_offs), its genomes scanned in blocks
    of at most block_bases codes and block_cells (genome, read, window)
    cells."""
    G = len(genome_offs) - 1
    R, L = reads.shape
    Wk = max(0, L - k + 1)
    flat = np.full((R, L + 1), SEP, dtype=np.uint8)
    flat[:, :L] = reads
    rk, rv = window_keys(
        torch.from_numpy(flat.reshape(-1)).to(device, torch.int64), k)
    pos = (torch.arange(R, device=device)[:, None] * (L + 1)
           + torch.arange(Wk, device=device)[None, :])
    rk, rv = rk[pos], rv[pos]
    if fingerprint_bits is not None:
        rk = fingerprint(rk, fingerprint_bits)
    uniq, inv = torch.unique(rk[rv], return_inverse=True)
    nU = uniq.numel()
    uw = torch.full((R, Wk), nU, dtype=torch.int64, device=device)
    uw[rv] = inv
    counts = torch.zeros((R, G), dtype=torch.int32, device=device)
    present_any = torch.zeros(nU + 1, dtype=torch.bool, device=device)
    offs = np.asarray(genome_offs, dtype=np.int64)
    per_genome = max(1, R * Wk)
    g = 0
    while g < G:
        g1 = g + 1
        while (g1 < G and offs[g1 + 1] - offs[g] <= block_bases
               and (g1 + 1 - g) * per_genome <= block_cells):
            g1 += 1
        seg = torch.from_numpy(np.array(codes[offs[g]: offs[g1]])).to(
            device, torch.int64)
        keys, valid = window_keys(seg, k)
        if fingerprint_bits is not None:
            keys = fingerprint(keys, fingerprint_bits)
        pres = torch.zeros((g1 - g, nU + 1), dtype=torch.bool, device=device)
        if nU and keys.numel():
            at = torch.searchsorted(uniq, keys).clamp_(max=nU - 1)
            hit = valid & (uniq[at] == keys)
            where = torch.nonzero(hit).squeeze(1)
            rel = torch.from_numpy(offs[g + 1: g1 + 1] - offs[g]).to(device)
            gid = torch.searchsorted(rel, where, right=True)
            pres[gid, at[where]] = True
        pres[:, nU] = False
        present_any |= pres.any(0)
        counts[:, g:g1] = pres[:, uw].sum(-1, dtype=torch.int32).T
        g = g1
    npos = present_any[uw].sum(1)
    return npos.cpu().numpy(), counts.cpu().numpy()


def colour_lists(npos: np.ndarray, counts: np.ndarray, tau, colours: int):
    """Each read's ascending colour ids (uint32): FI where tau is None,
    else TU at tau; colour c stands for genome c % G."""
    G = counts.shape[1]
    reps = -(-colours // G)
    out = []
    for n, row in zip(npos.tolist(), counts):
        if n == 0:
            out.append(np.empty(0, dtype=np.uint32))
            continue
        need = n if tau is None else int(float(n) * tau)
        keep = np.tile(row >= need, reps)[:colours]
        out.append(np.flatnonzero(keep).astype(np.uint32))
    return out


class AsciiLines:
    """The ascii record of a read, "qid\\tn[\\tc1\\tc2...]\\n" (fulgor's
    README.md:199-220), made by array gathers from one table of every
    colour's "\\t<id>"."""

    def __init__(self, colours: int):
        parts = [b"\t%d" % c for c in range(colours)]
        self.size = np.array([len(p) for p in parts], dtype=np.int64)
        self.start = np.zeros(colours, dtype=np.int64)
        np.cumsum(self.size[:-1], out=self.start[1:])
        self.buf = np.frombuffer(b"".join(parts), dtype=np.uint8)

    def line(self, qid: int, cols: np.ndarray) -> bytes:
        cols = np.asarray(cols, dtype=np.int64)
        size = self.size[cols]
        total = int(size.sum())
        first = np.cumsum(size) - size
        at = (np.repeat(self.start[cols] - first, size)
              + np.arange(total, dtype=np.int64))
        return (b"%d\t%d" % (qid, len(cols)) + self.buf[at].tobytes()
                + b"\n")
