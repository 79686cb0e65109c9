"""The colour widening of a configuration whose published width is more
colours than the genomes simulated: colour c stands for genome c % G, so
each genome is several clonal isolates, as real collections hold
near-identical isolates. Frozen copy of chip_smoke.py:2422-2445
(`expand_colours`)."""

from __future__ import annotations

import numpy as np


def expand_colours(cat, offs, G, C):
    """Each ascending colour list L of (cat, offs) over G colours ->
    {c < C : c % G in L}, ascending, as (cat, offs): the lists of the copies
    g + G j follow one another in j, each a prefix of L in the last."""
    reps = -(-C // G)
    cat = np.asarray(cat, dtype=np.int64)
    offs = np.asarray(offs, dtype=np.int64)
    sizes = np.diff(offs)
    sid = np.repeat(np.arange(len(sizes)), sizes)
    in_last = cat < C - G * (reps - 1)
    new_sizes = (reps - 1) * sizes + np.bincount(
        sid[in_last], minlength=len(sizes))
    new_offs = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(new_sizes, out=new_offs[1:])
    out = np.empty(int(new_offs[-1]), dtype=np.uint32)
    dest = new_offs[sid] + np.arange(len(cat)) - offs[sid]  # copy j = 0
    step = sizes[sid]
    vals = cat.astype(np.uint32)
    for j in range(reps - 1):
        out[dest] = vals
        dest += step
        vals += np.uint32(G)
    out[dest[in_last]] = vals[in_last]
    return out, new_offs
