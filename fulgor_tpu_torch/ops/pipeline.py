"""Query steps (counterparts of fulgor_tpu/ops/pipeline.py's jitted steps).

Plain Python functions that launch the kernels in order on the tensors'
device; on CPU tensors every step runs its plain version. `table` is the
(slots, text32, skew) triple of Index.device_tables and `dparams` the
static (m, num_slots) of Index.device_dict, as in fulgor_tpu.
"""

from __future__ import annotations

from .intersect import fi_and
from .minidict2 import SKEW_CAND, VERIFY_BUDGET
from .prep import window_prep
from .probe import minidict2_probe


def query_window_csids_packed(table, codes2, bad, *, k: int, width: int,
                              dparams, probe_budget=None):
    """K1 -> K2 over a packed batch -> (hit, csid, ovf), each (B, Wk)
    (fulgor_tpu pipeline.py:232). Also the deferred redo's probe."""
    m, num_slots = dparams
    vb, sc = probe_budget or (VERIFY_BUDGET, SKEW_CAND)
    slots, text32, skew = table
    prep = window_prep(codes2, bad, width=width, k=k, m=m)
    return minidict2_probe(slots, text32, skew, prep, k=k, m=m,
                           num_slots=num_slots, vb=vb, sc=sc)


def query_full_intersection_packed(table, dense_bits, codes2, bad, *, k: int,
                                   width: int, dparams, probe_budget=None):
    """K1 -> K2 -> K3 -> (result bits (B, C32) int32, ovf (B,) bool)
    (fulgor_tpu pipeline.py:208). A read maps iff its row is non-empty;
    ovf reads need the exact redo."""
    hit, csid, ovf = query_window_csids_packed(
        table, codes2, bad, k=k, width=width, dparams=dparams,
        probe_budget=probe_budget)
    return fi_and(dense_bits, hit, csid), ovf.any(dim=1)
