"""The lists fetch on the CPU (plain versions of the kernels), against
fulgor_tpu, tolerance 0:

- K9's plain version first_set_bits_plain against fulgor_tpu's
  first_set_bits at C32 in {1, 5, 32, 33, 143} (around K9's chunk of 32
  words) and T in {1, 3, 31, 32, 33, 64, 65} (around its group of 32
  slots), on seeded
  random rows with empty rows, all-ones rows, rows whose only bit is bit
  31 and rows with more than T bits; the wrapper refuses other devices;
- the steps query_fi_lists_packed and query_tu_lists_packed against
  fulgor_tpu's on test_torch_engine's index;
- the engine with use_lists forced on test_torch_large_c's 4,546-colour
  graft, at T_LIST = 3 (most reads pass T and take the row fetch) and 64:
  FI and TU files equal fulgor_tpu's, records sorted by read id; and on
  test_torch_engine's 5-colour index, where reads fall on both sides of
  T_LIST = 3, in every format.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import intersect as JI
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu.query import engine as JE
from fulgor_tpu_torch.ops import intersect as TI
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import pipeline as TP
from fulgor_tpu_torch.query import engine as E
from tests.test_torch_engine import _records, corpus  # noqa: F401
from tests.test_torch_large_c import (  # noqa: F401
    NUM_READS, engines, run_both, wide,
)
from tests.test_torch_union_engine import _step_inputs
from tests.test_torch_threads import one_thread  # noqa: F401


def edge_rows(C32: int, T: int, seed: int) -> np.ndarray:
    """(40, C32) u32 rows: seeded random words, sparse rows, and the edge
    rows (empty, all ones, bit 31 only in the last word, more than T set
    bits in one word and spread over the row)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, size=(40, C32), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[10:20] &= rng.integers(0, 1 << 32, size=(10, C32),
                                dtype=np.uint64).astype(np.uint32)
    rows[20:30] *= rng.random((10, C32)) < 0.1
    rows[30] = 0
    rows[31] = 0xFFFFFFFF
    rows[32] = 0
    rows[32, -1] = 0x80000000
    rows[33] = 0
    rows[33, 0] = (1 << min(32, T + 1)) - 1 if T < 31 else 0xFFFFFFFF
    rows[34] = 0
    rows[34, ::2] = 0x80000001
    return rows


@pytest.mark.parametrize("C32", [1, 5, 32, 33, 143])
@pytest.mark.parametrize("T", [1, 3, 31, 32, 33, 64, 65])
def test_first_set_bits_plain_matches_reference(C32, T):
    rows = edge_rows(C32, T, seed=C32 * 100 + T)
    want_count, want_lists = JI.first_set_bits(jnp.asarray(rows), T)
    count, lists = TI.first_set_bits(torch.from_numpy(rows.view(np.int32)),
                                     T)
    assert count.dtype == lists.dtype == torch.int32
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    np.testing.assert_array_equal(lists.numpy(), np.asarray(want_lists))
    assert count[31] == 32 * C32 and count[30] == 0
    assert lists[32, 0] == 32 * C32 - 1  # bit 31: a negative int32 word
    assert not lists[30].any()
    assert (count > T).any() == (32 * C32 > T)


def test_first_set_bits_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        TI.first_set_bits(torch.zeros((4, 3), dtype=torch.int32,
                                      device="meta"), 3)


class _CardRows:
    """A stand-in for an int32 (B, C32) tensor on a CUDA card."""

    def __init__(self, shape):
        self.shape = shape
        self.device = torch.device("cuda", 0)
        self.dtype = torch.int32

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("shape", [(0, 143), (4, 0), (0, 0)])
def test_first_set_bits_empty_card_rows_skip_plain(monkeypatch, shape):
    """Card rows with no reads or no words get the wrapper's own zeroed
    outputs: neither the plain version nor the kernel runs."""
    def refuse(*_a, **_k):
        raise AssertionError("card rows reached the plain version or kernel")

    empty = torch.empty
    monkeypatch.setattr(TI, "first_set_bits_plain", refuse)
    monkeypatch.setattr(TI.kernels, "library", refuse)
    # the outputs land on the CPU here; the wrapper asks for the rows' device
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: (
        empty(*a, **k) if device.type == "cuda" else refuse()))
    before = dict(TI.kernels.launches)
    count, lists = TI.first_set_bits(_CardRows(shape), 3)
    assert TI.kernels.launches == before
    assert tuple(count.shape) == (shape[0],)
    assert tuple(lists.shape) == (shape[0], 3)
    assert not count.any() and not lists.any()


@pytest.mark.parametrize("step", ["fi", "tu"])
@pytest.mark.parametrize("T,pb", [(3, (1, 1)), (64, (2, 2))])
def test_lists_steps_match_reference(corpus, step, T, pb):  # noqa: F811
    """query_fi_lists_packed and query_tu_lists_packed (tau 0.8) on a
    (64, 96) batch, at the default probe budget and at (1, 1), where reads
    overflow: count, lists, the (B, C32) rows and ovf equal fulgor_tpu's."""
    idx, dparams, jargs, targs = _step_inputs(corpus[0])
    Wk = 96 - idx.k + 1
    tab = (np.arange(Wk + 1, dtype=np.float64) * 0.8).astype(np.int32)
    kw = dict(k=idx.k, width=96, T=T, dparams=dparams, probe_budget=pb)
    if step == "fi":
        want = JP.query_fi_lists_packed(*jargs, **kw)
        got = TP.query_fi_lists_packed(*targs, **kw)
    else:
        kw["num_colors"] = idx.num_colors
        want = JP.query_tu_lists_packed(*jargs, jnp.asarray(tab), **kw)
        got = TP.query_tu_lists_packed(*targs, torch.from_numpy(tab), **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    assert (got[0] > 0).any()
    if pb == (1, 1):
        assert got[3].sum() > 10


@pytest.mark.parametrize("tool,T", [("fi", 3), ("fi", 64), ("tu0.8", 3),
                                    ("tu0.8", 64), ("tu0.25", 3)])
def test_forced_lists_match_reference(wide, tmp_path,  # noqa: F811
                                      monkeypatch, tool, T):
    """use_lists forced in both packages on the 4,546-colour graft; at
    T_LIST = 3 nearly every read passes T and takes the row fetch."""
    monkeypatch.setattr(JE, "T_LIST", T)
    monkeypatch.setattr(E, "T_LIST", T)
    jeng, teng = engines(wide, monkeypatch)
    assert not teng.use_lists and teng.use_runs_fetch
    jeng.use_lists = teng.use_lists = True
    kw = {} if tool == "fi" else {"threshold": float(tool[2:])}
    want, got, _st = run_both(jeng, teng, wide[2], tmp_path, **kw)
    assert got == want and len(got) == NUM_READS
    counts = [ln.count(b"\t") - 1 for ln in got]
    assert sum(c > T for c in counts) > NUM_READS // 2


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_forced_lists_narrow_index_matches_reference(corpus, tmp_path,  # noqa: F811
                                                     monkeypatch, fmt):
    """use_lists forced on the 5-colour index at T_LIST = 3: reads of up to
    3 colours come from their lists, the others from their fetched rows;
    the records equal fulgor_tpu's FI records (long and junk reads
    included)."""
    tmp, qfile, refs, n = corpus
    monkeypatch.setattr(E, "T_LIST", 3)
    eng = E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), batch_size=256,
                        device="cpu")
    eng.use_lists = True
    out = str(tmp_path / f"lists.{fmt}")
    eng.pseudoalign_file(qfile, out, fmt=fmt)
    got = _records(out, fmt)
    assert got == refs[fmt] and len(got) == n
    sizes = [len(c) for c in got.values()]
    assert min(sizes) == 0 and any(0 < k <= 3 for k in sizes)
    assert max(sizes) > 3
