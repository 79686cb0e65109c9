"""The timed path broken underneath a run, the harness's look for a card
skipped: each fault a cell can have makes `correct` false. The cells run
on one card and no model, so of the faults a run can have two apply: half of
a batch left out, and an answer altered where it is produced (each colour
path's own step)."""

import numpy as np
import pytest

from benchmark.tests.test_bench_runs import force_lists, run


def test_half_of_each_batch_left_out(tiny_bench, small_batches, runs_fetch,
                                     monkeypatch):
    from fulgor_tpu_torch.query import engine as engine_mod

    W = engine_mod.AsyncWriter
    real = W.write_batch_bits_grouped

    def half(self, ids, rows, inv):
        return real(self, ids[::2], rows, inv[::2])

    monkeypatch.setattr(W, "write_batch_bits_grouped", half)
    r = run(tiny_bench, "tiny.fi")
    assert not r["correct"]
    assert r["checks"]["reads_not_written_once"]["value"] > 0


def _flip_first_bit(rows):
    rows = np.array(rows, copy=True)
    rows[:, 0] ^= np.uint32(1)
    return rows


@pytest.mark.parametrize("name", ["tiny.fi", "tiny.tu", "lists"])
def test_an_answer_altered_where_it_is_produced(tiny_bench, small_batches,
                                                runs_fetch, monkeypatch,
                                                name):
    import torch

    from fulgor_tpu_torch.query import engine as engine_mod

    if name == "tiny.fi":  # the runs fetch's host AND
        real = engine_mod.QueryEngine._intersect_segments
        monkeypatch.setattr(
            engine_mod.QueryEngine, "_intersect_segments",
            lambda self, *a: _flip_first_bit(real(self, *a)))
    elif name == "tiny.tu":  # K4's mask
        real = engine_mod.query_tu_bits_packed

        def mask(*a, **kw):
            bits, ovf = real(*a, **kw)
            return bits ^ torch.ones_like(bits[:, :1]), ovf

        monkeypatch.setattr(engine_mod, "query_tu_bits_packed", mask)
    else:  # K9's lists
        force_lists(monkeypatch)
        real = engine_mod.query_fi_lists_packed

        def lists(*a, **kw):
            count, ids, bits, ovf = real(*a, **kw)
            return count, ids ^ 1, bits, ovf

        monkeypatch.setattr(engine_mod, "query_fi_lists_packed", lists)
        name = "tiny.fi"
    r = run(tiny_bench, name)
    assert not r["correct"]
    assert r["checks"]["records_wrong"]["value"] > 0


def test_the_redo_altered(tiny_bench, small_batches, runs_fetch,
                          monkeypatch):
    """The deferred redo's answers altered: every read sampled, so the
    redone ones are among them."""
    from fulgor_tpu_torch.query import engine as engine_mod

    from benchmark import harness

    monkeypatch.setattr(harness, "SAMPLE_BLOCKS",
                        tiny_bench.cell("tiny.fi")["reads_per_job"]
                        // harness.SAMPLE_BLOCK)
    real = engine_mod.QueryEngine._fi_lists_from_csids_many

    def redo(self, csids_list):
        return [np.setxor1d(c, [0]).astype(np.uint32)
                for c in real(self, csids_list)]

    monkeypatch.setattr(engine_mod.QueryEngine, "_fi_lists_from_csids_many",
                        redo)
    r = run(tiny_bench, "tiny.fi")
    assert not r["correct"]
    assert r["checks"]["records_wrong"]["value"] > 0
