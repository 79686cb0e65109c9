"""Whole runs of the tiny cells on the CPU (the kernels' plain versions):
the records of every colour path the cells take equal the reference's, and
the result line has the keys a run must print."""

import concurrent.futures
import io
import json

import numpy as np
import pytest

from benchmark import harness


def run(bench, name, traced=False, seed=2**31 + 77):
    return harness.run_cell(bench, name, seed, 0.5, traced, "cpu")


def force_lists(monkeypatch):
    """The engine made to take the lists fetch (K3 or K4, then K9) on the
    tiny index, as a low ekpu makes it at 65,536 colours."""
    from fulgor_tpu_torch.query import engine as engine_mod

    base = engine_mod.QueryEngine

    class Lists(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.use_lists, self.use_runs_fetch = True, False
            self.use_tu_runs = False

    monkeypatch.setattr(engine_mod, "QueryEngine", Lists)
    monkeypatch.setattr(engine_mod, "T_LIST", 8)


@pytest.mark.parametrize("name,path", [("tiny.fi", "runs fetch"),
                                       ("tiny.tu", "dense mask")])
def test_records_equal_the_reference(tiny_bench, small_batches, runs_fetch,
                                     name, path, capsys):
    r = run(tiny_bench, name)
    err = capsys.readouterr().err
    assert f"colour step: {path}" in err
    assert r["correct"], r["checks"]
    assert r["checks"]["records_wrong"]["value"] == 0
    assert r["attempted"] >= 2000


@pytest.mark.parametrize("name", ["tiny.fi", "tiny.tu"])
def test_lists_fetch_records_equal_the_reference(tiny_bench, small_batches,
                                                 monkeypatch, name, capsys):
    force_lists(monkeypatch)
    r = run(tiny_bench, name)
    assert "colour step: lists fetch" in capsys.readouterr().err
    assert r["correct"], r["checks"]


def test_a_wrong_record_fails_the_comparison(tiny_bench, small_batches,
                                             runs_fetch, monkeypatch):
    """The comparison itself: one sampled record's digest altered after
    the window."""
    real = harness.compare

    def altered(jobs, refs):
        lines = jobs[0]["capture"]["lines"]
        q = sorted(lines)[3]
        lines[q] = (lines[q][0], b"x" * 16)
        return real(jobs, refs)

    monkeypatch.setattr(harness, "compare", altered)
    r = run(tiny_bench, "tiny.fi")
    assert not r["correct"]
    assert r["checks"]["records_wrong"]["value"] == 1


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(tiny_bench, small_batches, runs_fetch, traced,
                         capsys):
    r = run(tiny_bench, "tiny.fi", traced=traced)
    assert harness.main_result(r) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in tiny_bench.metrics("tiny.fi", traced)}
    if traced:  # no device on the CPU: the device readers find nothing
        want -= {"kernel_ms_per_mread", "device_idle_share"}
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    # the numbers compared come last on standard error, each beside its
    # limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("[check] ") and " limit " in t for t in tail)


def _rows(rng, n, colours):
    """n bit rows of `colours` colours, of densities from none to all."""
    dens = rng.choice([0.0, 0.001, 0.02, 0.5, 1.0], n)
    keep = rng.random((n, 32 * -(-colours // 32))) < dens[:, None]
    keep[:, colours:] = False
    words = np.packbits(keep, axis=1, bitorder="little").view("<u4")
    return np.ascontiguousarray(words, dtype=np.uint32), keep


@pytest.mark.parametrize("colours", [100, 4546, 65536])
def test_line_lengths_equal_the_formatters(colours):
    """Where the harness finds a call's sampled lines: each line's length
    from the rows, ids or lists the formatter was handed, against the
    program's native formatters' lines."""
    from fulgor_tpu_torch.native import lib as native

    rng = np.random.default_rng(colours)
    n = 200
    qids = rng.integers(0, 10**7, n).astype(np.uint32)
    bits, keep = _rows(rng, n, colours)

    def lengths(buf):
        return [len(x) + 1 for x in bytes(buf).split(b"\n")[:-1]]

    got = lengths(native.format_psa_ascii_bits(qids, bits)[0])
    assert got == (harness._digits(qids)
                   + harness.bits_body_lengths(bits)).tolist()
    inv = rng.integers(0, 20, n).astype(np.int32)
    got = lengths(native.format_psa_ascii_bits_grouped(
        qids, bits[:20], inv)[0])
    want = harness._digits(qids) + harness.bits_body_lengths(bits[:20])[inv]
    assert got == want.tolist()
    lists = [np.flatnonzero(k).astype(np.uint32) for k in keep]
    offs = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    got = lengths(native.format_psa_ascii(qids, np.concatenate(lists),
                                          offs.astype(np.int64)))
    assert got == harness.list_lines(qids, lists).tolist()


def test_keep_takes_the_sampled_lines_across_writes():
    """The formatter's file while a call runs: every byte goes on, and
    the spans' bytes are kept, also where a span crosses writes."""
    spans = concurrent.futures.Future()
    spans.set_result(([2, 9], [5, 14]))
    sink = io.BytesIO()
    keep = harness.Keep(sink, spans)
    for piece in (b"0123", b"456789", b"abcdefgh"):
        keep.write(memoryview(piece))
    assert sink.getvalue() == b"0123456789abcdefgh"
    assert keep.lines() == [b"234", b"9abcd"]
