"""The large-colour regime on the CPU (plain versions of the kernels),
against fulgor_tpu on a wide store grafted onto test_torch_engine's index
(test_bigc's recipe, one device): colour c of the 4,546-colour store stands
for genome c % 5 of the corpus, each set thinned at random, so the 31 sets
keep their ids and the dictionary stays valid.

- the engine's strategy flags equal fulgor_tpu's for the same index and
  dense limit;
- the host segmented AND (member lists, decoded rows, the choice between
  them) and Index.color_rows against fulgor_tpu's, and a chunk of empty
  sets, where fulgor_tpu raises IndexError and the port answers;
- the runs fetch with its run budget forced to 2 (the run-overflow gather
  fires) and the no-dense-matrix regime (dense_max_bytes=0, with
  dense_color_bits raising): FI, TU at 0.8 and 0.25 and --deduplicate
  files equal fulgor_tpu's, records sorted by read id;
- fulgor_tpu's eight tuning variables, each reaching the port's engine or
  index, FULGOR_DENSE_MAX_BYTES=0 also through the port's CLI.
"""

import dataclasses
import gzip

import numpy as np
import pytest

from fulgor_tpu.core.colorstores import HybridStore as JHybridStore
from fulgor_tpu.index import Index as JIndex
from fulgor_tpu.query import engine as JE
from fulgor_tpu_torch import cli as tcli
from fulgor_tpu_torch.core.colorstores import HybridStore as THybridStore
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.query import engine as E
from tests.test_torch_engine import _records, corpus  # noqa: F401
from tests.test_torch_threads import one_thread  # noqa: F401

WIDE_C = 4546  # the reference's Salmonella index: C32 = 143
NUM_READS = 120
BATCH = 64


def _graft(idx, store_cls, cat, offs):
    return dataclasses.replace(
        idx, num_colors=WIDE_C, filenames=[],
        color_store=store_cls.build(cat, offs, WIDE_C), _dense_bits=None,
        _cs_cache=None, _row_memo=None, _row_pos=None, _row_n=0)


@pytest.fixture(scope="module")
def wide(corpus):  # noqa: F811
    """(fulgor_tpu index, port index, reads file) of the wide graft; the
    reads are the corpus's first NUM_READS without the one over 1,024
    bases, and its junk read."""
    tmp = corpus[0]
    jidx = JIndex.load(str(tmp / "jidx.tfur"))
    tidx = TIndex.load(str(tmp / "tidx.tfur"))
    cat, offs = tidx.color_sets_decoded()
    rng = np.random.default_rng(5)
    colours = np.arange(WIDE_C, dtype=np.uint32)
    sets = []
    for s in range(tidx.num_color_sets):
        members = colours[np.isin(colours % tidx.num_colors,
                                  cat[offs[s]: offs[s + 1]])]
        thin = members[rng.random(len(members)) < 0.97]
        sets.append(thin if len(thin) else members[:1])
    wcat = np.concatenate(sets)
    woffs = np.concatenate([[0], np.cumsum([len(s) for s in sets])])
    with gzip.open(corpus[1], "rt") as f:
        lines = f.read().splitlines()
    recs = [lines[i: i + 4] for i in range(0, len(lines), 4)]
    keep = [r for r in recs[:NUM_READS] if not r[0].startswith("@verylong")]
    reads = str(tmp / "wide_reads.fq")
    with open(reads, "w") as f:
        f.write("\n".join(sum(keep + [recs[-1]], [])) + "\n")
    return (_graft(jidx, JHybridStore, wcat, woffs.astype(np.int64)),
            _graft(tidx, THybridStore, wcat, woffs.astype(np.int64)), reads)


def _fresh(idx):
    """A copy of a grafted index with nothing decoded or cached."""
    return dataclasses.replace(idx, _dense_bits=None, _cs_cache=None,
                               _row_memo=None, _row_pos=None, _row_n=0)


def _forbid_dense(*indexes):
    def boom():
        raise AssertionError("the dense colour matrix was built")

    for idx in indexes:
        idx.dense_color_bits = boom
        if isinstance(idx, TIndex):
            idx.device_dense = lambda device: boom()


def engines(wide, monkeypatch, dense_max_bytes=None):
    """(fulgor_tpu engine, port engine) on fresh copies of the graft, both
    under the same dense limit (fulgor_tpu's default where None)."""
    j, t, _reads = wide
    j, t = _fresh(j), _fresh(t)
    kw = {}
    if dense_max_bytes is not None:
        monkeypatch.setenv("FULGOR_DENSE_MAX_BYTES", str(dense_max_bytes))
        kw["dense_max_bytes"] = dense_max_bytes
    if dense_max_bytes == 0:
        _forbid_dense(j, t)
    return (JE.QueryEngine(j, batch_size=BATCH, use_mesh=False),
            E.QueryEngine(t, batch_size=BATCH, device="cpu", **kw))


def sorted_records(path) -> list:
    with open(path, "rb") as f:
        return sorted(f.read().splitlines(),
                      key=lambda ln: int(ln[: ln.index(b"\t")]))


def run_both(jeng, teng, reads, tmp_path, **kw):
    """The same pseudoalign_file call on both engines -> (fulgor_tpu's
    records, the port's, the port's stats), records sorted by read id."""
    out_j, out_t = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    jeng.pseudoalign_file(reads, out_j, **kw)
    st = teng.pseudoalign_file(reads, out_t, **kw)
    return sorted_records(out_j), sorted_records(out_t), st


FLAG_CASES = [("narrow", None), ("wide", None), ("wide", 0), ("wide", "exact"),
              ("shredded", None), ("shredded", 0)]


@pytest.mark.parametrize("store,limit", FLAG_CASES)
def test_strategy_flags_match_reference(corpus, wide,  # noqa: F811
                                        monkeypatch, store, limit):
    """use_lists, use_runs_fetch, use_tu_runs, the runs-ok signal and the
    run budget, for the corpus's own 5-colour index and the wide graft,
    at fulgor_tpu's default dense limit, at 0 and at exactly the dense
    bytes; "shredded" reports an ekpu under 8 (fulgor_tpu's lists-fetch
    regime)."""
    if store == "narrow":
        tmp = corpus[0]
        j = JIndex.load(str(tmp / "jidx.tfur"))
        t = TIndex.load(str(tmp / "tidx.tfur"))
        wide = (j, t, None)
    if limit == "exact":
        t = wide[1]
        limit = t.num_color_sets * t.words_per_set * 4
    if store == "shredded":
        monkeypatch.setattr(JIndex, "expected_kmers_per_unitig",
                            lambda self: 4.0)
        monkeypatch.setattr(TIndex, "expected_kmers_per_unitig",
                            lambda self: 4.0)
    jeng, teng = engines(wide, monkeypatch, limit)
    flags = ("use_lists", "use_runs_fetch", "use_tu_runs", "_runs_ok",
             "_runs_R")
    assert ({f: getattr(teng, f) for f in flags}
            == {f: getattr(jeng, f) for f in flags})
    expect = {"narrow": (False, False), "wide": (False, True),
              "shredded": (True, False)}[store]
    if limit == 0:
        expect = (False, True)
    assert (teng.use_lists, teng.use_runs_fetch) == expect
    assert teng._bits is None


@pytest.mark.parametrize("path", ["lists", "rows", "choice"])
def test_intersect_segments_match_reference(wide, monkeypatch, path):
    """The host segmented AND over 200 random keys of 0-6 csids (repeats
    across keys, empty keys included, the last of one csid), with no dense
    matrix, against fulgor_tpu's, bit for bit."""
    jeng, teng = engines(wide, monkeypatch, 0)
    rng = np.random.default_rng(7)
    sizes = rng.integers(0, 7, size=200).astype(np.int64)
    sizes[-1] = 1  # the last segment of the chunk holds one set
    S = teng.idx.num_color_sets
    flat = np.concatenate([np.sort(rng.choice(S, size=n, replace=False))
                           for n in sizes]).astype(np.int64)
    fn = {"lists": "_intersect_segments_lists",
          "rows": "_intersect_segments_rows",
          "choice": "_intersect_segments"}[path]
    want = getattr(jeng, fn)(flat, sizes)
    got = getattr(teng, fn)(flat, sizes)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (200, 143) and got.any(axis=1).sum() > 50
    assert not got[sizes == 0].any()
    assert teng.idx._dense_bits is None


def test_empty_sets_chunk_answers_where_reference_raises(wide, monkeypatch):
    """A chunk whose sets hold no member (fulgor_tpu engine.py:623-624):
    fulgor_tpu's list intersection indexes an empty array and raises
    IndexError; the port's rows stay empty."""
    jeng, teng = engines(wide, monkeypatch, 0)
    cat, offs = teng._cs_cache
    empty = (cat, np.concatenate([offs[:3], np.full(len(offs) - 3, offs[2])]))
    jeng._cs_cache = teng._cs_cache = empty
    flat, sizes = np.array([5, 9, 7], np.int64), np.array([2, 1], np.int64)
    with pytest.raises(IndexError):
        jeng._intersect_segments_lists(flat, sizes)
    got = teng._intersect_segments_lists(flat, sizes)
    assert got.shape == (2, 143) and not got.any()


def test_color_rows_match_reference(wide, monkeypatch):
    """Index.color_rows decoded on demand, across a memo reset, against
    fulgor_tpu's and against the dense rows."""
    j, t = _fresh(wide[0]), _fresh(wide[1])
    monkeypatch.setenv("FULGOR_ROW_MEMO_BYTES", str(20 * 143 * 4))
    rng = np.random.default_rng(9)
    for n in (5, 12, 18, 3):  # the third call resets the memo
        ids = rng.integers(0, t.num_color_sets, size=n)
        np.testing.assert_array_equal(t.color_rows(ids), j.color_rows(ids))
    assert t._dense_bits is None and t._row_n <= 20
    dense = _fresh(wide[1]).dense_color_bits()
    np.testing.assert_array_equal(t.color_rows(np.arange(31)), dense)


E2E = [("runs", "fi"), ("runs", "tu0.8"), ("nodense", "fi"),
       ("nodense", "tu0.8"), ("nodense", "tu0.25"), ("nodense", "dedup")]


@pytest.mark.parametrize("mode,tool", E2E)
def test_large_c_paths_match_reference(wide, tmp_path, monkeypatch, mode,
                                       tool):
    """runs: the default strategy of the graft (runs fetch FI, K4 TU), the
    run budget forced to 2 in both packages; nodense: dense_max_bytes=0
    (runs fetch FI, K6 runs TU scored on the host, --deduplicate), the dense
    matrix forbidden. Records sorted by read id equal fulgor_tpu's."""
    if mode == "runs":
        monkeypatch.setattr(JE, "RUNS_FI_BUDGET", 2)
        monkeypatch.setattr(E, "RUNS_FI_BUDGET", 2)
    jeng, teng = engines(wide, monkeypatch, 0 if mode == "nodense" else None)
    assert teng.use_runs_fetch
    assert teng._runs_R == (2 if mode == "runs" else 48)
    kw = ({"deduplicate": True} if tool == "dedup"
          else {"threshold": float(tool[2:])} if tool.startswith("tu")
          else {})
    want, got, st = run_both(jeng, teng, wide[2], tmp_path, **kw)
    assert got == want and len(got) == NUM_READS
    assert sum(1 for ln in got if ln.count(b"\t") > 1) > NUM_READS // 2
    if mode == "runs" and tool == "fi":
        assert st["num_run_ovf"] > 0 and teng._runs_R == 4
    if mode == "nodense":
        assert teng._bits is None and teng.idx._dense_bits is None
        assert teng.use_tu_runs
        if tool in ("fi", "dedup"):  # the ANDs took decoded rows
            assert teng.idx._row_n > 0


@pytest.mark.parametrize("fmt", ["binary", "compressed"])
def test_runs_fetch_writes_every_format(wide, tmp_path, monkeypatch, fmt):
    """With no dense matrix the port's runs fetch writes binary and
    compressed output too (fulgor_tpu takes the dense path there): the
    records equal fulgor_tpu's ascii records, the run budget forced to 2."""
    monkeypatch.setattr(JE, "RUNS_FI_BUDGET", 2)
    monkeypatch.setattr(E, "RUNS_FI_BUDGET", 2)
    jeng, teng = engines(wide, monkeypatch, 0)
    out_j, out_t = str(tmp_path / "j.tsv"), str(tmp_path / f"t.{fmt}")
    jeng.pseudoalign_file(wide[2], out_j)
    st = teng.pseudoalign_file(wide[2], out_t, fmt=fmt)
    got = _records(out_t, fmt)
    assert got == _records(out_j, "ascii") and len(got) == NUM_READS
    assert st["num_run_ovf"] > 0 and teng.idx._dense_bits is None


def _no_dense(*_args):
    raise AssertionError("the dense colour matrix was built")


TUNING = ["FULGOR_MAX_LANES", "FULGOR_REDO_FLUSH", "FULGOR_RUNS_MIN_WORDS",
          "FULGOR_RUNS_FI_BUDGET", "FULGOR_FI_KEY_CACHE",
          "FULGOR_FI_KEY_CACHE_BYTES", "FULGOR_ROW_MEMO_BYTES",
          "FULGOR_DENSE_MAX_BYTES"]


@pytest.mark.parametrize("var", TUNING)
def test_tuning_variables_reach_the_port(wide, tmp_path, monkeypatch, var):
    """Each of fulgor_tpu's tuning variables, set in the environment,
    reaches what it tunes in the port, with fulgor_tpu's defaults and
    precedence: the key cache's entry count wins over its bytes (the caps
    equal fulgor_tpu's engine's), an explicit dense_max_bytes= wins over
    FULGOR_DENSE_MAX_BYTES. FULGOR_DENSE_MAX_BYTES=0 through the port's
    CLI takes the no-dense path (the dense matrix forbidden): its TU(0.8)
    file holds the records of the run with the dense matrix allowed."""
    t = wide[1]

    def port(**kw):
        return E.QueryEngine(_fresh(t), batch_size=kw.pop("batch", BATCH),
                             device="cpu", **kw)

    if var == "FULGOR_MAX_LANES":
        assert port(batch=4096)._batch_for_width(160) == 4096
        monkeypatch.setenv(var, "123456")
        eng = port(batch=4096)
        assert eng.max_lanes == 123456
        assert eng._batch_for_width(160) == (123456 // 130) & ~255
    elif var == "FULGOR_REDO_FLUSH":
        monkeypatch.setenv(var, "77")
        assert port().redo_flush == 77
    elif var == "FULGOR_RUNS_MIN_WORDS":
        assert port().use_runs_fetch  # 143 words: past the default 64
        monkeypatch.setenv(var, "143")
        eng = port()
        assert eng.runs_min_words == 143 and not eng.use_runs_fetch
    elif var == "FULGOR_RUNS_FI_BUDGET":
        monkeypatch.setenv(var, "5")
        eng = port()
        assert eng.runs_fi_budget == 5 and eng._runs_R == 5
    elif var.startswith("FULGOR_FI_KEY_CACHE"):
        monkeypatch.setenv("FULGOR_FI_KEY_CACHE_BYTES", str(2000 * 143 * 8))
        if var == "FULGOR_FI_KEY_CACHE":
            monkeypatch.setenv(var, "9")
        jeng = JE.QueryEngine(_fresh(wide[0]), batch_size=BATCH,
                              use_mesh=False)
        cap = port()._fi_key_cache_cap
        assert cap == jeng._fi_key_cache_cap == (9 if var.endswith("CACHE")
                                                 else 2000)
    elif var == "FULGOR_ROW_MEMO_BYTES":
        for memo, rows in ((None, 30), (20 * 143 * 4, 15)):
            if memo:
                monkeypatch.setenv(var, str(memo))
            idx = _fresh(t)
            idx.color_rows(np.arange(15))
            idx.color_rows(np.arange(15, 30))  # past 20 rows: a reset
            assert idx._row_n == rows
    else:
        path = str(tmp_path / "wide.tfur")
        _fresh(t).save(path)
        monkeypatch.setenv(var, "0")
        assert port().use_tu_runs
        assert not port(dense_max_bytes=3 << 30).use_tu_runs
        outs = []
        for limit in (None, "0"):
            if limit is None:
                monkeypatch.delenv(var)
            else:
                monkeypatch.setenv(var, limit)
                for name in ("dense_color_bits", "device_dense"):
                    monkeypatch.setattr(TIndex, name, _no_dense)
            outs.append(str(tmp_path / f"tu_{limit}.tsv"))
            assert tcli.main(["pseudoalign", "-i", path, "-q", wide[2],
                              "-o", outs[-1], "-r", "0.8", "--device", "cpu",
                              "--batch-size", str(BATCH)]) == 0
        got, want = sorted_records(outs[1]), sorted_records(outs[0])
        assert got == want and len(got) == NUM_READS


@pytest.mark.parametrize("mode,tool", [("runs", "fi"), ("nodense", "tu0.8")])
@pytest.mark.parametrize("redo", ["device", "host"])
def test_forced_redo_writes_bit_rows(wide, tmp_path, monkeypatch, mode, tool,
                                     redo):
    """Forced probe overflow (budget (1, 1)) on sal4546.fi's path, the runs
    fetch, and on the no-dense TU: the overflowed reads take the (8, 4)
    device redo (with a (1, 1) redo budget, the host mirror too) and reach
    the ascii writer as bit rows. The file equals fulgor_tpu's byte for
    byte."""
    monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,1")
    jeng, teng = engines(wide, monkeypatch, 0 if mode == "nodense" else None)
    assert teng.use_runs_fetch and teng._pb == (1, 1)
    assert teng.use_tu_runs == (mode == "nodense")
    if redo == "host":
        monkeypatch.setattr(teng, "_pb_redo", (1, 1))
    kw = {} if tool == "fi" else {"threshold": float(tool[2:])}
    out_j, out_t = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    jeng.pseudoalign_file(wide[2], out_j, **kw)
    st = teng.pseudoalign_file(wide[2], out_t, **kw)
    with open(out_j, "rb") as fj, open(out_t, "rb") as ft:
        assert ft.read() == fj.read()
    assert st["num_redo"] > NUM_READS // 4
    assert st["redo_row_reads"] == st["num_redo"]
    assert (st["num_redo_host"] > 0) == (redo == "host")
