"""kmer-conservation and --deduplicate end to end on the CPU (plain versions
of the kernels), against fulgor_tpu on test_torch_engine's corpus:

- the steps query_conservation_runs_packed, query_distinct_runs_packed and
  query_runs_tu_packed against fulgor_tpu's, bit-exact, at the engine's run
  and probe budgets, and at a run budget of 2 with probe budget (1, 1);
- `cli kmer-conservation` byte for byte (a junk read, a read shorter than
  k, a read over 1,024 bases with a 220-character name), also with the run
  budget forced to 2 and under FULGOR_PROBE_BUDGET=1,1, where reads take
  the redo on the card and, at a (1, 1) redo budget, the host mirror;
- `cli pseudoalign --deduplicate` in ascii and binary byte for byte, and
  record for record equal to the port's full intersection, also with the
  run budget forced to 2 and under FULGOR_PROBE_BUDGET=1,1; with -r it is
  refused.
"""

import gzip

import numpy as np
import pytest

from fulgor_tpu import cli as jcli
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu_torch import cli as tcli
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import pipeline as TP
from fulgor_tpu_torch.query import engine as E
from tests.test_torch_engine import _records, corpus  # noqa: F401
from tests.test_torch_union_engine import _step_inputs
from tests.test_torch_threads import one_thread  # noqa: F401

SHORT = "ACGTACGTAC"  # shorter than k = 15
DEDUP_FORMATS = ["ascii", "binary"]
MODES = [None, "runs2", "probe11"]


@pytest.fixture(scope="module")
def refs(corpus):  # noqa: F811
    """fulgor_tpu's kmer-conservation over the corpus reads plus a short
    read, its --deduplicate output in ascii and binary, and the port's own
    full-intersection records."""
    tmp, qfile, _refs, _n = corpus
    jidx = str(tmp / "jidx.tfur")
    with gzip.open(qfile, "rt") as f:
        lines = f.read().splitlines()
    kc_reads = str(tmp / "kc_reads.fq")
    with open(kc_reads, "w") as f:
        f.write("\n".join(lines[:4 * 120]) + "\n")
        f.write(f"@short\n{SHORT}\n+\n{'I' * len(SHORT)}\n")
        f.write("\n".join(lines[4 * 120:]) + "\n")
    kc_out = str(tmp / "ref.kc")
    assert jcli.main(["kmer-conservation", "-i", jidx, "-q", kc_reads, "-o",
                      kc_out, "--batch-size", "256"]) == 0
    dedup = {}
    for fmt in DEDUP_FORMATS:
        out = str(tmp / f"ref_dedup.{fmt}")
        assert jcli.main(["pseudoalign", "-i", jidx, "-q", qfile, "-o", out,
                          "--deduplicate", "--format", fmt,
                          "--batch-size", "256"]) == 0
        dedup[fmt] = open(out, "rb").read()
    fi_out = str(tmp / "port_fi.tsv")
    assert tcli.main(["pseudoalign", "-i", str(tmp / "tidx.tfur"), "-q", qfile,
                      "-o", fi_out, "--batch-size", "256",
                      "--device", "cpu"]) == 0
    return kc_reads, open(kc_out, "rb").read(), dedup, _records(fi_out, "ascii")


def _engine(tmp, monkeypatch, mode):
    """The port's engine on the CPU, with the run budget forced to 2
    ("runs2") or the probe budget to (1, 1) ("probe11")."""
    if mode == "runs2":
        monkeypatch.setattr(E, "_runs_budget", lambda W, ekpu=64.0, k=31: 2)
    elif mode == "probe11":
        monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,1")
    return E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), batch_size=256,
                         device="cpu")


@pytest.mark.parametrize("step", ["conservation", "distinct", "runs_tu"])
def test_runs_steps_match_reference(corpus, step):
    idx, dparams, jargs, targs = _step_inputs(corpus[0])
    jfn, tfn = {"conservation": (JP.query_conservation_runs_packed,
                                 TP.query_conservation_runs_packed),
                "distinct": (JP.query_distinct_runs_packed,
                             TP.query_distinct_runs_packed),
                "runs_tu": (JP.query_runs_tu_packed,
                            TP.query_runs_tu_packed)}[step]
    budget = E._runs_budget(96, idx.expected_kmers_per_unitig(), idx.k)
    for pb, R in (((2, 2), budget), ((1, 1), 2)):
        want = jfn(jargs[0], jargs[2], jargs[3], k=idx.k, width=96, R=R,
                   dparams=dparams, probe_budget=pb)
        got = tfn(targs[0], targs[2], targs[3], k=idx.k, width=96, R=R,
                  dparams=dparams, probe_budget=pb)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            # u32 and u16 outputs are carried as int32 and int16
            np.testing.assert_array_equal(g.view(w.dtype), w)
        assert got[0].shape == (64, R) and (got[0] != -1).any()
    # at R = 2, reads past the run budget
    assert got[2 if step == "distinct" else -1].any()


def test_kmer_conservation_cli(corpus, refs, tmp_path):
    tmp = corpus[0]
    kc_reads, want, _dedup, _fi = refs
    out = str(tmp_path / "out.kc")
    assert tcli.main(["kmer-conservation", "-i", str(tmp / "tidx.tfur"), "-q",
                      kc_reads, "-o", out, "--batch-size", "256",
                      "--device", "cpu"]) == 0
    got = open(out, "rb").read()
    assert got == want
    lines = got.splitlines()
    assert lines[120] == b"short\t0" and lines[-1] == b"junk\t0"
    assert lines[57].startswith(b"verylong_" + b"n" * 220 + b"\t")


@pytest.mark.parametrize("mode", ["runs2", "probe11", "probe11_host"])
def test_kmer_conservation_forced_redo(corpus, refs, tmp_path, monkeypatch,
                                       mode):
    """Run budget 2, or probe budget (1, 1): the overflowed reads re-probe
    on the card with K6 at one run a window and the output is unchanged;
    with a (1, 1) redo budget reads still in overflow take the host
    mirror."""
    tmp = corpus[0]
    kc_reads, want, _dedup, _fi = refs
    eng = _engine(tmp, monkeypatch, mode.replace("_host", ""))
    if mode == "probe11_host":
        monkeypatch.setattr(eng, "_pb_redo", (1, 1))
    out = str(tmp_path / "out.kc")
    stats = eng.kmer_conservation_file(kc_reads, out)
    assert open(out, "rb").read() == want
    assert stats["num_redo"] > 4 and stats["num_reads"] == 203
    # the long read always ends on the host
    if mode == "probe11_host":
        assert stats["num_redo_host"] > 1
    else:
        assert stats["num_redo_host"] == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", DEDUP_FORMATS)
def test_dedup_matches_reference(corpus, refs, tmp_path, monkeypatch, fmt,
                                 mode):
    tmp, qfile, _refs, n = corpus
    _kc_reads, _kc, dedup, fi = refs
    eng = _engine(tmp, monkeypatch, mode)
    out = str(tmp_path / f"out.{fmt}")
    stats = eng.pseudoalign_file(qfile, out, fmt=fmt, deduplicate=True)
    assert open(out, "rb").read() == dedup[fmt]
    got = _records(out, fmt)
    assert list(got) == list(range(n)) and got == fi
    assert stats["num_reads"] == n and stats["num_keys"] < n
    if mode == "runs2":
        assert stats["num_run_ovf"] > 4
    elif mode == "probe11":
        assert stats["num_redo"] > 4
    assert stats["num_redo_host"] == 1  # the long read


def test_dedup_refuses_threshold(corpus, tmp_path, capsys):
    tmp, qfile, _refs, _n = corpus
    argv = ["pseudoalign", "-i", str(tmp / "tidx.tfur"), "-q", qfile, "-o",
            str(tmp_path / "out.tsv"), "--device", "cpu"]
    assert tcli.main(argv + ["-r", "0.8", "--deduplicate"]) == 1
    assert "Deduplication not available" in capsys.readouterr().out
    eng = E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), device="cpu")
    with pytest.raises(ValueError, match="full intersection only"):
        eng.pseudoalign_file(qfile, str(tmp_path / "out.tsv"), threshold=0.8,
                             deduplicate=True)
