"""Threshold union and kmer-matches end to end on the CPU (plain versions
of the kernels), against fulgor_tpu on test_torch_engine's corpus:

- the steps query_tu_bits_packed and query_kmer_matches_packed2 against
  fulgor_tpu's query_tu_lists_packed (maskbits, ovf) and
  query_kmer_matches_packed2, bit-exact;
- `cli pseudoalign -r` record for record in every format (long read, junk
  read, forced probe overflow and FULGOR_SELFCHECK included); -r 1.0 also
  equals the port's full intersection;
- `cli kmer-matches` byte for byte, with a junk read, a read shorter than
  k and a long read. One read of 1,030 bases (over the 1,024-base stream
  ladder but, at k = 15, within the 32 windows fulgor_tpu fetches anyway)
  is checked against the exact host mirror instead: fulgor_tpu writes its
  last windows as negative (engine.py:1767-1769), the port redoes it.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu import cli as jcli
from fulgor_tpu.core import kmers as K
from fulgor_tpu.index import Index as JIndex
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu_torch import cli as tcli
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import pipeline as TP
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.query import engine as E
from tests.test_torch_engine import (  # noqa: F401
    FORMATS, _records, check_redo_sink, corpus, redo_cases, watch_redo_sink)
from tests.test_torch_threads import one_thread  # noqa: F401

TU_CASES = [(0.8, f) for f in FORMATS] + [(0.5, "ascii"), (1.0, "ascii")]
LEN_FAULT = 1030
KM_SHORT = "ACGTACGTAC"  # shorter than k = 15


@pytest.fixture(scope="module")
def refs(corpus):  # noqa: F811
    """fulgor_tpu's outputs: pseudoalign -r for every TU case, and
    kmer-matches over the corpus reads plus a short read and the
    1,030-base read."""
    tmp, qfile, _refs, _n = corpus
    jidx = str(tmp / "jidx.tfur")
    tu = {}
    for tau, fmt in TU_CASES:
        out = str(tmp / f"ref_tu{tau}.{fmt}")
        assert jcli.main(["pseudoalign", "-i", jidx, "-q", qfile, "-o", out,
                          "-r", str(tau), "--format", fmt,
                          "--batch-size", "256"]) == 0
        tu[tau, fmt] = _records(out, fmt)
    with gzip.open(qfile, "rt") as f:
        lines = f.read().splitlines()
    seqs = dict(zip(lines[0::4], lines[1::4]))
    long_seq = next(s for s in seqs.values() if len(s) > E.MAX_STREAM_WIDTH)
    km_reads = str(tmp / "km_reads.fq")
    with open(km_reads, "w") as f:
        f.write("\n".join(lines) + "\n")
        for nm, s in (("short", KM_SHORT), ("len1030", long_seq[:LEN_FAULT])):
            f.write(f"@{nm}\n{s}\n+\n{'I' * len(s)}\n")
    km_out = str(tmp / "ref.km")
    assert jcli.main(["kmer-matches", "-i", jidx, "-q", km_reads, "-o", km_out,
                      "--batch-size", "256"]) == 0
    with open(km_out, "rb") as f:
        km = f.read().splitlines()
    return tu, km_reads, km, long_seq[:LEN_FAULT]


def _run_tu(tmp, qfile, out, tau, fmt="ascii"):
    argv = ["pseudoalign", "-i", str(tmp / "tidx.tfur"), "-q", qfile, "-o",
            out, "--format", fmt, "--batch-size", "256", "--device", "cpu"]
    assert tcli.main(argv + ([] if tau is None else ["-r", str(tau)])) == 0
    return _records(out, fmt)


@pytest.mark.parametrize("tau,fmt", TU_CASES)
def test_threshold_union_matches_reference(corpus, refs, tmp_path, tau, fmt):
    tmp, qfile, _refs, n = corpus
    got = _run_tu(tmp, qfile, str(tmp_path / f"out.{fmt}"), tau, fmt)
    assert len(got) == n
    assert got == refs[0][tau, fmt]
    assert got[n - 1] == () and len(got[57]) > 0  # junk read; long read
    if tau == 1.0:  # TU at 1.0 is the full intersection
        assert got == _run_tu(tmp, qfile, str(tmp_path / "fi.tsv"), None)


def test_threshold_must_be_in_range(corpus):
    tmp, qfile, _refs, _n = corpus
    with pytest.raises(SystemExit):
        tcli.main(["pseudoalign", "-i", str(tmp / "tidx.tfur"), "-q", qfile,
                   "-o", "unused", "-r", "0", "--device", "cpu"])


@pytest.mark.parametrize("redo,fmt", redo_cases())
def test_tu_forced_overflow_takes_redo(corpus, refs, tmp_path, monkeypatch,
                                       redo, fmt):
    """Probe budget (1, 1) under -r 0.8: overflow reads re-probe at (8, 4)
    and take K4 (its plain version here) on the re-probe's outputs; with a
    (1, 1) redo budget the reads still in overflow take the host mirror.
    The output is unchanged in every format; an ascii writer takes the
    redo's bit rows."""
    tmp, qfile, _refs, _n = corpus
    monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,1")
    calls = {"device": 0, "host": 0}
    dev_dispatch = E.QueryEngine._device_tu_dispatch
    host_tu = E.QueryEngine._tu_from_csids

    def count_dev(self, rows, threshold):
        calls["device"] += 1
        return dev_dispatch(self, rows, threshold)

    def count_host(self, csids, threshold):
        calls["host"] += 1
        return host_tu(self, csids, threshold)

    monkeypatch.setattr(E.QueryEngine, "_device_tu_dispatch", count_dev)
    monkeypatch.setattr(E.QueryEngine, "_tu_from_csids", count_host)
    eng = E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), batch_size=256,
                        device="cpu")
    if redo == "host":
        monkeypatch.setattr(eng, "_pb_redo", (1, 1))
    seen, lists_calls = watch_redo_sink(monkeypatch)
    out = str(tmp_path / f"out.{fmt}")
    stats = eng.pseudoalign_file(qfile, out, threshold=0.8, fmt=fmt)
    assert _records(out, fmt) == refs[0][0.8, fmt]
    assert calls["device"] >= 1 and calls["host"] == stats["num_redo_host"]
    if redo == "device":  # only the long read needs the host
        assert stats["num_redo"] > 4 and stats["num_redo_host"] == 1
    else:
        assert stats["num_redo_host"] > 1
    check_redo_sink(stats, fmt, seen, lists_calls)


def test_selfcheck_under_threshold(corpus, refs, tmp_path, monkeypatch):
    tmp, qfile, _refs, _n = corpus
    monkeypatch.setenv("FULGOR_SELFCHECK", "3")
    idx = TIndex.load(str(tmp / "tidx.tfur"))
    eng = E.QueryEngine(idx, batch_size=256, device="cpu")
    out = str(tmp_path / "out.tsv")
    eng.pseudoalign_file(qfile, out, threshold=0.8)
    assert _records(out, "ascii") == refs[0][0.8, "ascii"]
    wrong = np.arange(idx.num_colors + 1, dtype=np.uint32)
    monkeypatch.setattr(eng, "_host_mirror_many",
                        lambda rows, tau: [wrong] * len(rows))
    with pytest.raises(RuntimeError, match="FULGOR_SELFCHECK"):
        eng.pseudoalign_file(qfile, out, threshold=0.8)


def _exact_km_line(tmp, name, seq) -> bytes:
    """The kmer-matches line of one read from fulgor_tpu's exact host
    probe and its decoded colour sets."""
    idx = JIndex.load(str(tmp / "jidx.tfur"))
    hit, csid = idx.host_window_csids(K.seq_to_codes(seq))
    cat, offs = idx.color_sets_decoded()
    counts = np.zeros(idx.num_colors, dtype=np.int64)
    for sid in csid[hit]:
        counts[cat[offs[sid]: offs[sid + 1]]] += 1
    fields = [name, str(len(hit))] + [str(int(h)) for h in hit]
    return "\t".join(fields + [str(c) for c in counts]).encode()


@pytest.mark.parametrize("budget", [None, "device", "host"])
def test_kmer_matches_matches_reference(corpus, refs, tmp_path, monkeypatch,
                                        budget):
    """Byte for byte against fulgor_tpu, but for the 1,030-base read, which
    equals the exact host mirror where fulgor_tpu's line does not. budget:
    the engine's probe budget, or (1, 1) with the redo on the card at
    (8, 4) ("device"), or at (1, 1), leaving reads to the host ("host")."""
    tmp, _qfile, _refs, _n = corpus
    _tu, km_reads, want, seq = refs
    if budget is not None:
        monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,1")
    eng = E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), batch_size=256,
                        device="cpu")
    if budget == "host":
        monkeypatch.setattr(eng, "_pb_redo", (1, 1))
    out = str(tmp_path / "out.km")
    stats = eng.kmer_matches_file(km_reads, out)
    with open(out, "rb") as f:
        got = f.read().splitlines()
    assert len(got) == len(want) == stats["num_reads"] + 1
    assert got[:-1] == want[:-1]
    assert got[-2].startswith(b"short\t0\t") and got[-2].count(b"\t1") == 0
    exact = _exact_km_line(tmp, "len1030", seq)
    assert got[-1] == exact and want[-1] != exact
    if budget is None:  # the two reads over the ladder
        assert stats["num_redo"] == stats["num_redo_host"] == 2
    elif budget == "device":
        assert stats["num_redo"] > 4 and stats["num_redo_host"] == 2
    else:
        assert stats["num_redo_host"] > 2


def test_kmer_matches_cli(corpus, refs, tmp_path):
    tmp, _qfile, _refs, _n = corpus
    _tu, km_reads, want, _seq = refs
    out = str(tmp_path / "out.km")
    assert tcli.main(["kmer-matches", "-i", str(tmp / "tidx.tfur"), "-q",
                      km_reads, "-o", out, "--batch-size", "256",
                      "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        got = f.read().splitlines()
    assert got[0] == b"num_colors=5" and got[:-1] == want[:-1]


def _step_inputs(tmp):
    idx = TIndex.load(str(tmp / "tidx.tfur"))
    table_np, dparams = idx.device_dict()
    rng = np.random.default_rng(3)
    chunk = rng.integers(0, 4, size=(64, 96)).astype(np.uint8)
    codes_all = K.unpack2(idx.unitig_seq, int(idx.unitig_offs[-1]))
    for b in range(48):  # most reads from the indexed text
        p = rng.integers(0, len(codes_all) - 96)
        chunk[b] = codes_all[p: p + 96]
    chunk[5, 70:] = 4
    chunk[6, 20:] = 4  # fewer bases than k + 1
    codes2, bad = pack_reads_host(chunk)
    tabs = idx.device_tables("cpu")
    jargs = (tuple(jnp.asarray(a) for a in table_np),
             jnp.asarray(idx.dense_color_bits()), jnp.asarray(codes2),
             jnp.asarray(bad))
    targs = ((tabs["slots"], tabs["text32"], tabs["skew"]),
             idx.device_dense("cpu"),
             torch.from_numpy(codes2), torch.from_numpy(bad))
    return idx, dparams, jargs, targs


@pytest.mark.parametrize("tau", [0.01, 0.8, 1.0])
def test_tu_step_matches_reference(corpus, tau):
    """query_tu_bits_packed against fulgor_tpu's query_tu_lists_packed
    (its maskbits and ovf) at the engine's and a (1, 1) probe budget."""
    idx, dparams, jargs, targs = _step_inputs(corpus[0])
    Wk = 96 - idx.k + 1
    tab = (np.arange(Wk + 1, dtype=np.float64) * tau).astype(np.int32)
    for pb in ((2, 2), (1, 1)):
        want = JP.query_tu_lists_packed(
            *jargs, jnp.asarray(tab), k=idx.k, width=96,
            num_colors=idx.num_colors, T=8, dparams=dparams, probe_budget=pb)
        got = TP.query_tu_bits_packed(
            *targs, torch.from_numpy(tab), k=idx.k, width=96,
            num_colors=idx.num_colors, dparams=dparams, probe_budget=pb)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                      np.asarray(want[2]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[3]))
        assert got[0].any()


def test_kmer_matches_step_matches_reference(corpus):
    idx, dparams, jargs, targs = _step_inputs(corpus[0])
    for pb in ((2, 2), (1, 1)):
        want = JP.query_kmer_matches_packed2(
            *jargs, k=idx.k, width=96, num_colors=idx.num_colors,
            dparams=dparams, probe_budget=pb)
        got = TP.query_kmer_matches_packed2(
            *targs, k=idx.k, width=96, num_colors=idx.num_colors,
            dparams=dparams, probe_budget=pb)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy().view(np.uint16),
                                      np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[1].numpy().max() > 0
