"""The port's slice end to end on the CPU (plain versions of the kernels):
index files carried across both ways, `cli pseudoalign` against
fulgor_tpu's output record for record in every format (long read, junk
read and forced probe overflow included), and the query step against
fulgor_tpu's. Records are compared after sorting by read id: both engines
write overflow and long-read stragglers after the in-order stream."""

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
from fulgor_tpu_torch.query.formatters import read_compressed_psa
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta

K_LEN, M_LEN = 15, 9
FORMATS = ["ascii", "binary", "compressed"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("torch_e2e")
    genomes = random_genomes(rng, num_colors=5, length=1500, mut=0.03, k=K_LEN)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa.gz")
        write_fasta(p, seqs, gz=True)
        paths.append(p)
    listfile = str(tmp / "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(paths) + "\n")
    base = ["build", "-l", listfile, "-k", str(K_LEN), "-m", str(M_LEN)]
    assert jcli.main(base + ["-o", str(tmp / "jidx")]) == 0
    assert tcli.main(base + ["-o", str(tmp / "tidx"), "--check"]) == 0
    # 200 reads with sequencing errors, a junk read, a read longer than the
    # stream ladder with a 220-character name, and reads of ragged lengths
    reads, names = [], []
    for i in range(200):
        s = genomes[rng.integers(0, len(genomes))][0]
        L = int(rng.integers(40, 90))
        p = rng.integers(0, len(s) - L)
        r = K.seq_to_codes(s[p: p + L]).copy()
        if i % 3 == 0:
            e = rng.integers(0, L)
            r[e] = (r[e] + 1) % 4
        reads.append(K.codes_to_seq(r))
        names.append(f"read{i} comment")
    reads.append(K.codes_to_seq(rng.integers(0, 4, size=70).astype(np.uint8)))
    names.append("junk")
    long_seq = genomes[0][0]
    while len(long_seq) <= E.MAX_STREAM_WIDTH:
        long_seq += genomes[1][0]
    reads.insert(57, long_seq)
    names.insert(57, "verylong_" + "n" * 220)
    qfile = str(tmp / "reads.fq.gz")
    with gzip.open(qfile, "wt") as f:
        for nm, r in zip(names, reads):
            f.write(f"@{nm}\n{r}\n+\n{'I' * len(r)}\n")
    refs = {}
    for fmt in FORMATS:
        out = str(tmp / f"ref.{fmt}")
        assert jcli.main(["pseudoalign", "-i", str(tmp / "jidx.tfur"), "-q",
                          qfile, "-o", out, "--format", fmt,
                          "--batch-size", "256"]) == 0
        refs[fmt] = _records(out, fmt)
    assert len(refs["ascii"]) == len(reads)
    return tmp, qfile, refs, len(reads)


def _records(path, fmt) -> dict:
    """qid -> tuple of colours, for any of the three output formats."""
    recs = {}
    if fmt == "ascii":
        for ln in open(path).read().splitlines():
            parts = ln.split("\t")
            assert int(parts[1]) == len(parts) - 2
            recs[int(parts[0])] = tuple(int(x) for x in parts[2:])
    elif fmt == "binary":
        buf = np.fromfile(path, dtype=np.uint32)
        pos = 0
        while pos < len(buf):
            qid, n = int(buf[pos]), int(buf[pos + 1])
            recs[qid] = tuple(buf[pos + 2: pos + 2 + n].tolist())
            pos += 2 + n
    else:
        _c, d = read_compressed_psa(path)
        recs = {int(q): tuple(v.tolist()) for q, v in d.items()}
    return recs


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_index_files_cross_load(corpus, direction):
    tmp = corpus[0]
    src, dst_cls, ref_cls = (("jidx", TIndex, JIndex)
                             if direction == "jax_to_torch"
                             else ("tidx", JIndex, TIndex))
    path = str(tmp / f"{src}.tfur")
    a, b = dst_cls.load(path), ref_cls.load(path)
    for f in ("k", "m", "num_kmers", "num_colors", "filenames", "dict_kind",
              "mini_num_slots", "num_color_sets"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("unitig_seq", "unitig_offs", "u2c_csid", "mini_slots", "mini_sec"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.dense_color_bits(), b.dense_color_bits())
    # both packages build the same index from the same inputs
    other = TIndex.load(str(tmp / ("tidx.tfur" if src == "jidx" else "jidx.tfur")))
    np.testing.assert_array_equal(other.mini_slots, a.mini_slots)


@pytest.mark.parametrize("fmt", FORMATS)
def test_pseudoalign_matches_reference(corpus, tmp_path, fmt):
    tmp, qfile, refs, n = corpus
    out = str(tmp_path / f"out.{fmt}")
    assert tcli.main(["pseudoalign", "-i", str(tmp / "tidx.tfur"), "-q", qfile,
                      "-o", out, "--format", fmt, "--batch-size", "256",
                      "--device", "cpu"]) == 0
    got = _records(out, fmt)
    assert len(got) == n
    assert got == refs[fmt]
    assert got[n - 1] == ()  # the junk read maps nowhere
    assert len(got[57]) > 0  # the long read maps through the host path


@pytest.mark.parametrize("redo", ["device", "host"])
def test_forced_overflow_takes_redo(corpus, tmp_path, monkeypatch, redo):
    """Probe budget (1, 1) overflows many reads; they take the deferred
    device redo at (8, 4), and with a (1, 1) redo budget the lanes still in
    overflow take the exact host mirror. The output is unchanged."""
    tmp, qfile, refs, n = corpus
    monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,1")
    calls = {"device": 0, "host": 0}
    dev_dispatch = E.QueryEngine._device_csids_dispatch
    host_many = E.QueryEngine._host_csids_many

    def count_dev(self, rows):
        calls["device"] += 1
        return dev_dispatch(self, rows)

    def count_host(self, rows):
        calls["host"] += len(rows)
        return host_many(self, rows)

    monkeypatch.setattr(E.QueryEngine, "_device_csids_dispatch", count_dev)
    monkeypatch.setattr(E.QueryEngine, "_host_csids_many", count_host)
    eng = E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), batch_size=256,
                        device="cpu")
    assert eng._pb == (1, 1) and eng._pb_redo == E.REDO_BUDGET
    if redo == "host":
        monkeypatch.setattr(eng, "_pb_redo", (1, 1))
    out = str(tmp_path / "out.tsv")
    stats = eng.pseudoalign_file(qfile, out)
    assert _records(out, "ascii") == refs["ascii"]
    assert stats["num_redo"] > 4 and calls["device"] >= 1
    # the long read always ends on the host; a (1, 1) redo leaves more
    assert calls["host"] > (1 if redo == "host" else 0)


def test_selfcheck_compares_with_host_mirror(corpus, tmp_path, monkeypatch):
    """FULGOR_SELFCHECK=N recomputes every N-th read through the exact host
    mirror: a right result passes, a wrong one raises."""
    tmp, qfile, refs, _n = corpus
    monkeypatch.setenv("FULGOR_SELFCHECK", "3")
    idx = TIndex.load(str(tmp / "tidx.tfur"))
    eng = E.QueryEngine(idx, batch_size=256, device="cpu")
    out = str(tmp_path / "out.tsv")
    eng.pseudoalign_file(qfile, out)
    assert _records(out, "ascii") == refs["ascii"]
    wrong = np.arange(idx.num_colors + 1, dtype=np.uint32)
    monkeypatch.setattr(eng, "_host_full_intersection", lambda codes: wrong)
    with pytest.raises(RuntimeError, match="FULGOR_SELFCHECK"):
        eng.pseudoalign_file(qfile, out)


def test_query_step_matches_reference(corpus):
    """query_full_intersection_packed: the port's step against fulgor_tpu's
    jitted step on one packed batch, bits and ovf bit-exact."""
    tmp = corpus[0]
    idx = TIndex.load(str(tmp / "tidx.tfur"))
    table_np, dparams = idx.device_dict()
    rng = np.random.default_rng(2)
    chunk = rng.integers(0, 4, size=(64, 96)).astype(np.uint8)
    codes_all = K.unpack2(idx.unitig_seq, int(idx.unitig_offs[-1]))
    for b in range(48):  # most reads from the indexed text
        p = rng.integers(0, len(codes_all) - 96)
        chunk[b] = codes_all[p: p + 96]
    chunk[5, 70:] = 4
    codes2, bad = pack_reads_host(chunk)
    for pb in ((2, 2), (1, 1)):
        want = JP.query_full_intersection_packed(
            tuple(jnp.asarray(a) for a in table_np),
            jnp.asarray(idx.dense_color_bits()), jnp.asarray(codes2),
            jnp.asarray(bad), k=idx.k, width=96, dparams=dparams,
            probe_budget=pb)
        tabs = idx.device_tables("cpu")
        got = TP.query_full_intersection_packed(
            (tabs["slots"], tabs["text32"], tabs["skew"]), tabs["dense"],
            torch.from_numpy(codes2), torch.from_numpy(bad), k=idx.k,
            width=96, dparams=dparams, probe_budget=pb)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
