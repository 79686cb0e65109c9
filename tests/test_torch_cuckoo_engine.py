"""A `--dict cuckoo` index end to end on the CPU (plain versions of the
kernels, K7's included), against fulgor_tpu:

- the packed steps (window csids, FI, TU mask, kmer-matches,
  kmer-conservation runs, distinct runs) against fulgor_tpu's on the same
  cuckoo index, bit-exact;
- `cli build --dict cuckoo --check`, then all five tools (pseudoalign FI,
  -r 0.8 and --deduplicate, kmer-conservation, kmer-matches) against
  fulgor_tpu's files (pseudoalign compared record for record by read id,
  kmer-conservation and kmer-matches byte for byte) and against the port's
  own files on a mini index of the same genomes;
- a read over 1,024 bases (and a junk read, and a read shorter than k):
  the cuckoo table never overflows, so it is the only read redone.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu import cli as jcli
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu_torch import cli as tcli
from fulgor_tpu_torch.core import kmers as K
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import pipeline as TP
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.query import engine as E
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_engine import _records
from tests.test_torch_threads import one_thread  # noqa: F401

K_LEN, M_LEN = 15, 9
TOOLS = {"fi": ["pseudoalign"], "tu": ["pseudoalign", "-r", "0.8"],
         "dedup": ["pseudoalign", "--deduplicate"],
         "kc": ["kmer-conservation"], "km": ["kmer-matches"]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five genomes of 1,500 bp; fulgor_tpu's cuckoo index and the port's
    cuckoo and mini indexes of them; 150 reads with errors, a read of
    1,500 bases, a junk read and a read shorter than k; fulgor_tpu's output
    of every tool."""
    rng = np.random.default_rng(19)
    tmp = tmp_path_factory.mktemp("torch_cuckoo")
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
    assert jcli.main(base + ["-o", str(tmp / "jc"), "--dict", "cuckoo"]) == 0
    assert tcli.main(base + ["-o", str(tmp / "tc"), "--dict", "cuckoo",
                             "--check"]) == 0
    assert tcli.main(base + ["-o", str(tmp / "tm")]) == 0
    reads, names = [], []
    for i in range(150):
        s = genomes[rng.integers(0, len(genomes))][0]
        L = int(rng.integers(40, 90))
        p = rng.integers(0, len(s) - L)
        r = K.seq_to_codes(s[p: p + L]).copy()
        if i % 3 == 0:
            r[rng.integers(0, L)] = rng.integers(0, 5)
        reads.append(K.codes_to_seq(r))
        names.append(f"read{i}")
    reads.insert(40, genomes[2][0][:1500])
    names.insert(40, "long")
    reads.insert(80, "ACGTACGTAC")
    names.insert(80, "short")
    reads.append(K.codes_to_seq(rng.integers(0, 4, size=70).astype(np.uint8)))
    names.append("junk")
    qfile = str(tmp / "reads.fq.gz")
    with gzip.open(qfile, "wt") as f:
        for nm, r in zip(names, reads):
            f.write(f"@{nm}\n{r}\n+\n{'I' * len(r)}\n")
    refs = {}
    for tool, args in TOOLS.items():
        out = str(tmp / f"ref.{tool}")
        assert jcli.main(args + ["-i", str(tmp / "jc.tfur"), "-q", qfile,
                                 "-o", out, "--batch-size", "256"]) == 0
        refs[tool] = out
    return tmp, qfile, refs, len(reads)


def _output(path, tool):
    """pseudoalign: qid -> colours; kmer-conservation and -matches: bytes."""
    if tool in ("fi", "tu", "dedup"):
        return _records(path, "ascii")
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tools_match_reference(corpus, tmp_path, tool):
    tmp, qfile, refs, n = corpus
    outs = {}
    for kind in ("tc", "tm"):
        out = str(tmp_path / f"{kind}.{tool}")
        assert tcli.main(TOOLS[tool] + [
            "-i", str(tmp / f"{kind}.tfur"), "-q", qfile, "-o", out,
            "--batch-size", "256", "--device", "cpu"]) == 0
        outs[kind] = _output(out, tool)
    want = _output(refs[tool], tool)
    assert outs["tc"] == want  # the cuckoo index, against fulgor_tpu
    assert outs["tm"] == want  # the mini index of the same genomes
    if tool in ("fi", "tu", "dedup"):
        assert len(want) == n and want[n - 1] == () and want[80] == ()
        assert len(want[40]) > 0  # the long read maps
    else:
        assert len(want.splitlines()) == n + (tool == "km")


def test_only_the_long_read_is_redone(corpus, tmp_path):
    """The cuckoo table never overflows: FI, TU and kmer-matches redo the
    one read over 1,024 bases, on the host, and nothing else."""
    tmp, qfile, _refs, _n = corpus
    eng = E.QueryEngine(TIndex.load(str(tmp / "tc.tfur")), batch_size=256,
                        device="cpu")
    assert eng.dparams is None and eng._pb is None
    assert isinstance(eng.table, torch.Tensor) and eng.table.shape[1] == 4
    for st in (eng.pseudoalign_file(qfile, str(tmp_path / "fi.tsv")),
               eng.pseudoalign_file(qfile, str(tmp_path / "tu.tsv"),
                                    threshold=0.8),
               eng.kmer_matches_file(qfile, str(tmp_path / "km.tsv")),
               eng.kmer_conservation_file(qfile, str(tmp_path / "kc.tsv"))):
        assert st["redo_ids"] == [40] and st["num_redo_host"] == 1


@pytest.mark.parametrize("step", ["csids", "fi", "tu", "km", "kc",
                                  "distinct"])
def test_cuckoo_steps_match_reference(corpus, step):
    """The port's packed steps against fulgor_tpu's on one packed batch of
    the cuckoo index (dparams None), every output bit-exact."""
    tmp = corpus[0]
    idx = TIndex.load(str(tmp / "tc.tfur"))
    rng = np.random.default_rng(5)
    W = 96
    chunk = rng.integers(0, 4, size=(64, W)).astype(np.uint8)
    codes_all = K.unpack2(idx.unitig_seq, int(idx.unitig_offs[-1]))
    for b in range(48):
        p = rng.integers(0, len(codes_all) - W)
        chunk[b] = codes_all[p: p + W]
    chunk[5, 70:] = 4
    chunk[6, 20:] = 4
    chunk[7, 30] = 4
    codes2, bad = pack_reads_host(chunk)
    tabs = idx.device_tables("cpu")
    jt, jd = jnp.asarray(idx.dict_table), jnp.asarray(idx.dense_color_bits())
    jc, jb = jnp.asarray(codes2), jnp.asarray(bad)
    tt, td = tabs["table"], idx.device_dense("cpu")
    tc, tb = torch.from_numpy(codes2), torch.from_numpy(bad)
    kw = dict(k=idx.k, width=W, dparams=None)
    C, Wk = idx.num_colors, W - idx.k + 1
    R = E._runs_budget(W, idx.expected_kmers_per_unitig(), idx.k)
    if step == "csids":
        want = JP.query_window_csids_packed(jt, jc, jb, **kw)
        got = TP.query_window_csids_packed(tt, tc, tb, **kw)
    elif step == "fi":
        want = JP.query_full_intersection_packed(jt, jd, jc, jb, **kw)
        got = TP.query_full_intersection_packed(tt, td, tc, tb, **kw)
    elif step == "tu":
        tab = (np.arange(Wk + 1, dtype=np.float64) * 0.8).astype(np.int32)
        want = JP.query_tu_lists_packed(jt, jd, jc, jb, jnp.asarray(tab),
                                        num_colors=C, T=8, **kw)[2:]
        got = TP.query_tu_bits_packed(tt, td, tc, tb, torch.from_numpy(tab),
                                      num_colors=C, **kw)
    elif step == "km":
        want = JP.query_kmer_matches_packed2(jt, jd, jc, jb, num_colors=C,
                                             **kw)
        got = TP.query_kmer_matches_packed2(tt, td, tc, tb, num_colors=C,
                                            **kw)
    elif step == "kc":
        want = JP.query_conservation_runs_packed(jt, jc, jb, R=R, **kw)
        got = TP.query_conservation_runs_packed(tt, tc, tb, R=R, **kw)
    else:
        want = JP.query_distinct_runs_packed(jt, jc, jb, R=R, **kw)
        got = TP.query_distinct_runs_packed(tt, tc, tb, R=R, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        # u32 and u16 outputs are carried as int32 and int16
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    if step == "csids":
        assert got[0][:48].any() and not got[2].any()
