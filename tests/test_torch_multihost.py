"""Pseudoalign over several processes with the port (parallel/multihost.py),
on the CPU: the counterparts of tests/test_multihost.py.

The sharding is host logic that does not depend on the process count, so
shard passes run in ONE process must merge to the single-process output,
as a real run's processes (each one of those passes) do. The fixture
forces the probe's overflow (FULGOR_PROBE_BUDGET=1,1) and a redo flush
every two reads (FULGOR_REDO_FLUSH=2), so that every shard writes many
redo pools, several of them pending at the final flush, into its `.redo`
side fragment. A real two-process run goes through the port's CLI on a
gloo process group.
"""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from fulgor_tpu.parallel import multihost as JMH
from fulgor_tpu_torch import cli as tcli
from fulgor_tpu_torch.core import kmers as K
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.parallel import multihost as MH
from fulgor_tpu_torch.query import engine as E
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_engine import _records
from tests.test_torch_threads import one_thread  # noqa: F401

K_LEN, P = 15, 3
FORMATS = ["ascii", "binary", "compressed"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's index of six genomes of 1,600 bp; 300 reads of 70 bp (five
    chunks at batch size 64), a junk read and a read of 1,400 bases; the
    single-process output in each format."""
    rng = np.random.default_rng(23)
    tmp = tmp_path_factory.mktemp("torch_mh")
    genomes = random_genomes(rng, num_colors=6, length=1600, mut=0.03,
                             k=K_LEN)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa.gz")
        write_fasta(p, seqs, gz=True)
        paths.append(p)
    listfile = str(tmp / "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(paths) + "\n")
    out_base = str(tmp / "idx")
    assert tcli.main(["build", "-l", listfile, "-o", out_base, "-k",
                      str(K_LEN), "-m", "9"]) == 0
    reads = []
    for _ in range(300):
        s = genomes[rng.integers(0, len(genomes))][0]
        p = rng.integers(0, len(s) - 70)
        reads.append(s[p: p + 70])
    reads.append(K.codes_to_seq(rng.integers(0, 4, size=70).astype(np.uint8)))
    reads.append((genomes[0][0] * 2)[:1400])
    qfile = str(tmp / "reads.fq.gz")
    with gzip.open(qfile, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i}\n{r}\n+\n{'I' * len(r)}\n")
    mp = pytest.MonkeyPatch()
    mp.setenv("FULGOR_PROBE_BUDGET", "1,1")
    mp.setenv("FULGOR_REDO_FLUSH", "2")
    try:
        eng = E.QueryEngine(TIndex.load(out_base + ".tfur"), batch_size=64,
                            device="cpu")
    finally:
        mp.undo()
    assert eng._pb == (1, 1) and eng.redo_flush == 2
    single, shards = {}, {}
    for fmt in FORMATS:
        single[fmt] = str(tmp / f"single.{fmt}")
        st = eng.pseudoalign_file(qfile, single[fmt], fmt=fmt)
        assert st["num_reads"] == st["num_reads_total"] == len(reads)
        assert st["num_redo"] > 20  # many pools of two reads
    return dict(tmp=tmp, index=out_base + ".tfur", qfile=qfile,
                n=len(reads), eng=eng, single=single, shards=shards)


def _shard_passes(built, fmt):
    """The P shard passes of one format, in this process (cached). ->
    (main fragment paths, their stats)."""
    if fmt not in built["shards"]:
        parts, stats = [], []
        for p in range(P):
            part = str(built["tmp"] / f"out.{fmt}.part{p}")
            stats.append(built["eng"].pseudoalign_file(
                built["qfile"], part, fmt=fmt, shard=(p, P)))
            parts.append(part)
        built["shards"][fmt] = (parts, stats)
    return built["shards"][fmt]


def _ids(path, fmt):
    """The read ids of a psa file, in file order."""
    if fmt == "ascii":
        return [q for q, _ in MH._iter_ascii_records(path)]
    if fmt == "binary":
        return [q for q, _ in MH._iter_binary_records(path)]
    from fulgor_tpu_torch.query.formatters import iter_compressed_psa

    return [q for q, _ in iter_compressed_psa(path)]


@pytest.mark.parametrize("fmt", FORMATS)
def test_shard_passes_merge_to_single_process_output(built, tmp_path, fmt):
    parts, stats = _shard_passes(built, fmt)
    n = built["n"]
    assert all(st["num_reads_total"] == n for st in stats)
    assert sum(st["num_reads"] for st in stats) == n  # shards partition
    owned = []
    for part, st in zip(parts, stats):
        # each fragment and its side fragment are id-ascending; the redone
        # reads are in the side fragment only
        main, redo = _ids(part, fmt), _ids(part + ".redo", fmt)
        assert main == sorted(main) and redo == sorted(redo)
        assert sorted(redo) == sorted(st["redo_ids"]) and len(redo) > 5
        assert not set(main) & set(redo)
        owned += main + redo
    assert sorted(owned) == list(range(n))
    merged = str(tmp_path / f"merged.{fmt}")
    used = MH.merge_fragments(parts, merged, fmt)
    assert len(used) == 2 * P
    assert _ids(merged, fmt) == list(range(n))
    assert _records(merged, fmt) == _records(built["single"][fmt], fmt)


@pytest.mark.parametrize("fmt", FORMATS)
def test_merge_matches_reference(built, tmp_path, fmt):
    """The port's merge of the shard fragments is byte-identical to
    fulgor_tpu's merge of the same files."""
    parts, _stats = _shard_passes(built, fmt)
    got, want = str(tmp_path / "got"), str(tmp_path / "want")
    assert MH.merge_fragments(parts, got, fmt) == JMH.merge_fragments(
        parts, want, fmt)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_merge_refuses_a_fragment_out_of_order(tmp_path):
    part = str(tmp_path / "bad.part0")
    with open(part, "w") as f:
        f.write("5\t1\t0\n3\t0\n")
    with pytest.raises(ValueError, match="not id-ascending"):
        MH.merge_fragments([part], str(tmp_path / "out"), "ascii")


def test_unsharded_output_unchanged(built, tmp_path):
    """No shard: no side fragment, and num_procs=1 is pseudoalign_file,
    byte for byte."""
    out = str(tmp_path / "one.tsv")
    st = MH.pseudoalign_multihost(built["eng"], built["qfile"], out,
                                  num_procs=1, proc_id=0)
    assert st["num_reads"] == built["n"]
    assert not os.path.exists(out + ".redo")
    with open(out, "rb") as f, open(built["single"]["ascii"], "rb") as g:
        assert f.read() == g.read()


def test_deduplicate_takes_no_shard(built, tmp_path):
    with pytest.raises(ValueError, match="no shard"):
        built["eng"].pseudoalign_file(built["qfile"], str(tmp_path / "d"),
                                      deduplicate=True, shard=(0, 2))


def test_deduplicate_refused_over_processes(built, tmp_path, capsys):
    """The CLI refuses --deduplicate with --num-procs 2, as fulgor_tpu's
    does, before any bring-up."""
    out = str(tmp_path / "dd.tsv")
    argv = ["pseudoalign", "-i", built["index"], "-q", built["qfile"], "-o",
            out, "--deduplicate", "--num-procs", "2", "--proc-id", "0",
            "--coordinator", "127.0.0.1:1", "--device", "cpu"]
    assert tcli.main(argv) == 1
    assert capsys.readouterr().out == (
        "--deduplicate is single-host (global dedup state)\n")
    assert not os.path.exists(out)


def test_bring_up_needs_a_coordinator(monkeypatch):
    monkeypatch.delenv("FULGOR_COORDINATOR", raising=False)
    monkeypatch.setenv("FULGOR_NUM_PROCS", "1")
    assert MH.init_multihost() == (0, 1)
    assert MH.init_multihost(num_procs=1, proc_id=0) == (0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        MH.init_multihost(None, 2, 0)


def test_two_process_gloo_cli(built, tmp_path):
    """Two processes of the port's CLI on one gloo process group: both exit
    0, the fragments are merged and removed, and the merged file is
    id-ascending and holds the single-process records."""
    out = str(tmp_path / "mh.tsv")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "FULGOR_THREADS": "1",
           "FULGOR_PROBE_BUDGET": "1,1", "FULGOR_REDO_FLUSH": "2",
           "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fulgor_tpu_torch.cli", "pseudoalign", "-i",
         built["index"], "-q", built["qfile"], "-o", out, "--batch-size",
         "64", "--device", "cpu", "--num-procs", "2", "--proc-id", str(p),
         "--coordinator", coord, "-t", "1", "--verbose"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert all("mapped " in log for log in logs), logs
    assert os.listdir(tmp_path) == ["mh.tsv"]
    ids = _ids(out, "ascii")
    assert ids == list(range(built["n"]))
    assert _records(out, "ascii") == _records(built["single"]["ascii"],
                                              "ascii")
