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


@pytest.mark.parametrize("hosts,rank,want", [
    (["a"], 0, (0, 1)),
    (["a", "a"], 0, (0, 2)),
    (["a", "a"], 1, (1, 2)),
    (["a", "b", "a", "b", "a"], 4, (2, 3)),
    (["a", "b", "a", "b", "a"], 3, (1, 2)),
])
def test_host_rank(hosts, rank, want):
    assert MH.host_rank(hosts, rank) == want


def test_process_device_mapping():
    """Alone on its host (or with no card) a process keeps the engine's
    default; processes sharing a host take one card each, round robin."""
    assert MH.process_device(0, 1, 4) is None
    assert MH.process_device(0, 1, 1) is None
    assert MH.process_device(1, 2, 0) is None
    assert [MH.process_device(r, 4, 4) for r in range(4)] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert [MH.process_device(r, 3, 2) for r in range(3)] == [
        "cuda:0", "cuda:1", "cuda:0"]
    assert MH.local_rank() == (0, 1)  # no process group


def test_two_gloo_processes_get_local_ranks(tmp_path):
    """Two processes of one gloo group on this host: local ranks 0 and 1 of
    2, and with two cards each would take its own."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    code = ("import sys; from fulgor_tpu_torch.parallel import multihost "
            "as MH; p = int(sys.argv[1]); "
            f"MH.init_multihost({coord!r}, 2, p); "
            "r = MH.local_rank(); print('local', p, *r, "
            "MH.process_device(*r, 2)); MH.shutdown_multihost()")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(p)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    got = [ln for log in logs for ln in log.splitlines()
           if ln.startswith("local ")]
    assert got == ["local 0 0 2 cuda:0", "local 1 1 2 cuda:1"], logs


class _Chosen(Exception):
    pass


@pytest.mark.parametrize("argv_device,local,want", [
    (None, (1, 2), "cuda:1"),  # two processes share the host: one card each
    (None, (0, 2), "cuda:0"),
    (None, (0, 1), None),  # alone on its host: the engine's default mesh
    ("cuda:3", (1, 2), "cuda:3"),  # an explicit --device wins
])
def test_cli_process_takes_its_card(built, monkeypatch, argv_device, local,
                                    want):
    """The CLI's multi-process branch, its group and engine stubbed: the
    device it gives QueryEngine on a host of two cards."""
    import torch

    calls = []
    monkeypatch.setattr(MH, "init_multihost", lambda *a: (local[0], 2))
    monkeypatch.setattr(MH, "local_rank", lambda: calls.append(1) or local)
    monkeypatch.setattr(MH, "shutdown_multihost", lambda: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def engine(idx, batch_size, device):
        raise _Chosen(device)

    monkeypatch.setattr(E, "QueryEngine", engine)
    argv = ["pseudoalign", "-i", built["index"], "-q", built["qfile"], "-o",
            "unused.tsv", "--num-procs", "2", "--proc-id", str(local[0]),
            "--coordinator", "127.0.0.1:1", "--verbose"]
    with pytest.raises(_Chosen) as chosen:
        tcli.main(argv + (["--device", argv_device] if argv_device else []))
    assert chosen.value.args[0] == want
    assert len(calls) == (0 if argv_device else 1)


@pytest.mark.parametrize("entry", [
    "pseudoalign_codes", "pseudoalign_codes_dedup", "window_csids_codes",
    "pseudoalign_file", "kmer_conservation_file", "kmer_matches_file"])
def test_engine_launches_go_to_its_card(monkeypatch, entry):
    """A process that takes cuda:1 (one card a process) keeps card 0
    current: each engine entry point makes its engine's card current for
    its launches (a ctypes launch goes to the current card, where another
    card's stream fails) and gives the caller's card back after, so that
    an engine made later with no device still resolves to card 0."""
    import contextlib
    import types

    import torch

    from fulgor_tpu_torch.query import engine as E

    current, seen = [0], []

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], torch.device(dev).index
        try:
            yield
        finally:
            current[0] = prev

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", device)
    wrapped = getattr(E.QueryEngine, entry)
    assert wrapped.__code__ is E.on_its_card(lambda self: None).__code__
    assert wrapped.__wrapped__.__name__ == entry

    @E.on_its_card
    def launch(self, x, y=0):
        seen.append((current[0], x, y))
        return x + y

    one = types.SimpleNamespace(device=E.resolve_device("cuda:1"))
    assert launch(one, 2, y=3) == 5 and seen == [(1, 2, 3)]
    assert current[0] == 0
    assert E.resolve_device(None) == torch.device("cuda", 0)
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert launch(cpu, 1) == 1 and seen[-1] == (0, 1, 0)
