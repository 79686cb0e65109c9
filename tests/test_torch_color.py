"""The meta, diff and meta-diff indexes and the host tools of the port, on
the CPU, against fulgor_tpu, tolerance 0:

- `color --meta/--diff/--meta --diff --check` with the port against
  fulgor_tpu's convert of the same index: the same kind, filenames and
  decoded colour sets, the same file bytes; check_conversion holds and a
  save/load round trip keeps the kind and the sets;
- FI and TU(0.8) on each conversion (device="cpu") against the base
  index's output, once each colour id is mapped through the filenames (a
  meta or meta-diff index stores its colours in permuted order); FI on the
  meta-diff conversion also against fulgor_tpu's engine on the same file;
- stats, print-filenames, verify, permute, dump then load, check and
  check --against: the same stdout, files and exit codes as
  fulgor_tpu.cli.main; `build --meta --diff` and `help`.
"""

import gzip
import os

import numpy as np
import pytest

from fulgor_tpu import cli as jcli
from fulgor_tpu.build import color_builder as JCB
from fulgor_tpu.index import Index as JIndex
from fulgor_tpu_torch import cli as tcli
from fulgor_tpu_torch.build import color_builder as TCB
from fulgor_tpu_torch.core import kmers as K
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.query import engine as E
from tests.test_color_tiers import tree_genomes
from tests.test_native import write_fasta
from tests.test_torch_engine import _records
from tests.test_torch_threads import one_thread  # noqa: F401

K_LEN, M_LEN, TAU = 15, 9, 0.8
KINDS = {"meta": (["--meta"], ".tmfur"), "diff": (["--diff"], ".tdfur"),
         "meta_diff": (["--meta", "--diff"], ".tmdfur")}
ALL_EXT = (".tfur",) + tuple(ext for _f, ext in KINDS.values())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """64 genomes of a clade tree (2,000 bp), listed in a seeded shuffled
    order so that the colour permutations are not the identity; the port's
    index of them and its three conversions (`color --check`); 200 reads
    with errors, a read of 1,500 bases and a junk read; the base index's FI
    and TU(0.8) records."""
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("torch_color")
    genomes = tree_genomes(rng, depth=6, length=2000, mut_per_branch=16)
    paths = []
    for i in rng.permutation(len(genomes)):
        p = str(tmp / f"g{i}.fa")
        write_fasta(p, genomes[i])
        paths.append(p)
    listfile = str(tmp / "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(paths) + "\n")
    base = str(tmp / "idx")
    assert tcli.main(["build", "-l", listfile, "-o", base, "-k", str(K_LEN),
                      "-m", str(M_LEN)]) == 0
    for flags, _ext in KINDS.values():
        assert tcli.main(["color", "-i", base + ".tfur", "--check"]
                         + flags) == 0
    reads = []
    for i in range(200):
        s = genomes[rng.integers(0, len(genomes))][0]
        L = int(rng.integers(50, 100))
        p = rng.integers(0, len(s) - L)
        r = K.seq_to_codes(s[p: p + L]).copy()
        if i % 4 == 0:
            e = rng.integers(0, L)
            r[e] = (r[e] + 1) % 4
        reads.append(K.codes_to_seq(r))
    reads.insert(70, genomes[5][0][:1500])
    reads.append(K.codes_to_seq(rng.integers(0, 4, size=80).astype(np.uint8)))
    qfile = str(tmp / "reads.fq.gz")
    with gzip.open(qfile, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    want = _query(base + ".tfur", qfile, tmp)
    assert len(want["fi"]) == len(reads) and want["fi"][len(reads) - 1] == ()
    assert len(want["fi"][70]) > 0  # the long read maps
    return tmp, base, listfile, qfile, want


def _query(path, qfile, tmp, tools=("fi", "tu")) -> dict:
    """FI and TU(TAU) records (qid -> colours) of the port on the CPU."""
    eng = E.QueryEngine(TIndex.load(path), batch_size=64, device="cpu")
    out = {}
    for tool in tools:
        o = os.path.join(tmp, f"{os.path.basename(path)}.{tool}")
        eng.pseudoalign_file(qfile, o,
                             threshold=TAU if tool == "tu" else None)
        out[tool] = _records(o, "ascii")
    return out


def _decoded(idx):
    cat, offs = idx.color_sets_decoded()
    return np.asarray(cat), np.asarray(offs)


@pytest.mark.parametrize("kind", list(KINDS))
def test_conversion_matches_reference(corpus, kind):
    """The port's `color` output is fulgor_tpu's convert of the same index:
    kind, filenames, sets and file bytes."""
    tmp, base, *_ = corpus
    flags, ext = KINDS[kind]
    want = JCB.convert(JIndex.load(base + ".tfur"), meta="--meta" in flags,
                       diff="--diff" in flags)
    got = TIndex.load(base + ext)
    assert got.kind == want.kind == kind
    assert got.filenames == want.filenames
    for a, b in zip(_decoded(got), _decoded(want)):
        np.testing.assert_array_equal(a, b)
    ref = str(tmp / f"ref{ext}")
    want.save(ref)
    with open(ref, "rb") as f, open(base + ext, "rb") as g:
        assert f.read() == g.read()
    if kind != "diff":  # the shuffled listing is regrouped by clade
        assert got.filenames != TIndex.load(base + ".tfur").filenames


@pytest.mark.parametrize("kind", list(KINDS))
def test_conversion_round_trip(corpus, kind):
    """check_conversion holds on the in-memory conversion, and saving and
    loading it keeps its kind, filenames and sets."""
    tmp, base, *_ = corpus
    flags, _ext = KINDS[kind]
    idx = TIndex.load(base + ".tfur")
    conv = TCB.convert(idx, meta="--meta" in flags, diff="--diff" in flags)
    assert conv.kind == TCB.KIND_TARGET[("--meta" in flags,
                                         "--diff" in flags)]
    assert TCB.check_conversion(idx, conv)
    path = TIndex.path_for(str(tmp / f"rt_{kind}"), conv.kind)
    conv.save(path)
    assert TIndex.kind_of(path) == kind
    back = TIndex.load(path)
    assert back.kind == kind and back.filenames == conv.filenames
    for a, b in zip(_decoded(back), _decoded(conv)):
        np.testing.assert_array_equal(a, b)
    for s in (0, conv.num_color_sets - 1):
        np.testing.assert_array_equal(back.color_set(s), conv.color_set(s))


@pytest.mark.parametrize("tool", ["fi", "tu"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_queries_match_base_after_mapping(corpus, kind, tool):
    """FI and TU(0.8) on a conversion name its (permuted) colour ids: mapped
    through the filenames to the base index's ids, every record equals the
    base index's."""
    tmp, base, _l, qfile, want = corpus
    path = base + KINDS[kind][1]
    conv = TIndex.load(path)
    to_base = {fn: i for i, fn in enumerate(TIndex.load(base + ".tfur")
                                            .filenames)}
    m = np.array([to_base[fn] for fn in conv.filenames], dtype=np.int64)
    got = _query(path, qfile, tmp, (tool,))[tool]
    mapped = {q: tuple(sorted(m[list(c)].tolist())) for q, c in got.items()}
    assert mapped == want[tool]


def test_meta_diff_fi_matches_fulgor_tpu(corpus, tmp_path):
    """FI on the meta-diff conversion: the port's records equal fulgor_tpu's
    engine's on the same file (one fulgor_tpu pass)."""
    from fulgor_tpu.query.engine import QueryEngine

    tmp, base, _l, qfile, _want = corpus
    path = base + ".tmdfur"
    out = str(tmp_path / "ref.tsv")
    QueryEngine(JIndex.load(path), batch_size=256,
                use_mesh=False).pseudoalign_file(qfile, out)
    assert _query(path, qfile, tmp, ("fi",))["fi"] == _records(out, "ascii")


def _both(capsys, argv):
    """(rc, stdout) of fulgor_tpu's cli and of the port's on argv."""
    capsys.readouterr()
    outs = []
    for cli in (jcli, tcli):
        rc = cli.main(argv(cli))
        outs.append((rc, capsys.readouterr().out))
    return outs


@pytest.mark.parametrize("tool,ext", [
    ("stats", e) for e in ALL_EXT] + [
    ("print-filenames", ".tfur"), ("print-filenames", ".tmdfur"),
    ("verify", ".tfur"), ("verify", ".tmdfur"), ("check", ".tfur"),
    ("check --against", ".tmfur"), ("check --against", ".tdfur"),
    ("check --against", ".tmdfur")])
def test_host_tools_match_reference(corpus, capsys, tool, ext):
    tmp, base, *_ = corpus
    argv = [*tool.split(), "-i", base + ext]
    if tool == "check --against":
        argv = ["check", "-i", base + ext, "--against", base + ".tfur",
                "--verbose"]
    (jrc, jout), (trc, tout) = _both(capsys, lambda _c: argv)
    assert trc == jrc == 0
    assert tout == jout and tout
    if tool.startswith("check"):
        assert tout.endswith("EVERYTHING OK!\n")


def test_permute_matches_reference(corpus, capsys, tmp_path):
    tmp, base, *_ = corpus
    (jrc, jout), (trc, tout) = _both(capsys, lambda c: [
        "permute", "-i", base + ".tfur", "-o", str(tmp_path / c.__name__)])
    assert trc == jrc == 0
    assert tout.replace(tcli.__name__, jcli.__name__) == jout
    with open(tmp_path / jcli.__name__) as f, \
            open(tmp_path / tcli.__name__) as g:
        got = g.read()
        assert got == f.read()
    assert sorted(got.split()) == sorted(TIndex.load(base + ".tfur")
                                         .filenames)


@pytest.mark.parametrize("ext", [".tfur", ".tmdfur"])
def test_dump_then_load_matches_reference(corpus, capsys, tmp_path, ext):
    """dump writes the same four text files as fulgor_tpu's; load of them
    writes the same index file, which answers check."""
    tmp, base, *_ = corpus
    (jrc, jout), (trc, tout) = _both(capsys, lambda c: [
        "dump", "-i", base + ext, "-o", str(tmp_path / c.__name__)])
    assert trc == jrc == 0 and tout == jout
    for part in ("metadata.txt", "filenames.txt", "unitigs.fa",
                 "color_sets.txt"):
        with open(tmp_path / f"{jcli.__name__}.{part}", "rb") as f, \
                open(tmp_path / f"{tcli.__name__}.{part}", "rb") as g:
            assert g.read() == f.read(), part
    dump = str(tmp_path / tcli.__name__)
    (jrc, jout), (trc, tout) = _both(capsys, lambda c: [
        "load", "-i", dump, "-o", str(tmp_path / f"loaded_{c.__name__}"),
        "-m", str(M_LEN)])
    assert trc == jrc == 0
    assert tout.replace(tcli.__name__, jcli.__name__) == jout
    with open(tmp_path / f"loaded_{jcli.__name__}.tfur", "rb") as f, \
            open(tmp_path / f"loaded_{tcli.__name__}.tfur", "rb") as g:
        assert g.read() == f.read()
    loaded = TIndex.load(str(tmp_path / f"loaded_{tcli.__name__}.tfur"))
    src = TIndex.load(base + ext)
    assert loaded.filenames == src.filenames
    for a, b in zip(_decoded(loaded), _decoded(src)):
        np.testing.assert_array_equal(a, b)
    assert loaded.unitig_seq_str(3) == src.unitig_seq_str(3)
    assert loaded.u2c(3) == src.u2c(3)
    assert tcli.main(["check", "-i", str(tmp_path / f"loaded_"
                                         f"{tcli.__name__}.tfur")]) == 0


def test_build_meta_diff_and_refusals(corpus, capsys, tmp_path):
    """`build --meta --diff --check` writes the base index and the same
    meta-diff index as `color`; `color` refuses an existing output without
    --force as fulgor_tpu does."""
    tmp, base, listfile, *_ = corpus
    out = str(tmp_path / "b")
    assert tcli.main(["build", "-l", listfile, "-o", out, "-k", str(K_LEN),
                      "-m", str(M_LEN), "--meta", "--diff", "--check"]) == 0
    assert f"index written to '{out}.tmdfur'" in capsys.readouterr().out
    for ext in (".tfur", ".tmdfur"):
        with open(out + ext, "rb") as f, open(base + ext, "rb") as g:
            assert f.read() == g.read()
    capsys.readouterr()
    rcs = []
    for cli in (jcli, tcli):
        rcs.append(cli.main(["color", "-i", out + ".tfur", "--meta",
                             "--diff"]))
        rcs.append(capsys.readouterr().err)
    assert rcs[0] == rcs[2] == 1 and rcs[1] == rcs[3]
    assert "already exists" in rcs[1]


def test_help_lists_every_subcommand(capsys):
    assert tcli.main(["help"]) == 0
    text = capsys.readouterr().out
    for cmd in ("build", "color", "permute", "pseudoalign",
                "kmer-conservation", "kmer-matches", "stats",
                "print-filenames", "verify", "dump", "load", "check",
                "help"):
        assert cmd in text
