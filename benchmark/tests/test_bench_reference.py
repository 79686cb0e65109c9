"""The reference against a plain loop over k-mer strings, the control
against the reference, and the frozen copies against the program's
originals where both can run here."""

import numpy as np
import pytest
import torch

from benchmark.control import control_run
from benchmark.reference.exact import (
    AsciiLines, colour_lists, genome_counts, window_keys)

K = 5


def canon(s: str) -> str:
    rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    return min(s, rc)


def loop_counts(genomes, reads, k):
    """npos and counts by Python sets of canonical k-mer strings."""
    sets = []
    for g in genomes:
        seen = set()
        for part in g.split("N"):
            seen |= {canon(part[i: i + k]) for i in range(len(part) - k + 1)}
        sets.append(seen)
    every = set().union(*sets)
    npos, counts = [], []
    for r in reads:
        ws = [canon(r[i: i + k]) for i in range(len(r) - k + 1)
              if "N" not in r[i: i + k]]
        pos = [w for w in ws if w in every]
        npos.append(len(pos))
        counts.append([sum(w in s for w in pos) for s in sets])
    return np.array(npos), np.array(counts)


def test_counts_equal_a_plain_loop():
    rng = np.random.default_rng(7)
    anc = rng.integers(0, 4, 300)
    genomes = []
    for i in range(6):
        g = anc.copy()
        g[rng.choice(300, 12, replace=False)] = rng.integers(0, 4, 12)
        genomes.append(np.concatenate([g[:140], [4], g[140:]]))
    codes = np.concatenate([np.append(g, 4) for g in genomes]).astype(
        np.uint8)
    offs = np.cumsum([0] + [len(g) + 1 for g in genomes])
    reads = np.stack([genomes[i % 6][i * 7: i * 7 + 40] for i in range(20)]
                     + [rng.integers(0, 4, 40) for _ in range(4)])
    reads[3, 10] = 4
    reads = reads.astype(np.uint8)
    want = loop_counts(["".join("ACGTN"[c] for c in g) for g in genomes],
                       ["".join("ACGTN"[c] for c in r) for r in reads], K)
    for blocks in ((1 << 28, 1 << 30), (100, 1000)):
        got = genome_counts(codes, offs, reads, K, torch.device("cpu"),
                            block_bases=blocks[0], block_cells=blocks[1])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_window_keys_are_canonical():
    s = torch.tensor([0, 1, 2, 3, 3, 2], dtype=torch.int64)
    rc = 3 - s.flip(0)
    a, _ = window_keys(s, 4)
    b, _ = window_keys(rc, 4)
    assert sorted(a.tolist()) == sorted(b.tolist())


def test_colour_lists_and_lines():
    npos = np.array([0, 4, 5])
    counts = np.array([[0, 0, 0], [4, 3, 4], [5, 4, 0]])
    fi = colour_lists(npos, counts, None, 7)
    assert [x.tolist() for x in fi] == [[], [0, 2, 3, 5, 6], [0, 3, 6]]
    tu = colour_lists(npos, counts, 0.8, 7)  # int(4 * 0.8) = 3, int(4.0)
    assert [x.tolist() for x in tu] == [[], list(range(7)), [0, 1, 3, 4, 6]]
    fmt = AsciiLines(12)
    assert fmt.line(7, np.array([], np.uint32)) == b"7\t0\n"
    assert fmt.line(0, np.array([3, 11], np.uint32)) == b"0\t2\t3\t11\n"


def test_the_control_fails_on_three_seeds(tiny_bench):
    """The control's records, judged by the run's own comparison."""
    for seed in (11, 2**31 + 12, 13):
        r = control_run(tiny_bench, "tiny.fi", seed, torch.device("cpu"))
        assert not r["correct"], r
        assert r["checks"]["records_wrong"]["value"] > 0, r


def test_frozen_copies_match_the_originals(tmp_path):
    from benchmark.corpus import simulate_pangenome_blocks
    from benchmark.widen import expand_colours
    from fulgor_tpu_torch.io.simulate import (
        load_genome_codes, simulate_pangenome_blocks as original)

    kw = dict(num_genes=6, gene_len=200, core_frac=0.5, loss_rate=0.1,
              mut_per_branch=4, gain_per_branch=1, gain_len=150,
              pool_genes=8, seed=9)
    a, _ = simulate_pangenome_blocks(str(tmp_path / "a"), 10, **kw)
    b = original(str(tmp_path / "b"), 10, gzip_files=False, **kw)
    for x, y in zip(a, b):
        assert open(x, "rb").read() == open(y, "rb").read()
        assert len(load_genome_codes(x))
    cat = np.array([0, 2, 1, 0, 1, 2], np.uint32)
    offs = np.array([0, 2, 3, 6])
    out, o = expand_colours(cat, offs, 3, 7)
    got = [out[o[i]: o[i + 1]].tolist() for i in range(3)]
    assert got == [[0, 2, 3, 5, 6], [1, 4], [0, 1, 2, 3, 4, 5, 6]]


@pytest.mark.card
def test_the_reference_on_the_card_equals_the_cpu(tiny_bench, card):
    from benchmark import harness

    cell = tiny_bench.cell("tiny.fi")
    cfg = tiny_bench.config("tiny")
    cdir = harness.ensure_prepared(tiny_bench, cfg)
    codes = np.load(f"{cdir}/codes.npy")
    offs = np.load(f"{cdir}/genome_offs.npy")
    reads = codes[offs[0]: offs[0] + 150 * 64].reshape(64, 150).copy()
    reads[reads > 3] = 0
    a = genome_counts(codes, offs, reads, cfg["k"], torch.device("cpu"))
    b = genome_counts(codes, offs, reads, cfg["k"], card)
    np.testing.assert_array_equal(a[1], b[1])
    assert cell["tau"] is None
