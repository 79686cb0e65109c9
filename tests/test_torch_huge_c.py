"""The huge-colour regime (65,536 colours, C32 = 2,048: fulgor_tpu's
scripts/demo150k.py) on the CPU, against fulgor_tpu, tolerance 0.

- One small index built with the port, widened to 65,536 colours by
  repetition (colour c stands for genome c % G, as chip_smoke's wide
  index), saved and loaded by both packages: FI and TU(0.8) under
  dense_max_bytes=0 (the runs fetch and runs TU, the dense matrix
  forbidden) and under the defaults, through both engines on the same
  reads; records equal after sorting by read id, and the strategy flags
  equal.
- The plain versions of K3, K4, K5 and K9 against fulgor_tpu's
  full_intersection_windows, threshold_union_scores_windows (thresholded
  and packed as query_tu_lists_packed does) and first_set_bits on seeded
  inputs at C = 65,536 and at the ragged C = 65,519 (random pad bits).
- fulgor_tpu_torch.demo150k at 64 genomes and 256 reads with --device cpu:
  its regimes' assertions hold and its lines have their shape; without a
  card it refuses to run unless told --device cpu.
"""

import dataclasses
import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.index import Index as JIndex
from fulgor_tpu.ops import intersect as J
from fulgor_tpu.query import engine as JE
from fulgor_tpu_torch import demo150k
from fulgor_tpu_torch.build.builder import build_index
from fulgor_tpu_torch.core import kmers as K
from fulgor_tpu_torch.core.colorstores import HybridStore
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import intersect as TI
from fulgor_tpu_torch.query import engine as E
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_threads import one_thread  # noqa: F401

HUGE_C, RAGGED_C = 65536, 65519
G, NUM_READS, BATCH, TAU = 5, 96, 64, 0.8


def widen(cat, offs, G, C):
    """Each set S over G colours -> {c < C : c % G in S}, as (cat, offs)."""
    genome = np.arange(C) % G
    sets = [np.flatnonzero(np.isin(genome, cat[offs[s]: offs[s + 1]]))
            for s in range(len(offs) - 1)]
    woffs = np.zeros(len(sets) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in sets], out=woffs[1:])
    return np.concatenate(sets).astype(np.uint32), woffs


@pytest.fixture(scope="module")
def huge(tmp_path_factory):
    """(index path, reads path): the port's index of G genomes of 2,000 bp
    widened to HUGE_C colours; NUM_READS reads of 100 bp and a junk read."""
    rng = np.random.default_rng(65)
    tmp = tmp_path_factory.mktemp("torch_huge")
    genomes = random_genomes(rng, num_colors=G, length=2000, mut=0.02, k=31)
    paths = []
    for i, seqs in enumerate(genomes):
        paths.append(str(tmp / f"g{i}.fa"))
        write_fasta(paths[-1], seqs)
    idx = build_index(paths, k=31, m=19)
    cat, offs = widen(*idx.color_sets_decoded(), G, HUGE_C)
    wide = dataclasses.replace(
        idx, num_colors=HUGE_C,
        filenames=[f"{idx.filenames[c % G]}#{c // G}" for c in range(HUGE_C)],
        color_store=HybridStore.build(cat, offs, HUGE_C), _dense_bits=None,
        _cs_cache=None, _row_memo=None, _row_pos=None, _row_n=0)
    path = str(tmp / "huge.tfur")
    wide.save(path)
    reads = str(tmp / "reads.fq.gz")
    with gzip.open(reads, "wt") as f:
        for i in range(NUM_READS):
            s = genomes[rng.integers(0, G)][0]
            p = rng.integers(0, len(s) - 100)
            f.write(f"@r{i}\n{s[p: p + 100]}\n+\n{'I' * 100}\n")
        junk = K.codes_to_seq(rng.integers(0, 4, size=100).astype(np.uint8))
        f.write(f"@junk\n{junk}\n+\n{'I' * 100}\n")
    return path, reads


def sorted_records(path) -> list:
    with open(path, "rb") as f:
        return sorted(f.read().splitlines(),
                      key=lambda ln: int(ln[: ln.index(b"\t")]))


@pytest.mark.parametrize("tool", ["fi", "tu"])
@pytest.mark.parametrize("regime", ["no_dense", "default"])
def test_engines_agree_at_65536_colours(huge, tmp_path, monkeypatch, regime,
                                        tool):
    path, reads = huge
    jidx, tidx = JIndex.load(path), TIndex.load(path)
    assert tidx.num_colors == jidx.num_colors == HUGE_C
    assert tidx.words_per_set == 2048
    kw = {}
    if regime == "no_dense":
        monkeypatch.setenv("FULGOR_DENSE_MAX_BYTES", "0")
        kw["dense_max_bytes"] = 0

        def boom(*_a):
            raise AssertionError("the dense colour matrix was built")

        for i in (jidx, tidx):
            i.dense_color_bits = boom
        tidx.device_dense = boom
    jeng = JE.QueryEngine(jidx, batch_size=BATCH, use_mesh=False)
    teng = E.QueryEngine(tidx, batch_size=BATCH, device="cpu", **kw)
    for flag in ("use_lists", "use_runs_fetch", "use_tu_runs"):
        assert getattr(teng, flag) == getattr(jeng, flag), flag
    assert teng.use_runs_fetch  # 2,048 words a set: past RUNS_MIN_WORDS
    assert teng.use_tu_runs == (regime == "no_dense")
    threshold = TAU if tool == "tu" else None
    out_j, out_t = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    jeng.pseudoalign_file(reads, out_j, threshold=threshold)
    st = teng.pseudoalign_file(reads, out_t, threshold=threshold)
    want, got = sorted_records(out_j), sorted_records(out_t)
    assert len(got) == NUM_READS + 1 and st["num_reads"] == NUM_READS + 1
    assert got == want
    sizes = [int(ln.split(b"\t")[1]) for ln in got]
    # a genome stands for 13,107 or 13,108 colours
    assert max(sizes) >= HUGE_C // G and sizes.count(0) < NUM_READS // 4
    if regime == "no_dense":
        assert tidx._dense_bits is None and teng._bits is None


def _inputs(C, seed):
    """Seeded dense rows of C colours (random pad bits), reads of runs of
    equal csids with negative windows between them, reads 0-1 unmapped."""
    rng = np.random.default_rng(seed)
    S, B, Wk, C32 = 40, 12, 130, (C + 31) // 32
    dense = rng.integers(0, 1 << 32, size=(S, C32), dtype=np.uint64)
    dense |= rng.integers(0, 1 << 32, size=(S, C32), dtype=np.uint64)
    dense = dense.astype(np.uint32)
    dense[: S // 4] = 0xFFFFFFFF
    dense[S // 2:] &= rng.integers(0, 1 << 32, size=(S - S // 2, C32),
                                   dtype=np.uint64).astype(np.uint32)
    csid = np.empty((B, Wk), np.uint32)
    for b in range(B):
        csid[b] = np.repeat(rng.integers(0, 10 if b % 2 else S, size=Wk),
                            rng.integers(1, 12, size=Wk))[:Wk]
    hit = rng.random((B, Wk)) < 0.8
    hit[:2] = False
    csid[~hit] = 0xFFFFFFFF
    return dense, hit, csid


def _torch(dense, hit, csid):
    return (torch.from_numpy(dense.view(np.int32)), torch.from_numpy(hit),
            torch.from_numpy(csid.view(np.int32)))


def _table(tau, Wk):
    npos = np.arange(Wk + 1, dtype=np.float64)
    return (npos * tau).astype(np.int64).astype(np.int32)


def _jax_mask(dense, hit, csid, C, tau):
    """query_tu_lists_packed's mask (fulgor_tpu pipeline.py:274-281)."""
    jh = jnp.asarray(hit)
    scores = J.threshold_union_scores_windows(
        jnp.asarray(dense), jh, jnp.asarray(csid), C)
    npos = jnp.sum(jh.astype(jnp.int32), axis=1)
    ms = jnp.take(jnp.asarray(_table(tau, hit.shape[1])), npos, axis=0)
    mask = (scores >= ms[:, None].astype(scores.dtype)) & (npos > 0)[:, None]
    return np.asarray(J.pack_bool_bits(jnp.pad(mask,
                                               ((0, 0), (0, (-C) % 32)))))


@pytest.mark.parametrize("kernel", ["K3", "K4", "K5", "K9"])
@pytest.mark.parametrize("C", [HUGE_C, RAGGED_C])
def test_plain_kernels_match_jax_at_huge_c(C, kernel):
    dense, hit, csid = _inputs(C, seed=C % 1000)
    jd, jh, jc = jnp.asarray(dense), jnp.asarray(hit), jnp.asarray(csid)
    t = _torch(dense, hit, csid)
    if kernel == "K3":
        got = TI.fi_and(*t).numpy().view(np.uint32)
        want = np.asarray(J.full_intersection_windows(jd, jh, jc))
        np.testing.assert_array_equal(got, want)
        assert got[:2].sum() == 0 and got[2:].any()
    elif kernel == "K4":
        for tau in (TAU, 1.0):
            got = TI.tu_mask(*t, torch.from_numpy(_table(tau, hit.shape[1])),
                             C).numpy().view(np.uint32)
            np.testing.assert_array_equal(got,
                                          _jax_mask(dense, hit, csid, C, tau))
            if C % 32:
                assert not (got[:, -1] >> np.uint32(C % 32)).any()
        fi = np.array(J.full_intersection_windows(jd, jh, jc))
        pad = np.uint32((1 << (C % 32)) - 1) if C % 32 else np.uint32(
            0xFFFFFFFF)
        fi[:, -1] &= pad
        np.testing.assert_array_equal(got, fi)  # tau 1.0: the AND
    elif kernel == "K5":
        _hitw, got = TI.km_scores(*t, C)
        want = np.asarray(J.threshold_union_scores_windows(jd, jh, jc, C))
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      want.astype(np.int64))
        assert got.shape == (hit.shape[0], C) and int(got.max()) > 100
    else:
        rows = np.concatenate([  # writable copies
            np.asarray(J.full_intersection_windows(jd, jh, jc)),
            _jax_mask(dense, hit, csid, C, TAU)])
        rows[-1] = 0
        rows[-2] = 0
        rows[-2, -1] = 0x80000000  # bit 31 of the last word alone
        for T in (1, 64):
            count, lists = TI.first_set_bits(
                torch.from_numpy(rows.view(np.int32)), T)
            want_count, want_lists = J.first_set_bits(jnp.asarray(rows), T)
            np.testing.assert_array_equal(count.numpy(),
                                          np.asarray(want_count))
            np.testing.assert_array_equal(lists.numpy(),
                                          np.asarray(want_lists))
            assert lists[-2, 0] == 32 * 2048 - 1 and count[-1] == 0
            assert (count > 60000).any()


def test_demo150k_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The demo's three regimes at 64 genomes and 256 reads on the plain
    versions; RUNS_MIN_WORDS at 0 puts its 2-word sets in the large-colour
    regime, whose paths the demo asserts."""
    monkeypatch.setenv("FULGOR_RUNS_MIN_WORDS", "0")
    assert demo150k.main(["--genomes", "64", "--reads", "256", "--device",
                          "cpu", "--cache", str(tmp_path), "--batch-size",
                          "256"]) == 0
    out = capsys.readouterr().out.splitlines()
    res = json.loads(out[-1])
    assert res["genomes"] == 64 and res["reads"] == 256
    assert res["selfcheck"] == 1 and res["a_never_dense"]
    assert res["index"]["colours"] == 64 and res["index"]["words_per_set"] == 2
    assert res["b_fetch"] in ("lists", "runs")
    for regime in "abc":
        for tool in ("fi", "tu"):
            p = res[regime][tool]
            assert p["warm"]["reads"] == p["timed"]["reads"] == 256
            assert p["warm"]["mapped"] == p["timed"]["mapped"] > 0
            assert p["timed"]["card_bytes"] is None
    lines = [ln for ln in out[:-1] if ln.startswith("[demo150k] (")]
    assert sum(" warm, self-check every 1: 256 reads in " in ln
               for ln in lines) == 6
    assert sum(" timed: 256 reads in " in ln for ln in lines) == 6
    assert sum("records, all equal to (a)'s" in ln for ln in lines) == 4
    assert any("(a) dense matrix never made: True" in ln for ln in lines)
    assert any("(c) dense matrix never made: True" in ln for ln in lines)
    for ln in lines:
        if " timed: " in ln:
            assert "reads/s; query " in ln and "peak host RSS" in ln


def test_demo150k_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo150k.main(["--genomes", "64", "--cache", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # nothing made before it raised
