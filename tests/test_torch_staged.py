"""The staged probe (kernel K10, FULGOR_PROBE_BUDGET=vb1,vb2,sc,RU) on the
CPU: the port's plain versions against fulgor_tpu on the same seeded
inputs, bit-exact (tolerance 0):

- K2's stage1 mode against _probe_entries(stage1=True): hit, csid, the
  uncapped candidate count and need_sec, usable or not;
- the staged probe against lookup_minidict2_staged_packed at (2, 8, 4, 16),
  (2, 8, 4, 2) and (1, 8, 4, 1), the last two with heavy reads past the
  B2 sub-batch; and its contract: wherever its ovf is false, the one-pass
  probe at (8, 4) decides the window too, with the same hit and csid; hit
  and ovf never both;
- `cli pseudoalign` (FI and -r 0.8) and `cli kmer-conservation` under the
  staged budgets, and with pipeline.ANCHORED_PROBE on, against the default
  one-pass output on test_torch_engine's corpus (FI fulgor_tpu's records;
  TU and kmer-conservation the port's, held equal to fulgor_tpu's by the
  other engine tests); with tight lane budgets the anchored probe's
  deferred redo runs anchored too, and reads it leaves in overflow take
  the host mirror. The engine under both probes is tested here, so that
  one corpus serves both; tests/test_torch_anchored.py holds K11's own
  parity;
- a four-value FULGOR_PROBE_BUDGET selects the staged probe.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.build.builder import build_index
from fulgor_tpu.core import kmers as K
from fulgor_tpu.ops import minidict2 as J
from fulgor_tpu_torch import cli as tcli
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import anchored as A
from fulgor_tpu_torch.ops import pipeline as TP
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.ops.prep import window_prep
from fulgor_tpu_torch.ops.intersect import _first_positions
from fulgor_tpu_torch.ops.probe import (
    minidict2_probe, prep_of_lanes, probe_lanes,
)
from fulgor_tpu_torch.ops.staged import minidict2_staged_probe
from fulgor_tpu_torch.query import engine as E
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_engine import _records, corpus  # noqa: F401
from tests.test_torch_threads import one_thread  # noqa: F401

W = 64
STAGED = [(2, 8, 4, 16), (2, 8, 4, 2), (1, 8, 4, 1)]
ENGINE_BUDGETS = ["2,8,4,16", "1,8,4,1"]
TAU = 0.8


def probe_inputs(k, m, seed, tmp):
    """Six near-identical genomes (heavy minimizer groups, so covered
    entries, the skew route and overflow all occur) and 48 reads of W
    bases with up to two errors, an all-N read and a padded one. ->
    (minidict, the JAX prep, the port's prep, the port's tables, codes2,
    bad)."""
    rng = np.random.default_rng(seed)
    genomes = random_genomes(rng, num_colors=6, length=3000, mut=0.02, k=k)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa")
        write_fasta(p, seqs)
        paths.append(p)
    d = build_index(paths, k=k, m=m).minidict()
    reads = []
    for _ in range(48):
        g = genomes[rng.integers(0, len(genomes))][0]
        p = rng.integers(0, len(g) - W)
        r = K.seq_to_codes(g[p: p + W]).copy()
        ne = rng.integers(0, 3)
        if ne:
            pos = rng.choice(W, size=ne, replace=False)
            r[pos] = (r[pos] + rng.integers(1, 4, size=ne)) % 4
        reads.append(r)
    chunk = np.stack(reads).astype(np.uint8)
    chunk[-1, :] = 4          # all-N read
    chunk[-2, 40:] = 4        # padded read
    codes2, bad = pack_reads_host(chunk)
    jprep = J._window_prep_from_words(
        *J.words_from_packed(jnp.asarray(codes2), jnp.asarray(bad)), W, k, m)
    tabs = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in (d.slots, d.text32, d.sec_table)]
    tprep = window_prep(torch.from_numpy(codes2), torch.from_numpy(bad),
                        width=W, k=k, m=m)
    return d, jprep, tprep, tabs, codes2, bad


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    k, m = 31, 19
    return (k, m) + probe_inputs(k, m, 17, tmp_path_factory.mktemp("staged"))


def _np(t):
    t = t.numpy()
    return t.view(np.uint32) if t.dtype == np.int32 else t


@pytest.mark.parametrize("vb", [1, 2])
def test_stage1_matches_jax(case, vb):
    k, m, d, jprep, tprep, tabs, _c2, _bad = case
    (minval, iL, iR, _pL, _pR, sigL, sigR, flo, fhi, rlo, rhi, usable) = jprep
    want = J._probe_entries(
        jnp.asarray(d.slots), jnp.asarray(d.text32), jnp.asarray(d.sec_table),
        minval, iL, iR, sigL, sigR, flo, fhi, rlo, rhi, usable, k=k, m=m,
        num_slots=d.num_slots, vb=vb, stage1=True)
    got = minidict2_probe(*tabs, tprep, k=k, m=m, num_slots=d.num_slots,
                          vb=vb, stage1=True)
    assert [t.dtype for t in got] == [torch.bool, torch.int32, torch.int32,
                                      torch.bool]
    for name, g, w in zip(("hit", "csid", "cnt", "need_sec"), got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(_np(g).view(w.dtype), w, err_msg=name)
    cnt, need, use = (np.asarray(want[2]), np.asarray(want[3]),
                      np.asarray(usable))
    # candidates past the budget, and need_sec on lanes that are not usable
    assert (cnt > vb).any() and (need & ~use).any()


@pytest.mark.parametrize("budget", STAGED, ids=str)
def test_staged_matches_jax(case, budget):
    k, m, d, _jprep, tprep, tabs, codes2, bad = case
    vb1, vb2, sc, ru = budget
    args = (jnp.asarray(d.slots), jnp.asarray(d.text32),
            jnp.asarray(d.sec_table), jnp.asarray(codes2), jnp.asarray(bad))
    kw = dict(width=W, k=k, m=m, num_slots=d.num_slots)
    want = [np.asarray(t) for t in J.lookup_minidict2_staged_packed(
        *args, **kw, vb1=vb1, vb2=vb2, sc=sc, RU=ru)]
    got = [_np(t) for t in minidict2_staged_probe(
        *tabs, tprep, k=k, m=m, num_slots=d.num_slots, vb1=vb1, vb2=vb2,
        sc=sc, RU=ru)]
    for name, g, w in zip(("hit", "csid", "ovf"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the contract against the one-pass probe at (vb2, sc)
    hit1, cs1, ovf1 = (_np(t) for t in minidict2_probe(
        *tabs, tprep, k=k, m=m, num_slots=d.num_slots, vb=vb2, sc=sc))
    hit, cs, ovf = got
    assert hit.any() and not (hit & ovf).any()
    ok = ~ovf  # decided: the one-pass probe decides it the same way
    assert not ovf1[ok].any()
    np.testing.assert_array_equal(hit[ok], hit1[ok])
    np.testing.assert_array_equal(cs[ok], cs1[ok])
    if ru <= 2:  # heavy reads past the B2 sub-batch (B // 8 = 6 rows)
        assert ovf.any()


def edge_batch(k, m, seed, B, Wk):
    """B reads of Wk + k - 1 bases cut from probe_inputs' genomes (the same
    seed), with up to two errors, the first all N when B > 1 (no usable
    window) -> (d, the JAX prep, the port's prep, the port's tables), each
    prep cut to Wk windows: a window's fields are its own k bases'."""
    rng = np.random.default_rng(seed)
    genomes = random_genomes(rng, num_colors=6, length=3000, mut=0.02, k=k)
    L = Wk + k - 1
    Wb = -(-L // 32) * 32
    chunk = np.full((B, Wb), 4, dtype=np.uint8)
    for b in range(B):
        g = genomes[rng.integers(0, len(genomes))][0]
        p = rng.integers(0, len(g) - L)
        r = K.seq_to_codes(g[p: p + L]).copy()
        ne = rng.integers(0, 3)
        if ne:
            pos = rng.choice(L, size=ne, replace=False)
            r[pos] = (r[pos] + rng.integers(1, 4, size=ne)) % 4
        chunk[b, :L] = r
    if B > 1:
        chunk[0] = 4
    codes2, bad = pack_reads_host(chunk)
    jprep = tuple(a[:, :Wk] for a in J._window_prep_from_words(
        *J.words_from_packed(jnp.asarray(codes2), jnp.asarray(bad)), Wb, k,
        m))
    tprep = tuple(t[:, :Wk].contiguous() for t in window_prep(
        torch.from_numpy(codes2), torch.from_numpy(bad), width=Wb, k=k, m=m))
    return jprep, tprep


def bit_words(mask):
    """(B, Wk) bool -> (B, ceil(Wk / 32)) uint32: window w at bit w % 32 of
    word w // 32, a warp's ballot over 32 windows (csrc/staged.cu and
    anchored.cu keep word c in lane c)."""
    mask = np.asarray(mask)
    B, Wk = mask.shape
    pad = np.zeros((B, -(-Wk // 32) * 32), dtype=bool)
    pad[:, :Wk] = mask
    return np.packbits(pad, axis=1, bitorder="little").view("<u4")


def bits_before(words, n):
    """The set bits of each row's words before each of its first n
    positions, (B, n): the exclusive prefix popcount of the words before
    its word (a warp scan) plus the popcount of its word below it."""
    counts = np.bitwise_count(words).astype(np.int64)
    pre = np.cumsum(counts, axis=1) - counts
    w = np.arange(n)
    below = ((np.uint64(1) << (w % 32).astype(np.uint64))
             - np.uint64(1)).astype(np.uint32)
    return pre[:, w // 32] + np.bitwise_count(words[:, w // 32] & below)


def word_bit(words, n):
    """Bit w of each row's words for w < n, (B, n) bool."""
    w = np.arange(n)
    return ((words[:, w // 32] >> (w % 32).astype(np.uint32)) & 1) == 1


def staged_model(tabs, tprep, *, k, m, num_slots, vb1, vb2, sc, RU):
    """csrc/staged.cu's index arithmetic in numpy around the plain K2:
    each read's undecided mask as words, a light read's ranks by prefix
    popcount; the heavy reads' bits as words over the batch, their ranks
    (hrank) as each word's prefix (hpre) plus a popcount, posH the first
    BH set bits in word order; the tiers' lanes gathered by those ranks and
    merged back. -> ((hit, csid, ovf), intermediates)."""
    B, Wk = tprep[0].shape
    RU, BH = min(RU, Wk), max(1, B // 8)
    kw = dict(k=k, m=m, num_slots=num_slots)
    hitA, valA, cnt, need = (t.numpy() for t in minidict2_probe(
        *tabs, tprep, vb=vb1, stage1=True, **kw))
    usable = tprep[-1].numpy()
    undec = usable & ~hitA & ((cnt > vb1) | need)
    uw = bit_words(undec)
    nU = np.bitwise_count(uw).astype(np.int64).sum(axis=1)
    heavy = nU > RU
    hw = bit_words(heavy[None, :])[0]
    hcnt = np.bitwise_count(hw).astype(np.int64)
    hpre = np.cumsum(hcnt) - hcnt
    hrank = bits_before(hw[None, :], B)[0]
    posH = np.zeros(BH, dtype=np.int64)
    for j, word in enumerate(hw):  # the gather blocks' walk of the words
        r = int(hpre[j])
        while word:
            if r < BH:
                posH[r] = j * 32 + (int(word) & -int(word)).bit_length() - 1
            word &= word - np.uint32(1)
            r += 1
    rank = bits_before(uw, Wk)
    lanes = [t.numpy() for t in probe_lanes(tprep)]
    # tier B1: a light read's r-th undecided window in lane r
    b1, w1 = np.nonzero(undec & ~heavy[:, None])
    posU = np.zeros((B, RU), dtype=np.int64)
    posU[b1, rank[b1, w1]] = w1
    validU = np.arange(RU)[None, :] < np.where(heavy, 0, nU)[:, None]
    lanesU = [np.take_along_axis(a, posU, axis=1) for a in lanes[:-1]]
    hitU, valU, ovfU = (t.numpy() for t in minidict2_probe(
        *tabs, prep_of_lanes([torch.from_numpy(a) for a in lanesU]
                             + [torch.from_numpy(validU)]),
        vb=vb2, sc=sc, **kw))
    # tier B2: the h-th heavy read in row h
    rowsH = [a[posH] for a in lanes[:-1]]
    useH = undec[posH] & (np.arange(BH) < hcnt.sum())[:, None]
    hitH, valH, ovfH = (t.numpy() for t in minidict2_probe(
        *tabs, prep_of_lanes([torch.from_numpy(a) for a in rowsH]
                             + [torch.from_numpy(useH)]),
        vb=vb2, sc=sc, **kw))
    # the merge: a window's tier from its bit, the read's heavy bit, hrank
    hit = hitA.copy()
    csid = valA.view(np.uint32).copy()
    ovf = np.zeros_like(hitA)
    light = undec & ~heavy[:, None]
    b, w = np.nonzero(light)
    j = rank[b, w]
    hit[b, w], ovf[b, w] = hitU[b, j], ovfU[b, j]
    csid[b, w] = valU.view(np.uint32)[b, j]
    b, w = np.nonzero(undec & (heavy & (hrank < BH))[:, None])
    h = hrank[b]
    hit[b, w], ovf[b, w] = hitH[h, w], ovfH[h, w]
    csid[b, w] = valH.view(np.uint32)[h, w]
    b, w = np.nonzero(undec & (heavy & (hrank >= BH))[:, None])
    hit[b, w], ovf[b, w] = False, True
    csid[~hit] = 0xFFFFFFFF
    return (hit, csid, ovf), dict(undec=undec, uw=uw, rank=rank, heavy=heavy,
                                  hw=hw, hpre=hpre, hrank=hrank, posH=posH)


EDGE_STAGED = [(7, 1, (2, 8, 4, 16)), (7, 33, (0, 8, 4, 1)),
               (7, 33, (2, 8, 4, 33)), (1, 130, (2, 8, 4, 16)),
               (7, 130, (0, 8, 4, 1))]


@pytest.mark.parametrize("shape", EDGE_STAGED, ids=str)
def test_staged_index_arithmetic(case, shape):
    """The split's, gather's and merge's index arithmetic (numpy,
    staged_model) against the plain version's cumulative-sum ranks, and
    composed around the plain K2 against fulgor_tpu's _probe_staged and the
    plain staged probe, at edge shapes: reads cut to Wk 1, 33 and 130, B 1
    and 7 (BH = 1), all heavy at RU = 1."""
    k, m, d = case[:3]
    B, Wk, (vb1, vb2, sc, ru) = shape
    jprep, tprep = edge_batch(k, m, 17, B, Wk)
    tabs = case[5]
    kw = dict(k=k, m=m, num_slots=d.num_slots)
    got, mid = staged_model(tabs, tprep, vb1=vb1, vb2=vb2, sc=sc, RU=ru,
                            **kw)
    undec, heavy = mid["undec"], mid["heavy"]
    np.testing.assert_array_equal(word_bit(mid["uw"], Wk), undec)
    light = undec & ~heavy[:, None]
    np.testing.assert_array_equal(  # the plain version's ur
        mid["rank"][light], (np.cumsum(light, axis=1) - 1)[light])
    np.testing.assert_array_equal(mid["hrank"][heavy],
                                  (np.cumsum(heavy) - 1)[heavy])
    hp = np.cumsum(heavy) - heavy
    np.testing.assert_array_equal(mid["hpre"], hp[::32])
    BH = max(1, B // 8)
    np.testing.assert_array_equal(mid["posH"], _first_positions(
        torch.from_numpy(heavy[None, :]), BH)[0].numpy())
    want = [np.asarray(t) for t in J._probe_staged(
        jnp.asarray(d.slots), jnp.asarray(d.text32),
        jnp.asarray(d.sec_table), jprep, k, m, d.num_slots, vb1, vb2, sc, ru)]
    plain = [_np(t) for t in minidict2_staged_probe(
        *tabs, tprep, vb1=vb1, vb2=vb2, sc=sc, RU=ru, **kw)]
    for name, g, p, w in zip(("hit", "csid", "ovf"), got, plain, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(p, w, err_msg=name)
    if ru == 1 and B > 1:  # every read with two undecided windows heavy,
        assert heavy[1:].all() and got[2].any()  # past BH = 1


@pytest.fixture(scope="module")
def default_refs(corpus):  # noqa: F811
    """The default one-pass output of every tool on the corpus: FI, the
    records of fulgor_tpu's default file (corpus's); TU(0.8) and
    kmer-conservation, the port's one-pass files, which
    tests/test_torch_union_engine.py and tests/test_torch_runs_engine.py
    hold equal to fulgor_tpu's on the same reads (kmer-conservation there
    with one short read more). Both are made here on the CPU, without a
    second set of fulgor_tpu runs: their compiles would more than double
    this module's cost in the parallel test run."""
    tmp, qfile, refs, _n = corpus
    tu = str(tmp / "default_tu.tsv")
    kc = str(tmp / "default.kc")
    for cmd, out in ((["pseudoalign", "-r", str(TAU)], tu),
                     (["kmer-conservation"], kc)):
        assert tcli.main(cmd + ["-i", str(tmp / "tidx.tfur"), "-q", qfile,
                                "-o", out, "--batch-size", "256",
                                "--device", "cpu"]) == 0
    return {"fi": refs["ascii"], "tu": _records(tu, "ascii"),
            "kc": open(kc, "rb").read()}


@pytest.mark.parametrize("tool", ["fi", "tu", "kc"])
@pytest.mark.parametrize("budget", ENGINE_BUDGETS)
def test_cli_under_staged_budget(corpus, default_refs, tmp_path, monkeypatch,
                                 budget, tool):
    tmp, qfile, _refs, _n = corpus
    monkeypatch.setenv("FULGOR_PROBE_BUDGET", budget)
    calls = []

    def staged(*a, **kw):
        calls.append(kw["RU"])
        return minidict2_staged_probe(*a, **kw)

    monkeypatch.setattr(TP, "minidict2_staged_probe", staged)
    out = str(tmp_path / "out")
    cmd = {"fi": ["pseudoalign"], "tu": ["pseudoalign", "-r", str(TAU)],
           "kc": ["kmer-conservation"]}[tool]
    assert tcli.main(cmd + ["-i", str(tmp / "tidx.tfur"), "-q", qfile, "-o",
                            out, "--batch-size", "256", "--device",
                            "cpu"]) == 0
    if tool == "kc":
        assert open(out, "rb").read() == default_refs["kc"]
    else:
        assert _records(out, "ascii") == default_refs[tool]
    assert calls and set(calls) == {int(budget.split(",")[-1])}


def test_four_value_budget_selects_staged(corpus, monkeypatch):
    tmp = corpus[0]
    monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,8,4,1")
    monkeypatch.setenv("FULGOR_PROBE_BUDGET_REDO", "6,3")
    eng = E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), batch_size=256,
                        device="cpu")
    assert eng._pb == (1, 8, 4, 1) and eng._pb_redo == (6, 3)
    monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,8,4")
    with pytest.raises(ValueError, match="vb1,vb2,sc,RU"):
        E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), device="cpu")


@pytest.mark.parametrize("tool", ["fi", "tu", "kc"])
def test_cli_under_anchored_probe(corpus, default_refs, tmp_path,
                                  monkeypatch, tool):
    tmp, qfile, _refs, _n = corpus
    monkeypatch.setattr(TP, "ANCHORED_PROBE", True)
    calls = []

    def anchored(*a, **kw):
        calls.append(a[3][0].shape)
        return A.minidict2_anchored_probe(*a, **kw)

    monkeypatch.setattr(TP, "minidict2_anchored_probe", anchored)
    out = str(tmp_path / "out")
    cmd = {"fi": ["pseudoalign"], "tu": ["pseudoalign", "-r", str(TAU)],
           "kc": ["kmer-conservation"]}[tool]
    assert tcli.main(cmd + ["-i", str(tmp / "tidx.tfur"), "-q", qfile, "-o",
                            out, "--batch-size", "256", "--device",
                            "cpu"]) == 0
    if tool == "kc":
        assert open(out, "rb").read() == default_refs["kc"]
    else:
        assert _records(out, "ascii") == default_refs[tool]
    assert calls


def test_tight_anchored_redo_runs_anchored(corpus, default_refs, tmp_path,
                                           monkeypatch):
    """Lane budgets of (2, 1) leave many reads in overflow. The deferred
    redo probes them anchored again, whatever its (8, 4) budget says, so
    most stay in overflow and take the exact host mirror (a one-pass redo
    would decide them on the device, leaving only the read longer than
    the stream ladder to the host). The output is unchanged."""
    tmp, qfile, _refs, _n = corpus
    monkeypatch.setattr(TP, "ANCHORED_PROBE", True)
    monkeypatch.setattr(A, "anchor_budget", lambda Wk, k, m: 2)
    monkeypatch.setattr(A, "reprobe_budget", lambda Wk, k, m: 1)
    eng = E.QueryEngine(TIndex.load(str(tmp / "tidx.tfur")), batch_size=256,
                        device="cpu")
    assert eng._pb_redo == E.REDO_BUDGET
    out = str(tmp_path / "out")
    stats = eng.pseudoalign_file(qfile, out)
    assert _records(out, "ascii") == default_refs["fi"]
    assert stats["num_redo"] > 4 and stats["num_redo_host"] > 1
