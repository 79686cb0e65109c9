"""The mesh query path on the CPU (plain versions of the kernels), tolerance 0
everywhere, on one small index (70 colours, k = 13, m = 9, as
tests/test_mesh.py) and a batch of 256 reads of 48 bp at width 64, the
shape of the engines' dispatches, so that fulgor_tpu compiles its (4, 2)
steps once for both (through its persistent compile cache):

- K12's plain versions against fulgor_tpu's threshold_union_scores_runs on
  the same runs (K6's int16 lengths and fulgor_tpu's int32 counts, the
  runs also shuffled among INVALID slots), the mask against those scores
  thresholded; K13's plain version against _pack_hits and the u16
  narrowing; query_conservation_packed against fulgor_tpu's;
- the colour steps (full intersection, threshold union, kmer-matches) on
  grids of CPU cells (4, 2), (2, 4) and (1, 1) against fulgor_tpu's
  builders on the virtual 8-device CPU mesh of the same layout: ovf equal,
  the rest equal on every read without overflow; the kmer-matches step
  with pack_hits made to raise (its hit words come from K6's call);
- the data-parallel and unpacked steps against the port's own one-device
  steps;
- the engine on a (4, 2) grid: FI and TU(0.8) against fulgor_tpu's meshed
  engine (sorted lines), --deduplicate, kmer-conservation and kmer-matches
  against the port's one-device engine byte for byte, the TU and
  kmer-matches redo pools and the array API's FI and TU against the
  one-device engine's with no whole dense matrix on any device; a (3, 2)
  grid rounds its batch up to the cell count;
- make_mesh without a card raises.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

from fulgor_tpu.build.builder import build_index
from fulgor_tpu.core import kmers as K
from fulgor_tpu.ops import intersect as J
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu.parallel import mesh as JM
from fulgor_tpu.query.engine import QueryEngine as JEngine
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import pipeline as TP
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.ops.intersect import (
    compact_runs_plain, pack_hits_plain, runs_mask_plain, runs_scores_plain,
)
from fulgor_tpu_torch.parallel import mesh as M
from fulgor_tpu_torch.query.engine import QueryEngine
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_threads import one_thread  # noqa: F401

K_LEN, M_LEN, READ_LEN, WIDTH, BATCH = 13, 9, 48, 64, 256
WK = WIDTH - K_LEN + 1
LAYOUTS = [(4, 2), (2, 4), (1, 1)]
TAU = 0.8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The index (fulgor_tpu's build, loaded by both packages), a batch of
    256 reads of 48 bp at width 64 (240 from the genomes, 16 all-N) and a
    read file of 100 reads of 50 bp for the engines."""
    rng = np.random.default_rng(5)
    tmp = tmp_path_factory.mktemp("torch_mesh")
    genomes = random_genomes(rng, num_colors=70, length=900, mut=0.05,
                             k=K_LEN)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa")
        write_fasta(p, seqs)
        paths.append(p)
    jidx = build_index(paths, k=K_LEN, m=M_LEN)
    jidx.save(str(tmp / "idx.tfur"))
    tidx = TIndex.load(str(tmp / "idx.tfur"))
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    for i in range(BATCH - 16):
        s = genomes[rng.integers(0, len(genomes))][0]
        p = rng.integers(0, len(s) - READ_LEN)
        chunk[i, :READ_LEN] = K.seq_to_codes(s[p: p + READ_LEN])
    qfile = str(tmp / "reads.fq.gz")
    with gzip.open(qfile, "wt") as f:
        for i in range(100):
            s = genomes[rng.integers(0, len(genomes))][0]
            p = rng.integers(0, len(s) - 50)
            f.write(f"@r{i}\n{s[p: p + 50]}\n+\n{'I' * 50}\n")
    return tmp, jidx, tidx, chunk, qfile


def _inputs(tidx, chunk):
    """(numpy table, dparams, codes2, bad, port table tensors, dense)."""
    table_np, dparams = tidx.device_dict()
    codes2, bad = pack_reads_host(chunk)
    tabs = tidx.device_tables("cpu")
    return (table_np, dparams, codes2, bad,
            (tabs["slots"], tabs["text32"], tabs["skew"]),
            tidx.device_dense("cpu"))


def _probe(tidx, chunk):
    """The port's one-device probe of the reads -> (hit, csid, ovf)."""
    _tn, dparams, codes2, bad, table, _d = _inputs(tidx, chunk)
    return TP.query_window_csids_packed(
        table, torch.from_numpy(codes2), torch.from_numpy(bad), k=K_LEN,
        width=WIDTH, dparams=dparams)


def _pack_bool(mask):
    return np.asarray(J.pack_bool_bits(jnp.asarray(np.pad(
        mask, ((0, 0), (0, (-mask.shape[1]) % 32)))))).view(np.int32)


# ---------------------------------------------------------------- K12, K13


@pytest.mark.parametrize("counts", ["k6_int16", "reference_int32",
                                    "shuffled"])
def test_runs_scores_plain_matches_reference(setup, counts):
    """runs_scores_plain against threshold_union_scores_runs on the same
    runs, cast to int; runs_mask_plain against those scores thresholded at
    tau 0.01, 0.8 and 1.0 (pad colours 0), on the full dense and on the two
    halves of a 2-shard split."""
    _tmp, _jidx, tidx, chunk, _q = setup
    hit, csid, _ovf = _probe(tidx, chunk)
    if counts == "reference_int32":
        rc, cnt, _rovf = J.compact_runs(jnp.asarray(hit.numpy()), jnp.asarray(
            csid.numpy().view(np.uint32)), WK)
        rc = torch.from_numpy(np.array(rc).view(np.int32))
        cnt = torch.from_numpy(np.asarray(cnt).astype(np.int32))
    else:
        rc, _start, cnt, _total, _npos = compact_runs_plain(hit, csid, WK)
    if counts == "shuffled":  # valid runs among INVALID slots
        perm = torch.from_numpy(np.random.default_rng(1).permutation(WK))
        rc, cnt = rc[:, perm].contiguous(), cnt[:, perm].contiguous()
    assert int((rc != -1).sum()) > 64
    npos = hit.sum(dim=1, dtype=torch.int32)
    dense = M.pad_bits_for_mesh(tidx.dense_color_bits(), 2)
    C = tidx.num_colors
    w = dense.shape[1] // 2
    for lo, hi in ((0, dense.shape[1]), (0, w), (w, 2 * w)):
        d_np = np.ascontiguousarray(dense[:, lo:hi])
        d_t = torch.from_numpy(d_np.view(np.int32))
        ncol = max(0, min(32 * (hi - lo), C - 32 * lo))
        want = np.asarray(J.threshold_union_scores_runs(
            jnp.asarray(d_np), jnp.asarray(rc.numpy().view(np.uint32)),
            jnp.asarray(cnt.numpy().astype(np.int32)), 32 * (hi - lo)))
        got = runs_scores_plain(d_t, rc, cnt, 32 * (hi - lo))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        for tau in (0.01, TAU, 1.0):
            tab = (np.arange(WK + 1, dtype=np.float64) * tau).astype(np.int32)
            mask = ((want >= tab[npos.numpy()][:, None])
                    & (npos.numpy() > 0)[:, None])
            mask[:, ncol:] = False
            got = runs_mask_plain(d_t, rc, cnt, npos, torch.from_numpy(tab),
                                  ncol)
            np.testing.assert_array_equal(got.numpy(), _pack_bool(mask))


@pytest.mark.parametrize("narrow", [False, True])
def test_pack_hits_plain_matches_reference(setup, narrow):
    """pack_hits_plain against _pack_hits (Wk = 36: a ragged last word) and
    query_conservation_packed's u16 narrowing."""
    _tmp, _jidx, tidx, chunk, _q = setup
    hit, csid, _ovf = _probe(tidx, chunk)
    hitw, csid16 = pack_hits_plain(hit, csid if narrow else None)
    want = np.asarray(JP._pack_hits(jnp.asarray(hit.numpy())))
    np.testing.assert_array_equal(hitw.numpy().view(np.uint32), want)
    if narrow:
        cs = csid.numpy().view(np.uint32)
        want16 = np.where(hit.numpy(), cs, np.uint32(0xFFFF)).astype(np.uint16)
        np.testing.assert_array_equal(csid16.numpy().view(np.uint16), want16)
    else:
        assert csid16 is None


@pytest.fixture(scope="module")
def conservation_ref(setup):
    """fulgor_tpu's query_conservation_packed with small_csid (one
    compile): its hit words and ovf do not depend on the narrowing."""
    _tmp, _jidx, tidx, chunk, _q = setup
    table_np, dparams, codes2, bad, _t, _d = _inputs(tidx, chunk)
    return [np.asarray(a) for a in JP.query_conservation_packed(
        tuple(jnp.asarray(a) for a in table_np), jnp.asarray(codes2),
        jnp.asarray(bad), k=K_LEN, width=WIDTH, small_csid=True,
        dparams=dparams)]


@pytest.mark.parametrize("small_csid", [False, True])
def test_query_conservation_packed_matches_reference(setup, conservation_ref,
                                                     small_csid):
    """The port's step against fulgor_tpu's: hit words, u16 csids and ovf;
    without small_csid the csids are the probe's own, unnarrowed."""
    _tmp, _jidx, tidx, chunk, _q = setup
    _tn, dparams, codes2, bad, table, _d = _inputs(tidx, chunk)
    got = TP.query_conservation_packed(
        table, torch.from_numpy(codes2), torch.from_numpy(bad), k=K_LEN,
        width=WIDTH, small_csid=small_csid, dparams=dparams)
    hitw, csid16, ovf = conservation_ref
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), hitw)
    np.testing.assert_array_equal(got[2].numpy(), ovf)
    if small_csid:
        assert got[1].dtype == torch.int16
        np.testing.assert_array_equal(got[1].numpy().view(np.uint16), csid16)
    else:
        hit, csid, _ovf = _probe(tidx, chunk)
        np.testing.assert_array_equal(got[1].numpy(), csid.numpy())
        narrow = np.where(hit.numpy(), csid.numpy().view(np.uint32) & 0xFFFF,
                          0xFFFF).astype(np.uint16)
        np.testing.assert_array_equal(narrow, csid16)


# ---------------------------------------------------------------- colour steps


def _grids(layout):
    """(fulgor_tpu's mesh, the port's grid of CPU cells) of one layout."""
    D, P = layout
    return (JM.make_mesh(jax.devices()[: D * P], data=D, color=P),
            M.make_mesh(["cpu"] * (D * P), data=D, color=P))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("tool", ["fi", "tu", "km"])
def test_colour_steps_match_reference(setup, tool, layout):
    """The port's sharded FI, TU and kmer-matches steps against fulgor_tpu's
    builders on the same layout: ovf equal; the result rows (FI), the mask
    against the f32 scores thresholded at tau 0.8 and npos (TU), the hit
    words and u16 scores (kmer-matches) equal on every read without
    overflow. Rows are compared in read order: a gather out of cell order
    would permute them."""
    _tmp, _jidx, tidx, chunk, _q = setup
    table_np, dparams, codes2, bad, _t, _d = _inputs(tidx, chunk)
    jmesh, tmesh = _grids(layout)
    P = layout[1]
    bits = M.pad_bits_for_mesh(tidx.dense_color_bits(), P)
    Cpad = bits.shape[1] * 32
    # placed as fulgor_tpu's meshed engine places them (engine.py:214-215,
    # 356-358), so that its (4, 2) steps compile to the same programs
    jtable = tuple(jax.device_put(a, NamedSharding(jmesh, PS()))
                   for a in table_np)
    jbits = jax.device_put(bits, NamedSharding(jmesh, PS(None, "color")))
    jc2, jbd = JM.place_packed(jmesh, codes2, bad)
    ttable = M.place_table(tmesh, table_np)
    tbits = M.place_bits(tmesh, bits)
    tc2, tbd = M.place_packed(tmesh, codes2, bad)
    if tool == "fi":
        want = JM.make_sharded_full_intersection_packed(
            jmesh, K_LEN, WIDTH, WK, dparams=dparams)(jtable, jbits, jc2, jbd)
        got = M.make_sharded_full_intersection_packed(
            tmesh, K_LEN, WIDTH, WK, dparams=dparams)(ttable, tbits, tc2, tbd)
        pairs = [(got[0], np.asarray(want[0]).view(np.int32)),
                 (got[1], np.asarray(want[1]))]
    elif tool == "tu":
        want = JM.make_sharded_threshold_union_packed(
            jmesh, K_LEN, WIDTH, Cpad, WK, dparams=dparams)(
                jtable, jbits, jc2, jbd)
        tab = (np.arange(WK + 1, dtype=np.float64) * TAU).astype(np.int32)
        C = tidx.num_colors
        got = M.make_sharded_threshold_union_packed(
            tmesh, K_LEN, WIDTH, Cpad, WK, dparams=dparams, num_colors=C)(
                ttable, tbits, tc2, tbd,
                M.place_replicated(tmesh, torch.from_numpy(tab)))
        scores, npos = np.asarray(want[0]), np.asarray(want[1])
        mask = (scores >= tab[npos][:, None]) & (npos > 0)[:, None]
        mask[:, C:] = False  # the pad colours stay clear
        pairs = [(got[0], _pack_bool(mask)), (got[1], npos)]
    else:
        want = JM.make_sharded_kmer_matches(
            jmesh, K_LEN, WIDTH, Cpad, WK, dparams=dparams)(
                jtable, jbits, jc2, jbd)
        got = M.make_sharded_kmer_matches(
            tmesh, K_LEN, WIDTH, Cpad, WK, dparams=dparams)(
                ttable, tbits, tc2, tbd)
        pairs = [(got[0], np.asarray(want[0]).view(np.int32)),
                 (got[1], np.asarray(want[1]).view(np.int16))]
    ovf, want_ovf = got[2].numpy(), np.asarray(want[2])
    np.testing.assert_array_equal(ovf, want_ovf)
    assert ovf.mean() < 0.25
    keep = ~ovf
    for g, w in pairs:
        g = g.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[keep], w[keep])


def test_kmer_matches_step_takes_k6_hit_words(setup, monkeypatch):
    """The port's kmer-matches step on a (4, 2) grid calls no pack_hits
    (K13): each cell's hit words come from its compact_runs call (K6's
    hit-word instance on a card). pack_hits made to raise; hit words,
    scores and ovf still equal fulgor_tpu's step on every read without
    overflow."""
    _tmp, _jidx, tidx, chunk, _q = setup
    import fulgor_tpu_torch.ops.intersect as TI

    def refuse(*_a, **_k):
        raise AssertionError("the kmer-matches step called pack_hits")

    for mod in (TI, TP, M):
        monkeypatch.setattr(mod, "pack_hits", refuse, raising=False)
    asked = []

    def spy(hit, csid, R, hit_words=False):
        asked.append(hit_words)
        return TI.compact_runs(hit, csid, R, hit_words)

    monkeypatch.setattr(M, "compact_runs", spy)
    table_np, dparams, codes2, bad, _t, _d = _inputs(tidx, chunk)
    layout = (4, 2)
    jmesh, tmesh = _grids(layout)
    bits = M.pad_bits_for_mesh(tidx.dense_color_bits(), layout[1])
    Cpad = bits.shape[1] * 32
    jtable = tuple(jax.device_put(a, NamedSharding(jmesh, PS()))
                   for a in table_np)
    jbits = jax.device_put(bits, NamedSharding(jmesh, PS(None, "color")))
    jc2, jbd = JM.place_packed(jmesh, codes2, bad)
    want = JM.make_sharded_kmer_matches(
        jmesh, K_LEN, WIDTH, Cpad, WK, dparams=dparams)(
            jtable, jbits, jc2, jbd)
    got = M.make_sharded_kmer_matches(
        tmesh, K_LEN, WIDTH, Cpad, WK, dparams=dparams)(
            M.place_table(tmesh, table_np), M.place_bits(tmesh, bits),
            *M.place_packed(tmesh, codes2, bad))
    assert asked == [True] * tmesh.size
    ovf = got[2].numpy()
    np.testing.assert_array_equal(ovf, np.asarray(want[2]))
    keep = ~ovf
    assert keep.mean() > 0.75
    for g, w in ((got[0], np.asarray(want[0]).view(np.int32)),
                 (got[1], np.asarray(want[1]).view(np.int16))):
        g = g.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[keep], w[keep])


@pytest.mark.parametrize("step", ["conservation", "distinct", "runs_tu",
                                  "fi_unpacked", "tu_unpacked"])
def test_data_parallel_and_unpacked_steps_match_one_device(setup, step):
    """The data-parallel steps and the unpacked colour steps on a (4, 2)
    grid against the port's one-device steps (held against fulgor_tpu in
    their own tests): the data-parallel outputs equal row for row; the
    unpacked ones equal the packed sharded step's outputs."""
    _tmp, _jidx, tidx, chunk, _q = setup
    table_np, dparams, codes2, bad, table, _d = _inputs(tidx, chunk)
    mesh = M.make_mesh(["cpu"] * 8, data=4, color=2)
    ttable = M.place_table(mesh, table_np)
    tc2, tbd = M.place_packed(mesh, codes2, bad)
    kw = dict(k=K_LEN, width=WIDTH, R=6, dparams=dparams)
    if step in ("conservation", "distinct", "runs_tu"):
        make, one = {
            "conservation": (M.make_sharded_conservation_runs,
                             TP.query_conservation_runs_packed),
            "distinct": (M.make_sharded_distinct_runs,
                         TP.query_distinct_runs_packed),
            "runs_tu": (M.make_sharded_runs_tu, TP.query_runs_tu_packed),
        }[step]
        got = make(mesh, K_LEN, WIDTH, 6, dparams=dparams)(ttable, tc2, tbd)
        want = one(table, torch.from_numpy(codes2), torch.from_numpy(bad),
                   **kw)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        return
    bits = M.pad_bits_for_mesh(tidx.dense_color_bits(), 2)
    ttable, tbits, codes = M.shard_inputs(mesh, table_np, bits,
                                          chunk[:, :READ_LEN])
    if step == "fi_unpacked":
        got = M.make_sharded_full_intersection(mesh, K_LEN, WK, dparams)(
            ttable, tbits, codes)
        want = M.make_sharded_full_intersection_packed(
            mesh, K_LEN, WIDTH, WK, dparams)(ttable, tbits, tc2, tbd)
    else:
        ms = M.place_replicated(mesh, (torch.arange(WK + 1) * 4) // 5)
        ms = {d: t.to(torch.int32) for d, t in ms.items()}
        C = tidx.num_colors
        got = M.make_sharded_threshold_union(
            mesh, K_LEN, 32 * bits.shape[1], WK, dparams, num_colors=C)(
                ttable, tbits, codes, ms)
        want = M.make_sharded_threshold_union_packed(
            mesh, K_LEN, WIDTH, 32 * bits.shape[1], WK, dparams,
            num_colors=C)(ttable, tbits, tc2, tbd, ms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ---------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engines(setup):
    """The port's one-device engine and its engine on a (4, 2) grid of CPU
    cells, and fulgor_tpu's meshed engine, over the same index."""
    _tmp, jidx, tidx, _chunk, _q = setup
    mesh = M.make_mesh(["cpu"] * 8, data=4, color=2)
    return (QueryEngine(tidx, batch_size=64, device="cpu"),
            QueryEngine(tidx, batch_size=64, device="cpu", mesh=mesh),
            JEngine(jidx, batch_size=64, use_mesh=True))


@pytest.mark.parametrize("tool", ["fi", "tu"])
def test_engine_mesh_matches_reference_mesh(setup, engines, tool):
    """FI and TU(0.8) of the port's meshed engine against fulgor_tpu's
    QueryEngine(use_mesh=True), lines sorted (the overflow stragglers
    differ between probe budgets)."""
    tmp, _jidx, _tidx, _chunk, qfile = setup
    _single, meshed, jeng = engines
    kw = {} if tool == "fi" else {"threshold": TAU}
    got, want = str(tmp / f"m_{tool}.tsv"), str(tmp / f"j_{tool}.tsv")
    meshed.pseudoalign_file(qfile, got, **kw)
    jeng.pseudoalign_file(qfile, want, **kw)
    lines = sorted(open(got, "rb").read().splitlines())
    assert len(lines) == 100
    assert lines == sorted(open(want, "rb").read().splitlines())


@pytest.mark.parametrize("tool", ["dedup", "kc", "km"])
def test_engine_mesh_matches_one_device(setup, engines, tool):
    """--deduplicate, kmer-conservation and kmer-matches of the meshed
    engine against the port's one-device engine, byte for byte."""
    tmp, _jidx, _tidx, _chunk, qfile = setup
    single, meshed, _j = engines
    method, kw = {"dedup": ("pseudoalign_file", {"deduplicate": True}),
                  "kc": ("kmer_conservation_file", {}),
                  "km": ("kmer_matches_file", {})}[tool]
    outs = []
    for tag, eng in (("s", single), ("m", meshed)):
        out = str(tmp / f"{tag}1_{tool}.tsv")
        getattr(eng, method)(qfile, out, **kw)
        outs.append(open(out, "rb").read())
    assert outs[0] and outs[0] == outs[1]


@pytest.mark.parametrize("tool", ["tu", "km"])
def test_mesh_redo_runs_on_colour_shards(setup, engines, tool):
    """The TU and kmer-matches redo pools of the meshed engine run its own
    colour steps at the redo budget and decide each read as the one-device
    redo (K4, K5 on the whole matrix) does; no device of the mesh holds
    the whole dense matrix, and `bits` refuses under a mesh."""
    _tmp, _jidx, _tidx, chunk, _q = setup
    single, meshed, _j = engines
    rows = [chunk[i, :READ_LEN] for i in range(0, BATCH, 6)]
    got = []
    for eng in (single, meshed):
        before = eng.redo_batches
        got.append(eng._device_tu_resolve(
            rows, eng._device_tu_dispatch(rows, TAU)) if tool == "tu"
            else eng._device_km_resolve(rows, eng._device_km_dispatch(rows)))
        assert eng.redo_batches == before + 1
    assert sum(g is not None for g in got[0]) > len(rows) // 2
    for g, w in zip(got[1], got[0]):
        assert (g is None) == (w is None)
        if w is not None:
            for a, b in ([(g, w)] if tool == "tu" else zip(g, w)):
                np.testing.assert_array_equal(a, b)
    assert meshed._bits is None
    with pytest.raises(RuntimeError, match="colour shards"):
        meshed.bits


@pytest.mark.parametrize("tool", ["fi", "tu"])
def test_mesh_array_api_matches_one_device(setup, engines, tool):
    """pseudoalign_codes of the meshed engine (its FI and TU steps on the
    colour shards) against the one-device engine's, read for read."""
    _tmp, _jidx, _tidx, chunk, _q = setup
    single, meshed, _j = engines
    codes = chunk[:, :READ_LEN]
    lens = np.full(BATCH, READ_LEN)
    kw = {} if tool == "fi" else {"threshold": TAU}
    want = single.pseudoalign_codes(codes, lens, **kw)
    got = meshed.pseudoalign_codes(codes, lens, **kw)
    assert sum(len(w) > 0 for w in want) > BATCH // 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert meshed._bits is None


def test_mesh_batch_rounds_up_to_the_cells(setup, engines):
    """A (3, 2) grid takes batch 64 up to 66 and its 256-read dispatches up
    to 258, as fulgor_tpu rounds its batch (engine.py:222-223); FI equals
    the one-device engine's file byte for byte."""
    tmp, _jidx, tidx, _chunk, qfile = setup
    eng = QueryEngine(tidx, batch_size=64, device="cpu",
                      mesh=M.make_mesh(["cpu"] * 6, data=3, color=2))
    assert eng.batch == 66 and eng._batch_for_width(WIDTH) == 258
    outs = []
    for tag, e in (("s", engines[0]), ("m", eng)):
        out = str(tmp / f"{tag}32_fi.tsv")
        e.pseudoalign_file(qfile, out)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_make_mesh_without_a_card_raises(setup, monkeypatch):
    """make_mesh() with no card visible and no devices given raises, and so
    does QueryEngine(use_mesh=True); a grid whose shape does not match its
    devices is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(setup[2], device="cpu", use_mesh=True)
    with pytest.raises(ValueError):
        M.Mesh(["cpu"] * 5, data=2, color=2)
    assert M.make_mesh(["cpu"] * 6).shape == {"data": 3, "color": 2}
    assert M.make_mesh(["cpu"] * 3).shape == {"data": 3, "color": 1}
