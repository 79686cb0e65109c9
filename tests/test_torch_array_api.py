"""The array API on the CPU (plain versions of the kernels), against
fulgor_tpu, bit-exact (tolerance 0), on a mini and a cuckoo index of the
same genomes (tests/test_ops.py's corpus):

- pack_codes (kernel K8's plain version) against fulgor_tpu's
  _device_pack_codes at L = 1, 15, 17, 31, 33, 64, 160 and 1,024, codes
  up to 255, and its bytes against the host packer's at L % 32 == 0;
- the unpacked steps query_window_csids, query_full_intersection and
  query_threshold_union, and the packed query_threshold_union_packed,
  against fulgor_tpu's on both backends;
- QueryEngine.pseudoalign_codes (FI and TU), pseudoalign_codes_dedup and
  window_csids_codes against fulgor_tpu's QueryEngine(use_mesh=False) read
  by read, reads over 1,024 bases included (the port's widths stop at
  1,024: such reads take the exact host path), and the cuckoo engine's
  results equal to the mini engine's (tests/test_minidict2.py:232-257).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.build.builder import build_index
from fulgor_tpu.ops import pipeline as JP
from fulgor_tpu.ops.minidict2 import _device_pack_codes
from fulgor_tpu.query.engine import QueryEngine as JEngine
from fulgor_tpu_torch.core import kmers as K
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops import pipeline as TP
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.ops.prep import pack_codes
from fulgor_tpu_torch.query import engine as E
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_threads import one_thread  # noqa: F401

K_LEN, M_LEN, L = 15, 9, 60
LONG = 1100  # over the port's 1,024-base cap
KINDS = ["mini", "cuckoo"]
APIS = ["fi", "tu", "dedup", "csids"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """kind -> (fulgor_tpu's Index, the port's Index loaded from its file);
    and (codes (N, LONG) uint8, lens) of 80 reads of 60 bases (errors and
    Ns), 12 random reads, a read shorter than k and two of 1,100 bases."""
    rng = np.random.default_rng(7)
    tmp = tmp_path_factory.mktemp("array_api")
    genomes = random_genomes(rng, num_colors=6, length=2000, mut=0.03,
                             k=K_LEN)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa")
        write_fasta(p, seqs)
        paths.append(p)
    idx = {}
    for kind in KINDS:
        j = build_index(paths, k=K_LEN, m=M_LEN, dict_kind=kind)
        j.save(str(tmp / f"{kind}.tfur"))
        idx[kind] = (j, TIndex.load(str(tmp / f"{kind}.tfur")))
    reads = []
    for _ in range(80):
        s = genomes[rng.integers(0, len(genomes))][0]
        p = rng.integers(0, len(s) - L)
        r = K.seq_to_codes(s[p: p + L]).copy()
        for _ in range(rng.poisson(1.0)):
            r[rng.integers(0, L)] = rng.integers(0, 5)
        reads.append(r)
    reads += [rng.integers(0, 4, size=L).astype(np.uint8) for _ in range(12)]
    reads.insert(30, K.seq_to_codes("ACGTACGTAC"))
    for g in (1, 4):
        reads.insert(10 * g, K.seq_to_codes(genomes[g][0][:LONG]))
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    codes = np.full((len(reads), LONG), 4, dtype=np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    return idx, codes, lens


@pytest.mark.parametrize("Lc", [1, 15, 17, 31, 33, 64, 160, 1024])
def test_pack_codes_matches_jax(Lc):
    rng = np.random.default_rng(Lc)
    codes = rng.integers(0, 4, size=(40, Lc)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.05] = 4
    codes[3, 7 % Lc], codes[4, 9 % Lc] = 5, 255  # any code above 3 is bad
    high = rng.random(codes.shape) < 0.05
    codes[high] = rng.integers(5, 256, size=int(high.sum()))
    words, badw = pack_codes(torch.from_numpy(codes))
    jw, jb = _device_pack_codes(jnp.asarray(codes))
    assert words.dtype == badw.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(badw.numpy().view(np.uint32), np.asarray(jb))
    if Lc % 32 == 0:  # the wire format of the stream's host packer
        codes2, bad = pack_reads_host(codes)
        np.testing.assert_array_equal(words.view(torch.uint8).numpy(), codes2)
        np.testing.assert_array_equal(badw.view(torch.uint8).numpy(), bad)


def _tables(j, t):
    """(fulgor_tpu table, dparams), (port table) of one backend."""
    table_np, dparams = j.device_dict()
    tabs = t.device_tables("cpu")
    if dparams is None:
        return jnp.asarray(table_np), dparams, tabs["table"]
    return (tuple(jnp.asarray(a) for a in table_np), dparams,
            (tabs["slots"], tabs["text32"], tabs["skew"]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", ["csids", "fi", "tu", "tu_packed"])
def test_unpacked_steps_match_reference(corpus, kind, step):
    """The steps on a (256, 64) batch of the corpus's reads, at the default
    probe budget, as the array API calls them."""
    idx, codes, lens = corpus
    j, t = idx[kind]
    jt, dparams, tt = _tables(j, t)
    chunk = np.full((256, 64), 4, dtype=np.uint8)
    fit = np.flatnonzero(lens <= 64)
    chunk[: len(fit)] = codes[fit, :64]
    jd, td = jnp.asarray(j.dense_color_bits()), t.device_dense("cpu")
    C = j.num_colors
    kw = dict(k=K_LEN, dparams=dparams)
    if step == "csids":
        want = JP.query_window_csids(jt, jnp.asarray(chunk), **kw)
        got = TP.query_window_csids(tt, torch.from_numpy(chunk), **kw)
    elif step == "fi":
        want = JP.query_full_intersection(jt, jd, jnp.asarray(chunk), **kw)
        got = TP.query_full_intersection(tt, td, torch.from_numpy(chunk), **kw)
    elif step == "tu":
        want = JP.query_threshold_union(jt, jd, jnp.asarray(chunk),
                                        num_colors=C, **kw)
        got = TP.query_threshold_union(tt, td, torch.from_numpy(chunk),
                                       num_colors=C, **kw)
        # fulgor_tpu's scores are f32 counts, the port's u16 as int16
        want = (np.asarray(want[0]).astype(np.uint16),) + tuple(want[1:])
    else:
        codes2, bad = pack_reads_host(chunk)
        want = JP.query_threshold_union_packed(
            jt, jd, jnp.asarray(codes2), jnp.asarray(bad), width=64,
            num_colors=C, **kw)
        got = TP.query_threshold_union_packed(
            tt, td, torch.from_numpy(codes2), torch.from_numpy(bad), width=64,
            num_colors=C, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    assert got[0].numpy().any()


def _api(eng, api, codes, lens):
    if api == "fi":
        return eng.pseudoalign_codes(codes, lens)
    if api == "tu":
        return eng.pseudoalign_codes(codes, lens, threshold=0.8)
    if api == "dedup":
        return eng.pseudoalign_codes_dedup(codes, lens)
    return eng.window_csids_codes(codes, lens)


def _same(api, got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if api == "csids":
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[1].dtype == np.uint32
        else:
            assert g.dtype == np.uint32
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def port_results(corpus):
    """kind -> api -> the port's results (engines on the CPU)."""
    idx, codes, lens = corpus
    out = {}
    for kind in KINDS:
        eng = E.QueryEngine(idx[kind][1], batch_size=32, device="cpu")
        out[kind] = {api: _api(eng, api, codes, lens) for api in APIS}
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("api", APIS)
def test_array_api_matches_reference(corpus, port_results, kind, api):
    idx, codes, lens = corpus
    want = _api(JEngine(idx[kind][0], batch_size=32, use_mesh=False), api,
                codes, lens)
    got = port_results[kind][api]
    _same(api, got, want)
    if api == "csids":
        assert got[10][0].any() and len(got[10][0]) == LONG - K_LEN + 1
    else:
        assert len(got[10]) > 0 and len(got[40]) > 0  # the long reads map
        assert len(got[31]) == 0  # the read shorter than k


@pytest.mark.parametrize("api", APIS)
def test_cuckoo_equals_mini(port_results, api):
    """Two exact dictionaries of the same k-mers: every result equal."""
    _same(api, port_results["cuckoo"][api], port_results["mini"][api])
    if api == "dedup":  # and --deduplicate is the full intersection
        _same("fi", port_results["mini"]["dedup"], port_results["mini"]["fi"])


def test_bucket_widths_capped(corpus):
    """The port's widths are fulgor_tpu's, capped at MAX_STREAM_WIDTH."""
    from fulgor_tpu.query.engine import bucket_widths as jbw

    _idx, _codes, lens = corpus
    fit = lens[lens <= 64]
    assert E.bucket_widths(fit, K_LEN) == jbw(fit, K_LEN)
    assert E.bucket_widths(lens, K_LEN)[-1] == E.MAX_STREAM_WIDTH
    assert jbw(lens, K_LEN)[-1] > E.MAX_STREAM_WIDTH
