"""The cuckoo dictionary (kernel K7's plain version, the host mirror, the
builder and the index file) against fulgor_tpu, bit-exact (tolerance 0):

- cuckoo_lookup (its plain version on the CPU) against fulgor_tpu's
  unpack_reads + lookup_batch on a fulgor_tpu-built `--dict cuckoo` index
  at k = 15 and k = 31, over reads from the indexed text, random reads,
  reads with N, padded reads and a read shorter than k;
- host_lookup.lookup_host against fulgor_tpu's, on every indexed k-mer and
  on random keys;
- the port's build_kmer_dict table equal to fulgor_tpu's byte for byte;
- a cuckoo index saved by fulgor_tpu, loaded by the port (and back), with
  the same host window lookups in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.build import builder as JB
from fulgor_tpu.index import Index as JIndex
from fulgor_tpu.ops.lookup import lookup_batch, unpack_reads
from fulgor_tpu.query import host_lookup as JH
from fulgor_tpu_torch.build import builder as TB
from fulgor_tpu_torch.core import kmers as K
from fulgor_tpu_torch.index import Index as TIndex
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.ops.lookup import (
    cuckoo_lookup, cuckoo_row_gathers,
)
from fulgor_tpu_torch.query import host_lookup as TH
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_threads import one_thread  # noqa: F401

W = 96
KS = [15, 31]


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """k -> (fulgor_tpu's cuckoo Index, its file, the FASTA paths), over 6
    genomes of 2,000 bp (tests/test_ops.py's corpus)."""
    tmp = tmp_path_factory.mktemp("cuckoo")
    out = {}
    for k in KS:
        rng = np.random.default_rng(7 + k)
        genomes = random_genomes(rng, num_colors=6, length=2000, mut=0.03, k=k)
        paths = []
        for i, seqs in enumerate(genomes):
            p = str(tmp / f"g{k}_{i}.fa")
            write_fasta(p, seqs)
            paths.append(p)
        idx = JB.build_index(paths, k=k, m=9, dict_kind="cuckoo")
        path = str(tmp / f"j{k}.tfur")
        idx.save(path)
        out[k] = (idx, path, paths)
    return out


def _chunk(idx, seed, width=W):
    """(64, width) codes: 40 reads from the indexed text (some with an N),
    16 random, one padded after 70 bases, one with fewer bases than k."""
    rng = np.random.default_rng(seed)
    codes_all = K.unpack2(idx.unitig_seq, int(idx.unitig_offs[-1]))
    chunk = rng.integers(0, 4, size=(64, width)).astype(np.uint8)
    for b in range(40):
        p = rng.integers(0, len(codes_all) - width)
        chunk[b] = codes_all[p: p + width]
        if b % 5 == 0:
            chunk[b, rng.integers(0, width)] = 4
    chunk[40:44] = rng.integers(0, 5, size=(4, width))  # N anywhere
    chunk[45, 70:] = 4
    chunk[46, idx.k - 1:] = 4
    return chunk


# the kernel's edge shapes beside the base batch: a batch of 37 reads (not
# a multiple of a block's 8) with reads 3-10 all N; widths 32 (one window
# at k = 31) and 1,024 (the widest)
SHAPES = [(W, 64), (W, 37), (32, 64), (1024, 64)]
CASES = [(k, w, n) for w, n in SHAPES for k in KS]


@pytest.mark.parametrize(
    "k, width, reads", CASES,
    ids=[str(k) if (w, n) == (W, 64) else f"{k}-w{w}-b{n}"
         for k, w, n in CASES])
def test_cuckoo_lookup_plain_matches_jax(indexes, k, width, reads):
    idx = indexes[k][0]
    chunk = _chunk(idx, seed=k + width, width=width)[:reads]
    if reads < 64:
        chunk[3:11] = 4
    codes2, bad = pack_reads_host(chunk)
    jh, jc = lookup_batch(jnp.asarray(idx.dict_table),
                          unpack_reads(jnp.asarray(codes2), jnp.asarray(bad),
                                       width), k)
    table = torch.from_numpy(idx.dict_table.view(np.int32))
    th, tc = cuckoo_lookup(table, torch.from_numpy(codes2),
                           torch.from_numpy(bad), width=width, k=k)
    assert th.shape == tc.shape == (reads, width - k + 1)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(jc))
    hits = th.numpy()
    if (width, reads) == (W, 64):
        assert hits[:40].mean() > 0.3 and not hits[46].any()
        assert not hits[45, 70 - k + 1:].any()
    else:  # reads from the text hit; the all-N reads never
        text = [b for b in range(min(40, reads)) if not 3 <= b < 11]
        assert hits[text].any(axis=1).mean() > 0.25
        assert reads == 64 or not hits[3:11].any()
    # one row a valid window, a second where the first choice misses
    valid = (np.lib.stride_tricks.sliding_window_view(chunk < 4, k, axis=1)
             .all(axis=2))
    rows = cuckoo_row_gathers(table, torch.from_numpy(codes2),
                              torch.from_numpy(bad), width=width, k=k)
    assert valid.sum() < rows < 2 * valid.sum()


def test_wrapper_refuses_other_devices(indexes):
    idx = indexes[15][0]
    codes2, bad = pack_reads_host(_chunk(idx, seed=1))
    with pytest.raises(ValueError, match="unsupported device"):
        cuckoo_lookup(torch.from_numpy(idx.dict_table.view(np.int32)).to("meta"),
                      torch.from_numpy(codes2).to("meta"),
                      torch.from_numpy(bad).to("meta"), width=W, k=15)


@pytest.mark.parametrize("k", KS)
def test_lookup_host_matches_jax(indexes, k):
    idx = indexes[k][0]
    keys, _uids = TB.unitig_kmers(
        K.unpack2(idx.unitig_seq, int(idx.unitig_offs[-1])),
        idx.unitig_offs, k)
    rng = np.random.default_rng(k)
    rand = rng.integers(0, 1 << (2 * k), size=5000, dtype=np.uint64)
    for q in (keys, rand):
        want = JH.lookup_host(idx.dict_table, q)
        np.testing.assert_array_equal(TH.lookup_host(idx.dict_table, q), want)
    assert (TH.lookup_host(idx.dict_table, keys) != 0xFFFFFFFF).all()
    assert TH.table_params(len(idx.dict_table))[0] == JH.table_params(
        len(idx.dict_table))[0]


@pytest.mark.parametrize("k", KS)
def test_build_kmer_dict_matches_jax(indexes, k):
    idx = indexes[k][0]
    codes = K.unpack2(idx.unitig_seq, int(idx.unitig_offs[-1]))
    want, n_want = JB.build_kmer_dict(codes, idx.unitig_offs, idx.u2c_csid, k)
    got, n_got = TB.build_kmer_dict(codes, idx.unitig_offs, idx.u2c_csid, k)
    assert n_got == n_want == idx.num_kmers
    assert got.dtype == np.uint32 and got.tobytes() == want.tobytes()
    # and the whole build through the port's builder
    tidx = TB.build_index(indexes[k][2], k=k, m=9, dict_kind="cuckoo")
    assert tidx.dict_kind == "cuckoo" and tidx.mini_slots is None
    assert tidx.dict_table.tobytes() == idx.dict_table.tobytes()
    assert TB.check_index(tidx)


def test_index_file_carries_across(indexes, tmp_path):
    idx, path, _paths = indexes[31]
    tidx = TIndex.load(path)
    assert tidx.dict_kind == "cuckoo"
    np.testing.assert_array_equal(tidx.dict_table, idx.dict_table)
    table, dparams = tidx.device_dict()
    assert dparams is None and table is tidx.dict_table
    tabs = tidx.device_tables("cpu")
    assert set(tabs) == {"table"}
    assert tabs["table"].dtype == torch.int32
    np.testing.assert_array_equal(tabs["table"].numpy().view(np.uint32),
                                  idx.dict_table)
    chunk = _chunk(idx, seed=3)
    row = np.concatenate([chunk[0], chunk[40], chunk[45]])
    for got, want in zip(tidx.host_window_csids(row),
                         idx.host_window_csids(row)):
        np.testing.assert_array_equal(got, want)
    back = str(tmp_path / "t.tfur")
    tidx.save(back)
    jidx = JIndex.load(back)
    assert jidx.dict_kind == "cuckoo"
    np.testing.assert_array_equal(jidx.dict_table, idx.dict_table)
