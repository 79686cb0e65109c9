"""The v1 minimizer dictionary (fulgor_tpu_torch/ops/minidict.py) against
fulgor_tpu's (fulgor_tpu/ops/minidict.py), on the CPU.

One dictionary at k = 21, m = 11 (tests/test_minidict.py's shape), built
by both packages from the same few hundred seeded random unitigs of 30-400
bases (random text repeats no 21-mer, to within a negligible chance), so
no ccdBG build is needed:

  * the port's build_minidict equals the reference's field for field;
  * lookup_minidict_host equals the reference's on mapped, noisy (N
    included) and junk reads;
  * the plain lookup_minidict_batch (what the CPU runs; on the card the
    wrapper launches K8, K1 and K14) equals the JAX lookup_minidict_batch
    bit for bit (tolerance 0) on one (B = 40, L = 90) batch at
    max_candidates 1, 4 and 8, ovf included;
  * the run split (shared with minidict2) equals the reference's loop;
  * the card path's composition (K8 -> K1 -> K14, each wrapper's plain
    version on the CPU) and its splitting of long reads (lookup_in_pieces)
    equal the unsplit plain version;
  * asking for the card where there is none raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.ops import minidict as J
from fulgor_tpu_torch.ops import minidict as T
from fulgor_tpu_torch.ops.minidict2 import _minimizer_runs
from tests.test_torch_threads import one_thread  # noqa: F401

K_LEN, M_LEN = 21, 11
B, L = 40, 90


@pytest.fixture(scope="module")
def setup():
    """(unitig codes, offsets, csids), both packages' dictionaries and the
    (B, L) batch (mapped, noisy with N, junk)."""
    rng = np.random.default_rng(81)
    lens = rng.integers(30, 401, size=300)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    codes = rng.integers(0, 4, size=int(offs[-1])).astype(np.uint8)
    ucs = rng.integers(0, 5000, size=len(lens)).astype(np.uint32)
    jd = J.build_minidict(codes, offs, ucs, K_LEN, M_LEN)
    td = T.build_minidict(codes, offs, ucs, K_LEN, M_LEN)
    batch = np.full((B, L), 4, dtype=np.uint8)
    long_ones = np.flatnonzero(lens >= L)
    for i in range(B):
        if i % 5 == 4:  # junk
            batch[i] = rng.integers(0, 4, size=L)
            continue
        u = rng.choice(long_ones)
        p = offs[u] + rng.integers(0, lens[u] - L + 1)
        batch[i] = codes[p:p + L]
        for _ in range(rng.poisson(2)):  # noise, N (4) included
            batch[i, rng.integers(0, L)] = rng.integers(0, 5)
    return (codes, offs, ucs), jd, td, batch


def _tables(d):
    return tuple(torch.from_numpy(a.view(np.int32))
                 for a in (d.entries, d.bucket_offs, d.text16))


def test_build_equals_reference(setup):
    _u, jd, td, _b = setup
    assert (td.k, td.m) == (jd.k, jd.m) == (K_LEN, M_LEN)
    for f in ("entries", "bucket_offs", "text16"):
        a, b = getattr(td, f), getattr(jd, f)
        assert a.dtype == b.dtype == np.uint32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert td.num_bytes() == jd.num_bytes()
    assert len(td.entries) > 1000


def test_run_split_matches_the_reference_loop(setup):
    """A run of constant minimizer position is at most w = k - m + 1
    positions long (its minimizer lies in every window of the run), so no
    run reaches 255 and the v1 split never fires at k <= 32. The split
    itself (shared with minidict2) is held here at small spans against the
    reference's loop (fulgor_tpu build_minidict :223-234) applied to the
    unsplit runs."""
    (codes, offs, ucs), _jd, _td, _b = setup
    whole = _minimizer_runs(codes, offs, ucs, K_LEN, M_LEN, max_span=255)
    assert whole["span"].max() <= K_LEN - M_LEN + 1
    assert (whole["span"] > 2).any()
    for s in (1, 2, 3):
        wlo, span, moff, csid = [], [], [], []
        for w0, sp, mo, cs in zip(whole["wlo"], whole["span"],
                                  whole["moff"], whole["csid"]):
            jj, p, rem = int(w0) + int(mo), int(w0), int(sp)
            while rem > 0:
                take = min(rem, s)
                wlo.append(p)
                span.append(take)
                moff.append(jj - p)
                csid.append(cs)
                p += take
                rem -= take
        got = _minimizer_runs(codes, offs, ucs, K_LEN, M_LEN, max_span=s)
        for f, want in (("wlo", wlo), ("span", span), ("moff", moff),
                        ("csid", csid)):
            np.testing.assert_array_equal(got[f], np.array(want), err_msg=f)


def test_host_lookup_equals_reference(setup):
    _u, jd, td, batch = setup
    for i in range(B):
        for a, b, what in zip(T.lookup_minidict_host(td, batch[i]),
                              J.lookup_minidict_host(jd, batch[i]),
                              ("hit", "csid", "ovf")):
            np.testing.assert_array_equal(a, b, err_msg=f"read {i} {what}")
    hit, _cs, _ovf = T.lookup_minidict_host(td, batch[0])
    assert hit.any()


@pytest.mark.parametrize("max_candidates", [1, 4, 8])
def test_plain_lookup_equals_jax(setup, max_candidates):
    _u, jd, td, batch = setup
    want = [np.asarray(x) for x in J.lookup_minidict_batch(
        jnp.asarray(jd.entries), jnp.asarray(jd.bucket_offs),
        jnp.asarray(jd.text16), jnp.asarray(batch), k=K_LEN, m=M_LEN,
        max_candidates=max_candidates)]
    got = T.lookup_minidict_batch(*_tables(td), torch.from_numpy(batch),
                                  k=K_LEN, m=M_LEN,
                                  max_candidates=max_candidates)
    assert [tuple(g.shape) for g in got] == [(B, L - K_LEN + 1)] * 3
    hit, csid, ovf = (g.numpy() for g in got)
    np.testing.assert_array_equal(hit, want[0])
    np.testing.assert_array_equal(csid.view(np.uint32), want[1])
    np.testing.assert_array_equal(ovf, want[2])
    assert hit.sum() > 0.3 * hit.size
    if max_candidates == 1:
        assert ovf.any()  # the ovf masking is exercised
        assert not (hit & ovf).any()


def test_tables_on_a_device_lookup(setup):
    """MiniDict.to("cpu") holds the tables once; its lookup is the plain
    version on them."""
    _u, _jd, td, batch = setup
    tabs = td.to("cpu")
    assert tabs.entries.dtype == torch.int32
    assert tuple(tabs.bucket_offs.shape) == td.bucket_offs.shape
    codes = torch.from_numpy(batch)
    want = T.lookup_minidict_batch_plain(*_tables(td), codes, k=K_LEN,
                                         m=M_LEN, max_candidates=8)
    for a, b in zip(tabs.lookup(codes, max_candidates=8), want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def long_reads(setup):
    """12 reads of 300 bases cut from the unitigs, one N at base 150 of
    the second (inside the overlap of its first two pieces of 128)."""
    (codes, offs, _ucs), _jd, _td, _b = setup
    rng = np.random.default_rng(82)
    n, Lr = 12, 300
    lens = np.diff(offs)
    long_ones = np.flatnonzero(lens >= Lr)
    reads = np.full((n, Lr), 4, dtype=np.uint8)
    for i in range(n):
        u = rng.choice(long_ones)
        p = offs[u] + rng.integers(0, lens[u] - Lr + 1)
        reads[i] = codes[p:p + Lr]
    reads[1, 150] = 4
    return reads


def test_pieces_equal_unsplit(setup, long_reads):
    """Reads of 300 bases in pieces of 128 (each piece's last k - 1 bases
    are the next one's first): the card path's splitting, driven with the
    plain version, equals the unsplit plain version."""
    _u, _jd, td, _b = setup
    reads = long_reads
    n = len(reads)
    tabs = _tables(td)
    kw = dict(k=K_LEN, m=M_LEN, max_candidates=4)
    whole = T.lookup_minidict_batch_plain(*tabs, torch.from_numpy(reads),
                                          **kw)
    calls = []

    def run(rows):
        calls.append(tuple(rows.shape))
        return T.lookup_minidict_batch_plain(*tabs, rows, **kw)

    split = T.lookup_in_pieces(torch.from_numpy(reads), k=K_LEN, piece=128,
                               run=run)
    assert calls == [(n * 3, 128)]  # 280 windows in pieces of 108
    for a, b in zip(split, whole):
        assert torch.equal(a, b)
    assert whole[0].float().mean() > 0.9


@pytest.mark.parametrize("max_candidates", [1, 8])
@pytest.mark.parametrize("reads", ["batch", "long"])
def test_kernel_composition_equals_plain(setup, long_reads, reads,
                                         max_candidates):
    """The card path's composition, K8 -> K1 -> K14 (each wrapper's plain
    version on the CPU), equals lookup_minidict_batch_plain, whose own
    minimizers and packings follow fulgor_tpu's: the (B, 90) batch in one
    piece padded to 96 bases, the 300-base reads in pieces of at most 128."""
    _u, _jd, td, batch = setup
    codes = torch.from_numpy(batch if reads == "batch" else long_reads)
    kw = dict(k=K_LEN, m=M_LEN, max_candidates=max_candidates)
    got = T.lookup_by_kernels(*_tables(td), codes, max_width=128, **kw)
    want = T.lookup_minidict_batch_plain(*_tables(td), codes, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_card_raises(setup, monkeypatch):
    """MiniDict.to() takes the card, and raises where there is none, as
    the engine's resolve_device does: it never runs the plain version
    quietly."""
    _u, _jd, td, _b = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.to(dev)


def test_wrapper_refuses_other_devices(setup):
    _u, _jd, td, batch = setup
    meta = [t.to("meta") for t in _tables(td)]
    with pytest.raises(ValueError, match="unsupported device"):
        T.lookup_minidict_batch(*meta, torch.from_numpy(batch).to("meta"),
                                k=K_LEN, m=M_LEN)
    with pytest.raises(ValueError, match="L >= k"):
        T.lookup_minidict_batch(*_tables(td),
                                torch.from_numpy(batch[:, :K_LEN - 1]),
                                k=K_LEN, m=M_LEN)
