"""Dictionary probe (kernel K2): the port's plain PyTorch version against
fulgor_tpu's lookup_minidict2_packed at the engine's budgets and at the
kernel's edge budgets (none verified; wider than a slot row's 16
candidates), bit-exact on hit, csid and ovf (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fulgor_tpu.build.builder import build_index
from fulgor_tpu.core import kmers as K
from fulgor_tpu.ops import minidict2 as J
from fulgor_tpu_torch.ops import minidict2 as T
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.ops.prep import window_prep
from fulgor_tpu_torch.ops.probe import minidict2_probe
from tests.test_ccdbg import random_genomes
from tests.test_native import write_fasta
from tests.test_torch_threads import one_thread  # noqa: F401

W = 64
# (0, 2): no verify; (20, 4): more than the 16 candidates of a slot row
BUDGETS = [(2, 2), (4, 4), (3, 3), (8, 4), None, (1, 1), (0, 2), (20, 4)]


# six near-identical genomes: shared minimizers across unitigs form heavy
# groups, so covered entries, the skew route and ovf all occur
@pytest.fixture(scope="module", params=[(15, 9), (31, 19)],
                ids=["k15", "k31"])
def probe_case(request, tmp_path_factory):
    k, m = request.param
    rng = np.random.default_rng(17)
    tmp = tmp_path_factory.mktemp(f"probe_k{k}")
    genomes = random_genomes(rng, num_colors=6, length=3000, mut=0.02, k=k)
    paths = []
    for i, seqs in enumerate(genomes):
        p = str(tmp / f"g{i}.fa")
        write_fasta(p, seqs)
        paths.append(p)
    d = build_index(paths, k=k, m=m).minidict()
    reads = []
    for _ in range(46):
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
    tabs = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in (d.slots, d.text32, d.sec_table)]
    prep = window_prep(torch.from_numpy(codes2), torch.from_numpy(bad),
                       width=W, k=k, m=m)
    return d, k, m, codes2, bad, tabs, prep, chunk


def _probe(case, vb, sc):
    d, k, m, _c2, _bad, tabs, prep, _chunk = case
    hit, csid, ovf = minidict2_probe(*tabs, prep, k=k, m=m,
                                     num_slots=d.num_slots, vb=vb, sc=sc)
    return hit.numpy(), csid.numpy().view(np.uint32), ovf.numpy()


@pytest.mark.parametrize("budget", BUDGETS, ids=str)
def test_probe_matches_jax(probe_case, budget):
    d, k, m, codes2, bad, _tabs, _prep, _chunk = probe_case
    ref = J.lookup_minidict2_packed(
        jnp.asarray(d.slots), jnp.asarray(d.text32), jnp.asarray(d.sec_table),
        jnp.asarray(codes2), jnp.asarray(bad), width=W, k=k, m=m,
        num_slots=d.num_slots, probe_budget=budget)
    vb, sc = budget or (J.VERIFY_BUDGET, J.SKEW_CAND)
    for name, r, g in zip(("hit", "csid", "ovf"), ref,
                          _probe(probe_case, vb, sc)):
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=name)


def test_probe_paths_exercised(probe_case):
    """The fixture drives every branch the budgets gate: tiny budgets
    overflow, and the skew route decides windows the slot screen cannot."""
    hit_full, _, ovf_full = _probe(probe_case, 6, 3)
    hit_noskew, _, _ = _probe(probe_case, 6, 0)
    _, _, ovf_tiny = _probe(probe_case, 1, 1)
    assert ovf_tiny.sum() > ovf_full.sum()
    assert hit_full.sum() > hit_noskew.sum()


def test_probe_matches_host_mirrors(probe_case):
    """The port's own host mirrors, which the redo and chip_smoke.py use:
    lookup_host_device_sem equals the probe at the default budget read for
    read, and lookup_host_exact agrees with a tiny (1, 1) budget on every
    window not in overflow."""
    d, chunk = probe_case[0], probe_case[-1]
    hit, csid, ovf = _probe(probe_case, T.VERIFY_BUDGET, T.SKEW_CAND)
    hit1, csid1, ovf1 = _probe(probe_case, 1, 1)
    assert ovf1.any()
    for i, row in enumerate(chunk):
        for name, got, want in zip(("hit", "csid", "ovf"),
                                   (hit[i], csid[i], ovf[i]),
                                   T.lookup_host_device_sem(d, row)):
            np.testing.assert_array_equal(got, want, err_msg=f"{i} {name}")
        he, ce = T.lookup_host_exact(d, row)
        ok = ~ovf1[i]
        np.testing.assert_array_equal(hit1[i][ok], he[ok], err_msg=str(i))
        np.testing.assert_array_equal(csid1[i][hit1[i]], ce[hit1[i]])
