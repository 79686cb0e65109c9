"""The benchmark's corpora and reads, made from seeds. Frozen copies, so
that later changes to the program cannot move the yardstick:

- `simulate_pangenome_blocks`: fulgor_tpu_torch/io/simulate.py:142-304
  (the same as fulgor_tpu/io/simulate.py:142-304), the block-structured
  pangenome simulator. Changed only in what it writes: plain FASTA, and
  every genome's codes kept for `pack_corpus`; the random draws are the
  same, so a seed gives the same genomes as the original.
- `simulate_reads`: the semantics of fulgor_tpu_torch/io/simulate.py:32-63
  (uniform genome, uniform start on a window with no record boundary,
  substitution errors at `error_rate` a base, a share of uniformly random
  reads, shuffled), vectorized: the original loops over reads in Python.
  It draws in another order, so a seed gives other reads than the
  original's.
- `write_fastq`: fixed-width records, gzip level 1.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

SEP = 4  # the code of every non-ACGT byte; no k-mer spans one


def simulate_pangenome_blocks(
    out_dir: str,
    num_genomes: int,
    num_genes: int = 400,
    gene_len: int = 2500,
    core_frac: float = 0.5,
    loss_rate: float = 0.04,
    mut_per_branch: int = 60,
    gain_per_branch: int = 0,
    gain_len: int | None = None,
    pool_genes: int = 0,
    ancestral_mut_frac: float | None = None,
    seed: int = 0,
) -> tuple[list[str], list[list[np.ndarray]]]:
    """Gene presence/absence pangenome (block-structured colour sets): the
    ancestor is `num_genes` gene blocks of `gene_len` bp; genomes descend
    a binary tree, each branch applying SNPs, gains from a finite pool and
    losses (see the original's docstring). -> (FASTA paths in colour
    order, each genome's gene code arrays)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    depth = max(1, int(np.ceil(np.log2(max(2, num_genomes)))))
    if gain_len is None:
        gain_len = gene_len
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    genes0 = [rng.integers(0, 4, size=gene_len).astype(np.uint8)
              for _ in range(num_genes)]
    core0 = rng.random(num_genes) < core_frac
    pool = [rng.integers(0, 4, size=gain_len).astype(np.uint8)
            for _ in range(pool_genes)]
    paths: list[str] = []
    genomes: list[list[np.ndarray]] = []

    def emit(gene_seqs):
        # one record a gene, as the original
        i = len(paths)
        p = os.path.join(out_dir, f"g{i:05d}.fa")
        with open(p, "wb") as f:
            for j, g in enumerate(gene_seqs):
                f.write(b">genome%d_%d\n" % (i, j))
                f.write(lut[g].tobytes())
                f.write(b"\n")
        paths.append(p)
        genomes.append(gene_seqs)

    def _snp(gs, which, n):
        if not len(which) or n <= 0:
            return
        lens = np.array([len(gs[j]) for j in which], dtype=np.int64)
        cum = np.concatenate([[0], np.cumsum(lens)])
        flat = rng.choice(int(cum[-1]), size=min(n, int(cum[-1])),
                          replace=False)
        for pos in np.sort(flat):
            w = int(np.searchsorted(cum, int(pos), side="right") - 1)
            gi, off = which[w], int(pos) - int(cum[w])
            gs[gi][off] = (gs[gi][off] + rng.integers(1, 4)) % 4

    def mutate(gene_seqs, core, pids, held):
        gs = [g.copy() for g in gene_seqs]
        if ancestral_mut_frac is None:
            _snp(gs, np.arange(len(gs)), mut_per_branch)
        else:
            n_anc = int(round(mut_per_branch * ancestral_mut_frac))
            _snp(gs, np.flatnonzero(pids < 0), n_anc)
            _snp(gs, np.flatnonzero(pids >= 0), mut_per_branch - n_anc)
        keep = core | (rng.random(len(gs)) >= loss_rate)
        held = held.copy()
        for j in np.nonzero(~keep)[0]:
            if pids[j] >= 0:
                held[pids[j]] = False
        gs = [g for g, k in zip(gs, keep) if k]
        cr = core[keep]
        pd = pids[keep]
        new_seqs, new_pids = [], []
        if pool_genes:
            absent = np.nonzero(~held)[0]
            take = absent[rng.permutation(len(absent))[:gain_per_branch]]
            for pid in take:
                new_seqs.append(pool[pid].copy())
                new_pids.append(int(pid))
                held[pid] = True
        else:
            for _ in range(gain_per_branch):
                new_seqs.append(
                    rng.integers(0, 4, size=gain_len).astype(np.uint8))
                new_pids.append(-1)
        if new_seqs:
            gs = gs + new_seqs
            cr = np.concatenate([cr, np.zeros(len(new_seqs), bool)])
            pd = np.concatenate([pd, np.array(new_pids, dtype=np.int64)])
        return gs, cr, pd, held

    def dfs(gene_seqs, core, pids, held, d):
        if len(paths) >= num_genomes:
            return
        if d == depth:
            emit(gene_seqs)
            return
        for _ in range(2):
            dfs(*mutate(gene_seqs, core, pids, held), d + 1)

    held0 = np.zeros(max(1, pool_genes), bool)
    pids0 = np.full(num_genes, -1, dtype=np.int64)
    if pool_genes and gain_per_branch and loss_rate > 0:
        n0 = min(pool_genes, int(round(gain_per_branch / loss_rate)))
        take0 = rng.permutation(pool_genes)[:n0]
        genes0 = genes0 + [pool[pid].copy() for pid in take0]
        core0 = np.concatenate([core0, np.zeros(n0, bool)])
        pids0 = np.concatenate([pids0, take0.astype(np.int64)])
        held0[take0] = True
    dfs(genes0, core0, pids0, held0, 0)
    return paths, genomes


def pack_corpus(genomes: list[list[np.ndarray]]):
    """Every genome's genes joined, each gene followed by one SEP code.
    -> (codes u8, genome_offs i64 (G + 1,)): genome g is
    codes[genome_offs[g]:genome_offs[g + 1]]."""
    sizes = np.array([sum(len(x) + 1 for x in gs) for gs in genomes],
                     dtype=np.int64)
    offs = np.zeros(len(genomes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    codes = np.full(int(offs[-1]), SEP, dtype=np.uint8)
    for g, gs in enumerate(genomes):
        p = int(offs[g])
        for x in gs:
            codes[p: p + len(x)] = x
            p += len(x) + 1
    return codes, offs


def simulate_reads(codes: np.ndarray, genome_offs: np.ndarray,
                   genomes: np.ndarray, num_reads: int, read_len: int,
                   error_rate: float, unmapped_frac: float,
                   seed: int) -> np.ndarray:
    """(num_reads, read_len) u8 codes: the first int(num_reads *
    unmapped_frac) uniformly random, the others from a uniform pick of
    `genomes`, at a uniform start whose window holds no SEP, with each
    base substituted at rate `error_rate`; then shuffled."""
    rng = np.random.default_rng(seed)
    n_random = int(num_reads * unmapped_frac)
    out = np.empty((num_reads, read_len), dtype=np.uint8)
    out[:n_random] = rng.integers(0, 4, size=(n_random, read_len))
    sep_cum = np.concatenate([[0], np.cumsum(codes == SEP)])
    genomes = np.asarray(genomes, dtype=np.int64)
    lo = genome_offs[genomes]
    span = genome_offs[genomes + 1] - lo - read_len
    if (span <= 0).any():
        raise ValueError("a genome is shorter than a read")
    todo = np.arange(n_random, num_reads)
    g = rng.integers(0, len(genomes), size=len(todo))
    start = np.empty(len(todo), dtype=np.int64)
    while len(todo):
        s = lo[g] + (rng.random(len(todo)) * span[g]).astype(np.int64)
        ok = sep_cum[s + read_len] == sep_cum[s]
        idx = todo - n_random
        start[idx[ok]] = s[ok]
        todo, g = todo[~ok], g[~ok]
    rows = start[:, None] + np.arange(read_len)
    seg = codes[rows]
    err = rng.random(seg.shape) < error_rate
    seg[err] = (seg[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
    out[n_random:] = seg
    return out[rng.permutation(num_reads)]


def write_fastq(path: str, codes: np.ndarray):
    """Reads as gzipped FASTQ (level 1), read i named r<i>, every record
    of one width so that the file is made in a few array operations."""
    n, L = codes.shape
    width = len(str(max(n - 1, 0)))
    name = np.char.zfill(np.arange(n).astype(str), width).astype(f"S{width}")
    rec = np.empty((n, 2 + width + 1 + L + 3 + L + 1), dtype=np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@r", dtype=np.uint8)
    rec[:, 2: 2 + width] = np.frombuffer(name.tobytes(), np.uint8).reshape(
        n, width)
    p = 2 + width
    rec[:, p] = ord("\n")
    rec[:, p + 1: p + 1 + L] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    p += 1 + L
    rec[:, p: p + 3] = np.frombuffer(b"\n+\n", dtype=np.uint8)
    rec[:, p + 3: p + 3 + L] = ord("I")
    rec[:, -1] = ord("\n")
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(rec.tobytes())
