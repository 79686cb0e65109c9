"""Deterministic read simulation from reference FASTAs (bench + tests).

The reference benchmarks with SRR801268 (real SRA reads); with no network
egress we sample reads from the indexed genomes with a controlled error
rate, which exercises the identical code paths (hits, misses, multi-color
intersections)."""

from __future__ import annotations

import gzip

import numpy as np

from ..core import kmers as K


def load_genome_codes(path: str) -> np.ndarray:
    """Concatenated base codes of all records in a FASTA(.gz); records are
    separated by a single invalid code so windows never span records."""
    op = gzip.open if path.endswith(".gz") else open
    chunks = []
    with op(path, "rb") as f:
        data = f.read()
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            chunks.append(np.array([4], dtype=np.uint8))
        elif line:
            chunks.append(K.seq_to_codes(line))
    return np.concatenate(chunks) if chunks else np.empty(0, np.uint8)


def simulate_reads(
    genome_paths: list[str],
    num_reads: int,
    read_len: int = 150,
    error_rate: float = 0.005,
    unmapped_frac: float = 0.1,
    seed: int = 0,
):
    """-> (codes (N, read_len) uint8, names list). Deterministic in seed."""
    rng = np.random.default_rng(seed)
    genomes = [load_genome_codes(p) for p in genome_paths]
    out = np.empty((num_reads, read_len), dtype=np.uint8)
    n_random = int(num_reads * unmapped_frac)
    gsel = rng.integers(0, len(genomes), size=num_reads)
    for i in range(num_reads):
        if i < n_random:
            out[i] = rng.integers(0, 4, size=read_len).astype(np.uint8)
            continue
        g = genomes[gsel[i]]
        while True:
            p = int(rng.integers(0, len(g) - read_len))
            seg = g[p : p + read_len]
            if (seg != 4).all():
                break
        seg = seg.copy()
        nerr = rng.binomial(read_len, error_rate)
        if nerr:
            pos = rng.choice(read_len, size=nerr, replace=False)
            seg[pos] = (seg[pos] + rng.integers(1, 4, size=nerr)) % 4
        out[i] = seg
    perm = rng.permutation(num_reads)
    return out[perm], [f"sim.{i}" for i in range(num_reads)]


def _existing_corpus(out_dir: str, num_genomes: int, gzip_files: bool):
    """Return the corpus paths if out_dir already holds ALL of them (the
    simulators are deterministic in seed, so a complete directory is a
    valid cache — regenerating a 4,546-genome corpus costs minutes that a
    benchmark timeout cannot afford); None -> generate."""
    import os

    ext = ".fa.gz" if gzip_files else ".fa"
    paths = [os.path.join(out_dir, f"g{i:05d}{ext}") for i in range(num_genomes)]
    last = paths[-1] if paths else None
    if last and os.path.exists(last) and all(os.path.exists(p) for p in paths):
        return paths
    return None


def simulate_pangenome(
    out_dir: str,
    num_genomes: int,
    genome_len: int,
    mut_per_branch: int,
    seed: int = 0,
    gzip_files: bool = True,
) -> list[str]:
    """Clade-structured synthetic pangenome: binary-tree evolution from one
    ancestor, `mut_per_branch` SNPs per branch, leaves written as FASTA(.gz)
    in DFS order (only the first `num_genomes` leaves are materialized).
    Mirrors the regime the reference's meta/diff tiers target (many similar
    genomes, subtree-shaped color sets). Deterministic in seed.
    -> list of file paths (color order)."""
    import os

    done = _existing_corpus(out_dir, num_genomes, gzip_files)
    if done is not None:
        return done
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    depth = max(1, int(np.ceil(np.log2(max(2, num_genomes)))))
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    anc = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    paths: list[str] = []

    def mutate(g):
        c = g.copy()
        pos = rng.choice(genome_len, size=mut_per_branch, replace=False)
        c[pos] = (c[pos] + rng.integers(1, 4, size=mut_per_branch)) % 4
        return c

    ext = ".fa.gz" if gzip_files else ".fa"

    def emit(g):
        i = len(paths)
        p = os.path.join(out_dir, f"g{i:05d}{ext}")
        f_open = (
            (lambda: gzip.open(p, "wb", compresslevel=1))
            if gzip_files
            else (lambda: open(p, "wb"))
        )
        with f_open() as f:
            f.write(b">genome%d\n" % i)
            f.write(lut[g].tobytes())
            f.write(b"\n")
        paths.append(p)

    def dfs(g, d):
        if len(paths) >= num_genomes:
            return
        if d == depth:
            emit(g)
            return
        dfs(mutate(g), d + 1)
        dfs(mutate(g), d + 1)

    dfs(anc, 0)
    return paths


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
    gzip_files: bool = True,
) -> list[str]:
    """Gene presence/absence pangenome (block-structured color sets).

    The ancestor is `num_genes` gene blocks of `gene_len` bp. Genomes
    descend a binary tree: each branch applies `mut_per_branch` SNPs (to
    present genes, length-weighted), GAINS `gain_per_branch` genes of
    `gain_len` bp (horizontal acquisition — inherited by the subtree,
    losable like any non-core gene), and LOSES each non-core gene with
    probability `loss_rate` (losses inherit down the subtree; pool genes
    can be re-gained later). A leaf is the concatenation of its retained
    genes. k-mers of one gene appear in exactly the leaves that retain it,
    so color sets are unions of subtree complements — the block structure
    the reference's Salmonella meta/meta-diff ratios reflect
    (README.md:187-191), unlike the scattered-SNP corpora of
    simulate_pangenome.

    `pool_genes > 0` switches gains from NOVEL random genes to draws from
    a finite ancestral gene pool (fresh ancestral copy each gain; copies
    then drift independently). This is the mechanism that bounds a real
    cohort's distinct text: the reference's 4,546-genome index holds only
    ~10 genome-equivalents of distinct k-mers yet averages ~23
    k-mers/unitig (README.md:310-317) — most distinct text is accessory
    gene blocks shared across clades, not SNP bubbles. Pure-SNP
    simulations shred to ~2-5 k-mers/unitig instead. Deterministic in
    seed. -> paths (color order)."""
    import os

    done = _existing_corpus(out_dir, num_genomes, gzip_files)
    if done is not None:
        return done
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    depth = max(1, int(np.ceil(np.log2(max(2, num_genomes)))))
    if gain_len is None:
        gain_len = gene_len
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    # Node state is four parallel per-node values: gene list (all PRESENT
    # — losses remove entries), core mask, pool-id per gene (-1 ancestral/
    # novel), held mask over the pool. Gene identity is its SEQUENCE, so
    # sibling subtrees need no index alignment.
    genes0 = [rng.integers(0, 4, size=gene_len).astype(np.uint8)
              for _ in range(num_genes)]
    core0 = rng.random(num_genes) < core_frac
    pool = [rng.integers(0, 4, size=gain_len).astype(np.uint8)
            for _ in range(pool_genes)]
    paths: list[str] = []
    ext = ".fa.gz" if gzip_files else ".fa"

    def emit(gene_seqs):
        # one RECORD per gene: concatenating genes would manufacture
        # junction k-mers whose neighbors differ per leaf (gain/loss
        # reshuffles adjacency), i.e. a shredded-text band real conserved-
        # synteny genomes don't have — reads sampled from the emitted
        # genome then never span gene boundaries either (the read
        # simulator skips windows crossing records).
        i = len(paths)
        p = os.path.join(out_dir, f"g{i:05d}{ext}")
        opener = (
            (lambda: gzip.open(p, "wb", compresslevel=1))
            if gzip_files
            else (lambda: open(p, "wb"))
        )
        with opener() as f:
            for j, g in enumerate(gene_seqs):
                f.write(b">genome%d_%d\n" % (i, j))
                f.write(lut[g].tobytes())
                f.write(b"\n")
        paths.append(p)

    def _snp(gs, which, n):
        # n SNPs over the `which` gene subset, length-weighted
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
            # SNPs land on present genes, length-weighted
            _snp(gs, np.arange(len(gs)), mut_per_branch)
        else:
            # split SNPs between ancestral (pid -1) and gained-pool genes.
            # Real cohorts put most segregating sites on accessory text
            # (faster-evolving, recombining) while the purifying-selected
            # core stays sparse — a length-weighted draw would pile
            # cumulative bubbles onto the small shared core coordinate
            # space and shred exactly the text most reads traverse.
            n_anc = int(round(mut_per_branch * ancestral_mut_frac))
            _snp(gs, np.flatnonzero(pids < 0), n_anc)
            _snp(gs, np.flatnonzero(pids >= 0), mut_per_branch - n_anc)
        # losses: non-core genes drop; lost pool genes become re-gainable
        keep = core | (rng.random(len(gs)) >= loss_rate)
        held = held.copy()
        for j in np.nonzero(~keep)[0]:
            if pids[j] >= 0:
                held[pids[j]] = False
        gs = [g for g, k in zip(gs, keep) if k]
        cr = core[keep]
        pd = pids[keep]
        # gains: pool draws (fresh ancestral copies) or novel genes
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
                new_seqs.append(rng.integers(0, 4, size=gain_len).astype(np.uint8))
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

    # root holds a pool subset at the gain/loss equilibrium (gain/loss_rate)
    # so held-gene count is stationary down the tree rather than ramping
    # from zero; root-held genes drift toward soft-core presence patterns,
    # later gains toward subtree patterns — both occur in real cohorts.
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
    return paths


def write_fastq(path: str, codes: np.ndarray, names: list[str]):
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wb") as f:
        qual = b"I" * codes.shape[1]
        for i, name in enumerate(names):
            f.write(b"@" + name.encode() + b"\n")
            f.write(lut[codes[i]].tobytes() + b"\n+\n" + qual + b"\n")
