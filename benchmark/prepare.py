"""A configuration's corpus and index, made once in a checkout and kept
under the benchmark's cache/ (which git ignores):

    python3 benchmark/prepare.py <config> [--bench-dir DIR]

It simulates the corpus from the configuration's seed (corpus.py), keeps
its codes for the reads and the reference (codes.npy, genome_offs.npy),
builds the ccdBG with the port's native builder, widens its colour sets
where the configuration asks for more colours than genomes (widen.py),
assembles and saves the index with the port's `assemble_index`, and
removes the FASTA files. Everything is made in `<dir>.part` and renamed
into place, so a cut run leaves nothing that a later one would take for
finished. The harness runs it in a process of its own, so that the
build's peak memory is not the queries'."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import cells  # noqa: E402


def log(msg):
    print(f"[prepare] {msg}", file=sys.stderr, flush=True)


def prepare(cfg: dict, out: str):
    import numpy as np

    from benchmark.corpus import pack_corpus, simulate_pangenome_blocks
    from benchmark.widen import expand_colours
    from fulgor_tpu_torch.build.builder import (
        assemble_index, estimate_build_passes)
    from fulgor_tpu_torch.native import lib as native

    part = out + ".part"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    corpus = dict(cfg["corpus"])
    if corpus.pop("simulator") != "blocks":
        raise ValueError("only the block simulator is known")
    G = corpus.pop("genomes")
    t0 = time.perf_counter()
    paths, genomes = simulate_pangenome_blocks(os.path.join(part, "fa"), G,
                                               **corpus)
    codes, offs = pack_corpus(genomes)
    del genomes
    np.save(os.path.join(part, "codes.npy"), codes)
    np.save(os.path.join(part, "genome_offs.npy"), offs)
    corpus_s = time.perf_counter() - t0
    log(f"corpus: {G} genomes, {len(codes)} codes in {corpus_s:.1f} s")
    del codes
    t0 = time.perf_counter()
    passes = estimate_build_passes(paths, None)
    spill = tempfile.mkdtemp(prefix="ccdbg_") if passes > 1 else None
    try:
        g = native.build_ccdbg(paths, cfg["k"], num_passes=passes,
                               spill_dir=spill)
    finally:
        if spill is not None:
            shutil.rmtree(spill, ignore_errors=True)
    C = cfg["colours"]
    cat, cs_offs = g["cs_colors"], g["cs_offs"]
    names = [os.path.basename(p) for p in paths]
    if C != G:
        cat, cs_offs = expand_colours(cat, cs_offs, G, C)
        names = [f"{names[c % G]}#{c // G}" for c in range(C)]
    idx = assemble_index(
        k=cfg["k"], m=cfg["m"], num_colors=C, filenames=names,
        unitig_codes=g["unitig_codes"], unitig_offs=g["unitig_offs"],
        unitig_cs=g["unitig_cs"], cs_colors=cat, cs_offs=cs_offs,
        dict_kind=cfg["dict_kind"])
    idx.save(os.path.join(part, "index.tfur"))
    build_s = time.perf_counter() - t0
    shutil.rmtree(os.path.join(part, "fa"))
    figures = dict(
        genomes=G, colours=C, kmers=int(idx.num_kmers),
        unitigs=int(idx.num_unitigs), color_sets=int(idx.num_color_sets),
        words_per_set=int(idx.words_per_set),
        ekpu=idx.expected_kmers_per_unitig(),
        dense_bytes=int(idx.num_color_sets * idx.words_per_set * 4),
        index_bytes=os.path.getsize(os.path.join(part, "index.tfur")),
        codes_bytes=int(offs[-1]), corpus_s=corpus_s, build_s=build_s,
        build_passes=passes)
    with open(os.path.join(part, "figures.json"), "w") as f:
        json.dump(figures, f)
    os.rename(part, out)
    log(f"index: {figures}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--bench-dir", default=HERE)
    args = ap.parse_args(argv)
    bench = cells.Bench(args.bench_dir)
    cfg = bench.config(args.config)
    out = cells.cache_dir(cfg, os.path.join(bench.dir, "cache"))
    if os.path.exists(os.path.join(out, "figures.json")):
        log(f"{out} is already made")
        return 0
    prepare(cfg, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
