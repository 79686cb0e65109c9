"""Index construction pipeline (reference L6: include/builders/builder.hpp).

build_index(): FASTA list -> ccdBG (native C++) -> k-mer dictionary (mini,
or cuckoo with dict_kind="cuckoo") -> hybrid color-set encoding -> Index.
The reference's 4-step builder maps to:

    step 1 GGCAT           -> native fn_build_ccdbg
    step 2 u2c + encoding  -> dense u2c array + HybridEncoder
    step 3 SSHash build    -> ops/minidict2.build_minidict2, or
                              unitig_kmers() + native cuckoo_build
    step 4 filenames       -> kept as a list

check_index() reproduces the --check oracle (builder.hpp:221-277): every
k-mer of every unitig must resolve to that unitig, and decoded color sets
must match the construction's; check_against() checks one index against
another unitig by unitig (`check --against`).
"""

from __future__ import annotations

import numpy as np

from ..constants import KIND_HYBRID
from ..core import kmers as K
from ..core.colorstores import HybridStore
from ..index import Index


def unitig_kmers(unitig_codes: np.ndarray, unitig_offs: np.ndarray, k: int):
    """(canonical kmer keys u64, unitig_id vals u32) for every kmer of every
    unitig, vectorized over the concatenated code array."""
    km_all, _ = K.pack_kmers(unitig_codes, k)
    n = len(km_all)
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    pos = np.arange(n, dtype=np.int64)
    uid = np.searchsorted(unitig_offs, pos, side="right") - 1
    keep = (pos + k) <= unitig_offs[uid + 1]
    keys = K.canonicalize(km_all[keep], k)
    vals = uid[keep].astype(np.uint32)
    return keys, vals


def build_kmer_dict(unitig_codes, unitig_offs, unitig_cs, k):
    """Cuckoo table mapping canonical kmer -> COLOR-SET id (u2c folded in at
    build time, saving a gather a window) -> (table (nb, 4) u32, kmers)."""
    from ..native import lib as native

    keys, uids = unitig_kmers(unitig_codes, unitig_offs, k)
    vals = np.asarray(unitig_cs, dtype=np.uint32)[uids.astype(np.int64)]
    return native.cuckoo_build(keys, vals), len(keys)


def assemble_index(
    *,
    k: int,
    m: int,
    num_colors: int,
    filenames: list[str],
    unitig_codes: np.ndarray,
    unitig_offs: np.ndarray,
    unitig_cs: np.ndarray,
    cs_colors: np.ndarray,
    cs_offs: np.ndarray,
    dict_kind: str = "mini",
    verbose: bool = False,
) -> Index:
    store = HybridStore.build(
        np.asarray(cs_colors, dtype=np.uint32), np.asarray(cs_offs), num_colors
    )
    table = mini_slots = mini_sec = None
    mini_num_slots = 0
    if dict_kind == "cuckoo":
        table, num_kmers = build_kmer_dict(unitig_codes, unitig_offs,
                                           unitig_cs, k)
    elif dict_kind == "mini":
        from ..ops.minidict2 import build_minidict2

        d = build_minidict2(unitig_codes, unitig_offs, unitig_cs, k, m,
                            verbose=verbose)
        mini_slots, mini_sec, mini_num_slots = d.slots, d.sec_table, d.num_slots
        num_kmers = int(np.clip(
            np.diff(np.asarray(unitig_offs, np.int64)) - k + 1, 0, None).sum())
    else:
        raise ValueError(f"unknown dictionary kind {dict_kind!r} "
                         "(mini or cuckoo)")
    return Index(
        kind=KIND_HYBRID,
        k=k,
        m=m,
        num_kmers=num_kmers,
        num_colors=num_colors,
        filenames=list(filenames),
        dict_table=table,
        unitig_seq=K.pack2(unitig_codes),
        unitig_offs=np.asarray(unitig_offs, dtype=np.int64),
        u2c_csid=np.asarray(unitig_cs, dtype=np.uint32),
        color_store=store,
        dict_kind=dict_kind,
        mini_slots=mini_slots,
        mini_sec=mini_sec,
        mini_num_slots=mini_num_slots,
    )


def _uncompressed_size(path: str) -> int:
    """Exact decompressed byte count for single-member .gz files via the
    trailer's ISIZE field (mod 2^32 — exact for files under 4 GiB, which
    covers per-genome FASTAs); plain files report their size. O(1) per file,
    so the pass estimator never mis-guesses the gz ratio (round-3 lesson:
    a 4x-compression guess put a 46.5M-kmer build at 16 passes on a 125 GB
    host — a 40-minute wall when 2 passes fit)."""
    import os

    try:
        if path.endswith(".gz"):
            with open(path, "rb") as f:
                f.seek(-4, os.SEEK_END)
                return int(np.frombuffer(f.read(4), dtype="<u4")[0])
        return os.path.getsize(path)
    except OSError:
        return 0


def host_ram_gib() -> float:
    """Available host RAM in GiB (MemAvailable; generous fallback)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / (1 << 20)
    except OSError:
        pass
    return 8.0


def estimate_build_passes(filenames: list[str], ram_gib: float | None) -> int:
    """Pick the multi-pass factor so the (k-mer, color) pair table fits the
    RAM budget. Pairs ~= total input bases. ram_gib=None -> real host RAM."""
    if ram_gib is None:
        ram_gib = host_ram_gib()
    total = sum(_uncompressed_size(f) for f in filenames)
    # measured peak of the native builder after the in-place bucket-sort
    # rewrite: ~16 B/pair (the KC buffer) + the per-genome 8 B lists being
    # drained into it; 18 B/pair of ESTIMATED pairs (~= input bases) with a
    # 0.6 RAM budget keeps a comfortable margin (the pre-rewrite peak was
    # ~44 B/pair: parallel-mergesort temp + zero-init resize + cat copy —
    # which OOM-killed a 125 GB host at 4 passes on an 11.6 GB corpus)
    pair_bytes = total * 18
    budget = max(1.0, ram_gib) * (1 << 30) * 0.6
    passes = 1
    while pair_bytes / passes > budget and passes < 256:
        passes *= 2
    return passes


def build_index(
    filenames: list[str], k: int = 31, m: int = 19, verbose: bool = False,
    ram_gib: float | None = None, dict_kind: str = "mini",
    spill_dir: str | None = None,
) -> Index:
    """Full build from a list of FASTA(.gz) reference files (color order =
    file order, as the reference's -l list). ram_gib bounds the pair-table
    memory via multi-pass construction (reference -g flag semantics;
    None = measure the host's available RAM);
    spill_dir switches the multi-pass partitioning from per-pass re-parsing
    to a single parse spilling partition streams to temp files there
    (reference -d temp-dir semantics, GGCAT.hpp:42-50). When passes > 1 and
    no spill_dir is given, a temp dir is created automatically (single-parse
    is the default: re-parsing a multi-GB gz corpus per pass dominated the
    4,546-genome build wall-clock). dict_kind: "mini" (default) or
    "cuckoo", the k-mer dictionary backend."""
    import shutil
    import tempfile
    import time

    from ..native import lib as native

    if dict_kind == "mini" and m % 2 == 0:
        # the mini dictionary's per-entry strand bit is only sound when no
        # m-mer can equal its own reverse complement, i.e. odd m; the
        # minimizer length is an internal space/speed knob (results are
        # exact either way), so quietly use the next odd value down
        if verbose:
            print(f"note: mini dictionary needs odd m; using m={m - 1}")
        m -= 1

    passes = estimate_build_passes(filenames, ram_gib)
    _auto_spill = None
    if spill_dir is None and passes > 1:
        _auto_spill = tempfile.mkdtemp(prefix="fulgor_spill_")
        spill_dir = _auto_spill
    t0 = time.perf_counter()
    if verbose:
        mode = f"spill to {spill_dir}" if spill_dir and passes > 1 else "re-parse"
        print(
            f"step 1+2. building ccdBG over {len(filenames)} references "
            f"(k={k}, passes={passes}, {mode})...", flush=True
        )
    try:
        g = native.build_ccdbg(filenames, k, num_passes=passes, spill_dir=spill_dir)
    finally:
        if _auto_spill is not None:
            shutil.rmtree(_auto_spill, ignore_errors=True)
    t1 = time.perf_counter()
    if verbose:
        print(
            f"  {g['num_kmers']} kmers, {len(g['unitig_offs']) - 1} unitigs, "
            f"{len(g['cs_offs']) - 1} color sets ({t1 - t0:.1f} s)"
        )
        print("step 3. building k-mer dictionary + encoding color sets...")
    idx = assemble_index(
        k=k,
        m=m,
        num_colors=len(filenames),
        filenames=filenames,
        unitig_codes=g["unitig_codes"],
        unitig_offs=g["unitig_offs"],
        unitig_cs=g["unitig_cs"],
        cs_colors=g["cs_colors"],
        cs_offs=g["cs_offs"],
        dict_kind=dict_kind,
        verbose=verbose,
    )
    if verbose:
        print(f"  dictionary + color encoding: {time.perf_counter() - t1:.1f} s")
    assert idx.num_kmers == g["num_kmers"]
    return idx


def check_against(base: Index, target: Index, verbose: bool = False) -> bool:
    """Unitig-level cross-index validation (reference tools/util.cpp:63-231):
    every k-mer of every target unitig must resolve to ONE color set in each
    index, and the two sets must match modulo the color permutation recovered
    by sorting filenames. Makes no assumption that set ids align. Both
    indexes are looked up on the host (Index.host_window_csids)."""
    if base.num_colors != target.num_colors:
        print("CHECK FAILED: number of colors mismatch")
        return False
    if base.num_color_sets != target.num_color_sets:
        print("CHECK FAILED: number of color sets mismatch")
        return False
    if base.num_unitigs != target.num_unitigs:
        print("CHECK FAILED: number of unitigs mismatch")
        return False
    if base.num_kmers != target.num_kmers:
        print("CHECK FAILED: number of kmers mismatch")
        return False
    # color map via filename sort (util.cpp:90-106)
    base_perm = np.argsort(np.array(base.filenames, dtype=object), kind="stable")
    tgt_perm = np.argsort(np.array(target.filenames, dtype=object), kind="stable")
    base_to_target = np.empty(base.num_colors, dtype=np.int64)
    base_to_target[base_perm] = tgt_perm

    codes_all = K.unpack2(target.unitig_seq, int(target.unitig_offs[-1]))
    uids, inside = unitig_window_mask(target.unitig_offs, target.k, len(codes_all))
    _th, tcs_all = target.host_window_csids(codes_all)
    tgt_csid_kmer = tcs_all[inside]
    expect_tgt = target.u2c_csid[uids.astype(np.int64)]
    if not (tgt_csid_kmer == expect_tgt).all():
        print("CHECK FAILED: target kmers do not resolve to their unitig's set")
        return False
    _bh, bcs_all = base.host_window_csids(codes_all)
    base_csid_kmer = bcs_all[inside].astype(np.int64)
    num_checked_kmers = int(inside.sum())
    # base csid must be constant within each target unitig
    first_of_uid = np.concatenate([[True], uids[1:] != uids[:-1]])
    uid_first_base = base_csid_kmer[first_of_uid][
        np.cumsum(first_of_uid.astype(np.int64)) - 1
    ]
    if not (base_csid_kmer == uid_first_base).all():
        print("CHECK FAILED: a target unitig spans multiple base color sets")
        return False
    # per target set: compare contents vs the mapped base set (one pair per
    # distinct target csid; unitig grouping guarantees coverage of all sets)
    tcs = target.u2c_csid.astype(np.int64)
    bcs = base_csid_kmer[first_of_uid]  # base csid per target unitig
    tsids, first_uid = np.unique(tcs, return_index=True)
    bsid_of_t = bcs[first_uid]
    bcat, boffs = base.color_sets_decoded()
    tcat, toffs = target.color_sets_decoded()
    tsz = (toffs[1:] - toffs[:-1]).astype(np.int64)[tsids]
    bsz = (boffs[1:] - boffs[:-1]).astype(np.int64)[bsid_of_t]
    if not np.array_equal(tsz, bsz):
        s = int(tsids[np.flatnonzero(tsz != bsz)[0]])
        print(f"CHECK FAILED: color set {s} size mismatch vs base")
        return False
    # gather mapped base contents in target-set order, sort per segment
    exp_offs = np.concatenate([[0], np.cumsum(bsz)]).astype(np.int64)
    g = np.repeat(boffs[:-1][bsid_of_t], bsz) + (
        np.arange(int(bsz.sum()), dtype=np.int64) - np.repeat(exp_offs[:-1], bsz)
    )
    mapped = base_to_target[bcat[g].astype(np.int64)]
    seg = np.repeat(np.arange(len(tsids), dtype=np.int64), bsz)
    mapped = mapped[np.lexsort((mapped, seg))]
    tg = np.repeat(toffs[:-1][tsids], tsz) + (
        np.arange(int(tsz.sum()), dtype=np.int64) - np.repeat(exp_offs[:-1], tsz)
    )
    tvals = tcat[tg].astype(np.int64)
    tvals = tvals[np.lexsort((tvals, seg))]
    bad = mapped != tvals
    if bad.any():
        s = int(tsids[seg[np.flatnonzero(bad)[0]]])
        print(f"CHECK FAILED: color set {s} mismatch vs base")
        return False
    if verbose:
        print(
            f"checked {target.num_unitigs} unitigs, {num_checked_kmers} kmers, "
            f"{target.num_color_sets} color sets against base"
        )
    return True


def unitig_window_mask(unitig_offs: np.ndarray, k: int, total: int):
    """(uid, inside) for every window position of the concatenated unitig
    text: uid = owning unitig, inside = window fully within one unitig."""
    offs = np.asarray(unitig_offs, dtype=np.int64)
    Wk = max(0, total - k + 1)
    pos = np.arange(Wk, dtype=np.int64)
    uid = np.searchsorted(offs, pos, side="right") - 1
    inside = (pos + k) <= offs[uid + 1]
    return uid[inside], inside


def check_index(idx: Index, verbose: bool = False) -> bool:
    """--check oracle: every unitig k-mer resolves to its unitig's color set
    through the dictionary (any backend), and u2c/color sets are consistent."""
    codes_all = K.unpack2(idx.unitig_seq, int(idx.unitig_offs[-1]))
    uids, inside = unitig_window_mask(idx.unitig_offs, idx.k, len(codes_all))
    _hit, csid_all = idx.host_window_csids(codes_all)
    got = csid_all[inside]
    expect = idx.u2c_csid[uids.astype(np.int64)]
    if not (got == expect).all():
        bad = np.flatnonzero(got != expect)
        print(f"CHECK FAILED: {len(bad)} kmers misresolve (first window: {bad[0]})")
        return False
    if int(idx.u2c_csid.max(initial=0)) >= idx.num_color_sets:
        print("CHECK FAILED: u2c out of range")
        return False
    if verbose:
        print(f"checked {len(got)} kmers: all resolve to their unitig")
    return True
