"""fulgor-tpu-torch command line, with the subcommands and flags of
fulgor_tpu's cli (reference tools/fulgor.cpp): `build`, `color`, `permute`,
`pseudoalign` (full intersection, threshold union with -r, or full
intersection once per distinct colour-set list with --deduplicate),
`kmer-conservation`, `kmer-matches`, `stats`, `print-filenames`, `verify`,
`dump`, `load`, `check` and `help`. The query tools run on the card unless
--device says otherwise; the host tools (build, color, permute, stats,
print-filenames, verify, dump, load, check) never touch it.

    python -m fulgor_tpu_torch.cli build -l list.txt -o idx [-k 31 -m 19] [--dict cuckoo] [--meta] [--diff]
    python -m fulgor_tpu_torch.cli color -i idx.tfur --meta --diff [--check]
    python -m fulgor_tpu_torch.cli pseudoalign -i idx.tfur -q reads.fq -o out [-r 0.8 | --deduplicate]
    python -m fulgor_tpu_torch.cli kmer-conservation -i idx.tfur -q reads.fq -o out
    python -m fulgor_tpu_torch.cli kmer-matches -i idx.tfur -q reads.fq -o out
    python -m fulgor_tpu_torch.cli check -i idx.mdfur --against idx.tfur

pseudoalign over several processes (parallel/multihost.py): the same
command in each, with --num-procs N, --proc-id 0..N-1 (or
FULGOR_NUM_PROCS, FULGOR_PROC_ID) and --coordinator host:port (or
FULGOR_COORDINATOR), where process 0 listens; each names its card with
--device. Process 0 merges the fragments into the output.

On a mini index, FULGOR_PROBE_BUDGET=vb1,vb2,sc,RU selects the staged probe
and FULGOR_ANCHORED_PROBE=1 the run-anchored one for every query tool, as
in fulgor_tpu (FULGOR_PROBE_BUDGET=vb,sc trims the one-pass probe, and
FULGOR_PROBE_BUDGET_REDO=vb,sc sets the overflow redo's budget).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import INDEX_VERSION
from .constants import EXT, KIND_HYBRID
from .index import Index


def _apply_thread_cap(threads):
    """-t: cap the native std::thread pools (FULGOR_THREADS) and OpenMP
    regions; must run before the native lib spawns its first region."""
    if threads and threads > 0:
        os.environ["FULGOR_THREADS"] = str(threads)
        os.environ["OMP_NUM_THREADS"] = str(threads)


def cmd_build(args):
    from .build.builder import build_index, check_index

    out = args.output + EXT[KIND_HYBRID]
    if os.path.exists(out):
        if args.force:
            print("Option '--force' specified: re-building the index.",
                  file=sys.stderr)
        else:
            print(f"Index '{out}' already exists. Use option '--force' to "
                  "re-build the index.", file=sys.stderr)
            return 1
    with open(args.filenames_list) as f:
        filenames = [ln.strip() for ln in f if ln.strip()]
    idx = build_index(
        filenames, k=args.k, m=args.m, verbose=args.verbose,
        ram_gib=args.ram_gib, dict_kind=args.dict_kind,
        spill_dir=(args.tmp_dir if args.tmp_dir != "." else None),
    )
    idx.save(out)
    if args.verbose:
        print(f"index written to '{out}'")
        idx.print_stats()
    if args.check:
        if not check_index(idx, verbose=args.verbose):
            return 1
        print("EVERYTHING OK!")
    if args.meta or args.diff:
        from .build.color_builder import check_conversion, convert

        conv = convert(idx, meta=args.meta, diff=args.diff)
        conv_path = args.output + EXT[conv.kind]
        conv.save(conv_path)
        print(f"index written to '{conv_path}'")
        if args.check and not check_conversion(idx, conv):
            return 1
    return 0


def cmd_pseudoalign(args):
    from .query.engine import QueryEngine

    if args.deduplicate and args.threshold is not None:
        print("Deduplication not available for threshold < 1.0. Remove "
              "--deduplicate flag.")
        return 1
    if args.num_procs > 1:
        # data parallelism over processes (parallel/multihost.py): the
        # same command in each, --proc-id distinct; process 0 merges
        from .parallel import multihost as MH

        if args.deduplicate:
            print("--deduplicate is single-host (global dedup state)")
            return 1
        pid, nprocs = MH.init_multihost(args.coordinator, args.num_procs,
                                        args.proc_id)
        try:
            device = args.device
            if device is None:  # one card a process where several share
                import torch  # a host; alone, the engine's default

                device = MH.process_device(*MH.local_rank(),
                                           torch.cuda.device_count())
            idx = Index.load(args.index_filename)
            eng = QueryEngine(idx, batch_size=args.batch_size,
                              device=device)
            if args.verbose:
                print(f"process {pid} runs on {eng.device}"
                      + (f" (a mesh over {len(eng.mesh.distinct())} cards)"
                         if eng.mesh is not None else ""))
            MH.pseudoalign_multihost(
                eng, args.query_filename, args.output_filename,
                threshold=args.threshold, fmt=args.format,
                verbose=args.verbose, proc_id=pid, num_procs=nprocs)
        finally:
            MH.shutdown_multihost()
        return 0
    idx = Index.load(args.index_filename)
    eng = QueryEngine(idx, batch_size=args.batch_size, device=args.device)
    eng.pseudoalign_file(args.query_filename, args.output_filename,
                         threshold=args.threshold, fmt=args.format,
                         verbose=args.verbose, deduplicate=args.deduplicate)
    return 0


def cmd_kmer_conservation(args):
    from .query.engine import QueryEngine

    idx = Index.load(args.index_filename)
    eng = QueryEngine(idx, batch_size=args.batch_size, device=args.device)
    eng.kmer_conservation_file(args.query_filename, args.output_filename,
                               verbose=args.verbose)
    return 0


def cmd_kmer_matches(args):
    from .query.engine import QueryEngine

    idx = Index.load(args.index_filename)
    eng = QueryEngine(idx, batch_size=args.batch_size, device=args.device)
    eng.kmer_matches_file(args.query_filename, args.output_filename,
                          verbose=args.verbose)
    return 0


def cmd_stats(args):
    Index.load(args.index_filename).print_stats()
    return 0


def cmd_print_filenames(args):
    for fn in Index.load(args.index_filename).filenames:
        print(fn)
    return 0


def cmd_verify(args):
    from .core.container import Container

    c = Container(args.index_filename)
    ver = c.meta.get("index_version", [0, 0, 0])
    print(f"index version: {ver[0]}.{ver[1]}.{ver[2]}")
    if ver[0] != INDEX_VERSION[0]:
        print("MAJOR index version mismatch: index needs rebuilding")
        return 1
    print("OK")
    return 0


def cmd_dump(args):
    Index.load(args.index_filename).dump(args.output)
    return 0


def cmd_load(args):
    idx = Index.from_dump(args.input_basename, m=args.m)
    out = args.output + EXT[KIND_HYBRID]
    idx.save(out)
    print(f"index written to '{out}'")
    return 0


def cmd_check(args):
    from .build.builder import check_against, check_index

    idx = Index.load(args.index_filename)
    ok = check_index(idx, verbose=args.verbose)
    if ok and args.against:
        ok = check_against(Index.load(args.against), idx,
                           verbose=args.verbose)
    if ok:
        print("EVERYTHING OK!")
        return 0
    return 1


def cmd_color(args):
    from .build.color_builder import KIND_TARGET, check_conversion, convert

    base = args.index_filename
    for ext in EXT.values():
        if base.endswith(ext):
            base = base[: -len(ext)]
    target_kind = KIND_TARGET[(args.meta, args.diff)]
    out_path = base + EXT[target_kind]
    if os.path.exists(out_path):
        if args.force:
            print("Option '--force' specified: re-building the index.",
                  file=sys.stderr)
        else:
            print(f"Index '{out_path}' already exists. Use option '--force' "
                  "to re-build the index.", file=sys.stderr)
            return 1
    idx = Index.load(args.index_filename)
    out_idx = convert(idx, meta=args.meta, diff=args.diff)
    assert out_idx.kind == target_kind
    out_idx.save(out_path)
    print(f"index written to '{out_path}'")
    if args.verbose:
        out_idx.print_stats()
    if args.check:
        if not check_conversion(idx, out_idx):
            return 1
        print("EVERYTHING OK!")
    return 0


def cmd_permute(args):
    """Write the filenames in clustered (permuted) order, to pre-sort the
    inputs of a build for better compression (reference
    tools/permute.cpp)."""
    import numpy as np

    from .build.color_builder import permute_colors

    idx = Index.load(args.index_filename)
    perm, _bounds = permute_colors(idx)
    with open(args.output, "w") as f:
        for old in np.argsort(perm):
            f.write(idx.filenames[int(old)] + "\n")
    print(f"permuted filenames written to '{args.output}'")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="fulgor-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a colored compacted dBG index")
    b.add_argument("-l", dest="filenames_list", required=True,
                   help="list of FASTA(.gz) files")
    b.add_argument("-o", dest="output", required=True,
                   help="output index basename")
    b.add_argument("-k", dest="k", type=int, default=31)
    b.add_argument("-m", dest="m", type=int, default=19)
    b.add_argument("-d", dest="tmp_dir", default=".",
                   help="temp dir for disk-spill multi-pass construction; "
                        "with the default '.', multi-pass re-parses inputs")
    b.add_argument("-g", dest="ram_gib", type=float, default=None,
                   help="RAM budget (GiB) for the build pair table "
                        "(default: the host's available RAM)")
    b.add_argument("-t", dest="threads", type=int, default=0,
                   help="cap build threads (0 = all cores)")
    b.add_argument("--dict", dest="dict_kind", default="mini",
                   choices=("mini", "cuckoo"),
                   help="k-mer dictionary backend (mini: minimizer-positional,"
                        " SSHash-class, default; cuckoo: quotient cuckoo)")
    b.add_argument("--verbose", action="store_true")
    b.add_argument("--check", action="store_true")
    b.add_argument("--force", action="store_true",
                   help="overwrite an existing output index")
    b.add_argument("--meta", action="store_true",
                   help="also build the meta-colored index")
    b.add_argument("--diff", action="store_true",
                   help="also build the differential-colored index")
    b.set_defaults(fn=cmd_build)

    def add_query_args(q):
        q.add_argument("-i", dest="index_filename", required=True)
        q.add_argument("-q", dest="query_filename", required=True)
        q.add_argument("-o", dest="output_filename", required=True)
        q.add_argument("-t", dest="threads", type=int, default=0,
                       help="cap host threads (0 = all cores)")
        q.add_argument("--batch-size", dest="batch_size", type=int,
                       default=32768)
        q.add_argument("--device", dest="device", default=None,
                       help="torch device (default: cuda; 'cpu' runs the "
                            "plain PyTorch versions of the kernels). With "
                            "several cards visible and no device named, "
                            "queries shard over a mesh of them all; name a "
                            "card, e.g. cuda:0, for one device")
        q.add_argument("--verbose", action="store_true")

    q = sub.add_parser("pseudoalign", help="pseudoalign reads")
    add_query_args(q)
    q.add_argument("-r", dest="threshold", type=float, default=None,
                   help="threshold-union threshold in (0.0, 1.0]")
    q.add_argument("--deduplicate", action="store_true",
                   help="group reads with identical colour-set-id lists and "
                        "intersect each distinct list once")
    q.add_argument("--format", dest="format", default="ascii",
                   choices=["ascii", "binary", "compressed"])
    q.add_argument("--num-procs", dest="num_procs", type=int,
                   default=int(os.environ.get("FULGOR_NUM_PROCS", "1")),
                   help="scale-out over processes: total processes (run "
                        "the same command in each)")
    q.add_argument("--proc-id", dest="proc_id", type=int,
                   default=int(os.environ.get("FULGOR_PROC_ID", "0")))
    q.add_argument("--coordinator", dest="coordinator",
                   default=os.environ.get("FULGOR_COORDINATOR"),
                   help="host:port of process 0, where the "
                        "torch.distributed process group meets")
    q.set_defaults(fn=cmd_pseudoalign)

    kc = sub.add_parser("kmer-conservation",
                        help="per read: its runs of consecutive positive "
                             "k-mers with equal colour-set id")
    add_query_args(kc)
    kc.set_defaults(fn=cmd_kmer_conservation)

    km = sub.add_parser("kmer-matches",
                        help="per read: window positivity and per-colour "
                             "match counts")
    add_query_args(km)
    km.set_defaults(fn=cmd_kmer_matches)

    s = sub.add_parser("stats")
    s.add_argument("-i", dest="index_filename", required=True)
    s.set_defaults(fn=cmd_stats)

    pf = sub.add_parser("print-filenames")
    pf.add_argument("-i", dest="index_filename", required=True)
    pf.set_defaults(fn=cmd_print_filenames)

    v = sub.add_parser("verify")
    v.add_argument("-i", dest="index_filename", required=True)
    v.set_defaults(fn=cmd_verify)

    d = sub.add_parser("dump")
    d.add_argument("-i", dest="index_filename", required=True)
    d.add_argument("-o", dest="output", required=True, help="output basename")
    d.set_defaults(fn=cmd_dump)

    ld = sub.add_parser("load",
                        help="build an index from dump files (GGCAT-free)")
    ld.add_argument("-i", dest="input_basename", required=True)
    ld.add_argument("-o", dest="output", required=True)
    ld.add_argument("-m", dest="m", type=int, default=19)
    ld.set_defaults(fn=cmd_load)

    ck = sub.add_parser("check", help="self-check an index (optionally vs a "
                                      "base index)")
    ck.add_argument("-i", dest="index_filename", required=True)
    ck.add_argument("--against", dest="against", default=None,
                    help="base index to cross-validate color sets against")
    ck.add_argument("--verbose", action="store_true")
    ck.set_defaults(fn=cmd_check)

    co = sub.add_parser("color",
                        help="re-compress an index (meta/diff/meta-diff)")
    co.add_argument("-i", dest="index_filename", required=True)
    co.add_argument("-d", dest="tmp_dir", default=".",
                    help="(accepted for parity)")
    co.add_argument("--meta", action="store_true")
    co.add_argument("--diff", action="store_true")
    co.add_argument("--check", action="store_true")
    co.add_argument("--force", action="store_true",
                    help="overwrite an existing output index")
    co.add_argument("--verbose", action="store_true")
    co.set_defaults(fn=cmd_color)

    pm = sub.add_parser("permute", help="write filenames in clustered order")
    pm.add_argument("-i", dest="index_filename", required=True)
    pm.add_argument("-o", dest="output", required=True)
    pm.set_defaults(fn=cmd_permute)

    hp = sub.add_parser("help", help="print this helper and exit gracefully")
    hp.set_defaults(fn=lambda a: (p.print_help(), 0)[1])

    args = p.parse_args(argv)
    if (getattr(args, "threshold", None) is not None
            and not 0.0 < args.threshold <= 1.0):
        p.error("threshold must be a float in (0.0, 1.0]")
    _apply_thread_cap(getattr(args, "threads", 0))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
