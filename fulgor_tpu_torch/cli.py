"""fulgor-tpu-torch command line: `build`, `pseudoalign` (full
intersection, threshold union with -r, or full intersection once per
distinct colour-set list with --deduplicate), `kmer-conservation` and
`kmer-matches`, with the flags of fulgor_tpu's cli (reference
tools/fulgor.cpp). Queries run on the card unless --device says otherwise.

    python -m fulgor_tpu_torch.cli build -l list.txt -o idx [-k 31 -m 19] [--dict cuckoo]
    python -m fulgor_tpu_torch.cli pseudoalign -i idx.tfur -q reads.fq -o out [-r 0.8 | --deduplicate]
    python -m fulgor_tpu_torch.cli kmer-conservation -i idx.tfur -q reads.fq -o out
    python -m fulgor_tpu_torch.cli kmer-matches -i idx.tfur -q reads.fq -o out

On a mini index, FULGOR_PROBE_BUDGET=vb1,vb2,sc,RU selects the staged probe
and FULGOR_ANCHORED_PROBE=1 the run-anchored one for every query tool, as
in fulgor_tpu (FULGOR_PROBE_BUDGET=vb,sc trims the one-pass probe, and
FULGOR_PROBE_BUDGET_REDO=vb,sc sets the overflow redo's budget).
"""

from __future__ import annotations

import argparse
import os
import sys

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
    return 0


def cmd_pseudoalign(args):
    from .query.engine import QueryEngine

    if args.deduplicate and args.threshold is not None:
        print("Deduplication not available for threshold < 1.0. Remove "
              "--deduplicate flag.")
        return 1
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

    args = p.parse_args(argv)
    if (getattr(args, "threshold", None) is not None
            and not 0.0 < args.threshold <= 1.0):
        p.error("threshold must be a float in (0.0, 1.0]")
    _apply_thread_cap(getattr(args, "threads", 0))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
