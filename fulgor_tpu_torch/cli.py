"""fulgor-tpu-torch command line: `build` and `pseudoalign` (full
intersection), with the flags of fulgor_tpu's cli (reference
tools/fulgor.cpp). Queries run on the card unless --device says otherwise.

    python -m fulgor_tpu_torch.cli build -l list.txt -o idx [-k 31 -m 19]
    python -m fulgor_tpu_torch.cli pseudoalign -i idx.tfur -q reads.fq -o out
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
        ram_gib=args.ram_gib,
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

    idx = Index.load(args.index_filename)
    eng = QueryEngine(idx, batch_size=args.batch_size, device=args.device)
    eng.pseudoalign_file(args.query_filename, args.output_filename,
                         fmt=args.format, verbose=args.verbose)
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
    b.add_argument("--verbose", action="store_true")
    b.add_argument("--check", action="store_true")
    b.add_argument("--force", action="store_true",
                   help="overwrite an existing output index")
    b.set_defaults(fn=cmd_build)

    q = sub.add_parser("pseudoalign",
                       help="pseudoalign reads (full intersection)")
    q.add_argument("-i", dest="index_filename", required=True)
    q.add_argument("-q", dest="query_filename", required=True)
    q.add_argument("-o", dest="output_filename", required=True)
    q.add_argument("-t", dest="threads", type=int, default=0,
                   help="cap host threads (0 = all cores)")
    q.add_argument("--batch-size", dest="batch_size", type=int, default=32768)
    q.add_argument("--format", dest="format", default="ascii",
                   choices=["ascii", "binary", "compressed"])
    q.add_argument("--device", dest="device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    q.add_argument("--verbose", action="store_true")
    q.set_defaults(fn=cmd_pseudoalign)

    args = p.parse_args(argv)
    _apply_thread_cap(getattr(args, "threads", 0))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
