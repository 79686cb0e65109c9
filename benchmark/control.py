"""The control of a cell's comparison: the reference put in the program's
place with one guarantee broken, which the comparison must find wrong.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

The guarantee broken is exact k-mer membership: the control keys the
k-mers by a fingerprint of the configuration's `control_fingerprint_bits`
bits (reference/exact.py `fingerprint`) instead of their whole 62-bit
code, the step a faster dictionary would take by matching fingerprints
without the text. For each seed it makes the reads and the sample exactly
as a run does (harness.make_reads), works the sampled reads' records out
with the control, hands them to the run's own comparison (harness.compare)
as the program's records, and prints the numbers compared and `correct`:
one line a seed, then one JSON line. The benchmark's own runs never run
it. The corpus and index are made first where absent, as a run makes
them.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def control_run(bench, name: str, seed: int, device) -> dict:
    """-> dict(seed, sampled, checks, correct) of the control's records
    judged by the run's comparison."""
    from benchmark import harness

    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    cdir = harness.ensure_prepared(bench, cfg)
    with tempfile.TemporaryDirectory(prefix="fulgor_control_") as tmp:
        _p, _w, masks, all_codes = harness.make_reads(cell, cfg, cdir, seed,
                                                      tmp)
    refs = harness.reference_records(cfg, cdir, cell, masks, all_codes,
                                     device)
    ctrl = harness.reference_records(
        cfg, cdir, cell, masks, all_codes, device,
        fingerprint_bits=cfg["control_fingerprint_bits"])
    jobs = [dict(index=f, file=f, redo_ids=[],
                 capture=dict(lines=lines, not_once=0, dup_lines=0))
            for f, lines in enumerate(ctrl)]
    cmp_ = harness.compare(jobs, refs)
    return dict(seed=seed, sampled=cmp_["sampled"], checks=cmp_["checks"],
                correct=harness.is_correct(cmp_["checks"]),
                bits=cfg["control_fingerprint_bits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    from benchmark import cells

    if not torch.cuda.is_available():
        print("[control] no card visible", file=sys.stderr)
        return 2
    bench = cells.Bench(HERE)
    out = []
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = control_run(bench, args.workload, int(s), torch.device("cuda"))
        r["seconds"] = time.perf_counter() - t0
        print(f"[control] {args.workload} seed {s}: correct {r['correct']}"
              f"; records_wrong {r['checks']['records_wrong']['value']} "
              f"of {r['sampled']} sampled, limit "
              f"{r['checks']['records_wrong']['limit']} ({r['bits']}-bit "
              f"fingerprints; {r['seconds']:.1f} s)",
              file=sys.stderr, flush=True)
        out.append(r)
    print(json.dumps({"workload": args.workload, "runs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
