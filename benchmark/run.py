"""The benchmark of fulgor_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the port. The cell, its
configuration, its traffic and its metrics are found by name
(benchmark/cells.py); the run is benchmark/harness.py. With --trace 0 the
result line holds the cell's end-to-end metrics, with --trace 1 its
per-layer ones, read under torch.profiler. It exits non-zero and prints no
result where no card, or too few, is visible, and where jax, jaxlib, flax
or fulgor_tpu was loaded. The last line of standard output is the result;
the last lines of standard error are the numbers compared, each beside its
limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import cells

    bench = cells.Bench(HERE)
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] cell {args.workload} needs {chips} card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible. No run on the CPU.", file=sys.stderr)
        return 2
    from benchmark import harness

    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    return harness.main_result(result)


if __name__ == "__main__":
    sys.exit(main())
