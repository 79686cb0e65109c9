"""The program's stage spans on a traced run's profiler timeline.

The program (fulgor_tpu_torch.tracing) keeps its spans on perf_counter_ns
while it records, with two (perf_counter_ns, time_ns) pairs; the profiler
gives each event in microseconds after `trace_start_ns()`, on time_ns's
clock. `place` maps the one onto the other; `attribute` then sets each
job's `job` span against the harness's `bench.job` range around it (the
clock check, `check`), measures how much of each job the main thread's
spans cover, and puts every idle gap of the card inside a job (between
the busy intervals of trace.busy_union) down to the innermost main-thread
span at the gap's middle, with what the writer and parse threads were in
then: `redo.mirror|writer:write.format|parse:parse.read`, `-` for a thread
in no span, `unspanned` where the main thread was in none. A gap takes
its middle's label whole, so a long gap's label stands for all of it.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

runs one `--trace 1` run of the cell (harness.run_cell) with the
program's recording on, keeps the profiler it ran under, and prints the
result line with `breakdown.idle_by_span` added (the 10 largest labels,
seconds) after the checks. It needs a card, as benchmark/run.py does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":  # run as a script: the repo's root on the path
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark.trace import MARK, busy_union  # noqa: E402

CLOCK_US = 1000.0  # the clock check's tolerance (check)
TOP = 10
WRITER, PARSE = "fulgor-writer", "fulgor-parse"  # the program's threads


def log(msg):
    print(f"[spans] {msg}", file=sys.stderr, flush=True)


def place(drained: dict, trace_start_ns: int) -> list:
    """-> [(Span, start us, end us)] on the profiler's timeline: each
    perf_counter_ns reading put on time_ns by the drained clock pairs
    (linear between them), less trace_start_ns."""
    (p0, u0), (p1, u1) = drained["clock"]
    rate = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0

    def us(t):
        return (u0 - trace_start_ns + (t - p0) * rate) / 1e3

    return [(s, us(s.start_ns), us(s.end_ns)) for s in drained["spans"]]


def from_events(events) -> tuple:
    """-> (the harness's `bench.job` ranges [(start, end)], the card's
    merged busy intervals) of a profiler's events, in us."""
    from torch.autograd import DeviceType

    jobs = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.name == MARK + "job")
    _busy, merged = busy_union(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == DeviceType.CUDA and not e.name.startswith(MARK))
    return jobs, merged


def _union(iv) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(iv):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _innermost(spans, t) -> str:
    """The name of the latest-opened span of `spans` that covers t."""
    best = None
    for s, a, b in spans:
        if a <= t <= b and (best is None or a > best[1]):
            best = (s, a)
    return "-" if best is None else best[0].name


def attribute(marks, busy, placed) -> dict:
    """marks: the bench.job ranges; busy: the card's merged busy intervals;
    placed: place()'s spans. -> dict(jobs: per program job inside the
    trace, its clock offsets (us), whether it opened inside its range, its
    main thread's coverage (%); idle: {label: s} of the gaps inside the
    ranges; idle_s, unspanned_s)."""
    by_job: dict = {}
    for s, a, b in placed:
        by_job.setdefault(s.job, []).append((s, a, b))
    jobs, idle = [], {}
    busy = np.asarray(busy, dtype=np.float64).reshape(-1, 2)
    for jid, spans in by_job.items():
        top = [x for x in spans if x[0].name == "job"]
        if len(top) != 1:
            continue
        js, ja, jb = top[0]
        if ja < 0:  # before the profiler started (a warm-up job)
            continue
        mark = next(((ms, me) for ms, me in marks if ms <= ja <= me), None)
        main = [x for x in spans if x[0].thread == js.thread
                and x[0].name != "job"]
        cover = _union([(max(a, ja), min(b, jb)) for _, a, b in main
                        if b > ja and a < jb])
        row = dict(job=jid, wall_s=(jb - ja) / 1e6,
                   covered=100.0 * cover / (jb - ja) if jb > ja else 0.0,
                   inside=mark is not None)
        jobs.append(row)
        if mark is None:
            continue
        row["offsets_us"] = (ja - mark[0], mark[1] - jb)
        writer = [x for x in spans if x[0].thread.startswith(WRITER)]
        parse = [x for x in spans if x[0].thread.startswith(PARSE)]
        inside = busy[(busy[:, 1] > mark[0]) & (busy[:, 0] < mark[1])]
        edges = np.concatenate([[mark[0]], inside.ravel(), [mark[1]]])
        for s, e in zip(edges[::2], edges[1::2]):
            s, e = max(s, mark[0]), min(e, mark[1])
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            m = _innermost(main, mid)
            label = ("unspanned" if m == "-" else
                     f"{m}|writer:{_innermost(writer, mid)}"
                     f"|parse:{_innermost(parse, mid)}")
            idle[label] = idle.get(label, 0.0) + float(e - s) / 1e6
    total = sum(idle.values())
    return dict(jobs=jobs, idle=idle, idle_s=total,
                unspanned_s=idle.get("unspanned", 0.0))


def top(idle: dict) -> list:
    return [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])
            [:TOP]]


def check(rep: dict) -> bool:
    """Log each job's coverage and offsets, and the clock check. -> True
    where every job's span lies inside its bench.job range and the
    mapping is pinned within CLOCK_US. A mapping off by d adds d to every
    start offset and takes it from every end offset, and the code between
    the harness's range and the program's span takes time of its own
    (0.2-10 ms a job on the card, the garbage collector's pauses
    included), so d lies between minus the smallest end offset and the
    smallest start offset."""
    ok = bool(rep["jobs"])
    for j in rep["jobs"]:
        off = j.get("offsets_us")
        good = j["inside"] and off is not None and min(off) >= 0.0
        ok &= good
        log(f"job {j['job']}: {j['wall_s']:.3f} s, main thread's spans "
            f"cover {j['covered']:.2f}%; bench.job offsets (us) {off}: "
            f"{'inside' if good else 'OUTSIDE'}")
    if ok:
        lo = -min(j["offsets_us"][1] for j in rep["jobs"])
        hi = min(j["offsets_us"][0] for j in rep["jobs"])
        ok = max(-lo, hi) <= CLOCK_US
        log(f"clock check: the mapping is off by {lo:.0f} to {hi:.0f} us: "
            f"{'ok' if ok else 'FAILED'}")
    share = (100.0 * rep["unspanned_s"] / rep["idle_s"] if rep["idle_s"]
             else 0.0)
    log(f"idle inside the jobs {rep['idle_s']:.3f} s, unspanned "
        f"{rep['unspanned_s']:.3f} s ({share:.2f}%)")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from benchmark import cells, harness
    from fulgor_tpu_torch import tracing

    if not torch.cuda.is_available():
        print("[spans] no card visible. No run on the CPU.", file=sys.stderr)
        return 2
    kept = {}
    real = torch.profiler.profile

    class Kept(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["prof"] = self

    torch.profiler.profile = Kept
    try:
        with tracing.recording():
            result = harness.run_cell(cells.Bench(HERE), args.workload,
                                      args.seed, args.seconds, True, "cuda",
                                      T_START)
    finally:
        torch.profiler.profile = real
    prof = kept["prof"]
    rep = attribute(*from_events(prof.events()), place(
        tracing.drain(), prof.profiler.kineto_results.trace_start_ns()))
    ok = check(rep)
    result.setdefault("breakdown", {})["idle_by_span"] = top(rep["idle"])
    main_only: dict = {}
    for label, s in rep["idle"].items():
        key = label.split("|", 1)[0]
        main_only[key] = main_only.get(key, 0.0) + s
    log(f"idle by the main thread's span: {top(main_only)}")
    code = harness.main_result(result)
    return code if ok else code or 4


if __name__ == "__main__":
    sys.exit(main())
