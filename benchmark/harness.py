"""One run of one cell: set-up, the measured window of whole jobs, and the
comparison with the plain reference that decides `correct`.

A job is what the CLI's `pseudoalign` runs: a fresh QueryEngine on the
loaded Index, then one `pseudoalign_file` of a reads file to /dev/null in
ascii. Jobs run back to back until --seconds have passed; the loaded index
and its decode memo persist between them, as in one process that holds
the index. The reads come from --seed: JOB_FILES files of `reads_per_job`
reads each, job i reading file i % JOB_FILES.

The records reach the comparison from the bytes the timed calls write,
without the output going to disk: the engine's ascii formatter is wrapped
(Tee), and while a call runs its file is a Keep, which passes every write
on to /dev/null and keeps the bytes of the call's sampled lines. Where
those lines lie in the call's output is worked out from the rows, ids or
lists the engine handed the formatter (a line's length follows from its
read id and its colour ids), on a thread of the harness while the
formatter runs. The sample is SAMPLE_BLOCKS blocks of SAMPLE_BLOCK
consecutive reads of each file, drawn from the seed. After each job its
kept lines become (qid, n, digest) and every read id written is counted;
after the window the reference works out the sampled reads' records from
the corpus and the reads, and each job's are compared with them.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

from benchmark import cells

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "fulgor_tpu")
BATCH = 32768  # the CLI's --batch-size default
JOB_FILES = 2
SAMPLE_BLOCK = 16
SAMPLE_BLOCKS = 64
# where a colour id's decimal digits grow
_TENS = 10 ** np.arange(1, 10, dtype=np.uint32)


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one that
    no run may load."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def host_cpu():
    """The process's CPU seconds so far, every thread: user, system."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime


def cpu_note(a, b, wall: float) -> str:
    du, ds = (y - x for x, y in zip(a, b))
    return (f"cpu user {du:.2f} s, system {ds:.2f} s ({(du + ds) / wall:.2f}"
            " cores)")


def host_probe_ms() -> float:
    """A fixed piece of single-threaded work, timed: how fast the host
    runs this process between jobs (the run's log only)."""
    t0 = time.perf_counter()
    sum(i * i for i in range(200_000))
    return 1e3 * (time.perf_counter() - t0)


def seeds_of(seed: int, *path) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % 2**64, *path])


def _digits(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.int64)
    d = np.ones(x.shape, dtype=np.int64)
    b = 10
    while x.size and b <= x.max():
        d += x >= b
        b *= 10
    return d


def bits_body_lengths(rows) -> np.ndarray:
    """Bytes of each bit row's "\\t<n>\\t<c1>...\\n": 2 + digits(n) + 2n,
    and one more for each colour at or past 10, 100, 1,000, ..."""
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    pc = np.bitwise_count(rows)
    n = pc.sum(axis=1, dtype=np.uint32).astype(np.int64)
    past = np.zeros(len(rows), dtype=np.int64)
    for b in _TENS[_TENS < 32 * rows.shape[1]].tolist():
        w, s = divmod(b, 32)
        past += pc[:, w + 1:].sum(axis=1, dtype=np.uint32)
        past += np.bitwise_count(rows[:, w] >> np.uint32(s))
    return 2 + _digits(n) + 2 * n + past


def list_lines(qids, lists) -> np.ndarray:
    """Bytes of each read's ascii line from its ascending colour list."""
    n = np.fromiter((len(c) for c in lists), dtype=np.int64,
                    count=len(lists))
    past = np.fromiter(
        (len(c) * len(_TENS) - int(np.searchsorted(
            c, _TENS.astype(c.dtype)).sum()) if len(c) else 0
         for c in map(np.asarray, lists)), dtype=np.int64, count=len(lists))
    return _digits(qids) + 2 + _digits(n) + 2 * n + past


def _spans(lengths, js):
    """[start, end) of lines js of a call's output, from each line's
    length."""
    ln = lengths()
    end = np.cumsum(ln)
    return (end[js] - ln[js]).tolist(), end[js].tolist()


class Keep:
    """The formatter's file while one call runs: every write goes on to
    the real file; the bytes inside `spans` (a future of the sampled
    lines' [start, end) offsets into the call's output) are kept."""

    def __init__(self, f, spans):
        self.f, self.spans, self.pos = f, spans, 0
        self.parts = None

    def write(self, b):
        out = self.f.write(b)
        if self.parts is None:
            self.start, self.end = self.spans.result()
            self.parts = [[] for _ in self.start]
            self.k = 0
        mv = memoryview(b)
        lo, hi = self.pos, self.pos + len(mv)
        while self.k < len(self.end) and self.end[self.k] <= lo:
            self.k += 1
        i = self.k
        while i < len(self.start) and self.start[i] < hi:
            a, e = max(self.start[i], lo), min(self.end[i], hi)
            if a < e:
                self.parts[i].append(mv[a - lo: e - lo].tobytes())
            i += 1
        self.pos = hi
        return out

    def lines(self) -> list:
        start, _end = self.spans.result()
        return [b"".join(p) for p in self.parts or [[] for _ in start]]


class Tee:
    """The program's ascii formatter, every call passed on whole, as the
    engine made it; while a call that holds sampled reads runs, its file
    is a Keep (see the module docstring)."""

    def __init__(self, real, capture):
        self.real = real
        self.cap = capture

    def _call(self, method, qids, args, lengths):
        q = np.asarray(qids, dtype=np.int64)
        self.cap.seen.append(q.copy())
        inside = np.flatnonzero((q >= 0) & (q < len(self.cap.mask)))
        js = inside[self.cap.mask[q[inside]]]
        if not len(js):
            return getattr(self.real, method)(*args)
        keep = Keep(self.real.f, self.cap.pool.submit(_spans, lengths, js))
        self.real.f = keep
        try:
            return getattr(self.real, method)(*args)
        finally:
            self.real.f = keep.f
            self.cap.lines.extend(zip(q[js].tolist(), keep.lines()))

    def write_batch(self, qids, colors_per_read):
        qids, lists = list(qids), list(colors_per_read)
        return self._call("write_batch", qids, (qids, lists),
                          lambda: list_lines(qids, lists))

    def write_batch_bits(self, qids, bits):
        return self._call("write_batch_bits", qids, (qids, bits),
                          lambda: _digits(qids) + bits_body_lengths(bits))

    def write_batch_bits_grouped(self, qids, rows, inv):
        return self._call(
            "write_batch_bits_grouped", qids, (qids, rows, inv),
            lambda: _digits(qids) + bits_body_lengths(rows)[np.asarray(inv)])

    def close(self):
        self.real.close()


class Capture:
    """What one job wrote: every read id, and the sampled reads' lines as
    (qid, bytes)."""

    def __init__(self, mask: np.ndarray, pool):
        self.mask = mask
        self.pool = pool
        self.seen: list = []
        self.lines: list = []

    def summary(self, n_reads: int) -> dict:
        """-> dict(lines {qid: (n, digest)}, not_once: reads written 0 or
        2+ times, dup_lines)."""
        ids = (np.concatenate(self.seen) if self.seen
               else np.zeros(0, np.int64))
        inside = ids[(ids >= 0) & (ids < n_reads)]
        times = np.bincount(inside, minlength=n_reads)
        not_once = int((times != 1).sum()) + int(len(ids) - len(inside))
        lines, dup = {}, 0
        for q, ln in self.lines:
            dup += q in lines
            try:
                n = int(ln.split(b"\t", 2)[1])
            except (IndexError, ValueError):
                n = -1
            lines[q] = (n, hashlib.blake2b(ln, digest_size=16).digest())
        return dict(lines=lines, not_once=not_once, dup_lines=dup)


@contextlib.contextmanager
def teed_formatter(engine_mod, state: dict):
    """pseudoalign_file's ascii formatter wrapped in a Tee while
    state['capture'] is set."""
    make = engine_mod.make_formatter

    def wrapped(fmt, path, num_colors):
        real = make(fmt, path, num_colors)
        cap = state.get("capture")
        return real if cap is None or fmt != "ascii" else Tee(real, cap)

    engine_mod.make_formatter = wrapped
    try:
        yield
    finally:
        engine_mod.make_formatter = make


def ensure_prepared(bench: cells.Bench, cfg: dict) -> str:
    out = cells.cache_dir(cfg, os.path.join(bench.dir, "cache"))
    if not os.path.exists(os.path.join(out, "figures.json")):
        root = os.path.dirname(bench.dir)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(HERE, "prepare.py"),
                        cfg["name"], "--bench-dir", bench.dir],
                       env=env, check=True, stdout=sys.stderr)
        log(f"corpus and index made in {time.perf_counter() - t0:.1f} s")
    return out


def make_reads(cell: dict, cfg: dict, cdir: str, seed: int, tmp: str):
    """The job files and the warm-up file of `seed`, and each job file's
    sample mask. -> (paths, warm path, masks, codes of each job file)."""
    from benchmark.corpus import simulate_reads, write_fastq

    codes = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
    offs = np.load(os.path.join(cdir, "genome_offs.npy"))
    rd = cfg["reads"]
    picked = np.arange(0, len(offs) - 1, rd["every"])
    # only the picked genomes' codes are read
    parts, sub = [], [0]
    for g in picked:
        parts.append(np.asarray(codes[offs[g]: offs[g + 1]]))
        sub.append(sub[-1] + len(parts[-1]))
    sub_codes = np.concatenate(parts)
    sub_offs = np.array(sub, dtype=np.int64)
    idxs = np.arange(len(picked))
    n = cell["reads_per_job"]
    paths, masks, all_codes = [], [], []
    for f in range(JOB_FILES):
        ss = seeds_of(seed, 1, f)
        rc = simulate_reads(sub_codes, sub_offs, idxs, n, rd["length"],
                            rd["error_rate"], rd["unmapped_frac"],
                            int(ss.generate_state(1)[0]))
        p = os.path.join(tmp, f"job{f}.fq.gz")
        write_fastq(p, rc)
        rng = np.random.default_rng(seeds_of(seed, 2, f))
        starts = rng.choice(n // SAMPLE_BLOCK, SAMPLE_BLOCKS,
                            replace=False) * SAMPLE_BLOCK
        mask = np.zeros(n, dtype=bool)
        for s in starts:
            mask[s: s + SAMPLE_BLOCK] = True
        paths.append(p)
        masks.append(mask)
        all_codes.append(rc)
    warm = os.path.join(tmp, "warm.fq.gz")
    write_fastq(warm, simulate_reads(
        sub_codes, sub_offs, idxs, cell["warm_reads"], rd["length"],
        rd["error_rate"], rd["unmapped_frac"],
        int(seeds_of(seed, 3).generate_state(1)[0])))
    return paths, warm, masks, all_codes


def one_job(QueryEngine, idx, path, tau, device, profiled):
    """A fresh engine and one pseudoalign_file. -> (stats, engine s,
    wall s)."""
    import torch

    mark = (torch.profiler.record_function if profiled
            else lambda _n: contextlib.nullcontext())
    t0 = time.perf_counter()
    with mark("bench.engine"):
        eng = QueryEngine(idx, batch_size=BATCH, device=device)
    t1 = time.perf_counter()
    with mark("bench.job"):
        st = eng.pseudoalign_file(path, os.devnull, threshold=tau)
    t2 = time.perf_counter()
    st["strategy"] = strategy(eng, tau)
    del eng
    return st, t1 - t0, t2 - t0


def strategy(eng, tau) -> str:
    """The colour step the engine took (QueryEngine.pseudoalign_file)."""
    if eng.use_lists:
        return "lists fetch"
    if tau is None:
        return "runs fetch" if eng.use_runs_fetch else "dense rows"
    return "runs scored on the host" if eng.use_tu_runs else "dense mask"


def reference_records(cfg, cdir, cell, masks, all_codes, device,
                      fingerprint_bits=None):
    """The reference's record of each sampled read of each job file, as
    its colour count and its ascii line's digest: [{qid: (n, digest)}] by
    file. fingerprint_bits: the control's k-mer keys (reference/exact.py
    genome_counts)."""
    from benchmark.reference.exact import (
        AsciiLines, colour_lists, genome_counts)

    codes = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
    offs = np.load(os.path.join(cdir, "genome_offs.npy"))
    qids = [np.flatnonzero(m) for m in masks]
    reads = np.concatenate([c[q] for c, q in zip(all_codes, qids)])
    npos, counts = genome_counts(codes, offs, reads, cfg["k"], device,
                                 fingerprint_bits=fingerprint_bits)
    lists = colour_lists(npos, counts, cell["tau"], cfg["colours"])
    fmt = AsciiLines(cfg["colours"])
    out, at = [], 0
    for q in qids:
        want = {}
        for i, x in enumerate(q.tolist()):
            cols = lists[at + i]
            want[x] = (len(cols), hashlib.blake2b(
                fmt.line(x, cols), digest_size=16).digest())
        out.append(want)
        at += len(q)
    return out


def compare(jobs, refs) -> dict:
    """The numbers compared, each with its limit, and what else the
    comparison saw."""
    wrong = not_once = sampled = redone = dup = 0
    first_bad = None
    for j in jobs:
        want = refs[j["file"]]
        got = j["capture"]["lines"]
        not_once += j["capture"]["not_once"]
        dup += j["capture"]["dup_lines"]
        redo = set(j["redo_ids"])
        for q, (n_want, digest) in want.items():
            sampled += 1
            redone += q in redo
            g = got.get(q)
            if g is None or g[1] != digest:
                wrong += 1
                if first_bad is None:
                    first_bad = (f"job {j['index']} read {q}: "
                                 f"{'no record' if g is None else g[0]} "
                                 f"colours written, {n_want} in the "
                                 "reference")
    return dict(
        checks={"records_wrong": {"value": wrong, "limit": 0},
                "reads_not_written_once": {"value": not_once + dup,
                                           "limit": 0}},
        sampled=sampled, sampled_redone=redone, first_bad=first_bad)


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(bench: cells.Bench, name: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of cell `name`. -> the result line's object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        log(f"card: {card_line()}")
    cdir = ensure_prepared(bench, cfg)
    from fulgor_tpu_torch.index import Index
    from fulgor_tpu_torch.ops import kernels
    from fulgor_tpu_torch.query import engine as engine_mod

    if on_card:
        t0 = time.perf_counter()
        kernels.library()
        log(f"kernels ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    idx = Index.load(os.path.join(cdir, "index.tfur"))
    log(f"index loaded in {time.perf_counter() - t0:.1f} s")
    state: dict = {}
    tau = cell["tau"]
    with tempfile.TemporaryDirectory(prefix="fulgor_bench_") as tmp, \
            teed_formatter(engine_mod, state), \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        paths, warm, masks, all_codes = make_reads(cell, cfg, cdir, seed,
                                                   tmp)
        log(f"reads made in {time.perf_counter() - t0:.1f} s")
        st, eng_s, wall = one_job(engine_mod.QueryEngine, idx, warm, tau,
                                  dev, False)
        log(f"warm-up job: {st['num_reads']} reads in {wall:.3f} s; colour "
            f"step: {st['strategy']}")
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")
        kernels.reset_launches()
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else []))
            prof.__enter__()
        jobs = []
        t_win = time.perf_counter()
        cpu0 = host_cpu()
        while True:
            probe = host_probe_ms()
            cpu_a = host_cpu()
            f = len(jobs) % len(paths)
            cap = state["capture"] = Capture(masks[f], pool)
            st, eng_s, wall = one_job(engine_mod.QueryEngine, idx, paths[f],
                                      tau, dev, traced)
            state["capture"] = None
            cpu_b = host_cpu()
            jobs.append(dict(index=len(jobs), file=f,
                             reads=st["num_reads"], wall_s=wall,
                             engine_s=eng_s,
                             stats={k: v for k, v in st.items()
                                    if k != "redo_ids"},
                             redo_ids=st["redo_ids"],
                             capture=cap.summary(len(masks[f]))))
            log(f"job {len(jobs) - 1}: {st['num_reads']} reads in "
                f"{wall:.3f} s (engine {eng_s:.3f}, parse "
                f"{st['parse_sec']:.3f}, query {st['query_sec']:.3f}, "
                f"host {st['host_sec']:.3f}, redo {st['redo_sec']:.3f}, "
                f"write {st['write_sec']:.3f}; {st['num_redo']} "
                f"redone, {st['num_mapped']} mapped; "
                f"{cpu_note(cpu_a, cpu_b, wall)}; probe {probe:.1f} ms "
                "before it)")
            if time.perf_counter() - t_win >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_win
        log(f"window's CPU: {cpu_note(cpu0, host_cpu(), window_s)} of "
            f"{os.cpu_count()}; probe {host_probe_ms():.1f} ms after it")
        trace = None
        if prof is not None:
            from benchmark.trace import reduce_events

            prof.__exit__(None, None, None)
            trace = reduce_events(prof.events(), dict(kernels.launches),
                                  window_s)
            del prof
        launches = {k: v for k, v in kernels.launches.items() if v}
        host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        card_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    run = dict(jobs=jobs, reads=sum(j["reads"] for j in jobs),
               wall=sum(j["wall_s"] for j in jobs), window_s=window_s,
               setup_s=setup_s, host_peak_gib=host_peak / 2**30,
               card_peak_gib=card_peak / 2**30, trace=trace,
               launches=launches)
    log(f"window: {len(jobs)} jobs, {run['reads']} reads in "
        f"{run['wall']:.3f} s of jobs ({window_s:.3f} s window): "
        f"{run['reads'] / run['wall']:.1f} reads/s; launches {launches}; "
        f"host peak {run['host_peak_gib']:.3f} GiB, card peak "
        f"{run['card_peak_gib']:.3f} GiB")
    # the program's state is freed before the reference runs
    del idx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = reference_records(cfg, cdir, cell, masks, all_codes, dev)
    cmp_ = compare(jobs, refs)
    log(f"reference and comparison in {time.perf_counter() - t0:.1f} s: "
        f"{cmp_['sampled']} sampled records ({cmp_['sampled_redone']} "
        f"redone) over {len(jobs)} jobs"
        + (f"; first difference: {cmp_['first_bad']}"
           if cmp_["first_bad"] else ""))
    return assemble(bench, name, traced, run, cmp_, card_peak, on_card)


def assemble(bench, name, traced, run, cmp_, card_peak, on_card) -> dict:
    import torch

    metrics = {}
    for m in bench.metrics(name, traced):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = cmp_["checks"]
    correct = is_correct(checks)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": int(card_peak)}
    out = {"correct": correct, "attempted": run["reads"],
           "failed": sum(c["value"] for c in checks.values()),
           "metrics": metrics, "device": device}
    if traced and run["trace"] is not None:
        from benchmark.trace import breakdown

        tr = run["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        out["breakdown"] = breakdown(tr)
        missed = {k: c - r for k, (c, r) in tr["guard"].items() if c != r}
        log(f"trace: {tr['recorded']} device events; launches counted and "
            f"recorded {tr['guard']}; missed by the profiler {missed or 0}")
    out["checks"] = checks
    return out


def main_result(result: dict) -> int:
    """Print the check lines last on stderr and the result last on stdout;
    refuse (no result) where a forbidden module was loaded by then: the
    program, the reference, the metric readers and the trace's reduction
    have all been imported."""
    bad = forbidden_modules()
    if bad:
        print(f"[bench] forbidden modules loaded: {bad}", file=sys.stderr,
              flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
