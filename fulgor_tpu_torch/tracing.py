"""Stage spans and counters of the port's jobs.

`with span(name):` times a stage on the calling thread; spans nest through
a per-thread stack, so each knows its parent. A span's perf_counter_ns
duration always adds to the per-name total of the Totals its thread
reports into (`into`, `job`), and `count` adds an integer there: the
engines' stats dicts are made from these. A span opened with process=True
(the index's load and first decode) also adds to PROCESS.

Inside `recording()` every span is also kept as a Span. `drain()` hands
them out with PROCESS's totals and two (perf_counter_ns, time_ns) pairs,
which put them on the Unix clock of torch.profiler's events.

No span or counter goes inside a per-read or per-key loop. The program
opens no `torch.profiler.record_function`: such a range lands on the CUDA
timeline, where a trace reduction that counts every device event as busy
would count it as device work.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import resource
import threading
import time
from collections import namedtuple

# parent: the enclosing span's id or 0; job: the id of its thread's Totals
Span = namedtuple("Span", "id name start_ns end_ns thread parent job")

_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()  # .totals: Totals or None; .stack: open span ids
_rec = {"on": False, "spans": [], "clock": None}
_THREAD = getattr(resource, "RUSAGE_THREAD", None)  # Linux only


class Totals:
    """Per-name span ns (`ns`; the latest span of each name in `last`) and
    counters of one job or one engine's construction."""

    def __init__(self):
        self.id = next(_ids)
        self.ns, self.last, self.counts = {}, {}, {}

    def add(self, name: str, ns: int):
        with _lock:
            self.ns[name] = self.ns.get(name, 0) + ns
            self.last[name] = ns

    def sec(self, name: str) -> float:
        return self.ns.get(name, 0) / 1e9

    def stats(self) -> dict:
        """Each span's total as `<name>_sec`, each counter under its name,
        dots as underscores."""
        out = {f"{n.replace('.', '_')}_sec": v / 1e9
               for n, v in self.ns.items()}
        out.update((n.replace(".", "_"), v) for n, v in self.counts.items())
        return out


PROCESS = Totals()


def current() -> Totals | None:
    """The Totals the calling thread reports into, if any."""
    return getattr(_local, "totals", None)


@contextlib.contextmanager
def into(totals: Totals | None):
    """The calling thread reports into `totals` inside the block."""
    prev = current()
    _local.totals = totals
    try:
        yield totals
    finally:
        _local.totals = prev


class span:
    """`with span(name):` times the block as stage `name`."""

    __slots__ = ("name", "process", "id", "parent", "t0")

    def __init__(self, name: str, process: bool = False):
        self.name, self.process = name, process

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        tot = current()
        if tot is not None:
            tot.add(self.name, t1 - self.t0)
        if self.process:
            PROCESS.add(self.name, t1 - self.t0)
        if _rec["on"]:
            _rec["spans"].append(Span(
                self.id, self.name, self.t0, t1,
                threading.current_thread().name, self.parent,
                tot.id if tot is not None else 0))
        return False


def traced(name: str, process: bool = False):
    """A function run inside span(name, process)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name, process):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n: int):
    """Add n to counter `name` of the calling thread's Totals."""
    tot = current()
    if tot is not None:
        with _lock:
            tot.counts[name] = tot.counts.get(name, 0) + int(n)


@contextlib.contextmanager
def cpu(thread: str | None = None):
    """Count the block's CPU as sys_ns, user_ns and minflt: the process's
    (RUSAGE_SELF), or with a label the calling thread's alone
    (RUSAGE_THREAD, as `<counter>.<label>`; nothing where it is missing)."""
    who = resource.RUSAGE_SELF if thread is None else _THREAD
    if who is None:
        yield
        return
    a = resource.getrusage(who)
    try:
        yield
    finally:
        b = resource.getrusage(who)
        sfx = "" if thread is None else f".{thread}"
        count("sys_ns" + sfx, int((b.ru_stime - a.ru_stime) * 1e9))
        count("user_ns" + sfx, int((b.ru_utime - a.ru_utime) * 1e9))
        count("minflt" + sfx, b.ru_minflt - a.ru_minflt)


@contextlib.contextmanager
def job():
    """One job on the calling thread: a fresh Totals, the process's and
    the thread's (`main`) CPU counters and the span `job`. -> Totals."""
    with into(Totals()) as tot, cpu(), cpu("main"), span("job"):
        yield tot


@contextlib.contextmanager
def recording():
    """Keep every span that ends inside the block, on any thread, until
    drain(); what an earlier recording kept undrained is dropped."""
    _rec.update(spans=[], clock=(time.perf_counter_ns(), time.time_ns()),
                on=True)
    try:
        yield
    finally:
        _rec["on"] = False


def drain() -> dict:
    """-> dict(spans: the recorded Spans, each once; process: {name: s}
    of PROCESS; clock: [(perf_counter_ns, time_ns)] at recording's start
    and now)."""
    spans, _rec["spans"] = _rec["spans"], []
    return dict(spans=spans,
                process={n: v / 1e9 for n, v in PROCESS.ns.items()},
                clock=[_rec["clock"], (time.perf_counter_ns(),
                                       time.time_ns())])
