"""The traced run's reduction of a torch.profiler trace. The busy-interval
union and the launch-count guard are frozen copies of chip_smoke.py's
`device_busy` (chip_smoke.py:1818-1849) and `kernel_pattern`
(chip_smoke.py:1810-1813): busy time is the union of the card's kernel and
copy intervals, and a launch counter's kernels are `{name}_kernel` or
`{name}_<step>_kernel`."""

from __future__ import annotations

import re

import numpy as np

MARK = "bench."  # the harness's own record_function ranges
GAPS_LABELLED = 400  # the longest idle gaps that are given a label


def kernel_pattern(name):
    return re.compile(rf"\b{name}(_\w+)?_kernel\b")


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def busy_union(intervals):
    """-> (busy us, merged [(start, end)]) of (start, end) intervals."""
    merged = []
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = e
            else:
                merged.append([s, e])
            end = e
    return busy, merged


def reduce_events(events, launches: dict, window_s: float) -> dict:
    """The trace's figures: busy_s, kernel_s, the per-name device time,
    the idle gaps by what the host was doing, and the launch guard (each
    counter's launches against the kernels the profiler recorded)."""
    from torch.autograd import DeviceType

    # the harness's ranges appear on the device's timeline too, as
    # annotations: they are no device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(MARK)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    busy_us, merged = busy_union(iv)
    per_name: dict = {}
    kernel_us = 0.0
    for e in dev:
        us = e.time_range.elapsed_us()
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        if not is_copy(e.name):
            kernel_us += us
    guard = {}
    for name, n in launches.items():
        if n:
            pat = kernel_pattern(name)
            guard[name] = (n, sum(1 for e in dev if pat.search(e.name)))
    marks = [(e.time_range.start, e.time_range.end, e.name[len(MARK):])
             for e in host if e.name.startswith(MARK)]
    ops = [(e.time_range.start, e.time_range.end, e.name)
           for e in host if not e.name.startswith(MARK)]
    t0 = min([m[0] for m in marks] or [0.0])
    t1 = max([m[1] for m in marks] or [0.0])
    gaps = []
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps.append((e - s, s, e))
    gaps.sort(reverse=True)
    idle = {}
    o_s = np.array([o[0] for o in ops]) if ops else np.zeros(0)
    o_e = np.array([o[1] for o in ops]) if ops else np.zeros(0)
    for dur, s, e in gaps:
        label = gap_label(s, e, marks, ops, o_s, o_e) \
            if len(idle) < GAPS_LABELLED else "other"
        idle[label] = idle.get(label, 0.0) + dur
    return dict(busy_s=busy_us / 1e6, kernel_s=kernel_us / 1e6,
                window_s=window_s, per_name=per_name, guard=guard,
                idle=idle, recorded=len(dev))


def gap_label(s, e, marks, ops, o_s, o_e) -> str:
    """The harness range around the gap's middle, and the host op that
    overlaps the gap longest (`python` where none covers a tenth of it)."""
    mid = 0.5 * (s + e)
    where = "between_jobs"
    for ms, me, name in marks:
        if ms <= mid <= me:
            where = name
    label = "python"
    if len(o_s):
        ov = np.minimum(o_e, e) - np.maximum(o_s, s)
        j = int(np.argmax(ov))
        if ov[j] > 0.1 * (e - s):
            label = ops[j][2]
    return f"{where}:{label}"


def breakdown(red: dict) -> dict:
    """At most 10 of each, in seconds, unrounded."""
    ops = sorted(red["per_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(red["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}
