#!/usr/bin/env python3
"""Drive fulgor_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--genomes 512] [--reads 250000] [--seed 27]

Phases, each printing its own lines; any failure exits non-zero before the
last line, which is printed only when every phase passed:

  1. device   a CUDA card is required; its name and power limit as
              nvidia-smi reports them.
  2. build    the CUDA kernels (csrc/*.cu, one nvcc per source in
              parallel) and the native host library, from this checkout.
  3. index    a pansal4546-calibrated pangenome (fulgor_tpu's bench.py
              simulator settings) cut to --genomes genomes, built at k=31,
              m=19 into a temporary directory removed at exit; 150 bp reads
              at 0.5% errors sampled from every 16th genome.
  4. kernels  one full batch of real reads (B=32768, W=160): each kernel
              against its plain PyTorch version, bit for bit (tolerance 0),
              with times (kernels: median device time per launch from
              torch.profiler, with L2 flushed before each launch and warm;
              plain versions: CUDA events) and bounds.
  5. e2e      QueryEngine.pseudoalign_file on the card over every read:
              a warm-up, five timed runs to /dev/null (median and spread),
              each with the launch counts reset just before it, a profiled
              run for the card's busy share, then a run to a file checked
              against the exact host mirror (lookup_host_exact + set
              intersection) for every redone read and a seeded sample of
              2,000 others.

The line before the last is one JSON object of per-kernel numbers; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import platform
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fulgor_tpu_torch.build.builder import build_index
from fulgor_tpu_torch.index import Index
from fulgor_tpu_torch.io.simulate import (
    simulate_pangenome_blocks, simulate_reads, write_fastq,
)
from fulgor_tpu_torch.native import lib as native
from fulgor_tpu_torch.ops import kernels
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.ops.intersect import fi_and, fi_and_plain
from fulgor_tpu_torch.ops.minidict2 import lookup_host_exact
from fulgor_tpu_torch.ops.prep import PREP_FIELDS, window_prep, window_prep_plain
from fulgor_tpu_torch.ops.probe import minidict2_probe, minidict2_probe_plain
from fulgor_tpu_torch.ops.u32 import mix32, mulhi32, u32
from fulgor_tpu_torch.query.engine import QueryEngine

# fulgor_tpu bench.py:53-55: the pansal4546 calibration (4,546 Salmonella
# genomes in the reference's published index) of the block simulator
PANSAL = dict(num_genes=480, gene_len=2500, core_frac=0.6, loss_rate=0.03,
              mut_per_branch=65, ancestral_mut_frac=0.075,
              gain_per_branch=18, gain_len=2500, pool_genes=9000)
FULL_GENOMES = 4546
K, M = 31, 19
READ_LEN, WIDTH, BATCH = 150, 160, 32768
# NVIDIA's H100 SXM data sheet at 700 W: HBM3 bandwidth, and the fp32 rate
# outside the tensor cores, the nearest published rate for integer work
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
REPS_KERNEL, REPS_PLAIN = 20, 3
E2E_PASSES = 5


def log(msg):
    print(msg, flush=True)


def kernel_ms(fn, name, reps, flush=None):
    """Median device milliseconds of one launch of kernel `name` over
    `reps` calls of fn after a warm-up, as torch.profiler records them.
    flush: a device buffer zeroed before each call, so that every launch
    starts with a cold L2. Raises unless exactly `reps` launches were
    recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
          if f"{name}_kernel" in e.name]
    if len(ts) != reps:
        raise RuntimeError(f"the profiler recorded {len(ts)} of {reps} "
                           f"{name} launches")
    return statistics.median(ts)


def time_ms(fn, reps):
    """Median milliseconds of `reps` timed calls (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over a tuple of outputs, u32 data compared
    as unsigned values."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            g, w = g.to(torch.int64), w.to(torch.int64)
        else:
            g, w = u32(g), u32(w)
        err = max(err, int((g - w).abs().max().item()) if g.numel() else 0)
    return err


def host_cpu() -> str:
    """The host CPU's model name, from /proc/cpuinfo or lscpu, else its
    architecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, val = ln.partition(":")
                if key.strip() in ("model name", "Model", "cpu model"):
                    return val.strip()
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        for ln in out.splitlines():
            key, _, val = ln.partition(":")
            if key.strip() == "Model name":
                return val.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return f"unknown {platform.machine()} CPU"


def phase_device():
    if not torch.cuda.is_available():
        log("FAIL device: torch.cuda.is_available() is false")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; host {host_cpu()}, "
        f"{os.cpu_count()} cores visible")
    return card


def phase_build():
    s = kernels.build_seconds()
    regs = [ln.strip() for ln in open(os.path.join(kernels.BUILD, "build.log"))
            if "registers" in ln or "spill" in ln]
    log(f"[build] CUDA kernels built in {s:.2f} s ({len(kernels.SOURCES)} "
        "sources, one nvcc each, in parallel)")
    for ln in regs:
        log(f"[build]   {ln}")
    t0 = time.perf_counter()
    native._load()
    log(f"[build] native host library ready in "
        f"{time.perf_counter() - t0:.2f} s")


def phase_index(tmp, genomes, num_reads, seed):
    t0 = time.perf_counter()
    paths = simulate_pangenome_blocks(os.path.join(tmp, "corpus"), genomes,
                                      seed=seed, **PANSAL)
    t1 = time.perf_counter()
    idx = build_index(paths, k=K, m=M)
    t2 = time.perf_counter()
    log(f"[index] pansal4546 calibration cut to {genomes} of {FULL_GENOMES} "
        f"genomes (build time): simulated in {t1 - t0:.1f} s, built in "
        f"{t2 - t1:.1f} s")
    codes, names = simulate_reads(paths[::16], num_reads, READ_LEN,
                                  seed=seed + 1)
    reads = os.path.join(tmp, "reads.fastq.gz")
    write_fastq(reads, codes, names)
    log(f"[index] {idx.num_kmers} k-mers, {idx.num_color_sets} colour sets, "
        f"{idx.num_colors} colours, {idx.num_unitigs} unitigs; "
        f"{num_reads} reads of {READ_LEN} bp from {len(paths[::16])} genomes "
        f"({time.perf_counter() - t2:.1f} s)")
    return idx, codes, reads


def kernel_times(fn, name, flush):
    """(cold-L2 ms, warm ms) of one launch of kernel `name`: the first with
    `flush` zeroed before every launch, as on the main path, where each
    batch's K1 writes far more than L2 holds before K2 and K3 run; the
    second on the same inputs launched back to back."""
    return (kernel_ms(fn, name, REPS_KERNEL, flush),
            kernel_ms(fn, name, REPS_KERNEL))


def phase_kernels(idx, eng, codes):
    dev = eng.device
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    n = min(BATCH, len(codes))
    chunk[:n, :READ_LEN] = codes[:n]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    slots, text32, skew = eng.table
    m, num_slots = eng.dparams
    Wk = WIDTH - K + 1
    lanes = BATCH * Wk
    # 256 MiB, five times the card's 50 MB L2
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []

    # K1
    prep = window_prep(c2, bd, width=WIDTH, k=K, m=M)
    plain = window_prep_plain(c2, bd, width=WIDTH, k=K, m=M)
    torch.cuda.synchronize()
    err1 = max_abs_err(prep, plain)
    bytes_in1 = BATCH * (WIDTH // 4 + WIDTH // 8)
    bytes1 = bytes_in1 + lanes * (9 * 4 + 3)
    ops1 = lanes * 150  # ~hash pair per m-mer, w-wide minimum, packings
    ms1, warm1 = kernel_times(
        lambda: window_prep(c2, bd, width=WIDTH, k=K, m=M), "window_prep",
        flush)
    rows.append(dict(
        name="window_prep", source="fulgor_tpu_torch/csrc/prep.cu",
        replaces="fulgor_tpu/ops/minidict2.py:1004", max_abs_err=err1,
        ms=ms1, warm_ms=warm1,
        plain_ms=time_ms(lambda: window_prep_plain(c2, bd, width=WIDTH, k=K,
                                                   m=M), REPS_PLAIN),
        bytes=bytes1, ops=ops1))
    # pL and pR (8 of the 39 bytes a lane) are written but read by nothing
    # on the main path: the bound of the outputs K2 reads
    bytes1_used = bytes_in1 + lanes * (7 * 4 + 3)
    log(f"[kernels] window_prep without pL/pR: {bytes1_used / 1e6:.1f} MB, "
        f"bound {bytes1_used / HBM_BYTES_PER_S * 1e3:.4f} ms")

    # K2 at the engine's budget, and at the redo budget
    prep = tuple(t.contiguous() for t in prep)
    kw = dict(k=K, m=m, num_slots=num_slots)
    errs2 = []
    for vb, sc in (eng._pb, eng._pb_redo):
        got = minidict2_probe(slots, text32, skew, prep, vb=vb, sc=sc, **kw)
        want = minidict2_probe_plain(slots, text32, skew, prep, vb=vb, sc=sc,
                                     **kw)
        torch.cuda.synchronize()
        errs2.append(max_abs_err(got, want))
        log(f"[kernels] minidict2_probe at ({vb}, {sc}): "
            f"{int(got[0].sum())} hits, {int(got[2].sum())} ovf lanes of "
            f"{lanes}, max_abs_err {errs2[-1]}")
    vb, sc = eng._pb
    hit, csid, _ovf = minidict2_probe(slots, text32, skew, prep, vb=vb, sc=sc,
                                      **kw)
    usable = prep[PREP_FIELDS.index("usable")]
    minval = u32(prep[PREP_FIELDS.index("minval")])[usable]
    slot_rows = torch.unique(mulhi32(mix32(minval), num_slots) >> 3).numel()
    bytes2 = lanes * (7 * 4 + 3) + lanes * 6 + slot_rows * 96
    ops2 = lanes * 120  # screen of 8 slots, ~1-2 verifies, hash
    t_redo, t_redo_warm = kernel_times(lambda: minidict2_probe(
        slots, text32, skew, prep, vb=eng._pb_redo[0], sc=eng._pb_redo[1],
        **kw), "minidict2_probe", flush)
    ms2, warm2 = kernel_times(
        lambda: minidict2_probe(slots, text32, skew, prep, vb=vb, sc=sc, **kw),
        "minidict2_probe", flush)
    rows.append(dict(
        name="minidict2_probe", source="fulgor_tpu_torch/csrc/probe.cu",
        replaces="fulgor_tpu/ops/minidict2.py:1126", max_abs_err=max(errs2),
        ms=ms2, warm_ms=warm2,
        plain_ms=time_ms(lambda: minidict2_probe_plain(
            slots, text32, skew, prep, vb=vb, sc=sc, **kw), REPS_PLAIN),
        bytes=bytes2, ops=ops2))
    log(f"[kernels] minidict2_probe at the redo budget {eng._pb_redo}: "
        f"{t_redo:.4f} ms cold L2, {t_redo_warm:.4f} ms warm")

    # K3
    got = fi_and(eng.bits, hit, csid)
    want = fi_and_plain(eng.bits, hit, csid)
    torch.cuda.synchronize()
    C32 = eng.bits.shape[1]
    distinct = torch.unique(csid[hit]).numel()
    bytes3 = lanes * 5 + distinct * C32 * 4 + BATCH * C32 * 4
    ms3, warm3 = kernel_times(lambda: fi_and(eng.bits, hit, csid), "fi_and",
                              flush)
    rows.append(dict(
        name="fi_and", source="fulgor_tpu_torch/csrc/intersect.cu",
        replaces="fulgor_tpu/ops/intersect.py:91",
        max_abs_err=max_abs_err((got,), (want,)), ms=ms3, warm_ms=warm3,
        plain_ms=time_ms(lambda: fi_and_plain(eng.bits, hit, csid),
                         REPS_PLAIN),
        bytes=bytes3, ops=lanes * C32))
    log(f"[kernels] fi_and: {int(got.ne(0).any(dim=1).sum())} of {BATCH} "
        f"reads non-empty, {distinct} distinct colour sets in the batch")
    del flush

    for r in rows:
        b_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        o_ms = r["ops"] / INT_OPS_PER_S * 1e3
        r["bound_ms"] = max(b_ms, o_ms)
        r["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms cold L2, "
            f"{r['warm_ms']:.4f} ms warm (plain {r['plain_ms']:.2f} ms), "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bytes'] / 1e6:.1f} MB), max_abs_err {r['max_abs_err']}")
        if r["max_abs_err"] != 0:
            raise RuntimeError(f"{r['name']} disagrees with its plain version")
    return rows


def device_busy(fn):
    """Run fn under torch.profiler. -> (wall s, device busy s or None,
    {kernel name: (count, device ms)}); busy is the union of the card's
    kernel and copy intervals, None where the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return wall, None, {}
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    per_kernel = {}
    for name in kernels.launches:
        evs = [e for e in dev if f"{name}_kernel" in e.name]
        per_kernel[name] = (len(evs), sum(e.time_range.elapsed_us()
                                          for e in evs) / 1e3)
    return wall, busy_us / 1e6, per_kernel


_MIRROR: dict = {}  # one host-mirror worker's index and reads


def _mirror_init(index_path, codes_path):
    eng = QueryEngine(Index.load(index_path), device="cpu")
    _MIRROR.update(d=eng.idx.minidict(), eng=eng,
                   codes=np.load(codes_path, mmap_mode="r"))


def _host_mirror(q):
    """FI colours of read q by the exact host mirror: lookup_host_exact
    over every window, then the intersection of the decoded colour sets."""
    _hit, csid = lookup_host_exact(_MIRROR["d"],
                                   np.asarray(_MIRROR["codes"][q]))
    return _MIRROR["eng"]._fi_from_csids(csid)


def phase_e2e(idx, eng, codes, reads, tmp, seed):
    eng.pseudoalign_file(reads, os.devnull)  # warm-up
    rates = []
    for i in range(E2E_PASSES):
        kernels.reset_launches()
        st = eng.pseudoalign_file(reads, os.devnull)
        launches = dict(kernels.launches)
        rates.append(st["num_reads"] / st["elapsed"])
        log(f"[e2e] pass {i + 1}: {st['num_reads']} reads in "
            f"{st['elapsed']:.3f} s: {rates[-1]:.1f} reads/s; parse "
            f"{st['parse_sec']:.3f} s, query {st['query_sec']:.3f} s, redo "
            f"{st['redo_sec']:.3f} s, write {st['write_sec']:.3f} s; "
            f"{st['num_redo']} reads redone; {st['num_mapped']} mapped; "
            f"launches {launches}")
        if st["num_reads"] != len(codes):
            raise RuntimeError("the engine did not read every read")
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise RuntimeError(
                f"kernels not launched on the main path: {missing}")
    rate = statistics.median(rates)
    log(f"[e2e] {E2E_PASSES} timed passes: median {rate:.1f} reads/s, "
        f"min {min(rates):.1f}, max {max(rates):.1f} "
        f"(spread {(max(rates) - min(rates)) / rate:.4f} of the median)")
    wall, busy, per_kernel = device_busy(
        lambda: eng.pseudoalign_file(reads, os.devnull))
    if busy is None:
        log("[e2e] card busy share: not measured (the profiler recorded no "
            "device activity)")
    else:
        log(f"[e2e] profiled run: {wall:.3f} s wall, card busy "
            f"{busy * 1e3:.2f} ms (kernels and copies), idle share "
            f"{1 - busy / wall:.4f}; per kernel (launches, device ms) "
            f"{per_kernel}")

    out = os.path.join(tmp, "psa.tsv")
    st2 = eng.pseudoalign_file(reads, out)
    recs = {}
    with open(out) as f:
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            recs[int(parts[0])] = np.array(parts[2:], dtype=np.uint32)
    if len(recs) != len(codes):
        raise RuntimeError(f"{len(recs)} records for {len(codes)} reads")
    rng = np.random.default_rng(seed)
    redone = sorted(set(st2["redo_ids"]))
    sample = rng.choice(len(codes), size=min(2000, len(codes)), replace=False)
    check = sorted(set(redone) | set(sample.tolist()))
    t0 = time.perf_counter()
    # the per-read exact mirror is a Python loop (~25 ms a read): spread it
    # over the host's cores, in spawned workers that load the saved index
    index_path = os.path.join(tmp, "smoke.tfur")
    codes_path = os.path.join(tmp, "codes.npy")
    idx.save(index_path)
    np.save(codes_path, codes)
    with multiprocessing.get_context("spawn").Pool(
            os.cpu_count(), initializer=_mirror_init,
            initargs=(index_path, codes_path)) as pool:
        wants = pool.map(_host_mirror, check, chunksize=64)
    bad = [q for q, want in zip(check, wants)
           if not np.array_equal(recs[q], want)]
    log(f"[e2e] output file checked against the exact host mirror: "
        f"{len(redone)} redone + {len(check) - len(redone)} sampled reads, "
        f"{len(bad)} differ ({time.perf_counter() - t0:.1f} s)")
    if bad:
        raise RuntimeError(f"reads {bad[:10]} differ from the host mirror")
    return st, launches, rate


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomes", type=int, default=512)
    ap.add_argument("--reads", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=27)
    args = ap.parse_args()
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    tmp = tempfile.mkdtemp(prefix="fulgor_smoke_")
    try:
        idx, codes, reads = phase_index(tmp, args.genomes, args.reads,
                                        args.seed)
        eng = QueryEngine(idx)
        log(f"[index] covered fraction {eng._covered_frac:.4f} -> probe "
            f"budget {eng._pb}, redo budget {eng._pb_redo}")
        rows = phase_kernels(idx, eng, codes)
        _st, launches, rate = phase_e2e(idx, eng, codes, reads, tmp,
                                        args.seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; "
        f"{rate:.1f} reads/s end to end on {card}")
    out = []
    for r in rows:
        out.append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
