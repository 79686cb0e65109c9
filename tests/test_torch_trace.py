"""The port's stage spans and counters (fulgor_tpu_torch.tracing) on the
CPU, on a tiny block-corpus index built by the port's own builder that
takes the runs fetch (FULGOR_RUNS_MIN_WORDS=0) with its probe budgets cut
to (1, 1), so that the redo re-probes and the host mirror both run:

- the stage keys every entry point returned before keep their names, and
  host_sec and redo_sec hold their children (`colour.and`; the redo's
  re-probe, mirror and lists);
- the main thread's spans cover at least 95% of the `job` span, and every
  recorded span lies inside its parent;
- a second pass of the same reads on a warm engine hits its key cache;
- with recording off nothing is kept;
- `--verbose`'s stage split line prints the split;
- under a CPU torch.profiler with `bench.job` around each call, the
  benchmark's spans.py puts every `job` span inside its range, the mapping
  pinned within 1 ms;
- spans.py's idle-gap attribution and clock check on made-up intervals.
"""

import os
from collections import namedtuple

import pytest

from benchmark import spans as S
from fulgor_tpu_torch import tracing
from fulgor_tpu_torch.index import Index
from fulgor_tpu_torch.query import engine as E
from tests.test_torch_threads import one_thread  # noqa: F401

CORPUS = dict(num_genes=12, gene_len=300, core_frac=0.5, loss_rate=0.05,
              mut_per_branch=3, gain_per_branch=1, gain_len=300,
              pool_genes=12, seed=4)
GENOMES, NUM_READS, BATCH = 16, 512, 256
JOBS = 3  # recorded's jobs on one engine
# the keys of pseudoalign_file's stats before the tracer
PSA_KEYS = {"num_reads", "num_reads_total", "num_mapped", "parse_sec",
            "query_sec", "host_sec", "write_sec", "num_redo", "redo_ids",
            "num_redo_host", "redo_sec", "num_run_ovf", "elapsed"}
INLINE_KEYS = {"num_reads", "num_reads_total", "parse_sec", "query_sec",
               "write_sec", "num_redo", "redo_ids", "num_redo_host",
               "redo_sec", "elapsed"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(index path, reads path) of a 16-genome block corpus, and 512 reads
    of every 4th genome."""
    from fulgor_tpu_torch.build.builder import build_index
    from fulgor_tpu_torch.io.simulate import (
        simulate_pangenome_blocks, simulate_reads, write_fastq)

    out = tmp_path_factory.mktemp("trace")
    paths = simulate_pangenome_blocks(str(out / "fa"), GENOMES, **CORPUS)
    index = str(out / "index.tfur")
    build_index(paths, k=31, m=19).save(index)
    reads = str(out / "reads.fq.gz")
    write_fastq(reads, *simulate_reads(paths[::4], NUM_READS, 150, 0.005,
                                       0.12, seed=9))
    return index, reads


@pytest.fixture
def engine(tiny, monkeypatch):
    """A fresh engine on the tiny index: the runs fetch, probe and redo
    budgets (1, 1)."""
    monkeypatch.setenv("FULGOR_RUNS_MIN_WORDS", "0")
    monkeypatch.setenv("FULGOR_PROBE_BUDGET", "1,1")
    monkeypatch.setenv("FULGOR_PROBE_BUDGET_REDO", "1,1")
    eng = E.QueryEngine(Index.load(tiny[0]), batch_size=BATCH, device="cpu")
    assert eng.use_runs_fetch
    return eng


@pytest.fixture(scope="module")
def recorded(tiny):
    """JOBS FI jobs on one fresh engine under a CPU profiler with the
    harness's `bench.engine` and `bench.job` ranges around the engine's
    construction and each call, recording on -> ([each job's stats],
    drained, profiler). The clock check bounds the mapping by the smallest
    offsets over a run's jobs, as the real time between one range and its
    span (a garbage collector's pause, a preemption) can pass 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    mp = pytest.MonkeyPatch()
    mp.setenv("FULGOR_RUNS_MIN_WORDS", "0")
    mp.setenv("FULGOR_PROBE_BUDGET", "1,1")
    mp.setenv("FULGOR_PROBE_BUDGET_REDO", "1,1")
    try:
        with tracing.recording(), \
                profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("bench.engine"):  # as the harness does
                eng = E.QueryEngine(Index.load(tiny[0]), batch_size=BATCH,
                                    device="cpu")
            stats = []
            for _ in range(JOBS):
                with record_function("bench.job"):
                    stats.append(eng.pseudoalign_file(tiny[1], os.devnull))
        return stats, tracing.drain(), prof
    finally:
        mp.undo()


def test_stage_keys_hold_their_children(recorded):
    st = recorded[0][0]
    assert PSA_KEYS <= set(st)
    assert st["num_redo"] > 0 and st["num_redo_host"] > 0
    assert st["host_sec"] >= st["colour_and_sec"] > 0
    parts = (st["redo_reprobe_sec"] + st["redo_mirror_sec"]
             + st["redo_lists_sec"])
    assert st["redo_sec"] >= parts and st["redo_mirror_sec"] > 0
    assert st["parse_sec"] == st["parse_read_sec"]
    assert st["query_sec"] == st["fetch_wait_sec"]
    assert st["elapsed"] == st["job_sec"] >= st["host_sec"] + st["redo_sec"]
    assert st["write_sec"] >= st["write_format_sec"] > 0
    assert st["write_bytes"] > 0 and st["key_lookups"] > 0
    assert st["engine_init_sec"] >= st["engine_tables_sec"] > 0
    assert st["sys_ns"] >= 0 and st["user_ns"] > 0


def test_main_thread_covers_the_job_and_spans_nest(recorded):
    _st, d, _p = recorded
    spans = d["spans"]
    by_id = {s.id: s for s in spans}
    jobs = [s for s in spans if s.name == "job"]
    assert len(jobs) == JOBS
    for job in jobs:
        main = [s for s in spans if s.job == job.job
                and s.thread == job.thread and s.name != "job"]
        covered = S._union([(max(s.start_ns, job.start_ns),
                             min(s.end_ns, job.end_ns)) for s in main])
        assert covered >= 0.95 * (job.end_ns - job.start_ns)
        threads = {s.thread for s in spans if s.job == job.job}
        assert {"fulgor-parse", "fulgor-writer", job.thread} <= threads
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert {"index.load", "index.decode"} <= set(d["process"])
    assert d["clock"][0][0] < d["clock"][1][0]


def test_job_span_inside_bench_job_range(recorded):
    _st, d, prof = recorded
    marks, busy = S.from_events(prof.events())
    assert len(marks) == JOBS and busy == []
    placed = S.place(d, prof.profiler.kineto_results.trace_start_ns())
    rep = S.attribute(marks, busy, placed)
    assert S.check(rep)
    assert len(rep["jobs"]) == JOBS
    for job in rep["jobs"]:
        assert job["inside"] and job["covered"] >= 95.0
        assert min(job["offsets_us"]) >= 0.0
    # no card: each range is one idle gap, labelled by the main thread's
    # span at its middle (or `unspanned`, in the under 5% no span covers)
    assert rep["idle_s"] == pytest.approx(
        sum(e - s for s, e in marks) / 1e6)
    main = {s.name for s, _a, _b in placed if s.thread == "MainThread"}
    for label in rep["idle"]:
        head = label.split("|")[0]
        assert head == "unspanned" or head in main - {"job"}


def test_warm_engine_hits_its_key_cache(recorded):
    first, second = recorded[0][:2]
    assert first["engine_init_sec"] > 0 and "engine_init_sec" not in second
    assert second["key_hits"] > first["key_hits"]
    assert second["key_hits"] == second["key_lookups"]
    assert "colour_and_sec" not in second  # every key from the cache


def test_verbose_prints_the_split(recorded, capsys):
    first, second = recorded[0][:2]
    E.QueryEngine._print_stats(first)
    E.QueryEngine._print_stats(second)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("stage split: ")]
    assert len(lines) == 2
    assert lines[0].startswith("stage split: engine ")
    assert "tables" in lines[0] and "engine" not in lines[1]
    for word in ("dispatch", "rows", "parse wait", "write wait", "reprobe",
                 "mirror", "lists", "AND", "key hits", "parse put", "format",
                 "emit", "bytes", "process", "main", "writer"):
        assert word in lines[1]
    assert f"{second['write_bytes']} bytes" in lines[1]
    assert (f"writer {second['sys_ns_writer'] / 1e9:.3f}/"
            f"{second['user_ns_writer'] / 1e9:.3f}s "
            f"{second['minflt_writer']}") in lines[1]


@pytest.mark.parametrize("tool", ["fi", "tu", "dedup", "kmer_conservation",
                                  "kmer_matches"])
def test_recording_off_keeps_nothing_and_stats_keep_their_keys(
        engine, tiny, tmp_path, tool):
    before = len(tracing._rec["spans"])
    out = str(tmp_path / "out")
    if tool == "kmer_conservation":
        st = engine.kmer_conservation_file(tiny[1], out)
        keys = INLINE_KEYS
    elif tool == "kmer_matches":
        st = engine.kmer_matches_file(tiny[1], out)
        keys = INLINE_KEYS
    else:
        st = engine.pseudoalign_file(
            tiny[1], out, threshold=0.8 if tool == "tu" else None,
            deduplicate=tool == "dedup")
        keys = PSA_KEYS | ({"num_keys"} if tool == "dedup" else set())
    assert len(tracing._rec["spans"]) == before
    assert keys <= set(st)
    assert st["elapsed"] >= st["redo_sec"] + st["query_sec"] > 0
    assert st["num_reads"] == NUM_READS


def test_attribution_on_made_up_intervals():
    Sp = namedtuple("Sp", "id name start_ns end_ns thread parent job")
    us = 1000  # the spans' ns to the trace's us, the clock pair aligned
    spans = [Sp(1, "job", 0, 100 * us, "main", 0, 7),
             Sp(2, "dispatch", 0, 10 * us, "main", 1, 7),
             Sp(3, "colour", 20 * us, 60 * us, "main", 1, 7),
             Sp(4, "colour.and", 30 * us, 50 * us, "main", 3, 7),
             Sp(5, "write", 35 * us, 45 * us, "fulgor-writer", 0, 7),
             Sp(6, "parse.read", 0, 70 * us, "fulgor-parse", 0, 7)]
    drained = {"spans": spans, "clock": [(0, 5_000), (100 * us, 5_000
                                                      + 100 * us)]}
    placed = S.place(drained, 5_000)
    assert [(a, b) for _s, a, b in placed][:2] == [(0, 100), (0, 10)]
    # busy 0-10, 15-20, 60-100: gaps 10-15 (nothing on main), 20-60
    rep = S.attribute([(0.0, 100.0)], [[0, 10], [15, 20], [60, 100]],
                      placed)
    assert rep["idle"] == {
        "unspanned": 5e-6,
        "colour.and|writer:write|parse:parse.read": 40e-6}
    assert rep["jobs"][0]["covered"] == pytest.approx(50.0)
    assert rep["jobs"][0]["offsets_us"] == (0.0, 0.0)
    assert S.check(rep)
    # the same job placed 2 ms late: it leaves its bench.job range
    late = S.place(dict(drained, clock=[(0, 7_000), (100 * us, 7_000
                                                      + 100 * us)]), 5_000)
    assert not S.check(S.attribute([(0.0, 100.0)], [], late))
    # two jobs whose ranges fit them loosely: pinned within 1 ms or not
    rows = [{"job": 1, "wall_s": 1.0, "covered": 99.0, "inside": True,
             "offsets_us": off} for off in ((300.0, 1500.0),
                                            (2000.0, 700.0))]
    base = {"idle_s": 0.0, "unspanned_s": 0.0}
    assert S.check(dict(base, jobs=rows))
    rows[0]["offsets_us"] = (1200.0, 1500.0)
    assert not S.check(dict(base, jobs=rows))
    assert S.top({"a": 1.0, "b": 3.0}) == [["b", 3.0], ["a", 1.0]]
