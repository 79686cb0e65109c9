"""BENCHMARK.json, every configuration, cell and metric file: they load,
and their names, units and limits keep to the benchmark format's rules; a cell
that exists only in another folder loads by name; the run refuses without
a card, and without the program beside it."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import cells, harness
from benchmark.tests.conftest import BENCH, ROOT, TINY, make_bench

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_the_spec_keeps_to_the_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert all(one_line(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    n = len(SPEC["workloads"])
    assert 1 <= n <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # a full check's time with 24 cells fits
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(cells.NAME.match(x) for x in names)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert len(c["reduced"]) <= 16
        assert all(cells.NAME.match(k) for k in c["reduced"])
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == n
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, n // 4)
    for w in SPEC["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4)
        assert one_line(w["why"]) and cells.NAME.match(w["traffic"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert cells.UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                               "higher")
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_and_its_configuration_load(cell):
    bench = cells.Bench(BENCH)
    c = bench.cell(cell)
    cfg = bench.config(c["config"])
    assert c["reads_per_job"] % harness.SAMPLE_BLOCK == 0
    assert harness.SAMPLE_BLOCKS * harness.SAMPLE_BLOCK <= c["reads_per_job"]
    assert cfg["colours"] >= cfg["corpus"]["genomes"]
    assert set(cfg["reduced"]) == set(
        next(x for x in SPEC["configs"] if x["name"] == c["config"])
        ["reduced"])
    assert {"source", "reduced", "assumed", "control_fingerprint_bits"} \
        <= set(cfg)
    # every metric of the cell has its reader
    for traced in (False, True):
        for m in bench.metrics(cell, traced):
            assert callable(bench.reader(m["name"]))


def test_a_cell_in_another_folder_loads_by_name(tmp_path):
    """A later cell, configuration or metric is new files only."""
    bench = make_bench(str(tmp_path), [dict(TINY, name="elsewhere")],
                       {"elsewhere.fi": ("elsewhere", "fi", "fi", None)})
    with open(os.path.join(bench, "metrics", "reads_redone.py"), "w") as f:
        f.write("def read(run):\n    return 7.0\n")
    b = cells.Bench(bench)
    assert b.cell("elsewhere.fi")["config"] == "elsewhere"
    assert b.config("elsewhere")["colours"] == 100
    assert b.reader("reads_redone")({}) == 7.0
    with pytest.raises(KeyError):
        b.cell("sal4546.fi")


def test_no_card_no_result(tmp_path):
    """The measurement path refuses on a machine without a card, before it
    builds anything: no CPU fallback, no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sal4546.fi",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "No run on the CPU" in r.stderr
    assert not os.path.exists(os.path.join(BENCH, "cache", "never"))


def test_no_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's
    folder: the run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sal4546.fi",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
