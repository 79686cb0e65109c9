"""The benchmark's own tests (python3 -m pytest benchmark/tests from the
repository's root; the repository's tests/ do not collect them). They run
on the CPU with the kernels' plain versions, on tiny configurations made
in a temporary benchmark folder; tests marked `card` need a CUDA card and
skip without one."""

import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# a block corpus of 24 genomes widened to 100 colours (sal4546's shape),
# and reads from every 4th genome
TINY = {
    "name": "tiny", "source": "test",
    "corpus": {"simulator": "blocks", "genomes": 24, "num_genes": 20,
               "gene_len": 300, "core_frac": 0.5, "loss_rate": 0.05,
               "mut_per_branch": 3, "gain_per_branch": 1, "gain_len": 300,
               "pool_genes": 20, "seed": 3},
    "colours": 100, "k": 31, "m": 19, "dict_kind": "mini",
    "reads": {"length": 150, "error_rate": 0.005, "unmapped_frac": 0.12,
              "every": 4},
    "control_fingerprint_bits": 22,
}
TRAFFIC = {"reads_per_job": 2000, "warm_reads": 300, "why": "test",
           "who": "test"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test runs on the card")
    return torch.device("cuda")


def make_bench(root, configs, cells) -> str:
    """A benchmark folder under `root` holding `configs` and `cells`
    ({name: (config, traffic name, tool, tau)}), the metric readers
    copied, and its BENCHMARK.json beside it. -> the folder."""
    bench = os.path.join(root, "bench")
    for d in ("configs", "workloads"):
        os.makedirs(os.path.join(bench, d), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True)
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"], spec["workloads"] = [], []
    for cfg in configs:
        with open(os.path.join(bench, "configs", f"{cfg['name']}.json"),
                  "w") as f:
            json.dump(cfg, f)
        spec["configs"].append({"name": cfg["name"], "source": "test",
                                "file": f"bench/configs/{cfg['name']}.json",
                                "reduced": [], "why": "test"})
    for name, (config, traffic, tool, tau) in cells.items():
        with open(os.path.join(bench, "workloads", f"{name}.json"),
                  "w") as f:
            json.dump({"config": config, "traffic": traffic, "tool": tool,
                       "tau": tau, **TRAFFIC}, f)
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in spec["per_layer"] + spec["end_to_end"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """The tiny configuration's cells: FI, TU(0.8), its corpus and index
    made once for the session."""
    from benchmark import cells, harness

    root = str(tmp_path_factory.mktemp("tiny"))
    bench = make_bench(root, [TINY], {
        "tiny.fi": ("tiny", "fi", "fi", None),
        "tiny.tu": ("tiny", "tu0.8", "tu", 0.8)})
    b = cells.Bench(bench)
    harness.ensure_prepared(b, b.config("tiny"))
    return b


@pytest.fixture
def small_batches(monkeypatch):
    """Batches of 1,024 reads: the plain versions on the CPU run a
    32,768-read batch slowly, and the tiny jobs fill none."""
    from benchmark import harness

    monkeypatch.setattr(harness, "BATCH", 1024)


@pytest.fixture
def runs_fetch(monkeypatch):
    """The engine's strategy thresholds lowered so that the tiny index
    (4 words a set) takes sal4546's runs fetch, as 143 words do."""
    monkeypatch.setenv("FULGOR_RUNS_MIN_WORDS", "1")
