"""What the harness finds by name: BENCHMARK.json's cells and metrics, a
configuration's file (configs/<name>.json), a cell's traffic
(workloads/<cell>.json) and a metric's reader (metrics/<metric>.py, a
function `read(run)` that returns a number, or None where it finds nothing
to read). A later cell, configuration or metric is a new file here and a
new entry in BENCHMARK.json; no file of the harness changes."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOOLS = ("fi", "tu")


class Bench:
    """The benchmark rooted at `bench_dir`, its BENCHMARK.json one level
    up."""

    def __init__(self, bench_dir: str):
        self.dir = os.path.abspath(bench_dir)
        self.spec_path = os.path.join(os.path.dirname(self.dir),
                                      "BENCHMARK.json")
        with open(self.spec_path) as f:
            self.spec = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in {self.spec_path}")

    def config(self, name: str) -> dict:
        path = os.path.join(os.path.dirname(self.spec_path),
                            self._entry("configs", name)["file"])
        with open(path) as f:
            cfg = json.load(f)
        if cfg["name"] != name:
            raise ValueError(f"{path} names {cfg['name']!r}, not {name!r}")
        return cfg

    def cell(self, name: str) -> dict:
        """BENCHMARK.json's entry of the cell with its traffic file's
        parameters; the two must agree on the configuration and traffic."""
        entry = self._entry("workloads", name)
        with open(os.path.join(self.dir, "workloads", f"{name}.json")) as f:
            traffic = json.load(f)
        for key in ("config", "traffic"):
            if traffic[key] != entry[key]:
                raise ValueError(f"cell {name}: {key} {traffic[key]!r} in "
                                 f"its file, {entry[key]!r} in "
                                 "BENCHMARK.json")
        if traffic["tool"] not in TOOLS:
            raise ValueError(f"cell {name}: unknown tool {traffic['tool']}")
        return {**traffic, **entry}

    def metrics(self, cell: str, traced: bool) -> list:
        """The metrics a run of `cell` reports: the end-to-end ones
        untraced, the per-layer ones traced; each only in the cells its
        `workloads` lists, where it has that key."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def cache_dir(cfg: dict, root: str) -> str:
    """Where a configuration's corpus and index are kept: its name and a
    digest of everything that shapes them."""
    shape = {k: cfg[k] for k in ("corpus", "colours", "k", "m", "dict_kind")}
    key = hashlib.sha1(json.dumps(shape, sort_keys=True).encode()).hexdigest()
    return os.path.join(root, f"{cfg['name']}-{key[:12]}")
