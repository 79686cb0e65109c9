"""The benchmark stands apart: nothing it runs loads jax, jaxlib, flax or
fulgor_tpu (top-level names compared whole: fulgor_tpu_torch begins with
fulgor_tpu), nor reads the JAX package's bench.py, chip_smoke.py,
scripts/ or bench_cache/; and the reference loads nothing of the program
at all."""

import os
import re
import subprocess
import sys

from benchmark.tests.conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fulgor_tpu"}
IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|fulgor_tpu|bench|chip_smoke|"
    r"scripts)\b(?!_torch)", re.M)
READS = re.compile(r"bench_cache|chip_smoke|scripts/|bench\.py")

_LOADED = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import importlib, os
for mod in sys.argv[2:]:
    importlib.import_module(mod)
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
"""


def top_level_names(*modules) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _LOADED, ROOT, *modules],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    import json

    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def sources():
    for d, _dirs, files in os.walk(BENCH):
        if os.sep + "cache" in d[len(BENCH):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_harness_readers_and_reference_load_no_jax():
    readers = [f"benchmark.metrics.{f[:-3]}" for f in
               sorted(os.listdir(os.path.join(BENCH, "metrics")))
               if f.endswith(".py")]
    names = top_level_names(
        "benchmark.run", "benchmark.harness", "benchmark.cells",
        "benchmark.prepare", "benchmark.control", "benchmark.trace",
        "benchmark.corpus", "benchmark.widen", "benchmark.reference.exact",
        "fulgor_tpu_torch.query.engine", "fulgor_tpu_torch.build.builder",
        *readers)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "fulgor_tpu_torch" in names  # the whole name, not a prefix
    assert "fulgor_tpu" not in names


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_names("benchmark.reference.exact")
    assert not names & (FORBIDDEN | {"fulgor_tpu_torch"}), names


def test_no_source_imports_or_reads_them():
    """Function-local imports never run at import time: the sources are
    scanned too."""
    bad = [p for p in sources() if IMPORT.search(open(p).read())]
    assert not bad, bad
    read = [p for p in sources() if not p.startswith(
        os.path.join(BENCH, "tests")) and READS.search(
            re.sub(r'"""[\s\S]*?"""|#.*', "", open(p).read()))]
    assert not read, read
    ref = open(os.path.join(BENCH, "reference", "exact.py")).read()
    assert "fulgor_tpu_torch" not in re.sub(r'"""[\s\S]*?"""', "", ref)


def test_the_guard_compares_whole_names():
    from benchmark import harness

    sys.modules.setdefault("fulgor_tpu_torch_probe", sys)
    try:
        found = harness.forbidden_modules()
        assert not [n for n in found if n.startswith("fulgor_tpu_torch")]
        sys.modules["jaxlib"] = sys
        assert "jaxlib" in harness.forbidden_modules()
    finally:
        sys.modules.pop("jaxlib", None)
        sys.modules.pop("fulgor_tpu_torch_probe", None)


def test_a_module_loaded_after_the_window_refuses_the_result(tmp_path,
                                                             capsys):
    """The guard runs as the result is printed, after the readers, the
    reference and the trace's reduction have been imported: a reader that
    loads a forbidden module leaves no result line."""
    from benchmark import cells, harness
    from benchmark.tests.conftest import TINY, make_bench

    bench = make_bench(str(tmp_path), [TINY],
                       {"tiny.fi": ("tiny", "fi", "fi", None)})
    with open(os.path.join(bench, "metrics", "reads_per_s.py"), "w") as f:
        f.write("import sys, types\n\n\ndef read(run):\n"
                "    sys.modules['jax'] = types.ModuleType('jax')\n"
                "    return 1.0\n")
    run = dict(reads=10, wall=1.0, setup_s=1.0, host_peak_gib=1.0,
               card_peak_gib=0.0, trace=None)
    cmp_ = dict(checks={"records_wrong": {"value": 0, "limit": 0}})
    assert "jax" not in sys.modules
    try:
        result = harness.assemble(cells.Bench(bench), "tiny.fi", False, run,
                                  cmp_, 0, False)
        assert result["correct"]
        assert harness.main_result(result) != 0
    finally:
        sys.modules.pop("jax", None)
    out, err = capsys.readouterr()
    assert out.strip() == "" and "forbidden modules loaded: ['jax']" in err
