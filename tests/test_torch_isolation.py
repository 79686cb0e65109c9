"""The port stands alone: no module of fulgor_tpu_torch, and not
chip_smoke.py, imports jax or fulgor_tpu; and its engine runs on the card
unless asked otherwise, raising where there is none."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fulgor_tpu_torch")
# jax, or fulgor_tpu not followed by _torch
FORBIDDEN = re.compile(r"^(jax|jaxlib|fulgor_tpu)(\..*)?$")
IMPORT_LINE = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|fulgor_tpu)(?!_torch)\b", re.M)

_PROBE = r"""
import importlib, os, re, sys
for d, _dirs, files in os.walk("fulgor_tpu_torch"):
    for f in sorted(files):
        if f.endswith(".py"):
            mod = os.path.join(d, f[:-3]).replace(os.sep, ".")
            importlib.import_module(mod.removesuffix(".__init__"))
import chip_smoke
bad = sorted(n for n in sys.modules if re.match(r"^(jax|jaxlib|fulgor_tpu)(\..*)?$", n))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_fulgor_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    # function-local imports never run at import time: scan the sources too
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PKG):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    offenders = [p for p in sources if IMPORT_LINE.search(open(p).read())]
    assert not offenders, offenders
    assert FORBIDDEN.match("fulgor_tpu.ops") and not FORBIDDEN.match(
        "fulgor_tpu_torch.ops")


def test_engine_defaults_to_the_card(tmp_path, monkeypatch):
    from fulgor_tpu_torch.build.builder import build_index
    from fulgor_tpu_torch.query.engine import QueryEngine

    rng = np.random.default_rng(4)
    anc = rng.integers(0, 4, size=400)
    paths = []
    for i in range(3):
        g = anc.copy()
        g[rng.integers(0, 400, size=6)] = rng.integers(0, 4, size=6)
        p = tmp_path / f"g{i}.fa"
        p.write_text(">g\n" + "".join("ACGT"[c] for c in g) + "\n")
        paths.append(str(p))
    idx = build_index(paths, k=15, m=9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(idx)
    assert QueryEngine(idx, device="cpu").device.type == "cpu"
