"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled for Hopper (sm_90a) with nvcc at first use, one
nvcc per source, all started together, then linked into one shared library
with a plain C interface (_build/libfulgor_kernels.so) that ctypes loads.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises on a non-zero code. `launches` counts
the kernel launches made by the wrappers in ops/prep.py, ops/probe.py and
ops/intersect.py (one per launch, nowhere else).
"""

from __future__ import annotations

import ctypes as ct
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD, "libfulgor_kernels.so")
SOURCES = ("prep.cu", "probe.cu", "intersect.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

launches = {"window_prep": 0, "minidict2_probe": 0, "fi_and": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set NVCC to its path)")


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC))
    return os.path.getmtime(LIB) < newest


def build() -> str:
    """Compile every source in parallel and link the library. -> the
    compiler's output (ptxas register and spill report included)."""
    nvcc = _nvcc()
    os.makedirs(BUILD, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = os.path.join(BUILD, src.replace(".cu", ".o"))
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", os.path.join(CSRC, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = f"{LIB}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", tmp, *(o for _s, o, _p in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
    os.replace(tmp, LIB)
    text = "\n".join(log)
    with open(os.path.join(BUILD, "build.log"), "w") as f:
        f.write(text)
    return text


def library():
    """The loaded kernel library, built first if a source is newer."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ct.CDLL(LIB)
        P, I = ct.c_void_p, ct.c_int
        lib.fulgor_window_prep.argtypes = [P, P, I, I, I, I] + [P] * 12 + [P]
        lib.fulgor_minidict2_probe.argtypes = (
            [P, ct.c_int64, P, ct.c_int64, P, ct.c_int64]
            + [P] * 10 + [ct.c_int64, I, I, ct.c_uint32, I, I] + [P] * 3 + [P])
        lib.fulgor_fi_and.argtypes = [P, I, P, P, I, I, P, P]
        for fn in (lib.fulgor_window_prep, lib.fulgor_minidict2_probe,
                   lib.fulgor_fi_and):
            fn.restype = I
        _lib = lib
        return lib


def build_seconds() -> float:
    """Force a fresh build and load; -> wall seconds (chip_smoke's build
    phase)."""
    global _lib
    t0 = time.perf_counter()
    with _lock:
        _lib = None
        if os.path.exists(LIB):
            os.remove(LIB)
    library()
    return time.perf_counter() - t0


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
