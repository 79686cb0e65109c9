"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled for Hopper (sm_90a) with nvcc at first use, one
nvcc per source, all started together, then linked into one shared library
with a plain C interface (_build/libfulgor_kernels.so) that ctypes loads.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises on a non-zero code. `launches` counts
the kernel launches made by the wrappers in ops/prep.py (K1 window_prep,
K8 pack_codes), ops/probe.py (K2 minidict2_probe), ops/intersect.py (K3
fi_and, K4 tu_mask, K5 km_scores, K6 compact_runs: both of its C entries,
K9 first_set_bits, K12 runs_scores: runs_mask and runs_scores, K13
pack_hits), ops/lookup.py (K7 cuckoo_lookup), ops/staged.py (K10
staged_probe: its three kernels, not the K2 launches between them),
ops/anchored.py (K11 anchored_probe: its three kernels) and
ops/minidict.py (K14 minidict_v1_verify, not the K8 and K1 launches before
it): one per launch, nowhere else.
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
SOURCES = ("prep.cu", "probe.cu", "intersect.cu", "union.cu", "runs.cu",
           "cuckoo.cu", "pack.cu", "lists.cu", "staged.cu", "anchored.cu",
           "minidict.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

launches = {"window_prep": 0, "minidict2_probe": 0, "fi_and": 0,
            "tu_mask": 0, "km_scores": 0, "compact_runs": 0,
            "cuckoo_lookup": 0, "pack_codes": 0, "first_set_bits": 0,
            "staged_probe": 0, "anchored_probe": 0, "runs_scores": 0,
            "pack_hits": 0, "minidict_v1_verify": 0}

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


def build(csrc: str = CSRC, lib: str = LIB, sources=SOURCES) -> str:
    """Compile the sources of `csrc` in parallel and link them into the
    library `lib` (another checkout's sources and library: chip_smoke.py's
    --parent). -> the compiler's output (ptxas register and spill report
    included), also written to build.log beside the library."""
    nvcc = _nvcc()
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in sources:
        obj = os.path.join(out_dir, src.replace(".cu", ".o"))
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", os.path.join(csrc, src), "-o", obj],
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
    tmp = f"{lib}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", tmp, *(o for _s, o, _p in procs)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
    os.replace(tmp, lib)
    text = "\n".join(log)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(text)
    return text


_P, _I, _L = ct.c_void_p, ct.c_int, ct.c_int64
# every C entry point: its argument types
ENTRIES = {
    "fulgor_window_prep": [_P, _P, _I, _I, _I, _I] + [_P] * 12 + [_P],
    "fulgor_minidict2_probe": (
        [_P, _L, _P, _L, _P, _L] + [_P] * 10
        + [_L, _I, _I, ct.c_uint32, _I, _I, _I] + [_P] * 7 + [_P]),
    "fulgor_fi_and": [_P, _I, _P, _P, _I, _I, _P, _P],
    "fulgor_tu_mask": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
    "fulgor_km_scores": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
    "fulgor_compact_runs": [_P, _P, _I, _I, _I] + [_P] * 5 + [_P],
    "fulgor_compact_runs_hits": [_P, _P, _I, _I, _I] + [_P] * 6 + [_P],
    "fulgor_cuckoo_lookup": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    "fulgor_pack_codes": [_P, _I, _I, _P, _P, _P],
    "fulgor_first_set_bits": [_P, _I, _I, _I, _P, _P, _P],
    "fulgor_staged_split": [_P] * 4 + [_I] * 5 + [_P] * 6,
    "fulgor_staged_merge": [_P] * 11 + [_I] * 4 + [_P] * 4,
    "fulgor_anchored_anchors": [_P] * 3 + [_I] * 3 + [_P] * 4,
    "fulgor_anchored_extend": (
        [_P, _L, _P] + [_P] * 2 + [_P] * 7 + [_I] * 5 + [_P] * 6),
    "fulgor_anchored_merge": [_P] * 4 + [_I] * 3 + [_P] * 4,
    "fulgor_runs_scores": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _I, _P,
                           _P],
    "fulgor_pack_hits": [_P, _P, _I, _I, _P, _P, _P],
    "fulgor_minidict_v1_verify": (
        [_P, _L, _P, _L, _P, _L] + [_P] * 8 + [_L, _I, _I, _I] + [_P] * 3
        + [_P]),
}


def bind(lib, names=ENTRIES):
    """Set the argument and result types of the C entry points `names`
    (every one by default) of a loaded kernel library. -> lib"""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = ENTRIES[name]
        fn.restype = ct.c_int
    return lib


def library():
    """The loaded kernel library, built first if a source is newer."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            _lib = bind(ct.CDLL(LIB))
        return _lib


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


def pointers(tensors):
    """A C array of the tensors' device pointers (a void* const*)."""
    return (ct.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
