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
fi_and, K4 tu_mask, K5 km_scores, K6 compact_runs, K9 first_set_bits, K12
runs_scores: runs_mask and runs_scores, K13 pack_hits), ops/lookup.py (K7
cuckoo_lookup), ops/staged.py (K10 staged_probe: its three kernels, not the
K2 launches between them), ops/anchored.py (K11 anchored_probe: its
three kernels) and ops/minidict.py (K14 minidict_v1_verify, not the K8
and K1 launches before it): one per launch, nowhere else.
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
           "hits.cu", "minidict.cu")
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


def build(csrc: str = CSRC, lib: str = LIB) -> str:
    """Compile every source of `csrc` in parallel and link them into the
    library `lib` (another checkout's sources and library: chip_smoke.py's
    --parent). -> the compiler's output (ptxas register and spill report
    included), also written to build.log beside the library."""
    nvcc = _nvcc()
    out_dir = os.path.dirname(lib)
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in SOURCES:
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


def bind(lib):
    """Set the argument and result types of every C entry point of a
    loaded kernel library. -> lib"""
    P, I = ct.c_void_p, ct.c_int
    lib.fulgor_window_prep.argtypes = [P, P, I, I, I, I] + [P] * 12 + [P]
    lib.fulgor_minidict2_probe.argtypes = (
        [P, ct.c_int64, P, ct.c_int64, P, ct.c_int64]
        + [P] * 10 + [ct.c_int64, I, I, ct.c_uint32, I, I, I] + [P] * 7
        + [P])
    lib.fulgor_fi_and.argtypes = [P, I, P, P, I, I, P, P]
    lib.fulgor_tu_mask.argtypes = [P, I, I, P, P, I, I, P, P, P]
    lib.fulgor_km_scores.argtypes = [P, I, I, P, P, I, I, P, P, P]
    lib.fulgor_compact_runs.argtypes = [P, P, I, I, I] + [P] * 5 + [P]
    lib.fulgor_cuckoo_lookup.argtypes = [P, I, P, P, I, I, I, P, P, P]
    lib.fulgor_pack_codes.argtypes = [P, I, I, P, P, P]
    lib.fulgor_first_set_bits.argtypes = [P, I, I, I, P, P, P]
    lib.fulgor_staged_split.argtypes = [P] * 4 + [I] * 5 + [P] * 6
    lib.fulgor_staged_merge.argtypes = [P] * 11 + [I] * 4 + [P] * 4
    lib.fulgor_anchored_anchors.argtypes = [P] * 3 + [I] * 3 + [P] * 4
    lib.fulgor_anchored_extend.argtypes = (
        [P, ct.c_int64, P] + [P] * 2 + [P] * 7 + [I] * 5 + [P] * 6)
    lib.fulgor_anchored_merge.argtypes = [P] * 4 + [I] * 3 + [P] * 4
    lib.fulgor_runs_scores.argtypes = [P, I, I, P, P, I, I, I, P, P, I, P,
                                       P]
    lib.fulgor_pack_hits.argtypes = [P, P, I, I, P, P, P]
    L = ct.c_int64
    lib.fulgor_minidict_v1_verify.argtypes = (
        [P, L, P, L, P, L] + [P] * 8 + [L, I, I, I] + [P] * 3 + [P])
    for fn in (lib.fulgor_window_prep, lib.fulgor_minidict2_probe,
               lib.fulgor_fi_and, lib.fulgor_tu_mask,
               lib.fulgor_km_scores, lib.fulgor_compact_runs,
               lib.fulgor_cuckoo_lookup, lib.fulgor_pack_codes,
               lib.fulgor_first_set_bits, lib.fulgor_staged_split,
               lib.fulgor_staged_merge, lib.fulgor_anchored_anchors,
               lib.fulgor_anchored_extend, lib.fulgor_anchored_merge,
               lib.fulgor_runs_scores, lib.fulgor_pack_hits,
               lib.fulgor_minidict_v1_verify):
        fn.restype = I
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
