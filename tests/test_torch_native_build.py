"""Both native host libraries load, and the test run never loads a
half-written one.

fulgor_tpu's loader (fulgor_tpu/native/lib.py) runs `make` straight into
the shared libfulgor_native.so when that file is missing or older than its
source, guarded by a thread lock only. Under pytest-xdist every worker is a
process of its own: one worker's compiler can still be writing the file
while another finds it present and newer than the source and loads a
truncated library ("file too short"). The port's loader builds under a
private name and renames the result into place.

This module does the same for fulgor_tpu's library while it is imported.
Every worker imports every test module during collection, before any test
runs, so the guard below has run in each worker first: under a file lock,
the first worker builds the library if it is stale, and the others wait
and then find it up to date, so fulgor_tpu's loader never runs `make`.
The guard imports nothing of fulgor_tpu and edits none of its files.
"""

import fcntl
import hashlib
import os
import subprocess
import tempfile

from tests.test_torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE = os.path.join(ROOT, "fulgor_tpu", "native")
REF_SO = os.path.join(REF_NATIVE, "libfulgor_native.so")
REF_SRC = os.path.join(REF_NATIVE, "src", "fulgor_native.cpp")


def _stale(so: str, src: str) -> bool:
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def build_reference_library():
    """Build fulgor_tpu's native library if it is missing or older than its
    source, under a lock shared by every process of the test run, into a
    private file renamed into place. -> None, or the build's output where
    `make` failed (the test below reports it). With FULGOR_NATIVE_LIB set
    fulgor_tpu loads that file and builds nothing, so neither does this."""
    if os.environ.get("FULGOR_NATIVE_LIB"):
        return None
    tag = hashlib.sha1(REF_NATIVE.encode()).hexdigest()[:16]
    lock = os.path.join(tempfile.gettempdir(), f"fulgor_native_{tag}.lock")
    with open(lock, "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _stale(REF_SO, REF_SRC):
                return None
            tmp = f"{REF_SO}.{os.getpid()}.tmp"
            res = subprocess.run(["make", "-C", REF_NATIVE, f"OUT={tmp}"],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                return res.stdout + res.stderr
            os.replace(tmp, REF_SO)
            return None
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


_BUILD_ERROR = build_reference_library()


def test_both_native_libraries_load():
    assert _BUILD_ERROR is None, _BUILD_ERROR
    assert os.environ.get("FULGOR_NATIVE_LIB") or not _stale(REF_SO, REF_SRC)
    from fulgor_tpu.native import lib as ref
    from fulgor_tpu_torch.native import lib as port

    for mod in (ref, port):
        assert mod._load() is not None
