"""ctypes bindings for the native host library (builds on first use)."""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
# FULGOR_NATIVE_LIB: alternate build override (e.g. the ASan build — see
# the Makefile's `asan` target for the full invocation)
_SO = os.environ.get("FULGOR_NATIVE_LIB") or os.path.join(
    _DIR, "libfulgor_native.so"
)
_SRC = os.path.join(_DIR, "src", "fulgor_native.cpp")

_lock = threading.Lock()
_lib = None


class CcdbgOut(ct.Structure):
    _fields_ = [
        ("unitig_codes", ct.POINTER(ct.c_uint8)),
        ("unitig_offs", ct.POINTER(ct.c_int64)),
        ("unitig_cs", ct.POINTER(ct.c_uint32)),
        ("cs_colors", ct.POINTER(ct.c_uint32)),
        ("cs_offs", ct.POINTER(ct.c_int64)),
        ("num_unitigs", ct.c_int64),
        ("num_color_sets", ct.c_int64),
        ("num_kmers", ct.c_int64),
        ("codes_len", ct.c_int64),
        ("cs_colors_len", ct.c_int64),
    ]


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            # build under a private name and rename into place, so that
            # processes starting together never load a half-written library
            # The compiler is g++ from PATH (FULGOR_CXX overrides), not an
            # ambient CXX: some CUDA hosts export a CXX without OpenMP.
            tmp = f"{_SO}.{os.getpid()}.tmp"
            cxx = os.environ.get("FULGOR_CXX", "g++")
            res = subprocess.run(["make", "-C", _DIR, f"OUT={tmp}",
                                  f"CXX={cxx}"],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"building the native library failed:\n{res.stdout}"
                    f"{res.stderr}")
            os.replace(tmp, _SO)
        lib = ct.CDLL(_SO)
        lib.fn_free.argtypes = [ct.c_void_p]
        lib.fn_build_ccdbg.argtypes = [ct.c_char_p, ct.c_int, ct.c_int, ct.POINTER(CcdbgOut)]
        lib.fn_build_ccdbg.restype = ct.c_int
        lib.fn_build_ccdbg_mp.argtypes = [
            ct.c_char_p, ct.c_int, ct.c_int, ct.c_int, ct.POINTER(CcdbgOut)
        ]
        lib.fn_build_ccdbg_mp.restype = ct.c_int
        lib.fn_build_ccdbg_spill.argtypes = [
            ct.c_char_p, ct.c_int, ct.c_int, ct.c_int, ct.c_char_p,
            ct.POINTER(CcdbgOut),
        ]
        lib.fn_build_ccdbg_spill.restype = ct.c_int
        lib.fn_cuckoo_build.argtypes = [
            ct.POINTER(ct.c_uint64),
            ct.POINTER(ct.c_uint32),
            ct.c_int64,
            ct.POINTER(ct.POINTER(ct.c_uint32)),
        ]
        lib.fn_cuckoo_build.restype = ct.c_uint64
        lib.fn_hybrid_decode_all.argtypes = [
            ct.POINTER(ct.c_uint64),
            ct.POINTER(ct.c_uint64),
            ct.c_int64,
            ct.c_uint32,
            ct.POINTER(ct.POINTER(ct.c_uint32)),
            ct.POINTER(ct.POINTER(ct.c_int64)),
            ct.POINTER(ct.c_int64),
        ]
        lib.fn_hybrid_decode_all.restype = ct.c_int
        lib.fn_parse_reads.argtypes = [
            ct.c_char_p,
            ct.c_int64,
            ct.POINTER(ct.POINTER(ct.c_uint8)),
            ct.POINTER(ct.POINTER(ct.c_int32)),
            ct.POINTER(ct.POINTER(ct.c_char)),
            ct.POINTER(ct.POINTER(ct.c_int64)),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int32),
        ]
        lib.fn_parse_reads.restype = ct.c_int
        lib.fn_format_psa_ascii.argtypes = [
            ct.POINTER(ct.c_uint32),
            ct.POINTER(ct.c_uint32),
            ct.POINTER(ct.c_int64),
            ct.c_int64,
            ct.POINTER(ct.POINTER(ct.c_char)),
            ct.POINTER(ct.c_int64),
        ]
        lib.fn_format_psa_ascii.restype = ct.c_int
        lib.fn_delta_records_decode.argtypes = [
            ct.POINTER(ct.c_uint64),
            ct.POINTER(ct.c_uint64),
            ct.c_int64,
            ct.c_int,
            ct.POINTER(ct.POINTER(ct.c_int64)),
            ct.POINTER(ct.POINTER(ct.c_uint32)),
            ct.POINTER(ct.POINTER(ct.c_int64)),
            ct.POINTER(ct.c_int64),
        ]
        lib.fn_delta_records_decode.restype = ct.c_int
        lib.fn_format_kc.argtypes = [
            ct.c_char_p, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint32),
            ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.POINTER(ct.c_char)), ct.POINTER(ct.c_int64),
        ]
        lib.fn_format_kc.restype = ct.c_int
        lib.fn_format_km.argtypes = [
            ct.c_char_p, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_uint32), ct.c_int64,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_int64,
            ct.POINTER(ct.POINTER(ct.c_char)), ct.POINTER(ct.c_int64),
        ]
        lib.fn_format_km.restype = ct.c_int
        lib.fn_format_km_u16.argtypes = [
            ct.c_char_p, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_uint32), ct.c_int64,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_uint16),
            ct.c_int64, ct.c_int64,
            ct.POINTER(ct.POINTER(ct.c_char)), ct.POINTER(ct.c_int64),
        ]
        lib.fn_format_km_u16.restype = ct.c_int
        lib.fn_format_psa_ascii_bits.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint32),
            ct.c_int64, ct.c_int32,
            ct.POINTER(ct.POINTER(ct.c_char)), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
        ]
        lib.fn_format_psa_ascii_bits.restype = ct.c_int
        lib.fn_format_psa_ascii_bits_grouped.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint32),
            ct.POINTER(ct.c_int32), ct.c_int64, ct.c_int64, ct.c_int32,
            ct.POINTER(ct.POINTER(ct.c_char)), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
        ]
        lib.fn_format_psa_ascii_bits_grouped.restype = ct.c_int
        lib.fn_sort_i64.argtypes = [ct.POINTER(ct.c_int64), ct.c_int64]
        lib.fn_sort_i64.restype = None
        lib.fn_symdiff_segments.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.c_int64, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.POINTER(ct.c_uint32)),
        ]
        lib.fn_symdiff_segments.restype = ct.c_int
        lib.fn_symdiff_segments_ind.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.c_int64, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.POINTER(ct.c_uint32)),
        ]
        lib.fn_symdiff_segments_ind.restype = ct.c_int
        lib.fn_pooled_features.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_uint32, ct.c_int32, ct.POINTER(ct.c_uint32),
        ]
        lib.fn_pooled_features.restype = None
        lib.fn_bisect2.argtypes = [
            ct.POINTER(ct.c_float), ct.c_int32, ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_int64, ct.c_int32,
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_double),
        ]
        lib.fn_bisect2.restype = None
        lib.fn_bisect2_batch.argtypes = [
            ct.POINTER(ct.c_float), ct.c_int32, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64), ct.c_int64, ct.POINTER(ct.c_int64),
            ct.c_int32, ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_double),
        ]
        lib.fn_bisect2_batch.restype = None
        lib.fn_dense_bits.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_int64, ct.POINTER(ct.c_uint32),
        ]
        lib.fn_dense_bits.restype = None
        lib.fn_and_reduce_rows.argtypes = [
            ct.POINTER(ct.c_uint32), ct.c_int64, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64), ct.c_int64, ct.POINTER(ct.c_uint32),
        ]
        lib.fn_and_reduce_rows.restype = None
        lib.fn_pack_patterns.argtypes = [
            ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_uint64), ct.c_int64,
            ct.POINTER(ct.c_uint64),
        ]
        lib.fn_pack_patterns.restype = None
        lib.fn_touch.argtypes = [ct.c_char_p, ct.c_int64]
        lib.fn_touch.restype = None
        lib.fn_omp_threads.argtypes = [ct.c_int]
        lib.fn_omp_threads.restype = ct.c_int
        lib.fn_hash_partials.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64),
            ct.c_int64, ct.c_int64,
            ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_uint64),
        ]
        lib.fn_hash_partials.restype = None
        lib.fn_color_features_fp.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_uint16),
            ct.c_int32, ct.c_int64, ct.POINTER(ct.c_uint64),
        ]
        lib.fn_color_features_fp.restype = None
        lib.fn_permute_sort_segments.argtypes = [
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.c_uint32),
        ]
        lib.fn_permute_sort_segments.restype = None
        _lib = lib
        return lib


def _take(ptr, n, dtype):
    """Copy a malloc'd C buffer into numpy and free it."""
    lib = _load()
    if n == 0:
        lib.fn_free(ptr)
        return np.empty(0, dtype=dtype)
    arr = np.ctypeslib.as_array(ptr, shape=(int(n),)).astype(dtype, copy=True)
    lib.fn_free(ptr)
    return arr


def build_ccdbg(paths: list[str], k: int, num_passes: int = 1,
                spill_dir: str | None = None):
    """Native ccdBG build -> dict of arrays (same contract as build_ccdbg_py).

    num_passes > 1 bounds peak (k-mer, color) pair memory by processing key
    partitions one at a time (the scale knob for corpora whose pair table
    exceeds RAM; output is pass-count invariant). The partition streams
    come from re-parsing the inputs per pass, or — with spill_dir set —
    from ONE parse that spills each partition to a temp file there
    (external-memory mode for slow-to-parse corpora; reference GGCAT temp
    dirs, GGCAT.hpp:42-50)."""
    lib = _load()
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = CcdbgOut()
    if spill_dir is not None and num_passes > 1:
        rc = lib.fn_build_ccdbg_spill(
            blob, len(paths), k, num_passes, spill_dir.encode(), ct.byref(out)
        )
    else:
        rc = lib.fn_build_ccdbg_mp(blob, len(paths), k, num_passes, ct.byref(out))
    if rc != 0:
        raise RuntimeError(f"fn_build_ccdbg failed rc={rc} (bad path or invalid k={k}?)")
    return dict(
        unitig_codes=_take(out.unitig_codes, out.codes_len, np.uint8),
        unitig_offs=_take(out.unitig_offs, out.num_unitigs + 1, np.int64),
        unitig_cs=_take(out.unitig_cs, out.num_unitigs, np.uint32),
        cs_colors=_take(out.cs_colors, out.cs_colors_len, np.uint32),
        cs_offs=_take(out.cs_offs, out.num_color_sets + 1, np.int64),
        num_kmers=int(out.num_kmers),
    )


def cuckoo_build(keys: np.ndarray, vals: np.ndarray):
    """-> quotient-cuckoo table (nb, 4) uint32: two u64 slots per bucket
    (see native fn_cuckoo_build / query/host_lookup.py for the layout)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    ptr = ct.POINTER(ct.c_uint32)()
    nb = lib.fn_cuckoo_build(
        keys.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        vals.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        len(keys),
        ct.byref(ptr),
    )
    if nb == 0:
        raise RuntimeError("cuckoo build failed")
    return _take(ptr, nb * 4, np.uint32).reshape(int(nb), 4)


def hybrid_decode_all(words: np.ndarray, bit_offsets: np.ndarray, num_colors: int):
    lib = _load()
    words = np.ascontiguousarray(words, dtype=np.uint64)
    if len(words) == 0:
        words = np.zeros(1, dtype=np.uint64)
    offs = np.ascontiguousarray(bit_offsets, dtype=np.uint64)
    n_sets = len(offs) - 1
    cat_p = ct.POINTER(ct.c_uint32)()
    offs_p = ct.POINTER(ct.c_int64)()
    cat_len = ct.c_int64()
    rc = lib.fn_hybrid_decode_all(
        words.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        offs.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        n_sets,
        num_colors,
        ct.byref(cat_p),
        ct.byref(offs_p),
        ct.byref(cat_len),
    )
    if rc != 0:
        raise RuntimeError("hybrid_decode_all failed")
    cat = _take(cat_p, cat_len.value, np.uint32)
    out_offs = _take(offs_p, n_sets + 1, np.int64)
    return cat, out_offs


def parse_reads(path: str, max_reads: int = 0):
    """-> (codes (n, maxlen) uint8 [4=pad], lens (n,) int32, names list[str])."""
    lib = _load()
    codes_p = ct.POINTER(ct.c_uint8)()
    lens_p = ct.POINTER(ct.c_int32)()
    names_p = ct.POINTER(ct.c_char)()
    noffs_p = ct.POINTER(ct.c_int64)()
    num = ct.c_int64()
    maxlen = ct.c_int32()
    rc = lib.fn_parse_reads(
        path.encode(),
        max_reads,
        ct.byref(codes_p),
        ct.byref(lens_p),
        ct.byref(names_p),
        ct.byref(noffs_p),
        ct.byref(num),
        ct.byref(maxlen),
    )
    if rc != 0:
        raise RuntimeError(f"cannot parse reads file: {path}")
    n, L = num.value, maxlen.value
    codes = _take(ct.cast(codes_p, ct.POINTER(ct.c_uint8)), n * L, np.uint8).reshape(n, L)
    lens = _take(lens_p, n, np.int32)
    noffs = _take(noffs_p, n + 1, np.int64)
    blob_len = int(noffs[-1]) if n else 0
    blob = (
        _take(ct.cast(names_p, ct.POINTER(ct.c_uint8)), blob_len, np.uint8)
        .tobytes()
        .decode(errors="replace")
        if blob_len
        else ""
    )
    if blob_len == 0:
        lib.fn_free(names_p)
    names = [blob[noffs[i] : noffs[i + 1]] for i in range(n)]
    return codes, lens, names


def parse_reads_select(path: str, ids):
    """Stream the file and return ONLY reads with the given 0-based ids
    (ragged): -> (list[np.uint8 codes], list[str] names), in id-sorted order.
    Avoids materializing a dense (num_reads, max_len) matrix when only a few
    reads (e.g. long-read stragglers) are needed."""
    lib = _load()
    if not hasattr(lib, "_sel_proto"):
        lib.fn_reads_select.argtypes = [
            ct.c_char_p, ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.POINTER(ct.c_uint8)), ct.POINTER(ct.POINTER(ct.c_int64)),
            ct.POINTER(ct.POINTER(ct.c_char)), ct.POINTER(ct.POINTER(ct.c_int64)),
        ]
        lib.fn_reads_select.restype = ct.c_int
        lib._sel_proto = True
    ids = np.ascontiguousarray(np.sort(np.asarray(ids, dtype=np.int64)))
    n = len(ids)
    if n == 0:
        return [], []
    seq_p = ct.POINTER(ct.c_uint8)()
    soffs_p = ct.POINTER(ct.c_int64)()
    names_p = ct.POINTER(ct.c_char)()
    noffs_p = ct.POINTER(ct.c_int64)()
    rc = lib.fn_reads_select(
        path.encode(), ids.ctypes.data_as(ct.POINTER(ct.c_int64)), n,
        ct.byref(seq_p), ct.byref(soffs_p), ct.byref(names_p), ct.byref(noffs_p),
    )
    if rc != 0:
        raise RuntimeError(f"reads_select failed rc={rc}: {path}")
    soffs = _take(soffs_p, n + 1, np.int64)
    noffs = _take(noffs_p, n + 1, np.int64)
    seqblob = _take(seq_p, int(soffs[-1]), np.uint8)  # _take frees even when empty
    blob_len = int(noffs[-1])
    blob = (
        _take(ct.cast(names_p, ct.POINTER(ct.c_uint8)), blob_len, np.uint8)
        .tobytes().decode(errors="replace")
        if blob_len else ""
    )
    if blob_len == 0:
        lib.fn_free(names_p)
    seqs = [seqblob[soffs[i]: soffs[i + 1]] for i in range(n)]
    names = [blob[noffs[i]: noffs[i + 1]] for i in range(n)]
    return seqs, names


def _bytes_at(buf, size: int) -> bytes:
    """bytes from a malloc'd char* of SIZE bytes. ct.string_at truncates
    its length arg to C int, so buffers past 2 GiB (large pseudoalign
    batches: 32k reads x thousands of colors) came back with a negative
    size — copy through a ctypes array, which carries Py_ssize_t."""
    if size <= 0:
        return b""
    return bytes((ct.c_char * size).from_address(
        ct.addressof(buf.contents)))


def _emit(buf, size: int, sink):
    """Dispose of a malloc'd native buffer: with a sink callable, write a
    zero-copy memoryview straight to it (the copy through Python bytes was
    ~4.4 s of a pansal4546 run) and return the byte count; without one,
    return a bytes copy. Frees the buffer either way."""
    lib = _load()
    try:
        if size <= 0:
            return 0 if sink is not None else b""
        arr = (ct.c_char * size).from_address(ct.addressof(buf.contents))
        if sink is not None:
            sink(memoryview(arr))
            return size
        return bytes(arr)
    finally:
        lib.fn_free(buf)


def format_psa_ascii(qids: np.ndarray, colors_cat: np.ndarray, offs: np.ndarray) -> bytes:
    """ascii pseudoalignment block for a batch of results."""
    lib = _load()
    qids = np.ascontiguousarray(qids, dtype=np.uint32)
    colors_cat = np.ascontiguousarray(colors_cat, dtype=np.uint32)
    if len(colors_cat) == 0:
        colors_cat = np.zeros(1, dtype=np.uint32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    buf = ct.POINTER(ct.c_char)()
    blen = ct.c_int64()
    rc = lib.fn_format_psa_ascii(
        qids.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        colors_cat.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        len(qids),
        ct.byref(buf),
        ct.byref(blen),
    )
    if rc != 0:
        raise RuntimeError("format_psa_ascii failed")
    out = _bytes_at(buf, blen.value)
    lib.fn_free(buf)
    return out


def or_bits_at(res: np.ndarray, seg: np.ndarray, col: np.ndarray) -> None:
    """res[seg[i], col[i]//32] |= 1 << (col[i]%32), in place. res must be
    a C-contiguous (n, W) uint32 array; seg/col int64."""
    lib = _load()
    if not hasattr(lib.fn_or_bits_at, "argtypes") or not lib.fn_or_bits_at.argtypes:
        lib.fn_or_bits_at.argtypes = [
            ct.POINTER(ct.c_uint32), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64), ct.c_int64,
        ]
        lib.fn_or_bits_at.restype = None
    assert res.flags.c_contiguous and res.dtype == np.uint32
    seg = np.ascontiguousarray(seg, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    if len(seg):
        lib.fn_or_bits_at(
            res.ctypes.data_as(ct.POINTER(ct.c_uint32)), res.shape[1],
            seg.ctypes.data_as(ct.POINTER(ct.c_int64)),
            col.ctypes.data_as(ct.POINTER(ct.c_int64)), len(seg),
        )


def sort_i64(arr: np.ndarray) -> np.ndarray:
    """In-place parallel sort of a contiguous int64 array (falls back to
    np.sort semantics; uses all cores via gnu parallel sort)."""
    lib = _load()
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    if len(arr):
        lib.fn_sort_i64(arr.ctypes.data_as(ct.POINTER(ct.c_int64)), len(arr))
    return arr


def omp_threads(n: int = 0) -> int:
    """Set the OpenMP thread count of this library's later parallel regions
    on the calling thread (n >= 1; n = 0 only reads it). -> the count in
    force before the call. FULGOR_THREADS sizes its std::thread pools and
    its explicitly sized regions."""
    return int(_load().fn_omp_threads(int(n)))


_warmed_bytes = 0


def warm_heap(nbytes: int):
    """Pre-fault ~nbytes of reusable heap with all cores (one-time, ~4x the
    serial demand-fault rate on this host). With the package's malloc tuning
    the pages then stay mapped and every later large numpy allocation reuses
    them instead of faulting mid-pipeline. No-op for already-warmed bytes."""
    global _warmed_bytes
    nbytes = int(nbytes)
    if nbytes <= _warmed_bytes:
        return
    lib = _load()
    buf = np.empty(nbytes, dtype=np.uint8)
    lib.fn_touch(buf.ctypes.data_as(ct.c_char_p), nbytes)
    _warmed_bytes = nbytes
    del buf


def pack_patterns(pats: np.ndarray, lens: np.ndarray, total_bits: int) -> np.ndarray:
    """Pack (pattern, length) pairs into an LSB-first u64 bit stream."""
    lib = _load()
    pats = np.ascontiguousarray(pats, dtype=np.uint64)
    lens = np.ascontiguousarray(lens, dtype=np.uint64)
    nw = (total_bits + 63) // 64
    words = np.zeros(nw + 1, dtype=np.uint64)  # +1: aligned-tail spill slack
    if len(pats):
        lib.fn_pack_patterns(
            pats.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            lens.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            len(pats),
            words.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        )
    return words[:nw]


def bisect2(X: np.ndarray, idx: np.ndarray, i0: int, max_iter: int):
    """One deterministic 2-means bisection of X[idx] seeded at X[idx[i0]]
    (parallel; thread-count-invariant chunked reductions).
    -> (assign u8 (m,), sse0, sse1)."""
    lib = _load()
    assert X.dtype == np.float32 and X.flags.c_contiguous
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    m = len(idx)
    assign = np.empty(m, dtype=np.uint8)
    sse = np.zeros(2, dtype=np.float64)
    lib.fn_bisect2(
        X.ctypes.data_as(ct.POINTER(ct.c_float)), X.shape[1],
        idx.ctypes.data_as(ct.POINTER(ct.c_int64)), m, i0, max_iter,
        assign.ctypes.data_as(ct.POINTER(ct.c_uint8)),
        sse.ctypes.data_as(ct.POINTER(ct.c_double)),
    )
    return assign, float(sse[0]), float(sse[1])


def bisect2_batch(X: np.ndarray, idx_cat: np.ndarray, idx_offs: np.ndarray,
                  i0s: np.ndarray, max_iter: int):
    """Bisect every cluster of a wave in one call (parallel across the
    small clusters, within the big ones; per-cluster results identical to
    bisect2). idx_cat/idx_offs: concatenated per-cluster index lists;
    i0s: cluster-local seed positions.
    -> (assign u8 (len(idx_cat),), sse f64 (ncl, 2))."""
    lib = _load()
    assert X.dtype == np.float32 and X.flags.c_contiguous
    idx_cat = np.ascontiguousarray(idx_cat, dtype=np.int64)
    idx_offs = np.ascontiguousarray(idx_offs, dtype=np.int64)
    i0s = np.ascontiguousarray(i0s, dtype=np.int64)
    ncl = len(idx_offs) - 1
    assign = np.empty(len(idx_cat), dtype=np.uint8)
    sse = np.zeros((ncl, 2), dtype=np.float64)
    if ncl:
        lib.fn_bisect2_batch(
            X.ctypes.data_as(ct.POINTER(ct.c_float)), X.shape[1],
            idx_cat.ctypes.data_as(ct.POINTER(ct.c_int64)),
            idx_offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            ncl,
            i0s.ctypes.data_as(ct.POINTER(ct.c_int64)),
            max_iter,
            assign.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            sse.ctypes.data_as(ct.POINTER(ct.c_double)),
        )
    return assign, sse


def color_features_fp(cat, offs, wq, hs, dims: int, num_colors: int):
    """Fixed-point pooled co-occurrence features per color (parallel,
    thread-count-invariant): out[c, hs[s]] += wq[s] for c in set s.
    -> u64 (num_colors, dims)."""
    lib = _load()
    cat = np.ascontiguousarray(cat, dtype=np.uint32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    wq = np.ascontiguousarray(wq, dtype=np.uint64)
    hs = np.ascontiguousarray(hs, dtype=np.uint16)
    out = np.zeros((num_colors, dims), dtype=np.uint64)
    S = len(offs) - 1
    if S:
        lib.fn_color_features_fp(
            cat.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            S,
            wq.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            hs.ctypes.data_as(ct.POINTER(ct.c_uint16)),
            dims, num_colors,
            out.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        )
    return out


def permute_sort_segments(cat, offs, perm):
    """Apply a color permutation within every segment and re-sort each
    segment (parallel). Returns a new u32 array; `cat` is not modified."""
    lib = _load()
    out = np.array(cat, dtype=np.uint32, copy=True, order="C")
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    perm = np.ascontiguousarray(perm, dtype=np.uint32)
    n = len(offs) - 1
    if n:
        lib.fn_permute_sort_segments(
            out.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            n,
            perm.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        )
    return out


def hash_partials(rel: np.ndarray, starts: np.ndarray, total: int):
    """Two position-mixed 64-bit content hashes per occurrence range
    [starts[o], starts[o+1]) of `rel` (parallel). -> (h1, h2) u64."""
    lib = _load()
    rel = np.ascontiguousarray(rel, dtype=np.uint32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = len(starts)
    h1 = np.empty(n, dtype=np.uint64)
    h2 = np.empty(n, dtype=np.uint64)
    if n:
        lib.fn_hash_partials(
            rel.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            starts.ctypes.data_as(ct.POINTER(ct.c_int64)),
            n, total,
            h1.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            h2.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        )
    return h1, h2


def pooled_features(cat: np.ndarray, offs: np.ndarray, num_colors: int,
                    dims: int) -> np.ndarray:
    """Per-set pooled membership counts over `dims` equal-width color blocks
    (parallel; the converters' clustering feature space). -> u32 (n, dims)."""
    lib = _load()
    n = len(offs) - 1
    cat = np.ascontiguousarray(cat, dtype=np.uint32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    out = np.zeros((n, dims), dtype=np.uint32)
    if n:
        lib.fn_pooled_features(
            cat.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
            n, num_colors, dims,
            out.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        )
    return out


def symdiff_segments(cat_a, offs_a, cat_b, offs_b):
    """Per-segment symmetric difference of two families of sorted
    duplicate-free u32 lists (parallel two-pointer merges; the chain-diff
    converter's hot op). -> (out_cat u32, out_offs i64 (n+1,))."""
    lib = _load()
    n = len(offs_a) - 1
    assert len(offs_b) - 1 == n
    cat_a = np.ascontiguousarray(cat_a, dtype=np.uint32)
    cat_b = np.ascontiguousarray(cat_b, dtype=np.uint32)
    offs_a = np.ascontiguousarray(offs_a, dtype=np.int64)
    offs_b = np.ascontiguousarray(offs_b, dtype=np.int64)
    out_offs = np.zeros(n + 1, dtype=np.int64)
    out_ptr = ct.POINTER(ct.c_uint32)()
    rc = lib.fn_symdiff_segments(
        cat_a.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        offs_a.ctypes.data_as(ct.POINTER(ct.c_int64)),
        cat_b.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        offs_b.ctypes.data_as(ct.POINTER(ct.c_int64)),
        n,
        out_offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ct.byref(out_ptr),
    )
    if rc != 0:
        raise MemoryError("symdiff_segments allocation failed")
    return _take(out_ptr, int(out_offs[n]), np.uint32), out_offs


def dense_bits(cat: np.ndarray, starts: np.ndarray, ends: np.ndarray,
               num_colors: int) -> np.ndarray:
    """(len(starts), ceil(num_colors/32)) u32 bitset matrix: row s covers
    cat[starts[s]:ends[s]] (parallel over rows). Pass offs[:-1]/offs[1:]
    for the all-sets case."""
    lib = _load()
    cat = np.ascontiguousarray(cat, dtype=np.uint32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    S = len(starts)
    W = (num_colors + 31) // 32
    out = np.zeros((S, W), dtype=np.uint32)
    if S:
        lib.fn_dense_bits(
            cat.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            starts.ctypes.data_as(ct.POINTER(ct.c_int64)),
            ends.ctypes.data_as(ct.POINTER(ct.c_int64)),
            S, W,
            out.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        )
    return out


def and_reduce_rows(dense: np.ndarray, ids: np.ndarray,
                    starts: np.ndarray) -> np.ndarray:
    """(len(starts)-1, W) u32: segment s = AND of dense rows ids[starts[s]:
    starts[s+1]] (empty segment -> zeros). Parallel over segments; no
    (total_ids, W) intermediate (vs numpy gather + bitwise_and.reduceat)."""
    lib = _load()
    assert dense.dtype == np.uint32 and dense.flags.c_contiguous
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    nseg = len(starts) - 1
    out = np.empty((nseg, dense.shape[1]), dtype=np.uint32)
    if nseg:
        lib.fn_and_reduce_rows(
            dense.ctypes.data_as(ct.POINTER(ct.c_uint32)), dense.shape[1],
            ids.ctypes.data_as(ct.POINTER(ct.c_int64)),
            starts.ctypes.data_as(ct.POINTER(ct.c_int64)),
            nseg, out.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        )
    return out


def symdiff_segments_ind(cat_a, starts_a, ends_a, cat_b, starts_b, ends_b):
    """symdiff_segments with per-side arbitrary [start, end) slices: segment
    s = setxor1d(a[starts_a[s]:ends_a[s]], b[starts_b[s]:ends_b[s]]). Reads
    both sides in place — no gather-index materialization for chain-parent
    segments. -> (out_cat u32, out_offs i64 (n+1,))."""
    lib = _load()
    n = len(starts_a)
    cat_a = np.ascontiguousarray(cat_a, dtype=np.uint32)
    cat_b = np.ascontiguousarray(cat_b, dtype=np.uint32)
    starts_a = np.ascontiguousarray(starts_a, dtype=np.int64)
    ends_a = np.ascontiguousarray(ends_a, dtype=np.int64)
    starts_b = np.ascontiguousarray(starts_b, dtype=np.int64)
    ends_b = np.ascontiguousarray(ends_b, dtype=np.int64)
    out_offs = np.zeros(n + 1, dtype=np.int64)
    out_ptr = ct.POINTER(ct.c_uint32)()
    rc = lib.fn_symdiff_segments_ind(
        cat_a.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        starts_a.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ends_a.ctypes.data_as(ct.POINTER(ct.c_int64)),
        cat_b.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        starts_b.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ends_b.ctypes.data_as(ct.POINTER(ct.c_int64)),
        n,
        out_offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ct.byref(out_ptr),
    )
    if rc != 0:
        raise MemoryError("symdiff_segments_ind allocation failed")
    return _take(out_ptr, int(out_offs[n]), np.uint32), out_offs


def format_psa_ascii_bits(qids: np.ndarray, bits: np.ndarray, sink=None):
    """ascii pseudoalignment block straight from (n, C32) u32 bitset rows.
    -> (bytes, num_mapped), or (bytes_written, num_mapped) with a zero-copy
    `sink` callable. Avoids materializing per-read color lists."""
    lib = _load()
    qids = np.ascontiguousarray(qids, dtype=np.uint32)
    bits = np.ascontiguousarray(bits, dtype=np.uint32)
    n, c32 = bits.shape
    buf = ct.POINTER(ct.c_char)()
    blen = ct.c_int64()
    mapped = ct.c_int64()
    rc = lib.fn_format_psa_ascii_bits(
        qids.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        bits.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        n, c32,
        ct.byref(buf), ct.byref(blen), ct.byref(mapped),
    )
    if rc != 0:
        raise RuntimeError("format_psa_ascii_bits failed")
    return _emit(buf, blen.value, sink), int(mapped.value)


def format_psa_ascii_bits_grouped(qids, rows, inv, sink=None):
    """ascii pseudoalignment block where read i's result is DISTINCT row
    inv[i] of `rows` (G, c32): each distinct body is formatted once and
    memcpy'd per read. -> (bytes, num_mapped), or (bytes_written,
    num_mapped) with a zero-copy `sink` callable."""
    lib = _load()
    qids = np.ascontiguousarray(qids, dtype=np.uint32)
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    inv = np.ascontiguousarray(inv, dtype=np.int32)
    G, c32 = rows.shape
    buf = ct.POINTER(ct.c_char)()
    blen = ct.c_int64()
    mapped = ct.c_int64()
    rc = lib.fn_format_psa_ascii_bits_grouped(
        qids.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        rows.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        inv.ctypes.data_as(ct.POINTER(ct.c_int32)),
        len(qids), G, c32,
        ct.byref(buf), ct.byref(blen), ct.byref(mapped),
    )
    if rc != 0:
        raise RuntimeError("format_psa_ascii_bits_grouped failed")
    return _emit(buf, blen.value, sink), int(mapped.value)


class ReadsStream:
    """Chunked FASTA/FASTQ(.gz) reader (native): overlaps parsing with
    device compute. Yields fixed-shape padded chunks."""

    def __init__(self, path: str, chunk_reads: int, row_len: int = 1024):
        lib = _load()
        lib.fn_reads_open.argtypes = [ct.c_char_p]
        lib.fn_reads_open.restype = ct.c_void_p
        lib.fn_reads_next.argtypes = [
            ct.c_void_p, ct.c_int64, ct.c_int32,
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_char), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int),
        ]
        lib.fn_reads_next.restype = ct.c_int64
        lib.fn_reads_close.argtypes = [ct.c_void_p]
        self._lib = lib
        self._h = lib.fn_reads_open(path.encode())
        if not self._h:
            raise RuntimeError(f"cannot open reads file: {path}")
        self.chunk_reads = chunk_reads
        self.row_len = row_len
        self._codes = np.empty((chunk_reads, row_len), dtype=np.uint8)
        self._lens = np.empty(chunk_reads, dtype=np.int32)
        self._names_cap = chunk_reads * 64
        self._names = ct.create_string_buffer(self._names_cap)
        self._noffs = np.empty(chunk_reads + 1, dtype=np.int64)

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        done = ct.c_int(0)
        while True:
            n = self._lib.fn_reads_next(
                self._h,
                self.chunk_reads,
                self.row_len,
                self._codes.ctypes.data_as(ct.POINTER(ct.c_uint8)),
                self._lens.ctypes.data_as(ct.POINTER(ct.c_int32)),
                self._names,
                self._names_cap,
                self._noffs.ctypes.data_as(ct.POINTER(ct.c_int64)),
                ct.byref(done),
            )
            if n >= 0:
                break
            # a single name exceeds the buffer: grow and retry (never truncate)
            self._names_cap = max(-int(n), self._names_cap * 2)
            self._names = ct.create_string_buffer(self._names_cap)
        if n == 0:
            self.close()
            raise StopIteration
        blob = self._names.raw[: self._noffs[n]].decode(errors="replace")
        names = [blob[self._noffs[i] : self._noffs[i + 1]] for i in range(n)]
        out = (self._codes[:n], self._lens[:n].copy(), names)
        if done.value:
            self.close()
        return out

    def close(self):
        if self._h is not None:
            self._lib.fn_reads_close(self._h)
            self._h = None


def delta_records_decode(words: np.ndarray, bit_offs: np.ndarray, num_headers: int):
    """-> (headers (n, H) i64, cat u32, offs i64); see encode_delta_lists."""
    lib = _load()
    words = np.ascontiguousarray(words, dtype=np.uint64)
    if len(words) == 0:
        words = np.zeros(1, dtype=np.uint64)
    offs_in = np.ascontiguousarray(bit_offs, dtype=np.uint64)
    n = len(offs_in) - 1
    h_p = ct.POINTER(ct.c_int64)()
    cat_p = ct.POINTER(ct.c_uint32)()
    offs_p = ct.POINTER(ct.c_int64)()
    cat_len = ct.c_int64()
    rc = lib.fn_delta_records_decode(
        words.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        offs_in.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        n,
        num_headers,
        ct.byref(h_p),
        ct.byref(cat_p),
        ct.byref(offs_p),
        ct.byref(cat_len),
    )
    if rc != 0:
        raise RuntimeError("delta_records_decode failed")
    headers = _take(h_p, max(1, n * num_headers), np.int64)[: n * num_headers].reshape(
        n, num_headers
    )
    cat = _take(cat_p, cat_len.value, np.uint32)
    offs = _take(offs_p, n + 1, np.int64)
    return headers, cat, offs


def _names_blob(names):
    blob = "".join(names).encode()
    offs = np.zeros(len(names) + 1, dtype=np.int64)
    pos = 0
    for i, nm in enumerate(names):
        pos += len(nm.encode())
        offs[i + 1] = pos
    return blob, offs


def format_kc(names, starts, lens_, ids, run_offs) -> bytes:
    lib = _load()
    blob, noffs = _names_blob(names)
    starts = np.ascontiguousarray(starts, dtype=np.uint32)
    lens_ = np.ascontiguousarray(lens_, dtype=np.uint32)
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    if len(starts) == 0:
        starts = lens_ = ids = np.zeros(1, dtype=np.uint32)
    run_offs = np.ascontiguousarray(run_offs, dtype=np.int64)
    buf = ct.POINTER(ct.c_char)()
    blen = ct.c_int64()
    rc = lib.fn_format_kc(
        blob, noffs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        starts.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        lens_.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        ids.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        run_offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        len(names), ct.byref(buf), ct.byref(blen),
    )
    if rc != 0:
        raise RuntimeError("format_kc failed")
    out = _bytes_at(buf, blen.value)
    lib.fn_free(buf)
    return out


def format_km(names, hit_words, widths, counts) -> bytes:
    lib = _load()
    blob, noffs = _names_blob(names)
    hit_words = np.ascontiguousarray(hit_words, dtype=np.uint32)
    widths = np.ascontiguousarray(widths, dtype=np.int32)
    # format straight from the device's u16 count buffer when possible (a
    # (batch, num_colors) int64 conversion costs ~0.25 GB/batch at 1k colors)
    if counts.dtype == np.uint16:
        counts = np.ascontiguousarray(counts)
        fn, cptr = lib.fn_format_km_u16, ct.POINTER(ct.c_uint16)
    else:
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        fn, cptr = lib.fn_format_km, ct.POINTER(ct.c_int64)
    n, wpr = hit_words.shape
    C = counts.shape[1]
    buf = ct.POINTER(ct.c_char)()
    blen = ct.c_int64()
    rc = fn(
        blob, noffs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        hit_words.ctypes.data_as(ct.POINTER(ct.c_uint32)), wpr,
        widths.ctypes.data_as(ct.POINTER(ct.c_int32)),
        counts.ctypes.data_as(cptr),
        C, n, ct.byref(buf), ct.byref(blen),
    )
    if rc != 0:
        raise RuntimeError("format_km failed")
    out = _bytes_at(buf, blen.value)
    lib.fn_free(buf)
    return out
