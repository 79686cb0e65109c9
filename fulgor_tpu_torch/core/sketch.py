"""HyperLogLog sketches + divisive k-means (build-time clustering), as in
fulgor_tpu's core/sketch.py: the same hashes and seeds, so that the
colour re-compressions (build/color_builder.py) match fulgor_tpu's.

Replaces the reference's dnbaker/sketch (hll_t) and jermp/kmeans submodules
(use-sites: include/build_util.hpp:8-253, builders/meta_builder.hpp:14-124,
builders/differential_builder.hpp:7-197). Only the clustering *quality*
affects the reference's behavior (compression ratio); correctness never
depends on it, so the algorithms here are deterministic re-implementations,
not ports: an HLL with p-bit register indexing and a bisecting k-means over
register vectors (seeded, largest-cluster-first splits).
"""

from __future__ import annotations

import numpy as np

HLL_P = 10  # 2^10 registers (reference: p=10, meta_builder.hpp:24)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hll_parts(values: np.ndarray):
    """-> (register index, rank) per value — for vectorized scatter-max."""
    h = _splitmix64(np.asarray(values, dtype=np.uint64))
    idx = (h >> np.uint64(64 - HLL_P)).astype(np.int64)
    rest = (h << np.uint64(HLL_P)) | np.uint64((1 << HLL_P) - 1)
    lz = (63 - np.floor(np.log2(rest.astype(np.float64) + 0.0))).astype(np.int64)
    rank = (lz + 1).astype(np.uint8)
    return idx, rank


def hll_add(registers: np.ndarray, values: np.ndarray):
    """Add uint64 values into a (2^p,) uint8 register array (in place)."""
    h = _splitmix64(np.asarray(values, dtype=np.uint64))
    idx = (h >> np.uint64(64 - HLL_P)).astype(np.int64)
    rest = (h << np.uint64(HLL_P)) | np.uint64((1 << HLL_P) - 1)
    # rank = leading zeros of rest + 1  (rest has low bits forced to 1)
    lz = (63 - np.floor(np.log2(rest.astype(np.float64) + 0.0))).astype(np.int64)
    rank = (lz + 1).astype(np.uint8)
    np.maximum.at(registers, idx, rank)


def hll_sketch(values: np.ndarray) -> np.ndarray:
    regs = np.zeros(1 << HLL_P, dtype=np.uint8)
    hll_add(regs, values)
    return regs


def sketch_matrix(groups: list[np.ndarray]) -> np.ndarray:
    """One HLL per group of uint64 values -> (n, 2^p) uint8."""
    out = np.zeros((len(groups), 1 << HLL_P), dtype=np.uint8)
    for i, vals in enumerate(groups):
        if len(vals):
            hll_add(out[i], vals)
    return out


def kmeans_divisive(
    points: np.ndarray,
    min_delta: float = 1e-4,
    max_iter: int = 10,
    min_cluster_size: int = 50,
    seed: int = 0,
) -> np.ndarray:
    """Bisecting k-means over float-converted rows -> cluster label per row.

    Deterministic: fixed seed, largest-cluster-first split order, split
    accepted only if it reduces within-cluster SSE by > min_delta
    (relative). Parameters mirror the reference's clustering_parameters
    (meta_builder.hpp:56-64)."""
    n = len(points)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    X = np.ascontiguousarray(points, dtype=np.float32)
    labels = np.zeros(n, dtype=np.uint32)
    next_label = 1

    from ..native import lib as native

    def sse(idx):
        if len(idx) == 0:
            return 0.0
        sub = X[idx].astype(np.float64)
        m = sub.mean(axis=0)
        return float((sub**2).sum() - len(idx) * (m @ m))

    # wave-batched divisive bisection: every pending cluster of a wave is
    # bisected in ONE native call (parallel across clusters, within the big
    # ones — per-cluster results are identical either way thanks to the
    # chunk-serial reductions). The bisection seed point is a deterministic
    # hash of the cluster's identity (first member, size, global seed), so
    # the outcome is independent of processing order; split acceptance
    # (relative SSE reduction > min_delta) is per cluster and thus
    # order-free too.
    wave: list = [(np.arange(n, dtype=np.int64), sse(np.arange(n)))]
    while wave:
        todo = [
            (idx, base)
            for idx, base in wave
            if len(idx) > min_cluster_size and base > 0
        ]
        if not todo:
            break
        lens = np.array([len(idx) for idx, _ in todo], dtype=np.uint64)
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        cat = np.concatenate([idx for idx, _ in todo])
        firsts = np.array([idx[0] for idx, _ in todo], dtype=np.uint64)
        h = _splitmix64(
            firsts * np.uint64(0x9E3779B1)
            + lens
            + np.uint64(seed) * np.uint64(0xC2B2AE3D)
        )
        i0s = (h % lens).astype(np.int64)
        assign, sse2 = native.bisect2_batch(X, cat, offs, i0s, max_iter)
        new_wave = []
        for t, (idx, base) in enumerate(todo):
            a = assign[offs[t] : offs[t + 1]]
            part0 = idx[a == 0]
            part1 = idx[a == 1]
            if len(part0) == 0 or len(part1) == 0:
                continue
            sse0, sse1 = float(sse2[t, 0]), float(sse2[t, 1])
            if base - (sse0 + sse1) <= min_delta * base:
                continue
            labels[part1] = next_label
            next_label += 1
            new_wave.append((part0, sse0))
            new_wave.append((part1, sse1))
        wave = new_wave

    # compact labels to 0..k-1 in first-appearance order
    uniq, first = np.unique(labels, return_index=True)
    order = uniq[np.argsort(first)]
    remap = np.zeros(labels.max() + 1, dtype=np.uint32)
    remap[order] = np.arange(len(order), dtype=np.uint32)
    return remap[labels]
