"""Query steps sharded over a (data, colour) grid of devices in one process
(counterpart of fulgor_tpu/parallel/mesh.py).

fulgor_tpu's mesh is single-controller: one process drives every local
device (jax.local_devices(), its engine.py:193-199); processes belong to
multi-host. So is this one: one process drives a (D, P) grid of torch
devices with the axes "data" and "color".

One step over the grid, as in fulgor_tpu:
  phase 1  every cell probes its OWN block of the batch, the reads split
           over both axes (cell (d, p) takes rows [(d P + p) b,
           (d P + p + 1) b), b = B / (D P)), and builds its compact
           (csid, count) runs: K1 -> K2 (or K7) -> K6 (kmer-matches: with
           the cell's hit words, from the same K6 launch);
  phase 2  each cell of a data row gathers the runs of that row's cells,
           in cell order: a copy to its device (after an event recorded on
           the source cell's stream) and a concatenation (fulgor_tpu's
           all_gather along "color");
  phase 3  each cell scores the gathered row block against its own colour
           shard: K3 AND (FI), K12 threshold-union mask (TU) or K12 scores
           (kmer-matches). Outputs are blocked (data row, colour shard).
kmer-conservation, --deduplicate and the no-dense threshold union need no
colour data: each cell runs the single-device step on its own block.

Every probe of the stream runs at the default budget (VERIFY_BUDGET,
SKEW_CAND), as fulgor_tpu's mesh steps do (its dict_probe_packed without
probe_budget); the engine's threshold-union and kmer-matches redo pools
run these steps at the redo budget, so that no device holds the whole
dense matrix (fulgor_tpu redoes against its colour-sharded matrix).

A grid may repeat a device: a grid of four cells on one card runs every
sharded step, kernel and output assembly there, as the reference's tests
run on virtual CPU devices; only the copy between two cards is left out.
The table and each colour shard are uploaded once per distinct device.

Outputs are Blocks: a global (B, ...) tensor held as blocks on the cells'
devices. Row-sharded outputs hold one row block per cell, colour outputs
one row block per data row cut into P colour blocks.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.intersect import compact_runs, fi_and, runs_mask, runs_scores
from ..ops.pipeline import (
    pack_unpacked,
    query_conservation_runs_packed,
    query_distinct_runs_packed,
    query_runs_tu_packed,
    query_window_csids_packed,
)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (data, color) grid of torch devices; cell (d, p) is
    devices[d * color + p]. Devices may repeat."""

    axis_names = ("data", "color")

    def __init__(self, devices, data: int, color: int):
        devs = [_device(d) for d in devices]
        if data < 1 or color < 1 or data * color != len(devs):
            raise ValueError(f"a ({data}, {color}) grid needs {data * color} "
                             f"devices, not {len(devs)}")
        self.devices = devs
        self.shape = {"data": data, "color": color}

    @property
    def size(self) -> int:
        return len(self.devices)

    def cell(self, d: int, p: int) -> torch.device:
        return self.devices[d * self.shape["color"] + p]

    def distinct(self) -> list:
        """The grid's devices, each once, in cell order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(devices=None, data: int | None = None,
              color: int | None = None) -> Mesh:
    """A grid over `devices` (default: one cell per visible CUDA card).
    Without both data and color, color = 2 when there are at least two
    cells and an even count, else 1, and data the rest (fulgor_tpu
    mesh.py:43-51)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible (pass "
                               "devices=[...] to grid other devices)")
        devices = [torch.device("cuda", i) for i in range(n)]
    n = len(devices)
    if data is None or color is None:
        color = 2 if n % 2 == 0 and n >= 2 else 1
        data = n // color
    return Mesh(list(devices)[: data * color], data, color)


def _on(dev: torch.device):
    """Kernel launches and allocations on `dev` (a ctypes launch goes to
    the calling thread's current card)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t on dev. Between two cards the copy waits on an event recorded on
    the source's current stream (the stream its producer launched on)."""
    if t.device == dev:
        return t
    if t.device.type == "cuda" and dev.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(dev).wait_event(ev)
        return t.to(dev, non_blocking=True)
    return t.to(dev)


def _cat(parts):
    return torch.cat(parts) if len(parts) > 1 else parts[0]


class Blocks:
    """A global tensor as blocks on the cells' devices: blocks[i][j] is row
    block i, column block j (one column block but for colour outputs)."""

    def __init__(self, blocks):
        self.blocks = [list(r) for r in blocks]

    @classmethod
    def by_rows(cls, tensors) -> "Blocks":
        return cls([[t] for t in tensors])

    def map(self, fn) -> "Blocks":
        return Blocks([[fn(t) for t in r] for r in self.blocks])

    def tensors(self) -> list:
        return [t for r in self.blocks for t in r]

    def numpy(self) -> np.ndarray:
        """The whole tensor as numpy, assembled on the host."""
        rows = [r[0].cpu().numpy() if len(r) == 1 else np.concatenate(
            [t.cpu().numpy() for t in r], axis=1) for r in self.blocks]
        return rows[0] if len(rows) == 1 else np.concatenate(rows)

    def take_rows(self, idx) -> np.ndarray:
        """Global rows idx of a row-sharded tensor, as numpy: each row
        block's share gathered on its device."""
        idx = np.asarray(idx, dtype=np.int64)
        starts = np.cumsum([0] + [r[0].shape[0] for r in self.blocks])
        which = np.searchsorted(starts, idx, side="right") - 1
        order = np.argsort(which, kind="stable")  # idx grouped by block
        parts = [r[0].index_select(0, torch.from_numpy(
            idx[which == i] - starts[i]).to(r[0].device)).cpu().numpy()
            for i, r in enumerate(self.blocks)]
        got = np.concatenate(parts)
        out = np.empty_like(got)
        out[order] = got
        return out


def pad_bits_for_mesh(dense_bits: np.ndarray, color_shards: int) -> np.ndarray:
    """(S, C32) -> (S, C32 padded with zero words to a multiple of P)."""
    _S, C32 = dense_bits.shape
    pad = (-C32) % color_shards
    if pad:
        dense_bits = np.pad(dense_bits, ((0, 0), (0, pad)))
    return dense_bits


def _tensor(a) -> torch.Tensor:
    """A numpy array (u32 as int32 bit patterns) or a tensor, on the CPU."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.writeable:  # memory-mapped from the index file
        a = a.copy()
    return torch.from_numpy(a)


def place_table(mesh: Mesh, table) -> dict:
    """The dictionary on every distinct device -> {device: table}: the
    mini (slots, text32, skew) triple or the cuckoo (nb, 4) table."""
    if isinstance(table, (tuple, list)):
        host = tuple(_tensor(a) for a in table)
        return {dev: tuple(t.to(dev) for t in host) for dev in mesh.distinct()}
    host = _tensor(table)
    return {dev: host.to(dev) for dev in mesh.distinct()}


def place_bits(mesh: Mesh, bits) -> list:
    """(S, C32) colour bits, C32 a multiple of P -> a list over colour
    shards p of {device: (S, C32 / P) int32}, shard p once on each distinct
    device of colour column p."""
    D, P = mesh.shape["data"], mesh.shape["color"]
    t = _tensor(bits)
    C32 = t.shape[1]
    if C32 % P:
        raise ValueError(f"{C32} colour words do not split into {P} shards "
                         "(pad_bits_for_mesh)")
    w = C32 // P
    shards = []
    for p in range(P):
        host = t[:, p * w: (p + 1) * w].contiguous()
        shards.append({dev: host.to(dev) for dev in
                       dict.fromkeys(mesh.cell(d, p) for d in range(D))})
    return shards


def place_replicated(mesh: Mesh, t) -> dict:
    """A small tensor on every distinct device -> {device: tensor}."""
    t = _tensor(t)
    return {dev: t.to(dev) for dev in mesh.distinct()}


def place_rows(mesh: Mesh, x) -> list:
    """(B, ...) with B a multiple of the cell count -> the cells' row
    blocks, each on its cell's device (through pinned memory to a card)."""
    t = _tensor(x)
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {n} cells")
    b = t.shape[0] // n
    out = []
    for c, dev in enumerate(mesh.devices):
        blk = t[c * b: (c + 1) * b]
        out.append(blk.pin_memory().to(dev, non_blocking=True)
                   if dev.type == "cuda" else blk.to(dev))
    return out


def place_packed(mesh: Mesh, codes2, bad):
    """Host-packed (codes2, bad) -> their cells' row blocks."""
    return place_rows(mesh, codes2), place_rows(mesh, bad)


def shard_inputs(mesh: Mesh, table, bits, codes):
    """(table, colour bits, (B, L) codes) placed as the unpacked steps take
    them."""
    return place_table(mesh, table), place_bits(mesh, bits), place_rows(
        mesh, codes)


# ---------------------------------------------------------------------------
# The three phases
# ---------------------------------------------------------------------------


def _per_cell(mesh: Mesh, fn) -> list:
    """[fn(c, device)] over the cells, each under its device."""
    out = []
    for c, dev in enumerate(mesh.devices):
        with _on(dev):
            out.append(fn(c, dev))
    return out


def _probe_runs(mesh, table, codes2, bad, k, width, R, dparams,
                probe_budget=None, hit_words=False):
    """Phase 1 on every cell -> [(hit, run_csid, run_len, npos, ovf)]: ovf =
    more than R runs or any probe overflow of the read; with hit_words each
    tuple also ends with the cell's hit words, from K6's launch."""
    def cell(c, dev):
        hit, csid, dovf = query_window_csids_packed(
            table[dev], codes2[c], bad[c], k=k, width=width, dparams=dparams,
            probe_budget=probe_budget)
        rc, _start, rl, total, npos, *hitw = compact_runs(hit, csid, R,
                                                          hit_words)
        return (hit, rc, rl, npos, (total > R) | dovf.any(dim=1), *hitw)

    return _per_cell(mesh, cell)


def _colour_stage(mesh: Mesh, per_cell, fn) -> Blocks:
    """Phases 2 and 3: cell (d, q) gathers the tuples per_cell of cells
    (d, 0..P-1), in cell order, then block [d][q] = fn(q, device,
    *gathered)."""
    D, P = mesh.shape["data"], mesh.shape["color"]
    rows = []
    for d in range(D):
        parts = per_cell[d * P: (d + 1) * P]
        row = []
        for q in range(P):
            dev = mesh.cell(d, q)
            with _on(dev):
                gathered = [_cat([_to(x[i], dev) for x in parts])
                            for i in range(len(parts[0]))]
                row.append(fn(q, dev, *gathered))
        rows.append(row)
    return Blocks(rows)


def _shard_colours(num_colors: int, q: int, words: int) -> int:
    """Colours below num_colors in colour shard q of `words` words."""
    return max(0, min(32 * words, num_colors - 32 * words * q))


def _check_padded(mesh: Mesh, num_colors_padded: int):
    if num_colors_padded % (32 * mesh.shape["color"]):
        raise ValueError(f"{num_colors_padded} colours do not split into "
                         f"{mesh.shape['color']} shards of whole words")


# ---------------------------------------------------------------------------
# Colour steps: full intersection, threshold union, kmer-matches
# ---------------------------------------------------------------------------


def make_sharded_full_intersection_packed(mesh: Mesh, k: int, width: int,
                                          max_runs: int, dparams=None):
    """-> fn(table, bits, codes2, bad) -> (out (B, C32) int32 Blocks by
    (data row, colour shard), mapped (B,) bool, ovf (B,) bool) (fulgor_tpu
    mesh.py:128): each cell's runs at max_runs, then K3 over the gathered
    runs (hit = run_csid != INVALID) on each colour shard."""

    def step(table, bits, codes2, bad):
        cells = _probe_runs(mesh, table, codes2, bad, k, width, max_runs,
                            dparams)
        out = _colour_stage(mesh, [(c[1],) for c in cells],
                            lambda q, dev, rc: fi_and(bits[q][dev], rc != -1,
                                                      rc))
        return (out, Blocks.by_rows(c[0].any(dim=1) for c in cells),
                Blocks.by_rows(c[4] for c in cells))

    return step


def make_sharded_threshold_union_packed(mesh: Mesh, k: int, width: int,
                                        num_colors_padded: int, max_runs: int,
                                        dparams=None, *, num_colors: int,
                                        probe_budget=None):
    """-> fn(table, bits, codes2, bad, minscore) -> (mask (B, C32) int32
    Blocks by (data row, colour shard), npos (B,) int32, ovf (B,) bool)
    (fulgor_tpu mesh.py:154): each cell's (csid, count) runs and npos at
    max_runs, gathered, then K12's mask on each colour shard: colour c <
    num_colors is set iff npos > 0 and its run-weighted score reaches
    minscore[npos]. fulgor_tpu returns the f32 scores and the engine
    thresholds them on the host; the mask is the same. minscore: {device:
    (n,) int32} (place_replicated). probe_budget: the engine's redo budget
    (default: the default budget, as fulgor_tpu's mesh steps probe)."""
    _check_padded(mesh, num_colors_padded)

    def step(table, bits, codes2, bad, minscore):
        cells = _probe_runs(mesh, table, codes2, bad, k, width, max_runs,
                            dparams, probe_budget)

        def score(q, dev, rc, rl, npos):
            shard = bits[q][dev]
            return runs_mask(shard, rc, rl, npos, minscore[dev],
                             _shard_colours(num_colors, q, shard.shape[1]))

        mask = _colour_stage(mesh, [(c[1], c[2], c[3]) for c in cells], score)
        return (mask, Blocks.by_rows(c[3] for c in cells),
                Blocks.by_rows(c[4] for c in cells))

    return step


def make_sharded_kmer_matches(mesh: Mesh, k: int, width: int,
                              num_colors_padded: int, max_runs: int,
                              dparams=None, probe_budget=None):
    """-> fn(table, bits, codes2, bad) -> (hitw (B, ceil(Wk/32)) int32, scores
    (B, num_colors_padded) int16 bit patterns of u16 Blocks by (data row,
    colour shard), ovf (B,) bool) (fulgor_tpu mesh.py:263): each cell's
    hit words come from the K6 launch that builds its runs, as fulgor_tpu
    packs them in the step that builds its runs; K12 scores the gathered
    runs on each shard. probe_budget as in
    make_sharded_threshold_union_packed."""
    _check_padded(mesh, num_colors_padded)

    def step(table, bits, codes2, bad):
        cells = _probe_runs(mesh, table, codes2, bad, k, width, max_runs,
                            dparams, probe_budget, hit_words=True)

        def score(q, dev, rc, rl):
            shard = bits[q][dev]
            return runs_scores(shard, rc, rl, 32 * shard.shape[1])

        scores = _colour_stage(mesh, [(c[1], c[2]) for c in cells], score)
        return (Blocks.by_rows(c[5] for c in cells), scores,
                Blocks.by_rows(c[4] for c in cells))

    return step


def _pack_cells(mesh: Mesh, codes):
    """Each cell's (b, L) uint8 codes packed on its device by K8 ->
    (codes2 blocks, bad blocks, padded width)."""
    packed = _per_cell(mesh, lambda c, dev: pack_unpacked(codes[c]))
    return [p[0] for p in packed], [p[1] for p in packed], packed[0][2]


def make_sharded_full_intersection(mesh: Mesh, k: int, max_runs: int = 64,
                                   dparams=None):
    """-> fn(table, bits, codes) over (B, L) uint8 codes placed by
    shard_inputs (fulgor_tpu mesh.py:62): K8 on each cell, then the packed
    step."""
    steps: dict = {}

    def step(table, bits, codes):
        codes2, bad, W = _pack_cells(mesh, codes)
        if W not in steps:
            steps[W] = make_sharded_full_intersection_packed(
                mesh, k, W, max_runs, dparams)
        return steps[W](table, bits, codes2, bad)

    return step


def make_sharded_threshold_union(mesh: Mesh, k: int, num_colors_padded: int,
                                 max_runs: int = 64, dparams=None, *,
                                 num_colors: int):
    """-> fn(table, bits, codes, minscore) over (B, L) uint8 codes
    (fulgor_tpu mesh.py:89): K8 on each cell, then the packed step."""
    steps: dict = {}

    def step(table, bits, codes, minscore):
        codes2, bad, W = _pack_cells(mesh, codes)
        if W not in steps:
            steps[W] = make_sharded_threshold_union_packed(
                mesh, k, W, num_colors_padded, max_runs, dparams,
                num_colors=num_colors)
        return steps[W](table, bits, codes2, bad, minscore)

    return step


# ---------------------------------------------------------------------------
# Data-parallel steps: kmer-conservation, --deduplicate and the no-dense
# threshold union need no colour data, so each cell runs the single-device
# step on its own block and nothing is gathered.
# ---------------------------------------------------------------------------


def _data_parallel(mesh: Mesh, step, table, codes2, bad, **kw):
    outs = _per_cell(mesh, lambda c, dev: step(table[dev], codes2[c], bad[c],
                                               **kw))
    return tuple(Blocks.by_rows(col) for col in zip(*outs))


def make_sharded_conservation_runs(mesh: Mesh, k: int, width: int, R: int,
                                   dparams=None):
    """-> fn(table, codes2, bad) -> query_conservation_runs_packed's four
    outputs as Blocks (fulgor_tpu mesh.py:200)."""
    def step(table, codes2, bad):
        return _data_parallel(mesh, query_conservation_runs_packed, table,
                              codes2, bad, k=k, width=width, R=R,
                              dparams=dparams)

    return step


def make_sharded_distinct_runs(mesh: Mesh, k: int, width: int, R: int,
                               dparams=None):
    """-> fn(table, codes2, bad) -> query_distinct_runs_packed's four
    outputs as Blocks, the per-window csids left on the cells (fulgor_tpu
    mesh.py:219)."""
    def step(table, codes2, bad):
        return _data_parallel(mesh, query_distinct_runs_packed, table, codes2,
                              bad, k=k, width=width, R=R, dparams=dparams)

    return step


def make_sharded_runs_tu(mesh: Mesh, k: int, width: int, R: int,
                         dparams=None):
    """-> fn(table, codes2, bad) -> query_runs_tu_packed's four outputs as
    Blocks: no colour data on any device (fulgor_tpu mesh.py:240)."""
    def step(table, codes2, bad):
        return _data_parallel(mesh, query_runs_tu_packed, table, codes2, bad,
                              k=k, width=width, R=R, dparams=dparams)

    return step
