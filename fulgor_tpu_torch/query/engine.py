"""Host query orchestration for full-intersection (FI) pseudoalignment on
the card (counterpart of fulgor_tpu/query/engine.py, FI only).

    native chunked FASTA/FASTQ parse  ->  2-bit pack -> pinned upload ->
    (prefetch thread)                     K1 window prep -> K2 probe ->
                                          K3 AND, async on the card
    ->  device->host copies on a side stream into pinned buffers
    ->  native ascii formatting on a writer thread

with at most two batches in flight while the host consumes a third. Batch
widths come from the same ladder and lane budget as fulgor_tpu's engine.

Reads the device cannot decide exactly — probe overflow (ovf) or longer
than the widest rung — are deferred: every REDO_FLUSH of them take
one device re-probe at the redo budget REDO_BUDGET = (8, 4); reads still
in overflow after it, and over-long reads, take the exact host mirror. The
redo pools are written in read-id order (fulgor_tpu's final flush writes
its last pool before the earlier in-flight ones; this engine does not).
So output is in read-id order except for these stragglers, which trail.

Strategies of fulgor_tpu's engine not taken here yet: threshold union,
lists fetch and runs fetch (where fulgor_tpu would take either, this engine
runs dense FI: the same AND, identical output), --deduplicate, the mesh
and multi-host sharding.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from ..constants import INVALID_U32
from ..index import Index
from ..ops.hostpack import pack_reads_host
from ..ops.pipeline import (
    query_full_intersection_packed,
    query_window_csids_packed,
)
from .formatters import make_formatter


class AsyncWriter:
    """Runs formatter writes on a worker thread so ascii formatting + file
    IO (ctypes releases the GIL during the native calls) overlap device
    compute and the next batch's result fetch. FIFO queue preserves output
    order; `mapped` and `busy_sec` are valid after close()."""

    def __init__(self, fmtr):
        import queue
        import threading

        self.fmtr = fmtr
        self.has_bits = hasattr(fmtr, "write_batch_bits")
        self.q = queue.Queue(maxsize=4)
        self.mapped = 0
        self.busy_sec = 0.0
        self.err = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            try:
                t0 = time.perf_counter()
                kind, a, b = item
                if kind == "bits":
                    self.mapped += self.fmtr.write_batch_bits(a, b)
                else:
                    self.fmtr.write_batch(a, b)
                    self.mapped += sum(1 for s in b if len(s))
                self.busy_sec += time.perf_counter() - t0
            except BaseException as e:  # surfaced on next write or close
                self.err = e

    def _put(self, item):
        if self.err is not None:
            raise self.err
        self.q.put(item)

    def write_batch_bits(self, ids, rows):
        self._put(("bits", ids, rows))

    def write_batch(self, ids, lists):
        self._put(("lists", list(ids), list(lists)))

    def close(self):
        self.q.put(None)
        self.t.join()
        if self.err is not None:
            raise self.err
        self.fmtr.close()


WIDTH_LADDER = (64, 96, 128, 160, 192, 256, 384, 512, 768, 1024)
MAX_STREAM_WIDTH = WIDTH_LADDER[-1]
# Probe-lane budget per dispatch, B_eff * (W - k + 1) <= MAX_LANES: wide
# ladder rungs dispatch in smaller sub-batches (fulgor_tpu's value; the
# card's own limit is re-measured in a later slice).
MAX_LANES = 6_000_000
# Deferred reads are resolved this many at a time.
REDO_FLUSH = 8192
# Probe budget (VERIFY_BUDGET, SKEW_CAND) of the deferred device redo.
REDO_BUDGET = (8, 4)


def resolve_device(device=None) -> torch.device:
    """The engine's device: "cuda" unless the caller asks otherwise. Raises
    when the card is asked for and absent — never a quiet CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; fulgor_tpu_torch runs on the card "
            "(pass device='cpu' to run the plain PyTorch versions)")
    return dev


class _Fetch:
    """Results of one dispatch on their way to the host: on the card they
    are copied into pinned buffers on a side stream that waits for the
    compute, so the copy overlaps the next batch; `numpy()` waits for the
    copy only."""

    def __init__(self, tensors, stream):
        self.event = None
        if stream is None:  # CPU: already on the host
            self.host = list(tensors)
            return
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in tensors]
            self.event = torch.cuda.Event()
            self.event.record(stream)
        for t in tensors:
            t.record_stream(stream)

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class QueryEngine:
    """FI pseudoalignment of read files against an Index on one device."""

    def __init__(self, index: Index, batch_size: int = 32768, device=None):
        self.device = resolve_device(device)
        if index.dict_kind != "mini":
            raise NotImplementedError(
                "fulgor_tpu_torch queries the mini dictionary only; rebuild "
                "the index with the default --dict mini")
        self.idx = index
        self.k = index.k
        self._cs_cache = index.color_sets_decoded()
        _, self.dparams = index.device_dict()
        tabs = index.device_tables(self.device)
        self.table = (tabs["slots"], tabs["text32"], tabs["skew"])
        self.bits = tabs["dense"]
        self.batch = batch_size
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # probe budgets (VERIFY_BUDGET, SKEW_CAND) by the covered-entry
        # fraction of the slot array, exactly as fulgor_tpu's engine
        # (engine.py:303-341): <0.10 skew-light (2, 2); 0.10-0.45 mid
        # (4, 4); >=0.45 skew-heavy (3, 3); FULGOR_PROBE_BUDGET=vb,sc
        # overrides. Overflow reads re-probe at REDO_BUDGET.
        ms = index.mini_slots[:, 2::3]
        covb = ((ms >> np.uint32(15)) & np.uint32(1)) == 1
        occ = int(((((ms >> np.uint32(8)) & np.uint32(0x7F)) > 0)
                   | covb).sum())
        self._covered_frac = int(covb.sum()) / max(1, occ)
        pb_env = os.environ.get("FULGOR_PROBE_BUDGET")
        if pb_env:
            self._pb = tuple(int(x) for x in pb_env.split(","))
            if len(self._pb) != 2:
                raise ValueError("FULGOR_PROBE_BUDGET takes vb,sc (the staged "
                                 "probe is not part of fulgor_tpu_torch)")
        else:
            self._pb = ((2, 2) if self._covered_frac < 0.10
                        else (4, 4) if self._covered_frac < 0.45
                        else (3, 3))
        self._pb_redo = REDO_BUDGET
        # FULGOR_SELFCHECK=N: reads whose global id is divisible by N
        # recompute through the exact host mirror and must match the device
        # result. 0/unset disables.
        self._selfcheck = int(os.environ.get("FULGOR_SELFCHECK", "0"))

    # ---------------------------------------------------------------- device IO

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fetch(self, *tensors) -> _Fetch:
        return _Fetch(tensors, self._copy_stream)

    # ---------------------------------------------------------------- helpers

    def _width_for(self, maxlen: int) -> int:
        need = max(int(maxlen), self.k + 1)
        for w in WIDTH_LADDER:
            if w >= need:
                return w
        return MAX_STREAM_WIDTH

    def _batch_for_width(self, W: int) -> int:
        """Largest dispatch batch whose lane count B*(W-k+1) fits MAX_LANES,
        rounded down to a multiple of 256."""
        Wk = max(1, W - self.k + 1)
        b = min(self.batch, (MAX_LANES // Wk) & ~255)
        return max(256, b)

    def _host_csids(self, row_codes: np.ndarray):
        """Exact host window->csid for one code array (slow path)."""
        _hit, csid = self.idx.host_window_csids(row_codes.astype(np.uint8))
        return csid

    def _host_csids_many(self, rows) -> list:
        """Exact host window->csids for many ragged reads in one vectorized
        probe: reads joined by one invalid code, so boundary-crossing
        windows self-invalidate, then sliced back per read."""
        if not len(rows):
            return []
        k = self.k
        parts, starts, pos = [], [], 0
        sep = np.full(1, 4, dtype=np.uint8)
        for r in rows:
            starts.append(pos)
            parts.append(np.asarray(r, dtype=np.uint8))
            parts.append(sep)
            pos += len(r) + 1
        csid = self._host_csids(np.concatenate(parts))
        return [csid[s: s + max(0, len(r) - k + 1)]
                for r, s in zip(rows, starts)]

    def _device_csids_dispatch(self, rows) -> list:
        """Launch the device per-window probe at the redo budget for the
        rows within the stream ladder; resolution waits in
        _device_csids_resolve."""
        state = []
        fit = [i for i, r in enumerate(rows) if len(r) <= MAX_STREAM_WIDTH]
        B = min(self.batch, max(256, 1 << (max(1, len(fit)) - 1).bit_length()))
        for i0 in range(0, len(fit), B):
            sel = fit[i0: i0 + B]
            W = self._width_for(max(len(rows[i]) for i in sel))
            chunk = np.full((B, W), 4, dtype=np.uint8)
            for j, i in enumerate(sel):
                chunk[j, : len(rows[i])] = rows[i]
            codes2, bad = pack_reads_host(chunk)
            out = query_window_csids_packed(
                self.table, self._upload(codes2), self._upload(bad),
                k=self.k, width=W, dparams=self.dparams,
                probe_budget=self._pb_redo)
            state.append((sel, self._fetch(*out)))
        return state

    def _device_csids_resolve(self, rows, state) -> list:
        """Collect a _device_csids_dispatch state: per-window csids, or None
        for reads the device cannot decide (probe overflow, too long)."""
        out: list = [None] * len(rows)
        for sel, handle in state:
            hit, csid, ovf = handle.numpy()
            vals = np.where(hit, csid.view(np.uint32), np.uint32(INVALID_U32))
            for j, i in enumerate(sel):
                if not ovf[j].any():
                    out[i] = vals[j, : max(0, len(rows[i]) - self.k + 1)]
        return out

    def _fi_from_csids(self, csids: np.ndarray) -> np.ndarray:
        cat, offs = self._cs_cache
        distinct = np.unique(csids[csids != INVALID_U32])
        if len(distinct) == 0:
            return np.empty(0, dtype=np.uint32)
        acc = None
        for sid in distinct:
            s = cat[offs[sid]: offs[sid + 1]]
            acc = s if acc is None else np.intersect1d(acc, s, assume_unique=True)
            if len(acc) == 0:
                break
        return acc.astype(np.uint32)

    def _fi_lists_from_csids_many(self, csids_list: list) -> list:
        """Exact FI colour lists for many reads from their window csids
        (INVALID = negative window): one native segmented AND over the
        dense rows of each read's distinct csids."""
        from ..native import lib as native

        keys = [np.unique(c[c != INVALID_U32]).astype(np.int64)
                for c in map(np.asarray, csids_list)]
        sizes = np.fromiter((len(u) for u in keys), dtype=np.int64,
                            count=len(keys))
        starts = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum(sizes, out=starts[1:])
        flat = np.concatenate(keys) if starts[-1] else np.empty(0, np.int64)
        rows = native.and_reduce_rows(self.idx.dense_color_bits(), flat, starts)
        return self._bits_to_lists(rows, self.idx.num_colors)[0]

    def _host_full_intersection(self, row_codes: np.ndarray) -> np.ndarray:
        return self._fi_from_csids(self._host_csids(row_codes))

    def _selfcheck_batch(self, qid0, chunk, lens, n, get_colors, skip=()):
        """FULGOR_SELFCHECK: sampled reads' colour lists must equal the
        exact host mirror's. skip: rows deferred to the redo (which IS the
        host mirror or the full-budget probe)."""
        period = self._selfcheck
        if not period:
            return
        for j in range((-qid0) % period, n, period):
            if lens[j] > MAX_STREAM_WIDTH or j in skip:
                continue
            want = self._host_full_intersection(chunk[j, : lens[j]])
            got = np.asarray(get_colors(j), dtype=np.uint32)
            if not np.array_equal(got, np.asarray(want, dtype=np.uint32)):
                raise RuntimeError(
                    f"FULGOR_SELFCHECK: read {qid0 + j} device result "
                    f"({len(got)} colors) != host mirror ({len(want)})")

    @staticmethod
    def _bits_to_lists(bits_np: np.ndarray, num_colors: int):
        bits_np = np.ascontiguousarray(bits_np)
        bm = np.unpackbits(bits_np.view(np.uint8), axis=1, bitorder="little")[
            :, :num_colors].astype(bool)
        counts = bm.sum(axis=1)
        _rows, cols = np.nonzero(bm)
        return np.split(cols.astype(np.uint32), np.cumsum(counts))[:-1], counts

    # ---------------------------------------------------------------- streaming

    def _stream(self, query_path: str, dispatch, consume):
        """Parse chunk -> dispatch(chunk) -> handle (<= 2 in flight) ->
        consume(qid0, n, lens, handle, chunk). Parsing runs on a prefetch
        thread (the native parser releases the GIL).
        -> (num_reads_total, parse_sec)."""
        import queue
        import threading

        from ..native.lib import ReadsStream

        stream = ReadsStream(query_path, self.batch, row_len=MAX_STREAM_WIDTH)
        q: queue.Queue = queue.Queue(maxsize=2)
        parse_sec = [0.0]

        def producer():
            try:
                t = time.perf_counter()
                base = 0
                for codes, lens, _names in stream:
                    parse_sec[0] += time.perf_counter() - t
                    # copy out of the stream's reused buffers
                    q.put((codes.copy(), lens, base))
                    base += len(lens)
                    t = time.perf_counter()
                parse_sec[0] += time.perf_counter() - t
                q.put(("total", base))
            except BaseException as e:  # surface parse failures
                q.put(e)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        total = 0
        inflight: deque = deque()
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                th.join()
                raise item
            if isinstance(item[0], str):  # ("total", num_reads)
                total = item[1]
                break
            codes, lens, base = item
            n = len(lens)
            W = self._width_for(min(int(lens.max()) if n else 0,
                                    MAX_STREAM_WIDTH))
            # one long read widens the whole chunk (its row rides along
            # truncated; its answer comes from the host path): sub-batch so
            # B_eff * (W - k + 1) stays within the lane budget
            B_eff = self._batch_for_width(W)
            for lo in range(0, max(n, 1), B_eff):
                n_sub = min(B_eff, n - lo) if n else 0
                chunk = np.full((B_eff, W), 4, dtype=np.uint8)
                chunk[:n_sub] = codes[lo:lo + n_sub, :W]
                inflight.append((base + lo, n_sub, lens[lo:lo + n_sub],
                                 dispatch(chunk), chunk))
                if len(inflight) > 2:
                    consume(*inflight.popleft())
        th.join()
        while inflight:
            consume(*inflight.popleft())
        return total, parse_sec[0]

    def pseudoalign_file(self, query_path: str, out_path: str, threshold=None,
                         fmt: str = "ascii", verbose: bool = False):
        """FI pseudoalignment of a FASTA/FASTQ(.gz) file -> stats dict
        (num_reads, num_mapped, parse/query/redo/write seconds, num_redo and
        the redone read ids)."""
        if threshold is not None:
            raise NotImplementedError(
                "threshold union is not part of fulgor_tpu_torch yet")
        C = self.idx.num_colors
        t0 = time.perf_counter()
        fmtr = AsyncWriter(make_formatter(fmt, out_path, C))
        num_reads = 0
        query_sec = 0.0
        redo_ids: list = []  # reads written through the redo path
        redo_sec = 0.0

        def dispatch(chunk):
            codes2, bad = pack_reads_host(chunk)
            bits, ovf = query_full_intersection_packed(
                self.table, self.bits, self._upload(codes2),
                self._upload(bad), k=self.k, width=chunk.shape[1],
                dparams=self.dparams, probe_budget=self._pb)
            return self._fetch(bits, ovf)

        # Deferred redo: overflow and over-long reads wait here as (read id,
        # codes | None = re-parse) and are resolved REDO_FLUSH at a time. A
        # flush launches the device re-probe and the pool is written one
        # flush later (or at the end), pools strictly in order.
        deferred: list = []
        pending_redo: deque = deque()  # (ids, rows, device state | None)

        def defer_reads(qid0, chunk, lens, js):
            for j in js:
                j = int(j)
                deferred.append((qid0 + j, None if lens[j] > MAX_STREAM_WIDTH
                                 else chunk[j, : lens[j]].copy()))
            return {int(j) for j in js}

        def flush_deferred(final=False):
            nonlocal redo_sec
            tr = time.perf_counter()
            if deferred and (final or len(deferred) >= REDO_FLUSH):
                from ..native import lib as native

                long_pos = [i for i, (_, r) in enumerate(deferred) if r is None]
                if long_pos:
                    seqs, _nm = native.parse_reads_select(
                        query_path, [deferred[i][0] for i in long_pos])
                    for i, s in zip(long_pos, seqs):
                        deferred[i] = (deferred[i][0],
                                       np.asarray(s, dtype=np.uint8))
                ids = [q for q, _ in deferred]
                rows = [r for _, r in deferred]
                deferred.clear()
                pending_redo.append(
                    (ids, rows, self._device_csids_dispatch(rows)))
            while pending_redo and (final or len(pending_redo) >= 2):
                ids, rows, state = pending_redo.popleft()
                csids = self._device_csids_resolve(rows, state)
                left = [i for i, c in enumerate(csids) if c is None]
                for i, c in zip(left, self._host_csids_many(
                        [rows[i] for i in left])):
                    csids[i] = c
                fmtr.write_batch(ids, self._fi_lists_from_csids_many(csids))
                redo_ids.extend(ids)
            redo_sec += time.perf_counter() - tr

        def consume(qid0, n, lens, handle, chunk):
            nonlocal num_reads, query_sec
            tq = time.perf_counter()
            bits, ovf = handle.numpy()
            fetched = bits[:n].view(np.uint32)
            ovf = ovf[:n]
            query_sec += time.perf_counter() - tq
            keep = (lens <= MAX_STREAM_WIDTH) & ~ovf
            dropped = defer_reads(qid0, chunk, lens, np.flatnonzero(~keep))
            wr = np.flatnonzero(keep)
            num_reads += n
            if fmtr.has_bits:
                # native bits -> ascii straight from the device's layout
                self._selfcheck_batch(
                    qid0, chunk, lens, n,
                    lambda j: self._bits_to_lists(fetched[j: j + 1], C)[0][0],
                    skip=dropped)
                fmtr.write_batch_bits(qid0 + wr.astype(np.uint32), fetched[wr])
            else:
                lists, _counts = self._bits_to_lists(fetched, C)
                self._selfcheck_batch(qid0, chunk, lens, n, lambda j: lists[j],
                                      skip=dropped)
                fmtr.write_batch([qid0 + int(j) for j in wr],
                                 [lists[j] for j in wr])
            flush_deferred()

        total, parse_sec = self._stream(query_path, dispatch, consume)
        flush_deferred(final=True)
        fmtr.close()
        elapsed = time.perf_counter() - t0
        # per-stage busy times; the stages overlap (parse on a prefetch
        # thread, the card async, formatting on the writer thread)
        stats = dict(num_reads=num_reads, num_reads_total=total,
                     num_mapped=fmtr.mapped, parse_sec=parse_sec,
                     query_sec=query_sec, write_sec=fmtr.busy_sec,
                     num_redo=len(redo_ids), redo_ids=redo_ids,
                     redo_sec=redo_sec, elapsed=elapsed)
        if verbose:
            self._print_stats(stats)
        return stats

    @staticmethod
    def _print_stats(stats):
        n = max(1, stats["num_reads"])
        elapsed = stats["elapsed"]
        print(f"mapped {stats['num_reads']} reads")
        print(f"elapsed = {elapsed * 1e3:.0f} millisec / {elapsed:.3f} sec / "
              f"{elapsed / 60:.5f} min / {elapsed * 1e6 / n:.4f} musec/read")
        print(f"num_mapped_reads {stats['num_mapped']}/{stats['num_reads']} "
              f"({100.0 * stats['num_mapped'] / n:.3f}%)")
        print(f"stage busy: parse {stats['parse_sec']:.3f}s "
              f"query {stats['query_sec']:.3f}s "
              f"redo {stats['redo_sec']:.3f}s ({stats['num_redo']} reads) "
              f"write {stats['write_sec']:.3f}s")
