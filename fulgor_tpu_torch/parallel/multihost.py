"""Multi-host scale-out of pseudoalign (fulgor_tpu parallel/multihost.py).

Reads are data-parallel across processes: each process queries only the
chunks with index % num_procs == proc_id of the shared FASTA/FASTQ
(engine._stream(shard=...)) on its own engine and its own card, and writes
`{out}.part{proc_id}` (and its `.redo` side fragment). Read ids stay the
reads' ordinals in the whole file, so process 0 merges the fragments by id
into the single-process output. A process that names no card (--device)
takes, where it shares its host with others, card local rank % cards
(local_rank, process_device); alone on its host, the engine's default.

The only traffic between processes is the bring-up of a torch.distributed
process group (gloo backend, init_method tcp://<coordinator>), a gather of
every process's host name where no --device is named (local_rank), one
barrier when the fragments are complete and one when the merge is; the
merge goes through the filesystem. The gather is a collective, so the
processes must agree: every one names --device or none does, else those
that gather hang. Every process parses the whole (usually gzip) stream but
dispatches only its own chunks: skipping the others' chunks skips all card
work, host reduction and formatting, which is where the time goes.
"""

from __future__ import annotations

import heapq
import os

import numpy as np


# --------------------------------------------------------------- bring-up


def init_multihost(coordinator: str | None = None,
                   num_procs: int | None = None,
                   proc_id: int | None = None):
    """Join the process group of `num_procs` processes, from the arguments
    or the environment: FULGOR_COORDINATOR (host:port, where process 0
    listens), FULGOR_NUM_PROCS, FULGOR_PROC_ID. -> (proc_id, num_procs).
    With num_procs <= 1 (or nothing configured) this does nothing and the
    query tools behave exactly as without it; past that, a failed bring-up
    raises."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("FULGOR_COORDINATOR")
    if num_procs is None:
        num_procs = int(os.environ.get("FULGOR_NUM_PROCS", "1"))
    if proc_id is None:
        proc_id = int(os.environ.get("FULGOR_PROC_ID", "0"))
    if num_procs <= 1:
        return 0, 1
    if not coordinator:
        raise ValueError("multihost needs a coordinator address "
                         "(FULGOR_COORDINATOR=host:port)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_procs, rank=proc_id)
    return proc_id, num_procs


def host_rank(hostnames: list, rank: int) -> tuple:
    """(local rank, processes on its host) of process `rank` of a group
    whose processes run on `hostnames` (one entry a process, in rank
    order): its local rank counts the lower ranks on the same host."""
    me = hostnames[rank]
    return (sum(1 for h in hostnames[:rank] if h == me),
            sum(1 for h in hostnames if h == me))


def local_rank() -> tuple:
    """(local rank, processes on this host) of this process, from every
    process's host name (one gloo all_gather_object); (0, 1) outside a
    process group."""
    import socket

    import torch.distributed as dist

    if _group_size() <= 1:
        return 0, 1
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return host_rank(names, dist.get_rank())


def process_device(local: int, on_host: int, device_count: int):
    """The card of a process that names none: None, the engine's default (a
    mesh over every card of the host, as fulgor_tpu meshes a process's own
    devices), where the process is alone on its host or no card is
    visible; else cuda:(local % device_count), one card a process where
    there are as many cards as processes."""
    if on_host <= 1 or device_count < 1:
        return None
    return f"cuda:{local % device_count}"


def _group_size() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def barrier():
    """Barrier of every process of the group (no-op in one process)."""
    import torch.distributed as dist

    if _group_size() > 1:
        dist.barrier()


def shutdown_multihost():
    """Leave the process group, where one was joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------------- merge


# Every fragment stream below is id-ascending by construction: a sharded
# pseudoalign_file writes its batches in file order and sends the redone
# reads to a `.redo` side fragment, whose pools are written in dispatch
# order. The merge is thus a k-way heap merge over sequential readers:
# memory O(number of fragments), never O(file).


def _checked_ascending(it, path: str):
    last = -1
    for qid, payload in it:
        if qid < last:
            raise ValueError(
                f"{path}: fragment records not id-ascending ({qid} after "
                f"{last}); was it written by a pre-streaming-merge build?")
        last = qid
        yield qid, payload


def _iter_ascii_records(path: str):
    """Yield (qid, line_bytes) from an ascii psa fragment, sequentially."""
    with open(path, "rb") as f:
        for ln in f:
            if ln.strip():
                yield int(ln.split(b"\t", 1)[0]), ln


def merge_psa_ascii(parts: list[str], out_path: str):
    streams = [_checked_ascending(_iter_ascii_records(p), p) for p in parts]
    with open(out_path, "wb", buffering=1 << 20) as f:
        for _qid, line in heapq.merge(*streams, key=lambda r: r[0]):
            f.write(line)


def _iter_binary_records(path: str):
    """Yield (qid, record_bytes) from a binary psa fragment (u32 qid,
    u32 n, u32 colors[n] little-endian), sequentially."""
    with open(path, "rb", buffering=1 << 20) as f:
        while True:
            head = f.read(8)
            if not head:
                return
            if len(head) != 8:
                raise ValueError(f"{path}: truncated record header")
            qid, n = np.frombuffer(head, dtype=np.uint32)
            body = f.read(4 * int(n))
            if len(body) != 4 * int(n):
                raise ValueError(f"{path}: truncated record body")
            yield int(qid), head + body


def merge_psa_binary(parts: list[str], out_path: str):
    streams = [_checked_ascending(_iter_binary_records(p), p) for p in parts]
    with open(out_path, "wb", buffering=1 << 20) as f:
        for _qid, rec in heapq.merge(*streams, key=lambda r: r[0]):
            f.write(rec)


def merge_psa_compressed(parts: list[str], out_path: str):
    """Stream-decode fragments frame-at-a-time, re-encode id-ordered. The
    compressed stream groups records into flush frames
    (query/formatters.py), so a merged file must re-frame; output is a
    valid CompressedFormatter file with identical decoded content."""
    from ..query.formatters import (CompressedFormatter,
                                    compressed_psa_num_colors,
                                    iter_compressed_psa)

    ncs = [compressed_psa_num_colors(p) for p in parts]
    num_colors = ncs[0] if ncs else 0
    if any(nc != num_colors for nc in ncs):
        raise ValueError("fragment num_colors mismatch")
    streams = [
        _checked_ascending(iter_compressed_psa(p, num_colors), p)
        for p in parts
    ]
    fmtr = CompressedFormatter(out_path, int(num_colors))
    STEP = 1 << 15
    qids, lists = [], []
    for qid, cols in heapq.merge(*streams, key=lambda r: r[0]):
        qids.append(qid)
        lists.append(cols)
        if len(qids) >= STEP:
            fmtr.write_batch(qids, lists)
            qids, lists = [], []
    if qids:
        fmtr.write_batch(qids, lists)
    fmtr.close()


_MERGERS = {
    "ascii": merge_psa_ascii,
    "binary": merge_psa_binary,
    "compressed": merge_psa_compressed,
}


def merge_fragments(parts: list[str], out_path: str, fmt: str) -> list[str]:
    """Merge main fragments plus their `.redo` side fragments into
    out_path; -> the fragment files consumed (for cleanup)."""
    full = []
    for p in parts:
        full.append(p)
        if os.path.exists(p + ".redo"):
            full.append(p + ".redo")
    full = [p for p in full if os.path.exists(p)]
    _MERGERS[fmt](full, out_path)
    return full


# ---------------------------------------------------------------- driver


def pseudoalign_multihost(
    engine,
    query_path: str,
    out_path: str,
    threshold=None,
    fmt: str = "ascii",
    verbose: bool = False,
    proc_id: int | None = None,
    num_procs: int | None = None,
):
    """Pseudoalign sharded over the processes of the group (init_multihost;
    proc_id and num_procs from torch.distributed where not given).

    Each process writes `{out_path}.part{proc_id}`; after a barrier,
    process 0 merges the fragments by read id into `out_path` and removes
    them. In one process this is engine.pseudoalign_file. -> this
    process's stats dict (num_reads: the reads this process mapped;
    num_reads_total: the whole file's)."""
    import torch.distributed as dist

    if num_procs is None:
        num_procs = _group_size()
    if proc_id is None:
        proc_id = dist.get_rank() if _group_size() > 1 else 0
    if num_procs <= 1:
        return engine.pseudoalign_file(query_path, out_path,
                                       threshold=threshold, fmt=fmt,
                                       verbose=verbose)
    part = f"{out_path}.part{proc_id}"
    stats = engine.pseudoalign_file(query_path, part, threshold=threshold,
                                    fmt=fmt, verbose=verbose,
                                    shard=(proc_id, num_procs))
    barrier()  # every fragment is complete
    if proc_id == 0:
        used = merge_fragments(
            [f"{out_path}.part{p}" for p in range(num_procs)], out_path, fmt)
        for p in used:
            os.remove(p)
    barrier()  # the output is merged
    return stats
