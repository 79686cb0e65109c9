"""The 65,536-colour regime on the card: the port's counterpart of
fulgor_tpu's scripts/demo150k.py.

    python3 -m fulgor_tpu_torch.demo150k [--genomes 65536] [--reads 100000]
        [--timed-reads N] [--device cuda] [--cache bench_cache]
        [--batch-size 32768]

A block-structured corpus of short simulated genomes (10 genes of 330 bp,
the demo's parameters; gene presence, not length, makes the colour sets),
its index (k = 31, m = 19) and 150 bp reads from every 256th genome are
made once and kept under --cache (bench_cache/ in the checkout, which git
ignores). Then FI and TU(0.8) run in three regimes on the same index and
reads:

  (a) no dense matrix (dense_max_bytes=0), the demo's regime: FI by the
      runs fetch (K6's run lists, ANDed on the host per distinct key) and
      TU by runs scored on the host. The dense colour matrix must never be
      made, on the host or on the card.
  (b) the engine's default strategy at this width: the fetch FI takes
      (lists or runs) is printed with the index's ekpu; every record must
      equal (a)'s.
  (c) the meta-diff index (build/color_builder.convert(meta=True,
      diff=True)) in regime (a): its colour ids, which name permuted
      colours, are mapped through the filenames and every record must
      equal (a)'s. Where the host cannot hold the conversion (about 12x
      the decoded colour sets' bytes), (c) is skipped with a line that says
      why.

Each regime's engine is made under FULGOR_SELFCHECK=N (every N-th read
recomputed by the exact host mirror; a difference raises), and each tool
takes a warm pass with that check, whose records are kept as digests, then
one timed pass to /dev/null without it (over the first --timed-reads reads
where given; the runs fetch's key cache emptied first). A line a pass
gives reads/s, the
engine's query, host, redo and write seconds, reads redone and mapped, the
kernel launches, the peak host RSS and the card's peak memory. The last
line is one JSON object of every figure.

It runs on the card and raises where none is visible, unless --device cpu
is given (the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from .build.builder import build_index
from .build.color_builder import convert
from .index import Index
from .io.simulate import simulate_pangenome_blocks, simulate_reads, write_fastq
from .ops import kernels
from .query import engine as engine_mod
from .query.engine import QueryEngine, resolve_device

# scripts/demo150k.py:35-39, :48 and :20
CORPUS = dict(num_genes=10, gene_len=330, core_frac=0.3, loss_rate=0.05,
              mut_per_branch=2, gain_per_branch=1, gain_len=330,
              pool_genes=400, seed=11)
GENOMES, READS, READ_LEN, READ_EVERY, READ_SEED = 65536, 100_000, 150, 256, 5
K, M = 31, 19
TAU = 0.8
# the colour re-compressions stream through about this many times the
# decoded colour sets' bytes (build/color_builder.convert)
CONVERT_FACTOR = 12
# the warm passes check at least this many reads against the host mirror
SELFCHECK_READS = 1000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = (("fi", None), ("tu", TAU))


def log(msg):
    print(f"[demo150k] {msg}", flush=True)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    stands in for them."""
    if device.type != "cuda":
        return f"{device} (no card)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return out or torch.cuda.get_device_name(device)


def peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def mem_available() -> int:
    """Bytes the host can still give, from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def ensure_inputs(cache: str, genomes: int = GENOMES, reads: int = READS):
    """The corpus, its index and the reads under `cache`, made where
    absent. -> dict(index, reads paths; corpus_s, build_s seconds, None
    where taken from the cache)."""
    corpus = os.path.join(cache, f"torch_big{genomes}")
    index_path = corpus + ".tfur"
    reads_path = os.path.join(cache, f"torch_big{genomes}_reads{reads}.fq.gz")
    out = dict(index=index_path, reads=reads_path, corpus_s=None,
               build_s=None)
    if not os.path.exists(index_path):
        t0 = time.perf_counter()
        paths = simulate_pangenome_blocks(corpus, genomes, gzip_files=False,
                                          **CORPUS)
        out["corpus_s"] = time.perf_counter() - t0
        log(f"corpus: {len(paths)} genomes in {out['corpus_s']:.1f} s")
        t0 = time.perf_counter()
        idx = build_index(paths, k=K, m=M, verbose=True)
        idx.save(index_path + ".part")
        os.replace(index_path + ".part", index_path)
        out["build_s"] = time.perf_counter() - t0
        log(f"index built and saved in {out['build_s']:.1f} s")
    if not os.path.exists(reads_path):
        paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus)
                       if f.endswith(".fa"))
        codes, names = simulate_reads(paths[::READ_EVERY], reads, READ_LEN,
                                      seed=READ_SEED)
        write_fastq(reads_path + ".part.gz", codes, names)
        os.replace(reads_path + ".part.gz", reads_path)
    return out


def make_inputs(cache: str, genomes: int, reads: int) -> dict:
    """ensure_inputs in a child process, so that this process's peak RSS is
    the queries' own. -> its dict, with the child's peak RSS (GiB)."""
    import tempfile

    code = ("import json, resource, sys; "
            "from fulgor_tpu_torch.demo150k import ensure_inputs; "
            "made = ensure_inputs(sys.argv[1], int(sys.argv[2]), "
            "int(sys.argv[3])); made['rss_gib'] = resource.getrusage("
            "resource.RUSAGE_SELF).ru_maxrss / 2**20; "
            "json.dump(made, open(sys.argv[4], 'w'))")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "made.json")
        subprocess.run([sys.executable, "-c", code, cache, str(genomes),
                        str(reads), out], env=env, check=True)
        with open(out) as f:
            return json.load(f)


def first_reads(path: str, n: int) -> str:
    """A file of the first n reads of a FASTQ(.gz) file, made beside it
    where absent."""
    out = path.replace(".fq.gz", f"_first{n}.fq.gz")
    if not os.path.exists(out):
        with gzip.open(path, "rb") as f, gzip.open(out + ".part", "wb") as g:
            for _ in range(4 * n):
                g.write(f.readline())
        os.replace(out + ".part", out)
    return out


def index_figures(idx: Index) -> dict:
    cat, _offs = idx.color_sets_decoded()
    return dict(kmers=int(idx.num_kmers), colours=int(idx.num_colors),
                sets=int(idx.num_color_sets), unitigs=int(idx.num_unitigs),
                words_per_set=int(idx.words_per_set),
                ekpu=round(idx.expected_kmers_per_unitig(), 4),
                members=int(len(cat)), cat_bytes=int(cat.nbytes),
                dense_bytes=int(idx.num_color_sets * idx.words_per_set * 4),
                store_bytes=int(idx.color_store.num_bytes()))


class Digests:
    """An output formatter that keeps one digest a record: the blake2b of
    the read's colour bit row (C32 u32 words, the pad bits 0), so that the
    records of two passes compare read for read without a file of some GB.
    cmap: where given, colour j of these records is colour cmap[j] of the
    records they are compared with (a meta-diff index's permuted ids)."""

    def __init__(self, num_colors: int, cmap=None):
        self.C = num_colors
        self.C32 = (num_colors + 31) // 32
        # column j of a mapped row is column inv[j] of the row written
        self.inv = None if cmap is None else np.argsort(np.concatenate([
            np.asarray(cmap, np.int64),
            np.arange(num_colors, 32 * self.C32)]))
        self.records: dict = {}

    def _rows_of_lists(self, lists) -> np.ndarray:
        from .native import lib as native

        rows = np.zeros((len(lists), self.C32), dtype=np.uint32)
        sizes = np.array([len(c) for c in lists], dtype=np.int64)
        if sizes.sum():
            cols = np.concatenate([np.asarray(c, np.int64) for c in lists])
            native.or_bits_at(rows, np.repeat(np.arange(len(lists)), sizes),
                              cols)
        return rows

    def _mapped(self, rows: np.ndarray) -> np.ndarray:
        """rows with their colours mapped through cmap, 2,048 rows at a
        time."""
        if self.inv is None:
            return rows
        out = np.empty_like(rows)
        for i in range(0, len(rows), 2048):
            bm = np.unpackbits(rows[i: i + 2048].view(np.uint8), axis=1,
                               bitorder="little")
            out[i: i + 2048] = np.packbits(
                np.take(bm, self.inv, axis=1), axis=1,
                bitorder="little").view(np.uint32)
        return out

    def _keep(self, qids, rows) -> int:
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        if self.C % 32:
            rows = rows.copy()
            rows[:, -1] &= np.uint32((1 << (self.C % 32)) - 1)
        rows = self._mapped(rows)
        for q, r in zip(np.asarray(qids).tolist(), rows):
            if q in self.records:
                raise RuntimeError(f"read {q} written twice")
            self.records[q] = hashlib.blake2b(r.tobytes(),
                                              digest_size=16).digest()
        return int(rows.any(axis=1).sum())

    def write_batch(self, qids, colors_per_read):
        self._keep(list(qids), self._rows_of_lists(list(colors_per_read)))

    def write_batch_bits(self, qids, bits) -> int:
        return self._keep(qids, bits)

    def write_batch_bits_grouped(self, qids, rows, inv) -> int:
        return self._keep(qids, np.asarray(rows)[np.asarray(inv)])

    def close(self):
        pass


@contextlib.contextmanager
def digest_output(sink: Digests, path: str):
    """pseudoalign_file's records for `path` go to `sink` instead of a
    file."""
    make = engine_mod.make_formatter
    engine_mod.make_formatter = (
        lambda fmt, p, c: sink if p == path else make(fmt, p, c))
    try:
        yield
    finally:
        engine_mod.make_formatter = make


@contextlib.contextmanager
def selfcheck_env(period: int):
    """FULGOR_SELFCHECK=period while an engine is made."""
    old = os.environ.get("FULGOR_SELFCHECK")
    os.environ["FULGOR_SELFCHECK"] = str(period)
    try:
        yield
    finally:
        if old is None:
            del os.environ["FULGOR_SELFCHECK"]
        else:
            os.environ["FULGOR_SELFCHECK"] = old


def one_pass(eng, reads, threshold, sink=None):
    """One pseudoalign_file pass, the launch counts reset just before it
    and read just after; to `sink` (Digests) or to /dev/null. -> figures of
    the pass."""
    dev = eng.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = "digests" if sink is not None else os.devnull
    kernels.reset_launches()
    with (digest_output(sink, out) if sink is not None
          else contextlib.nullcontext()):
        st = eng.pseudoalign_file(reads, out, threshold=threshold)
    launches = {k: v for k, v in kernels.launches.items() if v}
    return dict(
        reads=st["num_reads"], rate=st["num_reads"] / st["elapsed"],
        elapsed=st["elapsed"], parse_s=st["parse_sec"],
        query_s=st["query_sec"], host_s=st["host_sec"],
        redo_s=st["redo_sec"], write_s=st["write_sec"],
        redone=st["num_redo"], redone_host=st["num_redo_host"],
        mapped=st["num_mapped"], launches=launches,
        rss_gib=peak_rss_gib(),
        card_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None))


def pass_line(regime, tool, kind, p) -> str:
    card = ("-" if p["card_bytes"] is None
            else f"{p['card_bytes'] / 2**30:.3f} GiB")
    return (f"({regime}) {tool} {kind}: {p['reads']} reads in "
            f"{p['elapsed']:.3f} s, {p['rate']:.1f} reads/s; query "
            f"{p['query_s']:.3f} s, host {p['host_s']:.3f} s, redo "
            f"{p['redo_s']:.3f} s, write {p['write_s']:.3f} s; "
            f"{p['redone']} reads redone ({p['redone_host']} on the host), "
            f"{p['mapped']} mapped; launches {p['launches']}; peak host RSS "
            f"{p['rss_gib']:.2f} GiB, card peak {card}")


def regime_passes(regime, eng, reads, cmap=None, timed=True,
                  timed_reads=None) -> dict:
    """FI and TU(TAU) on eng: a warm pass with the engine's self-check,
    its records kept as digests, then (timed) a pass to /dev/null without
    it, over timed_reads (a reads file; the same reads where None), the
    runs fetch's key cache emptied before it (the warm pass filled it with
    the same reads' keys). -> {tool: dict(warm, timed, records)}."""
    out = {}
    check = eng._selfcheck
    for tool, tau in TOOLS:
        eng._selfcheck = check
        sink = Digests(eng.idx.num_colors, cmap)
        warm = one_pass(eng, reads, tau, sink)
        log(pass_line(regime, tool, f"warm, self-check every {check}",
                      warm))
        out[tool] = dict(warm=warm, records=sink.records, timed=None)
        if timed:
            eng._selfcheck = 0
            eng._fi_key_cache.clear()
            out[tool]["timed"] = one_pass(eng, timed_reads or reads, tau)
            log(pass_line(regime, tool, "timed", out[tool]["timed"]))
    eng._selfcheck = check
    return out


def same_records(regime, got, want):
    """Raise unless every tool's records equal want's, read for read."""
    for tool, _tau in TOOLS:
        a, b = got[tool]["records"], want[tool]["records"]
        bad = sorted(q for q in a.keys() | b.keys() if a.get(q) != b.get(q))
        log(f"({regime}) {tool}: {len(a)} records, "
            f"{'all equal to' if not bad else f'{len(bad)} differ from'} "
            f"(a)'s" + (f", first {bad[:10]}" if bad else ""))
        if bad:
            raise RuntimeError(f"regime ({regime}) {tool} differs from (a) "
                               f"on {len(bad)} reads")


def strategy(eng) -> str:
    return ("lists" if eng.use_lists else "runs" if eng.use_runs_fetch
            else "dense")


def run_regimes(idx, reads, device, selfcheck, timed=True,
                batch_size=32768, selfcheck_c=None,
                timed_reads=None) -> dict:
    """Regimes (a), (b) and (c) on idx and the reads file (module
    docstring), each engine under FULGOR_SELFCHECK=selfcheck (regime (c)'s
    under selfcheck_c where given). -> every figure, with each pass's
    launches."""
    res = dict(index=index_figures(idx))
    log(f"index: {res['index']}")
    # (a) the dense matrix forbidden
    with selfcheck_env(selfcheck):
        eng = QueryEngine(idx, batch_size, device, dense_max_bytes=0)
    if not (eng.use_runs_fetch and eng.use_tu_runs):
        raise RuntimeError("regime (a) is not in the runs regime: "
                           f"runs fetch {eng.use_runs_fetch}, runs TU "
                           f"{eng.use_tu_runs}")
    log(f"(a) dense_max_bytes=0: runs fetch {eng.use_runs_fetch}, runs TU "
        f"{eng.use_tu_runs}, probe budget {eng._pb}")
    res["a"] = regime_passes("a", eng, reads, timed=timed,
                             timed_reads=timed_reads)
    never = idx._dense_bits is None and eng._bits is None
    log(f"(a) dense matrix never made: {never} (host {idx._dense_bits is None}"
        f", card {eng._bits is None})")
    if not never:
        raise RuntimeError("regime (a) made the dense colour matrix")
    res["a_never_dense"] = never
    del eng
    # (b) the default strategy
    with selfcheck_env(selfcheck):
        eng = QueryEngine(idx, batch_size, device)
    res["b_fetch"] = strategy(eng)
    log(f"(b) default: FI takes the {res['b_fetch']} fetch (ekpu "
        f"{res['index']['ekpu']}, {idx.words_per_set} words a set, dense "
        f"matrix allowed: {eng._dense_ok}), TU "
        f"{'runs' if eng.use_tu_runs else 'lists' if eng.use_lists else 'mask'}")
    res["b"] = regime_passes("b", eng, reads, timed=timed,
                             timed_reads=timed_reads)
    same_records("b", res["b"], res["a"])
    del eng
    idx._dense_bits = None  # (b) may have made it; (c) works apart
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (c) the meta-diff index
    res["c"] = None
    cat, _ = idx.color_sets_decoded()
    need, avail = CONVERT_FACTOR * cat.nbytes, mem_available()
    log(f"(c) the decoded colour sets hold {cat.nbytes} bytes; the "
        f"conversion needs about {need} ({CONVERT_FACTOR}x), the host has "
        f"{avail} available")
    if need > avail:
        log(f"(c) skipped: the host cannot hold the meta-diff conversion "
            f"({need} bytes needed, {avail} available)")
        res["c_skipped"] = dict(need=need, available=avail)
        return res
    t0 = time.perf_counter()
    md = convert(idx, meta=True, diff=True)
    res["c_convert_s"] = time.perf_counter() - t0
    pos = {fn: i for i, fn in enumerate(idx.filenames)}
    cmap = np.array([pos[fn] for fn in md.filenames], dtype=np.int64)
    log(f"(c) meta-diff conversion in {res['c_convert_s']:.1f} s: colour "
        f"store {md.color_store.num_bytes()} bytes against the hybrid's "
        f"{idx.color_store.num_bytes()}, "
        f"{int((cmap != np.arange(len(cmap))).sum())} colour ids permuted")
    with selfcheck_env(selfcheck_c or selfcheck):
        eng = QueryEngine(md, batch_size, device, dense_max_bytes=0)
    if not (eng.use_runs_fetch and eng.use_tu_runs):
        raise RuntimeError("regime (c) is not in the runs regime")
    res["c"] = regime_passes("c", eng, reads, cmap=cmap, timed=timed,
                             timed_reads=timed_reads)
    same_records("c", res["c"], res["a"])
    never = md._dense_bits is None and eng._bits is None
    log(f"(c) dense matrix never made: {never}")
    if not never:
        raise RuntimeError("regime (c) made the dense colour matrix")
    del eng
    return res


def summary(res) -> dict:
    """res without the records, for the JSON line."""
    out = {}
    for key, val in res.items():
        if key in ("a", "b", "c") and val is not None:
            val = {t: {k: v for k, v in p.items() if k != "records"}
                   for t, p in val.items()}
        out[key] = val
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomes", type=int, default=GENOMES)
    ap.add_argument("--reads", type=int, default=READS)
    ap.add_argument("--device", default=None,
                    help="the card (default) or cpu for the plain versions")
    ap.add_argument("--cache", default=os.path.join(ROOT, "bench_cache"))
    ap.add_argument("--batch-size", type=int, default=32768)
    ap.add_argument("--timed-reads", type=int, default=None,
                    help="the timed passes over the first N reads only "
                    "(default: every read)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises where no card is visible
    log(f"device {device}: {card_line(device)}")
    selfcheck = max(1, args.reads // SELFCHECK_READS)
    os.makedirs(args.cache, exist_ok=True)
    t0 = time.perf_counter()
    made = make_inputs(args.cache, args.genomes, args.reads)
    idx = Index.load(made["index"])
    log(f"inputs ready in {time.perf_counter() - t0:.1f} s (corpus "
        f"{made['corpus_s']}, build {made['build_s']} s; None = cached; "
        f"peak RSS {made['rss_gib']:.2f} GiB, in a process of their own); "
        f"{args.reads} reads of {READ_LEN} bp from every {READ_EVERY}th "
        f"genome; self-check every {selfcheck} reads")
    timed_reads = None
    if args.timed_reads and args.timed_reads < args.reads:
        timed_reads = first_reads(made["reads"], args.timed_reads)
        log(f"the timed passes take the first {args.timed_reads} reads")
    res = run_regimes(idx, made["reads"], device, selfcheck,
                      batch_size=args.batch_size, timed_reads=timed_reads)
    res.update(card=card_line(device), genomes=args.genomes,
               reads=args.reads, timed_reads=args.timed_reads or args.reads,
               selfcheck=selfcheck, inputs=made)
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(summary(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
