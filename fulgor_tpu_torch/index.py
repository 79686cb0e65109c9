"""The fulgor-tpu index (reference L4: include/index.hpp), as read and
written by fulgor_tpu_torch: the file format is fulgor_tpu's.

Composition (hybrid kind; meta/diff variants layer on the color-set store):

    k-mer dictionary : default "mini" = minimizer-positional bucketless
                       dictionary (ops/minidict2.py): one 12 B entry per
                       minimizer RUN (~6.5 k-mers) verified against the
                       unitig text -> ~2-4 B/k-mer on disk, the SSHash-class
                       space point (reference include/index.hpp:13-14).
                       "cuckoo" (build --dict cuckoo) = quotient cuckoo
                       table (ops/lookup.py, kernel K7): (nb, 4) u32 rows
                       of two u64 slots whose value is the colour-set id,
                       ~20 B/k-mer, two 16 B row gathers a window.
    unitig text      : concatenated 2-bit packed bases + base offsets
                       (the dictionary verifies windows against it).
    u2c              : dense uint32 unitig_id -> color_set_id.
    color sets       : one of four stores (core/colorstores.py: hybrid /
                       meta / diff / meta-diff); expanded on demand into a
                       dense bitset matrix (num_sets, ceil(C/32)) for the
                       paths that read it (device_dense), or into the rows
                       a query touches (color_rows) where the matrix is
                       too large.
    filenames        : reference names in color-id order.

Index.load and the colour sets' first decode (color_sets_decoded) are the
tracing spans `index.load` and `index.decode`, kept in the per-process
totals (tracing.PROCESS).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import INDEX_VERSION, tracing
from .constants import EXT, KIND_FROM_EXT
from .core import container
from .core import kmers as K
from .core.colorstores import STORE_CLASSES

# color_rows' memo of decoded rows is reset when it would pass this size
# (FULGOR_ROW_MEMO_BYTES overrides it, read at each call, as fulgor_tpu
# reads it)
ROW_MEMO_BYTES = 4 << 30


def _as_i32(a, device):
    """A u32 numpy array as a torch.int32 tensor of its bit patterns on
    `device`."""
    import torch

    a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    if not a.flags.writeable:  # memory-mapped from the index file
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _print_nested(d, indent=0):
    pad = "  " * indent
    if isinstance(d, dict):
        for key, val in d.items():
            if isinstance(val, dict) or (
                isinstance(val, list) and val and isinstance(val[0], dict)
            ):
                print(f"{pad}{key}:")
                _print_nested(val, indent + 1)
            else:
                print(f"{pad}{key}: {val}")
    else:  # list of dicts
        for item in d:
            _print_nested(item, indent)


@dataclass
class Index:
    kind: str
    k: int
    m: int
    num_kmers: int
    num_colors: int
    filenames: list[str]

    # k-mer dictionary: ONE of two backends (dict_kind selects).
    #   "mini"   (default): minimizer-positional bucketless dictionary
    #            (ops/minidict2.py) — ~2-4 B/k-mer on disk, verifies against
    #            the unitig text (the SSHash-class design, SURVEY §7.3);
    #   "cuckoo": quotient cuckoo table (ops/lookup.py) — ~20 B/k-mer,
    #            2 gathers/window, kept for tooling oracles and comparison.
    dict_table: np.ndarray | None  # cuckoo (nb, 4) u32 rows; value = csid
    unitig_seq: np.ndarray  # uint64 2-bit packed concat
    unitig_offs: np.ndarray  # int64 (U+1,) base offsets
    u2c_csid: np.ndarray  # uint32 (U,)

    color_store: object  # Hybrid/Meta/Diff/MetaDiff store (core/colorstores)

    dict_kind: str = "cuckoo"
    mini_slots: np.ndarray | None = None  # (M2, 6) u32 paired entry slots
    mini_sec: np.ndarray | None = None  # (NR, 8) u32 skew pointer table
    mini_num_slots: int = 0  # fastrange modulus M

    _dense_bits: np.ndarray | None = field(default=None, repr=False)
    _cs_cache: tuple | None = field(default=None, repr=False)
    _mini_obj: object | None = field(default=None, repr=False)
    _row_memo: np.ndarray | None = field(default=None, repr=False)
    _row_pos: np.ndarray | None = field(default=None, repr=False)
    _row_n: int = field(default=0, repr=False)

    # ------------------------------------------------ basic accessors

    @property
    def num_unitigs(self) -> int:
        return len(self.unitig_offs) - 1

    @property
    def num_color_sets(self) -> int:
        return self.color_store.num_color_sets

    def u2c(self, unitig_id: int) -> int:
        return int(self.u2c_csid[unitig_id])

    # ------------------------------------------------ dictionary backend

    def minidict(self):
        """MiniDict2 view over this index's arrays (text32 derived from the
        packed unitig text — not stored twice)."""
        if self._mini_obj is None:
            from .ops.minidict2 import MiniDict2, text32_from_packed

            assert self.dict_kind == "mini"
            self._mini_obj = MiniDict2(
                k=self.k,
                m=self.m,
                slots=self.mini_slots,
                num_slots=self.mini_num_slots,
                text32=text32_from_packed(self.unitig_seq, int(self.unitig_offs[-1])),
                sec_table=self.mini_sec,
                spill_frac=-1.0,
                multi_tail=-1.0,
            )
        return self._mini_obj

    def device_dict(self):
        """(table, dparams) for ops/pipeline: for mini the (slots, text32,
        skew) numpy arrays plus the static probe parameters (m, num_slots);
        for cuckoo the (nb, 4) table and None."""
        if self.dict_kind == "cuckoo":
            return self.dict_table, None
        d = self.minidict()
        return (d.slots, d.text32, d.sec_table), (self.m, self.mini_num_slots)

    def device_tables(self, device) -> dict:
        """The index's dictionary as tensors on `device`, u32 data as
        torch.int32 bit patterns: for mini, slots (R, 24), text32 (N, 4) and
        skew (NR, 8); for cuckoo, table (nb, 4). The colour bits are apart
        (device_dense): only the paths that read them upload them."""
        if self.dict_kind == "cuckoo":
            return {"table": _as_i32(self.dict_table, device)}
        (slots, text32, skew), _ = self.device_dict()
        return {"slots": _as_i32(slots, device),
                "text32": _as_i32(text32, device),
                "skew": _as_i32(skew, device)}

    def device_dense(self, device):
        """The dense colour bits (num_color_sets, C32) as an int32 tensor on
        `device` (dense_color_bits, uploaded)."""
        return _as_i32(self.dense_color_bits(), device)

    def host_window_csids(self, codes: np.ndarray):
        """Exact host lookup over every k-window of a 1-D code array.
        -> (hit bool (Wk,), csid u32 (Wk,) — INVALID_U32 where no hit)."""
        from .constants import INVALID_U32

        if self.dict_kind == "mini":
            from .ops.minidict2 import probe_windows_host

            hit, csid = probe_windows_host(self.minidict(), codes)
            return hit, np.where(hit, csid, np.uint32(INVALID_U32))
        from .query.host_lookup import lookup_host

        km, valid = K.pack_kmers(np.asarray(codes, dtype=np.uint8), self.k)
        out = np.full(len(km), INVALID_U32, dtype=np.uint32)
        if len(km):
            vals = lookup_host(self.dict_table, K.canonicalize(km, self.k))
            hitm = valid & (vals != INVALID_U32)
            out[hitm] = vals[hitm]
        return out != INVALID_U32, out

    def color_sets_decoded(self):
        """(cat u32, offs i64) for all sets, cached. For meta/meta-diff
        kinds the color ids are the PERMUTED ids (filenames are stored in
        the same permuted order, reference README.md:222-231)."""
        if self._cs_cache is None:
            with tracing.span("index.decode", process=True):
                self._cs_cache = self.color_store.decode_all()
        return self._cs_cache

    def color_set(self, cs_id: int) -> np.ndarray:
        cat, offs = self.color_sets_decoded()
        return cat[offs[cs_id] : offs[cs_id + 1]]

    def unitig_codes(self, i: int) -> np.ndarray:
        lo, hi = int(self.unitig_offs[i]), int(self.unitig_offs[i + 1])
        w0, w1 = lo >> 5, (hi + 31) >> 5
        codes = K.unpack2(self.unitig_seq[w0:w1], (w1 - w0) * 32)
        return codes[lo - (w0 << 5) : hi - (w0 << 5)]

    def unitig_seq_str(self, i: int) -> str:
        return K.codes_to_seq(self.unitig_codes(i))

    def expected_kmers_per_unitig(self) -> float:
        """Occurrence-weighted expected unitig k-mer count at a random READ
        position: unitig u is traversed by reads in proportion to its k-mer
        count TIMES how many genomes contain it (its color-set size), so
        E = sum(len_u^2 * |set_u|) / sum(len_u * |set_u|). This is the
        engine's streaming-locality signal (clonal pangenomes ~ hundreds;
        SNP-shredded graphs ~ 2-5) — the reference's streaming fast path
        (src/ps_full_intersection.cpp:341-353) exploits the same locality
        implicitly."""
        k = self.k
        ul = np.diff(self.unitig_offs)
        lens_k = np.maximum(0, ul - k + 1).astype(np.float64)
        _cat, offs = self.color_sets_decoded()
        ssz = (offs[1:] - offs[:-1]).astype(np.float64)
        w = ssz[self.u2c_csid.astype(np.int64)]
        den = float((lens_k * w).sum())
        return float((lens_k * lens_k * w).sum() / den) if den > 0 else 1.0

    # ------------------------------------------------ dense device view

    @property
    def words_per_set(self) -> int:
        return (self.num_colors + 31) // 32

    def dense_color_bits(self) -> np.ndarray:
        """(num_color_sets, ceil(C/32)) uint32 bitset matrix (cached).

        This is the device-side colour-set representation: the full
        intersection is a gather + AND of its rows (ops/intersect.py).
        """
        if self._dense_bits is None:
            from .native import lib as _native

            cat, offs = self.color_sets_decoded()
            self._dense_bits = _native.dense_bits(
                cat, offs[:-1], offs[1:], self.num_colors
            )
        return self._dense_bits

    def color_rows(self, csids: np.ndarray) -> np.ndarray:
        """(len(csids), C32) uint32 bitset rows of the given sets, decoded
        on demand (fulgor_tpu index.py:215): where the dense matrix is too
        large to build, only the sets a query stream touches are decoded.
        The rows live in a growing memo with a csid -> row map, so the
        fan-out is one fancy index; when the memo would pass ROW_MEMO_BYTES
        (FULGOR_ROW_MEMO_BYTES) it is reset and the working set decodes
        again. Rows come from the dense matrix instead where it exists."""
        if self._dense_bits is not None:
            return self._dense_bits[np.asarray(csids, dtype=np.int64)]
        W = self.words_per_set
        if self._row_memo is None:
            self._row_memo = np.empty((4096, W), dtype=np.uint32)
            self._row_pos = np.full(self.num_color_sets, -1, dtype=np.int64)
            self._row_n = 0
        csids = np.asarray(csids, dtype=np.int64)
        pos = self._row_pos
        new = np.unique(csids[pos[csids] < 0])
        if len(new):
            cap = int(os.environ.get("FULGOR_ROW_MEMO_BYTES",
                                     ROW_MEMO_BYTES))
            if (self._row_n + len(new)) * 4 * W > cap:
                self._row_memo = np.empty((4096, W), dtype=np.uint32)
                pos.fill(-1)
                self._row_n = 0
                new = np.unique(csids)
            need = self._row_n + len(new)
            if need > len(self._row_memo):
                arr = np.empty((max(need, 2 * len(self._row_memo)), W),
                               dtype=np.uint32)
                arr[: self._row_n] = self._row_memo[: self._row_n]
                self._row_memo = arr
            from .native import lib as _native

            cat, offs = self.color_sets_decoded()
            self._row_memo[self._row_n: need] = _native.dense_bits(
                cat, offs[new], offs[new + 1], self.num_colors)
            pos[new] = self._row_n + np.arange(len(new), dtype=np.int64)
            self._row_n = need
        return self._row_memo[pos[csids]]

    # ------------------------------------------------ serialization

    def save(self, path: str):
        meta = {
            "index_version": list(INDEX_VERSION),
            "k": self.k,
            "m": self.m,
            "num_kmers": self.num_kmers,
            "num_colors": self.num_colors,
            "num_unitigs": self.num_unitigs,
            "num_color_sets": self.num_color_sets,
        }
        meta["dict_kind"] = self.dict_kind
        fn_blob = "\n".join(self.filenames).encode()
        cs_arrays, cs_extra = self.color_store.arrays()
        arrays = {
            "unitig_seq": self.unitig_seq,
            "unitig_offs": self.unitig_offs,
            "u2c_csid": self.u2c_csid,
            "filenames": np.frombuffer(fn_blob, dtype=np.uint8),
        }
        if self.dict_kind == "cuckoo":
            arrays["dict_table"] = self.dict_table
        else:
            arrays["dict.slots"] = self.mini_slots
            arrays["dict.skew"] = self.mini_sec
            meta["dict_num_slots"] = self.mini_num_slots
            meta["dict_version"] = 3  # 3 = 15-bit fingerprint + strand
            # bit (2 = skew pointer table with 16-bit fingerprints)
        for name, arr in cs_arrays.items():
            arrays["cs." + name] = arr
        container.save(
            path, kind=self.kind, meta=meta, extra={"color_store": cs_extra}, arrays=arrays
        )

    @classmethod
    @tracing.traced("index.load", process=True)
    def load(cls, path: str) -> "Index":
        c = container.Container(path)
        fn_blob = c.array("filenames").tobytes().decode()
        meta = c.meta
        store = STORE_CLASSES[c.kind].from_arrays(
            c.extra["color_store"], lambda name: c.array("cs." + name)
        )
        dict_kind = meta.get("dict_kind", "cuckoo")
        dict_version = meta.get("dict_version", 1)
        mini_slots = c.array("dict.slots") if dict_kind == "mini" else None
        if dict_kind == "mini" and dict_version == 2:
            # v2 -> v3 upgrade on load: the 15 low fingerprint bits are
            # layout-identical; only the strand bit (bit 31) is recomputed
            # from the dictionary's own text (ops/minidict2.py docstring).
            # Soundness requires odd m (no m-mer equals its own reverse
            # complement); even-m v2 indexes cannot take the strand filter
            # and must be rebuilt (build_index now forces odd m).
            if int(meta["m"]) % 2 == 0:
                raise ValueError(
                    f"{path}: v2 mini dictionary built with even m="
                    f"{meta['m']} cannot be upgraded to the strand-bit "
                    "layout (palindromic m-mers); rebuild the index"
                )
            from .ops.minidict2 import text32_from_packed, upgrade_slots_v2_to_v3

            mini_slots = upgrade_slots_v2_to_v3(
                mini_slots,
                text32_from_packed(c.array("unitig_seq"),
                                   int(c.array("unitig_offs")[-1])),
                meta["m"],
            )
        elif dict_kind == "mini" and dict_version != 3:
            raise ValueError(
                f"{path}: mini-dictionary format v{dict_version} "
                "predates the skew pointer table; rebuild the index"
            )
        idx = cls(
            kind=c.kind,
            k=meta["k"],
            m=meta["m"],
            num_kmers=meta["num_kmers"],
            num_colors=meta["num_colors"],
            filenames=fn_blob.split("\n") if fn_blob else [],
            dict_table=c.array("dict_table") if dict_kind == "cuckoo" else None,
            unitig_seq=c.array("unitig_seq"),
            unitig_offs=c.array("unitig_offs"),
            u2c_csid=c.array("u2c_csid"),
            color_store=store,
            dict_kind=dict_kind,
            mini_slots=mini_slots,
            mini_sec=c.array("dict.skew") if dict_kind == "mini" else None,
            mini_num_slots=meta.get("dict_num_slots", 0),
        )
        assert meta["num_unitigs"] == idx.num_unitigs
        assert meta["num_color_sets"] == idx.num_color_sets
        return idx

    @staticmethod
    def path_for(basename: str, kind: str) -> str:
        return basename + EXT[kind]

    @staticmethod
    def kind_of(path: str) -> str:
        for ext, kind in KIND_FROM_EXT.items():
            if path.endswith(ext):
                return kind
        raise ValueError(f"unknown index extension: {path}")

    # ------------------------------------------------ stats

    def component_bytes(self) -> dict:
        if self.dict_kind == "cuckoo":
            dict_bytes = int(self.dict_table.nbytes)
        else:  # text32 is derived from unitig_text (counted there), not stored
            dict_bytes = int(self.mini_slots.nbytes + self.mini_sec.nbytes)
        return {
            "dictionary": dict_bytes,
            "unitig_text": int(self.unitig_seq.nbytes + self.unitig_offs.nbytes),
            "color_sets": int(self.color_store.num_bytes()),
            "u2c": int(self.u2c_csid.nbytes),
            "filenames": sum(len(f) for f in self.filenames) + 4 * len(self.filenames),
        }

    def print_stats(self):
        comp = self.component_bytes()
        total = sum(comp.values())
        print(f"total index size: {total} [B] -- {total / 1e9:.5f} [GB]")
        print("SPACE BREAKDOWN:")
        for name, nbytes in comp.items():
            print(f"  {name}: {nbytes} bytes / {nbytes / 1e9:.5f} GB ({100.0 * nbytes / total:.3f}%)")
        cat, offs = self.color_sets_decoded()
        nints = len(cat)
        print(f"Color id range 0..{self.num_colors - 1}")
        print(f"Number of distinct color sets: {self.num_color_sets}")
        print(
            f"Number of ints in distinct color sets: {nints} "
            f"({8.0 * comp['color_sets'] / max(1, nints):.5f} bits/int)"
        )
        print(f"k: {self.k}")
        print(f"m: {self.m} (nominal minimizer length)")
        print(
            f"Number of kmers in dBG: {self.num_kmers} "
            f"({8.0 * (comp['dictionary'] + comp['unitig_text']) / max(1, self.num_kmers):.5f} bits/kmer)"
        )
        print(f"Number of unitigs in dBG: {self.num_unitigs}")
        print(
            f"dictionary backend: {self.dict_kind} "
            f"({comp['dictionary'] / max(1, self.num_kmers):.2f} B/kmer + unitig text)"
        )
        print(f"color store [{self.kind}]:")
        _print_nested(self.color_store.stats(), indent=1)

    # ------------------------------------------------ dump / load (text interchange)

    def dump(self, basename: str):
        """Write the 4-file text dump (format: reference README.md:295-387)."""
        with open(basename + ".metadata.txt", "w") as f:
            f.write(f"k={self.k}\n")
            f.write(f"num_kmers={self.num_kmers}\n")
            f.write(f"num_colors={self.num_colors}\n")
            f.write(f"num_unitigs={self.num_unitigs}\n")
            f.write(f"num_color_sets={self.num_color_sets}\n")
        with open(basename + ".filenames.txt", "w") as f:
            for fn in self.filenames:
                f.write(fn + "\n")
        codes_all = K.unpack2(self.unitig_seq, int(self.unitig_offs[-1]))
        lut = np.frombuffer(b"ACGT", dtype=np.uint8)
        with open(basename + ".unitigs.fa", "wb") as f:
            for i in range(self.num_unitigs):
                f.write(b"> color_set_id=%d\n" % self.u2c_csid[i])
                seg = lut[codes_all[self.unitig_offs[i] : self.unitig_offs[i + 1]]]
                f.write(seg.tobytes())
                f.write(b"\n")
        cat, offs = self.color_sets_decoded()
        with open(basename + ".color_sets.txt", "w") as f:
            for s in range(self.num_color_sets):
                row = cat[offs[s] : offs[s + 1]]
                f.write(f"size={len(row)} " + " ".join(map(str, row)) + "\n")

    @classmethod
    def from_dump(cls, basename: str, m: int = 20) -> "Index":
        """An index from the dump files, no ccdBG build (reference
        src/index.cpp:122-305), through build/builder.assemble_index."""
        from .build.builder import assemble_index
        from .native import lib as native

        meta = {}
        with open(basename + ".metadata.txt") as f:
            for line in f:
                key, val = line.strip().split("=")
                meta[key] = int(val)
        with open(basename + ".filenames.txt") as f:
            filenames = [ln.rstrip("\n") for ln in f if ln.strip()]
        codes_mat, lens, names = native.parse_reads(basename + ".unitigs.fa")
        ucs = np.array([int(n.split("=")[1]) for n in names], dtype=np.uint32)
        uoffs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
        ucodes = np.concatenate(
            [codes_mat[i, : lens[i]] for i in range(len(lens))]
        ) if len(lens) else np.empty(0, np.uint8)
        sizes = []
        cols = []
        with open(basename + ".color_sets.txt") as f:
            for ln in f:
                parts = ln.split()
                n = int(parts[0].split("=")[1])
                if n != len(parts) - 1:
                    raise ValueError(f"{basename}.color_sets.txt: a set of "
                                     f"size={n} lists {len(parts) - 1}")
                sizes.append(n)
                cols.append(np.array(parts[1:], dtype=np.uint32))
        cs_offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        cs_colors = np.concatenate(cols).astype(np.uint32) if cols else np.empty(0, np.uint32)
        idx = assemble_index(
            k=meta["k"],
            m=m,
            num_colors=meta["num_colors"],
            filenames=filenames,
            unitig_codes=ucodes,
            unitig_offs=uoffs,
            unitig_cs=ucs,
            cs_colors=cs_colors,
            cs_offs=cs_offs,
        )
        if idx.num_kmers != meta["num_kmers"]:
            raise ValueError("kmer count mismatch vs dump metadata")
        return idx
