"""The fulgor-tpu index (reference L4: include/index.hpp), as read and
written by fulgor_tpu_torch: the file format is fulgor_tpu's.

Composition (hybrid kind; meta/diff variants layer on the color-set store):

    k-mer dictionary : default "mini" = minimizer-positional bucketless
                       dictionary (ops/minidict2.py): one 12 B entry per
                       minimizer RUN (~6.5 k-mers) verified against the
                       unitig text -> ~2-4 B/k-mer on disk, the SSHash-class
                       space point (reference include/index.hpp:13-14).
                       fulgor_tpu's alternative "cuckoo" table loads here
                       but is not queried by this package.
    unitig text      : concatenated 2-bit packed bases + base offsets
                       (the dictionary verifies windows against it).
    u2c              : dense uint32 unitig_id -> color_set_id.
    color sets       : one of four stores (core/colorstores.py: hybrid /
                       meta / diff / meta-diff); expanded at load into a
                       dense bitset matrix (num_sets, ceil(C/32)) for the
                       device.
    filenames        : reference names in color-id order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import INDEX_VERSION
from .core import container
from .core.colorstores import STORE_CLASSES


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

    # ------------------------------------------------ basic accessors

    @property
    def num_unitigs(self) -> int:
        return len(self.unitig_offs) - 1

    @property
    def num_color_sets(self) -> int:
        return self.color_store.num_color_sets

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
        """(table, dparams) for ops/pipeline: the (slots, text32, skew) numpy
        arrays plus the static probe parameters (m, num_slots)."""
        d = self.minidict()
        return (d.slots, d.text32, d.sec_table), (self.m, self.mini_num_slots)

    def device_tables(self, device) -> dict:
        """The index's device state as tensors on `device`, u32 data as
        torch.int32 bit patterns: slots (R, 24), text32 (N, 4), skew
        (NR, 8) and the dense colour bits (S, C32)."""
        import torch

        (slots, text32, skew), _ = self.device_dict()

        def as_i32(a):
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
            if not a.flags.writeable:  # memory-mapped from the index file
                a = a.copy()
            return torch.from_numpy(a).to(device)

        return {"slots": as_i32(slots), "text32": as_i32(text32),
                "skew": as_i32(skew),
                "dense": as_i32(self.dense_color_bits())}

    def host_window_csids(self, codes: np.ndarray):
        """Exact host lookup over every k-window of a 1-D code array.
        -> (hit bool (Wk,), csid u32 (Wk,) — INVALID_U32 where no hit)."""
        from .constants import INVALID_U32

        if self.dict_kind != "mini":
            raise NotImplementedError(
                "fulgor_tpu_torch queries the mini dictionary only; rebuild "
                "the index with the default --dict mini")
        from .ops.minidict2 import probe_windows_host

        hit, csid = probe_windows_host(self.minidict(), codes)
        return hit, np.where(hit, csid, np.uint32(INVALID_U32))

    def color_sets_decoded(self):
        """(cat u32, offs i64) for all sets, cached. For meta/meta-diff
        kinds the color ids are the PERMUTED ids (filenames are stored in
        the same permuted order, reference README.md:222-231)."""
        if self._cs_cache is None:
            self._cs_cache = self.color_store.decode_all()
        return self._cs_cache

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
