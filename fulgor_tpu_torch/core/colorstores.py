"""Color-set stores: hybrid, meta, differential, meta-differential.

Reference: include/color_sets/{hybrid,meta,differential,meta_differential}.hpp.

Design difference vs the reference (TPU-first): the stores are SERIALIZATION
tiers only. Queries always run on the dense bitset matrix built at load from
`decode_all()`, so no per-codec iterator algebra exists on the query path
(the reference's leapfrog/merge specializations per codec are CPU-isms).
What each tier preserves is the reference's compression *structure*:

  hybrid    per-set sparse/bitmap/complement encoding      (hybrid.py)
  meta      colors permuted + partitioned; sets become lists of deduplicated
            per-partition "partial sets"; partials hybrid-coded per partition
  diff      sets permuted into clusters; per-cluster representative set;
            each set stored as delta-coded symmetric difference vs rep
  meta_diff meta structure whose partial sets are diff-coded per partition,
            plus dedup of the partition-id lists ("partition sets")

Color/set id permutations are APPLIED at build time: a meta store's decoded
sets use permuted color ids (the caller permutes filenames to match —
reference README.md:222-231), and a diff store's set ids are the permuted
ones (the caller rewires u2c / the dictionary).
"""

from __future__ import annotations

import numpy as np

from ..constants import KIND_DIFF, KIND_HYBRID, KIND_META, KIND_META_DIFF
from . import hybrid as H
from .bitsx import (BitReader, BitWriter, EliasFano, delta_patterns,
                    seg_gather_idx, seg_ids)


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------


def _ef_arrays(prefix: str, values: np.ndarray, arrays: dict, extra: dict):
    ef = EliasFano.encode(np.asarray(values, dtype=np.uint64))
    arrays[prefix + "_low"] = ef.low_words
    arrays[prefix + "_high"] = ef.high_words
    extra[prefix] = {"n": ef.n, "u": ef.u, "l": ef.l}


def _ef_decode(prefix: str, get, extra: dict) -> np.ndarray:
    p = extra[prefix]
    return EliasFano(get(prefix + "_low"), get(prefix + "_high"), p["n"], p["u"], p["l"]).decode_all()


def encode_delta_lists(lists_cat: np.ndarray, offs: np.ndarray, headers: np.ndarray | None = None):
    """Encode records [delta(header_0) .. delta(header_h) delta(n)
    delta(first) delta(gap-1)...] -> (words u64, bit_offs u64 (n+1,)).

    headers: optional (n_records, h) extra uint values per record.
    """
    n = len(offs) - 1
    sizes = (offs[1:] - offs[:-1]).astype(np.int64)
    w = BitWriter()
    bit_offs = [0]
    # vectorized: build global (pattern,len) item sequence
    h = 0 if headers is None else headers.shape[1]
    counts = sizes + 1 + h
    item_offs = np.concatenate([[0], np.cumsum(counts)])
    total = int(item_offs[-1])
    pats = np.zeros(total, dtype=np.uint64)
    lens = np.zeros(total, dtype=np.uint64)
    if headers is not None:
        for j in range(h):
            p, l = delta_patterns(headers[:, j].astype(np.uint64))
            pats[item_offs[:-1] + j] = p
            lens[item_offs[:-1] + j] = l
    p, l = delta_patterns(sizes.astype(np.uint64))
    pats[item_offs[:-1] + h] = p
    lens[item_offs[:-1] + h] = l
    if len(lists_cat):
        starts = offs[:-1].astype(np.int64)
        vals = np.empty(len(lists_cat), dtype=np.uint64)
        c = lists_cat.astype(np.int64)
        vals[1:] = (c[1:] - c[:-1] - 1).astype(np.uint64)
        nz = starts[sizes > 0]
        vals[nz] = lists_cat[nz]
        p, l = delta_patterns(vals)
        sid = seg_ids(sizes)
        dest = (
            item_offs[:-1][sid]
            + h
            + 1
            + (np.arange(len(lists_cat), dtype=np.int64) - starts[sid])
        )
        pats[dest] = p
        lens[dest] = l
    w.append_patterns(pats, lens)
    per_rec = np.add.reduceat(lens, item_offs[:-1]) if n else np.empty(0)
    bit_offs = np.concatenate([[0], np.cumsum(per_rec)]).astype(np.uint64)
    return w.finalize(), bit_offs


def read_bits_at(words: np.ndarray, bit_pos: np.ndarray, widths) -> np.ndarray:
    """Vectorized fixed-width reads at arbitrary bit offsets: element i is
    the `widths[i]`-bit LSB-first value at bit `bit_pos[i]` of the u64
    stream. widths may be a scalar or an array; widths < 64."""
    bit_pos = np.asarray(bit_pos, dtype=np.uint64)
    widths = np.asarray(widths, dtype=np.uint64)
    widx = (bit_pos >> np.uint64(6)).astype(np.int64)
    sh = bit_pos & np.uint64(63)
    lo = words[widx] >> sh
    spill = (sh + widths) > np.uint64(64)
    nxt = np.minimum(widx + 1, len(words) - 1)
    hi = np.where(
        spill, words[nxt] << (np.uint64(64) - np.maximum(sh, np.uint64(1))), np.uint64(0)
    ).astype(np.uint64)
    return ((lo | hi) & ((np.uint64(1) << widths) - np.uint64(1))).astype(np.int64)


def decode_delta_lists(words: np.ndarray, bit_offs: np.ndarray, num_headers: int = 0):
    """Inverse of encode_delta_lists (native-accelerated when available).
    -> (headers (n, num_headers) i64, cat u32, offs i64)."""
    try:
        from ..native import lib as _native

        return _native.delta_records_decode(words, bit_offs, num_headers)
    except Exception:
        pass
    n = len(bit_offs) - 1
    headers = np.zeros((n, num_headers), dtype=np.int64)
    sizes = np.zeros(n, dtype=np.int64)
    chunks = []
    for i in range(n):
        r = BitReader(words, int(bit_offs[i]))
        for j in range(num_headers):
            headers[i, j] = r.read_delta()
        sz = r.read_delta()
        sizes[i] = sz
        vals = np.empty(sz, dtype=np.uint32)
        prev = -1
        for t in range(sz):
            d = r.read_delta()
            prev = d if t == 0 else prev + 1 + d
            vals[t] = prev
        chunks.append(vals)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    cat = np.concatenate(chunks).astype(np.uint32) if chunks else np.empty(0, np.uint32)
    return headers, cat, offs


# --------------------------------------------------------------------------
# hybrid
# --------------------------------------------------------------------------


class HybridStore:
    kind = KIND_HYBRID

    def __init__(self, num_colors: int, stream: np.ndarray, bit_offs: np.ndarray):
        self.num_colors = int(num_colors)
        self.stream = stream
        self.bit_offs = bit_offs

    @classmethod
    def build(cls, cat: np.ndarray, offs: np.ndarray, num_colors: int) -> "HybridStore":
        enc = H.HybridEncoder(num_colors)
        enc.add_sets(np.asarray(cat, dtype=np.uint32), np.asarray(offs))
        stream, bit_offs = enc.finalize()
        return cls(num_colors, stream, bit_offs)

    @property
    def num_color_sets(self) -> int:
        return len(self.bit_offs) - 1

    def decode_all(self):
        return H.decode_all(self.stream, self.bit_offs, self.num_colors)

    def decode_set(self, sid: int) -> np.ndarray:
        return H.decode_set(self.stream, self.bit_offs[sid], self.num_colors)

    def arrays(self):
        arrays = {"cs_stream": self.stream}
        extra = {"num_colors": self.num_colors}
        _ef_arrays("cs_offs", self.bit_offs, arrays, extra)
        return arrays, extra

    @classmethod
    def from_arrays(cls, extra, get):
        return cls(extra["num_colors"], get("cs_stream"), _ef_decode("cs_offs", get, extra))

    def num_bytes(self) -> int:
        return int(self.stream.nbytes + EliasFano.encode(self.bit_offs).num_bytes())

    def stats(self) -> dict:
        """Per-encoding and per-size-bucket space breakdown (superset of the
        reference hybrid::print_stats, src/color_sets.cpp:8-82)."""
        _, offs = self.decode_all()
        sizes = (offs[1:] - offs[:-1]).astype(np.int64)
        bits = np.diff(self.bit_offs).astype(np.int64)
        kinds = H.encoding_kinds(sizes, self.num_colors)
        C = self.num_colors
        nb = 10
        bsize = max(1, C // nb)
        bucket = np.minimum((np.maximum(sizes, 1) - 1) // bsize, nb - 1)
        total_bits = int(bits.sum())
        total_ints = int(sizes.sum())
        buckets = []
        for i in range(nb):
            sel = bucket == i
            n_sets = int(sel.sum())
            if n_sets == 0:
                continue
            n_ints = int(sizes[sel].sum())
            n_bits = int(bits[sel].sum())
            buckets.append({
                "size_range": (i * bsize, C if i == nb - 1 else (i + 1) * bsize),
                "sets": n_sets,
                "ints": n_ints,
                "bits_per_int": round(n_bits / max(1, n_ints), 3),
                "pct_space": round(100.0 * n_bits / max(1, total_bits), 2),
            })
        ef_bytes = EliasFano.encode(self.bit_offs).num_bytes()
        return {
            "sets": {
                "sparse": int((kinds == 0).sum()),
                "bitmap": int((kinds == 1).sum()),
                "complement": int((kinds == 2).sum()),
            },
            "colors_bits_per_int": round(8.0 * self.stream.nbytes / max(1, total_ints), 3),
            "offsets_bits_per_int": round(8.0 * ef_bytes / max(1, total_ints), 3),
            "size_buckets": buckets,
        }


# --------------------------------------------------------------------------
# meta
# --------------------------------------------------------------------------


def _splitmix64_np(x):
    x = (np.asarray(x, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def intern_partials(cat, offs, num_colors, partition_bounds):
    """Split every set at partition boundaries and intern the partial sets
    per partition — fully vectorized (the reference deduplicates partials by
    CityHash128, meta_builder.hpp:171-217; we use two independent 64-bit
    position-mixed hashes, with `check_conversion` as the end-to-end
    collision oracle).

    -> dict with:
      occ_set, occ_part        per partial OCCURRENCE (element order)
      occ_global               global partial id per occurrence
      meta_offs (S+1,)         occurrences per set
      partial_base (P+1,)      global id base per partition
      plists_cat, plists_offs  unique partial contents (relative colors),
                               ordered by (partition, local id)
    """
    from ..native import lib as _native

    S = len(offs) - 1
    P = len(partition_bounds) - 1
    L = len(cat)
    sizes = (offs[1:] - offs[:-1]).astype(np.int64)
    sid = seg_ids(sizes)
    part_of_color = (
        np.searchsorted(partition_bounds, np.arange(num_colors), side="right") - 1
    )
    parts = part_of_color[cat.astype(np.int64)]
    rel = (cat.astype(np.int64) - np.asarray(partition_bounds)[parts]).astype(np.uint32)

    is_new = np.empty(L, dtype=bool)
    if L:
        is_new[0] = True
        np.not_equal(sid[1:], sid[:-1], out=is_new[1:])
        is_new[1:] |= parts[1:] != parts[:-1]
    starts = np.flatnonzero(is_new)
    n_occ = len(starts)
    occ_sizes = np.diff(np.concatenate([starts, [L]]))
    occ_set = sid[starts]
    occ_part = parts[starts]
    meta_counts = np.bincount(occ_set, minlength=S)
    meta_offs = np.concatenate([[0], np.cumsum(meta_counts)]).astype(np.int64)

    # content hashes (position-mixed, summed per occurrence; native parallel)
    h1, h2 = _native.hash_partials(rel, starts, L)

    # group identical (partition, h1, h2) triples: a 3-key lexsort + run
    # detection replaces np.unique(axis=0) (void-compare sort, several times
    # slower). The resulting ids are identical: ranks depend only on
    # (partition, first-occurrence index), not on group enumeration order.
    so = np.lexsort((h2, h1, occ_part))
    kp, k1, k2 = occ_part[so], h1[so], h2[so]
    new = np.empty(n_occ, dtype=bool)
    if n_occ:
        new[0] = True
        new[1:] = (kp[1:] != kp[:-1]) | (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])
    gstart = np.flatnonzero(new)
    gid_sorted = np.cumsum(new) - 1 if n_occ else np.empty(0, np.int64)
    first_idx = (
        np.minimum.reduceat(so, gstart) if n_occ else np.empty(0, np.int64)
    )
    grp_part = kp[gstart] if n_occ else np.empty(0, np.int64)
    # local ids: first-occurrence order within each partition
    order = np.lexsort((first_idx, grp_part))  # by (partition, first occurrence)
    rank_of_uniq = np.empty(len(gstart), dtype=np.int64)
    rank_of_uniq[order] = np.arange(len(gstart))
    per_part = np.bincount(grp_part.astype(np.int64), minlength=P)
    partial_base = np.concatenate([[0], np.cumsum(per_part)]).astype(np.int64)
    inverse = np.empty(n_occ, dtype=np.int64)
    inverse[so] = gid_sorted
    occ_global = rank_of_uniq[inverse]  # global partial id per occurrence

    # unique contents ordered by global id: representative = first occurrence
    rep = first_idx[order]  # occurrence index per global id
    rep_start = starts[rep]
    rep_size = occ_sizes[rep]
    plists_offs = np.concatenate([[0], np.cumsum(rep_size)]).astype(np.int64)
    plists_cat = rel[seg_gather_idx(rep_start, rep_size)]
    return dict(
        occ_set=occ_set,
        occ_part=occ_part,
        occ_global=occ_global.astype(np.int64),
        meta_offs=meta_offs,
        partial_base=partial_base,
        plists_cat=plists_cat,
        plists_offs=plists_offs,
        per_part=per_part,
    )


class MetaStore:
    """Colors permuted into P contiguous partitions; every set = union of
    per-partition partial sets, interned per partition and hybrid-coded in
    partition-relative color space; meta lists are fixed-width global
    partial ids (reference include/color_sets/meta.hpp)."""

    kind = KIND_META

    def __init__(
        self,
        num_colors,
        partition_bounds,  # (P+1,) i64 lower color bound per partition (permuted space)
        partial_stores,  # list[HybridStore] (relative colors)
        partial_base,  # (P+1,) i64 global partial-id base per partition
        meta_stream,  # packed fixed-width global partial ids
        meta_offs,  # (S+1,) element offsets into meta_stream
        id_width,
    ):
        self.num_colors = int(num_colors)
        self.partition_bounds = partition_bounds
        self.partial_stores = partial_stores
        self.partial_base = partial_base
        self.meta_stream = meta_stream
        self.meta_offs = meta_offs
        self.id_width = int(id_width)

    @classmethod
    def build(cls, cat, offs, num_colors, partition_bounds) -> "MetaStore":
        """cat/offs: sets with colors ALREADY permuted (sorted per set)."""
        P = len(partition_bounds) - 1
        it = intern_partials(cat, offs, num_colors, partition_bounds)
        total_partials = int(it["partial_base"][-1])
        id_width = max(1, int(max(0, total_partials - 1)).bit_length())
        w = BitWriter()
        w.append_fixed(it["occ_global"].astype(np.uint64), id_width)
        stores = []
        for p in range(P):
            psize = int(partition_bounds[p + 1] - partition_bounds[p])
            lo = int(it["partial_base"][p])
            hi = int(it["partial_base"][p + 1])
            po = (
                it["plists_offs"][lo : hi + 1] - it["plists_offs"][lo]
            ).astype(np.int64)
            pc = it["plists_cat"][it["plists_offs"][lo] : it["plists_offs"][hi]]
            stores.append(HybridStore.build(pc.astype(np.uint32), po, psize))
        return cls(
            num_colors,
            np.asarray(partition_bounds, dtype=np.int64),
            stores,
            it["partial_base"],
            w.finalize(),
            it["meta_offs"],
            id_width,
        )

    @property
    def num_color_sets(self) -> int:
        return len(self.meta_offs) - 1

    def _meta_ids(self) -> np.ndarray:
        """All meta lists unpacked -> flat global partial ids (int64)."""
        total = int(self.meta_offs[-1])
        if total == 0:
            return np.empty(0, dtype=np.int64)
        pos = np.arange(total, dtype=np.uint64) * np.uint64(self.id_width)
        widx = (pos >> np.uint64(6)).astype(np.int64)
        sh = pos & np.uint64(63)
        w = self.meta_stream
        lo = w[widx] >> sh
        spill = (sh + np.uint64(self.id_width)) > np.uint64(64)
        nxt = np.minimum(widx + 1, len(w) - 1)
        hi = np.where(spill, w[nxt] << (np.uint64(64) - np.maximum(sh, np.uint64(1))), 0).astype(
            np.uint64
        )
        mask = np.uint64((1 << self.id_width) - 1)
        return ((lo | hi) & mask).astype(np.int64)

    def decode_all(self):
        # decode every partition's partials once (absolute color space)
        pcat_all, poffs_all, psizes_all = [], [], []
        base_off = 0
        offs_per_store = []
        for p, st in enumerate(self.partial_stores):
            c, o = st.decode_all()
            pcat_all.append(c.astype(np.int64) + int(self.partition_bounds[p]))
            offs_per_store.append(o)
        # global partial table
        sizes = np.concatenate(
            [o[1:] - o[:-1] for o in offs_per_store]
        ) if offs_per_store else np.empty(0, np.int64)
        gcat = np.concatenate(pcat_all) if pcat_all else np.empty(0, np.int64)
        goffs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        ids = self._meta_ids()
        id_sizes = sizes[ids] if len(ids) else np.empty(0, np.int64)
        # expand: for each meta element, copy its partial's colors
        cat = gcat[seg_gather_idx(goffs[ids], id_sizes)].astype(np.uint32)
        # set offsets: sum partial sizes per set
        set_sizes = np.add.reduceat(
            id_sizes, self.meta_offs[:-1]
        ) if self.num_color_sets else np.empty(0, np.int64)
        set_sizes = np.where(
            (self.meta_offs[1:] - self.meta_offs[:-1]) == 0, 0, set_sizes
        )
        offs = np.concatenate([[0], np.cumsum(set_sizes)]).astype(np.int64)
        return cat, offs

    def arrays(self):
        arrays = {
            "meta_stream": self.meta_stream,
            "partition_bounds": self.partition_bounds.astype(np.int64),
            "partial_base": self.partial_base.astype(np.int64),
        }
        extra = {
            "num_colors": self.num_colors,
            "id_width": self.id_width,
            "num_partitions": len(self.partial_stores),
        }
        _ef_arrays("meta_offs", self.meta_offs, arrays, extra)
        for p, st in enumerate(self.partial_stores):
            a, e = st.arrays()
            for k, v in a.items():
                arrays[f"p{p}_{k}"] = v
            extra[f"p{p}"] = e
        return arrays, extra

    @classmethod
    def from_arrays(cls, extra, get):
        P = extra["num_partitions"]
        stores = []
        for p in range(P):
            e = extra[f"p{p}"]
            stores.append(
                HybridStore.from_arrays(
                    e, lambda name, p=p: get(f"p{p}_{name}")
                )
            )
        return cls(
            extra["num_colors"],
            get("partition_bounds"),
            stores,
            get("partial_base"),
            get("meta_stream"),
            _ef_decode("meta_offs", get, extra).astype(np.int64),
            extra["id_width"],
        )

    def num_bytes(self) -> int:
        n = self.meta_stream.nbytes + self.partition_bounds.nbytes + self.partial_base.nbytes
        n += EliasFano.encode(self.meta_offs.astype(np.uint64)).num_bytes()
        for st in self.partial_stores:
            n += st.num_bytes()
        return int(n)

    def stats(self) -> dict:
        """Partial-set encoding census + space split (reference
        meta::print_stats, src/color_sets.cpp:84-142)."""
        enc = {"sparse": 0, "bitmap": 0, "complement": 0}
        partial_bytes = 0
        for st in self.partial_stores:
            s = st.stats()["sets"]
            for key in enc:
                enc[key] += s[key]
            partial_bytes += st.num_bytes()
        meta_bytes = self.meta_stream.nbytes + EliasFano.encode(
            self.meta_offs.astype(np.uint64)
        ).num_bytes()
        total = max(1, self.num_bytes())
        return {
            "partitions": len(self.partial_stores),
            "partials": int(self.partial_base[-1]),
            "meta_ints": int(self.meta_offs[-1]),
            "partial_encodings": enc,
            "partial_color_sets_bytes": int(partial_bytes),
            "meta_color_sets_bytes": int(meta_bytes),
            "partial_pct": round(100.0 * partial_bytes / total, 2),
            "meta_pct": round(100.0 * meta_bytes / total, 2),
        }


# --------------------------------------------------------------------------
# differential
# --------------------------------------------------------------------------


CHAIN_MAX = 64  # chains break here so the levelized decode is bounded
CHAIN_POOL = 128  # pooled feature dims for the within-cluster chain order


class DiffStore:
    """Sets ordered into similarity CHAINS within each cluster; every set is
    stored as the delta-coded symmetric difference against its CHAIN PARENT
    (the previous set in the chain); chain heads diff against the empty set
    (i.e. are stored raw).

    Design difference vs the reference differential codec
    (include/color_sets/differential.hpp, which stores one majority
    representative per cluster and diffs every member against it): a chain
    of nearest-neighbor diffs is substantially smaller on pangenome corpora
    (25.8M vs 42.6M ints on the 1,024-genome clade benchmark) and our
    queries run on dense bitset rows decoded once at load — not per-query
    iterators — so the chain's sequential decode dependency costs nothing
    at query time. Chains break every CHAIN_MAX sets, bounding the decode
    to <= CHAIN_MAX vectorized level passes. Set ids stay stable (the
    reference instead permutes set ids/unitigs and rebuilds its dictionary);
    the per-set parent pointer costs ceil(log2 n) bits."""

    kind = KIND_DIFF

    def __init__(self, num_colors, n_sets, parents, parent_width,
                 diff_stream, diff_offs, n_clusters=0):
        self.num_colors = int(num_colors)
        self.n_sets = int(n_sets)
        self.parents = parents  # packed fixed-width chain-parent set ids
        self.parent_width = int(parent_width)
        self.diff_stream = diff_stream
        self.diff_offs = diff_offs
        self.n_clusters = int(n_clusters)  # informational (stats only)

    @staticmethod
    def _pack_fixed(vals: np.ndarray, width: int) -> np.ndarray:
        w = BitWriter()
        w.append_fixed(np.asarray(vals, dtype=np.uint64), width)
        return w.finalize()

    @staticmethod
    def _unpack_fixed(words: np.ndarray, n: int, width: int) -> np.ndarray:
        pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
        widx = (pos >> np.uint64(6)).astype(np.int64)
        sh = pos & np.uint64(63)
        lo = words[widx] >> sh
        spill = (sh + np.uint64(width)) > np.uint64(64)
        nxt = np.minimum(widx + 1, len(words) - 1)
        hi = np.where(
            spill, words[nxt] << (np.uint64(64) - np.maximum(sh, np.uint64(1))), 0
        ).astype(np.uint64)
        return ((lo | hi) & np.uint64((1 << width) - 1)).astype(np.int64)

    @classmethod
    def build(cls, cat, offs, num_colors, cluster_labels,
              order_features=None) -> "DiffStore":
        """cluster_labels: (n_sets,) cluster id per set (any order). The
        chain order within each cluster is a deterministic sort by quantized
        pooled membership features (a cheap nearest-neighbor proxy);
        order_features overrides them — callers whose `cat` values are NOT
        the similarity space (e.g. the meta-chain's partial ids) must pass
        features computed in the real similarity space."""
        n = len(offs) - 1
        labels = np.asarray(cluster_labels, dtype=np.int64)
        ncl = int(labels.max()) + 1 if n else 0
        sizes = (offs[1:] - offs[:-1]).astype(np.int64)

        # chain order: (cluster, pooled-feature lex)
        if order_features is None:
            from ..native import lib as _native

            B = min(CHAIN_POOL, max(1, int(num_colors)))
            feat = _native.pooled_features(cat, offs, max(1, int(num_colors)), B)
        else:
            feat = np.asarray(order_features, dtype=np.float64)
            B = feat.shape[1]
        # normalize per dim before quantizing: small membership counts must
        # keep resolution or the lex order degenerates into size buckets
        fmax = np.maximum(1.0, feat.max(axis=0) / 255.0) if n else 1.0
        fq = np.round(feat / fmax).astype(np.uint8)
        # (label, feature-bytes lex) sort via u64-packed keys: big-endian
        # 8-byte words compare exactly like the byte sequence, and a few
        # u64 lexsort passes beat a structured-record argsort by >10x
        nw = (B + 7) // 8
        padded = np.zeros((n, nw * 8), dtype=np.uint8)
        padded[:, :B] = fq
        packed = padded.view(np.uint64).reshape(n, nw).byteswap()
        order = np.lexsort(
            tuple(packed[:, i] for i in range(nw - 1, -1, -1)) + (labels,)
        )

        lo = labels[order]
        new_cl = np.concatenate([[True], lo[1:] != lo[:-1]]) if n else np.zeros(0, bool)
        starts = np.flatnonzero(new_cl)
        runlen = np.diff(np.concatenate([starts, [n]]))
        posc = np.arange(n) - np.repeat(starts, runlen)
        head = new_cl | (posc % CHAIN_MAX == 0)
        parent_sorted = np.concatenate([[0], order[:-1]]) if n else np.zeros(0, np.int64)
        parent_sorted[head] = order[head]
        parent = np.empty(n, dtype=np.int64)
        parent[order] = parent_sorted

        # per-set diff = setxor1d(set, parent set); heads diff vs empty.
        # Parent segments are read IN PLACE out of `cat` by the indirect
        # native merge — no gather-index / parent-copy materialization
        # (those were ~2/3 of build time at 232M ints).
        from ..native import lib as _native

        is_head = np.zeros(n, dtype=bool)
        is_head[order[head]] = True
        par_starts = offs[:-1][parent]
        par_ends = par_starts + np.where(is_head, 0, sizes[parent])
        cat32 = np.ascontiguousarray(cat, dtype=np.uint32)
        d_cat, d_offs = _native.symdiff_segments_ind(
            cat32, offs[:-1], offs[1:], cat32, par_starts, par_ends,
        )
        diff_stream, diff_bits = encode_delta_lists(d_cat, d_offs, headers=sizes[:, None])
        pw = max(1, int(max(0, n - 1)).bit_length())
        return cls(
            num_colors, n, cls._pack_fixed(parent, pw), pw,
            diff_stream, diff_bits, ncl,
        )

    @property
    def num_color_sets(self) -> int:
        return len(self.diff_offs) - 1

    def chain_parents(self) -> np.ndarray:
        return self._unpack_fixed(self.parents, self.n_sets, self.parent_width)

    def decode_all(self):
        from ..native import lib as _native

        headers, d_cat, d_offs = decode_delta_lists(self.diff_stream, self.diff_offs, 1)
        n = self.num_color_sets
        parent = self.chain_parents()
        sizes = headers[:, 0].astype(np.int64) if n else np.zeros(0, np.int64)
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        out = np.empty(int(sizes.sum()), dtype=np.uint32)
        d_sz = (d_offs[1:] - d_offs[:-1]).astype(np.int64)

        def seg_gather(src, seg_starts, seg_lens):
            return src[seg_gather_idx(seg_starts, seg_lens)]

        def write_sets(sel, flat):
            out[seg_gather_idx(offs[:-1][sel], sizes[sel])] = flat

        done = parent == np.arange(n)
        sel = np.flatnonzero(done)
        if len(sel):  # heads: the diff IS the set
            write_sets(sel, seg_gather(d_cat, d_offs[:-1][sel], d_sz[sel]))
        # levelized chain application (<= CHAIN_MAX passes by construction)
        for _ in range(CHAIN_MAX + 1):
            ready = ~done & done[parent]
            sel = np.flatnonzero(ready)
            if not len(sel):
                break
            p = parent[sel]
            # both sides read in place: diffs out of d_cat, parent sets out
            # of the (already-written) out buffer
            rc, ro = _native.symdiff_segments_ind(
                d_cat, d_offs[:-1][sel], d_offs[1:][sel],
                out, offs[:-1][p], offs[:-1][p] + sizes[p],
            )
            assert np.array_equal(ro[1:] - ro[:-1], sizes[sel]), "chain decode size mismatch"
            write_sets(sel, rc)
            done[sel] = True
        assert done.all() or n == 0, "chain decode did not converge"
        return out, offs

    def arrays(self):
        arrays = {
            "diff_stream": self.diff_stream,
            "parents": self.parents,
        }
        extra = {
            "format": "chain",
            "num_colors": self.num_colors,
            "n_clusters": self.n_clusters,
            "parent_width": self.parent_width,
            "n_sets": self.n_sets,
        }
        _ef_arrays("diff_offs", self.diff_offs, arrays, extra)
        return arrays, extra

    @classmethod
    def from_arrays(cls, extra, get):
        if extra.get("format") != "chain":
            raise ValueError(
                "differential store predates the chain-diff layout; "
                "re-run `color` to rebuild this index"
            )
        return cls(
            extra["num_colors"],
            extra["n_sets"],
            get("parents"),
            extra["parent_width"],
            get("diff_stream"),
            _ef_decode("diff_offs", get, extra),
            extra["n_clusters"],
        )

    def num_bytes(self) -> int:
        return int(
            self.diff_stream.nbytes
            + self.parents.nbytes
            + EliasFano.encode(self.diff_offs).num_bytes()
        )

    def stats(self) -> dict:
        """Chain/differential space split + diff-size histogram (role of the
        reference differential::print_stats, src/color_sets.cpp:144-241)."""
        headers, d_cat, d_o = decode_delta_lists(self.diff_stream, self.diff_offs, 1)
        n = self.num_color_sets
        parent = self.chain_parents()
        heads = int((parent == np.arange(n)).sum())
        d_sizes = (d_o[1:] - d_o[:-1]).astype(np.int64)
        tenth = max(1, self.num_colors // 10)
        hist = np.bincount(np.minimum(d_sizes // tenth, 10), minlength=11)
        total = max(1, self.num_bytes())
        return {
            "clusters": self.n_clusters,
            "chain_heads": heads,
            "avg_differential_size": round(float(len(d_cat)) / max(1, n), 2),
            "differential_bytes": int(self.diff_stream.nbytes),
            "parent_map_bytes": int(self.parents.nbytes),
            "offsets_bytes": int(EliasFano.encode(self.diff_offs).num_bytes()),
            "diff_pct": round(100.0 * self.diff_stream.nbytes / total, 2),
            "diff_size_distribution": hist.tolist(),
        }


# --------------------------------------------------------------------------
# meta-differential
# --------------------------------------------------------------------------


class MetaDiffStore:
    """Meta structure whose per-set GLOBAL partial-id lists are chain-diff
    coded by the same DiffStore machinery used for plain color sets; the
    partials themselves are interned per partition and hybrid-coded in
    partition-relative space (as in MetaStore).

    Design difference vs the reference meta-differential codec
    (include/color_sets/meta_differential.hpp): the reference diff-codes
    partial CONTENTS per partition and deduplicates partition-id lists
    ("partition sets"). After vectorized interning our partial payloads are
    1-2% of the store while the per-set meta reference stream dominates, so
    the chain diff attacks the meta VECTORS themselves: two sets sharing
    most partials store only their few differing global partial ids. This
    subsumes the partition-set dedup (identical partition lists contribute
    nothing to a chain diff)."""

    kind = KIND_META_DIFF

    def __init__(self, num_colors, partition_bounds, partial_stores,
                 partial_base, meta_diff):
        self.num_colors = int(num_colors)
        self.partition_bounds = partition_bounds
        self.partial_stores = partial_stores  # list[HybridStore], rel space
        self.partial_base = partial_base  # (P+1,) global partial-id bases
        self.meta_diff = meta_diff  # DiffStore over global-id lists

    @classmethod
    def build(cls, cat, offs, num_colors, partition_bounds, set_labels,
              order_features=None):
        """cat/offs: sets with colors already permuted (sorted per set);
        set_labels: cluster id per set for the meta-level chain order;
        order_features: color-space similarity features for the chain order
        (the partial-id lists the chain diffs operate on carry no locality,
        so ordering must come from color space)."""
        P = len(partition_bounds) - 1
        it = intern_partials(cat, offs, num_colors, partition_bounds)
        stores = []
        for p in range(P):
            psize = int(partition_bounds[p + 1] - partition_bounds[p])
            lo = int(it["partial_base"][p])
            hi = int(it["partial_base"][p + 1])
            po = (
                it["plists_offs"][lo : hi + 1] - it["plists_offs"][lo]
            ).astype(np.int64)
            pc = it["plists_cat"][it["plists_offs"][lo] : it["plists_offs"][hi]]
            stores.append(HybridStore.build(pc.astype(np.uint32), po, psize))
        total_partials = int(it["partial_base"][-1])
        md = DiffStore.build(
            it["occ_global"].astype(np.uint32),
            it["meta_offs"],
            max(1, total_partials),
            np.asarray(set_labels, dtype=np.int64),
            order_features=order_features,
        )
        return cls(
            num_colors,
            np.asarray(partition_bounds, dtype=np.int64),
            stores,
            it["partial_base"],
            md,
        )

    @property
    def num_color_sets(self) -> int:
        return self.meta_diff.num_color_sets

    def decode_all(self):
        # decode every partition's partials once (absolute color space)
        pcat_all, offs_per_store = [], []
        for p, st in enumerate(self.partial_stores):
            c, o = st.decode_all()
            pcat_all.append(c.astype(np.int64) + int(self.partition_bounds[p]))
            offs_per_store.append(o)
        sizes = np.concatenate(
            [o[1:] - o[:-1] for o in offs_per_store]
        ) if offs_per_store else np.empty(0, np.int64)
        gcat = np.concatenate(pcat_all) if pcat_all else np.empty(0, np.int64)
        goffs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        idcat, idoffs = self.meta_diff.decode_all()
        ids = idcat.astype(np.int64)
        n = len(idoffs) - 1
        id_sizes = sizes[ids] if len(ids) else np.empty(0, np.int64)
        cat2 = gcat[seg_gather_idx(goffs[ids], id_sizes)].astype(np.uint32)
        set_sizes = np.add.reduceat(
            id_sizes, np.minimum(idoffs[:-1], max(0, len(ids) - 1))
        ) if n and len(ids) else np.zeros(max(0, n), np.int64)
        set_sizes = np.where(
            (idoffs[1:] - idoffs[:-1]) == 0, 0, set_sizes
        ) if n else set_sizes
        offs2 = np.concatenate([[0], np.cumsum(set_sizes)]).astype(np.int64)
        return cat2, offs2

    def arrays(self):
        arrays = {
            "partition_bounds": self.partition_bounds.astype(np.int64),
            "partial_base": np.asarray(self.partial_base, dtype=np.int64),
        }
        extra = {
            "format": "meta-chain",
            "num_colors": self.num_colors,
            "num_partitions": len(self.partial_stores),
        }
        a, e = self.meta_diff.arrays()
        for k, v in a.items():
            arrays["md_" + k] = v
        extra["md"] = e
        for p, st in enumerate(self.partial_stores):
            a, e = st.arrays()
            for k, v in a.items():
                arrays[f"p{p}_{k}"] = v
            extra[f"p{p}"] = e
        return arrays, extra

    @classmethod
    def from_arrays(cls, extra, get):
        if extra.get("format") != "meta-chain":
            raise ValueError(
                "meta-differential store predates the meta-chain layout; "
                "re-run `color` to rebuild this index"
            )
        P = extra["num_partitions"]
        stores = [
            HybridStore.from_arrays(extra[f"p{p}"], lambda name, p=p: get(f"p{p}_{name}"))
            for p in range(P)
        ]
        md = DiffStore.from_arrays(extra["md"], lambda name: get("md_" + name))
        return cls(
            extra["num_colors"],
            get("partition_bounds"),
            stores,
            get("partial_base"),
            md,
        )

    def num_bytes(self) -> int:
        n = self.partition_bounds.nbytes + np.asarray(self.partial_base).nbytes
        n += self.meta_diff.num_bytes()
        for st in self.partial_stores:
            n += st.num_bytes()
        return int(n)

    def stats(self) -> dict:
        """Partial vs meta space split (role of the reference
        meta_differential::print_stats, src/color_sets.cpp:242-265)."""
        partial_bytes = sum(st.num_bytes() for st in self.partial_stores)
        meta_bytes = self.meta_diff.num_bytes()
        total = max(1, self.num_bytes())
        return {
            "partitions": len(self.partial_stores),
            "total_partials": int(np.asarray(self.partial_base)[-1]),
            "partial_color_sets_bytes": int(partial_bytes),
            "meta_chain_bytes": int(meta_bytes),
            "partial_pct": round(100.0 * partial_bytes / total, 2),
            "meta_pct": round(100.0 * meta_bytes / total, 2),
            "meta_chain": self.meta_diff.stats(),
        }


STORE_CLASSES = {
    KIND_HYBRID: HybridStore,
    KIND_META: MetaStore,
    KIND_DIFF: DiffStore,
    KIND_META_DIFF: MetaDiffStore,
}
