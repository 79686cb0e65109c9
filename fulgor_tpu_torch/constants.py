"""Global constants.

Mirrors the semantic constants of the reference (include/util.hpp:19-37,
include/color_sets/hybrid.hpp:20-21) without copying its code: the hybrid
codec density thresholds and the index-kind registry are behavioral contracts
that queries depend on.
"""

# Hybrid color-set codec density thresholds (fractions of num_colors).
# size < SPARSE_FRAC * N            -> delta-gap list
# size < VERY_DENSE_FRAC * N        -> N-bit bitmap
# otherwise                         -> complemented delta-gap list
SPARSE_FRAC = 0.25
VERY_DENSE_FRAC = 0.75

# Index kinds (reference: enum index_t, include/util.hpp:18).
KIND_HYBRID = "hybrid"
KIND_META = "meta"
KIND_DIFF = "diff"
KIND_META_DIFF = "meta_diff"

# File extensions for serialized indexes (ours; the reference uses
# .fur/.mfur/.dfur/.mdfur -- include/util.hpp:26-29).
EXT = {
    KIND_HYBRID: ".tfur",
    KIND_META: ".tmfur",
    KIND_DIFF: ".tdfur",
    KIND_META_DIFF: ".tmdfur",
}
KIND_FROM_EXT = {v: k for k, v in EXT.items()}

# Per-set encodings inside a codec stream (reference: enum encoding_t).
ENC_DELTA_GAPS = 0
ENC_BITMAP = 1
ENC_COMPLEMENT_DELTA_GAPS = 2
ENC_SYMMETRIC_DIFFERENCE = 3

# Defaults (reference build_configuration, include/util.hpp:39-72).
DEFAULT_K = 31
DEFAULT_M = 20
DEFAULT_RAM_GIB = 8

# 2-bit nucleotide codes. Complement(x) = 3 - x.
BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
BASES = "ACGT"

# Sentinel for "no hit" / padding in device arrays (fits uint32).
INVALID_U32 = 0xFFFFFFFF
