#!/usr/bin/env python3
"""Drive fulgor_tpu_torch's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--genomes 512] [--reads 250000] [--seed 27]
                          [--parent DIR]

Phases, each printing its own lines; any failure exits non-zero before the
last line, which is printed only when every phase passed:

  1. device   a CUDA card is required; its name and power limit as
              nvidia-smi reports them.
  2. build    the CUDA kernels (csrc/*.cu, one nvcc per source in
              parallel; each kernel's registers, static shared memory and
              spills from nvcc -Xptxas -v) and the native host library,
              from this checkout; with --parent DIR also DIR's kernels
              (another commit, unpacked with git archive).
  3. index    a pansal4546-calibrated pangenome (fulgor_tpu's bench.py
              simulator settings) cut to --genomes genomes, built at k=31,
              m=19 into a temporary directory removed at exit; 150 bp reads
              at 0.5% errors sampled from every 16th genome. Then the
              --dict cuckoo dictionary of the same ccdBG (build_kmer_dict
              over its unitig text, no second ccdBG build), saved and
              loaded back.
  4. kernels  one full batch of real reads (B=32768, W=160): each kernel
              against its plain PyTorch version, bit for bit (tolerance 0),
              K4 at tau 0.8 and 1.0 (where it must also equal K3), K6 (with
              and without its hit words, which must equal K13's plain
              version's) at run budgets 2, 16, 32, Wk, 2 Wk and the
              engine's three, and K6 and K13 on seeded edge batches (Wk 1,
              31, 32, 33, 130, 257 and 1,024, B 1, 8,191 and 32,768, rows
              all negative, all positive, of one csid and of alternating
              csids, run budgets 1 to 2 Wk), K7 also
              against K2 at the redo budget on every window K2 decides and
              on seeded edge batches (k 15 and 31, W 32, 160 and 1,024, 777
              reads, 16 of them all N; k = 15 on a table of the first 4 Mbp
              of the unitig text's 15-mers), K8
              also against the host packer's bytes and on seeded edge
              batches (L 1, 15, 16, 17, 31, 32, 33, 160 and 1,024, B 1, 7
              and 32,768, codes 0 to 255, each batch also from rows that
              start at an odd byte offset; at L % 32 == 0 also against the
              host packer's bytes), timed at phase 4's batch and at the v1
              lookup's piece width, 1,024 (with --parent in turns with
              DIR's K8), with
              times (kernels: median device time per launch from
              torch.profiler, with L2 flushed before each launch and warm;
              plain versions: CUDA events) and bounds; then K4 and K5 on
              4,096 of the batch's reads against a seeded random dense
              matrix of 4,546 colours (the reference's Salmonella width),
              and on the same reads at 65,536 colours (C32 = 2,048,
              fulgor_tpu's huge-colour demo; random words, pad bits too):
              K3, K4 at tau 0.8 and 1.0 (equal to K3 at 1.0) and K5 at
              65,536 and 65,519 colours, K9 at T 1 and 64 on K3's rows,
              K4's rows and seeded edge rows, all bit for bit, each timed
              cold L2 and warm beside its byte bound (K9 on K4's rows at
              T 64), its plain version timed once on the checked call;
              query_runs_tu_packed against its plain composition. K7 is
              also timed against a table of the first 2 Mbp of the text's
              k-mers, which L2 holds, on reads cut from that text; with
              --parent it is timed in turns with DIR's K7. K6 is timed at
              the kmer-conservation, --deduplicate and runs fetch budgets
              and at one (2, 2) grid cell's shape, with and without hit
              words; with --parent in turns with DIR's K6 (the hit-word
              instance against DIR's K6 then K13).
  5. e2e      on the card over every read, each path with the launch counts
              reset just before each timed run and checked just after:
              FI pseudoalign_file (a warm-up, two timed runs to /dev/null,
              cut from five to make room for phases 9, 5b and 5c, median
              and spread, a
              profiled run for the card's busy share,
              a run to a file); TU pseudoalign_file at tau 0.8 (a timed
              run, a profiled run, an ascii and a binary run to files,
              which must hold the same records); kmer_matches_file (a
              timed run, a run to a file); kmer_conservation_file and
              pseudoalign_file(deduplicate=True) (each a timed run, kc a
              profiled run, a run to a file, and a run to a file with the
              run budget forced to 2, which must be byte-identical to the
              first). After FI the engine is warm: the other tools' passes
              take no warm-up (cut, with their second timed runs, to make
              room for phases 9b and 4's 65,536 colours).
  5b. meta-diff  phase 3's index saved, converted to the meta-diff kind on
              the host (build/color_builder.convert with meta and diff),
              checked by check_conversion, saved and loaded back (seconds,
              and the colour store's bytes against the hybrid store's,
              logged); FI and TU(0.8) over every read on a QueryEngine of
              it, one pass each to a binary file, with phase 5's launch
              checks: each record's colour ids, which name the permuted
              colours, mapped through the filenames to phase 3's ids and
              sorted, every record must equal phase 5's.
  5c. multihost  two processes of `python -m fulgor_tpu_torch.cli
              pseudoalign --num-procs 2 --proc-id p --coordinator
              127.0.0.1:<free port> --device cuda:0 --verbose` on the saved
              index and every read (FI, ascii), one gloo process group:
              each must exit 0 within MULTIHOST_TIMEOUT_S having launched
              phase 5's FI kernels (its --verbose launch counts), each
              process's reads and seconds logged; process 0's merged file
              must be id-ascending and hold phase 5's FI records, and no
              fragment may be left.
  6. cuckoo   the same tools on a QueryEngine over the cuckoo index (FI: a
              warm-up, a timed run, with --parent four in turns with
              DIR's kernels, a profiled run; TU(0.8): a
              timed run; then each tool once to a file): every file must
              equal the mini engine's (pseudoalign records sorted by read
              id, kmer-matches and kmer-conservation byte for byte).
  7. mirror   the exact host mirror (lookup_host_exact) in spawned workers,
              once for every read any path redid and a seeded sample of
              2,000 others: the FI lists, the TU(0.8) lists, the
              kmer-matches positivity and counts and the kmer-conservation
              runs derived from its csids must equal the output files; the
              --deduplicate file must equal the FI file on every read.
  8. array    the array API on the mini engine over the reads' in-memory
              codes, each call once: pseudoalign_codes FI and TU(0.8) must
              equal the FI and TU files read by read,
              pseudoalign_codes_dedup must equal FI, window_csids_codes
              must equal the host mirror on phase 7's reads, and
              pseudoalign_codes FI on the cuckoo engine must equal FI.
  9. wide     a 4,546-colour index made from phase 3's (colour c stands for
              genome c % 512: each simulated genome 8 or 9 clonal isolates;
              the same dictionary, unitigs and colour-set ids), the
              large-colour regime of fulgor_tpu's engine. K9 against its
              plain version bit for bit on one batch's K3 rows at C32 =
              143 and on seeded edge rows, at T in {1, 3, 64}, and on
              seeded edge batches (C32 1, 31, 32, 33, 143 and 1,024, B 1,
              7 and 32,768, T 1, 3, 31, 32, 33, 64, 65 and 128: rows of
              exactly T - 1, T and T + 1 bits, the T-th bit in a chunk's
              last word and in the next chunk's first, all-ones, empty and
              bit-31-only rows); timed at T_LIST (with --parent in turns
              with DIR's K9), 1 and 3.
              (a) The default strategy, runs fetch: FI (no K3) and TU(0.8)
              (K4), each a timed run (FI's key cache emptied before each
              run), a profiled run and a run to a file;
              every record equal to the expansion (g -> g, g + 512, ...) of
              the read's record in phase 5's files, on every read, and to
              the host mirror on phase 7's reads. FI by the dense path
              (use_runs_fetch off: K3, its rows fetched), a timed run
              and a run to a file equal to the runs fetch's, which decides
              whether the runs fetch earns its place where the dense matrix
              is allowed.
              (b) The lists fetch forced (K3 or K4, then K9), FI and TU at
              T_LIST = 64 (the run to a file profiled) and 3: each file
              equal to (a)'s.
              (c) dense_max_bytes=0: FI, TU(0.8) (K6 runs, no K4) and
              --deduplicate with the dense matrix forbidden, each file equal
              to (a)'s; the card's peak memory logged.
  9b. huge    fulgor_tpu_torch.demo150k's own functions (imported, not
              copied) at 8,192 genomes (C32 = 256) and 4,096 reads in the
              temporary directory: its corpus, index and reads made, then
              (a) dense_max_bytes=0: FI by the runs fetch and TU by runs,
              the dense matrix never made on the host or the card; (b) the
              default strategy (the fetch it takes logged); (c) the
              meta-diff conversion in regime (a), where the host holds it.
              FI and TU(0.8) once each on engines made under
              FULGOR_SELFCHECK=1 (every read checked against the exact
              host mirror; (c) every 64th), each pass's launches reset
              just before it and checked just after against its path's
              kernels ((a) and (c): K1, K2 and K6, no K3, K4 or K9; (b) by
              its fetch); (b)'s and (c)'s records (c's colour ids mapped
              through the filenames) equal (a)'s read for read.
 10. probes   the opt-in probes. On phase 4's batch, bit for bit against
              the plain versions: K2's stage1 mode at vb 1 and 2 and its
              want_entry mode; K10 staged_probe at (2, 8, 4, 16) and
              (1, 8, 4, 2) (tier B2 and its overflow past B / 8 heavy
              reads), its light, heavy and past-B2 reads logged, and every
              window it decides equal to K2 at (8, 4); K11 anchored_probe
              at the default (RA, RU) and (4, 2), no hit in ovf and csid
              equal to K2's wherever both hit. Then K10 and K11 on seeded
              edge batches of reads cut from the unitig text, bit for bit:
              Wk 1, 31, 33, 130 and 1,024 (1,054 bases in two pieces of
              1,024 overlapping by k - 1) at 777 reads, B 1, 7 and 40,000
              at Wk 130 (BH = 5,000), an all-heavy batch; reads with no
              usable window, with more runs than RA and heavy reads past
              BH; K10 at (2, 8, 4, 16), (0, 8, 4, 1) and (2, 8, 4, Wk), K11
              at its defaults, (1, 1) and (Wk, Wk). Both probes timed whole
              (the device time of every kernel a call launches, K2's
              included, L2 cold and warm; and the call on the stream, launch
              gaps included), each of their own kernels beside its byte
              bound; with --parent in turns with DIR's K10 and K11, launched
              by DIR's own wrappers (parent, this, this, parent). End to
              end, FI and TU(0.8) under the staged probe
              (FULGOR_PROBE_BUDGET=2,8,4,16, a new engine) and the
              anchored one (pipeline.ANCHORED_PROBE on, restored after):
              the staged ones each a warm-up and a timed pass in turns
              with a one-pass pass of the same tool (with --parent one
              staged FI pass also in turns with DIR's kernels); every one
              a profiled pass to a file, which must hold phase 5's FI or
              phase 6's TU records (the anchored rate is that pass's).
 10b. k2-k5  K2, K3, K4 and K5 as redesigned for the card, bit for bit
              against their plain versions: K2 in its three modes at the
              engine's two budgets and at (0, 2) and (20, 4) (no verify;
              more than a slot row's 16 candidates), on phase 4's batch and
              on an odd count of lanes drawn from it; K3 on the batch at C32
              = 16 and against the wide index's rows (C32 = 143), on a (2,
              2) grid shard's runs (C32 = 8), and on seeded edge batches
              (C32 1, 8, 17, 143; Wk 1, 33, 130, 1,024; holes in hit,
              unmapped reads); K4 at tau 0.8 and 1.0 and K5 on the batch at
              C32 = 16 and against the wide rows (4,546 colours), and on the
              same edge batches with a ragged C = 32 C32 - 5 and one read
              whose every window is positive with one all-colour csid (its
              score Wk, 1,024 at the widest), K4 also at tau 0.01 (need 0).
              Then K2 at the engine's two budgets, in stage1 mode (K10's
              vb1) and want_entry mode (K11's budget), K3 at C32 = 16, 143
              and the shard width, and K4 (tau 0.8) and K5 at C32 = 16 and
              143, each timed cold L2 and warm with its byte bound (K2's
              counting the text rows of the first min(vb, cnt) candidates a
              lane, the count without them beside it); with --parent in
              turns with DIR's kernels (parent, this, this, parent). Last,
              TU(0.8) and kmer-matches passes (to /dev/null; with --parent
              one pass each in turns with DIR's kernels) and a profiled
              pass of each: the card's busy time and K4's or K5's share.
 11. mesh     the mesh query path (parallel/mesh.py) on the one card. (a)
              On phase 4's batch, bit for bit: K12 runs_scores over K6's
              runs at R = Wk, mask (tau 0.8) and u16 modes, on every colour
              shard of the 512-colour dense at P in {1, 2, 4} and of the
              4,546-colour one at P = 2; K13 pack_hits on K2's hits and
              csids, with and without narrowing; query_conservation_packed
              against its plain composition, launching K1, K2 and K13 once
              each (K13's launches in the last line); K12 also on seeded edge
              batches (C32 x R of 1 x 1, 1 x 1,024, 8 x 33, 8 x 130, 72 x
              130 and 143 x 1,024, a ragged C; reads of no valid run, of
              1-4 and more, scattered among INVALID slots, a csid that
              recurs; counts summing to 1,024 and past 2,047 and 65,535,
              K6's int16 and int32 ones, negative ones; npos 0 and past the
              table), mask mode at tau 0.01, 0.8 and 1.0 and u16 mode; the
              reads its truth table takes logged. K12 timed at a (2, 2)
              grid's shape (one data row's reads, shard 0 of 2) in mask and
              u16 mode, with --parent in turns with DIR's K12 and also on
              the 4,546-colour index's shard 0 of 2; K13 at one cell's
              shape, with and without narrowing, with --parent in turns
              with DIR's K13.
              (b) QueryEngine on a (2, 2) grid of four cells on this card
              and with use_mesh=True (a (1, 1) grid): FI, TU(0.8),
              --deduplicate, kmer-matches and kmer-conservation once each
              to a file, pseudoalign records equal to phase 5's sorted by
              read id, kmer-matches and -conservation byte for byte; each
              batch four launches (one on (1, 1)) of K1, K2 and K6 and of
              K3 or K12, the TU and kmer-matches redo batches as many
              (their redo runs the mesh's step, never K4 or K5), and no
              K13 (kmer-matches takes its hit words from K6); FI and
              TU(0.8) on (2, 2) also a warm-up, a timed pass in
              turns with a one-device pass of the same tool, and a
              profiled pass; with --parent TU(0.8) and kmer-matches on
              (2, 2) four passes each in turns with DIR's kernels (DIR's
              own kmer-matches step, which launched K13); a profiled
              kmer-matches pass on (2, 2), with --parent DIR's too; the
              array API's FI and TU(0.8) on the (2, 2)
              grid, read for read equal to phase 8's.
              (c) the 4,546-colour index on the (2, 2) grid: runs fetch
              FI, dense FI (K3 on 72-word shards) and TU(0.8) (K12), each
              file equal to phase 9's. (d) cuckoo FI on the (2, 2) grid,
              its file equal to phase 6's. No meshed engine ever holds
              the whole dense matrix.
 12. v1       the v1 minimizer dictionary (ops/minidict.py) of phase 3's
              unitigs: built on the host (seconds, NE, NB, bytes and bytes
              a k-mer logged), its tables put on the card once; its lookup
              (K8 -> K1 -> K14 minidict_v1_verify) on phase 4's batch at
              max_candidates 4 and 8, on phase 7's mirror reads and on 64
              seeded reads of 3,000 bases cut from the unitig text (in
              pieces of 1,024 overlapping by k - 1), the launch counts
              reset just before and checked just after (one K8, K1 and K14
              a call, nothing else). Each result equal to the plain
              version on the card bit for bit (the long reads' to the
              unsplit one), the ovf windows logged; K14 alone against its
              plain version on the same K1 fields, and timed as phase 4
              times the others; at 8 candidates K14 equal to K2 at the
              redo budget on every window both decide (two dictionaries
              over one ccdBG) and to the host mirror on every window it
              decides.
 13. cards    only where more than one card is visible (a line says it was
              not run on one): phase 11's (2, 2) grid over four distinct
              cards (make_mesh()'s default grid where fewer): FI, TU(0.8)
              and kmer-matches once each to a file equal to phase 5's,
              every card launching K1, K2, K6 and K3 in a profiled FI pass,
              FI timed in turns with one card; then QueryEngine(idx) with
              no device named (the default mesh over every card), FI and
              TU(0.8) to files equal to phase 5's; then phase 5c's two
              processes of the CLI with no --device, each on a card of its
              own (one card a process where processes share a host), the
              merged file phase 5's FI records. `--cards-only` runs
              phases 1-3, phase 5's FI, TU and kmer-matches on the first
              card, and this phase.

The line before the last is one JSON object of per-kernel numbers; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import ctypes as ct
import dataclasses
import json
import multiprocessing
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fulgor_tpu_torch.build.builder import (
    build_index, build_kmer_dict, unitig_kmers,
)
from fulgor_tpu_torch.build.color_builder import check_conversion, convert
from fulgor_tpu_torch.constants import INVALID_U32
from fulgor_tpu_torch.core.kmers import unpack2
from fulgor_tpu_torch.index import Index
from fulgor_tpu_torch.io.simulate import (
    simulate_pangenome_blocks, simulate_reads, write_fastq,
)
from fulgor_tpu_torch.native import lib as native
from fulgor_tpu_torch.ops import kernels
from fulgor_tpu_torch.ops.hostpack import pack_reads_host
from fulgor_tpu_torch.core.colorstores import HybridStore
from fulgor_tpu_torch.ops.intersect import (
    compact_runs, compact_runs_plain, fi_and, fi_and_plain, first_set_bits,
    first_set_bits_plain, km_scores, km_scores_plain, pack_hits,
    pack_hits_plain, runs_mask, runs_mask_plain, runs_scores,
    runs_scores_plain, tu_mask, tu_mask_plain,
)
from fulgor_tpu_torch.ops.lookup import (
    cuckoo_lookup, cuckoo_lookup_plain, cuckoo_row_gathers,
)
from fulgor_tpu_torch.ops import pipeline as pipeline_mod
from fulgor_tpu_torch.ops.anchored import (
    _run_bounds, minidict2_anchored_probe, minidict2_anchored_probe_plain,
)
from fulgor_tpu_torch.ops.minidict import (
    V1_FIELDS, _text_kmer, build_minidict, lookup_minidict_batch_plain,
    minidict_v1_verify, minidict_v1_verify_plain,
)
from fulgor_tpu_torch.ops.minidict2 import (
    SKEW_CAND, VERIFY_BUDGET, anchor_budget, lookup_host_exact,
    reprobe_budget,
)
from fulgor_tpu_torch.ops.prep import (
    MAX_WIDTH, PREP_FIELDS, pack_codes, pack_codes_plain, window_prep,
    window_prep_plain,
)
from fulgor_tpu_torch.ops.pipeline import (
    query_conservation_packed, query_runs_tu_packed, query_window_csids_packed,
)
from fulgor_tpu_torch.parallel.mesh import make_mesh, pad_bits_for_mesh
from fulgor_tpu_torch.ops.probe import (
    minidict2_probe, minidict2_probe_plain, prep_of_lanes, probe_lanes,
)
from fulgor_tpu_torch.ops.staged import (
    minidict2_staged_probe, minidict2_staged_probe_plain,
)
from fulgor_tpu_torch.ops.u32 import mix32, mulhi32, u32
from fulgor_tpu_torch.query import engine as engine_mod
from fulgor_tpu_torch.query.engine import QueryEngine, conservation_runs

# fulgor_tpu bench.py:53-55: the pansal4546 calibration (4,546 Salmonella
# genomes in the reference's published index) of the block simulator
PANSAL = dict(num_genes=480, gene_len=2500, core_frac=0.6, loss_rate=0.03,
              mut_per_branch=65, ancestral_mut_frac=0.075,
              gain_per_branch=18, gain_len=2500, pool_genes=9000)
FULL_GENOMES = 4546
K, M = 31, 19
READ_LEN, WIDTH, BATCH = 150, 160, 32768
# NVIDIA's H100 SXM data sheet at 700 W: HBM3 bandwidth, and the fp32 rate
# outside the tensor cores, the nearest published rate for integer work
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
REPS_KERNEL, REPS_PLAIN = 20, 3
# recordings a kernel's timing may take, and the idle time each leaves on
# the card before its first timed launch and after its last: late in a
# run the profiler often drops the first launches of a recording (42
# recordings discarded in one whole run; once eight in a row, with no
# idle time). The idle time doubles with each recording discarded; where
# none of them holds every launch, CUDA events time the calls instead.
PROFILE_ATTEMPTS = 8
PROFILE_GUARD_S, PROFILE_GUARD_MAX_S = 0.02, 0.32
# FI's timed passes were cut from five to three to make room for phase 9;
# FI's, TU's, kmer-matches', kmer-conservation's and --deduplicate's to
# two to make room for phases 5b and 5c (with CUCKOO_PASSES, WIDE_PASSES,
# PROBE_PASSES, MESH_PASSES and E2E_PROFILES, at least as many seconds of
# timed passes as the two phases take: PERF.md §4 and §6)
# TU's, kmer-matches', kmer-conservation's and --deduplicate's to one, and
# their warm-ups and phase 9's (a) warm-ups taken out, to make room for
# phase 9b and phase 4's 65,536 colours (the engine is warm from FI's)
E2E_PASSES, TU_PASSES, KM_PASSES, KC_PASSES, DEDUP_PASSES = 2, 1, 1, 1, 1
TAU = 0.8
# the reference's Salmonella index: 4,546 genomes (C32 = 143)
WIDE_C, WIDE_READS = 4546, 4096
# phase 9b: fulgor_tpu_torch.demo150k cut to these genomes and reads (its
# regime (b) takes the lists fetch from about 8,192 genomes on, where the
# index's ekpu falls under 8, as at 65,536)
HUGE_GENOMES, HUGE_READS = 8192, 4096
# the self-check's period in its regime (c), whose records are held against
# regime (a)'s read for read (the host mirror takes some 3-4 ms a read)
HUGE_SELFCHECK_C = 64
# fulgor_tpu's huge-colour demo (scripts/demo150k.py): 65,536 genomes, C32
# = 2,048; the ragged width K4 and K5 also take there, and K9's list
# lengths
HUGE_C, HUGE_RAGGED, HUGE_T = 65536, 17, (1, 64)
# the kernels each path must launch, and those it must not (no path of
# the 512-colour engines takes the lists fetch, K9)
MINI, CUCKOO = ("window_prep", "minidict2_probe"), ("cuckoo_lookup",)
K9 = ("first_set_bits",)
PATH_KERNELS = {
    "fi": (MINI + ("fi_and",), CUCKOO + ("pack_codes",) + K9),
    "tu": (MINI + ("tu_mask",), CUCKOO + ("fi_and", "pack_codes") + K9),
    "km": (MINI + ("km_scores",), CUCKOO + ("pack_codes",) + K9),
    "kc": (MINI + ("compact_runs",),
           CUCKOO + ("fi_and", "tu_mask", "km_scores", "pack_codes") + K9),
    "dedup": (MINI + ("compact_runs",),
              CUCKOO + ("fi_and", "tu_mask", "km_scores", "pack_codes") + K9),
    "cuckoo_fi": (CUCKOO + ("fi_and",), MINI + ("pack_codes",) + K9),
    "cuckoo_tu": (CUCKOO + ("tu_mask",), MINI + ("fi_and", "pack_codes") + K9),
    "cuckoo_km": (CUCKOO + ("km_scores",), MINI + ("pack_codes",) + K9),
    "cuckoo_kc": (CUCKOO + ("compact_runs",), MINI + ("pack_codes",) + K9),
    "cuckoo_dedup": (CUCKOO + ("compact_runs",),
                     MINI + ("pack_codes",) + K9),
    "array_fi": (("pack_codes",) + MINI + ("fi_and",), CUCKOO + K9),
    "array_tu": (("pack_codes",) + MINI + ("km_scores",),
                 CUCKOO + ("fi_and", "tu_mask") + K9),
    "array_dedup": (("pack_codes",) + MINI, CUCKOO + ("fi_and",) + K9),
    "array_csids": (("pack_codes",) + MINI, CUCKOO + ("fi_and",) + K9),
    "array_fi_cuckoo": (("pack_codes",) + CUCKOO + ("fi_and",), MINI + K9),
    # phase 9, the 4,546-colour index: (a) runs fetch FI (no K3), TU by K4,
    # and FI by the dense path (K3, its rows fetched) beside it; (b) the lists fetch, K3 or K4 then K9; (c) no dense matrix: FI, TU
    # and --deduplicate on K6 alone
    "wide_fi": (MINI + ("compact_runs",),
                CUCKOO + ("fi_and", "tu_mask", "km_scores", "pack_codes")
                + K9),
    "wide_tu": (MINI + ("tu_mask",),
                CUCKOO + ("fi_and", "compact_runs", "km_scores", "pack_codes")
                + K9),
    "wide_dense_fi": (MINI + ("fi_and",),
                      CUCKOO + ("tu_mask", "compact_runs", "km_scores",
                                "pack_codes") + K9),
    "wide_lists_fi": (MINI + ("fi_and",) + K9,
                      CUCKOO + ("tu_mask", "compact_runs", "km_scores",
                                "pack_codes")),
    "wide_lists_tu": (MINI + ("tu_mask",) + K9,
                      CUCKOO + ("fi_and", "compact_runs", "km_scores",
                                "pack_codes")),
}
for _p in ("wide_nd_fi", "wide_nd_tu", "wide_nd_dedup"):
    PATH_KERNELS[_p] = PATH_KERNELS["wide_fi"]
# phase 10: the opt-in probes, K10 and K11, which no other path launches
PROBES = ("staged_probe", "anchored_probe")
for _p, (_need, _forbid) in list(PATH_KERNELS.items()):
    PATH_KERNELS[_p] = (_need, _forbid + PROBES)
for _probe, _other in (("staged", "anchored_probe"),
                       ("anchored", "staged_probe")):
    PATH_KERNELS[f"{_probe}_fi"] = (
        MINI + (f"{_probe}_probe", "fi_and"),
        CUCKOO + (_other, "tu_mask", "km_scores", "compact_runs",
                  "pack_codes") + K9)
    PATH_KERNELS[f"{_probe}_tu"] = (
        MINI + (f"{_probe}_probe", "tu_mask"),
        CUCKOO + (_other, "fi_and", "km_scores", "compact_runs",
                  "pack_codes") + K9)
# phase 11: the mesh's kernel, which no earlier path launches, and its
# paths; MESH_EXACT: the kernels a path launches once a cell a batch (the
# probe's K1/K2 at least that: the redo pools add theirs). K13 runs on no
# engine path: the mesh's kmer-matches takes its hit words from K6's
# launch (query_conservation_packed, which no engine path calls, still
# launches K13); the parent's mesh kmer-matches step (--parent) launched it
MESHK, K13 = ("runs_scores",), ("pack_hits",)
for _p, (_need, _forbid) in list(PATH_KERNELS.items()):
    PATH_KERNELS[_p] = (_need, _forbid + MESHK + K13)
_NOT_MESH = CUCKOO + ("pack_codes",) + K9 + PROBES
PATH_KERNELS.update({
    "mesh_fi": (MINI + ("compact_runs", "fi_and"),
                _NOT_MESH + ("tu_mask", "km_scores") + MESHK + K13),
    # TU's and kmer-matches' redo pools run the mesh's own steps too
    "mesh_tu": (MINI + ("compact_runs",) + MESHK,
                _NOT_MESH + ("fi_and", "tu_mask", "km_scores") + K13),
    "mesh_km": (MINI + ("compact_runs",) + MESHK,
                _NOT_MESH + ("fi_and", "tu_mask", "km_scores") + K13),
    # the parent's own step: an older one launched K13 after K6, a newer
    # one takes K6's hit words, so K13 is neither needed nor forbidden
    "mesh_km_parent": (MINI + ("compact_runs",) + MESHK,
                       _NOT_MESH + ("fi_and", "tu_mask", "km_scores")),
    "mesh_kc": (MINI + ("compact_runs",),
                _NOT_MESH + ("fi_and", "tu_mask", "km_scores") + MESHK
                + K13),
    "mesh_cuckoo_fi": (CUCKOO + ("compact_runs", "fi_and"),
                       MINI + ("pack_codes", "tu_mask", "km_scores") + K9
                       + PROBES + MESHK + K13),
})
PATH_KERNELS["mesh_dedup"] = PATH_KERNELS["mesh_wide_fi"] = (
    PATH_KERNELS["mesh_kc"])
PATH_KERNELS["mesh_wide_dense_fi"] = PATH_KERNELS["mesh_array_fi"] = (
    PATH_KERNELS["mesh_fi"])
PATH_KERNELS["mesh_wide_tu"] = PATH_KERNELS["mesh_array_tu"] = (
    PATH_KERNELS["mesh_tu"])
# phase 12: the v1 dictionary's lookup, K8 -> K1 -> K14, which no other
# path launches
V1K = ("minidict_v1_verify",)
for _p, (_need, _forbid) in list(PATH_KERNELS.items()):
    PATH_KERNELS[_p] = (_need, _forbid + V1K)
PATH_KERNELS["v1"] = (("pack_codes", "window_prep") + V1K,
                      tuple(n for n in kernels.launches
                            if n not in ("pack_codes", "window_prep") + V1K))
# phases 5b and 5c: the meta-diff index's FI and TU passes and each
# process of the two-process FI take phase 5's paths
PATH_KERNELS["meta_diff_fi"] = PATH_KERNELS["fi"]
PATH_KERNELS["meta_diff_tu"] = PATH_KERNELS["tu"]
MULTIHOST_PROCS, MULTIHOST_TIMEOUT_S = 2, 300
MESH_EXACT = {
    "mesh_fi": ("compact_runs", "fi_and"),
    "mesh_tu": ("compact_runs", "runs_scores"),
    "mesh_km": ("compact_runs",) + MESHK,
    "mesh_km_parent": ("compact_runs",) + MESHK,
    "mesh_kc": (),  # its inline redo runs K6 too
    "mesh_dedup": ("compact_runs",),
    "mesh_wide_fi": ("compact_runs",),
    "mesh_wide_dense_fi": ("compact_runs", "fi_and"),
    "mesh_wide_tu": ("compact_runs", "runs_scores"),
    "mesh_cuckoo_fi": ("cuckoo_lookup", "compact_runs", "fi_and"),
    "mesh_array_fi": ("compact_runs", "fi_and"),
    "mesh_array_tu": ("compact_runs", "runs_scores"),
}
# the paths whose redo pools run the mesh's colour step: each redo batch
# adds one launch a cell of their MESH_EXACT kernels
MESH_REDO = ("mesh_tu", "mesh_km", "mesh_km_parent", "mesh_wide_tu")
# K12's colour shards at 512 colours; the grid of four cells on one card
MESH_P, GRID = (1, 2, 4), (2, 2)
# (FI's and TU's timed passes on the grid cut from three to two to make
# room for K6's and K13's timing in turns and the profiled kmer-matches
# passes, then to one, each beside one one-device pass, with the cuckoo
# engine's from three to one, for phases 5b and 5c)
MESH_PASSES = 1
CUCKOO_PASSES = 1
# the run budget forced on kc and dedup for their overflow runs
FORCED_RUNS = 2
# phase 9: timed runs of each default path, and the list length forced on
# the lists fetch so that most reads take the row fetch
# (WIDE_PASSES cut from three to two with MESH_PASSES, then to one for
# phases 5b and 5c)
WIDE_PASSES, FORCED_T = 1, 3
# phase 10: K10's budgets (vb1, vb2, sc, RU), the second forcing tier B2
# and its overflow past BH heavy reads, the first the end-to-end one; K11's
# (RA, RU), None for anchor_budget/reprobe_budget; timed passes a path
STAGED_BUDGETS = ((2, 8, 4, 16), (1, 8, 4, 2))
ANCHORED_BUDGETS = ((None, None), (4, 2))
# (cut from three to two: the whole run must stay inside its clock; to
# one, each beside one one-pass pass, for phases 5b and 5c). The anchored
# probe has no timed pass (an anchored pass takes 10-15 s on a slow host;
# cut for phase 9b and phase 4's 65,536 colours): its rate is that of its
# profiled pass to a file, the pass whose records are checked
PROBE_PASSES = 1
# phase 12: the v1 lookup's candidate budgets (4, its default, is timed),
# and its long reads cut from the unitig text
V1_CANDIDATES = (4, 8)
V1_LONG_READS, V1_LONG_LEN = 64, 3000
# phase 10b: K2's edge budgets (no verify; more than the 16 candidates of
# a slot row) beside the engine's two, on the batch and on an odd count of
# lanes drawn from it; K3's seeded edge batches (C32, Wk) of EDGE_READS
# reads with holes in hit, unmapped reads and runs broken by misses
K2_EDGE_BUDGETS = ((0, 2), (20, 4))
K3_EDGE = ((1, 1), (1, 1024), (143, 1), (143, 1024), (8, 33), (17, 130))
EDGE_READS = 777
# K10's and K11's seeded edge batches (B, Wk) of reads cut from the first
# PROBE_EDGE_BASES bases of the unitig text (Wk + K - 1 bases; past
# MAX_WIDTH in two pieces, as the engine cuts a long read), and an
# all-heavy batch of EDGE_READS text reads at Wk 130; their budgets, "Wk"
# for the batch's Wk (K11's (None, None) its defaults)
PROBE_EDGE = ((EDGE_READS, 1), (EDGE_READS, 31), (EDGE_READS, 33),
              (EDGE_READS, 130), (EDGE_READS, 1024), (1, 130), (7, 130),
              (40_000, 130))
STAGED_EDGE = ((2, 8, 4, 16), (0, 8, 4, 1), (2, 8, 4, "Wk"))
ANCHORED_EDGE = ((None, None), (1, 1), ("Wk", "Wk"))
PROBE_EDGE_BASES = 4_000_000
# K12's seeded edge batches (C32, R) of EDGE_READS reads, with K6's int16
# counts and with int32 ones, and the length of their npos table; K7's
# edge shapes (k, W) of EDGE_READS reads, k = 15 on a table of the
# k-mers of the unitigs in the first K7_EDGE_BASES bases of the text; K7
# timed against a table of the first K7_L2_BASES bases' k-mers, which L2
# holds
K12_EDGE = ((1, 1), (1, 1024), (8, 33), (8, 130), (72, 130), (143, 1024))
# K6's and K13's seeded edge batches (B, Wk): Wk around a 32-window chunk
# and K6's group of eight chunks at 8,191 reads (an odd count of blocks of
# eight reads), one read, and phase 4's batch size
RUNS_EDGE = ((8191, 1), (8191, 31), (8191, 32), (8191, 33), (8191, 130),
             (8191, 257), (8191, 1024), (1, 130), (1, 1024), (32768, 130))
K12_EDGE_NPOS = 70_000
# K9's seeded edge batches: C32 around a 32-word chunk and past K9's group
# of eight chunks, one row, an odd count of rows and phase 4's batch, T
# around a group of 32 slots; K8's: L around a 16-base word and a 32-base
# piece, phase 4's width and the v1 lookup's piece, the same three B
K9_EDGE_C32 = (1, 31, 32, 33, 143, 1024)
K9_EDGE_T = (1, 3, 31, 32, 33, 64, 65, 128)
K8_EDGE_L = (1, 15, 16, 17, 31, 32, 33, 160, 1024)
EDGE_B = (1, 7, 32768)
K7_EDGE = ((31, 32), (31, 160), (31, 1024), (15, 32), (15, 160), (15, 1024))
K7_EDGE_BASES = 4_000_000
K7_L2_BASES = 2_000_000
# K4's edge thresholds (0.01: need 0 up to npos 99, every colour below C
# passes), and the colours a K4/K5 edge batch leaves out of its last word;
# the profiled TU and kmer-matches passes a tool may take (cut from two
# to one for phases 5b and 5c: in two whole runs on an H100 the second
# pass dropped the launches the first had dropped, 4 of 10 K4 and 10 of
# 16 K5)
K4_EDGE_TAUS = (0.01, TAU, 1.0)
EDGE_RAGGED = 5
E2E_PROFILES = 1
# csrc/union.cu kTable: K4 takes a read of at most this many runs by its
# truth table, a longer one bit-sliced
K4_TABLE_RUNS = 4


def log(msg):
    print(msg, flush=True)


def recording(body, attempt):
    """body() under torch.profiler's CUDA tracing, the card left idle for
    PROFILE_GUARD_S * 2 ** (attempt - 1) seconds, at most
    PROFILE_GUARD_MAX_S, before body's first launch and after its last,
    and a small memset first, so that no timed launch is the recording's
    first record. -> the profiler."""
    from torch.profiler import ProfilerActivity, profile

    guard = min(PROFILE_GUARD_S * 2 ** (attempt - 1), PROFILE_GUARD_MAX_S)
    lead = torch.zeros(64, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead.zero_()
        torch.cuda.synchronize()
        time.sleep(guard)
        body()
        torch.cuda.synchronize()
        time.sleep(guard)
    return prof


def event_ms(fn, reps, flush=None):
    """Milliseconds of each of `reps` calls of fn on the stream, CUDA
    events around it, launch gaps included; flush as in kernel_ms."""
    ts = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return ts


def kernel_ms(fn, name, reps, flush=None):
    """Median device milliseconds of one launch of kernel `name` over
    `reps` calls of fn after a warm-up, as torch.profiler records them.
    flush: a device buffer zeroed before each call, so that every launch
    starts with a cold L2. The wrapper's own count must show `reps`
    launches in each recording. The profiler now and then records fewer
    kernel events than were launched, most often the first of a recording
    missing: such a recording is discarded and the launches timed again in
    a new one (`recording`), up to PROFILE_ATTEMPTS recordings. Where no
    recording holds exactly `reps` launches, the median of `reps` calls
    timed with CUDA events (event_ms) is returned instead, and logged so.
    Raises where fn launches the kernel other than once a call."""
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = kernels.launches[name]
        prof = recording(body, attempt)
        launched = kernels.launches[name] - before
        if launched != reps:
            raise RuntimeError(f"{reps} calls made {launched} {name} launches")
        ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if f"{name}_kernel" in e.name]
        if len(ts) == reps:
            return statistics.median(ts)
        log(f"[kernels] {name}: the profiler recorded {len(ts)} of {reps} "
            f"launches (recording {attempt} of {PROFILE_ATTEMPTS}), "
            "discarded")
    before = kernels.launches[name]
    ts = event_ms(fn, reps, flush)
    if kernels.launches[name] - before != reps:
        raise RuntimeError(f"{reps} calls made "
                           f"{kernels.launches[name] - before} {name} launches")
    log(f"[kernels] {name}: no recording of {PROFILE_ATTEMPTS} held all "
        f"{reps} launches; timed with CUDA events around each call instead "
        "(launch gaps included)")
    return statistics.median(ts)


def time_ms(fn, reps):
    """Median milliseconds of `reps` timed calls (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over a tuple of outputs, u32 data compared
    as unsigned values."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            g, w = g.to(torch.int64), w.to(torch.int64)
        else:
            g, w = u32(g), u32(w)
        err = max(err, int((g - w).abs().max().item()) if g.numel() else 0)
    return err


def host_cpu() -> str:
    """The host CPU's model name, from /proc/cpuinfo or lscpu, else its
    architecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, val = ln.partition(":")
                if key.strip() in ("model name", "Model", "cpu model"):
                    return val.strip()
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        for ln in out.splitlines():
            key, _, val = ln.partition(":")
            if key.strip() == "Model name":
                return val.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return f"unknown {platform.machine()} CPU"


def phase_device():
    if not torch.cuda.is_available():
        log("FAIL device: torch.cuda.is_available() is false")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; host {host_cpu()}, "
        f"{os.cpu_count()} cores visible")
    return card


def kernel_resources(log_text):
    """(source, kernel, registers, static shared bytes, spill stores,
    spill loads) of each kernel in an nvcc -Xptxas -v log, names
    demangled where c++filt is found."""
    rows, src, fn, spill = [], None, None, (0, 0)
    for ln in log_text.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            sm = re.search(r"(\d+) bytes smem", ln)
            rows.append([src, fn, int(m.group(1)),
                         int(sm.group(1)) if sm else 0, *spill])
            fn = None
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(r[1] for r in rows),
                               capture_output=True, text=True).stdout
        for r, name in zip(rows, names.splitlines()):
            name = name.replace("(anonymous namespace)::", "")
            r[1] = re.sub(r"^void |\(.*", "", name)
    return [tuple(r) for r in rows]


def log_resources(tag, log_text, sources=None):
    for src, fn, regs, smem, st, ld in kernel_resources(log_text):
        if sources is None or src in sources:
            log(f"[{tag}]   {src} {fn}: {regs} registers, {smem} B static "
                f"shared, spill {st} B stores / {ld} B loads")


def phase_build():
    s = kernels.build_seconds()
    log(f"[build] CUDA kernels built in {s:.2f} s ({len(kernels.SOURCES)} "
        "sources, one nvcc each, in parallel); nvcc -Xptxas -v:")
    with open(os.path.join(kernels.BUILD, "build.log")) as f:
        log_resources("build", f.read())
    t0 = time.perf_counter()
    native._load()
    log(f"[build] native host library ready in "
        f"{time.perf_counter() - t0:.2f} s")


def parent_library(parent):
    """The kernel library of another checkout of this repository (--parent:
    an earlier commit unpacked with git archive), built from the sources of
    its csrc/ into its own _build/ and bound as this one, its C entries
    only: its K2-K9, K12 and K13 are timed in turns with this tree's
    (in_turns), and its kernels drive TU, kmer-matches, the mesh's TU and
    kmer-matches, cuckoo FI and staged FI passes in turns with this tree's
    (passes_in_turns). The C entry points that both trees define must take
    the same arguments, but for K10's and K11's, which the parent's own
    wrappers launch (parent_probes); the parent's mesh kmer-matches step
    is its own too (parent_mesh_km)."""
    pkg = os.path.join(os.path.abspath(parent), "fulgor_tpu_torch")
    csrc = os.path.join(pkg, "csrc")
    lib = os.path.join(pkg, "_build", "libfulgor_kernels.so")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    t0 = time.perf_counter()
    text = kernels.build(csrc, lib, sources)
    log(f"[build] the parent's kernels ({parent}) built in "
        f"{time.perf_counter() - t0:.2f} s; its K2-K13:")
    log_resources("build", text, ("probe.cu", "intersect.cu", "union.cu",
                                  "runs.cu", "hits.cu", "cuckoo.cu",
                                  "pack.cu", "lists.cu", "staged.cu",
                                  "anchored.cu"))
    defined = set()
    for f in sources:
        with open(os.path.join(csrc, f)) as fh:
            defined.update(re.findall(r'extern "C" int (\w+)\(', fh.read()))
    return kernels.bind(ct.CDLL(lib),
                        [n for n in kernels.ENTRIES if n in defined])


# the parent's K10 and K11 wrappers (parent_probes), which the engine's
# pipeline takes inside using_library(parent)
PARENT_PROBES = None


def parent_probes(parent):
    """DIR's own ops/staged.py and ops/anchored.py (their C entries take
    other arguments than this tree's), imported as a package of their own
    whose kernel library is the one parent_library built from DIR's csrc
    and whose launch counts are this tree's. -> (staged wrapper, anchored
    wrapper)."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(parent), "fulgor_tpu_torch")
    name = "parent_fulgor_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(f"{name}.ops.kernels").launches = kernels.launches
    return (importlib.import_module(f"{name}.ops.staged")
            .minidict2_staged_probe,
            importlib.import_module(f"{name}.ops.anchored")
            .minidict2_anchored_probe)


def parent_mesh_km():
    """The parent's make_sharded_kmer_matches, from the package that
    parent_probes imported (an older step launched K13 on each cell's hits
    after K6; its wrappers launch the parent's kernels), its outputs given
    as this tree's Blocks."""
    import importlib

    pm = importlib.import_module("parent_fulgor_tpu_torch.parallel.mesh")

    def make(*args, **kw):
        step = pm.make_sharded_kmer_matches(*args, **kw)
        return lambda *x: tuple(engine_mod.M.Blocks(o.blocks)
                                for o in step(*x))
    return make


PARENT_MESH_KM = None


def parent_mesh_km_pass(meng, fn):
    """fn() with the meshed engine meng's kmer-matches steps built by the
    parent's mesh (PARENT_MESH_KM), its own steps restored after."""
    keep, own = dict(meng._mesh_fns), engine_mod.M.make_sharded_kmer_matches
    meng._mesh_fns = {k: v for k, v in keep.items() if k[0] != "km"}
    engine_mod.M.make_sharded_kmer_matches = PARENT_MESH_KM
    try:
        return fn()
    finally:
        engine_mod.M.make_sharded_kmer_matches = own
        meng._mesh_fns = keep


@contextlib.contextmanager
def using_library(lib):
    """Launch every wrapper's kernel from `lib` inside the block (the
    parent's, for timing in turns), the launch counts as ever; the
    pipeline's K10 and K11 are the parent's wrappers there (PARENT_PROBES)
    when lib is not this tree's."""
    own = kernels.library()
    probes = (pipeline_mod.minidict2_staged_probe,
              pipeline_mod.minidict2_anchored_probe)
    with kernels._lock:
        kernels._lib = lib
    if PARENT_PROBES is not None and lib is not own:
        (pipeline_mod.minidict2_staged_probe,
         pipeline_mod.minidict2_anchored_probe) = PARENT_PROBES
    try:
        yield
    finally:
        with kernels._lock:
            kernels._lib = own
        (pipeline_mod.minidict2_staged_probe,
         pipeline_mod.minidict2_anchored_probe) = probes


def phase_index(tmp, genomes, num_reads, seed):
    t0 = time.perf_counter()
    paths = simulate_pangenome_blocks(os.path.join(tmp, "corpus"), genomes,
                                      seed=seed, **PANSAL)
    t1 = time.perf_counter()
    idx = build_index(paths, k=K, m=M)
    t2 = time.perf_counter()
    log(f"[index] pansal4546 calibration cut to {genomes} of {FULL_GENOMES} "
        f"genomes (build time): simulated in {t1 - t0:.1f} s, built in "
        f"{t2 - t1:.1f} s")
    codes, names = simulate_reads(paths[::16], num_reads, READ_LEN,
                                  seed=seed + 1)
    reads = os.path.join(tmp, "reads.fastq.gz")
    write_fastq(reads, codes, names)
    log(f"[index] {idx.num_kmers} k-mers, {idx.num_color_sets} colour sets, "
        f"{idx.num_colors} colours, {idx.num_unitigs} unitigs; "
        f"{num_reads} reads of {READ_LEN} bp from {len(paths[::16])} genomes "
        f"({time.perf_counter() - t2:.1f} s)")
    return idx, codes, names, reads


def phase_cuckoo_index(idx, tmp):
    """The --dict cuckoo index of phase 3's ccdBG (its unitig text, u2c
    and colour store; no second ccdBG build), saved and loaded back."""
    t0 = time.perf_counter()
    codes = unpack2(idx.unitig_seq, int(idx.unitig_offs[-1]))
    table, n = build_kmer_dict(codes, idx.unitig_offs, idx.u2c_csid, K)
    t1 = time.perf_counter()
    if n != idx.num_kmers:
        raise RuntimeError(f"cuckoo table holds {n} k-mers of {idx.num_kmers}")
    path = os.path.join(tmp, "cuckoo.tfur")
    dataclasses.replace(idx, dict_kind="cuckoo", dict_table=table,
                        mini_slots=None, mini_sec=None, mini_num_slots=0,
                        _mini_obj=None).save(path)
    cidx = Index.load(path)
    nb = len(cidx.dict_table)
    log(f"[index] cuckoo dictionary of the same ccdBG: built in "
        f"{t1 - t0:.1f} s, saved and loaded in {time.perf_counter() - t1:.1f}"
        f" s; nb {nb} (b = {nb.bit_length() - 1}), "
        f"{cidx.dict_table.nbytes} table bytes, load factor "
        f"{n / (2 * nb):.4f} ({n} k-mers in {2 * nb} slots)")
    return cidx


def in_turns(tag, name, what, nbytes, fn, flush, parent):
    """Kernel `name` at `what` timed cold L2 and warm (kernel_times) beside
    its byte bound; with `parent` (a kernel library, --parent) in turns
    with the parent's kernel: parent, this, this, parent. nbytes: (bytes,)
    or (bytes, bytes without text and pointer rows). -> this tree's (cold,
    warm) ms, the mean of its two turns with a parent."""
    bound = nbytes[0] / HBM_BYTES_PER_S * 1e3
    if parent is None:
        ms, warm = kernel_times(fn, name, flush)
        log(f"[{tag}] {name} at {what}: {ms:.4f} ms cold L2, {warm:.4f} "
            f"warm; bound {bound:.4f} ms ({nbytes[0] / 1e6:.1f} MB), "
            f"{bound / ms:.1%} of it cold")
        return ms, warm
    with using_library(parent):
        o1 = kernel_times(fn, name, flush)
    n1 = kernel_times(fn, name, flush)
    n2 = kernel_times(fn, name, flush)
    with using_library(parent):
        o2 = kernel_times(fn, name, flush)
    new, old = (n1[0] + n2[0]) / 2, (o1[0] + o2[0]) / 2
    log(f"[{tag}] {name} at {what}, in turns (parent, this, this, "
        f"parent): this tree {n1[0]:.4f}, {n2[0]:.4f} ms cold L2 "
        f"({n1[1]:.4f}, {n2[1]:.4f} warm); the parent's {o1[0]:.4f}, "
        f"{o2[0]:.4f} ({o1[1]:.4f}, {o2[1]:.4f} warm): "
        f"{old / new:.2f}x; "
        f"bound {bound:.4f} ms ({nbytes[0] / 1e6:.1f} MB"
        + (f"; {nbytes[1] / 1e6:.1f} MB without text and pointer rows"
           if len(nbytes) > 1 else "")
        + f"), {bound / new:.1%} of it cold (the parent "
        f"{bound / old:.1%})")
    return new, (n1[1] + n2[1]) / 2


def passes_in_turns(tag, path, fn, parent, parent_fn=None,
                    parent_path=None):
    """With `parent`, one timed pass of fn (timed_passes, its launches
    checked against PATH_KERNELS[path]) on the parent's kernels and on
    this tree's in turns: parent, this, this, parent; logs the two
    medians and their ratio. The parent's turn runs parent_fn where given,
    its launches checked against parent_path's. No reads/s is claimed from
    them: the card idles through most of a pass."""
    if parent is None:
        return
    rates = {"this": [], "parent": []}
    for who in ("parent", "this", "this", "parent"):
        if who == "parent":
            with using_library(parent):
                rates[who] += timed_passes(parent_path or path,
                                           parent_fn or fn, 1)[0]
        else:
            rates[who] += timed_passes(path, fn, 1)[0]
    new = statistics.median(rates["this"])
    old = statistics.median(rates["parent"])
    log(f"[{tag}] {path} passes in turns (parent, this, this, parent): this "
        f"tree {rates['this']}, the parent's {rates['parent']} reads/s: "
        f"{new / old:.3f}x")


def kernel_times(fn, name, flush):
    """(cold-L2 ms, warm ms) of one launch of kernel `name`: the first with
    `flush` zeroed before every launch, as on the main path, where each
    batch's K1 writes far more than L2 holds before K2 and K3 run; the
    second on the same inputs launched back to back."""
    return (kernel_ms(fn, name, REPS_KERNEL, flush),
            kernel_ms(fn, name, REPS_KERNEL))


def phase_kernels(idx, eng, ceng, codes, parent):
    dev = eng.device
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    n = min(BATCH, len(codes))
    chunk[:n, :READ_LEN] = codes[:n]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    slots, text32, skew = eng.table
    m, num_slots = eng.dparams
    Wk = WIDTH - K + 1
    lanes = BATCH * Wk
    # 256 MiB, five times the card's 50 MB L2
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []

    # K1
    prep = window_prep(c2, bd, width=WIDTH, k=K, m=M)
    plain = window_prep_plain(c2, bd, width=WIDTH, k=K, m=M)
    torch.cuda.synchronize()
    err1 = max_abs_err(prep, plain)
    bytes_in1 = BATCH * (WIDTH // 4 + WIDTH // 8)
    bytes1 = bytes_in1 + lanes * (9 * 4 + 3)
    ops1 = lanes * 150  # ~hash pair per m-mer, w-wide minimum, packings
    ms1, warm1 = kernel_times(
        lambda: window_prep(c2, bd, width=WIDTH, k=K, m=M), "window_prep",
        flush)
    rows.append(dict(
        name="window_prep", source="fulgor_tpu_torch/csrc/prep.cu",
        replaces="fulgor_tpu/ops/minidict2.py:1004", max_abs_err=err1,
        ms=ms1, warm_ms=warm1,
        plain_ms=time_ms(lambda: window_prep_plain(c2, bd, width=WIDTH, k=K,
                                                   m=M), REPS_PLAIN),
        bytes=bytes1, ops=ops1))
    # pL and pR (8 of the 39 bytes a lane) are written but read by nothing
    # on the main path: the bound of the outputs K2 reads
    bytes1_used = bytes_in1 + lanes * (7 * 4 + 3)
    log(f"[kernels] window_prep without pL/pR: {bytes1_used / 1e6:.1f} MB, "
        f"bound {bytes1_used / HBM_BYTES_PER_S * 1e3:.4f} ms")

    # K2 at the engine's budget, and at the redo budget
    prep = tuple(t.contiguous() for t in prep)
    kw = dict(k=K, m=m, num_slots=num_slots)
    errs2 = []
    for vb, sc in (eng._pb, eng._pb_redo):
        got = minidict2_probe(slots, text32, skew, prep, vb=vb, sc=sc, **kw)
        want = minidict2_probe_plain(slots, text32, skew, prep, vb=vb, sc=sc,
                                     **kw)
        torch.cuda.synchronize()
        errs2.append(max_abs_err(got, want))
        log(f"[kernels] minidict2_probe at ({vb}, {sc}): "
            f"{int(got[0].sum())} hits, {int(got[2].sum())} ovf lanes of "
            f"{lanes}, max_abs_err {errs2[-1]}")
    vb, sc = eng._pb
    hit, csid, _ovf = minidict2_probe(slots, text32, skew, prep, vb=vb, sc=sc,
                                      **kw)
    bytes2, old2, trows, gated = k2_bytes(eng.table, prep, kw, vb)
    log(f"[kernels] minidict2_probe's bytes at ({vb}, {sc}): "
        f"{bytes2 / 1e6:.1f} MB with the {trows} text rows of the first "
        f"min(vb, cnt) candidates a lane and the skew pointer rows of "
        f"{gated} gated lanes; {old2 / 1e6:.1f} MB without them (bound "
        f"{old2 / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    ops2 = lanes * 120  # screen of 8 slots, ~1-2 verifies, hash
    t_redo, t_redo_warm = kernel_times(lambda: minidict2_probe(
        slots, text32, skew, prep, vb=eng._pb_redo[0], sc=eng._pb_redo[1],
        **kw), "minidict2_probe", flush)
    ms2, warm2 = kernel_times(
        lambda: minidict2_probe(slots, text32, skew, prep, vb=vb, sc=sc, **kw),
        "minidict2_probe", flush)
    rows.append(dict(
        name="minidict2_probe", source="fulgor_tpu_torch/csrc/probe.cu",
        replaces="fulgor_tpu/ops/minidict2.py:1126", max_abs_err=max(errs2),
        ms=ms2, warm_ms=warm2,
        plain_ms=time_ms(lambda: minidict2_probe_plain(
            slots, text32, skew, prep, vb=vb, sc=sc, **kw), REPS_PLAIN),
        bytes=bytes2, ops=ops2))
    log(f"[kernels] minidict2_probe at the redo budget {eng._pb_redo}: "
        f"{t_redo:.4f} ms cold L2, {t_redo_warm:.4f} ms warm")

    # K3
    got = fi_and(eng.bits, hit, csid)
    want = fi_and_plain(eng.bits, hit, csid)
    torch.cuda.synchronize()
    C32 = eng.bits.shape[1]
    distinct = torch.unique(csid[hit]).numel()
    bytes3 = k3_bytes(hit, csid, C32)
    ms3, warm3 = kernel_times(lambda: fi_and(eng.bits, hit, csid), "fi_and",
                              flush)
    rows.append(dict(
        name="fi_and", source="fulgor_tpu_torch/csrc/intersect.cu",
        replaces="fulgor_tpu/ops/intersect.py:91",
        max_abs_err=max_abs_err((got,), (want,)), ms=ms3, warm_ms=warm3,
        plain_ms=time_ms(lambda: fi_and_plain(eng.bits, hit, csid),
                         REPS_PLAIN),
        bytes=bytes3, ops=lanes * C32))
    log(f"[kernels] fi_and: {int(got.ne(0).any(dim=1).sum())} of {BATCH} "
        f"reads non-empty, {distinct} distinct colour sets in the batch")
    fi_bits = got

    # K4 at tau 0.8 and 1.0, K5: each reads hit/csid once, one bit row per
    # distinct csid of the batch, and does one multiply-add per run of
    # equal csids and colour (the runs of this batch, counted here)
    C = idx.num_colors
    runs = count_runs(hit, csid)
    errs4 = []
    for tau in (TAU, 1.0):
        tab = eng._minscore_tab(tau, Wk)
        got = tu_mask(eng.bits, hit, csid, tab, C)
        want = tu_mask_plain(eng.bits, hit, csid, tab, C)
        torch.cuda.synchronize()
        errs4.append(max_abs_err((got,), (want,)))
        log(f"[kernels] tu_mask at tau {tau}: "
            f"{int(got.ne(0).any(dim=1).sum())} of {BATCH} reads map, "
            f"max_abs_err {errs4[-1]}")
    if not torch.equal(got, fi_bits):
        raise RuntimeError("tu_mask at tau 1.0 differs from fi_and")
    log("[kernels] tu_mask at tau 1.0 equals fi_and on the same hit/csid")
    tab = eng._minscore_tab(TAU, Wk)
    ms4, warm4 = kernel_times(
        lambda: tu_mask(eng.bits, hit, csid, tab, C), "tu_mask", flush)
    rows.append(dict(
        name="tu_mask", source="fulgor_tpu_torch/csrc/union.cu",
        replaces="fulgor_tpu/ops/intersect.py:106", max_abs_err=max(errs4),
        ms=ms4, warm_ms=warm4,
        plain_ms=time_ms(lambda: tu_mask_plain(eng.bits, hit, csid, tab, C),
                         REPS_PLAIN),
        bytes=lanes * 5 + distinct * C32 * 4 + (Wk + 1) * 4
        + BATCH * C32 * 4, ops=runs * C32 * 32 + BATCH * C32 * 32))
    got = km_scores(eng.bits, hit, csid, C)
    want = km_scores_plain(eng.bits, hit, csid, C)
    torch.cuda.synchronize()
    err5 = max_abs_err(got, want)
    ms5, warm5 = kernel_times(lambda: km_scores(eng.bits, hit, csid, C),
                              "km_scores", flush)
    rows.append(dict(
        name="km_scores", source="fulgor_tpu_torch/csrc/union.cu",
        replaces="fulgor_tpu/ops/pipeline.py:363", max_abs_err=err5,
        ms=ms5, warm_ms=warm5,
        plain_ms=time_ms(lambda: km_scores_plain(eng.bits, hit, csid, C),
                         REPS_PLAIN),
        bytes=lanes * 5 + distinct * C32 * 4 + BATCH * C * 2
        + BATCH * ((Wk + 31) // 32) * 4, ops=runs * C))
    log(f"[kernels] tu_mask/km_scores: {runs} runs of equal csids in the "
        f"batch ({runs / BATCH:.2f} a read), {C} colours")
    nr = runs_per_read(hit, csid)
    long = nr > K4_TABLE_RUNS
    log(f"[kernels] tu_mask takes {int((~long & (nr > 0)).sum())} reads of "
        f"1-{K4_TABLE_RUNS} runs by its truth table and "
        f"{int(long.sum())} ({float(long.float().mean()):.1%}) bit-sliced, "
        f"{float(nr[long].float().mean()) if long.any() else 0:.2f} runs "
        f"each, {int(nr[long].sum())} of the batch's {runs} runs")
    del flush
    huge_errs = phase_wide_c(eng, hit, csid)
    for r in rows:
        r["max_abs_err"] = max(r["max_abs_err"], huge_errs.get(r["name"], 0))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows.append(phase_runs(eng, hit, csid, flush, parent))
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"],
                                  phase_runs_tu(eng, c2, bd))
    rows += phase_cuckoo_pack(eng, ceng, chunk, c2, bd, prep, flush,
                              parent)
    del flush

    for r in rows:
        finish_row(r, "kernels")
    return rows, huge_errs


def k2_bytes(tabs, prep, kw, vb, out_bytes=6, skew=True):
    """K2's bytes on one batch of lanes at verify budget vb -> (bytes, the
    count without text and pointer rows, text rows, gated lanes): every
    lane's 31 B of prep read once and out_bytes written, one 96 B slot row
    a distinct bucket row of the usable lanes (the shorter count ends
    here), one 12 B text row for each of the first min(vb, cnt) candidates
    of a lane (as K14's bound counts its candidates' rows) and two 32 B
    skew pointer rows a lane the skew route takes (skew: not in stage1
    mode); the entries it chases are not counted. The counts come from the
    plain version's stage1 mode on the same lanes."""
    usable = prep[PREP_FIELDS.index("usable")]
    minval = u32(prep[PREP_FIELDS.index("minval")])[usable]
    slot_rows = torch.unique(
        mulhi32(mix32(minval), kw["num_slots"]) >> 3).numel()
    lanes = usable.numel()
    old = lanes * (7 * 4 + 3) + lanes * out_bytes + slot_rows * 96
    hit, _csid, cnt, need = minidict2_probe_plain(*tabs, prep, vb=vb,
                                                  stage1=True, **kw)
    trows = int(torch.clamp(cnt, max=vb).sum())
    gated = int((usable & ~hit & need).sum()) if skew else 0
    return old + trows * 12 + gated * 64, old, trows, gated


def finish_row(r, phase):
    """A kernel's bound from its bytes and operations; log its row, and
    raise unless it equalled its plain version."""
    b_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
    o_ms = r["ops"] / INT_OPS_PER_S * 1e3
    r["bound_ms"] = max(b_ms, o_ms)
    r["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
    log(f"[{phase}] {r['name']}: {r['ms']:.4f} ms cold L2, "
        f"{r['warm_ms']:.4f} ms warm (plain {r['plain_ms']:.2f} ms), "
        f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
        f"({r['bytes'] / 1e6:.1f} MB), max_abs_err {r['max_abs_err']}")
    if r["max_abs_err"] != 0:
        raise RuntimeError(f"{r['name']} disagrees with its plain version")


def text_table(cidx, bases, k):
    """A cuckoo table over the distinct canonical k-mers of the unitigs in
    the first `bases` bases of the index's text, each valued by its
    unitig id. -> (table (nb, 4) u32, that text's codes)."""
    offs = cidx.unitig_offs
    n = int(np.searchsorted(offs, bases, side="right")) - 1
    codes = unpack2(cidx.unitig_seq, int(offs[n]))
    keys, uids = unitig_kmers(codes, offs[: n + 1], k)
    keys, first = np.unique(keys, return_index=True)
    return native.cuckoo_build(keys, uids[first]), codes


def k7_in_l2(cidx, dev, flush):
    """K7 as phase 4 runs it (BATCH reads of READ_LEN bases at W = WIDTH,
    k = K) but on reads cut from the first K7_L2_BASES bases of the text
    and a table of that text's k-mers that L2 holds: the same kernel and
    windows, its row gathers served by L2 where warm rather than by
    random reads of device memory. Logs its rows read and its cold and
    warm ms."""
    table, codes = text_table(cidx, K7_L2_BASES, K)
    t = torch.from_numpy(table.view(np.int32)).to(dev)
    rng = np.random.default_rng(EDGE_READS + K)
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    starts = rng.integers(0, len(codes) - READ_LEN, BATCH)
    chunk[:, :READ_LEN] = codes[starts[:, None] + np.arange(READ_LEN)]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    rows = cuckoo_row_gathers(t, c2, bd, width=WIDTH, k=K)
    ms, warm = kernel_times(lambda: cuckoo_lookup(t, c2, bd, width=WIDTH,
                                                  k=K), "cuckoo_lookup", flush)
    log(f"[kernels] cuckoo_lookup with its table in L2: a table of "
        f"{table.nbytes / 1e6:.1f} MB (the k-mers of {len(codes)} bases of "
        f"the text; L2 holds 50 MB), {BATCH} reads cut from that text: "
        f"{rows} table rows read, {ms:.4f} ms cold L2, {warm:.4f} warm")


def edge_reads(rng, codes, W):
    """EDGE_READS reads of W bases: 16 all N, then three in four cut from
    the text `codes` (every fifth of those with an N), the rest random."""
    chunk = rng.integers(0, 4, (EDGE_READS, W)).astype(np.uint8)
    chunk[:16] = 4
    for b in range(16, EDGE_READS):
        if b % 4:
            p = int(rng.integers(0, len(codes) - W))
            chunk[b] = codes[p: p + W]
            if b % 5 == 0:
                chunk[b, rng.integers(0, W)] = 4
    return chunk


def check_k7_edges(cidx, table31, dev):
    """K7 at K7_EDGE's shapes on EDGE_READS reads (not a multiple of a
    block's reads), 16 of them all N, bit for bit against its plain
    version: k = 31 on the index's table, k = 15 on text_table's.
    -> the largest max_abs_err."""
    t0 = time.perf_counter()
    table15, codes = text_table(cidx, K7_EDGE_BASES, 15)
    tables = {31: table31,
              15: torch.from_numpy(table15.view(np.int32)).to(dev)}
    log(f"[kernels] cuckoo_lookup's edge batches: a k = 15 table of "
        f"{len(table15)} buckets over {len(codes)} bases of the text, built "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(EDGE_READS + 7)
    err = 0
    for k, W in K7_EDGE:
        c2, bd = (torch.from_numpy(a).to(dev)
                  for a in pack_reads_host(edge_reads(rng, codes, W)))
        got = cuckoo_lookup(tables[k], c2, bd, width=W, k=k)
        want = cuckoo_lookup_plain(tables[k], c2, bd, width=W, k=k)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        log(f"[kernels] cuckoo_lookup on an edge batch (k = {k}, W = {W}): "
            f"{int(got[0].sum())} hits of {got[0].numel()} windows, "
            f"{int(got[0][:16].sum())} in the all-N reads, max_abs_err {e}")
        if got[0][:16].any():
            raise RuntimeError("cuckoo_lookup hit in an all-N read")
    return err


def edge_codes(rng, B, L):
    """(B, L) uint8 codes for K8, seeded: bases 0..3 with a tenth of them
    any byte 0..255, and every third row all bytes 0..255."""
    x = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    odd = rng.random((B, L)) < 0.1
    x[odd] = rng.integers(0, 256, size=int(odd.sum()), dtype=np.uint8)
    x[::3] = rng.integers(0, 256, size=x[::3].shape, dtype=np.uint8)
    return x


def check_k8_edges(dev) -> int:
    """K8 against its plain version on the seeded edge batches (L x B in
    K8_EDGE_L x EDGE_B), bit for bit, each from rows that start 16-byte
    aligned and from the same rows starting at an odd byte offset (the
    byte-load instance); at L % 32 == 0 its bytes also against the host
    packer's. -> the largest max_abs_err."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    err, checks = 0, 0
    for L in K8_EDGE_L:
        for B in EDGE_B:
            x = edge_codes(rng, B, L)
            aligned = torch.from_numpy(x).to(dev)
            buf = torch.empty(B * L + 1, dtype=torch.uint8, device=dev)
            buf[1:].copy_(aligned.view(-1))
            odd = buf[1:].view(B, L)
            if odd.data_ptr() % 2 != 1 or not odd.is_contiguous():
                raise RuntimeError("the odd-offset view is not one")
            want = pack_codes_plain(aligned)
            host = pack_reads_host(x) if L % 32 == 0 else None
            for what, c in (("aligned", aligned), ("odd offset", odd)):
                got = pack_codes(c)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                wire = True
                if host is not None:
                    c2, bd = host
                    wire = (np.array_equal(
                        got[0].view(torch.uint8).cpu().numpy(), c2)
                        and np.array_equal(
                            got[1].view(torch.uint8).cpu().numpy(), bd))
                if e or not wire:
                    log(f"[kernels] pack_codes edge batch B {B}, L {L}, "
                        f"{what}: max_abs_err {e}, the host packer's bytes "
                        f"{wire}")
                    if not wire:
                        raise RuntimeError("pack_codes differs from "
                                           "pack_reads_host")
                err = max(err, e)
                checks += 1
            del aligned, buf, odd
    log(f"[kernels] pack_codes on {checks} seeded edge batches (L "
        f"{K8_EDGE_L} x B {EDGE_B}, aligned and at an odd byte offset; at L "
        f"% 32 == 0 also the host packer's bytes): max_abs_err {err} "
        f"({time.perf_counter() - t0:.1f} s)")
    return err


def phase_cuckoo_pack(eng, ceng, chunk, c2, bd, prep, flush, parent):
    """K7 on the kernels batch against its plain version, and against K2
    at the redo budget on every window K2 decides, and on K7_EDGE's edge
    batches (check_k7_edges); timed, with `parent` in turns with the
    parent's K7, and against a table that L2 holds (k7_in_l2). K8 on the
    same chunk's codes against its plain version and the host packer's
    bytes, and on K8's edge batches (check_k8_edges); timed on the chunk
    and on its bases in rows of 1,024, with `parent` in turns with the
    parent's K8. -> the two kernels' rows."""
    table = ceng.table
    Wk = WIDTH - K + 1
    lanes = BATCH * Wk
    got = cuckoo_lookup(table, c2, bd, width=WIDTH, k=K)
    want = cuckoo_lookup_plain(table, c2, bd, width=WIDTH, k=K)
    slots, text32, skew = eng.table
    m, num_slots = eng.dparams
    hit2, csid2, ovf2 = minidict2_probe(
        slots, text32, skew, prep, k=K, m=m, num_slots=num_slots,
        vb=eng._pb_redo[0], sc=eng._pb_redo[1])
    torch.cuda.synchronize()
    err7 = max_abs_err(got, want)
    decided = ~ovf2
    differ = int(((got[0] != hit2) | (got[1] != csid2))[decided].sum())
    log(f"[kernels] cuckoo_lookup: {int(got[0].sum())} hits of {lanes} "
        f"windows, max_abs_err {err7}; against minidict2_probe at "
        f"{eng._pb_redo} on the {int(decided.sum())} windows it decides: "
        f"{differ} differ")
    if differ:
        raise RuntimeError("cuckoo_lookup differs from minidict2_probe")
    rows_read = cuckoo_row_gathers(table, c2, bd, width=WIDTH, k=K)
    io7 = BATCH * (WIDTH // 4 + WIDTH // 8) + lanes * 5
    log(f"[kernels] cuckoo_lookup reads {rows_read} table rows of 16 B "
        f"(one a valid window, two where the first choice misses): "
        f"{(io7 + 16 * rows_read) / 1e6:.1f} MB, bound "
        f"{(io7 + 16 * rows_read) / HBM_BYTES_PER_S * 1e3:.4f} ms; counted "
        f"as 32-byte sectors {(io7 + 32 * rows_read) / 1e6:.1f} MB, "
        f"{(io7 + 32 * rows_read) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    err7 = max(err7, check_k7_edges(ceng.idx, table, eng.device))
    ms7, warm7 = in_turns(
        "kernels", "cuckoo_lookup", f"phase 4's batch ({lanes} windows)",
        (io7 + 16 * rows_read,),
        lambda: cuckoo_lookup(table, c2, bd, width=WIDTH, k=K), flush,
        parent)
    k7_in_l2(ceng.idx, eng.device, flush)
    row7 = dict(
        name="cuckoo_lookup", source="fulgor_tpu_torch/csrc/cuckoo.cu",
        replaces="fulgor_tpu/ops/lookup.py:186", max_abs_err=err7, ms=ms7,
        warm_ms=warm7,
        plain_ms=time_ms(lambda: cuckoo_lookup_plain(table, c2, bd,
                                                     width=WIDTH, k=K),
                         REPS_PLAIN),
        # the k-mer, two 62-bit permutations and four slot compares: ~60
        bytes=io7 + 16 * rows_read, ops=lanes * 60)

    codes = torch.from_numpy(chunk).to(eng.device)
    got = pack_codes(codes)
    want = pack_codes_plain(codes)
    torch.cuda.synchronize()
    err8 = max_abs_err(got, want)
    wire = (np.array_equal(got[0].view(torch.uint8).cpu().numpy(),
                           c2.cpu().numpy())
            and np.array_equal(got[1].view(torch.uint8).cpu().numpy(),
                               bd.cpu().numpy()))
    log(f"[kernels] pack_codes: max_abs_err {err8}; its bytes equal the host "
        f"packer's: {wire}")
    if not wire:
        raise RuntimeError("pack_codes differs from pack_reads_host")
    err8 = max(err8, check_k8_edges(eng.device))
    ms8, warm8 = in_turns(
        "kernels", "pack_codes", f"phase 4's batch (B {BATCH}, L {WIDTH})",
        (BATCH * WIDTH + BATCH * (WIDTH // 16 + WIDTH // 32) * 4,),
        lambda: pack_codes(codes), flush, parent)
    # the same bases in rows of the v1 lookup's pieces
    long_rows = codes.view(-1, 1024)
    in_turns("kernels", "pack_codes",
             f"the v1 lookup's piece width (B {long_rows.shape[0]}, L 1024)",
             (long_rows.numel() * (1 + 3 / 8),),
             lambda: pack_codes(long_rows), flush, parent)
    row8 = dict(
        name="pack_codes", source="fulgor_tpu_torch/csrc/pack.cu",
        replaces="fulgor_tpu/ops/minidict2.py:919", max_abs_err=err8, ms=ms8,
        warm_ms=warm8,
        plain_ms=time_ms(lambda: pack_codes_plain(codes), REPS_PLAIN),
        bytes=BATCH * WIDTH + BATCH * (WIDTH // 16 + WIDTH // 32) * 4,
        ops=BATCH * WIDTH * 4)
    return [row7, row8]


def runs_bytes(B, Wk, R, words=False) -> int:
    """K6's bytes at run budget R: hit and csid read once (5 B a window),
    an int32 csid and two u16 a run slot and two int32 a read written, and
    with hit words 4 B a 32 windows."""
    return (B * Wk * 5 + B * R * 8 + B * 8
            + (B * ((Wk + 31) // 32) * 4 if words else 0))


def edge_runs_inputs(rng, B, Wk, dev):
    """A seeded (hit, csid) batch for K6's and K13's edge checks: rows of
    runs of mean length 1, 3 or 20 over 3 or 70,000 csids (a csid recurs
    after another run and after a miss) at 30%-100% positive windows; row
    b % 8 = 0 all negative, 1 all positive with one csid near INVALID over
    the whole read, 2 all positive with alternating csids, 3 all positive
    with a new csid each window (Wk runs), 4 positive every other window."""
    mean = rng.choice([1.0, 3.0, 20.0], size=(B, 1))
    alpha = rng.choice([3, 70_000], size=(B, 1))
    change = rng.random((B, Wk)) < 1.0 / mean
    csid = np.cumsum(change, axis=1) * 2_654_435_761 % alpha
    hit = rng.random((B, Wk)) < rng.choice([0.3, 0.8, 0.97, 1.0],
                                            size=(B, 1))
    w = np.arange(Wk)
    kind = np.arange(B) % 8
    hit[kind == 0] = False
    hit[(kind >= 1) & (kind <= 3)] = True
    hit[kind == 4] = w % 2 == 0
    csid[kind == 1] = 0xFFFFFFF0
    csid[kind == 2] = w % 2
    csid[kind == 3] = w
    csid = csid.astype(np.uint32).view(np.int32)
    return (torch.from_numpy(hit).to(dev),
            torch.from_numpy(np.ascontiguousarray(csid)).to(dev))


def check_runs_edges(dev) -> int:
    """K6 (both instances, hit words against pack_hits_plain's) and K13
    (with and without narrowing) on RUNS_EDGE's seeded batches, bit for bit
    against the plain versions; K6 at run budgets 1 to 2 Wk; an
    all-negative and an all-positive one-csid batch too. -> max_abs_err."""
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    batches = [(B, Wk, edge_runs_inputs(rng, B, Wk, dev))
               for B, Wk in RUNS_EDGE]
    for fill in (False, True):
        hit = torch.full((EDGE_READS, 33), fill, dtype=torch.bool, device=dev)
        batches.append((EDGE_READS, 33, (hit, torch.full_like(
            hit, 5, dtype=torch.int32))))
    err, checks, over = 0, 0, 0
    for B, Wk, (hit, csid) in batches:
        for R in sorted({1, 2, 16, Wk // 2 + 1, Wk, 2 * Wk}):
            want = compact_runs_plain(hit, csid, R, True)
            for words in (False, True):
                got = compact_runs(hit, csid, R, words)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, want[:len(got)]))
                checks += 1
            over += int((want[3] > R).sum())
        for narrow in (False, True):
            got = pack_hits(hit, csid if narrow else None)
            want = pack_hits_plain(hit, csid if narrow else None)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(
                tuple(x for x in got if x is not None),
                tuple(x for x in want if x is not None)))
            checks += 1
    log(f"[kernels] compact_runs and pack_hits on {len(batches)} seeded edge "
        f"batches (B x Wk {RUNS_EDGE}, an all-negative and an all-positive "
        f"batch of {EDGE_READS} x 33; run budgets 1 to 2 Wk): {checks} "
        f"checks, {over} read-budget pairs past R, max_abs_err {err} "
        f"({time.perf_counter() - t0:.1f} s)")
    return err


def runs_in_turns(what, B, Wk, R, hit, csid, flush, parent):
    """K6 at (B, Wk, R) in turns with the parent's (in_turns), then its
    hit-word instance: with `parent` in turns with the parent's K6 and K13
    launched one after the other, as the mesh's kmer-matches step did
    (probe_in_turns: a call's kernels summed). -> (ms, warm ms) of K6's
    plain instance."""
    ms = in_turns("kernels", "compact_runs", f"{what} ({B} reads x Wk "
                  f"{Wk}, R = {R})", (runs_bytes(B, Wk, R),),
                  lambda: compact_runs(hit, csid, R), flush, parent)
    bound = runs_bytes(B, Wk, R, True) / HBM_BYTES_PER_S * 1e3
    if parent is None:
        cold, warm = kernel_times(lambda: compact_runs(hit, csid, R, True),
                                  "compact_runs", flush)
        log(f"[kernels] compact_runs with hit words at {what}: {cold:.4f} ms "
            f"cold L2, {warm:.4f} warm; bound {bound:.4f} ms, "
            f"{bound / cold:.1%} of it cold")
        return ms

    def parent_fn():
        with using_library(parent):
            compact_runs(hit, csid, R)
            pack_hits(hit)

    cold, warm, _per = probe_in_turns(
        "compact_runs", ("compact_runs", "pack_hits"),
        lambda: compact_runs(hit, csid, R, True), parent_fn, flush)
    log(f"[kernels] compact_runs with hit words at {what}: {cold:.4f} ms "
        f"cold L2 ({warm:.4f} warm) against the parent's K6 then K13 in the "
        f"turns above; bound {bound:.4f} ms, {bound / cold:.1%} of it cold")
    return ms


def phase_runs(eng, hit, csid, flush, parent):
    """K6 against compact_runs_plain on the batch's (hit, csid), bit for
    bit on all five outputs and its hit words, at run budgets 2 (most reads
    overflow), 16, 32, Wk, 2 Wk, the engine's kmer-conservation and
    --deduplicate budgets and the runs fetch's; on seeded edge batches
    (check_runs_edges). Timed at the last three and at one (2, 2) grid
    cell's shape (B / 4 reads at R = Wk, with and without hit words), with
    `parent` in turns with the parent's kernels. -> the kernel's row."""
    Wk = WIDTH - K + 1
    r_kc = engine_mod._runs_budget(WIDTH, eng._ekpu, K)
    r_dd = 2 * r_kc
    r_rf = eng.runs_fi_budget
    log(f"[kernels] index ekpu {eng._ekpu:.2f}: run budget at W={WIDTH} "
        f"{r_kc} (kmer-conservation), {r_dd} (--deduplicate), {r_rf} (runs "
        "fetch)")
    err = 0
    for R in sorted({2, 16, 32, Wk, 2 * Wk, r_kc, r_dd, r_rf}):
        want = compact_runs_plain(hit, csid, R, True)
        e = 0
        for words in (False, True):
            got = compact_runs(hit, csid, R, words)
            torch.cuda.synchronize()
            e = max(e, max_abs_err(got, want[:len(got)]))
        err = max(err, e)
        log(f"[kernels] compact_runs at R={R}: {int((got[3] > R).sum())} of "
            f"{hit.shape[0]} reads past R, up to {int(got[3].max())} runs "
            f"a read, {int(got[3].sum())} runs, max_abs_err {e} (with hit "
            "words)")
    err = max(err, check_runs_edges(hit.device))
    ms, warm = runs_in_turns("phase 4's batch, kmer-conservation", BATCH, Wk,
                             r_kc, hit, csid, flush, parent)
    for what, R in (("--deduplicate", r_dd), ("runs fetch", r_rf)):
        runs_in_turns(f"phase 4's batch, {what}", BATCH, Wk, R, hit, csid,
                      flush, parent)
    b = BATCH // (GRID[0] * GRID[1])
    hc, cc = hit[:b].contiguous(), csid[:b].contiguous()
    runs_in_turns(f"one {GRID} grid cell", b, Wk, Wk, hc, cc, flush, parent)
    return dict(
        name="compact_runs", source="fulgor_tpu_torch/csrc/runs.cu",
        replaces="fulgor_tpu/ops/intersect.py:188", max_abs_err=err,
        ms=ms, warm_ms=warm,
        plain_ms=time_ms(lambda: compact_runs_plain(hit, csid, r_kc),
                         REPS_PLAIN),
        # shuffles, compares, ballots and popcounts: ~16 a window
        bytes=runs_bytes(BATCH, Wk, r_kc), ops=BATCH * Wk * 16)


def phase_runs_tu(eng, c2, bd) -> int:
    """query_runs_tu_packed (K1 -> K2 -> K6) against its composition of
    the plain versions on the batch. -> max_abs_err."""
    m, num_slots = eng.dparams
    slots, text32, skew = eng.table
    R = engine_mod._runs_budget(WIDTH, eng._ekpu, K)
    got = query_runs_tu_packed(eng.table, c2, bd, k=K, width=WIDTH, R=R,
                               dparams=eng.dparams, probe_budget=eng._pb)
    prep = window_prep_plain(c2, bd, width=WIDTH, k=K, m=M)
    hit, csid, ovf = minidict2_probe_plain(
        slots, text32, skew, prep, k=K, m=m, num_slots=num_slots,
        vb=eng._pb[0], sc=eng._pb[1])
    rc, _start, rl, total, npos = compact_runs_plain(hit, csid, R)
    want = (rc, rl.to(torch.int32), npos, (total > R) | ovf.any(dim=1))
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    log(f"[kernels] query_runs_tu_packed at R={R} against its plain "
        f"composition: {int(got[3].sum())} reads in overflow, max_abs_err "
        f"{err}")
    return err


def runs_per_read(hit, csid):
    """Each read's runs of consecutive positive windows with equal csid."""
    cont = torch.zeros_like(hit)
    cont[:, 1:] = hit[:, :-1] & (csid[:, 1:] == csid[:, :-1])
    return (hit & ~cont).sum(dim=1)


def count_runs(hit, csid) -> int:
    """Runs of consecutive positive windows with equal csid in a batch."""
    return int(runs_per_read(hit, csid).sum())


def wide_dense(S, C32, dev, seed):
    """A seeded random (S, C32) dense matrix: random words (their pad bits
    too), a third of the rows sparser, the first eighth every colour (core
    rows)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(n):
        return torch.randint(-(1 << 31), 1 << 31, (n, C32), dtype=torch.int32,
                             device=dev, generator=g)

    dense = rnd(S)
    lo, hi = S // 3, 2 * S // 3
    dense[lo:hi] &= rnd(hi - lo) & rnd(hi - lo)  # sparser rows
    dense[: S // 8] = -1  # core rows hold every colour
    return dense


def plain_ms(fn):
    """fn() once, timed with CUDA events. -> (its result, ms)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def phase_wide_c(eng, hit, csid):
    """K4 (tau 0.8 and 1.0) and K5 against their plain versions on
    WIDE_READS of the batch's reads and a seeded random dense matrix of
    WIDE_C colours: several colour tiles a block and a ragged last word
    (random pad bits included, which K4 must not pass on). Then at HUGE_C
    colours (C32 = 2,048, fulgor_tpu's scripts/demo150k.py) on the same
    reads and a seeded random dense matrix of that width: K4 (tau 0.8 and
    1.0) and K5 at HUGE_C and at the ragged HUGE_C - HUGE_RAGGED, K3, and
    K9 at T 1 and T_LIST on K3's rows, K4's rows and seeded edge rows, all
    bit for bit; each timed cold L2 and warm beside its byte bound, its
    plain version timed once on the checked call. -> {kernel name: largest
    max_abs_err}."""
    dev = eng.device
    S = eng.bits.shape[0]
    h = hit[:WIDE_READS].contiguous()
    c = csid[:WIDE_READS].contiguous()
    B, Wk = h.shape
    errs = dict.fromkeys(("fi_and", "tu_mask", "km_scores",
                          "first_set_bits"), 0)
    dense = wide_dense(S, (WIDE_C + 31) // 32, dev, WIDE_C)
    for tau in (TAU, 1.0):
        tab = eng._minscore_tab(tau, Wk)
        got = tu_mask(dense, h, c, tab, WIDE_C)
        want = tu_mask_plain(dense, h, c, tab, WIDE_C)
        torch.cuda.synchronize()
        errs["tu_mask"] = max(errs["tu_mask"], max_abs_err((got,), (want,)))
        log(f"[kernels] wide C: tu_mask at tau {tau}, {WIDE_READS} reads x "
            f"{WIDE_C} colours: {int(got.ne(0).any(dim=1).sum())} reads map, "
            f"max_abs_err {errs['tu_mask']}")
    got = km_scores(dense, h, c, WIDE_C)
    want = km_scores_plain(dense, h, c, WIDE_C)
    torch.cuda.synchronize()
    errs["km_scores"] = max_abs_err(got, want)
    log(f"[kernels] wide C: km_scores, {WIDE_READS} reads x {WIDE_C} "
        f"colours: max score {int(got[1].max())}, max_abs_err "
        f"{errs['km_scores']}")
    del dense, got, want

    # HUGE_C: C32 = 2,048, every word of a row past K9's groups of chunks
    C32 = HUGE_C // 32
    dense = wide_dense(S, C32, dev, HUGE_C)
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    runs = count_runs(h, c)
    distinct = torch.unique(c[h]).numel()
    rows = []

    def row(name, fn, plain, err, nbytes, ops):
        ms, warm = kernel_times(fn, name, flush)
        rows.append(dict(name=f"{name} (C = {HUGE_C})", ms=ms, warm_ms=warm,
                         plain_ms=plain, max_abs_err=err, bytes=nbytes,
                         ops=ops))
        errs[name] = max(errs[name], err)

    k3 = fi_and(dense, h, c)
    want, pm = plain_ms(lambda: fi_and_plain(dense, h, c))
    e3 = max_abs_err((k3,), (want,))
    log(f"[kernels] huge C: fi_and, {B} reads x {HUGE_C} colours: "
        f"{int(k3.ne(0).any(dim=1).sum())} reads map, {distinct} distinct "
        f"colour sets, max_abs_err {e3}")
    row("fi_and", lambda: fi_and(dense, h, c), pm, e3,
        k3_bytes(h, c, C32), B * Wk * C32)
    masks = {}
    for C in (HUGE_C, HUGE_C - HUGE_RAGGED):
        e4 = []
        for tau in (TAU, 1.0):
            tab = eng._minscore_tab(tau, Wk)
            got = tu_mask(dense, h, c, tab, C)
            want, pm4 = plain_ms(lambda: tu_mask_plain(dense, h, c, tab, C))
            e4.append(max_abs_err((got,), (want,)))
            masks[(C, tau)] = got
        if not torch.equal(masks[(HUGE_C, 1.0)], k3):
            raise RuntimeError("tu_mask at tau 1.0 differs from fi_and at "
                               f"{HUGE_C} colours")
        got = km_scores(dense, h, c, C)
        want, pm5 = plain_ms(lambda: km_scores_plain(dense, h, c, C))
        e5 = max_abs_err(got, want)
        log(f"[kernels] huge C: tu_mask at tau {TAU} and 1.0 and km_scores, "
            f"{B} reads x {C} colours: "
            f"{int(masks[(C, TAU)].ne(0).any(dim=1).sum())} reads map at "
            f"tau {TAU}, max score {int(got[1].max())}, max_abs_err {e4} and "
            f"{e5}")
        del got, want
        if C == HUGE_C:
            tab = eng._minscore_tab(TAU, Wk)
            row("tu_mask", lambda: tu_mask(dense, h, c, tab, C), pm4,
                max(e4), B * Wk * 5 + distinct * C32 * 4 + (Wk + 1) * 4
                + B * C32 * 4, runs * C32 * 32 + B * C32 * 32)
            row("km_scores", lambda: km_scores(dense, h, c, C), pm5, e5,
                k5_bytes(h, c, C32, C), runs * C)
            torch.cuda.empty_cache()
        else:
            errs["tu_mask"] = max(errs["tu_mask"], *e4)
            errs["km_scores"] = max(errs["km_scores"], e5)
    log(f"[kernels] tu_mask at tau 1.0 equals fi_and at {HUGE_C} colours")
    edge = torch.from_numpy(edge_bit_rows(
        np.random.default_rng(HUGE_C), B, C32, HUGE_T).view(np.int32)).to(dev)
    T = engine_mod.T_LIST
    for name, x in (("K3 rows", k3), ("K4 rows", masks[(HUGE_C, TAU)]),
                    ("edge rows", edge)):
        for t in HUGE_T:
            got = first_set_bits(x, t)
            want, pm9 = plain_ms(lambda: first_set_bits_plain(x, t))
            e9 = max_abs_err(got, want)
            log(f"[kernels] huge C: first_set_bits on {B} {name} x {C32} "
                f"words at T={t}: {int((got[0] > t).sum())} rows past T, "
                f"{int((got[0] == 0).sum())} empty, up to "
                f"{int(got[0].max())} colours a row, max_abs_err {e9}")
            if name == "K4 rows" and t == T:
                row("first_set_bits", lambda: first_set_bits(x, T), pm9, e9,
                    B * C32 * 4 + B * (T + 1) * 4, B * C32 * 12 + B * T * 3)
            errs["first_set_bits"] = max(errs["first_set_bits"], e9)
    del flush, dense, masks, edge, k3
    torch.cuda.empty_cache()
    for r in rows:
        finish_row(r, "kernels")
    log(f"[kernels] huge C: {HUGE_C} colours checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    if any(errs.values()):
        raise RuntimeError(f"a kernel disagrees with its plain version at "
                           f"{WIDE_C} or {HUGE_C} colours: {errs}")
    return errs


def kernel_pattern(name):
    """The device kernels of launch count `name`: `{name}_kernel`, or
    `{name}_<step>_kernel` for a wrapper that launches several."""
    return re.compile(rf"\b{name}(_\w+)?_kernel\b")


def device_busy(fn):
    """Run fn under torch.profiler. -> (wall s, device busy s or None,
    {kernel name: (count, device ms)}, fn's result); busy is the union of
    the card's kernel and copy intervals, None where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return wall, None, {}, out
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    per_kernel = {}
    for name in kernels.launches:
        pat = kernel_pattern(name)
        evs = [e for e in dev if pat.search(e.name)]
        per_kernel[name] = (len(evs), sum(e.time_range.elapsed_us()
                                          for e in evs) / 1e3)
    return wall, busy_us / 1e6, per_kernel, out


_MIRROR: dict = {}  # one host-mirror worker's index and reads


def _mirror_init(index_path, codes_path):
    eng = QueryEngine(Index.load(index_path), device="cpu")
    _MIRROR.update(d=eng.idx.minidict(), eng=eng,
                   codes=np.load(codes_path, mmap_mode="r"))


def _host_mirror(q):
    """Read q by the exact host mirror: lookup_host_exact over every
    window, then from its csids the FI colours (intersection of the decoded
    colour sets), the TU(TAU) colours, the kmer-matches counts (each
    positive window adds one to every colour of its set) and the
    kmer-conservation runs."""
    pos, csid = lookup_host_exact(_MIRROR["d"],
                                  np.asarray(_MIRROR["codes"][q]))
    eng = _MIRROR["eng"]
    cat, offs = eng._cs_cache
    counts = np.zeros(eng.idx.num_colors, dtype=np.int64)
    for sid in csid[pos]:
        counts[cat[offs[sid]: offs[sid + 1]].astype(np.int64)] += 1
    npos = int(pos.sum())
    tu = (np.flatnonzero(counts >= int(npos * TAU)).astype(np.uint32)
          if npos else np.empty(0, np.uint32))
    return (eng._fi_from_csids(csid), tu, pos, counts,
            conservation_runs(pos, csid), csid)


def timed_passes(path, fn, passes):
    """Run fn() `passes` times, the launch counts reset just before each
    run and checked just after against PATH_KERNELS[path]. -> (reads/s of
    each run, the last run's stats, its launches)."""
    need, forbid = PATH_KERNELS[path]
    rates = []
    for i in range(passes):
        kernels.reset_launches()
        st = fn()
        launches = dict(kernels.launches)
        rates.append(st["num_reads"] / st["elapsed"])
        log(f"[{path}] pass {i + 1}: {st['num_reads']} reads in "
            f"{st['elapsed']:.3f} s: {rates[-1]:.1f} reads/s; parse "
            f"{st['parse_sec']:.3f} s, query {st['query_sec']:.3f} s, host "
            f"{st.get('host_sec', 0.0):.3f} s, redo {st['redo_sec']:.3f} s, "
            f"write {st['write_sec']:.3f} s; "
            f"{st['num_redo']} reads redone ({st['num_redo_host']} on the "
            f"host); {st.get('num_mapped', '-')} mapped; launches {launches}")
        missing = [k for k in need if launches[k] <= 0]
        extra = [k for k in forbid if launches[k] > 0]
        if missing or extra:
            raise RuntimeError(f"{path} path: kernels not launched {missing}, "
                               f"launched and not expected {extra}")
    rate = statistics.median(rates)
    log(f"[{path}] {passes} timed passes: median {rate:.1f} reads/s, "
        f"min {min(rates):.1f}, max {max(rates):.1f} "
        f"(spread {(max(rates) - min(rates)) / rate:.4f} of the median)")
    return rates, st, launches


def profiled_pass(path, fn):
    """fn() under the profiler; logs the card's busy share and each
    kernel's launches and device time. -> fn's result."""
    wall, busy, per_kernel, out = device_busy(fn)
    if busy is None:
        log(f"[{path}] card busy share: not measured (the profiler recorded "
            "no device activity)")
    else:
        log(f"[{path}] profiled run: {wall:.3f} s wall, card busy "
            f"{busy * 1e3:.2f} ms (kernels and copies), idle share "
            f"{1 - busy / wall:.4f}; per kernel (launches, device ms) "
            f"{per_kernel}")
    return out


def read_binary_psa(path):
    """-> (qids, offs, cat) of a binary pseudoalignment file."""
    buf = np.fromfile(path, dtype=np.uint32)
    qids, offs, spans = [], [0], []
    pos = 0
    while pos < len(buf):
        n = int(buf[pos + 1])
        qids.append(buf[pos])
        spans.append((pos + 2, pos + 2 + n))
        offs.append(offs[-1] + n)
        pos += 2 + n
    cat = (np.concatenate([buf[a:b] for a, b in spans]) if spans
           else np.empty(0, np.uint32))
    return (np.array(qids, dtype=np.uint32), np.array(offs, dtype=np.int64),
            cat)


def ascii_records(path, want):
    """qid -> colours of the ascii records whose qid is in `want`."""
    recs = {}
    with open(path) as f:
        for ln in f:
            q = int(ln[: ln.index("\t")])
            if q in want:
                recs[q] = np.array(ln.rstrip("\n").split("\t")[2:],
                                   dtype=np.uint32)
    return recs


def phase_fi(eng, reads, tmp):
    def fn(out=os.devnull):
        return eng.pseudoalign_file(reads, out)

    fn()  # warm-up
    rates, _st, launches = timed_passes("fi", fn, E2E_PASSES)
    profiled_pass("fi", fn)
    out = os.path.join(tmp, "psa.tsv")
    st = fn(out)
    return dict(out=out, redo=st["redo_ids"], launches=launches,
                rate=statistics.median(rates))


def phase_tu(eng, reads, tmp):
    def fn(out=os.devnull, fmt="ascii"):
        return eng.pseudoalign_file(reads, out, threshold=TAU, fmt=fmt)

    rates, _st, launches = timed_passes("tu", fn, TU_PASSES)
    profiled_pass("tu", fn)
    out_a = os.path.join(tmp, "tu.tsv")
    out_b = os.path.join(tmp, "tu.bin")
    st_a = fn(out_a)
    st_b = fn(out_b, "binary")
    t0 = time.perf_counter()
    qids, offs, cat = read_binary_psa(out_b)
    with open(out_a, "rb") as f:
        same = f.read() == native.format_psa_ascii(qids, cat, offs)
    if not same:  # same records in another order?
        rec_b = {int(q): cat[offs[i]: offs[i + 1]] for i, q in enumerate(qids)}
        rec_a = ascii_records(out_a, set(rec_b))
        same = len(rec_a) == len(rec_b) and all(
            np.array_equal(rec_a[q], v) for q, v in rec_b.items())
    log(f"[tu] ascii and binary outputs: {len(qids)} records, the same "
        f"records: {same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise RuntimeError("the TU ascii and binary outputs differ")
    return dict(out=(qids, offs, cat), ascii=out_a,
                redo=st_a["redo_ids"] + st_b["redo_ids"],
                launches=launches, rate=statistics.median(rates))


def phase_km(eng, reads, tmp):
    def fn(out=os.devnull):
        return eng.kmer_matches_file(reads, out)

    rates, _st, launches = timed_passes("km", fn, KM_PASSES)
    out = os.path.join(tmp, "km.tsv")
    st = fn(out)
    log(f"[km] output file: {os.path.getsize(out) / 1e6:.1f} MB")
    return dict(out=out, redo=st["redo_ids"], launches=launches,
                rate=statistics.median(rates))


def forced_runs_budget(fn):
    """fn() with the engine's run budget forced to FORCED_RUNS, so that
    most reads take the run-overflow paths."""
    keep = engine_mod._runs_budget
    engine_mod._runs_budget = lambda W, ekpu=64.0, k=31: FORCED_RUNS
    try:
        return fn()
    finally:
        engine_mod._runs_budget = keep


def same_bytes(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_kc(eng, reads, tmp):
    def fn(out=os.devnull):
        return eng.kmer_conservation_file(reads, out)

    log(f"[kc] index ekpu {eng._ekpu:.2f}: run budget "
        f"{engine_mod._runs_budget(WIDTH, eng._ekpu, K)} at W={WIDTH}")
    rates, _st, launches = timed_passes("kc", fn, KC_PASSES)
    profiled_pass("kc", fn)
    out = os.path.join(tmp, "kc.tsv")
    st = fn(out)
    forced = os.path.join(tmp, "kc_forced.tsv")
    kernels.reset_launches()
    st2 = forced_runs_budget(lambda: fn(forced))
    same = same_bytes(out, forced)
    log(f"[kc] output file: {os.path.getsize(out) / 1e6:.1f} MB; run budget "
        f"forced to {FORCED_RUNS}: {st2['num_redo']} reads redone "
        f"({st2['num_redo_host']} on the host) in {st2['elapsed']:.3f} s, "
        f"launches {dict(kernels.launches)}, byte-identical: {same}")
    if not same:
        raise RuntimeError("kmer-conservation differs under a forced run "
                           "budget")
    return dict(out=out, redo=st["redo_ids"], launches=launches,
                rate=statistics.median(rates))


def phase_dedup(eng, reads, tmp):
    def fn(out=os.devnull):
        return eng.pseudoalign_file(reads, out, deduplicate=True)

    log(f"[dedup] run budget "
        f"{2 * engine_mod._runs_budget(WIDTH, eng._ekpu, K)} at W={WIDTH}")
    rates, _st, launches = timed_passes("dedup", fn, DEDUP_PASSES)
    out = os.path.join(tmp, "dedup.tsv")
    st = fn(out)
    forced = os.path.join(tmp, "dedup_forced.tsv")
    st2 = forced_runs_budget(lambda: fn(forced))
    same = same_bytes(out, forced)
    log(f"[dedup] {st['num_keys']} distinct keys for {st['num_reads']} "
        f"reads, {st['num_run_ovf']} reads past the run budget; run budget "
        f"forced to {2 * FORCED_RUNS}: {st2['num_run_ovf']} reads past it, "
        f"{st2['elapsed']:.3f} s, byte-identical: {same}")
    if not same:
        raise RuntimeError("--deduplicate differs under a forced run budget")
    return dict(out=out, redo=st["redo_ids"], launches=launches,
                rate=statistics.median(rates))


def sorted_lines(qids, offs, cat) -> list:
    """The records (qids, offs, cat) as ascii pseudoalignment lines, sorted
    by read id."""
    lines = native.format_psa_ascii(qids, cat, offs).splitlines()
    return [lines[i] for i in np.argsort(qids, kind="stable")]


def phase_meta_diff(idx, eng, reads, tmp, fi, tu):
    """Phase 5b: phase 3's index saved, converted to meta-diff on the host,
    checked (check_conversion), saved and loaded back; FI and TU(TAU) on
    the card over every read on a QueryEngine of it, once each to a
    binary file, each record's (permuted) colour ids mapped through the
    filenames to phase 3's: the records must equal phase 5's. -> the saved
    base index's path and phase 5's FI records sorted by read id (phase
    5c compares with them too)."""
    t0 = time.perf_counter()
    base_path = os.path.join(tmp, "mini.tfur")
    idx.save(base_path)
    t1 = time.perf_counter()
    conv = convert(idx, meta=True, diff=True)
    t2 = time.perf_counter()
    if not check_conversion(idx, conv):
        raise RuntimeError("check_conversion failed on the meta-diff index")
    t3 = time.perf_counter()
    path = Index.path_for(os.path.join(tmp, "mini"), conv.kind)
    conv.save(path)
    midx = Index.load(path)
    t4 = time.perf_counter()
    hb, mb = idx.color_store.num_bytes(), midx.color_store.num_bytes()
    pos = {fn: i for i, fn in enumerate(idx.filenames)}
    to_base = np.array([pos[fn] for fn in midx.filenames], dtype=np.uint32)
    log(f"[meta-diff] base index saved in {t1 - t0:.1f} s; converted "
        f"(meta and diff) in {t2 - t1:.1f} s, check_conversion {t3 - t2:.1f}"
        f" s, saved and loaded in {t4 - t3:.1f} s; colour store {mb} bytes "
        f"against the hybrid store's {hb} ({mb / hb:.4f} x), "
        f"{midx.color_store.num_color_sets} sets; {os.path.getsize(path)} "
        f"file bytes against {os.path.getsize(base_path)}; "
        f"{int((to_base != np.arange(len(to_base))).sum())} of "
        f"{len(to_base)} colour ids permuted")
    t5 = time.perf_counter()
    meng = QueryEngine(midx, device=eng.device)
    log(f"[meta-diff] engine made in {time.perf_counter() - t5:.1f} s")
    rates = {}
    fi_lines = records_by_qid(fi["out"])
    for tool, kw, want in (
            ("fi", {}, lambda: fi_lines),
            ("tu", {"threshold": TAU}, lambda: sorted_lines(*tu["out"]))):
        out = os.path.join(tmp, f"meta_diff_{tool}.bin")
        r, _st, _l = timed_passes(
            f"meta_diff_{tool}", lambda kw=kw, o=out: meng.pseudoalign_file(
                reads, o, fmt="binary", **kw), 1)
        rates[tool] = r[0]
        t0 = time.perf_counter()
        qids, offs, cat = read_binary_psa(out)
        got = sorted_lines(qids, offs, native.permute_sort_segments(
            cat, offs, to_base))
        same = got == want()
        log(f"[meta-diff] {tool.upper()}: {len(qids)} records, colour ids "
            f"mapped through the filenames, equal to phase 5's on every "
            f"read: {same} ({time.perf_counter() - t0:.1f} s)")
        if not same:
            raise RuntimeError(f"meta-diff {tool} records differ from phase "
                               "5's")
        os.remove(out)
    del meng
    torch.cuda.empty_cache()
    return dict(path=base_path, rates=rates, seconds=t2 - t1,
                fi_lines=fi_lines)


def phase_multihost(base_path, reads, tmp, fi_lines, device="cuda:0",
                    tag="multihost"):
    """Phase 5c: MULTIHOST_PROCS processes of the port's CLI, `pseudoalign
    --num-procs 2 --proc-id p --coordinator 127.0.0.1:<free port> --device
    cuda:0 --verbose` over the saved index and every read (FI, ascii), on
    one gloo process group: each must exit 0 having launched phase 5's FI
    kernels, and process 0's merged file must be id-ascending and hold
    phase 5's FI records (fi_lines, sorted by read id). device None: no
    --device (phase 13, where each process takes a card of its own). ->
    each process's reads, seconds, launches and card."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    out = os.path.join(tmp, "multihost.tsv")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fulgor_tpu_torch.cli", "pseudoalign", "-i",
         base_path, "-q", reads, "-o", out, "--num-procs",
         str(MULTIHOST_PROCS), "--proc-id", str(p), "--coordinator", coord,
         "--verbose"] + (["--device", device] if device else []),
        cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(MULTIHOST_PROCS)]
    try:
        logs = [p.communicate(timeout=MULTIHOST_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    need, forbid = PATH_KERNELS["fi"]
    for p, text in enumerate(logs):
        for ln in text.strip().splitlines():
            log(f"[{tag}] process {p}: {ln}")
    per = []
    for p, (proc, text) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise RuntimeError(f"multihost process {p} exited "
                               f"{proc.returncode}")
        reads_p = int(re.search(r"^mapped (\d+) reads$", text, re.M)[1])
        secs = float(re.search(r"/ ([0-9.]+) sec /", text)[1])
        launches = ast.literal_eval(re.search(
            r"^kernel launches in this process (\{.*\})$", text, re.M)[1])
        missing = [k for k in need if launches.get(k, 0) <= 0]
        extra = [k for k in forbid if launches.get(k, 0) > 0]
        if missing or extra:
            raise RuntimeError(f"multihost process {p}: kernels not launched "
                               f"{missing}, launched and not expected "
                               f"{extra}")
        per.append(dict(reads=reads_p, seconds=secs, launches=launches,
                        card=re.search(rf"^process {p} runs on (\S+)", text,
                                       re.M)[1]))
    t1 = time.perf_counter()
    left = sorted(f for f in os.listdir(tmp) if f.startswith("multihost."))
    with open(out, "rb") as f:
        got = f.read().splitlines()
    ids = [int(ln[: ln.index(b"\t")]) for ln in got]
    ascending = all(a < b for a, b in zip(ids, ids[1:]))
    same = got == fi_lines
    log(f"[{tag}] {MULTIHOST_PROCS} processes in {wall:.1f} s wall "
        f"(start-up, index load and engine included); reads, seconds and "
        f"card {[(d['reads'], d['seconds'], d['card']) for d in per]}; "
        f"merged file "
        f"{len(got)} records, id-ascending: {ascending}, equal to phase 5's "
        f"FI records: {same}; files left {left} "
        f"({time.perf_counter() - t1:.1f} s)")
    if not (ascending and same and left == ["multihost.tsv"]
            and sum(d["reads"] for d in per) == len(got)):
        raise RuntimeError("the multihost FI output differs from phase 5's")
    os.remove(out)
    return dict(procs=per, wall=wall)


def records_by_qid(path) -> list:
    """The lines of an ascii pseudoalignment file, sorted by read id."""
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    return sorted(lines, key=lambda ln: int(ln[: ln.index(b"\t")]))


def kc_line(name, runs) -> str:
    """A kmer-conservation line as format_kc writes it."""
    return f"{name}\t{len(runs)}" + "".join(f"\t({p} {n} {i})"
                                           for p, n, i in runs)


def phase_mirror(idx, codes, names, tmp, seed, fi, tu, km, kc, dedup):
    """Every read any path redid and a seeded sample of 2,000 others: the
    FI, TU, kmer-matches and kmer-conservation files against the exact
    host mirror; the --deduplicate file against the FI file on every
    read. -> {read id: (hit, csid)} of the checked reads, by the host
    mirror."""
    t0 = time.perf_counter()
    fi_sorted = records_by_qid(fi["out"])
    with open(dedup["out"], "rb") as f:
        dd_lines = f.read().splitlines()
    same = fi_sorted == dd_lines and len(dd_lines) == len(codes)
    log(f"[mirror] --deduplicate against FI: {len(dd_lines)} records, equal "
        f"on every read: {same} ({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise RuntimeError("the --deduplicate file differs from the FI file")
    rng = np.random.default_rng(seed)
    redone = (set(fi["redo"]) | set(tu["redo"]) | set(km["redo"])
              | set(kc["redo"]) | set(dedup["redo"]))
    sample = rng.choice(len(codes), size=min(2000, len(codes)), replace=False)
    check = sorted(redone | set(sample.tolist()))
    want_set = set(check)
    t0 = time.perf_counter()
    fi_recs = ascii_records(fi["out"], want_set)
    qids, offs, cat = tu["out"]
    tu_recs = {int(q): cat[offs[i]: offs[i + 1]] for i, q in enumerate(qids)
               if int(q) in want_set}
    km_lines = {}
    with open(km["out"]) as f:
        header = f.readline().rstrip("\n")
        nlines = 0
        for q, ln in enumerate(f):
            nlines += 1
            if q in want_set:
                km_lines[q] = ln.rstrip("\n").split("\t")
    if header != f"num_colors={idx.num_colors}" or nlines != len(codes):
        raise RuntimeError(f"kmer-matches output: header {header!r}, "
                           f"{nlines} lines for {len(codes)} reads")
    with open(kc["out"]) as f:
        kc_lines = {q: ln.rstrip("\n") for q, ln in enumerate(f)
                    if q in want_set}
    if len(fi_recs) != len(check) or len(tu_recs) != len(check):
        raise RuntimeError("a checked read has no FI or TU record")
    if len(kc_lines) != len(check):
        raise RuntimeError("a checked read has no kmer-conservation line")
    t1 = time.perf_counter()
    # the per-read exact mirror is a Python loop (~25 ms a read): spread it
    # over the host's cores, in spawned workers that load the saved index
    index_path = os.path.join(tmp, "smoke.tfur")
    codes_path = os.path.join(tmp, "codes.npy")
    idx.save(index_path)
    np.save(codes_path, codes)
    with multiprocessing.get_context("spawn").Pool(
            os.cpu_count(), initializer=_mirror_init,
            initargs=(index_path, codes_path)) as pool:
        wants = pool.map(_host_mirror, check, chunksize=64)
    bad = {"fi": [], "tu": [], "km": [], "kc": []}
    Wk = READ_LEN - K + 1
    for q, (fi_w, tu_w, hit_w, counts_w, runs_w, _cs) in zip(check, wants):
        if not np.array_equal(fi_recs[q], fi_w):
            bad["fi"].append(q)
        if not np.array_equal(tu_recs[q], tu_w):
            bad["tu"].append(q)
        f = km_lines[q]
        if (f[0] != names[q] or f[1] != str(Wk)
                or f[2: 2 + Wk] != [str(int(h)) for h in hit_w]
                or f[2 + Wk:] != [str(c) for c in counts_w]):
            bad["km"].append(q)
        if kc_lines[q] != kc_line(names[q], runs_w):
            bad["kc"].append(q)
    log(f"[mirror] {len(redone)} redone + {len(check) - len(redone)} sampled "
        f"reads against the exact host mirror: FI {len(bad['fi'])}, "
        f"TU({TAU}) {len(bad['tu'])}, kmer-matches {len(bad['km'])}, "
        f"kmer-conservation {len(bad['kc'])} differ "
        f"(files read in {t1 - t0:.1f} s, mirror "
        f"{time.perf_counter() - t1:.1f} s)")
    if any(bad.values()):
        raise RuntimeError(f"reads differ from the host mirror: "
                           f"{ {k: v[:10] for k, v in bad.items()} }")
    return {q: (w[2], w[5]) for q, w in zip(check, wants)}


def phase_cuckoo(ceng, reads, tmp, fi, tu, km, kc, dedup, parent):
    """Every tool on the cuckoo index over every read: FI (a warm-up,
    CUCKOO_PASSES timed runs, with `parent` four runs in turns with the
    parent's kernels, a profiled run, a run to a file), TU(TAU)
    (CUCKOO_PASSES timed runs, a run to a file), kmer-matches,
    kmer-conservation and --deduplicate (a run to a file each). Each file
    must equal the mini engine's: pseudoalign records sorted by read id,
    kmer-matches and kmer-conservation byte for byte. -> the FI path's
    launches and the medians."""
    def psa(out=os.devnull, **kw):
        return ceng.pseudoalign_file(reads, out, **kw)

    psa()  # warm-up
    rates_fi, _st, launches = timed_passes("cuckoo_fi", psa, CUCKOO_PASSES)
    passes_in_turns("cuckoo", "cuckoo_fi", psa, parent)
    profiled_pass("cuckoo_fi", psa)
    rates_tu, _st, _l = timed_passes(
        "cuckoo_tu", lambda: psa(threshold=TAU), CUCKOO_PASSES)
    outs = {t: os.path.join(tmp, f"cuckoo.{t}")
            for t in ("fi", "tu", "km", "kc", "dedup")}
    runs = {"fi": ("cuckoo_fi", lambda: psa(outs["fi"])),
            "tu": ("cuckoo_tu", lambda: psa(outs["tu"], threshold=TAU)),
            "km": ("cuckoo_km",
                   lambda: ceng.kmer_matches_file(reads, outs["km"])),
            "kc": ("cuckoo_kc",
                   lambda: ceng.kmer_conservation_file(reads, outs["kc"])),
            "dedup": ("cuckoo_dedup",
                      lambda: psa(outs["dedup"], deduplicate=True))}
    for path, fn in runs.values():
        timed_passes(path, fn, 1)
    mini = {"fi": fi["out"], "tu": tu["ascii"], "km": km["out"],
            "kc": kc["out"], "dedup": dedup["out"]}
    t0 = time.perf_counter()
    same = {t: (records_by_qid(outs[t]) == records_by_qid(mini[t])
                if t in ("fi", "tu", "dedup") else same_bytes(outs[t], mini[t]))
            for t in outs}
    log(f"[cuckoo] each output file equal to the mini engine's: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(same.values()):
        raise RuntimeError("a cuckoo-engine output differs from the mini "
                           "engine's")
    return dict(launches=launches, rate=statistics.median(rates_fi),
                rate_tu=statistics.median(rates_tu))


def array_pass(path, fn, num_reads):
    """fn() once, the launch counts reset just before and checked just
    after against PATH_KERNELS[path]. -> (result, reads/s, launches)."""
    need, forbid = PATH_KERNELS[path]
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"[{path}] {num_reads} reads in {dt:.3f} s: "
        f"{num_reads / dt:.1f} reads/s; launches {launches}")
    missing = [k for k in need if launches[k] <= 0]
    extra = [k for k in forbid if launches[k] > 0]
    if missing or extra:
        raise RuntimeError(f"{path} path: kernels not launched {missing}, "
                           f"launched and not expected {extra}")
    return res, num_reads / dt, launches


def phase_array(eng, ceng, codes, fi, tu, mirror):
    """The array API on the mini engine over the in-memory codes of every
    read, each call once: pseudoalign_codes FI and TU(TAU) must equal the
    FI and TU files read by read, pseudoalign_codes_dedup must equal FI,
    window_csids_codes must equal the host mirror on the mirror phase's
    reads; pseudoalign_codes FI on the cuckoo engine must equal it too.
    -> the FI path's launches and the rates."""
    n = len(codes)
    lens = np.full(n, codes.shape[1], dtype=np.int64)
    rates = {}
    lists, rates["fi"], launches = array_pass(
        "array_fi", lambda: eng.pseudoalign_codes(codes, lens), n)
    tu_lists, rates["tu"], _l = array_pass(
        "array_tu", lambda: eng.pseudoalign_codes(codes, lens, threshold=TAU),
        n)
    dd_lists, rates["dedup"], _l = array_pass(
        "array_dedup", lambda: eng.pseudoalign_codes_dedup(codes, lens), n)
    csids, rates["csids"], _l = array_pass(
        "array_csids", lambda: eng.window_csids_codes(codes, lens), n)
    c_lists, rates["fi_cuckoo"], _l = array_pass(
        "array_fi_cuckoo", lambda: ceng.pseudoalign_codes(codes, lens), n)
    t0 = time.perf_counter()
    fi_recs = ascii_records(fi["out"], set(range(n)))
    qids, offs, cat = tu["out"]
    tu_recs = {int(q): cat[offs[i]: offs[i + 1]] for i, q in enumerate(qids)}
    bad = {
        "fi": [q for q in range(n) if not np.array_equal(lists[q], fi_recs[q])],
        "tu": [q for q in range(n)
               if not np.array_equal(tu_lists[q], tu_recs[q])],
        "dedup": [q for q in range(n)
                  if not np.array_equal(dd_lists[q], lists[q])],
        "fi_cuckoo": [q for q in range(n)
                      if not np.array_equal(c_lists[q], lists[q])],
        "csids": [q for q, (hit, cs) in mirror.items()
                  if not (np.array_equal(csids[q][0], hit) and np.array_equal(
                      csids[q][1], np.where(hit, cs, np.uint32(INVALID_U32))))],
    }
    log(f"[array] {n} reads: FI, TU({TAU}) against the files, dedup and "
        f"cuckoo FI against FI, window csids against the host mirror on "
        f"{len(mirror)} reads: { {k: len(v) for k, v in bad.items()} } differ "
        f"({time.perf_counter() - t0:.1f} s)")
    if any(bad.values()):
        raise RuntimeError(f"array API results differ: "
                           f"{ {k: v[:10] for k, v in bad.items()} }")
    return dict(launches=launches, rates=rates, fi=lists, tu=tu_lists)

def expand_colours(cat, offs, G, C):
    """Each ascending colour list L of (cat, offs) over G colours ->
    {c < C : c % G in L}, ascending, as (cat, offs): the lists of the copies
    g + G j follow one another in j, each a prefix of L in the last."""
    reps = -(-C // G)
    cat = np.asarray(cat, dtype=np.int64)
    offs = np.asarray(offs, dtype=np.int64)
    sizes = np.diff(offs)
    sid = np.repeat(np.arange(len(sizes)), sizes)
    in_last = cat < C - G * (reps - 1)
    new_sizes = (reps - 1) * sizes + np.bincount(
        sid[in_last], minlength=len(sizes))
    new_offs = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(new_sizes, out=new_offs[1:])
    out = np.empty(int(new_offs[-1]), dtype=np.uint32)
    dest = new_offs[sid] + np.arange(len(cat)) - offs[sid]  # copy j = 0
    step = sizes[sid]
    vals = cat.astype(np.uint32)
    for j in range(reps - 1):
        out[dest] = vals
        dest += step
        vals += np.uint32(G)
    out[dest[in_last]] = vals[in_last]
    return out, new_offs


def phase_wide_index(idx):
    """The WIDE_C-colour index of phase 3's: colour c stands for genome
    c % G (G = phase 3's genome count), so each simulated genome is 8 or 9
    clonal isolates, as real Salmonella collections hold near-identical
    isolates; each set S becomes {c : c % G in S}. The dictionary, unitigs,
    u2c and colour-set ids stay the same."""
    t0 = time.perf_counter()
    G = idx.num_colors
    cat, offs = expand_colours(*idx.color_sets_decoded(), G, WIDE_C)
    wide = dataclasses.replace(
        idx, num_colors=WIDE_C,
        filenames=[f"{idx.filenames[c % G]}#{c // G}" for c in range(WIDE_C)],
        color_store=HybridStore.build(cat, offs, WIDE_C), _dense_bits=None,
        _cs_cache=None, _row_memo=None, _row_pos=None, _row_n=0)
    dcat, doffs = wide.color_sets_decoded()
    if not (np.array_equal(dcat, cat) and np.array_equal(doffs, offs)):
        raise RuntimeError("the wide colour store decodes to other sets")
    log(f"[wide] {WIDE_C} colours (genome c % {G}), C32 "
        f"{wide.words_per_set}: {wide.num_color_sets} colour sets of "
        f"{len(cat)} members "
        f"({len(cat) / len(idx.color_sets_decoded()[0]):.2f} x phase 3's), "
        f"dense matrix "
        f"{wide.num_color_sets * wide.words_per_set * 4} bytes, store "
        f"{wide.color_store.num_bytes()} bytes; built in "
        f"{time.perf_counter() - t0:.1f} s")
    return wide


def edge_bit_rows(rng, B, C32, Ts):
    """(B, C32) u32 rows for K9, seeded: the edge rows (empty, all ones,
    bit 31 of the first or the last word alone; for each T in Ts, T - 1, T
    and T + 1 set bits at random places, and T bits whose T-th is in a
    chunk's last word or the next chunk's first (words 31 and 32, 255 and
    256 where the row has them) with random bits after it), then dense,
    sparse and ANDed random words. Where B is smaller than the edge rows,
    B rows drawn at random from them and the random kinds."""
    nb = 32 * C32

    def spread(n, hi):  # n distinct set bits among the first hi
        r = np.zeros(nb, dtype=bool)
        r[rng.choice(hi, n, replace=False)] = True
        return r

    edge = [np.zeros(nb, dtype=bool), np.ones(nb, dtype=bool)]
    for w in (0, C32 - 1):
        edge.append(np.zeros(nb, dtype=bool))
        edge[-1][32 * w + 31] = True
    for T in Ts:
        edge += [spread(n, nb) for n in (T - 1, T, T + 1) if n <= nb]
        for w in (31, 32, 255, 256):
            if w < C32 and T - 1 <= 32 * w:
                r = spread(T - 1, 32 * w)
                r[32 * w + rng.integers(32)] = True
                r[32 * (w + 1):] = rng.random(nb - 32 * (w + 1)) < 0.3
                edge.append(r)
    edge = np.packbits(np.stack(edge).reshape(-1, C32, 32), axis=2,
                       bitorder="little").view("<u4").reshape(-1, C32)

    def rand(n):
        x = rng.integers(0, 1 << 32, size=(n, C32), dtype=np.uint64)
        x = x.astype(np.uint32)
        third = n // 3
        x[:third] &= rng.integers(0, 1 << 32, size=(third, C32),
                                  dtype=np.uint64).astype(np.uint32)
        x[third:2 * third] *= rng.random((third, C32)) < 0.02
        return x

    if B >= len(edge):
        return np.concatenate([edge, rand(B - len(edge))])
    pool = np.concatenate([edge, rand(3)])
    return pool[rng.choice(len(pool), B, replace=False)]


def check_k9_edges(dev) -> int:
    """K9 against its plain version on the seeded edge batches (C32 x B in
    K9_EDGE_C32 x EDGE_B, each at every T of K9_EDGE_T), bit for bit. ->
    the largest max_abs_err."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    err, checks, past, exact = 0, 0, 0, 0
    for C32 in K9_EDGE_C32:
        for B in EDGE_B:
            x = torch.from_numpy(edge_bit_rows(rng, B, C32, K9_EDGE_T).view(
                np.int32)).to(dev)
            for T in K9_EDGE_T:
                got = first_set_bits(x, T)
                want = first_set_bits_plain(x, T)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                if e:
                    log(f"[wide] first_set_bits edge batch B {B}, C32 {C32},"
                        f" T {T}: max_abs_err {e}")
                err = max(err, e)
                checks += 1
                past += int((want[0] > T).sum())
                exact += int((want[0] == T).sum())
            del x
    log(f"[wide] first_set_bits on {checks} seeded edge batches (C32 "
        f"{K9_EDGE_C32} x B {EDGE_B} x T {K9_EDGE_T}): {past} rows past T, "
        f"{exact} of exactly T bits, max_abs_err {err} "
        f"({time.perf_counter() - t0:.1f} s)")
    return err


def phase_first_set_bits(eng, weng, codes, parent):
    """K9 against first_set_bits_plain, bit for bit (tolerance 0): on one
    BATCH-read batch's K3 rows over the wide index (C32 = 143) at T_LIST,
    1 and 3, on seeded random rows with empty rows, all-ones rows, rows
    whose only bit is bit 31 and rows of more than T bits, and on the
    seeded edge batches (check_k9_edges); timed on the K3 rows at T_LIST,
    with `parent` in turns with the parent's K9, and at 1 and 3. -> the
    kernel's row."""
    dev = eng.device
    T = engine_mod.T_LIST
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    n = min(BATCH, len(codes))
    chunk[:n, :READ_LEN] = codes[:n]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    hit, csid, _ovf = query_window_csids_packed(
        eng.table, c2, bd, k=K, width=WIDTH, dparams=eng.dparams,
        probe_budget=eng._pb)
    rows = fi_and(weng.bits, hit, csid)
    C32 = rows.shape[1]
    g = torch.Generator(device=dev).manual_seed(WIDE_C)
    edge = torch.randint(-(1 << 31), 1 << 31, (4096, C32), dtype=torch.int32,
                         device=dev, generator=g)
    edge[:1024] &= torch.randint(-(1 << 31), 1 << 31, (1024, C32),
                                 dtype=torch.int32, device=dev, generator=g)
    edge[1024:2048] *= torch.rand((1024, C32), device=dev, generator=g) < 0.01
    edge[2048:2112] = 0
    edge[2112:2176] = -1
    edge[2176:2240] = 0
    edge[2176:2240, -1] = -(1 << 31)  # bit 31 only
    err = 0
    for name, x in (("K3 rows", rows), ("edge rows", edge)):
        for t in (T, 1, 3):
            got = first_set_bits(x, t)
            want = first_set_bits_plain(x, t)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            err = max(err, e)
            log(f"[wide] first_set_bits on {x.shape[0]} {name} x {C32} "
                f"words at T={t}: {int((got[0] > t).sum())} rows past T, "
                f"{int((got[0] == 0).sum())} empty, up to {int(got[0].max())}"
                f" colours a row, max_abs_err {e}")
    err = max(err, check_k9_edges(dev))
    B = rows.shape[0]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms, warm = in_turns(
        "wide", "first_set_bits", f"the K3 rows (B {B}, C32 {C32}, T {T})",
        (B * C32 * 4 + B * (T + 1) * 4,),
        lambda: first_set_bits(rows, T), flush, parent)
    for t in (1, 3):
        in_turns("wide", "first_set_bits",
                 f"the K3 rows (B {B}, C32 {C32}, T {t})",
                 (B * C32 * 4 + B * (t + 1) * 4,),
                 lambda t=t: first_set_bits(rows, t), flush, None)
    del flush
    return dict(
        name="first_set_bits", source="fulgor_tpu_torch/csrc/lists.cu",
        replaces="fulgor_tpu/ops/intersect.py:220", max_abs_err=err, ms=ms,
        warm_ms=warm,
        plain_ms=time_ms(lambda: first_set_bits_plain(rows, T), REPS_PLAIN),
        # the words read once, count and T ids written; a popcount and a
        # five-step scan a word, a find-first-set and a clear an id
        bytes=B * C32 * 4 + B * (T + 1) * 4,
        ops=B * C32 * 12 + B * T * 3)


def huge_paths(fetch) -> dict:
    """The PATH_KERNELS entry of each pass of phase 9b: regimes (a) and
    (c) on K6 alone (runs fetch FI, runs TU: no K3, K4 or K9); (b) by the
    fetch its engine took."""
    b = {"lists": ("wide_lists_fi", "wide_lists_tu"),
         "runs": ("wide_fi", "wide_tu"),
         "dense": ("wide_dense_fi", "wide_tu")}[fetch]
    return {("a", "fi"): "wide_nd_fi", ("a", "tu"): "wide_nd_tu",
            ("b", "fi"): b[0], ("b", "tu"): b[1],
            ("c", "fi"): "wide_nd_fi", ("c", "tu"): "wide_nd_tu"}


def phase_huge(tmp, device):
    """Phase 9b: fulgor_tpu_torch.demo150k's own functions at HUGE_GENOMES
    genomes and HUGE_READS reads in a temporary directory: the corpus, its
    index and reads made, then regimes (a) no dense matrix, (b) the default
    strategy and (c) the meta-diff index (where the host holds the
    conversion), FI and TU(TAU) each, one pass each with the self-check on
    every read ((c) every HUGE_SELFCHECK_C-th; no timed pass); (b)'s and (c)'s records equal (a)'s read
    for read, the dense matrix never made in (a) or (c), each pass's
    launches (reset just before it, read just after) those of its path.
    -> the figures."""
    from fulgor_tpu_torch import demo150k

    t0 = time.perf_counter()
    cache = os.path.join(tmp, "huge")
    made = demo150k.ensure_inputs(cache, HUGE_GENOMES, HUGE_READS)
    idx = Index.load(made["index"])
    t1 = time.perf_counter()
    res = demo150k.run_regimes(idx, made["reads"], device, selfcheck=1,
                               timed=False,
                               selfcheck_c=HUGE_SELFCHECK_C)
    paths = huge_paths(res["b_fetch"])
    for (regime, tool), path in paths.items():
        if res[regime] is None:
            continue
        launches = res[regime][tool]["warm"]["launches"]
        need, forbid = PATH_KERNELS[path]
        missing = [k for k in need if launches.get(k, 0) <= 0]
        extra = [k for k in forbid if launches.get(k, 0) > 0]
        log(f"[huge] ({regime}) {tool}: launches {launches}, those of path "
            f"{path}: {not (missing or extra)}")
        if missing or extra:
            raise RuntimeError(f"huge ({regime}) {tool}: kernels not "
                               f"launched {missing}, launched and not "
                               f"expected {extra}")
    shutil.rmtree(cache, ignore_errors=True)
    log(f"[huge] {HUGE_GENOMES} genomes, {HUGE_READS} reads: inputs made in "
        f"{t1 - t0:.1f} s (build {made['build_s']:.1f} s), regimes in "
        f"{time.perf_counter() - t1:.1f} s; (b) took the {res['b_fetch']} "
        f"fetch; (c) {'run' if res['c'] else 'skipped'}")
    return res


def same_records(a, b) -> bool:
    """Two ascii pseudoalignment files hold the same records (compared
    sorted by read id where their bytes differ)."""
    return same_bytes(a, b) or records_by_qid(a) == records_by_qid(b)


def check_expansion(path, lists, G, tool):
    """Every record of the wide file `path` equals the expansion to WIDE_C
    colours of the read's 512-colour list (phase 8's lists, equal to phase
    5's files). -> the file's lines sorted by read id."""
    t0 = time.perf_counter()
    lines = records_by_qid(path)
    n = len(lists)
    if len(lines) != n:
        raise RuntimeError(f"wide {tool}: {len(lines)} records for {n} reads")
    step = 1 << 15
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        part = lists[lo:hi]
        offs = np.zeros(hi - lo + 1, dtype=np.int64)
        np.cumsum([len(x) for x in part], out=offs[1:])
        cat, woffs = expand_colours(np.concatenate(part), offs, G, WIDE_C)
        want = native.format_psa_ascii(np.arange(lo, hi, dtype=np.uint32),
                                       cat, woffs)
        if b"\n".join(lines[lo:hi]) + b"\n" != want:
            bad = next(q for q, w in zip(range(lo, hi), want.splitlines())
                       if lines[q] != w)
            raise RuntimeError(f"wide {tool}: read {bad} is not the "
                               "expansion of its 512-colour record")
    log(f"[wide] {tool}: all {n} records equal the expansion of the "
        f"512-colour records ({os.path.getsize(path) / 1e6:.1f} MB, checked "
        f"in {time.perf_counter() - t0:.1f} s)")
    return lines


def phase_wide(idx, eng, codes, reads, tmp, array, mirror, parent):
    """Phase 9 on the WIDE_C-colour index: K9 on the card, then (a) the
    default strategy (runs fetch FI, K4 TU), checked read by read against
    the expansion of the 512-colour records and the host mirror; (b) the
    lists fetch forced at T_LIST and FORCED_T; (c) no dense matrix. ->
    K9's row, its launches, and the rates."""
    wide = phase_wide_index(idx)
    weng = QueryEngine(wide, device=eng.device)
    log(f"[wide] engine: ekpu {weng._ekpu:.2f}, use_runs_fetch "
        f"{weng.use_runs_fetch}, use_lists {weng.use_lists}, use_tu_runs "
        f"{weng.use_tu_runs}, run budget {weng._runs_R}")
    if not (weng.use_runs_fetch and not weng.use_lists
            and not weng.use_tu_runs):
        raise RuntimeError("the wide index does not take the runs fetch")
    row = phase_first_set_bits(eng, weng, codes, parent)
    finish_row(row, "wide")
    G = idx.num_colors
    out = {t: os.path.join(tmp, f"wide_{t}.tsv") for t in ("fi", "tu")}
    rates = {}
    torch.cuda.reset_peak_memory_stats()
    for tool, kw in (("fi", {}), ("tu", {"threshold": TAU})):
        def fn(o=os.devnull, kw=kw):
            # each pass starts with the runs fetch's key cache empty, as a
            # user's first file does
            weng._fi_key_cache.clear()
            return weng.pseudoalign_file(reads, o, **kw)

        r, _st, _l = timed_passes(f"wide_{tool}", fn, WIDE_PASSES)
        rates[tool] = statistics.median(r)
        profiled_pass(f"wide_{tool}", fn)
        timed_passes(f"wide_{tool}", lambda fn=fn, o=out[tool]: fn(o), 1)
    log(f"[wide] (a) peak card memory {torch.cuda.max_memory_allocated()} "
        f"bytes; FI key cache {len(weng._fi_key_cache)} keys")
    lines = {"fi": check_expansion(out["fi"], array["fi"], G, "FI"),
             "tu": check_expansion(out["tu"], array["tu"], G, f"TU({TAU})")}
    t0 = time.perf_counter()
    qs = sorted(mirror)
    bad = {}
    for tool, colours in (
            ("fi", lambda cs: weng._fi_from_csids(cs)),
            ("tu", lambda cs: weng._tu_from_csids(cs, TAU))):
        want = [colours(mirror[q][1]) for q in qs]
        offs = np.zeros(len(qs) + 1, dtype=np.int64)
        np.cumsum([len(w) for w in want], out=offs[1:])
        want = native.format_psa_ascii(
            np.array(qs, dtype=np.uint32), np.concatenate(want).astype(
                np.uint32), offs).splitlines()
        bad[tool] = [q for q, w in zip(qs, want) if lines[tool][q] != w]
    log(f"[wide] host mirror on phase 7's {len(mirror)} reads: FI "
        f"{len(bad['fi'])}, TU({TAU}) {len(bad['tu'])} differ "
        f"({time.perf_counter() - t0:.1f} s)")
    if bad["fi"] or bad["tu"]:
        raise RuntimeError(f"wide records differ from the host mirror: "
                           f"{ {k: v[:10] for k, v in bad.items()} }")
    del lines

    # FI by the dense path on the same index (K3, its (B, C32) rows fetched)
    weng.use_runs_fetch = False
    path = os.path.join(tmp, "wide_dense_fi.tsv")
    try:
        def dfn(o=os.devnull):
            return weng.pseudoalign_file(reads, o)

        r, _st, _l = timed_passes("wide_dense_fi", dfn, WIDE_PASSES)
        rates["dense_fi"] = statistics.median(r)
        timed_passes("wide_dense_fi", lambda: dfn(path), 1)
    finally:
        weng.use_runs_fetch = True
    same = same_records(path, out["fi"])
    log(f"[wide] dense FI: the same records as the runs fetch's: {same}; "
        f"median {rates['dense_fi']:.1f} reads/s against the runs fetch's "
        f"{rates['fi']:.1f} ({rates['fi'] / rates['dense_fi']:.3f} x)")
    if not same:
        raise RuntimeError("the dense FI path differs from the runs fetch")
    os.remove(path)

    # (b) the lists fetch, forced
    weng.use_lists = True
    keep_T = engine_mod.T_LIST
    launches9 = None
    try:
        for T in (keep_T, FORCED_T):
            engine_mod.T_LIST = T
            for tool, kw in (("fi", {}), ("tu", {"threshold": TAU})):
                path = os.path.join(tmp, f"wide_lists{T}_{tool}.tsv")

                def fn(kw=kw, o=path, T=T, tool=tool):
                    run = lambda: weng.pseudoalign_file(reads, o, **kw)
                    return (profiled_pass(f"wide_lists_{tool}", run)
                            if T == keep_T else run())

                _r, _st, launches = timed_passes(f"wide_lists_{tool}", fn, 1)
                if tool == "fi" and T == keep_T:
                    launches9 = launches
                same = same_records(path, out[tool])
                log(f"[wide] (b) lists fetch at T_LIST={T}, {tool}: the "
                    f"same records as the runs fetch's: {same}")
                if not same:
                    raise RuntimeError(f"the lists fetch at T={T} differs "
                                       f"({tool})")
                os.remove(path)
    finally:
        engine_mod.T_LIST = keep_T
        weng.use_lists = False

    # (c) no dense matrix on the host or the card
    del weng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    nd = dataclasses.replace(wide, _dense_bits=None, _row_memo=None,
                             _row_pos=None, _row_n=0)

    def forbidden(*_a):
        raise RuntimeError("the no-dense pass built the dense colour matrix")

    nd.dense_color_bits = forbidden
    nd.device_dense = forbidden
    neng = QueryEngine(nd, device=eng.device, dense_max_bytes=0)
    tables = sum(t.numel() * t.element_size() for t in neng.table)
    if not (neng.use_runs_fetch and neng.use_tu_runs):
        raise RuntimeError("dense_max_bytes=0 does not take the no-dense "
                           "paths")
    runs = (("fi", {}, out["fi"]), ("tu", {"threshold": TAU}, out["tu"]),
            ("dedup", {"deduplicate": True}, out["fi"]))
    for tool, kw, ref in runs:
        path = os.path.join(tmp, f"wide_nd_{tool}.tsv")
        _r, st, _l = timed_passes(
            f"wide_nd_{tool}",
            lambda kw=kw, o=path: neng.pseudoalign_file(reads, o, **kw), 1)
        same = same_records(path, ref)
        log(f"[wide] (c) no dense matrix, {tool}: the same records as (a)'s "
            f"{'FI' if tool == 'dedup' else tool.upper()}: {same}; "
            f"{st.get('num_run_ovf', 0)} reads past the run budget")
        if not same:
            raise RuntimeError(f"the no-dense {tool} output differs")
        os.remove(path)
    if neng._bits is not None or nd._dense_bits is not None:
        raise RuntimeError("a dense colour matrix exists after the no-dense "
                           "pass")
    dense = nd.num_color_sets * nd.words_per_set * 4
    log(f"[wide] (c) peak card memory {torch.cuda.max_memory_allocated()} "
        f"bytes, {torch.cuda.max_memory_allocated() - base} above the "
        f"{base} held before the pass; the engine's tables "
        f"{tables} bytes; the dense matrix would be {dense} bytes; engine "
        f"_bits None, index _dense_bits None, {nd._row_n} rows decoded on "
        f"demand")
    return dict(row=row, launches=launches9, rates=rates, index=wide,
                out=out)


def call_ms(fn, names, reps, flush=None):
    """(Mean device milliseconds of one call of fn: every kernel of the
    launch counts `names` that the call launches, summed, as
    torch.profiler records them over `reps` calls after a warm-up; median
    milliseconds of a call on the stream, CUDA events around it, launch
    gaps included; {kernel: mean device ms a call}). flush: a device
    buffer zeroed before each call, so that every call starts with a cold
    L2. A recording that holds fewer kernel events than the calls launched
    is discarded, as in kernel_ms; where every recording is, the first
    number is the stream's median too, and the dict is empty."""
    pats = [kernel_pattern(n) for n in names]
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = sum(kernels.launches[n] for n in names)
        ts = []
        prof = recording(lambda: ts.extend(event_ms(fn, reps, flush)),
                         attempt)
        launched = sum(kernels.launches[n] for n in names) - before
        evs = [e for e in prof.events()
               if any(p.search(e.name) for p in pats)]
        if len(evs) == launched:
            per = {}
            for e in evs:
                k = re.search(r"\w+_kernel(<[^>]*>)?", e.name).group(0)
                per[k] = per.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
            return (sum(per.values()) / reps, statistics.median(ts),
                    {k: round(v / reps, 4) for k, v in per.items()})
        log(f"[probes] {names}: the profiler recorded {len(evs)} of "
            f"{launched} launches (recording {attempt} of "
            f"{PROFILE_ATTEMPTS}), discarded")
    ms = statistics.median(event_ms(fn, reps, flush))
    log(f"[probes] {names}: no recording of {PROFILE_ATTEMPTS} held all "
        "launches; a call's time on the stream (CUDA events, launch gaps "
        "included) stands for its kernels' device time")
    return ms, ms, {}


def staged_tiers(prep, stage_a, vb1, RU):
    """-> (reads with undecided windows within RU, heavy reads, heavy reads
    past the B2 sub-batch) of a staged probe whose stage A gave
    stage_a = (hit, csid, cnt, need_sec)."""
    usable = prep[PREP_FIELDS.index("usable")]
    hit, _csid, cnt, need = stage_a
    B, Wk = hit.shape
    nU = (usable & ~hit & ((cnt > vb1) | need)).sum(dim=1)
    heavy = nU > min(RU, Wk)
    n_heavy = int(heavy.sum())
    return (int(((nU > 0) & ~heavy).sum()), n_heavy,
            max(0, n_heavy - max(1, B // 8)))


def edge_probe_reads(rng, text, B, L, all_text=False):
    """B seeded reads of L bases: three in four cut from the text `text`
    (every fifth of those with an N), the rest random, the first B // 4 (at
    most 16) all N (no usable window); with all_text every read cut from
    the text, no N."""
    chunk = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(B):
        if all_text or b % 4 != 3:
            p = int(rng.integers(0, len(text) - L))
            chunk[b] = text[p: p + L]
            if not all_text and b % 5 == 4:
                chunk[b, rng.integers(0, L)] = 4
    if not all_text:
        chunk[: min(16, B // 4)] = 4
    return chunk


def edge_probe_prep(chunk, dev):
    """The window prep of a (B, L) batch of codes, (B, L - K + 1): one
    window_prep at the next multiple of 32 bases, cut to its first L - K + 1
    windows (a window's fields are its own bases'); past MAX_WIDTH bases two
    pieces overlapping by K - 1, as the engine cuts a long read, the
    second's absolute positions pL and pR moved by its offset."""
    B, L = chunk.shape
    if L > MAX_WIDTH:
        step = MAX_WIDTH - K + 1
        a = edge_probe_prep(chunk[:, :MAX_WIDTH], dev)
        b = list(edge_probe_prep(chunk[:, step:], dev))
        for f in ("pL", "pR"):
            b[PREP_FIELDS.index(f)] = b[PREP_FIELDS.index(f)] + step
        return tuple(torch.cat([x, y], dim=1) for x, y in zip(a, b))
    W = -(-L // 32) * 32
    pad = np.full((B, W), 4, dtype=np.uint8)
    pad[:, :L] = chunk
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(pad))
    prep = window_prep(c2, bd, width=W, k=K, m=M)
    return tuple(t[:, : L - K + 1].contiguous() for t in prep)


def check_probe_edges(eng, text):
    """K10 at STAGED_EDGE and K11 at ANCHORED_EDGE on PROBE_EDGE's seeded
    batches and an all-heavy one, bit for bit (tolerance 0) against their
    plain versions; hit and ovf never both. Each batch logs its reads with
    no usable window; K10 its light, heavy and past-B2 reads (every read
    of the all-heavy batch heavy at (0, 8, 4, 1)), K11 its reads with more
    runs than RA. Raises unless the batches hold each of these somewhere.
    -> (K10's max_abs_err, K11's)."""
    tabs = eng.table
    m, num_slots = eng.dparams
    kw = dict(k=K, m=m, num_slots=num_slots)
    rng = np.random.default_rng(EDGE_READS + 10)
    batches = [(B, Wk, False) for B, Wk in PROBE_EDGE] + [
        (EDGE_READS, 130, True)]
    seen = dict.fromkeys(("no usable window", "runs past RA", "heavy",
                          "heavy past BH"), 0)
    err10 = err11 = 0
    t0 = time.perf_counter()
    for B, Wk, all_text in batches:
        prep = edge_probe_prep(
            edge_probe_reads(rng, text, B, Wk + K - 1, all_text), eng.device)
        usable = prep[PREP_FIELDS.index("usable")]
        bare = int((~usable.any(dim=1)).sum())
        seen["no usable window"] += bare
        what = (f"B = {B}, Wk = {Wk}" + (", all heavy" if all_text else "")
                + f", {bare} reads with no usable window")
        for vb1, vb2, sc, ru in STAGED_EDGE:
            ru = Wk if ru == "Wk" else ru
            bkw = dict(vb1=vb1, vb2=vb2, sc=sc, RU=ru, **kw)
            got = minidict2_staged_probe(*tabs, prep, **bkw)
            want = minidict2_staged_probe_plain(*tabs, prep, **bkw)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            err10 = max(err10, e)
            light, heavy, past = staged_tiers(prep, minidict2_probe(
                *tabs, prep, vb=vb1, stage1=True, **kw), vb1, ru)
            seen["heavy"] += heavy
            seen["heavy past BH"] += past
            log(f"[probes] staged_probe edge batch ({what}) at ({vb1}, "
                f"{vb2}, {sc}, {ru}): {light} light reads with undecided "
                f"windows, {heavy} heavy, {past} past the "
                f"{max(1, B // 8)}-read B2 sub-batch; {int(got[0].sum())} "
                f"hits, {int(got[2].sum())} ovf; max_abs_err {e}")
            if e or (got[0] & got[2]).any():
                raise RuntimeError("staged_probe disagrees with its plain "
                                   "version on an edge batch")
            if all_text and (vb1, ru) == (0, 1) and heavy != B:
                raise RuntimeError(f"the all-heavy batch has {heavy} heavy "
                                   f"reads of {B}")
        is_start, _end = _run_bounds(usable, prep[PREP_FIELDS.index("pL")],
                                     prep[PREP_FIELDS.index("pR")])
        runs = is_start.sum(dim=1)
        for RA, RU in ANCHORED_EDGE:
            RA, RU = (Wk if v == "Wk" else v for v in (RA, RU))
            got = minidict2_anchored_probe(*tabs, prep, RA=RA, RU=RU, **kw)
            want = minidict2_anchored_probe_plain(*tabs, prep, RA=RA, RU=RU,
                                                  **kw)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            err11 = max(err11, e)
            ra = anchor_budget(Wk, K, M) if RA is None else RA
            past = int((runs > ra).sum())
            seen["runs past RA"] += past
            log(f"[probes] anchored_probe edge batch ({what}) at (RA, RU) = "
                f"({ra}, {reprobe_budget(Wk, K, M) if RU is None else RU}): "
                f"{past} reads with more runs than RA (at most "
                f"{int(runs.max())}), {int(got[0].sum())} hits, "
                f"{int(got[2].sum())} ovf in {int(got[2].any(dim=1).sum())} "
                f"reads; max_abs_err {e}")
            if e or (got[0] & got[2]).any():
                raise RuntimeError("anchored_probe disagrees with its plain "
                                   "version on an edge batch")
    log(f"[probes] K10/K11 edge batches: {seen} over {len(batches)} "
        f"batches, all bit for bit, in {time.perf_counter() - t0:.1f} s")
    if not all(seen.values()):
        raise RuntimeError(f"the probes' edge batches miss a case: {seen}")
    return err10, err11


def phase_probe_kernels(eng, idx, codes):
    """K2's two modes, K10 at STAGED_BUDGETS and K11 at ANCHORED_BUDGETS
    against their plain versions, bit for bit, on phase 4's batch; the
    contracts against K2 (K10's decided windows equal K2 at (8, 4), K11's
    hits K2's at the defaults, hit and ovf never both); K10 at
    STAGED_BUDGETS[0] and K11 at its defaults timed whole: the device time
    of all the kernels a call launches, K2's included (L2 cold and warm),
    and the call's time on the stream. -> (K2's modes' max_abs_err,
    [K10's row, K11's row])."""
    dev = eng.device
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    n = min(BATCH, len(codes))
    chunk[:n, :READ_LEN] = codes[:n]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    slots, text32, skew = eng.table
    m, num_slots = eng.dparams
    tabs = (slots, text32, skew)
    kw = dict(k=K, m=m, num_slots=num_slots)
    Wk = WIDTH - K + 1
    lanes = BATCH * Wk
    prep = window_prep(c2, bd, width=WIDTH, k=K, m=M)
    usable = prep[PREP_FIELDS.index("usable")]

    # K2's modes
    err2 = 0
    for mode in ({"stage1": True, "vb": 1}, {"stage1": True, "vb": 2},
                 {"want_entry": True}):
        got = minidict2_probe(*tabs, prep, **mode, **kw)
        want = minidict2_probe_plain(*tabs, prep, **mode, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err2 = max(err2, e)
        what = (f"cnt > vb on {int((got[2] > mode['vb']).sum())} lanes, "
                f"need_sec on {int(got[3].sum())}" if "stage1" in mode else
                f"{int(got[4][got[0]].sum())} of {int(got[0].sum())} hits "
                "in reverse complement")
        log(f"[probes] minidict2_probe {mode}: {int(got[0].sum())} hits of "
            f"{lanes} lanes, {what}, max_abs_err {e}")
    if err2:
        raise RuntimeError("a mode of minidict2_probe disagrees with its "
                           "plain version")
    hit8, cs8, ovf8 = minidict2_probe(*tabs, prep, vb=8, sc=4, **kw)
    hitd, csd, _ovfd = minidict2_probe(*tabs, prep, **kw)

    # K10
    err10 = 0
    for vb1, vb2, sc, ru in STAGED_BUDGETS:
        bkw = dict(vb1=vb1, vb2=vb2, sc=sc, RU=ru, **kw)
        got = minidict2_staged_probe(*tabs, prep, **bkw)
        want = minidict2_staged_probe_plain(*tabs, prep, **bkw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err10 = max(err10, e)
        light, heavy, past = staged_tiers(prep, minidict2_probe(
            *tabs, prep, vb=vb1, stage1=True, **kw), vb1, ru)
        hit, csid, ovf = got
        ok = ~ovf
        bad = int((ovf8[ok] | (hit[ok] != hit8[ok])
                   | (csid[ok] != cs8[ok])).sum())
        log(f"[probes] staged_probe at ({vb1}, {vb2}, {sc}, {ru}): "
            f"{light} light reads with undecided windows, {heavy} heavy, "
            f"{past} past the {max(1, BATCH // 8)}-read B2 sub-batch; "
            f"{int(hit.sum())} hits, {int(ovf.sum())} ovf lanes in "
            f"{int(ovf.any(dim=1).sum())} reads; max_abs_err {e}; decided "
            f"lanes differing from minidict2_probe at (8, 4): {bad}")
        if e or bad or (hit & ovf).any():
            raise RuntimeError("staged_probe disagrees with its plain "
                               "version or with minidict2_probe at (8, 4)")

    # K11
    err11 = 0
    for RA, RU in ANCHORED_BUDGETS:
        got = minidict2_anchored_probe(*tabs, prep, RA=RA, RU=RU, **kw)
        want = minidict2_anchored_probe_plain(*tabs, prep, RA=RA, RU=RU,
                                              **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err11 = max(err11, e)
        hit, csid, ovf = got
        both = hit & hitd
        bad = int((csid[both] != csd[both]).sum())
        log(f"[probes] anchored_probe at (RA, RU) = "
            f"({RA or anchor_budget(Wk, K, M)}, "
            f"{RU or reprobe_budget(Wk, K, M)}): {int(hit.sum())} hits "
            f"({int(hitd.sum())} by minidict2_probe), {int(ovf.sum())} ovf "
            f"lanes in {int(ovf.any(dim=1).sum())} reads; max_abs_err {e}; "
            f"csid differing from minidict2_probe where both hit: {bad}")
        if e or bad or (hit & ovf).any():
            raise RuntimeError("anchored_probe disagrees with its plain "
                               "version or with minidict2_probe")

    # the edge batches
    t_edge = time.perf_counter()
    offs = idx.unitig_offs
    nb = int(offs[min(np.searchsorted(offs, PROBE_EDGE_BASES),
                      len(offs) - 1)])
    e10, e11 = check_probe_edges(eng, unpack2(idx.unitig_seq[: (nb + 31)
                                                             // 32], nb))
    err10, err11 = max(err10, e10), max(err11, e11)
    log(f"[probes] edge batches on {nb} bases of text: "
        f"{time.perf_counter() - t_edge:.1f} s")

    # times: each probe whole, as the main path calls it, and its own
    # kernels, with their byte bounds
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    vb1, vb2, sc, ru = STAGED_BUDGETS[0]
    RA, RU = anchor_budget(Wk, K, M), reprobe_budget(Wk, K, M)
    stage_a = minidict2_probe(*tabs, prep, vb=vb1, stage1=True, **kw)
    p10, p11 = (None, None) if PARENT_PROBES is None else PARENT_PROBES
    probes = (
        ("staged_probe", "staged.cu", 1356, 0, vb1,
         staged_stage_bytes(prep, stage_a, vb1, ru, tabs, kw),
         lambda: minidict2_staged_probe(*tabs, prep, vb1=vb1, vb2=vb2, sc=sc,
                                        RU=ru, **kw),
         p10 and (lambda: p10(*tabs, prep, vb1=vb1, vb2=vb2, sc=sc, RU=ru,
                              **kw)),
         lambda: minidict2_staged_probe_plain(*tabs, prep, vb1=vb1, vb2=vb2,
                                              sc=sc, RU=ru, **kw), err10),
        # K11 also reads pL and pR
        ("anchored_probe", "anchored.cu", 1500, 8, VERIFY_BUDGET,
         anchored_stage_bytes(prep, RA, RU),
         lambda: minidict2_anchored_probe(*tabs, prep, **kw),
         p11 and (lambda: p11(*tabs, prep, **kw)),
         lambda: minidict2_anchored_probe_plain(*tabs, prep, **kw), err11))
    rows = []
    for name, src, line, extra, vb, stages, fn, parent_fn, plain, err in (
            probes):
        names = (name, "minidict2_probe")
        if parent_fn is None:
            ms, stream_ms, per = call_ms(fn, names, REPS_KERNEL, flush)
            warm, warm_stream, _p = call_ms(fn, names, REPS_KERNEL)
            log(f"[probes] {name}: a call's kernels {ms:.4f} ms of device "
                f"time cold L2, {warm:.4f} warm; on the stream, launch gaps "
                f"included, {stream_ms:.4f} ms cold L2, {warm_stream:.4f} "
                "back to back")
        else:
            ms, warm, per = probe_in_turns(name, names, fn, parent_fn, flush)
        # the call's bound: K2's count of every lane (k2_bytes: prep, hit,
        # csid and ovf, slot rows, the text rows of the first min(vb, cnt)
        # candidates a lane, the skew pointer rows of gated lanes) and the
        # fields only this probe reads
        kb, old, trows, gated = k2_bytes(tabs, prep, kw, vb)
        nbytes = kb + lanes * extra
        log(f"[probes] {name}'s bound: {nbytes / 1e6:.1f} MB, "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms with {trows} text rows "
            f"(the first min({vb}, cnt) candidates a lane) and {gated} "
            f"gated lanes' pointer rows; {(old + lanes * extra) / 1e6:.1f} "
            f"MB, {(old + lanes * extra) / HBM_BYTES_PER_S * 1e3:.4f} ms "
            "without them (the earlier count)")
        for kname, b in stages.items():
            # a template's instances: the name without its arguments
            t = sum(v for k, v in per.items()
                    if k == kname or k.split("<")[0] == kname)
            bound = b / HBM_BYTES_PER_S * 1e3
            log(f"[probes] {name} stage {kname}: "
                + (f"{t:.4f} ms a call cold L2, " if t else "not recorded, ")
                + f"bound {bound:.4f} ms ({b / 1e6:.2f} MB)"
                + (f", {bound / t:.1%} of it" if t else ""))
        rows.append(dict(
            name=name, source=f"fulgor_tpu_torch/csrc/{src}",
            replaces=f"fulgor_tpu/ops/minidict2.py:{line}", max_abs_err=err,
            ms=ms, warm_ms=warm, plain_ms=time_ms(plain, REPS_PLAIN),
            bytes=nbytes, ops=lanes * 120))
    del flush
    for r in rows:
        finish_row(r, "probes")
    return err2, rows


def probe_in_turns(name, names, fn, parent_fn, flush):
    """A probe's call timed (call_ms) in turns with the parent's wrapper of
    it: parent, this, this, parent, each cold L2 and warm; logs each
    turn's kernels and the two trees' own kernels (K2's launches left out).
    -> this tree's (cold ms, warm ms, {kernel: cold ms a call}), the means
    of its two turns."""
    turns = {"this": [], "parent": []}
    for who in ("parent", "this", "this", "parent"):
        f = fn if who == "this" else parent_fn
        cold, stream, per = call_ms(f, names, REPS_KERNEL, flush)
        warm, _s, _p = call_ms(f, names, REPS_KERNEL)
        turns[who].append((cold, warm, stream, per))
        own = sum(v for k, v in per.items() if k.startswith(name))
        log(f"[probes] {name}, {who} tree's turn: a call's kernels "
            f"{cold:.4f} ms cold L2 ({warm:.4f} warm), on the stream "
            f"{stream:.4f}; its own kernels {own:.4f} ms; {per}")
    new = statistics.mean(t[0] for t in turns["this"])
    old = statistics.mean(t[0] for t in turns["parent"])

    def own(who):
        return statistics.mean(sum(v for k, v in t[3].items()
                                   if k.startswith(name))
                               for t in turns[who])
    # a call timed on the stream (call_ms) splits into no kernels: 0
    ratio = own("parent") / own("this") if own("this") else float("nan")
    log(f"[probes] {name} in turns (parent, this, this, parent): this tree "
        f"{new:.4f} ms a call cold L2, the parent's {old:.4f}: "
        f"{old / new:.2f}x; own kernels {own('this'):.4f} against "
        f"{own('parent'):.4f} ({ratio:.2f}x)")
    per = {}
    for t in turns["this"]:
        for k, v in t[3].items():
            per[k] = per.get(k, 0.0) + v / len(turns["this"])
    return new, statistics.mean(t[1] for t in turns["this"]), per


def staged_stage_bytes(prep, stage_a, vb1, RU, tabs, kw):
    """The bytes each of K10's own kernels must move at (vb1, RU) on one
    batch, and stage A's (K2's stage1 mode, k2_bytes) -> {kernel: bytes}.
    The split reads usable, hit, need (1 B) and cnt (4 B) a window, reads
    the 30 B of inputs of a light read's undecided windows and writes their
    31 B lanes, the usable flags of B1's other lanes, the undecided masks
    and the heavy words; the gather reads the heavy words and, for each of
    the first BH heavy reads, its mask and undecided windows' inputs, and
    writes its row (31 B a lane taken, 1 B else, past the heavy reads 1 B
    a lane) and the words' prefixes; the merge reads stage A's hit and
    csid, the masks, heavy words and prefixes, the tiers' 6 B of each
    undecided window a tier answers, and writes 6 B a window."""
    usable = prep[PREP_FIELDS.index("usable")]
    hit, _csid, cnt, need = stage_a
    B, Wk = usable.shape
    lanes, nw, nh = B * Wk, (Wk + 31) // 32, (B + 31) // 32
    RU, BH = min(RU, Wk), max(1, B // 8)
    nU = (usable & ~hit & ((cnt > vb1) | need)).sum(dim=1)
    heavy = nU > RU
    light = int(nU[~heavy].sum())
    rows = nU[heavy][:BH]
    used, und_h = rows.numel(), int(rows.sum())
    return {
        "minidict2_probe_kernel<true, false>": k2_bytes(
            tabs, prep, kw, vb1, out_bytes=10, skew=False)[0],
        "staged_probe_split_kernel": (lanes * 7 + light * 61
                                      + (B * RU - light) + B * nw * 4
                                      + nh * 4),
        "staged_probe_gather_kernel": (nh * 8 + used * nw * 4 + und_h * 61
                                       + used * Wk - und_h
                                       + (BH - used) * Wk),
        "staged_probe_merge_kernel": (lanes * 5 + B * nw * 4 + nh * 8
                                      + (light + und_h) * 6 + lanes * 6)}


def anchored_stage_bytes(prep, RA, RU):
    """The bytes each of K11's own kernels must move at (RA, RU) on one
    batch -> {kernel: bytes}: counts that the prep alone fixes, so the
    extension's text rows and the undecided windows' lanes (taken by the
    extension, answered in the merge) are left out. The anchors kernel
    reads usable (1 B a window) and pL, pR of usable windows (8 B), reads
    the 30 B of inputs of each anchor lane it takes and writes them, the 2
    RA usable flags a read and the run-start and run-end masks; the
    extension reads the masks, its used anchors' 19 B of K2 results, flo..
    rhi (16 B) of each window in its first RA runs, writes 6 B a window,
    RU usable flags a read and the undecided masks; the merge reads the
    masks."""
    usable = prep[PREP_FIELDS.index("usable")]
    B, Wk = usable.shape
    lanes, nw = B * Wk, (Wk + 31) // 32
    is_start, is_end = _run_bounds(usable, prep[PREP_FIELDS.index("pL")],
                                   prep[PREP_FIELDS.index("pR")])
    runid = torch.cumsum(is_start, dim=1) - 1
    n_a = int(is_start.sum(dim=1).clamp(max=RA).sum())
    taken = n_a + int((is_start & ~is_end & (runid < RA)).sum())
    in_run = int((usable & (runid < RA)).sum())
    return {
        "anchored_probe_anchors_kernel": (lanes + int(usable.sum()) * 8
                                          + taken * 60 + B * 2 * RA
                                          + B * nw * 8),
        "anchored_probe_extend_kernel": (B * nw * 8 + n_a * 2 * 19
                                         + in_run * 16 + lanes * 6 + B * RU
                                         + B * nw * 4),
        "anchored_probe_merge_kernel": B * nw * 4}


def k3_bytes(hit, csid, C32) -> int:
    """K3's bytes: hit and csid read once (5 B a window), one C32-word row
    a distinct csid of the positive windows, C32 words written a read."""
    distinct = torch.unique(csid[hit]).numel()
    return hit.numel() * 5 + distinct * C32 * 4 + hit.shape[0] * C32 * 4


def edge_fi_batch(rng, C32, Wk, dev):
    """A seeded K3 edge batch of EDGE_READS reads x Wk windows over 4,096
    random rows (a third all-ones): each read's windows in runs 1-11 long
    of csids from a pool of four (so that a csid recurs after other runs
    and the AND stays non-empty), broken by misses (20% of windows; half
    of them INVALID, half keeping the run's csid), the first 16 reads with
    no positive window."""
    S, B = 4096, EDGE_READS
    dense = (rng.integers(0, 1 << 32, (S, C32), dtype=np.uint64)
             | rng.integers(0, 1 << 32, (S, C32), dtype=np.uint64))
    dense[: S // 3] = 0xFFFFFFFF
    hit = rng.random((B, Wk)) < 0.8
    hit[:16] = False
    pick = np.repeat(rng.integers(0, 4, B * Wk),
                     rng.integers(1, 12, B * Wk))[: B * Wk].reshape(B, Wk)
    csid = np.take_along_axis(rng.integers(0, S, (B, 4)), pick, axis=1)
    csid = csid.astype(np.uint32)
    csid[~hit & (rng.random((B, Wk)) < 0.5)] = INVALID_U32
    dense = dense.astype(np.uint32).view(np.int32)
    return (torch.from_numpy(dense).to(dev), torch.from_numpy(hit).to(dev),
            torch.from_numpy(csid.view(np.int32)).to(dev))


def edge_runs_batch(rng, C32, R):
    """A seeded K12 edge batch of EDGE_READS reads x R run slots over 4,096
    random rows (a third all-ones), as the mesh hands K12 its runs: each
    read's valid runs scattered among INVALID slots, their csids from a
    pool of four a read (a csid recurs). Reads 0-15 hold no valid run,
    16-47 one to four (the truth table's), the rest any number up to R.
    Counts by read mod 4: 1-11 (as K6's lengths), summing to 1,024, 100 to
    3,000 each (totals past 2,047), any u16 (totals past 65,535); the
    int32 counts equal them but in every 8th read from 48 on, which holds
    counts in [-2^30, 2^30) (negative, and sums that wrap). npos: each
    read's total of u16 counts up to K12_EDGE_NPOS, but 0 for reads 0-7,
    1-130 for 8-15 (positive windows and no valid run) and past the table
    (K12_EDGE_NPOS + 1 + 0..3) in every 16th read from 16 on. -> numpy
    (dense (4096, C32) u32, run_csid (B, R) u32, counts int16, counts
    int32, npos int32)."""
    S, B = 4096, EDGE_READS
    dense = (rng.integers(0, 1 << 32, (S, C32), dtype=np.uint64)
             | rng.integers(0, 1 << 32, (S, C32), dtype=np.uint64))
    dense[: S // 3] = 0xFFFFFFFF
    nvalid = rng.integers(0, R + 1, B)
    nvalid[:16] = 0
    nvalid[16:48] = np.minimum(rng.integers(1, 5, 32), R)
    rc = np.full((B, R), INVALID_U32, np.uint32)
    c16 = np.zeros((B, R), np.uint16)
    pools = rng.integers(0, S, (B, 4))
    for b in range(B):
        n = int(nvalid[b])
        slots = rng.choice(R, n, replace=False)
        rc[b, slots] = pools[b, rng.integers(0, 4, n)]
        kind = b % 4
        if kind == 0:
            cnt = rng.integers(1, 12, n)
        elif kind == 1 and n:
            cuts = np.sort(rng.choice(np.arange(1, 1024), n - 1,
                                      replace=False))
            cnt = np.diff([0, *cuts, 1024])
        elif kind == 2:
            cnt = rng.integers(100, 3001, n)
        else:
            cnt = rng.integers(0, 1 << 16, n)
        c16[b, slots] = cnt
    c32 = c16.astype(np.int32)
    odd = np.arange(B) % 8 == 7
    odd[:48] = False
    big = rng.integers(-(1 << 30), 1 << 30, (int(odd.sum()), R))
    c32[odd] = np.where(rc[odd] != INVALID_U32, big, 0)
    npos = np.minimum(c16.astype(np.int64).sum(axis=1), K12_EDGE_NPOS)
    npos[:8] = 0
    npos[8:16] = rng.integers(1, 131, 8)
    npos[16::16] = K12_EDGE_NPOS + 1 + rng.integers(0, 4, len(npos[16::16]))
    return (dense.astype(np.uint32), rc, c16.view(np.int16), c32,
            npos.astype(np.int32))


def check_k12_edges(dev):
    """K12 on K12_EDGE's seeded edge batches, bit for bit against its plain
    versions: with K6's int16 counts and with int32 ones, mask mode at
    K4_EDGE_TAUS (the whole row's colours and a ragged C = 32 C32 - 5) and
    u16 mode. -> the largest max_abs_err."""
    rng = np.random.default_rng(EDGE_READS + 12)
    err = 0
    for C32, R in K12_EDGE:
        dense, rc, c16, c32, npos = (
            torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            .to(dev) for a in edge_runs_batch(rng, C32, R))
        C = 32 * C32 - EDGE_RAGGED if C32 > 1 else 32
        errs = []
        for cnt in (c16, c32):
            for tau in K4_EDGE_TAUS:
                tab = torch.from_numpy(
                    (np.arange(K12_EDGE_NPOS + 1, dtype=np.float64) * tau)
                    .astype(np.int64).astype(np.int32)).to(dev)
                got = runs_mask(dense, rc, cnt, npos, tab, C)
                want = runs_mask_plain(dense, rc, cnt, npos, tab, C)
                torch.cuda.synchronize()
                errs.append(max_abs_err((got,), (want,)))
            got = runs_scores(dense, rc, cnt, C)
            want = runs_scores_plain(dense, rc, cnt, C).to(torch.int16)
            torch.cuda.synchronize()
            errs.append(max_abs_err((got,), (want,)))
        err = max(err, *errs)
        nv = (rc != -1).sum(dim=1)
        log(f"[mesh] runs_scores on an edge batch (C32 = {C32}, C = {C}, R "
            f"= {R}, {int(nv.sum())} valid runs, {int((nv == 0).sum())} reads "
            f"with none, {int(((nv > 0) & (nv <= K4_TABLE_RUNS)).sum())} with "
            f"1-{K4_TABLE_RUNS}): int16 counts, mask at tau "
            f"{K4_EDGE_TAUS} and u16, then int32 counts: max_abs_err {errs}")
    return err


def k5_bytes(hit, csid, C32, C) -> int:
    """K5's bytes: hit and csid read once, one C32-word row a distinct
    csid of the positive windows, C int16 scores and the hit words written
    a read."""
    B, Wk = hit.shape
    distinct = torch.unique(csid[hit]).numel()
    return hit.numel() * 5 + distinct * C32 * 4 + B * (C * 2
                                                       + (Wk + 31) // 32 * 4)


def check_k4k5(eng, wide_bits, hit, csid, edges):
    """K4 and K5 against their plain versions, bit for bit: on phase 4's
    batch at the index's colours and against the wide index's rows at
    WIDE_C, K4 at tau TAU and 1.0; on K3's edge batches with C = 32 C32 -
    EDGE_RAGGED and read 16 (the first with positive windows) made
    positive in every window with csid 0, a row of every colour (its score
    Wk), K4 at K4_EDGE_TAUS. -> (K4's max_abs_err, K5's)."""
    cases = [("phase 4's batch", eng.bits, hit, csid, eng.idx.num_colors,
              (TAU, 1.0)),
             ("phase 4's batch, the wide index's rows", wide_bits, hit, csid,
              WIDE_C, (TAU, 1.0))]
    for dense, h, c in edges:
        h, c = h.clone(), c.clone()
        h[16] = True
        c[16] = 0
        cases.append(("an edge batch", dense, h, c,
                      32 * dense.shape[1] - EDGE_RAGGED, K4_EDGE_TAUS))
    err4 = err5 = 0
    for what, d, h, c, C, taus in cases:
        e4 = []
        for tau in taus:
            tab = eng._minscore_tab(tau, h.shape[1])
            got = tu_mask(d, h, c, tab, C)
            want = tu_mask_plain(d, h, c, tab, C)
            torch.cuda.synchronize()
            e4.append(max_abs_err((got,), (want,)))
        got = km_scores(d, h, c, C)
        want = km_scores_plain(d, h, c, C)
        torch.cuda.synchronize()
        e5 = max_abs_err(got, want)
        err4, err5 = max(err4, *e4), max(err5, e5)
        log(f"[k2-k5] tu_mask at tau {taus} and km_scores on {what} (C32 = "
            f"{d.shape[1]}, C = {C}, Wk = {h.shape[1]}): max score "
            f"{int(got[1].max())}, max_abs_err {e4} and {e5}")
    return err4, err5


def e2e_in_turns(eng, reads, parent):
    """TU(TAU) and kmer-matches passes to /dev/null: with `parent`, one
    pass each in turns with the parent's kernels (parent, this, this,
    parent); then a profiled pass of each on this tree's (up to
    E2E_PROFILES, until one holds every launch of K4 or K5): the card's
    busy time and K4's or K5's share of it."""
    tools = (("tu", "tu_mask", lambda: eng.pseudoalign_file(
        reads, os.devnull, threshold=TAU)),
        ("km", "km_scores", lambda: eng.kmer_matches_file(reads,
                                                          os.devnull)))
    for path, name, fn in tools:
        passes_in_turns("k2-k5", path, fn, parent)
        # the profiler may drop a pass's launches (kernel_ms): up to
        # E2E_PROFILES passes, until one holds every launch of `name`
        for attempt in range(1, E2E_PROFILES + 1):
            kernels.reset_launches()
            wall, busy, per_kernel, _st = device_busy(fn)
            launched = kernels.launches[name]
            if busy is None:
                log(f"[k2-k5] {path} profiled pass: {wall:.3f} s; card busy "
                    "not measured (the profiler recorded no device activity)")
                break
            n, ms = per_kernel[name]
            log(f"[k2-k5] {path} profiled pass {attempt}: {wall:.3f} s wall, "
                f"card busy {busy * 1e3:.2f} ms (idle share "
                f"{1 - busy / wall:.4f}); {name} {n} of {launched} launches "
                f"recorded, {ms:.3f} ms, {ms / (busy * 1e3):.1%} of the busy "
                f"time; per kernel (launches, device ms) {per_kernel}")
            if n == launched:
                break


def phase_k2_to_k5(eng, wide, codes, reads, parent):
    """Phase 10b: K2, K3, K4 and K5 as redesigned for the card, bit for
    bit (tolerance 0) against their plain versions. K2 in its three modes at
    the engine's two budgets and at K2_EDGE_BUDGETS, on phase 4's batch
    and on an odd count of lanes drawn from it (K10 and K11 launch it on
    compacted lanes); K3 on the batch's hits at C32 = 16 and against the
    wide index's rows (C32 = 143), at the (2, 2) grid's shard width on a
    data row's runs (hit = run csid valid), and on K3_EDGE's seeded edge
    batches; K4 and K5 as check_k4k5 says. Then each timed at the main
    path's shapes, L2 cold and warm: K2 at the engine's two budgets, in
    stage1 mode at K10's vb1 and in want_entry mode at K11's budget; K3 at
    C32 = 16, 143 and the shard width; K4 at tau TAU and K5 at C32 = 16
    and 143. With `parent` (a kernel library, --parent) each shape is
    timed in turns with the parent's kernels: parent, this, this, parent.
    Last, e2e_in_turns. -> (K2's max_abs_err, K3's, K4's, K5's)."""
    t0 = time.perf_counter()
    dev = eng.device
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    n = min(BATCH, len(codes))
    chunk[:n, :READ_LEN] = codes[:n]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    tabs = eng.table
    m, num_slots = eng.dparams
    kw = dict(k=K, m=m, num_slots=num_slots)
    Wk = WIDTH - K + 1
    prep = tuple(t.contiguous()
                 for t in window_prep(c2, bd, width=WIDTH, k=K, m=M))
    lanes = probe_lanes(prep)
    nl = lanes[0].numel()
    g = torch.Generator(device=dev).manual_seed(EDGE_READS)
    sel = torch.randperm(nl, device=dev, generator=g)[: nl // 3 | 1]
    odd = prep_of_lanes([t.reshape(-1)[sel].reshape(1, -1).contiguous()
                         for t in lanes])
    err2 = 0
    for vb, sc in (eng._pb, eng._pb_redo) + K2_EDGE_BUDGETS:
        errs = []
        for p in (prep, odd):
            for mode in ({}, {"stage1": True}, {"want_entry": True}):
                got = minidict2_probe(*tabs, p, vb=vb, sc=sc, **mode, **kw)
                want = minidict2_probe_plain(*tabs, p, vb=vb, sc=sc, **mode,
                                             **kw)
                torch.cuda.synchronize()
                errs.append(max_abs_err(got, want))
        err2 = max(err2, *errs)
        log(f"[k2-k5] minidict2_probe at ({vb}, {sc}), default, stage1 and "
            f"want_entry modes, on the batch's {nl} lanes, then on "
            f"{odd[0].numel()} drawn from them: max_abs_err {errs}")

    hit, csid, _ovf = minidict2_probe(*tabs, prep, vb=eng._pb[0],
                                      sc=eng._pb[1], **kw)
    wide_bits = wide.device_dense(dev)
    rc = compact_runs(hit, csid, Wk)[0]
    h = BATCH // GRID[0]
    rcr = rc[:h].contiguous()
    hr = rcr != -1
    shard = eng.bits[:, : eng.bits.shape[1] // GRID[1]].contiguous()
    batches = [("phase 4's batch", eng.bits, hit, csid),
               ("phase 4's batch, the wide index's rows", wide_bits, hit,
                csid),
               (f"a {GRID} grid's shard, {h} reads x {Wk} runs", shard, hr,
                rcr)]
    rng = np.random.default_rng(EDGE_READS)
    edges = [edge_fi_batch(rng, c, w, dev) for c, w in K3_EDGE]
    batches += [("an edge batch", *e) for e in edges]
    err3 = 0
    for what, d, hh, cc in batches:
        got = fi_and(d, hh, cc)
        want = fi_and_plain(d, hh, cc)
        torch.cuda.synchronize()
        e = max_abs_err((got,), (want,))
        err3 = max(err3, e)
        log(f"[k2-k5] fi_and on {what} (C32 = {d.shape[1]}, Wk = "
            f"{hh.shape[1]}): {int(got.ne(0).any(dim=1).sum())} of "
            f"{hh.shape[0]} reads non-empty, {int((~hh.any(dim=1)).sum())} "
            f"with no positive window, max_abs_err {e}")
    err4, err5 = check_k4k5(eng, wide_bits, hit, csid, edges)
    if err2 or err3 or err4 or err5:
        raise RuntimeError("K2, K3, K4 or K5 disagrees with its plain "
                           "version")

    (vb, sc), (vbr, scr) = eng._pb, eng._pb_redo
    vb1 = STAGED_BUDGETS[0][0]
    vbe, sce = VERIFY_BUDGET, SKEW_CAND  # K11's want_entry launch
    shapes = (
        ("minidict2_probe", f"({vb}, {sc})", k2_bytes(tabs, prep, kw, vb),
         lambda: minidict2_probe(*tabs, prep, vb=vb, sc=sc, **kw)),
        ("minidict2_probe", f"({vbr}, {scr})",
         k2_bytes(tabs, prep, kw, vbr),
         lambda: minidict2_probe(*tabs, prep, vb=vbr, sc=scr, **kw)),
        ("minidict2_probe", f"stage1 at vb {vb1}",
         k2_bytes(tabs, prep, kw, vb1, out_bytes=10, skew=False),
         lambda: minidict2_probe(*tabs, prep, vb=vb1, stage1=True, **kw)),
        ("minidict2_probe", f"want_entry at ({vbe}, {sce})",
         k2_bytes(tabs, prep, kw, vbe, out_bytes=19),
         lambda: minidict2_probe(*tabs, prep, want_entry=True, **kw)),
        ("fi_and", f"C32 = {eng.bits.shape[1]}",
         (k3_bytes(hit, csid, eng.bits.shape[1]),),
         lambda: fi_and(eng.bits, hit, csid)),
        ("fi_and", f"C32 = {wide_bits.shape[1]}",
         (k3_bytes(hit, csid, wide_bits.shape[1]),),
         lambda: fi_and(wide_bits, hit, csid)),
        ("fi_and", f"the shard's C32 = {shard.shape[1]}, {h} reads x {Wk}",
         (k3_bytes(hr, rcr, shard.shape[1]),),
         lambda: fi_and(shard, hr, rcr)))
    tab = eng._minscore_tab(TAU, Wk)
    C = eng.idx.num_colors
    for d, nc in ((eng.bits, C), (wide_bits, WIDE_C)):
        shapes += (
            ("tu_mask", f"C32 = {d.shape[1]}, tau {TAU}",
             (k3_bytes(hit, csid, d.shape[1]) + tab.numel() * 4,),
             lambda d=d, nc=nc: tu_mask(d, hit, csid, tab, nc)),
            ("km_scores", f"C = {nc}", (k5_bytes(hit, csid, d.shape[1], nc),),
             lambda d=d, nc=nc: km_scores(d, hit, csid, nc)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for name, what, nbytes, fn in shapes:
        in_turns("k2-k5", name, what, nbytes, fn, flush, parent)
    del flush

    # csrc/union.cu runs_smem: a read's u32 csids and Wk + 1 u16 ranks
    k45 = [8 * 4 * (w + (w + 2) // 2) for w in (Wk, 1024)]
    log(f"[k2-k5] dynamic shared memory a block of 8 reads: fi_and "
        f"{Wk * 4 * 8} B at Wk = {Wk}, {1024 * 4 * 8} B at Wk = 1,024; "
        f"tu_mask and km_scores {k45[0]} B, {k45[1]} B")
    e2e_in_turns(eng, reads, parent)
    log(f"[k2-k5] phase 10b took {time.perf_counter() - t0:.1f} s")
    return err2, err3, err4, err5


def phase_probes(idx, eng, reads, tmp, fi, tu, parent):
    """The two opt-in probes end to end: FI and TU(TAU) under the staged
    probe (FULGOR_PROBE_BUDGET at STAGED_BUDGETS[0], a new engine) and
    under the anchored one (pipeline.ANCHORED_PROBE on the mini engine,
    restored after): a profiled pass to a file, which must hold phase 5's
    FI or phase 6's TU records; the staged probe also PROBE_PASSES timed
    passes after a warm-up, in turns with as many one-pass passes of the
    same tool, so that the two rates come from the same stretch of the
    host's time (its speed drifts within a call). The anchored probe's
    rate and launches are its profiled pass's, 4-7x slower than phases
    5-6's unprofiled medians, which it is set against. With `parent`, one staged
    FI pass also in turns with the parent's kernels, its K10 and K11 by
    the parent's wrappers (passes_in_turns). -> {path: (launches, median
    reads/s)}."""
    budget = ",".join(map(str, STAGED_BUDGETS[0]))
    os.environ["FULGOR_PROBE_BUDGET"] = budget
    try:
        seng = QueryEngine(idx, device=eng.device)
    finally:
        del os.environ["FULGOR_PROBE_BUDGET"]
    if seng._pb != STAGED_BUDGETS[0]:
        raise RuntimeError(f"FULGOR_PROBE_BUDGET={budget} gave {seng._pb}")
    refs = {"fi": (fi["out"], fi["rate"]), "tu": (tu["ascii"], tu["rate"])}
    out = {}
    for probe, e in (("staged", seng), ("anchored", eng)):
        pipeline_mod.ANCHORED_PROBE = probe == "anchored"
        try:
            for tool, kw in (("fi", {}), ("tu", {"threshold": TAU})):
                path = f"{probe}_{tool}"

                def fn(o=os.devnull, kw=kw, e=e):
                    return e.pseudoalign_file(reads, o, **kw)

                ref, one_pass = refs[tool]
                if probe == "staged":
                    fn()  # warm-up
                    rates, base = [], []
                    for _ in range(PROBE_PASSES):
                        base += timed_passes(tool, lambda kw=kw: (
                            eng.pseudoalign_file(reads, os.devnull, **kw)),
                            1)[0]
                        r, _st, launches = timed_passes(path, fn, 1)
                        rates += r
                    one_pass, where = statistics.median(base), "in turns"
                    if tool == "fi":
                        passes_in_turns("probes", path, fn, parent)
                f = os.path.join(tmp, f"{path}.tsv")
                fr, _st, fl = timed_passes(
                    path, lambda fn=fn, f=f, path=path: profiled_pass(
                        path, lambda: fn(f)), 1)
                if probe == "anchored":
                    rates, launches = fr, fl
                    where = (f"phase {5 if tool == 'fi' else 6}'s; this "
                             "rate from its profiled pass to a file")
                same = records_by_qid(f) == records_by_qid(ref)
                rate = statistics.median(rates)
                log(f"[probes] {path}: median {rate:.1f} reads/s "
                    f"({min(rates):.1f}-{max(rates):.1f}) against the "
                    f"one-pass probe's {one_pass:.1f} ({where}, "
                    f"{rate / one_pass:.3f} x); the same records as phase "
                    f"{5 if tool == 'fi' else 6}'s file: {same}")
                if not same:
                    raise RuntimeError(f"{path} differs from the one-pass "
                                       "probe's records")
                os.remove(f)
                out[path] = (launches, rate)
        finally:
            pipeline_mod.ANCHORED_PROBE = False
    return out


def phase_mesh_kernels(eng, wide, codes, parent):
    """Phase 11 (a) on phase 4's batch, bit for bit (tolerance 0): K12 over
    K6's runs at R = Wk in mask (tau TAU) and u16 mode on every colour shard
    of the 512-colour dense at MESH_P and of the wide index's at P = 2, and
    on K12_EDGE's seeded edge batches (check_k12_edges); the reads its
    truth table takes logged. K13 with and without narrowing, on the batch
    and on one cell's reads; query_conservation_packed (K1 -> K2 -> K13)
    against its plain composition, small_csid on and off, its launches
    counted (K13's row's path_launches). K12 timed at the (2, 2) grid's
    shape (a data row's B / 2 reads, shard 0 of 2) in mask
    and u16 mode, with `parent` in turns with the parent's K12 and also on
    the wide index's shard 0 of 2; K13 at one cell's shape (B / 4 reads,
    with and without narrowing), with `parent` in turns. -> (K12's row,
    K13's row)."""
    dev = eng.device
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    n = min(BATCH, len(codes))
    chunk[:n, :READ_LEN] = codes[:n]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    hit, csid, _ovf = query_window_csids_packed(
        eng.table, c2, bd, k=K, width=WIDTH, dparams=eng.dparams,
        probe_budget=eng._pb)
    Wk = WIDTH - K + 1
    rc, _start, rl, _total, npos = compact_runs(hit, csid, Wk)
    tab = eng._minscore_tab(TAU, Wk)
    nruns = int((rc != -1).sum())
    err12 = 0
    shard0 = None
    for what, dense_np, C, Ps in (
            ("512", eng.idx.dense_color_bits(), eng.idx.num_colors, MESH_P),
            (str(WIDE_C), wide.dense_color_bits(), WIDE_C, (2,))):
        for P in Ps:
            padded = pad_bits_for_mesh(dense_np, P)
            w = padded.shape[1] // P
            for q in range(P):
                shard = torch.from_numpy(np.ascontiguousarray(
                    padded[:, q * w: (q + 1) * w]).view(np.int32)).to(dev)
                ncol = max(0, min(32 * w, C - 32 * w * q))
                got = (runs_mask(shard, rc, rl, npos, tab, ncol),
                       runs_scores(shard, rc, rl, 32 * w))
                want = (runs_mask_plain(shard, rc, rl, npos, tab, ncol),
                        runs_scores_plain(shard, rc, rl, 32 * w).to(
                            torch.int16))
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                err12 = max(err12, e)
                log(f"[mesh] runs_scores, {what} colours, shard {q} of {P} "
                    f"({w} words, {ncol} colours): "
                    f"{int(got[0].ne(0).any(dim=1).sum())} of {BATCH} reads "
                    f"pass tau {TAU}, max score {int(got[1].max())}, "
                    f"max_abs_err {e}")
                if P == 2 and q == 0:
                    if what == "512":
                        shard0 = shard
                    else:
                        wide_shard = shard
    err12 = max(err12, check_k12_edges(dev))
    nv = (rc != -1).sum(dim=1)
    table = (npos > 0) & (npos < tab.numel()) & (nv <= K4_TABLE_RUNS)
    log(f"[mesh] runs_scores (mask mode) takes {int(table.sum())} of phase "
        f"4's {BATCH} reads by its truth table (1-{K4_TABLE_RUNS} valid runs "
        f"or none, positive windows within the table), "
        f"{int(((npos > 0) & ~table).sum())} bit-sliced, "
        f"{int((npos == 0).sum())} with no positive window")
    # the (2, 2) grid's K12 launch: a data row's reads on shard 0 of 2
    h = BATCH // 2
    rcr, rlr, npr = rc[:h].contiguous(), rl[:h].contiguous(), npos[:h]
    w = shard0.shape[1]
    valid = rcr != -1
    distinct = torch.unique(rcr[valid]).numel()
    runs_h = int(valid.sum())
    # every run csid slot scanned (a valid run may stand in any slot), the
    # u16 count of each valid run, one row a distinct csid; mask mode: npos,
    # the table and the mask words written, u16 mode: 2 B a colour written
    slots = h * Wk * 4 + runs_h * 2
    bytes_mask = slots + distinct * w * 4 + h * 4 + (Wk + 1) * 4 + h * w * 4
    bytes_u16 = slots + distinct * w * 4 + h * 32 * w * 2
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms, warm = in_turns(
        "mesh", "runs_scores", f"the (2, 2) grid's shape, mask mode ({h} "
        f"reads x R = {Wk}, {runs_h} runs, {w}-word shard)", (bytes_mask,),
        lambda: runs_mask(shard0, rcr, rlr, npr, tab, 32 * w), flush, parent)
    in_turns("mesh", "runs_scores", "the same, u16 mode", (bytes_u16,),
             lambda: runs_scores(shard0, rcr, rlr, 32 * w), flush, parent)
    if parent is not None:  # the 4,546-colour index's shard 0 of 2
        ww = wide_shard.shape[1]
        in_turns("mesh", "runs_scores", f"{WIDE_C} colours' shard 0 of 2, "
                 f"mask mode ({ww} words)",
                 (slots + distinct * ww * 4 + h * 4 + (Wk + 1) * 4
                  + h * ww * 4,),
                 lambda: runs_mask(wide_shard, rcr, rlr, npr, tab, 32 * ww),
                 flush, parent)
    log(f"[mesh] the batch holds {nruns} runs")
    row12 = dict(
        name="runs_scores", source="fulgor_tpu_torch/csrc/union.cu",
        replaces="fulgor_tpu/ops/intersect.py:264", max_abs_err=err12,
        ms=ms, warm_ms=warm,
        plain_ms=time_ms(lambda: runs_mask_plain(shard0, rcr, rlr, npr, tab,
                                                 32 * w), REPS_PLAIN),
        bytes=bytes_mask, ops=runs_h * 32 * w + h * 32 * w)

    # K13
    err13 = 0
    b = BATCH // 4
    for rows in (BATCH, b):
        for narrow in (False, True):
            hh, cc = hit[:rows].contiguous(), csid[:rows].contiguous()
            got = pack_hits(hh, cc if narrow else None)
            want = pack_hits_plain(hh, cc if narrow else None)
            torch.cuda.synchronize()
            e = max_abs_err(tuple(x for x in got if x is not None),
                            tuple(x for x in want if x is not None))
            err13 = max(err13, e)
            log(f"[mesh] pack_hits on {rows} reads, narrowing {narrow}: "
                f"max_abs_err {e}")
    hb = hit[:b].contiguous()
    nw = (Wk + 31) // 32
    bytes13 = b * Wk + b * nw * 4
    ms13, warm13 = in_turns("mesh", "pack_hits", f"one {GRID} grid cell's "
                            f"shape ({b} reads x Wk {Wk}, no narrowing)",
                            (bytes13,), lambda: pack_hits(hb), flush, parent)
    in_turns("mesh", "pack_hits", f"the same, narrowing ({b} x Wk {Wk})",
             (bytes13 + b * Wk * 6,),
             lambda: pack_hits(hb, csid[:b].contiguous()), flush, parent)
    del flush
    row13 = dict(
        name="pack_hits", source="fulgor_tpu_torch/csrc/runs.cu",
        replaces="fulgor_tpu/ops/pipeline.py:338", max_abs_err=err13,
        ms=ms13, warm_ms=warm13,
        plain_ms=time_ms(lambda: pack_hits_plain(hb), REPS_PLAIN),
        bytes=bytes13, ops=b * Wk * 2)

    # query_conservation_packed against its plain composition
    slots, text32, skew = eng.table
    m, num_slots = eng.dparams
    prep = window_prep_plain(c2, bd, width=WIDTH, k=K, m=M)
    ph, pc, po = minidict2_probe_plain(
        slots, text32, skew, prep, k=K, m=m, num_slots=num_slots,
        vb=eng._pb[0], sc=eng._pb[1])
    for small in (False, True):
        kernels.reset_launches()
        got = query_conservation_packed(
            eng.table, c2, bd, k=K, width=WIDTH, small_csid=small,
            dparams=eng.dparams, probe_budget=eng._pb)
        launches = dict(kernels.launches)
        hw, c16 = pack_hits_plain(ph, pc if small else None)
        want = (hw, c16 if small else pc, po.any(dim=1))
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err13 = max(err13, e)
        log(f"[mesh] query_conservation_packed, small_csid {small}, against "
            f"its plain composition: max_abs_err {e}; launches {launches}")
        if launches["pack_hits"] != 1 or any(launches[n] < 1 for n in MINI):
            raise RuntimeError("query_conservation_packed did not launch K1, "
                               f"K2 and K13 once: {launches}")
    # K13's launches: the step that still launches it, small_csid on
    row13["max_abs_err"] = err13
    row13["path_launches"] = launches
    for r in (row12, row13):
        finish_row(r, "mesh")
    return row12, row13


def profiled_km(path, fn):
    """A mesh kmer-matches pass under the profiler: the card's busy time,
    each kernel's launches and device time; its launches checked against
    PATH_KERNELS[path], and the profiler's record too where it holds every
    launch of K6."""
    kernels.reset_launches()
    wall, busy, per_kernel, _st = device_busy(fn)
    launches = dict(kernels.launches)
    need, forbid = PATH_KERNELS[path]
    missing = [k for k in need if launches[k] <= 0]
    extra = [k for k in forbid if launches[k] > 0]
    if missing or extra:
        raise RuntimeError(f"{path} profiled pass: kernels not launched "
                           f"{missing}, launched and not expected {extra}")
    if busy is None:
        log(f"[mesh] {path} profiled pass: {wall:.3f} s; card busy not "
            "measured (the profiler recorded no device activity)")
        return
    log(f"[mesh] {path} profiled pass: {wall:.3f} s wall, card busy "
        f"{busy * 1e3:.2f} ms (idle share {1 - busy / wall:.4f}); launches "
        f"{launches}; per kernel (launches recorded, device ms) "
        f"{per_kernel}")
    if (per_kernel["compact_runs"][0] == launches["compact_runs"]
            and per_kernel["pack_hits"][0] != launches["pack_hits"]):
        raise RuntimeError(f"{path}: the profiler recorded "
                           f"{per_kernel['pack_hits'][0]} K13 launches of "
                           f"{launches['pack_hits']}")


def check_cells(path, launches, cells, batches, redo=0):
    """Each kernel of MESH_EXACT[path] launched once a cell a batch (the
    stream's batches, and the redo's where MESH_REDO runs the mesh's step
    for them), and the probe's K1 and K2 (or K7) at least that."""
    want = cells * (batches + (redo if path in MESH_REDO else 0))
    probe = ("cuckoo_lookup",) if path == "mesh_cuckoo_fi" else MINI
    bad = ([k for k in MESH_EXACT[path] if launches[k] != want]
           + [k for k in probe if launches[k] < want])
    if bad:
        raise RuntimeError(f"{path}: {cells} cells x ({batches} batches + "
                           f"{redo} redo batches), launches of {bad} are not "
                           f"{want}: {launches}")


def mesh_pass(path, fn, eng, num_reads):
    """fn() once under timed_passes, then its launches checked against the
    engine's cells, batches and redo batches. -> (stats, launches)."""
    batches = -(-num_reads // eng._batch_for_width(WIDTH))
    redo0 = eng.redo_batches
    _r, st, launches = timed_passes(path, fn, 1)
    check_cells(path, launches, eng.mesh.size, batches,
                eng.redo_batches - redo0)
    return st, launches


def phase_mesh(eng, cidx, wide, reads, codes, tmp, fi, tu, km, kc, dedup,
               array, wide_out, parent):
    """Phase 11 (b)-(d): the engine on a GRID of cells on the card of the
    one-device engine `eng` (FI and TU(TAU) timed in turns with it; with
    `parent`, TU(TAU) and kmer-matches passes on the GRID in turns with
    the parent's kernels) and on
    use_mesh=True's (1, 1) grid, the wide index and the cuckoo index on the
    GRID; every file equal to the one-device file named for it. -> the
    launches of the TU and kmer-matches passes on the GRID and the FI and
    TU medians."""
    idx = eng.idx
    num_reads = len(codes)
    grid = make_mesh([eng.device] * (GRID[0] * GRID[1]), *GRID)
    one = QueryEngine(idx, use_mesh=True)
    if one.mesh is None or one.mesh.shape != {"data": 1, "color": 1}:
        raise RuntimeError(f"use_mesh=True on one card gave "
                           f"{one.mesh and one.mesh.shape}")
    meng = QueryEngine(idx, mesh=grid)
    refs = {"fi": fi["out"], "tu": tu["ascii"], "dedup": dedup["out"],
            "km": km["out"], "kc": kc["out"]}
    tools = {"fi": ("pseudoalign_file", {}),
             "tu": ("pseudoalign_file", {"threshold": TAU}),
             "dedup": ("pseudoalign_file", {"deduplicate": True}),
             "km": ("kmer_matches_file", {}),
             "kc": ("kmer_conservation_file", {})}
    out = {"rates": {}}
    for tool in ("fi", "tu"):
        method, kw = tools[tool]

        def fn(o=os.devnull, method=method, kw=kw, e=meng):
            return getattr(e, method)(reads, o, **kw)

        fn()  # warm-up
        # in turns with one-device passes of the same tool: the host's
        # speed drifts within a call (phase 10)
        rates, base = [], []
        for _ in range(MESH_PASSES):
            base += timed_passes(tool, lambda fn=fn: fn(e=eng), 1)[0]
            redo0 = meng.redo_batches
            r, _st, launches = timed_passes(f"mesh_{tool}", fn, 1)
            check_cells(f"mesh_{tool}", launches, grid.size,
                        -(-num_reads // meng._batch_for_width(WIDTH)),
                        meng.redo_batches - redo0)
            rates += r
        profiled_pass(f"mesh_{tool}", fn)
        out["rates"][tool] = rate = statistics.median(rates)
        turns = statistics.median(base)
        p5 = (fi if tool == "fi" else tu)["rate"]
        log(f"[mesh] {tool} on the {GRID} grid: median {rate:.1f} reads/s "
            f"({min(rates):.1f}-{max(rates):.1f}) against one device's "
            f"{turns:.1f} in turns ({rate / turns:.3f} x) and phase 5's "
            f"median {p5:.1f} ({rate / p5:.3f} x)")
    passes_in_turns("mesh", "mesh_tu", lambda: meng.pseudoalign_file(
        reads, os.devnull, threshold=TAU), parent)

    def km_pass():
        return meng.kmer_matches_file(reads, os.devnull)

    def km_parent():
        return parent_mesh_km_pass(meng, km_pass)

    passes_in_turns("mesh", "mesh_km", km_pass, parent, km_parent,
                    "mesh_km_parent")
    # the card's time in a profiled kmer-matches pass: K6 launched, no K13
    # (with --parent also the parent's pass: an older parent's K6 then K13
    # a cell a batch)
    profiled_km("mesh_km", km_pass)
    if parent is not None:
        with using_library(parent):
            profiled_km("mesh_km_parent", km_parent)
    for name, e in (("grid", meng), ("one", one)):
        for tool, (method, kw) in tools.items():
            path = os.path.join(tmp, f"mesh_{name}.{tool}")
            st, launches = mesh_pass(
                f"mesh_{tool}", lambda m=method, kw=kw, p=path: getattr(
                    e, m)(reads, p, **kw), e, num_reads)
            if name == "grid":
                out[f"{tool}_launches"] = launches
            same = (same_bytes(path, refs[tool]) if tool in ("km", "kc")
                    else same_records(path, refs[tool]))
            log(f"[mesh] {name} {e.mesh.shape}: {tool} {st['num_redo']} "
                f"reads redone; the same "
                f"{'bytes' if tool in ('km', 'kc') else 'records'} as phase "
                f"5's file: {same}")
            if not same:
                raise RuntimeError(f"the meshed {tool} ({name}) differs from "
                                   "the one-device file")
            os.remove(path)
    # the array API's FI and TU on the grid's colour shards
    lens = np.full(num_reads, codes.shape[1], dtype=np.int64)
    for tool, kw in (("fi", {}), ("tu", {"threshold": TAU})):
        path = f"mesh_array_{tool}"
        lists, _rate, launches = array_pass(
            path, lambda kw=kw: meng.pseudoalign_codes(codes, lens, **kw),
            num_reads)
        check_cells(path, launches, grid.size,
                    -(-num_reads // meng._batch_for_width(WIDTH)))
        bad = [q for q in range(num_reads)
               if not np.array_equal(lists[q], array[tool][q])]
        log(f"[mesh] array API {tool} on the {GRID} grid: {len(bad)} reads "
            "differ from phase 8's")
        if bad:
            raise RuntimeError(f"the meshed array API's {tool} differs from "
                               f"the one-device one on reads {bad[:10]}")
    whole = [e.mesh.shape for e in (meng, one) if e._bits is not None]
    del one, meng

    # (c) the wide index, (d) the cuckoo index, on the grid
    weng = QueryEngine(wide, mesh=grid)
    if not (weng.use_runs_fetch and not weng.use_lists
            and not weng.use_tu_runs):
        raise RuntimeError("the meshed wide engine does not take the runs "
                           "fetch")
    cmeng = QueryEngine(cidx, mesh=grid)
    runs = (("mesh_wide_fi", weng, {}, wide_out["fi"]),
            ("mesh_wide_dense_fi", weng, {}, wide_out["fi"]),
            ("mesh_wide_tu", weng, {"threshold": TAU}, wide_out["tu"]),
            ("mesh_cuckoo_fi", cmeng, {}, os.path.join(tmp, "cuckoo.fi")))
    for path, e, kw, ref in runs:
        f = os.path.join(tmp, f"{path}.tsv")
        keep = e.use_runs_fetch
        if e is weng:  # dense FI: K3 on the shards instead
            e.use_runs_fetch = path != "mesh_wide_dense_fi"
        try:
            st, _l = mesh_pass(path, lambda e=e, f=f, kw=kw:
                               e.pseudoalign_file(reads, f, **kw), e,
                               num_reads)
        finally:
            e.use_runs_fetch = keep
        same = same_records(f, ref)
        log(f"[mesh] {path} on the {GRID} grid: {st['num_redo']} reads "
            f"redone, {st['elapsed']:.3f} s; the same records as "
            f"{'phase 6' if e is cmeng else 'phase 9'}'s file: {same}")
        if not same:
            raise RuntimeError(f"{path} differs from the one-device file")
        os.remove(f)
    whole += [e.mesh.shape for e in (weng, cmeng) if e._bits is not None]
    if whole:
        raise RuntimeError(f"meshed engines {whole} uploaded the whole dense "
                           "matrix")
    log("[mesh] no meshed engine uploaded the whole dense matrix")
    return out


def v1_work(tabs, prep, max_candidates):
    """What K14 reads on these inputs: (usable windows, windows with 1 to
    max_candidates candidates, candidate entries examined, strands whose q
    lies in the entry's span), the examination stopping at the first
    match, forward before reverse, as the kernel's loop does."""
    minval, iL, iR, flo, fhi, rlo, rhi, usable = prep
    NB = tabs.bucket_offs.shape[0]
    brow = u32(tabs.bucket_offs[u32(minval) & (NB - 1)])
    start, cnt = brow[..., 0], brow[..., 1]
    live = usable & (cnt > 0) & (cnt <= max_candidates)
    n_cand = int(live.sum())
    entries = strands = 0
    done = torch.zeros_like(usable)
    packs = ((u32(flo), u32(fhi)), (u32(rlo), u32(rhi)))
    for e in range(max_candidates):
        act = live & (e < cnt) & ~done
        entries += int(act.sum())
        ent = u32(tabs.entries[torch.where(act, start + e, 0)])
        wlo, ms = ent[..., 0], ent[..., 2]
        mpos = wlo + (ms & 0xFF)
        for q, (wl, wh) in zip((mpos - iL.long(), mpos - (K - M) + iR.long()),
                               packs):
            inb = act & ~done & (q >= wlo) & (q < wlo + (ms >> 8))
            strands += int(inb.sum())
            tlo, thi = _text_kmer(tabs.text16, torch.where(inb, q, 0), K)
            done |= inb & (tlo == wl) & (thi == wh)
    return int(usable.sum()), n_cand, entries, strands


def phase_v1(idx, eng, codes, mirror, seed):
    """Phase 12: the v1 minimizer dictionary of phase 3's unitigs, built on
    the host and put on the card once; its lookup (K8 -> K1 -> K14) on
    phase 4's batch at V1_CANDIDATES, on phase 7's mirror reads and on
    V1_LONG_READS reads of V1_LONG_LEN bases cut from the unitig text (in
    pieces of 1,024), the launch counts reset just before and checked just
    after. Each result equals the plain version on the card bit for bit;
    K14 alone equals its plain version on the same K1 fields; at 8
    candidates K14 equals K2 at the redo budget on every window both decide
    and the host mirror on every window it decides. -> K14's row."""
    dev = eng.device
    Wk = READ_LEN - K + 1
    t0 = time.perf_counter()
    total = int(idx.unitig_offs[-1])
    ucodes = unpack2(idx.unitig_seq, total)
    d = build_minidict(ucodes, idx.unitig_offs, idx.u2c_csid, K, M)
    t1 = time.perf_counter()
    tabs = d.to(dev)
    torch.cuda.synchronize()
    NE, NB = len(d.entries), len(d.bucket_offs)
    log(f"[v1] dictionary of {idx.num_unitigs} unitigs ({total} bases) built "
        f"in {t1 - t0:.1f} s, on the card in "
        f"{time.perf_counter() - t1:.2f} s: NE {NE} "
        f"({idx.num_kmers / NE:.2f} k-mers an entry), NB {NB}, "
        f"{d.num_bytes()} bytes ({d.num_bytes() / idx.num_kmers:.3f} B a "
        f"k-mer; entries {d.entries.nbytes}, buckets "
        f"{d.bucket_offs.nbytes}, text {d.text16.nbytes})")
    n = min(BATCH, len(codes))
    batch = torch.from_numpy(np.ascontiguousarray(codes[:n])).to(dev)
    mq = sorted(mirror)
    mreads = torch.from_numpy(np.ascontiguousarray(codes[mq])).to(dev)
    rng = np.random.default_rng(seed + 12)
    starts = rng.integers(0, total - V1_LONG_LEN, size=V1_LONG_READS)
    longr = torch.from_numpy(np.stack(
        [ucodes[s:s + V1_LONG_LEN] for s in starts])).to(dev)

    # the path: the wrapper on the three inputs, launches counted
    kernels.reset_launches()
    got = {c: tabs.lookup(batch, max_candidates=c) for c in V1_CANDIDATES}
    got_m = tabs.lookup(mreads, max_candidates=8)
    got_l = tabs.lookup(longr, max_candidates=8)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    calls = len(V1_CANDIDATES) + 2
    need, forbid = PATH_KERNELS["v1"]
    bad = ([k for k in need if launches[k] != calls]
           + [k for k in forbid if launches[k]])
    log(f"[v1] {calls} lookups: launches {launches}")
    if bad:
        raise RuntimeError(f"v1 path: launches of {bad} are not {calls} for "
                           f"K8/K1/K14 and 0 for the others: {launches}")

    kw = dict(k=K, m=M)
    errs = []
    for c in V1_CANDIDATES:
        want = lookup_minidict_batch_plain(*tables_of(tabs), batch,
                                           max_candidates=c, **kw)
        torch.cuda.synchronize()
        errs.append(max_abs_err(got[c], want))
        hit, _cs, ovf = got[c]
        log(f"[v1] max_candidates {c}: {int(hit.sum())} hits, "
            f"{int(ovf.sum())} ovf windows of {hit.numel()} "
            f"({int(ovf.any(dim=1).sum())} reads), max_abs_err against "
            f"the plain version {errs[-1]}")
    want_l = lookup_minidict_batch_plain(*tables_of(tabs), longr,
                                         max_candidates=8, **kw)
    torch.cuda.synchronize()
    errs.append(max_abs_err(got_l, want_l))
    log(f"[v1] {V1_LONG_READS} reads of {V1_LONG_LEN} bases in pieces of "
        f"1,024: {int(got_l[0].sum())} hits of {got_l[0].numel()} windows, "
        f"{int(got_l[2].sum())} ovf; max_abs_err against the unsplit plain "
        f"version {errs[-1]}")

    # K14 alone, on K1's fields of the packed batch (phase 4's shape)
    chunk = np.full((BATCH, WIDTH), 4, dtype=np.uint8)
    chunk[:n, :READ_LEN] = codes[:n]
    c2, bd = (torch.from_numpy(a).to(dev) for a in pack_reads_host(chunk))
    prep_all = window_prep(c2, bd, width=WIDTH, k=K, m=M)
    prep = tuple(prep_all[PREP_FIELDS.index(f)].contiguous()
                 for f in V1_FIELDS)
    mc = V1_CANDIDATES[0]
    k14 = minidict_v1_verify(*tables_of(tabs), prep, max_candidates=mc, **kw)
    want = minidict_v1_verify_plain(*tables_of(tabs), prep, max_candidates=mc,
                                    **kw)
    torch.cuda.synchronize()
    errs.append(max_abs_err(k14, want))
    same = all(torch.equal(a[:n, :Wk], b) for a, b in zip(k14, got[mc]))
    log(f"[v1] K14 alone on K1's fields at W={WIDTH}: max_abs_err "
        f"{errs[-1]}; its first {Wk} windows equal the wrapper's: {same}")
    if not same:
        raise RuntimeError("K14 on the packed batch differs from the wrapper")

    # against K2 at the redo budget, and the host mirror
    slots, text32, skew = eng.table
    m2, num_slots = eng.dparams
    vb, sc = eng._pb_redo
    hit2, csid2, ovf2 = (t[:n, :Wk] for t in minidict2_probe(
        slots, text32, skew, tuple(t.contiguous() for t in prep_all), k=K,
        m=m2, num_slots=num_slots, vb=vb, sc=sc))
    hit, csid, ovf = got[8]
    both = ~ovf & ~ovf2
    differ = int(((hit != hit2) | (csid != csid2))[both].sum())
    log(f"[v1] against minidict2_probe at ({vb}, {sc}) on the "
        f"{int(both.sum())} windows both decide: {differ} differ")
    if differ:
        raise RuntimeError("the v1 lookup differs from minidict2_probe")
    hit, csid, ovf = (t.cpu().numpy() for t in got_m)
    nbad = decided = 0
    for i, q in enumerate(mq):
        hit_w, cs_w = mirror[q]
        ok = ~ovf[i]
        decided += int(ok.sum())
        cs_w = np.where(hit_w, cs_w, np.uint32(INVALID_U32))
        nbad += int(((hit[i] != hit_w) | (csid[i].view(np.uint32) != cs_w))[
            ok].any())
    log(f"[v1] {len(mq)} mirror reads: {decided} windows decided, "
        f"{int(ovf.sum())} ovf; {nbad} reads differ from the host mirror")
    if nbad:
        raise RuntimeError("the v1 lookup differs from the host mirror")

    # time and bound
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms, warm = kernel_times(lambda: minidict_v1_verify(
        *tables_of(tabs), prep, max_candidates=mc, **kw),
        "minidict_v1_verify", flush)
    del flush
    chain = time_ms(lambda: tabs.lookup(batch, max_candidates=mc), REPS_PLAIN)
    plain = time_ms(lambda: lookup_minidict_batch_plain(
        *tables_of(tabs), batch, max_candidates=mc, **kw), REPS_PLAIN)
    lanes = prep[0].numel()
    n_us, n_cand, n_ent, n_str = v1_work(tabs, prep, mc)
    nbytes = (lanes + n_us * (4 + 8) + n_cand * 24 + n_ent * 12 + n_str * 12
              + lanes * 6)
    sectors = (lanes + n_us * (4 + 32) + n_cand * 24 + n_ent * 32
               + n_str * 32 + lanes * 6)
    log(f"[v1] K14 at max_candidates {mc} over {lanes} windows: {n_us} "
        f"usable (1 B usable each; 4 B minval + 8 B bucket row a usable "
        f"one), {n_cand} with 1-{mc} candidates (24 B of K1's fields), "
        f"{n_ent} entries examined (12 B), {n_str} strands in range (12 B "
        f"text row), 6 B written a window: {nbytes / 1e6:.1f} MB, bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; counted as 32-byte "
        f"sectors {sectors / 1e6:.1f} MB, "
        f"{sectors / HBM_BYTES_PER_S * 1e3:.4f} ms; the wrapper (K8, K1, "
        f"K14 and the piece copies) {chain:.4f} ms on the stream; phase 12 "
        f"{time.perf_counter() - t0:.1f} s")
    row = dict(
        name="minidict_v1_verify", source="fulgor_tpu_torch/csrc/minidict.cu",
        replaces="fulgor_tpu/ops/minidict.py:325", max_abs_err=max(errs),
        ms=ms, warm_ms=warm, plain_ms=plain, bytes=nbytes,
        # a candidate's bounds, shifts and compares; a window's bucket
        ops=n_ent * 40 + lanes * 10, launches=launches)
    finish_row(row, "v1")
    return row


def tables_of(tabs):
    return tabs.entries, tabs.bucket_offs, tabs.text16


def visible_cards():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def per_card_launches(fn, names):
    """fn() under torch.profiler. -> (fn's result, {card index: {kernel:
    launches}}) for the launch counts `names`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if kernel_pattern(name).search(e.name):
                card = per.setdefault(e.device_index, dict.fromkeys(names, 0))
                card[name] += 1
    return out, per


def phase_cards(idx, eng, reads, tmp, fi, tu, km, base_path, fi_lines):
    """Phase 13, where more than one card is visible: phase 11's GRID over
    distinct cards (the first four, or make_mesh()'s default over all
    where fewer), FI, TU(TAU) and kmer-matches each once to a file equal to
    the one-card file, every card of the grid launching K1, K2, K6 and K3
    in a profiled FI pass, FI timed in turns with the one-card engine; then
    QueryEngine(idx) with no device named, the default mesh over every
    card, FI and TU(TAU) to files equal to the one-card ones; then phase
    5c's processes of the CLI with no --device on the saved index
    (base_path): each on a card of its own, the merged file phase 5's FI
    records (fi_lines). -> the card count and the FI medians, or None on
    one card."""
    cards = visible_cards()
    n = len(cards)
    if n < 2:
        log(f"[cards] not run: {n} card visible (the mesh over distinct "
            "cards needs two or more)")
        return None
    grid = (make_mesh(cards[:4], *GRID) if n >= 4 else make_mesh(cards))
    meng = QueryEngine(idx, mesh=grid)
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    log(f"[cards] {n} cards visible: {names}; grid {grid.shape} over "
        f"{[str(d) for d in grid.devices]}")
    refs = (("fi", "pseudoalign_file", {}, fi["out"]),
            ("tu", "pseudoalign_file", {"threshold": TAU}, tu["ascii"]),
            ("km", "kmer_matches_file", {}, km["out"]))
    for tool, method, kw, ref in refs:
        path = os.path.join(tmp, f"cards.{tool}")
        st = getattr(meng, method)(reads, path, **kw)
        num_reads = st["num_reads"]
        same = (same_bytes(path, ref) if tool == "km"
                else same_records(path, ref))
        log(f"[cards] {tool} on {grid.size} cards: {st['num_reads']} reads "
            f"in {st['elapsed']:.3f} s, {st['num_redo']} redone; the same "
            f"{'bytes' if tool == 'km' else 'records'} as the one-card "
            f"file: {same}")
        if not same:
            raise RuntimeError(f"{tool} over distinct cards differs from the "
                               "one-card file")
        os.remove(path)
    names = ("window_prep", "minidict2_probe", "compact_runs", "fi_and")
    _, per = per_card_launches(
        lambda: meng.pseudoalign_file(reads, os.devnull), names)
    log(f"[cards] profiled FI pass: launches a card {per}")
    missing = [(str(d), k) for d in grid.devices for k in names
               if per.get(d.index, {}).get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"cards of the grid launched no {missing}")
    rates, base = [], []
    for _ in range(MESH_PASSES):
        st = eng.pseudoalign_file(reads, os.devnull)
        base.append(st["num_reads"] / st["elapsed"])
        st = meng.pseudoalign_file(reads, os.devnull)
        rates.append(st["num_reads"] / st["elapsed"])
    rate, one = statistics.median(rates), statistics.median(base)
    log(f"[cards] FI on {grid.size} cards {grid.shape}: median {rate:.1f} "
        f"reads/s ({min(rates):.1f}-{max(rates):.1f}) against one card's "
        f"{one:.1f} ({min(base):.1f}-{max(base):.1f}) in turns: "
        f"{rate / one:.3f} x")
    del meng
    deng = QueryEngine(idx)
    if deng.mesh is None or deng.mesh.size != n:
        raise RuntimeError(f"QueryEngine(idx) on {n} cards took mesh "
                           f"{deng.mesh and deng.mesh.shape}")
    for tool, method, kw, ref in refs[:2]:
        path = os.path.join(tmp, f"default.{tool}")
        st = getattr(deng, method)(reads, path, **kw)
        same = same_records(path, ref)
        log(f"[cards] default mesh {deng.mesh.shape} over {n} cards: {tool} "
            f"{st['num_reads']} reads in {st['elapsed']:.3f} s; the same "
            f"records as the one-card file: {same}")
        if not same:
            raise RuntimeError(f"the default mesh's {tool} differs from the "
                               "one-card file")
        os.remove(path)
    del deng
    torch.cuda.empty_cache()
    mh = phase_multihost(base_path, reads, tmp, fi_lines, device=None,
                         tag="cards")
    used = [d["card"] for d in mh["procs"]]
    log(f"[cards] {MULTIHOST_PROCS} processes with no --device on {n} "
        f"cards: on {used}")
    if len(set(used)) != MULTIHOST_PROCS or not all(
            u.startswith("cuda:") for u in used):
        raise RuntimeError(f"processes sharing a host took cards {used}, "
                           "not one card each")
    return dict(cards=n, rate=rate, one=one, reads=num_reads, procs=used)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomes", type=int, default=512)
    ap.add_argument("--reads", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=27)
    ap.add_argument("--cards-only", action="store_true",
                    help="phases 1-3, FI, TU and kmer-matches on the first "
                    "card, then phase 13 only (a machine with several cards)")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of an earlier commit (git archive into "
                    "a directory .gitignore lists): its kernels are built "
                    "and K2-K13 timed in turns with this tree's "
                    "(phases 4, 9, 10, 10b, 11), and TU, kmer-matches, the "
                    "mesh's TU and kmer-matches, cuckoo FI and staged FI "
                    "passes run in turns on both")
    args = ap.parse_args()
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    parent = parent_library(args.parent) if args.parent else None
    if args.parent:
        global PARENT_PROBES, PARENT_MESH_KM
        PARENT_PROBES = parent_probes(args.parent)
        PARENT_MESH_KM = parent_mesh_km()
    tmp = tempfile.mkdtemp(prefix="fulgor_smoke_")
    try:
        idx, codes, names, reads = phase_index(tmp, args.genomes, args.reads,
                                               args.seed)
        # the one-card engine: with no device named, several cards would
        # give the default mesh (phase 13 runs that)
        eng = QueryEngine(idx, device=torch.device("cuda", 0))
        if args.cards_only:
            fi = phase_fi(eng, reads, tmp)
            tu = phase_tu(eng, reads, tmp)
            km = phase_km(eng, reads, tmp)
            base_path = os.path.join(tmp, "mini.tfur")
            idx.save(base_path)
            cards = phase_cards(idx, eng, reads, tmp, fi, tu, km, base_path,
                                records_by_qid(fi["out"]))
            if cards is None:
                raise RuntimeError("--cards-only needs two or more cards")
            log(f"[done] {time.perf_counter() - t_start:.1f} s in all; "
                f"{cards['cards']} cards: FI {cards['rate']:.1f} reads/s "
                f"against one card's {cards['one']:.1f}")
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
            return
        log(f"[index] covered fraction {eng._covered_frac:.4f} -> probe "
            f"budget {eng._pb}, redo budget {eng._pb_redo}")
        ceng = QueryEngine(phase_cuckoo_index(idx, tmp), device=eng.device)
        rows, huge_errs = phase_kernels(idx, eng, ceng, codes, parent)
        fi = phase_fi(eng, reads, tmp)
        tu = phase_tu(eng, reads, tmp)
        km = phase_km(eng, reads, tmp)
        kc = phase_kc(eng, reads, tmp)
        dedup = phase_dedup(eng, reads, tmp)
        t_new = time.perf_counter()
        md = phase_meta_diff(idx, eng, reads, tmp, fi, tu)
        t_md = time.perf_counter()
        fi_lines = md.pop("fi_lines")
        mh = phase_multihost(md["path"], reads, tmp, fi_lines)
        log(f"[phases 5b-5c] meta-diff {t_md - t_new:.1f} s, multihost "
            f"{time.perf_counter() - t_md:.1f} s")
        cuckoo = phase_cuckoo(ceng, reads, tmp, fi, tu, km, kc, dedup,
                              parent)
        mirror = phase_mirror(idx, codes, names, tmp, args.seed, fi, tu, km,
                              kc, dedup)
        array = phase_array(eng, ceng, codes, fi, tu, mirror)
        wide = phase_wide(idx, eng, codes, reads, tmp, array, mirror,
                          parent)
        wide["row"]["max_abs_err"] = max(wide["row"]["max_abs_err"],
                                         huge_errs["first_set_bits"])
        rows.append(wide["row"])
        huge = phase_huge(tmp, eng.device)
        err2, probe_rows = phase_probe_kernels(eng, idx, codes)
        rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], err2)
        errs = dict(zip(("minidict2_probe", "fi_and", "tu_mask",
                         "km_scores"),
                        phase_k2_to_k5(eng, wide["index"], codes, reads,
                                       parent)))
        for r in rows:
            r["max_abs_err"] = max(r["max_abs_err"], errs.get(r["name"], 0))
        rows += probe_rows
        probes = phase_probes(idx, eng, reads, tmp, fi, tu, parent)
        rows += phase_mesh_kernels(eng, wide["index"], codes, parent)
        mesh = phase_mesh(eng, ceng.idx, wide["index"], reads, codes, tmp,
                          fi, tu, km, kc, dedup, array, wide["out"], parent)
        v1 = phase_v1(idx, eng, codes, mirror, args.seed)
        rows.append(v1)
        cards = phase_cards(idx, eng, reads, tmp, fi, tu, km, md["path"],
                            fi_lines)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; end to end "
        f"on {card}: FI {fi['rate']:.1f}, TU({TAU}) {tu['rate']:.1f}, "
        f"kmer-matches {km['rate']:.1f}, kmer-conservation "
        f"{kc['rate']:.1f}, --deduplicate {dedup['rate']:.1f} reads/s "
        f"(medians); meta-diff index FI {md['rates']['fi']:.1f}, TU({TAU}) "
        f"{md['rates']['tu']:.1f} reads/s (one pass each); "
        f"{MULTIHOST_PROCS} processes FI in {mh['wall']:.1f} s wall "
        f"(start-up included); cuckoo FI {cuckoo['rate']:.1f}, TU({TAU}) "
        f"{cuckoo['rate_tu']:.1f} reads/s (medians); array API "
        f"{ {k: round(v, 1) for k, v in array['rates'].items()} } reads/s "
        f"(one call each); {WIDE_C} colours: FI {wide['rates']['fi']:.1f} "
        f"(dense FI {wide['rates']['dense_fi']:.1f}), TU({TAU}) "
        f"{wide['rates']['tu']:.1f} reads/s (medians); {HUGE_GENOMES} "
        f"colours: regimes (a), (b: the {huge['b_fetch']} fetch) and (c) "
        f"{'run' if huge['c'] else 'skipped'}, every record equal; opt-in "
        f"probes "
        f"{ {k: round(v[1], 1) for k, v in probes.items()} } reads/s "
        f"(medians); on a {GRID} grid of this card FI "
        f"{mesh['rates']['fi']:.1f}, TU({TAU}) {mesh['rates']['tu']:.1f} "
        f"reads/s (medians)"
        + (f"; over {cards['cards']} cards FI {cards['rate']:.1f} reads/s "
           f"against one card's {cards['one']:.1f} in turns" if cards
           else ""))
    # each kernel's launches on its own path's last timed run; K13's on
    # query_conservation_packed's (phase 11 (a))
    rows_by_name = {r["name"]: r for r in rows}
    path_of = {"tu_mask": tu, "km_scores": km, "compact_runs": kc,
               "cuckoo_lookup": cuckoo, "pack_codes": array,
               "first_set_bits": wide,
               "staged_probe": {"launches": probes["staged_fi"][0]},
               "anchored_probe": {"launches": probes["anchored_fi"][0]},
               "runs_scores": {"launches": mesh["tu_launches"]},
               "pack_hits": {"launches": rows_by_name["pack_hits"][
                   "path_launches"]},
               "minidict_v1_verify": v1}
    out = []
    for r in rows:
        out.append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"],
            launches=path_of.get(r["name"], fi)["launches"][r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
