#!/usr/bin/env python3
"""Drive the PyTorch port's alignment (engine and `align` CLI), PairHMM,
edit-distance, NW, SW, MSA, read-mapper, clustering, distributed and
tools paths once on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of a checkout.  Phases, one line each:

1. device   the card (nvidia-smi name and power limit), torch and CUDA;
2. build    nvcc builds every kernel from csrc/, one nvcc per source,
            all started together;
3. parity   each kernel against its plain PyTorch version on the card,
            integer-equal: B=4096+37 at 152x152 (ACGT only; LOCAL, KSW
            and BANDED score-only with has_n True and False) and B=1000
            in the 216x328 bucket with Ns: local_sw SCORE/END/TB/SECOND and
            SCORE16/END16 (held to their int16 plain version and to the
            int32 modes, also at match=200, scores up to 30,400, and with
            match x Lq one below each int16 limit on pairs that reach it:
            127 x 258 = 32,766 for END16, 991 x 33 = 32,703 for SCORE16;
            then match x Lq just inside and just past each limit, at Lq
            168, must take the mode the gate gives, by launch counts: the
            ends END16 only under GENOMICS_TPU_INT16_CELLS=1, the scores
            SCORE16 only on N-free batches),
            global_sw SCORE/TB, semiglobal_sw END for all 16 HEAD x TAIL
            and TB for NONE/NONE, TARGET/TARGET, QUERY/QUERY and
            BOTH/BOTH (END and TB also under each HEAD with TAIL BOTH at
            1, 2, 4 and 8 threads a pair, and END16 / SCORE16 at 1, 2, 4
            and 8 threads per two pairs, besides the rule's),
            the LOCAL, GLOBAL and SEMI_GLOBAL walks to byte-CIGARs (the
            bytes that carry meaning, n_ops and the starts; SEMI_GLOBAL
            under each HEAD), also at their edges (walk_edges: M runs of
            63, 64 and 126, pads of 63 and 64, starts outside the cube,
            walks with no step, a LOCAL stop on the first step, chain-
            biased cubes) at B=37 and 4,133 in every mode and head,
            local_start fed the END kernel's result, semiglobal_start for
            all 16 HEAD x TAIL fed the semiglobal END kernel's, ksw_extend
            END/SCORE with seed scores h0 of 0-60 (and at Lq 1,000, where
            the wrapper keeps the rows in the global scratch), and banded_sw
            END/SCORE at bands of 1, 2 and 4 tiles; then both PairHMM
            kernels (bit-equal, both exact modes) at B=4096+37 ragged
            100-150 x 250-350 pairs, the wavefront also at B=1, 7, 64 of
            250 x 500, every lanes-a-pair x rows-a-lane shape of both
            (PAIRHMM_SHAPES) in the rule's handover layout and the forced
            global one at B=1, 7, 64, 256 and 1,061 with rlen at every
            round edge and ragged reads with clen past C (pairhmm_edges),
            64 records against the gold, and
            Myers at W=1, 3, 5 and 9 (uint32 and int64 masks, texts whole,
            3 bytes off a 16-byte boundary and with rows 13 bytes past
            Lt, all read in place);
4. slice    20,000 GASAL2-shaped pairs (150 bp reads cut from 200-300 bp
            targets, ~2% substitutions, ~0.5% 1-3 bp indels, a few Ns)
            through AlignEngine(device="cuda"), every kernel's launch
            count set to 0 just before and read just after each path,
            the plain version's host run-length encode made to raise
            on every card run (no_host_encode):
            LOCAL with traceback, ends only (END, and END16 under
            GENOMICS_TPU_INT16_CELLS=1), score-only (SCORE: every chunk
            holds Ns), score-only on N-free copies of the pairs (SCORE16;
            its host-clock wall beside the same run with SCORE forced, in
            turns) and ends at match=160 under the switch, past the int16
            range (END); then GLOBAL
            and SEMI_GLOBAL glocal (head=tail=TARGET), each with and
            without traceback; then the start passes (LOCAL, glocal and
            SEMI_GLOBAL NONE/BOTH compute_start) and LOCAL second_best
            with and without traceback; then KSW on 20,000 bwa-mem-style
            seed extensions (the read past a 19-31 bp seed against the
            reference past it, h0 = seed length x match, ~10% unrelated
            targets) and BANDED (band of 4 tiles) on the GASAL2-shaped
            pairs, each with ends and score-only.  Checked against the
            CPU engine on the first CPU_CHECK (512) pairs of each path, or
            twice that for LOCAL (every field, CIGAR bytes included) and the
            pure-Python golds, plus one GLOBAL run with
            models/assembly.py's scoring.  Then the same 20,000 pairs
            written to two FASTA files under all four header ops through
            `python -m genomics_tpu_torch align -q Q.fa -t T.fa` (its
            main()), twice: as is (END) and under
            GENOMICS_TPU_INT16_CELLS=1 (END16), each run's first 512
            lines byte-equal to the CLI's own --device cpu run, 64 held to
            the gold.  Then PairHMM over 256 GATK-
            shaped regions x 32 reads x 8 haplotypes (150 / 300 bp;
            65,536 pairs, 2.95 G cells) through
            models.pairhmm.compute_region_likelihoods (the inter-task
            kernel) and four regions' candidates through the wavefront,
            every likelihood held to the plain version on the card and 64
            to the gold; and the mapper's `ed` stage, 65,536 150 bp reads
            against 200 bp windows through
            ops.myers.edit_distance_semiglobal (W=5), held to the plain
            version and, on 64, to the plain DP;
5. timings  each kernel and its plain version on the card at bench.py's
            shape (B=65,536, 152x152; the four score / end modes and TB
            of local_sw as launches alone, in turns, TB held to the plain
            cube word for word; global_sw SCORE and TB as launches
            alone, in turns; semiglobal_sw END and TB (NONE/BOTH) as
            launches alone, in turns, TB's cube word for word and END
            under all 16 HEAD x TAIL held to the plain version, END's
            bound and lanes' share counted at the pairs' extents;
            semiglobal_start as a launch alone, held to
            its plain version under all 16 HEAD x TAIL flags; the lanes'
            share of the start passes' and BANDED's work in the pairs'
            order and as launched, local_start's cells counted at qr8
            columns a strip and at 152; local_start fed the END kernel's
            result and ordered by qr8 x tr8 as a launch alone; KSW with
            h0 = 30 as launches alone in both row layouts, in turns, each
            also as a ratio to local_sw SCORE; BANDED with a band of 4
            tiles, as benchmarks/run_all.py runs them, END and SCORE as
            launches alone in turns; local_start, BANDED, semiglobal_sw
            END / TB (glocal's TARGET/TARGET) and local_sw SCORE16 /
            END16 beside SCORE / END also at the engine's own launches
            (phase 4's pairs in its buckets), held to the plain versions,
            and the three walks there on the TB kernels' cubes, in turns,
            beside their bounds and sector floors;
            ptxas's resources of ksw_extend, global_sw, local_sw,
            semiglobal_sw, semiglobal_start, local_start and banded_sw),
            PairHMM at
            B=16,384 x 128 x 128 and Myers at B=16,384, Lp 96, Lt 152
            (run_all.py's shapes; the launch alone on inputs already in
            the kernel's layout, and the wrapper beside it), Myers also at
            the `ed` stage's launch (phase 4's 65,536 reads, W = 5), both
            PairHMM kernels also at the launches the
            paths make (pairhmm_timing_launches: the 65,536-pair region
            launch, a 256-pair candidate launch, 1, 7 and 64 pairs of 250
            x 500) with their serial steps a pair, the least time the card
            could take for
            the same work (the bound; see `bound` and OPS_PER_CELL), the
            four score / end modes again at the engine's 216 x 328 bucket
            over launches of 830 (the align CLI's) to 65,536 pairs (the
            sweep that decides whether SCORE16 may be the default), and
            the engine's pairs/s.

Then the NW, SW and MSA apps (`apps`), phases 3-5 of their own:
3. parity   nw_app at N = 1, 31, 33 and 257, at its stripe's height and
            one row more or less, and on grids of fewer warps than stripes
            (nw_stripe_edges: warps take a second ticket); the MSA fill at
            fill_edges (a strip's and a round's height +- 1, pair counts
            around the 8-pair sector group, 40,000 pairs, ragged lengths
            with 0, protein bytes the matrix does not name); sw_app at
            sw_edges (one window, windows shorter than L, a one-base and
            an empty fragment, two columns a thread) and at
            sw_stripe_edges (n = 0 and 1, a stripe's height +- 1, a tile's
            width +- 1 and below it, one window, windows shorter than L,
            a copy across a tile's edge; each on the card's resident
            blocks and on a grid of fewer blocks than stripes), the MSA
            fill and backtrack at msa_edges (one sequence, identical
            sequences, sequences longer and shorter than the center, one
            of length 1, a protein table; the host gold too, msa() on the
            card == on the CPU) and at backtrack_edges (a sequence of
            length 1, gap runs past a round's 32 lanes, ties of a vertical
            and a horizontal run, the fill's pitch not the pair count),
            msa() in chunks of 16 pairs == one call;
4. apps     nw.run(N=4,096) against nw_cpu and N=32,768 torch.equal to
            the plain version; sw.align of a 1,000 bp fragment against
            300,000 bp holding a mutated copy, and its first 200 bp in
            windows of 45,000 (7 windows: the rows of each spread over 17
            stripes), against golds.sw_best_alignment; msa() and `python -m
            genomics_tpu_torch msa` over run_all.py's 2,048 x 120, 1,024
            sequences of about 1,500 bp with substitutions and indels (a
            9.2 GB cube) and 512 x ~300 protein sequences under a synthetic
            NCBI matrix (the subcommand drops -p, as the JAX one does: its
            file is held to msa() without it), each fill and backtrack held
            to the plain version
            and 16 pairs to the host backtrack; every launch count set to 0
            before and read after;
5. timings  each app kernel and its plain version at those sizes (SW's
            wide windows too; NW also at nw.run's 4,096), with
            nw_app's and sw_app's CUDA launches a call (NW beside a CUDA
            graph's replay), the fill's G cells/s and GB written, the
            backtrack's steps, rounds, words loaded against the words a
            one-thread walk needs and sector floor, each beside its bound,
            NW / SW cells/s and MSA seqs/s.

Then the read mapper (`mapper_slice`), phases 3-5 of its own:
3. parity   fm_search against its plain version and the host
            FMIndex.backward_search at FM_EDGE_SPECS (texts of 1-4,096
            bp with the sentinel at a block's first and last row, one-
            letter texts), queries of 0-32 present and absent, and every
            1-32-gram of a 300 bp text;
4. mapper   a 12.07 Mbp genome of S288C's 16 chromosome lengths with 256
            copied segments of 1-5 kb, 16,384 reads of 150 bp (~1%
            substitutions, 1-3 bp indels in a tenth, ~0.1% Ns, half
            reverse) and 4,096 FR pairs (300-500 bp inserts, 5% with a
            random mate): ReadMapper(seeder="fmdev").map_batch(two_stage=
            "ed") (fm_search, myers, local_sw TB, tb_walk; every seed's
            range == plain on the card and == FMIndex.backward_search on
            the host), the q-gram map_batch, map_pairs with rescue and
            `python -m genomics_tpu_torch map` to SAM, to BAM and paired,
            every launch count set to 0 before and read after each path;
            the first 1,024 reads' Mappings (512 pairs) and the CLI's
            header and first 1,024 lines == the same run on the CPU, every
            BAM record == its SAM line, the share of reads within 2 bp of
            their origin; and run_all.py's bench_mapper shape;
5. timings  fm_search as a launch alone (a CUDA graph's replay, and
            from the host) at the mapper's seed launch and at 1,048,576
            queries of 16-32, its plain version, its bound
            (FM_OPS_PER_STEP / _RANK / _KEY / _LOOKUP over the steps,
            ranks, key codes and suffix table lookups; the bytes, with
            the index resident in L2) and its L2 sector floor; the
            mapper's reads/s, pairs/s and lines/s.

Then clustering (`cluster_slice`), phases 3-5 of its own:
3. parity   cluster_filter against window_filters_plain at
            FILTER_CARD_EDGES (one and eight copies of a word, wl = 7,
            one representative, one job, J not a multiple of 8 or 32,
            groups of 32 representatives, 256 x 3,001 at wl = 7; each
            with a job that is a representative and one whose words all
            miss); cluster_lcs against lcs_accept_plain over lcs_edge_reads
            (nets 1, 31-33, 63-65, 140 and 1,100 bases: one-word texts
            and a row of 35 words, a warp a pair; noisy copies with
            gaps, Ns, lowercase and U; one base; net 0), every read alone
            and S of 1, 7 and 256 against J not a multiple of 32, gated
            and not; a launch no pair passes, one every pair passes, 300
            columns against one representative (survivors across warps,
            groups part empty), nets 1-1,100 in one launch; each in the
            rule's layout and at G = 32 with the rows in a global
            scratch;
            ngia_lcs against banded_lcs_accept_plain over ngia_edge_reads
            at 0.95 and 0.9 (bands clipped at word 0 and at the row's
            end, empty bands, reads under 3 bases, a band of 65 words,
            the fma pairs 203 / 180 and 113 / 90; no pair passing, every
            pair passing, 300 columns of one family, lane groups and
            wide bands in one launch), as windows and as rounds;
4. cluster  cluster_reads over bench_cluster's 50,000 x 140 bp reads,
            speculate=256 (one cluster_filter launch a window and no
            plain filter on the path; the first two windows' accept
            matrices == the plain filters + LCS on the card; the int8
            min-sum == the host's; cluster <= arange, reps their own); at
            5,000 reads
            the speculative run == the serial run == device="cpu";
            cluster_distributed over bench_ngia's 8,000 x 1,200 bp,
            speculate=32 == the serial rounds; at 1,000 reads
            speculate=32 == device="cpu"; `python -m genomics_tpu_torch
            cluster` over 2,000 reads and `ngia` over 500: stdout and file
            == --device cpu; every launch count set to 0 before and read
            after each path;
5. timings  cluster_lcs at bench_cluster's first window's pass-2 columns,
            ngia_lcs at the first speculate=32 window (32 x 8,000) and at
            one serial round (1 x 8,000, round mode, the cluster array
            restored before each replay and the restores' time taken off),
            over bench_ngia's reads and over a mixed-length set (family
            lengths drawn from NGIA_MIXED), each replayed from a CUDA
            graph and launched from the host, beside its plain version,
            its bound (LCS_OPS_PER_WORD / _STEP, NGIA_OPS_PER_BIN over
            the pairs, steps and words the kernel runs) and its cycles a
            step (kernel ms x the SM clock / the longest live pair's
            active steps); cluster_filter at the first window (== plain)
            beside its bound (CF_OPS_PER_LOOKUP / _PAIR), its plain
            version and torch._int_mm of the window's indicators; the
            paths' reads/s.

Then the distributed slice (`dist_slice`, phase 7): NCCL at world size
1 in this process (a file:// rendezvous): sharded_pipeline_step over
bench_sharded_sw's 16,384 pairs of 152 x 152 a device with 16,384
PairHMM pairs of 128 x 128 (every field == the single-device entry
points, the first 4,096 pairs == the plain versions on the card; each of
its kernels launched; its wall, pairs/s and GCUPS), sharded_align_scores
at 16,384 x 152 x 152 (== local_align_scores and the plain version; its
time and GCUPS), cluster_distributed(mesh=) serial over bench_ngia's
8,000 x 1,200 bp (== one device without a mesh) and msa(mesh=) over
bench_msa's 2,048 x 120 set and an indel one (== msa()); then two gloo
ranks on the one card as child processes (this script with
--dist-worker, a timeout each), 16,384 pairs a rank: the same two calls,
nGIA's mesh rounds over 1,000 reads and msa(mesh=), == world size 1 on
the same inputs.  Then the tools (`tools_slice`, phase 8):
LighterCorrector at bench_corrector's 20,000 x 100 bp (the native walk's
reads/s, == the Python walk on 1,000 reads); local_assembly over 64
windows of 300 bp x 32 reads of 100 bp (64 wavefront launches; each
window's likelihoods == the plain version on the card, its haplotypes
and variants == device="cpu" in child interpreters); alndiff of the
mapper slice's fmdev and q-gram SAMs; the `lighter`, `assemble` and
`alndiff` CLIs == a second run (assemble: == --device cpu).

Then the script's wall, part by part (`6 wall`), one JSON line with the
kernels, the nvidia-smi line, and last {"ok": true, "device": {...}}.  With --profile, phases 3-5 give way to
one line per mapper path over 8,192 reads or 2,048 pairs (fmdev + ed,
q-grams, map_pairs, the `map` CLI to SAM), per engine path over the
20,000 pairs (LOCAL score-only on their N-free copies with SCORE16 and
with SCORE forced), the `align` CLI over them with and without
GENOMICS_TPU_INT16_CELLS=1, the PairHMM regions, the `ed` reads and
the clustering paths (cluster_reads at speculate=256, cluster_distributed
at speculate=32 and serial):
wall, device busy time and per-kernel device time (torch.profiler), and
the host functions with the most self time (cProfile).  Any failure
exits non-zero before the last line, and so does a child process (nvcc,
nvidia-smi, the PairHMM gold's workers) still running before the JSON
lines.  Needs one CUDA card, nvcc and g++; imports no JAX.  NCCL and
gloo rendezvous through files in a temporary directory: no network.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BENCH_B, BENCH_L = 65536, 152
BENCH_H0, BENCH_BAND = 30, 4   # benchmarks/run_all.py's ksw h0 and band
PAIRS = 20000  # GASAL2's test program aligns 20,000 reads
# pairs of each engine path held to the CPU engine (1,024 until the
# distributed and tools phases came, whose time this cut pays for)
CPU_CHECK = 512
GOLD_CHECK = 64   # pairs held to the pure-Python gold
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
INT32_LANES_PER_SM = 64    # Hopper's INT32 lanes per SM per clock
FP32_LANES_PER_SM = 128    # Hopper's FP32 lanes per SM per clock
KERNEL_SOURCES = ("local_sw", "global_sw", "semiglobal_sw", "local_start",
                  "semiglobal_start", "ksw_extend", "banded_sw", "tb_walk",
                  "pairhmm_intertask", "pairhmm_wavefront", "myers",
                  "fm_search", "cluster_lcs", "ngia_lcs", "cluster_filter")
# PairHMM and Myers at benchmarks/run_all.py's shapes (:145, :222)
PH_B, PH_L = 16384, 128
MY_B, MY_LP, MY_LT = 16384, 96, 152
# GATK HaplotypeCaller-sized regions for one card: 256 x 32 reads x 8
# haplotypes of 150 / 300 bp (benchmarks/run_all.py:573-605's generator)
REGIONS, REGION_READS, REGION_HAPS, REGION_RL, REGION_HL = 256, 32, 8, 150, 300
ED_PAIRS = 65536  # the mapper's `ed` stage: 150 bp reads vs 200 bp windows
F32_OPS_PER_CELL = 8       # PairHMM: 1 add, 4 multiplies, 3 fmas
# Myers: the integer operations its recurrence needs, counting any
# three-input bitwise function as one (a LOP3).  Per pattern word and text
# step, 11: the eq word of the text code (a select), Ev & Pv, the add with
# the previous word's carry in and its carry out (one IADD3), Xh =
# ((s ^ Pv) | Ev), Xv = Ev | Mv, Ph = Mv | ~(Xh | Pv), Mh = Pv & Xh, the
# two one-bit funnel shifts of Ph and Mh across words, Pv = Mh' |
# ~(Xv | Ph') and Mv = Ph' & Xv.  Per text step, once, 10: the 255 test
# and the tlen test, the score bit (two shifts by topb, two masks, one
# three-input add), and the best update (a compare, two selects).
MYERS_OPS_PER_WORD, MYERS_OPS_PER_STEP = 11, 10
# Integer operations per DP cell (per walk step for the walks), one per
# add, max, compare or select, as each kernel's source counts them; the
# score kernels as timed (has_n=False).  The packed-16-bit modes do the
# work of SCORE and END, 12 and 15 operations per cell, with two cells'
# worth in one lane-operation wherever the value is 16 bits: SCORE16's 12
# are all packed, so 6 lane-operations a cell; END16's 15 are 13 packed
# (the 11 of SCORE but its best max, then the best's compare and select)
# and the qend and tend selects in int32, so 13 / 2 + 2 = 8.5.
OPS_PER_CELL = {
    "local_sw.score": 12, "local_sw.end": 15, "local_sw.tb": 25,
    "local_sw.second": 20, "local_sw.score16": 12 / 2,
    "local_sw.end16": 13 / 2 + 2, "local_start": 15,
    "global_sw.score": 10, "global_sw.tb": 20,
    "semiglobal_sw.end": 14, "semiglobal_sw.tb": 24, "semiglobal_start": 14,
    "tb_walk": 25, "tb_walk.global": 25, "tb_walk.semiglobal": 25,
    "ksw.end": 24, "ksw.score": 19,
    "banded_sw.end": 19, "banded_sw.score": 13,
}
# local_sw's score / end modes at the engine's 216 x 328 bucket, from the
# align CLI's launches (5,000-pair chunks: about 830 pairs in the 216 x
# 216 bucket and 4,150 in this one) to the engine's largest; 16,384 pairs
# are 128 of SCORE's 128-thread blocks, 16,896 fill the 132 SMs
# threads per pair of local_start and semiglobal_sw, per two pairs of
# SCORE16 / END16 (what cuda_align.split_group takes)
SPLIT_GROUPS = (4, 8)
SWEEP_B = (830, 1024, 2048, 4096, 4150, 8192, 16384, 16896, 24576, 32768,
           49152, 65536)


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def int32_peak() -> float:
    """Integer operations per second of card 0: SMs x 64 INT32 lanes x
    the maximum SM clock nvidia-smi reports."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def fp32_peak() -> float:
    """f32 operations (one per add, multiply or fma) per second of card 0:
    SMs x 128 FP32 lanes x the maximum SM clock nvidia-smi reports."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_LANES_PER_SM * mhz * 1e6


@contextlib.contextmanager
def int16_cells():
    """GENOMICS_TPU_INT16_CELLS=1 within the block: LOCAL ends take END16
    wherever every value fits in int16."""
    old = os.environ.get("GENOMICS_TPU_INT16_CELLS")
    os.environ["GENOMICS_TPU_INT16_CELLS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["GENOMICS_TPU_INT16_CELLS"]
        else:
            os.environ["GENOMICS_TPU_INT16_CELLS"] = old


@contextlib.contextmanager
def int32_scores():
    """LOCAL score-only in SCORE within the block, where the gate would
    pick SCORE16: the baseline SCORE16's engine wall is compared with."""
    from genomics_tpu_torch.ops import cuda_align

    pick = cuda_align.local_mode
    cuda_align.local_mode = lambda ends, *a, **k: (
        pick(ends, *a, **k) if ends else "score")
    try:
        yield
    finally:
        cuda_align.local_mode = pick


def bound(ops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time in ms the card could take for `ops` operations at
    `peak` per second and `nbytes` of device-memory traffic, and which of
    the two sets it."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def band_windows(qlen: np.ndarray, tlen: np.ndarray, band: int) -> np.ndarray:
    """[B, strips] int64: the query tiles of banded.h's band in each strip
    ib of each pair, [max(0, ib - k_other + 1), min(band + ib, qr)) for
    ib < tr and none past it.  A row's sum is the pair's work (64 cells a
    tile), the max the widest window of live columns."""
    qr = (np.asarray(qlen, np.int64) + 7) // 8
    tr = (np.asarray(tlen, np.int64) + 7) // 8
    k_other = tr - (qr - band)
    ib = np.arange(int(tr.max()) if tr.size else 0)[None, :]
    lo = np.maximum(0, ib - k_other[:, None] + 1)
    hi = np.minimum(band + ib, qr[:, None])
    return np.where(ib < tr[:, None], np.maximum(hi - lo, 0), 0)


def band_cells(qlen: np.ndarray, tlen: np.ndarray, band: int) -> int:
    """Cells of banded.h's band over a batch, 64 to a tile."""
    return int(band_windows(qlen, tlen, band).sum()) * 64


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over paired integer tensors; raises if a
    shape or dtype differs."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def walk_work(*walk_args) -> tuple[int, int, int]:
    """(steps, words, bytes) of walk_cigars on walk_args, from the plain
    version: the walk's steps; the cube words it needs, counted low as
    the steps that move the column (M, X, I), each reading a word no
    earlier step read; and the CIGAR bytes it writes (n_ops)."""
    from genomics_tpu_torch.ops import tb_walk

    ops = tb_walk.tb_walk_plain(*walk_args[:6])[0]
    n_ops = tb_walk.walk_cigars_plain(*walk_args)[1]
    return (int((ops != 255).sum()), int(((ops <= 1) | (ops == 3)).sum()),
            int(n_ops.sum()))


def walk_err(got, want) -> int:
    """max_abs_err of two walk_cigars results: the bytes that carry
    meaning (tb_walk.valid_bytes), n_ops and the starts."""
    from genomics_tpu_torch.ops import tb_walk

    return max_abs_err([tb_walk.valid_bytes(*got[:2]), *got[1:]],
                       [tb_walk.valid_bytes(*want[:2]), *want[1:]])


@contextlib.contextmanager
def no_host_encode():
    """The engine's card path must not run the plain version's host loops
    (tb_walk.rle_cigar, tb_walk.cigars_from_walk): within this block they
    raise."""
    from genomics_tpu_torch.ops import tb_walk

    def host_loop(*_a, **_k):
        raise AssertionError("the card path ran a host run-length encode")
    saved = tb_walk.rle_cigar, tb_walk.cigars_from_walk
    tb_walk.rle_cigar = tb_walk.cigars_from_walk = host_loop
    try:
        yield
    finally:
        tb_walk.rle_cigar, tb_walk.cigars_from_walk = saved


def random_codes(rng, B, Lq, Lt, n_rate, related=True):
    """(q, t, qlen, tlen): [B, L] uint8 4-bit codes, half the pairs
    related (~8% mismatch), random lengths padded with N4, in-sequence Ns
    at n_rate, and the lengths as int32 [B]."""
    acgt = np.array([1, 3, 7, 4], np.uint8)
    q = acgt[rng.integers(0, 4, (B, Lq))]
    t = acgt[rng.integers(0, 4, (B, Lt))]
    if related:
        k = min(Lq, Lt)
        q[::2, :k] = t[::2, :k]
        flip = rng.random(q.shape) < 0.08
        q[flip] = acgt[rng.integers(0, 4, int(flip.sum()))]
    if n_rate:
        q[rng.random(q.shape) < n_rate] = 14
        t[rng.random(t.shape) < n_rate] = 14
    ql = rng.integers(Lq // 2, Lq + 1, B)
    tl = rng.integers(Lt // 2, Lt + 1, B)
    q[np.arange(Lq)[None, :] >= ql[:, None]] = 14
    t[np.arange(Lt)[None, :] >= tl[:, None]] = 14
    return q, t, ql.astype(np.int32), tl.astype(np.int32)


BASES = np.frombuffer(b"ACGT", np.uint8)


def read_from(rng, tgt, start):
    """A 150 bp read cut from tgt at start under gasal_pairs' error model:
    ~2% substitutions, ~0.5% indels of 1-3 bp, ~0.1% Ns."""
    read = list(tgt[start:start + 160])
    out = []
    k = 0
    while k < len(read):
        r = rng.random()
        if r < 0.0025:                      # deletion of 1-3 bases
            k += int(rng.integers(1, 4))
            continue
        if r < 0.005:                       # insertion of 1-3 bases
            out.extend(BASES[rng.integers(0, 4, int(rng.integers(1, 4)))])
        out.append(BASES[rng.integers(0, 4)] if rng.random() < 0.02
                   else read[k])
        k += 1
    read = np.array(out[:150], np.uint8)
    read[rng.random(len(read)) < 0.001] = ord("N")
    return read


def with_ns(rng, tgt):
    """A copy of tgt with ~0.05% of its bases set to N."""
    tgt = tgt.copy()
    tgt[rng.random(len(tgt)) < 0.0005] = ord("N")
    return tgt


def gasal_pairs(rng, n):
    """GASAL2 test-program-shaped pairs: 150 bp reads cut from random
    200-300 bp targets, ~2% substitutions, ~0.5% indels of 1-3 bp, and
    a few Ns in reads and targets."""
    qs, ts = [], []
    for _ in range(n):
        tl = int(rng.integers(200, 301))
        tgt = BASES[rng.integers(0, 4, tl)]
        start = int(rng.integers(0, tl - 160 + 1))
        qs.append(read_from(rng, tgt, start).tobytes())
        ts.append(with_ns(rng, tgt).tobytes())
    return qs, ts


def extension_pairs(rng, n, match):
    """bwa-mem-style seed extensions: a 150 bp read cut from a random
    200-300 bp target as gasal_pairs cuts it, its first k in [19, 31]
    bases the seed; the query is the read past the seed, the target the
    reference past the seed, and h0 = k x match.  About 10% of the pairs
    get an unrelated target of the same length, marked in `unrelated`.
    Returns (qs, ts, h0, unrelated)."""
    qs, ts, h0, unrelated = [], [], [], []
    for _ in range(n):
        tl = int(rng.integers(200, 301))
        tgt = BASES[rng.integers(0, 4, tl)]
        start = int(rng.integers(0, tl - 160 + 1))
        k = int(rng.integers(19, 32))
        qs.append(read_from(rng, tgt, start)[k:].tobytes())
        ref = tgt[start + k:]
        unrelated.append(rng.random() < 0.1)
        if unrelated[-1]:
            ref = BASES[rng.integers(0, 4, len(ref))]
        ts.append(with_ns(rng, ref).tobytes())
        h0.append(k * match)
    return qs, ts, np.array(h0, np.int32), np.array(unrelated)


COMPLEMENT = bytes.maketrans(b"ACGTN", b"TGCAN")
HEADER_OPS = ">", "<", "/", "+"


def engine_batches(qs, ts) -> dict:
    """{(Lq, Lt): (q, t, qlen, tlen)} as numpy: the pairs of each bucket
    of the engine (runtime.dispatch's buckets, without traceback one
    launch each), N4-padded 4-bit codes as the engine lays them out."""
    from genomics_tpu_torch.core.encoding import encode4
    from genomics_tpu_torch.runtime.dispatch import _bucket_of, default_buckets

    edges = default_buckets()
    groups = {}
    for a, b in zip(qs, ts):
        ea, eb = encode4(a), encode4(b)
        key = _bucket_of(len(ea), edges), _bucket_of(len(eb), edges)
        groups.setdefault(key, []).append((ea, eb))
    out = {}
    for (lq, lt), pairs in sorted(groups.items()):
        q = np.full((len(pairs), lq), 14, np.uint8)
        t = np.full((len(pairs), lt), 14, np.uint8)
        for k, (ea, eb) in enumerate(pairs):
            q[k, :len(ea)] = ea
            t[k, :len(eb)] = eb
        out[lq, lt] = (q, t, np.array([len(a) for a, _ in pairs], np.int32),
                       np.array([len(b) for _, b in pairs], np.int32))
    return out


def write_pair_fastas(dirname: str, qs, ts) -> tuple[str, str]:
    """Write the pairs to q.fasta and t.fasta under dirname, pair k's read
    under header op HEADER_OPS[k % 4] and its target under
    HEADER_OPS[(k // 4) % 4], each stored so that applying its op (reverse,
    complement or both; each its own inverse) gives back the pair."""
    def stored(seq: bytes, op: str) -> str:
        if op in "/+":
            seq = seq.translate(COMPLEMENT)
        return (seq[::-1] if op in "<+" else seq).decode()

    paths = (f"{dirname}/q.fasta", f"{dirname}/t.fasta")
    with open(paths[0], "w") as fq, open(paths[1], "w") as ft:
        for k, (q, t) in enumerate(zip(qs, ts)):
            qop, top = HEADER_OPS[k % 4], HEADER_OPS[(k // 4) % 4]
            fq.write(f"{qop}read{k}\n{stored(q, qop)}\n")
            ft.write(f"{top}target{k}\n{stored(t, top)}\n")
    return paths


def run_cli(argv) -> str:
    """stdout of `python -m genomics_tpu_torch` with argv, run in-process."""
    from genomics_tpu_torch import __main__ as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if cli.main(argv) != 0:
            raise AssertionError(f"{argv[0]} {argv} returned non-zero")
    return out.getvalue()


def n_free(seqs):
    """Copies of byte sequences with every N made an A."""
    return [x.replace(b"N", b"A") for x in seqs]


def zero_counts(*counts):
    for c in counts:
        for k in c:
            c[k] = 0


def assert_jobs_equal(got, want, what: str):
    """Every AlignmentJob field, CIGAR bytes included."""
    for k, (a, b) in enumerate(zip(got, want)):
        for f in ("score", "query_end", "target_end", "query_start",
                  "target_start", "score_second", "query_end_second",
                  "target_end_second"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{what}, pair {k}: {f} differs from "
                                     f"the CPU engine ({a} vs {b})")
        if (a.cigar is None) != (b.cigar is None) or (
                a.cigar is not None and not np.array_equal(a.cigar, b.cigar)):
            raise AssertionError(f"{what}, pair {k}: CIGAR differs from "
                                 f"the CPU engine")


def cigar_spans(cigar: str) -> tuple[int, int]:
    """(query bases, target bases) a CIGAR string covers."""
    n = {"M": 0, "X": 0, "D": 0, "I": 0}
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            n[ch] += num
            num = 0
    return n["M"] + n["X"] + n["I"], n["M"] + n["X"] + n["D"]


def profile_paths(paths, smi: str):
    """For each path (label, run, n) — run() drives it once over n pairs —
    the host-clock wall of three runs after a warm-up; the device time of
    one run under torch.profiler, in all and per kernel of csrc/; and the
    three host functions with the most self time under cProfile."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    for label, run, n in paths:
        run()
        walls = []
        for _ in range(3):
            t0 = time.time()
            run()
            walls.append(time.time() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy, kern = 0.0, {}
        for ev in prof.key_averages():
            # the program's spans recur on the card's timeline as user
            # annotations over the kernels they cover: not device work
            if not str(ev.device_type).endswith("CUDA") \
                    or ev.is_user_annotation:
                continue
            us = ev.self_device_time_total
            busy += us
            for name in KERNEL_SOURCES:   # global_sw is in semiglobal_sw
                if re.search(rf"(?<![A-Za-z]){name}(16|_split)?_kernel",
                             ev.key):
                    kern[name] = kern.get(name, 0.0) + us
        pr = cProfile.Profile()
        pr.enable()
        run()
        pr.disable()
        top = sorted(pstats.Stats(pr).stats.items(),
                     key=lambda kv: -kv[1][2])[:3]
        share = busy / 1e6 / min(walls)
        log("profile", f"{label}: wall {min(walls):.3f}-{max(walls):.3f} s; "
            f"device busy {busy / 1e3:.2f} ms ({100 * share:.1f}% of the "
            f"fastest wall); kernels " + ", ".join(
                f"{k} {v / 1e3:.2f} ms" for k, v in kern.items())
            + "; host self time " + ", ".join(
                f"{fn[2]} {st[2]:.3f} s" for fn, st in top)
            + f"; {n if isinstance(n, str) else f'{n} pairs'}, on {smi}")


def float_err(got, want) -> float:
    """Largest |kernel - plain| over paired f32 tensors: 0.0 exactly when
    every value is bit-equal (any other bit difference counts as nonzero);
    raises if a shape or dtype differs."""
    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            d = float((a.double() - b.double()).abs().nan_to_num(1.0).max())
            err = max(err, d, 1e-45)
    return err


def pairhmm_records(rng, n, rl=(100, 151), hl=(250, 351)):
    """n PairHMM records: reads of rl bases cut from random haplotypes of
    hl bases with ~2% substitutions (5% of the reads unrelated), quals of
    10-40; raw ASCII bytes."""
    recs = []
    for _ in range(n):
        hap = BASES[rng.integers(0, 4, int(rng.integers(*hl)))]
        k = int(rng.integers(*rl))
        at = int(rng.integers(0, len(hap) - k + 1))
        read = (hap[at:at + k].copy() if rng.random() > 0.05
                else BASES[rng.integers(0, 4, k)])
        flip = rng.random(k) < 0.02
        read[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
        recs.append(dict(read=read.tobytes(), hap=hap.tobytes(),
                         base_quals=rng.integers(10, 41, k),
                         ins_quals=rng.integers(10, 41, k),
                         del_quals=rng.integers(10, 41, k)))
    return recs


def regions_batch(rng, n, reads_per, haps_per, RL, HL):
    """benchmarks/run_all.py:573-605's GATK-shaped regions: a reference
    window, haps_per haplotypes with 2 substitutions each, reads_per reads
    of RL bases cut from it with 2 substitutions each."""
    regions = []
    for _ in range(n):
        hap0 = BASES[rng.integers(0, 4, HL)]
        haps = []
        for _h in range(haps_per):
            h = hap0.copy()
            h[rng.integers(0, HL, 2)] = BASES[rng.integers(0, 4, 2)]
            haps.append(h.tobytes())
        rds = []
        for _r in range(reads_per):
            o = rng.integers(0, HL - RL)
            rd = hap0[o:o + RL].copy()
            rd[rng.integers(0, RL, 2)] = BASES[rng.integers(0, 4, 2)]
            rds.append({"read": rd.tobytes(),
                        "base_quals": rng.integers(20, 40, RL),
                        "ins_quals": rng.integers(30, 45, RL),
                        "del_quals": rng.integers(30, 45, RL)})
        regions.append({"reads": rds, "haps": haps})
    return regions


# csrc/pairhmm.cuh's shapes, (entry point, lanes a pair, rows a lane):
# every shape the two PairHMM entry points are built for
# (cuda_pairhmm.INTERTASK_SHAPES, 32 lanes x cuda_pairhmm.WAVEFRONT_ROWS)
PAIRHMM_SHAPES = (("intertask", 4, 8), ("intertask", 8, 8),
                  ("intertask", 16, 8), ("intertask", 16, 10),
                  ("intertask", 32, 8), ("wavefront", 32, 4),
                  ("wavefront", 32, 5), ("wavefront", 32, 8))
PAIRHMM_EDGE_B = (1, 7, 64, 256, 1061)


def pairhmm_edges(rng, B, G, K, dev):
    """B PairHMM pairs whose rlen falls at every round edge of G lanes x K
    rows (1, K - 1, K, K + 1, GK n - 1, GK n, GK n + 1 for n = 1, 2), then
    rlen 0, rlen past R, clen 1, clen 0 and clen past C (cut at C, D0 from
    clen) at rlen R, 1, K + 1 and GK + 1, over and over; reads cut from
    their haplotypes with ~3% substitutions, R = 2 GK + 2, C = R + 8:
    ([reads, haps, rlen, clen], params) on dev."""
    from genomics_tpu_torch.ops import scan_pairhmm

    rr = G * K
    R, C = 2 * rr + 2, 2 * rr + 10
    edges = [1, K - 1, K, K + 1, rr - 1, rr, rr + 1, 2 * rr - 1, 2 * rr,
             2 * rr + 1]
    haps = BASES[rng.integers(0, 4, (B, C))]
    at = rng.integers(0, C - R + 1, B)
    reads = haps[np.arange(B)[:, None], at[:, None] + np.arange(R)]
    flip = rng.random((B, R)) < 0.03
    reads = np.where(flip, BASES[rng.integers(0, 4, (B, R))], reads)
    kinds = [(e, C) for e in edges] + [(0, C), (R + 3, C), (R, 1),
                                       (R, C + 5), (R, 0), (1, C + 3),
                                       (K + 1, C + 1), (rr + 1, 2 * C)]
    rlen, clen = (np.array([kinds[i % len(kinds)][j] for i in range(B)],
                           np.int32) for j in (0, 1))
    if B == 1:
        rlen[0] = rr + 1
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (reads, haps, rlen, clen)]
    p = scan_pairhmm.prepare_params(*(torch.from_numpy(
        rng.integers(10, 41, (B, R)).astype(np.int32)).to(dev)
        for _ in range(3)))
    return t, p


WALK_EDGE_L = 136   # a cube that holds an M run of 126
# (start row, start column, the cell of an X on an all-M cube, what it
# shows); GLOBAL walks from (tlen, qlen), so these rows and columns are
# GLOBAL's tlen and qlen too
WALK_EDGES = (
    (136, 136, None, "from outside the cube: M runs 63, 63, 11"),
    (136, 136, 73, "an M run of exactly 63"),
    (136, 136, 72, "an M run of exactly 64"),
    (136, 136, 10, "an M run of exactly 126"),
    (99, 36, None, "a D pad of exactly 63"),
    (100, 36, None, "a D pad of exactly 64"),
    (36, 99, None, "an I pad of exactly 63"),
    (36, 100, None, "an I pad of exactly 64"),
    (149, 20, None, "a start row past the cube (SEMI_GLOBAL's TAIL_T row)"),
    (-1, 5, None, "no step: an I pad only"),
    (5, -1, None, "no step: a D pad only"),
    (40, 40, None, "LOCAL: an M, then the score stop"),
)


def walk_edges(rng, B: int, dev, L: int = WALK_EDGE_L):
    """(tb [L/8, L, B] int32, score, qend, tend [B] int32) on dev: B walks
    over L x L nibble cubes.  With L = WALK_EDGE_L the first pairs are
    WALK_EDGES' (all M but for the X, LOCAL's score the match there); the
    rest start at random cells of random cubes, a quarter each uniform,
    mostly D chains (D runs across word rows), mostly I chains (I runs
    longer than a window) and all M, LOCAL's score random in -20..40."""
    nibs = rng.integers(0, 16, (B, L, L)).astype(np.uint8)
    kind = np.arange(B) % 4
    chain = rng.random((B, L, L)) < 0.8
    nibs[(kind == 1)[:, None, None] & chain] = 2 | 4   # D, extended
    nibs[(kind == 2)[:, None, None] & chain] = 3 | 8   # I, extended
    nibs[kind == 3] = 0
    i0 = rng.integers(0, L, B).astype(np.int32)
    j0 = rng.integers(0, L, B).astype(np.int32)
    score = rng.integers(-20, 41, B).astype(np.int32)
    if L == WALK_EDGE_L:
        for b, (i, j, x, _) in enumerate(WALK_EDGES[:B]):
            nibs[b] = 0
            if x is not None:
                nibs[b, x, x] = 1
            i0[b], j0[b] = i, j
            score[b] = 1   # AlignmentParams' match: LOCAL stops at once
    cube = np.zeros((L // 8, L, B), np.uint32)
    for r in range(8):
        cube |= nibs[:, r::8, :].transpose(1, 2, 0).astype(np.uint32) << (4 * r)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (cube.view(np.int32), score, j0, i0)]


def pairhmm_launch(kernel: str, t, p, G: int, K: int, force_global=False):
    """One counted launch of a PairHMM kernel on inputs t, p through its
    layout and launch helpers, G lanes a pair (32 for the wavefront) and K
    rows a lane."""
    from genomics_tpu_torch.ops import cuda_pairhmm

    if kernel == "intertask":
        return cuda_pairhmm.launch_intertask(cuda_pairhmm.intertask_layout(
            *t, p, shape=(G, K), force_global=force_global))
    return cuda_pairhmm.launch_wavefront(cuda_pairhmm.wavefront_layout(
        *t, p, rows_per_lane=K, force_global=force_global))


def pairhmm_steps(G: int, K: int, R: int, C: int) -> int:
    """Serial steps of one full-length R x C pair's chain when G lanes a
    pair hold K rows each: every round of G K rows takes C steps plus one
    for each lane after the first that holds rows.  G = 1, K = 8 is the
    first inter-task design (a step: one column of an 8-row strip), G =
    32, K = 1 the first wavefront."""
    return sum(C + min(G, -(-(R - r0) // K)) - 1 for r0 in range(0, R, G * K))


def pairhmm_timing_launches(dev, flat: list, seed: int) -> dict:
    """{label: (t, p, kernels)}: the PairHMM launches phase 5 times, with
    the kernels timed at each: run_all.py:145's 16,384 full 128 x 128
    pairs (random bytes 65-84, quals 5-59; both kernels), phase 4f's
    region launch (65,536 pairs of 150 x 300; inter-task), its candidate
    launch (the first region's 256 pairs; wavefront) and 1, 7 and 64
    pairs of 250 x 500 (wavefront).  `flat`: region_records' pairs."""
    from genomics_tpu_torch.ops import scan_pairhmm

    rng = np.random.default_rng(0)
    ph5 = [rng.integers(65, 85, (PH_B, PH_L)).astype(np.uint8),
           rng.integers(65, 85, (PH_B, PH_L)).astype(np.uint8),
           np.full(PH_B, PH_L, np.int32), np.full(PH_B, PH_L, np.int32)]
    t5 = [torch.from_numpy(a).to(dev) for a in ph5]
    p5 = scan_pairhmm.prepare_params(*(
        torch.from_numpy(rng.integers(5, 60, (PH_B, PH_L)).astype(np.int32)
                         ).to(dev) for _ in range(3)))
    both = ("pairhmm.intertask", "pairhmm.wavefront")
    out = {f"B={PH_B} {PH_L}x{PH_L} (run_all.py)": (t5, p5, both)}
    n_reg = REGION_READS * REGION_HAPS
    for label, recs, kern in (
            (f"B={len(flat)} {REGION_RL}x{REGION_HL} (the region launch)",
             flat, both[:1]),
            (f"B={n_reg} {REGION_RL}x{REGION_HL} (a candidate launch)",
             flat[:n_reg], both[1:])):
        t, p = scan_pairhmm.device_inputs(scan_pairhmm.pack_records(recs),
                                          dev)
        out[label] = (t, p, kern)
    small = np.random.default_rng(seed + 3)
    for B in (1, 7, 64):
        t, p = scan_pairhmm.device_inputs(scan_pairhmm.pack_records(
            pairhmm_records(small, B, (250, 251), (500, 501))), dev)
        out[f"B={B} 250x500"] = (t, p, both[1:])
    return out


def region_records(seed: int) -> tuple[list, list]:
    """Phase 4f's GATK-shaped regions (256 x 32 reads x 8 haplotypes of
    150 / 300 bp) and their 65,536 (read, haplotype) records, region by
    region, reads outer (compute_region_likelihoods' order)."""
    regions = regions_batch(np.random.default_rng(seed + 4), REGIONS,
                            REGION_READS, REGION_HAPS, REGION_RL, REGION_HL)
    return regions, [{**r, "hap": h} for reg in regions
                     for r in reg["reads"] for h in reg["haps"]]


GOLD_WORKER = """
import pickle, sys
from genomics_tpu_torch.core import golds
with open(sys.argv[1], "rb") as f:
    recs = pickle.load(f)
keys = ("read", "hap", "base_quals", "ins_quals", "del_quals")
pickle.dump([float(golds.pairhmm_forward(*(r[k] for k in keys)))
             for r in recs], sys.stdout.buffer)
"""


def start_children(code: str, items: list) -> tuple:
    """`code` started over items split over up to 8 child interpreters,
    each reading its share (pickled, path in argv[1]) and writing a
    pickled list of results to stdout; `join_children` collects them.
    Plain subprocesses, not a multiprocessing pool, whose spawn start
    method leaves its resource tracker running past the call."""
    n = max(1, min(8, os.cpu_count() or 1, len(items)))
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    procs = []
    try:
        for w in range(n):
            path = os.path.join(tmp.name, f"items{w}.pkl")
            with open(path, "wb") as f:
                pickle.dump(items[w::n], f)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, path], cwd=root,
                stdout=subprocess.PIPE))
    except BaseException:
        join_children((procs, tmp, len(items)), kill=True)
        raise
    return procs, tmp, len(items)


def join_children(started: tuple, kill: bool = False) -> list:
    """The results of `start_children`'s children in the items' order;
    every child is waited for (or, with `kill` or on a failure, killed
    and waited for) before this returns."""
    procs, tmp, count = started
    parts = []
    try:
        for p in procs:
            if kill:
                break
            out, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"worker failed: rc {p.returncode}")
            parts.append(pickle.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tmp.cleanup()
    got = [None] * count
    for w, part in enumerate(parts):
        got[w::len(procs)] = part
    return got


def in_children(code: str, items: list) -> list:
    """`start_children` and `join_children` in one call."""
    return join_children(start_children(code, items))


def gold_likelihoods(records) -> np.ndarray:
    """golds.pairhmm_forward over records (about 0.6 s a record at 150 x
    300), in child interpreters (`in_children`)."""
    return np.array(in_children(GOLD_WORKER, records), np.float32)


def child_pids() -> list[int]:
    """Live children of this process (Linux /proc)."""
    me, kids = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # after the ')' that closes the command: state, ppid, ...
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) == me and fields[0] != "Z":
            kids.append(int(d))
    return kids


def ed_pairs(rng, n, RL=150, WL=200):
    """The mapper's `ed` stage inputs: n reads of RL bases cut from random
    windows of WL bases with ~2% substitutions, ~10% of the reads with a 1-3
    bp deletion and ~0.1% Ns; returns (reads, windows) as str lists."""
    win = BASES[rng.integers(0, 4, (n, WL))]
    at = rng.integers(0, WL - RL - 3, n)
    reads = win[np.arange(n)[:, None], at[:, None] + np.arange(RL + 3)]
    flip = rng.random(reads.shape) < 0.02
    reads[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
    reads[rng.random(reads.shape) < 0.001] = ord("N")
    out = []
    for k in range(n):
        r = reads[k]
        if rng.random() < 0.1:
            d = int(rng.integers(0, RL))
            r = np.delete(r, range(d, d + int(rng.integers(1, 4))))
        out.append(r[:RL].tobytes().decode())
    return out, [w.tobytes().decode() for w in win]


def myers_inputs(rng, B, W, dev):
    """myers_batch's inputs on dev for patterns of up to 32W codes and
    texts of 32W + 48: half the texts hold their pattern, ~3% Ns, ~1%
    interior 255s, three empty patterns."""
    from genomics_tpu_torch.ops import myers

    Lp, Lt = 32 * W, 32 * W + 48
    pats = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    texts = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    plen = rng.integers(1, Lp + 1, B).astype(np.int32)
    tlen = rng.integers(1, Lt + 1, B).astype(np.int32)
    plen[:3] = 0
    for i in range(0, B, 2):
        at = int(rng.integers(0, Lt - plen[i] + 1))
        texts[i, at:at + plen[i]] = pats[i, :plen[i]]
    texts[rng.random(texts.shape) < 0.03] = 4
    texts[rng.random(texts.shape) < 0.01] = 255
    pats[np.arange(Lp)[None, :] >= plen[:, None]] = 255
    eq = myers.build_eq_masks(pats, plen, W)
    return [torch.from_numpy(a).to(dev) for a in (eq, plen, texts, tlen)]


def edit_distance_dp(p: str, t: str) -> tuple[int, int, int]:
    """Semiglobal edit distance by the plain DP (text prefix and suffix
    free; N and any other non-ACGT base match nothing): (best, leftmost
    end, final), as myers_batch reports them."""
    code = lambda s: np.frombuffer(s.upper().encode(), np.uint8)
    pc, tc = code(p), code(t)
    row = np.zeros(len(tc) + 1, np.int64)        # row -1: all free
    for i, a in enumerate(pc):
        sub = row[:-1] + ((tc != a) | (a == ord("N")))
        new = np.empty_like(row)
        new[0] = i + 1
        for j in range(len(tc)):                 # the left (gap) term
            new[j + 1] = min(sub[j], row[j + 1] + 1, new[j] + 1)
        row = new
    scores = row[1:]
    best = int(min(scores.min(), len(pc)))
    end = int(np.argmax(scores == best)) if best < len(pc) else -1
    return best, end, int(scores[-1])


def has_ns(q, t, qlen, tlen) -> bool:
    """Whether a batch of [B, L] codes holds an N inside a sequence (not
    in its padding): the engine's has_n for a launch."""
    def inside(x, n):
        cols = torch.arange(x.shape[1], device=x.device)[None, :]
        return (x == 14) & (cols < n[:, None])
    return bool(inside(q, qlen).any() or inside(t, tlen).any())


def lane_share(work: torch.Tensor, warp: int = 32) -> float:
    """The lanes' share of a kernel's work where each warp runs `warp`
    pairs: the work each pair needs (launch order, [B]) over what the
    warps run, each pair as long as its warp's slowest (the last warp's
    pairs only)."""
    w = work.to(torch.float64)
    pad = (-w.numel()) % warp
    most = torch.nn.functional.pad(w, (0, pad)).view(-1, warp).amax(1)
    lanes = torch.full_like(most, warp)
    lanes[-1] -= pad
    return float(w.sum() / (most * lanes).sum())


# -- the NW, SW and MSA apps (models/nw.py, sw.py, msa.py) -----------------
# NW: one row, a warp's rows and one more or less, two stripes; nw.run's
# check against nw_cpu, and benchmarks/nw_scaling.py's top size (CDP/NW's
# plot_execution_times.py runs 2^5 .. 2^15)
NW_EDGE_N = (1, 31, 33, 257)
NW_RUN_N, NW_BIG_N = 4096, 32768
# SW: a 1,000 bp fragment against 300,000 bp, the app's default windows
# (3 x 1,000 with an overlap of 1,000: 100 windows, the first 201,000 bp)
SW_X, SW_Y, SW_PLANT = 1000, 300_000, 123_457
# and the fragment's first 200 bp in windows of 45,000 (`sw -w 45000`):
# 7 windows of 22 tiles, the wide case (one block a window left 125 of
# 132 SMs idle there)
SW_WIDE_X, SW_WIDE = 200, 45_000
# MSA: run_all.py's bench_msa (2,048 x 120, substitutions only), 1,024
# sequences of about 1,500 bp with substitutions and indels, 512 protein
# sequences of about 300 under a synthetic NCBI matrix
MSA_RUN_ALL, MSA_LONG, MSA_PROTEIN = (2048, 120), (1024, 1500), (512, 300)
MSA_GOLD = 16   # pairs of each MSA set held to the host backtrack
DNA, PROTEIN = "ACGT", "ACDEFGHIKLMNPQRSTVWY"
# one int op per add, max, compare or select of each kernel's cell (a
# walk step for the backtrack), as their sources write them: NW 3 adds, a
# compare, a select, 2 max; SW 4 adds, a compare, a select, 3 max in the
# three passes and the subtract; the MSA fill 11 (nw.cc's three maxima
# with their 5 adds, the score's compare and select); the backtrack's
# diagonal test and step (index, compare, add, two decrements, the loop
# test), about 10
APP_OPS = {"nw_app": 7, "sw_app": 10, "msa_nw.fill": 11,
           "msa_nw.backtrack": 10}


def random_seq(rng, n: int, letters: str = DNA) -> str:
    a = np.frombuffer(letters.encode(), np.uint8)
    return a[rng.integers(0, len(a), n)].tobytes().decode()


def mutate(rng, s: str, sub: float, indel: float, letters: str = DNA) -> str:
    """s with each position substituted at rate `sub`, deleted at indel /
    2 and preceded by an inserted letter at indel / 2."""
    a = np.frombuffer(letters.encode(), np.uint8)
    b = np.frombuffer(s.encode(), np.uint8).copy()
    flip = rng.random(len(b)) < sub
    b[flip] = a[rng.integers(0, len(a), int(flip.sum()))]
    v = rng.random(len(b))
    new = a[rng.integers(0, len(a), len(b))]
    # each position's inserted letter (where v < indel / 2), then its
    # base (unless indel / 2 <= v < indel)
    keep = np.stack([v < indel / 2, (v < indel / 2) | (v >= indel)], 1)
    return np.stack([new, b], 1)[keep].tobytes().decode()


def ncbi_matrix(rng, letters: str = "ARNDCQEGHILKMFPSTWYVBZX*") -> str:
    """An NCBI-format substitution matrix over `letters`: symmetric, the
    diagonal 4..11, elsewhere -4..3 (BLOSUM's ranges), one comment line."""
    k = len(letters)
    s = rng.integers(-4, 4, (k, k))
    s = np.triu(s) + np.triu(s, 1).T
    s[np.arange(k), np.arange(k)] = rng.integers(4, 12, k)
    lines = ["# synthetic matrix", "   " + "  ".join(letters)]
    lines += [c + " " + " ".join(f"{v:2d}" for v in row)
              for c, row in zip(letters, s)]
    return "\n".join(lines) + "\n"


def sw_edges(rng) -> list:
    """(label, x, windows) numpy uint8 cases at the SW kernel's edges."""
    a = np.frombuffer(DNA.encode(), np.uint8)
    x = a[rng.integers(0, 4, 50)]
    short = a[rng.integers(0, 4, (5, 150))]
    for k, n in enumerate((150, 149, 77, 1, 0)):
        short[k, n:] = 0
    return [("one window", x, a[rng.integers(0, 4, (1, 150))]),
            ("windows shorter than L", x, short),
            ("one-base fragment", x[:1], a[rng.integers(0, 4, (3, 40))]),
            ("empty fragment", x[:0], a[rng.integers(0, 4, (2, 10))]),
            # 2 columns a thread, made 3; a copy of x in each window
            ("two columns a thread", x, np.stack([np.concatenate(
                [a[rng.integers(0, 4, 200)], x, a[rng.integers(0, 4, 262)]])
                for _ in range(3)]))]


def sw_stripe_edges(rng) -> list:
    """(label, x, windows, grid) numpy uint8 cases at the edges of
    sw_app.cu's stripes of sw.ROWS rows and tiles of sw.TILE columns: n =
    0 and 1, n at a stripe's height +- 1, L at a tile's width +- 1 and
    below it, one window, windows shorter than L (0 pads, one empty) and
    a copy of x across a tile's edge.  `grid`: fewer blocks than the
    case's stripes, so that blocks take more than one ticket."""
    from genomics_tpu_torch.models import sw

    R, T = sw.ROWS, sw.TILE
    a = np.frombuffer(DNA.encode(), np.uint8)
    shapes = [("n = 0", 0, 50, 2), ("n = 1", 1, 30, 3),
              ("n = R - 1", R - 1, T + 1, 2), ("n = R + 1", R + 1, T + 1, 2),
              ("L = T - 1", R + 3, T - 1, 2), ("L = T + 1", 2 * R, T + 1, 3),
              ("L < T", R + 2, T // 2 + 3, 3),
              ("one window", 3 * R + 1, T + 7, 1),
              ("windows shorter than L", R + 1, T + 5, 5),
              ("a copy across a tile's edge", 40, T + 100, 2)]
    out = []
    for label, n, L, W in shapes:
        x = a[rng.integers(0, 4, n)]
        wins = a[rng.integers(0, 4, (W, L))]
        if label == "windows shorter than L":
            for k, m in enumerate(rng.integers(0, L, W)):
                wins[k, (0 if k == 1 else m):] = 0
        if label == "a copy across a tile's edge":
            wins[1, T - 20:T + 20] = x   # columns T - 19 .. T + 20
        out.append((label, x, wins, max(1, W * sw.stripes(n) - 1)))
    return out


def msa_edges(rng) -> list:
    """(label, seqs, protein) cases at the MSA kernels' edges."""
    base = random_seq(rng, 60)
    prot = random_seq(rng, 40, PROTEIN)
    return [("one sequence", [base], False),
            ("identical sequences", [base] * 4, False),
            ("longer and shorter than the center",
             [base, base[:30], mutate(rng, base, 0.05, 0.05)
              + random_seq(rng, 45), base[:59], base + "ACGT"], False),
            ("a sequence of length 1", [base, "A", mutate(rng, base, 0.05, 0.1)],
             False),
            ("protein table", [mutate(rng, prot, 0.1, 0.1, PROTEIN)
                               for _ in range(6)] + ["W", prot.lower()], True)]


def backtrack_edges(rng) -> list:
    """(label, seqs, protein) cases at the edges of msa_nw.cu's backtrack,
    the center first: a sequence of length 1; gap runs longer than a
    round's 32 lanes (sequences much shorter and much longer than the
    center, a deletion of 42); ties between a vertical and a horizontal
    run at equal k (the walks of the last two sequences meet one); and
    pair counts whose fill pitch is not the count (9 pairs: pitch 16;
    one protein pair: pitch 8)."""
    base = random_seq(rng, 80)
    prot = random_seq(rng, 50, PROTEIN)
    return [("a sequence of length 1",
             [base, "A", "G", mutate(rng, base, 0.05, 0.05)], False),
            ("gap runs longer than 32",
             [base, base[:10], base[:20] + base[62:],
              base + random_seq(rng, 70), random_seq(rng, 5) + base[45:]],
             False),
            ("ties at equal k", ["CGTTAATTACTC", "GTAATTAC", "CTGTACTATAC",
                                 "CAGTTAATGATCT"], False),
            ("9 pairs: pitch 16",
             [base] + [mutate(rng, base, 0.05, 0.05) for _ in range(9)],
             False),
            ("one protein pair: pitch 8",
             [prot, mutate(rng, prot, 0.1, 0.1, PROTEIN)[:20]], True)]


def nw_stripe_edges(stripe: int) -> tuple:
    """(N, grid) launches at the edges of nw_app.cu's stripes of `stripe`
    rows (nw.STRIPE): a stripe and one row more or less, two stripes but a
    row, and grids of fewer warps than stripes, so that warps take more
    than one ticket (grid None: the card's resident blocks)."""
    return ((stripe - 1, None), (stripe, None), (stripe + 1, None),
            (2 * stripe - 1, None), (1000, 1), (1000, 3), (2049, 5))


def fill_edges(rng) -> list:
    """(label, center [m] uint8, seqs [B, n] uint8 with ragged lengths, 0
    among them, protein) cases at the edges of msa_nw.cu's fill: a strip's
    height and one row more or less, a round's (msa.FILL_ROUND_ROWS) the
    same, pair counts around the sector group (msa.FILL_PAIRS), and 40,000
    pairs, many waves of blocks."""
    from genomics_tpu_torch.models import msa

    def case(m, B, n, letters=DNA):
        a = np.frombuffer(letters.encode(), np.uint8)
        c = a[rng.integers(0, len(a), m)]
        # bytes of the center, a fifth of them any letter, to ragged lengths
        seqs = np.where(rng.random((B, n)) < 0.2,
                        a[rng.integers(0, len(a), (B, n))],
                        c[rng.integers(0, m, (B, n))])
        lens = rng.integers(0, n + 1, B)
        lens[: min(B, 1)] = n
        if B > 2:
            lens[2] = 0
        seqs[np.arange(n)[None, :] >= lens[:, None]] = 0
        return c, seqs.astype(np.uint8)

    h, r, g = msa.FILL_ROWS, msa.FILL_ROUND_ROWS, msa.FILL_PAIRS
    out = [(f"m = {m}", *case(m, 9, 40), False) for m in (h - 1, h, h + 1)]
    out += [(f"m = {m}", *case(m, 9, 60), False) for m in (r - 1, r, r + 1)]
    out += [(f"B = {B}", *case(50, B, 45), False)
            for B in (1, g - 1, g, g + 1, 2 * g - 1, 2 * g + 1)]
    out.append(("40,000 pairs", *case(20, 40000, 20), False))
    out.append(("protein, bytes the matrix does not name",
                *case(70, 17, 80, PROTEIN + "JOU09"), True))
    return out


def sw_planted(rng) -> tuple[str, str]:
    """(fragment, sequence): SW_X random bases, and SW_Y random bases
    with a copy of the fragment (2% substitutions, 1% indels) at SW_PLANT."""
    x = random_seq(rng, SW_X)
    y = random_seq(rng, SW_Y)
    copy = mutate(rng, x, 0.02, 0.01)
    return x, y[:SW_PLANT] + copy + y[SW_PLANT + len(copy):]


def msa_sets(rng, tmpdir: str) -> list:
    """(label, seqs, matrix path or None) of phase 4: run_all.py's
    bench_msa set (its own generator, rng(0)), MSA_LONG sequences of a
    random center with 3% substitutions and 2% indels, and MSA_PROTEIN
    protein sequences (5% substitutions, 2% indels) under a synthetic
    NCBI matrix written to tmpdir."""
    r0 = np.random.default_rng(0)
    n, L = MSA_RUN_ALL
    bases = np.array(list(DNA))
    center = "".join(bases[r0.integers(0, 4, L)])
    bench = []
    for _ in range(n):
        c = np.array(list(center))
        idx = r0.choice(L, size=r0.integers(0, 8), replace=False)
        c[idx] = bases[r0.integers(0, 4, len(idx))]
        bench.append("".join(c))
    n, L = MSA_LONG
    base = random_seq(rng, L)
    long = [mutate(rng, base, 0.03, 0.02) for _ in range(n)]
    n, L = MSA_PROTEIN
    base = random_seq(rng, L, PROTEIN)
    prot = [mutate(rng, base, 0.05, 0.02, PROTEIN) for _ in range(n)]
    path = os.path.join(tmpdir, "synthetic.txt")
    with open(path, "w") as fh:
        fh.write(ncbi_matrix(rng))
    return [(f"run_all.py's {MSA_RUN_ALL[0]} x {MSA_RUN_ALL[1]}", bench, None),
            (f"{MSA_LONG[0]} x ~{MSA_LONG[1]} with indels", long, None),
            (f"{MSA_PROTEIN[0]} x ~{MSA_PROTEIN[1]} protein", prot, path)]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches captured in one CUDA
    graph and replayed, after a warm-up: the launches without the host's
    cost of making them, for a kernel shorter than that cost (fn must
    allocate nothing)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


APP_ROWS = (("nw_app", "nw_app.cu", "genomics_tpu/models/nw.py:51"),
            ("sw_app", "sw_app.cu", "genomics_tpu/models/sw.py:24"),
            ("msa_nw.fill", "msa_nw.cu", "genomics_tpu/models/msa.py:103"),
            ("msa_nw.backtrack", "msa_nw.cu",
             "genomics_tpu/models/msa.py:160"))


def cube_err(got, want, lens=None) -> int:
    """Largest |got - want| over two [B, R, C] int32 tensors, a slice of
    rows at a time; with lens [B], only columns <= lens[b] of pair b."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if lens is None and torch.equal(got, want):
        return 0
    B, R, C = got.shape
    own = (torch.ones((B, 1, C), dtype=torch.bool, device=got.device)
           if lens is None else (torch.arange(C, device=got.device)[None, :]
                                 <= lens[:, None])[:, None, :])
    err, step = 0, max(1, (1 << 27) // max(B * C, 1))
    for r0 in range(0, R, step):
        d = (got[:, r0:r0 + step].long() - want[:, r0:r0 + step].long())
        d = d.abs().masked_fill_(~own, 0)
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def msa_kernel_err(dev, seqs, center_idx, table):
    """(fill err, backtrack err, plain fill ms, plain backtrack ms, the
    plain backtrack's stats) of the MSA kernels on msa()'s pairs: the
    fill against the plain version within each pair's length, the
    backtrack's space and so against the plain version's, and MSA_GOLD
    of the pairs against the host backtrack (a difference there raises)."""
    from genomics_tpu_torch.models import msa

    cenc, arr, slens = msa.pack_pairs(seqs, center_idx)
    c, a, sl = (torch.from_numpy(v).to(dev) for v in (cenc, arr, slens))
    t = None if table is None else torch.from_numpy(table).to(dev)
    M = msa.nw_matrices_batch(c, a, t)
    t0 = time.time()
    P = msa.nw_matrices_batch_plain(c, a, t)
    torch.cuda.synchronize()
    fill_ms = (time.time() - t0) * 1e3
    fill_err = cube_err(M, P, sl)
    sp, so = msa.backtrack_batch(M, c, a, sl, t)
    stats = {}
    t0 = time.time()
    want = msa.backtrack_batch_plain(P, c, a, sl, t, stats)
    torch.cuda.synchronize()
    bt_ms = (time.time() - t0) * 1e3
    del P
    bt_err = max_abs_err([sp, so], want)
    center = seqs[center_idx]
    others = [s for k, s in enumerate(seqs) if k != center_idx]
    for k, s in enumerate(others[:MSA_GOLD]):
        g_sp, g_so = msa.backtrack(M[k, :, :len(s) + 1].cpu().numpy(), center,
                                   s, table)
        if not (np.array_equal(sp[k].cpu().numpy(), g_sp) and np.array_equal(
                so[k, :len(s) + 1].cpu().numpy(), g_so)):
            raise AssertionError(f"msa backtrack of pair {k} differs from "
                                 f"the host gold")
    return fill_err, bt_err, fill_ms, bt_ms, stats


def apps(seed: int, dev, smi: str, peak: float) -> dict:
    """Phases 3-5 of the NW, SW and MSA apps on the card; returns each
    kernel's row of the kernels line but its name, route and source."""
    from genomics_tpu_torch.core import golds
    from genomics_tpu_torch.core.submat import load_scoring_matrix
    from genomics_tpu_torch.models import msa, nw, sw

    names = [r[0] for r in APP_ROWS]
    err = dict.fromkeys(names, 0)
    rng = np.random.default_rng(seed + 11)
    tmp = tempfile.TemporaryDirectory()

    # -- 3. the kernels at their edges ------------------------------------
    for N in NW_EDGE_N:
        ref = rng.integers(0, 256, N).astype(np.uint8)
        r = torch.from_numpy(ref).to(dev)
        q = torch.from_numpy(nw.generate_query(ref, rng)).to(dev)
        err["nw_app"] = max(err["nw_app"], cube_err(
            nw.nw_matrix(r, q)[None], nw.nw_matrix_plain(r, q)[None]))
    # the stripes' edges and fewer warps than stripes; the fill's edges (a
    # generator of their own, so that the timed sets stay as they were)
    erng = np.random.default_rng(seed + 15)
    for N, grid in nw_stripe_edges(nw.STRIPE):
        ref = erng.integers(0, 256, N).astype(np.uint8)
        r = torch.from_numpy(ref).to(dev)
        q = torch.from_numpy(nw.generate_query(ref, erng)).to(dev)
        got = nw.launch_nw(r, q, torch.empty((N, N), dtype=torch.int32,
                                             device=dev), grid=grid)
        err["nw_app"] = max(err["nw_app"], cube_err(
            got[None], nw.nw_matrix_plain(r, q)[None]))
    # sw_edges, then the stripes' and tiles' edges on the card's resident
    # blocks and on fewer blocks than stripes (a generator of their own)
    srng = np.random.default_rng(seed + 16)
    sw_cases = [(*c, None) for c in sw_edges(rng)]
    for label, x, wins, grid in sw_stripe_edges(srng):
        sw_cases += [(label, x, wins, None), (label, x, wins, grid)]
    for label, x, wins, grid in sw_cases:
        xd, wd = torch.from_numpy(x).to(dev), torch.from_numpy(wins).to(dev)
        W, L = wins.shape
        want = sw.sw_matrix_batch_plain(xd, wd)
        H = torch.empty((W, len(x) + 1, L + 1), dtype=torch.int32, device=dev)
        got = sw.launch_sw(xd, wd, H, torch.empty(W, dtype=torch.int32,
                                                  device=dev), grid=grid)
        err["sw_app"] = max(err["sw_app"], cube_err(got[0], want[0]),
                            max_abs_err(got[1:], want[1:]))
    mpath = os.path.join(tmp.name, "edges.txt")
    with open(mpath, "w") as fh:
        fh.write(ncbi_matrix(rng))
    table = load_scoring_matrix(mpath)
    fill_labels = []
    for label, cenc, seqs, protein in fill_edges(erng):
        c, a = (torch.from_numpy(v).to(dev) for v in (cenc, seqs))
        t = torch.from_numpy(table).to(dev) if protein else None
        fa = msa.fill_args(c, a, t)
        err["msa_nw.fill"] = max(err["msa_nw.fill"], cube_err(
            msa.launch_fill(fa), msa.nw_matrices_batch_plain(c, a, t),
            fa[2][:fa[9]]))
        fill_labels.append(label)
        del fa
    for label, seqs, protein in msa_edges(rng):
        fe, be, *_ = msa_kernel_err(dev, seqs, 0, table if protein else None)
        err["msa_nw.fill"] = max(err["msa_nw.fill"], fe)
        err["msa_nw.backtrack"] = max(err["msa_nw.backtrack"], be)
        path = mpath if protein else None
        if msa.msa(seqs, matrix_path=path, device=dev) != msa.msa(
                seqs, matrix_path=path, device="cpu"):
            raise AssertionError(f"msa() on the card differs from the CPU's "
                                 f"at the edge {label!r}")
    # the backtrack's edges: the fill's pitch apart from the pair count
    for label, seqs, protein in backtrack_edges(srng):
        fe, be, *_ = msa_kernel_err(dev, seqs, 0, table if protein else None)
        err["msa_nw.fill"] = max(err["msa_nw.fill"], fe)
        err["msa_nw.backtrack"] = max(err["msa_nw.backtrack"], be)
        path = mpath if protein else None
        if msa.msa(seqs, matrix_path=path, device=dev) != msa.msa(
                seqs, matrix_path=path, device="cpu"):
            raise AssertionError(f"msa() on the card differs from the CPU's "
                                 f"at the edge {label!r}")
    # the pairs in chunks of 16
    base = random_seq(rng, 200, PROTEIN)
    prot = [mutate(rng, base, 0.05, 0.03, PROTEIN) for _ in range(64)]
    one = msa.msa(prot, matrix_path=mpath, device=dev)
    rule = msa.pairs_per_call
    msa.pairs_per_call = lambda dev, m, n: 16
    try:
        chunked = msa.msa(prot, matrix_path=mpath, device=dev)
    finally:
        msa.pairs_per_call = rule
    if chunked != one:
        raise AssertionError("msa() in chunks of 16 pairs differs from one "
                             "call")
    if any(err.values()):
        raise AssertionError(f"app kernels disagree with their plain "
                             f"versions at their edges: {err}")
    log("3 parity", f"apps: nw_app at N={NW_EDGE_N} and (N, grid) "
        f"{nw_stripe_edges(nw.STRIPE)}, msa_nw fill at {fill_labels}, "
        f"sw_app at "
        f"{[lb for lb, *_ in sw_edges(np.random.default_rng(0))]} and "
        f"{[lb for lb, *_ in sw_stripe_edges(np.random.default_rng(0))]} "
        f"(each also on fewer blocks than stripes), msa_nw fill and "
        f"backtrack at "
        f"{[lb for lb, *_ in msa_edges(np.random.default_rng(0))]} and "
        f"{[lb for lb, *_ in backtrack_edges(np.random.default_rng(0))]} "
        f"(and the host gold), msa() in chunks of 16 pairs == one call == "
        f"the CPU's: == plain")

    # -- 4. the apps end to end -------------------------------------------
    launches, walls = {}, {}
    zero_counts(nw.LAUNCHES)
    t0 = time.time()
    score = nw.run(N=NW_RUN_N, seed=seed, device=dev)   # == nw_cpu
    walls["nw.run"] = time.time() - t0
    ref = rng.integers(0, 256, NW_BIG_N).astype(np.uint8)
    r = torch.from_numpy(ref).to(dev)
    q = torch.from_numpy(nw.generate_query(ref, rng)).to(dev)
    big = nw.nw_matrix(r, q)
    launches["nw_app"] = nw.LAUNCHES["nw_app"]
    t0 = time.time()
    big_plain = nw.nw_matrix_plain(r, q)
    torch.cuda.synchronize()
    plain_nw = (time.time() - t0) * 1e3
    if not torch.equal(big, big_plain):
        err["nw_app"] = cube_err(big[None], big_plain[None])
    del big_plain
    log("4 apps", f"nw: run(N={NW_RUN_N}) == nw_cpu, final score {score}, "
        f"{walls['nw.run']:.3f} s; N={NW_BIG_N} torch.equal to the plain "
        f"version: {err['nw_app'] == 0}; launches {launches['nw_app']}")

    x, y = sw_planted(rng)
    zero_counts(sw.LAUNCHES)
    t0 = time.time()
    res = sw.align(x, y, device=dev)
    walls["sw.align"] = time.time() - t0
    launches["sw_app"] = sw.LAUNCHES["sw_app"]
    t0 = time.time()
    gold = golds.sw_best_alignment(x, y)
    gold_s = time.time() - t0
    if (res["score"], res["location"], res["window"], res["cigar"]) != gold:
        raise AssertionError(f"sw.align differs from the gold: {res} vs "
                             f"{gold}")
    t0 = time.time()
    wide = sw.align(x[:SW_WIDE_X], y, window_size=SW_WIDE, device=dev)
    walls["sw.align wide"] = time.time() - t0
    launches["sw_app"] = sw.LAUNCHES["sw_app"]
    gold = golds.sw_best_alignment(x[:SW_WIDE_X], y, window_size=SW_WIDE)
    if (wide["score"], wide["location"], wide["window"],
            wide["cigar"]) != gold:
        raise AssertionError(f"sw.align in windows of {SW_WIDE} differs from "
                             f"the gold: {wide} vs {gold}")
    log("4 apps", f"sw: {SW_X} bp against {SW_Y} bp (a copy at {SW_PLANT}),"
        f" {SW_Y // (3 * SW_X)} windows of {3 * SW_X}: score {res['score']} at {res['location']}, "
        f"window {res['window']}, {res['cigar_compressed'][:40]}...; == "
        f"golds.sw_best_alignment ({gold_s:.1f} s); {walls['sw.align']:.3f} "
        f"s; its first {SW_WIDE_X} bp in windows of {SW_WIDE}: score "
        f"{wide['score']} at {wide['location']}, "
        f"window {wide['window']}, == the gold, {walls['sw.align wide']:.3f}"
        f" s; launches {launches['sw_app']}")

    zero_counts(msa.LAUNCHES)
    sets, runs = msa_sets(rng, tmp.name), []
    for label, seqs, path in sets:
        t0 = time.time()
        aligned, cidx = msa.msa(seqs, matrix_path=path, device=dev)
        wall = time.time() - t0
        fa_in = os.path.join(tmp.name, "in.fasta")
        out = os.path.join(tmp.name, "out.fasta")
        with open(fa_in, "w") as fh:
            fh.writelines(f">s{k}\n{s}\n" for k, s in enumerate(seqs))
        run_cli(["msa", fa_in, out, "--device", str(dev)]
                + (["-p", path] if path else []))
        from genomics_tpu_torch.utils.fasta import read_fasta
        # the subcommand reads -p and drops it, as the JAX package's does
        if [rec.seq for rec in read_fasta(out)] != (
                msa.msa(seqs, device=dev)[0] if path else aligned):
            raise AssertionError(f"msa CLI's file differs from msa() on "
                                 f"{label}")
        if len({len(a_) for a_ in aligned}) != 1 or [
                a_.replace("-", "") for a_ in aligned] != seqs:
            raise AssertionError(f"msa() rows on {label} are not an "
                                 f"alignment of the inputs")
        runs.append((label, seqs, path, cidx, wall))
    launches["msa_nw.fill"] = msa.LAUNCHES["msa_nw.fill"]
    launches["msa_nw.backtrack"] = msa.LAUNCHES["msa_nw.backtrack"]
    for k in names:
        if not launches[k]:
            raise AssertionError(f"{k} was not launched by its app")
    checks = {}
    for label, seqs, path, cidx, wall in runs:
        table = load_scoring_matrix(path) if path else None
        fe, be, f_ms, b_ms, stats = msa_kernel_err(dev, seqs, cidx, table)
        err["msa_nw.fill"] = max(err["msa_nw.fill"], fe)
        err["msa_nw.backtrack"] = max(err["msa_nw.backtrack"], be)
        checks[label] = (f_ms, b_ms, stats)
        log("4 apps", f"msa {label}: center {cidx}, {len(seqs) / wall:.1f} "
            f"seqs/s ({wall:.3f} s through msa(), then the CLI's file ==); "
            f"fill == plain {fe == 0}, backtrack == plain {be == 0}, "
            f"{MSA_GOLD} pairs == the host gold")
    log("4 apps", f"launches: {launches}")
    if any(err.values()):
        raise AssertionError(f"app kernels disagree with their plain "
                             f"versions: {err}")

    # -- 5. times ----------------------------------------------------------
    ms, plain_ms, bounds = {}, {}, {}
    out = torch.empty_like(big)
    flags = torch.empty(nw.flag_words(NW_BIG_N), dtype=torch.int32,
                        device=dev)
    ms["nw_app"] = cuda_ms(lambda: nw.launch_nw(r, q, out, flags), 5)
    nw_graph = graph_ms(lambda: nw.launch_nw(r, q, out, flags), 3)
    if not torch.equal(out, big):
        err["nw_app"] = max(err["nw_app"], cube_err(out[None], big[None]))
    plain_ms["nw_app"] = plain_nw
    bounds["nw_app"] = bound(APP_OPS["nw_app"] * NW_BIG_N ** 2,
                             4 * NW_BIG_N ** 2 + 2 * NW_BIG_N, peak)
    del big, out
    # and nw.run's size, N = 4,096
    rs = torch.from_numpy(rng.integers(0, 256, NW_RUN_N).astype(
        np.uint8)).to(dev)
    qs = torch.from_numpy(nw.generate_query(rs.cpu().numpy(), rng)).to(dev)
    out_s = torch.empty((NW_RUN_N, NW_RUN_N), dtype=torch.int32, device=dev)
    run_ms = cuda_ms(lambda: nw.launch_nw(rs, qs, out_s, flags), 20)
    run_graph = graph_ms(lambda: nw.launch_nw(rs, qs, out_s, flags), 20)
    err["nw_app"] = max(err["nw_app"], cube_err(
        out_s[None], nw.nw_matrix_plain(rs, qs)[None]))
    run_bound = bound(APP_OPS["nw_app"] * NW_RUN_N ** 2,
                      4 * NW_RUN_N ** 2 + 2 * NW_RUN_N, peak)
    del out_s
    for N, k_ms, g_ms, bd in ((NW_BIG_N, ms["nw_app"], nw_graph,
                               bounds["nw_app"]),
                              (NW_RUN_N, run_ms, run_graph, run_bound)):
        log("5 timings", f"nw_app at N={N}: kernel {k_ms:.4f} ms "
            f"({N ** 2 / k_ms / 1e6:.2f} G cells/s), "
            f"{nw.launches_per_call(N)} CUDA launches a call (the flags' "
            f"memset and one kernel, {-(-N // nw.STRIPE)} stripes of "
            f"{nw.STRIPE} rows); replayed from a CUDA graph {g_ms:.4f} ms; "
            f"bound {bd[0]:.4f} ms by {bd[1]} ({N ** 2 / bd[0] / 1e6:.2f} G "
            f"cells/s; {APP_OPS['nw_app']} op a cell, the matrix written), "
            f"{k_ms / bd[0]:.2f} x the bound"
            + (f"; plain {plain_ms['nw_app']:.1f} ms" if N == NW_BIG_N
               else "") + f"; on {smi}")

    # sw_app at the app's default windows (the kernels line's shape) and
    # at the wide case's, one path
    xd = torch.from_numpy(np.frombuffer(x.encode(), np.uint8).copy()).to(dev)
    for n, wsize in ((SW_X, None), (SW_WIDE_X, SW_WIDE)):
        xs = xd[:n].clone()
        wd = torch.from_numpy(sw.split_windows(y.encode(), n,
                                               wsize)[2]).to(dev)
        W, L = wd.shape
        H = torch.empty((W, n + 1, L + 1), dtype=torch.int32, device=dev)
        best = torch.empty(W, dtype=torch.int32, device=dev)
        flags = torch.empty(sw.flag_words(n, W), dtype=torch.int32,
                            device=dev)
        k_ms = cuda_ms(lambda: sw.launch_sw(xs, wd, H, best, flags), 5)
        t0 = time.time()
        want = sw.sw_matrix_batch_plain(xs, wd)
        torch.cuda.synchronize()
        p_ms = (time.time() - t0) * 1e3
        err["sw_app"] = max(err["sw_app"], cube_err(H, want[0]),
                            max_abs_err([best], want[1:]))
        del want, H
        cells = W * n * L
        bd = bound(APP_OPS["sw_app"] * cells,
                   4 * W * (n + 1) * (L + 1) + n + W * L + 4 * W, peak)
        log("5 timings", f"sw_app at {W} windows of {L} x {n}: kernel "
            f"{k_ms:.4f} ms ({cells / k_ms / 1e6:.2f} G cells/s), "
            f"{sw.launches_per_call(W)} CUDA launches a call (the flags' "
            f"memset and one kernel; {W * sw.stripes(n)} stripes of "
            f"{sw.ROWS} rows, {-(-L // sw.TILE)} tiles of {sw.TILE} "
            f"columns); plain {p_ms:.1f} ms; bound {bd[0]:.4f} ms by "
            f"{bd[1]}, {k_ms / bd[0]:.2f} x the bound"
            + (f"; the app {SW_Y * SW_X / walls['sw.align'] / 1e9:.2f} G "
               f"cells/s of sequence x fragment through sw.align"
               if wsize is None else "") + f"; on {smi}")
        if wsize is None:
            ms["sw_app"], plain_ms["sw_app"], bounds["sw_app"] = k_ms, p_ms, bd

    for label, seqs, path, cidx, wall in runs:
        cenc, arr, slens = msa.pack_pairs(seqs, cidx)
        c, a, sl = (torch.from_numpy(v).to(dev) for v in (cenc, arr, slens))
        t = (None if path is None
             else torch.from_numpy(load_scoring_matrix(path)).to(dev))
        fa = msa.fill_args(c, a, t)
        f_ms = cuda_ms(lambda: msa.launch_fill(fa), 3)
        M = msa.launch_fill(fa)
        ba = msa.backtrack_args(M, c, a, sl, t)
        b_ms = cuda_ms(lambda: msa.launch_backtrack(ba), 3)
        p_f, p_b, stats = checks[label]
        m, B = len(cenc), len(slens)
        own = int(slens.astype(np.int64).sum())
        f_bound = bound(APP_OPS["msa_nw.fill"] * m * own,
                        4 * ((m + 1) * (own + B)) + arr.size + m + 4 * B,
                        peak)
        b_bound = bound(APP_OPS["msa_nw.backtrack"] * stats["steps"],
                        4 * stats["reads"] + 4 * B * (m + arr.shape[1] + 3),
                        peak)
        floor = 32 * stats["reads"] / HBM_BYTES_PER_S * 1e3
        log("5 timings", f"msa_nw at {label}: fill {f_ms:.4f} ms "
            f"({m * own / f_ms / 1e6:.2f} G cells/s; {4 * (m + 1) * (own + B) / 1e9:.2f}"
            f" GB of matrices written, "
            f"{4 * (m + 1) * (own + B) / f_ms / 1e6:.1f} GB/s), plain "
            f"{p_f:.1f} ms, bound {f_bound[0]:.4f} ms "
            f"by {f_bound[1]} ({m * own / f_bound[0] / 1e6:.2f} G cells/s), "
            f"{f_ms / f_bound[0]:.2f} x the bound; backtrack {b_ms:.4f} ms, "
            f"plain {p_b:.1f} ms, "
            f"{stats['steps']} steps in {stats['rounds']} rounds of "
            f"{msa.BACKTRACK_DIAG} diagonal words or {msa.BACKTRACK_RUN} gap "
            f"lengths ({stats['max_rounds']} the most of a pair), "
            f"{stats['loaded']} words loaded for the {stats['reads']} a "
            f"one-thread walk needs: sector "
            f"floor {floor:.4f} ms, bound {b_bound[0]:.4f} ms by "
            f"{b_bound[1]}; 1 launch each a call; msa() {len(seqs) / wall:.1f}"
            f" seqs/s; on {smi}")
        if label == runs[1][0]:   # the 1,024 x ~1,500 set: the kernels line
            ms["msa_nw.fill"], ms["msa_nw.backtrack"] = f_ms, b_ms
            plain_ms["msa_nw.fill"], plain_ms["msa_nw.backtrack"] = p_f, p_b
            bounds["msa_nw.fill"], bounds["msa_nw.backtrack"] = f_bound, b_bound
        del M, ba, fa
    tmp.cleanup()
    if any(err.values()):
        raise AssertionError(f"app kernels disagree with their plain "
                             f"versions at the timed launches: {err}")
    return {k: dict(launches=launches[k], max_abs_err=err[k], ms=ms[k],
                    plain_ms=plain_ms[k], bound_ms=bounds[k][0],
                    bound_by=bounds[k][1]) for k in names}


# -- the mapper slice: its own phases 3-5 ----------------------------------

FM_EDGE_N = (1, 31, 32, 33, 127, 128, 129, 4095, 4096)
# csrc/fm_search.cu's integer operations (its header): per active step,
# per rank (two a step, one 32-byte record each), per code of a suffix
# table key and per table lookup; steps, ranks, lookups and key codes as
# backward_search_plain(stats=) counts them.  The L2 sector floor: one
# 32-byte sector a rank and a lookup
FM_OPS_PER_STEP, FM_OPS_PER_RANK, FM_OPS_PER_KEY, FM_OPS_PER_LOOKUP = \
    12, 18, 3, 3
FM_TIMING_Q = 1 << 20        # queries of 16-32 bases, the launch alone
# S. cerevisiae S288C's 16 nuclear chromosomes (SGD reference R64; 12.07
# Mbp), the size and layout of a common small-genome mapper benchmark
YEAST = (("chrI", 230218), ("chrII", 813184), ("chrIII", 316620),
         ("chrIV", 1531933), ("chrV", 576874), ("chrVI", 270161),
         ("chrVII", 1090940), ("chrVIII", 562643), ("chrIX", 439888),
         ("chrX", 745751), ("chrXI", 666816), ("chrXII", 1078177),
         ("chrXIII", 924431), ("chrXIV", 784333), ("chrXV", 1091291),
         ("chrXVI", 948066))
YEAST_DUPS = 256             # segments of 1-5 kb copied elsewhere
# a quarter of the 65,536 reads and 16,384 pairs first planned, so that the
# whole script stays near the time the earlier slices kept
MAP_READS, MAP_LEN = 16384, 150
MAP_PAIRS = 4096             # FR pairs, inserts of 300-500 bp
MAP_CHECK = 1024             # reads held to the same run on the CPU
CLI_READS, CLI_PAIRS = 16384, 4096
PROFILE_READS, PROFILE_PAIRS = 8192, 2048
# benchmarks/run_all.py's bench_mapper: 2,000 warm + 2,000 timed 100 bp
# reads at 1% substitutions against a 100 kbp genome (:494-519)
BENCH_MAP_READS, BENCH_MAP_LEN, BENCH_MAP_GENOME = 2000, 100, 100000
READ_LUT = np.frombuffer(b"ACGTN", np.uint8)
COMPLEMENT2 = np.array([3, 2, 1, 0, 4], np.uint8)


def fm_codes_with_primary(rng, n, rows):
    """A random text of n 2-bit codes whose sentinel row (`primary`) falls
    on one of `rows` (mod 128) where some draw puts it there, else the
    last draw."""
    from genomics_tpu_torch.index.fmindex import FMIndex

    for _ in range(600):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        if int(np.nonzero(FMIndex(codes).bwt == 0)[0][0]) % 128 in rows:
            break
    return codes


def fm_edge_specs() -> list:
    """(label, n, what) of fm_search's edge texts: each FM_EDGE_N length
    with its sentinel at a block's first row and at its last (`what` the
    rows, mod 128; below 128 symbols row 1, the first a text's own row can
    take, and row n, the last), and one-letter texts (`what` the code:
    their sentinel row is n, so 127 and 128 put it on a block's edges)."""
    out = {}
    for n in FM_EDGE_N:
        for rows in (((0,) if n >= 128 else (1,)),
                     ((127,) if n >= 127 else (n,))):
            out[f"n={n} primary%128 in {rows}"] = (n, rows)
    for n in (1, 127, 128, 255, 256, 4096):
        for c in (0, 3):
            out[f"{'AT'[c // 3]}*{n}"] = (n, c)
    return [(label, *v) for label, v in out.items()]


FM_EDGE_SPECS = fm_edge_specs()


def fm_edge_text(spec, seed: int = 17) -> np.ndarray:
    """The codes of one of FM_EDGE_SPECS, from a generator of its own."""
    _, n, what = spec
    if isinstance(what, int):
        return np.full(n, what, np.uint8)
    return fm_codes_with_primary(np.random.default_rng((seed, n, *what)), n,
                                 what)


def fm_queries(rng, codes, S: int = 256, L: int = 32):
    """[S, L] int32 codes and [S] int32 lengths 0..L, every length among
    the first L + 1: half cut from the text (present), half random
    (mostly absent), 255 past each length."""
    n = len(codes)
    Q = rng.integers(0, 4, (S, L)).astype(np.int32)
    ql = rng.integers(0, L + 1, S).astype(np.int32)
    ql[:L + 1] = np.arange(L + 1)
    for s in range(0, S, 2):
        k = min(int(ql[s]), n)
        at = int(rng.integers(0, n - k + 1))
        Q[s, :k] = codes[at:at + k]
        ql[s] = k
    for s in range(S):
        Q[s, ql[s]:] = 255
    return Q, ql


def yeast_like(rng):
    """(contigs [(name, str)], codes [12,071,326] uint8, contig starts):
    S288C's 16 chromosome lengths, random bases, YEAST_DUPS segments of
    1-5 kb copied to random places (repeats for second best and MAPQ)."""
    lens = np.array([n for _, n in YEAST], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    codes = rng.integers(0, 4, int(starts[-1])).astype(np.uint8)
    for _ in range(YEAST_DUPS):
        ln = int(rng.integers(1000, 5001))
        a, b = rng.integers(0, len(codes) - ln, 2)
        codes[b:b + ln] = codes[a:a + ln]
    text = BASES[codes].tobytes().decode()
    return ([(name, text[s:s + n]) for (name, n), s in zip(YEAST, starts)],
            codes, starts)


def mutate_windows(rng, win, L, sub=0.01, indel=0.1, n_rate=0.001):
    """[n, L + 3] windows of codes → [n, L] reads: ~1% substitutions, one
    1-3 bp insertion or deletion in a tenth of them, ~0.1% Ns (code 4)."""
    win = np.where(rng.random(win.shape) < sub,
                   (win + rng.integers(1, 4, win.shape)) % 4,
                   win).astype(np.uint8)
    win[rng.random(win.shape) < n_rate] = 4
    out = win[:, :L].copy()
    for i in np.flatnonzero(rng.random(len(win)) < indel):
        at, d = int(rng.integers(20, L - 20)), int(rng.integers(1, 4))
        w = win[i]
        if rng.random() < 0.5:
            out[i] = np.concatenate([w[:at], w[at + d:]])[:L]
        else:
            out[i] = np.concatenate(
                [w[:at], rng.integers(0, 4, d).astype(np.uint8), w[at:]])[:L]
    return out


def as_reads(arr, rev) -> list[str]:
    """Reads of codes (4 = N) as strings, the rows under `rev` reverse
    complemented."""
    arr = arr.copy()
    arr[rev] = COMPLEMENT2[arr[rev]][:, ::-1]
    return [READ_LUT[r].tobytes().decode() for r in arr]


def simulate_reads(rng, codes, starts, n, L=MAP_LEN):
    """n reads of L bases (mutate_windows' errors), every second from the
    reverse strand; returns (reads, contig index, 0-based start in the
    contig, reverse)."""
    room = np.diff(starts) - L - 3
    ci = rng.choice(len(room), n, p=room / room.sum())
    local = (rng.random(n) * room[ci]).astype(np.int64)
    win = codes[(starts[ci] + local)[:, None] + np.arange(L + 3)]
    rev = np.arange(n) % 2 == 1
    return as_reads(mutate_windows(rng, win, L), rev), ci, local, rev


def simulate_pairs(rng, codes, starts, n, L=MAP_LEN, lost=0.05):
    """n FR pairs: fragments of 300-500 bp, mate 1 its first L bases,
    mate 2 the reverse complement of its last L (mutate_windows' errors);
    in a `lost` share one mate (first or second in turn) is random
    sequence, which maps nowhere, so the pair goes to rescue.  Returns
    (mates 1, mates 2, contig index, fragment start, lost mask)."""
    ins = rng.integers(300, 501, n)
    room = np.diff(starts) - 503
    ci = rng.choice(len(room), n, p=room / room.sum())
    local = (rng.random(n) * room[ci]).astype(np.int64)
    g = starts[ci] + local
    w1 = codes[g[:, None] + np.arange(L + 3)]
    w2 = codes[(g + ins - L)[:, None] + np.arange(L + 3)]
    m1 = mutate_windows(rng, w1, L)
    m2 = mutate_windows(rng, w2, L)
    gone = rng.random(n) < lost
    for i in np.flatnonzero(gone):
        (m1 if i % 2 else m2)[i] = rng.integers(0, 4, L)
    fwd = np.zeros(n, bool)
    return (as_reads(m1, fwd), as_reads(m2, ~fwd), ci, local, gone)


def origin_share(maps, names, ci, local, tol: int = 2) -> float:
    """Share of reads mapped to their own contig within tol bp of the
    start they were cut from."""
    ok = sum(m.pos > 0 and m.contig == names[c] and abs(m.pos - 1 - p) <= tol
             for m, c, p in zip(maps, ci, local))
    return ok / len(maps)


@contextlib.contextmanager
def shared_qgram_index(mapper):
    """Within the block, a ReadMapper built on `mapper`'s reference takes
    `mapper`'s q-gram index in place of building its own: the `map` CLI's
    runs over the same FASTA build no index."""
    from genomics_tpu_torch.models import mapper as mm

    inner = mm.QGramIndex

    def build(text, q=16):
        same = (isinstance(text, str) and text == mapper.reference
                and q == mapper.index.q)
        return mapper.index if same else inner(text, q)
    mm.QGramIndex = build
    try:
        yield
    finally:
        mm.QGramIndex = inner


@contextlib.contextmanager
def recording_fm(store: list):
    """Within the block, every fm_search call appends (queries, qlen, lo,
    hi): the launches the mapper makes, to be checked after."""
    from genomics_tpu_torch.ops import fm_search as fs

    inner = fs.fm_search

    def record(idx, q, ql):
        lo, hi = inner(idx, q, ql)
        store.append((idx, q, ql, lo, hi))
        return lo, hi
    fs.fm_search = record
    try:
        yield
    finally:
        fs.fm_search = inner


def cpu_twin(mapper):
    """The same ReadMapper (its indexes shared) on the CPU: its engine,
    FM search and Myers take the plain versions."""
    import copy

    from genomics_tpu_torch import AlignEngine

    twin = copy.copy(mapper)
    twin.device = torch.device("cpu")
    twin.engine = AlignEngine(mapper.params, with_tb=True, device="cpu")
    twin._dev_fm = None
    return twin


def host_backward_search(fm, Q, ql, chunk: int = 4096, threads: int = 8):
    """FMIndex.backward_search over chunks of the queries, in threads
    (numpy's gathers let go of the GIL); returns (lo, hi) int64."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as ex:
        parts = list(ex.map(
            lambda i: fm.backward_search(Q[i:i + chunk], ql[i:i + chunk]),
            range(0, len(ql), chunk)))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def mapping_fields(maps) -> list:
    import dataclasses

    return [dataclasses.asdict(m) for m in maps]


def write_fastq(path: str, names, seqs):
    with open(path, "w") as fh:
        for name, s in zip(names, seqs):
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")


def sam_body(path: str) -> tuple[list, list]:
    """(header lines, record lines) of a SAM file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    return ([ln for ln in lines if ln.startswith("@")],
            [ln for ln in lines if not ln.startswith("@")])


def mapper_counts() -> dict:
    """Every kernel's launch count (the mapper's paths read these)."""
    from genomics_tpu_torch.ops import cuda_align, fm_search, myers, tb_walk

    return {**cuda_align.LAUNCHES, **tb_walk.LAUNCHES, **myers.LAUNCHES,
            **fm_search.LAUNCHES}


def zero_mapper_counts():
    from genomics_tpu_torch.ops import cuda_align, fm_search, myers, tb_walk

    zero_counts(cuda_align.LAUNCHES, tb_walk.LAUNCHES, myers.LAUNCHES,
                fm_search.LAUNCHES)


def launched(want, label: str) -> dict:
    """The nonzero launch counts since zero_mapper_counts; raises unless
    every kernel of `want` was launched."""
    got = {k: v for k, v in mapper_counts().items() if v}
    missing = [k for k in want if not got.get(k)]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched ({got})")
    return got


def mapper_inputs(seed: int, n_reads: int, n_pairs: int):
    """The mapper slice's genome, reads and pairs, from their own
    generator (so that the earlier phases' data stay as they were)."""
    rng = np.random.default_rng(seed + 23)
    contigs, codes, starts = yeast_like(rng)
    reads = simulate_reads(rng, codes, starts, n_reads)
    pairs = simulate_pairs(rng, codes, starts, n_pairs)
    return contigs, codes, starts, reads, pairs


def write_mapper_files(dirname: str, contigs, reads, pairs, n_reads: int,
                       n_pairs: int) -> dict:
    """ref.fa, reads.fq (n_reads), m1.fq / m2.fq (n_pairs) under dirname,
    and their first MAP_CHECK reads / MAP_CHECK // 2 pairs (head*.fq)."""
    from genomics_tpu_torch.utils.fasta import write_fasta

    p = {k: os.path.join(dirname, f) for k, f in (
        ("ref", "ref.fa"), ("reads", "reads.fq"), ("m1", "m1.fq"),
        ("m2", "m2.fq"), ("head", "head.fq"), ("h1", "h1.fq"),
        ("h2", "h2.fq"))}
    write_fasta(p["ref"], contigs, width=80)
    names = [f"read{i}" for i in range(n_reads)]
    write_fastq(p["reads"], names, reads[:n_reads])
    write_fastq(p["head"], names[:MAP_CHECK], reads[:MAP_CHECK])
    pnames = [f"pair{i}" for i in range(n_pairs)]
    write_fastq(p["m1"], pnames, pairs[0][:n_pairs])
    write_fastq(p["m2"], pnames, pairs[1][:n_pairs])
    half = MAP_CHECK // 2
    write_fastq(p["h1"], pnames[:half], pairs[0][:half])
    write_fastq(p["h2"], pnames[:half], pairs[1][:half])
    return p


def mapper_slice(seed: int, dev, smi: str, peak: float):
    """Phases 3-5 of the mapper slice on the card; returns fm_search's row
    of the kernels line but its name, route and source, and the SAM files
    of both seeders' map_batch over the same reads ({"fmdev": path,
    "qgram": path, "dir": their TemporaryDirectory})."""
    from genomics_tpu_torch.index.fmindex import FMIndex
    from genomics_tpu_torch.models.mapper import ReadMapper
    from genomics_tpu_torch.ops import fm_search as fs
    from genomics_tpu_torch.utils import bamio, samio

    err = 0
    # -- 3. fm_search at its edges ----------------------------------------
    qrng = np.random.default_rng(seed + 21)
    edges = [(spec[0], fm_edge_text(spec, seed + 17))
             for spec in FM_EDGE_SPECS]
    small = qrng.integers(0, 4, 300).astype(np.uint8)
    for label, codes in edges + [("every q-gram of 300 bp", small)]:
        fm = FMIndex(codes)
        idx = fm.to_device(device=dev)
        if label.startswith("every"):
            Q = np.concatenate([np.pad(np.lib.stride_tricks.sliding_window_view(
                codes, q), ((0, 0), (0, 32 - q)), constant_values=255)
                for q in range(1, 33)]).astype(np.int32)
            ql = np.repeat(np.arange(1, 33, dtype=np.int32),
                           [len(codes) - q + 1 for q in range(1, 33)])
        else:
            Q, ql = fm_queries(qrng, codes)
        q = torch.from_numpy((Q & 3).astype(np.uint8)).to(dev)
        qlt = torch.from_numpy(ql).to(dev)
        got = fs.fm_search(idx, q, qlt)
        want = fs.backward_search_plain(idx, q, qlt)
        host = fm.backward_search(Q, ql)
        err = max(err, max_abs_err(got, want), max_abs_err(
            got, [torch.from_numpy(h.astype(np.int32)).to(dev)
                  for h in host]))
    if err:
        raise AssertionError(f"fm_search disagrees at its edges: {err}")
    log("3 parity", f"fm_search == plain == FMIndex.backward_search at "
        f"{len(edges)} texts ({', '.join(lb for lb, _ in edges)}), "
        f"queries of 0-32 present and absent, and every 1-32-gram of a "
        f"300 bp text")

    # -- 4. the mapper slice ------------------------------------------------
    t0 = time.time()
    contigs, codes, starts, reads, pairs = mapper_inputs(seed, MAP_READS,
                                                         MAP_PAIRS)
    names = [n for n, _ in contigs]
    reads, r_ci, r_local, _r_rev = reads
    gen_s = time.time() - t0
    t0 = time.time()
    m_fm = ReadMapper(contigs, seeder="fmdev", device=dev)
    fm_build = time.time() - t0
    t0 = time.time()
    m_q = ReadMapper(contigs, device=dev)
    q_build = time.time() - t0
    log("4 mapper", f"genome {len(codes)} bp in {len(contigs)} contigs "
        f"(S288C's lengths, {YEAST_DUPS} copied segments of 1-5 kb), "
        f"{MAP_READS} reads of {MAP_LEN} bp, {MAP_PAIRS} pairs, made in "
        f"{gen_s:.1f} s; FMIndex (sa_rate {m_fm.fm.sa_rate}) {fm_build:.1f}"
        f" s, QGramIndex {q_build:.1f} s on the host")
    walls, rates, launches = {}, {}, {}

    # fmdev seeding + the `ed` stage + the gapped DP with traceback
    zero_mapper_counts()
    seeds = []
    with recording_fm(seeds):
        t0 = time.time()
        maps = m_fm.map_batch(reads, two_stage="ed")
        walls["fmdev"] = time.time() - t0
    launches["fmdev"] = launched(("fm_search", "myers", "local_sw.tb",
                                  "tb_walk"), "fmdev + ed")
    n_seeds = sum(len(r[2]) for r in seeds)
    for idx, q, ql, lo, hi in seeds:
        err = max(err, max_abs_err((lo, hi),
                                   fs.backward_search_plain(idx, q, ql)))
    t0 = time.time()
    Qh = torch.cat([r[1] for r in seeds]).cpu().numpy()
    qlh = torch.cat([r[2] for r in seeds]).cpu().numpy()
    hlo, hhi = host_backward_search(m_fm.fm, Qh, qlh)
    host_s = time.time() - t0
    dlo = torch.cat([r[3] for r in seeds]).cpu().numpy()
    dhi = torch.cat([r[4] for r in seeds]).cpu().numpy()
    err = max(err, int(np.abs(dlo - hlo).max(initial=0)),
              int(np.abs(dhi - hhi).max(initial=0)))
    if err:
        raise AssertionError(f"fm_search disagrees on the mapper's seeds: "
                             f"{err}")
    twin = cpu_twin(m_fm)
    t0 = time.time()
    cpu_maps = twin.map_batch(reads[:MAP_CHECK], two_stage="ed")
    cpu_s = time.time() - t0
    if mapping_fields(maps[:MAP_CHECK]) != mapping_fields(cpu_maps):
        raise AssertionError("fmdev + ed: the first reads' Mappings differ "
                             "from device='cpu'")
    share = origin_share(maps, names, r_ci, r_local)
    rates["fmdev"] = MAP_READS / walls["fmdev"]
    log("4 mapper", f"ReadMapper(seeder='fmdev').map_batch(two_stage='ed'):"
        f" {walls['fmdev']:.2f} s, {rates['fmdev']:.0f} reads/s; "
        f"{len(seeds)} fm_search calls over {n_seeds} seeds, == plain on the "
        f"card and == FMIndex.backward_search on the host ({host_s:.1f} s); "
        f"the first {MAP_CHECK} Mappings == device='cpu' ({cpu_s:.1f} s); "
        f"mapped {sum(m.pos > 0 for m in maps)}, {100 * share:.2f}% within "
        f"2 bp of their origin; launches {launches['fmdev']}")

    # the default seeder: q-grams
    zero_mapper_counts()
    t0 = time.time()
    maps_q = m_q.map_batch(reads)
    walls["qgram"] = time.time() - t0
    launches["qgram"] = launched(("local_sw.tb", "tb_walk"), "qgram")
    if launches["qgram"].get("fm_search"):
        raise AssertionError("the qgram seeder launched fm_search")
    twin_q = cpu_twin(m_q)
    if mapping_fields(maps_q[:MAP_CHECK]) != mapping_fields(
            twin_q.map_batch(reads[:MAP_CHECK])):
        raise AssertionError("qgram: the first reads' Mappings differ from "
                             "device='cpu'")
    share_q = origin_share(maps_q, names, r_ci, r_local)
    # both seeders' SAMs of the same reads, for the tools slice's alndiff
    sam_dir = tempfile.TemporaryDirectory()
    sams = {"dir": sam_dir}
    for tag, mm in (("fmdev", maps), ("qgram", maps_q)):
        sams[tag] = os.path.join(sam_dir.name, f"{tag}.sam")
        samio.write_sam(sams[tag], [(n, len(c)) for n, c in contigs], 0,
                        [(f"read{i}", r, m)
                         for i, (r, m) in enumerate(zip(reads, mm))])
    rates["qgram"] = MAP_READS / walls["qgram"]
    log("4 mapper", f"ReadMapper().map_batch: {walls['qgram']:.2f} s, "
        f"{rates['qgram']:.0f} reads/s; the first {MAP_CHECK} Mappings == "
        f"device='cpu'; mapped {sum(m.pos > 0 for m in maps_q)}, "
        f"{100 * share_q:.2f}% within 2 bp of their origin; launches "
        f"{launches['qgram']}")

    # pairs, with rescue
    r1, r2, p_ci, p_local, gone = pairs
    rescued = []
    inner = m_q._rescue_candidates

    def rescue(cands, a, b, lo, hi, discordant):
        rescued.append(len(discordant))
        return inner(cands, a, b, lo, hi, discordant)
    m_q._rescue_candidates = rescue
    zero_mapper_counts()
    t0 = time.time()
    pm = m_q.map_pairs(r1, r2)
    walls["pairs"] = time.time() - t0
    del m_q._rescue_candidates
    launches["pairs"] = launched(("local_sw.tb", "tb_walk"), "map_pairs")
    half = MAP_CHECK // 2
    cpu_pairs = twin_q.map_pairs(r1[:half], r2[:half])
    if [mapping_fields(p) for p in pm[:half]] != [mapping_fields(p)
                                                  for p in cpu_pairs]:
        raise AssertionError("map_pairs: the first pairs differ from "
                             "device='cpu'")
    proper = sum(a.proper_pair for a, _ in pm)
    share_p = origin_share([a for a, _ in pm], names, p_ci, p_local)
    rates["pairs"] = MAP_PAIRS / walls["pairs"]
    if not rescued or not rescued[0]:
        raise AssertionError("map_pairs: rescue never ran")
    log("4 mapper", f"map_pairs: {walls['pairs']:.2f} s, {rates['pairs']:.0f}"
        f" pairs/s; rescue over {rescued[0]} discordant pairs ({int(gone.sum())}"
        f" with a random mate); {proper} proper pairs; mate 1 within 2 bp "
        f"of its origin {100 * share_p:.2f}%; the first {half} pairs == "
        f"device='cpu'; launches {launches['pairs']}")

    # the `map` subcommand over FASTA / FASTQ files: SAM, BAM, paired
    tmp = tempfile.TemporaryDirectory()
    files = write_mapper_files(tmp.name, contigs, reads, pairs, CLI_READS,
                               CLI_PAIRS)
    out = {k: os.path.join(tmp.name, k) for k in (
        "out.sam", "out.bam", "pairs.sam", "cpu.sam", "cpupairs.sam")}
    cli_runs = (("SAM", ["-q", files["reads"], "-o", out["out.sam"]],
                 CLI_READS),
                ("BAM", ["-q", files["reads"], "-o", out["out.bam"]],
                 CLI_READS),
                ("paired SAM", ["-q", files["m1"], "-2", files["m2"], "-o",
                                out["pairs.sam"]], 2 * CLI_PAIRS))
    with shared_qgram_index(m_q):
        for label, argv, lines in cli_runs:
            zero_mapper_counts()
            t0 = time.time()
            said = run_cli(["map", "-r", files["ref"], *argv, "--device",
                            str(dev)])
            walls[f"cli {label}"] = time.time() - t0
            launches[f"cli {label}"] = launched(("local_sw.tb", "tb_walk"),
                                                f"map CLI ({label})")
            rates[f"cli {label}"] = lines / walls[f"cli {label}"]
            log("4 mapper", f"python -m genomics_tpu_torch map ({label}): "
                f"{said.strip()}; {walls[f'cli {label}']:.2f} s, "
                f"{rates[f'cli {label}']:.0f} lines/s (the FASTA read; the "
                f"q-gram index shared with ReadMapper() above, its "
                f"{q_build:.1f} s build not included); launches "
                f"{launches[f'cli {label}']}")
        run_cli(["map", "-r", files["ref"], "-q", files["head"], "-o",
                 out["cpu.sam"], "--device", "cpu"])
        run_cli(["map", "-r", files["ref"], "-q", files["h1"], "-2",
                 files["h2"], "-o", out["cpupairs.sam"], "--device", "cpu"])
    for card, cpu in (("out.sam", "cpu.sam"), ("pairs.sam", "cpupairs.sam")):
        h_card, body = sam_body(out[card])
        h_cpu, body_cpu = sam_body(out[cpu])
        if h_card != h_cpu or body[:MAP_CHECK] != body_cpu:
            raise AssertionError(f"map CLI: {card}'s header or first "
                                 f"{MAP_CHECK} lines differ from --device "
                                 f"cpu")
    _, sam_lines = sam_body(out["out.sam"])
    _h, refs, recs = bamio.read_bam(out["out.bam"])
    if [n for n, _ in refs] != names or len(recs) != len(sam_lines):
        raise AssertionError("map CLI: the BAM's references or records do "
                             "not match the SAM's")
    for r, ln in zip(recs, sam_lines):
        f = ln.split("\t")
        if (r.name, r.flag, r.pos + 1, r.mapq, r.cigar, r.seq) != (
                f[0], int(f[1]), int(f[3]), int(f[4]), f[5], f[9]):
            raise AssertionError(f"map CLI: BAM record {r.name} differs from "
                                 f"its SAM line")
    tmp.cleanup()
    log("4 mapper", f"map CLI: SAM and paired SAM headers and first "
        f"{MAP_CHECK} lines == --device cpu; every BAM record == its SAM "
        f"line")

    # benchmarks/run_all.py's bench_mapper shape (best of 3)
    brng = np.random.default_rng(0)
    g = brng.integers(0, 4, BENCH_MAP_GENOME)
    bref = BASES[g].tobytes().decode()
    breads = []
    for p in brng.integers(0, BENCH_MAP_GENOME - BENCH_MAP_LEN,
                           2 * BENCH_MAP_READS):
        r = g[p:p + BENCH_MAP_LEN].copy()
        e = brng.random(BENCH_MAP_LEN) < 0.01
        r[e] = (r[e] + brng.integers(1, 4, int(e.sum()))) % 4
        breads.append(BASES[r].tobytes().decode())
    bm = ReadMapper(bref, device=dev)
    bm.map_batch(breads[:BENCH_MAP_READS])
    best = None
    for _ in range(3):
        t0 = time.time()
        bout = bm.map_batch(breads[BENCH_MAP_READS:])
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    mapped = sum(m.pos > 0 for m in bout)
    if mapped < 0.95 * BENCH_MAP_READS:
        raise AssertionError(f"bench_mapper shape: only {mapped} mapped")
    rates["bench_mapper"] = BENCH_MAP_READS / best
    log("4 mapper", f"run_all.py's bench_mapper shape ({BENCH_MAP_READS} "
        f"warm + {BENCH_MAP_READS} timed {BENCH_MAP_LEN} bp reads, "
        f"{BENCH_MAP_GENOME} bp): mapper_reads_per_s "
        f"{rates['bench_mapper']:.1f} (best of 3), {mapped} mapped; on {smi}")

    # -- 5. fm_search's timings -------------------------------------------
    idx = seeds[0][0]
    big = max(seeds, key=lambda r: r[1].shape[0])
    index_bytes = 4 * (idx.rec.numel() + idx.table.numel() + 6)
    rng = np.random.default_rng(seed + 29)
    S = FM_TIMING_Q
    ql = rng.integers(16, 33, S).astype(np.int32)
    at = rng.integers(0, len(codes) - 32, S)
    Q = codes[at[:, None] + np.arange(32)]
    Q[1::2] = rng.integers(0, 4, (S // 2, 32))
    shapes = {"the mapper's seeds": (big[1], big[2]),
              f"{S} queries of 16-32": (torch.from_numpy(Q).to(dev),
                                        torch.from_numpy(ql).to(dev))}
    row = None
    for label, (q, ql_t) in shapes.items():
        stats = {}
        want = fs.backward_search_plain(idx, q, ql_t, stats=stats)
        lay = fs.fm_search_layout(idx, q, ql_t)
        err = max(err, max_abs_err(fs.launch_fm_search(lay), want))
        k_ms = graph_ms(lambda: fs.launch_fm_search(lay), 20)
        host_ms = cuda_ms(lambda: fs.launch_fm_search(lay), 20)
        p_ms = cuda_ms(lambda: fs.backward_search_plain(idx, q, ql_t), 2)
        n, L = q.shape
        steps, ranks, lookups, keys = (
            stats[k] for k in ("steps", "ranks", "lookups", "key_codes"))
        ops = (FM_OPS_PER_STEP * steps + FM_OPS_PER_RANK * ranks
               + FM_OPS_PER_KEY * keys + FM_OPS_PER_LOOKUP * lookups)
        bd = bound(ops, n * L + 4 * n + 8 * n + index_bytes, peak)
        floor = 32 * (ranks + lookups) / HBM_BYTES_PER_S * 1e3
        log("5 timings", f"fm_search at {label} ({n} x {L}, suffix table "
            f"of {idx.tk} codes): kernel {k_ms:.4f} ms (a CUDA graph's "
            f"replay; launched from the host {host_ms:.4f} ms; "
            f"{n / k_ms / 1e3:.1f} M queries/s), plain {p_ms:.2f} ms, bound "
            f"{bd[0]:.4f} ms by {bd[1]} ({steps} steps x {FM_OPS_PER_STEP} +"
            f" {ranks} ranks x {FM_OPS_PER_RANK} + {keys} key codes x "
            f"{FM_OPS_PER_KEY} + {lookups} lookups x {FM_OPS_PER_LOOKUP} = "
            f"{ops} int op, {steps / n:.2f} steps a query after the table; "
            f"{n * L + 12 * n + index_bytes} bytes, the index's "
            f"{index_bytes} of them resident in L2, so the HBM bound "
            f"understates the floor), {k_ms / bd[0]:.1f} x the bound; L2 "
            f"sector floor {floor:.4f} ms ({ranks + lookups} sectors of 32 "
            f"bytes at the HBM rate), {k_ms / floor:.1f} x; == plain; on "
            f"{smi}")
        if row is None:
            row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bd[0],
                       bound_by=bd[1])
    if err:
        raise AssertionError(f"fm_search disagrees with its plain version at "
                             f"the timed launches: {err}")
    log("5 timings", "mapper: " + ", ".join(
        f"{k} {v:.0f} {'lines' if k.startswith('cli') else 'pairs' if k == 'pairs' else 'reads'}/s"
        for k, v in rates.items()) + f" (host clock); on {smi}")
    return dict(launches=launches["fmdev"]["fm_search"], max_abs_err=err,
                **row), sams


# -- the clustering slice (cluster_slice) ----------------------------------
# benchmarks/run_all.py's bench_cluster (:542-569) and bench_ngia
# (:657-683): their read counts, lengths, families and mutations
CLUSTER_READS, CLUSTER_LEN, CLUSTER_SPEC = 50000, 140, 256
NGIA_READS, NGIA_LEN, NGIA_SPEC = 8000, 1200, 32
NGIA_MIXED = (300, 1200)  # family lengths of the mixed-length nGIA set
CLUSTER_CHECK, NGIA_CHECK = 5000, 1000   # reads held to device="cpu"
CLI_CLUSTER, CLI_NGIA = 2000, 500  # reads of the CLIs' runs, held to cpu
CLUSTER_WINDOWS = 2      # speculative windows held to the plain versions
MIN_SUM_COLS = 2048      # job columns of the min-sum held to the host's
# Integer operations, as csrc/cluster_lcs.cu and ngia_lcs.cu count them
# (myers.cu's rule: a match-mask select, the carrying add and each
# three-input bitwise function one op): per row word and active query
# step 4, per active step 5, per filter bin 2 (nGIA)
LCS_OPS_PER_WORD, LCS_OPS_PER_STEP, NGIA_OPS_PER_BIN = 4, 5, 2
INT8_TOPS = 1.979e15      # H100 SXM dense int8 tensor rate (data sheet)
LCS_EDGE_NETS = (1, 31, 32, 33, 63, 64, 65)
LCS_LONG = 4200   # bases of a row past the widest lane group (128 words)
# launches whose rows in shared memory pass 48 KB with the kernels' static
# shared memory: a representative of LCS_THREAD_BP bases (79 words, a
# thread a pair: 528 bytes a word a block), and LCS_LONG's launches with
# warp slots of LCS_SMEM_WORDS words (a warp a pair: 16 bytes a word)
LCS_THREAD_BP, LCS_SMEM_WORDS = 2500, 2500
LCS_EDGE_S = (1, 7, 256)
# (representative, read, similarity) where nGIA's band rounds differently
# in separately rounded f32 and in the fma the JAX package computes
NGIA_FMA_PAIRS = ((203, 180, 0.95), (113, 90, 0.9))


LCS_ROWS = (("cluster_lcs", "genomics_tpu/models/cluster.py:192"),
            ("ngia_lcs", "genomics_tpu/models/ngia.py:91"))


# The kernel's edges (label, wl, K, S, J): one and eight copies of a word,
# wl = 7 (16,384 bins, 8 tables a block), one representative (a lane a
# job), one job, J not a multiple of 8 or 32, two groups of 32
# representatives; every set also has a job that is a representative, a
# job whose words all miss and a read with no words.
FILTER_EDGES = (("K=1", 5, 1, 5, 37), ("K=8", 4, 8, 33, 70),
                ("wl=7", 7, 3, 9, 45), ("S=1", 6, 2, 1, 100),
                ("J=1", 6, 2, 12, 1), ("J=33", 5, 4, 3, 33),
                ("S=64 J=65", 6, 5, 64, 65))


def filter_edge_inputs(label, wl, K, S, J, seed=23):
    """(words, counts, prefix, wcut, bcut, reps, jobs, D) of one of
    FILTER_EDGES: reads drawn from a pool of words so that their min-sums
    spread, cutoffs around them, base counts that pass and fail."""
    rng = np.random.default_rng((seed, wl, K, S, J))
    bins, N, wmax = 1 << 2 * wl, S + J + 2, 23
    pool = rng.choice(bins - 64, 40, replace=False) + 64
    words = np.zeros((N, wmax), np.uint16)
    counts = np.zeros((N, wmax), np.uint16)
    for i in range(N):
        n = int(rng.integers(1, wmax + 1))
        src = np.arange(n) if i == N - 1 else rng.choice(pool, n, False)
        w = np.sort(src)                      # the last read's all miss
        words[i, :n] = w
        counts[i, :n] = rng.integers(1, K + 1, n)
    counts[0, 0] = K
    words[N - 2] = counts[N - 2] = 0          # a read with no words
    D = np.zeros((N, bins), np.uint8)
    for i in range(N):
        D[i, words[i][counts[i] > 0]] = counts[i][counts[i] > 0]
    prefix = rng.integers(10, 40, (N, 4)).astype(np.int32)
    bcut = rng.integers(40, 100, N).astype(np.int32)
    wcut = rng.integers(0, 30, N).astype(np.int32)
    wcut[N - 1] = bcut[N - 1] = 0              # passes on no word at all
    reps = rng.choice(N - 2, S, replace=False).astype(np.int32)
    jobs = np.concatenate([[N - 1, reps[0]], rng.integers(0, N, J)])[:J]
    return (words, counts, prefix, wcut, bcut, reps, jobs.astype(np.int32),
            D)


# and on the card also many groups of representatives and blocks at wl = 7
FILTER_CARD_EDGES = FILTER_EDGES + (
    ("wl=7 S=256 J=3001", 7, 8, 256, 3001),)
# Integer operations of csrc/cluster_filter.cu (its header): per
# representative and job word a min and an add, per pair the prefix
# minimum-sum (4 mins, 3 adds), two compares and an AND
CF_OPS_PER_LOOKUP, CF_OPS_PER_PAIR = 2, 10


def family_reads(rng, n_reads: int, L, per: int, mutations: int):
    """run_all.py's generator: n_reads // per families of L random bases
    (L an int, or (lo, hi): each family's length drawn from [lo, hi]),
    read i a copy of family i % n_fam with up to mutations - 1 bases
    replaced."""
    bases = np.array(list("ACGT"))
    n_fam = max(n_reads // per, 1)
    lens = ([L] * n_fam if isinstance(L, int)
            else rng.integers(L[0], L[1] + 1, n_fam))
    fams = [bases[rng.integers(0, 4, n)] for n in lens]
    reads = []
    for i in range(n_reads):
        c = fams[i % n_fam].copy()
        idx = rng.choice(len(c), size=rng.integers(0, mutations),
                         replace=False)
        c[idx] = bases[rng.integers(0, 4, len(idx))]
        reads.append("".join(c))
    return reads


def noisy(rng, s: str, n: int = 3) -> str:
    """s with n positions made a gap, an N, a lowercase base or a U."""
    c = np.array(list(s))
    for pos in rng.integers(0, len(c), n):
        c[pos] = rng.choice(list("-NacgtU"))
    return "".join(c)


def lcs_edge_reads(rng) -> list[str]:
    """Reads at cluster_lcs.cu's edges: prefixes of one 1,100 bp family
    base at the word edges (LCS_EDGE_NETS, one-word texts) and at 140 /
    1,100 bases (35 words: past the widest register bucket), mutated and
    noisy copies (gaps, Ns, lowercase, U), a one-base text, and reads of
    net 0 (empty, all N)."""
    base = "".join(rng.choice(list("ACGT"), 1100))
    reads = [base[:n] for n in (*LCS_EDGE_NETS, 140, 1100)]
    reads += [mutate(rng, base[:140], 0.02, 0.0) for _ in range(6)]
    reads += [noisy(rng, mutate(rng, base[:140], 0.02, 0.0))
              for _ in range(4)]
    reads += [mutate(rng, base, 0.02, 0.0), "A", "", "N" * 20,
              random_seq(rng, 140)]
    return reads


def ngia_edge_reads(rng, sim: float) -> list[str]:
    """Reads at ngia_lcs.cu's edges for similarity `sim`: prefixes of one
    1,100 bp family base at the word edges (bands clipped at word 0 and at
    the row's last word), mutated and noisy copies, reads under 3 bases
    (an empty histogram), a 40 bp read (an empty band against the long
    ones), 1,100 bp against 100 bp (a band of 65 words, past the widest
    register window), and the NGIA_FMA_PAIRS of this similarity."""
    base = "".join(rng.choice(list("ACGT"), 1100))
    reads = [base[:n] for n in (*LCS_EDGE_NETS, 100, 300, 1100)]
    reads += [mutate(rng, base[:300], 0.01, 0.0) for _ in range(6)]
    reads += [noisy(rng, mutate(rng, base[:300], 0.01, 0.0))
              for _ in range(4)]
    reads += ["A", "AC", "", base[:40], random_seq(rng, 300)]
    for rn, qn, s in NGIA_FMA_PAIRS:
        if s == sim:
            rep = random_seq(rng, rn)
            reads += [rep, mutate(rng, rep[:qn], 0.02, 0.0)]
    return reads


def lcs_edge_launches(rng, n: int):
    """(reps, jobs) of the edge launches over n reads: every read alone,
    then S of 1, 7 and 256 drawn with replacement, each against all jobs
    but the first three (J not a multiple of 32)."""
    jobs = np.arange(3, n, dtype=np.int32)
    return ([(np.array([r], np.int32), jobs) for r in range(n)]
            + [(rng.integers(0, n, S).astype(np.int32), jobs)
               for S in LCS_EDGE_S])


def cluster_lcs_parity(rng, dev) -> tuple[int, int]:
    """cluster_lcs against lcs_accept_plain on the card over
    lcs_edge_reads: each edge launch gated by random bits and ungated, in
    the rule's layout and with G x K = 128 and the rows in a global
    scratch (max_words past SHARED_WORDS; the plain version once over
    every representative, each read alone held to its row); then a launch no
    pair passes (a gate of zeros), one every pair passes (no gate), 300
    columns drawn from the reads against one 140 bp representative (a
    block's survivors across its warps, groups part empty), the same
    columns against 256 representatives (blocks of 32 or more gated pairs
    run them a thread each), nets 1, 33, 65, 140 and 1,100 in one launch
    (G x K = 64), and a 4,200 bp
    representative (132 words: its block a warp a pair) beside a 140 bp
    one, also in warp slots of LCS_SMEM_WORDS words, and a 2,500 bp
    representative among 256 against 300 short columns (a thread a pair):
    shared memory past 48 KB with the kernel's static part; returns (the
    largest difference, launches)."""
    from genomics_tpu_torch.models import cluster as TC
    from genomics_tpu_torch.ops import lcs

    reads = lcs_edge_reads(rng)
    N = len(reads)
    p = TC._prepare(reads, 0.9, 5)
    aux = TC._aux_dev(p, dev)
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    every = torch.arange(N, dtype=torch.int32, device=dev)
    wide = lcs.SHARED_WORDS + 1
    err = n = 0

    def check(rp, jb, gate, want=None, words=(None, wide)):
        nonlocal err, n
        if want is None:
            want = lcs.lcs_accept_plain(*args, rp, jb, gate)
        for mw in words:
            got = lcs.lcs_accept(*args, rp, jb, gate, max_words=mw)
            err = max(err, max_abs_err([got], [want]))
            n += 1
    for gated in (False, True):
        launches = lcs_edge_launches(rng, N)
        jb = torch.from_numpy(launches[0][1]).to(dev)
        g_all = (torch.from_numpy(rng.integers(0, 2, (N, jb.shape[0])).astype(
            np.uint8)).to(dev) if gated else None)
        w_all = lcs.lcs_accept_plain(*args, every, jb, g_all)
        for reps, _ in launches:
            rp = torch.from_numpy(reps).to(dev)
            gate = None if g_all is None else g_all[rp.long()]
            check(rp, jb, gate, w_all[rp.long()] if len(reps) == 1 else None)
    net = p.net_lengths
    at = {m: int(np.nonzero(net == m)[0][0]) for m in (1, 33, 65, 140, 1100)}
    jb = torch.from_numpy(np.arange(3, N, dtype=np.int32)).to(dev)
    rp = torch.tensor([at[140], at[65]], dtype=torch.int32, device=dev)
    check(rp, jb, torch.zeros((2, N - 3), dtype=torch.uint8, device=dev))
    check(rp, jb, None)
    cols = torch.from_numpy(rng.integers(0, N, 300).astype(np.int32)).to(dev)
    check(rp[:1], cols, None)
    many = torch.from_numpy(rng.integers(0, N, 256).astype(np.int32)).to(dev)
    check(many, cols, None)
    check(torch.tensor(list(at.values()), dtype=torch.int32, device=dev), jb,
          None)
    # a 4,200 bp representative (132 words, past G x K = 128: a warp a
    # pair) beside its copies and prefixes, gated and not
    base = random_seq(rng, LCS_LONG)
    long_reads = [base, mutate(rng, base, 0.02, 0.0), base[:140],
                  base[:1100], noisy(rng, base[:2000])]
    p = TC._prepare(long_reads, 0.9, 5)
    aux = TC._aux_dev(p, dev)
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    rp = torch.tensor([0, 2], dtype=torch.int32, device=dev)
    jb = torch.arange(len(long_reads), dtype=torch.int32, device=dev)
    for gate in (None, torch.from_numpy(rng.integers(
            0, 2, (2, len(long_reads))).astype(np.uint8)).to(dev)):
        check(rp, jb, gate, words=(None, LCS_SMEM_WORDS, wide))
    p, rp, jb = thread_edge_launch(rng, dev)
    aux = TC._aux_dev(p, dev)
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    check(rp, jb, None)
    return err, n


def thread_edge_launch(rng, dev, ngia: bool = False):
    """(prepared reads, reps, jobs) of a launch of 256 representatives,
    the first a random read of LCS_THREAD_BP bases, the rest drawn from it,
    its mutated copy, its prefixes of 140, 250 and 300 bases, a mutated
    and a noisy prefix and an unrelated 300 bp read, against 300 columns
    drawn from those of up to 300 bases: blocks of 32 pairs or more in a
    launch of more than a wave, a thread a pair; `ngia`: nGIA's _prepare
    tuple in place of clustering's."""
    from genomics_tpu_torch.models import cluster as TC
    from genomics_tpu_torch.models import ngia as TN

    base = random_seq(rng, LCS_THREAD_BP)
    reads = [base, mutate(rng, base, 0.01, 0.0), base[:140], base[:250],
             base[:300], mutate(rng, base[:300], 0.01, 0.0),
             noisy(rng, base[:200]), random_seq(rng, 300)]
    p = TN._prepare(reads) if ngia else TC._prepare(reads, 0.9, 5)
    net = p[2] if ngia else p.net_lengths
    reps = np.concatenate([[int(np.argmax(net))],
                           rng.integers(0, len(reads), 255)])
    jobs = rng.choice(np.nonzero(net <= 300)[0], 300)
    return (p, torch.from_numpy(reps.astype(np.int32)).to(dev),
            torch.from_numpy(jobs.astype(np.int32)).to(dev))


def ngia_lcs_parity(rng, dev) -> tuple[int, int]:
    """ngia_lcs against banded_lcs_accept_plain on the card over
    ngia_edge_reads at similarities 0.95 and 0.9: each edge launch as a
    window, in the rule's layout and with G x K = 64 and the rows of the
    wide bands in a global scratch (max_shift 16, max_words past
    SHARED_WORDS;
    the plain version once over every representative, each read alone
    held to its row); a window no pair passes (representatives under 3
    bases), one every pair passes (the 300 bp family against itself), the
    family drawn to 300 columns against base[:300] (a block's survivors
    across its warps, groups part empty) and against 256 of the family (a
    thread a pair), the 1,100 and 300 bp reads
    against all, a 4,200 bp representative against its copy and
    prefixes (bands in lane groups and past 128 words, a warp a pair, in
    one launch, also in warp slots of LCS_SMEM_WORDS words); a 2,500 bp
    representative among 256 against 300 short columns (a thread a pair)
    and as a round (shared memory past 48 KB with the kernel's static
    part); and rounds of eight representatives from a cluster array with
    some reads clustered; returns (the largest difference, launches)."""
    from genomics_tpu_torch.models import ngia as TN
    from genomics_tpu_torch.ops import lcs

    err = n = 0
    for sim in (0.95, 0.9):
        reads = ngia_edge_reads(rng, sim)
        order, _l, net, words, low, high, codes = TN._prepare(reads)
        a = TN._device_arrays(net, words, low, high, codes, dev)
        args = [a[k] for k in ("words", "net", "low", "high", "codes")]
        N = len(reads)
        every = torch.arange(N, dtype=torch.int32, device=dev)

        def check(reps, jobs, want=None):
            nonlocal err, n
            rp = torch.from_numpy(np.asarray(reps, np.int32)).to(dev)
            jb = torch.from_numpy(np.asarray(jobs, np.int32)).to(dev)
            if want is None:
                want = lcs.banded_lcs_accept_plain(*args, rp, jb, sim)
            for bounds in ({}, dict(max_shift=16,
                                    max_words=lcs.SHARED_WORDS + 1)):
                got = lcs.banded_lcs_accept(*args, rp, jb, sim, **bounds)
                err = max(err, max_abs_err([got], [want]))
                n += 1
        launches = lcs_edge_launches(rng, N)
        jobs = launches[0][1]
        w_all = lcs.banded_lcs_accept_plain(
            *args, every, torch.from_numpy(jobs).to(dev), sim)
        for reps, _ in launches:
            check(reps, jobs, w_all[torch.from_numpy(reps).long().to(dev)]
                  if len(reps) == 1 else None)
        # base[:300] and its mutated and noisy copies (ngia_edge_reads)
        fam = [i for i, o in enumerate(order) if o == 8 or 10 <= o < 20]
        check([i for i in range(N) if net[i] < 3], every.cpu().numpy())
        check(fam, fam)
        check([fam[0]], rng.choice(fam, 300))
        check(rng.choice(fam, 256), rng.choice(fam, 300))
        check([int(np.argmax(net)), fam[0]], every.cpu().numpy())
        # a 4,200 bp representative against its copy (a band of 15 in a
        # group) and its prefixes (bands past G x K = 128: a warp a pair)
        base = random_seq(rng, LCS_LONG)
        lr = [base, mutate(rng, base, 0.01, 0.0), base[:1100], base[:300],
              base[:100]]
        o2, _l, n2, w2, l2, h2, c2 = TN._prepare(lr)
        a2 = TN._device_arrays(n2, w2, l2, h2, c2, dev)
        for bounds in ({}, dict(max_words=LCS_SMEM_WORDS),
                       dict(max_shift=16, max_words=lcs.SHARED_WORDS + 1)):
            rp = torch.tensor([0], dtype=torch.int32, device=dev)
            jb = torch.arange(len(lr), dtype=torch.int32, device=dev)
            args2 = [a2[k] for k in ("words", "net", "low", "high", "codes")]
            want = lcs.banded_lcs_accept_plain(*args2, rp, jb, sim)
            got = lcs.banded_lcs_accept(*args2, rp, jb, sim, **bounds)
            err = max(err, max_abs_err([got], [want]))
            n += 1
        (_o, _l, n2, w2, l2, h2, c2), rp, jb = thread_edge_launch(
            rng, dev, ngia=True)
        a2 = TN._device_arrays(n2, w2, l2, h2, c2, dev)
        args2 = [a2[k] for k in ("words", "net", "low", "high", "codes")]
        want = lcs.banded_lcs_accept_plain(*args2, rp, jb, sim)
        for bounds in ({}, dict(max_shift=16,
                                max_words=lcs.SHARED_WORDS + 1)):
            got = lcs.banded_lcs_accept(*args2, rp, jb, sim, **bounds)
            err = max(err, max_abs_err([got], [want]))
            n += 1
        every2 = torch.arange(len(n2), dtype=torch.int32, device=dev)
        cl = [torch.full((len(n2),), -1, dtype=torch.int32, device=dev)
              for _ in range(2)]
        lcs.banded_lcs_accept_plain(*args2, rp[:1], every2, sim,
                                    cluster=cl[0])
        lcs.banded_lcs_accept(*args2, rp[:1], every2, sim, cluster=cl[1])
        err = max(err, max_abs_err([cl[1]], [cl[0]]))
        n += 1
        for r in rng.choice(N, 8, replace=False):
            rp = torch.tensor([r], dtype=torch.int32, device=dev)
            start = np.where(rng.random(N) < 0.3, rng.integers(0, N, N),
                             -1).astype(np.int32)
            start[r] = -1
            cl = [torch.from_numpy(start).to(dev) for _ in range(2)]
            lcs.banded_lcs_accept_plain(*args, rp, every, sim, cluster=cl[0])
            lcs.banded_lcs_accept(*args, rp, every, sim, cluster=cl[1])
            err = max(err, max_abs_err([cl[1]], [cl[0]]))
            n += 1
    return err, n


def cluster_filter_parity(dev) -> tuple[int, int]:
    """cluster_filter against window_filters_plain on the card at
    FILTER_CARD_EDGES: (the largest difference, the launches)."""
    from genomics_tpu_torch.ops import cluster_filter as CF

    err = 0
    for edge in FILTER_CARD_EDGES:
        _, wl, K, S, J = edge
        words, counts, *rest, _ = filter_edge_inputs(*edge)
        packed = torch.from_numpy(CF.pack_words(words, counts)).to(dev)
        args = [torch.from_numpy(x).to(dev) for x in rest]
        got = CF.window_filters(packed, *args, 1 << 2 * wl, K)
        want = CF.window_filters_plain(packed, *args, 1 << 2 * wl, K)
        err = max(err, max_abs_err(got, want))
    return err, len(FILTER_CARD_EDGES)


def host_min_sum(p, reps, jobs, wl: int) -> np.ndarray:
    """[S, J] word min-sums from the host arrays, as _accept_matrix_host
    computes them."""
    tables = np.zeros((len(reps), 1 << (2 * wl)), np.uint16)
    for si, r in enumerate(reps):
        m = p.word_counts[r] > 0
        tables[si, p.words[r][m]] = p.word_counts[r][m]
    return np.minimum(tables[:, p.words[jobs]],
                      p.word_counts[jobs][None, :, :]).sum(
                          axis=2, dtype=np.int64)


def plain_accept(p, reps, jobs, wl: int, dev) -> np.ndarray:
    """_accept_matrix with the plain versions on the card: the filters
    (window_filters_plain: the f64 indicator product), then
    lcs_accept_plain."""
    from genomics_tpu_torch.models import cluster as TC
    from genomics_tpu_torch.ops import cluster_filter as CF
    from genomics_tpu_torch.ops import lcs

    aux = TC._aux_dev(p, dev)
    rp, jp = (torch.from_numpy(x.astype(np.int32)).to(dev)
              for x in (reps, jobs))
    p2, _ = CF.window_filters_plain(TC._packed_dev(p, dev), aux["prefix"],
                                    aux["wcut"], aux["bcut"], rp, jp,
                                    1 << 2 * wl, TC._dense_k(p, wl))
    acc = lcs.lcs_accept_plain(aux["low"], aux["high"], aux["net"],
                               aux["codes"], aux["bcut"], rp, jp, p2)
    return acc.cpu().numpy() != 0


@contextlib.contextmanager
def recording_windows(store: list, n: int):
    """Within the block, the first n calls of cluster._accept_matrix keep
    (p, reps, jobs, wl, result) in store."""
    from genomics_tpu_torch.models import cluster as TC

    inner = TC._accept_matrix

    def rec(p, reps, jobs, wl, batch_cap, dev):
        out = inner(p, reps, jobs, wl, batch_cap, dev)
        if len(store) < n:
            store.append((p, reps.copy(), jobs.copy(), wl, out.copy()))
        return out
    TC._accept_matrix = rec
    try:
        yield
    finally:
        TC._accept_matrix = inner


@contextlib.contextmanager
def counting_calls(module, name: str, store: list):
    """Within the block, each call of module.name appends None to store."""
    inner = getattr(module, name)

    def counted(*a, **k):
        store.append(None)
        return inner(*a, **k)
    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, inner)


def assert_clustering(res, label: str):
    """The greedy invariants: every read's representative is at or before
    it and is a representative itself."""
    c = np.asarray(res.cluster)
    if not ((c >= 0).all() and (c <= np.arange(len(c))).all()
            and (c[c] == c).all()):
        raise AssertionError(f"{label}: the clustering breaks cluster <= "
                             f"arange or reps that are their own")


def cluster_slice(seed: int, dev, smi: str, peak: float) -> dict:
    """Phases 3-5 of the clustering slice on the card; returns the
    cluster_lcs and ngia_lcs rows of the kernels line but their names,
    routes and sources."""
    from genomics_tpu_torch.models import cluster as TC
    from genomics_tpu_torch.models import ngia as TN
    from genomics_tpu_torch.ops import cluster_filter as CF
    from genomics_tpu_torch.ops import lcs
    from genomics_tpu_torch.utils.fasta import write_fasta

    rng = np.random.default_rng(seed + 31)
    # -- 3. the three kernels at their edges ------------------------------
    t0 = time.time()
    f_err, f_n = cluster_filter_parity(dev)
    c_err, c_n = cluster_lcs_parity(rng, dev)
    n_err, n_n = ngia_lcs_parity(rng, dev)
    if f_err or c_err or n_err:
        raise AssertionError(f"the clustering kernels disagree with their "
                             f"plain versions at their edges: cluster_filter"
                             f" {f_err}, cluster_lcs {c_err}, ngia_lcs "
                             f"{n_err}")
    log("3 parity", f"cluster_filter == plain at {f_n} launches ("
        + ", ".join(e[0] for e in FILTER_CARD_EDGES) + "; each with a job "
        "that is a representative, a job whose words all miss and a read "
        "with no words)")
    log("3 parity", f"cluster_lcs == plain at {c_n} launches over "
        f"lcs_edge_reads (nets {LCS_EDGE_NETS}, 140 and 1,100 bases, noisy "
        f"copies, one base, net 0; every read alone and S of "
        f"{LCS_EDGE_S}, J not a multiple of 32, gated and not; no pair "
        f"gated, every pair, 300 columns against 1 and 256 (a thread a "
        f"pair), nets 1-1,100 in one launch, a "
        f"{LCS_LONG} bp row a warp a pair, also in slots of "
        f"{LCS_SMEM_WORDS} words, a {LCS_THREAD_BP} bp row a thread a pair "
        f"(shared memory past 48 KB); each in the rule's layout and at G x "
        f"K = 128 with a global scratch); ngia_lcs == plain at {n_n} "
        f"launches over ngia_edge_reads at 0.95 and 0.9 (bands clipped at "
        f"both ends, empty bands, reads under 3 bases, a band of 65 words, "
        f"the fma pairs {NGIA_FMA_PAIRS}; no pair passing, every pair, 300 "
        f"columns of one family against 1 and 256 (a thread a pair), lane "
        f"groups and bands past 128 words in one launch, also in slots of "
        f"{LCS_SMEM_WORDS} words, a {LCS_THREAD_BP} bp row a thread a pair; "
        f"windows and rounds); "
        f"{time.time() - t0:.1f} s")

    # -- 4. cluster_reads and cluster_distributed --------------------------
    walls, rates, launches = {}, {}, {}
    reads = family_reads(np.random.default_rng(0), CLUSTER_READS,
                         CLUSTER_LEN, 8, 6)
    windows, calls, plain = [], [], []
    zero_counts(lcs.LAUNCHES, CF.LAUNCHES)
    with recording_windows(windows, CLUSTER_WINDOWS), \
            counting_calls(TC, "_accept_matrix", calls), \
            counting_calls(CF, "_indicators", plain), \
            counting_calls(CF, "window_filters_plain", plain):
        t0 = time.time()
        res = TC.cluster_reads(reads, speculate=CLUSTER_SPEC, device=dev)
        walls["cluster"] = time.time() - t0
    launches["cluster"] = dict(lcs.LAUNCHES, **CF.LAUNCHES)
    if (not launches["cluster"]["cluster_lcs"]
            or launches["cluster"]["ngia_lcs"]
            or launches["cluster"]["cluster_filter"] != len(calls)
            or plain):
        raise AssertionError(f"cluster_reads: launches {launches['cluster']}"
                             f" over {len(calls)} windows, {len(plain)} calls"
                             f" of the plain filters or their indicators")
    assert_clustering(res, "cluster_reads")
    rates["cluster"] = CLUSTER_READS / walls["cluster"]
    t0 = time.time()
    for p, reps, jobs, wl, A in windows:
        if not np.array_equal(A, plain_accept(p, reps, jobs, wl, dev)):
            raise AssertionError("cluster_reads: a window's accept matrix "
                                 "differs from the plain filters + LCS")
    p, reps, jobs, wl, _ = windows[0]
    cols = jobs[:MIN_SUM_COLS]
    K = TC._dense_k(p, wl)
    got = CF.word_min_sum(*(CF.dense_rows(TC._packed_dev(p, dev),
                                          torch.from_numpy(x).to(dev),
                                          1 << 2 * wl) for x in (reps, cols)),
                          K)
    if not np.array_equal(got.cpu().numpy(), host_min_sum(p, reps, cols, wl)):
        raise AssertionError("word_min_sum (torch._int_mm) differs from the "
                             "host min-sum")
    check_s = time.time() - t0
    log("4 cluster", f"cluster_reads({CLUSTER_READS} x {CLUSTER_LEN} bp, "
        f"speculate={CLUSTER_SPEC}): {walls['cluster']:.2f} s, "
        f"{rates['cluster']:.0f} reads/s, {res.n_clusters} clusters; the "
        f"first {len(windows)} windows' accept matrices ({reps.size} x "
        f"{jobs.size} first) == the plain filters + LCS on the card, the "
        f"int8 min-sum == the host's over {cols.size} columns "
        f"(K = {K}, {check_s:.1f} s); launches {launches['cluster']} (one "
        f"cluster_filter a window, no plain filter or indicator on the "
        f"path)")
    small = family_reads(np.random.default_rng(1), CLUSTER_CHECK,
                         CLUSTER_LEN, 8, 6)
    t0 = time.time()
    a = TC.cluster_reads(small, speculate=CLUSTER_SPEC, device=dev)
    walls["cluster 5k spec"] = time.time() - t0
    zero_counts(lcs.LAUNCHES)
    t0 = time.time()
    b = TC.cluster_reads(small, device=dev)
    walls["cluster 5k serial"] = time.time() - t0
    launches["cluster serial"] = dict(lcs.LAUNCHES)
    if not launches["cluster serial"]["cluster_lcs"]:
        raise AssertionError("cluster_reads (serial): cluster_lcs never "
                             "launched")
    t0 = time.time()
    c = TC.cluster_reads(small, speculate=CLUSTER_SPEC, device="cpu")
    cpu_s = time.time() - t0
    if not (np.array_equal(a.cluster, b.cluster)
            and np.array_equal(a.cluster, c.cluster)):
        raise AssertionError(f"cluster_reads at {CLUSTER_CHECK} reads: "
                             f"speculative, serial and device='cpu' differ")
    log("4 cluster", f"{CLUSTER_CHECK} reads: speculate={CLUSTER_SPEC} "
        f"{walls['cluster 5k spec']:.2f} s == serial "
        f"{walls['cluster 5k serial']:.2f} s (launches "
        f"{launches['cluster serial']}) == device='cpu' ({cpu_s:.1f} s); "
        f"{a.n_clusters} clusters")

    nreads = family_reads(np.random.default_rng(0), NGIA_READS, NGIA_LEN,
                          16, 12)
    zero_counts(lcs.LAUNCHES)
    t0 = time.time()
    ns = TN.cluster_distributed(nreads, 0.95, speculate=NGIA_SPEC,
                                device=dev)
    walls["ngia"] = time.time() - t0
    launches["ngia"] = dict(lcs.LAUNCHES)
    zero_counts(lcs.LAUNCHES)
    t0 = time.time()
    nr = TN.cluster_distributed(nreads, 0.95, device=dev)
    walls["ngia serial"] = time.time() - t0
    launches["ngia serial"] = dict(lcs.LAUNCHES)
    for k in ("ngia", "ngia serial"):
        if not launches[k]["ngia_lcs"] or launches[k]["cluster_lcs"]:
            raise AssertionError(f"{k}: launches {launches[k]}")
    if not np.array_equal(ns.cluster, nr.cluster):
        raise AssertionError("cluster_distributed: speculate=32 and the "
                             "serial rounds differ")
    assert_clustering(ns, "cluster_distributed")
    rates["ngia"] = NGIA_READS / walls["ngia"]
    rates["ngia serial"] = NGIA_READS / walls["ngia serial"]
    few = family_reads(np.random.default_rng(1), NGIA_CHECK, NGIA_LEN, 16,
                       12)
    t0 = time.time()
    a = TN.cluster_distributed(few, 0.95, speculate=NGIA_SPEC, device=dev)
    card_s = time.time() - t0
    t0 = time.time()
    b = TN.cluster_distributed(few, 0.95, speculate=NGIA_SPEC, device="cpu")
    cpu_s = time.time() - t0
    if not np.array_equal(a.cluster, b.cluster):
        raise AssertionError(f"cluster_distributed at {NGIA_CHECK} reads "
                             f"differs from device='cpu'")
    log("4 ngia", f"cluster_distributed({NGIA_READS} x {NGIA_LEN} bp, 0.95)"
        f": speculate={NGIA_SPEC} {walls['ngia']:.2f} s ({rates['ngia']:.0f}"
        f" reads/s, launches {launches['ngia']}) == serial rounds "
        f"{walls['ngia serial']:.2f} s ({rates['ngia serial']:.0f} reads/s, "
        f"launches {launches['ngia serial']}); {ns.n_clusters} clusters; "
        f"{NGIA_CHECK} reads speculate={NGIA_SPEC} {card_s:.2f} s == "
        f"device='cpu' ({cpu_s:.1f} s)")

    tmp = tempfile.TemporaryDirectory()
    for cmd, rd, flag in (("cluster", small[:CLI_CLUSTER], "-t"),
                          ("ngia", few[:CLI_NGIA], "-s")):
        src = os.path.join(tmp.name, f"{cmd}.fa")
        write_fasta(src, [(f"read{i} of {len(x)}", x)
                          for i, x in enumerate(rd)], width=80)
        outs = {}
        for where in ("card", "cpu"):
            path = os.path.join(tmp.name, f"{cmd}.{where}.fa")
            zero_counts(lcs.LAUNCHES)
            t0 = time.time()
            said = run_cli([cmd, "-i", src, "-o", path, flag, "0.95",
                            "--device", str(dev) if where == "card"
                            else "cpu"])
            wall = time.time() - t0
            with open(path, "rb") as fh:
                outs[where] = (said, fh.read())
            if where == "card":
                walls[f"{cmd} CLI"] = wall
                launches[f"{cmd} CLI"] = dict(lcs.LAUNCHES)
        key = "ngia_lcs" if cmd == "ngia" else "cluster_lcs"
        if not launches[f"{cmd} CLI"][key]:
            raise AssertionError(f"{cmd} CLI: {key} never launched")
        if outs["card"] != outs["cpu"]:
            raise AssertionError(f"{cmd} CLI: stdout or file differs from "
                                 f"--device cpu")
        rates[f"{cmd} CLI"] = len(rd) / walls[f"{cmd} CLI"]
        log("4 CLI", f"python -m genomics_tpu_torch {cmd} over {len(rd)} "
            f"reads: {outs['card'][0].strip()!r}; {walls[cmd + ' CLI']:.2f} s"
            f" ({rates[cmd + ' CLI']:.0f} reads/s), stdout and file == "
            f"--device cpu; launches {launches[cmd + ' CLI']}")
    tmp.cleanup()

    # -- 5. the kernels' timings -------------------------------------------
    rows = {}
    mhz = int(nvidia_smi("clocks.max.sm").split()[0])
    # cluster_lcs at the first bench_cluster window's pass-2 columns
    p, reps, jobs, wl, _ = windows[0]
    aux = TC._aux_dev(p, dev)
    K, bins, packed = TC._dense_k(p, wl), 1 << 2 * wl, TC._packed_dev(p, dev)
    rp = torch.from_numpy(reps.astype(np.int32)).to(dev)
    jp = torch.from_numpy(jobs.astype(np.int32)).to(dev)
    f_args = (packed, aux["prefix"], aux["wcut"], aux["bcut"], rp, jp, bins)
    f_lay = CF.filter_layout(*f_args)
    p2, anyv = CF.launch_cluster_filter(f_lay)
    f_want = CF.window_filters_plain(*f_args, K)
    f_err = max(f_err, max_abs_err((p2, anyv), f_want))
    cols = torch.nonzero(anyv)[:, 0]
    jb, gate = jp[cols], p2[:, cols].contiguous()
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    S, J = len(reps), int(cols.shape[0])
    out = torch.empty((S, J), dtype=torch.uint8, device=dev)
    mw = TC.words_needed(p, reps)
    lays = lcs.lcs_layouts(*args, rp, jb, gate, out, mw)
    stats = {}
    want = lcs.lcs_accept_plain(*args, rp, jb, gate, stats=stats)
    for lay in lays:
        lcs.launch_cluster_lcs(lay)
    err_c = max_abs_err([out], [want])
    k_ms = graph_ms(lambda: [lcs.launch_cluster_lcs(x) for x in lays], 20)
    host_ms = cuda_ms(lambda: [lcs.launch_cluster_lcs(x) for x in lays], 20)
    p_ms = cuda_ms(lambda: lcs.lcs_accept_plain(*args, rp, jb, gate), 1)
    ops = (LCS_OPS_PER_WORD * stats["word_steps"]
           + LCS_OPS_PER_STEP * stats["steps"])
    nbytes = 2 * S * J + J * (p.codes.shape[1] + 12) + 8 * S * mw
    bd = bound(ops, nbytes, peak)
    cyc = k_ms * 1e3 * mhz / stats["longest"]
    log("5 timings", f"cluster_lcs at bench_cluster's first window's pass-2 "
        f"columns ({S} x {J}, {stats['pairs']} gated pairs, {mw} words, "
        f"{lcs.cluster_bucket(mw)} lanes a pair): kernel {k_ms:.4f} ms (a "
        f"CUDA graph's replay; launched from the host {host_ms:.4f} ms), "
        f"{cyc:.0f} cycles a step of the longest live pair's "
        f"{stats['longest']} at {mhz} MHz, plain {p_ms:.2f} ms, bound "
        f"{bd[0]:.5f} ms by {bd[1]} ({stats['word_steps']} word-steps x "
        f"{LCS_OPS_PER_WORD} + {stats['steps']} steps x {LCS_OPS_PER_STEP} = "
        f"{ops} int op; {nbytes} bytes), {k_ms / bd[0]:.1f} x the bound, == "
        f"plain; on {smi}")
    rows["cluster_lcs"] = dict(launches=launches["cluster"]["cluster_lcs"],
                               max_abs_err=max(c_err, err_c), ms=k_ms,
                               plain_ms=p_ms, bound_ms=bd[0], bound_by=bd[1])
    # cluster_filter at the same window, all its jobs: a CUDA graph's
    # replay and launched from the host; its plain version; the library
    # yardstick, torch._int_mm of the window's K indicator matrices (made
    # before, timed alone); the bound: CF_OPS_PER_LOOKUP / _PAIR over the
    # jobs' words, or the bytes (the packed words of both sides, prefix,
    # cutoffs, indices, pass2 and any)
    Jw = len(jobs)
    f_ms = graph_ms(lambda: CF.launch_cluster_filter(f_lay), 20)
    f_host = cuda_ms(lambda: CF.launch_cluster_filter(f_lay), 20)
    f_plain = cuda_ms(lambda: CF.window_filters_plain(*f_args, K), 1)
    A, B = CF.int_mm_operands(CF.dense_rows(packed, rp, bins),
                              CF.dense_rows(packed, jp, bins), K)
    lib_ms = cuda_ms(lambda: torch._int_mm(A, B.T), 5)
    del A, B
    work = CF.filter_work(packed, rp, jp)
    f_ops = (CF_OPS_PER_LOOKUP * work["lookups"]
             + CF_OPS_PER_PAIR * work["pairs"])
    f_bytes = (packed.shape[1] * 4 * (S + Jw) + (16 + 4) * (S + Jw)
               + 8 * Jw + S * Jw + Jw)
    f_bd = bound(f_ops, f_bytes, peak)
    log("5 timings", f"cluster_filter at bench_cluster's first window "
        f"({S} x {Jw} jobs, wl = {wl}, K = {K}, "
        f"{CF.rep_rows(S, bins)} tables a block; "
        f"{launches['cluster']['cluster_filter']} launches in the "
        f"{CLUSTER_READS}-read run): kernel {f_ms:.4f} ms (a CUDA graph's "
        f"replay; launched from the host {f_host:.4f} ms), plain "
        f"{f_plain:.2f} ms, torch._int_mm of the indicators alone "
        f"{lib_ms:.4f} ms ({2 * S * Jw * K * bins} int8 op, "
        f"{2 * S * Jw * K * bins / INT8_TOPS * 1e3:.4f} ms at "
        f"{INT8_TOPS / 1e12:.0f} TOP/s), bound {f_bd[0]:.4f} ms by "
        f"{f_bd[1]} ({work['lookups']} lookups x {CF_OPS_PER_LOOKUP} + "
        f"{work['pairs']} pairs x {CF_OPS_PER_PAIR} = {f_ops} int op; "
        f"{f_bytes} bytes), {f_ms / f_bd[0]:.1f} x the bound, == plain; on "
        f"{smi}")
    if f_err:
        raise AssertionError(f"cluster_filter disagrees with its plain "
                             f"version at the timed window: {f_err}")
    rows["cluster_filter"] = dict(
        launches=launches["cluster"]["cluster_filter"], max_abs_err=f_err,
        ms=f_ms, plain_ms=f_plain, bound_ms=f_bd[0], bound_by=f_bd[1],
        library_ms=lib_ms)
    # ngia_lcs at the first speculate=32 window (out mode) and at one
    # serial round as the serial path launches it: round mode, the first
    # (representative 0 against all 8,000 reads, none clustered), the
    # cluster array restored before each replay and the restores' own time
    # taken off; at bench_ngia's reads and at the mixed-length set
    mixed = family_reads(np.random.default_rng(0), NGIA_READS, NGIA_MIXED,
                         16, 12)
    for which, rd in (("bench_ngia's", nreads), (
            f"the mixed-length ({NGIA_MIXED[0]}-{NGIA_MIXED[1]} bp)", mixed)):
        for label, S, row in ngia_timings(rd, dev, peak, mhz, launches):
            if row["err"]:
                raise AssertionError(f"ngia_lcs disagrees with its plain "
                                     f"version at {which} {label}: "
                                     f"{row['err']}")
            log("5 timings", f"ngia_lcs at {which} {label} ({S} x "
                f"{NGIA_READS}, {row['how']}): kernel {row['ms']:.4f} ms (a "
                f"CUDA graph's replay; launched from the host "
                f"{row['host_ms']:.4f} ms), {row['cycles']:.0f} cycles a "
                f"step of the longest live pair's {row['longest']} at {mhz} "
                f"MHz, plain {row['plain_ms']:.2f} ms, bound "
                f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                f"({row['count']}), {row['ms'] / row['bound_ms']:.1f} x the "
                f"bound, == plain; on {smi}")
            if "ngia_lcs" not in rows:
                rows["ngia_lcs"] = dict(
                    launches=launches["ngia"]["ngia_lcs"], max_abs_err=n_err,
                    **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")})
    if err_c:
        raise AssertionError(f"cluster_lcs disagrees with its plain version "
                             f"at the timed launch: {err_c}")
    log("5 timings", "clustering: " + ", ".join(
        f"{k} {v:.0f} reads/s" for k, v in rates.items())
        + f" (host clock); on {smi}")
    return rows


def clustering_runs(dev) -> list:
    """--profile's clustering paths (label, run, n): cluster_reads over
    bench_cluster's 50,000 x 140 bp at speculate=256, cluster_distributed
    over bench_ngia's 8,000 x 1,200 bp at speculate=32 and serial."""
    from genomics_tpu_torch.models import cluster as TC
    from genomics_tpu_torch.models import ngia as TN

    reads = family_reads(np.random.default_rng(0), CLUSTER_READS,
                         CLUSTER_LEN, 8, 6)
    nreads = family_reads(np.random.default_rng(0), NGIA_READS, NGIA_LEN,
                          16, 12)
    return [
        (f"clustering: cluster_reads speculate={CLUSTER_SPEC}",
         functools.partial(TC.cluster_reads, reads, speculate=CLUSTER_SPEC,
                           device=dev), f"{CLUSTER_READS} reads"),
        (f"clustering: nGIA cluster_distributed speculate={NGIA_SPEC}",
         functools.partial(TN.cluster_distributed, nreads, 0.95,
                           speculate=NGIA_SPEC, device=dev),
         f"{NGIA_READS} reads"),
        ("clustering: nGIA cluster_distributed serial",
         functools.partial(TN.cluster_distributed, nreads, 0.95, device=dev),
         f"{NGIA_READS} reads")]


def ngia_timings(reads, dev, peak: float, mhz: int, launches: dict):
    """ngia_lcs over `reads` at the first speculate=32 window (32 x all,
    out mode) and at the first serial round (round mode, representative 0
    against every read, the cluster array restored before each replay and
    the restores' time taken off), each held to its plain version: yields
    (label, S, row) with the row's ms, host_ms, plain_ms, bound_ms,
    bound_by, the count behind the bound, cycles a step of the longest
    live pair and err."""
    from genomics_tpu_torch.models import ngia as TN
    from genomics_tpu_torch.ops import lcs

    N = len(reads)
    o_, l_, net, words, low, high, codes = TN._prepare(reads)
    a = TN._device_arrays(net, words, low, high, codes, dev)
    args = [a[k] for k in ("words", "net", "low", "high", "codes")]
    every = torch.arange(N, dtype=torch.int32, device=dev)
    mw = int((net.max() + 31) // 32)
    L = int(net.max())
    fresh = torch.full((N,), -1, dtype=torch.int32, device=dev)
    cl = fresh.clone()
    for label, S in (("the first speculate=32 window", NGIA_SPEC),
                     ("one serial round", 1)):
        rnd = S == 1
        rp = torch.arange(S, dtype=torch.int32, device=dev)
        ms_ = lcs.max_shift_of(net[:S] if not rnd else net, net, 0.95)
        out = None if rnd else torch.empty((S, N), dtype=torch.uint8,
                                           device=dev)
        lays = lcs.banded_layouts(*args, rp, every, 0.95, cl if rnd else None,
                                  out, mw, ms_)
        stats = {}
        want = lcs.banded_lcs_accept_plain(
            *args, rp, every, 0.95, fresh.clone() if rnd else None,
            stats=stats)

        def run(lays=lays, rnd=rnd):
            if rnd:
                cl.copy_(fresh)
            for x in lays:
                lcs.launch_ngia_lcs(x)
        run()
        err = max_abs_err([cl if rnd else out], [want])
        restore_ms = graph_ms(lambda: cl.copy_(fresh), 20) if rnd else 0.0
        k_ms = graph_ms(run, 20) - restore_ms
        host_ms = cuda_ms(run, 20) - restore_ms
        p_ms = cuda_ms(lambda rnd=rnd, rp=rp: lcs.banded_lcs_accept_plain(
            *args, rp, every, 0.95, fresh.clone() if rnd else None), 1)
        ops = (NGIA_OPS_PER_BIN * 256 * stats["filtered"]
               + LCS_OPS_PER_WORD * stats["word_steps"]
               + LCS_OPS_PER_STEP * stats["steps"])
        # the jobs' histograms and nets, the representatives' histograms
        # and planes, the accepts (the cluster words read and written in
        # a round) and the LCS pairs' codes
        nbytes = (N * (512 + 4) + S * (512 + 8 * mw)
                  + N * (8 if rnd else S) + stats["pairs"] * L)
        bd = bound(ops, nbytes, peak)
        how = (f"round mode, {launches['ngia serial']['ngia_lcs']} such "
               f"launches in the serial 8,000-read run; the cluster array's "
               f"restore, {restore_ms:.4f} ms, taken off" if rnd
               else f"{launches['ngia']['ngia_lcs']} launches in the "
               f"speculate={NGIA_SPEC} 8,000-read run")
        count = (f"{stats['filtered']} pairs x 256 bins x {NGIA_OPS_PER_BIN}"
                 f" + {stats['word_steps']} band word-steps x "
                 f"{LCS_OPS_PER_WORD} + {stats['steps']} steps x "
                 f"{LCS_OPS_PER_STEP} = {ops} int op; {nbytes} bytes")
        yield label, S, dict(
            ms=k_ms, host_ms=host_ms, plain_ms=p_ms, bound_ms=bd[0],
            bound_by=bd[1], count=count, longest=stats.get("longest", 0),
            cycles=k_ms * 1e3 * mhz / max(stats.get("longest", 0), 1),
            err=err, how=f"{lcs.ngia_bucket(ms_)} lanes a pair, "
            f"{stats['pairs']} LCS pairs; {how}")


# -- the distributed slice (dist_slice) -------------------------------------
# run_all.py's bench_sharded_sw (:428-467): 16,384 pairs of 152 x 152 a
# device (codes integers(0, 4) * 2 + 1, has_n=False); the pipeline step at
# that per-rank shape with PairHMM reads and haplotypes of 128 x 128
# (bench_pairhmm's); bench_ngia's 8,000 x 1,200 bp; bench_msa's 2,048 x 120
DIST_B, DIST_L, DIST_R, DIST_C = 16384, 152, 128, 128
DIST_PLAIN = 4096       # pairs of each call held to the plain versions
DIST_RANKS = 2          # gloo ranks sharing the one card
DIST_NGIA = 1000        # reads of nGIA's two-rank run
DIST_TIMEOUT_S = 300    # each child rank's
DIST_REPS = 5           # timed pipeline steps
PIPELINE_KERNELS = ("local_sw.end", "local_sw.tb", "global_sw.score",
                    "ksw.end", "banded_sw.end", "myers", "pairhmm.wavefront",
                    "pairhmm.intertask")
PIPELINE_SCORE_MODES = ("local_sw.score", "local_sw.score16")
TWO_BIT_LUT = np.full(256, 255, np.uint8)
TWO_BIT_LUT[[1, 3, 7, 4]] = [0, 1, 2, 3]


def require(launches: dict, every: tuple, one_of: tuple = (),
            what: str = "", exactly: dict | None = None):
    """Raises unless a path launched each kernel of `every`, one of
    `one_of` (where given) and `exactly` {kernel: count}."""
    missing = [k for k in every if not launches.get(k)]
    if one_of and not any(launches.get(k) for k in one_of):
        missing.append(" or ".join(one_of))
    missing += [f"{k} x {n}" for k, n in (exactly or {}).items()
                if launches.get(k) != n]
    if missing:
        raise AssertionError(f"{what} did not launch {missing}: {launches}")


def dist_inputs(seed: int, B: int) -> tuple:
    """The pipeline step's global inputs: B GASAL2-style pairs of up to
    DIST_L (ACGT only, the has_n=False contract; half related, lengths
    DIST_L / 2 to DIST_L) and B PairHMM pairs of up to DIST_R x DIST_C
    bytes with quals of 5-59, as run_all.py's bench_pairhmm draws them."""
    rng = np.random.default_rng(seed)
    q, t, ql, tl = random_codes(rng, B, DIST_L, DIST_L, 0.0)
    reads = BASES[rng.integers(0, 4, (B, DIST_R))]
    haps = BASES[rng.integers(0, 4, (B, DIST_C))]
    rlen = rng.integers(DIST_R // 2, DIST_R + 1, B).astype(np.int32)
    clen = rng.integers(DIST_C // 2, DIST_C + 1, B).astype(np.int32)
    quals = [rng.integers(5, 60, (B, DIST_R)).astype(np.int32)
             for _ in range(3)]
    return (q, t, ql, tl, reads, haps, rlen, clen, *quals)


def sharded_sw_inputs(B: int) -> tuple:
    """bench_sharded_sw's q, t: rng(0), integers(0, 4) * 2 + 1, 152 x 152."""
    rng = np.random.default_rng(0)
    return tuple(rng.integers(0, 4, (B, DIST_L)).astype(np.uint8) * 2 + 1
                 for _ in range(2))


def bench_msa_seqs(with_indels: bool = False) -> list:
    """bench_msa's 2,048 x 120 set (its own generator, rng(0)); with
    indels, 2,048 copies of a 120 bp center with 3% substitutions and 2%
    indels."""
    r0 = np.random.default_rng(0)
    n, L = MSA_RUN_ALL
    bases = np.array(list(DNA))
    center = "".join(bases[r0.integers(0, 4, L)])
    if with_indels:
        return [mutate(r0, center, 0.03, 0.02) for _ in range(n)]
    out = []
    for _ in range(n):
        c = np.array(list(center))
        idx = r0.choice(L, size=r0.integers(0, 8), replace=False)
        c[idx] = bases[r0.integers(0, 4, len(idx))]
        out.append("".join(c))
    return out


def pipeline_fields(out: dict) -> dict:
    """The step's 12 fields as host numpy, gathered over the ranks."""
    from genomics_tpu_torch.parallel import multihost

    return {k: multihost.fetch(v) for k, v in out.items()}


def single_device_fields(ins: tuple, dev, plain: bool = False) -> dict:
    """The pipeline step's per-pair fields and its checksum through the
    single-device entry points (`plain`: the plain versions) on `dev`,
    with Myers' masks built on the host (myers.build_eq_masks) and the
    2-bit codes by a host table: an independent assembly of what the
    step computes."""
    from genomics_tpu_torch import AlignmentParams
    from genomics_tpu_torch.ops import (cuda_align, cuda_pairhmm, myers,
                                        scan_align, scan_pairhmm)

    P = AlignmentParams()
    q, t, ql, tl, reads, haps, rlen, clen, bq, iq, dq = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in ins)
    W = (q.shape[1] + 31) // 32
    eq = torch.from_numpy(myers.build_eq_masks(
        TWO_BIT_LUT[ins[0]], ins[2], W).astype(np.int64)).to(dev)
    t2 = torch.from_numpy(TWO_BIT_LUT[ins[1]]).to(dev)
    h0 = torch.full((q.shape[0],), 30, dtype=torch.int32, device=dev)
    p = scan_pairhmm.prepare_params(bq, iq, dq)
    if plain:
        tb = scan_align.local_align_batch(q, t, P, with_tb=True).tb
        return {
            "sw_score": scan_align.local_align_batch(q, t, P).score,
            "sw_score_fast": scan_align.local_align_batch(q, t, P).score,
            "nw_score": scan_align.global_align_batch(q, t, ql, tl,
                                                      P).score,
            "ksw_score": scan_align.ksw_align_batch(q, t, ql, tl, h0,
                                                    P).score,
            "banded_score": scan_align.banded_align_batch(
                q, t, ql, tl, P, 4).score,
            "myers_best": myers.myers_batch_plain(eq, ql, t2, tl)[0],
            "likelihood": scan_pairhmm.forward_prepared(reads, haps, rlen,
                                                        clen, p),
            "likelihood_intertask": scan_pairhmm.forward_prepared(
                reads, haps, rlen, clen, p),
            "tb_checksum": (tb & 0xF).sum()}
    tb = cuda_align.local_align(q, t, P, with_tb=True).tb
    return {
        "sw_score": cuda_align.local_align(q, t, P).score,
        "sw_score_fast": cuda_align.local_align_scores(q, t, P, has_n=False),
        "nw_score": cuda_align.global_align(q, t, ql, tl, P).score,
        "ksw_score": cuda_align.ksw_align(q, t, ql, tl, h0, P).score,
        "banded_score": cuda_align.banded_align(q, t, ql, tl, P, 4).score,
        "myers_best": myers.myers_batch(eq, ql, t2, tl)[0],
        "likelihood": cuda_pairhmm.pairhmm_forward_prepared(
            reads, haps, rlen, clen, p),
        "likelihood_intertask":
            cuda_pairhmm.pairhmm_forward_intertask_prepared(
                reads, haps, rlen, clen, p),
        "tb_checksum": (tb & 0xF).sum()}


def fields_differ(got: dict, want: dict) -> list:
    """The names of the fields of `want` that `got` does not equal, bit
    for bit (numpy or tensors)."""
    bad = []
    for k, v in want.items():
        a = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        b = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if a.shape != b.shape or not np.array_equal(a, b):
            bad.append(k)
    return bad


def dist_calls(mesh, seed: int, B: int, ngia_reads, msa_seqs) -> dict:
    """What a rank of the dist slice runs on `mesh` over B pairs a rank
    (B x mesh.size in all): the pipeline step, the sharded scores, nGIA's
    serial mesh rounds over `ngia_reads` and msa(mesh=) over `msa_seqs`;
    the results gathered to host numpy on every rank."""
    from genomics_tpu_torch import AlignmentParams
    from genomics_tpu_torch.models import msa, ngia
    from genomics_tpu_torch.parallel import (multihost, shard_batch,
                                             sharded_align_scores,
                                             sharded_pipeline_step)

    P = AlignmentParams()
    n = B * mesh.size
    ins = shard_batch(mesh, *dist_inputs(seed, n))
    res = {f"pipe_{k}": v for k, v in pipeline_fields(
        sharded_pipeline_step(mesh, *ins, params=P)).items()}
    s, best = sharded_align_scores(mesh, *sharded_sw_inputs(n), P)
    res["scores"], res["best"] = multihost.fetch(s), int(best)
    res["ngia"] = ngia.cluster_distributed(ngia_reads, 0.95,
                                           mesh=mesh).cluster
    res["msa"] = np.array(msa.msa(msa_seqs, mesh=mesh)[0])
    return res


def dist_worker(args) -> int:
    """One gloo rank of the dist slice's two-rank run (a child process):
    the dist calls on its block, rank 0's results saved for the parent."""
    from genomics_tpu_torch.parallel import data_mesh, multihost

    multihost.initialize(args.init, args.world, args.rank, backend="gloo",
                         device="cuda")
    mesh = data_mesh(args.world)
    reads = family_reads(np.random.default_rng(0), DIST_NGIA, NGIA_LEN,
                         16, 12)
    res = dist_calls(mesh, args.seed, DIST_B, reads, bench_msa_seqs(True))
    if args.rank == 0:
        np.savez(os.path.join(args.dir, "ranks.npz"), **res)
    torch.distributed.destroy_process_group()
    return 0


def dist_slice(seed: int, dev, smi: str) -> dict:
    """The distributed slice on the card: NCCL at world size 1 in this
    process, then two gloo ranks sharing the card as child processes;
    returns the step's launches by kernel."""
    import torch.distributed as dist

    from genomics_tpu_torch import AlignmentParams
    from genomics_tpu_torch.models import msa, ngia
    from genomics_tpu_torch.ops import (cuda_align, cuda_pairhmm, lcs,
                                        myers, scan_align)
    from genomics_tpu_torch.parallel import (data_mesh, multihost,
                                             shard_batch,
                                             sharded_align_scores,
                                             sharded_pipeline_step)

    counts = (cuda_align.LAUNCHES, cuda_pairhmm.LAUNCHES, myers.LAUNCHES)
    P = AlignmentParams()
    tmp = tempfile.TemporaryDirectory()
    multihost.initialize(f"file://{tmp.name}/nccl", 1, 0, backend="nccl",
                         device="cuda")
    mesh = data_mesh(1)
    log("7 dist", f"NCCL at world size 1 (file:// rendezvous), mesh "
        f"{mesh}; backend {dist.get_backend()}")

    # the pipeline step at bench_sharded_sw's per-device shape
    ins = dist_inputs(seed, DIST_B)
    dins = shard_batch(mesh, *ins)
    zero_counts(*counts)
    t0 = time.time()
    out = sharded_pipeline_step(mesh, *dins, params=P)
    torch.cuda.synchronize()
    first = time.time() - t0
    launches = {k: v for c in counts for k, v in c.items() if v}
    require(launches, PIPELINE_KERNELS, PIPELINE_SCORE_MODES,
            "the pipeline step")
    got = pipeline_fields(out)
    bad = fields_differ(got, single_device_fields(ins, dev))
    if bad or got["global_best_sw"] != got["sw_score"].max() or \
            got["global_best_owner"] != 0:
        raise AssertionError(f"the pipeline step differs from the single-"
                             f"device entry points in {bad}")
    sub = tuple(x[:DIST_PLAIN] for x in ins)
    want = single_device_fields(sub, dev, plain=True)
    got_sub = {k: (v[:DIST_PLAIN] if k != "tb_checksum" else v)
               for k, v in got.items() if k in want}
    got_sub["tb_checksum"] = single_device_fields(sub, dev)["tb_checksum"]
    bad = fields_differ(got_sub, want)
    if bad:
        raise AssertionError(f"the pipeline step differs from the plain "
                             f"versions on its first {DIST_PLAIN} pairs in "
                             f"{bad}")
    walls = []
    for _ in range(DIST_REPS):
        torch.cuda.synchronize()
        t0 = time.time()
        sharded_pipeline_step(mesh, *dins, params=P)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    wall = min(walls)
    cells = DIST_B * (6 * DIST_L * DIST_L + DIST_L * DIST_L
                      + 2 * DIST_R * DIST_C)
    log("7 dist", f"sharded_pipeline_step over {DIST_B} pairs of {DIST_L} x "
        f"{DIST_L} and {DIST_B} PairHMM pairs of {DIST_R} x {DIST_C} (NCCL, "
        f"1 rank): every field == the single-device entry points, and the "
        f"first {DIST_PLAIN} pairs == the plain versions; launches "
        f"{launches}; first call {first:.3f} s, then the best of "
        f"{DIST_REPS} {wall * 1e3:.1f} ms (host clock), {DIST_B / wall:.0f} "
        f"pairs/s, {cells / wall / 1e9:.1f} GCUPS (cells: the six DP "
        f"kernels' and Myers' {DIST_L} x {DIST_L} and both PairHMM kernels' "
        f"{DIST_R} x {DIST_C} a pair); on {smi}")

    def step():
        sharded_pipeline_step(mesh, *dins, params=P)
        torch.cuda.synchronize()
    profile_paths([("sharded_pipeline_step (NCCL, 1 rank)", step,
                    DIST_B)], smi)

    # the sharded scores, bench_sharded_sw's inputs
    sq, st = sharded_sw_inputs(DIST_B)
    zero_counts(*counts)
    s, best = sharded_align_scores(mesh, sq, st, P)
    s_launch = {k: v for c in counts for k, v in c.items() if v}
    require(s_launch, (), PIPELINE_SCORE_MODES, "sharded_align_scores")
    qd, td = shard_batch(mesh, sq, st)
    direct = cuda_align.local_align_scores(qd, td, P, has_n=False)
    plain = scan_align.local_align_batch(qd[:DIST_PLAIN], td[:DIST_PLAIN],
                                         P).score
    if not (torch.equal(s, direct) and torch.equal(s[:DIST_PLAIN], plain)
            and int(best) == int(direct.max())):
        raise AssertionError("sharded_align_scores differs from "
                             "local_align_scores or the plain version")
    s_ms = cuda_ms(lambda: sharded_align_scores(mesh, qd, td, P,
                                                has_n=False), 20)
    log("7 dist", f"sharded_align_scores at bench_sharded_sw's {DIST_B} x "
        f"{DIST_L} x {DIST_L} a device (has_n detected False): == "
        f"local_align_scores and, on {DIST_PLAIN}, the plain version; "
        f"launches {s_launch}; {s_ms:.4f} ms a call with its all-reduce "
        f"(CUDA events), {DIST_B * DIST_L * DIST_L / s_ms / 1e6:.1f} GCUPS; "
        f"on {smi}")

    # nGIA's serial mesh rounds at bench_ngia's shape, and msa(mesh=)
    nreads = family_reads(np.random.default_rng(0), NGIA_READS, NGIA_LEN,
                          16, 12)
    zero_counts(lcs.LAUNCHES)
    t0 = time.time()
    mres = ngia.cluster_distributed(nreads, 0.95, mesh=mesh)
    m_wall = time.time() - t0
    n_launch = dict(lcs.LAUNCHES)
    t0 = time.time()
    one = ngia.cluster_distributed(nreads, 0.95, device=dev)
    o_wall = time.time() - t0
    require(n_launch, ("ngia_lcs",), what="cluster_distributed(mesh=)")
    if not np.array_equal(mres.cluster, one.cluster):
        raise AssertionError("nGIA's mesh rounds differ from one device")
    assert_clustering(mres, "cluster_distributed(mesh=)")
    log("7 dist", f"cluster_distributed(mesh=) serial over bench_ngia's "
        f"{NGIA_READS} x {NGIA_LEN} bp, 1 rank: {mres.n_clusters} clusters "
        f"== device='cuda' without a mesh; {m_wall:.2f} s "
        f"({NGIA_READS / m_wall:.0f} reads/s; without the mesh {o_wall:.2f}"
        f" s); launches {n_launch}")
    for label, seqs in (("bench_msa's", bench_msa_seqs()),
                        ("an indel", bench_msa_seqs(True))):
        zero_counts(msa.LAUNCHES)
        t0 = time.time()
        rows = msa.msa(seqs, mesh=mesh)
        a_wall = time.time() - t0
        a_launch = dict(msa.LAUNCHES)
        require(a_launch, tuple(a_launch), what="msa(mesh=)")
        if rows != msa.msa(seqs, device=dev):
            raise AssertionError(f"msa(mesh=) over {label} set differs from "
                                 f"msa()")
        log("7 dist", f"msa(mesh=) over {label} {len(seqs)} x "
            f"~{len(seqs[0])} set, 1 rank: == msa(); {a_wall:.3f} s; "
            f"launches {a_launch}")

    # two gloo ranks on the one card, as child processes
    n2 = DIST_B * DIST_RANKS
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker",
         "--seed", str(seed), "--rank", str(r), "--world", str(DIST_RANKS),
         "--init", f"file://{tmp.name}/gloo", "--dir", tmp.name],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DIST_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}:\n"
                                 f"{text[-3000:]}")
    ranks_s = time.time() - t0
    ranks = dict(np.load(os.path.join(tmp.name, "ranks.npz")))
    one = dist_calls(mesh, seed, n2, family_reads(
        np.random.default_rng(0), DIST_NGIA, NGIA_LEN, 16, 12),
        bench_msa_seqs(True))
    # the owner is a rank: the lowest whose block holds the best score
    sw = one["pipe_sw_score"]
    owner = int(np.argmax(sw == sw.max())) // DIST_B
    one["pipe_global_best_owner"] = np.array(owner, np.int32)
    bad = [k for k, v in one.items() if not np.array_equal(ranks[k], v)]
    if bad:
        raise AssertionError(f"two gloo ranks differ from world size 1 in "
                             f"{bad}")
    log("7 dist", f"{DIST_RANKS} gloo ranks on the one card (child "
        f"processes, {DIST_B} pairs a rank): the pipeline step's 12 fields, "
        f"sharded_align_scores, cluster_distributed(mesh=) over "
        f"{DIST_NGIA} reads and msa(mesh=) == world size 1 on the same "
        f"{n2} pairs; {ranks_s:.1f} s with the ranks' start")
    dist.destroy_process_group()
    tmp.cleanup()
    return launches


# -- the tools slice (tools_slice) ------------------------------------------
# run_all.py's bench_corrector (:470-491): 20,000 reads of 100 bp with 1%
# errors from a 20 kbp genome, the filters built on the first 6,000
CORR_READS, CORR_LEN, CORR_GENOME, CORR_BUILD = 20000, 100, 20000, 6000
CORR_CHECK = 1000       # reads of the native walk held to the Python walk
CLI_LIGHTER = (3000, 600)   # the lighter CLI's genome and reads (~20x)
ASM_WINDOWS, ASM_LEN, ASM_READS, ASM_READ_LEN = 64, 300, 32, 100
ASSEMBLY_WORKER = """
import pickle, sys
import torch
torch.set_num_threads(1)
from genomics_tpu_torch.models import assembly
with open(sys.argv[1], "rb") as f:
    windows = pickle.load(f)
out = []
for ref, reads in windows:
    haps, variants = assembly.local_assembly(ref, reads, device="cpu")
    out.append(([(h.seq, h.likelihood) for h in haps],
                [vars(v) for v in variants]))
pickle.dump(out, sys.stdout.buffer)
"""


def corrector_reads(n: int, genome: int, seed: int = 0) -> list:
    """bench_corrector's reads: rng(seed), a random genome, reads of
    CORR_LEN at random starts with 1% of their bases changed."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome)
    bases = np.array(list("ACGT"))
    reads = []
    for p in rng.integers(0, genome - CORR_LEN, n):
        r = g[p:p + CORR_LEN].copy()
        e = rng.random(CORR_LEN) < 0.01
        r[e] = (r[e] + rng.integers(1, 4, int(e.sum()))) % 4
        reads.append("".join(bases[r]))
    return reads


def assembly_windows(seed: int) -> list:
    """ASM_WINDOWS (reference window, reads): a random ASM_LEN bp window,
    a haplotype with a SNV and a 1-3 bp deletion or insertion, and
    ASM_READS reads of ASM_READ_LEN bp, half from each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ASM_WINDOWS):
        ref = random_seq(rng, ASM_LEN)
        s, d = int(rng.integers(60, 140)), int(rng.integers(160, 240))
        k = int(rng.integers(1, 4))
        snv = "ACGT"[("ACGT".index(ref[s]) + 1) % 4]
        alt = ref[:s] + snv + ref[s + 1:d] + (
            ref[d + k:] if rng.random() < 0.5 else random_seq(rng, k)
            + ref[d:])
        reads = []
        for i in range(ASM_READS):
            src = alt if i % 2 else ref
            p = int(rng.integers(0, len(src) - ASM_READ_LEN))
            reads.append(src[p:p + ASM_READ_LEN])
        out.append((ref, reads))
    return out


def tool_clis(tmpdir: str, window: tuple, sams: dict) -> dict:
    """The `lighter`, `assemble` and `alndiff` subcommands run twice each
    under tmpdir ("card" and "again"; assemble's second run with --device
    cpu): {run: [stdout and file bytes]}, the runs' directories written
    DIR; raises where the runs differ."""
    from genomics_tpu_torch.utils.fasta import write_fasta

    g, n = CLI_LIGHTER
    lr = os.path.join(tmpdir, "lighter.fa")
    write_fasta(lr, [(f"r{i}", r) for i, r in enumerate(
        corrector_reads(n, g, 43))])
    ref, rd = window
    wr, rr = (os.path.join(tmpdir, f) for f in ("win.fa", "reads.fa"))
    write_fasta(wr, [("win", ref)])
    write_fasta(rr, [(f"r{i}", r) for i, r in enumerate(rd)])
    runs = {}
    for tag in ("card", "again"):
        d = os.path.join(tmpdir, tag)
        os.mkdir(d)
        fa, html = os.path.join(d, "out.fa"), os.path.join(d, "r.html")
        runs[tag] = [
            run_cli(["lighter", "-i", lr, "-o", fa, "-g", str(g)]).replace(
                d, "DIR"),
            open(fa, "rb").read(),
            run_cli(["assemble", "-r", wr, "-q", rr] + (
                ["--device", "cpu"] if tag == "again" else [])),
            run_cli(["alndiff", sams["fmdev"], sams["qgram"], "--report",
                     html]).replace(d, "DIR"),
            open(html, "rb").read()]
    if runs["card"] != runs["again"]:
        raise AssertionError("the lighter / assemble / alndiff CLIs differ "
                             "between runs (assemble: between the card and "
                             "--device cpu)")
    return runs


def tools_slice(seed: int, dev, smi: str, sams: dict) -> dict:
    """The corrector, local assembly and alndiff on the card's machine,
    and the `lighter`, `assemble` and `alndiff` CLIs; returns the
    wavefront kernel's launches from local_assembly."""
    from genomics_tpu_torch.models import alndiff, assembly
    from genomics_tpu_torch.models.corrector import LighterCorrector
    from genomics_tpu_torch.ops import cuda_align, cuda_pairhmm, scan_pairhmm
    from genomics_tpu_torch.ops import tb_walk
    from genomics_tpu_torch.runtime import native

    # -- Lighter at bench_corrector's shape ---------------------------------
    reads = corrector_reads(CORR_READS, CORR_GENOME)
    corr = LighterCorrector(k=17, genome_size=CORR_GENOME)
    t0 = time.time()
    corr.build(reads[:CORR_BUILD])
    build_s = time.time() - t0
    t0 = time.time()
    fixed = corr.correct_batch(reads)
    walk_s = time.time() - t0
    t0 = time.time()
    python = corr.correct_batch(reads[:CORR_CHECK], use_native=False)
    py_s = time.time() - t0
    if fixed[:CORR_CHECK] != python:
        raise AssertionError("the native Lighter walk differs from the "
                             "Python walk")
    n_fix = sum(max(c, 0) for _, c in fixed)
    log("8 tools", f"LighterCorrector at bench_corrector's {CORR_READS} x "
        f"{CORR_LEN} bp (1% errors, a {CORR_GENOME} bp genome, built on "
        f"{CORR_BUILD} in {build_s:.1f} s): the native walk "
        f"(native/{' '.join(native.SOURCES)}, g++ without OpenMP: one "
        f"core) {walk_s:.2f} s, {CORR_READS / walk_s:.0f} reads/s; "
        f"{n_fix} bases corrected, {sum(c < 0 for _, c in fixed)} "
        f"unreliable; == the Python walk on {CORR_CHECK} reads "
        f"({CORR_CHECK / py_s:.0f} reads/s) (host clock)")

    # -- local assembly over ASM_WINDOWS windows -----------------------------
    windows = assembly_windows(seed + 41)
    zero_counts(cuda_pairhmm.LAUNCHES, cuda_align.LAUNCHES, tb_walk.LAUNCHES)
    t0 = time.time()
    results = [assembly.local_assembly(ref, rd, device=dev)
               for ref, rd in windows]
    asm_s = time.time() - t0
    launches = {k: v for c in (cuda_pairhmm.LAUNCHES, cuda_align.LAUNCHES,
                               tb_walk.LAUNCHES) for k, v in c.items() if v}
    require(launches, ("global_sw.tb", "tb_walk.global"),
            what="local_assembly",
            exactly={"pairhmm.wavefront": ASM_WINDOWS})
    t0 = time.time()
    profile_paths([("local_assembly over the windows", lambda: [
        assembly.local_assembly(ref, rd, device=dev)
        for ref, rd in windows], f"{ASM_WINDOWS} windows")], smi)
    # device="cpu" in child interpreters, while the card checks the
    # likelihoods and the CLIs run (nothing below is timed)
    cpu_jobs = start_children(ASSEMBLY_WORKER, windows)
    try:
        pairs = 0
        for (ref, rd), (haps, _v) in zip(windows, results):
            recs = [{"read": r.encode(), "hap": h.seq.encode(),
                     "base_quals": np.full(len(r), 30, np.int64),
                     "ins_quals": np.full(len(r), 45, np.int64),
                     "del_quals": np.full(len(r), 45, np.int64)}
                    for h in haps for r in rd]
            pairs += len(recs)
            plain = scan_pairhmm.pairhmm_forward_dataset(recs, device=dev)
            kern = cuda_pairhmm.pairhmm_forward_dataset(recs, device=dev)
            lik = np.log10(np.maximum(plain.astype(np.float64),
                                      1e-300)).reshape(
                len(haps), len(rd)).sum(axis=1)
            if not np.array_equal(plain, kern) or [
                    h.likelihood for h in haps] != [float(v) for v in lik]:
                raise AssertionError("a window's likelihoods differ from "
                                     "the plain version on the card")
        tmp = tempfile.TemporaryDirectory()
        an = alndiff.diff(sams["fmdev"], sams["qgram"],
                          report=os.path.join(tmp.name, "r.html"))
        runs = tool_clis(tmp.name, windows[0], sams)
    except BaseException:
        join_children(cpu_jobs, kill=True)
        raise
    on_cpu = join_children(cpu_jobs)
    if [([(h.seq, h.likelihood) for h in haps], [vars(v) for v in var])
            for haps, var in results] != on_cpu:
        raise AssertionError("a window's haplotypes or variants differ from "
                             "device='cpu'")
    n_var = sum(len(v) for _, v in results)
    log("8 tools", f"local_assembly over {ASM_WINDOWS} windows of {ASM_LEN} "
        f"bp x {ASM_READS} reads of {ASM_READ_LEN} bp: {asm_s:.2f} s "
        f"({ASM_WINDOWS / asm_s:.1f} windows/s, host clock), {pairs} "
        f"(read, haplotype) pairs in {launches.get('pairhmm.wavefront')} "
        f"wavefront launches, {n_var} variants; launches {launches}; each "
        f"window's likelihoods == the plain version on the card (bit for "
        f"bit), its haplotypes and variants == device='cpu' (in child "
        f"interpreters, {time.time() - t0:.1f} s with the checks below)")
    log("8 tools", f"alndiff of the mapper slice's fmdev + ed and q-gram "
        f"SAMs: {an.n} alignments, mapped by both {an.mapped.L_and_R}, one "
        f"only {an.mapped.L} / {an.mapped.R}, distant "
        f"{an.n_distant.count}, discordant {an.n_discordant.count}")
    g, n = CLI_LIGHTER
    log("8 tools", f"python -m genomics_tpu_torch lighter ({n} reads of a "
        f"{g} bp genome: {runs['card'][0].strip()}), assemble (window 0: "
        f"{runs['card'][2].splitlines()[-1]}) and alndiff: stdout and files "
        f"== a second run (assemble: == --device cpu)")
    tmp.cleanup()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after the build, profile every path (torch."
                         "profiler, cProfile) instead of phases 3-5")
    # a gloo rank of the distributed slice, started by the slice itself
    ap.add_argument("--dist-worker", action="store_true",
                    help=argparse.SUPPRESS)
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, help=argparse.SUPPRESS)
    for name in ("--init", "--dir"):
        ap.add_argument(name, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.time()

    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.dist_worker:
        return dist_worker(args)
    from genomics_tpu_torch import AlgoType, AlignEngine, AlignmentParams, _build
    from genomics_tpu_torch.core import golds
    from genomics_tpu_torch.core.scoring import SemiGlobalSkip
    from genomics_tpu_torch.models import pairhmm
    from genomics_tpu_torch.ops import (
        cuda_align,
        cuda_pairhmm,
        myers,
        scan_align_full,
        scan_pairhmm,
        tb_walk,
    )
    from genomics_tpu_torch.ops.scan_align import (
        banded_align_batch,
        global_align_batch,
        ksw_align_batch,
        local_align_batch,
        local_align_batch16,
        semiglobal_align_batch,
    )
    from genomics_tpu_torch.runtime.dispatch import default_buckets, walk_start

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log("1 device", f"{smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | cards visible {torch.cuda.device_count()}")
    P = AlignmentParams()
    PG = AlignmentParams(algo=AlgoType.GLOBAL)
    PS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    PK = AlignmentParams(algo=AlgoType.KSW)
    PB = AlignmentParams(algo=AlgoType.BANDED)
    SKIPS = [SemiGlobalSkip.NONE, SemiGlobalSkip.QUERY,
             SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH]
    GLOCAL = SemiGlobalSkip.TARGET   # head = tail = TARGET: read in target

    # -- 2. build ---------------------------------------------------------
    for lib in _build.BUILD_DIR.glob("lib*.so"):
        lib.unlink()                    # build from this checkout's sources
    t0 = time.time()
    _build.build_all()
    for name in _build.KERNELS:
        _build.library(name)
    build_s = time.time() - t0
    log("2 build", f"{len(_build.KERNELS)} kernels built in {build_s:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS[:2])}, one process per source)")
    from genomics_tpu_torch.runtime import native
    t0 = time.time()
    native.library()
    log("2 build", f"native/{' '.join(native.SOURCES)} (SA-IS) ready in "
        f"{time.time() - t0:.1f} s (g++ {' '.join(native.CXX_FLAGS)}, "
        f"build/native/)")
    for name in _build.KERNELS:
        lines = (_build.BUILD_DIR / f"{name}.log").read_text().splitlines()
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in lines if "Used " in ln})
        spilled = sum("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                      "loads" not in ln for ln in lines)
        log("2 build", f"{name}: {sum('Compiling entry' in ln for ln in lines)}"
            f" entry points, {regs[0]}-{regs[-1]} registers, {spilled} "
            f"with spills")

    if args.profile:
        prng = np.random.default_rng(args.seed)
        pairs = gasal_pairs(prng, PAIRS)
        kq, kt, kh0, _ = extension_pairs(prng, PAIRS, PK.match)
        PLS = AlignmentParams(compute_start=True)
        PSS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL, compute_start=True)
        P2 = AlignmentParams(second_best=True)
        glocal = dict(head=GLOCAL, tail=GLOCAL)
        paths = [(label, AlignEngine(pp, device=dev, **kw), pairs, None)
                 for label, pp, kw in (
                     ("LOCAL with traceback", P, dict(with_tb=True)),
                     ("LOCAL ends", P, {}),
                     ("LOCAL score-only", P, dict(score_only=True)),
                     ("GLOBAL with traceback", PG, dict(with_tb=True)),
                     ("GLOBAL score", PG, {}),
                     ("SEMI_GLOBAL glocal with traceback", PS,
                      dict(with_tb=True, **glocal)),
                     ("SEMI_GLOBAL glocal ends", PS, glocal),
                     ("LOCAL compute_start", PLS, {}),
                     ("glocal compute_start", PSS, glocal),
                     ("SEMI_GLOBAL NONE/BOTH compute_start", PSS,
                      dict(tail=SemiGlobalSkip.BOTH)),
                     ("LOCAL second_best", P2, {}),
                     ("LOCAL second_best + traceback", P2,
                      dict(with_tb=True)),
                     ("BANDED ends", PB, dict(band_width_tiles=BENCH_BAND)),
                     ("BANDED score-only", PB,
                      dict(band_width_tiles=BENCH_BAND, score_only=True)))]
        paths += [(label, AlignEngine(PK, device=dev, **kw), (kq, kt), kh0)
                  for label, kw in (("KSW ends", {}),
                                    ("KSW score-only", dict(score_only=True)))]
        paths.append(("LOCAL score-only, N-free pairs (SCORE16)",
                      AlignEngine(P, score_only=True, device=dev),
                      tuple(map(n_free, pairs)), None))
        runs = [(label, functools.partial(eng.align, q, t, h0=h0), len(q))
                for label, eng, (q, t), h0 in paths]

        def within(ctx, fn):
            def run():
                with ctx():
                    return fn()
            return run
        so_nf = functools.partial(AlignEngine(P, score_only=True,
                                              device=dev).align,
                                  *map(n_free, pairs))
        runs += [("LOCAL score-only, N-free pairs, SCORE forced",
                  within(int32_scores, so_nf), PAIRS),
                 ("LOCAL ends, GENOMICS_TPU_INT16_CELLS=1 (END16)",
                  within(int16_cells, functools.partial(
                      AlignEngine(P, device=dev).align, *pairs)), PAIRS)]
        regions, _ = region_records(args.seed)
        reads_ed, wins = ed_pairs(np.random.default_rng(args.seed + 5),
                                  ED_PAIRS)
        fasta_dir = tempfile.TemporaryDirectory()
        qf, tf = write_pair_fastas(fasta_dir.name, *pairs)
        cli = functools.partial(run_cli, ["align", "-q", qf, "-t", tf])
        runs += [
            ("align -y local (CLI over the FASTA files)", cli, PAIRS),
            ("align -y local, GENOMICS_TPU_INT16_CELLS=1",
             within(int16_cells, cli), PAIRS),
            ("PairHMM regions", functools.partial(
                pairhmm.compute_region_likelihoods, regions, device=dev),
             REGIONS * REGION_READS * REGION_HAPS),
            ("Myers ed", functools.partial(myers.edit_distance_semiglobal,
                                           reads_ed, wins, device=dev),
             ED_PAIRS)]
        # the mapper's paths, at PROFILE_READS reads / PROFILE_PAIRS pairs
        # against the 12 Mbp genome
        from genomics_tpu_torch.models.mapper import ReadMapper

        contigs, _, _, (mreads, *_), mpairs = mapper_inputs(
            args.seed, PROFILE_READS, PROFILE_PAIRS)
        m_fm = ReadMapper(contigs, seeder="fmdev", device=dev)
        m_q = ReadMapper(contigs, device=dev)
        mfiles = write_mapper_files(fasta_dir.name, contigs, mreads, mpairs,
                                    PROFILE_READS, PROFILE_PAIRS)
        runs = [
            ("mapper fmdev + ed", functools.partial(
                m_fm.map_batch, mreads, two_stage="ed"),
             f"{PROFILE_READS} reads"),
            ("mapper qgram", functools.partial(m_q.map_batch, mreads),
             f"{PROFILE_READS} reads"),
            ("mapper map_pairs (rescue)", functools.partial(
                m_q.map_pairs, mpairs[0], mpairs[1]),
             f"{PROFILE_PAIRS} read pairs"),
            ("map CLI to SAM (the index built from the FASTA included)",
             functools.partial(run_cli, [
                 "map", "-r", mfiles["ref"], "-q", mfiles["reads"], "-o",
                 os.path.join(fasta_dir.name, "o.sam")]),
             f"{PROFILE_READS} reads")] + runs + clustering_runs(dev)
        profile_paths(runs, smi)
        fasta_dir.cleanup()
        return 0

    # -- 3. each kernel against its plain version, on the card ------------
    err = {k: 0 for k in ("local_sw.score", "local_sw.end", "local_sw.tb",
                          "local_sw.score16", "local_sw.end16",
                          "tb_walk", "global_sw.score", "global_sw.tb",
                          "semiglobal_sw.end", "semiglobal_sw.tb",
                          "tb_walk.global", "tb_walk.semiglobal",
                          "local_sw.second", "local_start",
                          "semiglobal_start", "ksw.end", "ksw.score",
                          "banded_sw.end", "banded_sw.score")}

    def local_start_args(q, t, ql, tl, fwd):
        """(rev_q, rev_t, score, P, qr8, tr8) of the start pass fed the
        forward result fwd: the plain version takes the first four."""
        rq, rt, qr8, tr8 = scan_align_full.local_start_inputs(
            q, t, ql, tl, fwd.query_end, fwd.target_end)
        return rq, rt, fwd.score, P, qr8, tr8

    def semiglobal_start_args(q, t, ql, tl, fwd, head, tail):
        """(args, flags) of the start pass fed the forward result fwd."""
        rev = scan_align_full.semiglobal_start_inputs(q, t, ql, tl,
                                                      fwd.target_end)
        return ((*rev[:2], ql, tl, *rev[2:], fwd.score, fwd.query_end, PS),
                scan_align_full.skip_flags(head, tail))
    rng = np.random.default_rng(args.seed)
    # the seed scores come from their own generator, so rng's draws (and
    # every later phase's data) stay those of the earlier slices
    h0_rng = np.random.default_rng(args.seed + 2)
    cases = [("B=4133 152x152 ACGT", 4096 + 37, 152, 152, 0.0),
             ("B=1000 216x328 with Ns", 1000, 216, 328, 0.01)]
    for label, B, Lq, Lt, n_rate in cases:
        qn, tn, qln, tln = random_codes(rng, B, Lq, Lt, n_rate)
        q, t = torch.from_numpy(qn).to(dev), torch.from_numpy(tn).to(dev)
        ql, tl = torch.from_numpy(qln).to(dev), torch.from_numpy(tln).to(dev)
        e = {}
        # LOCAL: the 16-bit modes held to their int16 plain version and to
        # the int32 modes; END16 and the int32 modes through their
        # launches, the N-free scores through the score path (SCORE16)
        plain_tb = local_align_batch(q, t, P, with_tb=True)
        got_end = cuda_align.local_align(q, t, P)
        got_tb = cuda_align.local_align(q, t, P, with_tb=True)
        e["local_sw.end"] = max(
            max_abs_err(got_end[:3], plain_tb[:3]), max_abs_err(
                cuda_align._launch("end", q.T, t.T, P, True)[:3],
                plain_tb[:3]))
        got_end16 = cuda_align._launch("end16", q.T, t.T, P, True)[:3]
        e["local_sw.end16"] = max(
            max_abs_err(got_end16, plain_tb[:3]),
            max_abs_err(got_end16, local_align_batch16(q, t, P)[:3]))
        for g in SPLIT_GROUPS:   # every group, not only the rule's
            got_g = cuda_align.launch_local(cuda_align.local_launch_args(
                "end16", q.T, t.T, P, True, group=g))[:3]
            e["local_sw.end16"] = max(e["local_sw.end16"],
                                      max_abs_err(got_g, plain_tb[:3]))
        e["local_sw.tb"] = max_abs_err(got_tb, plain_tb)
        e["local_sw.score"] = max_abs_err(
            [cuda_align.local_align_scores(q, t, P, has_n=True)],
            [plain_tb.score])
        e["local_sw.score16"] = 0
        top = ""
        if n_rate == 0.0:   # only padding Ns: the has_n=False contract holds
            qs16, ts16 = (cuda_align._pads_to_sentinels(x.T, c).contiguous()
                          for x, c in ((q, 16), (t, 17)))
            e["local_sw.score"] = max(e["local_sw.score"], max_abs_err(
                [cuda_align._launch("score", qs16, ts16, P, False)[0]],
                [plain_tb.score]))
            e["local_sw.score16"] = max_abs_err(
                [cuda_align.local_align_scores(q, t, P, has_n=False),
                 cuda_align.local_align_scores_tm(
                     q.T.contiguous(), t.T.contiguous(), P, has_n=False),
                 local_align_batch16(qs16.T, ts16.T, P, ends=False).score]
                + [cuda_align.launch_local(cuda_align.local_launch_args(
                    "score16", qs16, ts16, P, False, group=g))[0]
                   for g in SPLIT_GROUPS],
                [plain_tb.score] * (3 + len(SPLIT_GROUPS)))
            # the top of the int16 range: match=200 at Lq 152
            P200 = AlignmentParams(match=200)
            plain200 = local_align_batch(q, t, P200)
            e["local_sw.end16"] = max(e["local_sw.end16"], max_abs_err(
                [*cuda_align._launch("end16", q.T, t.T, P200, True)[:3],
                 *local_align_batch16(q, t, P200)[:3],
                 *cuda_align._launch("end", q.T, t.T, P200, True)[:3]],
                [*plain200[:3]] * 3))
            zero_counts(cuda_align.LAUNCHES)
            e["local_sw.score16"] = max(e["local_sw.score16"], max_abs_err(
                [cuda_align.local_align_scores(q, t, P200, has_n=False),
                 cuda_align._launch("score", qs16, ts16, P200, False)[0]],
                [plain200.score] * 2))
            if not cuda_align.LAUNCHES["local_sw.score16"]:
                raise AssertionError(f"{label}: N-free scores at match=200 "
                                     f"did not take SCORE16")
            top = f" (match=200: best score {int(plain200.score.max())})"
        walk_args = (got_tb.tb, got_tb.score, got_tb.query_end,
                     got_tb.target_end, P)
        e["tb_walk"] = walk_err(tb_walk.walk_cigars(*walk_args),
                                tb_walk.walk_cigars_plain(*walk_args))
        e["local_sw.second"] = max_abs_err(
            cuda_align.local_align_second(q, t, ql, tl, P),
            scan_align_full.local_align_second_batch(q, t, ql, tl, P))
        st_args = local_start_args(q, t, ql, tl, got_end)
        e["local_start"] = max_abs_err(
            cuda_align.local_start(*st_args),
            scan_align_full._local_start_core(*st_args[:4]))
        # GLOBAL
        plain_g = global_align_batch(q, t, ql, tl, PG, with_tb=True)
        got_g = cuda_align.global_align(q, t, ql, tl, PG, with_tb=True)
        e["global_sw.tb"] = max_abs_err(got_g, plain_g)
        e["global_sw.score"] = max_abs_err(
            cuda_align.global_align(q, t, ql, tl, PG)[:3], plain_g[:3])
        walk_args = (got_g.tb, got_g.score, ql, tl, PG, "global")
        e["tb_walk.global"] = walk_err(tb_walk.walk_cigars(*walk_args),
                                       tb_walk.walk_cigars_plain(*walk_args))
        # SEMI_GLOBAL: ends for all 16 skips, traceback for head == tail
        e["semiglobal_sw.end"] = e["semiglobal_sw.tb"] = 0
        e["tb_walk.semiglobal"] = e["semiglobal_start"] = 0
        for head in SKIPS:
            for tail in SKIPS:
                kw = dict(head=head, tail=tail)
                got_s = cuda_align.semiglobal_align(q, t, ql, tl, PS, **kw)
                e["semiglobal_sw.end"] = max(e["semiglobal_sw.end"], max_abs_err(
                    got_s, semiglobal_align_batch(q, t, ql, tl, PS, **kw)[:3]))
                st_args, flags = semiglobal_start_args(q, t, ql, tl, got_s,
                                                       head, tail)
                e["semiglobal_start"] = max(e["semiglobal_start"], max_abs_err(
                    cuda_align.semiglobal_start(*st_args, **flags),
                    scan_align_full._semiglobal_start_core(*st_args,
                                                           **flags)))
            got_s = cuda_align.semiglobal_align(q, t, ql, tl, PS, head=head,
                                                tail=head, with_tb=True)
            e["semiglobal_sw.tb"] = max(e["semiglobal_sw.tb"], max_abs_err(
                got_s, semiglobal_align_batch(q, t, ql, tl, PS, head=head,
                                              tail=head, with_tb=True)))
            for g in SPLIT_GROUPS:   # every group, not only the rule's
                for tb_ in (False, True):
                    got_g = cuda_align.launch_semiglobal(
                        cuda_align.semiglobal_launch_args(
                            q.T, t.T, ql, tl, PS, head, SemiGlobalSkip.BOTH,
                            tb_, group=g))
                    key = "semiglobal_sw.tb" if tb_ else "semiglobal_sw.end"
                    e[key] = max(e[key], max_abs_err(
                        got_g if tb_ else got_g[:3], semiglobal_align_batch(
                            q, t, ql, tl, PS, head=head,
                            tail=SemiGlobalSkip.BOTH, with_tb=tb_)[:4 if tb_ else 3]))
            i0, j0 = walk_start(AlgoType.SEMI_GLOBAL, head, got_s, ql, tl)
            walk_args = (got_s.tb, got_s.score, j0, i0, PS, "semiglobal",
                         bool(head & SemiGlobalSkip.QUERY),
                         bool(head & SemiGlobalSkip.TARGET))
            e["tb_walk.semiglobal"] = max(e["tb_walk.semiglobal"], walk_err(
                tb_walk.walk_cigars(*walk_args),
                tb_walk.walk_cigars_plain(*walk_args)))
        # KSW with seed scores of 0-60; BANDED at bands of 1, 2, 4 tiles;
        # score-only without the N compare where the batch holds no N
        no_n = (True, False) if n_rate == 0.0 else (True,)
        h0 = torch.from_numpy(h0_rng.integers(0, 61, B).astype(np.int32)
                              ).to(dev)
        plain_k = ksw_align_batch(q, t, ql, tl, h0, PK)
        e["ksw.end"] = max_abs_err(cuda_align.ksw_align(q, t, ql, tl, h0, PK),
                                   plain_k[:3])
        e["ksw.score"] = max(max_abs_err(
            [cuda_align.ksw_align_scores(q, t, ql, tl, h0, PK, has_n=hn)],
            [plain_k.score]) for hn in no_n)
        e["banded_sw.end"] = e["banded_sw.score"] = 0
        for band in (1, 2, 4):
            plain_b = banded_align_batch(q, t, ql, tl, PB, band)
            e["banded_sw.end"] = max(e["banded_sw.end"], max_abs_err(
                cuda_align.banded_align(q, t, ql, tl, PB, band), plain_b[:3]))
            e["banded_sw.score"] = max([e["banded_sw.score"]] + [max_abs_err(
                [cuda_align.banded_align_scores(q, t, ql, tl, PB, band,
                                                has_n=hn)],
                [plain_b.score]) for hn in no_n])
        torch.cuda.synchronize()
        for k, v in e.items():
            err[k] = max(err[k], v)
        log("3 parity", f"{label}{top}: max |kernel - plain| " + " ".join(
            f"{k} {v}" for k, v in e.items()))
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {err}")
    # one below each int16 limit, on an odd B of related pairs whose first
    # 8 are identical (the query the target's first Lq bases), so that the
    # best score is the limit less one: END16 at 127 x 258 = 32,766 (the
    # ends' limit is 32,767), SCORE16 at 991 x 33 = 32,703 (32,704)
    edge_rng = np.random.default_rng(args.seed + 6)
    for mode, match, Lq, Lt in (("end16", 127, 258, 264),
                                ("score16", 991, 33, 40)):
        qn, tn, _, _ = random_codes(edge_rng, 1025, Lq, Lt, 0.0)
        full = np.array([1, 3, 7, 4], np.uint8)[edge_rng.integers(0, 4, Lt)]
        qn[:8], tn[:8] = full[:Lq], full
        q, t = torch.from_numpy(qn).to(dev), torch.from_numpy(tn).to(dev)
        pp = AlignmentParams(match=match)
        plain = local_align_batch(q, t, pp)
        if mode == "end16":
            got = [*cuda_align._launch("end16", q.T, t.T, pp, True)[:3],
                   *cuda_align._launch("end", q.T, t.T, pp, True)[:3],
                   *local_align_batch16(q, t, pp)[:3]]
            want = [*plain[:3]] * 3
        else:
            qs16, ts16 = (cuda_align._pads_to_sentinels(x.T, c).contiguous()
                          for x, c in ((q, 16), (t, 17)))
            got = [cuda_align._launch("score16", qs16, ts16, pp, False)[0],
                   cuda_align._launch("score", qs16, ts16, pp, False)[0],
                   local_align_batch16(qs16.T, ts16.T, pp, ends=False).score]
            want = [plain.score] * 3
        top = int(plain.score.max())
        if top != match * Lq:
            raise AssertionError(f"{mode} edge: best score {top}, not "
                                 f"{match * Lq}")
        err[f"local_sw.{mode}"] = max(err[f"local_sw.{mode}"],
                                      max_abs_err(got, want))
        log("3 parity", f"{mode} one below its limit: match {match} x Lq "
            f"{Lq} = {top}, B=1025, max |kernel - plain| "
            f"{max_abs_err(got, want)} (== the int32 mode and both plain "
            "versions)")
    # just inside and just past each int16 limit at Lq 168: 194 x 168 =
    # 32,592 is inside both, 195 x 168 = 32,760 past the scores' 32,704
    # only, 196 x 168 = 32,928 past both; the ends take END16 only under
    # GENOMICS_TPU_INT16_CELLS=1 and the scores SCORE16 only without Ns.
    # The launch counts show the mode.
    qt = [torch.from_numpy(x).to(dev)
          for x in random_codes(edge_rng, 1000, 168, 96, 0.0)[:2]]
    for match, cells16, has_n, modes in (
            (194, True, False, ("end16", "score16")),
            (195, True, False, ("end16", "score")),
            (196, True, False, ("end", "score")),
            (194, False, False, ("end", "score16")),
            (194, True, True, ("end16", "score"))):
        pp = AlignmentParams(match=match)
        zero_counts(cuda_align.LAUNCHES)
        with int16_cells() if cells16 else contextlib.nullcontext():
            got = [*cuda_align.local_align(*qt, pp)[:3],
                   cuda_align.local_align_scores(*qt, pp, has_n=has_n)]
        ran = {k for k, v in cuda_align.LAUNCHES.items() if v}
        if ran != {f"local_sw.{m}" for m in modes}:
            raise AssertionError(f"match {match} at Lq 168, INT16_CELLS "
                                 f"{cells16}, has_n {has_n}: launched {ran}, "
                                 f"not {modes}")
        plain = local_align_batch(*qt, pp)
        for m in modes:
            err[f"local_sw.{m}"] = max(err[f"local_sw.{m}"], max_abs_err(
                got, [*plain[:3], plain.score]))
    log("3 parity", "match x Lq at Lq 168, B=1000, under "
        "GENOMICS_TPU_INT16_CELLS=1: 194 -> END16 + SCORE16, 195 -> END16 + "
        "SCORE, 196 -> END + SCORE; 194 without it -> END + SCORE16; 194 "
        "with has_n -> END16 + SCORE (launch counts), each == plain")
    # KSW past the shared-memory rows: at Lq 1,000 the wrapper takes the
    # global [B, Lq + 1] scratch (ksw_layout), B = 1,024 + 37 ragged pairs
    # with Ns, seed scores 0-60, END and SCORE
    ksw_rng = np.random.default_rng(args.seed + 8)
    qk, tk, qlk, tlk = (torch.from_numpy(x).to(dev) for x in random_codes(
        ksw_rng, 1024 + 37, 1000, 1000, 0.01))
    h0k = torch.from_numpy(ksw_rng.integers(0, 61, 1024 + 37).astype(
        np.int32)).to(dev)
    if cuda_align.ksw_layout(1000)[0] != "global":
        raise AssertionError(f"Lq 1000 takes {cuda_align.ksw_layout(1000)}")
    plain_k = ksw_align_batch(qk, tk, qlk, tlk, h0k, PK)
    e_end = max_abs_err(cuda_align.ksw_align(qk, tk, qlk, tlk, h0k, PK),
                        plain_k[:3])
    e_score = max_abs_err([cuda_align.ksw_align_scores(qk, tk, qlk, tlk, h0k,
                                                        PK)],
                          [plain_k.score])
    err["ksw.end"] = max(err["ksw.end"], e_end)
    err["ksw.score"] = max(err["ksw.score"], e_score)
    log("3 parity", f"KSW at Lq 1000 (layout {cuda_align.ksw_layout(1000)}),"
        f" B=1061 1000x1000 with Ns: max |kernel - plain| ksw.end {e_end} "
        f"ksw.score {e_score}")
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {err}")

    # PairHMM: both kernels bit-equal to the plain sweep on the card in
    # both exact modes, B = 4,133 ragged reads of 100-150 against haps of
    # 250-350; the wavefront also at B = 1, 7, 64 of 250 x 500 (one round
    # of 8 rows a lane); every group and rows a lane of csrc/pairhmm.cuh,
    # in the rule's handover layout and the forced global one, at B = 1,
    # 7, 64, 256 and 1,061 with rlen at every round edge (pairhmm_edges);
    # 64 records against the gold
    ph_rng = np.random.default_rng(args.seed + 3)
    kernels_ph = {"pairhmm.intertask":
                  cuda_pairhmm.pairhmm_forward_intertask_prepared,
                  "pairhmm.wavefront": cuda_pairhmm.pairhmm_forward_prepared}
    recs = pairhmm_records(ph_rng, 4096 + 37)
    t_ph, p_ph = scan_pairhmm.device_inputs(
        scan_pairhmm.pack_records(recs), dev)
    plain_ph = scan_pairhmm.forward_prepared(*t_ph, p_ph)
    e = {k: max(float_err([fn(*t_ph, p_ph, exact=x)], [plain_ph])
                for x in (False, True)) for k, fn in kernels_ph.items()}
    for B in (1, 7, 64):
        t_s, p_s = scan_pairhmm.device_inputs(scan_pairhmm.pack_records(
            pairhmm_records(ph_rng, B, (250, 251), (500, 501))), dev)
        e["pairhmm.wavefront"] = max(e["pairhmm.wavefront"], float_err(
            [cuda_pairhmm.pairhmm_forward_prepared(*t_s, p_s)],
            [scan_pairhmm.forward_prepared(*t_s, p_s)]))
    for kernel, G, K in PAIRHMM_SHAPES:
        for B in PAIRHMM_EDGE_B:
            t_s, p_s = pairhmm_edges(ph_rng, B, G, K, dev)
            want_s = scan_pairhmm.forward_prepared(*t_s, p_s)
            for force in (False, True):
                e[f"pairhmm.{kernel}"] = max(
                    e[f"pairhmm.{kernel}"], float_err([pairhmm_launch(
                        kernel, t_s, p_s, G, K, force_global=force)],
                        [want_s]))
    ph_gold_idx = ph_rng.choice(len(recs), GOLD_CHECK, replace=False)
    want = gold_likelihoods([recs[k] for k in ph_gold_idx])
    got = plain_ph[torch.from_numpy(ph_gold_idx).to(dev)].cpu().numpy()
    if not np.array_equal(got.view(np.int32), want.view(np.int32)):
        raise AssertionError(f"PairHMM differs from the gold: {got} vs {want}")
    # Myers at W = 1, 3, 5 (registers) and 9 (scratch words): half the texts
    # hold their pattern, Ns, interior 255s, three empty patterns
    # uint32 masks (the `ed` stage's), their int64 copy (read at every second
    # word) and texts that are a slice of a larger tensor: rows 3 bytes off
    # a 16-byte boundary, and rows 13 bytes further apart than Lt
    e["myers"] = 0
    for W in (1, 3, 5, 9):
        m_args = myers_inputs(ph_rng, 4096 + 37, W, dev)
        m_plain = myers.myers_batch_plain(*m_args)
        B_m, Lt_m = m_args[2].shape
        flat = torch.zeros(3 + B_m * Lt_m, dtype=torch.uint8, device=dev)
        flat[3:] = m_args[2].reshape(-1)
        wide = torch.zeros((B_m, Lt_m + 13), dtype=torch.uint8, device=dev)
        wide[:, 5:5 + Lt_m] = m_args[2]
        for eq_m in (m_args[0], m_args[0].long()):
            for tx in (m_args[2], flat[3:].view(B_m, Lt_m),
                       wide[:, 5:5 + Lt_m]):
                e["myers"] = max(e["myers"], max_abs_err(
                    myers.myers_batch(eq_m, m_args[1], tx, m_args[3]),
                    m_plain))
    torch.cuda.synchronize()
    err.update(e)
    log("3 parity", f"PairHMM B=4133 100-150 x 250-350 (both exact modes), "
        f"wavefront B=1/7/64 at 250 x 500, the round edges at B="
        f"{'/'.join(map(str, PAIRHMM_EDGE_B))} for (kernel, lanes a pair, "
        f"rows a lane) in {PAIRHMM_SHAPES}, handover by the rule and "
        f"forced global; Myers W=1/3/5/9 at B=4133 (uint32 and int64 masks, "
        f"texts whole, 3 bytes off 16 and rows 13 bytes apart): "
        f"max |kernel - plain| " + " ".join(f"{k} {v}" for k, v in e.items())
        + f"; PairHMM == gold bit for bit on {GOLD_CHECK} records")
    if any(e.values()):
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{e}")

    # the walk at its edges (walk_edges: M runs of 63, 64 and 126, pads of
    # 63 and 64, starts outside the cube, walks with no step, a LOCAL stop
    # on the first step, chain-biased cubes) in every mode and SEMI_GLOBAL
    # head, under one wave and at 4,133 pairs; its own generator, so every
    # later phase's data stays the earlier slices'
    w_rng = np.random.default_rng(args.seed + 7)
    walk_modes = [("tb_walk", P, "local", False, False),
                  ("tb_walk.global", PG, "global", False, False)] + [
        ("tb_walk.semiglobal", PS, "semiglobal", hq, ht)
        for hq in (False, True) for ht in (False, True)]
    e = {k: 0 for k, *_ in walk_modes}
    for B in (37, 4096 + 37):
        edge = walk_edges(w_rng, B, dev)
        for key, pp, algo, hq, ht in walk_modes:
            a_ = (*edge, pp, algo, hq, ht)
            e[key] = max(e[key], walk_err(tb_walk.walk_cigars(*a_),
                                          tb_walk.walk_cigars_plain(*a_)))
    torch.cuda.synchronize()
    log("3 parity", f"walk edges ({len(WALK_EDGES)} made pairs, the rest "
        f"random and chain-biased {WALK_EDGE_L} x {WALK_EDGE_L} cubes) at "
        f"B=37 and 4133, every mode and SEMI_GLOBAL head: max |kernel - "
        f"plain| over the bytes, n_ops and starts " + " ".join(
            f"{k} {v}" for k, v in e.items()))
    if any(e.values()):
        raise AssertionError(f"the walk disagrees with its plain version at "
                             f"its edges: {e}")
    for k, v in e.items():
        err[k] = max(err[k], v)

    # -- 4. the slice through AlignEngine ---------------------------------
    qs, ts = gasal_pairs(rng, PAIRS)
    n = len(qs)
    log("4 slice", f"{n} pairs, reads {min(map(len, qs))}-"
        f"{max(map(len, qs))} bp, targets {min(map(len, ts))}-"
        f"{max(map(len, ts))} bp, seed {args.seed}")
    counts = (cuda_align.LAUNCHES, tb_walk.LAUNCHES)
    secs = {}

    def timed(key, eng, pairs=None, h0=None):
        """eng.align on the card (no host run-length encode), its host
        clock in secs[key]."""
        t0 = time.time()
        with no_host_encode():
            jobs = eng.align(*(pairs or (qs, ts)), h0=h0)
        secs[key] = time.time() - t0
        if len(jobs) != n:
            raise AssertionError(f"{key}: the engine returned {len(jobs)} "
                                 f"jobs for {n} pairs")
        return jobs

    # 4a. LOCAL: ends in END, and in END16 under GENOMICS_TPU_INT16_CELLS=1;
    # score-only in SCORE where a chunk holds an N (here every chunk) and in
    # SCORE16 on the N-free copies; ends past the int16 range (match=160 at
    # the 216 bucket) in END even under the switch
    qs_nf, ts_nf = n_free(qs), n_free(ts)
    PW = AlignmentParams(match=160)
    zero_counts(*counts)
    jobs_tb = timed("local tb", AlignEngine(P, with_tb=True, device=dev))
    jobs_end = timed("local ends", AlignEngine(P, device=dev))
    with int16_cells():
        jobs_end16 = timed("local ends INT16_CELLS=1",
                           AlignEngine(P, device=dev))
    jobs_so = timed("local score-only",
                    AlignEngine(P, score_only=True, device=dev))
    jobs_so16 = timed("local score-only N-free", AlignEngine(
        P, score_only=True, device=dev), (qs_nf, ts_nf))
    end16_before = cuda_align.LAUNCHES["local_sw.end16"]
    with int16_cells():
        jobs_wide = timed("local ends match=160", AlignEngine(PW, device=dev))
    if cuda_align.LAUNCHES["local_sw.end16"] != end16_before:
        raise AssertionError("ends at match=160 x 216 took END16")
    launches = {k: cuda_align.LAUNCHES[k] for k in
                ("local_sw.score", "local_sw.end", "local_sw.tb",
                 "local_sw.score16", "local_sw.end16")}
    launches["tb_walk"] = tb_walk.LAUNCHES["tb_walk"]
    edges = default_buckets()
    bucket = lambda s: next(e for e in edges if len(s) <= e)
    per_bucket = {}
    for a, b in zip(qs, ts):
        key = bucket(a), bucket(b)
        per_bucket[key] = per_bucket.get(key, 0) + 1
    log("4 slice", f"LOCAL launches: {launches}; pairs per bucket (one "
        f"launch each): {per_bucket}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the LOCAL path never launched: "
                             f"{launches}")
    # the engine's score-only wall on the N-free copies, SCORE16 (the gate's
    # pick) against SCORE forced, in turns (A, B, B, A) five times
    so_eng = AlignEngine(P, score_only=True, device=dev)
    so_walls = {"local_sw.score16": [], "local_sw.score": []}
    for key in ("local_sw.score16", "local_sw.score", "local_sw.score",
                "local_sw.score16") * 5:
        zero_counts(*counts)
        with int32_scores() if key == "local_sw.score" else (
                contextlib.nullcontext()):
            t0 = time.time()
            got = so_eng.align(qs_nf, ts_nf)
            so_walls[key].append(time.time() - t0)
        ran = {k for k, v in cuda_align.LAUNCHES.items() if v}
        if ran != {key} or [j.score for j in got] != [
                j.score for j in jobs_so16]:
            raise AssertionError(f"score-only with {key}: launched {ran}")
    log("4 slice", "LOCAL score-only on the N-free copies, host clock over "
        f"{n} pairs in turns: " + ", ".join(
            f"{k.split('.')[1].upper()} min {min(v):.4f} s, median "
            f"{float(np.median(v)):.4f} s ({' '.join(f'{x:.4f}' for x in v)})"
            for k, v in so_walls.items()) + f", on {smi}")
    for k in range(n):
        a, b, c = jobs_tb[k], jobs_end[k], jobs_so[k]
        if any((a.score, a.query_end, a.target_end) != (
                x.score, x.query_end, x.target_end)
                for x in (b, jobs_end16[k])) or a.score != c.score:
            raise AssertionError(f"pair {k}: traceback, ends-only and "
                                 f"score-only runs disagree")
        if not 0 <= a.score <= 150 * P.match or (
                a.score > 0 and not a.cigar_string):
            raise AssertionError(f"pair {k}: implausible result {a}")
    scores = np.array([j.score for j in jobs_tb])
    if np.mean(scores >= 100) < 0.9:
        raise AssertionError(f"reads cut from their targets scored low: "
                             f"median {np.median(scores)}")
    sub = range(2 * CPU_CHECK)
    assert_jobs_equal(jobs_tb, AlignEngine(
        P, with_tb=True, device="cpu").align([qs[k] for k in sub],
                                             [ts[k] for k in sub]), "LOCAL")
    gold_idx = np.random.default_rng(args.seed + 1).choice(n, GOLD_CHECK,
                                                           replace=False)
    for k in gold_idx:
        g = golds.local_align(qs[k], ts[k], P)
        got = jobs_tb[k]
        if (got.score, got.query_end, got.target_end) != (
                g["score"], g["query_end"], g["target_end"]):
            raise AssertionError(f"pair {k}: gold {g} vs engine {got}")
    sub = range(CPU_CHECK)
    for what, got, pp, kw, (sq, st) in (
            ("LOCAL ends", jobs_end, P, {}, (qs, ts)),
            ("LOCAL score-only N-free", jobs_so16, P, dict(score_only=True),
             (qs_nf, ts_nf)),
            ("LOCAL ends match=160", jobs_wide, PW, {}, (qs, ts))):
        assert_jobs_equal(got, AlignEngine(pp, device="cpu", **kw).align(
            [sq[k] for k in sub], [st[k] for k in sub]), what)
    for k in gold_idx:
        for got, pp, pair in ((jobs_so16[k], P, (qs_nf[k], ts_nf[k])),
                              (jobs_wide[k], PW, (qs[k], ts[k]))):
            g = golds.local_align(*pair, pp)
            if got.score != g["score"] or (pp is PW and (
                    got.query_end, got.target_end) != (g["query_end"],
                                                        g["target_end"])):
                raise AssertionError(f"pair {k}: gold {g} vs engine {got}")
    log("4 slice", f"LOCAL == CPU engine on {2 * CPU_CHECK} pairs (every "
        f"field, CIGAR bytes included), ends (END), N-free score-only "
        f"(SCORE16) and match=160 ends (END) on {CPU_CHECK}; == gold on "
        f"{GOLD_CHECK} pairs; median score {np.median(scores)}, at "
        f"match=160 {np.median([j.score for j in jobs_wide])}; e.g. "
        f"{jobs_tb[0].cigar_string} score {jobs_tb[0].score}")

    # 4b. GLOBAL and SEMI_GLOBAL glocal
    zero_counts(*counts)
    g_tb = timed("global tb", AlignEngine(PG, with_tb=True, device=dev))
    g_sc = timed("global score", AlignEngine(PG, device=dev))
    s_tb = timed("semiglobal tb", AlignEngine(
        PS, with_tb=True, head=GLOCAL, tail=GLOCAL, device=dev))
    s_end = timed("semiglobal ends", AlignEngine(
        PS, head=GLOCAL, tail=GLOCAL, device=dev))
    new_names = ("global_sw.score", "global_sw.tb", "semiglobal_sw.end",
                 "semiglobal_sw.tb")
    for k in new_names:
        launches[k] = cuda_align.LAUNCHES[k]
    for k in ("tb_walk.global", "tb_walk.semiglobal"):
        launches[k] = tb_walk.LAUNCHES[k]
    log("4 slice", "GLOBAL / SEMI_GLOBAL launches: " + str(
        {k: launches[k] for k in new_names + ("tb_walk.global",
                                              "tb_walk.semiglobal")}))
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the GLOBAL / SEMI_GLOBAL path "
                             f"never launched: {launches}")
    for k in range(n):
        a, b, c, d = g_tb[k], g_sc[k], s_tb[k], s_end[k]
        if (a.score, a.query_end, a.target_end) != (
                b.score, b.query_end, b.target_end) or (
                c.score, c.query_end, c.target_end) != (
                d.score, d.query_end, d.target_end):
            raise AssertionError(f"pair {k}: traceback and ends-only runs "
                                 f"disagree")
        ql, tl = len(qs[k]), len(ts[k])
        # the GLOBAL walk starts one cell past the end (a reference quirk)
        if cigar_spans(a.cigar_string) != (ql + 1, tl + 1) or (
                a.query_end, a.target_end) != (ql - 1, tl - 1):
            raise AssertionError(f"pair {k}: GLOBAL result {a} does not "
                                 f"span {ql} x {tl}")
        if cigar_spans(c.cigar_string) != (
                ql, c.target_end - c.target_start + 1) or c.query_start:
            raise AssertionError(f"pair {k}: glocal result {c} does not "
                                 f"cover the read")
    s_scores = np.array([j.score for j in s_tb])
    if np.mean(s_scores >= 100) < 0.9:
        raise AssertionError(f"reads cut from their targets scored low in "
                             f"glocal: median {np.median(s_scores)}")
    sub = range(CPU_CHECK)
    sq, st = [qs[k] for k in sub], [ts[k] for k in sub]
    assert_jobs_equal(g_tb, AlignEngine(PG, with_tb=True,
                                        device="cpu").align(sq, st), "GLOBAL")
    assert_jobs_equal(s_tb, AlignEngine(PS, with_tb=True, head=GLOCAL,
                                        tail=GLOCAL, device="cpu").align(
        sq, st), "SEMI_GLOBAL")
    for k in gold_idx:
        g = golds.global_align(qs[k], ts[k], PG)
        h = golds.semiglobal_align(qs[k], ts[k], PS, head=GLOCAL, tail=GLOCAL)
        for want, got in ((g, g_tb[k]), (h, s_tb[k])):
            if (got.score, got.query_end, got.target_end) != (
                    want["score"], want["query_end"], want["target_end"]):
                raise AssertionError(f"pair {k}: gold {want} vs engine {got}")
    # models/assembly.py's GLOBAL scoring (haplotype vs reference window)
    PA = AlignmentParams(algo=AlgoType.GLOBAL, match=2, mismatch=4,
                         gap_open=6, gap_extend=1)
    with no_host_encode():
        a_tb = AlignEngine(PA, with_tb=True, device=dev).align(qs[:4096],
                                                               ts[:4096])
    assert_jobs_equal(a_tb, AlignEngine(
        PA, with_tb=True, device="cpu").align(qs[:256], ts[:256]),
        "GLOBAL with the assembly scoring")
    for k in gold_idx[:16]:
        if k < 4096 and a_tb[k].score != golds.global_align(
                qs[k], ts[k], PA)["score"]:
            raise AssertionError(f"pair {k}: assembly-scoring GLOBAL "
                                 f"differs from the gold")
    log("4 slice", f"GLOBAL and SEMI_GLOBAL == CPU engine on {CPU_CHECK} "
        f"pairs each (every field, CIGAR bytes included); == gold on "
        f"{GOLD_CHECK} pairs; assembly scoring == CPU engine on 256; median "
        f"score GLOBAL {np.median([j.score for j in g_tb])}, glocal "
        f"{np.median(s_scores)}; e.g. glocal {s_tb[0].cigar_string} at "
        f"target {s_tb[0].target_start}-{s_tb[0].target_end}")

    # 4c. start positions without traceback, and LOCAL second best
    PLS = AlignmentParams(compute_start=True)
    PSS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL, compute_start=True)
    P2 = AlignmentParams(second_best=True)
    NB = dict(head=SemiGlobalSkip.NONE, tail=SemiGlobalSkip.BOTH)
    opts = {  # name: (params, engine keywords)
        "local start": (PLS, {}),
        "semiglobal start": (PSS, dict(head=GLOCAL, tail=GLOCAL)),
        "semiglobal start NONE/BOTH": (PSS, NB),
        "local second": (P2, {}),
        "local second tb": (P2, dict(with_tb=True)),
    }
    zero_counts(*counts)
    got_opt = {k: timed(k, AlignEngine(pp, device=dev, **kw))
               for k, (pp, kw) in opts.items()}
    new_names = ("local_sw.second", "local_start", "semiglobal_start")
    for k in new_names:
        launches[k] = cuda_align.LAUNCHES[k]
    log("4 slice", "start / second-best launches: " + str(
        {k: cuda_align.LAUNCHES[k] for k in cuda_align.LAUNCHES}
        | {"tb_walk": tb_walk.LAUNCHES["tb_walk"]}))
    if not all(launches[k] for k in new_names):
        raise AssertionError(f"a kernel of the start / second-best paths "
                             f"never launched: {launches}")
    l_st, s_st = got_opt["local start"], got_opt["semiglobal start"]
    l_2, l_2tb = got_opt["local second"], got_opt["local second tb"]
    walk_q = walk_t = 0
    for k in range(n):
        ends = lambda j: (j.score, j.query_end, j.target_end)
        second = lambda j: (j.score_second, j.query_end_second,
                            j.target_end_second)
        if not (ends(l_st[k]) == ends(l_2[k]) == ends(l_2tb[k])
                == ends(jobs_end[k])) or ends(s_st[k]) != ends(s_end[k]):
            raise AssertionError(f"pair {k}: the start / second-best runs "
                                 f"changed score or ends")
        if second(l_2[k]) != second(l_2tb[k]) or not (
                0 <= l_2[k].score_second <= l_2[k].score) or not np.array_equal(
                l_2tb[k].cigar, jobs_tb[k].cigar):
            raise AssertionError(f"pair {k}: second best {l_2[k]} vs "
                                 f"{l_2tb[k]}")
        walk_q += l_st[k].query_start == jobs_tb[k].query_start
        walk_t += s_st[k].target_start == s_tb[k].target_start
    sub = range(CPU_CHECK)
    sq, st = [qs[k] for k in sub], [ts[k] for k in sub]
    for k, (pp, kw) in opts.items():
        assert_jobs_equal(got_opt[k], AlignEngine(pp, device="cpu", **kw)
                          .align(sq, st), k)
    for k in gold_idx:
        g = golds.local_align(qs[k], ts[k], P, with_start=True,
                              second_best=True)
        for got, fields in ((l_st[k], ("score", "query_end", "target_end",
                                        "query_start", "target_start")),
                            (l_2[k], ("score", "query_end", "target_end",
                                      "score_second", "query_end_second",
                                      "target_end_second"))):
            if any(getattr(got, f) != g[f] for f in fields):
                raise AssertionError(f"pair {k}: gold {g} vs engine {got}")
        for key, kw in (("semiglobal start", opts["semiglobal start"][1]),
                        ("semiglobal start NONE/BOTH", NB)):
            h = golds.semiglobal_align(qs[k], ts[k], PS, with_start=True, **kw)
            got = got_opt[key][k]
            if (got.score, got.query_end, got.target_end, got.query_start,
                    got.target_start) != (h["score"], h["query_end"],
                                          h["target_end"], h["query_start"],
                                          h["target_start"]):
                raise AssertionError(f"pair {k}: {key} gold {h} vs engine "
                                     f"{got}")
    log("4 slice", f"start passes and second best == CPU engine on "
        f"{CPU_CHECK} pairs each (every field), == gold on {GOLD_CHECK} "
        f"pairs; score and ends == the forward runs on all {n}; LOCAL "
        f"query_start == the walk's on {walk_q} of {n} (target_start is "
        f"the reference's skewed one), glocal target_start == the walk's "
        f"on {walk_t}; median second best "
        f"{np.median([j.score_second for j in l_2])}; e.g. LOCAL starts "
        f"({l_st[0].query_start}, {l_st[0].target_start}), glocal "
        f"({s_st[0].query_start}, {s_st[0].target_start})")

    # 4d. KSW seed extension and BANDED
    kq, kt, kh0, unrelated = extension_pairs(rng, n, PK.match)
    ends = lambda j: (j.score, j.query_end, j.target_end)
    zero_counts(*counts)
    k_end = timed("ksw ends", AlignEngine(PK, device=dev), (kq, kt), kh0)
    k_so = timed("ksw score-only", AlignEngine(PK, score_only=True,
                                               device=dev), (kq, kt), kh0)
    b_end = timed("banded ends", AlignEngine(
        PB, band_width_tiles=BENCH_BAND, device=dev))
    b_so = timed("banded score-only", AlignEngine(
        PB, band_width_tiles=BENCH_BAND, score_only=True, device=dev))
    new_names = ("ksw.end", "ksw.score", "banded_sw.end", "banded_sw.score")
    for k in new_names:
        launches[k] = cuda_align.LAUNCHES[k]
    log("4 slice", "KSW / BANDED launches: " + str(
        {k: cuda_align.LAUNCHES[k] for k in cuda_align.LAUNCHES}
        | {k: v for k, v in tb_walk.LAUNCHES.items()}))
    if not all(launches[k] for k in new_names):
        raise AssertionError(f"a kernel of the KSW / BANDED paths never "
                             f"launched: {launches}")
    for k in range(n):
        if k_so[k].score != k_end[k].score or b_so[k].score != b_end[k].score:
            raise AssertionError(f"pair {k}: score-only and ends runs "
                                 f"disagree")
        if (k_so[k].query_end, k_so[k].target_end, b_so[k].query_end,
                b_so[k].target_end) != (0, 0, 0, 0) or any(
                j.cigar is not None for j in (k_end[k], b_end[k])):
            raise AssertionError(f"pair {k}: score-only ends or a CIGAR")
        if k_end[k].score < kh0[k] - 5 or not (
                0 <= b_end[k].score <= 150 * PB.match):
            raise AssertionError(f"pair {k}: implausible {k_end[k]}, "
                                 f"{b_end[k]}")
    sub = range(CPU_CHECK)
    for what, got, pp, kw, pairs, h0 in (
            ("KSW ends", k_end, PK, {}, (kq, kt), kh0),
            ("KSW score-only", k_so, PK, dict(score_only=True), (kq, kt), kh0),
            ("BANDED ends", b_end, PB, {}, (qs, ts), None),
            ("BANDED score-only", b_so, PB, dict(score_only=True), (qs, ts),
             None)):
        assert_jobs_equal(got, AlignEngine(
            pp, band_width_tiles=BENCH_BAND, device="cpu", **kw).align(
            [pairs[0][k] for k in sub], [pairs[1][k] for k in sub],
            h0=None if h0 is None else h0[:CPU_CHECK]), what)
    for k in gold_idx:
        g = golds.ksw_align(kq[k], kt[k], PK, int(kh0[k]))
        h = golds.banded_align(qs[k], ts[k], PB, BENCH_BAND)
        for want, got in ((g, k_end[k]), (h, b_end[k])):
            if ends(got) != (want["score"], want["query_end"],
                             want["target_end"]):
                raise AssertionError(f"pair {k}: gold {want} vs engine {got}")
    k_gain = np.array([j.score for j in k_end]) - kh0
    k_full = np.array([j.query_end == len(q) for j, q in zip(k_end, kq)])
    log("4 slice", f"KSW on {n} seed extensions ({int(unrelated.sum())} "
        f"with an unrelated target, seeds 19-31 bp, h0 = seed x match) and "
        f"BANDED (band {BENCH_BAND} tiles) on the {n} pairs: == CPU engine "
        f"on {CPU_CHECK} pairs each (every field, ends and score-only), == "
        f"gold on {GOLD_CHECK}; score-only scores == the ends runs' on all "
        f"{n}; KSW median gain over h0 {np.median(k_gain[~unrelated])} "
        f"(unrelated {np.median(k_gain[unrelated])}), extension to the "
        f"read's end on {int(k_full.sum())}; BANDED median score "
        f"{np.median([j.score for j in b_end])}")

    # 4e. the `align` CLI over the same pairs, written to two FASTA files
    # under all four header ops, as is (END) and under
    # GENOMICS_TPU_INT16_CELLS=1 (END16): the two runs equal line for line,
    # their first CPU_CHECK lines byte-equal to the CLI's own --device cpu
    # run (without the switch: the int32 plain version), GOLD_CHECK pairs
    # held to the gold
    cli_runs = {"-y local": (False, "local_sw.end"),
                "-y local, GENOMICS_TPU_INT16_CELLS=1": (True, "local_sw.end16")}
    cli_lines, cli_launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        qf, tf = write_pair_fastas(tmp, qs, ts)
        argv = ["align", "-q", qf, "-t", tf]
        for label, (cells16, kernel) in cli_runs.items():
            zero_counts(*counts)
            t0 = time.time()
            with int16_cells() if cells16 else contextlib.nullcontext():
                lines = run_cli(argv).splitlines()
            secs[f"align {label}"] = time.time() - t0
            cli_launches[label] = {k: v for k, v in cuda_align.LAUNCHES.items()
                                   if v}
            if len(lines) != n or set(cli_launches[label]) != {kernel}:
                raise AssertionError(f"align {label}: {len(lines)} lines, "
                                     f"launches {cli_launches[label]}")
            cli_lines[label] = lines
        cpu = run_cli(argv + ["--device", "cpu", "--limit",
                              str(CPU_CHECK)]).splitlines()
    for label, lines in cli_lines.items():
        if lines != cli_lines["-y local"] or cpu != lines[:CPU_CHECK]:
            k = next((i for i, (a, b) in enumerate(zip(cpu, lines)) if a != b),
                     None)
            raise AssertionError(f"align {label} differs from the run without "
                                 f"the switch or, at line {k}, from --device "
                                 f"cpu")
    for k in gold_idx:
        g = golds.local_align(qs[k], ts[k], P)
        want = f"{k}\tscore={g['score']}\tqe={g['query_end']}\tte={g['target_end']}"
        if cli_lines["-y local"][k] != want:
            raise AssertionError(f"align line {k}: "
                                 f"{cli_lines['-y local'][k]!r} vs gold {want!r}")
    log("4 slice", f"align CLI over {n} pairs in two FASTA files (header "
        f"ops {' '.join(HEADER_OPS)}), launches {cli_launches}; the runs "
        f"equal, == --device cpu byte for byte on {CPU_CHECK} lines, == gold "
        f"on {GOLD_CHECK}; host clock " + ", ".join(
            f"{label} {secs['align ' + label]:.3f} s" for label in cli_runs)
        + f", on {smi}")

    # 4f. PairHMM over GATK-shaped regions: every region's reads x haps in
    # one compute_region_likelihoods call (the inter-task kernel), both
    # exact modes; then assembly-style candidate scoring (one region's
    # reads x haps at a time, models/assembly.py:176-190) through the
    # wavefront's pairhmm_forward_dataset
    regions, flat = region_records(args.seed)
    n_ph = len(flat)
    zero_counts(*counts, cuda_pairhmm.LAUNCHES, myers.LAUNCHES)
    t0 = time.time()
    mats, ph_res = pairhmm.compute_region_likelihoods(regions, device=dev)
    region_s = time.time() - t0
    mats_x, _ = pairhmm.compute_region_likelihoods(regions, exact=True,
                                                   device=dev)
    cands = [cuda_pairhmm.pairhmm_forward_dataset(
        flat[k * REGION_READS * REGION_HAPS:(k + 1) * REGION_READS
             * REGION_HAPS], device=dev) for k in range(4)]
    new_names = ("pairhmm.intertask", "pairhmm.wavefront")
    for k in new_names:
        launches[k] = cuda_pairhmm.LAUNCHES[k]
    log("4 slice", f"PairHMM launches: {dict(cuda_pairhmm.LAUNCHES)}")
    if not all(launches[k] for k in new_names):
        raise AssertionError(f"a kernel of the PairHMM paths never "
                             f"launched: {launches}")
    lik = np.concatenate([m.ravel() for m in mats])
    if [m.shape for m in mats] != [(REGION_READS, REGION_HAPS)] * REGIONS or (
            lik.shape != (n_ph,)) or not np.isfinite(lik).all() or (
            np.mean(lik > 0) < 0.99):
        raise AssertionError(f"PairHMM regions: implausible likelihoods "
                             f"{[m.shape for m in mats[:2]]}, {lik[:4]}")
    bits = lambda x: np.asarray(x, np.float32).view(np.int32)
    if not np.array_equal(bits(lik), bits(np.concatenate(
            [m.ravel() for m in mats_x]))) or not np.array_equal(
            bits(np.concatenate(cands)), bits(lik[:len(cands) * REGION_READS
                                      * REGION_HAPS])):
        raise AssertionError("PairHMM: the exact run or the wavefront's "
                             "candidates differ from the region run")
    t_all, p_all = scan_pairhmm.device_inputs(
        scan_pairhmm.pack_records(flat), dev)
    plain_lik = scan_pairhmm.forward_prepared(*t_all, p_all).cpu().numpy()
    if not np.array_equal(bits(lik), bits(plain_lik)):
        raise AssertionError(f"PairHMM regions: "
                             f"{int((bits(lik) != bits(plain_lik)).sum())} "
                             f"likelihoods differ from the plain version")
    reg_gold_idx = np.random.default_rng(args.seed + 1).choice(
        n_ph, GOLD_CHECK, replace=False)
    want = gold_likelihoods([flat[k] for k in reg_gold_idx])
    if not np.array_equal(bits(lik[reg_gold_idx]), bits(want)):
        raise AssertionError("PairHMM regions differ from the gold")
    log10 = np.log10(lik[lik > 0])
    log("4 slice", f"PairHMM {REGIONS} regions x {REGION_READS} reads x "
        f"{REGION_HAPS} haplotypes ({REGION_RL} / {REGION_HL} bp): {n_ph} "
        f"pairs, {ph_res.cells} cells, one inter-task launch; == plain "
        f"version on the card on all {n_ph} (bit for bit, both exact modes), "
        f"== gold on {GOLD_CHECK}; wavefront candidates of 4 regions == the "
        f"region run; log10 likelihood median {np.median(log10):.2f} "
        f"({log10.min():.2f} to {log10.max():.2f}); host clock "
        f"{region_s:.3f} s for the call ({n_ph / region_s:.0f} pairs/s), "
        f"compute_likelihoods' own seconds {ph_res.seconds:.3f} "
        f"({ph_res.gcups:.2f} GCUPS), on {smi}")

    # 4g. the mapper's `ed` stage: 65,536 150 bp reads (W = 5) against the
    # 200 bp windows they were cut from, through edit_distance_semiglobal
    reads_ed, wins = ed_pairs(np.random.default_rng(args.seed + 5), ED_PAIRS)
    zero_counts(*counts, cuda_pairhmm.LAUNCHES, myers.LAUNCHES)
    t0 = time.time()
    ed = myers.edit_distance_semiglobal(reads_ed, wins, device=dev)
    ed_s = time.time() - t0
    launches["myers"] = myers.LAUNCHES["myers"]
    log("4 slice", f"ed launches: {dict(myers.LAUNCHES)}")
    if not launches["myers"]:
        raise AssertionError("the Myers kernel never launched")
    eq, plen, tarr, tlen = myers.encode_batch(reads_ed, wins)
    m_plain = myers.myers_batch_plain(*(torch.from_numpy(a).to(dev) for a in (
        eq.astype(np.int64), plen, tarr, tlen)))
    for g, w in zip(ed, m_plain):
        if not np.array_equal(g, w.cpu().numpy()):
            raise AssertionError("ed: the kernel differs from the plain "
                                 "version on the card")
    for k in gold_idx:
        want = edit_distance_dp(reads_ed[k], wins[k])
        if tuple(int(x[k]) for x in ed) != want:
            raise AssertionError(f"ed pair {k}: {[x[k] for x in ed]} vs the "
                                 f"DP {want}")
    log("4 slice", f"ed on {ED_PAIRS} reads of {REGION_RL} bp (W = "
        f"{eq.shape[2]}) against 200 bp windows: == plain version on the "
        f"card on all (best, end, final), == the plain DP on {GOLD_CHECK}; "
        f"median distance {np.median(ed[0])}, max {ed[0].max()}; host clock "
        f"{ed_s:.3f} s ({ED_PAIRS / ed_s:.0f} reads/s), on {smi}")

    # -- 5. timings at bench.py's shape -----------------------------------
    qn, tn, qln, tln = random_codes(rng, BENCH_B, BENCH_L, BENCH_L, 0.0)
    q, t = torch.from_numpy(qn).to(dev), torch.from_numpy(tn).to(dev)
    ql, tl = torch.from_numpy(qln).to(dev), torch.from_numpy(tln).to(dev)
    Q, T = q.T.contiguous(), t.T.contiguous()
    cells = BENCH_B * BENCH_L * BENCH_L
    # the fullest tracking combination, benchmarks/run_all.py's
    sg = dict(head=SemiGlobalSkip.NONE, tail=SemiGlobalSkip.BOTH)
    tb_res = cuda_align.local_align(q, t, P, with_tb=True)
    g_res = cuda_align.global_align(q, t, ql, tl, PG, with_tb=True)
    s_res = cuda_align.semiglobal_align(q, t, ql, tl, PS, with_tb=True, **sg)
    si0, sj0 = walk_start(AlgoType.SEMI_GLOBAL, sg["tail"], s_res, ql, tl)
    st_local = local_start_args(q, t, ql, tl, cuda_align.local_align(q, t, P))
    st_semi, st_flags = semiglobal_start_args(
        q, t, ql, tl, cuda_align.semiglobal_align(q, t, ql, tl, PS, **sg),
        **sg)
    plains = {
        "local_sw.second": (cuda_align.local_align_second,
                            scan_align_full.local_align_second_batch,
                            (q, t, ql, tl, P), {}),
    }
    walks = {
        "tb_walk": (tb_res.tb, tb_res.score, tb_res.query_end,
                    tb_res.target_end, P),
        "tb_walk.global": (g_res.tb, g_res.score, ql, tl, PG, "global"),
        "tb_walk.semiglobal": (s_res.tb, s_res.score, sj0, si0, PS,
                               "semiglobal", False, False),
    }
    # local_sw's score, end and TB modes as launches alone on their
    # allocated outputs (the score modes on the inputs with the pads
    # already remapped), int32 and 16-bit in turns: A, B, B, A (TB: A, B,
    # C, C, B, A with END and END16), each the mean of its two readings
    Qs, Ts = cuda_align._pads_to_sentinels(Q, 16), cuda_align._pads_to_sentinels(T, 17)
    l_args = {f"local_sw.{m}": cuda_align.local_launch_args(
        m, *((Qs, Ts, P, False) if "score" in m else (Q, T, P, True)))
        for m in ("score", "score16", "end", "end16", "tb")}
    modes = {k: lambda a=a: cuda_align.launch_local(a)
             for k, a in l_args.items()}
    ms = {k: 0.0 for k in modes}
    for group in (("local_sw.score", "local_sw.score16"),
                  ("local_sw.end", "local_sw.end16", "local_sw.tb")):
        for k in group + group[::-1]:
            ms[k] += cuda_ms(modes[k], 5 if k == "local_sw.tb" else 20) / 2
    # semiglobal_start as a launch alone on its laid-out inputs, its
    # ordering by row_count (the argsort, gathers and scatter) included
    sgs_args = cuda_align.semiglobal_start_launch_args(
        st_semi[0].T, st_semi[1].T, *st_semi[2:], **st_flags)
    ms["semiglobal_start"] = cuda_ms(
        lambda: cuda_align.launch_semiglobal_start(sgs_args), 10)
    # local_start the same way: its walk to the extents qr8 / tr8, its
    # ordering by qr8 x tr8 (the key, the argsort, the gathers) included
    ls_args = cuda_align.local_start_launch_args(
        st_local[0].T, st_local[1].T, st_local[2], P, *st_local[4:])
    ms["local_start"] = cuda_ms(
        lambda: cuda_align.launch_local_start(ls_args), 10)
    # global_sw's score and TB modes as launches alone, in turns (A, B, B,
    # A), on the time-major inputs and their allocated outputs
    g_args = {k: cuda_align.global_launch_args(Q, T, ql, tl, PG,
                                               k == "global_sw.tb")
              for k in ("global_sw.score", "global_sw.tb")}
    for k in ("global_sw.score", "global_sw.tb", "global_sw.tb",
              "global_sw.score"):
        ms[k] = ms.get(k, 0.0) + cuda_ms(
            lambda a=g_args[k]: cuda_align.launch_global(a), 5) / 2
    # semiglobal_sw's END and TB modes as launches alone, in turns (A, B,
    # B, A), on the time-major inputs and their allocated outputs, at the
    # rule's threads a pair (cuda_align.split_group)
    s_args = {k: cuda_align.semiglobal_launch_args(
        Q, T, ql, tl, PS, with_tb=k == "semiglobal_sw.tb", **sg)
        for k in ("semiglobal_sw.end", "semiglobal_sw.tb")}
    for k in ("semiglobal_sw.end", "semiglobal_sw.tb", "semiglobal_sw.tb",
              "semiglobal_sw.end"):
        ms[k] = ms.get(k, 0.0) + cuda_ms(
            lambda a=s_args[k]: cuda_align.launch_semiglobal(a), 10) / 2
    # the walks as launches alone on their allocated outputs, in turns (A,
    # B, C, C, B, A)
    walk_lay = {k: tb_walk.walk_launch_args(*a) for k, a in walks.items()}
    for k in (*walks, *reversed(walks)):
        ms[k] = ms.get(k, 0.0) + cuda_ms(
            lambda a=walk_lay[k]: tb_walk.launch_walk(a), 10) / 2
    for k, (kern, _, a, kw) in plains.items():
        ms[k] = cuda_ms(lambda kern=kern, a=a, kw=kw: kern(*a, **kw), 10)
    plain_ms = {
        "local_sw.score": cuda_ms(lambda: local_align_batch(Q.T, T.T, P), 2),
        "local_sw.end": cuda_ms(lambda: local_align_batch(q, t, P), 2),
        "local_sw.score16": cuda_ms(
            lambda: local_align_batch16(Qs.T, Ts.T, P, ends=False), 2),
        "local_sw.end16": cuda_ms(lambda: local_align_batch16(q, t, P), 2),
        "local_sw.tb": cuda_ms(
            lambda: local_align_batch(q, t, P, with_tb=True), 1),
        "global_sw.score": cuda_ms(
            lambda: global_align_batch(q, t, ql, tl, PG), 2),
        "global_sw.tb": cuda_ms(
            lambda: global_align_batch(q, t, ql, tl, PG, with_tb=True), 1),
        "semiglobal_sw.end": cuda_ms(
            lambda: semiglobal_align_batch(q, t, ql, tl, PS, **sg), 2),
        "semiglobal_sw.tb": cuda_ms(
            lambda: semiglobal_align_batch(q, t, ql, tl, PS, with_tb=True,
                                           **sg), 1),
    }
    # KSW from seed scores of BENCH_H0, BANDED at a band of BENCH_BAND
    # tiles; score-only without the N compare (the batch holds no N)
    h0_b = torch.full((BENCH_B,), BENCH_H0, dtype=torch.int32, device=dev)
    ksw_args = (q, t, ql, tl, h0_b, PK)
    band_args = (q, t, ql, tl, PB, BENCH_BAND)
    # ksw_extend's END and SCORE as launches alone on inputs already laid
    # out (SCORE's pads remapped), in the layout the wrapper takes at Lq
    # 152 (shared) and in the global one forced, in turns (A, B, B, A)
    qs_k, ts_k, _ = cuda_align._no_n_inputs(q, t, False)
    ksw_in = {"end": (q, t, True), "score": (qs_k, ts_k, False)}
    ksw_lay = {(m, g): cuda_align.ksw_launch_args(
        m, *ksw_in[m][:2], ql, tl, h0_b, PK, ksw_in[m][2], force_global=g)
        for m in ksw_in for g in (False, True)}
    ksw_ms = dict.fromkeys(ksw_lay, 0.0)
    for m in ksw_in:
        for g in (False, True, True, False):
            ksw_ms[m, g] += cuda_ms(
                lambda a=ksw_lay[m, g]: cuda_align.launch_ksw(a), 10) / 2
    ms["ksw.end"], ms["ksw.score"] = ksw_ms["end", False], ksw_ms["score", False]
    plain_k = ksw_align_batch(*ksw_args)
    for (m, g), a in ksw_lay.items():
        out = cuda_align.launch_ksw(a)
        err[f"ksw.{m}"] = max(err[f"ksw.{m}"], max_abs_err(
            out[:3] if m == "end" else out[:1],
            plain_k[:3] if m == "end" else [plain_k.score]))
    plain_g = global_align_batch(q, t, ql, tl, PG, with_tb=True)
    for k, a in g_args.items():
        score_g, tb_g = cuda_align.launch_global(a)
        err[k] = max(err[k], max_abs_err(
            [score_g] + ([tb_g] if k == "global_sw.tb" else []),
            [plain_g.score] + ([plain_g.tb] if k == "global_sw.tb" else [])))
    del plain_g
    # semiglobal_sw's launches alone: TB's cube word for word, END under
    # all 16 HEAD x TAIL flags, at the timing shape
    plain_s = semiglobal_align_batch(q, t, ql, tl, PS, with_tb=True, **sg)
    err["semiglobal_sw.tb"] = max(err["semiglobal_sw.tb"], max_abs_err(
        cuda_align.launch_semiglobal(s_args["semiglobal_sw.tb"]), plain_s))
    del plain_s
    for head in SKIPS:
        for tail in SKIPS:
            a_ = cuda_align.semiglobal_launch_args(Q, T, ql, tl, PS, head,
                                                   tail)
            err["semiglobal_sw.end"] = max(err["semiglobal_sw.end"], max_abs_err(
                cuda_align.launch_semiglobal(a_)[:3],
                semiglobal_align_batch(q, t, ql, tl, PS, head=head,
                                       tail=tail)[:3]))
    plain_ms["ksw.end"] = plain_ms["ksw.score"] = cuda_ms(
        lambda: ksw_align_batch(*ksw_args), 1)
    # banded_sw's END and SCORE as launches alone on inputs already laid
    # out (SCORE's pads remapped), in turns (A, B, B, A)
    b_args = {"banded_sw.end": cuda_align.banded_launch_args(
        "end", q, t, ql, tl, PB, BENCH_BAND, True),
        "banded_sw.score": cuda_align.banded_launch_args(
        "score", qs_k, ts_k, ql, tl, PB, BENCH_BAND, False)}
    for k in ("banded_sw.end", "banded_sw.score", "banded_sw.score",
              "banded_sw.end"):
        ms[k] = ms.get(k, 0.0) + cuda_ms(
            lambda a=b_args[k]: cuda_align.launch_banded(a), 10) / 2
    plain_b = banded_align_batch(*band_args)
    for k, a in b_args.items():
        plain_ms[k] = cuda_ms(lambda: banded_align_batch(*band_args), 1)
        got = cuda_align.launch_banded(a)
        err[k] = max(err[k], max_abs_err(
            got[:3] if k == "banded_sw.end" else got[:1],
            plain_b[:3] if k == "banded_sw.end" else plain_b[:1]))
    steps, words, walk_out = {}, {}, {}
    for k, a in walks.items():
        plain_ms[k] = cuda_ms(lambda a=a: tb_walk.walk_cigars_plain(*a), 1)
        err[k] = max(err[k], walk_err(tb_walk.launch_walk(walk_lay[k]),
                                      tb_walk.walk_cigars_plain(*a)))
        steps[k], words[k], walk_out[k] = walk_work(*a)
    for k, (kern, plain, a, kw) in plains.items():
        plain_ms[k] = cuda_ms(lambda plain=plain, a=a, kw=kw: plain(*a, **kw),
                              1)
        err[k] = max(err[k], max_abs_err(kern(*a, **kw), plain(*a, **kw)))
    plain16 = local_align_batch16(q, t, P)
    for k in modes:
        if k == "local_sw.tb":   # the cube word for word
            want = local_align_batch(q, t, P, with_tb=True)
        else:
            want = plain16[:1] if "score" in k else plain16[:3]
        err[k] = max(err[k], max_abs_err(modes[k]()[:len(want)], want))
    del want
    # semiglobal_start's launch alone under all 16 HEAD x TAIL flags, fed
    # the semiglobal END kernel's forward result
    plain_ms["semiglobal_start"] = cuda_ms(
        lambda: scan_align_full._semiglobal_start_core(*st_semi, **st_flags),
        1)
    for head in SKIPS:
        for tail in SKIPS:
            fwd = cuda_align.semiglobal_align(q, t, ql, tl, PS, head=head,
                                              tail=tail)
            a_, fl = semiglobal_start_args(q, t, ql, tl, fwd, head, tail)
            got = cuda_align.launch_semiglobal_start(
                cuda_align.semiglobal_start_launch_args(a_[0].T, a_[1].T,
                                                        *a_[2:], **fl))
            err["semiglobal_start"] = max(err["semiglobal_start"], max_abs_err(
                got, scan_align_full._semiglobal_start_core(*a_, **fl)))
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the timing shape: {err}")

    # the work these inputs need: DP cells (walk steps), and the bytes of
    # each input read once and each output written once (scratch carries
    # are not counted)
    covered = {
        "ksw": int(ksw_align_batch(*ksw_args, window_cells=True)[1].sum()),
        "banded": band_cells(qln, tln, BENCH_BAND),
    }
    plain_ms["local_start"] = cuda_ms(
        lambda: scan_align_full._local_start_core(*st_local[:4]), 1)
    col, strip, row = cuda_align.launch_local_start(ls_args)
    err["local_start"] = max(err["local_start"], max_abs_err(
        (col, strip, row), scan_align_full._local_start_core(*st_local[:4])))
    # the columns each pair's walk runs to its stop (its recorded cell
    # lies in the stop's column segment): qr8 a strip, what the inputs
    # need and the kernel runs, and BENCH_L a strip, the full walk
    qr8, tr8 = st_local[4:]
    start_cols = strip.long() * qr8 + col + 1
    start_cols_full = strip.long() * BENCH_L + col + 1
    start_cells = int(start_cols.sum()) * 8
    semi_strips = scan_align_full._semiglobal_start_core(
        *st_semi, **st_flags, count_strips=True)[2]
    semi_cells = int(semi_strips.long().sum()) * 8 * BENCH_L
    # semiglobal_sw END's cells to each pair's extents (columns < qlen,
    # strips to ceil(tlen/8)): all its outputs read (sg has a TAIL)
    sg_cols = torch.from_numpy(qln.astype(np.int64))
    sg_strips = torch.from_numpy((tln.astype(np.int64) + 7) // 8)
    sg_cells = int((sg_cols * sg_strips).sum()) * 8
    seqs = BENCH_B * 2 * BENCH_L          # Q and T, one byte a base
    pp = 4 * BENCH_B                      # one int32 per pair
    cube = (BENCH_L // 8) * BENCH_L * BENCH_B * 4
    work = {   # name: (cells or steps, bytes)
        "local_sw.score": (cells, seqs + pp),
        "local_sw.end": (cells, seqs + 3 * pp),
        "local_sw.score16": (cells, seqs + pp),
        "local_sw.end16": (cells, seqs + 3 * pp),
        "local_sw.tb": (cells, seqs + 3 * pp + cube),
        "global_sw.score": (cells, seqs + 3 * pp),
        "global_sw.tb": (cells, seqs + 3 * pp + cube),
        "semiglobal_sw.end": (sg_cells, seqs + 5 * pp),
        "semiglobal_sw.tb": (cells, seqs + 5 * pp + cube),
        "local_sw.second": (cells, seqs + 8 * pp),
        "local_start": (start_cells, seqs + 6 * pp),
        "semiglobal_start": (semi_cells, seqs + 8 * pp),
        "ksw.end": (covered["ksw"], seqs + 6 * pp),
        "ksw.score": (covered["ksw"], seqs + 4 * pp),
        "banded_sw.end": (covered["banded"], seqs + 5 * pp),
        "banded_sw.score": (covered["banded"], seqs + 3 * pp),
    }
    for k in walks:   # words read, 3 int32 in; the bytes and 3 int32 out
        work[k] = (steps[k], 4 * words[k] + 6 * pp + walk_out[k])
    peak = int32_peak()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("5 timings", f"bound: {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes "
        f"x {nvidia_smi('clocks.max.sm')} = {peak / 1e12:.2f} T int32 op/s; "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")
    bounds = {k: bound(OPS_PER_CELL[k] * u, nb, peak)
              for k, (u, nb) in work.items()}

    def per_cell(k):
        if k.endswith("16"):
            return (f"{OPS_PER_CELL[k]} lane-op per cell: "
                    f"{12 if 'score' in k else 15} op, two cells to a packed "
                    "lane-op")
        return f"{OPS_PER_CELL[k]} op per {'step' if k in steps else 'cell'}"
    for k in ms:
        if k in steps:
            rate = (f"{steps[k] / ms[k] / 1e6:.3f} G steps/s, {steps[k]} "
                    f"steps, {words[k]} words: sector floor "
                    f"{32 * words[k] / HBM_BYTES_PER_S * 1e3:.4f} ms")
        elif k.endswith("_start"):
            rate = f"stops at the start, {work[k][0]} cells"
        elif k.split(".")[0] in ("ksw", "banded_sw"):
            c = covered[k.split(".")[0].split("_")[0]]
            rate = (f"{cells / ms[k] / 1e6:.2f} GCUPS full-matrix "
                    f"equivalent; {c} cells covered, {c / ms[k] / 1e6:.2f} "
                    f"G cells/s")
        else:
            rate = f"{cells / ms[k] / 1e6:.2f} GCUPS"
        log("5 timings", f"{k}: kernel {ms[k]:.4f} ms ({rate}), plain "
            f"{plain_ms[k]:.2f} ms, bound {bounds[k][0]:.4f} ms by "
            f"{bounds[k][1]} ({per_cell(k)}, {work[k][1]} bytes), "
            f"B={BENCH_B} {BENCH_L}x{BENCH_L}, on {smi}")
    # the two kernels redesigned for Hopper beside untouched ones of the
    # same call: each time also as a ratio to local_sw.score (launches
    # alone); ptxas's resources of each of their entry points
    loc = ms["local_sw.score"]
    threads = cuda_align.ksw_layout(BENCH_L)[1]
    log("5 timings", "ksw_extend, launches alone in turns at B="
        f"{BENCH_B} {BENCH_L}x{BENCH_L}, h0 {BENCH_H0}: " + ", ".join(
            f"{m} {'global, 128 threads' if g else f'shared, {threads} threads'}"
            f" {v:.4f} ms ({v / loc:.3f}x local_sw.score)"
            for (m, g), v in ksw_ms.items())
        + f"; shared rows {9 * (BENCH_L + 1) * threads} bytes a block; on {smi}")
    log("5 timings", f"global_sw, launches alone in turns: tb "
        f"{ms['global_sw.tb']:.4f} ms = {ms['global_sw.tb'] / ms['global_sw.score']:.3f}"
        f"x score {ms['global_sw.score']:.4f} ms; score = "
        f"{ms['global_sw.score'] / loc:.3f}x local_sw.score {loc:.4f} ms; "
        f"semiglobal_sw.tb (NONE/BOTH, wrapper) {ms['semiglobal_sw.tb']:.4f} "
        f"ms; on {smi}")
    log("5 timings", f"local_sw, launches alone in turns: tb "
        f"{ms['local_sw.tb']:.4f} ms = {ms['local_sw.tb'] / ms['local_sw.end']:.3f}"
        f"x end {ms['local_sw.end']:.4f} ms; on {smi}")
    # the lanes' share of each kernel's work over what its warps run, in
    # the order the pairs come in and in the order the wrapper launches
    # them: semiglobal_start's strips (from the plain version; by
    # row_count), local_start's columns to the stop (from the kernel's
    # stop; by qr8 x tr8, the candidate keys beside it; G threads a pair,
    # so 32 / G pairs a warp) and banded_sw's band tiles (launched in the
    # pairs' order; ordered by band tiles beside it)
    by = lambda key: torch.argsort(key, descending=True)
    wp = sg_wp = 32 // cuda_align.split_group(BENCH_B, sms)
    ls_share = lambda key: lane_share(
        start_cols if key is None else start_cols[by(key)], wp)
    b_tiles = torch.from_numpy(band_windows(qln, tln, BENCH_BAND).sum(1))
    log("5 timings", f"lanes' share of the work: semiglobal_start "
        f"{lane_share(semi_strips):.4f} in the pairs' order, "
        f"{lane_share(semi_strips[torch.argsort(st_semi[5])]):.4f} as "
        f"launched ({int(semi_strips.sum())} strips); semiglobal_sw END's "
        f"column-strips to the extents at {sg_wp} pairs a warp "
        f"{lane_share(sg_cols * sg_strips, sg_wp):.4f} in the pairs' order, "
        f"as launched ({sg_cells} cells of {cells}: "
        f"{sg_cells / cells:.4f}); local_start, "
        f"{wp} pairs a warp, {ls_share(None):.4f} in the pairs' order, "
        f"{ls_share(qr8 * tr8):.4f} as launched (by qr8 x tr8; by tr8 "
        f"{ls_share(tr8):.4f}, by the forward score "
        f"{ls_share(st_local[2]):.4f}, by the true stop "
        f"{ls_share(start_cols):.4f}; at 32 pairs a warp "
        f"{lane_share(start_cols):.4f} and "
        f"{lane_share(start_cols[by(qr8 * tr8)]):.4f}; "
        f"{int(start_cols.sum())} columns to the stop at qr8 a strip, "
        f"{int(start_cols_full.sum())} at {BENCH_L} a strip, the first "
        f"design's walk); banded_sw {lane_share(b_tiles):.4f} in the "
        f"pairs' order, as launched ({lane_share(b_tiles[by(b_tiles)]):.4f} "
        f"were they ordered by band tiles; {int(b_tiles.sum())} band "
        f"tiles); B={BENCH_B} "
        f"{BENCH_L}x{BENCH_L}")
    from tools.sass_report import kernel_of, ptxas_lines
    for name in ("ksw_extend", "global_sw", "local_sw", "semiglobal_sw",
                 "semiglobal_start", "local_start", "banded_sw"):
        log_text = (_build.BUILD_DIR / f"{name}.log").read_text()
        for fn, line in ptxas_lines(log_text).items():
            log("5 timings", f"ptxas {name}.cu {kernel_of(fn)}: {line}")
    # the four score / end modes over launch sizes at the engine's 216 x 328
    # bucket (the align CLI's 5,000-pair chunks, test_prog's
    # STREAM_BATCH_SIZE, give it about 4,150 pairs), then at the engine's
    # own launches over the 20,000 pairs of phase 4; launches alone, in
    # turns (A, B, B, A).  SCORE16 may be the scores' default only if it is
    # nowhere slower than SCORE here
    sw_rng = np.random.default_rng(args.seed + 7)
    sweep = {}
    engine_shapes = sorted((c, lq, lt) for (lq, lt), c in per_bucket.items())
    for shape in [(Bs, 216, 328) for Bs in SWEEP_B] + engine_shapes:
        qn, tn, _, _ = random_codes(sw_rng, *shape, 0.0)
        Qc, Tc = (torch.from_numpy(x.T.copy()).to(dev) for x in (qn, tn))
        Qcs, Tcs = (cuda_align._pads_to_sentinels(x, c)
                    for x, c in ((Qc, 16), (Tc, 17)))
        got = sweep[shape] = dict.fromkeys(("score", "score16", "end",
                                            "end16"), 0.0)
        for m in ("score", "score16", "score16", "score", "end", "end16",
                  "end16", "end"):
            a, b = (Qcs, Tcs) if "score" in m else (Qc, Tc)
            got[m] += cuda_ms(lambda m=m, a=a, b=b: cuda_align._launch(
                m, a, b, P, "score" not in m), 5) / 2
        log("5 timings", f"local_sw at B={shape[0]} {shape[1]}x{shape[2]}"
            f"{' (an engine launch)' if shape in engine_shapes else ''} "
            "(launches alone, in turns): " + ", ".join(
                f"{m} {v:.4f} ms" for m, v in got.items())
            + f"; END16 / END {got['end16'] / got['end']:.3f}, SCORE16 / "
            f"SCORE {got['score16'] / got['score']:.3f}, on {smi}")
    ratio16 = {s_: v["score16"] / v["score"] for s_, v in sweep.items()}
    slower = {s_[0]: round(r, 3) for s_, r in ratio16.items() if r > 1.0}
    faster16 = [Bs for Bs in SWEEP_B if all(
        sweep[b, 216, 328]["end16"] < sweep[b, 216, 328]["end"]
        for b in SWEEP_B if b >= Bs)]
    log("5 timings", f"SCORE16 / SCORE over the sweep and the engine's "
        f"launches: {min(ratio16.values()):.3f}-{max(ratio16.values()):.3f}; "
        f"SCORE16 slower at {slower or 'no size'}; END16 faster than END "
        f"from B={faster16[0] if faster16 else None} of the sweep on, on "
        f"{smi}")
    # local_start and banded_sw at the engine's own launches: each bucket
    # of phase 4's 20,000 pairs as one launch holds them, fed (local_start)
    # the END kernel's forward result; launches alone (local_start's
    # ordering included), held to the plain versions, beside their bounds
    # and lanes' shares
    for (lq, lt), arrays in engine_batches(qs, ts).items():
        eq, et, eql, etl = (torch.from_numpy(x).to(dev) for x in arrays)
        n_b = eq.shape[0]
        ea = local_start_args(eq, et, eql, etl, cuda_align.local_align(eq, et, P))
        e_args = cuda_align.local_start_launch_args(ea[0].T, ea[1].T, ea[2], P,
                                                    *ea[4:])
        e_ms = cuda_ms(lambda: cuda_align.launch_local_start(e_args), 20)
        got = cuda_align.launch_local_start(e_args)
        err["local_start"] = max(err["local_start"], max_abs_err(
            got, scan_align_full._local_start_core(*ea[:4])))
        cols = got[1].long() * ea[4] + got[0] + 1
        wp_e = 32 // cuda_align.split_group(n_b, sms)
        e_bound = bound(OPS_PER_CELL["local_start"] * 8 * int(cols.sum()),
                        n_b * (lq + lt + 6 * 4), peak)
        log("5 timings", f"local_start at an engine launch, B={n_b} "
            f"{lq}x{lt}: kernel {e_ms:.4f} ms (ordering included), bound "
            f"{e_bound[0]:.4f} ms by {e_bound[1]}, lanes' share at {wp_e} "
            f"pairs a warp {lane_share(cols, wp_e):.4f} in the pairs' order, "
            f"{lane_share(cols[by(ea[4] * ea[5])], wp_e):.4f} as launched; "
            f"on {smi}")
        # SCORE drops the N compare only where the launch holds no N
        eqs, ets, e_n = cuda_align._no_n_inputs(eq, et,
                                                has_ns(eq, et, eql, etl))
        plain_e = banded_align_batch(eq, et, eql, etl, PB, BENCH_BAND)
        tiles_e = torch.from_numpy(band_windows(*arrays[2:], BENCH_BAND)
                                   .sum(1))
        for k, a in (("banded_sw.end", cuda_align.banded_launch_args(
                "end", eq, et, eql, etl, PB, BENCH_BAND, True)),
                ("banded_sw.score", cuda_align.banded_launch_args(
                    "score", eqs, ets, eql, etl, PB, BENCH_BAND, e_n))):
            b_ms = cuda_ms(lambda a=a: cuda_align.launch_banded(a), 20)
            got = cuda_align.launch_banded(a)
            n_out = 3 if k == "banded_sw.end" else 1
            err[k] = max(err[k], max_abs_err(got[:n_out], plain_e[:n_out]))
            b_bound = bound(OPS_PER_CELL[k] * 64 * int(tiles_e.sum()),
                            n_b * (lq + lt + 4 * (2 + n_out)), peak)
            log("5 timings", f"{k} at an engine launch, B={n_b} {lq}x{lt}, "
                f"band {BENCH_BAND}: kernel {b_ms:.4f} ms (the launch "
                f"alone), bound {b_bound[0]:.4f} ms by {b_bound[1]}, "
                f"lanes' share {lane_share(tiles_e):.4f} in the pairs' "
                f"order, as launched ({lane_share(tiles_e[by(tiles_e)]):.4f}"
                f" were they ordered by band tiles); on {smi}")
        # semiglobal_sw END and TB under glocal's skips (TARGET/TARGET)
        # at the rule's threads a pair, launches alone in turns (A, B, B,
        # A), held to the plain version (TB's cube word for word); END's
        # bound counted at the pairs' extents, TB's over every cell
        gl = dict(head=SemiGlobalSkip.TARGET, tail=SemiGlobalSkip.TARGET)
        eQ, eT = eq.T.contiguous(), et.T.contiguous()
        g_s = cuda_align.split_group(n_b, sms)
        ext_e = eql.long().cpu() * ((etl.long().cpu() + 7) // 8)
        s_e = {k: cuda_align.semiglobal_launch_args(
            eQ, eT, eql, etl, PS, with_tb=k == "semiglobal_sw.tb", **gl)
            for k in ("semiglobal_sw.end", "semiglobal_sw.tb")}
        s_ms = dict.fromkeys(s_e, 0.0)
        for k in (*s_e, *reversed(s_e)):
            s_ms[k] += cuda_ms(lambda a=s_e[k]: cuda_align.launch_semiglobal(a),
                               20) / 2
        want_s = semiglobal_align_batch(eq, et, eql, etl, PS, with_tb=True,
                                        **gl)
        for k, a in s_e.items():
            n_out = 4 if k == "semiglobal_sw.tb" else 3
            err[k] = max(err[k], max_abs_err(
                cuda_align.launch_semiglobal(a)[:n_out], want_s[:n_out]))
        del want_s
        cube_e = 4 * (lt // 8) * lq * n_b
        s_b = {"semiglobal_sw.end": bound(
            OPS_PER_CELL["semiglobal_sw.end"] * 8 * int(ext_e.sum()),
            n_b * (lq + lt + 5 * 4), peak),
            "semiglobal_sw.tb": bound(
            OPS_PER_CELL["semiglobal_sw.tb"] * n_b * lq * lt,
            n_b * (lq + lt + 5 * 4) + cube_e, peak)}
        log("5 timings", f"semiglobal_sw at an engine launch, B={n_b} "
            f"{lq}x{lt}, TARGET/TARGET, {g_s} threads a pair (launches "
            "alone, in turns): " + ", ".join(
                f"{k.split('.')[1].upper()} {s_ms[k]:.4f} ms (bound "
                f"{s_b[k][0]:.4f} ms by {s_b[k][1]})" for k in s_e)
            + f"; END's lanes' share of the column-strips to the extents "
            f"{lane_share(ext_e, 32 // g_s):.4f} in the pairs' order "
            f"({int(ext_e.sum())} of {n_b * lq * (lt // 8)}); on {smi}")
        # local_sw's SCORE16 / END16 beside the int32 SCORE / END on the
        # same launch (SCORE's pads remapped, no N compare), in turns (A,
        # B, B, A), each held to the plain int16 version
        eQs, eTs = (cuda_align._pads_to_sentinels(x, c) for x, c in ((eQ, 16),
                                                                   (eT, 17)))
        l_e = {m: cuda_align.local_launch_args(
            m, *((eQs, eTs, P, False) if "score" in m else (eQ, eT, P, True)))
            for m in ("score", "score16", "end", "end16")}
        l_ms = dict.fromkeys(l_e, 0.0)
        for m in ("score", "score16", "score16", "score", "end", "end16",
                  "end16", "end"):
            l_ms[m] += cuda_ms(lambda a=l_e[m]: cuda_align.launch_local(a),
                               20) / 2
        want_l = {"score": local_align_batch16(eQs.T, eTs.T, P,
                                               ends=False)[:1],
                  "end": local_align_batch16(eq, et, P)[:3]}
        for m, a in l_e.items():
            if m.endswith("16"):
                key = f"local_sw.{m}"
                want = want_l[m[:-2]]
                err[key] = max(err[key], max_abs_err(
                    cuda_align.launch_local(a)[:len(want)], want))
        l_b = {m: bound(OPS_PER_CELL[f"local_sw.{m}"] * n_b * lq * lt,
                        n_b * (lq + lt + 4 * (1 if "score" in m else 3)),
                        peak)[0] for m in ("score16", "end16")}
        log("5 timings", f"local_sw at an engine launch, B={n_b} {lq}x{lt}, "
            f"{cuda_align.split_group((n_b + 1) // 2, sms)} "
            "threads per two pairs (launches alone, in turns): " + ", ".join(
                f"{m} {v:.4f} ms" for m, v in l_ms.items())
            + f"; SCORE16 / SCORE {l_ms['score16'] / l_ms['score']:.3f}, "
            f"END16 / END {l_ms['end16'] / l_ms['end']:.3f}; bounds SCORE16 "
            f"{l_b['score16']:.4f} ms, END16 {l_b['end16']:.4f} ms; on {smi}")
        # the walk at this launch: LOCAL, GLOBAL and glocal (TARGET/TARGET)
        # on the TB kernels' cubes, launches alone in turns (A, B, C, C, B,
        # A), held to the plain version, beside the bound (the bytes: the
        # words the walk needs, 3 int32 in, the CIGAR bytes and 3 int32
        # out) and the sector floor (32 bytes a word)
        r_l = cuda_align.local_align(eq, et, P, with_tb=True)
        r_g = cuda_align.global_align(eq, et, eql, etl, PG, with_tb=True)
        r_s = cuda_align.semiglobal_align(eq, et, eql, etl, PS, with_tb=True,
                                          **gl)
        ei0, ej0 = walk_start(AlgoType.SEMI_GLOBAL, gl["tail"], r_s, eql, etl)
        e_walks = {
            "tb_walk": (r_l.tb, r_l.score, r_l.query_end, r_l.target_end, P),
            "tb_walk.global": (r_g.tb, r_g.score, eql, etl, PG, "global"),
            "tb_walk.semiglobal": (r_s.tb, r_s.score, ej0, ei0, PS,
                                   "semiglobal", False, True)}
        e_lay = {k: tb_walk.walk_launch_args(*a) for k, a in e_walks.items()}
        w_ms = dict.fromkeys(e_walks, 0.0)
        for k in (*e_walks, *reversed(e_walks)):
            w_ms[k] += cuda_ms(lambda a=e_lay[k]: tb_walk.launch_walk(a),
                               20) / 2
        parts = []
        for k, a in e_walks.items():
            err[k] = max(err[k], walk_err(tb_walk.launch_walk(e_lay[k]),
                                          tb_walk.walk_cigars_plain(*a)))
            st, wd, nb = walk_work(*a)
            wb = bound(OPS_PER_CELL[k] * st, 4 * wd + 6 * 4 * n_b + nb, peak)
            parts.append(f"{k} {w_ms[k]:.4f} ms (bound {wb[0]:.4f} ms by "
                         f"{wb[1]}, sector floor "
                         f"{32 * wd / HBM_BYTES_PER_S * 1e3:.4f} ms, {st} "
                         f"steps)")
        del e_lay, e_walks, r_l, r_g, r_s
        log("5 timings", f"walk at an engine launch, B={n_b} {lq}x{lt}: "
            + "; ".join(parts) + f"; == plain; on {smi}")
    log("5 timings", "engine, " + "; ".join(
        f"{k} {v:.3f} s ({n / v:.0f} pairs/s)" for k, v in secs.items())
        + f", {n} pairs, host clock, on {smi}")

    # PairHMM at run_all.py:145's data (B = 16,384 full 128 x 128 pairs of
    # random bytes 65-84, quals 5-59) and at the launches the paths make
    # (pairhmm_timing_launches); Myers at run_all.py:222's (B = 16,384 full
    # patterns of 96 and texts of 152, W = 3)
    ph_launches = pairhmm_timing_launches(dev, flat, args.seed)
    t5, p5, _ = next(iter(ph_launches.values()))
    W5 = (MY_LP + 31) // 32
    r5 = np.random.default_rng(0)
    pats = r5.integers(0, 4, (MY_B, MY_LP)).astype(np.uint8)
    m5 = [myers.build_eq_masks(pats, np.full(MY_B, MY_LP, np.int32), W5),
          np.full(MY_B, MY_LP, np.int32),
          r5.integers(0, 4, (MY_B, MY_LT)).astype(np.uint8),
          np.full(MY_B, MY_LT, np.int32)]
    m5 = [torch.from_numpy(a).to(dev) for a in m5]
    # `ms` is the launch alone, on inputs already in the kernel's layout;
    # `wrapper_ms` adds the wrapper (its checks, views and allocations)
    # around it
    launch_only = {
        "pairhmm.intertask": (cuda_pairhmm.launch_intertask,
                              cuda_pairhmm.intertask_layout(*t5, p5)),
        "pairhmm.wavefront": (cuda_pairhmm.launch_wavefront,
                              cuda_pairhmm.wavefront_layout(*t5, p5)),
        "myers": (myers.launch_myers, myers.myers_layout(*m5)),
    }
    wrapper_ms = {}
    for k, (launch, lay) in launch_only.items():
        ms[k] = cuda_ms(lambda launch=launch, lay=lay: launch(lay), 50)
    # Myers' launch takes less time on the card than its making on the
    # host: replayed from a CUDA graph
    ms["myers"] = graph_ms(lambda: myers.launch_myers(launch_only["myers"][1]),
                           50)
    for k, fn in kernels_ph.items():
        wrapper_ms[k] = cuda_ms(lambda fn=fn: fn(*t5, p5), 50)
    wrapper_ms["myers"] = cuda_ms(lambda: myers.myers_batch(*m5), 50)
    plain_ms["pairhmm.intertask"] = plain_ms["pairhmm.wavefront"] = cuda_ms(
        lambda: scan_pairhmm.forward_prepared(*t5, p5), 1)
    plain_ms["myers"] = cuda_ms(lambda: myers.myers_batch_plain(*m5), 1)
    plain5 = scan_pairhmm.forward_prepared(*t5, p5)
    for k, fn in kernels_ph.items():
        err[k] = max(err[k], float_err([fn(*t5, p5)], [plain5]),
                     float_err([launch_only[k][0](launch_only[k][1])],
                               [plain5]))
    plain_my = myers.myers_batch_plain(*m5)
    err["myers"] = max(err["myers"],
                       max_abs_err(myers.myers_batch(*m5), plain_my),
                       max_abs_err(myers.launch_myers(launch_only["myers"][1]),
                                   plain_my))
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the timing shape: {err}")
    # the work: PairHMM's cells (every pair full length) at 8 f32 ops; its
    # bytes the raw reads and haps, the five [B, R] f32 params, the lengths
    # and the output; Myers' active text steps at W words each, its bytes
    # the eq masks (4W words), the texts, the lengths and three outputs
    f_peak = fp32_peak()
    ph_cells = PH_B * PH_L * PH_L
    ph_bytes = PH_B * (2 * PH_L + 5 * 4 * PH_L + 3 * 4)
    my_steps = int(((m5[2] != 255) & (torch.arange(MY_LT, device=dev)[None, :]
                                      < m5[3][:, None])).sum())
    my_ops = my_steps * (W5 * MYERS_OPS_PER_WORD + MYERS_OPS_PER_STEP)
    my_bytes = MY_B * (16 * W5 + MY_LT + 2 * 4 + 3 * 4)
    for k in kernels_ph:
        bounds[k] = bound(F32_OPS_PER_CELL * ph_cells, ph_bytes, f_peak)
    bounds["myers"] = bound(my_ops, my_bytes, peak)
    log("5 timings", f"f32 bound: {sms} SMs x {FP32_LANES_PER_SM} FP32 lanes "
        f"x {nvidia_smi('clocks.max.sm')} = {f_peak / 1e12:.2f} T f32 op/s")
    for k in kernels_ph:
        log("5 timings", f"{k}: kernel {ms[k]:.4f} ms "
            f"({ph_cells / ms[k] / 1e6:.2f} GCUPS; the wrapper with its "
            f"layout passes {wrapper_ms[k]:.4f} ms), plain "
            f"{plain_ms[k]:.2f} ms, bound {bounds[k][0]:.4f} ms"
            f" by {bounds[k][1]} ({F32_OPS_PER_CELL} f32 op per cell, "
            f"{ph_bytes} bytes), B={PH_B} {PH_L}x{PH_L}, on {smi}")
    # PairHMM at each launch of pairhmm_timing_launches, launches alone on
    # their layouts (the rule's group, rows a lane and handover), in turns,
    # each held to the plain version; the bound of the launch's cells at 8
    # f32 ops, and the serial steps of a full-length pair's chain
    for label, (t, p, kern) in ph_launches.items():
        B, R = t[0].shape
        C = t[1].shape[1]
        cells = int((t[2].long() * t[3].long()).sum())
        b_ms, b_by = bound(F32_OPS_PER_CELL * cells,
                           B * (R + C + 5 * 4 * R + 3 * 4), f_peak)
        layout_of = {"pairhmm.intertask": cuda_pairhmm.intertask_layout,
                     "pairhmm.wavefront": cuda_pairhmm.wavefront_layout}
        lays = {k: layout_of[k](*t, p) for k in kern}
        runs = {k: functools.partial(launch_only[k][0], lays[k])
                for k in kern}
        want = scan_pairhmm.forward_prepared(*t, p)
        for k, run in runs.items():
            err[k] = max(err[k], float_err([run()], [want]))
        reps = 10 if B * R * C > 1e9 else 50
        t_ms = {k: 0.0 for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            t_ms[k] += cuda_ms(runs[k], reps) / 2
        shape = {k: (lays[k][:2] if k == "pairhmm.intertask"
                     else (32, lays[k][0])) for k in kern}
        log("5 timings", f"PairHMM {label}: " + "; ".join(
            f"{k} {v:.4f} ms ({v / b_ms:.2f}x the bound; {shape[k][0]} "
            f"lanes a pair x {shape[k][1]} rows, handover "
            f"{cuda_pairhmm.handover_layout(R, C, *shape[k])}, "
            f"{pairhmm_steps(*shape[k], R, C)} serial steps a pair)"
            for k, v in t_ms.items())
            + f"; bound {b_ms:.6f} ms by {b_by} ({cells} cells x "
            f"{F32_OPS_PER_CELL} f32 op), == plain; on {smi}")
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the timed launches: {err}")
    log("5 timings", f"myers: kernel {ms['myers']:.4f} ms "
        f"({MY_B * MY_LP * MY_LT / ms['myers'] / 1e6:.2f} GCUPS as "
        f"run_all.py counts B.Lp.Lt; the wrapper, host included, "
        f"{wrapper_ms['myers']:.4f} ms), plain {plain_ms['myers']:.2f} ms, "
        f"bound {bounds['myers'][0]:.4f} ms by {bounds['myers'][1]} "
        f"({MYERS_OPS_PER_WORD} int op per word-step x W={W5} + "
        f"{MYERS_OPS_PER_STEP} per step, {my_steps} steps, {my_bytes} "
        f"bytes), B={MY_B} Lp {MY_LP} Lt {MY_LT}, on {smi}")

    # Myers at the `ed` stage's launch: phase 4's 65,536 reads against
    # their 200 bp windows (W = 5), the uint32 masks as
    # edit_distance_semiglobal passes them; the launch alone, the wrapper
    # and the plain version, held to it
    ed_in = [torch.from_numpy(a).to(dev)
             for a in myers.encode_batch(reads_ed, wins)]
    ed_lay = myers.myers_layout(*ed_in)
    ed_ms = graph_ms(lambda: myers.launch_myers(ed_lay), 50)
    ed_wrap = cuda_ms(lambda: myers.myers_batch(*ed_in), 50)
    ed_plain = cuda_ms(lambda: myers.myers_batch_plain(*ed_in), 1)
    err["myers"] = max(err["myers"], max_abs_err(
        myers.launch_myers(ed_lay), myers.myers_batch_plain(*ed_in)))
    B_ed, Lt_ed = ed_in[2].shape
    W_ed = ed_in[0].shape[2]
    ed_steps = int(((ed_in[2] != 255) & (torch.arange(Lt_ed, device=dev)[
        None, :] < ed_in[3][:, None])).sum())
    ed_bound = bound(ed_steps * (W_ed * MYERS_OPS_PER_WORD
                                 + MYERS_OPS_PER_STEP),
                     B_ed * (16 * W_ed + Lt_ed + 2 * 4 + 3 * 4), peak)
    if err["myers"]:
        raise AssertionError(f"Myers disagrees with its plain version at the "
                             f"ed launch: {err['myers']}")
    log("5 timings", f"myers at the ed launch, B={B_ed} W={W_ed} Lt "
        f"{Lt_ed}: kernel {ed_ms:.4f} ms (the wrapper {ed_wrap:.4f} ms), "
        f"plain {ed_plain:.2f} ms, bound {ed_bound[0]:.4f} ms by "
        f"{ed_bound[1]} ({ed_steps} steps), == plain; on {smi}")

    # the NW, SW and MSA apps: their kernels at the edges, the apps end to
    # end, their times (phases 3-5 of the apps)
    t_apps = time.time()
    app_rows = apps(args.seed, dev, smi, peak)
    # the mapper slice: fm_search at its edges, the mapper's paths end to
    # end, fm_search's times (phases 3-5 of the mapper)
    t_mapper = time.time()
    fm_row, sams = mapper_slice(args.seed, dev, smi, peak)
    # the clustering slice: both LCS kernels at their edges, cluster_reads
    # and cluster_distributed end to end, the kernels' times (phases 3-5
    # of clustering)
    t_cluster = time.time()
    lcs_rows = cluster_slice(args.seed, dev, smi, peak)
    # the distributed slice: the pipeline step, the sharded scores, nGIA's
    # and MSA's mesh paths over NCCL at world size 1, then two gloo ranks
    t_dist = time.time()
    dist_launches = dist_slice(args.seed, dev, smi)
    # the tools: the corrector, local assembly, alndiff and their CLIs
    t_tools = time.time()
    tools_launches = tools_slice(args.seed, dev, smi, sams)
    sams["dir"].cleanup()
    t_end = time.time()
    log("6 wall", f"{t_end - t_start:.1f} s in all: the build and the "
        f"engine, PairHMM and Myers phases {t_apps - t_start:.1f} s, the "
        f"apps {t_mapper - t_apps:.1f} s, the mapper "
        f"{t_cluster - t_mapper:.1f} s, clustering {t_dist - t_cluster:.1f}"
        f" s, the distributed slice {t_tools - t_dist:.1f} s, the tools "
        f"{t_end - t_tools:.1f} s; the pipeline step's launches "
        f"{dist_launches}, local_assembly's {tools_launches}")

    src = "genomics_tpu_torch/csrc/"
    rows = [
        ("local_sw.score", "local_sw.cu",
         "genomics_tpu/ops/pallas_align.py:482"),
        ("local_sw.end", "local_sw.cu",
         "genomics_tpu/ops/pallas_align.py:221"),
        ("local_sw.tb", "local_sw.cu",
         "genomics_tpu/ops/pallas_align.py:717"),
        ("tb_walk", "tb_walk.cu", "genomics_tpu/ops/tb_walk.py:29"),
        ("global_sw.score", "global_sw.cu",
         "genomics_tpu/ops/pallas_gs.py:65"),
        ("global_sw.tb", "global_sw.cu",
         "genomics_tpu/ops/pallas_align.py:1201"),
        ("semiglobal_sw.end", "semiglobal_sw.cu",
         "genomics_tpu/ops/pallas_gs.py:181"),
        ("semiglobal_sw.tb", "semiglobal_sw.cu",
         "genomics_tpu/ops/pallas_align.py:1325"),
        ("tb_walk.global", "tb_walk.cu", "genomics_tpu/ops/tb_walk.py:29"),
        ("tb_walk.semiglobal", "tb_walk.cu", "native/cigar.cpp:32"),
        ("local_sw.second", "local_sw.cu",
         "genomics_tpu/ops/pallas_align.py:321"),
        ("local_sw.score16", "local_sw.cu",
         "genomics_tpu/ops/pallas_align.py:557"),
        ("local_sw.end16", "local_sw.cu",
         "genomics_tpu/ops/pallas_align.py:636"),
        ("local_start", "local_start.cu",
         "genomics_tpu/ops/pallas_align.py:1515"),
        ("semiglobal_start", "semiglobal_start.cu",
         "genomics_tpu/ops/pallas_gs.py:364"),
        ("ksw.end", "ksw_extend.cu", "genomics_tpu/ops/pallas_ksw.py:188"),
        ("ksw.score", "ksw_extend.cu", "genomics_tpu/ops/pallas_ksw.py:188"),
        ("banded_sw.end", "banded_sw.cu",
         "genomics_tpu/ops/pallas_ksw.py:453"),
        ("banded_sw.score", "banded_sw.cu",
         "genomics_tpu/ops/pallas_ksw.py:453"),
        # both PairHMM entry points (pairhmm_intertask.cu,
        # pairhmm_wavefront.cu) only instantiate pairhmm.cuh's template,
        # which holds all of the kernels' arithmetic
        ("pairhmm.intertask", "pairhmm.cuh",
         "genomics_tpu/ops/pallas_pairhmm.py:208"),
        ("pairhmm.wavefront", "pairhmm.cuh",
         "genomics_tpu/ops/pallas_pairhmm.py:140"),
        ("myers", "myers.cu", "genomics_tpu/ops/myers.py:161"),
    ]
    left = child_pids()
    if left:
        raise AssertionError(f"child processes still running: {left}")
    # no single PyTorch call computes these recurrences, a backward
    # search or a bit-parallel LCS: library_ms null; the window filters'
    # is torch._int_mm of their indicators
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + f,
         "replaces": rep, "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, f, rep in rows] + [
        {"name": name, "route": "cuda", "source": src + f, "replaces": rep,
         **app_rows[name], "library_ms": None}
        for name, f, rep in APP_ROWS] + [
        {"name": "fm_search", "route": "cuda", "source": src + "fm_search.cu",
         "replaces": "genomics_tpu/ops/fm_search.py:121", **fm_row,
         "library_ms": None}] + [
        {"name": name, "route": "cuda", "source": src + f"{name}.cu",
         "replaces": rep, **lcs_rows[name], "library_ms": None}
        for name, rep in LCS_ROWS] + [
        {"name": "cluster_filter", "route": "cuda",
         "source": src + "cluster_filter.cu",
         "replaces": "genomics_tpu/models/cluster.py:408",
         **lcs_rows["cluster_filter"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
