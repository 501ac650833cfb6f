#!/usr/bin/env python3
"""Drive the PyTorch port's alignment paths once on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of a checkout.  Phases, one line each:

1. device   the card (nvidia-smi name and power limit), torch and CUDA;
2. build    nvcc builds every kernel from csrc/, one nvcc per source,
            all started together;
3. parity   each kernel against its plain PyTorch version on the card,
            integer-equal: B=4096+37 at 152x152 (ACGT only; LOCAL, KSW
            and BANDED score-only with has_n True and False) and B=1000
            in the 216x328 bucket with Ns: local_sw SCORE/END/TB/SECOND,
            global_sw SCORE/TB, semiglobal_sw END for all 16 HEAD x TAIL
            and TB for NONE/NONE, TARGET/TARGET, QUERY/QUERY and
            BOTH/BOTH, the LOCAL, GLOBAL and SEMI_GLOBAL walks,
            local_start fed the END kernel's result, semiglobal_start for
            all 16 HEAD x TAIL fed the semiglobal END kernel's, ksw_extend
            END/SCORE with seed scores h0 of 0-60, and banded_sw
            END/SCORE at bands of 1, 2 and 4 tiles;
4. slice    20,000 GASAL2-shaped pairs (150 bp reads cut from 200-300 bp
            targets, ~2% substitutions, ~0.5% 1-3 bp indels, a few Ns)
            through AlignEngine(device="cuda"), every kernel's launch
            count set to 0 just before and read just after each path:
            LOCAL with traceback, ends only and score-only; then GLOBAL
            and SEMI_GLOBAL glocal (head=tail=TARGET), each with and
            without traceback; then the start passes (LOCAL, glocal and
            SEMI_GLOBAL NONE/BOTH compute_start) and LOCAL second_best
            with and without traceback; then KSW on 20,000 bwa-mem-style
            seed extensions (the read past a 19-31 bp seed against the
            reference past it, h0 = seed length x match, ~10% unrelated
            targets) and BANDED (band of 4 tiles) on the GASAL2-shaped
            pairs, each with ends and score-only.  Checked against the
            CPU engine (every field, CIGAR bytes included) and the
            pure-Python golds, plus one GLOBAL run with
            models/assembly.py's scoring;
5. timings  each kernel and its plain version on the card at bench.py's
            shape (B=65,536, 152x152; KSW with h0 = 30, BANDED with a band
            of 4 tiles, as benchmarks/run_all.py runs them), the least
            time the card could take for the same work (the bound; see
            `bound`), and the engine's pairs/s.

Then one JSON line with the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  With --profile, phases 3-5 give way to
one line per engine path over the 20,000 pairs: wall, device busy time
and per-kernel device time (torch.profiler), and the host functions with
the most self time (cProfile).  Any failure exits non-zero before the
last line.  Needs one CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_B, BENCH_L = 65536, 152
BENCH_H0, BENCH_BAND = 30, 4   # benchmarks/run_all.py's ksw h0 and band
PAIRS = 20000  # GASAL2's test program aligns 20,000 reads
CPU_CHECK = 1024  # pairs of each traceback run held to the CPU engine
GOLD_CHECK = 64   # pairs held to the pure-Python gold
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
INT32_LANES_PER_SM = 64    # Hopper's INT32 lanes per SM per clock
KERNEL_SOURCES = ("local_sw", "global_sw", "semiglobal_sw", "local_start",
                  "semiglobal_start", "ksw_extend", "banded_sw", "tb_walk")
# Integer operations per DP cell (per walk step for the walks), one per
# add, max, compare or select, as each kernel's source counts them; the
# score kernels as timed (has_n=False).
OPS_PER_CELL = {
    "local_sw.score": 12, "local_sw.end": 15, "local_sw.tb": 25,
    "local_sw.second": 20, "local_start": 15,
    "global_sw.score": 10, "global_sw.tb": 20,
    "semiglobal_sw.end": 14, "semiglobal_sw.tb": 24, "semiglobal_start": 14,
    "tb_walk": 25, "tb_walk.global": 25, "tb_walk.semiglobal": 25,
    "ksw.end": 24, "ksw.score": 19,
    "banded_sw.end": 19, "banded_sw.score": 13,
}


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


def bound(ops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time in ms the card could take for `ops` integer
    operations and `nbytes` of device-memory traffic, and which of the two
    sets it."""
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def band_cells(qlen: np.ndarray, tlen: np.ndarray, band: int) -> int:
    """Cells of banded.h's band over a batch: in strip ib < tr, the query
    tiles [max(0, ib - k_other + 1), min(band + ib, qr)), 64 cells each."""
    qr = (qlen.astype(np.int64) + 7) // 8
    tr = (tlen.astype(np.int64) + 7) // 8
    k_other = tr - (qr - band)
    total = 0
    for ib in range(int(tr.max())):
        lo = np.maximum(0, ib - k_other + 1)
        hi = np.minimum(band + ib, qr)
        total += int((np.maximum(hi - lo, 0) * (ib < tr)).sum())
    return total * 64


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
    """For each engine path (label, engine, (queries, targets), h0): the
    host-clock wall of three align() runs after a warm-up; the device time
    of one run under torch.profiler, in all and per kernel of csrc/; and
    the three host functions with the most self time under cProfile."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    for label, eng, (q, t), h0 in paths:
        eng.align(q, t, h0=h0)
        walls = []
        for _ in range(3):
            t0 = time.time()
            eng.align(q, t, h0=h0)
            walls.append(time.time() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.align(q, t, h0=h0)
            torch.cuda.synchronize()
        busy, kern = 0.0, {}
        for ev in prof.key_averages():
            if not str(ev.device_type).endswith("CUDA"):
                continue
            us = ev.self_device_time_total
            busy += us
            for name in KERNEL_SOURCES:   # global_sw is in semiglobal_sw
                if re.search(rf"(?<![A-Za-z]){name}_kernel", ev.key):
                    kern[name] = kern.get(name, 0.0) + us
        pr = cProfile.Profile()
        pr.enable()
        eng.align(q, t, h0=h0)
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
            + f"; {len(q)} pairs, on {smi}")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after the build, profile every engine path over "
                         "the 20,000 pairs (torch.profiler, cProfile) "
                         "instead of phases 3-5")
    args = ap.parse_args()

    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from genomics_tpu_torch import AlgoType, AlignEngine, AlignmentParams, _build
    from genomics_tpu_torch.core import golds
    from genomics_tpu_torch.core.scoring import SemiGlobalSkip
    from genomics_tpu_torch.ops import cuda_align, scan_align_full, tb_walk
    from genomics_tpu_torch.ops.scan_align import (
        banded_align_batch,
        global_align_batch,
        ksw_align_batch,
        local_align_batch,
        semiglobal_align_batch,
    )
    from genomics_tpu_torch.runtime.dispatch import walk_start

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
        profile_paths(paths, smi)
        return 0

    # -- 3. each kernel against its plain version, on the card ------------
    err = {k: 0 for k in ("local_sw.score", "local_sw.end", "local_sw.tb",
                          "tb_walk", "global_sw.score", "global_sw.tb",
                          "semiglobal_sw.end", "semiglobal_sw.tb",
                          "tb_walk.global", "tb_walk.semiglobal",
                          "local_sw.second", "local_start",
                          "semiglobal_start", "ksw.end", "ksw.score",
                          "banded_sw.end", "banded_sw.score")}

    def local_start_args(q, t, ql, tl, fwd):
        rq, rt, _, _ = scan_align_full.local_start_inputs(
            q, t, ql, tl, fwd.query_end, fwd.target_end)
        return rq, rt, fwd.score, P

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
        # LOCAL
        plain_tb = local_align_batch(q, t, P, with_tb=True)
        got_end = cuda_align.local_align(q, t, P)
        got_tb = cuda_align.local_align(q, t, P, with_tb=True)
        e["local_sw.end"] = max_abs_err(got_end[:3], plain_tb[:3])
        e["local_sw.tb"] = max_abs_err(got_tb, plain_tb)
        e["local_sw.score"] = max_abs_err(
            [cuda_align.local_align_scores(q, t, P, has_n=True)],
            [plain_tb.score])
        if n_rate == 0.0:   # only padding Ns: the has_n=False contract holds
            e["local_sw.score"] = max(e["local_sw.score"], max_abs_err(
                [cuda_align.local_align_scores(q, t, P, has_n=False),
                 cuda_align.local_align_scores_tm(
                     q.T.contiguous(), t.T.contiguous(), P, has_n=False)],
                [plain_tb.score] * 2))
        walk_args = (got_tb.tb, got_tb.score, got_tb.query_end,
                     got_tb.target_end, P)
        e["tb_walk"] = max_abs_err(tb_walk.tb_walk(*walk_args),
                                   tb_walk.tb_walk_plain(*walk_args))
        e["local_sw.second"] = max_abs_err(
            cuda_align.local_align_second(q, t, ql, tl, P),
            scan_align_full.local_align_second_batch(q, t, ql, tl, P))
        st_args = local_start_args(q, t, ql, tl, got_end)
        e["local_start"] = max_abs_err(
            cuda_align.local_start(*st_args),
            scan_align_full._local_start_core(*st_args))
        # GLOBAL
        plain_g = global_align_batch(q, t, ql, tl, PG, with_tb=True)
        got_g = cuda_align.global_align(q, t, ql, tl, PG, with_tb=True)
        e["global_sw.tb"] = max_abs_err(got_g, plain_g)
        e["global_sw.score"] = max_abs_err(
            cuda_align.global_align(q, t, ql, tl, PG)[:3], plain_g[:3])
        walk_args = (got_g.tb, got_g.score, ql, tl, PG, "global")
        e["tb_walk.global"] = max_abs_err(tb_walk.tb_walk(*walk_args),
                                          tb_walk.tb_walk_plain(*walk_args))
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
            i0, j0 = walk_start(AlgoType.SEMI_GLOBAL, head, got_s, ql, tl)
            walk_args = (got_s.tb, got_s.score, j0, i0, PS, "semiglobal")
            e["tb_walk.semiglobal"] = max(e["tb_walk.semiglobal"], max_abs_err(
                tb_walk.tb_walk(*walk_args), tb_walk.tb_walk_plain(*walk_args)))
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
        log("3 parity", f"{label}: max |kernel - plain| " + " ".join(
            f"{k} {v}" for k, v in e.items()))
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions: {err}")

    # -- 4. the slice through AlignEngine ---------------------------------
    qs, ts = gasal_pairs(rng, PAIRS)
    n = len(qs)
    log("4 slice", f"{n} pairs, reads {min(map(len, qs))}-"
        f"{max(map(len, qs))} bp, targets {min(map(len, ts))}-"
        f"{max(map(len, ts))} bp, seed {args.seed}")
    counts = (cuda_align.LAUNCHES, tb_walk.LAUNCHES)
    secs = {}

    def timed(key, eng, pairs=None, h0=None):
        t0 = time.time()
        jobs = eng.align(*(pairs or (qs, ts)), h0=h0)
        secs[key] = time.time() - t0
        if len(jobs) != n:
            raise AssertionError(f"{key}: the engine returned {len(jobs)} "
                                 f"jobs for {n} pairs")
        return jobs

    # 4a. LOCAL
    zero_counts(*counts)
    jobs_tb = timed("local tb", AlignEngine(P, with_tb=True, device=dev))
    jobs_end = timed("local ends", AlignEngine(P, device=dev))
    jobs_so = timed("local score-only",
                    AlignEngine(P, score_only=True, device=dev))
    launches = {k: cuda_align.LAUNCHES[k] for k in
                ("local_sw.score", "local_sw.end", "local_sw.tb")}
    launches["tb_walk"] = tb_walk.LAUNCHES["tb_walk"]
    log("4 slice", f"LOCAL launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the LOCAL path never launched: "
                             f"{launches}")
    for k in range(n):
        a, b, c = jobs_tb[k], jobs_end[k], jobs_so[k]
        if (a.score, a.query_end, a.target_end) != (
                b.score, b.query_end, b.target_end) or a.score != c.score:
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
    log("4 slice", f"LOCAL == CPU engine on {2 * CPU_CHECK} pairs (every "
        f"field, CIGAR bytes included); == gold on {GOLD_CHECK} pairs; "
        f"median score {np.median(scores)}; e.g. "
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
        "local_start": (cuda_align.local_start,
                        scan_align_full._local_start_core, st_local, {}),
        "semiglobal_start": (cuda_align.semiglobal_start,
                             scan_align_full._semiglobal_start_core,
                             st_semi, st_flags),
    }
    walks = {
        "tb_walk": (tb_res.tb, tb_res.score, tb_res.query_end,
                    tb_res.target_end, P),
        "tb_walk.global": (g_res.tb, g_res.score, ql, tl, PG, "global"),
        "tb_walk.semiglobal": (s_res.tb, s_res.score, sj0, si0, PS,
                               "semiglobal"),
    }
    ms = {
        "local_sw.score": cuda_ms(
            lambda: cuda_align.local_align_scores_tm(Q, T, P, has_n=False), 20),
        "local_sw.end": cuda_ms(lambda: cuda_align.local_align(q, t, P), 10),
        "local_sw.tb": cuda_ms(
            lambda: cuda_align.local_align(q, t, P, with_tb=True), 5),
        "global_sw.score": cuda_ms(
            lambda: cuda_align.global_align(q, t, ql, tl, PG), 10),
        "global_sw.tb": cuda_ms(
            lambda: cuda_align.global_align(q, t, ql, tl, PG, with_tb=True), 5),
        "semiglobal_sw.end": cuda_ms(
            lambda: cuda_align.semiglobal_align(q, t, ql, tl, PS, **sg), 10),
        "semiglobal_sw.tb": cuda_ms(
            lambda: cuda_align.semiglobal_align(q, t, ql, tl, PS,
                                                with_tb=True, **sg), 5),
    }
    for k, a in walks.items():
        ms[k] = cuda_ms(lambda a=a: tb_walk.tb_walk(*a), 10)
    for k, (kern, _, a, kw) in plains.items():
        ms[k] = cuda_ms(lambda kern=kern, a=a, kw=kw: kern(*a, **kw), 10)
    plain_ms = {
        "local_sw.score": cuda_ms(lambda: local_align_batch(Q.T, T.T, P), 2),
        "local_sw.end": cuda_ms(lambda: local_align_batch(q, t, P), 2),
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
    new_pairs = {   # name: (kernel, plain), each giving a list of tensors
        "ksw.end": (lambda: cuda_align.ksw_align(*ksw_args)[:3],
                    lambda: ksw_align_batch(*ksw_args)[:3]),
        "ksw.score": (
            lambda: [cuda_align.ksw_align_scores(*ksw_args, has_n=False)],
            lambda: [ksw_align_batch(*ksw_args).score]),
        "banded_sw.end": (lambda: cuda_align.banded_align(*band_args)[:3],
                          lambda: banded_align_batch(*band_args)[:3]),
        "banded_sw.score": (
            lambda: [cuda_align.banded_align_scores(*band_args, has_n=False)],
            lambda: [banded_align_batch(*band_args).score]),
    }
    for k, (kern, plain) in new_pairs.items():
        ms[k] = cuda_ms(kern, 10)
        plain_ms[k] = cuda_ms(plain, 1)
        err[k] = max(err[k], max_abs_err(kern(), plain()))
    steps, words = {}, {}
    for k, a in walks.items():
        plain_ms[k] = cuda_ms(lambda a=a: tb_walk.tb_walk_plain(*a), 1)
        got = tb_walk.tb_walk(*a)
        err[k] = max(err[k], max_abs_err(got, tb_walk.tb_walk_plain(*a)))
        steps[k] = int((got[0] != 255).sum())
        # a step that moves the column (M, X, I) reads a cube word no
        # earlier step read: a lower count of the words the walk needs
        words[k] = int(((got[0] <= 1) | (got[0] == 3)).sum())
    for k, (kern, plain, a, kw) in plains.items():
        plain_ms[k] = cuda_ms(lambda plain=plain, a=a, kw=kw: plain(*a, **kw),
                              1)
        err[k] = max(err[k], max_abs_err(kern(*a, **kw), plain(*a, **kw)))
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
    col, strip, _ = cuda_align.local_start(*st_local)
    start_cells = int(((strip.long() * BENCH_L + col + 1) * 8).sum())
    semi_strips = scan_align_full._semiglobal_start_core(
        *st_semi, **st_flags, count_strips=True)[2]
    semi_cells = int(semi_strips.long().sum()) * 8 * BENCH_L
    seqs = BENCH_B * 2 * BENCH_L          # Q and T, one byte a base
    pp = 4 * BENCH_B                      # one int32 per pair
    cube = (BENCH_L // 8) * BENCH_L * BENCH_B * 4
    work = {   # name: (cells or steps, bytes)
        "local_sw.score": (cells, seqs + pp),
        "local_sw.end": (cells, seqs + 3 * pp),
        "local_sw.tb": (cells, seqs + 3 * pp + cube),
        "global_sw.score": (cells, seqs + 3 * pp),
        "global_sw.tb": (cells, seqs + 3 * pp + cube),
        "semiglobal_sw.end": (cells, seqs + 5 * pp),
        "semiglobal_sw.tb": (cells, seqs + 5 * pp + cube),
        "local_sw.second": (cells, seqs + 8 * pp),
        "local_start": (start_cells, seqs + 4 * pp),
        "semiglobal_start": (semi_cells, seqs + 8 * pp),
        "ksw.end": (covered["ksw"], seqs + 6 * pp),
        "ksw.score": (covered["ksw"], seqs + 4 * pp),
        "banded_sw.end": (covered["banded"], seqs + 5 * pp),
        "banded_sw.score": (covered["banded"], seqs + 3 * pp),
    }
    for k in walks:   # words read, 3 int32 in, ops [Lq+Lt, B] + 2 out
        work[k] = (steps[k], 4 * words[k] + 5 * pp + seqs)
    peak = int32_peak()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("5 timings", f"bound: {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes "
        f"x {nvidia_smi('clocks.max.sm')} = {peak / 1e12:.2f} T int32 op/s; "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")
    bounds = {k: bound(OPS_PER_CELL[k] * u, nb, peak)
              for k, (u, nb) in work.items()}
    for k in ms:
        if k in steps:
            rate = f"{steps[k] / ms[k] / 1e6:.3f} G steps/s"
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
            f"{bounds[k][1]} ({OPS_PER_CELL[k]} op per "
            f"{'step' if k in steps else 'cell'}, {work[k][1]} bytes), "
            f"B={BENCH_B} {BENCH_L}x{BENCH_L}, on {smi}")
    log("5 timings", "engine, " + "; ".join(
        f"{k} {v:.3f} s ({n / v:.0f} pairs/s)" for k, v in secs.items())
        + f", {n} pairs, host clock, on {smi}")

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
    ]
    # no single PyTorch call computes these recurrences: library_ms null
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + f,
         "replaces": rep, "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name],
         "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, f, rep in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
