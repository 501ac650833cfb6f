#!/usr/bin/env python3
"""Drive the PyTorch port's alignment paths once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  Phases, one line each:

1. device   the card (nvidia-smi name and power limit), torch and CUDA;
2. build    nvcc builds every kernel from csrc/, one nvcc per source,
            all started together;
3. parity   each kernel against its plain PyTorch version on the card,
            integer-equal: B=4096+37 at 152x152 (ACGT only; LOCAL with
            has_n True and False) and B=1000 in the 216x328 bucket with
            Ns: local_sw SCORE/END/TB/SECOND, global_sw SCORE/TB,
            semiglobal_sw END for all 16 HEAD x TAIL and TB for
            NONE/NONE, TARGET/TARGET, QUERY/QUERY and BOTH/BOTH, the
            LOCAL, GLOBAL and SEMI_GLOBAL walks, local_start fed the END
            kernel's result and semiglobal_start for all 16 HEAD x TAIL
            fed the semiglobal END kernel's;
4. slice    20,000 GASAL2-shaped pairs (150 bp reads cut from 200-300 bp
            targets, ~2% substitutions, ~0.5% 1-3 bp indels, a few Ns)
            through AlignEngine(device="cuda"), every kernel's launch
            count set to 0 just before and read just after each path:
            LOCAL with traceback, ends only and score-only; then GLOBAL
            and SEMI_GLOBAL glocal (head=tail=TARGET), each with and
            without traceback; then the start passes (LOCAL, glocal and
            SEMI_GLOBAL NONE/BOTH compute_start) and LOCAL second_best
            with and without traceback.  Checked against the CPU engine
            (every field, CIGAR bytes included) and the pure-Python golds,
            plus one GLOBAL run with models/assembly.py's scoring;
5. timings  each kernel and its plain version on the card at bench.py's
            shape (B=65,536, 152x152), and the engine's pairs/s.

Then one JSON line with the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before the
last line.  Needs one CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_B, BENCH_L = 65536, 152
PAIRS = 20000  # GASAL2's test program aligns 20,000 reads
CPU_CHECK = 1024  # pairs of each traceback run held to the CPU engine
GOLD_CHECK = 64   # pairs held to the pure-Python gold


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def gasal_pairs(rng, n):
    """GASAL2 test-program-shaped pairs: 150 bp reads cut from random
    200-300 bp targets, ~2% substitutions, ~0.5% indels of 1-3 bp, and
    a few Ns in reads and targets."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    qs, ts = [], []
    for _ in range(n):
        tl = int(rng.integers(200, 301))
        tgt = bases[rng.integers(0, 4, tl)]
        start = int(rng.integers(0, tl - 160 + 1))
        read = list(tgt[start:start + 160])
        out = []
        k = 0
        while k < len(read):
            r = rng.random()
            if r < 0.0025:                      # deletion of 1-3 bases
                k += int(rng.integers(1, 4))
                continue
            if r < 0.005:                       # insertion of 1-3 bases
                out.extend(bases[rng.integers(0, 4, int(rng.integers(1, 4)))])
            out.append(bases[rng.integers(0, 4)] if rng.random() < 0.02
                       else read[k])
            k += 1
        read = np.array(out[:150], np.uint8)
        read[rng.random(len(read)) < 0.001] = ord("N")
        tgt = tgt.copy()
        tgt[rng.random(tl) < 0.0005] = ord("N")
        qs.append(read.tobytes())
        ts.append(tgt.tobytes())
    return qs, ts


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
        global_align_batch,
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

    # -- 3. each kernel against its plain version, on the card ------------
    err = {k: 0 for k in ("local_sw.score", "local_sw.end", "local_sw.tb",
                          "tb_walk", "global_sw.score", "global_sw.tb",
                          "semiglobal_sw.end", "semiglobal_sw.tb",
                          "tb_walk.global", "tb_walk.semiglobal",
                          "local_sw.second", "local_start",
                          "semiglobal_start")}

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

    def timed(key, eng):
        t0 = time.time()
        jobs = eng.align(qs, ts)
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
    assert_jobs_equal(jobs_tb, AlignEngine(P, with_tb=True).align(
        [qs[k] for k in sub], [ts[k] for k in sub]), "LOCAL")
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
    assert_jobs_equal(g_tb, AlignEngine(PG, with_tb=True).align(sq, st),
                      "GLOBAL")
    assert_jobs_equal(s_tb, AlignEngine(PS, with_tb=True, head=GLOCAL,
                                        tail=GLOCAL).align(sq, st),
                      "SEMI_GLOBAL")
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
    assert_jobs_equal(a_tb, AlignEngine(PA, with_tb=True).align(
        qs[:256], ts[:256]), "GLOBAL with the assembly scoring")
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
        assert_jobs_equal(got_opt[k], AlignEngine(pp, **kw).align(sq, st), k)
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
    steps = {}
    for k, a in walks.items():
        plain_ms[k] = cuda_ms(lambda a=a: tb_walk.tb_walk_plain(*a), 1)
        got = tb_walk.tb_walk(*a)
        err[k] = max(err[k], max_abs_err(got, tb_walk.tb_walk_plain(*a)))
        steps[k] = int((got[0] != 255).sum())
    for k, (kern, plain, a, kw) in plains.items():
        plain_ms[k] = cuda_ms(lambda plain=plain, a=a, kw=kw: plain(*a, **kw),
                              1)
        err[k] = max(err[k], max_abs_err(kern(*a, **kw), plain(*a, **kw)))
    if any(err.values()):
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"at the timing shape: {err}")
    for k in ms:
        rate = (f"{steps[k] / ms[k] / 1e6:.3f} G steps/s" if k in steps
                else "stops at the start" if k.endswith("_start")
                else f"{cells / ms[k] / 1e6:.2f} GCUPS")
        log("5 timings", f"{k}: kernel {ms[k]:.4f} ms ({rate}), plain "
            f"{plain_ms[k]:.2f} ms, B={BENCH_B} {BENCH_L}x{BENCH_L}, on {smi}")
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
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + f,
         "replaces": rep, "launches": launches[name],
         "max_abs_err": err[name], "ms": ms[name],
         "plain_ms": plain_ms[name]}
        for name, f, rep in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
