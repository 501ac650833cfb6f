#!/usr/bin/env python3
"""The LCS kernels' designs timed side by side on one card.

    python3 tools/lcs_variants.py --parent DIR [--rounds 3] [--out DIR]
    python3 tools/lcs_variants.py --sweep [--rounds 1]

csrc/cluster_lcs.cu and csrc/ngia_lcs.cu of this tree (`this`: the gate
or the word filter over every pair, then the LCS of the pairs that pass
only, G lanes a pair with carry-lookahead across the warp) against DIR's
(`first`: one thread a pair, the row in registers, past them in a
[words, pairs] scratch) at chip_smoke.py phase 5's launches: cluster_lcs
at bench_cluster's first window's pass-2 columns (256 x 2,002), ngia_lcs
at the first speculate=32 window (32 x 8,000) and at one serial round (1
x 8,000, round mode, the cluster array restored before each replay and
the restores' time taken off), over bench_ngia's reads and over the
mixed-length set (chip_smoke.NGIA_MIXED).  Each launch is replayed 20
times from a CUDA graph, the variants in turns (this, first, first,
this) over --rounds, every output held to the plain version's.  Each
design is built from its own sources, its header inlined.

DIR is an unpacked checkout of the commit before the redesign (`git
archive 5c97adb genomics_tpu_torch/csrc | tar -x -C DIR`, into a
directory .gitignore lists, such as variants_parent/).  The sources and
libraries go to --out (default build/lcs_variants).

--sweep times this tree's kernels (as ops/lcs.py builds them) at each
SWEEP_THREAD_MIN value of their thread_min argument (0: lane groups in
every block; n: a thread a pair in blocks whose lists hold n pairs or
more; the rule is ops/lcs.thread_min): cluster_lcs at 256 x 2,002
columns of family reads whose rows take SWEEP_WORDS words, gated at
SWEEP_DENSITY (1/256 is bench_cluster's pass 2, about one gated pair a
column), and ngia_lcs at the four launches above.  Every thread_min's
output is held to thread_min 0's, and those at the rule's launches to
the plain version's.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    CLUSTER_LEN,
    CLUSTER_READS,
    CLUSTER_SPEC,
    NGIA_LEN,
    NGIA_MIXED,
    NGIA_READS,
    NGIA_SPEC,
    family_reads,
    graph_ms,
    max_abs_err,
    nvidia_smi,
)
from genomics_tpu_torch import _build  # noqa: E402
from genomics_tpu_torch.models import cluster as TC  # noqa: E402
from genomics_tpu_torch.models import ngia as TN  # noqa: E402
from genomics_tpu_torch.ops import cluster_filter as CF  # noqa: E402
from genomics_tpu_torch.ops import lcs  # noqa: E402
from tools.tb_variants import build_variants  # noqa: E402

# the first design's register buckets (its ops/lcs.py): 0 takes the
# [max_words, S x J] scratch
FIRST_CLUSTER_WORDS = (1, 2, 4, 8, 16, 32)
FIRST_NGIA_BANDS = (1, 3, 5, 9, 17, 33)
# the first design's C parameters, which had no thread_min
FIRST_CLUSTER_ARGS = lcs._CLUSTER_ARGS[:16] + lcs._CLUSTER_ARGS[17:]
FIRST_NGIA_ARGS = lcs._NGIA_ARGS[:18] + lcs._NGIA_ARGS[19:]
# --sweep: thread_min values, row widths (words) and gate densities
SWEEP_THREAD_MIN = (0, 1, 32, 64, 128, 512)
SWEEP_WORDS = (5, 17, 33, 65, 96, 128, 192)
SWEEP_DENSITY = (1 / 256, 1 / 8, 1.0)
SWEEP_REPS = 5   # launches a CUDA graph replays, for each time


def inlined(csrc: Path, name: str) -> str:
    """csrc/<name>.cu with its bitlcs.cuh pasted in place of the include."""
    return (csrc / f"{name}.cu").read_text().replace(
        '#include "bitlcs.cuh"', (csrc / "bitlcs.cuh").read_text())


def first_bucket(buckets, need: int) -> int:
    return next((b for b in buckets if need <= b), 0)


def call(lib: ctypes.CDLL, symbol: str, argtypes: tuple, dev, *args):
    """`symbol` of lib with args (tensors by data pointer) on the current
    stream; raises on the CUDA error it returns."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def in_turns(runs: dict, rounds: int) -> dict:
    """ms of each run (a CUDA graph's 20 replays), the runs in turns:
    forward, then backward, `rounds` times."""
    got = {k: [] for k in runs}
    order = list(runs)
    for _ in range(rounds):
        for k in order + order[::-1]:
            got[k].append(runs[k]())
    return got


def cluster_launches(libs: dict, dev) -> tuple:
    """(label, runs, want, outs) at bench_cluster's first window's pass-2
    columns: the first 256 reads against the rest."""
    reads = family_reads(np.random.default_rng(0), CLUSTER_READS,
                         CLUSTER_LEN, 8, 6)
    wl = TC.auto_word_length(0.95)
    p = TC._prepare(reads, 0.95, wl)
    reps = np.arange(CLUSTER_SPEC)
    jobs = np.arange(1, CLUSTER_READS)
    aux = TC._aux_dev(p, dev)
    rp = torch.from_numpy(reps.astype(np.int32)).to(dev)
    jp = torch.from_numpy(jobs.astype(np.int32)).to(dev)
    p2, anyv = CF.window_filters(TC._packed_dev(p, dev), aux["prefix"],
                                 aux["wcut"], aux["bcut"], rp, jp,
                                 1 << (2 * wl), TC._dense_k(p, wl))
    cols = torch.nonzero(anyv)[:, 0]
    jb, gate = jp[cols], p2[:, cols].contiguous()
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    S, J = len(reps), int(cols.shape[0])
    mw = TC.words_needed(p, reps)
    want = lcs.lcs_accept_plain(*args, rp, jb, gate)
    runs, outs = {}, {}
    for key, lib in libs.items():
        out = torch.empty((S, J), dtype=torch.uint8, device=dev)
        if key == "this":
            lays = lcs.lcs_layouts(*args, rp, jb, gate, out, mw)
        else:
            nw = first_bucket(FIRST_CLUSTER_WORDS, mw)
            scratch = (torch.empty(mw * S * J, dtype=torch.int32, device=dev)
                       if nw == 0 else None)
            lays = [(*args[:2], args[0].shape[1], args[2], args[3],
                     args[3].stride(0), args[4], rp, S, jb, J, gate, out, J,
                     mw, nw, scratch)]

        def run(lib=lib, lays=lays, types=lcs._CLUSTER_ARGS
                if key == "this" else FIRST_CLUSTER_ARGS):
            for x in lays:
                call(lib, "cluster_lcs_launch", types, dev, *x)
        runs[key] = lambda run=run: graph_ms(run, 20)
        outs[key] = out
        run()
    return (f"cluster_lcs {S} x {J} ({mw} words)", runs, want, outs)


def ngia_launches(libs: dict, dev, reads, which: str) -> list:
    """(label, runs, want, outs) of the first speculate=32 window and the
    first serial round over `reads`."""
    N = len(reads)
    _o, _l, net, words, low, high, codes = TN._prepare(reads)
    a = TN._device_arrays(net, words, low, high, codes, dev)
    args = [a[k] for k in ("words", "net", "low", "high", "codes")]
    every = torch.arange(N, dtype=torch.int32, device=dev)
    mw = int((net.max() + 31) // 32)
    fresh = torch.full((N,), -1, dtype=torch.int32, device=dev)
    sim32, oms32 = float(np.float32(0.95)), float(np.float32(1.0 - 0.95))
    got = []
    for label, S in (("window", NGIA_SPEC), ("serial round", 1)):
        rnd = S == 1
        rp = torch.arange(S, dtype=torch.int32, device=dev)
        ms_ = lcs.max_shift_of(net if rnd else net[:S], net, 0.95)
        want = lcs.banded_lcs_accept_plain(*args, rp, every, 0.95,
                                           fresh.clone() if rnd else None)
        runs, outs = {}, {}
        spare = fresh.clone()
        restore = graph_ms(lambda: spare.copy_(fresh), 20) if rnd else 0.0
        for key, lib in libs.items():
            cl = fresh.clone() if rnd else None
            out = None if rnd else torch.empty((S, N), dtype=torch.uint8,
                                               device=dev)
            if key == "this":
                lays = lcs.banded_layouts(*args, rp, every, 0.95, cl, out,
                                          mw, ms_)
            else:
                bw = first_bucket(FIRST_NGIA_BANDS, 2 * max(ms_, 0) + 1)
                scratch = (torch.empty(mw * S * N, dtype=torch.int32,
                                       device=dev) if bw == 0 else None)
                lays = [(*args[:4], args[2].shape[1], args[4],
                         args[4].stride(0), rp, S, every, N, sim32, oms32, cl,
                         out, N, mw, bw, scratch)]

            def run(lib=lib, lays=lays, cl=cl, types=lcs._NGIA_ARGS
                    if key == "this" else FIRST_NGIA_ARGS):
                if cl is not None:
                    cl.copy_(fresh)
                for x in lays:
                    call(lib, "ngia_lcs_launch", types, dev, *x)
            runs[key] = (lambda run=run: graph_ms(run, 20) - restore)
            outs[key] = cl if rnd else out
            run()
        got.append((f"ngia_lcs {which} {label} {S} x {N} (shift "
                    f"{ms_})", runs, want, outs))
    return got


def sweep_line(label: str, runs: dict, outs: dict, want, rounds: int,
               smi: str):
    """Times runs (thread_min -> run) in turns, holds every output to
    thread_min 0's (and the rule's to `want` where given), and prints one
    line."""
    for k, o in outs.items():
        err = max_abs_err([o], [outs[0]])
        if err:
            raise AssertionError(f"{label}: thread_min {k} differs from "
                                 f"thread_min 0 by {err}")
    if want is not None:
        err = max_abs_err([outs[0]], [want])
        if err:
            raise AssertionError(f"{label}: differs from the plain version "
                                 f"by {err}")
    got = in_turns(runs, rounds)
    med = {k: statistics.median(v) for k, v in got.items()}
    best = min(med, key=med.get)
    print(f"sweep {label}: " + "; ".join(
        f"thread_min {k} {v:.4f} ms" for k, v in med.items())
        + f"; fastest thread_min {best}; == thread_min 0"
        + ("" if want is None else " == plain") + f"; on {smi}", flush=True)


def sweep_cluster(dev, rounds: int, smi: str):
    """cluster_lcs at 256 x 2,002 columns of family reads of 32 w - 8
    bases (rows of w words), gated at each SWEEP_DENSITY."""
    for w in SWEEP_WORDS:
        reads = family_reads(np.random.default_rng(w), 2258, 32 * w - 8, 8,
                             6)
        p = TC._prepare(reads, 0.95, 5)
        aux = TC._aux_dev(p, dev)
        args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
        S, J = CLUSTER_SPEC, len(reads) - CLUSTER_SPEC
        rp = torch.arange(S, dtype=torch.int32, device=dev)
        jb = torch.arange(S, S + J, dtype=torch.int32, device=dev)
        mw = TC.words_needed(p, np.arange(S))
        for d in SWEEP_DENSITY:
            gate = (torch.rand((S, J), generator=torch.Generator(
                device=dev).manual_seed(w), device=dev) < d).to(torch.uint8)
            runs, outs = {}, {}
            for tm in SWEEP_THREAD_MIN:
                out = torch.empty((S, J), dtype=torch.uint8, device=dev)
                lays = lcs.lcs_layouts(*args, rp, jb, gate, out, mw,
                                       threads=tm)

                def run(lays=lays):
                    for x in lays:
                        lcs.launch_cluster_lcs(x)
                run()
                runs[tm] = lambda run=run: graph_ms(run, SWEEP_REPS)
                outs[tm] = out
            want = (lcs.lcs_accept_plain(*args, rp, jb, gate)
                    if d < 0.5 and w <= 33 else None)
            sweep_line(f"cluster_lcs {S} x {J}, {mw} words, "
                       f"{int(gate.sum())} gated pairs (density {d:.4f}), "
                       f"rule thread_min {lcs.thread_min(mw, None)}",
                       runs, outs, want, rounds, smi)


def sweep_ngia(dev, rounds: int, smi: str):
    """ngia_lcs's window and serial round over bench_ngia's reads and the
    mixed-length set."""
    sets = (("bench_ngia", family_reads(np.random.default_rng(0), NGIA_READS,
                                        NGIA_LEN, 16, 12)),
            (f"mixed {NGIA_MIXED[0]}-{NGIA_MIXED[1]} bp",
             family_reads(np.random.default_rng(0), NGIA_READS, NGIA_MIXED,
                          16, 12)))
    for which, reads in sets:
        N = len(reads)
        _o, _l, net, words, low, high, codes = TN._prepare(reads)
        a = TN._device_arrays(net, words, low, high, codes, dev)
        args = [a[k] for k in ("words", "net", "low", "high", "codes")]
        every = torch.arange(N, dtype=torch.int32, device=dev)
        mw = int((net.max() + 31) // 32)
        fresh = torch.full((N,), -1, dtype=torch.int32, device=dev)
        spare = fresh.clone()
        restore = graph_ms(lambda: spare.copy_(fresh), SWEEP_REPS)
        for label, S in (("window", NGIA_SPEC), ("serial round", 1)):
            rnd = S == 1
            rp = torch.arange(S, dtype=torch.int32, device=dev)
            ms_ = lcs.max_shift_of(net[:S], net, 0.95)
            want = lcs.banded_lcs_accept_plain(*args, rp, every, 0.95,
                                               fresh.clone() if rnd else None)
            runs, outs = {}, {}
            for tm in SWEEP_THREAD_MIN:
                cl = fresh.clone() if rnd else None
                out = None if rnd else torch.empty((S, N), dtype=torch.uint8,
                                                   device=dev)
                lays = lcs.banded_layouts(*args, rp, every, 0.95, cl, out,
                                          mw, ms_, threads=tm)

                def run(lays=lays, cl=cl):
                    if cl is not None:
                        cl.copy_(fresh)
                    for x in lays:
                        lcs.launch_ngia_lcs(x)
                run()
                runs[tm] = (lambda run=run, rnd=rnd:
                            graph_ms(run, SWEEP_REPS)
                            - (restore if rnd else 0.0))
                outs[tm] = cl if rnd else out
            sweep_line(f"ngia_lcs {which} {label} {S} x {N} ({mw} words, "
                       f"shift {ms_}), rule thread_min "
                       f"{lcs.thread_min(mw, None)}", runs, outs, want,
                       rounds, smi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "lcs_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lcs_variants: no CUDA device", file=sys.stderr)
        return 2
    if not args.sweep and not args.parent:
        ap.error("--parent DIR, or --sweep")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    if args.sweep:
        sweep_cluster(dev, args.rounds, smi)
        sweep_ngia(dev, args.rounds, smi)
        return 0
    parent = Path(args.parent) / "genomics_tpu_torch" / "csrc"
    srcs = {f"{name}-{key}": inlined(csrc, name)
            for name in ("cluster_lcs", "ngia_lcs")
            for key, csrc in (("this", _build.CSRC), ("first", parent))}
    out = Path(args.out)
    build_variants(srcs, out)
    libs = {k: ctypes.CDLL(str(out / f"{k}.so")) for k in srcs}

    def group(name: str) -> dict:
        return {k: libs[f"{name}-{k}"] for k in ("this", "first")}

    launches = [cluster_launches(group("cluster_lcs"), dev)]
    nreads = family_reads(np.random.default_rng(0), NGIA_READS, NGIA_LEN,
                          16, 12)
    mixed = family_reads(np.random.default_rng(0), NGIA_READS, NGIA_MIXED,
                         16, 12)
    launches += ngia_launches(group("ngia_lcs"), dev, nreads, "bench_ngia")
    launches += ngia_launches(group("ngia_lcs"), dev, mixed,
                              f"mixed {NGIA_MIXED[0]}-{NGIA_MIXED[1]} bp")
    for label, runs, want, outs in launches:
        for key, o in outs.items():
            err = max_abs_err([o], [want])
            if err:
                raise AssertionError(f"{label}: {key} differs from the "
                                     f"plain version by {err}")
        got = in_turns(runs, args.rounds)
        print(f"{label}: " + "; ".join(
            f"{k} median {statistics.median(v):.4f} ms (min {min(v):.4f}, "
            f"max {max(v):.4f}, {len(v)} runs)" for k, v in got.items())
            + f"; first / this {statistics.median(got['first']) / statistics.median(got['this']):.2f}x"
            f"; == plain; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
