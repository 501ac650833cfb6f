#!/usr/bin/env python3
"""The design choices of the app kernels, timed side by side on one card.

    python3 tools/app_variants.py [--parent DIR] [--rounds 5] [--out DIR]
                                  [--only nw,fill,table,sw,backtrack]

nw (csrc/nw_app.cu, stripes of 32 kRows rows, one warp each, the chunk
of kChunk columns written out and published at a time, the row above
loaded kLead steps ahead) at chip_smoke's NW_RUN_N and NW_BIG_N: this
tree (`this`, kRows 4, kChunk 32, kLead 4; and `this-one-warp`, one warp
that takes every stripe in turn, at NW_RUN_N) against `rows2`, `rows8`,
`chunk16`, `lead32`, `lead8`, `scalar` (4-byte stores), `nosteady`
(every step through the general path),
`fence` (a __threadfence before the flag), `diag-nopoll` (no waits: its
output is wrong, its time the design's floor) and DIR's nw_app.cu
(`first`, one launch per diagonal of 32 x 32 tiles) where --parent is
given.

fill (csrc/msa_nw.cu's fill, 8 pairs x 4 strips of kRows rows a warp, a
block barrier every kChunk steps) at chip_smoke's three MSA sets
(MSA_RUN_ALL, MSA_LONG, MSA_PROTEIN): this tree (kRows 8, kChunk 8)
against `rows16` (kMaxStrips 64: its registers), `strips128` (1,024
threads a block: 64 registers), `chunk4`, `chunk16`, `stcs` (streaming
stores), `diag-nostore` (no cube stores: its output is wrong, its time
the fill's work without the bytes) and DIR's fill (`first`, one thread
a pair with a Y scratch).

table: the fill's table through __ldg against `shared-table`, a variant
that stages it in shared memory first, at the protein set.

sw (csrc/sw_app.cu, stripes of kRows rows a block of kThreads, tiles of
kTile columns) at chip_smoke's SW shapes (100 windows of 3,000 against
1,000 bp; 7 windows of 45,000 against 200 bp): this tree (256 threads,
2,048 columns, 12 rows) against blocks of 256 threads at every kRows in
4, 8, 16 by every kTile in 512, 1,024, 2,048, blocks of 32 to 128
threads and 12 rows (`wTHREADS-tTILE-rROWS`), `late-release` (a tile's
flag published after all its rows, not after the last one), `spin` (the
flag polled without __nanosleep), `vector-stage` (the stage written and
read 16 bytes at a time), `diag-nopoll` and `diag-nostore` (no
waits on the stripe above, no stores of H: their outputs are wrong,
their times floors), and DIR's sw_app.cu (`first`, a block
a window, the row in shared memory or, past 40,958 columns, in a global
scratch) where --parent is given.

backtrack (csrc/msa_nw.cu's backtrack, kLanes lanes a pair walking in
rounds of kDiag diagonal words or kRun gap lengths) at the three MSA
sets: this tree (32 lanes, 32 and 32) against `lanes8` and `lanes16`
(kLanes = kDiag = kRun), `run16` and `diag16` (32 lanes, kRun or kDiag
16),
`k1-apart` (no k = 1 words in the diagonal round: each gap step a
round of its own) and DIR's backtrack (`first`, a thread a pair, the fill's pads walked
too) where --parent is given; beside each set, the rounds and the words
loaded against the words a one-thread walk needs.

DIR is an unpacked checkout of the commit before the redesign of the
kernels that --only names (`git archive COMMIT genomics_tpu_torch/csrc |
tar -x -C DIR`, into a directory .gitignore lists, such as
variants_parent/): 5ef7697 for nw, fill and table; c3ff367 for sw and
backtrack (their entry points differ, so one call takes one of the two
groups with --parent).  Launches alone, CUDA events, in turns (every
variant forward, then backward) over --rounds; every output is compared
word for word with the plain version's.  The variant sources and
libraries go to --out (default chiprun_out/app_variants).
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    NW_BIG_N,
    NW_RUN_N,
    SW_WIDE,
    SW_WIDE_X,
    SW_X,
    cube_err,
    cuda_ms,
    msa_sets,
    nvidia_smi,
    sw_planted,
)
from genomics_tpu_torch import _build  # noqa: E402
from genomics_tpu_torch.core.submat import load_scoring_matrix  # noqa: E402
from genomics_tpu_torch.models import msa, nw, sw  # noqa: E402
from tools.tb_variants import build_variants  # noqa: E402

_vp, _ci = ctypes.c_void_p, ctypes.c_int

# this tree's fill -> the fill that stages the table in shared memory
SHARED_TABLE = [
    ("  const Rings ring{smem, smem + ring_words, smem + 2 * ring_words};\n",
     "  const Rings ring{smem, smem + ring_words, smem + 2 * ring_words};\n"
     "  int* stab = smem + 3 * ring_words;\n"
     "  if constexpr (kTable)\n"
     "    for (int k = threadIdx.x; k < A * A; k += blockDim.x)"
     " stab[k] = table[k];\n"),
    ("kTable ? __ldg(table + code[h] + ic)", "kTable ? stab[code[h] + ic]"),
    ("                   2 * kChunk * kPairs;\n",
     "                   2 * kChunk * kPairs +\n"
     "                   (table ? static_cast<int>(sizeof(int)) * A * A : 0);"
     "\n"),
]
FILL_VARIANTS = {
    "rows16": [("constexpr int kRows = 8;", "constexpr int kRows = 16;"),
               ("constexpr int kMaxStrips = 96;",
                "constexpr int kMaxStrips = 64;")],
    "strips128": [("constexpr int kMaxStrips = 96;",
                   "constexpr int kMaxStrips = 128;")],
    "chunk4": [("constexpr int kChunk = 8;", "constexpr int kChunk = 4;")],
    "chunk16": [("constexpr int kChunk = 8;", "constexpr int kChunk = 16;")],
}
NW_VARIANTS = {
    "rows2": [("constexpr int kRows = 4;", "constexpr int kRows = 2;")],
    "rows8": [("constexpr int kRows = 4;", "constexpr int kRows = 8;")],
    "chunk16": [("constexpr int kChunk = 32;", "constexpr int kChunk = 16;")],
    "lead32": [("constexpr int kLead = 4;", "constexpr int kLead = 32;")],
    "lead8": [("constexpr int kLead = 4;", "constexpr int kLead = 8;")],
    # a chunk in 4-byte stores; a full fence before the flag's release;
    # every step through the general path (no unrolled blocks of 32)
    "scalar": [("if (w == kChunk && N % 4 == 0) {", "if (false) {")],
    "nosteady": [("if ((s & 31) == 0 && s >= 32 && s + 32 <= N) {",
                  "if (false) {")],
    "fence": [("if (t == 0) st_release(progress + k, done + 1);",
               "if (t == 0) {\n          __threadfence();\n"
               "          st_release(progress + k, done + 1);\n        }")],
}
# timing only (their outputs are wrong and not compared): the stripes
# without their waits, this design's floor; the fill without its stores
NW_DIAG = {"nopoll": [("      if (k > 0 && t == 0) {\n",
                       "      if (k < 0 && t == 0) {\n")]}
FILL_DIAG = {
    "nostore": [("if (i0 + h <= m) cell[h * rs] = v;",
                 "if (v == 0x7fffffff) cell[h * rs] = v;")],
}
FILL_VARIANTS["stcs"] = [("if (i0 + h <= m) cell[h * rs] = v;",
                          "if (i0 + h <= m) __stcs(cell + h * rs, v);")]

def sw_shape(threads: int, tile: int, rows: int) -> list:
    """Edits of this tree's sw_app.cu to kThreads, kTile and kRows."""
    return [("constexpr int kThreads = 256;",
             f"constexpr int kThreads = {threads};"),
            ("constexpr int kTile = 2048;", f"constexpr int kTile = {tile};"),
            ("constexpr int kRows = 12;", f"constexpr int kRows = {rows};")]


# blocks of 256 threads at 4, 8, 16 rows x 512, 1,024, 2,048 columns
# (w256-t1024-r8 was this kernel's first choice); blocks of 32 to 128
# threads, fewer warps to meet at a row's barrier; 12 rows
SW_VARIANTS = {
    f"w{w}-t{t}-r{r}": sw_shape(w, t, r)
    for w, t, r in [(256, t, r) for r in (4, 8, 16) for t in (512, 1024, 2048)]
    + [(32, 256, 8), (32, 512, 8), (64, 256, 8), (64, 512, 8), (128, 512, 8),
       (128, 1024, 8), (128, 1024, 12), (128, 1024, 16), (128, 2048, 8),
       (128, 2048, 12), (256, 1024, 12)]}
# the flag published after all of a tile's rows; the flag polled without
# a sleep
SW_VARIANTS["late-release"] = [(
    "      write_row(rows - 1);\n      __syncthreads();\n"
    "      if (t == 0) st_release(progress + k, c + 1);\n"
    "      for (int h = 0; h + 1 < rows; ++h) write_row(h);\n"
    "      __syncthreads();   // the stage is free\n",
    "      for (int h = 0; h < rows; ++h) write_row(h);\n"
    "      __syncthreads();   // the stage is free\n"
    "      if (t == 0) st_release(progress + k, c + 1);\n")]
# the stage written and read 16 bytes at a time (its word-at-a-time
# accesses are 8- and 4-way bank conflicts)
SW_VARIANTS["vector-stage"] = [
    ("          srow[q] = v;\n", ""),
    ("        dg = prefix - (j0 - 1);   // H[i][j0 - 1], the next row's diagonal\n",
     "#pragma unroll\n        for (int q = 0; q < kCols; q += 4)\n"
     "          *reinterpret_cast<int4*>(srow + q) =\n"
     "              make_int4(up[q], up[q + 1], up[q + 2], up[q + 3]);\n"
     "        dg = prefix - (j0 - 1);   // H[i][j0 - 1], the next row's diagonal\n"),
    ("          const int* v = sr + (col - c0);\n"
     "          *reinterpret_cast<int4*>(g + col) = make_int4(v[0], v[1], v[2], v[3]);\n",
     "          const int d = a - c0;\n"
     "          const int4* q = reinterpret_cast<const int4*>(sr) + u;\n"
     "          const int4 q0 = q[0];\n          int4 v = q0;\n"
     "          if (d) {\n            const int4 q1 = q[1];\n"
     "            v = d == 1   ? make_int4(q0.y, q0.z, q0.w, q1.x)\n"
     "                : d == 2 ? make_int4(q0.z, q0.w, q1.x, q1.y)\n"
     "                         : make_int4(q0.w, q1.x, q1.y, q1.z);\n"
     "          }\n          *reinterpret_cast<int4*>(g + col) = v;\n"),
]
SW_VARIANTS["spin"] = [("while (ld_acquire(progress + k - W) <= c) __nanosleep(64);",
                        "while (ld_acquire(progress + k - W) <= c) {}")]
# timing only (their outputs are wrong and not compared): the stripes
# without their waits on the stripe above; the tiles without their stores
SW_DIAG = {
    "nopoll": [("      if (s > 0 && t == 0)\n        while (ld_acquire(",
                "      if (s < 0 && t == 0)\n        while (ld_acquire(")],
    "nostore": [("      write_row(rows - 1);\n", ""),
                ("      for (int h = 0; h + 1 < rows; ++h) write_row(h);\n",
                 "")],
}
BACKTRACK_VARIANTS = {
    **{f"lanes{g}": [("constexpr int kLanes = 32;",
                      f"constexpr int kLanes = {g};"),
                     ("constexpr int kDiag = 32;", f"constexpr int kDiag = {g};"),
                     ("constexpr int kRun = 32;", f"constexpr int kRun = {g};")]
       for g in (8, 16)},
    "run16": [("constexpr int kRun = 32;", "constexpr int kRun = 16;")],
    "diag16": [("constexpr int kDiag = 32;", "constexpr int kDiag = 16;")],
    # the diagonal round without the k = 1 words: every gap step a round of
    # its own (gap rounds from k = 1)
    "k1-apart": [("      if (k <= iu) {", "      if (k <= iu && !diag) {"),
                 ("      if (k <= ju) {", "      if (k <= ju && !diag) {"),
                 ("          base = 1;\n          if (base >= max(i, j)) "
                  "live = false;\n", "          base = 0;\n")],
}

# the first designs' entry points: nw_app_launch(reference, query, out, N,
# stream); msa_nw_launch(center, seqs, slens, table, A, M, Y, m, n_pad, B,
# stream); sw_app_launch(x, windows, H, best, row scratch or NULL, n, W,
# L, stream); msa_nw_backtrack_launch(M, center, seqs [n_pad, P], slens
# [P], table, A, space [P, m+1], so [P, n_pad+1], m, n_pad, P, stream)
FIRST_NW_ARGS = (_vp, _vp, _vp, _ci, _vp)
FIRST_FILL_ARGS = (_vp, _vp, _vp, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _vp)
FIRST_SW_ARGS = (_vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _vp)
FIRST_BACKTRACK_ARGS = (_vp, _vp, _vp, _vp, _vp, _ci, _vp, _vp, _ci, _ci,
                        _ci, _vp)


def edits(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant edit does not match once: {old!r}")
        src = src.replace(old, new)
    return src


def in_turns(fns: dict, reps: int, rounds: int) -> dict:
    """{name: [ms of each round]}, every fn forward then backward."""
    ms = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            ms[k].append(cuda_ms(fns[k], reps))
    return ms


def report(what: str, ms: dict, smi: str):
    ref = min(ms, key=lambda k: min(ms[k]))
    for k, v in ms.items():
        print(f"{what}: {k}: min {min(v):.4f} ms, median "
              f"{float(np.median(v)):.4f} ms over {len(v)} rounds, "
              f"{min(v) / min(ms[ref]):.3f} x {ref}; on {smi}", flush=True)


def entry(lib: Path, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def caller(fn, args, dev):
    """fn on args (tensors pass their pointers) and the current stream."""
    raw = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]

    def call():
        err = fn(*raw, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"variant launch: CUDA error {err}")
    return call


def time_nw(libs: dict, dev, smi: str, rounds: int):
    rng = np.random.default_rng(13)
    for N in (NW_RUN_N, NW_BIG_N):
        ref = rng.integers(0, 256, N).astype(np.uint8)
        r = torch.from_numpy(ref).to(dev)
        q = torch.from_numpy(nw.generate_query(ref, rng)).to(dev)
        out = torch.empty((N, N), dtype=torch.int32, device=dev)
        want = nw.nw_matrix_plain(r, q)
        fns = {}
        for name, lib in libs.items():
            if name == "first":
                fns[name] = caller(entry(lib, "nw_app_launch", FIRST_NW_ARGS),
                                   (r, q, out, N), dev)
                continue
            # flags enough for stripes of 32 rows, the shortest variant's
            flags = torch.empty(-(-N // 32) + 1, dtype=torch.int32,
                                device=dev)
            fns[name] = caller(entry(lib, "nw_app_launch", nw._ARGS),
                               (r, q, out, flags, N, 0), dev)
            if name == "this" and N <= NW_RUN_N:   # one warp, no waits
                fns["this-one-warp"] = caller(
                    entry(lib, "nw_app_launch", nw._ARGS),
                    (r, q, out, flags, N, 1), dev)
        for name, f in fns.items():
            out.fill_(0)
            f()
            if name.startswith("diag-"):
                continue
            if not torch.equal(out, want):
                raise AssertionError(f"nw variant {name} differs from plain "
                                     f"at N = {N}")
        del want
        print(f"nw_app at N = {N}: {sorted(fns)} == plain", flush=True)
        report(f"nw_app N = {N}", in_turns(fns, 3 if N > 10000 else 20,
                                           rounds), smi)
        del out


def time_fill(libs: dict, dev, smi: str, rounds: int, table_only: bool):
    rng = np.random.default_rng(11)
    tmp = tempfile.TemporaryDirectory()
    sets = msa_sets(rng, tmp.name)
    for label, seqs, path in (sets[2:] if table_only else sets):
        cenc, arr, slens = msa.pack_pairs(seqs, 0)
        c, a, sl = (torch.from_numpy(v).to(dev) for v in (cenc, arr, slens))
        t = (None if path is None
             else torch.from_numpy(load_scoring_matrix(path)).to(dev))
        fa = msa.fill_args(c, a, t)
        M, B = fa[5], fa[9]
        want = msa.nw_matrices_batch_plain(c, a, t)
        fns = {}
        for name, lib in libs.items():
            if name == "first":
                Y = torch.empty((fa[7] + 1, fa[8]), dtype=torch.int32,
                                device=dev)
                args = (*fa[:6], Y, *fa[6:9])
                fns[name] = caller(entry(lib, "msa_nw_launch",
                                         FIRST_FILL_ARGS), args, dev)
            else:
                fns[name] = caller(entry(lib, "msa_nw_launch",
                                         msa._FILL_ARGS), fa[:9], dev)
        for name, f in fns.items():
            M.fill_(0)
            f()
            if name.startswith("diag-"):
                continue
            err = cube_err(M.permute(2, 0, 1)[:B], want, sl)
            if err:
                raise AssertionError(f"fill variant {name} differs from "
                                     f"plain at {label}: {err}")
        del want
        print(f"msa_nw.fill at {label} (B = {B} in {fa[8]}, m = {fa[6]}, "
              f"n_pad = {fa[7]}): {sorted(fns)} == plain", flush=True)
        report(f"msa_nw.fill {label}", in_turns(fns, 3, rounds), smi)
        del fa, M, fns
    tmp.cleanup()


def time_sw(libs: dict, dev, smi: str, rounds: int):
    x, y = sw_planted(np.random.default_rng(12))
    for n, wsize in ((SW_X, None), (SW_WIDE_X, SW_WIDE)):
        xd = torch.from_numpy(np.frombuffer(x[:n].encode(),
                                            np.uint8).copy()).to(dev)
        wd = torch.from_numpy(sw.split_windows(y.encode(), n, wsize)[2]).to(dev)
        W, L = wd.shape
        H = torch.empty((W, n + 1, L + 1), dtype=torch.int32, device=dev)
        best = torch.empty(W, dtype=torch.int32, device=dev)
        # flags enough for stripes of 4 rows, the shortest variant's
        flags = torch.empty(W * -(-n // 4) + 1, dtype=torch.int32, device=dev)
        want_H, want_best = sw.sw_matrix_batch_plain(xd, wd)
        fns = {}
        for name, lib in libs.items():
            if name == "first":   # its wrapper's rule: the row in shared
                # memory up to 200 KB, else in a [W, L + 1] scratch
                scratch = (None if 4 * (L + 1) + L <= 200 * 1024 else
                           torch.empty((W, L + 1), dtype=torch.int32,
                                       device=dev))
                fns[name] = caller(entry(lib, "sw_app_launch", FIRST_SW_ARGS),
                                   (xd, wd, H, best, scratch, n, W, L), dev)
            else:
                fns[name] = caller(entry(lib, "sw_app_launch", sw._ARGS),
                                   (xd, wd, H, best, flags, n, W, L, 0), dev)
        for k, f in list(fns.items()):
            H.fill_(-1)
            best.fill_(-1)
            try:
                f()
            except RuntimeError as exc:   # reported, then left out
                print(f"sw_app {k} at {W} x {L} x {n}: {exc}", flush=True)
                del fns[k]
                continue
            if k.startswith("diag-"):
                continue
            if not (torch.equal(H, want_H) and torch.equal(best, want_best)):
                raise AssertionError(f"sw_app {k} differs from plain at {W} x "
                                     f"{L} x {n}")
        del want_H, want_best
        print(f"sw_app at {W} windows of {L} x {n}: {sorted(fns)} == plain",
              flush=True)
        report(f"sw_app {W} x {L} x {n}", in_turns(fns, 3, rounds), smi)
        del H


def time_backtrack(libs: dict, dev, smi: str, rounds: int):
    rng = np.random.default_rng(11)
    tmp = tempfile.TemporaryDirectory()
    for label, seqs, path in msa_sets(rng, tmp.name):
        cenc, arr, slens = msa.pack_pairs(seqs, 0)
        c, a, sl = (torch.from_numpy(v).to(dev) for v in (cenc, arr, slens))
        t = (None if path is None
             else torch.from_numpy(load_scoring_matrix(path)).to(dev))
        M = msa.nw_matrices_batch(c, a, t)
        ba = msa.backtrack_args(M, c, a, sl, t)
        stats = {}
        want = msa.backtrack_batch_plain(M, c, a, sl, t, stats)
        P, B = ba[10], ba[11]
        # the first design's arguments: the pads walked as pairs of length 0
        pad = P - B
        first = (*ba[:2], torch.cat([ba[2], ba[2].new_zeros((ba[2].shape[0],
                                                             pad))], 1),
                 torch.cat([ba[3], ba[3].new_zeros(pad)]), *ba[4:6],
                 torch.zeros((P, ba[6].shape[1]), dtype=torch.int32,
                             device=dev),
                 torch.zeros((P, ba[7].shape[1]), dtype=torch.int32,
                             device=dev), ba[8], ba[9], P)
        fns, outs = {}, {}
        for name, lib in libs.items():
            if name == "first":
                fns[name] = caller(entry(lib, "msa_nw_backtrack_launch",
                                         FIRST_BACKTRACK_ARGS), first, dev)
                outs[name] = first[6:8]
            else:
                fns[name] = caller(entry(lib, "msa_nw_backtrack_launch",
                                         msa._BACKTRACK_ARGS), ba, dev)
                outs[name] = ba[6:8]
        for name, f in fns.items():
            for o in outs[name]:
                o.zero_()
            f()
            if not all(torch.equal(o[:B], w) for o, w in zip(outs[name],
                                                               want)):
                raise AssertionError(f"backtrack variant {name} differs from "
                                     f"plain at {label}")
        print(f"msa_nw.backtrack at {label} (B = {B}, pitch {P}): "
              f"{sorted(fns)} == plain; {stats['steps']} steps, "
              f"{stats['rounds']} rounds ({stats['max_rounds']} the most of a "
              f"pair), {stats['loaded']} words loaded for "
              f"{stats['reads']} needed", flush=True)
        report(f"msa_nw.backtrack {label}", in_turns(fns, 3, rounds), smi)
        del M, ba, first, fns, outs
    tmp.cleanup()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", default="nw,fill,table,sw,backtrack")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "app_variants"))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if args.parent and only & {"nw", "fill", "table"} and \
            only & {"sw", "backtrack"}:
        print("app_variants: --parent takes nw/fill/table or sw/backtrack, "
              "not both", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("app_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    out = Path(args.out)
    nw_src = (_build.CSRC / "nw_app.cu").read_text()
    fill_src = (_build.CSRC / "msa_nw.cu").read_text()
    sw_src = (_build.CSRC / "sw_app.cu").read_text()
    srcs = {}
    if "nw" in only:
        srcs["nw-this"] = nw_src
        srcs |= {f"nw-{k}": edits(nw_src, v) for k, v in NW_VARIANTS.items()}
        srcs |= {f"nw-diag-{k}": edits(nw_src, v) for k, v in NW_DIAG.items()}
    if only & {"fill", "table", "backtrack"}:
        srcs["fill-this"] = fill_src
    if "fill" in only:
        srcs |= {f"fill-{k}": edits(fill_src, v)
                 for k, v in FILL_VARIANTS.items()}
        srcs |= {f"fill-diag-{k}": edits(fill_src, v)
                 for k, v in FILL_DIAG.items()}
    if "table" in only:
        srcs["fill-shared-table"] = edits(fill_src, SHARED_TABLE)
    if "sw" in only:
        srcs["sw-this"] = sw_src
        srcs |= {f"sw-{k}": edits(sw_src, v) for k, v in SW_VARIANTS.items()}
        srcs |= {f"sw-diag-{k}": edits(sw_src, v) for k, v in SW_DIAG.items()}
    if "backtrack" in only:
        srcs |= {f"bt-{k}": edits(fill_src, v)
                 for k, v in BACKTRACK_VARIANTS.items()}
    if args.parent:
        csrc = Path(args.parent) / "genomics_tpu_torch" / "csrc"
        for group, name in (("nw", "nw_app"), ("fill", "msa_nw"),
                            ("sw", "sw_app"), ("backtrack", "msa_nw")):
            if group in only:
                srcs[f"{group}-first"] = (csrc / f"{name}.cu").read_text()
    build_variants(srcs, out)
    libs = {k: out / f"{k}.so" for k in srcs}

    def group(prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in libs.items()
                if k.startswith(prefix)}

    if "nw" in only:
        time_nw(group("nw-"), dev, smi, args.rounds)
    if "fill" in only:
        time_fill({k: v for k, v in group("fill-").items()
                   if k != "shared-table"}, dev, smi, args.rounds, False)
    if "table" in only:
        time_fill({"ldg": libs["fill-this"],
                   "shared-table": libs["fill-shared-table"]},
                  dev, smi, args.rounds, True)
    if "sw" in only:
        time_sw(group("sw-"), dev, smi, args.rounds)
    if "backtrack" in only:
        bt = group("bt-")
        if "backtrack-first" in libs:
            bt["first"] = libs["backtrack-first"]
        time_backtrack({"this": libs["fill-this"], **bt}, dev, smi,
                       args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
