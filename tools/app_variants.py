#!/usr/bin/env python3
"""The design choices of the app kernels, timed side by side on one card.

    python3 tools/app_variants.py [--parent DIR] [--rounds 5] [--out DIR]
                                  [--only nw,fill,table,sw]

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

sw: sw_app.cu's row in shared memory and in its global scratch at
chip_smoke's SW shapes (100 windows of 3,000 against 1,000 bp; the
scratch also at 7 windows of 45,000 against 200 bp).

DIR is an unpacked checkout of the commit before the kernels' redesign
(`git archive 5ef7697 genomics_tpu_torch/csrc | tar -x -C DIR`, into a
directory .gitignore lists, such as variants_parent/).  Launches alone,
CUDA events, in turns (every variant forward, then backward) over
--rounds; every output is compared word for word with the plain
version's.  The variant sources and libraries go to --out (default
chiprun_out/app_variants).
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

# the first designs' entry points: nw_app_launch(reference, query, out, N,
# stream); msa_nw_launch(center, seqs, slens, table, A, M, Y, m, n_pad, B,
# stream)
FIRST_NW_ARGS = (_vp, _vp, _vp, _ci, _vp)
FIRST_FILL_ARGS = (_vp, _vp, _vp, _vp, _ci, _vp, _vp, _ci, _ci, _ci, _vp)


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


def time_sw(dev, smi: str, rounds: int):
    x, y = sw_planted(np.random.default_rng(12))
    for n, wsize in ((SW_X, None), (SW_WIDE_X, SW_WIDE)):
        xd = torch.from_numpy(np.frombuffer(x[:n].encode(),
                                            np.uint8).copy()).to(dev)
        wd = torch.from_numpy(sw.split_windows(y.encode(), n, wsize)[2]).to(dev)
        W, L = wd.shape
        H = torch.empty((W, n + 1, L + 1), dtype=torch.int32, device=dev)
        best = torch.empty(W, dtype=torch.int32, device=dev)
        scratch = torch.empty((W, L + 1), dtype=torch.int32, device=dev)
        want_H, want_best = sw.sw_matrix_batch_plain(xd, wd)
        fns = {"scratch": lambda: sw.launch_sw(xd, wd, H, best, scratch)}
        if sw.shared_row(L):
            fns["shared"] = lambda: sw.launch_sw(xd, wd, H, best, None)
        for k, f in fns.items():
            H.zero_()
            f()
            if not (torch.equal(H, want_H) and torch.equal(best, want_best)):
                raise AssertionError(f"sw_app {k} differs from plain at {W} x "
                                     f"{L} x {n}")
        del want_H, want_best
        print(f"sw_app at {W} windows of {L} x {n}: {sorted(fns)} == plain; "
              f"the wrapper takes "
              f"{'shared' if sw.shared_row(L) else 'scratch'}", flush=True)
        report(f"sw_app {W} x {L} x {n}", in_turns(fns, 3, rounds), smi)
        del H, scratch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", default="nw,fill,table,sw")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "app_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("app_variants: no CUDA device", file=sys.stderr)
        return 2
    only = set(args.only.split(","))
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    out = Path(args.out)
    nw_src = (_build.CSRC / "nw_app.cu").read_text()
    fill_src = (_build.CSRC / "msa_nw.cu").read_text()
    srcs = {"nw-this": nw_src, "fill-this": fill_src,
            "fill-shared-table": edits(fill_src, SHARED_TABLE)}
    srcs |= {f"nw-{k}": edits(nw_src, v) for k, v in NW_VARIANTS.items()}
    srcs |= {f"fill-{k}": edits(fill_src, v) for k, v in FILL_VARIANTS.items()}
    srcs |= {f"nw-diag-{k}": edits(nw_src, v) for k, v in NW_DIAG.items()}
    srcs |= {f"fill-diag-{k}": edits(fill_src, v)
             for k, v in FILL_DIAG.items()}
    if args.parent:
        csrc = Path(args.parent) / "genomics_tpu_torch" / "csrc"
        srcs["nw-first"] = (csrc / "nw_app.cu").read_text()
        srcs["fill-first"] = (csrc / "msa_nw.cu").read_text()
    build_variants(srcs, out)
    _build.build_all(("sw_app",))
    libs = {k: out / f"{k}.so" for k in srcs}

    if "nw" in only:
        time_nw({k[3:]: v for k, v in libs.items() if k.startswith("nw-")},
                dev, smi, args.rounds)
    if "fill" in only:
        time_fill({k[5:]: v for k, v in libs.items()
                   if k.startswith("fill-") and k != "fill-shared-table"},
                  dev, smi, args.rounds, False)
    if "table" in only:
        time_fill({"ldg": libs["fill-this"],
                   "shared-table": libs["fill-shared-table"]},
                  dev, smi, args.rounds, True)
    if "sw" in only:
        time_sw(dev, smi, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
