#!/usr/bin/env python3
"""What the GLOBAL traceback kernel's time is made of: variants of
csrc/global_sw.cu timed side by side on one card.

    python3 tools/tb_variants.py --parent DIR [--out DIR]

DIR is an unpacked checkout of the commit before the kernel's redesign
(`git archive <commit> | tar -x -C DIR`, into a directory .gitignore
lists).  The script builds, with the port's nvcc flags:

  parent          DIR's global_sw.cu, the first design
  parent-capture  the same without its per-cell score capture
                  (`if (j == jl && c == cl) score = h;`; the score is
                  then wrong, the cube right)
  parent-prefetch that, with the next column's query code and carry
                  loaded one column ahead
  this-noprefetch this tree's global_sw.cu with the loads back at the
                  top of each column
  this-parentcell this tree's global_sw.cu with the first design's cell
  this-vibmax     this tree's global_sw.cu with the TB cell's maxima as
                  __vibmax_s32, the direction bits from its predicates
  this            this tree's global_sw.cu

and launches each in SCORE and TB mode at bench.py's shape (65,536
pairs of 152 x 152, half related) with CUDA events, the launches alone,
in turns (every variant forward, then backward), beside local_sw's
SCORE and semiglobal_sw's TB (NONE/BOTH) of the same call.  Every
variant's cube and scores are compared word for word with the plain
version's.  The variant sources go to --out (default
chiprun_out/tb_variants), for tools/sass_report.py --src.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import BENCH_B, BENCH_L, cuda_ms, nvidia_smi, random_codes  # noqa: E402
from genomics_tpu_torch import _build  # noqa: E402
from genomics_tpu_torch.core.scoring import (  # noqa: E402
    AlgoType,
    AlignmentParams,
    SemiGlobalSkip,
)
from genomics_tpu_torch.ops import cuda_align  # noqa: E402
from genomics_tpu_torch.ops.scan_align import global_align_batch  # noqa: E402

CAPTURE = "        if (j == jl && c == cl) score = h;\n"
PARENT_LOADS = """    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      const int hcol = s ? gH[at] : (j ? -(gapo + ge * j) : 0);
      int e = s ? gE[at] : kMinusInf;
"""
PREFETCH = """    int qn = Q[b];
    int hn = s ? gH[b] : 0;
    int en = s ? gE[b] : kMinusInf;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = Q[at + sB];
        hn = s ? gH[at + sB] : -(gapo + ge * (j + 1));
        en = s ? gE[at + sB] : kMinusInf;
      }
"""


THIS_CELL = """        const int tmpg = tmp - goe;
        const int h = __vimax3_s32(tmp, u, e);
        if (MODE == TB) {
          // direction from the pre-update chains (pallas_align.py:1233-
          // 1240); f_ext = !(tmp - goe > u - ge) = (u >= tmp - gapo)
          const int tg = tmp - gapo;
          const uint32_t d = (h == tmp) ? static_cast<uint32_t>(sub) >> 31
                                        : (h == u ? 3u : 2u);
          word |= (d | (e >= tg ? 4u : 0u) | (u >= tg ? 8u : 0u)) << (4 * c);
        }
        f[c] = __viaddmax_s32(u, -ge, tmpg);
        e = __viaddmax_s32(e, -ge, tmpg);
"""
# the first design's cell
PARENT_CELL = """        const int h = max(max(tmp, u), e);
        const int tmpg = tmp - goe;
        if (MODE == TB) {
          const int d = (h == tmp) ? (sub >= 0 ? 0 : 1) : (h == u ? 3 : 2);
          const int f_ext = tmpg > u - ge ? 0 : 1;
          const int e_ext = tmpg > e - ge ? 0 : 1;
          word |= static_cast<uint32_t>(d | (e_ext << 2) | (f_ext << 3)) << (4 * c);
        }
        f[c] = max(tmpg, u - ge);
        e = max(tmpg, e - ge);
"""
# the direction bits from __vibmax_s32's predicates
VIBMAX_CELL = """        const int tmpg = tmp - goe;
        int h;
        if (MODE == TB) {
          bool p1, p2, f_ext, e_ext;
          h = __vibmax_s32(__vibmax_s32(tmp, u, &p1), e, &p2);
          f[c] = __vibmax_s32(u - ge, tmpg, &f_ext);
          e = __vibmax_s32(e - ge, tmpg, &e_ext);
          const uint32_t d = p2 ? (p1 ? static_cast<uint32_t>(sub) >> 31 : 3u)
                                : 2u;
          word |= (d | (e_ext ? 4u : 0u) | (f_ext ? 8u : 0u)) << (4 * c);
        } else {
          h = __vimax3_s32(tmp, u, e);
          f[c] = __viaddmax_s32(u, -ge, tmpg);
          e = __viaddmax_s32(e, -ge, tmpg);
        }
"""


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the variant's edit does not apply: {old!r}")
    return src.replace(old, new)


def variants(parent: Path) -> dict[str, str]:
    p = (parent / "genomics_tpu_torch" / "csrc" / "global_sw.cu").read_text()
    this = (_build.CSRC / "global_sw.cu").read_text()
    no_capture = edit(p, CAPTURE, "")
    return {"parent": p, "parent-capture": no_capture,
            "parent-prefetch": edit(no_capture, PARENT_LOADS, PREFETCH),
            "this-noprefetch": edit(this, PREFETCH, PARENT_LOADS),
            "this-parentcell": edit(this, THIS_CELL, PARENT_CELL),
            "this-vibmax": edit(this, THIS_CELL, VIBMAX_CELL),
            "this": this}


def build_variants(srcs: dict[str, str], out: Path):
    """Write each variant's source to out/<name>.cu and build it into
    out/<name>.so with the port's nvcc flags, one nvcc per source, as
    many at a time as the machine has cores."""
    out.mkdir(parents=True, exist_ok=True)
    names = list(srcs)
    step = os.cpu_count() or 1
    for at in range(0, len(names), step):
        jobs = {}
        for name in names[at:at + step]:
            cu = out / f"{name}.cu"
            cu.write_text(srcs[name])
            jobs[name] = subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for name, proc in jobs.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "tb_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tb_variants: no CUDA device", file=sys.stderr)
        return 2
    out = Path(args.out)
    srcs = variants(Path(args.parent))
    build_variants(srcs, out)

    dev = torch.device("cuda", 0)
    qn, tn, qln, tln = random_codes(np.random.default_rng(0), BENCH_B,
                                    BENCH_L, BENCH_L, 0.0)
    q, t = torch.from_numpy(qn).to(dev), torch.from_numpy(tn).to(dev)
    ql, tl = torch.from_numpy(qln).to(dev), torch.from_numpy(tln).to(dev)
    PG = AlignmentParams(algo=AlgoType.GLOBAL)
    PS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    P = AlignmentParams()
    sig = list(cuda_align._SIGNATURES["global_sw", "global_sw_launch"])
    fns, results = {}, {}   # results keeps every launch's tensors alive
    for name in srcs:
        fn = ctypes.CDLL(str(out / f"{name}.so")).global_sw_launch
        fn.argtypes, fn.restype = sig, ctypes.c_int
        for tb in (False, True):
            a = results[name, tb] = cuda_align.global_launch_args(
                q.T, t.T, ql, tl, PG, tb)
            ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
                    for x in a]

            def run(fn=fn, ptrs=ptrs):
                err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"global_sw_launch failed: {err}")
            fns[f"{name} {'tb' if tb else 'score'}"] = run
    Qs, Ts = (cuda_align._pads_to_sentinels(x.T.contiguous(), c)
              for x, c in ((q, 16), (t, 17)))
    fns["local_sw.score"] = lambda: cuda_align._launch("score", Qs, Ts, P,
                                                       False)
    fns["semiglobal_sw.tb NONE/BOTH (wrapper)"] = (
        lambda: cuda_align.semiglobal_align(q, t, ql, tl, PS, with_tb=True,
                                            head=SemiGlobalSkip.NONE,
                                            tail=SemiGlobalSkip.BOTH))
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    plain = global_align_batch(q, t, ql, tl, PG, with_tb=True)
    same = {name: {"cube == plain": bool(torch.equal(results[name, True][-1],
                                                     plain.tb)),
                   "tb score == plain": bool(torch.equal(
                       results[name, True][-2], plain.score)),
                   "score mode == plain": bool(torch.equal(
                       results[name, False][-2], plain.score))}
            for name in srcs}
    ms = dict.fromkeys(fns, 0.0)
    for k in list(fns) + list(fns)[::-1]:
        ms[k] += cuda_ms(fns[k], 5) / 2
    smi = nvidia_smi()
    loc = ms["local_sw.score"]
    for k, v in ms.items():
        print(f"{k}: {v:.4f} ms ({v / loc:.3f}x local_sw.score), B={BENCH_B}"
              f" {BENCH_L}x{BENCH_L}, on {smi}", flush=True)
    print(json.dumps(same), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
