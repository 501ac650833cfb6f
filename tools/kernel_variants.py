#!/usr/bin/env python3
"""What the LOCAL traceback kernel's and the SEMI_GLOBAL start pass's time
is made of: variants of csrc/local_sw.cu and csrc/semiglobal_start.cu
timed side by side on one card.

    python3 tools/kernel_variants.py --parent DIR [--out DIR]

DIR is an unpacked checkout of the commit before the kernels' redesign
(`git archive <commit> | tar -x -C DIR`, into a directory .gitignore
lists).  The script builds, with the port's nvcc flags:

  local_sw-parent          DIR's local_sw.cu, the first design
  local_sw-parent-ahead    that, with the next column's query code and
                           carry loaded one column ahead
  local_sw-parent-bits     that, with TB's extension bits compared against
                           tmp - gapo (no u - ge, e - ge formed)
  local_sw-parent-dpx      that, with the DPX maxima (__vimax3_s32_relu,
                           __viaddmax_s32)
  local_sw-this-top        this tree's local_sw.cu with the loads back at
                           the top of each column
  local_sw-this            this tree's local_sw.cu
  semiglobal_start-parent  DIR's semiglobal_start.cu, the first design
  semiglobal_start-parent-ahead  that, loading one column ahead (the
                           boundary values where no strip has run)
  semiglobal_start-parent-tailt  that, with TAIL_T's capture taken once
                           after column qlen-1 instead of in every cell
  semiglobal_start-parent-dpx    that, with the DPX maxima
  semiglobal_start-this-top      this tree's with the loads at the top
  semiglobal_start-this-dpx      this tree's with the DPX maxima
  semiglobal_start-this    this tree's semiglobal_start.cu
  semiglobal_start-this-64 the same with 64 threads a block

and launches them with CUDA events, the launches alone, in turns (every
variant forward, then backward), at bench.py's shape (65,536 pairs of
152 x 152, half related): local_sw in SCORE (pads remapped, no N
compare), END, TB and SECOND; semiglobal_start at NONE/BOTH (the fullest
tracking), fed the semiglobal_sw END kernel's forward result, in the
launch's order and with the pairs ordered by row_count as the port
launches them (cuda_align.by_row_count: the argsort, the gathers and the
inverse scatter counted; this tree's kernel also on inputs sorted
beforehand), and the parent and the two block sizes also at 10,000
pairs of 216 x 328 (an engine start launch).  Every reading is the mean
of a few launches; --rounds passes (default 2) give each variant
2 x rounds readings, their mean and their spread.  Every variant's
scores, ends and cube (LOCAL) and its starts under all 16 HEAD x TAIL
flags (SEMI_GLOBAL) are compared word for word with the plain versions';
the script exits 1 if any disagrees.  It also prints the lanes' share of semiglobal_start's
work (chip_smoke.lane_share) in the launch's order and sorted.  The
variant sources go to --out (default chiprun_out/kernel_variants), for
tools/sass_report.py --src.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    BENCH_B,
    BENCH_L,
    cuda_ms,
    lane_share,
    nvidia_smi,
    random_codes,
)
from genomics_tpu_torch import _build  # noqa: E402
from genomics_tpu_torch.core.scoring import (  # noqa: E402
    AlgoType,
    AlignmentParams,
    SemiGlobalSkip,
)
from genomics_tpu_torch.ops import cuda_align, scan_align_full  # noqa: E402
from genomics_tpu_torch.ops.scan_align import local_align_batch  # noqa: E402
from tools.tb_variants import build_variants, edit  # noqa: E402

# local_sw.cu: the first design's column loads, at the column's top
LOCAL_TOP = """    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = Q[at];
      const int hcol = s ? gH[at] : 0;
      int e = s ? gE[at] : 0;
"""
LOCAL_AHEAD = """    int qn = Q[b];
    int hn = s ? gH[b] : 0;
    int en = s ? gE[b] : 0;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hcol = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = Q[at + sB];
        hn = s ? gH[at + sB] : 0;
        en = s ? gE[at + sB] : 0;
      }
"""
LOCAL_BITS = """          const int d = (h == tmp) ? (sub >= 0 ? 0 : 1) : (h == u ? 3 : 2);
          const int f_ext = tmpg > u - ge ? 0 : 1;
          const int e_ext = tmpg > e - ge ? 0 : 1;
          word |= static_cast<uint32_t>(d | (e_ext << 2) | (f_ext << 3)) << (4 * c);
"""
LOCAL_BITS_TG = """          const int tg = tmp - (goe - ge);
          const uint32_t d = (h == tmp) ? static_cast<uint32_t>(sub) >> 31
                                        : (h == u ? 3u : 2u);
          word |= (d | (e >= tg ? 4u : 0u) | (u >= tg ? 8u : 0u)) << (4 * c);
"""
LOCAL_MAX = [("        const int h = max(max(tmp, u), max(e, 0));\n",
              "        const int h = __vimax3_s32_relu(tmp, u, e);\n"),
             ("        f[c] = max(tmpg, u - ge);\n        e = max(tmpg, e - ge);\n",
              "        f[c] = __viaddmax_s32(u, -ge, tmpg);\n"
              "        e = __viaddmax_s32(e, -ge, tmpg);\n")]

# semiglobal_start.cu
SEMI_TOP = """    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = a.Q[at];
      int hup, e;
      if (carried) {
        hup = a.gH[at];
        e = a.gE[at];
      } else {
        hup = (HEAD_Q || j == 0) ? 0 : -(gapo + ge * j);
        e = kMinusInf;
      }
"""
SEMI_AHEAD = """    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : kMinusInf;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn;
      int hup = hn, e = en;
      if (j + 1 < Lq) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : (HEAD_Q ? 0 : -(gapo + ge * (j + 1)));
        en = s ? a.gE[at + sB] : kMinusInf;
      }
"""
# this tree's loads ahead, up to its e0
SEMI_THIS_AHEAD = """    int qn = a.Q[b];
    int hn = s ? a.gH[b] : 0;
    int en = s ? a.gE[b] : kMinusInf;
    for (int j = 0; j < Lq; ++j) {
      const size_t at = static_cast<size_t>(j) * sB + b;
      const int qc = qn, hup = hn;
      int e = en;
      if (j + 1 < Lq) {
        qn = a.Q[at + sB];
        hn = s ? a.gH[at + sB] : (HEAD_Q ? 0 : -(gapo + ge * (j + 1)));
        en = s ? a.gE[at + sB] : kMinusInf;
      }
"""
SEMI_CELL_CAPTURE = """        const int r = s * 8 + c;
        if (TAIL_T && j == jl && r < rcnt && r + roff < tl && h > best) {
          best = h;
          row = r + roff;
        }
"""
SEMI_COLUMN_END = """        hl[c] = h;
      }
      a.gH[at] = keep ? hl[7] : hup0;
"""
SEMI_ONCE_CAPTURE = """        hl[c] = h;
      }
      if (TAIL_T && j == jl) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int r = s * 8 + c;
          if (r < rcnt && r + roff < tl && hl[c] > best) {
            best = hl[c];
            row = r + roff;
          }
        }
      }
      a.gH[at] = keep ? hl[7] : hup0;
"""
SEMI_MAX = [("        const int fc = max(hl[c] - goe, f[c] - ge);\n",
             "        const int fc = __viaddmax_s32(f[c], -ge, hl[c] - goe);\n"),
            ("        e = max(phd, e - ge);\n        const int h = max(max(tmp, fc), e);\n",
             "        e = __viaddmax_s32(e, -ge, phd);\n"
             "        const int h = __vimax3_s32(tmp, fc, e);\n")]
THREADS = "constexpr int kThreads = 128;\n"
ENGINE_START_B = 10_000   # about one engine start launch (216 x 328)


def edits(src: str, pairs) -> str:
    for old, new in pairs:
        src = edit(src, old, new)
    return src


def variants(parent: Path) -> dict[str, str]:
    """{"<kernel>-<variant>": source} of every variant."""
    csrc = parent / "genomics_tpu_torch" / "csrc"
    lp = (csrc / "local_sw.cu").read_text()
    sp = (csrc / "semiglobal_start.cu").read_text()
    lt = (_build.CSRC / "local_sw.cu").read_text()
    st = (_build.CSRC / "semiglobal_start.cu").read_text()
    return {
        "local_sw-parent": lp,
        "local_sw-parent-ahead": edit(lp, LOCAL_TOP, LOCAL_AHEAD),
        "local_sw-parent-bits": edit(lp, LOCAL_BITS, LOCAL_BITS_TG),
        "local_sw-parent-dpx": edits(lp, LOCAL_MAX),
        "local_sw-this-top": edit(lt, LOCAL_AHEAD, LOCAL_TOP),
        "local_sw-this": lt,
        "semiglobal_start-parent": sp,
        "semiglobal_start-parent-ahead": edit(sp, SEMI_TOP, SEMI_AHEAD),
        "semiglobal_start-parent-tailt": edits(sp, [
            (SEMI_CELL_CAPTURE, ""), (SEMI_COLUMN_END, SEMI_ONCE_CAPTURE)]),
        "semiglobal_start-parent-dpx": edits(sp, SEMI_MAX),
        "semiglobal_start-this-top": edit(st, SEMI_THIS_AHEAD, SEMI_TOP),
        "semiglobal_start-this-dpx": edits(st, SEMI_MAX),
        "semiglobal_start-this": st,
        "semiglobal_start-this-64": edit(st, THREADS,
                                         THREADS.replace("128", "64")),
    }


def entry(lib: ctypes.CDLL, key: tuple):
    fn = getattr(lib, key[1])
    fn.argtypes, fn.restype = list(cuda_align._SIGNATURES[key]), ctypes.c_int
    return fn


def runner(fn, args, dev):
    """A launch of fn on args (tensors as their pointers) on dev's stream;
    returns args, whose last entries are the outputs."""
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]

    def run():
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
        return args
    return run


def second_args(Q, T, ql, tl, P):
    """local_sw_second_launch's arguments but the stream."""
    Lq, B = Q.shape
    out = [torch.empty(B, dtype=torch.int32, device=Q.device) for _ in range(6)]
    gH, gE = cuda_align._carry("local_sw", Q, T)
    return (Q, T, ql, tl, B, Lq, T.shape[0], P.match, P.mismatch,
            cuda_align._n_score(P), P.gap_oe, P.gap_extend, gH, gE, *out)


def sorted_start(fn, args, dev):
    """fn on args with the pairs ordered by row_count, as
    cuda_align.launch_semiglobal_start orders them: the argsort, the
    gathers and the inverse scatter of the starts inside the call."""
    def run():
        ordered, order = cuda_align.by_row_count(args)
        runner(fn, ordered, dev)()
        return [torch.empty_like(x).index_copy_(0, order, x)
                for x in ordered[-2:]]
    return run


def in_turns(fns: dict, reps: int, rounds: int) -> dict:
    """{name: [readings]}: each fn's mean ms over reps launches, the fns
    read forward then backward, `rounds` times."""
    ms = {k: [] for k in fns}
    for _ in range(rounds):
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(cuda_ms(fns[k], reps))
    return ms


def report(ms: dict, ref: str, what: str, smi: str):
    """One line per variant: the mean of its readings, their spread and
    the ratio of the means to `ref`'s."""
    base = np.mean(ms[ref])
    for k, v in ms.items():
        print(f"{k}: {np.mean(v):.4f} ms (readings {min(v):.4f}-"
              f"{max(v):.4f}; {np.mean(v) / base:.3f}x {ref}), {what}, "
              f"on {smi}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "kernel_variants"))
    ap.add_argument("--rounds", type=int, default=2,
                    help="forward-and-backward passes over the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    out = Path(args.out)
    srcs = variants(Path(args.parent))
    build_variants(srcs, out)
    libs = {name: ctypes.CDLL(str(out / f"{name}.so")) for name in srcs}
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    qn, tn, qln, tln = random_codes(np.random.default_rng(0), BENCH_B,
                                    BENCH_L, BENCH_L, 0.0)
    q, t = torch.from_numpy(qn).to(dev), torch.from_numpy(tn).to(dev)
    ql, tl = torch.from_numpy(qln).to(dev), torch.from_numpy(tln).to(dev)
    Q, T = q.T.contiguous(), t.T.contiguous()
    Qs, Ts = (cuda_align._pads_to_sentinels(x, c) for x, c in ((Q, 16), (T, 17)))
    P = AlignmentParams()
    PS = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    same, bad = {}, []

    def check(name, got, want):
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        same[name] = ok
        if not ok:
            bad.append(name)

    # local_sw: every mode of every variant against the plain version
    plain = local_align_batch(q, t, P, with_tb=True)
    plain2 = scan_align_full.local_align_second_batch(q, t, ql, tl, P)
    local = {}
    for name in (n for n in srcs if n.startswith("local_sw")):
        launch = entry(libs[name], ("local_sw", "local_sw_launch"))
        second = entry(libs[name], ("local_sw", "local_sw_second_launch"))
        for mode in ("score", "end", "tb"):
            a = (cuda_align.local_launch_args(mode, Qs, Ts, P, False)
                 if mode == "score" else
                 cuda_align.local_launch_args(mode, Q, T, P, True))
            local[f"{name} {mode}"] = runner(launch, a, dev)
        local[f"{name} second"] = runner(second, second_args(Q, T, ql, tl, P),
                                         dev)
        for mode, want in (("score", plain[:1]), ("end", plain[:3]),
                           ("tb", plain)):
            check(f"{name} {mode}", local[f"{name} {mode}"]()[-4:], want)
        check(f"{name} second", local[f"{name} second"]()[-6:], plain2)
    torch.cuda.synchronize()
    del plain, plain2
    report(in_turns(local, 5, args.rounds), "local_sw-parent end",
           f"B={BENCH_B} {BENCH_L}x{BENCH_L}", smi)

    # semiglobal_start: all 16 flags, each fed the forward END result
    skips = [SemiGlobalSkip.NONE, SemiGlobalSkip.QUERY,
             SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH]
    semi = [n for n in srcs if n.startswith("semiglobal_start")]
    timed = {}
    for head, tail in itertools.product(skips, skips):
        fwd = cuda_align.semiglobal_align(q, t, ql, tl, PS, head=head,
                                          tail=tail)
        rev = scan_align_full.semiglobal_start_inputs(q, t, ql, tl,
                                                      fwd.target_end)
        per = (ql, tl, *rev[2:], fwd.score, fwd.query_end)
        flags = scan_align_full.skip_flags(head, tail)
        want = scan_align_full._semiglobal_start_core(
            *rev[:2], *per, PS, **flags, count_strips=True)
        for name in semi:
            fn = entry(libs[name], ("semiglobal_start",
                                    "semiglobal_start_launch"))
            a = cuda_align.semiglobal_start_launch_args(
                rev[0].T, rev[1].T, *per, PS, **flags)
            run = runner(fn, a, dev)
            check(f"{name} {head.name}/{tail.name}", run()[-2:], want[:2])
            if (head, tail) == (SemiGlobalSkip.NONE, SemiGlobalSkip.BOTH):
                timed[name] = run
                srt = timed[f"{name} sorted"] = sorted_start(fn, a, dev)
                check(f"{name} sorted", srt(), want[:2])
                if name == "semiglobal_start-this":
                    ordered, _ = cuda_align.by_row_count(a)
                    timed[f"{name} on sorted inputs"] = runner(fn, ordered,
                                                               dev)
                    strips = want[2]
                    order = torch.argsort(a[6])
                    print(f"semiglobal_start NONE/BOTH: lanes' share of "
                          f"the strips {lane_share(strips):.4f} in the "
                          f"launch's order, "
                          f"{lane_share(strips[order]):.4f} sorted by "
                          f"row_count; {int(strips.sum())} strips",
                          flush=True)
    torch.cuda.synchronize()
    report(in_turns(timed, 10, args.rounds), "semiglobal_start-parent",
           f"NONE/BOTH, B={BENCH_B} {BENCH_L}x{BENCH_L}", smi)

    # the block size at an engine start launch's size
    qn, tn, qln, tln = random_codes(np.random.default_rng(1), ENGINE_START_B,
                                    216, 328, 0.0)
    q, t = torch.from_numpy(qn).to(dev), torch.from_numpy(tn).to(dev)
    ql, tl = torch.from_numpy(qln).to(dev), torch.from_numpy(tln).to(dev)
    sg = dict(head=SemiGlobalSkip.NONE, tail=SemiGlobalSkip.BOTH)
    fwd = cuda_align.semiglobal_align(q, t, ql, tl, PS, **sg)
    rev = scan_align_full.semiglobal_start_inputs(q, t, ql, tl, fwd.target_end)
    per = (ql, tl, *rev[2:], fwd.score, fwd.query_end)
    flags = scan_align_full.skip_flags(**sg)
    want = scan_align_full._semiglobal_start_core(*rev[:2], *per, PS, **flags)
    small = {}
    for name in ("semiglobal_start-parent", "semiglobal_start-this",
                 "semiglobal_start-this-64"):
        fn = entry(libs[name], ("semiglobal_start", "semiglobal_start_launch"))
        a = cuda_align.semiglobal_start_launch_args(rev[0].T, rev[1].T, *per,
                                                    PS, **flags)
        small[name] = runner(fn, a, dev)
        small[f"{name} sorted"] = sorted_start(fn, a, dev)
        check(f"{name} B={ENGINE_START_B}", small[name]()[-2:], want)
        check(f"{name} sorted B={ENGINE_START_B}", small[f"{name} sorted"](),
              want)
    report(in_turns(small, 20, args.rounds), "semiglobal_start-parent",
           f"NONE/BOTH, B={ENGINE_START_B} 216x328", smi)
    print(json.dumps({"all equal to the plain versions": not bad,
                      "disagree": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
