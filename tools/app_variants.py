#!/usr/bin/env python3
"""The storage choices of the app kernels, timed side by side on one card.

    python3 tools/app_variants.py [--rounds 5] [--out DIR]

msa_nw.cu's fill reads its compact score table through __ldg.  The script
builds a variant of this tree's csrc/msa_nw.cu whose fill first stages
the table in shared memory (`shared-table`, the port's first design) and
times both fills at chip_smoke's protein set (MSA_PROTEIN: 512 sequences
of about 300 under a synthetic NCBI matrix, the table's 21 codes).

sw_app.cu keeps a window's row in shared memory up to
`sw.SHARED_ROW_BYTES` and in a global [W, L + 1] scratch beyond.  The
script times both at the app's default windows for chip_smoke's SW
fragment (100 windows of 3,000 against 1,000 bp), and the scratch at
chip_smoke's wide case (7 windows of 45,000 against 200 bp).

Launches alone, CUDA events, in turns (every variant forward, then
backward) over --rounds; every output is compared word for word with the
other variant's and the plain version's.  The variant source and library
go to --out (default chiprun_out/app_variants).
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
from genomics_tpu_torch.models import msa, sw  # noqa: E402
from tools.tb_variants import build_variants  # noqa: E402

# this tree's fill -> the fill that stages the table in shared memory
SHARED_TABLE = [
    ("  const int b = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (b >= B) return;\n  const int n = slens[b];\n",
     "  extern __shared__ int stab[];\n"
     "  if constexpr (kTable) {\n"
     "    for (int k = threadIdx.x; k < A * A; k += blockDim.x)"
     " stab[k] = table[k];\n"
     "    __syncthreads();\n"
     "  }\n"
     "  const int b = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (b >= B) return;\n  const int n = slens[b];\n"),
    ("kTable ? table + ci * A : nullptr", "kTable ? stab + ci * A : nullptr"),
    ("kTable ? __ldg(trow + cs[k])", "kTable ? trow[cs[k]]"),
    ("msa_fill_kernel<true><<<blocks, kThreads, 0, s>>>(",
     "msa_fill_kernel<true><<<blocks, kThreads, sizeof(int) * A * A, s>>>("),
]


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "app_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("app_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    out = Path(args.out)
    _build.build_all(("msa_nw", "sw_app"))
    build_variants({"shared-table": edits(
        (_build.CSRC / "msa_nw.cu").read_text(), SHARED_TABLE)}, out)
    fn = ctypes.CDLL(str(out / "shared-table.so")).msa_nw_launch
    fn.argtypes, fn.restype = list(msa._FILL_ARGS), ctypes.c_int

    # -- the MSA fill at the protein set --------------------------------
    rng = np.random.default_rng(11)
    tmp = tempfile.TemporaryDirectory()
    _, seqs, path = msa_sets(rng, tmp.name)[2]
    cenc, arr, slens = msa.pack_pairs(seqs, 0)
    c, a, sl = (torch.from_numpy(v).to(dev) for v in (cenc, arr, slens))
    t = torch.from_numpy(load_scoring_matrix(path)).to(dev)
    ldg = msa.fill_args(c, a, t)
    staged = msa.fill_args(c, a, t)
    raw = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in staged]

    def shared_table():
        err = fn(*raw, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"shared-table msa_nw_launch: CUDA error {err}")

    got = msa.launch_fill(ldg)
    shared_table()
    want = msa.nw_matrices_batch_plain(c, a, t)
    errs = (cube_err(got, want, sl), cube_err(staged[5].permute(2, 0, 1),
                                              want, sl))
    if any(errs):
        raise AssertionError(f"msa fill variants differ from plain: {errs}")
    del want
    print(f"msa_nw.fill at {len(seqs)} protein x ~300 (A = {ldg[4]}, "
          f"B = {ldg[9]}, m = {ldg[7]}, n_pad = {ldg[8]}): both == plain",
          flush=True)
    report("msa_nw.fill", in_turns({"ldg": lambda: msa.launch_fill(ldg),
                                    "shared-table": shared_table}, 5,
                                   args.rounds), smi)
    del ldg, staged, raw, got
    tmp.cleanup()

    # -- sw_app's row in shared memory and in the scratch ---------------
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
        report(f"sw_app {W} x {L} x {n}", in_turns(fns, 3, args.rounds), smi)
        del H, scratch
    return 0


if __name__ == "__main__":
    sys.exit(main())
