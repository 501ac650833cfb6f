#!/usr/bin/env python3
"""fm_search's and the window filters' designs timed side by side on one
card.

    python3 tools/fm_filter_variants.py --parent DIR [--rounds 3]

csrc/fm_search.cu of this tree (`this`: a 32-byte record a rank, the
suffix table, QPT queries a thread) against DIR's (`first`: one thread a
query, checkpoints every 128 positions and two plane arrays, the index
packed as its ops/fm_search.py packed it) at chip_smoke.py phase 5's
launches: the fmdev seeds of chip_smoke's mapper run (16,384 reads of
150 bp on the 12.07 Mbp genome, recorded from ReadMapper.map_batch) and
1,048,576 queries of 16-32; then csrc/cluster_filter.cu (`this`) against
the torch ops it replaced (`torch`: the prefix filter, the K indicator
products through torch._int_mm and the compares in chunks of job columns
under the old byte budget) at bench_cluster's first window (256 x
49,999).  The kernels are replayed 20 times from a CUDA graph, the torch
ops launched from the host, the variants in turns (this, first, first,
this) over --rounds; every output is held to the plain version's.  The
filter kernel also runs with R (representatives a block) capped at 16
and 8, more blocks of fewer tables.

DIR is an unpacked checkout of the parent of the redesign (`git archive
0aabbc0 genomics_tpu_torch/csrc | tar -x -C DIR`, into a directory
.gitignore lists, such as variants_parent/).  DIR's fm_search.cu is
built into --out (default build/fm_filter_variants).
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
    FM_TIMING_Q,
    MAP_PAIRS,
    MAP_READS,
    cuda_ms,
    family_reads,
    graph_ms,
    mapper_inputs,
    max_abs_err,
    nvidia_smi,
    recording_fm,
)
from genomics_tpu_torch import _build  # noqa: E402
from genomics_tpu_torch.models import cluster as TC  # noqa: E402
from genomics_tpu_torch.models.mapper import ReadMapper  # noqa: E402
from genomics_tpu_torch.ops import cluster_filter as CF  # noqa: E402
from genomics_tpu_torch.ops import fm_search as fs  # noqa: E402
from tools.tb_variants import build_variants  # noqa: E402

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# the first design's entry: p0, p1, W, ckpt, NB, C, primary, n, queries,
# L, qs, qlen, S, lo, hi, stream
FIRST_ARGS = (_vp, _vp, _ci, _vp, _ci, _vp, _ci, _ci, _vp, _ci,
              ctypes.c_longlong, _vp, _ci, _vp, _vp, _vp)
FIRST_RATE = 128
OLD_BUDGET = 1 << 28     # the torch ops' bytes a chunk: bins x (1 + 9 K)
FILTER_ROWS = (32, 16, 8)   # caps of cluster_filter's R, the rule's first


def first_index(fm, dev) -> tuple:
    """(p0, p1, ckpt) of the first design, as its build_device_index
    packed them: [W] int32 planes, [4, NB] int32 counts every 128
    positions, the sentinel stored as 'A' and counted in none."""
    bwt = np.asarray(fm.bwt, np.int64)
    n = fm.n
    primary = int(np.nonzero(bwt == 0)[0][0])
    code = np.where(bwt == 0, 0, bwt - 1).astype(np.uint32)
    W = (n + 31) // 32
    pad = np.zeros(W * 32, np.uint32)
    pad[:n] = code
    bits = pad.reshape(W, 32)
    sh = np.arange(32, dtype=np.uint32)
    p0 = ((bits & 1) << sh).sum(axis=1, dtype=np.uint32)
    p1 = (((bits >> 1) & 1) << sh).sum(axis=1, dtype=np.uint32)
    NB = (n + FIRST_RATE - 1) // FIRST_RATE + 1
    ckpt = np.zeros((4, NB), np.int64)
    aliased = np.where(np.arange(len(pad)) == primary, -1,
                       pad.astype(np.int64))
    starts = np.arange(0, n, FIRST_RATE)
    for s in range(4):
        ckpt[s, 1:] = np.cumsum(np.add.reduceat(aliased[:n] == s, starts))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (p0.view(np.int32), p1.view(np.int32),
                           ckpt.astype(np.int32)))


def first_search(lib, arrays, idx, q, ql):
    """(run, outputs): the first design's launch of q / ql over the index
    whose arrays first_index made."""
    p0, p1, ckpt = arrays
    S, L = q.shape
    out = [torch.empty(S, dtype=torch.int32, device=q.device)
           for _ in range(2)]
    fn = lib.fm_search_launch
    fn.argtypes, fn.restype = list(FIRST_ARGS), ctypes.c_int
    args = (p0.data_ptr(), p1.data_ptr(), p0.shape[0], ckpt.data_ptr(),
            ckpt.shape[1], idx.C.data_ptr(), idx.primary, idx.n,
            q.data_ptr(), L, q.stride(0), ql.data_ptr(), S,
            out[0].data_ptr(), out[1].data_ptr())

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the first fm_search failed: CUDA error {err}")
    return run, out


def torch_filters(D, prefix, wcut, bcut, rp, jp, K: int):
    """The window filters as the torch ops the kernel replaced: D's rows
    gathered, the prefix minimum-sum, the int8 indicator product
    (torch._int_mm) and the compares, in chunks of job columns under
    OLD_BUDGET."""
    S, J = rp.shape[0], jp.shape[0]
    rpl = rp.long()
    pre_r = prefix[rpl][:, None, :]
    D_r = D[rpl]
    p2 = torch.empty((S, J), dtype=torch.uint8, device=D.device)
    step = max(8, OLD_BUDGET // (D.shape[1] * (1 + 9 * K)) // 8 * 8)
    for c0 in range(0, J, step):
        jc = jp[c0:c0 + step].long()
        pre = torch.minimum(pre_r, prefix[jc][None, :, :]).sum(-1)
        p1 = pre >= bcut[jc][None, :]
        got = CF.word_min_sum(D_r, D[jc], K)
        p2[:, c0:c0 + step] = p1 & (got >= wcut[jc][None, :])
    return p2, p2.amax(dim=0) != 0


def in_turns(runs: dict, rounds: int, timer) -> dict:
    """Each run's times over `rounds` of (a, b, b, a)."""
    names = list(runs)
    t = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            t[k].append(timer(runs[k]))
    return t


def spread(ts) -> str:
    return (f"{statistics.median(ts):.4f} ms (median of {len(ts)}, "
            f"{min(ts):.4f}-{max(ts):.4f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "fm_filter_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fm_filter_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    src = Path(args.parent) / "genomics_tpu_torch" / "csrc" / "fm_search.cu"
    out = Path(args.out)
    build_variants({"fm_search_first": src.read_text()}, out)
    first = ctypes.CDLL(str(out / "fm_search_first.so"))
    _build.build_all(("fm_search", "cluster_filter"))

    # fm_search at the mapper's seed launch and at 1,048,576 queries
    contigs, codes, _, reads, _ = mapper_inputs(0, MAP_READS, MAP_PAIRS)
    mapper = ReadMapper(contigs, seeder="fmdev", device=dev)
    seeds = []
    with recording_fm(seeds):
        mapper.map_batch(reads[0], two_stage="ed")
    idx, q, ql = max(seeds, key=lambda r: r[1].shape[0])[:3]
    arrays = first_index(mapper.fm, dev)
    rng = np.random.default_rng(29)
    S = FM_TIMING_Q
    qlen = rng.integers(16, 33, S).astype(np.int32)
    at = rng.integers(0, len(codes) - 32, S)
    Q = codes[at[:, None] + np.arange(32)]
    Q[1::2] = rng.integers(0, 4, (S // 2, 32))
    shapes = {"the mapper's seeds": (q, ql),
              f"{S} queries of 16-32": (torch.from_numpy(Q).to(dev),
                                        torch.from_numpy(qlen).to(dev))}
    for label, (qq, qql) in shapes.items():
        want = fs.backward_search_plain(idx, qq, qql)
        lay = fs.fm_search_layout(idx, qq, qql)
        f_run, f_out = first_search(first, arrays, idx, qq, qql)
        runs = {"this": lambda: fs.launch_fm_search(lay), "first": f_run}
        t = in_turns(runs, args.rounds, lambda fn: graph_ms(fn, 20))
        err = max(max_abs_err(fs.launch_fm_search(lay), want),
                  max_abs_err(f_out, want))
        if err:
            raise AssertionError(f"fm_search disagrees with its plain "
                                 f"version at {label}: {err}")
        gain = statistics.median(t["first"]) / statistics.median(t["this"])
        print(f"fm_search at {label} ({qq.shape[0]} x {qq.shape[1]}, suffix "
              f"table of {idx.tk} codes): this {spread(t['this'])}, first "
              f"{spread(t['first'])}, {gain:.2f}x; both == plain; on {smi}",
              flush=True)

    # the window filters at bench_cluster's first window
    rd = family_reads(np.random.default_rng(0), CLUSTER_READS, CLUSTER_LEN,
                      8, 6)
    wl = TC.auto_word_length(0.95)
    p = TC._prepare(rd, 0.95, wl)
    aux = TC._aux_dev(p, dev)
    K, packed = TC._dense_k(p, wl), TC._packed_dev(p, dev)
    D = CF.dense_rows(packed, torch.arange(CLUSTER_READS, device=dev),
                      1 << 2 * wl)
    rp = torch.arange(CLUSTER_SPEC, dtype=torch.int32, device=dev)
    jp = torch.arange(1, CLUSTER_READS, dtype=torch.int32, device=dev)
    f_args = (packed, aux["prefix"], aux["wcut"], aux["bcut"], rp, jp,
              1 << 2 * wl)
    lays = {most: CF.filter_layout(*f_args, most=most)
            for most in FILTER_ROWS}
    want = CF.window_filters_plain(*f_args, K)
    old = (D, aux["prefix"], aux["wcut"], aux["bcut"], rp, jp, K)
    err = max(max_abs_err(torch_filters(*old), want), *(
        max_abs_err(CF.launch_cluster_filter(lay), want)
        for lay in lays.values()))
    if err:
        raise AssertionError(f"the window filters disagree with the plain "
                             f"version: {err}")
    runs = {f"R = {lay[9]}": lambda lay=lay: graph_ms(
        lambda: CF.launch_cluster_filter(lay), 20) for lay in lays.values()}
    runs["torch"] = lambda: cuda_ms(lambda: torch_filters(*old), 5)
    t = in_turns(runs, args.rounds, lambda timed: timed())
    this = f"R = {lays[FILTER_ROWS[0]][9]}"
    gain = statistics.median(t["torch"]) / statistics.median(t[this])
    print(f"window filters at bench_cluster's first window ({CLUSTER_SPEC} "
          f"x {CLUSTER_READS - 1}, wl = {wl}, K = {K}): cluster_filter "
          + ", ".join(f"{k} {spread(v)}" for k, v in t.items()
                      if k != "torch")
          + f" (a CUDA graph's replay; {this} the rule's), the torch ops "
          f"{spread(t['torch'])} (launched from the host), {gain:.1f}x; "
          f"all == plain; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
