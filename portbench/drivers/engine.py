"""GASAL2's streaming loop through `AlignEngine`.

The configuration's test program (test_prog.cpp) keeps `streams`
batches of `batch` pairs in flight and, as each comes back, takes its
results and launches the next.  Here one host thread does the same
through `align_async` / `AsyncHandle.result()`: it waits for the oldest
batch, takes its results, and submits the next slice of the pool, in
turn.  The pool is made from the seed in set-up; a pass over it in
set-up warms every shape the window uses.

Spans (host clock): `submit` around align_async, `collect` around
result(), `batch` from a batch's submit to its results.  Counts: pairs
`done` in the window, `attempted` (every pair submitted in it),
`failed` (results missing).  A window's `served` lists the slices of
the pool its batches held.  Each batch keeps `sample` results, drawn
from the seed, and its longest pair's, for the comparison.
"""
from __future__ import annotations

import time
import types
from collections import deque

import numpy as np

from portbench import generators
from portbench.harness import Check
from portbench.reference import align
from portbench.work import gotoh

SAMPLE_SALT = 0x5A17
CONTROL_BITS = 8          # the control's cells: int8 for the stated int16


def _scoring(config) -> tuple:
    s = config["scoring"]
    return (s["match"], s["mismatch"], s["gap_open"], s["gap_extend"])


def setup(run):
    import torch
    from genomics_tpu_torch.core.scoring import AlignmentParams, AlgoType
    from genomics_tpu_torch.runtime.dispatch import AlignEngine
    from torch.profiler import record_function

    cfg, mix = run.config, run.traffic
    n = cfg["pool"]
    qs, ts = generators.gasal_pairs(np.random.default_rng(run.seed), n,
                                    **cfg["pairs"])
    m, mm, go, ge = _scoring(cfg)
    eng = AlignEngine(AlignmentParams(match=m, mismatch=mm, gap_open=go,
                                      gap_extend=ge, algo=AlgoType.LOCAL),
                      with_tb=mix["traceback"], score_only=mix["score_only"],
                      device=run.device)
    slices = [slice(a, min(a + cfg["batch"], n))
              for a in range(0, n, cfg["batch"])]
    for s in slices:            # every bucket and chunk shape of the pool
        eng.align_async(qs[s], ts[s]).result()
    if run.device.startswith("cuda"):
        torch.cuda.synchronize()
    longest = [s.start + int(np.argmax([len(qs[k]) * len(ts[k])
                                        for k in range(s.start, s.stop)]))
               for s in slices]
    return dict(engine=eng, qs=qs, ts=ts, slices=slices, longest=longest,
                issued=0, kept=[], annotate=record_function)


def serve(run, state, win, t_end):
    eng, qs, ts = state["engine"], state["qs"], state["ts"]
    slices, kept, mark = state["slices"], state["kept"], state["annotate"]
    spans, counts = win.spans, win.counts
    flight = deque()

    def submit():
        b = state["issued"]
        state["issued"] += 1
        s = slices[b % len(slices)]
        with mark("engine.submit"):
            a = time.perf_counter()
            h = eng.align_async(qs[s], ts[s])
            spans["submit"].append(time.perf_counter() - a)
        flight.append((b, s, a, h))
        counts["attempted"] += s.stop - s.start

    for _ in range(run.config["streams"]):
        submit()
    while flight:
        b, s, a, h = flight.popleft()
        with mark("engine.collect"):
            c = time.perf_counter()
            res = h.result()
            end = time.perf_counter()
        spans["collect"].append(end - c)
        spans["batch"].append(end - a)
        n = s.stop - s.start
        counts["failed"] += max(0, n - len(res))
        if end <= t_end:
            counts["done"] += n
            counts["batches"] += 1
        win.served.append(b % len(slices))
        _keep(run.seed, b, s, res, state["longest"][b % len(slices)],
              run.traffic["sample"], kept)
        if end < t_end:
            submit()


def _keep(seed, b, s, res, longest, k, kept):
    """Keep the results of `k` positions of batch b drawn from the seed,
    and of the batch's longest pair: (pool index, job); a position past
    the results the batch gave is already counted as failed."""
    n = s.stop - s.start
    rng = np.random.default_rng([seed, SAMPLE_SALT, b])
    picks = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    picks.add(longest - s.start)
    kept += [(s.start + p, res[p]) for p in sorted(picks) if p < len(res)]


def release(state):
    state.pop("engine")


def reference(run, qs, ts, bits=None):
    """The reference's results over the pool, as dicts."""
    return align.align_local(qs, ts, _scoring(run.config),
                             with_tb=run.traffic["traceback"],
                             device=run.device, bits=bits)


def compare(kept, want, min_compared) -> list[Check]:
    """Each field of the kept results against the reference's."""
    bad = dict(score=0, ends=0, starts=0, cigar=0)
    compared = 0
    for k, job in kept:
        w = want[k]
        compared += 1
        if job is None:                 # a result slot left empty
            for key in bad:
                bad[key] += 1
            continue
        bad["score"] += job.score != w["score"]
        bad["ends"] += (job.query_end, job.target_end) != (
            w["query_end"], w["target_end"])
        bad["starts"] += (job.query_start, job.target_start) != (
            w["query_start"], w["target_start"])
        got = b"" if job.cigar is None else bytes(job.cigar)
        bad["cigar"] += got != w["cigar"]
    return [Check("compared", compared, min=min_compared)] + [
        Check(f"{k}_mismatch", v, max=0) for k, v in bad.items()]


def check(run, state):
    qs, ts = state["qs"], state["ts"]
    want = reference(run, qs, ts)
    checks = compare(state["kept"], want, run.traffic["min_compared"])
    checks.insert(1, Check("missing", sum(w.counts["failed"]
                                          for w in run.windows), max=0))
    if run.traced is not None:
        run.work = window_work(run, state, want, run.traced)
    return checks


def control(run):
    """The control's checks over the cell's whole pool: the reference
    with its cells clamped to int8, where the configuration needs int16,
    against the reference at full width."""
    cfg = run.config
    qs, ts = generators.gasal_pairs(np.random.default_rng(run.seed),
                                    cfg["pool"], **cfg["pairs"])
    want = reference(run, qs, ts)
    low = reference(run, qs, ts, bits=CONTROL_BITS)
    kept = [(k, types.SimpleNamespace(**d)) for k, d in enumerate(low)]
    return compare(kept, want, run.traffic["min_compared"])


def window_work(run, state, want, win) -> dict:
    """Least work of every batch the window served: each pool pair's
    work once for each batch that held it."""
    qs, ts, slices = state["qs"], state["ts"], state["slices"]
    tb = run.traffic["traceback"]
    outs = 5 if tb else 1        # score, ends, starts with traceback
    ops = nbytes = 0.0
    per_slice = []
    for s in slices:
        per = [gotoh.pair_work(len(qs[k]), len(ts[k]), True,
                               want[k]["cigar"] if tb else None, outs)
               for k in range(s.start, s.stop)]
        per_slice.append((sum(p[0] for p in per), sum(p[1] for p in per)))
    for i in win.served:
        ops += per_slice[i][0]
        nbytes += per_slice[i][1]
    return {"int32_ops": ops, "bytes": nbytes}
