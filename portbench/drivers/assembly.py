"""nvMicroAssembly's HaplotypeCaller pipeline through `local_assembly`.

One active region at a time, in turn from a pool of regions made from
the seed in set-up, each a call of `models/assembly.local_assembly` on
the card (the host de Bruijn graph, the wavefront PairHMM, the GLOBAL
traceback of the best haplotype).  Set-up runs one region to load and
warm every kernel the window uses.

Spans (host clock): `region`, each call.  Counts: regions `done` in the
window, `attempted`, `failed` (none: a call that raises ends the run).
Every result is kept in its window's `served` as (pool index, result);
the comparison takes `sample` of them over all windows, drawn from the
seed, and the region with the most PairHMM cells.
"""
from __future__ import annotations

import time

import numpy as np

from portbench import generators
from portbench.harness import Check
from portbench.reference import assembly as ref_asm
from portbench.work import gotoh, pairhmm

SAMPLE_SALT = 0xA55E
CONTROL_BITS = 8          # the control's GLOBAL cells: int8 for int16


def setup(run):
    import torch
    from genomics_tpu_torch.models import assembly
    from torch.profiler import record_function

    cfg, mix = run.config, run.traffic
    regions = generators.assembly_regions(
        np.random.default_rng(run.seed), cfg["pool"], reads=mix["reads"],
        **cfg["regions"])
    a = cfg["assembly"]
    kw = dict(k=a["kmer_size"], k_best=a["k_best_haplotypes"],
              min_edge_weight=a["min_edge_weight"], device=run.device)
    # a region whose best haplotype is not the reference: every kernel
    for ref, reads in regions:
        haps, _ = assembly.local_assembly(ref, reads, **kw)
        if haps[0].seq != ref:
            break
    if run.device.startswith("cuda"):
        torch.cuda.synchronize()
    return dict(call=assembly.local_assembly, kw=kw, regions=regions,
                next=0, annotate=record_function)


def serve(run, state, win, t_end):
    call, kw, regions = state["call"], state["kw"], state["regions"]
    mark = state["annotate"]
    spans, counts = win.spans, win.counts
    i = state["next"]
    while True:
        ref, reads = regions[i % len(regions)]
        with mark("assembly.region"):
            a = time.perf_counter()
            out = call(ref, reads, **kw)
            end = time.perf_counter()
        spans["region"].append(end - a)
        counts["attempted"] += 1
        if end <= t_end:
            counts["done"] += 1
        win.served.append((i % len(regions), out))
        i += 1
        if end >= t_end:
            break
    state["next"] = i


def release(state):
    state.pop("call")


def _plain(haps, variants):
    """A result of local_assembly as plain values: [(seq, graph score,
    likelihood)], [(pos, ref, alt, kind)]."""
    return ([(h.seq, h.graph_score, h.likelihood) for h in haps],
            [(v.pos, v.ref, v.alt, v.kind) for v in variants])


def sample(run, state, results) -> list[int]:
    """Positions of the results to compare: `sample` drawn from the seed
    and the one with the most PairHMM cells."""
    regions = state["regions"]
    rng = np.random.default_rng([run.seed, SAMPLE_SALT])
    n = len(results)
    picks = set(rng.choice(n, size=min(run.traffic["sample"], n),
                           replace=False).tolist())
    cells = [len(out[0]) * sum(map(len, regions[k][1]))
             for k, out in results]
    picks.add(int(np.argmax(cells)))
    return sorted(picks)


def reference(run, regions, bits=None, round_to=None):
    a, s = run.config["assembly"], run.config["global_scoring"]
    return ref_asm.local_assembly(
        regions, k=a["kmer_size"], k_best=a["k_best_haplotypes"],
        min_weight=a["min_edge_weight"], quals=tuple(a["quals"]),
        scoring=(s["match"], s["mismatch"], s["gap_open"], s["gap_extend"]),
        device=run.device, bits=bits, round_to=round_to)


def compare(got, want, min_compared) -> list[Check]:
    """Region results (plain) against the reference's: the haplotypes
    and their order, every likelihood bit for bit, the variants."""
    bad = dict(haplotype=0, likelihood=0, variant=0)
    for (gh, gv), (wh, wv, _) in zip(got, want):
        bad["haplotype"] += [(h[0], h[1]) for h in gh] != \
            [(h[0], h[1]) for h in wh]
        bad["likelihood"] += sum(
            np.float64(a[2]).tobytes() != np.float64(b[2]).tobytes()
            for a, b in zip(gh, wh)) + abs(len(gh) - len(wh))
        bad["variant"] += gv != wv
    return [Check("compared", len(got), min=min_compared)] + [
        Check(f"{k}_mismatch", v, max=0) for k, v in bad.items()]


def check(run, state):
    regions = state["regions"]
    results = [x for w in run.windows for x in w.served]
    picks = sample(run, state, results)
    want = reference(run, [regions[results[p][0]] for p in picks])
    got = [_plain(*results[p][1]) for p in picks]
    checks = compare(got, want, run.traffic["min_compared"])
    if run.traced is not None:
        run.work = window_work(run, state, run.traced)
    return checks


def control(run):
    """The control's checks on as many regions as a run compares, drawn
    from the seed: the reference with its GLOBAL cells clamped to int8
    and its PairHMM values rounded to bf16, where the configuration
    states int16 and f32, against the reference at full precision."""
    import torch
    cfg, mix = run.config, run.traffic
    regions = generators.assembly_regions(
        np.random.default_rng(run.seed), cfg["pool"], reads=mix["reads"],
        **cfg["regions"])
    rng = np.random.default_rng([run.seed, SAMPLE_SALT])
    picks = rng.choice(len(regions), size=min(mix["sample"], len(regions)),
                       replace=False)
    chosen = [regions[k] for k in picks]
    want = reference(run, chosen)
    low = reference(run, chosen, bits=CONTROL_BITS, round_to=torch.bfloat16)
    return compare([(h, v) for h, v, _ in low], want, mix["min_compared"])


def window_work(run, state, win) -> dict:
    """Least work of every region the window ran, from what each call
    did: its haplotypes x reads PairHMM pairs and, where the best
    haplotype is not the reference, its GLOBAL traceback against the
    window, whose walk covers at least the longer of the two."""
    regions = state["regions"]
    fp = ints = nbytes = 0.0
    for k, (haps, _) in win.served:
        ref, reads = regions[k]
        o, b = pairhmm.region_work([len(r) for r in reads],
                                   [len(h.seq) for h in haps])
        fp += o
        nbytes += b
        if haps and haps[0].seq != ref:
            hl = len(haps[0].seq)
            ints += hl * len(ref) * gotoh.cell_ops(False, True) \
                + gotoh.WALK_OPS * max(hl, len(ref))
            nbytes += hl + len(ref) + 8 + 4
    return {"int32_ops": ints, "fp32_ops": fp, "bytes": nbytes}
