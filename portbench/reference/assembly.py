"""Plain local micro-assembly: the reference the assembly cells are
judged by.

The host graph is a frozen copy of the port's (`genomics_tpu_torch/
models/assembly.py` DeBruijnGraph, assemble_region; nvMicroAssembly's
debruijn_graph, assembly_graph.h:35-131), the haplotypes are scored by
`reference.pairhmm` and the best one is placed by `reference.align`'s
GLOBAL traceback, the same steps in the same order as `local_assembly`
takes them.  It imports nothing of the port.  Many regions are scored
together: their PairHMM pairs in one sweep, their best haplotypes in
one GLOBAL batch.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from portbench.reference import align, pairhmm


class Graph:
    """k-mer de Bruijn graph over the reference window and the reads."""

    def __init__(self, k):
        self.k = k
        self.edges = defaultdict(lambda: defaultdict(int))
        self.ref_source = self.ref_sink = None

    def add(self, seq, is_ref=False, weight=1):
        k = self.k
        if len(seq) < k + 1:
            return
        prev = seq[:k]
        if is_ref:
            self.ref_source = prev
        for i in range(1, len(seq) - k + 1):
            cur = seq[i:i + k]
            self.edges[prev][cur] += weight
            prev = cur
        if is_ref:
            self.ref_sink = prev

    def prune(self, min_weight):
        for u in list(self.edges):
            kept = {v: w for v, w in self.edges[u].items() if w >= min_weight}
            if kept:
                self.edges[u] = defaultdict(int, kept)
            else:
                del self.edges[u]

    def order(self):
        """Kahn's topological order, or None on a cycle."""
        indeg = defaultdict(int)
        for u in self.edges:
            indeg.setdefault(u, 0)
            for v in self.edges[u]:
                indeg[v] += 1
        frontier = [u for u, d in indeg.items() if d == 0]
        out = []
        while frontier:
            u = frontier.pop()
            out.append(u)
            for v in self.edges.get(u, ()):
                indeg[v] -= 1
                if indeg[v] == 0:
                    frontier.append(v)
        return None if len(out) < len(indeg) else out

    def k_best(self, k_best):
        """[(log score, path)] of the k_best heaviest source-sink paths."""
        if self.ref_source is None or self.ref_sink is None:
            return []
        order = self.order()
        if order is None:
            return []
        tot = {u: sum(ws.values()) for u, ws in self.edges.items()}
        best = {self.ref_source: [(0.0, self.ref_source)]}
        for u in order:
            if u not in best or u not in self.edges:
                continue
            for v, w in self.edges[u].items():
                step = float(np.log(w / tot[u]))
                cand = best.setdefault(v, [])
                for s, p in best[u]:
                    cand.append((s + step, p + v[-1]))
                cand.sort(key=lambda x: -x[0])
                del cand[k_best:]
        return best.get(self.ref_sink, [])


def haplotypes(ref, reads, k, k_best, min_weight):
    """[(seq, graph score)]: the k-best paths, the reference first where
    no path spells it."""
    g = Graph(k)
    g.add(ref, is_ref=True, weight=min_weight)
    for r in reads:
        g.add(r)
    g.prune(min_weight)
    haps = [(p, s) for s, p in g.k_best(k_best)]
    if not any(h == ref for h, _ in haps):
        haps.insert(0, (ref, 0.0))
    return haps[:k_best]


def variants(ref, hap, cigar):
    """[(pos, ref, alt, kind)] from a GLOBAL CIGAR of hap against ref."""
    out = []
    qi = ti = num = 0
    for ch in align.cigar_string(cigar):
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            continue
        n, num = num, 0
        if ch in "M=":
            qi += n
            ti += n
        elif ch == "X":
            for j in range(n):
                out.append((ti + j, ref[ti + j], hap[qi + j], "snv"))
            qi += n
            ti += n
        elif ch == "I":
            out.append((ti, "", hap[qi:qi + n], "ins"))
            qi += n
        elif ch == "D":
            out.append((ti, ref[ti:ti + n], "", "del"))
            ti += n
    return out


def local_assembly(regions, k=10, k_best=12, min_weight=2, quals=(30, 45, 45),
                   scoring=(2, 4, 6, 1), device="cpu", bits=None,
                   round_to=None):
    """For each (ref window, reads): (haplotypes [(seq, graph score,
    likelihood)] in likelihood order, variants of the best, the best
    haplotype's CIGAR bytes).  `scoring` is call_variants' GLOBAL (match,
    mismatch, gap open, gap extend); `bits` and `round_to` make the
    control."""
    haps = [haplotypes(ref, rd, k, k_best, min_weight) for ref, rd in regions]
    pr, ph = [], []
    for (ref, rd), hs in zip(regions, haps):
        for h, _ in hs:
            pr += rd
            ph += [h] * len(rd)
    lik = pairhmm.likelihoods(pr, ph, *quals, device=device,
                              round_to=round_to)
    ranked, at = [], 0
    for (ref, rd), hs in zip(regions, haps):
        n = len(hs) * len(rd)
        part = lik[at:at + n].reshape(len(hs), len(rd))
        at += n
        log10 = np.log10(np.maximum(part.astype(np.float64), 1e-300))
        scored = [(h, s, float(log10[i].sum())) for i, (h, s) in
                  enumerate(hs)]
        scored.sort(key=lambda x: -x[2])
        ranked.append(scored)
    todo = [i for i, (r, _) in enumerate(regions) if ranked[i][0][0] != r]
    aln = align.align_global([ranked[i][0][0] for i in todo],
                             [regions[i][0] for i in todo], scoring,
                             device=device, bits=bits) if todo else []
    cig = dict(zip(todo, (a["cigar"] for a in aln)))
    out = []
    for i, (ref, _) in enumerate(regions):
        best = ranked[i][0][0]
        c = cig.get(i, b"")
        out.append((ranked[i], variants(ref, best, c) if i in cig else [], c))
    return out
