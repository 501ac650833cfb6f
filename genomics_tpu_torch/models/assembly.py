"""Local micro-assembly: the port of `genomics_tpu/models/assembly.py`,
the nvMicroAssembly / GATK-HaplotypeCaller
pipeline (reference: Non-CDP/NvB/nvMicroAssembly/: debruijn_graph
construct_graph / compute_edge_weights / topological_sort /
find_k_best_paths, assembly_graph.h:35-131; pipeline parameters
haplotype_caller.h — kmer_size=10, k_best_haplotypes=12,
active_region_size=100).

Active regions are tiny (100 bp, up to 1000 reads), so graph
construction, sorting and path search are host code, as the reference
builds them from gathered region reads; the compute-heavy stage, scoring
every (read, haplotype) pair, is one PairHMM launch of the wavefront
kernel (`ops.cuda_pairhmm.pairhmm_forward_dataset`: csrc/
pairhmm_wavefront.cu, one warp a pair), bit-equal to the gold, as the JAX
package's TPU path runs `pallas_pairhmm.pairhmm_forward_tpu_dataset`
exact.

Variant calling: each k-best haplotype is globally aligned to the
reference window (runtime.AlignEngine, GLOBAL + traceback, on the same
device) and its CIGAR walk emits SNV/insertion/deletion records.
Everything takes `device=` (the card unless told; "cpu" runs the plain
versions).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from genomics_tpu_torch.core.scoring import AlgoType, AlignmentParams
from genomics_tpu_torch.ops import cuda_pairhmm
from genomics_tpu_torch.runtime.dispatch import AlignEngine
from genomics_tpu_torch.utils import profiling

DEFAULT_KMER = 10            # haplotype_caller.h kmer_size
K_BEST = 12                  # haplotype_caller.h k_best_haplotypes
ACTIVE_REGION = 100          # haplotype_caller.h active_region_size


@dataclasses.dataclass
class Haplotype:
    seq: str
    graph_score: float       # product of edge weight fractions (log)
    likelihood: float = 0.0  # summed read PairHMM log10-likelihood


@dataclasses.dataclass
class Variant:
    pos: int                 # 0-based offset within the region
    ref: str
    alt: str
    kind: str                # "snv" | "ins" | "del"


class DeBruijnGraph:
    """k-mer de Bruijn graph over region reads + reference
    (assembly_graph.h construct_graph / compute_edge_weights).

    Nodes are k-mers; an edge u→v exists when v = u[1:] + base occurs in
    some sequence; edge weight = occurrence count (reads weighted 1,
    the reference path marked so it is never pruned away)."""

    def __init__(self, k: int = DEFAULT_KMER):
        self.k = k
        self.edges: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.nodes: set[str] = set()
        self.ref_source: str | None = None
        self.ref_sink: str | None = None

    def add_sequence(self, seq: str, is_ref: bool = False, weight: int = 1):
        k = self.k
        if len(seq) < k + 1:
            return
        prev = seq[:k]
        self.nodes.add(prev)
        if is_ref:
            self.ref_source = prev
        for i in range(1, len(seq) - k + 1):
            cur = seq[i : i + k]
            self.nodes.add(cur)
            self.edges[prev][cur] += weight
            prev = cur
        if is_ref:
            self.ref_sink = prev

    def prune(self, min_weight: int = 2):
        """Drop low-support edges (the reference's pruning step) but
        keep the reference path intact (weight bumped at build)."""
        for u in list(self.edges):
            kept = {v: w for v, w in self.edges[u].items() if w >= min_weight}
            if kept:
                self.edges[u] = defaultdict(int, kept)
            else:
                del self.edges[u]

    def topological_order(self) -> list[str] | None:
        """Kahn topological sort (assembly_graph.h:127); None if the
        graph has a cycle (the reference then bails or re-runs with a
        larger k — haplotype_caller.h increaze_kmer_size_for_cycles)."""
        indeg: dict[str, int] = defaultdict(int)
        for u in self.edges:
            indeg.setdefault(u, 0)
            for v in self.edges[u]:
                indeg[v] += 1
        frontier = [u for u, d in indeg.items() if d == 0]
        order = []
        while frontier:
            u = frontier.pop()
            order.append(u)
            for v in self.edges.get(u, ()):
                indeg[v] -= 1
                if indeg[v] == 0:
                    frontier.append(v)
        if len(order) < len(indeg):
            return None
        return order

    def k_best_paths(self, k_best: int = K_BEST) -> list[Haplotype]:
        """find_k_best_paths (assembly_graph.h:128): enumerate the
        k_best highest-weight source→sink paths through the DAG by
        DP over the topological order, carrying up to k_best partial
        paths per node scored by summed log edge-weight fractions."""
        if self.ref_source is None or self.ref_sink is None:
            return []
        order = self.topological_order()
        if order is None:
            return []
        # out-weight totals for fraction scoring
        tot = {u: sum(ws.values()) for u, ws in self.edges.items()}
        # best[node] = list of (score, path-string) partial paths
        best: dict[str, list[tuple[float, str]]] = {
            self.ref_source: [(0.0, self.ref_source)]
        }
        for u in order:
            if u not in best or u not in self.edges:
                continue
            for v, w in self.edges[u].items():
                step = float(np.log(w / tot[u]))
                cand = best.setdefault(v, [])
                for s, p in best[u]:
                    cand.append((s + step, p + v[-1]))
                cand.sort(key=lambda t: -t[0])
                del cand[k_best:]
        return [
            Haplotype(seq=p, graph_score=s)
            for s, p in best.get(self.ref_sink, [])
        ]


def assemble_region(
    ref_window: str,
    reads: list[str],
    k: int = DEFAULT_KMER,
    k_best: int = K_BEST,
    min_edge_weight: int = 2,
) -> list[Haplotype]:
    """Build the graph from reference + reads and return the k-best
    haplotypes (reference path always included first)."""
    with profiling.span("assembly.graph"):
        g = DeBruijnGraph(k)
        # reference edges get min_edge_weight so pruning keeps them
        g.add_sequence(ref_window, is_ref=True, weight=min_edge_weight)
        for r in reads:
            g.add_sequence(r)
        g.prune(min_edge_weight)
    with profiling.span("assembly.paths"):
        haps = g.k_best_paths(k_best)
        if not any(h.seq == ref_window for h in haps):
            haps.insert(0, Haplotype(seq=ref_window, graph_score=0.0))
        return haps[:k_best]


def score_haplotypes(
    haplotypes: list[Haplotype],
    reads: list[str],
    base_qual: int = 30,
    ins_qual: int = 45,
    del_qual: int = 45,
    device="cuda",
) -> list[Haplotype]:
    """Batched (read × haplotype) PairHMM through the wavefront kernel on
    `device`: one launch over all pairs; per-haplotype likelihood =
    Σ_reads log10 P(read|hap) (the HaplotypeCaller genotyping
    likelihood)."""
    if not haplotypes or not reads:
        return haplotypes
    nH, nR = len(haplotypes), len(reads)
    records = []
    for h in haplotypes:
        for r in reads:
            records.append({
                "read": r.encode(),
                "hap": h.seq.encode(),
                "base_quals": np.full(len(r), base_qual, np.int64),
                "ins_quals": np.full(len(r), ins_qual, np.int64),
                "del_quals": np.full(len(r), del_qual, np.int64),
            })
    lik = cuda_pairhmm.pairhmm_forward_dataset(records, device=device)
    lik = lik[: nH * nR].reshape(nH, nR)
    # log10 of the 2^120-scaled forward value; constant offset cancels
    # when comparing haplotypes
    log10 = np.log10(np.maximum(lik.astype(np.float64), 1e-300))
    for i, h in enumerate(haplotypes):
        h.likelihood = float(log10[i].sum())
    haplotypes.sort(key=lambda h: -h.likelihood)
    return haplotypes


def call_variants(ref_window: str, haplotype: str,
                  device="cuda") -> list[Variant]:
    """Globally align one haplotype to the reference window on `device` and
    emit variants from the CIGAR walk (the HaplotypeCaller event
    extraction step, re-using the framework's GLOBAL engine +
    traceback)."""
    if haplotype == ref_window:
        return []
    eng = AlignEngine(
        AlignmentParams(algo=AlgoType.GLOBAL, match=2, mismatch=4,
                        gap_open=6, gap_extend=1),
        with_tb=True, device=device,
    )
    job = eng.align([haplotype], [ref_window])[0]
    out: list[Variant] = []
    qi = ti = 0
    num = 0
    for ch in job.cigar_string:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            continue
        n, num = num, 0
        if ch in "M=":
            qi += n
            ti += n
        elif ch == "X":
            for j in range(n):
                out.append(Variant(pos=ti + j, ref=ref_window[ti + j],
                                   alt=haplotype[qi + j], kind="snv"))
            qi += n
            ti += n
        elif ch == "I":
            out.append(Variant(pos=ti, ref="", alt=haplotype[qi : qi + n],
                               kind="ins"))
            qi += n
        elif ch == "D":
            out.append(Variant(pos=ti, ref=ref_window[ti : ti + n], alt="",
                               kind="del"))
            ti += n
    return out


def local_assembly(
    ref_window: str,
    reads: list[str],
    k: int = DEFAULT_KMER,
    k_best: int = K_BEST,
    min_edge_weight: int = 2,
    device="cuda",
):
    """The full assembly.h:39-65 pipeline: graph → k-best haplotypes →
    PairHMM scoring → variant events for the winning haplotype, on
    `device`.

    Returns (haplotypes sorted by likelihood, variants of the best)."""
    with profiling.span("assembly", batch=profiling.NEW) as sp:
        haps = assemble_region(ref_window, reads, k, k_best, min_edge_weight)
        with profiling.span("assembly.score"):
            haps = score_haplotypes(haps, reads, device=device)
        with profiling.span("assembly.call"):
            variants = (call_variants(ref_window, haps[0].seq, device=device)
                        if haps else [])
        sp.count("assembly.regions")
        sp.count("assembly.haplotypes", len(haps))
        # a best haplotype other than the reference: one GLOBAL traceback
        sp.count("assembly.calls",
                 int(bool(haps) and haps[0].seq != ref_window))
    return haps, variants
