"""Read mapper — the nvBowtie-class pipeline (reference:
CDP/NvB/nvBowtie/bowtie2/cuda: seeding (mapping.cu) → locate → score
(score.cu, ungapped/gapped DP) → reduce/mapq (reduce.cu, mapq.h);
paired-end opposite-mate scoring in score.cu / pipeline driver).

Composition of framework pieces:
  1. seed: q-gram index lookups at fixed intervals (index/qgram) or
     FM-index MEM seeds (index/fmindex, the nvmem/nvBowtie seeding path)
     on BOTH strands (forward read + reverse complement),
  2. locate: diagonal voting over seed hits (host numpy — tiny),
  3. score: ALL candidate windows across ALL reads and strands extended
     in ONE batched local-alignment dispatch with traceback
     (runtime.AlignEngine: the card's LOCAL TB kernel and walk),
  4. reduce: best / second-best per read → position, strand, CIGAR and
     nvBowtie's BowtieMapq2 quality (models/mapq.py ← mapq.h:146-330),
     with `all` / best-N reporting modes (reduce.cu's reporting policy).

Multi-contig references: contigs are concatenated for indexing; seed
votes and alignment windows are clipped to the owning contig, and
reported positions are (contig name, 1-based local offset).

Paired-end (map_pairs): both mates are seeded/scored in the same single
batched dispatch; pairing evaluates the mate1 × mate2 candidate matrix
VECTORIZED over numpy arrays for the bowtie2 default FR orientation
with fragment length inside [min_insert, max_insert], maximizing the
pair score sum (nvBowtie's opposite-mate DP window is the same
insert-window constraint).  Concordant pairs set the SAM proper-pair
flag; otherwise each mate falls back to its best single-end alignment.

The port's copy of `genomics_tpu/models/mapper.py`, every `Mapping`
field equal to it.  `ReadMapper(..., device=)` runs on the card unless
told otherwise (it raises without one): the AlignEngine, the fmdev
seeder's backward search (`ops/fm_search.py`, csrc/fm_search.cu) and
the `ed` stage's Myers kernel (`ops/myers.py`) all take that device.
Seeding, voting and the reduce stay host numpy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import torch

from genomics_tpu_torch.core.encoding import encode4
from genomics_tpu_torch.core.scoring import AlignmentParams
from genomics_tpu_torch.device import checked_device
from genomics_tpu_torch.index.qgram import QGramIndex, encode2, qgrams_of
from genomics_tpu_torch.models.mapq import MapqScheme, bowtie_mapq2
from genomics_tpu_torch.runtime.dispatch import AlignEngine

_RC = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def revcomp(seq: str) -> str:
    return seq.translate(_RC)[::-1]


@dataclasses.dataclass
class Mapping:
    pos: int              # 1-based position within `contig` (-1 = unmapped)
    score: int
    mapq: int
    cigar_string: str
    reverse: bool = False      # mapped to the reverse strand
    second_score: int = 0
    ref_span: int = 0          # reference bases consumed (for TLEN)
    proper_pair: bool = False
    pair_score: int = 0
    contig: str | None = None   # None → SAM writer falls back to its ref_name


@dataclasses.dataclass
class _Candidate:
    pos: int               # 0-based leftmost GLOBAL reference position
    score: int
    cigar: str
    reverse: bool
    ref_span: int


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[3,0,2] → [0,1,2,0,1] (per-group arange, vectorized)."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    idx = np.arange(total, dtype=np.int64)
    return idx - np.repeat(ends - counts, counts)


def _cigar_ref_span(cigar: str) -> int:
    """Reference bases consumed by a byte-CIGAR string (M/X/D advance)."""
    span, num = 0, 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if ch in "MXD=":
                span += num
            num = 0
    return span


class ReadMapper:
    def __init__(
        self,
        reference: str | Sequence[tuple[str, str]],
        seed_len: int = 16,
        seed_interval: int = 12,
        max_hits_per_seed: int = 32,
        max_candidates: int = 4,
        band: int = 16,
        params: AlignmentParams | None = None,
        seeder: str = "qgram",          # "qgram" | "fm"
        mem_min_len: int = 19,
        fm_index=None,                  # prebuilt FMIndex (genome-scale:
                                        # skip the in-ctor rebuild)
        max_reseed: int = 1,            # nvBowtie re-seeding rounds for
                                        # reads with no/weak candidates
                                        # (mapping.cu seeding passes)
        reseed_min_frac: float = 0.5,   # reseed while best score <
                                        # frac * match * read_len
        max_effort: int = 64,           # cap on scored windows per read
                                        # per round (params.h effort cap)
        device: str | torch.device = "cuda",
    ):
        self.device = checked_device(device)
        if isinstance(reference, str):
            contigs = [("ref", reference)]
        elif isinstance(reference, np.ndarray):
            # genome-scale path: one contig given directly as 2-bit
            # codes (a 3+ Gbp reference as a Python string would cost
            # two extra full-genome copies)
            contigs = [("ref", reference)]
        else:
            contigs = [(n, s) for n, s in reference]
        self.contig_names = [n for n, _ in contigs]
        self.contig_seqs = [s for _, s in contigs]
        self.contig_starts = np.cumsum(
            [0] + [len(s) for s in self.contig_seqs[:-1]]
        ).astype(np.int64)
        self.contig_ends = self.contig_starts + np.array(
            [len(s) for s in self.contig_seqs], np.int64
        )
        if isinstance(contigs[0][1], np.ndarray):
            self.reference = None
            self.ref_codes = contigs[0][1]
            # 2-bit → GASAL 4-bit codes ('A'&0xF=1, 'C'&0xF=3,
            # 'G'&0xF=7, 'T'&0xF=4; anything else = N = 14)
            lut = np.full(256, 14, np.uint8)
            lut[:4] = [1, 3, 7, 4]
            self.ref_codes4 = lut[self.ref_codes]
        else:
            self.reference = "".join(self.contig_seqs)
            self.ref_codes = encode2(self.reference)
            self.ref_codes4 = encode4(self.reference)
        self.seed_len = seed_len
        self.seed_interval = seed_interval
        self.max_hits = max_hits_per_seed
        self.max_candidates = max_candidates
        self.band = band
        self.mem_min_len = mem_min_len
        self.seeder = seeder
        self.bidir = None
        # every index builder accepts either the string reference or the
        # 2-bit code array (the genome-scale path sets reference=None)
        ref_for_index = (self.reference if self.reference is not None
                         else self.ref_codes)
        if seeder in ("fm", "hybrid", "fmdev"):
            from genomics_tpu_torch.index.fmindex import FMIndex

            self.fm = fm_index if fm_index is not None \
                else FMIndex(ref_for_index)
            self.index = None
            self._dev_fm = None         # built lazily for seeder="fmdev"
        elif seeder == "smem":
            from genomics_tpu_torch.index.fmindex import BidirFMIndex

            self.bidir = BidirFMIndex(ref_for_index)
            self.fm = self.bidir.fwd
            self.index = None
        else:
            self.fm = None
            self.index = QGramIndex(ref_for_index, q=seed_len)
        self.max_reseed = int(max_reseed)
        self.reseed_min_frac = float(reseed_min_frac)
        self.max_effort = int(max_effort)
        self.params = params or AlignmentParams(
            match=2, mismatch=6, gap_open=5, gap_extend=3
        )
        self.mapq_scheme = MapqScheme(match=self.params.match, monotone=False)
        self.engine = AlignEngine(self.params, with_tb=True,
                                  device=self.device)

    # -- position bookkeeping --------------------------------------------

    def contig_of(self, gpos: int) -> tuple[int, int]:
        """Global 0-based position → (contig index, local 0-based)."""
        ci = int(np.searchsorted(self.contig_starts, gpos, "right")) - 1
        return ci, gpos - int(self.contig_starts[ci])

    # -- seeding -----------------------------------------------------------

    def _seed_hits(self, read_codes: np.ndarray) -> list[tuple[int, int]]:
        """(read_offset, global ref position) seed pairs."""
        if self.seeder == "smem":
            # supermaximal exact matches via the bidirectional index
            # (bidir.h / bwa-mem seeding)
            out = []
            for qs, _qe, lo, hi in self.bidir.smems(
                read_codes, min_len=self.mem_min_len
            ):
                for p in self.fm.sa_values(
                    np.arange(lo, min(hi, lo + self.max_hits))
                ):
                    out.append((qs, int(p)))
            return out
        if self.seeder == "hybrid":
            # nvBowtie approx-hybrid seeds (mapping_impl.h:67-68): fixed
            # seed offsets, exact subseed + <=1 mismatch in the rest
            out = []
            L, q = len(read_codes), self.seed_len
            for o in range(0, max(L - q, 0) + 1, self.seed_interval):
                seed = read_codes[o:o + q]
                if len(seed) < q or (seed > 3).any():
                    continue
                for lo, hi, _mm in self.fm.hybrid_search(seed, max_mm=1):
                    for p in self.fm.sa_values(
                        np.arange(lo, min(hi, lo + self.max_hits))
                    ):
                        out.append((o, int(p)))
            return out
        if self.seeder == "fm":
            from genomics_tpu_torch.index.fmindex import seed_positions

            return seed_positions(
                self.fm, read_codes, min_len=self.mem_min_len,
                max_hits=self.max_hits,
            )
        L = len(read_codes)
        q = self.seed_len
        offs = list(range(0, max(L - q, 0) + 1, self.seed_interval))
        if not offs:
            return []
        keys = []
        for o in offs:
            kg = qgrams_of(read_codes[o : o + q], q)
            keys.append(kg[0] if len(kg) else (1 << (2 * q)))
        hits, _ = self.index.hits(np.array(keys, np.int64), self.max_hits)
        out = []
        for o, row in zip(offs, hits):
            for h in row:
                if h >= 0:
                    out.append((o, int(h)))
        return out

    def _vote(self, diags: np.ndarray) -> list[int]:
        """Group seed diagonals within the band, rank bins by vote
        count (ties → lower diagonal), emit the median diagonal of the
        top max_candidates bins."""
        if not len(diags):
            return []
        binned = diags // max(self.band, 1)
        uniq, counts = np.unique(binned, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        out = []
        for b in uniq[order][: self.max_candidates]:
            members = diags[binned == b]
            out.append(int(np.median(members)))
        return out

    def _vote_all(self, ow: np.ndarray, dg: np.ndarray,
                  n_variants: int) -> list[list[int]]:
        """Vectorized _vote over every variant at once: one lexsort
        groups (owner, band-bin) pairs, group medians come from index
        arithmetic on the sorted diagonals — no per-read Python
        (nvBowtie's select/locate stages are similarly batch-wide,
        mapping.cu).  Semantics identical to per-variant _vote."""
        out: list[list[int]] = [[] for _ in range(n_variants)]
        if not len(dg):
            return out
        band = max(self.band, 1)
        bins = dg // band
        order = np.lexsort((dg, bins, ow))
        ow, bins, dg = ow[order], bins[order], dg[order]
        newgrp = np.concatenate(
            [[True], (ow[1:] != ow[:-1]) | (bins[1:] != bins[:-1])])
        grp = np.flatnonzero(newgrp)
        counts = np.diff(np.append(grp, len(ow)))
        gow = ow[grp]
        gbin = bins[grp]
        # rank groups per owner by (-count, bin): ties keep the lower
        # bin, matching _vote's stable argsort over bin-sorted uniques
        sel_order = np.lexsort((gbin, -counts, gow))
        sow = gow[sel_order]
        rank = np.arange(len(sow)) - np.searchsorted(sow, sow, "left")
        sel = sel_order[rank < self.max_candidates]
        n = counts[sel]
        start = grp[sel]
        # np.median of each sorted group, then int() truncation-toward-0
        med = (dg[start + (n - 1) // 2] + dg[start + n // 2]) / 2.0
        med = np.trunc(med).astype(np.int64)
        keep_ow = gow[sel]
        for v, m in zip(keep_ow, med):
            out[int(v)].append(int(m))
        return out

    def _diagonals(self, read_codes: np.ndarray) -> list[int]:
        """Seed + vote → candidate window start diagonals (global)."""
        pairs = self._seed_hits(read_codes)
        if not pairs:
            return []
        return self._vote(np.array([p - o for o, p in pairs]))

    def _seed_batch(self, codes_list: list[np.ndarray],
                    interval: int | None = None, phase: int = 0):
        """All (variant, seed_offset, key) triples, vectorized across
        variants grouped by length.  interval/phase override the seed
        placement for re-seeding rounds (denser, offset-shifted seeds —
        nvBowtie's repeated seeding passes, mapping.cu)."""
        q = self.seed_len
        iv = interval or self.seed_interval
        lens = np.array([len(c) for c in codes_list], np.int64)
        keys_cat, owner_cat, offs_cat = [], [], []
        shifts = 2 * np.arange(q - 1, -1, -1, dtype=np.int64)
        for L in np.unique(lens):
            if L < q:
                continue
            vids = np.flatnonzero(lens == L)
            mat = np.stack([codes_list[v] for v in vids])      # [V, L]
            offs = np.arange(phase % iv, L - q + 1, iv)
            if not len(offs):
                continue
            win = np.lib.stride_tricks.sliding_window_view(
                mat, q, axis=1)[:, offs]                       # [V, O, q]
            keys = (win.astype(np.int64) << shifts).sum(axis=2)
            keys = np.where((win == 255).any(axis=2),
                            np.int64(1) << (2 * q), keys)
            keys_cat.append(keys.ravel())
            owner_cat.append(np.repeat(vids, len(offs)))
            offs_cat.append(np.tile(offs, len(vids)))
        if not keys_cat:
            z = np.zeros(0, np.int64)
            return z, z, z
        return (np.concatenate(keys_cat), np.concatenate(owner_cat),
                np.concatenate(offs_cat))

    def _diagonals_all(self, codes_list: list[np.ndarray],
                       interval: int | None = None,
                       phase: int = 0) -> list[list[int]]:
        """Batched seeding: ONE index lookup for every seed of every
        read/strand variant (replaces the per-read hits() calls —
        nvBowtie's map_queries similarly seeds the whole batch in one
        kernel, mapping.cu), then vectorized diagonal voting.

        seeder="qgram": one batched q-gram table lookup.
        seeder="fmdev": the nvBowtie device-side seeding analog
        (mapping.cu:67-101) — every fixed-interval seed of every variant
        goes through ONE FM backward-search launch on the device
        (ops/fm_search), SA ranges resolve to positions host-side."""
        if self.seeder not in ("qgram", "fmdev"):
            return [self._diagonals(c) for c in codes_list]
        keys, owner, offs = self._seed_batch(
            codes_list, interval=interval, phase=phase)
        out: list[list[int]] = [[] for _ in codes_list]
        if not len(keys):
            return out
        if self.seeder == "qgram":
            hits, _ = self.index.hits(keys, self.max_hits)      # [S, H]
            valid = hits >= 0
            ow = np.broadcast_to(owner[:, None], hits.shape)[valid]
            dg = (hits - offs[:, None])[valid]
        else:
            ow, dg = self._fmdev_hits(keys, owner, offs)
        return self._vote_all(ow, dg, len(codes_list))

    def _fmdev_hits(self, keys: np.ndarray, owner: np.ndarray,
                    offs: np.ndarray):
        """Exact device backward search for all seeds at once: keys are
        the q-gram integers (the seed's 2-bit codes), re-expanded to
        [S, q] symbol arrays for the batched search (no launch where no
        seed is valid)."""
        from genomics_tpu_torch.ops.fm_search import backward_search_device

        if self._dev_fm is None:
            self._dev_fm = self.fm.to_device(device=self.device)
        q = self.seed_len
        valid_key = keys < (np.int64(1) << (2 * q))
        keys_v = keys[valid_key]
        shifts = 2 * np.arange(q - 1, -1, -1, dtype=np.int64)
        syms = ((keys_v[:, None] >> shifts) & 3).astype(np.int32)  # [S, q]
        qlen = np.full(len(keys_v), q, np.int32)
        lo, hi = backward_search_device(self._dev_fm, syms, qlen)
        take = np.minimum(hi - lo, self.max_hits)
        rows = np.repeat(lo, take) + _ragged_arange(take)
        pos = self.fm.sa_values(rows)
        ow = np.repeat(owner[valid_key], take)
        dg = pos - np.repeat(offs[valid_key], take)
        return ow, dg

    # -- scoring -----------------------------------------------------------

    def _ungapped_scores(self, q_list, t_list, diags_in_window):
        """Stage-1 ungapped scores (nvBowtie's EditDistance scoring
        stage, score.cu's best-approx pipeline runs cheap scoring
        before the gapped DP): match/mismatch along each candidate's
        seed diagonal, no gaps, vectorized over candidates."""
        n = len(q_list)
        out = np.zeros(n, np.int64)
        mt, mm = self.params.match, self.params.mismatch
        for i, (q, t, d) in enumerate(zip(q_list, t_list, diags_in_window)):
            qc = q if isinstance(q, np.ndarray) else encode2(q)
            tw = t[d:d + len(qc)]
            tc = tw if isinstance(tw, np.ndarray) else encode2(tw)
            L = min(len(qc), len(tc))
            eq = qc[:L] == tc[:L]
            out[i] = mt * int(eq.sum()) - mm * int(L - eq.sum())
        return out

    def _ed_scores(self, q_list, t_list):
        """Stage-1 EDIT DISTANCES via the batched Myers bit-vector
        kernel (ops/myers.py — nvBowtie's `ed` scoring backend;
        SW-Gotoh is its second backend, exactly this mapper's stage 2).
        Semiglobal: the read may start anywhere in the window."""
        from genomics_tpu_torch.ops import myers

        lut = np.full(16, 255, np.uint8)     # 4-bit → 2-bit codes
        for c2, c4 in [(0, 1), (1, 3), (2, 7), (3, 4)]:
            lut[c4] = c2
        B = len(q_list)
        Lp = max(len(q) for q in q_list)
        Lt = max(len(t) for t in t_list)
        parr = np.full((B, Lp), 255, np.uint8)
        tarr = np.full((B, Lt), 255, np.uint8)
        plen = np.zeros(B, np.int32)
        tlen = np.zeros(B, np.int32)
        for i, (q, t) in enumerate(zip(q_list, t_list)):
            parr[i, : len(q)] = lut[q]
            tarr[i, : len(t)] = lut[t]
            plen[i], tlen[i] = len(q), len(t)
        W = (Lp + 31) // 32
        eq = myers.build_eq_masks(parr, plen, W)
        best, _end, _fin = myers.myers_batch(
            *(torch.from_numpy(a).to(self.device)
              for a in (eq, plen, tarr, tlen)))
        return best.cpu().numpy().astype(np.int64)

    def _score_candidates(
        self, reads: list[str], both_strands: bool = True,
        two_stage=False, seed_interval: int | None = None,
        seed_phase: int = 0,
    ) -> list[list[_Candidate]]:
        """Seed/locate/score all reads (and strands) in one dispatch →
        per-read candidate lists sorted by descending score.

        two_stage=True|"ungapped" inserts nvBowtie's cheap-then-
        expensive scoring (score.cu best-approx pipeline): every
        candidate window gets an ungapped diagonal score first and only
        the top max_candidates windows per read run the gapped
        traceback DP.  two_stage="ed" uses the batched Myers edit
        distance as the cheap stage instead — the two scoring BACKENDS
        of nvBowtie (EditDistance then SmithWaterman, score.cu).
        seed_interval/seed_phase override seed placement (re-seeding
        rounds)."""
        variants_all = []          # (read_idx, seq, rev)
        for ri, read in enumerate(reads):
            variants_all.append((ri, read, False))
            if both_strands:
                variants_all.append((ri, revcomp(read), True))
        codes2_list = [encode2(seq) for _, seq, _ in variants_all]
        codes4_list = [encode4(seq) for _, seq, _ in variants_all]
        diag_lists = self._diagonals_all(
            codes2_list, interval=seed_interval, phase=seed_phase)
        # flatten candidates and clip windows to the owning contig,
        # all vectorized (alignments never straddle contigs)
        n_per = np.array([len(d) for d in diag_lists], np.int64)
        vi = np.repeat(np.arange(len(variants_all)), n_per)
        diag = np.array(
            [d for lst in diag_lists for d in lst], np.int64)
        vlen = np.array([len(c) for c in codes4_list], np.int64)
        if len(diag):
            ci = np.searchsorted(
                self.contig_starts,
                np.clip(diag, 0, len(self.ref_codes) - 1), "right") - 1
            c_lo = self.contig_starts[ci]
            c_hi = self.contig_ends[ci]
            s_arr = np.maximum(c_lo, diag - self.band)
            e_arr = np.minimum(c_hi, diag + vlen[vi] + self.band)
            keep = e_arr > s_arr
            vi, diag = vi[keep], diag[keep]
            s_arr, e_arr = s_arr[keep], e_arr[keep]
        else:
            s_arr = e_arr = diag
        ri_arr = np.array([v[0] for v in variants_all], np.int64)
        rev_arr = np.array([v[2] for v in variants_all], bool)
        q_list = [codes4_list[v] for v in vi]
        t_list = [self.ref_codes4[s:e] for s, e in zip(s_arr, e_arr)]
        owners = ri_arr[vi].tolist() if len(vi) else []
        starts = s_arr.tolist()
        strands = rev_arr[vi].tolist() if len(vi) else []
        windiags = np.maximum(diag - s_arr, 0).tolist()
        if (not two_stage) and q_list and self.max_effort:
            # effort cap (params.h's max-effort knob): bound the scored
            # windows per read even without the cheap stage
            keep_idx = []
            per_read: dict[int, int] = {}
            for i, ri in enumerate(owners):
                if per_read.get(ri, 0) < self.max_effort:
                    per_read[ri] = per_read.get(ri, 0) + 1
                    keep_idx.append(i)
            if len(keep_idx) < len(q_list):
                q_list = [q_list[i] for i in keep_idx]
                t_list = [t_list[i] for i in keep_idx]
                owners = [owners[i] for i in keep_idx]
                starts = [starts[i] for i in keep_idx]
                strands = [strands[i] for i in keep_idx]
        if two_stage and q_list:
            if two_stage == "ed":
                ed = self._ed_scores(q_list, t_list)
                order = np.lexsort((np.arange(len(ed)), ed))
            else:
                ug = self._ungapped_scores(q_list, t_list, windiags)
                order = np.lexsort((np.arange(len(ug)), -ug))
            keep_idx = []
            per_read: dict[int, int] = {}
            for i in order:
                ri = owners[i]
                if per_read.get(ri, 0) < self.max_candidates:
                    per_read[ri] = per_read.get(ri, 0) + 1
                    keep_idx.append(i)
            keep_idx.sort()
            q_list = [q_list[i] for i in keep_idx]
            t_list = [t_list[i] for i in keep_idx]
            owners = [owners[i] for i in keep_idx]
            starts = [starts[i] for i in keep_idx]
            strands = [strands[i] for i in keep_idx]
        results = self.engine.align(q_list, t_list) if q_list else []
        cands: list[list[_Candidate]] = [[] for _ in reads]
        for job, ri, s, rev in zip(results, owners, starts, strands):
            if job.score <= 0:
                continue
            cig = job.cigar_string
            cands[ri].append(
                _Candidate(
                    pos=s + job.target_start,
                    score=job.score,
                    cigar=cig,
                    reverse=rev,
                    ref_span=_cigar_ref_span(cig),
                )
            )
        for lst in cands:
            lst.sort(key=lambda c: (-c.score, c.pos))
            # drop duplicate loci (same pos+strand reached via two windows)
            seen, uniq = set(), []
            for c in lst:
                k = (c.pos, c.reverse)
                if k not in seen:
                    seen.add(k)
                    uniq.append(c)
            lst[:] = uniq
        return cands

    # -- reduce ------------------------------------------------------------

    def _to_mapping(self, c: _Candidate, mapq: int, second: int) -> Mapping:
        ci, local = self.contig_of(c.pos)
        return Mapping(
            pos=local + 1,
            score=c.score,
            mapq=mapq,
            cigar_string=c.cigar,
            reverse=c.reverse,
            second_score=second,
            ref_span=c.ref_span,
            contig=self.contig_names[ci],
        )

    def _reduce(self, read: str, cands: list[_Candidate]) -> Mapping:
        """best/second-best → BowtieMapq2 (reduce.cu + mapq.h analog)."""
        if not cands:
            return Mapping(-1, 0, 0, "")
        best = cands[0]
        second = cands[1].score if len(cands) > 1 else None
        mq = bowtie_mapq2(best.score, second, len(read), self.mapq_scheme)
        return self._to_mapping(best, mq, second or 0)

    def map_batch(
        self,
        reads: list[str],
        both_strands: bool = True,
        report: str | int = "best",
        two_stage: bool = False,
    ) -> list:
        """report='best' → one Mapping per read (default); report='all'
        or an int N → list of Mappings per read, best-first (nvBowtie's
        all / best-N reporting, reduce.cu).  Reads with no candidates or
        best score < reseed_min_frac * perfect get up to max_reseed
        extra seeding rounds with denser offset-shifted seeds
        (nvBowtie's repeated seeding passes, mapping.cu)."""
        cands = self._score_candidates(reads, both_strands,
                                       two_stage=two_stage)
        for round_i in range(self.max_reseed):
            weak = [
                i for i, (r, lst) in enumerate(zip(reads, cands))
                if not lst or lst[0].score <
                self.reseed_min_frac * self.params.match * len(r)
            ]
            if not weak:
                break
            iv = max(self.seed_interval // 2, 1)
            ph = ((round_i + 1) * max(iv // 2, 1)) % max(iv, 1)
            extra = self._score_candidates(
                [reads[i] for i in weak], both_strands,
                two_stage=two_stage, seed_interval=iv, seed_phase=ph)
            for i, lst2 in zip(weak, extra):
                merged = cands[i] + lst2
                merged.sort(key=lambda c: (-c.score, c.pos))
                seen, uniq = set(), []
                for c in merged:
                    k = (c.pos, c.reverse)
                    if k not in seen:
                        seen.add(k)
                        uniq.append(c)
                cands[i] = uniq
        if report == "best":
            return [self._reduce(r, c) for r, c in zip(reads, cands)]
        out = []
        for r, lst in zip(reads, cands):
            n = len(lst) if report == "all" else min(int(report), len(lst))
            second = lst[1].score if len(lst) > 1 else None
            mq = (
                bowtie_mapq2(lst[0].score, second, len(r), self.mapq_scheme)
                if lst
                else 0
            )
            row = []
            for k in range(n):
                # secondary alignments get mapq 0 by SAM convention
                row.append(
                    self._to_mapping(lst[k], mq if k == 0 else 0, second or 0)
                )
            out.append(row)
        return out

    # -- streamed pipeline (input_thread / compute_thread analog) ----------

    def map_stream(self, read_iter, batch_size: int = 4096,
                   both_strands: bool = True, two_stage: bool = False):
        """Overlap input parsing with alignment (reference: nvBowtie's
        threaded pipeline — input_thread.cpp fills read batches while
        compute_thread.cu drains them).  A background thread pulls and
        batches `read_iter` while the current batch maps; yields
        (read, Mapping) in input order."""
        import queue as _q
        import threading

        stop = object()
        ch: _q.Queue = _q.Queue(maxsize=2)   # double buffering

        def producer():
            batch = []
            for r in read_iter:
                batch.append(r)
                if len(batch) >= batch_size:
                    ch.put(batch)
                    batch = []
            if batch:
                ch.put(batch)
            ch.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            batch = ch.get()
            if batch is stop:
                break
            maps = self.map_batch(batch, both_strands=both_strands,
                                  two_stage=two_stage)
            for r, mp in zip(batch, maps):
                yield r, mp
        t.join()

    # -- paired-end ----------------------------------------------------------

    @staticmethod
    def _pair_eval(c1, c2, min_insert, max_insert):
        """FR concordance over the candidate×candidate matrix →
        (best_pair | None, best_sum, second_sum), vectorized."""
        if not (c1 and c2):
            return None, 0, 0
        pos1 = np.array([c.pos for c in c1])
        rev1 = np.array([c.reverse for c in c1])
        span1 = np.array([c.ref_span for c in c1])
        sc1 = np.array([c.score for c in c1])
        pos2 = np.array([c.pos for c in c2])
        rev2 = np.array([c.reverse for c in c2])
        span2 = np.array([c.ref_span for c in c2])
        sc2 = np.array([c.score for c in c2])
        # FR: opposite strands; fragment = reverse-mate end -
        # forward-mate start, within the insert window
        opp = rev1[:, None] != rev2[None, :]
        fwd_pos = np.where(rev1[:, None], pos2[None, :], pos1[:, None])
        rev_end = np.where(
            rev1[:, None],
            pos1[:, None] + span1[:, None],
            pos2[None, :] + span2[None, :],
        )
        frag = rev_end - fwd_pos
        ok = opp & (frag >= max(min_insert, 1)) & (frag <= max_insert)
        sums = np.where(ok, sc1[:, None] + sc2[None, :], 0)
        if sums.max() <= 0:
            return None, 0, 0
        a_i, b_i = np.unravel_index(np.argmax(sums), sums.shape)
        best_sum = int(sums[a_i, b_i])
        best_pair = (c1[a_i], c2[b_i])
        sums[a_i, b_i] = 0
        return best_pair, best_sum, int(sums.max())

    def _rescue_candidates(self, cands_all, reads1, reads2, min_insert,
                           max_insert, discordant):
        """nvBowtie opposite-mate rescue (reference: the opposite
        alignment machinery in CDP/NvB/nvBowtie/bowtie2/cuda/score.cu —
        when one mate anchors, score the OTHER mate inside the insert
        window implied by the anchor instead of requiring its own
        seeds).  All rescue windows across the batch go through ONE
        batched dispatch; hits become ordinary candidates and pairing
        re-evaluates."""
        n = len(reads1)
        jobs = []      # (pair_idx, which_mate, w_lo, w_hi, rev, q_codes)
        for i in discordant:
            for which, (anch_list, other_read) in enumerate(
                ((cands_all[i], reads2[i]), (cands_all[n + i], reads1[i]))
            ):
                if not anch_list:
                    continue
                a = anch_list[0]
                # FR geometry: a forward anchor implies the mate maps
                # reverse downstream; a reverse anchor implies the mate
                # maps forward upstream
                if not a.reverse:
                    w_lo = a.pos
                    w_hi = a.pos + max_insert
                    seq = revcomp(other_read)
                    rev = True
                else:
                    w_hi = a.pos + a.ref_span
                    w_lo = w_hi - max_insert
                    seq = other_read
                    rev = False
                ci, _ = self.contig_of(min(max(a.pos, 0),
                                           len(self.ref_codes) - 1))
                w_lo = max(w_lo, int(self.contig_starts[ci]))
                w_hi = min(w_hi, int(self.contig_ends[ci]))
                if w_hi - w_lo < len(other_read) // 2:
                    continue
                jobs.append((i, which, w_lo, w_hi, rev, encode4(seq)))
        if not jobs:
            return
        q_list = [j[5] for j in jobs]
        t_list = [self.ref_codes4[j[2]:j[3]] for j in jobs]
        results = self.engine.align(q_list, t_list)
        for (i, which, w_lo, _w_hi, rev, qc), job in zip(jobs, results):
            # score gate (nvBowtie applies its min-score function to
            # opposite alignments too): a bare local max in a ~insert
            # window is almost always positive, so accept only hits
            # recovering at least half the perfect score
            if job.score < max(30, self.params.match * len(qc) // 2):
                continue
            cig = job.cigar_string
            cand = _Candidate(
                pos=w_lo + job.target_start,
                score=job.score,
                cigar=cig,
                reverse=rev,
                ref_span=_cigar_ref_span(cig),
            )
            # the rescued candidate belongs to the OPPOSITE mate
            tgt = (len(reads1) + i) if which == 0 else i
            cands_all[tgt].append(cand)
            cands_all[tgt].sort(key=lambda c: (-c.score, c.pos))

    def map_pairs(
        self,
        reads1: list[str],
        reads2: list[str],
        min_insert: int = 0,
        max_insert: int = 500,
        rescue: bool = True,
    ) -> list[tuple[Mapping, Mapping]]:
        """Paired-end mapping, bowtie2 default FR orientation: the
        upstream mate maps forward, the downstream mate reverse, with
        fragment length (outer distance) in [min_insert, max_insert].
        The candidate×candidate evaluation is vectorized (numpy).

        rescue=True scores the opposite mate's insert window when one
        mate anchors but no concordant pair exists (nvBowtie's
        opposite-mate machinery, score.cu), in one extra batched
        dispatch for the whole batch."""
        assert len(reads1) == len(reads2)
        n = len(reads1)
        cands_all = self._score_candidates(list(reads1) + list(reads2))
        evals = [
            self._pair_eval(cands_all[i], cands_all[n + i], min_insert,
                            max_insert)
            for i in range(n)
        ]
        if rescue:
            discordant = [i for i in range(n) if evals[i][0] is None]
            if discordant:
                self._rescue_candidates(cands_all, reads1, reads2,
                                        min_insert, max_insert, discordant)
                for i in discordant:
                    evals[i] = self._pair_eval(
                        cands_all[i], cands_all[n + i], min_insert,
                        max_insert)
        out: list[tuple[Mapping, Mapping]] = []
        for i in range(n):
            c1, c2 = cands_all[i], cands_all[n + i]
            best_pair, best_sum, second_sum = evals[i]
            m1 = self._reduce(reads1[i], c1)
            m2 = self._reduce(reads2[i], c2)
            if best_pair is not None:
                a, b = best_pair
                for m, c in ((m1, a), (m2, b)):
                    ci, local = self.contig_of(c.pos)
                    m.contig = self.contig_names[ci]
                    m.pos = local + 1
                    m.score = c.score
                    m.cigar_string = c.cigar
                    m.reverse = c.reverse
                    m.ref_span = c.ref_span
                    m.proper_pair = True
                    m.pair_score = best_sum
                # pair-level mapq: nvBowtie's paired path (mapq.h) feeds
                # the summed scores with paired=True
                mq = bowtie_mapq2(
                    best_sum,
                    second_sum if second_sum > 0 else None,
                    len(reads1[i]),
                    self.mapq_scheme,
                    paired=True,
                    o_read_len=len(reads2[i]),
                )
                m1.mapq = max(m1.mapq, mq)
                m2.mapq = max(m2.mapq, mq)
            out.append((m1, m2))
        return out
