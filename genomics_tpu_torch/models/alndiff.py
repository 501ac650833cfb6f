"""nvbio-aln-diff: compare two alignment files (SE or PE), emit stats +
report.  The port's copy of `genomics_tpu/models/alndiff.py`, host code in
both packages, reading BAM through the port's `utils/bamio.py`.

Reference: CDP/NvB/nvbio-aln-diff/
  - Alignment struct + flags       alignment.h:36-105
  - distant()                      alignment.h:107-112
  - Histogram/Histogram2d/log_bin  utils.h:67-135, 196-203
  - read_length_bin                utils.h:169-194
  - Stats / StatsPartition         stats.h:39-135
  - AlignmentStats (9 stats)       stats.h:137-149
  - Filter (binary read-id dump)   filter.h:36-110
  - SEAnalyzer::push               se_analyzer.cpp:43-160
  - PEAnalyzer::push               pe_analyzer.cpp:44-250
  - driver flags (-paired, -report, -filter, -no-ids)  nvbio-aln-diff.cpp:51-130

The reference walks records one at a time on the host; here each file
is parsed into a struct-of-arrays and every statistic is a batched
histogram update (np.add.at over the whole batch), so the analyzer is
one vectorized pass rather than a per-read loop.  Analysis is host-side by design — it is an offline reporting
tool, not a device hot path.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

# Alignment::flag bits (alignment.h:46-56) — standard SAM flags.
PAIRED = 1
PROPER_PAIR = 2
UNMAPPED = 4
MATE_UNMAPPED = 8
REVERSE = 16
MATE_REVERSE = 32
READ_1 = 64
READ_2 = 128
SECONDARY = 256
QC_FAILED = 512
DUPLICATE = 1024

# Filter flag / statistic enums (filter.h:46-47)
F_DISTANT = 1
F_DISCORDANT = 2
F_DIFFERENT_REF = 4
F_ALL = 0xFFFFFFFF
S_ED = 1
S_MAPQ = 2
S_MMS = 4
S_INS = 8
S_DELS = 16
S_SCORE = 32
S_ALL = 0xFFFFFFFF


def log_bin(x):
    """utils.h:196-203: 0→0, x>0→1+log2(x), x<0→-(1+log2(-x)), vectorized."""
    x = np.asarray(x, np.int64)
    mag = np.where(x == 0, 1, np.abs(x))
    lb = (1 + np.floor(np.log2(mag))).astype(np.int64)
    return np.where(x == 0, 0, np.where(x > 0, lb, -lb)).astype(np.int32)


def read_length_bin(read_len):
    """utils.h:169-194 (edges 16/36/100/150/200/250/300/350/400/450/500)."""
    edges = np.array([16, 36, 100, 150, 200, 250, 300, 350, 400, 450, 500])
    return np.searchsorted(edges, np.asarray(read_len), side="left").astype(
        np.int32
    )


class Histogram:
    """utils.h:67-112: 2X bins, index i stored at i+X, clamped."""

    def __init__(self, X: int):
        self.X = X
        self.bins = np.zeros(2 * X, np.int64)
        self.count = 0

    def push(self, idx, mask=None):
        idx = np.asarray(idx, np.int64)
        if mask is not None:
            idx = idx[np.asarray(mask)]
        clamped = np.clip(idx + self.X, 0, 2 * self.X - 1)
        np.add.at(self.bins, clamped, 1)
        self.count += int(idx.size)

    def __getitem__(self, i):
        return int(self.bins[i + self.X])

    def all_but(self, i):
        return self.count - self[i]


class Histogram2d:
    """utils.h:114-135."""

    def __init__(self, X: int, Y: int):
        self.X, self.Y = X, Y
        self.bins = np.zeros((2 * X, 2 * Y), np.int64)
        self.count = 0

    def push(self, x, y, mask=None):
        x = np.asarray(x, np.int64)
        y = np.asarray(y, np.int64)
        x, y = np.broadcast_arrays(x, y)
        if mask is not None:
            m = np.asarray(mask)
            x, y = x[m], y[m]
        bx = np.clip(x + self.X, 0, 2 * self.X - 1)
        by = np.clip(y + self.Y, 0, 2 * self.Y - 1)
        np.add.at(self.bins, (bx, by), 1)
        self.count += int(x.size)


class BooleanStats:
    """L/R truth-table counts (utils.h BooleanStats)."""

    def __init__(self):
        self.L = 0          # L and not R
        self.R = 0          # R and not L
        self.L_and_R = 0
        self.neither = 0

    def push(self, l, r):
        l = np.asarray(l, bool)
        r = np.asarray(r, bool)
        self.L += int(np.sum(l & ~r))
        self.R += int(np.sum(r & ~l))
        self.L_and_R += int(np.sum(l & r))
        self.neither += int(np.sum(~l & ~r))

    @property
    def count(self):
        return self.L + self.R + self.L_and_R + self.neither


class StatsPartition:
    """stats.h:39-50."""

    def __init__(self):
        self.hist = Histogram(256)
        self.hist_by_length = Histogram2d(12, 10)
        self.hist_by_mapQ = Histogram2d(12, 10)
        self.diff_hist = Histogram(256)
        self.diff_hist_by_length = Histogram2d(12, 10)
        self.diff_hist_by_value_neg = Histogram2d(32, 10)
        self.diff_hist_by_value_pos = Histogram2d(32, 10)
        self.diff_hist_by_mapQ1 = Histogram2d(7, 12)
        self.diff_hist_by_mapQ2 = Histogram2d(7, 12)


class Stats:
    """stats.h:52-135, batched.  type: 'lower'|'higher'; bins: 'log'|'linear'.

    push() returns the signed per-element delta array (the value the
    reference feeds to the Filter)."""

    def __init__(self, type_: str, bins: str):
        self.type = type_
        self.bins = bins
        self.l = StatsPartition()
        self.r = StatsPartition()

    def _push_side(self, p, val, length_bin, mapq):
        lb = log_bin(val)
        p.hist.push(lb if self.bins == "log" else val)
        p.hist_by_length.push(length_bin, lb)
        p.hist_by_mapQ.push(log_bin(mapq), lb)

    def _push_diff(self, p, diff, val_other, length_bin, mapq1, mapq2, mask):
        ld = log_bin(diff)
        p.diff_hist.push(ld if self.bins == "log" else diff, mask)
        p.diff_hist_by_length.push(length_bin, ld, mask)
        p.diff_hist_by_mapQ1.push(log_bin(mapq1), ld, mask)
        p.diff_hist_by_mapQ2.push(log_bin(mapq2), ld, mask)
        neg = val_other < 0
        p.diff_hist_by_value_neg.push(log_bin(-val_other), ld, mask & neg)
        p.diff_hist_by_value_pos.push(log_bin(val_other), ld, mask & ~neg)

    def push(self, val1, val2, length_bin, mapq1, mapq2):
        val1 = np.asarray(val1, np.int64)
        val2 = np.asarray(val2, np.int64)
        if val1.size == 0:
            return np.zeros(0, np.int64)
        self._push_side(self.l, val1, length_bin, mapq1)
        self._push_side(self.r, val2, length_bin, mapq2)
        if self.type == "lower":
            diff = val2 - val1
            lval, rval = val1, val2  # value axis: l keys off val1, r off val2
        else:
            diff = val1 - val2
            lval, rval = val2, val1  # stats.h:113-132 (HIGHER keys off other side)
        self._push_diff(self.l, diff, lval, length_bin, mapq1, mapq2, diff >= 0)
        self._push_diff(self.r, -diff, rval, length_bin, mapq1, mapq2, diff <= 0)
        return diff


class AlignmentStats:
    """stats.h:137-149."""

    def __init__(self):
        self.higher_score = Stats("higher", "log")
        self.lower_ed = Stats("lower", "linear")
        self.higher_mapQ = Stats("higher", "log")
        self.longer_mapping = Stats("higher", "log")
        self.higher_pos = Stats("higher", "log")
        self.lower_subs = Stats("lower", "linear")
        self.lower_ins = Stats("lower", "linear")
        self.lower_dels = Stats("lower", "linear")
        self.lower_mms = Stats("lower", "linear")


class Filter:
    """filter.h:36-110: collect read ids whose stat delta crosses `delta`
    under matching read flags; written as raw uint32 (same binary format)."""

    def __init__(self, file_name=None, flags=F_ALL, stats=S_ALL, delta=5):
        self.file_name = file_name
        self.flags = flags
        self.stats = stats
        self.delta = delta
        self.read_ids: list[int] = []

    def push(self, delta, read_flags, stat, read_ids):
        if self.file_name is None:
            return
        delta = np.asarray(delta, np.int64)
        hit = (
            ((read_flags & self.flags) != 0)
            & ((self.stats & stat) != 0)
            & (delta >= self.delta if self.delta > 0 else delta <= self.delta)
        )
        self.read_ids.extend(np.asarray(read_ids)[hit].tolist())

    @property
    def filtered(self):
        return len(self.read_ids)

    def flush(self):
        if self.file_name:
            np.asarray(self.read_ids, np.uint32).tofile(self.file_name)


@dataclasses.dataclass
class AlignmentBatch:
    """Struct-of-arrays Alignment (alignment.h:36-105)."""

    read_id: np.ndarray
    read_len: np.ndarray
    pos: np.ndarray
    ref_id: np.ndarray
    flag: np.ndarray
    score: np.ndarray
    mapq: np.ndarray
    ed: np.ndarray
    subs: np.ndarray
    ins: np.ndarray
    dels: np.ndarray
    n_mm: np.ndarray
    has_second: np.ndarray
    sec_score: np.ndarray
    name: list

    def __len__(self):
        return len(self.read_id)

    @property
    def is_mapped(self):       # alignment.h:77
        return (self.pos != 0) & ((self.flag & UNMAPPED) == 0)

    @property
    def is_rc(self):
        return (self.flag & REVERSE) != 0

    @property
    def is_unique(self):       # alignment.h:79
        return self.is_mapped & ~self.has_second.astype(bool)

    @property
    def is_ambiguous(self):    # alignment.h:80
        return self.is_mapped & self.has_second.astype(bool) & (
            self.sec_score == self.score
        )

    @property
    def mapped_read_bases(self):   # alignment.h:82
        return self.subs + self.ins


_CIG_RE = re.compile(rb"(\d+)([MIDNSHP=X])")


def _parse_sam_lines(lines) -> AlignmentBatch:
    refs: dict[bytes, int] = {}
    rows = []
    names = []
    for ln in lines:
        if not ln or ln.startswith(b"@"):
            continue
        f = ln.rstrip(b"\n").split(b"\t")
        flag = int(f[1])
        if flag & SECONDARY:
            continue
        rname = f[2]
        ref_id = 0xFFFFFFFF
        if rname != b"*":
            ref_id = refs.setdefault(rname, len(refs))
        subs = ins = dels = 0
        for cnt, op in _CIG_RE.findall(f[5]):
            c = int(cnt)
            if op in b"M=X":
                subs += c
            elif op == b"I":
                ins += c
            elif op == b"D":
                dels += c
        read_len = len(f[9]) if f[9] != b"*" else subs + ins
        tags = dict()
        for t in f[11:]:
            k, typ, v = t.split(b":", 2)
            tags[k] = int(v) if typ == b"i" else v
        names.append(f[0])
        rows.append(
            (
                len(rows),
                read_len,
                int(f[3]),
                ref_id,
                flag,
                tags.get(b"AS", -65536),
                int(f[4]),
                tags.get(b"NM", 255),
                subs,
                ins,
                dels,
                tags.get(b"NM", 0),
                1 if b"XS" in tags else 0,
                tags.get(b"XS", -65536),
            )
        )
    arr = np.array(rows, np.int64).reshape(-1, 14)
    return AlignmentBatch(*(arr[:, i] for i in range(14)), name=names)


def load_alignments(path: str) -> AlignmentBatch:
    """Load a SAM (.sam) or BAM (.bam) file into a batch (behavioral
    analog of alignment_bam.cpp / alignment_dbg.cpp readers)."""
    if path.endswith(".bam"):
        from genomics_tpu_torch.utils import bamio

        _, refs, records = bamio.read_bam(path)
        lines = [
            (
                f"{r.name}\t{r.flag}\t"
                f"{refs[r.ref_id][0] if r.ref_id >= 0 else '*'}\t"
                f"{r.pos + 1}\t{r.mapq}\t{r.cigar}\t*\t0\t{r.tlen}\t{r.seq}"
            ).encode()
            for r in records
        ]
        return _parse_sam_lines(lines)
    with open(path, "rb") as fh:
        return _parse_sam_lines(fh)


def _distant(L: AlignmentBatch, R: AlignmentBatch):
    """alignment.h:107-112."""
    return (L.pos < R.pos - L.read_len) | (L.pos > R.pos + L.read_len)


class SEAnalyzer:
    """se_analyzer.cpp:43-160, batched."""

    def __init__(self, filter: Optional[Filter] = None):
        self.filter = filter or Filter()
        self.n = 0
        self.n_mismatched = 0
        self.mapped = BooleanStats()
        self.unique = BooleanStats()
        self.ambiguous = BooleanStats()
        self.mapped_L_not_R_by_mapQ = Histogram(8)
        self.mapped_R_not_L_by_mapQ = Histogram(8)
        self.unique_L_not_R_by_mapQ = Histogram(8)
        self.unique_R_not_L_by_mapQ = Histogram(8)
        self.ambiguous_L_not_R_by_mapQ = Histogram(8)
        self.ambiguous_R_not_L_by_mapQ = Histogram(8)
        self.n_different_ref = Histogram(8)
        self.n_distant = Histogram(8)
        self.n_discordant = Histogram(8)
        self.al_stats = AlignmentStats()
        self.distant_stats = AlignmentStats()
        self.discordant_stats = AlignmentStats()

    def push_batch(self, L: AlignmentBatch, R: AlignmentBatch, id_check=True):
        ok = L.read_len == R.read_len
        if id_check:
            ok = ok & np.array(
                [a == b for a, b in zip(L.name, R.name)], bool
            )
        self.n_mismatched += int(np.sum(~ok))
        idx = np.nonzero(ok)[0]
        L = AlignmentBatch(
            **{
                f.name: (getattr(L, f.name)[idx] if f.name != "name" else
                         [L.name[i] for i in idx])
                for f in dataclasses.fields(L)
            }
        )
        R = AlignmentBatch(
            **{
                f.name: (getattr(R, f.name)[idx] if f.name != "name" else
                         [R.name[i] for i in idx])
                for f in dataclasses.fields(R)
            }
        )
        self.n += len(L)

        mL, mR = L.is_mapped, R.is_mapped
        uL, uR = L.is_unique, R.is_unique
        aL, aR = L.is_ambiguous, R.is_ambiguous
        self.mapped.push(mL, mR)
        self.unique.push(uL, uR)
        self.ambiguous.push(aL, aR)
        self.mapped_L_not_R_by_mapQ.push(log_bin(L.mapq), mL & ~mR)
        self.mapped_R_not_L_by_mapQ.push(log_bin(R.mapq), mR & ~mL)
        self.unique_L_not_R_by_mapQ.push(log_bin(L.mapq), uL & ~uR)
        self.unique_R_not_L_by_mapQ.push(log_bin(R.mapq), uR & ~uL)
        self.ambiguous_L_not_R_by_mapQ.push(log_bin(L.mapq), aL & ~aR)
        self.ambiguous_R_not_L_by_mapQ.push(log_bin(R.mapq), aR & ~aL)

        both = mL & mR
        mapq_bin = log_bin(R.mapq)
        diff_ref = both & (L.ref_id != R.ref_id)
        distant = both & (diff_ref | _distant(L, R))
        discord = both & (L.is_rc != R.is_rc)
        self.n_different_ref.push(mapq_bin, diff_ref)
        self.n_distant.push(mapq_bin, distant)
        self.n_discordant.push(mapq_bin, discord)
        read_flags = (
            np.where(distant, F_DISTANT, 0)
            | np.where(diff_ref, F_DIFFERENT_REF, 0)
            | np.where(discord, F_DISCORDANT, 0)
        )

        def sel(batch, m):
            return AlignmentBatch(
                **{
                    f.name: (
                        getattr(batch, f.name)[m]
                        if f.name != "name"
                        else [n for n, k in zip(batch.name, m) if k]
                    )
                    for f in dataclasses.fields(batch)
                }
            )

        for stats, mask, use_filter in (
            (self.al_stats, both, True),
            (self.distant_stats, distant, False),
            (self.discordant_stats, discord, False),
        ):
            sL, sR = sel(L, mask), sel(R, mask)
            lb = read_length_bin(sL.read_len)
            rf = read_flags[mask]
            d = stats.lower_ed.push(sL.ed, sR.ed, lb, sL.mapq, sR.mapq)
            if use_filter:
                self.filter.push(d, rf, S_ED, sL.read_id)
            d = stats.higher_mapQ.push(sL.mapq, sR.mapq, lb, sL.mapq, sR.mapq)
            if use_filter:
                self.filter.push(d, rf, S_MAPQ, sL.read_id)
            stats.longer_mapping.push(
                sL.mapped_read_bases, sR.mapped_read_bases, lb, sL.mapq, sR.mapq
            )
            stats.lower_subs.push(sL.subs, sR.subs, lb, sL.mapq, sR.mapq)
            d = stats.lower_mms.push(sL.n_mm, sR.n_mm, lb, sL.mapq, sR.mapq)
            if use_filter:
                self.filter.push(d, rf, S_MMS, sL.read_id)
            d = stats.lower_ins.push(sL.ins, sR.ins, lb, sL.mapq, sR.mapq)
            if use_filter:
                self.filter.push(d, rf, S_INS, sL.read_id)
            d = stats.lower_dels.push(sL.dels, sR.dels, lb, sL.mapq, sR.mapq)
            if use_filter:
                self.filter.push(d, rf, S_DELS, sL.read_id)
            stats.higher_pos.push(sL.pos, sR.pos, lb, sL.mapq, sR.mapq)

    @property
    def mismatched(self):
        return self.n_mismatched / max(self.n + self.n_mismatched, 1)

    @property
    def different_ref(self):
        return self.n_different_ref.count / max(self.n, 1)

    @property
    def distant(self):
        return self.n_distant.count / max(self.n, 1)

    @property
    def discordant(self):
        return self.n_discordant.count / max(self.n, 1)


class PEAnalyzer:
    """pe_analyzer.cpp:44-250, batched: pair-level concordance stats +
    AlignmentStats over pair-summed fields (AlignmentPair accessors,
    alignment.h:114-162)."""

    def __init__(self, filter: Optional[Filter] = None):
        self.filter = filter or Filter()
        self.n = 0
        self.n_mismatched = 0
        self.mapped = BooleanStats()
        self.paired = BooleanStats()
        self.unique = BooleanStats()
        self.ambiguous = BooleanStats()
        self.paired_L_not_R_by_mapQ = Histogram(8)
        self.paired_R_not_L_by_mapQ = Histogram(8)
        self.unique_L_not_R_by_mapQ = Histogram(8)
        self.unique_R_not_L_by_mapQ = Histogram(8)
        self.ambiguous_L_not_R_by_mapQ = Histogram(8)
        self.ambiguous_R_not_L_by_mapQ = Histogram(8)
        self.n_different_ref = Histogram(8)
        self.n_different_ref1 = Histogram(8)
        self.n_different_ref2 = Histogram(8)
        self.n_different_ref12 = Histogram(8)
        self.n_distant = Histogram(8)
        self.n_discordant = Histogram(8)
        self.al_stats = AlignmentStats()

    @staticmethod
    def _split_mates(batch: AlignmentBatch):
        m1 = (batch.flag & READ_1) != 0
        m2 = (batch.flag & READ_2) != 0

        def sel(m):
            return AlignmentBatch(
                **{
                    f.name: (
                        getattr(batch, f.name)[m]
                        if f.name != "name"
                        else [n for n, k in zip(batch.name, m) if k]
                    )
                    for f in dataclasses.fields(batch)
                }
            )

        return sel(m1), sel(m2)

    def push_batch(self, L: AlignmentBatch, R: AlignmentBatch, id_check=True):
        L1, L2 = self._split_mates(L)
        R1, R2 = self._split_mates(R)
        k = min(len(L1), len(L2), len(R1), len(R2))
        ok = (
            (L1.read_len[:k] == R1.read_len[:k])
            & (L2.read_len[:k] == R2.read_len[:k])
        )
        if id_check:
            ok = ok & np.array(
                [a == b for a, b in zip(L1.name[:k], R1.name[:k])], bool
            )
        self.n_mismatched += int(np.sum(~ok))
        idx = np.nonzero(ok)[0]

        def sub(b):
            return AlignmentBatch(
                **{
                    f.name: (
                        getattr(b, f.name)[:k][idx]
                        if f.name != "name"
                        else [b.name[i] for i in idx]
                    )
                    for f in dataclasses.fields(b)
                }
            )

        L1, L2, R1, R2 = sub(L1), sub(L2), sub(R1), sub(R2)
        self.n += len(L1)

        def pair_mapped(a, b):
            return a.is_mapped & b.is_mapped

        def pair_paired(a, b):
            return pair_mapped(a, b) & ((a.flag & PROPER_PAIR) != 0)

        def pair_unique(a, b):
            return pair_paired(a, b) & (
                ~a.has_second.astype(bool) | ~b.has_second.astype(bool)
            )

        def pair_ambiguous(a, b):
            return (
                pair_paired(a, b)
                & a.has_second.astype(bool)
                & b.has_second.astype(bool)
                & ((a.sec_score + b.sec_score) == (a.score + b.score))
            )

        mL, mR = pair_mapped(L1, L2), pair_mapped(R1, R2)
        pL, pR = pair_paired(L1, L2), pair_paired(R1, R2)
        uL, uR = pair_unique(L1, L2), pair_unique(R1, R2)
        aL, aR = pair_ambiguous(L1, L2), pair_ambiguous(R1, R2)
        self.mapped.push(mL, mR)
        self.paired.push(pL, pR)
        self.unique.push(uL, uR)
        self.ambiguous.push(aL, aR)
        self.paired_L_not_R_by_mapQ.push(log_bin(L1.mapq), pL & ~pR)
        self.paired_R_not_L_by_mapQ.push(log_bin(R1.mapq), pR & ~pL)
        self.unique_L_not_R_by_mapQ.push(log_bin(L1.mapq), uL & ~uR)
        self.unique_R_not_L_by_mapQ.push(log_bin(R1.mapq), uR & ~uL)
        self.ambiguous_L_not_R_by_mapQ.push(log_bin(L1.mapq), aL & ~aR)
        self.ambiguous_R_not_L_by_mapQ.push(log_bin(R1.mapq), aR & ~aL)

        both = pL & pR
        mapq_bin = log_bin(R1.mapq)
        d1 = both & (L1.ref_id != R1.ref_id)
        d2 = both & (L2.ref_id != R2.ref_id)
        self.n_different_ref12.push(mapq_bin, d1 & d2)
        self.n_different_ref1.push(mapq_bin, d1 & ~d2)
        self.n_different_ref2.push(mapq_bin, d2 & ~d1)
        diff_ref = d1 | d2
        self.n_different_ref.push(mapq_bin, diff_ref)
        distant = both & (diff_ref | _distant(L1, R1) | _distant(L2, R2))
        self.n_distant.push(mapq_bin, distant)
        discord = both & (
            (L1.is_rc != R1.is_rc) | (L2.is_rc != R2.is_rc)
        )
        self.n_discordant.push(mapq_bin, discord)
        read_flags = (
            np.where(distant, F_DISTANT, 0)
            | np.where(diff_ref, F_DIFFERENT_REF, 0)
            | np.where(discord, F_DISCORDANT, 0)
        )[both]

        lb = read_length_bin(L1.read_len[both] + L2.read_len[both])
        mq1 = L1.mapq[both]
        mq2 = R1.mapq[both]

        def ps(a, b, field):
            return getattr(a, field)[both] + getattr(b, field)[both]

        d = self.al_stats.lower_ed.push(
            ps(L1, L2, "ed"), ps(R1, R2, "ed"), lb, mq1, mq2
        )
        self.filter.push(d, read_flags, S_ED, L1.read_id[both])
        d = self.al_stats.higher_mapQ.push(mq1, mq2, lb, mq1, mq2)
        self.filter.push(d, read_flags, S_MAPQ, L1.read_id[both])
        d = self.al_stats.higher_score.push(
            ps(L1, L2, "score"), ps(R1, R2, "score"), lb, mq1, mq2
        )
        self.filter.push(d, read_flags, S_SCORE, L1.read_id[both])
        self.al_stats.longer_mapping.push(
            L1.mapped_read_bases[both] + L2.mapped_read_bases[both],
            R1.mapped_read_bases[both] + R2.mapped_read_bases[both],
            lb, mq1, mq2,
        )
        for f, stat, sflag in (
            ("subs", self.al_stats.lower_subs, None),
            ("n_mm", self.al_stats.lower_mms, S_MMS),
            ("ins", self.al_stats.lower_ins, S_INS),
            ("dels", self.al_stats.lower_dels, S_DELS),
        ):
            d = stat.push(ps(L1, L2, f), ps(R1, R2, f), lb, mq1, mq2)
            if sflag is not None:
                self.filter.push(d, read_flags, sflag, L1.read_id[both])


def _html_hist_table(title: str, h: Histogram) -> str:
    rows = "".join(
        f"<tr><td>{i - h.X}</td><td>{int(v)}</td></tr>"
        for i, v in enumerate(h.bins)
        if v
    )
    return (
        f"<h3>{title}</h3><table border=1>"
        f"<tr><th>bin</th><th>count</th></tr>{rows}</table>"
    )


def generate_report(analyzer, file1: str, file2: str, report: str):
    """Behavioral html.h: summary tables + non-empty histograms."""
    b = []
    b.append(f"<html><head><title>nvbio-aln-diff report</title></head><body>")
    b.append(f"<h1>{file1} vs {file2}</h1>")
    b.append(f"<p>n = {analyzer.n}, mismatched = {analyzer.n_mismatched}</p>")
    for name in ("mapped", "paired", "unique", "ambiguous"):
        s = getattr(analyzer, name, None)
        if s is None:
            continue
        b.append(
            f"<h3>{name}</h3><table border=1>"
            f"<tr><th>L&R</th><th>L only</th><th>R only</th><th>neither</th></tr>"
            f"<tr><td>{s.L_and_R}</td><td>{s.L}</td><td>{s.R}</td>"
            f"<td>{s.neither}</td></tr></table>"
        )
    for name in ("n_different_ref", "n_distant", "n_discordant"):
        b.append(_html_hist_table(f"{name} by mapQ bin", getattr(analyzer, name)))
    for sname in ("lower_ed", "higher_mapQ", "longer_mapping"):
        st = getattr(analyzer.al_stats, sname)
        b.append(_html_hist_table(f"{sname} L diff", st.l.diff_hist))
        b.append(_html_hist_table(f"{sname} R diff", st.r.diff_hist))
    b.append("</body></html>")
    with open(report, "w") as fh:
        fh.write("\n".join(b))


def diff(
    file1: str,
    file2: str,
    paired: bool = False,
    report: Optional[str] = None,
    filter: Optional[Filter] = None,
    id_check: bool = True,
):
    """Top-level driver (nvbio-aln-diff.cpp:51-210): load both files,
    run the SE or PE analyzer, optionally write report + filter file."""
    L = load_alignments(file1)
    R = load_alignments(file2)
    analyzer = PEAnalyzer(filter) if paired else SEAnalyzer(filter)
    analyzer.push_batch(L, R, id_check=id_check)
    if filter is not None:
        filter.flush()
    if report:
        generate_report(analyzer, file1, file2, report)
    return analyzer
