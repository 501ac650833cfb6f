"""Bucketed batched dispatch of the five GASAL2 algorithms: LOCAL, GLOBAL,
SEMI_GLOBAL, KSW (bwa-mem's ksw_extend) and BANDED.

The counterpart of `genomics_tpu/runtime/dispatch.py`.  `AlignEngine`:

1. buckets jobs by padded (query_len, target_len), padding with N4
   (`default_buckets`/`_bucket_of` are the JAX engine's, so both engines
   make the same buckets);
2. launches one kernel per bucket on `device` (chunks of at most
   MAX_PAIRS_PER_LAUNCH pairs, fewer where the traceback cube would pass
   MAX_TB_BYTES; results do not depend on the chunking);
3. with traceback (LOCAL, GLOBAL, SEMI_GLOBAL), walks the nibble cube
   on the device too (`ops.tb_walk`), so only the O(Lq+Lt) op stream
   per pair comes back;
   for SEMI_GLOBAL the walk's start cell is first resolved from the
   kernel's ends on the device;
4. without traceback, serves `compute_start` (LOCAL, SEMI_GLOBAL) with
   GASAL2's reverse start pass fed the forward kernel's result on the
   device, and LOCAL's `second_best` with the inline second-best kernel
   (`ops.scan_align_full`, `ops.cuda_align`);
5. run-length encodes the op streams to byte-CIGARs on the host, with
   GLOBAL's and SEMI_GLOBAL's leading D/I pads.

Results come back in submission order, every `AlignmentJob` field as the
JAX engine gives it.  The JAX engine decodes GLOBAL and SEMI_GLOBAL
tracebacks on the host (native/cigar.cpp); here the walk runs on the
device and the host encodes, the split LOCAL already has.  The JAX
engine's 128-multiple batch floor and its 2048/1024 chunks exist for the
TPU's vector layout and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from genomics_tpu_torch.core import golds
from genomics_tpu_torch.core.encoding import N4, encode4
from genomics_tpu_torch.core.scoring import (
    AlgoType,
    AlignmentParams,
    SemiGlobalSkip,
)
from genomics_tpu_torch.ops import (
    cuda_align,
    scan_align,
    scan_align_full,
    tb_walk,
)

MAX_PAIRS_PER_LAUNCH = 65536
MAX_TB_BYTES = 1 << 32  # bound on one launch's traceback cube

_WALK = {AlgoType.LOCAL: "local", AlgoType.GLOBAL: "global",
         AlgoType.SEMI_GLOBAL: "semiglobal"}


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def default_buckets(max_len: int = 4096):
    """Bucket edges for sequence lengths: multiples of 8 up to 64, then
    ~1.5x geometric growth (keeps pad waste < ~33%)."""
    edges = [8, 16, 24, 32, 48, 64]
    v = 64
    while v < max_len:
        v = _round_up(int(v * 1.5), 8)
        edges.append(v)
    return edges


def _bucket_of(n: int, edges) -> int:
    for e in edges:
        if n <= e:
            return e
    return _round_up(n, 8)


@dataclasses.dataclass
class AlignmentJob:
    """One alignment result (order matches submission)."""

    score: int
    query_end: int = 0
    target_end: int = 0
    query_start: int = 0
    target_start: int = 0
    cigar: np.ndarray | None = None   # byte-CIGAR (walk order)
    score_second: int = 0
    query_end_second: int = 0
    target_end_second: int = 0

    @property
    def cigar_string(self) -> str:
        if self.cigar is None:
            return ""
        return golds.cigar_to_string(self.cigar)


def _pack_nibbles_np(nibs: np.ndarray) -> np.ndarray:
    """[B, Lt, Lq] uint8 nibbles → [B, Lt//8, Lq] int32 packed (8 target
    rows per word — the kernels' layout)."""
    B, Lt, Lq = nibs.shape
    r = nibs.reshape(B, Lt // 8, 8, Lq).astype(np.int64)
    shifts = 4 * np.arange(8, dtype=np.int64)
    return (r << shifts[None, None, :, None]).sum(axis=2).astype(np.int32)


def _codes(s) -> np.ndarray:
    if isinstance(s, (str, bytes)):
        return encode4(s)
    return np.asarray(s, np.uint8)


def walk_start(algo: AlgoType, tail: SemiGlobalSkip, res, qlen, tlen):
    """The traceback walk's start cell (i0, j0), [B] int32 tensors, from
    a kernel's result `res` and the lengths.  LOCAL starts at its ends;
    GLOBAL one cell past the end (get_tb.h, a reference quirk);
    SEMI_GLOBAL resolves the kernel's quirky ends per the tail policy, as
    the JAX engine does on the host (genomics_tpu/runtime/dispatch.py:
    403-416), here with torch.where on the results' device."""
    if algo == AlgoType.LOCAL:
        return res.target_end, res.query_end
    if algo == AlgoType.GLOBAL:
        return tlen, qlen
    j0, i0 = qlen - 1, tlen - 1
    if tail & SemiGlobalSkip.TARGET:
        i0 = res.target_end
    if tail & SemiGlobalSkip.QUERY:
        # the query-tail sweep won iff qend moved off its tlen init
        qwin = res.query_end != tlen
        j0 = torch.where(qwin, res.query_end, j0)
        i0 = torch.where(qwin, tlen - 1, i0)
    return i0, j0


class AlignEngine:
    """Batched alignment on one device, the card unless `device` says
    otherwise.

    >>> eng = AlignEngine(AlignmentParams(), with_tb=True)   # on "cuda"
    >>> results = eng.align(queries, targets)     # lists of str/bytes
    >>> ksw = AlignEngine(AlignmentParams(algo=AlgoType.KSW))
    >>> ext = ksw.align(queries, targets, h0=seed_scores)

    As in the JAX engine, SEMI_GLOBAL reads its skips from `head` and
    `tail` (not from params.head_skip / tail_skip), BANDED its band from
    `band_width_tiles` (not from params.band_width), KSW its seed scores
    from align's `h0` (0 by default); `score_only` applies to LOCAL, KSW
    and BANDED, `second_best` to LOCAL only, and `compute_start` is
    served by the traceback walk when there is one and by the reverse
    start pass otherwise (LOCAL and SEMI_GLOBAL).  KSW and BANDED give
    no traceback.  Where the JAX engine's Pallas and scan modes differ,
    this one gives the Pallas mode's fields: score-only reports ends of
    0, and with `second_best` (no traceback) the primary fields come
    from the second-best kernel.
    """

    def __init__(
        self,
        params: AlignmentParams,
        with_tb: bool = False,
        head: SemiGlobalSkip = SemiGlobalSkip.NONE,
        tail: SemiGlobalSkip = SemiGlobalSkip.NONE,
        score_only: bool = False,
        buckets: Sequence[int] | None = None,
        device: str | torch.device = "cuda",
        band_width_tiles: int = 4,
    ):
        algo = params.algo
        # KSW and BANDED have no traceback kernel: the JAX engine gives
        # them no CIGAR, so the traceback-cube chunk limit does not apply
        self.with_tb = (with_tb or params.with_traceback) and algo in _WALK
        self.second_best = params.second_best and algo == AlgoType.LOCAL
        # without traceback the starts come from the reverse start pass
        self.start_pass = (params.compute_start and not self.with_tb
                           and algo in (AlgoType.LOCAL, AlgoType.SEMI_GLOBAL))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"AlignEngine(device={str(device)!r}) needs a CUDA device; "
                "none is available")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.params = params
        self.head = head
        self.tail = tail
        # score-only runs the score kernels: scores, and ends left at 0
        self.score_only = score_only and algo in (
            AlgoType.LOCAL, AlgoType.KSW, AlgoType.BANDED)
        self.band_width_tiles = band_width_tiles
        self.buckets = list(buckets) if buckets else default_buckets()

    def _chunk_pairs(self, lq: int, lt: int) -> int:
        if not self.with_tb:
            return MAX_PAIRS_PER_LAUNCH
        per_pair = (lt // 8) * lq * 4
        return max(1, min(MAX_PAIRS_PER_LAUNCH, MAX_TB_BYTES // per_pair))

    def _scores(self, q, t, ql, tl, h0, has_n: bool) -> torch.Tensor:
        """The score-only kernel of LOCAL, KSW or BANDED."""
        p = self.params
        if p.algo == AlgoType.KSW:
            return cuda_align.ksw_align_scores(q, t, ql, tl, h0, p,
                                               has_n=has_n)
        if p.algo == AlgoType.BANDED:
            return cuda_align.banded_align_scores(
                q, t, ql, tl, p, self.band_width_tiles, has_n=has_n)
        return cuda_align.local_align_scores(q, t, p, has_n=has_n)

    def _run_chunk(self, qb: np.ndarray, tb: np.ndarray, qlen: np.ndarray,
                   tlen: np.ndarray, h0: np.ndarray, has_n: bool) -> dict:
        """Launch one chunk; returns device tensors: score, qend and tend
        (None when score-only), walk = (ops, final j, final i), starts =
        (qstart, tstart) from the start pass and second = (score2, qend2,
        tend2), each None when not asked for."""
        p = self.params
        q = torch.from_numpy(qb).to(self.device)
        t = torch.from_numpy(tb).to(self.device)
        ql = torch.from_numpy(qlen).to(self.device)
        tl = torch.from_numpy(tlen).to(self.device)
        h = (torch.from_numpy(h0).to(self.device) if p.algo == AlgoType.KSW
             else None)
        out = dict(walk=None, starts=None, second=None)
        if self.second_best and not self.with_tb:
            # the inline second-best kernel gives the primary fields too
            sec = cuda_align.local_align_second(q, t, ql, tl, p)
            res = scan_align.AlignResult(*sec[:3])
            out["second"] = sec[3:]
        elif self.score_only and not self.with_tb and not self.start_pass:
            out.update(score=self._scores(q, t, ql, tl, h, has_n), qend=None,
                       tend=None)
            return out
        elif p.algo == AlgoType.LOCAL:
            res = cuda_align.local_align(q, t, p, with_tb=self.with_tb)
        elif p.algo == AlgoType.GLOBAL:
            res = cuda_align.global_align(q, t, ql, tl, p,
                                          with_tb=self.with_tb)
        elif p.algo == AlgoType.SEMI_GLOBAL:
            res = cuda_align.semiglobal_align(
                q, t, ql, tl, p, head=self.head, tail=self.tail,
                with_tb=self.with_tb)
        elif p.algo == AlgoType.KSW:
            res = cuda_align.ksw_align(q, t, ql, tl, h, p)
        else:
            res = cuda_align.banded_align(q, t, ql, tl, p,
                                          self.band_width_tiles)
        if self.second_best and self.with_tb:
            # traceback kernel for the primary fields, the second-best
            # kernel for the *_second ones (genomics_tpu dispatch.py:306)
            out["second"] = cuda_align.local_align_second(q, t, ql, tl, p)[3:]
        if self.with_tb:
            i0, j0 = walk_start(p.algo, self.tail, res, ql, tl)
            out["walk"] = tb_walk.tb_walk(res.tb, res.score, j0, i0, p,
                                          _WALK[p.algo])
        if self.start_pass and p.algo == AlgoType.LOCAL:
            out["starts"] = scan_align_full.local_starts(q, t, ql, tl,
                                                         *res[:3], p)
        elif self.start_pass:
            out["starts"] = scan_align_full.semiglobal_starts(
                q, t, ql, tl, *res[:3], p, head=self.head, tail=self.tail)
        if self.start_pass and self.score_only and out["second"] is None:
            # score-only reports no ends, as the JAX engine's score kernel
            # does; the full forward pass above only fed the start pass
            res = res._replace(query_end=None, target_end=None)
        out.update(score=res.score, qend=res.query_end, tend=res.target_end)
        return out

    def _dispatch(self, queries, targets, h0=None):
        """Launch every chunk (the device runs ahead of the host);
        returns the pending state for _collect."""
        if len(queries) != len(targets):
            raise ValueError(
                f"queries/targets length mismatch: {len(queries)} vs "
                f"{len(targets)}")
        h0 = (np.zeros(len(queries), np.int32) if h0 is None
              else np.asarray(h0, np.int32))
        if h0.shape != (len(queries),):
            raise ValueError(f"h0 needs one seed score per pair; got shape "
                             f"{h0.shape} for {len(queries)} pairs")
        enc_q = [_codes(s) for s in queries]
        enc_t = [_codes(s) for s in targets]
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (eq, et) in enumerate(zip(enc_q, enc_t)):
            key = (_bucket_of(len(eq), self.buckets),
                   _bucket_of(len(et), self.buckets))
            groups.setdefault(key, []).append(i)
        pending = []
        for (lq, lt), idxs in groups.items():
            step = self._chunk_pairs(lq, lt)
            for pos in range(0, len(idxs), step):
                chunk = idxs[pos:pos + step]
                qb = np.full((len(chunk), lq), N4, np.uint8)
                tb = np.full((len(chunk), lt), N4, np.uint8)
                qlen = np.empty(len(chunk), np.int32)
                tlen = np.empty(len(chunk), np.int32)
                hb = h0[chunk]
                has_n = False
                for k, i in enumerate(chunk):
                    qlen[k] = len(enc_q[i])
                    tlen[k] = len(enc_t[i])
                    qb[k, :qlen[k]] = enc_q[i]
                    tb[k, :tlen[k]] = enc_t[i]
                    has_n = has_n or (N4 in enc_q[i]) or (N4 in enc_t[i])
                pending.append(
                    (chunk, self._run_chunk(qb, tb, qlen, tlen, hb, has_n)))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return pending, len(queries), event

    def _collect(self, pending, n) -> list[AlignmentJob]:
        """Copy results to the host (waits for the device) and build jobs."""
        out: list[AlignmentJob | None] = [None] * n

        def host(xs):
            return None if xs is None else [x.cpu().numpy() for x in xs]

        for idxs, r in pending:
            score = r["score"].cpu().numpy()
            ends = None if r["qend"] is None else host((r["qend"], r["tend"]))
            starts, second = host(r["starts"]), host(r["second"])
            cigars = None
            if r["walk"] is not None:
                cigars, n_ops, *starts = tb_walk.cigars_from_walk(
                    *host(r["walk"]), _WALK[self.params.algo],
                    head_q=bool(self.head & SemiGlobalSkip.QUERY),
                    head_t=bool(self.head & SemiGlobalSkip.TARGET))
            for k, i in enumerate(idxs):
                job = AlignmentJob(score=int(score[k]))
                if ends is not None:
                    job.query_end = int(ends[0][k])
                    job.target_end = int(ends[1][k])
                if cigars is not None:
                    job.cigar = cigars[k, :n_ops[k]].copy()
                if starts is not None:
                    job.query_start = int(starts[0][k])
                    job.target_start = int(starts[1][k])
                if second is not None:
                    job.score_second = int(second[0][k])
                    job.query_end_second = int(second[1][k])
                    job.target_end_second = int(second[2][k])
                out[i] = job
        return out  # type: ignore[return-value]

    def align(self, queries: Sequence, targets: Sequence,
              h0: Sequence[int] | None = None) -> list[AlignmentJob]:
        """Align pairs (str, bytes or uint8 code arrays); returns results
        in submission order.  h0: KSW's seed score per pair (default 0;
        the other algorithms ignore it)."""
        pending, n, _event = self._dispatch(queries, targets, h0)
        return self._collect(pending, n)

    def align_async(self, queries: Sequence, targets: Sequence,
                    h0: Sequence[int] | None = None) -> AsyncHandle:
        """Submit a batch; the device starts now and the host returns.

        >>> h1 = eng.align_async(q1, t1)   # device busy with batch 1
        >>> h2 = eng.align_async(q2, t2)   # prep + launch batch 2 meanwhile
        >>> r1, r2 = h1.result(), h2.result()
        """
        pending, n, event = self._dispatch(queries, targets, h0)
        return AsyncHandle(lambda: self._collect(pending, n), event)


class AsyncHandle:
    """In-flight batch.  `done()` is a non-blocking query of a CUDA event
    recorded after the batch's last launch (the cudaStreamQuery behind
    gasal_is_aln_async_done); on the CPU the work is already done.
    `result()` copies the results back and builds the jobs."""

    def __init__(self, finisher, event: torch.cuda.Event | None):
        self._finisher = finisher
        self._event = event
        self._result = None

    def done(self) -> bool:
        return (self._result is not None or self._event is None
                or self._event.query())

    def result(self) -> list[AlignmentJob]:
        if self._result is None:
            self._result = self._finisher()
        return self._result
