"""Bucketed batched dispatch of the five GASAL2 algorithms: LOCAL, GLOBAL,
SEMI_GLOBAL, KSW (bwa-mem's ksw_extend) and BANDED.

The counterpart of `genomics_tpu/runtime/dispatch.py`.  `AlignEngine`:

1. buckets jobs by padded (query_len, target_len), padding with N4
   (`default_buckets`/`_bucket_of` are the JAX engine's, so both engines
   make the same buckets), a batch at a time: one sort groups its pairs,
   and a chunk's rows come from one join of its bytes or one concatenate
   of its code arrays, with no Python loop over the pairs;
2. launches one kernel per bucket on `device` (chunks of at most
   MAX_PAIRS_PER_LAUNCH pairs, fewer where the traceback cube would pass
   MAX_TB_BYTES; results do not depend on the chunking);
3. with traceback (LOCAL, GLOBAL, SEMI_GLOBAL), walks the nibble cube
   on the device too (`ops.tb_walk.walk_cigars`), straight to
   byte-CIGARs with GLOBAL's and SEMI_GLOBAL's leading D/I pads and the
   starts, so only those bytes come back; for SEMI_GLOBAL the walk's
   start cell is first resolved from the kernel's ends on the device;
4. without traceback, serves `compute_start` (LOCAL, SEMI_GLOBAL) with
   GASAL2's reverse start pass fed the forward kernel's result on the
   device, and LOCAL's `second_best` with the inline second-best kernel
   (`ops.scan_align_full`, `ops.cuda_align`).

Results come back in submission order, every `AlignmentJob` field as the
JAX engine gives it.  The JAX engine decodes tracebacks on the host
(native/cigar.cpp); here the card writes the bytes.  The JAX
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
from genomics_tpu_torch.device import checked_device
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
from genomics_tpu_torch.utils import profiling

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


def _buckets_of(lens: np.ndarray, edges) -> np.ndarray:
    """`_bucket_of` over an array of lengths, as int64.  The first edge
    at least n is where the edges' running maximum first reaches n, so a
    search of that maximum gives it for edges in any order."""
    top = np.maximum.accumulate(np.asarray(edges, np.int64))
    lens = np.asarray(lens, np.int64)
    pos = np.searchsorted(top, lens)
    out = top.take(pos, mode="clip")
    past = pos == len(top)
    if past.any():
        out[past] = _round_up(lens[past], 8)
    return out


class _Side:
    """One side of a batch (its queries or its targets): the items, their
    lengths [N] int32, and whether its rows take the joined route.  That
    route holds ASCII bytes and is taken when every item is str or bytes
    (str encoded here); otherwise the items are code arrays, used as they
    are, with any str or bytes item encoded first."""

    def __init__(self, seqs):
        kinds = set(map(type, seqs))
        text = [issubclass(k, (str, bytes)) for k in kinds]
        self.joined = all(text)
        if self.joined and not all(issubclass(k, bytes) for k in kinds):
            seqs = [s.encode() if isinstance(s, str) else s for s in seqs]
        elif not self.joined and any(text):
            seqs = [encode4(s) if isinstance(s, (str, bytes)) else s
                    for s in seqs]
        self.seqs = seqs
        self.lens = np.fromiter(map(len, seqs), np.int32, len(seqs))

    def padded(self, chunk: np.ndarray, rows: list, width: int):
        """The chunk's rows as [len(rows), width] uint8 codes padded with
        N4, and their lengths.  Joined rows are padded with 'N' before the
        one encode (ord('N') & 0xF == N4); code rows go into an N4-filled
        array by a mask of their lengths."""
        lens = self.lens[chunk]
        items = list(map(self.seqs.__getitem__, rows))
        if self.joined:
            buf = b"".join([s.ljust(width, b"N") for s in items])
            codes = np.frombuffer(buf, np.uint8) & 0xF
            return codes.reshape(len(rows), width), lens
        codes = np.full((len(rows), width), N4, np.uint8)
        codes[np.arange(width) < lens[:, None]] = np.concatenate(items)
        return codes, lens


class _Pending(list):
    """A dispatched batch's chunks, (pair indices, device results) each,
    with the event recorded after its last launch (None on the CPU) and
    its batch id in the program's spans."""

    def __init__(self, batch=None):
        super().__init__()
        self.batch = batch
        self.event = None


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
        self.device = checked_device(device)
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
        """Copy one chunk to the device and launch it; returns device
        tensors: score, qend and tend (None when score-only), walk =
        (cigars, n_ops, qstart, tstart) of `tb_walk.walk_cigars`, starts =
        (qstart, tstart) from the start pass and second = (score2, qend2,
        tend2), each None when not asked for."""
        ksw = self.params.algo == AlgoType.KSW
        with profiling.span("dispatch.copy_in") as sp:
            q = torch.from_numpy(qb).to(self.device)
            t = torch.from_numpy(tb).to(self.device)
            ql = torch.from_numpy(qlen).to(self.device)
            tl = torch.from_numpy(tlen).to(self.device)
            h = torch.from_numpy(h0).to(self.device) if ksw else None
            sp.count("dispatch.bytes_in", qb.nbytes + tb.nbytes + qlen.nbytes
                     + tlen.nbytes + (h0.nbytes if ksw else 0))
        with profiling.span("dispatch.launch"):
            return self._launch(q, t, ql, tl, h, has_n)

    def _launch(self, q, t, ql, tl, h, has_n: bool) -> dict:
        """The chunk's kernels on its device tensors; see _run_chunk."""
        p = self.params
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
            out["walk"] = tb_walk.walk_cigars(
                res.tb, res.score, j0, i0, p, _WALK[p.algo],
                head_q=bool(self.head & SemiGlobalSkip.QUERY),
                head_t=bool(self.head & SemiGlobalSkip.TARGET))
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
        returns the pending state for _collect: the chunks, with the event
        recorded after the last launch, and the number of pairs."""
        with profiling.span("dispatch", batch=profiling.NEW) as sp:
            n = len(queries)
            if n != len(targets):
                raise ValueError(
                    f"queries/targets length mismatch: {n} vs "
                    f"{len(targets)}")
            h0 = (np.zeros(n, np.int32) if h0 is None
                  else np.asarray(h0, np.int32))
            if h0.shape != (n,):
                raise ValueError(
                    f"h0 needs one seed score per pair; got shape "
                    f"{h0.shape} for {n} pairs")
            with profiling.span("dispatch.encode"):
                q, t = _Side(queries), _Side(targets)
                lq, lt = _buckets_of(np.stack((q.lens, t.lens)), self.buckets)
                # one stable sort groups the pairs by (lq, lt), each group
                # in submission order; the groups go in the order of (lq, lt)
                key = (lq << 32) | lt
                order = np.argsort(key, kind="stable")
                key = key[order]
                cuts = (np.flatnonzero(key[1:] != key[:-1]) + 1).tolist()
            with profiling.span("dispatch.pack"):
                # each group cut into chunks: (pair indices, lq, lt)
                chunks = []
                for a, b in zip([0, *cuts] if n else [], [*cuts, n]):
                    shape = int(lq[order[a]]), int(lt[order[a]])
                    step = self._chunk_pairs(*shape)
                    chunks += [(order[c:min(c + step, b)], *shape)
                               for c in range(a, b, step)]
            pending = _Pending(batch=sp.batch)
            for chunk, lq_c, lt_c in chunks:
                with profiling.span("dispatch.pack"):
                    idxs = chunk.tolist()
                    qb, tb, qlen, tlen, has_n = self._pack(
                        chunk, idxs, q, t, lq_c, lt_c)
                if sp:
                    sp.count("dispatch.chunks")
                    sp.count("dispatch.cells",
                             int(qlen.astype(np.int64) @ tlen))
                    sp.count("dispatch.cells_launched",
                             len(idxs) * lq_c * lt_c)
                pending.append((idxs, self._run_chunk(
                    qb, tb, qlen, tlen, h0[chunk], has_n)))
            if self.device.type == "cuda":
                pending.event = torch.cuda.Event()
                pending.event.record(torch.cuda.current_stream(self.device))
            sp.count("dispatch.batches")
            sp.count("dispatch.pairs", n)
            sp.count("dispatch.pairs_joined",
                     n if q.joined and t.joined else 0)
        return pending, n

    @staticmethod
    def _pack(chunk, idxs, q: _Side, t: _Side, lq: int, lt: int):
        """A chunk's rows padded with N4 to the bucket's (lq, lt), their
        lengths, and whether any sequence of it holds an N.  `chunk` holds
        the pair indices, `idxs` the same as a list."""
        qb, qlen = q.padded(chunk, idxs, lq)
        tb, tlen = t.padded(chunk, idxs, lt)
        # the padding is N4 as well: a sequence holds an N iff the chunk
        # has more N4 codes than pad cells
        pads = qb.size + tb.size - int(qlen.sum()) - int(tlen.sum())
        has_n = bool(np.count_nonzero(qb == N4)
                     + np.count_nonzero(tb == N4) > pads)
        return qb, tb, qlen, tlen, has_n

    def _collect(self, pending, n) -> list[AlignmentJob]:
        """Wait for the batch's event, copy the results to the host and
        build the jobs."""
        out: list[AlignmentJob | None] = [None] * n

        def host(xs):
            return None if xs is None else [x.cpu().numpy() for x in xs]

        with profiling.span("collect", batch=pending.batch) as sp:
            with profiling.span("collect.wait"):
                if pending.event is not None:
                    pending.event.synchronize()
            with profiling.span("collect.copy_out"):
                chunks = []
                for idxs, r in pending:
                    score = r["score"].cpu().numpy()
                    ends = (None if r["qend"] is None
                            else host((r["qend"], r["tend"])))
                    starts, second = host(r["starts"]), host(r["second"])
                    cigars = n_ops = None
                    if r["walk"] is not None:
                        n_ops, *starts = host(r["walk"][1:])
                        cigars = r["walk"][0][:, :int(n_ops.max(initial=0))]
                        cigars = cigars.cpu().numpy()
                    chunks.append((idxs, score, ends, starts, second, cigars,
                                   n_ops))
            with profiling.span("collect.jobs"):
                for idxs, score, ends, starts, second, cigars, n_ops in \
                        chunks:
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
            sp.count("collect.jobs", n)
        return out  # type: ignore[return-value]

    def align(self, queries: Sequence, targets: Sequence,
              h0: Sequence[int] | None = None) -> list[AlignmentJob]:
        """Align pairs (str, bytes or uint8 code arrays); returns results
        in submission order.  h0: KSW's seed score per pair (default 0;
        the other algorithms ignore it)."""
        return self._collect(*self._dispatch(queries, targets, h0))

    def align_async(self, queries: Sequence, targets: Sequence,
                    h0: Sequence[int] | None = None) -> AsyncHandle:
        """Submit a batch; the device starts now and the host returns.

        >>> h1 = eng.align_async(q1, t1)   # device busy with batch 1
        >>> h2 = eng.align_async(q2, t2)   # prep + launch batch 2 meanwhile
        >>> r1, r2 = h1.result(), h2.result()
        """
        pending, n = self._dispatch(queries, targets, h0)
        return AsyncHandle(lambda: self._collect(pending, n), pending.event)


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
