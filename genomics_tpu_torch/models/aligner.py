"""GASAL2-compatible batched alignment library facade.

The counterpart of `genomics_tpu/models/aligner.py`: the reference
library's API shapes (gasal_align.h:114-120), so a GASAL2 user can port
call by call:

  GasalAligner(params, n_streams)      ~ gasal_init_gpu_storage_v + _init_streams
  stream.fill(seq, QUERY/TARGET)       ~ gasal_host_batch_fill (returns offset)
  stream.op_fill(ops, src)             ~ gasal_op_fill ('>' '<' '/' '+')
  stream.aln_async()                   ~ gasal_aln_async (AlignEngine.align_async)
  stream.is_done()                     ~ gasal_is_aln_async_done
  stream.results                       ~ host_res (scores/ends/starts/CIGARs)

`aln_async` returns once the stream's kernels are launched, so the host
fills the other stream while the card runs this one (its copies to the
card, from pageable memory, still wait for this one's kernels: ROADMAP
C15); `is_done` collects the results.  Op bytes (gasal.h:68-71 /
test_prog.cpp:83-86): 0 '>' forward natural, 1 '<' reverse, 2 '/' forward
complement, 3 '+' reverse complement, applied on the host to the 4-bit
codes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

from genomics_tpu_torch.core.encoding import complement4, encode4
from genomics_tpu_torch.core.scoring import AlignmentParams, AlgoType, SemiGlobalSkip
from genomics_tpu_torch.runtime.dispatch import (
    AlignEngine,
    AlignmentJob,
    AsyncHandle,
)

OP_CHARS = {">": 0, "<": 1, "/": 2, "+": 3}
CHUNK = 5000  # pairs per stream launch: STREAM_BATCH_SIZE (test_prog.cpp:12-18)


class DataSource(enum.Enum):
    QUERY = 0
    TARGET = 1


def apply_op(codes: np.ndarray, op: int) -> np.ndarray:
    out = codes
    if op & 2:
        out = complement4(out)
    if op & 1:
        out = out[::-1].copy()
    return out


@dataclasses.dataclass
class _Stream:
    engine: AlignEngine
    queries: list = dataclasses.field(default_factory=list)
    targets: list = dataclasses.field(default_factory=list)
    q_ops: np.ndarray | None = None
    t_ops: np.ndarray | None = None
    h0: np.ndarray | None = None
    handle: AsyncHandle | None = None
    results: list[AlignmentJob] | None = None
    is_free: bool = True      # the gasal is_free flag

    def fill(self, seq, src: DataSource) -> int:
        """Append one sequence; returns its index (the offset analog)."""
        codes = encode4(seq) if isinstance(seq, (str, bytes)) else np.asarray(seq)
        lst = self.queries if src == DataSource.QUERY else self.targets
        lst.append(codes)
        return len(lst) - 1

    def op_fill(self, ops, src: DataSource):
        arr = np.array(
            [OP_CHARS[o] if isinstance(o, str) else int(o) for o in ops], np.uint8
        )
        if src == DataSource.QUERY:
            self.q_ops = arr
        else:
            self.t_ops = arr

    def seed_scores(self, h0: Sequence[int]):
        self.h0 = np.asarray(h0, np.int32)

    def aln_async(self):
        """Launch the stream's batch; returns before the card is done."""
        if len(self.queries) != len(self.targets):
            raise ValueError(
                f"unbalanced batch: {len(self.queries)} queries vs "
                f"{len(self.targets)} targets (fill both before aln_async)"
            )
        qs = list(self.queries)
        ts = list(self.targets)
        if self.q_ops is not None:
            qs = [apply_op(c, int(o)) for c, o in zip(qs, self.q_ops)]
        if self.t_ops is not None:
            ts = [apply_op(c, int(o)) for c, o in zip(ts, self.t_ops)]
        self.is_free = False
        self.results = None
        self.handle = self.engine.align_async(qs, ts, h0=self.h0)
        return self

    def is_done(self) -> int:
        """0 once the results are collected into `results` (this call
        waits for the card), -2 with nothing launched
        (gasal_is_aln_async_done's codes)."""
        if self.handle is None:
            return -2
        self.results = self.handle.result()
        self.is_free = True
        return 0

    def reset(self):
        self.queries.clear()
        self.targets.clear()
        self.q_ops = self.t_ops = self.h0 = None
        self.handle = None
        self.results = None
        self.is_free = True


class GasalAligner:
    """The library object: scoring + N logical streams over one engine on
    `device` (the card unless told)."""

    def __init__(
        self,
        params: AlignmentParams | None = None,
        n_streams: int = 2,
        with_tb: bool = False,
        head: SemiGlobalSkip = SemiGlobalSkip.NONE,
        tail: SemiGlobalSkip = SemiGlobalSkip.NONE,
        band_width_tiles: int = 4,
        device="cuda",
    ):
        self.params = params or AlignmentParams()
        self.engine = AlignEngine(
            self.params,
            with_tb=with_tb,
            head=head,
            tail=tail,
            band_width_tiles=band_width_tiles,
            device=device,
        )
        self.streams = [_Stream(self.engine) for _ in range(n_streams)]

    def free_stream(self) -> _Stream | None:
        for s in self.streams:
            if s.is_free:
                return s
        return None


def align_fasta_pairs(
    query_fasta: str,
    target_fasta: str,
    params: AlignmentParams | None = None,
    algo: AlgoType = AlgoType.LOCAL,
    with_tb: bool = False,
    limit: int | None = None,
    head: SemiGlobalSkip = SemiGlobalSkip.NONE,
    tail: SemiGlobalSkip = SemiGlobalSkip.NONE,
    band_width_tiles: int = 4,
    device="cuda",
) -> list[AlignmentJob]:
    """GASAL2's test program flow (test_prog.cpp:264-430): read paired
    FASTAs with header-op characters, dispatch chunks over two streams so
    one is filled while the other runs, collect the results in order."""
    from genomics_tpu_torch.utils.fasta import read_fasta

    params = params or AlignmentParams(algo=algo)
    q_recs = read_fasta(query_fasta, with_ops=True)
    t_recs = read_fasta(target_fasta, with_ops=True)
    n = min(len(q_recs), len(t_recs))
    if limit:
        n = min(n, limit)
    lib = GasalAligner(params, n_streams=2, with_tb=with_tb,
                       head=head, tail=tail,
                       band_width_tiles=band_width_tiles, device=device)
    out = []
    pending = []
    for s0 in range(0, n, CHUNK):
        stream = lib.free_stream()
        if stream is None:
            st = pending.pop(0)
            st.is_done()
            out.extend(st.results)
            st.reset()
            stream = st
        chunk = range(s0, min(s0 + CHUNK, n))
        for i in chunk:
            stream.fill(q_recs[i].seq, DataSource.QUERY)
            stream.fill(t_recs[i].seq, DataSource.TARGET)
        stream.op_fill([q_recs[i].op for i in chunk], DataSource.QUERY)
        stream.op_fill([t_recs[i].op for i in chunk], DataSource.TARGET)
        stream.aln_async()
        pending.append(stream)
    for st in pending:
        st.is_done()
        out.extend(st.results)
        st.reset()
    return out
