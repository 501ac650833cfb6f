"""Batch containers: padded, static-shape sequence batches.

The port's copy of `genomics_tpu/core/batch.py` (which imports no JAX;
the port keeps its own copy all the same), with the same defaults, so
that the arrays equal the JAX package's.  A batch is a dense [B, Lpad]
uint8 code matrix plus an int32 length vector, the generalisation of
GASAL2's pad-to-8 'N' padding (host_batch.cpp:79-160); `AlignEngine`
buckets and pads its own batches and does not need these.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from genomics_tpu_torch.core import encoding

LANE = 128          # sequence axis padded to a multiple of this
SUBLANE = 8         # batch axis padded to a multiple of this


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class SeqBatch:
    """A batch of sequences as 4-bit codes, padded to static shape.

    codes:  [B, Lpad] uint8 (4-bit base codes; pad value = N code)
    lengths:[B] int32 true lengths
    """

    codes: np.ndarray
    lengths: np.ndarray

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    @property
    def padded_len(self) -> int:
        return self.codes.shape[1]

    @classmethod
    def from_strings(
        cls,
        seqs: Sequence[str | bytes],
        pad_len: int | None = None,
        pad_batch: int | None = None,
    ) -> "SeqBatch":
        n = len(seqs)
        enc = [encoding.encode4(s) for s in seqs]
        maxlen = max((len(e) for e in enc), default=1)
        L = round_up(max(maxlen, 1), LANE) if pad_len is None else pad_len
        B = round_up(max(n, 1), SUBLANE) if pad_batch is None else pad_batch
        codes = np.full((B, L), encoding.N4, dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, e in enumerate(enc):
            codes[i, : len(e)] = e
            lengths[i] = len(e)
        return cls(codes=codes, lengths=lengths)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.codes[i, : self.lengths[i]]


@dataclasses.dataclass
class PairBatch:
    """A batch of (query, target) alignment jobs (GASAL2's per-stream
    query/target pair, gasal.h:98-150)."""

    query: SeqBatch
    target: SeqBatch

    def __post_init__(self):
        if self.query.size != self.target.size:
            raise ValueError(f"query batch of {self.query.size} vs target "
                             f"batch of {self.target.size}")

    @property
    def size(self) -> int:
        return self.query.size

    @classmethod
    def from_strings(
        cls,
        queries: Sequence[str | bytes],
        targets: Sequence[str | bytes],
        q_pad: int | None = None,
        t_pad: int | None = None,
        pad_batch: int | None = None,
    ) -> "PairBatch":
        if len(queries) != len(targets):
            raise ValueError(f"{len(queries)} queries vs {len(targets)} "
                             f"targets")
        B = (
            round_up(max(len(queries), 1), SUBLANE)
            if pad_batch is None
            else pad_batch
        )
        return cls(
            query=SeqBatch.from_strings(queries, pad_len=q_pad, pad_batch=B),
            target=SeqBatch.from_strings(targets, pad_len=t_pad, pad_batch=B),
        )
