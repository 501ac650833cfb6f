"""Least work of GASAL2's affine-gap alignments (LOCAL, GLOBAL) and of
the traceback walk, counted from a cell's own inputs and outputs.

The count is of the cheapest form any implementation could take, so
that no kernel, present or later, can read above its roofline:

- Cells: len(query) x len(target) of each pair, the real lengths (no
  bucket, no padding).
- Operations a cell, on Hopper's INT32 lanes, one per add or subtract,
  one per max of up to three inputs (VIMNMX3), and one per fused
  add-and-max (VIADDMNMX); the substitution score comes from a query
  profile (a load, no operation):
    X = H - (gap_open + gap_extend)           1 (shared by E below, F right)
    E = max(E_up - gap_extend, X_up)          1 (fused add-max)
    F = max(F_left - gap_extend, X_left)      1 (fused add-max)
    H = max(H_diag + s, E, F [, 0])           2 (add, three-input max; LOCAL's
                                                 0 by the max's relu form)
  5 in all; LOCAL keeps its best (one max, `BEST`), and a traceback
  needs at least two compares to tell which of H's three sources won
  (`TRACEBACK`; the two extension bits fold into them).  Every value
  fits in 16 bits at these lengths and scores, so two cells share a
  lane: the operations a cell are halved (`LANES_PER_OP`).
- The walk: one step for each base of the CIGAR (M, X, D and I runs
  summed), `WALK_OPS` int32 operations a step: take the step's two
  bits, choose the move, move.
- Bytes: each input byte read once (a base a byte, two int32 lengths)
  and each output byte written once (int32 score, ends and starts as
  the mode returns them, the CIGAR's bytes).
"""
from __future__ import annotations

RECURRENCE = 5
BEST = 1
TRACEBACK = 2
LANES_PER_OP = 2          # two 16-bit cells in one INT32 lane
WALK_OPS = 3


def cell_ops(local: bool, traceback: bool) -> float:
    """INT32 lane-operations a DP cell."""
    return (RECURRENCE + BEST * local + TRACEBACK * traceback) / LANES_PER_OP


def walk_steps(cigar: bytes) -> int:
    """Steps of the walk that wrote these CIGAR bytes (op | count << 2):
    the bases its runs cover."""
    return sum(b >> 2 for b in cigar)


def pair_work(qlen: int, tlen: int, local: bool, cigar: bytes | None,
              out_ints: int) -> tuple[float, int]:
    """(INT32 lane-operations, bytes) of one pair: its DP, its walk when
    `cigar` is given (None without traceback), its inputs and its
    `out_ints` int32 outputs and CIGAR bytes."""
    tb = cigar is not None
    ops = qlen * tlen * cell_ops(local, tb)
    nbytes = qlen + tlen + 8 + 4 * out_ints
    if tb:
        ops += walk_steps(cigar) * WALK_OPS
        nbytes += len(cigar)
    return ops, nbytes
