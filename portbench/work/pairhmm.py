"""Least work of the PairHMM forward recurrence in f32, counted from a
cell's own reads and haplotypes.

The configuration asks for likelihoods bit-equal to the plain
recurrence (warp_based.cu:143-160), which fixes its rounding sites, so
each is one FP32 lane-operation (an FMA counts once):

    D = fma(D_left, eps, M_left * xiksi)            2 (mul, fma)
    I = fma(M_up, delta, I_up * eps)                2 (mul, fma)
    M = prior * fma(alpha, M_diag, beta * (I + D)_diag)   4 (add, mul, fma, mul)

8 a cell (`CELL_OPS`), the prior a lookup; the result sums M + I over
the last read row, 2 a haplotype base (`LAST_ROW_OPS`).  Cells: len(read)
x len(haplotype) of each pair.  Bytes: of a region, each read with its
three quality bytes a base and each haplotype read once, and one f32
result a pair written once.
"""
from __future__ import annotations

CELL_OPS = 8
LAST_ROW_OPS = 2


def region_work(read_lens, hap_lens) -> tuple[float, int]:
    """(FP32 operations, bytes) of every (read, haplotype) pair of a
    region."""
    nr, nh = len(read_lens), len(hap_lens)
    sr, sh = sum(read_lens), sum(hap_lens)
    return (CELL_OPS * sr * sh + LAST_ROW_OPS * nr * sh,
            4 * sr + sh + 4 * nr * nh)
