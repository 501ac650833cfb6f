"""Substitution matrix loader (reference: CDP/STAR/load-matrix.cc reads
the 68 bundled NCBI-format matrices in CDP/STAR/scoring/ — BLOSUM, PAM,
GONNET...; searchScore(x, y) looks scores up by residue chars).

The port's copy of `genomics_tpu/core/submat.py`."""
from __future__ import annotations

import numpy as np


def load_scoring_matrix(path: str) -> np.ndarray:
    """NCBI matrix file → [256, 256] int32 char-indexed score table.

    Unknown residue pairs score 0 (the reference's val_mat init)."""
    table = np.zeros((256, 256), np.int32)
    cols: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line or line.lstrip().startswith("#"):
                continue
            parts = line.split()
            if not cols:
                cols = parts
                continue
            row = parts[0]
            for c, v in zip(cols, parts[1:]):
                table[ord(row), ord(c)] = int(v)
                # case-insensitive like the reference's toupper handling
                table[ord(row.lower()), ord(c)] = int(v)
                table[ord(row), ord(c.lower())] = int(v)
                table[ord(row.lower()), ord(c.lower())] = int(v)
    return table


def dna_table(match: int, mismatch: int) -> np.ndarray:
    """Uniform match/mismatch table over raw chars (STAR DNA mode)."""
    table = np.full((256, 256), mismatch, np.int32)
    idx = np.arange(256)
    table[idx, idx] = match
    return table
