"""q-gram (seed) index: the port's copy of `genomics_tpu/index/qgram.py`
(reference: CDP/NvB/nvbio/qgram, the seed lookup structure behind
nvBowtie's mapping stage).  Host numpy in both packages; the port keeps
its own copy so that it imports nothing of the JAX package.

Build: extract all q-grams of the reference text, sort (key, position)
pairs.  Lookup: batched searchsorted over the sorted keys → (start,
count) ranges per query seed; a gather expands hits.
"""
from __future__ import annotations

import numpy as np

_BASE_MAP = np.full(256, 255, np.uint8)
for _c, _v in [("A", 0), ("C", 1), ("G", 2), ("T", 3)]:
    _BASE_MAP[ord(_c)] = _v
    _BASE_MAP[ord(_c.lower())] = _v


def encode2(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_MAP[np.frombuffer(seq, np.uint8)]


def qgrams_of(codes: np.ndarray, q: int) -> np.ndarray:
    """All q-gram keys of a 2-bit code array (positions with any non-ACGT
    char yield key 2^(2q) = invalid sentinel)."""
    n = len(codes)
    if n < q:
        return np.zeros(0, np.int64)
    win = np.lib.stride_tricks.sliding_window_view(codes, q)
    shifts = 2 * np.arange(q - 1, -1, -1, dtype=np.int64)
    keys = (win.astype(np.int64) << shifts).sum(axis=1)
    keys = np.where((win == 255).any(axis=1), np.int64(1) << (2 * q), keys)
    return keys


class QGramIndex:
    def __init__(self, text: "str | bytes | np.ndarray", q: int = 16):
        assert q <= 31
        self.q = q
        # ndarray = 2-bit codes directly (the genome-scale path); values
        # above 3 (e.g. N encoded as 4) are remapped to the 255 invalid
        # marker so qgrams_of voids their windows — same behavior the
        # string path gets from encode2, instead of key aliasing
        if isinstance(text, np.ndarray):
            self.codes = np.where(text > 3, np.uint8(255),
                                  text).astype(np.uint8)
        else:
            self.codes = encode2(text)
        keys = qgrams_of(self.codes, q)
        valid = keys < (np.int64(1) << (2 * q))
        pos = np.nonzero(valid)[0].astype(np.int64)
        keys = keys[valid]
        order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[order]
        self.sorted_pos = pos[order]

    def lookup_ranges(self, seed_keys: np.ndarray):
        """[S] keys → (start [S], count [S]) into sorted_pos."""
        seed_keys = np.asarray(seed_keys, np.int64)
        lo = np.searchsorted(self.sorted_keys, seed_keys, side="left")
        hi = np.searchsorted(self.sorted_keys, seed_keys, side="right")
        return lo, hi - lo

    def hits(self, seed_keys: np.ndarray, max_hits: int = 64):
        """[S] keys → positions [S, max_hits] int64 (-1 = none), count."""
        lo, cnt = self.lookup_ranges(seed_keys)
        S = len(seed_keys)
        out = np.full((S, max_hits), -1, np.int64)
        take = np.minimum(cnt, max_hits)
        idx = lo[:, None] + np.arange(max_hits)[None, :]
        mask = np.arange(max_hits)[None, :] < take[:, None]
        out[mask] = self.sorted_pos[np.clip(idx, 0, len(self.sorted_pos) - 1)][mask]
        return out, cnt
