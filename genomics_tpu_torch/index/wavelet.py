"""Wavelet tree over byte strings (reference:
Non-CDP/NvB/nvbio/strings/wavelet_tree.h — a binary tree of bitvectors
built from the MSB down, giving O(log sigma) `text[i]` access and
`rank(c, i)` with O(n log sigma) bits of storage plus a
RankDictionary-style sampled popcount per level).

The nvbio build packs one bitvector per level with stable partitioning
by the current bit (wavelet_tree_inl.h's per-level radix pass); this
implementation does the same with numpy (stable argsort of the
consumed prefix bits), and answers queries by walking levels with
checkpointed popcount ranks — no per-query materialization.

select(c, k) (the k-th occurrence of c) is answered by binary search
over rank, which nvbio also builds out of rank primitives.

The port's copy of `genomics_tpu/index/wavelet.py` (host numpy).
"""
from __future__ import annotations

import numpy as np


class WaveletTree:
    def __init__(self, data: np.ndarray | bytes | str, bits: int | None = None,
                 block: int = 512):
        if isinstance(data, str):
            data = data.encode()
        if isinstance(data, (bytes, bytearray)):
            data = np.frombuffer(bytes(data), np.uint8)
        data = np.asarray(data, np.uint32)
        self.n = len(data)
        if bits is None:
            bits = max(int(data.max()).bit_length(), 1) if self.n else 1
        self.bits = bits
        self.block = block
        # per level: the bitvector (packed words) + sampled ranks; the
        # occ counts per node give each node's span boundaries
        self.levels = []           # (words [W] uint64, ranks [W//8+1])
        self.node_starts = []      # per level: {node_id: start offset}
        cur = data.copy()
        path = np.zeros(self.n, np.uint64)    # consumed-prefix node id
        for lvl in range(bits):
            b = (cur >> (bits - 1 - lvl)) & 1
            packed = np.zeros((self.n + 63) // 64, np.uint64)
            idx = np.arange(self.n)
            np.bitwise_or.at(
                packed, idx // 64,
                b.astype(np.uint64) << (idx % 64).astype(np.uint64))
            # sampled popcount every 8 words (512 positions)
            pc = _popcount64(packed)
            ranks = np.zeros(len(packed) // 8 + 2, np.int64)
            sums = np.add.reduceat(pc, np.arange(0, len(packed), 8)) \
                if len(packed) else np.zeros(0, np.int64)
            ranks[1:len(sums) + 1] = np.cumsum(sums)
            self.levels.append((packed, ranks))
            # node start offsets for the NEXT level
            nid = (path << np.uint64(1)) | b.astype(np.uint64)
            order = np.argsort(nid, kind="stable")
            starts = {}
            uniq, first = np.unique(nid[order], return_index=True)
            for u, f in zip(uniq, first):
                starts[int(u)] = int(f)
            self.node_starts.append(starts)
            cur = cur[order]
            path = nid[order]
        self._sorted = cur       # fully sorted symbols (leaf level)

    def _rank1(self, lvl: int, i: int) -> int:
        """# of set bits in level lvl's bitvector positions [0, i)."""
        packed, ranks = self.levels[lvl]
        w = i // 64
        base = int(ranks[w // 8])
        for ww in range((w // 8) * 8, w):
            base += int(_popcount64_scalar(int(packed[ww])))
        if i % 64 or w < len(packed):
            if w < len(packed):
                mask = (1 << (i % 64)) - 1
                base += int(_popcount64_scalar(int(packed[w]) & mask))
        return base

    def access(self, i: int) -> int:
        """text[i] in O(bits)."""
        assert 0 <= i < self.n
        sym = 0
        node = 0
        pos = i
        start = 0
        for lvl in range(self.bits):
            b = self._bit(lvl, start + pos)
            r = self._rank1(lvl, start + pos) - self._rank1(lvl, start)
            sym = (sym << 1) | b
            node = (node << 1) | b
            if b:
                pos = r
            else:
                pos = pos - r
            start = self.node_starts[lvl].get(node, 0)
        return sym

    def _bit(self, lvl: int, i: int) -> int:
        packed, _ = self.levels[lvl]
        return (int(packed[i // 64]) >> (i % 64)) & 1

    def rank(self, c: int, i: int) -> int:
        """# of occurrences of symbol c in text[0, i)."""
        i = min(max(i, 0), self.n)
        node = 0
        start = 0
        lo, hi = 0, i
        for lvl in range(self.bits):
            b = (c >> (self.bits - 1 - lvl)) & 1
            r_lo = self._rank1(lvl, start + lo) - self._rank1(lvl, start)
            r_hi = self._rank1(lvl, start + hi) - self._rank1(lvl, start)
            if b:
                lo, hi = r_lo, r_hi
            else:
                lo, hi = lo - r_lo, hi - r_hi
            node = (node << 1) | b
            start = self.node_starts[lvl].get(node, 0)
            if hi <= lo:
                return 0
        return hi - lo

    def select(self, c: int, k: int) -> int:
        """Position of the k-th (1-based) occurrence of c, or -1."""
        if k <= 0 or self.rank(c, self.n) < k:
            return -1
        lo, hi = 0, self.n
        while lo < hi:
            mid = (lo + hi) // 2
            if self.rank(c, mid + 1) >= k:
                hi = mid
            else:
                lo = mid + 1
        return lo


_POP_TABLE = np.array([bin(x).count("1") for x in range(1 << 16)], np.int64)


def _popcount64(words: np.ndarray) -> np.ndarray:
    w = words.view(np.uint64)
    out = np.zeros(len(w), np.int64)
    for s in (0, 16, 32, 48):
        out += _POP_TABLE[((w >> np.uint64(s)) & np.uint64(0xFFFF)).astype(np.int64)]
    return out


def _popcount64_scalar(x: int) -> int:
    return bin(x & ((1 << 64) - 1)).count("1")
