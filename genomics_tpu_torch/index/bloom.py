"""Blocked Bloom filter: the port's copy of `genomics_tpu/index/bloom.py`
(reference: nvLighter's Bloom filters, CDP/NvB/contrib + nvLighter, the
trusted k-mer membership of the error corrector).  Host numpy in both
packages.

Bit array as uint32 words; k derived hashes via the standard
double-hashing scheme h1 + i*h2.  Batched insert (numpy scatter with
bitwise-or reduction) and batched query (gather + bit tests).
"""
from __future__ import annotations

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
    x ^= x >> np.uint64(31)
    return x


class BloomFilter:
    def __init__(self, n_bits: int, k: int = 4):
        self.n_bits = int(n_bits)
        self.k = k
        self.words = np.zeros((self.n_bits + 31) // 32, np.uint32)

    def _bit_positions(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint64)
        h1 = _splitmix64(keys)
        h2 = _splitmix64(h1) | np.uint64(1)
        i = np.arange(self.k, dtype=np.uint64)[None, :]
        return ((h1[:, None] + i * h2[:, None]) % np.uint64(self.n_bits)).astype(
            np.int64
        )

    def insert(self, keys: np.ndarray) -> None:
        pos = self._bit_positions(keys).ravel()
        np.bitwise_or.at(
            self.words, pos // 32, (np.uint32(1) << (pos % 32).astype(np.uint32))
        )

    def query(self, keys: np.ndarray) -> np.ndarray:
        pos = self._bit_positions(keys)
        bits = (self.words[pos // 32] >> (pos % 32).astype(np.uint32)) & 1
        return bits.all(axis=1)

    def query_one(self, key: int) -> bool:
        """Scalar query in pure Python ints — ~10x cheaper than a
        1-element numpy query (the error corrector's pass-3 extension
        probes are single k-mers; numpy ufunc overhead dominated its
        runtime).  Bit-identical to query()."""
        M = 0xFFFFFFFFFFFFFFFF
        x = (int(key) + 0x9E3779B97F4A7C15) & M
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & M
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & M
        h1 = x ^ (x >> 31)
        x = (h1 + 0x9E3779B97F4A7C15) & M
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & M
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & M
        h2 = (x ^ (x >> 31)) | 1
        words = self.words
        nb = self.n_bits
        for i in range(self.k):
            # Mask to 64 bits BEFORE the modulo: query() computes
            # h1 + i*h2 in numpy uint64 (wrapping), so for
            # non-power-of-two n_bits an unwrapped Python-int sum would
            # give different probe positions (false negatives).
            p = ((h1 + i * h2) & M) % nb
            if not (int(words[p >> 5]) >> (p & 31)) & 1:
                return False
        return True
