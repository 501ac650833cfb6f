"""Inputs from a seed, after `chip_smoke.py`'s generators.

Each function keeps the model of the one it cites (the same lengths,
error rates and placements) but draws its numbers in a few large calls,
so that making a cell's inputs takes a fraction of a second where the
per-base loops took about ten seconds for 20,000 pairs.  The benchmark
owns these copies: a later change to `chip_smoke.py` does not change
what a cell runs.  One seed always gives the same inputs.
"""
from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
DNA = "ACGT"


def _read(window, r, lens, subs, ins_bases, indel, read_len):
    """One read from `window` under `read_from`'s loop (chip_smoke.py:529):
    at each position k, r[k] < indel / 2 deletes lens[k] bases from k on
    (the loop jumps past them, so their own draws go unused), r[k] <
    indel inserts lens[k] random bases before base k; every base that is
    kept is `subs[k]` (the window's base, or a substitution).  The read
    is cut to read_len."""
    keep = np.ones(len(window), bool)
    inserts = []
    jump = 0
    for k in np.flatnonzero(r < indel):
        if k < jump:
            continue
        if r[k] < indel / 2:
            jump = k + int(lens[k])
            keep[k:jump] = False
        else:
            inserts.append(k)
    if not inserts:
        return subs[keep][:read_len]
    pieces, prev = [], 0
    for k in inserts:
        pieces += [subs[prev:k][keep[prev:k]], ins_bases[k, :lens[k]]]
        prev = k
    pieces.append(subs[prev:][keep[prev:]])
    return np.concatenate(pieces)[:read_len]


def gasal_pairs(rng, n, read_len=150, target_len=(200, 300), sub=0.02,
                indel=0.005, read_n_rate=0.001, target_n_rate=0.0005):
    """GASAL2 test-program-shaped pairs (chip_smoke.py:557 `gasal_pairs`
    with `read_from` :529 and `with_ns` :550): targets of target_len[0]
    to target_len[1] random bases; a read cut from each at a random start
    from read_len + 10 bases, with substitutions at `sub`, indels of 1-3
    bases at `indel` (half deletions, half insertions) and Ns at
    read_n_rate; Ns in the targets at target_n_rate.  Returns (queries,
    targets), lists of ASCII bytes."""
    W = read_len + 10
    tl = rng.integers(target_len[0], target_len[1] + 1, n)
    tgt = BASES[rng.integers(0, 4, (n, target_len[1]))]
    start = (rng.random(n) * (tl - W + 1)).astype(np.int64)
    win = tgt[np.arange(n)[:, None], start[:, None] + np.arange(W)]
    r = rng.random((n, W))
    lens = rng.integers(1, 4, (n, W))
    subs = np.where(rng.random((n, W)) < sub,
                    BASES[rng.integers(0, 4, (n, W))], win)
    ins_bases = BASES[rng.integers(0, 4, (n, W, 3))]
    read_ns = rng.random((n, read_len)) < read_n_rate
    tgt_ns = rng.random((n, target_len[1])) < target_n_rate
    tgt = np.where(tgt_ns, np.uint8(ord("N")), tgt)
    qs, ts = [], []
    for i in range(n):
        read = _read(win[i], r[i], lens[i], subs[i], ins_bases[i], indel,
                     read_len)
        read = np.where(read_ns[i, :len(read)], np.uint8(ord("N")), read)
        qs.append(read.tobytes())
        ts.append(tgt[i, :tl[i]].tobytes())
    return qs, ts


def random_seq(rng, n: int, letters: str = DNA) -> str:
    """chip_smoke.py:1164 `random_seq`."""
    a = np.frombuffer(letters.encode(), np.uint8)
    return a[rng.integers(0, len(a), n)].tobytes().decode()


def assembly_regions(rng, n, window=300, reads=30, read_len=150,
                     snv_at=(60, 140), indel_at=(160, 240), indel_len=(1, 3),
                     read_sub=0.005):
    """Active regions (chip_smoke.py:3694 `assembly_windows`): a random
    window, an alternate haplotype with one SNV and one indel of
    indel_len bases (a deletion or an insertion, one chance in two), and
    `reads` reads of read_len bp, alternately from the reference and the
    alternate, each given substitutions at read_sub as `mutate`
    (chip_smoke.py:1169) gives them; the original's reads are
    error-free.  Returns [(window, [reads])]."""
    out = []
    for _ in range(n):
        ref = random_seq(rng, window)
        s = int(rng.integers(snv_at[0], snv_at[1]))
        d = int(rng.integers(indel_at[0], indel_at[1]))
        k = int(rng.integers(indel_len[0], indel_len[1] + 1))
        snv = DNA[(DNA.index(ref[s]) + 1) % 4]
        alt = ref[:s] + snv + ref[s + 1:d] + (
            ref[d + k:] if rng.random() < 0.5 else random_seq(rng, k)
            + ref[d:])
        srcs = [np.frombuffer(x.encode(), np.uint8) for x in (ref, alt)]
        starts = rng.random(reads)
        flips = rng.random((reads, read_len)) < read_sub
        new = BASES[rng.integers(0, 4, (reads, read_len))]
        rd = []
        for i in range(reads):
            src = srcs[i % 2]
            p = int(starts[i] * (len(src) - read_len))
            rd.append(np.where(flips[i], new[i], src[p:p + read_len])
                      .tobytes().decode())
        out.append((ref, rd))
    return out
