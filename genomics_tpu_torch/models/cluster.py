"""Greedy read clustering (reference: CDP/CLUSTER, CD-HIT-style): the
port of `genomics_tpu/models/cluster.py`.

Pipeline parity with Non-CDP/CLUSTER/func.cu: read FASTA -> sort by
length desc -> base-to-number -> prefix base counts -> k-mer short words
(sorted, merged) -> cutoffs -> de-gap -> 2-bit pack -> greedy clustering
(representative = first unclustered; 3-stage candidate filtering:
prefix filter, word-histogram filter, bit-parallel LCS accept) -> reps.

The host preparation (`_prepare`) is the JAX package's numpy, copied.
On the device: the prefix and word filters of the speculative path as
`ops/cluster_filter.window_filters` (`csrc/cluster_filter.cu` on the
card, one launch a window), and the LCS accept as `ops/lcs.lcs_accept`
(`csrc/cluster_lcs.cu` on the card).
`speculate > 1` is the CDP tree's speculative multi-representative
batching (func.cu:722-820): S consecutive unclustered candidates are
representatives of one device pass, and conflicts resolve so that the
final clustering is identical to the serial one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomics_tpu_torch.device import checked_device
from genomics_tpu_torch.ops.cluster_filter import pack_words, window_filters
from genomics_tpu_torch.ops.lcs import lcs_accept, pad_codes
from genomics_tpu_torch.utils.fasta import read_fasta

_BASE_MAP = np.full(256, 4, np.uint8)
for _c, _v in [("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)]:
    _BASE_MAP[ord(_c)] = _v
    _BASE_MAP[ord(_c.lower())] = _v


def auto_word_length(threshold: float) -> int:
    """func.cu:48-57."""
    if threshold < 0.88:
        return 4
    if threshold < 0.94:
        return 5
    if threshold < 0.97:
        return 6
    return 7


@dataclasses.dataclass
class _Prepped:
    order: np.ndarray          # original indices in sorted order
    lengths: np.ndarray        # original lengths (incl. gaps)
    prefix: np.ndarray         # [N, 4] base counts
    words: np.ndarray          # [N, Wmax] distinct words (sorted, padded)
    word_counts: np.ndarray    # [N, Wmax] counts (0 = pad)
    word_cutoff: np.ndarray
    base_cutoff: np.ndarray
    net_lengths: np.ndarray    # de-gapped lengths
    low: np.ndarray            # [N, W32] packed low bit-planes
    high: np.ndarray           # [N, W32]
    codes: np.ndarray          # [N, Lmax] de-gapped 2-bit codes (pad 255)
    dense_k: int = 0           # max word multiplicity, -1: host filters
    #                            (0: not computed yet)
    aux_dev: dict = None       # device-resident prefix/cutoff/LCS arrays


def _prepare(seqs: list[str], threshold: float, word_length: int) -> _Prepped:
    N = len(seqs)
    lengths = np.array([len(s) for s in seqs], np.int64)
    # sort by length desc (stable for determinism; reference std::sort)
    order = np.argsort(-lengths, kind="stable")
    seqs = [seqs[i] for i in order]
    lengths = lengths[order]

    # one padded matrix (pad code 4 = gap/N → windows touching padding
    # are invalid automatically), everything below fully vectorized —
    # the per-read loops were ~1/3 of total time at 50k reads
    Lmax_all = max(int(lengths.max()), word_length) if N else word_length
    A = np.full((N, Lmax_all), 4, np.uint8)
    flat = _BASE_MAP[np.frombuffer("".join(seqs).encode(), np.uint8)]
    rowidx = np.repeat(np.arange(N), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths[:-1])])
    colidx0 = np.arange(len(flat)) - np.repeat(starts, lengths)
    A[rowidx, colidx0] = flat
    prefix = np.stack([(A == b).sum(axis=1) for b in range(4)],
                      axis=1).astype(np.int64)

    # words (gap-free k-mers), distinct + counts — vectorized
    # sort + run-length over all rows at once.  Reference packs
    # base[i-j] << 2j (func.cu:258-263): the window's LAST base gets
    # shift 0 → window index x shifts by 2*(wl-1-x).
    wl = word_length
    SENT = np.uint32(1 << (2 * wl))
    # rolling-key build per column (no [N, W, wl] strided materialize —
    # ~3x cheaper on this host's memory bandwidth): key ending at col j
    # = ((key << 2) | base) masked; valid iff the non-gap run length
    # ending at j is >= wl
    nw = Lmax_all - wl + 1
    keys = np.full((N, nw), SENT, np.uint32)
    key = np.zeros(N, np.uint32)
    run = np.zeros(N, np.int32)
    kmask = SENT - 1
    for j in range(Lmax_all):
        col = A[:, j]
        isb = col != 4
        key = ((key << 2) | col) & kmask
        run = np.where(isb, run + 1, 0)
        if j >= wl - 1:
            keys[:, j - wl + 1] = np.where(run >= wl, key, SENT)
    srt = np.sort(keys, axis=1)
    valid = srt != SENT
    newm = np.ones_like(valid)
    newm[:, 1:] = srt[:, 1:] != srt[:, :-1]
    newm &= valid
    n_dist = newm.sum(axis=1)
    wmax = max(int(n_dist.max()) if N else 0, 1)
    ordpos = np.cumsum(newm, axis=1) - 1
    rows, cols = np.nonzero(newm)
    words = np.zeros((N, wmax), np.uint16)
    word_counts = np.zeros((N, wmax), np.uint16)
    words[rows, ordpos[rows, cols]] = srt[rows, cols].astype(np.uint16)
    # run lengths: global run ids over the flattened sorted matrix
    run_id = np.cumsum(newm.ravel()) - 1
    rl = np.bincount(run_id[valid.ravel()], minlength=max(len(rows), 1))
    word_counts[rows, ordpos[rows, cols]] = np.minimum(
        rl[: len(rows)], 0xFFFF).astype(np.uint16)

    # cutoffs (kernel_createCutoff, func.cu exact float semantics) —
    # vectorized with the same f32/f64 promotion the scalar loop had:
    # f32(L) * pyfloat promotes to f64 before the ceil; the word-cutoff
    # product stays f32 x f32
    thr32 = np.float32(threshold)
    Lf32 = lengths.astype(np.float32)
    cutoff_v = np.ceil(
        Lf32.astype(np.float64) * (1.0 - float(thr32))
    ).astype(np.int64) * wl
    required_v = np.maximum(lengths - wl + 1 - cutoff_v, 1)
    if float(thr32) >= 0.9:
        offset = np.float32(1.1) - abs(np.float32(thr32) - np.float32(0.95)) * 2
    else:
        offset = np.float32(1.0)
    word_cutoff = np.ceil(
        required_v.astype(np.float32) * np.float32(offset)
    ).astype(np.int64)
    base_cutoff = np.ceil(
        (Lf32 * thr32).astype(np.float64)
    ).astype(np.int64)

    # de-gap + 2-bit pack (little-endian bit order, func.cu:422-457) —
    # vectorized: a stable argsort of the gap mask compacts non-gap
    # bases to the front of each row, order preserved
    gap = A == 4
    net = (~gap).sum(axis=1).astype(np.int64)
    W32 = int(net.max()) // 32 + 1
    Lmax = int(net.max())
    order2 = np.argsort(gap, axis=1, kind="stable")
    compact = np.take_along_axis(A, order2, axis=1)
    colidx = np.arange(Lmax_all)[None, :]
    codes_full = np.where(colidx < net[:, None], compact, 255).astype(np.uint8)
    codes = np.full((N, Lmax), 255, np.uint8)
    codes[:, : min(Lmax, Lmax_all)] = codes_full[:, :Lmax]
    padded = np.zeros((N, W32 * 32), np.uint8)
    m = min(W32 * 32, Lmax_all)
    padded[:, :m] = np.where(colidx < net[:, None], compact, 0)[:, :m]
    pb = padded.reshape(N, W32, 32).astype(np.uint32)
    shifts32 = np.arange(32, dtype=np.uint32)
    low = ((pb & 1) << shifts32).sum(axis=2, dtype=np.uint64).astype(np.uint32)
    high = (((pb >> 1) & 1) << shifts32).sum(
        axis=2, dtype=np.uint64).astype(np.uint32)
    return _Prepped(
        order=order,
        lengths=lengths,
        prefix=prefix,
        words=words,
        word_counts=word_counts,
        word_cutoff=word_cutoff,
        base_cutoff=base_cutoff,
        net_lengths=net,
        low=low,
        high=high,
        codes=codes,
    )


@dataclasses.dataclass
class ClusterResult:
    cluster: np.ndarray       # [N] rep index per read (sorted order)
    order: np.ndarray         # sorted order → original indices
    n_clusters: int

    def representative_mask(self):
        return self.cluster == np.arange(len(self.cluster))


def cluster_reads(
    seqs: list[str],
    threshold: float = 0.95,
    word_length: int = 0,
    drop: int | None = None,
    batch_cap: int = 4096,
    speculate: int = 1,
    device="cuda",
) -> ClusterResult:
    """The full greedy clustering pipeline (func.cu:823-855 semantics), on
    `device` (the card unless told; "cpu" takes the plain versions).

    speculate > 1 enables the CDP tree's speculative multi-representative
    batching (CDP/CLUSTER/func.cu:722-820): S consecutive unclustered
    candidates are treated as representatives in ONE device pass and
    conflicts resolved serially-equivalently (each read takes its
    smallest owner among candidates that themselves survived all smaller
    valid owners) — the final clustering is identical to speculate=1.
    `batch_cap` is the most job columns of one LCS launch."""
    dev = checked_device(device)
    if speculate > 1:
        return _cluster_reads_speculative(
            seqs, threshold, word_length, batch_cap, speculate, dev)
    # NOTE: the reference parses drop/pigeon flags but its clustering loop
    # never consults them (func.cu: only checkOption touches them) —
    # the word filter always runs; we match that.
    del drop
    wl = word_length or auto_word_length(threshold)
    p = _prepare(seqs, threshold, wl)
    aux = _aux_dev(p, dev)
    N = len(seqs)
    cluster = np.full(N, -1, np.int64)
    rep = -1
    while True:
        rep += 1
        while rep < N and cluster[rep] != -1:
            rep += 1
        if rep >= N:
            break
        cluster[rep] = rep
        jobs = np.nonzero(cluster == -1)[0]
        if len(jobs) == 0:
            continue
        # prefix filter
        sums = np.minimum(p.prefix[rep][None, :], p.prefix[jobs]).sum(axis=1)
        jobs = jobs[sums >= p.base_cutoff[jobs]]
        if len(jobs) == 0:
            continue
        # word-histogram filter: Σ min(rep count, query count); only
        # entries with count > 0 are real (count-0 slots are padding and
        # must not clobber table[0], the all-A k-mer)
        table = np.zeros(1 << (2 * wl), np.uint32)
        m = p.word_counts[rep] > 0
        table[p.words[rep][m]] = p.word_counts[rep][m]
        got = np.minimum(table[p.words[jobs]], p.word_counts[jobs]).sum(axis=1)
        jobs = jobs[got >= p.word_cutoff[jobs]]
        if len(jobs) == 0:
            continue
        # bit-parallel LCS accept
        rp = _indices([rep], dev)
        for s in range(0, len(jobs), batch_cap):
            jb = jobs[s : s + batch_cap]
            accept = _lcs(aux, rp, _indices(jb, dev),
                          words_needed(p, [rep])).cpu().numpy()[0] != 0
            cluster[jb[accept]] = rep
    n = int((cluster == np.arange(N)).sum())
    return ClusterResult(cluster=cluster, order=p.order, n_clusters=n)


def run_file(
    input_file: str,
    output_file: str | None = None,
    threshold: float = 0.95,
    word_length: int = 0,
    device="cuda",
) -> ClusterResult:
    """File-level driver matching the reference CLI (i/o/t/w flags)."""
    recs = read_fasta(input_file)
    res = cluster_reads(
        [r.seq for r in recs], threshold=threshold, word_length=word_length,
        device=device,
    )
    if output_file:
        with open(output_file, "w") as fh:
            for i in np.nonzero(res.representative_mask())[0]:
                orig = recs[res.order[i]]
                fh.write(f">{orig.name}\n{orig.seq}\n")
    return res


def _indices(idx, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int32), device=dev)


def words_needed(p: _Prepped, reps) -> int:
    """Row words of the widest of these representatives: ceil(net / 32)."""
    return int((p.net_lengths[np.asarray(reps)].max() + 31) // 32)


def _lcs(aux: dict, rp, jb, max_words: int, gate=None) -> torch.Tensor:
    """[S, J] uint8 LCS accepts of representatives rp against jobs jb."""
    return lcs_accept(aux["low"], aux["high"], aux["net"], aux["codes"],
                      aux["bcut"], rp, jb, gate, max_words=max_words)


_DENSE_MAX_BINS = 1 << 14   # wl <= 7, the JAX package's dense rule (the
#                             kernel's tables: 8 rows a block at wl = 7)
_DENSE_MAX_K = 8            # rare ultra-repetitive data: host filters


def _dense_k(p: _Prepped, wl: int) -> int:
    """The most times a word occurs in a read (K), or -1 where the data
    take the host filters (4^wl above 2^14 bins, or a word repeated more
    than 8 times in a read); computed once."""
    if p.dense_k == 0:
        K = int(p.word_counts.max()) if p.word_counts.size else 0
        p.dense_k = (-1 if (1 << (2 * wl)) > _DENSE_MAX_BINS
                     or K > _DENSE_MAX_K or K == 0 else K)
    return p.dense_k


def _aux_dev(p: _Prepped, dev) -> dict:
    """Ship the per-read filter/LCS arrays to the device ONCE — the
    greedy loop then only uploads index vectors per round."""
    if p.aux_dev is None:
        def put(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
        p.aux_dev = {
            "prefix": put(p.prefix),
            "wcut": put(p.word_cutoff),
            "bcut": put(p.base_cutoff),
            "low": put(p.low.view(np.int32)),
            "high": put(p.high.view(np.int32)),
            "net": put(p.net_lengths),
            "codes": put(pad_codes(p.codes), np.uint8),
        }
    return p.aux_dev


def _packed_dev(p: _Prepped, dev) -> torch.Tensor:
    """The reads' packed words (`cluster_filter.pack_words`) on the
    device, shipped once beside `_aux_dev`'s arrays."""
    aux = _aux_dev(p, dev)
    if "packed" not in aux:
        aux["packed"] = torch.from_numpy(
            pack_words(p.words, p.word_counts)).to(dev)
    return aux["packed"]


def _accept_matrix(p: _Prepped, reps: np.ndarray, jobs: np.ndarray, wl: int,
                   batch_cap: int, dev) -> np.ndarray:
    """[S, J] bool: does candidate rep s accept job j (filters + LCS).

    The prefix + word filters run on the device in one launch
    (`cluster_filter.window_filters`: csrc/cluster_filter.cu on the card,
    its plain version on the CPU), pass2 stays there, and the LCS kernel
    runs on the columns any candidate passes, gated by pass2.  Data the
    dense rule excludes (wl > 7 or a word multiplicity above 8) take
    `_accept_matrix_host`: the rule is on the data."""
    K = _dense_k(p, wl)
    if K < 0:
        return _accept_matrix_host(p, reps, jobs, wl, batch_cap, dev)
    S, J = len(reps), len(jobs)
    acc = np.zeros((S, J), bool)
    aux = _aux_dev(p, dev)
    rp = _indices(reps, dev)
    jp = _indices(jobs, dev)
    p2, anyv = window_filters(_packed_dev(p, dev), aux["prefix"],
                              aux["wcut"], aux["bcut"], rp, jp,
                              1 << (2 * wl), K)
    cols = torch.nonzero(anyv)[:, 0]
    words = words_needed(p, reps)
    pend = []
    for s0 in range(0, cols.shape[0], batch_cap):
        cb = cols[s0 : s0 + batch_cap]
        pend.append((cb, _lcs(aux, rp, jp[cb], words, p2[:, cb])))
    for cb, a in pend:                      # collect after the launches
        acc[:, cb.cpu().numpy()] = a.cpu().numpy() != 0
    return acc


def _accept_matrix_host(p: _Prepped, reps, jobs, wl, batch_cap, dev):
    """Host filters + device LCS: the path for data the dense rule
    (`_dense_k`) excludes (wl > 7 / multiplicity > 8), and the exact
    oracle of `_accept_matrix` in the tests."""
    S, J = len(reps), len(jobs)
    acc = np.zeros((S, J), bool)
    pre = np.minimum(p.prefix[reps][:, None, :],
                     p.prefix[jobs][None, :, :]).sum(axis=2)
    pass1 = pre >= p.base_cutoff[jobs][None, :]
    tables = np.zeros((S, 1 << (2 * wl)), np.uint32)
    for si, r in enumerate(reps):
        m = p.word_counts[r] > 0
        tables[si, p.words[r][m]] = p.word_counts[r][m]
    got = np.minimum(
        tables[:, p.words[jobs]], p.word_counts[jobs][None, :, :]
    ).sum(axis=2)
    pass2 = pass1 & (got >= p.word_cutoff[jobs][None, :])
    cols = np.nonzero(pass2.any(axis=0))[0]
    aux = _aux_dev(p, dev)
    rp = _indices(reps, dev)
    words = words_needed(p, reps)
    for s0 in range(0, len(cols), batch_cap):
        cb = cols[s0 : s0 + batch_cap]
        gate = torch.from_numpy(np.ascontiguousarray(pass2[:, cb],
                                                     np.uint8)).to(dev)
        a = _lcs(aux, rp, _indices(jobs[cb], dev), words, gate)
        acc[:, cb] = a.cpu().numpy() != 0
    return acc


def _cluster_reads_speculative(seqs, threshold, word_length, batch_cap, S,
                               dev):
    wl = word_length or auto_word_length(threshold)
    p = _prepare(seqs, threshold, wl)
    N = len(seqs)
    cluster = np.full(N, -1, np.int64)
    pos = 0
    while pos < N:
        # S consecutive unclustered candidates from pos
        cands = []
        k = pos
        while k < N and len(cands) < S:
            if cluster[k] == -1:
                cands.append(k)
            k += 1
        if not cands:
            break
        cands = np.array(cands)
        jobs = np.nonzero(cluster == -1)[0]
        jobs = jobs[jobs > cands[0]]
        if len(jobs):
            A = _accept_matrix(p, cands, jobs, wl, batch_cap, dev)
        else:
            A = np.zeros((len(cands), 0), bool)
        # serial-equivalent resolution: candidates in order; a candidate
        # is a valid rep iff no earlier valid rep accepted it; it claims
        # only still-unclustered jobs (an earlier candidate in this window
        # may have become a rep itself — never overwrite)
        for si, c in enumerate(cands):
            if cluster[c] != -1:
                continue  # claimed by an earlier valid candidate
            cluster[c] = c
            take = A[si] & (cluster[jobs] == -1)
            cluster[jobs[take]] = c
        pos = int(cands[-1]) + 1
    n = int((cluster == np.arange(N)).sum())
    return ClusterResult(cluster=cluster, order=p.order, n_clusters=n)
