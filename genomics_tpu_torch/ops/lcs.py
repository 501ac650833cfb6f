"""Bit-parallel LCS accepts of greedy clustering: the counterparts of
`genomics_tpu/models/cluster.py`'s `_lcs_batch` / `_lcs_multi` /
`_lcs_accept_bits` (CD-HIT-style clustering, func.cu:609-720's
kernel_dynamic) and of `genomics_tpu/models/ngia.py`'s `round_body` /
`accept_body` (nGIA: the word filter and the banded LCS).

A read is held as two bit-planes of 32-base words (bit b of word w is the
low / high bit of the 2-bit code of base 32w + b) and its de-gapped codes
(255 past its net length).  One query base updates a representative's
row of W words as the big-integer sum

    row <- (row + (row & match)) | (row & ~match)

with `match` the text positions equal to the base; the matched count is
the zero bits of the row below the text's net length.  The JAX package
resolves the words' carries with a monotone fix-point; a plain carry
chain gives the same sums (carries only flow upward).  nGIA's banded
variant updates only words [iw - shift, iw + shift] for query word iw
(clipped to the row), with no carry into the band's lowest word and the
carry out of its highest dropped.

`lcs_accept` and `banded_lcs_accept` take their plain versions for
tensors on the CPU and launch `csrc/cluster_lcs.cu` / `csrc/ngia_lcs.cu`
for tensors on a CUDA device; any other device raises.  The kernels gate
or filter every pair, then run the LCS of the pairs that pass only, each
pair's row (nGIA: its band) split over a group of G lanes, K words a
lane, the carries resolved by carry-lookahead across the warp
(`csrc/bitlcs.cuh`); a pair wider than its launch's group (past 128
words) runs a warp to itself with its row in shared memory, and a block
with many pairs runs them a thread each.  They read a query's codes 16
bytes at a time, so the codes' rows are padded to a multiple of 16 bytes
(`pad_codes`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.device import on_cpu
from genomics_tpu_torch.ops.fm_search import _popcount32

# Kernel launches; each wrapper adds one where it launches its kernel.
LAUNCHES = {"cluster_lcs": 0, "ngia_lcs": 0}
WORD = 0xFFFFFFFF
# cluster_lcs.cu splits a pair's row over a group of G lanes, K words a
# lane: G x K is the smallest of these that holds the launch's widest
# representative, at most 128 (G = min(G x K, 32)); a wider row runs a
# warp a pair with the row in the warp's slot of shared memory.
CLUSTER_WORDS = (1, 2, 4, 8, 16, 32, 64, 128)
# ngia_lcs.cu splits a pair's band of 2 * shift + 1 words the same way
# (the smallest that holds the launch's widest band, at most 128); a pair
# with a wider band runs a warp to itself with the whole row in shared
# memory.
NGIA_BANDS = (1, 2, 4, 8, 16, 32, 64, 128)
# The kernels load a query's codes 16 bytes at a time from 16-byte
# aligned rows.
CODE_ALIGN = 16
# The fewest job columns a block of either kernel takes (each picks the
# fewest that keep its launch to one wave) and its warps (kWarps): the
# global scratch's shape.
CHUNK_MIN, WARPS = 32, 4
# A warp's row lives in shared memory up to this many words (kSharedWords:
# reads of 393,216 bases); wider launches pass a global scratch of
# [S, blocks, WARPS, max_words] words, at most SCRATCH_BYTES a launch (in
# chunks of job columns).
SHARED_WORDS = 12288
SCRATCH_BYTES = 1 << 28
# A block whose list holds THREAD_MIN pairs or more runs them a thread
# each, its rows in shared memory, in a launch whose rows are up to
# THREAD_WORDS words (the kernels' thread_min argument, `thread_min`;
# the launchers drop it where the launch fills less than a wave): where
# a block has that many pairs, the LCS's work and not one pair's chain
# sets its time.  `tools/lcs_variants.py --sweep` (PERF.md §6): at 5-96
# words threads won 1.3-4.5x with every pair or 1/8 of them gated, 32
# beat 64 at 1/8, and wider rows' shared memory cost the sparse launches
# more than threads won.
THREAD_MIN, THREAD_WORDS = 32, 96

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# low, high, W, net, codes, cs, bcut, reps, S, jobs, J, gate, out, ld,
# max_words, nw, thread_min, scratch, stream
_CLUSTER_ARGS = (_vp, _vp, _ci, _vp, _vp, ctypes.c_longlong, _vp, _vp, _ci,
                 _vp, _ci, _vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp)
# words, net, low, high, W, codes, cs, reps, S, jobs, J, sim, oms,
# cluster, out, ld, max_words, bw, thread_min, scratch, stream
_NGIA_ARGS = (_vp, _vp, _vp, _vp, _ci, _vp, ctypes.c_longlong, _vp, _ci,
              _vp, _ci, _cf, _cf, _vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp)


def cluster_bucket(max_words: int) -> int:
    """Row words G x K a group of cluster_lcs.cu holds for a launch whose
    widest representative spans `max_words` words (128 past 128 words:
    wider rows run a warp a pair)."""
    for nw in CLUSTER_WORDS:
        if max_words <= nw:
            return nw
    return CLUSTER_WORDS[-1]


def ngia_bucket(max_shift: int) -> int:
    """Band words G x K a group of ngia_lcs.cu holds for a launch whose
    widest band is 2 * max_shift + 1 words (128 past 128 words: wider
    bands run a warp a pair)."""
    for bw in NGIA_BANDS:
        if 2 * max(max_shift, 0) + 1 <= bw:
            return bw
    return NGIA_BANDS[-1]


def thread_min(max_words: int, scratch) -> int:
    """The kernels' thread_min for a launch whose rows are up to
    `max_words` words: THREAD_MIN where they are up to THREAD_WORDS and in
    shared memory, else 0 (lane groups whatever a block's count)."""
    return THREAD_MIN if scratch is None and max_words <= THREAD_WORDS else 0


def pad_codes(codes: np.ndarray) -> np.ndarray:
    """codes [N, L] uint8 with each row padded by 255 to a multiple of
    CODE_ALIGN bytes, the layout the kernels read."""
    L = -(-codes.shape[1] // CODE_ALIGN) * CODE_ALIGN
    out = np.full((codes.shape[0], L), 255, np.uint8)
    out[:, :codes.shape[1]] = codes
    return out


def _aligned_codes(codes: torch.Tensor) -> torch.Tensor:
    """codes itself where its rows are CODE_ALIGN-byte aligned (the
    per-read arrays of models/cluster.py and models/ngia.py are), else a
    padded copy."""
    if codes.stride(0) % CODE_ALIGN == 0 and \
            codes.data_ptr() % CODE_ALIGN == 0:
        return codes
    out = codes.new_full((codes.shape[0], -(-codes.shape[1] // CODE_ALIGN)
                          * CODE_ALIGN), 255)
    out[:, :codes.shape[1]] = codes
    return out


def words_of(net: torch.Tensor) -> torch.Tensor:
    """Row words that matter for texts of these net lengths: ceil(net / 32)."""
    return torch.div(net.long() + 31, 32, rounding_mode="floor")


def shift_of(rep_net, net, sim: float) -> torch.Tensor:
    """nGIA's band half-width in words, ceil(ceil(rep_net - net * sim) / 32)
    (func.cu:377-388), as the JAX package computes it on the CPU: XLA
    contracts the f32 multiply and subtract into one fma, so the
    difference is rounded to f32 once (exact in f64 first: every term has
    under 40 significant bits)."""
    sim64 = float(np.float32(sim))
    diff = (rep_net.double() - net.double() * sim64).float().ceil()
    return torch.ceil(diff / 32.0).long()


def max_shift_of(rep_net: np.ndarray, job_net: np.ndarray, sim: float) -> int:
    """The widest band a pair of these representatives and jobs can take:
    the shift of the longest representative against the shortest job
    (shift_of is monotone in both)."""
    hi = torch.tensor([int(np.max(rep_net))])
    lo = torch.tensor([int(np.min(job_net))])
    return int(shift_of(hi, lo, sim)[0])


def _row_lcs(tl, th, tnet, q, qnet, shift=None, stats=None):
    """Matched counts of P (text, query) pairs: tl / th [P, W] int64 text
    planes (32-bit words), tnet [P], q [P, L] uint8 codes, qnet [P]; with
    `shift` [P], nGIA's band.  Every pair steps together: a step adds
    row & match to the row word by word and then ripples the carries up
    until none is left, out-of-band words passing none on.  Words at or
    past ceil(max tnet / 32) are not computed: they feed no lower word.
    With `stats`, adds the active steps and the word-steps the kernels run
    (words below ceil(tnet / 32), in the band for nGIA) and keeps the most
    active steps of one pair ("longest")."""
    dev = tl.device
    P = tl.shape[0]
    wr = words_of(tnet)
    W = int(wr.max()) if P else 0
    L = min(int(qnet.max()) if P else 0, q.shape[1])
    if W == 0 or L == 0:
        return torch.zeros(P, dtype=torch.int64, device=dev)
    tl, th = tl[:, :W], th[:, :W]
    # the text positions of each base code: [4, P, W]
    mt = torch.stack([~((tl ^ (WORD if c & 1 else 0))
                        | (th ^ (WORD if c & 2 else 0))) & WORD
                      for c in range(4)])
    codes = q[:, :L].long()
    act = (codes != 255) & (torch.arange(L, device=dev)[None, :]
                            < qnet.long()[:, None])
    codes = codes.clamp(max=3)
    if stats is not None:
        stats["longest"] = max(stats.get("longest", 0),
                               int(act.sum(dim=1).max()))
    pairs = torch.arange(P, device=dev)
    widx = torch.arange(W, device=dev)[None, :]
    inrow = widx < wr[:, None]
    row = torch.full((P, W), WORD, dtype=torch.int64, device=dev)
    steps = word_steps = 0
    for k in range(L):
        m = mt[codes[:, k], pairs]
        upd = act[:, k, None] & inrow
        if shift is not None:
            iw = k // 32
            band = (widx >= iw - shift[:, None]) & (widx <= iw + shift[:, None])
            upd &= band
        if stats is not None:
            steps += int(act[:, k].sum())
            word_steps += int(upd.sum())
        s = row + (row & m)
        while True:
            c = s >> 32
            if shift is not None:
                c &= band
            s &= WORD
            c = c[:, :-1]
            if not bool(c.any()):
                break
            s[:, 1:] += c
        row = torch.where(upd, s | (row & (m ^ WORD)), row)
    bits = (tnet.long()[:, None] - 32 * widx).clamp(0, 32)
    zeros = _popcount32(~row & ((1 << bits) - 1))
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + steps
        stats["word_steps"] = stats.get("word_steps", 0) + word_steps
    return zeros.sum(dim=1)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Plane words (int32 bit patterns) as int64 values of 32 bits."""
    return x.long() & WORD


def lcs_accept_plain(low, high, net, codes, bcut, reps, jobs, gate=None,
                     stats=None):
    """The plain version of `lcs_accept`, on the inputs' device: the pairs
    the gate lets through, all stepped together.  With `stats`, the work
    a bound counts: stats["pairs"] (the LCS pairs), stats["steps"] (their
    active query steps) and stats["word_steps"] (those steps times the
    representative's words), and stats["longest"] (one pair's most active
    steps)."""
    S, J = reps.shape[0], jobs.shape[0]
    out = torch.zeros((S, J), dtype=torch.uint8, device=low.device)
    if gate is None:
        si, ci = (t.reshape(-1) for t in torch.meshgrid(
            torch.arange(S, device=low.device),
            torch.arange(J, device=low.device), indexing="ij"))
    else:
        si, ci = torch.nonzero(gate, as_tuple=True)
    r, j = reps.long()[si], jobs.long()[ci]
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + int(si.shape[0])
    matched = _row_lcs(_bits(low[r]), _bits(high[r]), net[r], codes[j],
                       net[j], stats=stats)
    out[si, ci] = (matched > bcut.long()[j]).to(torch.uint8)
    return out


def _check(x, what, dtype, shape, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` on
    `device` (the kernels index every input from its first element)."""
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{what} must be {dtype} {shape}; got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, the reads on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _read_arrays(low, high, net, codes):
    """(N, W) of the per-read arrays, checked; codes may have any row
    stride, its bases contiguous."""
    N, W = low.shape
    dev = low.device
    _check(low, "low", torch.int32, (N, W), dev)
    _check(high, "high", torch.int32, (N, W), dev)
    _check(net, "net", torch.int32, (N,), dev)
    if (codes.dtype != torch.uint8 or codes.dim() != 2 or codes.shape[0] != N
            or codes.device != dev or codes.stride(1) != 1):
        raise ValueError(f"codes must be uint8 [{N}, L] on {dev} with "
                         f"contiguous rows; got {codes.dtype} "
                         f"{tuple(codes.shape)} on {codes.device}")
    return N, W


def lcs_accept(low, high, net, codes, bcut, reps, jobs, gate=None, *,
               max_words=None):
    """[S, J] uint8: does representative reps[s] accept job jobs[j], that
    is, is the bit-parallel LCS of the job's codes against the
    representative's planes above bcut[job] (kernel_dynamic, func.cu:
    707-712), where gate[s, j] (uint8, default all) is set.  Per-read
    arrays: low / high [N, W] int32 planes, net / bcut [N] int32, codes [N,
    L] uint8 (255 past net); reps [S] / jobs [J] int32 read indices.
    `max_words` (at least ceil of the largest representative net / 32;
    past 128 a pair runs a warp to itself, its row in shared memory up to
    SHARED_WORDS) saves the wrapper a sync."""
    N, _ = _read_arrays(low, high, net, codes)
    dev = low.device
    _check(bcut, "bcut", torch.int32, (N,), dev)
    S, J = reps.shape[0], jobs.shape[0]
    _check(reps, "reps", torch.int32, (S,), dev)
    _check(jobs, "jobs", torch.int32, (J,), dev)
    if gate is not None:
        _check(gate, "gate", torch.uint8, (S, J), dev)
    if on_cpu(low):
        return lcs_accept_plain(low, high, net, codes, bcut, reps, jobs, gate)
    out = torch.empty((S, J), dtype=torch.uint8, device=low.device)
    if S == 0 or J == 0:
        return out
    codes = _aligned_codes(codes)
    if max_words is None:
        max_words = int(words_of(net[reps.long()]).max())
    for lay in lcs_layouts(low, high, net, codes, bcut, reps, jobs, gate,
                           out, max_words):
        launch_cluster_lcs(lay)
    return out


def _launches(S: int, J: int, words: int, dev) -> list:
    """(first column, last column + 1, scratch) of each launch: all columns
    at once with the rows in shared memory up to SHARED_WORDS words, else
    chunks whose [S, blocks, WARPS, words] global scratch (blocks of
    CHUNK_MIN columns at the most) stays under SCRATCH_BYTES."""
    if words <= SHARED_WORDS:
        return [(0, J, None)]
    per = 4 * S * WARPS * words
    step = CHUNK_MIN * max(1, SCRATCH_BYTES // per)
    return [(c0, min(c0 + step, J), torch.empty(
        -(-(min(c0 + step, J) - c0) // CHUNK_MIN) * per // 4,
        dtype=torch.int32, device=dev)) for c0 in range(0, J, step)]


def lcs_layouts(low, high, net, codes, bcut, reps, jobs, gate, out,
                max_words: int, threads=None) -> list:
    """cluster_lcs_launch's arguments but the stream, one tuple a launch
    (one, or chunks of job columns where rows past SHARED_WORDS take a
    global scratch): pointers into the per-read arrays in place, the gate
    and out at their row stride J.  `threads` overrides `thread_min`'s
    rule (for timings)."""
    S, J = out.shape
    nw = cluster_bucket(max_words)
    lays = []
    for c0, c1, scratch in _launches(S, J, max_words, low.device):
        n = c1 - c0
        tm = thread_min(max_words, scratch) if threads is None else threads
        lays.append((low, high, low.shape[1], net, codes, codes.stride(0),
                     bcut, reps, S, jobs[c0:c1], n,
                     None if gate is None else gate[:, c0:], out[:, c0:], J,
                     max_words, nw, tm, scratch))
    return lays


def launch_cluster_lcs(layout: tuple):
    """Launch csrc/cluster_lcs.cu on one of `lcs_layouts`' tuples and count
    it."""
    _build.launch("cluster_lcs", "cluster_lcs_launch", _CLUSTER_ARGS,
                  layout[0].device, *layout)
    LAUNCHES["cluster_lcs"] += 1


def filter_sums(words, reps, jobs) -> torch.Tensor:
    """[S, J] int32: sum over the 256 bins of min(rep count, job count)
    (kernel_filter, func.cu:321-344), in chunks of job columns."""
    S, J = reps.shape[0], jobs.shape[0]
    rw = (words[reps.long()].int() & 0xFFFF)[:, None, :]
    out = torch.empty((S, J), dtype=torch.int32, device=words.device)
    step = max(1, (1 << 26) // max(S * 256, 1))
    for c0 in range(0, J, step):
        jw = (words[jobs[c0:c0 + step].long()].int() & 0xFFFF)[None, :, :]
        out[:, c0:c0 + step] = torch.minimum(rw, jw).sum(dim=2)
    return out


def banded_lcs_accept_plain(words, net, low, high, codes, reps, jobs, sim,
                            cluster=None, stats=None):
    """The plain version of `banded_lcs_accept`, on the inputs' device: the
    word filter over every pair, then the banded LCS of the pairs that
    pass it, all stepped together.  With `stats`: stats["filtered"] (pairs
    through the filter), stats["pairs"] (LCS pairs, shift >= 0),
    stats["steps"] and stats["word_steps"] (band words below ceil(rep net
    / 32)), stats["longest"] (one pair's most active steps)."""
    dev = words.device
    r, j = reps.long(), jobs.long()
    rn, jn = net.long()[r][:, None], net.long()[j][None, :]
    live = torch.ones((1, j.shape[0]), dtype=torch.bool, device=dev)
    if cluster is not None:
        live = (cluster[j] == -1)[None, :]
    mlen = torch.minimum(rn, jn)
    oms = torch.tensor(np.float32(1.0 - float(sim)), device=dev)
    sim32 = torch.tensor(np.float32(sim), device=dev)
    thr = mlen - torch.ceil(mlen.float() * oms).long() * 4
    passed = live & (filter_sums(words, reps, jobs).long()
                     >= thr.clamp(min=1))
    shift = shift_of(rn, jn, sim)
    run = passed & (shift >= 0)
    if stats is not None:
        stats["filtered"] = stats.get("filtered", 0) + int(
            live.sum()) * r.shape[0]
        stats["pairs"] = stats.get("pairs", 0) + int(run.sum())
    si, ci = torch.nonzero(run, as_tuple=True)
    matched = torch.zeros(passed.shape, dtype=torch.int64, device=dev)
    matched[si, ci] = _row_lcs(
        _bits(low[r[si]]), _bits(high[r[si]]), net[r[si]], codes[j[ci]],
        net[j[ci]], shift=shift[si, ci], stats=stats)
    cutoff = torch.ceil(mlen.float() * sim32).long()
    accept = passed & (matched >= cutoff)
    if cluster is None:
        return accept.to(torch.uint8)
    cluster[j[accept[0]]] = reps[0].to(cluster.dtype)
    return cluster


def banded_lcs_accept(words, net, low, high, codes, reps, jobs, sim: float,
                      cluster=None, *, max_shift=None, max_words=None):
    """nGIA's accept (round_body / accept_body, ngia.py:91-175 and
    :214-324): for representative reps[s] and job jobs[j], the 256-bin
    word filter, thr = max(mlen - ceil(mlen * (1 - sim)) * 4, 1), the
    banded LCS and matched >= ceil(mlen * sim), mlen the smaller net.
    Per-read arrays: words [N, 256] int16 (uint16 counts), net [N] int32,
    low / high [N, W] int32 planes, codes [N, L] uint8; reps [S] / jobs
    [J] int32 indices.  Without `cluster`, returns the [S, J] uint8
    accepts.  With `cluster` ([N] int32, one representative): only jobs
    whose cluster is -1 count, and each accepted job gets cluster[j] =
    reps[0], in place (the representative accepts itself); returns
    `cluster`.  `max_shift` / `max_words` (at least the widest band and row
    of the launch, see `max_shift_of`; past a shift of 63 a pair runs a
    warp to itself, its row in shared memory up to SHARED_WORDS) save the
    wrapper two syncs."""
    N, W = _read_arrays(low, high, net, codes)
    dev = low.device
    _check(words, "words", torch.int16, (N, 256), dev)
    S, J = reps.shape[0], jobs.shape[0]
    _check(reps, "reps", torch.int32, (S,), dev)
    _check(jobs, "jobs", torch.int32, (J,), dev)
    if cluster is not None:
        _check(cluster, "cluster", torch.int32, (N,), dev)
        if S != 1:
            raise ValueError(f"a round takes one representative; got {S}")
    if on_cpu(words):
        return banded_lcs_accept_plain(words, net, low, high, codes, reps,
                                       jobs, sim, cluster)
    out = None if cluster is not None else torch.empty(
        (S, J), dtype=torch.uint8, device=words.device)
    if S == 0 or J == 0:
        return cluster if cluster is not None else out
    if max_words is None:
        max_words = int(words_of(net[reps.long()]).max())
    if max_shift is None:
        max_shift = int(shift_of(net[reps.long()].max()[None],
                                 net[jobs.long()].min()[None], sim)[0])
    if words.data_ptr() % 16:
        words = words.clone()
    codes = _aligned_codes(codes)
    for lay in banded_layouts(words, net, low, high, codes, reps, jobs, sim,
                              cluster, out, max_words, max_shift):
        launch_ngia_lcs(lay)
    return cluster if cluster is not None else out


def banded_layouts(words, net, low, high, codes, reps, jobs, sim, cluster,
                   out, max_words: int, max_shift: int, threads=None) -> list:
    """ngia_lcs_launch's arguments but the stream, one tuple a launch (one,
    or chunks of job columns where rows past SHARED_WORDS take a global
    scratch); f32(sim) and f32(1 - sim), the latter formed in f64 first as
    the JAX package's weak-typed constant is.  `threads` overrides
    `thread_min`'s rule (for timings)."""
    S, J = reps.shape[0], jobs.shape[0]
    bw = ngia_bucket(max_shift)
    sim32 = float(np.float32(sim))
    oms32 = float(np.float32(1.0 - float(sim)))
    lays = []
    for c0, c1, scratch in _launches(S, J, max_words, words.device):
        n = c1 - c0
        tm = thread_min(max_words, scratch) if threads is None else threads
        lays.append((words, net, low, high, low.shape[1], codes,
                     codes.stride(0), reps, S, jobs[c0:c1], n, sim32, oms32,
                     cluster, None if out is None else out[:, c0:], J,
                     max_words, bw, tm, scratch))
    return lays


def launch_ngia_lcs(layout: tuple):
    """Launch csrc/ngia_lcs.cu on one of `banded_layouts`' tuples and count
    it."""
    _build.launch("ngia_lcs", "ngia_lcs_launch", _NGIA_ARGS,
                  layout[0].device, *layout)
    LAUNCHES["ngia_lcs"] += 1
