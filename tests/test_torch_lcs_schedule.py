"""The schedule of csrc/cluster_lcs.cu and csrc/ngia_lcs.cu, emulated in
numpy on the CPU, lane by lane.

A launch's blocks each serve one representative and `chunk` job columns
(a multiple of 32; the kernels pick the fewest that keep the launch to
one wave).  The throughput pass gates (clustering) or filters (nGIA, a
warp a job: lane l takes bins [8l, 8l + 8) of the job's histogram,
kBatch jobs in flight, only the columns still unclustered) every pair,
each warp over its slices of 32 columns, answers the pairs that run no
LCS, and compacts the rest into the block's list by a warp scan of the
threads' counts and the warps' totals (nGIA: two lists, the bands that
fit a group and the wider, counted in the two halves of one scan).  The
latency pass hands the lists to the block's lane groups in turn: G lanes
a pair, 32 / G pairs a warp, K row words (nGIA: band slots) a lane with
their planes, every step's carries resolved for the whole warp at once
from the generate and propagate ballots, ((Gm | Pm) + Gm) ^ Pm with each
group's top lane cleared in both; the query's codes loaded 16 bytes a
lane 16 G steps ahead and handed to the group by shuffles; nGIA's band
sliding up a word every 32 bases, the words moving down a slot (between
lanes by a shuffle down the group), the leaving word's zero bits
counted as it leaves.  A row or band wider than G x K runs a warp to
itself with the row in memory, ceil(width / 32) words a lane in two
passes.

The emulation counts every write of an accept or a cluster word (one
writer each) and every list entry (each surviving column once), and is
held integer-equal to the plain versions (`_row_lcs`,
`lcs_accept_plain`, `banded_lcs_accept_plain`) and to the JAX package's
`_lcs_multi` / `round_body` / `accept_body` at nets 1, 31-33 and 63-65,
every G x K of the kernels, rows and bands wider than the group, an
all-ones sum next to a generating word, a carry across a whole group,
the fma pairs, launches where no pair and where every pair passes, and
lists that straddle warps and leave groups empty.  The kernels
themselves run only on the card (tests/test_torch_cuda.py holds them to
the plain versions)."""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import NGIA_FMA_PAIRS, lcs_edge_reads, ngia_edge_reads
from genomics_tpu.models import cluster as JC
from genomics_tpu.models import ngia as JN
from genomics_tpu_torch import _build
from genomics_tpu_torch.models import cluster as TC
from genomics_tpu_torch.models import ngia as TN
from genomics_tpu_torch.ops import lcs

FULL = 0xFFFFFFFF
LANE = np.arange(32)
BIT = np.uint64(1) << LANE.astype(np.uint64)
M32 = np.uint64(FULL)


# the emulated launches' reads are cut to this many bases (but where a
# case needs a row or band past 64 words): a row's width, not a query's
# length, sets the lanes' work, and each base is a step of the emulation
SHORT = 300
# blocks the emulated card holds at once: more than any launch here makes,
# so each runs its lane groups, but where a case passes a wave of 1 (a
# launch that fills the card, where blocks of THREAD_MIN pairs or more run
# a thread a pair)
WAVE = 1 << 20


def _constants(name: str, *keys) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in keys}


CLUSTER = _constants("cluster_lcs", "kThreads", "kMaxChunk", "kSharedWords")
NGIA = _constants("ngia_lcs", "kThreads", "kBatch", "kMaxChunk",
                  "kSharedWords")


def lanes_words(slots: int) -> tuple[int, int]:
    """(G, K) of a bucket of G x K words, as the kernels' launchers map
    it: G = min(slots, 32)."""
    G = min(slots, 32)
    return G, slots // G


# -- the warp's primitives --------------------------------------------------
def ballot(pred) -> np.ndarray:
    """[n] uint64 masks of [n, 32] predicates."""
    return (pred.astype(np.uint64) * BIT).sum(axis=1, dtype=np.uint64)


def carriers(G: int) -> int:
    """bitlcs::carriers<G>: every lane but each group's top."""
    return sum(1 << int(l) for l in LANE if l % G != G - 1)


def carries(gen, prop, G: int) -> np.ndarray:
    """bitlcs::carries: the carry into each lane, [n] masks."""
    c = np.uint64(carriers(G))
    gen, prop = gen & c, prop & c
    return (((gen | prop) + gen) & M32) ^ prop


def popc(x) -> np.ndarray:
    return np.bitwise_count(x.astype(np.uint64)).astype(np.int64)


def word_mask(tnet, w) -> np.ndarray:
    bits = np.clip(tnet - 32 * w, 0, 32).astype(np.uint64)
    return np.where(bits >= 32, FULL, (np.uint64(1) << bits) - 1)


def match(pl, ph, b) -> np.ndarray:
    ql = np.where(b & 1, FULL, 0).astype(np.uint64)
    qh = np.where(b & 2, FULL, 0).astype(np.uint64)
    return ~((pl ^ ql) | (ph ^ qh)) & M32


def step(r, m, live, on, G: int) -> np.ndarray:
    """bitlcs::step<G, K> over [n, 32] lanes of K words ([n, 32, K] r, m
    and live; on [n, 32]): each lane's K-word chain, one lookahead a warp,
    each lane's carry in rippled through its words."""
    K = r.shape[2]
    s = np.zeros_like(r)
    c = np.zeros(r.shape[:2], np.uint64)
    ones = on.copy()
    for i in range(K):
        t = r[..., i] + (r[..., i] & m[..., i]) + c
        s[..., i] = t & M32
        c = np.where(live[..., i], t >> np.uint64(32), 0).astype(np.uint64)
        ones &= live[..., i] & (s[..., i] == FULL)
    cm = carries(ballot(on & (c != 0)), ballot(ones), G)
    c = (cm[:, None] >> LANE.astype(np.uint64)) & np.uint64(1)
    out = r.copy()
    for i in range(K):
        t = (s[..., i] + c) & M32
        c = np.where(live[..., i] & (s[..., i] == FULL), c, 0).astype(
            np.uint64)
        out[..., i] = np.where(on & live[..., i],
                               t | (r[..., i] & ~m[..., i] & M32), r[..., i])
    return out


def ripple(gen, prop, G: int) -> np.ndarray:
    """The carries into each lane as a chain, group by group: the
    lookahead's oracle."""
    out = np.zeros(gen.shape, np.uint64)
    for i in range(gen.shape[0]):
        c = 0
        for l in range(32):
            if l % G == 0:
                c = 0
            out[i] |= np.uint64(c << l)
            g, p = int(gen[i]) >> l & 1, int(prop[i]) >> l & 1
            c = g | (p & c)
    return out


def handout(ahead, q, qn, kb: int, G: int):
    """bitlcs::hand_out over [n, 32] lanes: `ahead` [n, 32, 16] reloaded
    every 16 G steps (lane t: codes [kb + 16 t, +16) of its group's query,
    255 past qn), then the 16 codes of [kb, kb + 16) from the group's lane
    (kb / 16) mod G."""
    t = LANE % G
    if kb % (16 * G) == 0:
        pos = np.broadcast_to(kb + 16 * t, qn.shape)
        idx = np.clip(pos[..., None] + np.arange(16), 0, q.shape[2] - 1)
        got = np.take_along_axis(q, idx, axis=2)
        ahead = np.where((pos < qn)[..., None], got, 255)
    src = (LANE // G) * G + (kb // 16) % G
    return ahead, ahead[:, src, :]


# -- the latency pass ---------------------------------------------------------
def group_lcs(slots: int, band: bool, tl, th, rnet, q, qn, shift):
    """bitlcs::group_lcs<G, K> over n warps (G x K = slots): tl / th [n,
    32, W] the planes of each lane's pair's representative, q [n, 32, L]
    its query's codes (L a multiple of 16), rnet / qn / shift [n, 32]
    (uniform over a group; qn = 0 for an empty group).  Slot j = t K + i
    (lane t's word i) holds word base + j.  Returns [n, 32 // G] counts."""
    G, K = lanes_words(slots)
    n = rnet.shape[0]
    W = tl.shape[2]
    t = np.broadcast_to(LANE % G, (n, 32))
    top_lane = t == G - 1
    j = t[..., None] * K + np.arange(K)            # [n, 32, K] slots
    wr = ((rnet + 31) // 32)[..., None]
    top = (2 * shift if band else np.full((n, 32), slots - 1))[..., None]
    base = (-shift if band else np.zeros((n, 32), np.int64))[..., None]

    def planes(w, ok):
        i = np.clip(w, 0, W - 1)
        return [np.where(ok, np.take_along_axis(x, i, axis=2), 0)
                .astype(np.uint64) for x in (tl, th)]

    w = base + j
    inrow = (w >= 0) & (w < wr)
    live = inrow & (j <= top)
    pl, ph = planes(w, inrow)
    nxt = base[..., 0] + slots
    nl, nh = (x[..., 0] for x in planes(
        nxt[..., None], (band & top_lane & (nxt >= 0)
                         & (nxt < wr[..., 0]))[..., None]))
    r = np.full((n, 32, K), FULL, np.uint64)
    zeros = np.zeros((n, 32), np.int64)
    kmax = qn.max(axis=1)
    ahead = np.full((n, 32, 16), 255, q.dtype)
    down = np.where(LANE % G == G - 1, LANE, LANE + 1)
    for kb in range(0, int(kmax.max(initial=0)), 16):
        wo = (kb < kmax)[:, None]           # the warps still in the loop
        ahead, c16 = handout(ahead, q, qn, kb, G)
        if band and kb and kb % 32 == 0:
            leave = wo & (t == 0) & live[..., 0]
            zeros += np.where(leave, popc(~r[..., 0] & word_mask(
                rnet, base[..., 0])), 0)
            new = [np.concatenate([x[..., 1:], np.where(
                top_lane, fresh, x[:, down, 0])[..., None]], axis=2)
                for x, fresh in ((r, FULL), (pl, nl), (ph, nh))]
            r, pl, ph = (np.where(wo[..., None], a, b)
                         for a, b in zip(new, (r, pl, ph)))
            base = np.where(wo[..., None], base + 1, base)
            w = base + j
            live = (w >= 0) & (w < wr) & (j <= top)
            nxt = base[..., 0] + slots
            ok = top_lane & (nxt >= 0) & (nxt < wr[..., 0])
            got = [x[..., 0] for x in planes(nxt[..., None], ok[..., None])]
            nl, nh = (np.where(wo, a, b) for a, b in zip(got, (nl, nh)))
        for i in range(16):
            b = c16[..., i].astype(np.int64)
            on = wo & (b != 255) & (kb + i < qn)
            r = step(r, match(pl, ph, b[..., None]), live, on, G)
    zeros += np.where(live, popc(~r & word_mask(rnet[..., None], w)),
                      0).sum(axis=2)
    return zeros.reshape(n, 32 // G, G).sum(axis=2)


def wide_lcs(band: bool, tl, th, rnet, q, qn, shift) -> np.ndarray:
    """bitlcs::wide_lcs over n warps, a pair each: tl / th [n, W], q [n,
    L], rnet / qn / shift [n]; the row in a scratch, lane l taking words
    [lo + l K, lo + l K + K) of [lo, hi], two passes a step.  Returns [n]
    counts."""
    n, W = tl.shape
    wr = (rnet + 31) // 32
    K = ((2 * shift + 1 if band else wr) + 31) // 32
    row = np.full((n, W + 1), FULL, np.uint64)
    rows = np.arange(n)[:, None]
    lo, hi = np.zeros(n, np.int64), wr - 1
    ahead = np.full((n, 32, 16), 255, q.dtype)
    qq = np.broadcast_to(q[:, None, :], (n, 32, q.shape[1]))
    qn32 = np.broadcast_to(qn[:, None], (n, 32))
    for kb in range(0, int(qn.max(initial=0)), 16):
        ahead, c16 = handout(ahead, qq, qn32, kb, 32)
        if band and kb % 32 == 0:
            lo = np.where(kb < qn, np.maximum(0, kb // 32 - shift), lo)
            hi = np.where(kb < qn, np.minimum(wr - 1, kb // 32 + shift), hi)
        w0 = lo[:, None] + LANE[None, :] * K[:, None]
        for i in range(16):
            b = c16[:, 0, i].astype(np.int64)
            act = (kb + i < qn) & (b != 255)
            if not act.any():
                continue
            c = np.zeros((n, 32), np.uint64)
            ones = w0 <= hi[:, None]
            for v in range(int(K.max())):
                w = w0 + v
                ok = (v < K[:, None]) & (w <= hi[:, None])
                wi = np.where(ok, w, W)
                r = row[rows, wi]
                s = r + (r & match(tl[rows, np.minimum(wi, W - 1)],
                                   th[rows, np.minimum(wi, W - 1)],
                                   b[:, None])) + c
                c = np.where(ok, s >> np.uint64(32), c)
                ones &= ~ok | ((s & np.uint64(FULL)) == FULL)
            c = (carries(ballot(c != 0), ballot(ones), 32)[:, None]
                 >> LANE.astype(np.uint64)) & np.uint64(1)
            for v in range(int(K.max())):
                w = w0 + v
                ok = (v < K[:, None]) & (w <= hi[:, None]) & act[:, None]
                wi = np.where(ok, w, W)
                r = row[rows, wi]
                m = match(tl[rows, np.minimum(wi, W - 1)],
                          th[rows, np.minimum(wi, W - 1)], b[:, None])
                s = r + (r & m) + c
                c = np.where(ok, s >> np.uint64(32), c)
                new = (s & np.uint64(FULL)) | (r & ~m & np.uint64(FULL))
                row[rows, wi] = np.where(ok, new, r)
            row[:, W] = FULL
    w = np.arange(W)[None, :]
    live = w < wr[:, None]
    return np.where(live, popc(~row[:, :W] & word_mask(rnet[:, None], w)),
                    0).sum(axis=1)


def thread_lcs(band: bool, tl, th, rnet, q, qn, shift) -> np.ndarray:
    """bitlcs::thread_lcs over n threads, a pair each: tl / th [n, W], q
    [n, L], rnet / qn / shift [n]; each step a serial carry chain over the
    row's words (the band's, clipped to the row).  Returns [n] counts."""
    n, W = tl.shape
    wr = (rnet + 31) // 32
    row = np.full((n, W), FULL, np.uint64)
    lo, hi = np.zeros(n, np.int64), wr - 1
    for k in range(int(qn.max(initial=0))):
        if band and k % 32 == 0:
            lo = np.maximum(0, k // 32 - shift)
            hi = np.minimum(wr - 1, k // 32 + shift)
        b = q[:, k].astype(np.int64)
        act = (k < qn) & (b != 255)
        m = match(tl, th, (b & 3)[:, None])
        carry = np.zeros(n, np.uint64)
        for w in range(int(wr.max(initial=0))):
            upd = act & (w >= lo) & (w <= hi)
            r = row[:, w]
            t = r + (r & m[:, w]) + carry
            carry = np.where(upd, t >> np.uint64(32), 0).astype(np.uint64)
            row[:, w] = np.where(upd, (t & M32) | (r & ~m[:, w] & M32), r)
    w = np.arange(W)[None, :]
    return np.where(w < wr[:, None], popc(~row & word_mask(rnet[:, None], w)),
                    0).sum(axis=1)


def block_offset(counts) -> tuple[np.ndarray, int]:
    """bitlcs::block_offset: a Hillis-Steele scan of each warp's counts by
    shuffles up, the warps' totals through shared memory."""
    v = np.array(counts, np.int64).reshape(-1, 32)
    n = v.copy()
    for o in (1, 2, 4, 8, 16):
        up = np.concatenate([np.zeros((v.shape[0], o), np.int64),
                             v[:, :-o]], axis=1)
        v = v + np.where(LANE >= o, up, 0)
    sums = v[:, 31]
    base = np.concatenate([[0], np.cumsum(sums)[:-1]])
    return (base[:, None] + v - n).reshape(-1), int(sums.sum())


def drain(lst, lanes: int, threads: int) -> list:
    """The latency pass's warps over one block's list, `lanes` lanes a
    pair: round i0 gives group g item i0 + g; returns, per warp that holds
    a pair, the columns of its 32 / lanes groups (-1 for none)."""
    per = 32 // lanes
    groups = threads // lanes
    warps = []
    for i0 in range(0, len(lst), groups):
        for wp in range(groups // per):
            slots = [lst[k] if k < len(lst) else -1
                     for k in range(i0 + wp * per, i0 + wp * per + per)]
            if max(slots) >= 0:
                warps.append(slots)
    return warps


def run_pairs(slots, band, wide, low, high, net, codes, pairs):
    """Counts of (rep, job, shift, ...) pairs run in the warps given: a
    list of warps, each a list of 32 / G pairs (wide: one pair) or None;
    returns [warps, pairs a warp]."""
    if not pairs:
        return np.zeros((0, 1), np.int64)
    G, _ = lanes_words(slots)
    per = 1 if wide else 32 // G
    lanes = np.repeat(np.arange(per), 32 // per)
    rp = np.array([[p[0] if p else 0 for p in w] for w in pairs])
    jp = np.array([[p[1] if p else 0 for p in w] for w in pairs])
    sh = np.array([[p[2] if p else 0 for p in w] for w in pairs])
    full = np.array([[p is not None for p in w] for w in pairs])
    qn = np.where(full, net[jp], 0)
    rn = np.where(full, net[rp], 0)
    if not wide:
        L = lambda x: x[:, lanes]   # noqa: E731
        return group_lcs(slots, band, low[L(rp)], high[L(rp)], L(rn),
                         codes[L(jp)], L(qn), L(sh))
    return wide_lcs(band, low[rp[:, 0]], high[rp[:, 0]], rn[:, 0],
                    codes[jp[:, 0]], qn[:, 0], sh[:, 0])[:, None]


def run_warps(slots, band, low, high, net, codes, tasks) -> list:
    """The warps' pairs, tasks of (mode, [(rep, job, shift, s, column) or
    None]): mode False a group's, True a warp's (wide), "thread" one pair
    a thread; each mode in one batch.  Returns (s, column, count) of every
    pair."""
    got = []
    mine = [t[1][0] for t in tasks if t[0] == "thread"]
    if mine:
        rp, jp, sh = (np.array([p[i] for p in mine]) for i in range(3))
        counts = thread_lcs(band, low[rp], high[rp], net[rp], codes[jp],
                            net[jp], sh)
        got += [(p[3], p[4], int(x)) for p, x in zip(mine, counts)]
    for wide in (False, True):
        mine = [t[1] for t in tasks if t[0] == wide]
        for pairs, m in zip(mine, run_pairs(slots, band, wide, low, high,
                                            net, codes, mine)):
            got += [(p[3], p[4], int(x)) for p, x in zip(pairs, m) if p]
    return got


def slices(T: int, chunk: int, first: int, J: int):
    """Each thread's columns of a block, in its slices' order: warp w's
    lane l takes column first + 32 (w + (T / 32) k) + l of slice k while
    in the chunk and below J."""
    warps = T // 32
    return [[first + 32 * sl + (th % 32)
             for sl in range(th // 32, chunk // 32, warps)
             if first + 32 * sl + th % 32 < J] for th in range(T)]


def compact(cols, keep) -> tuple[np.ndarray, int]:
    """The block's list: each thread's kept columns at its block_offset."""
    at, total = block_offset([sum(k) for k in keep])
    lst = np.full(total, -1)
    for th, (cs, ks) in enumerate(zip(cols, keep)):
        for c in [c for c, k in zip(cs, ks) if k]:
            lst[at[th]] = c
            at[th] += 1
    return lst, total


# -- the launches ---------------------------------------------------------------
def launch_thread_min(max_words: int, S: int, J: int, wave: int) -> int:
    """The thread_min a launch runs with: ops/lcs.thread_min's, dropped
    to 0 by bitlcs::launch_shape where S x ceil(J / 32) blocks fill less
    than the `wave` of blocks the card holds at once."""
    tm = lcs.thread_min(max_words, None)
    return 0 if S * -(-J // 32) < wave else tm


def cluster_launch(low, high, net, codes, bcut, reps, jobs, gate, slots,
                   chunk, max_words, wave=WAVE):
    """cluster_lcs_launch's kernel with blocks of `chunk` columns on a
    card that holds `wave` blocks at once: ([S, J] accepts, write counts,
    lists, the blocks that ran a thread a pair)."""
    T = CLUSTER["kThreads"]
    S, J = len(reps), len(jobs)
    tm = launch_thread_min(max_words, S, J, wave)
    out = np.zeros((S, J), np.int64)
    writes = np.zeros((S, J), np.int64)
    lists, tasks = [], []
    for s in range(S):
        wide = net[reps[s]] > 32 * slots     # the block's rows: warp a pair
        for first in range(0, J, chunk):
            cols = slices(T, chunk, first, J)
            keep = [[gate is None or gate[s, c] != 0 for c in cs]
                    for cs in cols]
            for cs, ks in zip(cols, keep):
                for c, k in zip(cs, ks):
                    writes[s, c] += not k
            lst, total = compact(cols, keep)
            lists.append((lst, [c for cs, ks in zip(cols, keep)
                                for c, k in zip(cs, ks) if k]))
            if tm and total >= tm:
                tasks += [("thread", [(reps[s], jobs[c], 0, s, c)])
                          for c in lst]
                continue
            G, _ = lanes_words(slots)
            tasks += [(wide, [(reps[s], jobs[c], 0, s, c) if c >= 0 else None
                              for c in sl])
                      for sl in drain(lst, 32 if wide else G, T)]
    for s, c, x in run_warps(slots, False, low, high, net, codes, tasks):
        out[s, c] = int(x > bcut[jobs[c]])
        writes[s, c] += 1
    return out, writes, lists, sum(t[0] == "thread" for t in tasks)


def f32(x) -> np.float32:
    return np.float32(x)


def band_shift(rnet, qn, sim: float) -> np.ndarray:
    """ngia_lcs.cu's band_shift: ceil(ceil(f32 fma(-qn, sim, rnet)) / 32)
    (the fma exact in f64, rounded once)."""
    d = (np.asarray(rnet, np.float64)
         - np.asarray(qn, np.float64) * float(f32(sim))).astype(np.float32)
    return np.ceil(np.ceil(d) * np.float32(0.03125)).astype(np.int64)


def ngia_launch(words, net, low, high, codes, reps, jobs, sim, slots, chunk,
                cluster=None, wave=WAVE):
    """ngia_lcs_launch's kernel with blocks of `chunk` columns on a card
    that holds `wave` blocks at once (max_words as the wrapper passes it,
    the widest representative's): the [S, J] accepts, or the cluster
    array updated (S = 1), with the write counts, the lists and the pairs
    run a thread each."""
    T, batch = NGIA["kThreads"], NGIA["kBatch"]
    S, J = len(reps), len(jobs)
    sim32, oms32 = f32(sim), f32(1.0 - float(sim))
    out = np.zeros((S, J), np.int64)
    writes = np.zeros((S, J), np.int64)
    cl = None if cluster is None else cluster.copy()
    hist = words.view(np.uint16).astype(np.int64)
    G, _ = lanes_words(slots)
    max_words = int((net[reps].max() + 31) // 32)
    tm = launch_thread_min(max_words, S, J, wave)
    lists, tasks = [], []
    for s in range(S):
        rep = reps[s]
        rnet = net[rep]
        for first in range(0, J, chunk):
            cols = slices(T, chunk, first, J)
            # the filter, a warp a job, slice by slice: each warp's live
            # lanes, kBatch at a time in lane order, each job's 32 lanes'
            # 8-bin partial sums
            total = {}
            for wp in range(T // 32):
                for k in range(len(cols[32 * wp])):
                    todo = [l for l in range(32) if k < len(cols[32 * wp + l])
                            and (cl is None
                                 or cl[jobs[cols[32 * wp + l][k]]] == -1)]
                    for b0 in range(0, len(todo), batch):
                        for l in todo[b0:b0 + batch]:
                            c = cols[32 * wp + l][k]
                            part = np.minimum(hist[jobs[c]], hist[rep])
                            assert c not in total
                            total[c] = int(part.reshape(32, 8).sum())
            keep, wide = [], []
            for cs in cols:
                keep.append([])
                wide.append([])
                for c in cs:
                    j = jobs[c]
                    mlen = min(net[j], rnet)
                    thr = max(mlen - int(np.ceil(np.float32(mlen) * oms32))
                              * 4, 1)
                    passed = c in total and total[c] >= thr
                    shift = int(band_shift(rnet, net[j], sim))
                    run = passed and shift >= 0
                    keep[-1].append(run)
                    wide[-1].append(run and 2 * shift + 1 > slots)
                    if not run:
                        acc = passed and int(np.ceil(np.float32(mlen)
                                                     * sim32)) <= 0
                        if cl is None:
                            out[s, c] = int(acc)
                            writes[s, c] += 1
                        elif acc:
                            cl[j] = rep
                            writes[s, c] += 1
            narrow_lst, _ = compact(cols, [[k and not w for k, w in zip(a, b)]
                                           for a, b in zip(keep, wide)])
            wide_lst, _ = compact(cols, wide)
            both = np.concatenate([narrow_lst, wide_lst])
            lists.append((both, [c for cs, ks in zip(cols, keep)
                                 for c, k in zip(cs, ks) if k]))
            if tm and len(both) >= tm:
                tasks += [("thread", [(rep, jobs[x], int(band_shift(
                    rnet, net[jobs[x]], sim)), s, x)]) for x in both]
                continue
            for is_wide, part in ((False, narrow_lst), (True, wide_lst)):
                tasks += [(is_wide, [(rep, jobs[x], int(band_shift(
                    rnet, net[jobs[x]], sim)), s, x) if x >= 0 else None
                    for x in sl])
                    for sl in drain(part, 32 if is_wide else G, T)]
    for s, c, x in run_warps(slots, True, low, high, net, codes, tasks):
        jj = jobs[c]
        acc = x >= int(np.ceil(np.float32(min(net[jj], net[reps[s]]))
                               * sim32))
        if cl is None:
            out[s, c] = int(acc)
            writes[s, c] += 1
        elif acc:
            cl[jj] = reps[s]
            writes[s, c] += 1
    return ((out if cl is None else cl), writes, lists,
            sum(t[0] == "thread" for t in tasks))


def assert_lists(lists):
    """Each block's list holds each surviving column once."""
    for lst, want in lists:
        assert sorted(lst.tolist()) == sorted(want)


# -- the tests ------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_lookahead_is_the_ripple_in_every_group(G):
    """((Gm | Pm) + Gm) ^ Pm with each group's top lane cleared == the
    carry chain group by group, over random exclusive generate and
    propagate masks, all-propagate groups led by a generating lane (a
    carry across the whole group), and propagates next to generates."""
    rng = np.random.default_rng(G)
    gen = rng.integers(0, 1 << 32, 64, dtype=np.uint64)
    prop = rng.integers(0, 1 << 32, 64, dtype=np.uint64) & ~gen
    lead = np.uint64(sum(1 << l for l in range(0, 32, G)))
    gen = np.concatenate([gen, [lead, lead, np.uint64(0x55555555)]])
    prop = np.concatenate([prop, [M32 & ~lead, np.uint64(0),
                                  np.uint64(0xAAAAAAAA)]])
    got = carries(gen, prop, G)
    assert np.array_equal(got, ripple(gen, prop, G))
    assert int(got[-3]) == FULL & ~int(lead)    # every lane but the leads


@pytest.mark.parametrize("slots", [8, 32, 64, 128])
def test_group_step_is_the_big_integer_step(slots):
    """One step of 32 / G groups side by side, K words a lane == (row +
    (row & m)) | (row & ~m) on each group's G x K words as one integer per
    run of live words, its top carry dropped: random words, words whose
    sum is all ones next to a generating word, and a lowest word that
    wraps under a group of all-ones sums (the carry runs to the top word,
    which adds it)."""
    G, K = lanes_words(slots)
    rng = np.random.default_rng(slots + 100)
    r = rng.integers(0, 1 << 32, (6, 32, K), dtype=np.uint64)
    m = rng.integers(0, 1 << 32, (6, 32, K), dtype=np.uint64)
    flat = lambda x: x.reshape(6, 32 // G, G * K)   # noqa: E731
    fr, fm = flat(r), flat(m)
    fr[1], fm[1] = FULL, 0                # every sum all ones ...
    fm[1, :, 0] = FULL                    # ... but each group's lowest wraps
    fr[1, :, -1] = 0xFFFF                 # and the top takes the carry in
    fr[2, :, 1::2], fm[2, :, 1::2] = FULL, 0   # propagates beside generates
    fr[2, :, ::2], fm[2, :, ::2] = 0xF0000000, 0xF0000000
    fr[3], fm[3] = M32 & ~np.uint64(1), 0
    fm[3, :, 0] = M32 & ~np.uint64(1)      # each lowest: 2^33 - 4, wraps
    live = rng.random((6, 32, K)) < 0.9
    live[1:4] = True
    on = np.ones((6, 32), bool)
    got = flat(step(r, m, live, on, G))
    fl = flat(live)
    for i in range(6):
        for g in range(32 // G):
            pieces, cur = [], []
            for j in range(G * K):
                if fl[i, g, j]:
                    cur.append(j)
                else:
                    pieces.append(cur)
                    cur = []
            pieces.append(cur)
            for pc in [pc for pc in pieces if pc]:
                val = sum(int(fr[i, g, j]) << (32 * k)
                          for k, j in enumerate(pc))
                msk = sum(int(fm[i, g, j]) << (32 * k)
                          for k, j in enumerate(pc))
                top = (1 << (32 * len(pc))) - 1
                want = (((val + (val & msk)) & top) | (val & ~msk)) & top
                have = sum(int(got[i, g, j]) << (32 * k)
                           for k, j in enumerate(pc))
                assert have == want, (i, g, pc)
            for j in range(G * K):
                if not fl[i, g, j]:
                    assert got[i, g, j] == fr[i, g, j]
    assert (got[1, :, -1] == 0x1FFFF).all()     # the carry reached it


# test_rows' shapes, the same in every case (JAX compiles _lcs_multi once):
# texts, queries, words and query bases
ROWS_SHAPE = (4, 12, 35, 160)


def _rows(texts, queries):
    """Plane rows [ROWS_SHAPE words] and codes [ROWS_SHAPE bases] of
    texts and queries (2-bit codes)."""
    _, _, W, L = ROWS_SHAPE
    tl = np.zeros((len(texts), W), np.uint64)
    th = np.zeros((len(texts), W), np.uint64)
    for i, t in enumerate(texts):
        pad = np.zeros(W * 32, np.uint64)
        pad[:len(t)] = t
        pb = pad.reshape(W, 32)
        tl[i] = ((pb & 1) << np.arange(32, dtype=np.uint64)).sum(1)
        th[i] = (((pb >> 1) & 1) << np.arange(32, dtype=np.uint64)).sum(1)
    qc = np.full((len(queries), L), 255, np.uint8)
    for i, q in enumerate(queries):
        qc[i, :len(q)] = q
    return tl, th, qc


@pytest.mark.parametrize("nets,slots", [
    ((1, 31, 32, 17), 1), ((33, 1, 64), 2), ((63, 64, 65, 17), 4),
    ((140, 96, 1, 65), 8), ((1000, 700), 32), ((1100, 140), 64),
    ((1100, 140), 8)])
def test_rows_match_row_lcs_and_jax(nets, slots):
    """The lane groups (and, for a text wider than the group, a warp a
    pair with the row in memory) against `_row_lcs` and JAX's
    `_lcs_multi`, every text against every query of nets 0, 1, 31-33,
    63-65 and the case's (cut to 160 bases: the first step's carry already
    runs the whole all-ones row), packed 32 / G a warp with the last warp
    part empty; each case at cluster_bucket's G x K but the last (1,100 bp
    at 8 words: a warp a pair)."""
    rng = np.random.default_rng(sum(nets) + slots)
    texts = [rng.integers(0, 4, n).astype(np.uint8) for n in nets]
    qnets = [0, 1, 31, 32, 33, 63, 64, 65, *(min(n, 160) for n in nets)]
    queries = [np.concatenate([t[:n], rng.integers(0, 4, max(0, n - len(t)))
                               ]).astype(np.uint8)
               for t, n in zip(texts * len(qnets), qnets)]
    for q in queries[2::3]:
        if len(q):
            q[rng.integers(0, len(q), 3)] = rng.integers(0, 4, 3)
    tl, th, qc = _rows(texts, queries)
    tn = np.array(nets)
    qn = np.array([len(q) for q in queries])
    if slots != 8 or max(nets) < 1000:
        assert lcs.cluster_bucket(max((n + 31) // 32 for n in nets)) == slots
    # texts and queries as one read set: the texts' rows, then the queries'
    low = np.concatenate([tl, np.zeros((len(queries), tl.shape[1]),
                                       np.uint64)])
    high = np.concatenate([th, np.zeros((len(queries), tl.shape[1]),
                                        np.uint64)])
    net = np.concatenate([tn, qn])
    codes = np.concatenate([np.full((len(texts), qc.shape[1]), 255,
                                    np.uint8), qc])
    off = len(texts)
    G, _ = lanes_words(slots)
    tasks = []
    for t, n in enumerate(nets):
        wide = n > 32 * slots             # a warp a pair, the row in memory
        tasks += [(wide, [None if b < 0 else (t, off + b, 0, t, b)
                          for b in sl])
                  for sl in drain(np.arange(len(queries)),
                                  32 if wide else G, 128)]
    got = np.full((len(texts), len(queries)), -1)
    for t, b, x in run_warps(slots, False, low, high, net, codes, tasks):
        got[t, b] = x
    # padded to ROWS_SHAPE's texts and queries with empty ones
    pt, pq = ROWS_SHAPE[0] - len(texts), ROWS_SHAPE[1] - len(queries)
    want = np.asarray(JC._lcs_multi(
        jnp.asarray(np.pad(tl, ((0, pt), (0, 0))).astype(np.uint32)),
        jnp.asarray(np.pad(th, ((0, pt), (0, 0))).astype(np.uint32)),
        jnp.asarray(np.pad(tn, (0, pt)), jnp.int32),
        jnp.asarray(np.pad(qc, ((0, pq), (0, 0)), constant_values=255)),
        jnp.asarray(np.pad(qn, (0, pq)), jnp.int32)))
    assert np.array_equal(got, want[:len(texts), :len(queries)])
    r = np.repeat(np.arange(len(texts)), len(queries))
    c = np.tile(np.arange(len(queries)), len(texts))
    plain = lcs._row_lcs(torch.from_numpy(tl[r].astype(np.int64)),
                         torch.from_numpy(th[r].astype(np.int64)),
                         torch.from_numpy(tn[r]), torch.from_numpy(qc[c]),
                         torch.from_numpy(qn[c])).numpy()
    assert np.array_equal(got.reshape(-1), plain)


def _cluster_arrays(reads):
    p = TC._prepare(reads, 0.9, 5)
    aux = TC._aux_dev(p, torch.device("cpu"))
    low = (aux["low"].numpy().view(np.uint32)).astype(np.uint64)
    high = (aux["high"].numpy().view(np.uint32)).astype(np.uint64)
    return p, aux, low, high


@pytest.mark.parametrize("case,chunk", [
    ("every read alone", 32), ("none gated", 64), ("all gated", 128),
    ("straddle", 256), ("straddle", 32), ("mixed", 64), ("wide", 128)])
def test_cluster_schedule_matches_plain_and_jax(case, chunk):
    """cluster_lcs.cu's launch emulated over chip_smoke's lcs_edge_reads
    cut to SHORT bases (nets 1, 31-33, 63-65, 140 and 300, noisy copies,
    one base, net 0) in blocks of `chunk` columns: each case's launch equals
    lcs_accept_plain (and, for "mixed" and "wide", JAX's _lcs_multi with
    the gate and the cutoff), every accept written once, each block's list
    each surviving column once.  "every read alone": a representative of
    each net up to 140 bases alone (G x K of 1, 2, 4 and 8); "mixed": nets 1,
    33, 65 and 140 in one launch under a random gate (G = 8); "straddle":
    140 bp copies as 300 jobs, so a block's list runs past its first
    warps and the last round's groups are part empty (in blocks of 64 or
    more on a card the launch fills, THREAD_MIN pairs or more: a thread a
    pair; blocks of 32 on a card it leaves idle: lane groups); "wide":
    the 300 bp representative (10 words) beside a 140 bp one at G x K =
    8, the wide one's block a warp a pair."""
    rng = np.random.default_rng(5)
    reads = [r[:SHORT] for r in lcs_edge_reads(rng)]
    if case == "straddle":
        reads = reads + [reads[7]] * 280          # base[:140]
    p, aux, low, high = _cluster_arrays(reads)
    N = len(reads)
    net = p.net_lengths.astype(np.int64)
    jobs = np.arange(3, N, dtype=np.int64)
    first = {n: int(np.nonzero(net == n)[0][0]) for n in (1, 33, 65, 140)}
    some = np.array([i for i in range(N) if 0 < net[i] <= 140][:7])
    if case == "every read alone":
        alone = {int(net[r]): r for r in range(N) if net[r] <= 140}
        launches = [(np.array([r]), None) for r in sorted(alone.values())]
    elif case == "none gated":
        launches = [(some, np.zeros((len(some), len(jobs)), np.uint8))]
    elif case == "all gated":
        launches = [(some, None)]
    elif case == "straddle":
        launches = [(np.array([first[140]]), None)]
    elif case == "mixed":
        reps = np.array([first[n] for n in (1, 33, 65, 140)])
        launches = [(reps, (rng.random((4, len(jobs))) < 0.5)
                     .astype(np.uint8))]
    else:
        launches = [(np.array([first[140], int(np.argmax(net))]), None)]
    codes = aux["codes"].numpy()
    assert codes.shape[1] % 16 == 0
    bcut = p.base_cutoff.astype(np.int64)
    buckets = set()
    for reps, gate in launches:
        slots = (8 if case == "wide"
                 else lcs.cluster_bucket(TC.words_needed(p, reps)))
        buckets.add(slots)
        out, writes, lists, threads = cluster_launch(
            low, high, net, codes, bcut, reps, jobs, gate, slots, chunk,
            TC.words_needed(p, reps), 1 if chunk >= 64 else WAVE)
        assert (threads > 0) == (case == "straddle" and chunk >= 64)
        assert (writes == 1).all()
        assert_lists(lists)
        tg = None if gate is None else torch.from_numpy(gate)
        want = lcs.lcs_accept_plain(
            aux["low"], aux["high"], aux["net"], aux["codes"], aux["bcut"],
            torch.from_numpy(reps.astype(np.int32)),
            torch.from_numpy(jobs.astype(np.int32)), tg).numpy()
        assert np.array_equal(out, want), (case, reps)
    assert buckets == ({1, 2, 4, 8} if case == "every read alone" else {8})
    if case in ("mixed", "wide"):
        # four representatives (the last repeated) in both: one compile
        r4 = np.pad(reps, (0, 4 - len(reps)), mode="edge")
        m = np.asarray(JC._lcs_multi(
            jnp.asarray(p.low[r4]), jnp.asarray(p.high[r4]),
            jnp.asarray(p.net_lengths[r4], jnp.int32),
            jnp.asarray(p.codes[jobs]),
            jnp.asarray(p.net_lengths[jobs], jnp.int32)))[:len(reps)]
        jax_acc = m > p.base_cutoff[jobs][None, :]
        if gate is not None:
            jax_acc &= gate != 0
        assert np.array_equal(out, jax_acc.astype(np.int64))
    if case == "none gated":
        assert not out.any() and all(len(x[0]) == 0 for x in lists)
    if case == "straddle":
        assert [len(x[0]) for x in lists] == [
            min(chunk, len(jobs) - c0) for c0 in range(0, len(jobs), chunk)]


def _ngia_arrays(reads):
    """The per-read arrays of TN._prepare (its order first) and the port's
    device arrays (codes padded) on the CPU."""
    _o, _l, net, words, low, high, codes = TN._prepare(reads)
    a = TN._device_arrays(net, words, low, high, codes, torch.device("cpu"))
    return (_o, net.astype(np.int64), words, low.astype(np.uint64),
            high.astype(np.uint64), a["codes"].numpy(), a, codes)


@functools.lru_cache(maxsize=None)
def _ngia_set(sim: float, cut: bool):
    """(reads, _ngia_arrays, JAX) of chip_smoke's ngia_edge_reads at
    `sim` (cut to SHORT bases where `cut`) and the family's first 240
    bases; JAX: accept_body of every read against every read where `cut`
    (one compile for all cases of a similarity), else None."""
    reads = ngia_edge_reads(np.random.default_rng(int(sim * 100)), sim)
    if cut:
        reads = [r[:SHORT] for r in reads]
    reads.append(reads[8][:240])               # the family's 240 bases
    arrays = _ngia_arrays(reads)
    if not cut:
        return reads, arrays, None
    every = np.arange(len(reads))
    return reads, arrays, _jax_window(sim, arrays, every, every)


def _jax_window(sim, arrays, reps, jobs) -> np.ndarray:
    """JAX's accept_body of reps against jobs over _ngia_arrays."""
    _o, net, words, low, high, codes, a, raw = arrays
    body = JN._spec_accept_factory(sim, low.shape[1], raw.shape[1],
                                   len(reps), -1)
    return np.asarray(body(jnp.asarray(reps.astype(np.int32)),
                           jnp.asarray(jobs.astype(np.int32)),
                           jnp.asarray(words), jnp.asarray(net, jnp.int32),
                           jnp.asarray(low.astype(np.uint32)),
                           jnp.asarray(high.astype(np.uint32)),
                           jnp.asarray(raw)))


def _plain_window(a, reps, jobs, sim):
    return lcs.banded_lcs_accept_plain(
        *[a[k] for k in ("words", "net", "low", "high", "codes")],
        torch.from_numpy(reps.astype(np.int32)),
        torch.from_numpy(jobs.astype(np.int32)), sim).numpy()


@pytest.mark.parametrize("sim,case,chunk", [
    (0.95, "long jobs", 32), (0.95, "all pass", 64), (0.95, "none pass", 32),
    (0.9, "wide", 128), (0.9, "fma", 32), (0.95, "every job", 64),
    (0.95, "mixed", 32), (0.95, "throughput", 128)])
def test_ngia_window_matches_plain_and_jax(sim, case, chunk):
    """ngia_lcs.cu's window emulated over chip_smoke's ngia_edge_reads
    (bands clipped at word 0 and the row's end, empty bands, reads under 3
    bases) in blocks of `chunk` columns: == banded_lcs_accept_plain and
    JAX's accept_body, every accept written once, each block's lists each
    surviving column once.  "long jobs": jobs of 240 bases and more
    (shift 3, G = 8); "all pass": the 300 bp family against itself; "none
    pass": representatives of under 3 bases; "wide": 1,100 bp against 100
    to SHORT bases at G x K = 64 (its bucket is 128): bands of 53 in lane
    groups, of 65 a warp a pair (every other case cuts the reads to
    SHORT bases); "fma": the NGIA_FMA_PAIRS; "every job":
    three representatives against all (G x K = 32); "mixed": the same at G x
    K = 8, the wider bands a warp a pair; "throughput": base[:300] against
    200 columns drawn from its family in blocks of 128 on a card the
    launch fills (a block of THREAD_MIN pairs or more runs them a thread
    each)."""
    rng = np.random.default_rng(len(case))
    reads, arrays, jax_all = _ngia_set(sim, case != "wide")
    kin = {reads[8]} | set(reads[10:20])       # base[:300] and its copies
    _o, net, words, low, high, codes, a, raw = arrays
    N = len(reads)
    order = np.arange(N)
    fam = [i for i in order if reads[_o[i]] in kin]
    if case == "long jobs":
        jobs = np.array([i for i in order if net[i] >= 240])
        reps = np.array(fam[:4])
    elif case == "all pass":
        reps = jobs = np.array(fam)
    elif case == "none pass":
        reps = np.array([i for i in order if net[i] < 3])
        jobs = order
    elif case == "wide":
        reps = np.array([int(np.argmax(net))])
        jobs = np.array([i for i in order if 100 <= net[i] <= SHORT])
    elif case == "fma":
        reps = np.array([i for i in order
                         if net[i] in [x[0] for x in NGIA_FMA_PAIRS]])
        jobs = order
    elif case == "throughput":
        reps = np.array(fam[:1])
        jobs = rng.choice(fam, 200)
    else:
        reps = np.array(fam[:3])
        jobs = order
    bucket = lcs.ngia_bucket(lcs.max_shift_of(net[reps], net[jobs], sim))
    slots = {"mixed": 8, "wide": 64}.get(case, bucket)
    out, writes, lists, threads = ngia_launch(
        words, net, low, high, codes, reps, jobs, sim, slots, chunk,
        wave=1 if case == "throughput" else WAVE)
    assert (threads > 0) == (case == "throughput")
    assert (writes == 1).all()
    assert_lists(lists)
    want = _plain_window(a, reps, jobs, sim)
    assert np.array_equal(out, want)
    jax_out = (_jax_window(sim, arrays, reps, jobs) if jax_all is None
               else jax_all[np.ix_(reps, jobs)])
    assert np.array_equal(out, jax_out)
    runs = sum(len(x[1]) for x in lists)
    if case == "none pass":
        assert runs == 0 and not out.any()
    if case == "all pass":
        assert runs == len(reps) * len(jobs)
    assert bucket == {"long jobs": 8, "wide": 128,
                      "every job": 32}.get(case, bucket)


@pytest.mark.parametrize("sim,chunk", [(0.95, 32), (0.9, 64)])
def test_ngia_rounds_match_plain_and_jax(sim, chunk):
    """Round mode emulated from cluster arrays with some reads clustered:
    == banded_lcs_accept_plain(cluster=) and JAX's round_body, each job
    written by one owner at most."""
    rng = np.random.default_rng(int(sim * 1000))
    reads, arrays, _ = _ngia_set(sim, True)
    _o, net, words, low, high, codes, a, raw = arrays
    N = len(reads)
    every = np.arange(N)
    round_step, _ = JN._round_step_factory(sim, low.shape[1], raw.shape[1])
    jarr = (jnp.asarray(words), jnp.asarray(net, jnp.int32),
            jnp.asarray(low.astype(np.uint32)),
            jnp.asarray(high.astype(np.uint32)), jnp.asarray(raw))
    for r in rng.choice(N, 2, replace=False):
        start = np.where(rng.random(N) < 0.3, rng.integers(0, N, N),
                         -1).astype(np.int64)
        start[r] = -1
        slots = lcs.ngia_bucket(lcs.max_shift_of(net[[r]], net, sim))
        got, writes, _, _ = ngia_launch(words, net, low, high, codes,
                                        np.array([r]), every, sim, slots,
                                        chunk, cluster=start)
        assert writes.max() <= 1
        cl = torch.from_numpy(start.astype(np.int32))
        lcs.banded_lcs_accept_plain(
            *[a[k] for k in ("words", "net", "low", "high", "codes")],
            torch.tensor([r], dtype=torch.int32),
            torch.from_numpy(every.astype(np.int32)), sim, cluster=cl)
        assert np.array_equal(got, cl.numpy())
        want = np.asarray(round_step(jnp.asarray(start, jnp.int32),
                                     jnp.int32(r), *jarr))
        assert np.array_equal(got, want)


def test_the_wrappers_sizes_are_the_kernels():
    """ops/lcs.py's warps a block and shared-row limit, which shape the
    global scratch, are the kernels' own constants; its buckets reach
    G x K = 128."""
    assert lcs.WARPS == CLUSTER["kThreads"] // 32 == NGIA["kThreads"] // 32
    assert lcs.SHARED_WORDS == CLUSTER["kSharedWords"] == \
        NGIA["kSharedWords"]
    assert lcs.CHUNK_MIN == 32 <= CLUSTER["kMaxChunk"] == NGIA["kMaxChunk"]
    assert lcs.CLUSTER_WORDS[-1] == lcs.NGIA_BANDS[-1] == 128


def test_compaction_scan_is_the_prefix_sum():
    """block_offset's shuffle scan == the exclusive prefix sum over a
    block's threads, counts of 0-32 and two counts packed in halves."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 33, CLUSTER["kThreads"])
    at, total = block_offset(counts)
    assert total == counts.sum()
    assert np.array_equal(at, np.concatenate([[0], np.cumsum(counts)[:-1]]))
    packed = counts + (rng.integers(0, 33, counts.size) << 16)
    at, total = block_offset(packed)
    assert np.array_equal(at & 0xFFFF, np.concatenate(
        [[0], np.cumsum(counts)[:-1]]))
    assert total >> 16 == (packed >> 16).sum()
