"""The walks of csrc/semiglobal_sw.cu and of local_sw.cu's packed 16-bit
modes, emulated in torch on the CPU, against the JAX package's scan
engine; and the launch arguments and the group rule that the wrappers
hand those kernels.

The emulations stand in for the kernels behind `cuda_align._call`, so
the launch helpers (`semiglobal_launch_args` / `launch_semiglobal`,
`local_launch_args` / `launch_local`) run as on the card.  They follow
the kernels' order of work, not their thread layout: SEMI_GLOBAL END
walks each pair only to its extents (columns < qlen, strips <=
ceil(tlen/8) - 1, nothing without a TAIL), and every cell outside them is
poisoned, so a read of one would show; TAIL_T is captured once per strip
at column qlen - 1 and the strips of a round of `group` are combined in
visit order; the 16-bit modes keep each strip's best (and END16's cell
per pair) and combine a round's strips in visit order, an earlier strip
keeping a tie.  The kernels themselves run only on the card
(tests/test_torch_cuda.py holds them to the plain versions)."""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu.core.scoring import AlgoType as JAlgo
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.core.scoring import SemiGlobalSkip as JSkip
from genomics_tpu.ops import scan_align as jscan
from genomics_tpu.runtime.dispatch import _pack_nibbles_np
from genomics_tpu_torch.core.scoring import (
    AlignmentParams,
    SemiGlobalSkip,
    params_from_jax,
)
from genomics_tpu_torch.ops import cuda_align

ACGT = np.array([1, 3, 7, 4], np.uint8)
N4 = 14
MINUS_INF = -32768
POISON = 1 << 20   # what a cell past the extents holds: any read shows
SKIPS = [JSkip.NONE, JSkip.QUERY, JSkip.TARGET, JSkip.BOTH]
COMBOS = list(itertools.product(SKIPS, SKIPS))
GROUPS = (4, 8)   # what the kernels take (cuda_align.split_group)


def _pairs(seed, B, Lq, Lt, n_rate=0.05, letters=4):
    """(q, t, qlen, tlen) numpy: half the pairs related, ragged lengths
    padded with N4, in-sequence Ns; pair 0 fills the bucket.  With
    letters=2 over A/C only, so that scores tie everywhere."""
    rng = np.random.default_rng(seed)
    q = ACGT[rng.integers(0, letters, (B, Lq))]
    t = ACGT[rng.integers(0, letters, (B, Lt))]
    k = min(Lq, Lt)
    q[::2, :k] = t[::2, :k]
    if n_rate:
        q[rng.random(q.shape) < n_rate] = N4
        t[rng.random(t.shape) < n_rate] = N4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    ql[0], tl[0] = Lq, Lt
    q[np.arange(Lq)[None, :] >= ql[:, None]] = N4
    t[np.arange(Lt)[None, :] >= tl[:, None]] = N4
    return q, t, ql, tl


def _rounds(n_strips, group):
    return [range(r, min(r + group, n_strips))
            for r in range(0, n_strips, group)]


def _semi_kernel(key, dev, mode, flags, group, Q, T, qlen, tlen, B, Lq, Lt,
                 match, mismatch, n_score, gapo, ge, gH, gE, score, qend,
                 tend, tb):
    """A stand-in for semiglobal_sw_launch on the CPU, over all pairs at
    once: END to each pair's extents (cells past them poisoned), TB over
    everything; TAIL_T's strips combined a round of `group` at a time."""
    assert group in GROUPS
    head_q, head_t, tail_q, tail_t = (bool(flags >> i & 1) for i in range(4))
    goe = gapo + ge
    Qi, Ti = Q.long(), T.long()
    ql, tl = qlen.long(), tlen.long()
    n_strips = Lt // 8
    s_bottom = (tl + 7) // 8 - 1
    if mode == 1:
        ncol = torch.full((B,), Lq)
        nstrip = torch.full((B,), n_strips)
    else:
        ncol = (torch.clamp(ql, max=Lq) if tail_q or tail_t
                else torch.zeros(B, dtype=torch.long))
        nstrip = torch.where(ncol > 0,
                             torch.clamp(s_bottom + 1, max=n_strips), 0)
    H = torch.full((Lq, B), POISON)
    E = torch.full((Lq, B), POISON)
    best_t, row_t = torch.full((B,), MINUS_INF), tl.clone()
    best_q, col_q = torch.full((B,), -(1 << 40)), torch.zeros(B, dtype=torch.long)
    mx = torch.maximum
    for strips in _rounds(n_strips, group):
        found = []
        for s in strips:
            rows = [s * 8 + c for c in range(8)]
            edge = [-(gapo + ge * r) for r in rows]
            hg = [torch.full((B,), (0 if head_t else edge[c]) - goe)
                  for c in range(8)]
            p = [torch.full((B,), 0 if head_t or rows[c] == 0 else edge[c])
                 for c in range(8)]
            f = [torch.full((B,), MINUS_INF) for _ in range(8)]
            sbest, srow = torch.full((B,), MINUS_INF), tl.clone()
            for j in range(Lq):
                act = (s < nstrip) & (j < ncol)
                qc = Qi[j]
                if s:
                    hup, e = H[j].clone(), E[j].clone()
                elif head_q:
                    hup, e = torch.zeros(B, dtype=torch.long), torch.zeros(B, dtype=torch.long)
                else:
                    hup = torch.full((B,), -(gapo + ge * j) if j else 0)
                    e = torch.full((B,), MINUS_INF)
                hab, phd, hs, word = hup, hup - goe, [], torch.zeros(B, dtype=torch.long)
                for c in range(8):
                    tcc = Ti[rows[c]]
                    sub = torch.where(qc == tcc, match, -mismatch)
                    sub = torch.where((qc == N4) | (tcc == N4), n_score, sub)
                    tmp = p[c] + sub
                    fc = mx(f[c] - ge, hg[c])
                    e = mx(e - ge, phd)
                    h = mx(mx(tmp, fc), e)
                    if mode == 1:
                        tg = tmp - gapo
                        d = torch.where(h == tmp, (sub < 0).long(),
                                        torch.where(h == fc, 3, 2))
                        word |= (d | (e >= tg).long() << 2
                                 | (fc >= tg).long() << 3) << (4 * c)
                    poison = lambda x: torch.where(act, x, POISON)
                    f[c], p[c], hg[c] = poison(fc), poison(hab), poison(h - goe)
                    hab, phd = h, h - goe
                    hs.append(h)
                e = torch.where(act, e, POISON)
                H[j], E[j] = torch.where(act, hs[7], POISON), e
                if mode == 1:
                    tb[s, j] = torch.from_numpy(
                        word.numpy().astype(np.uint32).view(np.int32))
                if tail_t:
                    at = act & (j == ql - 1)
                    for c in range(8):
                        upd = at & (rows[c] < tl) & (hs[c] > sbest)
                        sbest = torch.where(upd, hs[c], sbest)
                        srow = torch.where(upd, rows[c], srow)
                if tail_q:
                    upd = act & (s == s_bottom) & (j < ql) & (hs[7] > best_q)
                    best_q = torch.where(upd, hs[7], best_q)
                    col_q = torch.where(upd, j, col_q)
            found.append((sbest, srow))
        for sbest, srow in found:   # the round's strips in visit order
            upd = sbest > best_t
            best_t = torch.where(upd, sbest, best_t)
            row_t = torch.where(upd, srow, row_t)
    empty = (s_bottom < 0) & (ql > 0)   # an empty target's row reads 0
    best_q = torch.where(empty, 0, best_q)
    col_q = torch.where(empty, 0, col_q)
    sc = best_t if tail_t else torch.full((B,), MINUS_INF)
    qe = tl.clone()
    te = torch.where(best_t > MINUS_INF, row_t, ql) if tail_t else ql.clone()
    if tail_q:
        upd = best_q > sc
        sc = torch.where(upd, best_q, sc)
        qe = torch.where(upd, col_q, qe)
        te = torch.where(qe != tl, ql, te)
    for out, x in ((score, sc), (qend, qe), (tend, te)):
        out.copy_(x.int())


def _local16_kernel(key, dev, mode, with_n, group, Q, T, B, Lq, Lt, match,
                    mismatch, n_score, goe, ge, gH, gE, score, qend, tend, tb):
    """A stand-in for local_sw_launch's SCORE16 / END16 on the CPU, over
    all pairs at once (an odd B's last pair partnered with the 16/17
    dummy): f seeded at -4096, each strip's best kept apart (strictly
    greater replaces) and a round of `group` strips combined in visit
    order, an earlier strip keeping a tie."""
    assert key in ("local_sw.score16", "local_sw.end16") and mode in (4, 5)
    assert group in GROUPS
    ends = mode == 5
    Qi, Ti = Q.long(), T.long()
    if B % 2:
        Qi = torch.cat([Qi, torch.full((Lq, 1), 16)], 1)
        Ti = torch.cat([Ti, torch.full((Lt, 1), 17)], 1)
    n = Qi.shape[1]
    zero = lambda: torch.zeros(n, dtype=torch.long)
    H, E = torch.zeros((Lq, n), dtype=torch.long), torch.zeros((Lq, n), dtype=torch.long)
    best, qe, te = zero(), zero(), zero()
    mx = torch.maximum
    for strips in _rounds(Lt // 8, group):
        found = []
        for s in strips:
            hp = [zero() for _ in range(8)]
            f = [torch.full((n,), -4096) for _ in range(8)]
            sbest, sq, st = zero(), zero(), zero()
            diag0 = zero()
            for j in range(Lq):
                qc = Qi[j]
                hcol, e = (H[j].clone(), E[j].clone()) if s else (zero(), zero())
                diag = diag0
                for c in range(8):
                    tcc = Ti[s * 8 + c]
                    sub = torch.where(qc == tcc, match, -mismatch)
                    if ends:
                        sub = torch.where((qc == N4) | (tcc == N4), n_score, sub)
                    tmp = diag + sub
                    h = mx(mx(tmp, f[c]), mx(e, zero()))
                    upd = h > sbest
                    sbest = torch.where(upd, h, sbest)
                    sq = torch.where(upd, j, sq)
                    st = torch.where(upd, s * 8 + c, st)
                    f[c] = mx(f[c] - ge, tmp - goe)
                    e = mx(e - ge, tmp - goe)
                    diag, hp[c] = hp[c], h
                diag0 = hcol
                H[j], E[j] = hp[7], e
            found.append((sbest, sq, st))
        for sbest, sq, st in found:   # the round's strips in visit order
            upd = sbest > best
            best = torch.where(upd, sbest, best)
            qe = torch.where(upd, sq, qe)
            te = torch.where(upd, st, te)
    assert int(best.max()) < (1 << 15)   # the int16 range the wrapper checks
    score.copy_(best[:B].int())
    if ends:
        qend.copy_(qe[:B].int())
        tend.copy_(te[:B].int())


def _equal(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"field {k}")


def _jax_semiglobal(q, t, ql, tl, jp, head, tail, with_tb=False):
    return jscan.semiglobal_align_batch(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl), jp,
        head=head, tail=tail, with_tb=with_tb)


def _semiglobal_launch(q, t, ql, tl, jp, head, tail, group, with_tb=False):
    args = cuda_align.semiglobal_launch_args(
        torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy()),
        torch.from_numpy(ql), torch.from_numpy(tl), params_from_jax(jp),
        SemiGlobalSkip(head.value), SemiGlobalSkip(tail.value), with_tb,
        group=group)
    return cuda_align.launch_semiglobal(args)


@pytest.mark.parametrize("head,tail", COMBOS, ids=lambda s: s.name)
def test_semiglobal_end_to_the_extents_matches_jax(monkeypatch, head, tail):
    """END walked only to each pair's extents (the cells past them
    poisoned) gives the JAX scan engine's full-walk score and ends under
    every HEAD x TAIL, on ragged lengths with Ns and an n_penalty on half
    the combinations; the threads per pair alternate between 4 and 8."""
    monkeypatch.setattr(cuda_align, "_call", _semi_kernel)
    k = head.value * 4 + tail.value
    jp = JParams(algo=JAlgo.SEMI_GLOBAL, n_penalty=2 if k % 2 else None)
    q, t, ql, tl = _pairs(50 + k, 24, 20, 40)
    want = _jax_semiglobal(q, t, ql, tl, jp, head, tail)
    got = _semiglobal_launch(q, t, ql, tl, jp, head, tail, GROUPS[k % 2])
    _equal(got[:3], want[:3])
    assert got[3] is None


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("head,tail", [(s, s) for s in SKIPS],
                         ids=lambda s: s.name)
def test_semiglobal_tb_walks_everything_and_matches_jax(monkeypatch, head,
                                                        tail, group):
    """TB walks every column and strip: every word of the cube equals the
    JAX scan engine's packed nibbles, beside the score and ends, under
    the four skips the engine's traceback takes, at both groups."""
    monkeypatch.setattr(cuda_align, "_call", _semi_kernel)
    jp = JParams(algo=JAlgo.SEMI_GLOBAL, n_penalty=1)
    q, t, ql, tl = _pairs(60 + head.value, 12, 17, 24)
    want = _jax_semiglobal(q, t, ql, tl, jp, head, tail, with_tb=True)
    got = _semiglobal_launch(q, t, ql, tl, jp, head, tail, group,
                             with_tb=True)
    _equal(got[:3], want[:3])
    words = _pack_nibbles_np(np.asarray(want.tb)).transpose(1, 2, 0)
    np.testing.assert_array_equal(got[3].numpy(), words)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("tail", [JSkip.TARGET, JSkip.BOTH],
                         ids=lambda s: s.name)
def test_semiglobal_tail_t_ties_keep_the_first_row(monkeypatch, group, tail):
    """Over two letters at match = mismatch = gap_extend = 1 (gap_open
    0), column qlen - 1 ties across rows and strips: TAIL_T's column-level
    capture and the visit-order combine of a round's strips keep the
    first row, as the JAX scan engine does (TAIL_Q on top for BOTH)."""
    monkeypatch.setattr(cuda_align, "_call", _semi_kernel)
    jp = JParams(algo=JAlgo.SEMI_GLOBAL, match=1, mismatch=1, gap_open=0,
                 gap_extend=1)
    q, t, ql, tl = _pairs(70 + group, 32, 9, 64, n_rate=0.0, letters=2)
    want = _jax_semiglobal(q, t, ql, tl, jp, JSkip.NONE, tail)
    got = _semiglobal_launch(q, t, ql, tl, jp, JSkip.NONE, tail, group)
    _equal(got[:3], want[:3])


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("tail", [JSkip.QUERY, JSkip.BOTH],
                         ids=lambda s: s.name)
def test_semiglobal_empty_targets_match_jax(monkeypatch, group, tail):
    """Pairs with an empty target (tlen 0) beside full ones: TAIL_Q's row
    of an empty target reads 0, leftmost at column 0, as the JAX scan
    engine's does, and no pair takes a neighbour's TAIL_Q maximum; END
    and TB, HEAD NONE and BOTH."""
    monkeypatch.setattr(cuda_align, "_call", _semi_kernel)
    jp = JParams(algo=JAlgo.SEMI_GLOBAL)
    q, t, ql, tl = _pairs(75 + group, 12, 11, 32)
    tl[0] = 32                        # pair 0's TAIL_Q row in strip 3
    for k in (1, 2, 5, 9):
        tl[k] = 0
        t[k] = N4
    for head, with_tb in itertools.product([JSkip.NONE, JSkip.BOTH],
                                           [False, True]):
        want = _jax_semiglobal(q, t, ql, tl, jp, head, tail, with_tb)
        got = _semiglobal_launch(q, t, ql, tl, jp, head, tail, group, with_tb)
        _equal(got[:3], want[:3])
        assert (np.asarray(want.score)[[1, 2, 5, 9]] == 0).all()


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("mode", ["score16", "end16"])
def test_local16_split_walk_matches_jax(monkeypatch, mode, group):
    """The 16-bit modes' walk with `group` strips to a round, each strip's
    best combined in visit order, equals the JAX scan engine's score (and
    END16's ends: the earliest cell in strip order) over two letters at
    match = mismatch = gap_extend = 1, where every cell ties, and on odd
    B (the last pair partnered with the 16/17 dummy)."""
    monkeypatch.setattr(cuda_align, "_call", _local16_kernel)
    jp = JParams(match=1, mismatch=1, gap_open=0, gap_extend=1,
                 n_penalty=1 if mode == "end16" else None)
    q, t, _, _ = _pairs(80 + group, 33, 13, 40,
                        n_rate=0.03 if mode == "end16" else 0.0, letters=2)
    Q, T = torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy())
    if mode == "score16":   # has_n=False: the pads become the sentinels
        Q, T = (cuda_align._pads_to_sentinels(x, c) for x, c in ((Q, 16),
                                                                 (T, 17)))
    p = params_from_jax(jp)
    args = cuda_align.local_launch_args(mode, Q, T, p, mode == "end16",
                                        group=group)
    got = cuda_align.launch_local(args)
    want = jscan.local_align_batch(jnp.asarray(q), jnp.asarray(t), jp)
    n = 3 if mode == "end16" else 1
    _equal(got[:n], want[:n])


@pytest.mark.parametrize("group", GROUPS)
def test_local16_split_walk_keeps_the_earliest_cell_past_a_round(group):
    """Every row of pair 0 reaches its best, 1, at column 3: at each
    group, rounds of strips included, the first row's cell is kept; pair
    1's last strip beats it and takes the best."""
    B, Lq, Lt = 2, 8, 32
    t = np.full((B, Lt), ACGT[1], np.uint8)
    q = np.full((B, Lq), ACGT[0], np.uint8)
    q[:, 3] = ACGT[1]           # one match per row: best 1 on every row
    t[1, 24:] = ACGT[0]         # pair 1: strip 3 matches 7 of 8 columns
    p = AlignmentParams(match=1, mismatch=1, gap_open=0, gap_extend=1)
    want = jscan.local_align_batch(jnp.asarray(q), jnp.asarray(t),
                                   JParams(match=1, mismatch=1, gap_open=0,
                                           gap_extend=1))
    score, qend, tend = (torch.zeros(B, dtype=torch.int32) for _ in range(3))
    _local16_kernel("local_sw.end16", None, 5, 1, group,
                    torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy()),
                    B, Lq, Lt, p.match, p.mismatch, 0, p.gap_oe, p.gap_extend,
                    None, None, score, qend, tend, None)
    _equal([score, qend, tend], want[:3])
    assert int(want.target_end[0]) == 0 and int(want.score[0]) == 1
    assert int(want.target_end[1]) >= 24


@pytest.mark.parametrize("with_tb", [False, True], ids=["end", "tb"])
def test_semiglobal_launch_args_lay_out_each_mode(with_tb):
    """One value per C parameter but the stream: the mode, the skip flags,
    the threads per pair, the time-major inputs, the lengths, the sizes
    and scores, the [Lq, B] carries and the outputs last, the sqb cube
    only with traceback."""
    B, Lq, Lt = 7, 9, 16
    q, t, ql, tl = _pairs(90, B, Lq, Lt)
    Q, T = torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy())
    p = AlignmentParams(n_penalty=3)
    args = cuda_align.semiglobal_launch_args(
        Q, T, torch.from_numpy(ql), torch.from_numpy(tl), p,
        SemiGlobalSkip.QUERY, SemiGlobalSkip.BOTH, with_tb, group=8)
    sig = cuda_align._SIGNATURES["semiglobal_sw", "semiglobal_sw_launch"]
    assert len(args) + 1 == len(sig)
    assert args[:3] == (int(with_tb), 0b1101, 8)
    assert args[3].data_ptr() == Q.data_ptr()
    assert args[4].data_ptr() == T.data_ptr()
    assert torch.equal(args[5], torch.from_numpy(ql))
    assert torch.equal(args[6], torch.from_numpy(tl))
    assert args[7:15] == (B, Lq, Lt, p.match, p.mismatch, -3, p.gap_open,
                          p.gap_extend)
    assert all(x.shape == (Lq, B) and x.dtype == torch.int32
               for x in args[15:17])
    score, qend, tend, tb = args[-4:]
    assert all(x.shape == (B,) and x.dtype == torch.int32
               for x in (score, qend, tend))
    assert (tb is None) == (not with_tb)
    if with_tb:
        assert tb.shape == (Lt // 8, Lq, B) and tb.dtype == torch.int32


@pytest.mark.parametrize("mode", ["score", "end", "tb", "score16", "end16"])
def test_local_launch_args_take_a_group_only_in_16_bit_modes(mode):
    """The threads per pair of the int32 modes is 1 whatever is asked; the
    16-bit modes take the group they are given, per two pairs, over
    [Lq, ceil(B/2)] carries."""
    B, Lq, Lt = 7, 9, 16
    q, t, _, _ = _pairs(91, B, Lq, Lt)
    Q, T = torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy())
    args = cuda_align.local_launch_args(mode, Q, T, AlignmentParams(), True,
                                        group=4)
    assert args[2] == (4 if mode.endswith("16") else 1)
    assert args[13].shape == (Lq, 4 if mode.endswith("16") else B)


@pytest.mark.parametrize("sms", [1, 66, 132, 144])
def test_split_group_is_a_rule_on_the_launch_and_the_sm_count(sms):
    """4 threads per pair (pair pair) where 4 n give the card
    SPLIT_MIN_THREADS_PER_SM threads an SM, else 8; more SMs or fewer
    pairs never take fewer threads per pair."""
    need = cuda_align.SPLIT_MIN_THREADS_PER_SM * sms
    prev = 8
    for n in (1, 100, 1691, 3382, 8309, 12671, 12672, 16618, 32768, 65536,
              1 << 20):
        g = cuda_align.split_group(n, sms)
        assert g in GROUPS and g <= prev
        assert g == (4 if 4 * n >= need else 8)
        assert g >= cuda_align.split_group(n, max(sms // 2, 1))
        prev = g
    assert cuda_align.split_group(1, sms) == 8
    assert cuda_align.split_group(1 << 20, sms) == 4


@pytest.mark.parametrize("kernel", ["local_start", "semiglobal_sw",
                                    "score16", "end16"])
def test_launch_args_default_to_split_group(monkeypatch, kernel):
    """Without a group, local_start, semiglobal_sw and the 16-bit
    local_sw modes take split_group's on the launch's card: of B pairs,
    or of ceil(B/2) pair pairs in the 16-bit modes; 8 on one side of the
    rule's boundary and 4 on the other."""
    monkeypatch.setattr(cuda_align, "_sm_count", lambda index: 2)
    p = AlignmentParams()
    seen = set()
    for B in (1, 2, 191, 192, 193, 383, 384, 385):
        q, t, ql, tl = (torch.from_numpy(x) for x in _pairs(92, B, 9, 16))
        Q, T = q.T.contiguous(), t.T.contiguous()
        if kernel == "local_start":
            args = cuda_align.local_start_launch_args(Q, T, ql, p)
            got, n = args[14], B
        elif kernel == "semiglobal_sw":
            args = cuda_align.semiglobal_launch_args(Q, T, ql, tl, p)
            got, n = args[2], B
        else:
            args = cuda_align.local_launch_args(kernel, Q, T, p,
                                                kernel == "end16")
            got, n = args[2], (B + 1) // 2
        assert got == cuda_align.split_group(n, 2)
        seen.add(got)
    assert seen == set(GROUPS)
