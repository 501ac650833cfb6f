"""Plain GASAL2 LOCAL and GLOBAL alignment with traceback to byte-CIGARs:
the reference the engine cells and `call_variants` are judged by.

A frozen copy of the port's plain versions (`genomics_tpu_torch/ops/
scan_align.py` local_align_batch / global_align_batch and
`ops/tb_walk.py` tb_walk_plain / rle_cigar / cigars_from_walk), which
follow CDP/GASAL2's kernels and its decoder get_tb.h.  It imports
nothing of the port, and it runs on the real pairs, padded only to the
block's longest pair (not to the engine's buckets).

Every DP value passes through `sat`: the identity, or for the control
(`bits=8`) a clamp to signed 8-bit cells, the step below the 16-bit
cells that these scores need (SSW's and parasail's 8-bit first pass
without its overflow re-run).
"""
from __future__ import annotations

import numpy as np
import torch

N4 = 14
MINUS_INF = -32768
NEG_BIG = -(1 << 28)
KEY_MAX = (1 << 31) - 1
STOP = 255
CIGAR_OPS = "MXDI"


def encode(seqs, width: int) -> np.ndarray:
    """ASCII sequences -> [B, width] uint8 4-bit codes (ord & 15), N4
    padded."""
    out = np.full((len(seqs), width), N4, np.uint8)
    for k, s in enumerate(seqs):
        b = s.encode() if isinstance(s, str) else s
        out[k, :len(b)] = np.frombuffer(b, np.uint8) & 0xF
    return out


def saturate(bits: int | None):
    """The identity, or a clamp to signed `bits`-bit cells."""
    if bits is None:
        return lambda x: x
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return lambda x: x.clamp(lo, hi)


def _fscan(g, seed, ge):
    """f[0] = seed; f[j] = max(g[j-1], f[j-1] - ge), as a cummax."""
    B, L = g.shape
    j = torch.arange(L, dtype=torch.int32, device=g.device)
    cm = torch.cummax(g + (j + 1) * ge, dim=1).values
    shifted = torch.cat([torch.full((B, 1), NEG_BIG, dtype=torch.int32,
                                    device=g.device), cm[:, :-1]], dim=1)
    return torch.maximum(seed[:, None], shifted) - j * ge


def _sub(qi, q_is_n, tbase, match, mismatch, global_macro):
    """Substitution scores of one target base against every query column:
    the local macro scores N as 0, the global macro as a base."""
    sub = (qi == tbase).to(torch.int32) * (match + mismatch) - mismatch
    if global_macro:
        return sub
    return sub.masked_fill(q_is_n | (tbase == N4), 0)


def _nibble(sub, tmp, h, f_used, e_used, goe, ge):
    """dir | e_ext << 2 | f_ext << 3 of one row."""
    d = torch.where(h == tmp, (sub < 0).to(torch.int32),
                    2 + (h == f_used).to(torch.int32))
    f_ext = (tmp - goe <= f_used - ge).to(torch.int32)
    e_ext = (tmp - goe <= e_used - ge).to(torch.int32)
    return d | (e_ext << 2) | (f_ext << 3)


def _pack(tb, word, nib, i):
    word = nib if i % 8 == 0 else word | (nib << (4 * (i % 8)))
    if i % 8 == 7:
        tb[i >> 3] = word.T
    return word


def local_dp(q, t, s, with_tb, sat):
    """LOCAL score, ends and the sqb cube [Lt//8, Lq, B]; s = (match,
    mismatch, gap_open, gap_extend).  Ends follow GASAL2's strip visit
    order: among the best cells, the least ((i >> 3) * Lq + j) * 8 +
    (i & 7)."""
    match, mismatch, gapo, ge = s
    goe = gapo + ge
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    qi, ti = q.to(i32), t.to(i32)
    q_is_n = qi == N4
    jidx = torch.arange(Lq, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    seed0 = torch.zeros(B, dtype=i32, device=dev)
    H = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.zeros((B, Lq), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bkey = torch.full((B,), KEY_MAX, dtype=i32, device=dev)
    tb = torch.empty((Lt // 8, Lq, B), dtype=i32, device=dev) if with_tb \
        else None
    word = None
    for i in range(Lt):
        sub = _sub(qi, q_is_n, ti[:, i:i + 1], match, mismatch, False)
        tmp = sat(torch.cat([zcol, H[:, :-1]], dim=1) + sub)
        tmpg = sat(tmp - goe)
        f_used = sat(_fscan(tmpg, seed0, ge))
        h = torch.maximum(torch.maximum(tmp, f_used), E.clamp_min(0))
        rh = h.amax(dim=1)
        row_j = torch.where(h == rh[:, None], jidx, Lq).amin(dim=1)
        rkey = ((i >> 3) * Lq + row_j) * 8 + (i & 7)
        take = (rh > best) | ((rh == best) & (rkey < bkey))
        best = torch.where(take, rh, best)
        bkey = torch.where(take, rkey, bkey)
        if with_tb:
            word = _pack(tb, word, _nibble(sub, tmp, h, f_used, E, goe, ge),
                         i)
        E = sat(torch.maximum(tmpg, E - ge))
        H = h
    cell = bkey >> 3
    zero = best == 0
    qend = torch.where(zero, 0, cell % Lq)
    tend = torch.where(zero, 0, (cell // Lq) * 8 + (bkey & 7))
    return best, qend.to(i32), tend.to(i32), tb


def global_dp(q, t, qlen, tlen, s, sat):
    """GLOBAL score H(tlen-1, qlen-1) and the sqb cube, with global.h's
    boundaries (H(-1, j) = 0 at j = 0 else -(gapo + ge j); H(i, -1) =
    -(gapo + ge (i+1)); E(0, j) = f(i, -1) = MINUS_INF)."""
    match, mismatch, gapo, ge = s
    goe = gapo + ge
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    qi, ti = q.to(i32), t.to(i32)
    q_is_n = qi == N4
    jidx = torch.arange(Lq, dtype=i32, device=dev)
    last_j = (qlen - 1).long()[:, None]
    seed_inf = torch.full((B,), MINUS_INF, dtype=i32, device=dev)
    H = sat(torch.where(jidx == 0, 0, -(gapo + ge * jidx)).expand(B, Lq))
    E = sat(torch.full((B, Lq), MINUS_INF, dtype=i32, device=dev))
    score = torch.zeros(B, dtype=i32, device=dev)
    tb = torch.empty((Lt // 8, Lq, B), dtype=i32, device=dev)
    word = None
    for i in range(Lt):
        sub = _sub(qi, q_is_n, ti[:, i:i + 1], match, mismatch, True)
        diag0 = torch.full((B, 1), 0 if i == 0 else -(gapo + ge * i),
                           dtype=i32, device=dev)
        tmp = sat(torch.cat([sat(diag0), H[:, :-1]], dim=1) + sub)
        tmpg = sat(tmp - goe)
        f_used = sat(_fscan(tmpg, seed_inf, ge))
        h = torch.maximum(torch.maximum(tmp, f_used), E)
        score = torch.where(tlen == i + 1, h.gather(1, last_j)[:, 0], score)
        word = _pack(tb, word, _nibble(sub, tmp, h, f_used, E, goe, ge), i)
        E = sat(torch.maximum(tmpg, E - ge))
        H = h
    return score, tb


def walk(tb_sqb, score, qend, tend, s, local):
    """get_tb.h's walk from (tend, qend) over the cube: the op stream
    [Lq + Lt, B] (0 M, 1 X, 2 D, 3 I, 255 stop) and the final (j, i).
    LOCAL stops where the rebuilt score reaches `score`."""
    match, mismatch, gapo, ge = s
    goe = gapo + ge
    Lt8, Lq, B = tb_sqb.shape
    Lt = Lt8 * 8
    dev = tb_sqb.device
    i64 = torch.int64
    flat = tb_sqb.reshape(-1)
    barange = torch.arange(B, device=dev)
    i, j, total = tend.to(i64), qend.to(i64), score.to(i64)
    op_shift = torch.zeros(B, dtype=i64, device=dev)
    op_select = torch.full((B,), 3, dtype=i64, device=dev)
    curr = torch.zeros(B, dtype=i64, device=dev)
    prev_op = torch.zeros(B, dtype=i64, device=dev)
    active = (i >= 0) & (j >= 0)
    ops = torch.full((Lq + Lt, B), STOP, dtype=torch.uint8, device=dev)
    for step in range(Lq + Lt):
        if step % 16 == 0 and not bool(active.any()):
            break
        inb = (i < Lt) & (j < Lq)
        idx = ((i >> 3).clamp(0, Lt8 - 1) * Lq + j.clamp(0, Lq - 1)) * B \
            + barange
        word = flat[idx].to(i64)
        cell = torch.where(inb, (word >> (4 * (i & 7))) & 0xF, 0)
        op = (cell >> op_shift) & op_select
        sel3 = op_select == 3
        fill = torch.where((op == 0) | sel3, op, op_shift)
        reset = (op == 0) | ((op == 1) & sel3)
        to_gap = (op >= 2) & sel3
        new_shift = torch.where(reset, 0, torch.where(to_gap, op, op_shift))
        new_select = 1 + 2 * reset.to(i64)
        ops[step] = torch.where(active, fill, STOP).to(torch.uint8)
        move = active
        if local:
            gap_cost = -ge - (goe - ge) * (prev_op != fill).to(i64)
            sub_cost = match - (match + mismatch) * (fill == 1).to(i64)
            curr_new = curr + torch.where(fill >= 2, gap_cost, sub_cost)
            curr = torch.where(active, curr_new, curr)
            prev_op = torch.where(active, fill, prev_op)
            move = active & (curr_new != total)
        i = i - (move & (fill != 3)).to(i64)
        j = j - (move & (fill != 2)).to(i64)
        op_shift = torch.where(active, new_shift, op_shift)
        op_select = torch.where(active, new_select, op_select)
        active = move & (i >= 0) & (j >= 0)
    return ops.cpu().numpy(), j.cpu().numpy(), i.cpu().numpy()


def _runs(row) -> list[int]:
    """One pair's op stream -> its CIGAR bytes (op | count << 2, runs of
    at most 63), in walk order."""
    stop = np.flatnonzero(row == STOP)
    row = row[:stop[0]] if len(stop) else row
    out = []
    if not len(row):
        return out
    change = np.flatnonzero(np.diff(row)) + 1
    for a, b in zip(np.concatenate([[0], change]),
                    np.concatenate([change, [len(row)]])):
        n = int(b - a)
        while n > 0:
            out.append(int(row[a]) | (min(n, 63) << 2))
            n -= 63
    return out


def _pad(n: int, op: int) -> list[int]:
    out = []
    while n > 0:
        out.append(op | (min(n, 63) << 2))
        n -= 63
    return out


def cigar_string(cigar) -> str:
    """CIGAR bytes (walk order) -> text in alignment order."""
    parts = []
    for b in reversed(list(cigar)):
        if b >> 2:
            parts.append(f"{b >> 2}{CIGAR_OPS[b & 3]}")
    return "".join(parts)


def _blocks(n, size):
    return [range(a, min(a + size, n)) for a in range(0, n, size)]


def align_local(queries, targets, scoring, with_tb=True, device="cpu",
                bits=None, block=4096):
    """LOCAL over (query, target) pairs -> a list of dicts: score,
    query_end, target_end, query_start, target_start, cigar (bytes, walk
    order).  Score-only (with_tb=False) gives the score alone, as the
    engine's score kernels do (ends, starts and CIGAR 0 / empty)."""
    sat = saturate(bits)
    out = []
    for rows in _blocks(len(queries), block):
        qs = [queries[k] for k in rows]
        ts = [targets[k] for k in rows]
        Lq = max(len(x) for x in qs)
        Lt = -(-max(len(x) for x in ts) // 8) * 8
        q = torch.from_numpy(encode(qs, Lq)).to(device)
        t = torch.from_numpy(encode(ts, Lt)).to(device)
        best, qend, tend, tb = local_dp(q, t, scoring, with_tb, sat)
        score = best.cpu().numpy()
        if not with_tb:
            out += [dict(score=int(x), query_end=0, target_end=0,
                         query_start=0, target_start=0, cigar=b"")
                    for x in score]
            continue
        ops, qfin, tfin = walk(tb, best, qend, tend, scoring, local=True)
        qe, te = qend.cpu().numpy(), tend.cpu().numpy()
        for k in range(len(rows)):
            out.append(dict(score=int(score[k]), query_end=int(qe[k]),
                            target_end=int(te[k]),
                            query_start=int(qfin[k]),
                            target_start=int(tfin[k]),
                            cigar=bytes(_runs(ops[:, k]))))
    return out


def align_global(queries, targets, scoring, device="cpu", bits=None,
                 block=4096):
    """GLOBAL with traceback -> a list of dicts: score and cigar (bytes,
    walk order: the walk's runs from one cell past the end, get_tb.h's
    start, then the leading D pad of i + 1 rows and the I pad of j + 1
    columns).  Both sequences are padded with at least one N4 past the
    block's longest, so the walk's first cell is a pad cell, as it is in
    every engine bucket wider than the pair."""
    sat = saturate(bits)
    out = []
    for rows in _blocks(len(queries), block):
        qs = [queries[k] for k in rows]
        ts = [targets[k] for k in rows]
        Lq = max(len(x) for x in qs) + 1
        Lt = -(-(max(len(x) for x in ts) + 1) // 8) * 8
        q = torch.from_numpy(encode(qs, Lq)).to(device)
        t = torch.from_numpy(encode(ts, Lt)).to(device)
        qlen = torch.tensor([len(x) for x in qs], dtype=torch.int32,
                            device=device)
        tlen = torch.tensor([len(x) for x in ts], dtype=torch.int32,
                            device=device)
        score, tb = global_dp(q, t, qlen, tlen, scoring, sat)
        ops, qfin, tfin = walk(tb, score, qlen, tlen, scoring, local=False)
        sc = score.cpu().numpy()
        for k in range(len(rows)):
            cig = _runs(ops[:, k]) + _pad(int(tfin[k]) + 1, 2) \
                + _pad(int(qfin[k]) + 1, 3)
            out.append(dict(score=int(sc[k]), cigar=bytes(cig)))
    return out
