"""Plain PyTorch second-best and WITH_START engines: the references the
SECOND mode of `csrc/local_sw.cu`, `csrc/local_start.cu` and
`csrc/semiglobal_start.cu` are held to.

A port of `genomics_tpu/ops/scan_align_full.py`, same names and
interfaces, on torch tensors on the input's device.  These features need
cell-level visit-order state (the reference updates running maxima per
cell inside 8-row strips, column-major), so the local engines scan the
target in strips of 8 rows and flatten each strip to the visit order
[B, Lq*8], where the running quantities become cummax prefix scans:

- second best (local_kernel_template.h:147-163): a cell is a candidate
  iff h < runmax_inclusive(cell); second = max over candidates, its
  target row = first candidate in visit order attaining it; the query-end
  quirk (prev_maxHH_second compared against the PRIMARY max at column
  granularity, :414-419) is replicated via per-column-segment reductions.
- local WITH_START (:441-511): the reverse DP runs on the word-aligned
  reversed sequences (plain reversal of the first ceil(end/8)*8 bases);
  the early exit at column-segment granularity is emulated by keyed
  selection: with R = cell-level running max, k* = first key with
  R >= fwd_score, Kend = k*'s segment end, the recorded cell is the first
  attainment of max(h | key <= Kend).  The reference's skewed
  target-start coordinate is reproduced from (strip, row).
- semiglobal WITH_START (semiglobal_kernel_template.h:227-384): the
  reverse semiglobal DP on the plain-reversed sequences, the target
  shifted to start at strip gend_reg, with the early exit at strip
  granularity (its max only updates at column read_len-1).

`local_align_with_start` and `semiglobal_align_with_start` run the
forward pass and then the start pass through `ops.cuda_align`, so on
CUDA tensors both passes are the kernels and the reversed inputs are
built by index math on the card; on CPU tensors they are these plain
versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from genomics_tpu_torch.core.encoding import N4
from genomics_tpu_torch.core.scoring import AlignmentParams, SemiGlobalSkip
from genomics_tpu_torch.ops.scan_align import (
    MINUS_INF,
    NEG_BIG,
    _fscan,
    _sub_scores,
)

INT_MAX = (1 << 31) - 1


class SecondResult(NamedTuple):
    score: torch.Tensor              # [B] int32
    query_end: torch.Tensor
    target_end: torch.Tensor
    score_second: torch.Tensor
    query_end_second: torch.Tensor
    target_end_second: torch.Tensor


def _i32(x: torch.Tensor, dev) -> torch.Tensor:
    return x.to(device=dev, dtype=torch.int32)


def _strip_core(qi, q_is_n, H, E, tstrip, params: AlignmentParams):
    """Run 8 rows of the local DP (f seeded 0, the gap opens from tmp);
    returns (H, E, h_rows [8, B, Lq])."""
    B = qi.shape[0]
    goe, ge = params.gap_oe, params.gap_extend
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=qi.device)
    seed0 = torch.zeros(B, dtype=torch.int32, device=qi.device)
    hs = []
    for r in range(8):
        sub = _sub_scores(qi, q_is_n, tstrip[:, r:r + 1], params, False)
        tmp = torch.cat([zcol, H[:, :-1]], dim=1) + sub
        f_used = _fscan(tmp - goe, seed0, ge)
        h = torch.maximum(torch.maximum(tmp, f_used), E.clamp_min(0))
        E = torch.maximum(tmp - goe, E - ge)
        H = h
        hs.append(h)
    return H, E, torch.stack(hs)


def _first_key(vals, target, keys):
    """Smallest key per row where vals == target[:, None]."""
    return torch.where(vals == target[:, None], keys, INT_MAX).amin(dim=1)


def local_align_second_batch(
    q: torch.Tensor,      # [B, Lq] uint8, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8, Lt % 8 == 0
    qlen: torch.Tensor,   # [B] int
    tlen: torch.Tensor,   # [B] int
    params: AlignmentParams,
) -> SecondResult:
    """Local alignment with second-best (GASAL2 TRUE semantics).

    The reference visits each pair's OWN 8-padded extent — its padding
    cells can carry flagged (second-best candidate) values — so cells
    beyond qr8/tr8 per pair are masked out while cells inside are kept.

    Returns (score, qend, tend, score2, qend2, tend2), all [B] int32."""
    B, Lq = q.shape
    Lt = t.shape[1]
    if Lt % 8:
        raise ValueError(f"the visit order walks 8-row strips; Lt={Lt}")
    dev = q.device
    i32 = torch.int32
    qi = q.to(i32)
    ti = t.to(i32)
    q_is_n = qi == N4
    cell_idx = torch.arange(Lq * 8, dtype=i32, device=dev)[None, :]
    col_idx = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    qr8 = (_i32(qlen, dev) + 7) // 8 * 8
    tr8 = (_i32(tlen, dev) + 7) // 8 * 8
    col_ok = col_idx < qr8[:, None]                              # [B, Lq]
    cell_ok_cols = col_ok.repeat_interleave(8, dim=1)            # [B, Lq*8]

    H = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.zeros((B, Lq), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bkey = torch.full((B,), INT_MAX, dtype=i32, device=dev)
    best2 = torch.zeros(B, dtype=i32, device=dev)
    b2key = torch.full((B,), INT_MAX, dtype=i32, device=dev)
    prev2 = torch.zeros(B, dtype=i32, device=dev)    # prev_maxHH_second
    x2 = torch.zeros(B, dtype=i32, device=dev)       # maxXY_x_second
    runmax = torch.zeros(B, dtype=i32, device=dev)   # running max carry
    for s in range(Lt // 8):
        H, E, hs = _strip_core(qi, q_is_n, H, E, ti[:, s * 8:s * 8 + 8],
                               params)
        flat = hs.permute(1, 2, 0).reshape(B, Lq * 8)            # visit order
        strip_ok = s * 8 < tr8                                   # [B]
        row_ok = s * 8 + (cell_idx & 7) < tr8[:, None]
        visit = cell_ok_cols & row_ok & strip_ok[:, None]
        flat = torch.where(visit, flat, NEG_BIG)
        keys = s * Lq * 8 + cell_idx
        # cell-level running max (inclusive), carried across strips
        R = torch.maximum(torch.cummax(flat, dim=1).values, runmax[:, None])
        # primary best: first strict attainment = min key among the max
        smax = flat.amax(dim=1)
        skey = _first_key(flat, smax, keys)
        take = (smax > best) | ((smax == best) & (skey < bkey))
        best_n = torch.where(take, smax, best)
        bkey = torch.where(take, skey, bkey)
        # second best: candidates strictly below the running max
        # including self, visited cells only
        cand = (flat < R) & visit
        ch = torch.where(cand, flat, NEG_BIG)
        s2max = ch.amax(dim=1)
        s2key = _first_key(ch, s2max, keys)
        take2 = (s2max > best2) | ((s2max == best2) & (s2key < b2key))
        best2_n = torch.where(take2, s2max, best2)
        b2key = torch.where(take2, s2key, b2key)
        # query-end-second quirk, per column segment c (8 cells): after
        # the segment, if prev2 < maxHH(end of segment): x2 = column;
        # prev2 = max(run_second_through_segment, prev2)
        seg = flat.reshape(B, Lq, 8)
        segR = torch.maximum(torch.cummax(seg.amax(dim=2), dim=1).values,
                             runmax[:, None])        # running max at seg end
        seg2 = torch.where(cand.reshape(B, Lq, 8), seg, NEG_BIG).amax(dim=2)
        run2 = torch.maximum(torch.cummax(seg2, dim=1).values, best2[:, None])
        prev2_before = torch.cat([prev2[:, None], run2[:, :-1]], dim=1)
        cond = (prev2_before < segR) & col_ok & strip_ok[:, None]
        lastc = torch.where(cond, col_idx, -1).amax(dim=1)
        x2 = torch.where(lastc >= 0, lastc, x2)
        prev2 = torch.maximum(prev2, run2[:, -1])
        runmax = R[:, -1]
        best, best2 = best_n, best2_n

    def decode(key):
        cell = key >> 3
        return cell % Lq, (cell // Lq) * 8 + (key & 7)

    qend, tend = decode(bkey)
    _, t2 = decode(b2key)
    z = best == 0
    qend = torch.where(z, 0, qend)
    tend = torch.where(z, 0, tend)
    t2 = torch.where(best2 == 0, 0, t2)
    return SecondResult(best, qend, tend, best2, x2, t2)


def _local_start_core(
    qr_arr: torch.Tensor,     # [B, Lq] reversed codes (N4 beyond extents)
    tr_arr: torch.Tensor,     # [B, Lt]
    fwd_score: torch.Tensor,  # [B] int
    params: AlignmentParams,
):
    """Reverse-pass DP on pre-reversed word-aligned inputs; returns the
    recorded cell as (cprime, sstrip, r0): reversed query column, strip
    and row inside the strip, per gold semantics."""
    B, Lq = qr_arr.shape
    Lt = tr_arr.shape[1]
    if Lt % 8:
        raise ValueError(f"the visit order walks 8-row strips; Lt={Lt}")
    dev = qr_arr.device
    i32 = torch.int32
    qi = qr_arr.to(i32)
    ti = tr_arr.to(i32)
    q_is_n = qi == N4
    fwd = _i32(fwd_score, dev)
    cell_idx = torch.arange(Lq * 8, dtype=i32, device=dev)[None, :]

    H = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.zeros((B, Lq), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bkey = torch.full((B,), INT_MAX, dtype=i32, device=dev)
    runmax = torch.zeros(B, dtype=i32, device=dev)
    kstar = torch.full((B,), INT_MAX, dtype=i32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    for s in range(Lt // 8):
        H, E, hs = _strip_core(qi, q_is_n, H, E, ti[:, s * 8:s * 8 + 8],
                               params)
        flat = hs.permute(1, 2, 0).reshape(B, Lq * 8)
        keys = s * Lq * 8 + cell_idx
        R = torch.maximum(torch.cummax(flat, dim=1).values, runmax[:, None])
        # first key reaching fwd_score (if not already found)
        k_here = torch.where(R >= fwd[:, None], keys, INT_MAX).amin(dim=1)
        newly = ~found & (k_here < INT_MAX)
        kstar = torch.where(newly, k_here, kstar)
        kend = (kstar >> 3) * 8 + 7          # segment end of k*
        # best tracking limited to keys <= kend once found; strips after
        # the one that found it update nothing
        lim = torch.where(newly, kend, torch.where(found, -1, kend))
        fh = torch.where(keys <= lim[:, None], flat, NEG_BIG)
        smax = fh.amax(dim=1)
        skey = _first_key(fh, smax, keys)
        take = (smax > best) | ((smax == best) & (skey < bkey))
        best = torch.where(take, smax, best)
        bkey = torch.where(take, skey, bkey)
        found = found | newly
        runmax = R[:, -1]
    cell = bkey >> 3
    return cell % Lq, cell // Lq, bkey & 7


def _rev_prefix(arr: torch.Tensor, n8: torch.Tensor, fill: int):
    """Position j of row b reads arr[b, n8[b]-1-j] while that is >= 0
    (clamped to the row), `fill` beyond: one gather per side."""
    L = arr.shape[1]
    src = n8[:, None].long() - 1 - torch.arange(L, device=arr.device)
    got = arr.gather(1, src.clamp(0, L - 1))
    return torch.where(src >= 0, got, fill).to(torch.uint8)


def local_start_inputs(q, t, qlen, tlen, qend, tend):
    """The reverse pass's inputs from a forward result: the reversed
    word-aligned prefixes (N4 beyond) and their 8-padded extents
    (qr8, tr8), all on q's device."""
    dev = q.device
    qlen, tlen = _i32(qlen, dev), _i32(tlen, dev)
    qr8 = torch.minimum(_i32(qend, dev) // 8 + 1, (qlen + 7) // 8) * 8
    tr8 = torch.minimum(_i32(tend, dev) // 8 + 1, (tlen + 7) // 8) * 8
    return _rev_prefix(q, qr8, N4), _rev_prefix(t, tr8, N4), qr8, tr8


def local_starts(q, t, qlen, tlen, score, qend, tend,
                 params: AlignmentParams):
    """(qstart, tstart) [B] int32 from a forward result: the reverse
    pass through `cuda_align.local_start` (the kernel on CUDA tensors),
    with the reference's skewed target start; both 0 where score == 0."""
    from genomics_tpu_torch.ops import cuda_align

    rev_q, rev_t, qr8, tr8 = local_start_inputs(q, t, qlen, tlen, qend, tend)
    cprime, sstrip, r0 = cuda_align.local_start(rev_q, rev_t, score, params,
                                                qr8, tr8)
    z = score == 0
    qstart = torch.where(z, 0, qr8 - 1 - cprime)
    # reference skew: maxXY_y = (gend_reg*8 - 1 - 8*s) + r0
    tstart = torch.where(z, 0, tr8 - 1 - 8 * sstrip + r0)
    return qstart, tstart


def local_align_with_start(q, t, qlen, tlen, params: AlignmentParams):
    """Full WITH_START path: forward (scores/ends) + reverse pass
    (starts, gold semantics incl. the skewed target coordinate).

    q [B, Lq], t [B, Lt] uint8 N4-padded tensors; returns (score, qend,
    tend, qstart, tstart), [B] int32 on q's device."""
    from genomics_tpu_torch.ops import cuda_align

    fwd = cuda_align.local_align(q, t, params)
    qstart, tstart = local_starts(q, t, qlen, tlen, fwd.score, fwd.query_end,
                                  fwd.target_end, params)
    return fwd.score, fwd.query_end, fwd.target_end, qstart, tstart


def skip_flags(head: SemiGlobalSkip, tail: SemiGlobalSkip) -> dict:
    """The start pass's keyword flags head_q, head_t, tail_q, tail_t."""
    return dict(head_q=bool(head & SemiGlobalSkip.QUERY),
                head_t=bool(head & SemiGlobalSkip.TARGET),
                tail_q=bool(tail & SemiGlobalSkip.QUERY),
                tail_t=bool(tail & SemiGlobalSkip.TARGET))


def _semiglobal_start_core(
    rev_q: torch.Tensor,      # [B, Lq] reversed query codes (trailing 0)
    rev_t: torch.Tensor,      # [B, Lt] reversed target SUFFIX from gend_reg
    qlen: torch.Tensor,       # [B] read_len
    tlen: torch.Tensor,       # [B] ref_len
    row_off: torch.Tensor,    # [B] 8*gend_reg (reversed row of suffix row 0)
    row_count: torch.Tensor,  # [B] 8*(tr - gend_reg) valid suffix rows
    fwd_score: torch.Tensor,  # [B]
    fwd_qend: torch.Tensor,   # [B] forward maxXY_x (NOT reset by the reference)
    params: AlignmentParams,
    *, head_q: bool, head_t: bool, tail_q: bool, tail_t: bool,
    count_strips: bool = False,
):
    """Reverse semiglobal DP with the reference's word-granularity early
    exit, emulated exactly at strip granularity: the only in-loop update
    site is the column read_len-1, so the triggering strip processes all
    its rows and no later strip runs.  Returns (tstart, qstart), and with
    count_strips also the strips each pair runs ([B] int32, the work a
    per-thread kernel does)."""
    B, Lq = rev_q.shape
    Lt = rev_t.shape[1]
    dev = rev_q.device
    i32 = torch.int32
    goe, ge, gapo = params.gap_oe, params.gap_extend, params.gap_open
    qi = rev_q.to(i32)
    ti = rev_t.to(i32)
    q_is_n = qi == N4
    qlen, tlen = _i32(qlen, dev), _i32(tlen, dev)
    row_off, row_count = _i32(row_off, dev), _i32(row_count, dev)
    fwd = _i32(fwd_score, dev)
    j_idx = torch.arange(Lq, dtype=i32, device=dev)
    last_j = (qlen - 1).long()[:, None]

    if head_q:
        H = torch.zeros((B, Lq), dtype=i32, device=dev)
    else:
        H = torch.where(j_idx == 0, 0, -(gapo + ge * j_idx)).expand(B, Lq)
    E = torch.full((B, Lq), MINUS_INF, dtype=i32, device=dev)
    Hsnap = H          # no strip processed → the reference scans init gH
    mHH = torch.full((B,), MINUS_INF, dtype=i32, device=dev)
    y = torch.zeros(B, dtype=i32, device=dev)
    # the while-condition at the first strip: maxHH(=MINUS_INF) < fwd_score
    allow = fwd > MINUS_INF
    strips = torch.zeros(B, dtype=i32, device=dev)
    for r in range(Lt):
        sub = _sub_scores(qi, q_is_n, ti[:, r:r + 1], params, False)
        if head_t:
            diag0 = left0 = 0
        else:
            # the penalized boundary counts rows from the suffix start
            # (the u/r counters restart there, :307-318)
            left0 = -(gapo + ge * r)
            diag0 = 0 if r == 0 else left0
        tmp = torch.cat([torch.full((B, 1), diag0, dtype=i32, device=dev),
                         H[:, :-1]], dim=1) + sub
        E_used = torch.maximum(H - goe, E - ge)
        fseed = torch.full((B,), max(left0 - goe, MINUS_INF - ge),
                           dtype=i32, device=dev)
        f_used = _fscan(torch.maximum(tmp, E_used) - goe, fseed, ge)
        h = torch.maximum(torch.maximum(tmp, f_used), E_used)
        live = allow & (r < row_count)
        if r % 8 == 0:
            strips += live.to(i32)
        H = torch.where(live[:, None], h, H)
        E = torch.where(live[:, None], E_used, E)
        if tail_t:
            row_abs = r + row_off
            lastq = h.gather(1, last_j)[:, 0]
            upd = live & (row_abs < tlen) & (lastq > mHH)
            mHH = torch.where(upd, lastq, mHH)
            y = torch.where(upd, row_abs, y)
        if r % 8 == 7:
            Hsnap = torch.where(live[:, None], H, Hsnap)
            # the strip loop's condition for the NEXT strip
            allow = allow & (mHH < fwd)

    x = _i32(fwd_qend, dev)
    if tail_q:
        cand = torch.where(j_idx < qlen[:, None], Hsnap, NEG_BIG)
        best = cand.amax(dim=1)
        xc = torch.where(cand == best[:, None], j_idx, INT_MAX).amin(dim=1)
        x = torch.where(best > mHH, xc, x)
        # the reference's fixup, applied unconditionally inside the
        # TAIL-QUERY block (:377-378)
        y = torch.where(x != tlen, qlen, y)
    if count_strips:
        return (tlen - 1) - y, (qlen - 1) - x, strips
    return (tlen - 1) - y, (qlen - 1) - x


def semiglobal_start_inputs(q, t, qlen, tlen, tend):
    """The reverse pass's inputs from a forward result, on q's device:
    (rev_q, rev_t, row_off, row_count).  Plain full reversal into zeroed
    (code 0) words (:232-266), the target then shifted left by the
    skipped strips gend_reg (the suffix view)."""
    dev = q.device
    B, Lq = q.shape
    Lt = t.shape[1]
    qlen, tlen = _i32(qlen, dev), _i32(tlen, dev)
    tr = (tlen + 7) // 8
    a = tr - (_i32(tend, dev) // 8 + 1)
    gend_reg = torch.where(a > 0, a - 1, a).clamp_min(0)
    qi = qlen[:, None].long() - 1 - torch.arange(Lq, device=dev)
    rev_q = torch.where(qi >= 0, q.gather(1, qi.clamp(0, Lq - 1)), 0)
    ki = (tlen - 8 * gend_reg)[:, None].long() - 1 - torch.arange(Lt, device=dev)
    rev_t = torch.where(ki >= 0, t.gather(1, ki.clamp(0, Lt - 1)), 0)
    return (rev_q.to(torch.uint8), rev_t.to(torch.uint8), gend_reg * 8,
            (tr - gend_reg) * 8)


def semiglobal_starts(q, t, qlen, tlen, score, qend, tend,
                      params: AlignmentParams,
                      head: SemiGlobalSkip = SemiGlobalSkip.NONE,
                      tail: SemiGlobalSkip = SemiGlobalSkip.NONE):
    """(qstart, tstart) [B] int32 from a forward result: the reverse pass
    through `cuda_align.semiglobal_start` (the kernel on CUDA tensors)."""
    from genomics_tpu_torch.ops import cuda_align

    rev_q, rev_t, row_off, row_count = semiglobal_start_inputs(
        q, t, qlen, tlen, tend)
    tstart, qstart = cuda_align.semiglobal_start(
        rev_q, rev_t, _i32(qlen, q.device), _i32(tlen, q.device), row_off,
        row_count, score, qend, params, **skip_flags(head, tail))
    return qstart, tstart


def semiglobal_align_with_start(q, t, qlen, tlen, params: AlignmentParams,
                                head: SemiGlobalSkip = SemiGlobalSkip.NONE,
                                tail: SemiGlobalSkip = SemiGlobalSkip.NONE):
    """Full semiglobal WITH_START: forward pass (score/ends with the
    reference quirks) + reverse pass (starts).

    q [B, Lq], t [B, Lt] uint8 N4-padded tensors, Lt % 8 == 0; returns
    (score, qend, tend, qstart, tstart), [B] int32 on q's device."""
    from genomics_tpu_torch.ops import cuda_align

    dev = q.device
    qlen, tlen = _i32(qlen, dev), _i32(tlen, dev)
    fwd = cuda_align.semiglobal_align(q, t, qlen, tlen, params, head=head,
                                      tail=tail)
    qstart, tstart = semiglobal_starts(q, t, qlen, tlen, fwd.score,
                                       fwd.query_end, fwd.target_end, params,
                                       head=head, tail=tail)
    return fwd.score, fwd.query_end, fwd.target_end, qstart, tstart
