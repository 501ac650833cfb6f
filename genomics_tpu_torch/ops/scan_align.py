"""Plain PyTorch DP engines: the references the CUDA kernels are held to.

A port of `genomics_tpu/ops/scan_align.py:43-590` (LOCAL, GLOBAL,
SEMI_GLOBAL, KSW, BANDED).  Each GASAL2 recurrence is swept one target
row at a time and vectorised over the batch and the query axis: the H/E
column state is a dense [B, Lq] carry, and the horizontal gap chain is a
max-plus prefix scan (`torch.cummax`).  The scan is exact for the
tmp-based gap opens of the local and global cores, and for the h-based
opens of the semiglobal and banded cores because h = max(tmp, f, e) lets
f's h-term split into tmp and e terms (gap_oe >= gap_extend).  KSW's
beg/end window, m == 0 break and BANDED's band are masks on the row.

LOCAL end positions follow GASAL2's strip visit order (strips of 8
target rows, query-major inside a strip, strict '<' updates): among the
cells with the best score the one with the smallest key
((i >> 3) * Lq + j) * 8 + (i & 7) wins.  Pad cells (code N4) score 0 and
can only tie, and their keys are larger, so no length mask is needed.
GLOBAL and SEMI_GLOBAL read their lengths instead.

Traceback nibbles (dir | e_ext << 2 | f_ext << 3) come packed into the
kernels' sqb layout [Lt/8, Lq, B], 8 target rows per int32.

`local_align_batch16` is the plain version of the packed-16-bit LOCAL
modes (`pallas_align.py:557, :636`): the same recurrence on int16
tensors, swept by anti-diagonals.

Runs on whatever device its tensors are on; `ops.cuda_align` calls it
for CPU tensors and `chip_smoke.py` times it on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from genomics_tpu_torch.core.encoding import N4
from genomics_tpu_torch.core.scoring import AlignmentParams, SemiGlobalSkip

MINUS_INF = -32768
NEG_BIG = -(1 << 28)  # safe -inf for scans (no underflow)
NEG16 = -(1 << 12)    # the int16 paths' -inf (the TPU kernels' nbig)
_KEY_MAX = (1 << 31) - 1


class AlignResult(NamedTuple):
    score: torch.Tensor       # [B] int32
    query_end: torch.Tensor   # [B] int32
    target_end: torch.Tensor  # [B] int32
    # [Lt//8, Lq, B] int32 ("sqb"): 8 target rows of 4-bit nibbles per
    # word, row i in bits 4*(i%8)..; nibble = dir | e_ext<<2 | f_ext<<3
    tb: torch.Tensor | None = None


def _fscan(g: torch.Tensor, seed: torch.Tensor, ge: int) -> torch.Tensor:
    """Horizontal gap prefix scan.

    f[0] = seed; f[j] = max(g[j-1], f[j-1] - ge), computed as
    w[j] = f[j] + j*ge = max(seed, cummax(g + (k+1)*ge)[j-1]).
    g: [B, L] int32, seed: [B] int32 → [B, L] int32."""
    B, L = g.shape
    j = torch.arange(L, dtype=torch.int32, device=g.device)
    cm = torch.cummax(g + (j + 1) * ge, dim=1).values
    shifted = torch.cat([torch.full((B, 1), NEG_BIG, dtype=torch.int32,
                                    device=g.device), cm[:, :-1]], dim=1)
    return torch.maximum(seed[:, None], shifted) - j * ge


def _sub_scores(qi, q_is_n, tbase, params: AlignmentParams,
                global_macro: bool) -> torch.Tensor:
    """[B, Lq] substitution scores of one target base [B, 1] against
    every query column (DEV_GET_SUB_SCORE_LOCAL / _GLOBAL,
    gasal_kernels.h:39-57): the local macro scores N as 0, the global
    macro as an ordinary base; n_penalty overrides both."""
    sub = (qi == tbase).to(torch.int32) * (params.match + params.mismatch) \
        - params.mismatch
    if params.n_penalty is not None:
        return sub.masked_fill(q_is_n | (tbase == N4), -params.n_penalty)
    if global_macro:
        return sub
    return sub.masked_fill(q_is_n | (tbase == N4), 0)


def _tb_nibble(sub, tmp, h, f_used, e_used, goe: int, ge: int):
    """4-bit traceback code per cell (CORE_*_COMPUTE_TB semantics)."""
    d = torch.where(h == tmp, (sub < 0).to(torch.int32),
                    2 + (h == f_used).to(torch.int32))
    f_ext = (tmp - goe <= f_used - ge).to(torch.int32)
    e_ext = (tmp - goe <= e_used - ge).to(torch.int32)
    return d | (e_ext << 2) | (f_ext << 3)


def _pack_row(tb, word, nib, i: int):
    """Add row i's nibbles [B, Lq] to the strip's word; store the word
    into tb [Lt//8, Lq, B] once the strip's 8 rows are in."""
    word = nib if i % 8 == 0 else word | (nib << (4 * (i % 8)))
    if i % 8 == 7:
        tb[i >> 3] = word.T
    return word


def _check_batch(q, t, with_tb):
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"need q [B, Lq] and t [B, Lt]; got {tuple(q.shape)}"
                         f" and {tuple(t.shape)}")
    if with_tb and t.shape[1] % 8:
        raise ValueError(f"traceback packs 8 target rows per word; "
                         f"Lt={t.shape[1]}")


def local_align_batch(
    q: torch.Tensor,   # [B, Lq] uint8 codes, N4-padded
    t: torch.Tensor,   # [B, Lt] uint8 codes, N4-padded
    params: AlignmentParams,
    with_tb: bool = False,
) -> AlignResult:
    """Batched GASAL2 local alignment: score + end positions, and the
    traceback nibbles packed into the kernels' sqb layout when with_tb.

    E(0, j) = 0 and f(i, -1) = 0 (the gE/f strip inits), floor at 0,
    tmp-based gap opens."""
    _check_batch(q, t, with_tb)
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    goe, ge = params.gap_oe, params.gap_extend
    qi = q.to(i32)
    ti = t.to(i32)
    q_is_n = qi == N4
    jidx = torch.arange(Lq, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    seed0 = torch.zeros(B, dtype=i32, device=dev)  # f(i, -1) = 0

    H = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.zeros((B, Lq), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bkey = torch.full((B,), _KEY_MAX, dtype=i32, device=dev)
    tb = (torch.empty((Lt // 8, Lq, B), dtype=i32, device=dev)
          if with_tb else None)
    word = None
    for i in range(Lt):
        sub = _sub_scores(qi, q_is_n, ti[:, i:i + 1], params, False)
        tmp = torch.cat([zcol, H[:, :-1]], dim=1) + sub
        tmpg = tmp - goe
        f_used = _fscan(tmpg, seed0, ge)
        h = torch.maximum(torch.maximum(tmp, f_used), E.clamp_min(0))
        # leftmost max in the row == min key in the row
        rh = h.amax(dim=1)
        row_j = torch.where(h == rh[:, None], jidx, Lq).amin(dim=1)
        rkey = ((i >> 3) * Lq + row_j) * 8 + (i & 7)
        take = (rh > best) | ((rh == best) & (rkey < bkey))
        best = torch.where(take, rh, best)
        bkey = torch.where(take, rkey, bkey)
        if with_tb:
            word = _pack_row(tb, word,
                             _tb_nibble(sub, tmp, h, f_used, E, goe, ge), i)
        E = torch.maximum(tmpg, E - ge)
        H = h
    # decode key → (i, j): key = ((i>>3)*Lq + j)*8 + (i&7)
    cell = bkey >> 3
    zero = best == 0
    qend = torch.where(zero, 0, cell % Lq)
    tend = torch.where(zero, 0, (cell // Lq) * 8 + (bkey & 7))
    return AlignResult(best, qend, tend, tb)


def local_align_batch16(
    q: torch.Tensor,   # [B, Lq] uint8 codes, N4-padded
    t: torch.Tensor,   # [B, Lt] uint8 codes, N4-padded
    params: AlignmentParams,
    ends: bool = True,
) -> AlignResult:
    """The plain version of the SCORE16 / END16 kernels: LOCAL score (and,
    with `ends`, its end positions) with every DP quantity an int16.

    The caller checks the range (`cuda_align.local_mode`): in it, every
    value equals `local_align_batch`'s.  The recurrence is the kernels'
    (f(i, 0) = -4096, the TPU kernels' int16 -inf, e(0, j) = 0, tmp-based
    gap opens, floor at 0), swept
    one anti-diagonal at a time so that no prefix-scan offset can leave
    the int16 range: rows are the vector axis and row i holds cell
    (i, d - i).  Cells off the matrix hold H = 0 (the boundary) and take
    part in no maximum (NEG16).  Without `ends` there is no N compare:
    that is the has_n=False contract, under which the caller has remapped
    the padding to the 16/17 sentinels.  Ends are int32 and follow the
    strip visit order, as `local_align_batch`'s do."""
    _check_batch(q, t, False)
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i16 = torch.int16
    goe, ge = params.gap_oe, params.gap_extend
    n_score = -params.n_penalty if params.n_penalty is not None else 0
    # qrev[:, Lt + Lq - 1 - d + i] is query column d - i, or padding
    pad = torch.full((B, Lt), N4, dtype=torch.uint8, device=dev)
    qrev = torch.cat([pad, q.flip(1), pad], dim=1)
    t_is_n = t == N4
    rows = torch.arange(Lt, device=dev)
    row_key = (rows >> 3) * Lq * 8 + (rows & 7)
    zrow = torch.zeros((B, 1), dtype=i16, device=dev)
    zero = torch.zeros((B, Lt), dtype=i16, device=dev)
    H1, H2, T1, F1, E1 = zero, zero, zero, zero, zero  # diagonals d-1, d-2
    best = torch.zeros(B, dtype=i16, device=dev)
    bkey = torch.full((B,), _KEY_MAX, dtype=torch.int32, device=dev)
    for d in range(Lq + Lt - 1):
        j = d - rows
        on = (j >= 0) & (j < Lq)
        qc = qrev[:, Lt + Lq - 1 - d:2 * Lt + Lq - 1 - d]
        sub = torch.where(qc == t, params.match, -params.mismatch).to(i16)
        if ends:
            sub = sub.masked_fill((qc == N4) | t_is_n, n_score)
        # H(i-1, j-1) from diagonal d-2; row -1 and column -1 hold 0
        tmp = torch.cat([zrow, H2[:, :-1]], dim=1) + sub
        f = torch.where(j == 0, NEG16, torch.maximum(T1 - goe, F1 - ge))
        e = torch.maximum(torch.cat([zrow, T1[:, :-1]], dim=1) - goe,
                          torch.cat([zrow, E1[:, :-1]], dim=1) - ge)
        e = torch.where(rows == 0, 0, e)
        h = torch.maximum(torch.maximum(tmp, f), e.clamp_min(0))
        h = torch.where(on, h, NEG16)
        rh = h.amax(dim=1)
        if ends:
            key = torch.where(h == rh[:, None], row_key + j * 8, _KEY_MAX)
            rkey = key.to(torch.int32).amin(dim=1)
            take = (rh > best) | ((rh == best) & (rkey < bkey))
            best = torch.where(take, rh, best)
            bkey = torch.where(take, rkey, bkey)
        else:
            best = torch.maximum(best, rh)
        H2, H1 = H1, h.clamp_min(0)
        T1, F1, E1 = tmp, f, e
    best = best.to(torch.int32)
    if not ends:
        return AlignResult(best, None, None)
    cell = bkey >> 3
    zero_best = best == 0
    qend = torch.where(zero_best, 0, cell % Lq)
    tend = torch.where(zero_best, 0, (cell // Lq) * 8 + (bkey & 7))
    return AlignResult(best, qend, tend)


def global_align_batch(
    q: torch.Tensor,      # [B, Lq] uint8 codes, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8 codes, N4-padded
    qlen: torch.Tensor,   # [B] int32 true lengths, 1..Lq
    tlen: torch.Tensor,   # [B] int32, 1..Lt
    params: AlignmentParams,
    with_tb: bool = False,
) -> AlignResult:
    """Batched GASAL2 global alignment (global.h:31-303).

    Boundaries, reference quirks included:
      H(-1, j) = 0 if j == 0 else -(gapo + ge*j)      (global[] init)
      H(i, -1) = -(gapo + ge*(i+1))                   (u counter)
      diag(i, 0) = 0 if i == 0 else -(gapo + ge*i)    (p[] init, r counter)
      E(0, j) = MINUS_INF; f(i, -1) = MINUS_INF at every strip
    Score = H(tlen-1, qlen-1); the ends are (qlen-1, tlen-1)."""
    _check_batch(q, t, with_tb)
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    goe, ge, gapo = params.gap_oe, params.gap_extend, params.gap_open
    qi = q.to(i32)
    ti = t.to(i32)
    q_is_n = qi == N4
    qlen = qlen.to(device=dev, dtype=i32)
    tlen = tlen.to(device=dev, dtype=i32)
    jidx = torch.arange(Lq, dtype=i32, device=dev)
    last_j = (qlen - 1).long()[:, None]
    seed_inf = torch.full((B,), MINUS_INF, dtype=i32, device=dev)

    H = torch.where(jidx == 0, 0, -(gapo + ge * jidx)).expand(B, Lq)
    E = torch.full((B, Lq), MINUS_INF, dtype=i32, device=dev)
    score = torch.zeros(B, dtype=i32, device=dev)
    tb = (torch.empty((Lt // 8, Lq, B), dtype=i32, device=dev)
          if with_tb else None)
    word = None
    for i in range(Lt):
        sub = _sub_scores(qi, q_is_n, ti[:, i:i + 1], params, True)
        diag0 = torch.full((B, 1), 0 if i == 0 else -(gapo + ge * i),
                           dtype=i32, device=dev)
        tmp = torch.cat([diag0, H[:, :-1]], dim=1) + sub
        tmpg = tmp - goe
        f_used = _fscan(tmpg, seed_inf, ge)
        h = torch.maximum(torch.maximum(tmp, f_used), E)
        score = torch.where(tlen == i + 1, h.gather(1, last_j)[:, 0], score)
        if with_tb:
            word = _pack_row(tb, word,
                             _tb_nibble(sub, tmp, h, f_used, E, goe, ge), i)
        E = torch.maximum(tmpg, E - ge)
        H = h
    return AlignResult(score, qlen - 1, tlen - 1, tb)


def semiglobal_align_batch(
    q: torch.Tensor,      # [B, Lq] uint8 codes, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8 codes, N4-padded, Lt % 8 == 0
    qlen: torch.Tensor,   # [B] int32 true lengths, 1..Lq
    tlen: torch.Tensor,   # [B] int32, 1..Lt
    params: AlignmentParams,
    head: SemiGlobalSkip = SemiGlobalSkip.NONE,
    tail: SemiGlobalSkip = SemiGlobalSkip.NONE,
    with_tb: bool = False,
) -> AlignResult:
    """Batched GASAL2 semiglobal (semiglobal_kernel_template.h:40-230),
    forward pass.

    The optimized core: e opens from the h above, f from the h to the
    left (scanned as f(i,j) = max(max(tmp, e)(i,j-1) - goe,
    f(i,j-1) - ge)).  HEAD picks the boundary inits; TAIL picks where
    the max is scanned, with the reference's quirks kept:
      - the end inits are swapped: qend = tlen, tend = qlen (:63-64);
      - TAIL_T: column qlen-1, rows < tlen, first max in row order;
      - TAIL_Q: the pair's padded bottom row ceil(tlen/8)*8 - 1,
        columns < qlen, leftmost value beating the running score, then
        tend = qlen wherever qend != tlen (:205-210).
    Without a TAIL the score stays MINUS_INF."""
    _check_batch(q, t, False)
    B, Lq = q.shape
    Lt = t.shape[1]
    if Lt % 8:
        raise ValueError(f"the padded bottom row needs Lt % 8 == 0; Lt={Lt}")
    dev = q.device
    i32 = torch.int32
    goe, ge, gapo = params.gap_oe, params.gap_extend, params.gap_open
    head_q = bool(head & SemiGlobalSkip.QUERY)
    head_t = bool(head & SemiGlobalSkip.TARGET)
    tail_q = bool(tail & SemiGlobalSkip.QUERY)
    tail_t = bool(tail & SemiGlobalSkip.TARGET)
    qi = q.to(i32)
    ti = t.to(i32)
    q_is_n = qi == N4
    qlen = qlen.to(device=dev, dtype=i32)
    tlen = tlen.to(device=dev, dtype=i32)
    jidx = torch.arange(Lq, dtype=i32, device=dev)
    last_j = (qlen - 1).long()[:, None]
    t_last8 = (tlen + 7) // 8 * 8 - 1

    if head_q:
        H = torch.zeros((B, Lq), dtype=i32, device=dev)
        E = torch.zeros((B, Lq), dtype=i32, device=dev)
    else:
        H = torch.where(jidx == 0, 0, -(gapo + ge * jidx)).expand(B, Lq)
        E = torch.full((B, Lq), MINUS_INF, dtype=i32, device=dev)
    bT_score = torch.full((B,), MINUS_INF, dtype=i32, device=dev)
    bT_pos = tlen.clone()
    Hsnap = torch.zeros((B, Lq), dtype=i32, device=dev)
    tb = (torch.empty((Lt // 8, Lq, B), dtype=i32, device=dev)
          if with_tb else None)
    word = None
    for i in range(Lt):
        sub = _sub_scores(qi, q_is_n, ti[:, i:i + 1], params, False)
        if head_t:
            diag0 = left0 = 0             # h[m] = p[m] = 0 at every strip
        else:
            # the u/r counters: H(i, -1) = -(gapo + ge*i) and
            # diag(i, 0) = 0 for i == 0, else -(gapo + ge*i)
            left0 = -(gapo + ge * i)
            diag0 = 0 if i == 0 else left0
        tmp = torch.cat([torch.full((B, 1), diag0, dtype=i32, device=dev),
                         H[:, :-1]], dim=1) + sub
        E_used = torch.maximum(H - goe, E - ge)
        fseed = torch.full((B,), max(left0 - goe, MINUS_INF - ge),
                           dtype=i32, device=dev)
        f_used = _fscan(torch.maximum(tmp, E_used) - goe, fseed, ge)
        h = torch.maximum(torch.maximum(tmp, f_used), E_used)
        if tail_t:
            lastq = h.gather(1, last_j)[:, 0]
            upd = (i < tlen) & (lastq > bT_score)
            bT_score = torch.where(upd, lastq, bT_score)
            bT_pos = torch.where(upd, i, bT_pos)
        if tail_q:
            Hsnap = torch.where((t_last8 == i)[:, None], h, Hsnap)
        if with_tb:
            word = _pack_row(
                tb, word, _tb_nibble(sub, tmp, h, f_used, E_used, goe, ge), i)
        E = E_used
        H = h

    score = torch.full((B,), MINUS_INF, dtype=i32, device=dev)
    qend = tlen.clone()                   # maxXY_x <- ref_len
    tend = qlen.clone()                   # maxXY_y <- read_len
    if tail_t:
        score = bT_score
        tend = torch.where(bT_score > MINUS_INF, bT_pos, tend)
    if tail_q:
        cand = torch.where(jidx < qlen[:, None], Hsnap, NEG_BIG)
        cand = torch.where(cand > score[:, None], cand, NEG_BIG)
        new_score = cand.amax(dim=1)
        better = new_score > NEG_BIG
        # leftmost column holding the row max among the cells > score
        m_best = torch.where(cand == new_score[:, None], jidx, Lq).amin(dim=1)
        qend = torch.where(better, m_best, qend)
        score = torch.where(better, new_score, score)
        tend = torch.where(qend != tlen, qlen, tend)
    return AlignResult(score, qend, tend, tb)


def ksw_align_batch(
    q: torch.Tensor,      # [B, Lq] uint8 codes, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8 codes, N4-padded
    qlen: torch.Tensor,   # [B] int32 true lengths
    tlen: torch.Tensor,   # [B] int32
    h0: torch.Tensor,     # [B] int32 seed scores
    params: AlignmentParams,
    window_cells: bool = False,
):
    """Batched bwa-mem ksw_extend (ksw_kernel_template.h:46-203).

    The reference's data-dependent control flow is carried as per-pair
    state: the beg/end active window (masked updates emulate the skipped
    cells exactly: skipped prefixes hold eh = (0, 0), so a full-row
    compute with masked writes is equivalent), the m == 0 early break
    (alive flag) and the gscore-vs-clip final choice (PEN_CLIP5).  zdrop
    is hard-coded 0 in the reference (disabled).  Returns the
    AlignResult; with window_cells, (AlignResult, cells) where cells [B]
    int64 counts the window cells the reference's walk visits (the sum
    of end - beg over the rows before the break)."""
    _check_batch(q, t, False)
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    goe, ge = params.gap_oe, params.gap_extend
    # eh[] has a live slot at index `end` <= qlen: one N4 column more
    qe = torch.cat([q.to(i32), torch.full((B, 1), N4, dtype=i32, device=dev)],
                   dim=1)
    q_is_n = qe == N4
    ti = t.to(i32)
    qlen = qlen.to(device=dev, dtype=i32)
    tlen = tlen.to(device=dev, dtype=i32)
    h0 = h0.to(device=dev, dtype=i32)
    j_idx = torch.arange(Lq + 1, dtype=i32, device=dev)[None, :]

    # first row: eh[0].h = h0, eh[1].h = max(h0 - goe, 0), then
    # eh[j].h = eh[j-1].h - ge while eh[j-1].h > ge and j <= qlen
    # (ksw_kernel_template.h:79-83); eh[j] (j >= 2) is written iff
    # h0 - goe - (j-2)*ge > ge
    ehh = (h0[:, None] - goe - (j_idx - 1) * ge).clamp_min(0)
    ehh = torch.where(j_idx == 0, h0[:, None], ehh)
    written = (j_idx < 2) | ((h0[:, None] - goe - (j_idx - 2) * ge) > ge)
    ehh = torch.where(written & (j_idx <= qlen[:, None]), ehh, 0)
    ehe = torch.zeros_like(ehh)

    beg = torch.zeros(B, dtype=i32, device=dev)
    end = qlen.clone()
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    mx = h0.clone()
    max_i, max_j, max_ie, gscore = (torch.full((B,), -1, dtype=i32, device=dev)
                                    for _ in range(4))
    cells = torch.zeros(B, dtype=torch.int64, device=dev)
    seed0 = torch.zeros(B, dtype=i32, device=dev)
    for i in range(Lt):
        do = alive & (i < tlen)
        sub = _sub_scores(qe, q_is_n, ti[:, i:i + 1], params, False)
        M = torch.where(ehh != 0, ehh + sub, 0)
        tterm = (M - goe).clamp_min(0)
        # f(beg) = 0 and cells before beg have M = 0, so a full-row scan
        # seeded 0 gives the window's f chain
        f_used = _fscan(tterm, seed0, ge)
        h = torch.maximum(torch.maximum(M, ehe), f_used)
        # h1 entering cell beg
        h1_0 = torch.where(beg == 0, (h0 - (goe + ge * i)).clamp_min(0), 0)
        inwin = (j_idx >= beg[:, None]) & (j_idx < end[:, None])
        hwin = torch.where(inwin, h, NEG_BIG)
        rowmax = hwin.amax(dim=1).clamp_min(0)
        # mj: the LAST index attaining the row max (m <= h updates)
        mj = torch.where(hwin == rowmax[:, None], j_idx, -1).amax(dim=1)
        # eh writes: eh[j].h = H(i, j-1) in the window, eh[end].h = h1
        Hleft = torch.cat([h1_0[:, None], h[:, :-1]], dim=1)
        Hleft = torch.where(j_idx == beg[:, None], h1_0[:, None], Hleft)
        at_end = j_idx == end[:, None]
        h_endm1 = h.gather(1, (end - 1).clamp_min(0).long()[:, None])[:, 0]
        h1_final = torch.where(end > beg, h_endm1, h1_0)
        ehh_out = torch.where(inwin, Hleft, ehh)
        ehh_out = torch.where(at_end, h1_final[:, None], ehh_out)
        ehe_out = torch.where(inwin, torch.maximum(ehe - ge, tterm), ehe)
        ehe_out = torch.where(at_end, 0, ehe_out)
        ehh = torch.where(do[:, None], ehh_out, ehh)
        ehe = torch.where(do[:, None], ehe_out, ehe)
        if window_cells:
            cells += torch.where(do, end - beg, 0)
        # gscore, only when the row reached the last query column
        gupd = do & (end == qlen) & (gscore <= h1_final)
        gscore = torch.where(gupd, h1_final, gscore)
        max_ie = torch.where(gupd, i, max_ie)
        # the m == 0 break (after eh/gscore, before max/window updates)
        died = do & (rowmax == 0)
        alive = alive & ~died
        do2 = do & ~died
        mupd = do2 & (rowmax > mx)
        mx = torch.where(mupd, rowmax, mx)
        max_i = torch.where(mupd, i, max_i)
        max_j = torch.where(mupd, mj, max_j)
        # window update on the NEW eh arrays
        act = (ehh != 0) | (ehe != 0)
        first_act = torch.where(inwin & act, j_idx, 1 << 28).amin(dim=1)
        beg_new = torch.minimum(first_act, end)
        in2 = (j_idx >= beg_new[:, None]) & (j_idx <= end[:, None])
        last_act = torch.where(in2 & act, j_idx, -(1 << 28)).amax(dim=1)
        last_act = torch.maximum(last_act, beg_new - 1)
        end_new = torch.minimum(last_act + 2, qlen)
        beg = torch.where(do2, beg_new, beg)
        end = torch.where(do2, end_new, end)
    clip = (gscore <= 0) | (gscore <= mx - 5)   # PEN_CLIP5
    res = AlignResult(torch.where(clip, mx, gscore),
                      torch.where(clip, max_j + 1, qlen),
                      torch.where(clip, max_i + 1, max_ie + 1))
    return (res, cells) if window_cells else res


def banded_align_batch(
    q: torch.Tensor,      # [B, Lq] uint8 codes, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8 codes, N4-padded
    qlen: torch.Tensor,   # [B] int32 true lengths
    tlen: torch.Tensor,   # [B] int32
    params: AlignmentParams,
    band_width_tiles: int,
) -> AlignResult:
    """Batched banded local DP (banded.h:10-140): strips of 8 target rows,
    query tiles of 8 restricted to the band [max(0, strip - k_other + 1),
    min(k_band + strip, qr)) with k_other = tr - (qr - k_band); h-based
    f/e chains; the strip's h/f/p reset at the band's left edge (diag 0,
    f -ge); the stale out-of-band global[] state (masked writes); ends
    by strip visit order (the smallest key among the best cells).  Reads
    of rows or columns past a length score the N4 padding."""
    _check_batch(q, t, False)
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    i32 = torch.int32
    goe, ge = params.gap_oe, params.gap_extend
    qi = q.to(i32)
    ti = t.to(i32)
    q_is_n = qi == N4
    jidx = torch.arange(Lq, dtype=i32, device=dev)
    qr = (qlen.to(device=dev, dtype=i32) + 7) // 8
    tr = (tlen.to(device=dev, dtype=i32) + 7) // 8
    k_other = tr - (qr - band_width_tiles)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    fseed = torch.full((B,), -ge, dtype=i32, device=dev)

    gH = torch.zeros((B, Lq), dtype=i32, device=dev)
    gE = torch.zeros((B, Lq), dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bkey = torch.full((B,), _KEY_MAX, dtype=i32, device=dev)
    for i in range(Lt):
        strip = i >> 3
        j0 = (strip - k_other + 1).clamp_min(0) * 8
        jend = torch.clamp_max(qr, band_width_tiles + strip) * 8
        inband = ((jidx >= j0[:, None]) & (jidx < jend[:, None])
                  & (strip < tr)[:, None])
        sub = _sub_scores(qi, q_is_n, ti[:, i:i + 1], params, False)
        # diag: 0 at the band's first column (the strip's p[] reset)
        tmp = torch.cat([zcol, gH[:, :-1]], dim=1) + sub
        tmp = torch.where(jidx == j0[:, None], sub, tmp)
        # e: from the previous row's H (gH) and the carried gE
        E_used = torch.maximum(gH - goe, gE - ge)
        # f: h-based, seeded so that f(j0) = max(0 - goe, 0 - ge) = -ge
        g = torch.maximum(tmp, E_used).clamp_min(0) - goe
        g = torch.where(inband, g, NEG_BIG)
        g = torch.where(jidx == (j0 - 1)[:, None], -ge, g)
        f_used = _fscan(g, fseed, ge)
        h = torch.maximum(torch.maximum(tmp, f_used), E_used.clamp_min(0))
        gH = torch.where(inband, h, gH)
        gE = torch.where(inband, E_used, gE)
        hmask = torch.where(inband, h, NEG_BIG)
        rh = hmask.amax(dim=1)
        row_j = torch.where(hmask == rh[:, None], jidx, Lq).amin(dim=1)
        rkey = ((i >> 3) * Lq + row_j) * 8 + (i & 7)
        take = ((rh > best) | ((rh == best) & (rkey < bkey))) & (rh > 0)
        best = torch.where(take, rh, best)
        bkey = torch.where(take, rkey, bkey)
    cell = bkey >> 3
    zero = best == 0
    qend = torch.where(zero, 0, cell % Lq)
    tend = torch.where(zero, 0, (cell // Lq) * 8 + (bkey & 7))
    return AlignResult(best, qend, tend)
