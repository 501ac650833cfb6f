"""CPU golds for the LOCAL, GLOBAL, SEMI_GLOBAL, BANDED and KSW paths —
pure-Python emulations of the GASAL2 kernels and of its traceback
decoder, copied from `genomics_tpu/core/golds.py`.

They are independent of every torch and CUDA code path of this package,
so they are the oracles that `chip_smoke.py` spot-checks the card
against on a machine without JAX.  References (CDP/GASAL2/src/kernels/):
- local_align:      local_kernel_template.h (CORE_LOCAL_COMPUTE :19-30,
                    kernel :72-519; second best :147-163, WITH_START
                    reverse pass :441-511)
- global_align:     global.h:31-303
- semiglobal_align: semiglobal_kernel_template.h:40-230 (forward pass,
                    second best), :227-384 (WITH_START reverse pass)
- banded_align:     banded.h:10-140
- ksw_align:        ksw_kernel_template.h:46-203
- decode_tb:        get_tb.h:5-149
"""
from __future__ import annotations

import numpy as np

from genomics_tpu_torch.core.encoding import N4, encode4
from genomics_tpu_torch.core.scoring import AlignmentParams, SemiGlobalSkip

CIGAR_OPS = "MXDI"
MINUS_INF = -32768  # SHRT_MIN, gasal_kernels.h MINUS_INF


def _as_codes(seq) -> np.ndarray:
    if isinstance(seq, (str, bytes)):
        return encode4(seq)
    return np.asarray(seq, dtype=np.uint8)


def pad8(codes: np.ndarray) -> np.ndarray:
    """Pad a code array to a multiple of 8 with the N code (the
    gasal_host_batch_fill convention, host_batch.cpp:129-138)."""
    codes = _as_codes(codes)
    n = len(codes)
    n8 = ((n + 7) // 8) * 8
    if n8 == n:
        return codes.copy()
    out = np.full(n8, N4, dtype=np.uint8)
    out[:n] = codes
    return out


def _sub_score_local(rbase: int, gbase: int, p: AlignmentParams) -> int:
    """DEV_GET_SUB_SCORE_LOCAL (gasal_kernels.h:40-51): without N_PENALTY
    any pairing involving N scores 0; with N_PENALTY it scores -n_penalty."""
    score = p.match if rbase == gbase else -p.mismatch
    if rbase == N4 or gbase == N4:
        score = -p.n_penalty if p.n_penalty is not None else 0
    return score


def _sub_score_global(rbase: int, gbase: int, p: AlignmentParams) -> int:
    """DEV_GET_SUB_SCORE_GLOBAL: N handling only exists with N_PENALTY."""
    score = p.match if rbase == gbase else -p.mismatch
    if p.n_penalty is not None and (rbase == N4 or gbase == N4):
        score = -p.n_penalty
    return score


def local_align(
    query,
    target,
    params: AlignmentParams,
    with_tb: bool = False,
    with_start: bool = False,
    second_best: bool = False,
):
    """gasal_local_kernel emulation (local_kernel_template.h:72-519).

    Gap opens are taken from tmp = diag + sub, not from h.  Visit order:
    strips of 8 target rows, query columns left to right inside a strip,
    rows top to bottom inside a column; strict '<' max tracking, so the
    first cell attaining the final max in that order wins.

    Returns a dict with score, query_end, target_end (+ the *_second
    fields with second_best, + query_start / target_start with
    with_start, + tb_dirs, the [t_pad8, q_pad8] nibble matrix, with
    with_tb)."""
    q = pad8(query)
    t = pad8(target)
    qr = len(q) // 8  # query_batch_regs
    tr = len(t) // 8  # target_batch_regs
    goe, ge = params.gap_oe, params.gap_extend

    Lq = len(q)
    gH = np.zeros(Lq, dtype=np.int64)  # global[].x
    gE = np.zeros(Lq, dtype=np.int64)  # global[].y
    maxHH = 0
    maxXY_x = maxXY_y = 0
    prev_maxHH = 0
    maxHH_s = 0
    prev_maxHH_s = 0
    maxXY_x_s = maxXY_y_s = 0
    dirs = np.zeros((len(t), len(q)), dtype=np.uint8) if with_tb else None

    for i in range(tr):  # target strip
        h = [0] * 9
        f = [0] * 9
        p = [0] * 9
        gidx = i << 3
        for ridx in range(Lq):  # query column
            rbase = int(q[ridx])
            h[0] = int(gH[ridx])
            e = int(gE[ridx])
            for m in range(1, 9):
                gbase = int(t[gidx + m - 1])
                sub = _sub_score_local(rbase, gbase, params)
                tmp = p[m] + sub
                hm = max(tmp, f[m], e, 0)
                if with_tb:
                    m_or_x = 0 if tmp >= p[m] else 1
                    if hm == tmp:
                        d = m_or_x
                    elif hm == f[m]:
                        d = 3
                    else:
                        d = 2
                    f_ext = 0 if (tmp - goe) > (f[m] - ge) else 1
                    e_ext = 0 if (tmp - goe) > (e - ge) else 1
                    dirs[gidx + m - 1, ridx] = d | (e_ext << 2) | (f_ext << 3)
                h[m] = hm
                f[m] = max(tmp - goe, f[m] - ge)
                e = max(tmp - goe, e - ge)
                if second_best:
                    if maxHH_s < hm < maxHH:
                        maxXY_y_s = gidx + m - 1
                        maxHH_s = hm
                if maxHH < hm:
                    maxXY_y = gidx + m - 1
                    maxHH = hm
                p[m] = h[m - 1]
            gH[ridx] = h[8]
            gE[ridx] = e
            if prev_maxHH < maxHH:
                maxXY_x = ridx
            if second_best:
                # the quirk: prev_maxHH_second against the PRIMARY max
                if prev_maxHH_s < maxHH:
                    maxXY_x_s = ridx
                prev_maxHH_s = max(maxHH_s, prev_maxHH_s)
            prev_maxHH = max(maxHH, prev_maxHH)

    out = {"score": maxHH, "query_end": maxXY_x, "target_end": maxXY_y}
    if second_best:
        out["score_second"] = maxHH_s
        out["query_end_second"] = maxXY_x_s
        out["target_end_second"] = maxXY_y_s
    if with_tb:
        out["tb_dirs"] = dirs
    if with_start:
        out.update(_local_start_pass(q, t, qr, tr, out, params))
    return out


def _local_start_pass(q, t, qr, tr, fwd, params: AlignmentParams):
    """WITH_START reverse pass (local_kernel_template.h:441-511): re-run
    the DP on *word-aligned reversed* sequences starting at the words
    containing the end positions, stopping (at column-segment granularity)
    once the running max reaches the forward score."""
    goe, ge = params.gap_oe, params.gap_extend
    rend_pos, gend_pos, fwd_score = fwd["query_end"], fwd["target_end"], fwd["score"]
    rend_reg = min((rend_pos >> 3) + 1, qr)
    gend_reg = min((gend_pos >> 3) + 1, tr)
    Lq = len(q)

    gH = np.zeros(Lq, dtype=np.int64)
    gE = np.zeros(Lq, dtype=np.int64)
    maxHH = 0
    prev_maxHH = 0
    maxXY_x = 0
    maxXY_y = 0
    gidx = ((gend_reg << 3) + 8) - 1
    i = 0
    while i < gend_reg and maxHH < fwd_score:
        h = [0] * 9
        f = [0] * 9
        p = [0] * 9
        # target word gend_reg-1-i; the reference reads backwards from the
        # end word, the bases inside a word reversed by indexing
        # l = 0..28 (LSB first) instead of 28..0
        tword = t[(gend_reg - 1 - i) * 8 : (gend_reg - i) * 8]
        gidx -= 8
        ridx = (rend_reg << 3) - 1
        global_idx = 0
        j = 0
        while j < rend_reg and maxHH < fwd_score:
            qword = q[(rend_reg - 1 - j) * 8 : (rend_reg - j) * 8]
            k = 0
            while k <= 28 and maxHH < fwd_score:
                # rbase: bits k..k+3 → base index 7 - k/4 within the word
                rbase = int(qword[7 - (k >> 2)])
                h[0] = int(gH[global_idx])
                e = int(gE[global_idx])
                for m in range(1, 9):
                    # l = 0..28 → base 7 - l/4 = 8-m
                    gbase = int(tword[8 - m])
                    sub = _sub_score_local(rbase, gbase, params)
                    tmp = p[m] + sub
                    hm = max(tmp, f[m], e, 0)
                    h[m] = hm
                    f[m] = max(tmp - goe, f[m] - ge)
                    e = max(tmp - goe, e - ge)
                    if maxHH < hm:
                        # the reference's skewed target coordinate
                        maxXY_y = gidx + (m - 1)
                        maxHH = hm
                    p[m] = h[m - 1]
                gH[global_idx] = h[8]
                gE[global_idx] = e
                if prev_maxHH < maxHH:
                    maxXY_x = ridx
                prev_maxHH = max(maxHH, prev_maxHH)
                ridx -= 1
                global_idx += 1
                k += 4
            j += 1
        i += 1
    return {"query_start": maxXY_x, "target_start": maxXY_y}


def global_align(query, target, params: AlignmentParams, with_tb: bool = False):
    """gasal_global_kernel emulation (global.h:31-303).

    Boundary: first row/column -(gapo + gape*k), f initialized to
    MINUS_INF per strip, the `u`/`r` counters running across strips.
    Score read from the column ridx == read_len at row ref_len-1."""
    q = pad8(query)
    t = pad8(target)
    read_len = len(_as_codes(query))
    ref_len = len(_as_codes(target))
    tr = len(t) // 8
    goe, ge = params.gap_oe, params.gap_extend
    gapo = params.gap_open

    Lq = len(q)
    gH = np.zeros(Lq, dtype=np.int64)
    gE = np.zeros(Lq, dtype=np.int64)
    gH[0] = 0
    gE[0] = MINUS_INF
    for i in range(1, Lq):
        gH[i] = -(gapo + ge * i)
        gE[i] = MINUS_INF
    h = [0] * 9
    p = [0] * 9
    f = [0] * 9
    max_h = [0] * 9
    u = 1  # h[u++] = 0 consumed index 0
    r = 1
    dirs = np.zeros((len(t), len(q)), dtype=np.uint8) if with_tb else None

    for i in range(tr):
        for m in range(1, 9):
            h[m] = -(gapo + ge * u)
            f[m] = MINUS_INF
            p[m] = 0 if r == 1 else -(gapo + ge * (r - 1))
            u += 1
            r += 1
        gidx = i << 3
        for ridx in range(Lq):
            rbase = int(q[ridx])
            h[0] = int(gH[ridx])
            e = int(gE[ridx])
            for m in range(1, 9):
                gbase = int(t[gidx + m - 1])
                sub = _sub_score_global(rbase, gbase, params)
                tmp = p[m] + sub
                hm = max(tmp, f[m], e)
                if with_tb:
                    m_or_x = 0 if tmp >= p[m] else 1
                    if hm == tmp:
                        d = m_or_x
                    elif hm == f[m]:
                        d = 3
                    else:
                        d = 2
                    f_ext = 0 if (tmp - goe) > (f[m] - ge) else 1
                    e_ext = 0 if (tmp - goe) > (e - ge) else 1
                    dirs[gidx + m - 1, ridx] = d | (e_ext << 2) | (f_ext << 3)
                h[m] = hm
                f[m] = max(tmp - goe, f[m] - ge)
                e = max(tmp - goe, e - ge)
                p[m] = h[m - 1]
            gH[ridx] = h[8]
            gE[ridx] = e
            if ridx + 1 == read_len:
                for m in range(1, 9):
                    max_h[m] = h[m]
    score = max_h[8 - ((tr << 3) - ref_len)]
    out = {
        "score": score,
        "query_end": read_len - 1,
        "target_end": ref_len - 1,
    }
    if with_tb:
        out["tb_dirs"] = dirs
    return out


def semiglobal_align(
    query,
    target,
    params: AlignmentParams,
    head: SemiGlobalSkip = SemiGlobalSkip.NONE,
    tail: SemiGlobalSkip = SemiGlobalSkip.NONE,
    second_best: bool = False,
    with_start: bool = False,
):
    """gasal_semi_global_kernel emulation (semiglobal_kernel_template.h:
    40-230), with the WITH_START reverse pass (:227-384).

    HEAD skip picks free-vs-penalized row/col boundaries; TAIL skip picks
    where the max is scanned (bottom row for TARGET, last column for
    QUERY — with the rightmost-column fixup at :205-210).  Uses the
    optimized core (:17-28): standard h-based Gotoh updates carried via
    prev_hm_diff.  Substitution uses the LOCAL macro (N scores 0)."""
    q = pad8(query)
    t = pad8(target)
    read_len = len(_as_codes(query))
    ref_len = len(_as_codes(target))
    tr = len(t) // 8
    goe, ge = params.gap_oe, params.gap_extend
    gapo = params.gap_open
    head_q = head in (SemiGlobalSkip.QUERY, SemiGlobalSkip.BOTH)
    head_t = head in (SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH)
    tail_q = tail in (SemiGlobalSkip.QUERY, SemiGlobalSkip.BOTH)
    tail_t = tail in (SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH)

    Lq = len(q)
    maxHH = MINUS_INF
    maxXY_x = ref_len   # NOTE: reference swaps x/y inits (template :63-64)
    maxXY_y = read_len
    maxHH_s = MINUS_INF
    maxXY_x_s = ref_len
    maxXY_y_s = read_len

    if head_q:
        gH = np.zeros(Lq, dtype=np.int64)
        gE = np.zeros(Lq, dtype=np.int64)
    else:
        gH = np.array([0] + [-(gapo + ge * i) for i in range(1, Lq)], dtype=np.int64)
        gE = np.full(Lq, MINUS_INF, dtype=np.int64)

    h = [0] * 9
    f = [0] * 9
    p = [0] * 9
    u = 1
    r = 1

    for i in range(tr):
        gidx = i << 3
        if head_t:
            for m in range(9):
                h[m] = 0
                f[m] = MINUS_INF
                p[m] = 0
        else:
            for m in range(1, 9):
                h[m] = -(gapo + ge * (u - 1))
                f[m] = MINUS_INF
                p[m] = 0 if r == 1 else -(gapo + ge * (r - 1))
                u += 1
                r += 1
        for ridx in range(Lq):
            rbase = int(q[ridx])
            h[0] = int(gH[ridx])
            e = int(gE[ridx])
            prev_hm_diff = h[0] - goe
            for m in range(1, 9):
                gbase = int(t[gidx + m - 1])
                sub = _sub_score_local(rbase, gbase, params)
                curr_hm_diff = h[m] - goe
                f[m] = max(curr_hm_diff, f[m] - ge)
                curr_hm_diff = p[m] + sub
                curr_hm_diff = max(curr_hm_diff, f[m])
                e = max(prev_hm_diff, e - ge)
                curr_hm_diff = max(curr_hm_diff, e)
                h[m] = curr_hm_diff
                p[m] = prev_hm_diff + goe
                prev_hm_diff = curr_hm_diff - goe
            gH[ridx] = h[8]
            gE[ridx] = e
            if tail_t and ridx + 1 == read_len:
                for m in range(1, 9):
                    if h[m] > maxHH and (gidx + m - 1) < ref_len:
                        maxXY_y = gidx + m - 1
                        maxHH = h[m]
                    if second_best:
                        if h[m] > maxHH_s and h[m] < maxHH and (gidx + m - 1) < ref_len:
                            maxXY_y_s = gidx + m - 1
                            maxHH_s = h[m]

    if tail_q:
        for m in range(Lq):
            score_tmp = int(gH[m])
            if score_tmp > maxHH and m < read_len:
                maxXY_x = m
                maxHH = score_tmp
            if second_best:
                # NOTE: reference checks m < ref_len here (template :198) —
                # replicated verbatim, quirk included.
                if score_tmp > maxHH_s and score_tmp < maxHH and m < ref_len:
                    maxXY_x_s = m
                    maxHH_s = score_tmp
        if maxXY_x != ref_len:
            maxXY_y = read_len
        if second_best and maxXY_x_s != ref_len:
            maxXY_y_s = read_len

    out = {"score": maxHH, "query_end": maxXY_x, "target_end": maxXY_y}
    if second_best:
        out["score_second"] = maxHH_s
        out["query_end_second"] = maxXY_x_s
        out["target_end_second"] = maxXY_y_s
    if with_start:
        out.update(_semiglobal_start_pass(q, t, read_len, ref_len, tr, out,
                                          params, head, tail))
    return out


def _semiglobal_start_pass(q, t, read_len, ref_len, tr, fwd,
                           params: AlignmentParams,
                           head: SemiGlobalSkip, tail: SemiGlobalSkip):
    """Semiglobal WITH_START reverse pass (semiglobal_kernel_template.h:
    227-384): re-run the semiglobal DP on the PLAIN-REVERSED sequences
    (full-length reversal into zero-initialized words — trailing code 0,
    unlike the forward N-padding), starting at target word `gend_reg`,
    with word-granularity early exit once the running max reaches the
    forward score.  Reference quirks replicated:

    - the penalized (non-free-target-head) row boundary counts rows from
      the STARTING strip (`u`/`r` restart at 1, :307-318), while
      maxXY_y records absolute reversed coordinates (gidx + m - 1);
    - maxXY_x is NOT reset before the pass (:275-276 reset only
      maxHH/maxXY_y) — for TAIL without QUERY the query start derives
      from the forward query end;
    - the TAIL-QUERY final scan (:361-377) reads global[] columns
      m < read_len, which all live in the last strip processed, and
      applies the `maxXY_x != ref_len` fixup verbatim;
    - `gend_reg` clamped at 0 (the reference underflows into UB when the
      forward maxXY_y quirk value read_len lands beyond the last word)."""
    goe, ge = params.gap_oe, params.gap_extend
    gapo = params.gap_open
    head_q = head in (SemiGlobalSkip.QUERY, SemiGlobalSkip.BOTH)
    head_t = head in (SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH)
    tail_q = tail in (SemiGlobalSkip.QUERY, SemiGlobalSkip.BOTH)
    tail_t = tail in (SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH)
    Lq = len(q)
    Lt = len(t)
    qr = Lq // 8
    # plain full-length reversal into zeroed words (:232-266)
    rev_q = np.zeros(Lq, dtype=np.uint8)
    rev_q[:read_len] = q[:read_len][::-1]
    rev_t = np.zeros(Lt, dtype=np.uint8)
    rev_t[:ref_len] = t[:ref_len][::-1]

    gend_pos = fwd["target_end"]
    fwd_score = fwd["score"]
    a = tr - ((gend_pos >> 3) + 1)
    gend_reg = (a - 1) if a > 0 else a
    gend_reg = max(gend_reg, 0)

    maxHH = MINUS_INF
    maxXY_y = 0
    maxXY_x = fwd["query_end"]

    if head_q:
        gH = np.zeros(Lq, dtype=np.int64)
    else:
        gH = np.array([0] + [-(gapo + ge * i) for i in range(1, Lq)],
                      dtype=np.int64)
    gE = np.full(Lq, MINUS_INF, dtype=np.int64)

    h = [0] * 9
    f = [0] * 9
    p = [0] * 9
    u = 1
    r = 1

    i = gend_reg
    while i < tr and maxHH < fwd_score:
        gidx = i << 3
        if head_t:
            for m in range(9):
                h[m] = 0
                f[m] = MINUS_INF
                p[m] = 0
        else:
            for m in range(1, 9):
                h[m] = -(gapo + ge * (u - 1))
                f[m] = MINUS_INF
                p[m] = 0 if r == 1 else -(gapo + ge * (r - 1))
                u += 1
                r += 1
        ridx = 0
        j = 0
        while j < qr and maxHH < fwd_score:
            for kk in range(8):
                rbase = int(rev_q[j * 8 + kk])
                h[0] = int(gH[ridx])
                e = int(gE[ridx])
                prev_hm_diff = h[0] - goe
                for m in range(1, 9):
                    gbase = int(rev_t[gidx + m - 1])
                    sub = _sub_score_local(rbase, gbase, params)
                    curr_hm_diff = h[m] - goe
                    f[m] = max(curr_hm_diff, f[m] - ge)
                    curr_hm_diff = p[m] + sub
                    curr_hm_diff = max(curr_hm_diff, f[m])
                    e = max(prev_hm_diff, e - ge)
                    curr_hm_diff = max(curr_hm_diff, e)
                    h[m] = curr_hm_diff
                    p[m] = prev_hm_diff + goe
                    prev_hm_diff = curr_hm_diff - goe
                gH[ridx] = h[8]
                gE[ridx] = e
                ridx += 1
                if tail_t and ridx == read_len:
                    for m in range(1, 9):
                        if h[m] > maxHH and (gidx + m - 1) < ref_len:
                            maxXY_y = gidx + (m - 1)
                            maxHH = h[m]
            j += 1
        i += 1

    if tail_q:
        for m in range(Lq):
            score_tmp = int(gH[m])
            if score_tmp > maxHH and m < read_len:
                maxXY_x = m
                maxHH = score_tmp
        if maxXY_x != ref_len:
            maxXY_y = read_len
    return {
        "target_start": (ref_len - 1) - maxXY_y,
        "query_start": (read_len - 1) - maxXY_x,
    }


def banded_align(query, target, params: AlignmentParams, band_width_tiles: int):
    """gasal_banded_tiled_kernel emulation (banded.h:10-140): local DP
    restricted to a tile-diagonal band; h-based (deprecated-style) core;
    stale global[] entries outside the band are reused verbatim."""
    q = pad8(query)
    t = pad8(target)
    qr = len(q) // 8
    tr = len(t) // 8
    goe, ge = params.gap_oe, params.gap_extend
    k_band = band_width_tiles
    k_other = tr - (qr - k_band)

    Lq = len(q)
    gH = np.zeros(Lq, dtype=np.int64)
    gE = np.zeros(Lq, dtype=np.int64)
    maxHH = 0
    prev_maxHH = 0
    maxXY_x = maxXY_y = 0

    for i in range(tr):
        h = [0] * 9
        f = [0] * 9
        p = [0] * 9
        gidx = i << 3
        ridx = max(0, i - k_other + 1) << 3
        last_tile = min(k_band + i, qr)
        for j in range(ridx >> 3, last_tile):
            for kk in range(8):
                ridx_cur = j * 8 + kk
                rbase = int(q[ridx_cur])
                h[0] = int(gH[ridx_cur])
                e = int(gE[ridx_cur])
                for m in range(1, 9):
                    gbase = int(t[gidx + m - 1])
                    sub = _sub_score_local(rbase, gbase, params)
                    f[m] = max(h[m] - goe, f[m] - ge)
                    hm = p[m] + sub
                    hm = max(hm, f[m], 0)
                    e = max(h[m - 1] - goe, e - ge)
                    hm = max(hm, e)
                    h[m] = hm
                    if maxHH < hm:
                        maxXY_y = gidx + m - 1
                        maxHH = hm
                    p[m] = h[m - 1]
                gH[ridx_cur] = h[8]
                gE[ridx_cur] = e
                if prev_maxHH < maxHH:
                    maxXY_x = ridx_cur
                prev_maxHH = max(maxHH, prev_maxHH)
    return {"score": maxHH, "query_end": maxXY_x, "target_end": maxXY_y}


def ksw_align(query, target, params: AlignmentParams, h0: int):
    """gasal_ksw_kernel emulation (ksw_kernel_template.h:46-203): seed
    extension with initial score h0, M-based gap opens (the anti
    "M-I-D-M" rule :136), beg/end active-window pruning (:178-184),
    m==0 early break, and the gscore-vs-clip final choice (:189-198).
    zdrop is hardcoded 0 in the reference (disabled), so params.zdrop is
    ignored; the clip rule is PEN_CLIP5."""
    q = pad8(query)
    t = pad8(target)
    qlen = len(_as_codes(query))
    tlen = len(_as_codes(target))
    goe, ge = params.gap_oe, params.gap_extend
    PEN_CLIP5 = 5

    ehh = np.zeros(len(q) + 9, dtype=np.int64)  # eh[].h
    ehe = np.zeros(len(q) + 9, dtype=np.int64)  # eh[].e
    ehh[0] = h0
    ehh[1] = h0 - goe if h0 > goe else 0
    j = 2
    while j <= qlen and ehh[j - 1] > ge:
        ehh[j] = ehh[j - 1] - ge
        j += 1

    mx = h0
    max_i = max_j = -1
    max_ie = -1
    gscore = -1
    beg, end = 0, qlen

    for i in range(tlen):
        gbase = int(t[i])
        f = 0
        m = 0
        mj = -1
        if beg == 0:
            h1 = h0 - (goe + ge * i)
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        last_j = beg
        for j in range(beg, end):
            rbase = int(q[j])
            M = int(ehh[j])
            e = int(ehe[j])
            ehh[j] = h1
            sub = _sub_score_local(rbase, gbase, params)
            M = M + sub if M else 0
            h = max(M, e, f)
            h1 = h
            if m <= h:
                mj = j
                m = h
            tt = max(M - goe, 0)
            e = max(e - ge, tt)
            ehe[j] = e
            f = max(f - ge, tt)
            last_j = j + 1
        ehh[end] = h1
        ehe[end] = 0
        if last_j == qlen:
            if gscore <= h1:
                max_ie = i
                gscore = h1
        if m == 0:
            break
        if m > mx:
            mx, max_i, max_j = m, i, mj
        # beg/end update (zdrop==0 branch never breaks)
        j = beg
        while j < end and ehh[j] == 0 and ehe[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and ehh[j] == 0 and ehe[j] == 0:
            j -= 1
        end = min(j + 2, qlen)

    if gscore <= 0 or gscore <= mx - PEN_CLIP5:
        return {
            "score": mx,
            "query_end": max_j + 1,
            "target_end": max_i + 1,
        }
    return {"score": gscore, "query_end": qlen, "target_end": max_ie + 1}


def decode_tb(
    dirs: np.ndarray,
    qlen: int,
    tlen: int,
    algo: str,
    params: AlignmentParams,
    score: int = 0,
    query_end: int = 0,
    target_end: int = 0,
    head_q: bool = False,
    head_t: bool = False,
):
    """gasal_get_tb emulation (get_tb.h:5-149).

    dirs: [t_pad8, q_pad8] uint8 nibble matrix (bit3=f_ext, bit2=e_ext,
    bits1:0=dir code).  Returns a dict with the byte-CIGAR (walk order),
    query_start, target_start and n_ops.  ``algo`` is "local", "global"
    or "semiglobal".

    LOCAL stops when the rebuilt score reaches ``score``.  GLOBAL walks
    from one cell past the end, (tlen, qlen) — a reference quirk — and
    pads leading D / I runs.  SEMIGLOBAL (the JAX package's extension:
    GASAL2 writes the matrices but never decodes them) walks from the
    caller-resolved end cell (query_end, target_end) like GLOBAL and pads
    only a dimension whose HEAD is not skipped (head_t / head_q); its
    starts are the first consumed positions (i+1 / j+1).  GLOBAL starts
    are the final (j, i) after the pads, as in the JAX gold; the native
    decoder (native/cigar.cpp), which the engines use, reports 0."""
    goe, ge = params.gap_oe, params.gap_extend
    if algo == "local":
        i, j = target_end, query_end
        total_score = score
        curr_score = 0
    elif algo == "semiglobal":
        i, j = target_end, query_end
    else:
        i, j = tlen, qlen
    tpad, qpad = dirs.shape
    cigar = []
    prev_op = 0
    count = 0
    op_select = 3
    op_shift = 0
    while i >= 0 and j >= 0:
        cell_op = int(dirs[i, j]) if i < tpad and j < qpad else 0
        op = (cell_op >> op_shift) & op_select
        op_to_fill = op if (op == 0 or op_select == 3) else op_shift
        new_select = 3 if (op == 0 or (op == 1 and op_select == 3)) else 1
        if op == 0 or (op == 1 and op_select == 3):
            op_shift = 0
        elif op in (2, 3) and op_select == 3:
            op_shift = op
        op_select = new_select

        if count < 63 and op_to_fill == prev_op:
            count += 1
        else:
            if count > 0:
                cigar.append(prev_op | (count << 2))
            count = 1
        if algo == "local":
            if op_to_fill in (2, 3) and prev_op != op_to_fill:
                curr_score -= goe
            elif op_to_fill in (2, 3):
                curr_score -= ge
            elif op_to_fill == 1:
                curr_score -= params.mismatch
            else:
                curr_score += params.match
            if curr_score == total_score:
                prev_op = op_to_fill
                break
        prev_op = op_to_fill
        if op_to_fill in (0, 1, 2):
            i -= 1
        if op_to_fill in (0, 1, 3):
            j -= 1

    cigar.append(prev_op | (count << 2))
    if algo == "global" or (algo == "semiglobal" and not head_t):
        while i >= 0:
            cigar.append(2 | (min(i + 1, 63) << 2))
            i -= 63
    if algo == "global" or (algo == "semiglobal" and not head_q):
        while j >= 0:
            cigar.append(3 | (min(j + 1, 63) << 2))
            j -= 63
    if algo == "semiglobal":
        qstart, tstart = max(j + 1, 0), max(i + 1, 0)
    else:
        qstart, tstart = j, i
    return {
        "cigar": np.array(cigar, dtype=np.uint8),
        "query_start": qstart,
        "target_start": tstart,
        "n_ops": len(cigar),
    }


def cigar_to_string(cigar_bytes: np.ndarray) -> str:
    """Byte-CIGAR → text, in alignment order (reverse of walk order),
    matching the test_prog printer (test_prog.cpp:344-430)."""
    parts = []
    for b in reversed(np.asarray(cigar_bytes, dtype=np.uint8)):
        op = CIGAR_OPS[b & 3]
        cnt = int(b) >> 2
        if cnt:
            parts.append(f"{cnt}{op}")
    return "".join(parts)
