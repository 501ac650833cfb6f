"""Traceback walk on the device, and the host run-length encode to
byte-CIGARs.  The counterpart of `genomics_tpu/ops/tb_walk.py` and, for
GLOBAL and SEMI_GLOBAL, of the native decoder `native/cigar.cpp`.

The walk is the state machine of native/cigar.cpp decode_one (itself
the transcription of CDP/GASAL2/src/kernels/get_tb.h:5-149): op_select /
op_shift gap-chain tracking, X/M from the substitution bit, and for
LOCAL the score-stop.  It reads the sqb nibble cube [Lt//8, Lq, B] that
the `ops.cuda_align` kernels write with traceback, and only the
O(Lq + Lt)-byte op stream per alignment goes back to the host.  There
`cigars_from_walk` run-length encodes it and, for GLOBAL and
SEMI_GLOBAL, appends decode_one's leading D/I pads and derives the
starts from where the walk ended — the same bytes decode_one emits.

`tb_walk` takes the plain version for CPU tensors and the kernel of
`csrc/tb_walk.cu` for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core.scoring import AlignmentParams
from genomics_tpu_torch.ops.cuda_align import _on_cpu

STOP = 255
_CHUNK = 16  # steps between the plain walk's all-lanes-done checks
_ALGOS = {"local": 0, "global": 1, "semiglobal": 2}

# Kernel launches per walk mode (LOCAL is "tb_walk"); the wrapper adds
# one where it launches.
LAUNCHES = {"tb_walk": 0, "tb_walk.global": 0, "tb_walk.semiglobal": 0}


@functools.cache
def _kernel():
    fn = _build.library("tb_walk").tb_walk_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                   vp, vp, vp, vp]
    fn.restype = ci
    return fn


def tb_walk_plain(tb_sqb, score, qend, tend, params: AlignmentParams,
                  algo: str = "local"):
    """Vectorised walk over the batch: one step for every lane at a
    time, stopping early once every lane is done.  Bit-identical to
    genomics_tpu.ops.tb_walk.tb_walk_device with algo="local"."""
    Lt8, Lq, B = tb_sqb.shape
    Lt = Lt8 * 8
    T = Lq + Lt
    score_stop = algo == "local"
    dev = tb_sqb.device
    i64 = torch.int64
    flat = tb_sqb.reshape(-1)
    barange = torch.arange(B, device=dev)
    mt, mm = params.match, params.mismatch
    goe, ge = params.gap_oe, params.gap_extend

    i = tend.to(i64)
    j = qend.to(i64)
    total = score.to(i64)
    op_shift = torch.zeros(B, dtype=i64, device=dev)
    op_select = torch.full((B,), 3, dtype=i64, device=dev)
    curr = torch.zeros(B, dtype=i64, device=dev)
    prev_op = torch.zeros(B, dtype=i64, device=dev)
    active = (i >= 0) & (j >= 0)
    ops = torch.full((T, B), STOP, dtype=torch.uint8, device=dev)
    for s in range(T):
        if s % _CHUNK == 0 and not bool(active.any()):
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
        ops[s] = torch.where(active, fill, STOP).to(torch.uint8)
        move = active
        if score_stop:
            # local score reconstruction (decode_one:80-93)
            gap_cost = -ge - (goe - ge) * (prev_op != fill).to(i64)
            sub_cost = mt - (mt + mm) * (fill == 1).to(i64)
            curr_new = curr + torch.where(fill >= 2, gap_cost, sub_cost)
            curr = torch.where(active, curr_new, curr)
            prev_op = torch.where(active, fill, prev_op)
            # the score stop leaves i/j AT the stop cell (decode_one
            # breaks before moving)
            move = active & (curr_new != total)
        i = i - (move & (fill != 3)).to(i64)
        j = j - (move & (fill != 2)).to(i64)
        op_shift = torch.where(active, new_shift, op_shift)
        op_select = torch.where(active, new_select, op_select)
        active = move & (i >= 0) & (j >= 0)
    return ops, j.to(torch.int32), i.to(torch.int32)


def tb_walk(tb_sqb, score, qend, tend, params: AlignmentParams,
            algo: str = "local"):
    """→ (ops [Lq+Lt, B] uint8 walk-order op codes (0=M 1=X 2=D 3=I,
    255 = inactive), final j [B] int32, final i [B] int32).

    The walk starts at (tend, qend).  LOCAL stops where the rebuilt
    score reaches `score`, and its final (j, i) are the starts.  GLOBAL
    (start (tlen, qlen)) and SEMI_GLOBAL (the resolved end cell) walk
    to row or column -1 and ignore `score`; `cigars_from_walk` turns
    their final (j, i) into pads and starts.  Lq + Lt steps hold every
    walk from a start column <= Lq (see csrc/tb_walk.cu)."""
    if algo not in _ALGOS:
        raise ValueError(f"algo must be one of {sorted(_ALGOS)}; got {algo!r}")
    if tb_sqb.dim() != 3 or tb_sqb.dtype != torch.int32:
        raise ValueError(f"need an int32 [Lt//8, Lq, B] cube; got "
                         f"{tb_sqb.dtype} {tuple(tb_sqb.shape)}")
    Lt8, Lq, B = tb_sqb.shape
    for x in (score, qend, tend):
        if x.shape != (B,) or x.dtype != torch.int32 or x.device != tb_sqb.device:
            raise ValueError(f"score/qend/tend must be int32 [{B}] on "
                             f"{tb_sqb.device}; got {x.dtype} {tuple(x.shape)}"
                             f" on {x.device}")
    if _on_cpu(tb_sqb):
        return tb_walk_plain(tb_sqb, score, qend, tend, params, algo)
    dev = tb_sqb.device
    ops = torch.empty((Lq + Lt8 * 8, B), dtype=torch.uint8, device=dev)
    qfin = torch.empty(B, dtype=torch.int32, device=dev)
    tfin = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ops, qfin, tfin
    tb_sqb = tb_sqb.contiguous()
    score, qend, tend = (x.contiguous() for x in (score, qend, tend))
    fn = _kernel()
    with torch.cuda.device(dev):
        err = fn(_ALGOS[algo], tb_sqb.data_ptr(), score.data_ptr(),
                 qend.data_ptr(), tend.data_ptr(), B, Lq, Lt8, params.match,
                 params.mismatch, params.gap_oe, params.gap_extend,
                 ops.data_ptr(), qfin.data_ptr(), tfin.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"tb_walk ({algo}) launch failed: CUDA error {err}")
    LAUNCHES["tb_walk" if algo == "local" else f"tb_walk.{algo}"] += 1
    return ops, qfin, tfin


def rle_cigar(ops_np: np.ndarray, max_ops: int | None = None):
    """[T, B] uint8 op stream (255 = stop) → (cigars [B, max_ops] u8,
    n_ops [B]) in walk order with 63-run splitting — byte-identical to
    decode_one's emission."""
    T, B = ops_np.shape
    max_ops = max_ops or (T + 8)
    cigars = np.zeros((B, max_ops), np.uint8)
    n_ops = np.zeros(B, np.int32)
    opsT = ops_np.T  # [B, T]
    for b in range(B):
        row = opsT[b]
        stop = np.argmax(row == 255) if (row == 255).any() else T
        row = row[:stop]
        if not len(row):
            continue
        # run-length encode
        change = np.flatnonzero(np.diff(row)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(row)]])
        k = 0
        for s, e in zip(starts, ends):
            cnt = e - s
            opv = row[s]
            while cnt > 0:
                c = min(cnt, 63)
                if k < max_ops:
                    cigars[b, k] = opv | (c << 2)
                k += 1
                cnt -= c
        n_ops[b] = k
    return cigars, n_ops


def _pad_bytes(n: int, op: int) -> list[int]:
    """decode_one's leading-gap pad for n positions: runs of at most 63,
    the longest first."""
    out = []
    while n > 0:
        out.append(op | (min(n, 63) << 2))
        n -= 63
    return out


def cigars_from_walk(ops_np: np.ndarray, qfin: np.ndarray, tfin: np.ndarray,
                     algo: str = "local", head_q: bool = False,
                     head_t: bool = False):
    """Walk outputs → (cigars [B, max_ops] u8, n_ops [B], qstart [B],
    tstart [B]), byte-identical to native/cigar.cpp decode_one.

    LOCAL: the run-length encode, and the final (j, i) are the starts.
    GLOBAL and SEMI_GLOBAL: after the walk's runs come the leading D pad
    of the i+1 target rows left, then the leading I pad of the j+1 query
    columns left — for SEMI_GLOBAL only where that HEAD is not skipped.
    Starts are 0 for GLOBAL and max(j+1, 0) / max(i+1, 0) after the pads
    for SEMI_GLOBAL."""
    cigars, n_ops = rle_cigar(ops_np)
    B = len(n_ops)
    if algo == "local":
        return cigars, n_ops, qfin.astype(np.int32), tfin.astype(np.int32)
    pad_d = algo == "global" or not head_t
    pad_i = algo == "global" or not head_q
    qstart = np.zeros(B, np.int32)
    tstart = np.zeros(B, np.int32)
    longest = int(max(tfin.max(initial=-1), qfin.max(initial=-1))) + 1
    out = np.zeros((B, cigars.shape[1] + 2 * (longest // 63 + 1)), np.uint8)
    out[:, :cigars.shape[1]] = cigars
    for b in range(B):
        i, j = int(tfin[b]), int(qfin[b])
        pads = (_pad_bytes(i + 1, 2) if pad_d else []) \
            + (_pad_bytes(j + 1, 3) if pad_i else [])
        k = int(n_ops[b])
        out[b, k:k + len(pads)] = pads
        n_ops[b] = k + len(pads)
        if algo == "semiglobal":
            qstart[b] = 0 if pad_i else max(j + 1, 0)
            tstart[b] = 0 if pad_d else max(i + 1, 0)
    return out, n_ops, qstart, tstart
