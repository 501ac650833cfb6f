"""The DP kernels on the card: the wrappers of `csrc/local_sw.cu`,
`csrc/global_sw.cu`, `csrc/semiglobal_sw.cu`, `csrc/local_start.cu`,
`csrc/semiglobal_start.cu`, `csrc/ksw_extend.cu` and `csrc/banded_sw.cu`.

The counterpart of `genomics_tpu/ops/pallas_align.py`,
`genomics_tpu/ops/pallas_gs.py` and `genomics_tpu/ops/pallas_ksw.py`.
Every function takes the plain version (`ops.scan_align`,
`ops.scan_align_full`) for tensors on the CPU and launches the
hand-written kernel for tensors on a CUDA device; any other device
raises.  There is no fallback from the kernel to the plain version.

One kernel covers every batch size, so the TPU's lanes / inter-task
split has no counterpart here: one thread per alignment, or G threads
sharing an alignment's strips in local_start and semiglobal_sw, and G
threads per two alignments in the 16-bit local_sw modes (G of 4 or 8 by
`split_group`, one rule on the launch and the SM count for all three).
The modes replace these Pallas kernels:

  local_sw.score       `_local_kernel_intertask_score` (pallas_align.py:482)
  local_sw.end         `_local_kernel_intertask` (pallas_align.py:221)
                       and the lanes kernel `_local_kernel` (:116)
  local_sw.tb          `_local_kernel_intertask_tb` (pallas_align.py:717)
                       and `_local_kernel` (:116) with traceback
  local_sw.second      `_local_kernel_intertask_second` (pallas_align.py:321)
  local_sw.score16     `_local_kernel_intertask_score16` (pallas_align.py:557)
  local_sw.end16       `_local_kernel_intertask16` (pallas_align.py:636)
  local_start          `_local_start_kernel` (pallas_align.py:1515)
  global_sw.score      `_global_kernel_intertask` (pallas_gs.py:65)
  global_sw.tb         `_global_kernel` (pallas_align.py:1201) with traceback
  semiglobal_sw.end    `_semiglobal_kernel_intertask` (pallas_gs.py:181)
  semiglobal_sw.tb     `_semiglobal_kernel` (pallas_align.py:1325) with
                       traceback
  semiglobal_start     `_semiglobal_start_kernel` (pallas_gs.py:364)
  ksw.end              `_ksw_kernel_intertask` (pallas_ksw.py:188) and
                       the lanes kernel `_ksw_kernel` (:45)
  ksw.score            `_ksw_kernel_intertask` score-only (:188, :315)
  banded_sw.end        `_banded_kernel_intertask` (pallas_ksw.py:453) and
                       the lanes kernel `_banded_kernel` (:392)
  banded_sw.score      `_banded_kernel_intertask` score-only (:453, :559)

LOCAL scores of N-free batches take the packed-16-bit mode wherever every
DP value fits in int16, and LOCAL ends take it only under
GENOMICS_TPU_INT16_CELLS=1, as in the JAX package (`local_mode`).  A
failed launch raises like any other.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core.encoding import N4
from genomics_tpu_torch.core.scoring import AlignmentParams, SemiGlobalSkip
from genomics_tpu_torch.device import on_cpu
from genomics_tpu_torch.ops import scan_align_full
from genomics_tpu_torch.ops.scan_align import (
    AlignResult,
    banded_align_batch,
    global_align_batch,
    ksw_align_batch,
    local_align_batch,
    local_align_batch16,
    semiglobal_align_batch,
)
from genomics_tpu_torch.ops.scan_align_full import SecondResult

# Kernel launches per kernel mode; a wrapper adds one where it launches.
LAUNCHES = {"local_sw.score": 0, "local_sw.end": 0, "local_sw.tb": 0,
            "local_sw.second": 0, "local_sw.score16": 0, "local_sw.end16": 0,
            "local_start": 0,
            "global_sw.score": 0, "global_sw.tb": 0,
            "semiglobal_sw.end": 0, "semiglobal_sw.tb": 0,
            "semiglobal_start": 0, "ksw.end": 0, "ksw.score": 0,
            "banded_sw.end": 0, "banded_sw.score": 0}
_LOCAL_MODES = {"score": 0, "end": 1, "tb": 2, "score16": 4, "end16": 5}
_LOCAL_NAMES = {v: k for k, v in _LOCAL_MODES.items()}
# The JAX package's range checks on the best score, match x Lq < limit:
# the ends' (pallas_align.py:904) and the scores' (:1098).
END16_LIMIT = (1 << 15) - 1
SCORE16_LIMIT = (1 << 15) - 64

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# argument types of each exported entry point, by (library, entry)
_SIGNATURES = {
    # mode, with_n, group, Q, T, B, Lq, Lt, match, mismatch, n_score, goe,
    # ge, gH, gE, score, qend, tend, tb, stream (every mode of _LOCAL_MODES)
    ("local_sw", "local_sw_launch"):
        (_ci, _ci, _ci, _vp, _vp) + (_ci,) * 8 + (_vp,) * 7,
    # Q, T, qlen, tlen, B, Lq, Lt, match, mismatch, n_score, goe, ge, gH,
    # gE, score, qend, tend, score2, qend2, tend2, stream
    ("local_sw", "local_sw_second_launch"):
        (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 9,
    # Q, T, fwd, qext, text, order, B, Lq, Lt, match, mismatch, n_score,
    # goe, ge, group, gH, gE, col, strip, row, stream
    ("local_start", "local_start_launch"): (_vp,) * 6 + (_ci,) * 9 + (_vp,) * 6,
    # mode, with_n_penalty, Q, T, qlen, tlen, B, Lq, Lt, match, mismatch,
    # n_penalty, gapo, ge, gH, gE, score, tb, stream
    ("global_sw", "global_sw_launch"):
        (_ci, _ci) + (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 5,
    # mode, flags, group, Q, T, qlen, tlen, B, Lq, Lt, match, mismatch,
    # n_score, gapo, ge, gH, gE, score, qend, tend, tb, stream
    ("semiglobal_sw", "semiglobal_sw_launch"):
        (_ci, _ci, _ci) + (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 7,
    # flags, Q, T, qlen, tlen, row_off, row_count, fwd_score, fwd_qend, B,
    # Lq, Lt, match, mismatch, n_score, gapo, ge, gH, gE, tstart, qstart,
    # stream
    ("semiglobal_start", "semiglobal_start_launch"):
        (_ci,) + (_vp,) * 8 + (_ci,) * 8 + (_vp,) * 5,
    # mode, with_n, shared, threads, Q, T, qlen, tlen, h0, B, Lq, Lt,
    # match, mismatch, n_score, goe, ge, eh, score, qend, tend, stream
    ("ksw_extend", "ksw_extend_launch"):
        (_ci,) * 4 + (_vp,) * 5 + (_ci,) * 8 + (_vp,) * 5,
    # mode, with_n, shared, Q, T, qlen, tlen, B, Lq, Lt, k_band, match,
    # mismatch, n_score, goe, ge, ring, eh, score, qend, tend, stream
    ("banded_sw", "banded_sw_launch"):
        (_ci,) * 3 + (_vp,) * 4 + (_ci,) * 10 + (_vp,) * 5,
}
# library of each launch-count key whose name is not the library's
_LIBRARY = {"ksw": "ksw_extend"}
# ksw_extend keeps each block's (h, e) rows (int2) and query codes (a
# byte) of columns 0..Lq in shared memory, 9 bytes a column and thread,
# wherever 32 threads fit in what a block may have on sm_90
KSW_SHARED_BYTES = 232_448
KSW_MAX_THREADS = 256
KSW_GLOBAL_THREADS = 128
KSW_SHARED_MAX_LQ = KSW_SHARED_BYTES // (9 * 32) - 1
# banded_sw keeps each 32-thread block's (h, e) carry rings (int2, `ring`
# columns a thread) in shared memory wherever they fit a block, else in a
# global scratch at 128 threads a block
BANDED_SHARED_THREADS = 32
BANDED_SHARED_MAX_RING = KSW_SHARED_BYTES // (8 * BANDED_SHARED_THREADS)


def _check_codes(a: torch.Tensor, b: torch.Tensor, batch_dim: int):
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"sequence codes must be uint8; got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[batch_dim] != b.shape[batch_dim]:
        raise ValueError(f"mismatched batches: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"q on {a.device}, t on {b.device}")


def _check_lengths(q: torch.Tensor, *per_pair: torch.Tensor):
    """Each per-pair input (qlen, tlen, ...) must be int32 [B] on q's
    device."""
    B = q.shape[0]
    for x in per_pair:
        if x.shape != (B,) or x.dtype != torch.int32 or x.device != q.device:
            raise ValueError(f"per-pair inputs (qlen/tlen, ...) must be "
                             f"int32 [{B}] on {q.device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _outputs(name: str, mode: str, Q: torch.Tensor, T: torch.Tensor,
             ends: bool):
    """Allocate a launch's outputs and scratch on Q's device.  Returns
    (score, qend, tend, tb, gH, gE); qend/tend are None without `ends`
    and tb is the sqb cube [Lt//8, Lq, B] in tb mode."""
    gH, gE = _carry(name, Q, T, packed=mode.endswith("16"))
    Lq, B = Q.shape
    score, qend, tend = _per_pair(3, Q)
    tb = (torch.empty((T.shape[0] // 8, Lq, B), dtype=torch.int32,
                      device=Q.device) if mode == "tb" else None)
    return score, (qend if ends else None), (tend if ends else None), tb, gH, gE


def _carry(name: str, Q: torch.Tensor, T: torch.Tensor, packed=False):
    """The per-column H/E carry between strips (GASAL2's global[] array):
    two [Lq, B] int32 scratch tensors on Q's device, or [Lq, ceil(B/2)]
    when `packed` (two pairs' int16 values per word)."""
    if T.shape[0] % 8:
        raise ValueError(f"{name} walks 8-row target strips; Lt={T.shape[0]}")
    Lq, B = Q.shape
    shape = (Lq, (B + 1) // 2) if packed else (Lq, B)
    return [torch.empty(shape, dtype=torch.int32, device=Q.device)
            for _ in range(2)]


def _per_pair(n: int, Q: torch.Tensor):
    """n int32 [B] outputs on Q's device."""
    return [torch.empty(Q.shape[1], dtype=torch.int32, device=Q.device)
            for _ in range(n)]


def _call(key: str, dev: torch.device, *args, entry: str | None = None):
    """Launch the kernel counted under `key` ("<name>[.<mode>]", the
    library csrc/<name>.cu unless `_LIBRARY` maps the name) on dev's
    current stream through its entry point (default <library>_launch);
    count the launch."""
    lib = key.split(".")[0]
    lib = _LIBRARY.get(lib, lib)
    entry = entry or f"{lib}_launch"
    _build.launch(lib, entry, _SIGNATURES[lib, entry], dev, *args)
    LAUNCHES[key] += 1


def _n_score(params: AlignmentParams) -> int:
    """What a pairing with N scores under the local macro."""
    return -params.n_penalty if params.n_penalty is not None else 0


def _skip_flags(head_q: bool, head_t: bool, tail_q: bool, tail_t: bool):
    return int(head_q) | int(head_t) << 1 | int(tail_q) << 2 | int(tail_t) << 3


def int16_fits(Lq: int, params: AlignmentParams, limit: int) -> bool:
    """Every DP value of a LOCAL run over queries padded to Lq fits in
    int16.  The JAX package checks match x Lq < limit; here the N score
    counts as a substitution score there too, and two more terms must fit
    (ROADMAP C13): the kernels' -(match + mismatch) and the gap chains'
    floor, -(the worst substitution + gap_oe + gap_extend)."""
    n_score = _n_score(params)
    top = max(params.match, n_score) * Lq
    floor = max(params.mismatch, -n_score) + params.gap_oe + params.gap_extend
    return (top < limit and floor <= (1 << 15) - 1
            and params.match + params.mismatch <= (1 << 15) - 1)


def local_mode(ends: bool, Lq: int, params: AlignmentParams,
               has_n: bool = True) -> str:
    """The local_sw mode of a LOCAL launch without traceback over queries
    padded to Lq.  Ends: "end16" under GENOMICS_TPU_INT16_CELLS=1 (the
    JAX package's switch, read at each call) when every value fits in
    int16, else "end".  Scores: "score16" for an N-free batch when every
    value fits, else "score"; the JAX package asks for
    GENOMICS_TPU_INT16_SCORE=1 as well, which this port does not: the
    results are the same, and on an H100 SCORE16 took 0.16-0.41 of SCORE's
    time at every launch size from 830 to 65,536 pairs (chip_smoke.py
    phase 5, PERF.md section 6)."""
    if ends:
        on = os.environ.get("GENOMICS_TPU_INT16_CELLS") == "1"
        return "end16" if on and int16_fits(Lq, params, END16_LIMIT) else "end"
    return ("score16" if not has_n and int16_fits(Lq, params, SCORE16_LIMIT)
            else "score")


def local_launch_args(mode: str, Q: torch.Tensor, T: torch.Tensor,
                      params: AlignmentParams, with_n: bool,
                      group: int | None = None) -> tuple:
    """local_sw_launch's arguments but the stream, for time-major Q
    [Lq, B], T [Lt, B] uint8 in `mode` (a key of _LOCAL_MODES): the
    mode's number, with_n, the threads per pair (1) or, in the 16-bit
    modes, per two pairs (`group`, default `split_group`'s on Q's card),
    the inputs, the carries and the outputs (score, qend, tend, tb),
    last; qend/tend are None in the score modes and tb is the sqb cube
    [Lt//8, Lq, B] in tb mode."""
    Q, T = Q.contiguous(), T.contiguous()
    Lq, B = Q.shape
    if not mode.endswith("16"):
        group = 1
    elif group is None:
        group = split_group((B + 1) // 2, _sm_count(Q.device.index or 0))
    score, qend, tend, tb, gH, gE = _outputs(
        "local_sw", mode, Q, T, not mode.startswith("score"))
    return (_LOCAL_MODES[mode], int(with_n), group, Q, T, B, Lq, T.shape[0],
            params.match, params.mismatch, _n_score(params), params.gap_oe,
            params.gap_extend, gH, gE, score, qend, tend, tb)


def launch_local(args: tuple):
    """Launch local_sw on `local_launch_args`'s arguments (B > 0) and
    count it under local_sw.<mode>; returns (score, qend, tend, tb)."""
    _call(f"local_sw.{_LOCAL_NAMES[args[0]]}", args[3].device, *args)
    return args[-4:]


def _launch(mode: str, Q: torch.Tensor, T: torch.Tensor,
            params: AlignmentParams, with_n: bool):
    """Run local_sw in `mode` on time-major Q [Lq, B], T [Lt, B] uint8.
    Returns (score, qend, tend, tb); qend/tend are None in the score modes
    and tb is the sqb cube [Lt//8, Lq, B] in tb mode."""
    args = local_launch_args(mode, Q, T, params, with_n)
    return launch_local(args) if args[5] else args[-4:]


def local_align(
    q: torch.Tensor,   # [B, Lq] uint8, N4-padded
    t: torch.Tensor,   # [B, Lt] uint8, Lt % 8 == 0 on the card
    params: AlignmentParams,
    with_tb: bool = False,
    tb_layout: str = "sqb",
) -> AlignResult:
    """Score + (qend, tend) [+ traceback nibbles].  tb is [Lt//8, Lq, B]
    int32 ("sqb", what `ops.tb_walk` reads) or, with tb_layout="bsq",
    [B, Lt//8, Lq]."""
    _check_codes(q, t, 0)
    if tb_layout not in ("sqb", "bsq"):
        raise ValueError(f"tb_layout must be 'sqb' or 'bsq'; got {tb_layout!r}")
    mode = "tb" if with_tb else local_mode(True, q.shape[1], params)
    if on_cpu(q) and mode == "end16":
        res = local_align_batch16(q, t, params)
    elif on_cpu(q):
        res = local_align_batch(q, t, params, with_tb=with_tb)
    else:
        res = AlignResult(*_launch(mode, q.T, t.T, params, True))
    if with_tb and tb_layout == "bsq":
        res = res._replace(tb=res.tb.permute(2, 0, 1).contiguous())
    return res


def global_launch_args(Q: torch.Tensor, T: torch.Tensor, qlen, tlen,
                       params: AlignmentParams, with_tb: bool) -> tuple:
    """global_sw_launch's arguments but the stream, for time-major Q
    [Lq, B], T [Lt, B] uint8: the mode, the inputs, the [Lq, B] carries,
    the [B] score and the sqb cube [Lt//8, Lq, B] (None without
    traceback), last."""
    Q, T = Q.contiguous(), T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    mode = "tb" if with_tb else "score"
    score, _, _, tb, gH, gE = _outputs("global_sw", mode, Q, T, False)
    npen = params.n_penalty is not None
    return (int(with_tb), int(npen), Q, T, qlen, tlen, B, Lq, T.shape[0],
            params.match, params.mismatch, params.n_penalty if npen else 0,
            params.gap_open, params.gap_extend, gH, gE, score, tb)


def launch_global(args: tuple):
    """Launch global_sw on `global_launch_args`'s arguments (B > 0) and
    count it under global_sw.tb / global_sw.score; returns (score, tb)."""
    _call("global_sw.tb" if args[0] else "global_sw.score", args[2].device,
          *args)
    return args[-2:]


def global_align(
    q: torch.Tensor,      # [B, Lq] uint8, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8, Lt % 8 == 0 on the card
    qlen: torch.Tensor,   # [B] int32, 1..Lq
    tlen: torch.Tensor,   # [B] int32, 1..Lt
    params: AlignmentParams,
    with_tb: bool = False,
) -> AlignResult:
    """GLOBAL score H(tlen-1, qlen-1) [+ traceback nibbles, sqb
    [Lt//8, Lq, B]]; the ends are (qlen-1, tlen-1), as
    pallas_align.py:1279-1280 and :1316-1317 report them."""
    _check_codes(q, t, 0)
    _check_lengths(q, qlen, tlen)
    if on_cpu(q):
        return global_align_batch(q, t, qlen, tlen, params, with_tb=with_tb)
    args = global_launch_args(q.T, t.T, qlen, tlen, params, with_tb)
    score, tb = launch_global(args) if args[6] else args[-2:]
    return AlignResult(score, qlen - 1, tlen - 1, tb)


def semiglobal_align(
    q: torch.Tensor,      # [B, Lq] uint8, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8, Lt % 8 == 0
    qlen: torch.Tensor,   # [B] int32, 1..Lq
    tlen: torch.Tensor,   # [B] int32, 1..Lt
    params: AlignmentParams,
    head: SemiGlobalSkip = SemiGlobalSkip.NONE,
    tail: SemiGlobalSkip = SemiGlobalSkip.NONE,
    with_tb: bool = False,
) -> AlignResult:
    """SEMI_GLOBAL score and ends under the HEAD/TAIL skips, reference
    quirks included (see `ops.scan_align.semiglobal_align_batch`)
    [+ traceback nibbles, sqb [Lt//8, Lq, B]]."""
    _check_codes(q, t, 0)
    _check_lengths(q, qlen, tlen)
    if on_cpu(q):
        return semiglobal_align_batch(q, t, qlen, tlen, params, head=head,
                                      tail=tail, with_tb=with_tb)
    args = semiglobal_launch_args(q.T, t.T, qlen, tlen, params, head, tail,
                                  with_tb)
    return AlignResult(*(launch_semiglobal(args) if args[7] else args[-4:]))


def semiglobal_launch_args(Q: torch.Tensor, T: torch.Tensor, qlen, tlen,
                           params: AlignmentParams,
                           head: SemiGlobalSkip = SemiGlobalSkip.NONE,
                           tail: SemiGlobalSkip = SemiGlobalSkip.NONE,
                           with_tb: bool = False,
                           group: int | None = None) -> tuple:
    """semiglobal_sw_launch's arguments but the stream, for time-major Q
    [Lq, B], T [Lt, B] uint8: the mode (1 with traceback), the skip
    flags, the threads per pair (`group`, default `split_group`'s on Q's
    card), the inputs, the [Lq, B] carries and the outputs (score, qend,
    tend, tb), last; tb is the sqb cube [Lt//8, Lq, B] with traceback,
    else None."""
    Q, T = Q.contiguous(), T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    if group is None:
        group = split_group(B, _sm_count(Q.device.index or 0))
    score, qend, tend, tb, gH, gE = _outputs(
        "semiglobal_sw", "tb" if with_tb else "end", Q, T, True)
    flags = _skip_flags(**scan_align_full.skip_flags(head, tail))
    return (int(with_tb), flags, group, Q, T, qlen, tlen, B, Lq, T.shape[0],
            params.match, params.mismatch, _n_score(params), params.gap_open,
            params.gap_extend, gH, gE, score, qend, tend, tb)


def launch_semiglobal(args: tuple):
    """Launch semiglobal_sw on `semiglobal_launch_args`'s arguments (B >
    0) and count it under semiglobal_sw.tb / semiglobal_sw.end; returns
    (score, qend, tend, tb)."""
    _call("semiglobal_sw.tb" if args[0] else "semiglobal_sw.end",
          args[3].device, *args)
    return args[-4:]


def local_align_second(
    q: torch.Tensor,      # [B, Lq] uint8, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8, Lt % 8 == 0
    qlen: torch.Tensor,   # [B] int32
    tlen: torch.Tensor,   # [B] int32
    params: AlignmentParams,
) -> SecondResult:
    """Score + ends + GASAL2's inline second best (score2, qend2, tend2),
    one pass; the counterpart of `pallas_align.local_align_second_tpu`."""
    _check_codes(q, t, 0)
    _check_lengths(q, qlen, tlen)
    if on_cpu(q):
        return scan_align_full.local_align_second_batch(q, t, qlen, tlen,
                                                        params)
    Q, T = q.T.contiguous(), t.T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    score, qend, tend, _, gH, gE = _outputs("local_sw", "end", Q, T, True)
    score2, qend2, tend2 = _per_pair(3, Q)
    if B:
        _call("local_sw.second", Q.device, Q.data_ptr(), T.data_ptr(),
              qlen.data_ptr(), tlen.data_ptr(), B, Lq, T.shape[0],
              params.match, params.mismatch, _n_score(params), params.gap_oe,
              params.gap_extend, gH.data_ptr(), gE.data_ptr(),
              score.data_ptr(), qend.data_ptr(), tend.data_ptr(),
              score2.data_ptr(), qend2.data_ptr(), tend2.data_ptr(),
              entry="local_sw_second_launch")
    return SecondResult(score, qend, tend, score2, qend2, tend2)


def local_start(
    rev_q: torch.Tensor,      # [B, Lq] uint8, reversed word-aligned prefix
    rev_t: torch.Tensor,      # [B, Lt] uint8, Lt % 8 == 0
    fwd_score: torch.Tensor,  # [B] int32, the forward score
    params: AlignmentParams,
    qr8: torch.Tensor | None = None,  # [B] int32, the prefixes' extents
    tr8: torch.Tensor | None = None,
):
    """The LOCAL reverse pass: (cprime, sstrip, r0), [B] int32 each, as
    `pallas_align.local_start_tpu` returns them; build the inputs (and
    qr8 / tr8) with `scan_align_full.local_start_inputs`.  Given the
    extents, the kernel's walk ends at them and its pairs are launched
    ordered by qr8 x tr8 (`local_start_order`); the result is the same."""
    _check_codes(rev_q, rev_t, 0)
    _check_lengths(rev_q, fwd_score, *(x for x in (qr8, tr8) if x is not None))
    if (qr8 is None) != (tr8 is None):
        raise ValueError("pass both extents, qr8 and tr8, or neither")
    if on_cpu(rev_q):
        return scan_align_full._local_start_core(rev_q, rev_t, fwd_score,
                                                 params)
    args = local_start_launch_args(rev_q.T, rev_t.T, fwd_score, params, qr8,
                                   tr8)
    return launch_local_start(args) if args[6] else args[-3:]


# split_group's threads an SM at 4 threads a pair below which it takes 8
SPLIT_MIN_THREADS_PER_SM = 384


def split_group(n: int, sms: int) -> int:
    """Threads per pair of a local_start or semiglobal_sw launch of n
    pairs, or per two pairs of a 16-bit local_sw launch of n pair pairs,
    on a card with `sms` SMs: 4, or 8 where 4 n threads would give an SM
    fewer than SPLIT_MIN_THREADS_PER_SM (three 128-thread blocks).  G
    threads share the strips of their pair (pair pair) and cut its
    serial walk to about 1/G; 8 give a small launch's SMs more warps to
    hide a column's latency with, and cost three shuffles a column and
    G - 1 idle steps a round where a launch already fills them.  On an
    H100 (132 SMs) the rule takes 8 below 12,672 pairs (pair pairs) and 4
    from there.  `tools/kernel_variants.py --kernels groups` timed both
    (PERF.md section 6): 8 won at the engine's 3,382-pair launch in every
    kernel and at the 8,309 pair pairs of its 16,618-pair launch in the
    16-bit modes (by 21-31%); 4 won there in local_start and
    semiglobal_sw TB (by 4%; END lost 6%), and at bench.py's 65,536
    pairs."""
    return 4 if 4 * n >= SPLIT_MIN_THREADS_PER_SM * sms else 8


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def local_start_launch_args(Q: torch.Tensor, T: torch.Tensor, fwd_score,
                            params: AlignmentParams, qr8=None, tr8=None,
                            group: int | None = None) -> tuple:
    """local_start_launch's arguments but the stream, for time-major
    reversed Q [Lq, B], T [Lt, B] uint8, the [B] int32 forward scores and,
    optionally, the extents qr8 / tr8 (None: the full Lq x Lt walk): the
    inputs, no order, the sizes and scores, the threads per pair
    (`group`, default `split_group`'s on Q's card), the [Lq, B]
    carries and the [B] cprime, sstrip, r0, last."""
    Q, T = Q.contiguous(), T.contiguous()
    qr8, tr8 = (None if x is None else x.contiguous() for x in (qr8, tr8))
    Lq, B = Q.shape
    if group is None:
        group = split_group(B, _sm_count(Q.device.index or 0))
    gH, gE = _carry("local_start", Q, T)
    col, strip, row = _per_pair(3, Q)
    return (Q, T, fwd_score.contiguous(), qr8, tr8, None, B, Lq, T.shape[0],
            params.match, params.mismatch, _n_score(params), params.gap_oe,
            params.gap_extend, group, gH, gE, col, strip, row)


def local_start_order(args: tuple) -> tuple:
    """`local_start_launch_args`'s arguments (with extents) with the pairs
    ordered by qr8 x tr8, largest first: Q's and T's columns gathered in
    that order and the order (int32) passed on, through which the kernel
    reads each pair's forward score and extents and writes its outputs in
    place.  A warp runs as long as its slowest pair, and qr8 x tr8
    bounds the cells a pair's walk visits before it stops: at bench.py's
    shape the lanes do 0.296 of the columns their warps run in the
    launch's order and 0.934 in this one (PERF.md section 6)."""
    order = torch.argsort(args[3] * args[4], descending=True)
    return (args[0].index_select(1, order), args[1].index_select(1, order),
            *args[2:5], order.int(), *args[6:])


def launch_local_start(args: tuple):
    """Launch local_start on `local_start_launch_args`'s arguments (B >
    0), with extents its pairs ordered by `local_start_order`, and count
    it; returns (cprime, sstrip, r0) in the arguments' order."""
    if args[3] is not None:
        args = local_start_order(args)
    _call("local_start", args[0].device, *args)
    return args[-3:]


def semiglobal_start(
    rev_q: torch.Tensor,      # [B, Lq] uint8, reversed query (trailing 0)
    rev_t: torch.Tensor,      # [B, Lt] uint8, reversed target suffix
    qlen: torch.Tensor,       # [B] int32
    tlen: torch.Tensor,       # [B] int32
    row_off: torch.Tensor,    # [B] int32, 8 * gend_reg
    row_count: torch.Tensor,  # [B] int32, rows of the suffix
    fwd_score: torch.Tensor,  # [B] int32
    fwd_qend: torch.Tensor,   # [B] int32
    params: AlignmentParams,
    *, head_q: bool, head_t: bool, tail_q: bool, tail_t: bool,
):
    """The SEMI_GLOBAL reverse pass: (tstart, qstart), [B] int32 each,
    as `pallas_gs.semiglobal_start_intertask` returns them; build the
    inputs with `scan_align_full.semiglobal_start_inputs`."""
    _check_codes(rev_q, rev_t, 0)
    per_pair = (qlen, tlen, row_off, row_count, fwd_score, fwd_qend)
    _check_lengths(rev_q, *per_pair)
    flags = dict(head_q=head_q, head_t=head_t, tail_q=tail_q, tail_t=tail_t)
    if on_cpu(rev_q):
        return scan_align_full._semiglobal_start_core(
            rev_q, rev_t, *per_pair, params, **flags)
    args = semiglobal_start_launch_args(rev_q.T, rev_t.T, *per_pair, params,
                                        **flags)
    return launch_semiglobal_start(args) if args[9] else args[-2:]


def semiglobal_start_launch_args(Q: torch.Tensor, T: torch.Tensor, qlen,
                                 tlen, row_off, row_count, fwd_score,
                                 fwd_qend, params: AlignmentParams, *,
                                 head_q: bool, head_t: bool, tail_q: bool,
                                 tail_t: bool) -> tuple:
    """semiglobal_start_launch's arguments but the stream, for time-major
    reversed Q [Lq, B], T [Lt, B] uint8 and the [B] int32 per-pair inputs
    of `semiglobal_start`: the skip flags, the inputs, the [Lq, B]
    carries and the [B] tstart, qstart, last."""
    Q, T = Q.contiguous(), T.contiguous()
    per_pair = [x.contiguous() for x in (qlen, tlen, row_off, row_count,
                                         fwd_score, fwd_qend)]
    Lq, B = Q.shape
    gH, gE = _carry("semiglobal_start", Q, T)
    tstart, qstart = _per_pair(2, Q)
    return (_skip_flags(head_q, head_t, tail_q, tail_t), Q, T, *per_pair, B,
            Lq, T.shape[0], params.match, params.mismatch, _n_score(params),
            params.gap_open, params.gap_extend, gH, gE, tstart, qstart)


def by_row_count(args: tuple):
    """`semiglobal_start_launch_args`'s arguments with the pairs ordered
    by row_count (the inputs gathered, fresh [B] starts), and the order.
    One thread runs one pair, a warp as many strips as its longest pair,
    and row_count bounds a pair's strips: at bench.py's shape the lanes
    did 0.585 of the strips their warps ran in the launch's order and
    0.967 in this one (PERF.md section 6)."""
    order = torch.argsort(args[6])
    return (args[0], args[1].index_select(1, order),
            args[2].index_select(1, order),
            *(x.index_select(0, order) for x in args[3:9]), *args[9:-2],
            torch.empty_like(args[-2]), torch.empty_like(args[-1])), order


def launch_semiglobal_start(args: tuple):
    """Launch semiglobal_start on `semiglobal_start_launch_args`'s
    arguments (B > 0), its pairs ordered by row_count (`by_row_count`),
    and count it; returns (tstart, qstart) in the arguments' order."""
    ordered, order = by_row_count(args)
    _call("semiglobal_start", args[1].device, *ordered)
    for out, got in zip(args[-2:], ordered[-2:]):
        out.index_copy_(0, order, got)
    return args[-2:]


def _pads_to_sentinels(a: torch.Tensor, code: int) -> torch.Tensor:
    """The has_n=False contract: every N4 is padding.  Remapping query
    pads to 16 and target pads to 17 makes pad cells score as mismatches,
    which leaves the best local score unchanged (pallas_align.py:944-952)
    and lets the kernel drop the N compare."""
    return a.masked_fill(a == N4, code)


def local_align_scores(
    q: torch.Tensor,   # [B, Lq] uint8
    t: torch.Tensor,   # [B, Lt] uint8
    params: AlignmentParams,
    has_n: bool | None = None,
) -> torch.Tensor:
    """Local alignment scores only, [B] int32.  Pass has_n=False only
    when the batch holds no N other than padding."""
    return local_align_scores_tm(q.T, t.T, params, has_n)


def local_align_scores_tm(
    Q: torch.Tensor,   # [Lq, B] uint8, time-major
    T: torch.Tensor,   # [Lt, B] uint8
    params: AlignmentParams,
    has_n: bool | None = None,
) -> torch.Tensor:
    """Score-only over time-major batches, the layout `bench.py` feeds
    the TPU kernel; the kernel reads it without a transpose."""
    _check_codes(Q, T, 1)
    Q, T, with_n = _no_n_inputs(Q, T, has_n)
    mode = local_mode(False, Q.shape[0], params, with_n)
    if on_cpu(Q) and mode == "score16":
        return local_align_batch16(Q.T, T.T, params, ends=False).score
    if on_cpu(Q):
        return local_align_batch(Q.T, T.T, params).score
    return _launch(mode, Q, T, params, with_n)[0]


def _no_n_inputs(q, t, has_n: bool | None):
    """(q, t, with_n) for a score-only call: under has_n=False the pads
    become the 16/17 sentinels, so the kernel can drop the N compare and
    still score what the full kernel scores."""
    with_n = True if has_n is None else bool(has_n)
    if not with_n:
        q, t = _pads_to_sentinels(q, 16), _pads_to_sentinels(t, 17)
    return q, t, with_n


def ksw_layout(Lq: int) -> tuple[str, int]:
    """Where ksw_extend keeps its row state over queries padded to Lq, and
    its threads per block: ("shared", the most threads, a multiple of 32
    and at most 256, whose 9 (Lq + 1) bytes each fit KSW_SHARED_BYTES) up
    to Lq = KSW_SHARED_MAX_LQ (806), else ("global", 128): a [B, Lq + 1]
    int2 scratch in device memory.  A rule on the shape alone."""
    threads = min(KSW_MAX_THREADS,
                  KSW_SHARED_BYTES // (9 * (Lq + 1)) // 32 * 32)
    return ("shared", threads) if threads else ("global", KSW_GLOBAL_THREADS)


def ksw_launch_args(mode: str, q, t, qlen, tlen, h0,
                    params: AlignmentParams, with_n: bool,
                    force_global: bool = False) -> tuple:
    """ksw_extend_launch's arguments but the stream, for checked [B, L]
    uint8 q, t read as they are: the mode, the layout of `ksw_layout` (or
    the global one under `force_global`, which only the timings and the
    card tests ask for), the inputs, the scratch (None in the shared
    layout) and the [B] outputs (qend, tend None in score mode), last."""
    q, t = q.contiguous(), t.contiguous()
    qlen, tlen, h0 = qlen.contiguous(), tlen.contiguous(), h0.contiguous()
    B, Lq = q.shape
    kind, threads = (("global", KSW_GLOBAL_THREADS) if force_global
                     else ksw_layout(Lq))
    eh = (torch.empty((B, Lq + 1, 2), dtype=torch.int32, device=q.device)
          if kind == "global" else None)
    score, qend, tend = (torch.empty(B, dtype=torch.int32, device=q.device)
                         for _ in range(3))
    if mode == "score":
        qend = tend = None
    return (int(mode == "end"), int(with_n), int(kind == "shared"), threads,
            q, t, qlen, tlen, h0, B, Lq, t.shape[1], params.match,
            params.mismatch, _n_score(params), params.gap_oe,
            params.gap_extend, eh, score, qend, tend)


def launch_ksw(args: tuple):
    """Launch ksw_extend on `ksw_launch_args`'s arguments (B > 0) and
    count it under ksw.end / ksw.score; returns (score, qend, tend)."""
    _call("ksw.end" if args[0] else "ksw.score", args[4].device, *args)
    return args[-3:]


def _ksw_launch(mode: str, q, t, qlen, tlen, h0, params: AlignmentParams,
                with_n: bool, force_global: bool = False):
    """Run ksw_extend in `mode` on [B, L] uint8 q, t; returns (score,
    qend, tend), qend/tend None in score mode."""
    args = ksw_launch_args(mode, q, t, qlen, tlen, h0, params, with_n,
                           force_global)
    return launch_ksw(args) if args[9] else args[-3:]


def ksw_align(
    q: torch.Tensor,      # [B, Lq] uint8, N4-padded
    t: torch.Tensor,      # [B, Lt] uint8, N4-padded
    qlen: torch.Tensor,   # [B] int32
    tlen: torch.Tensor,   # [B] int32
    h0: torch.Tensor,     # [B] int32 seed scores
    params: AlignmentParams,
) -> AlignResult:
    """bwa-mem ksw_extend from the seed scores h0: score and (qend, tend)
    as `pallas_ksw.ksw_align_tpu` reports them (see
    `ops.scan_align.ksw_align_batch`)."""
    _check_codes(q, t, 0)
    _check_lengths(q, qlen, tlen, h0)
    if on_cpu(q):
        return ksw_align_batch(q, t, qlen, tlen, h0, params)
    return AlignResult(*_ksw_launch("end", q, t, qlen, tlen, h0, params,
                                    True))


def ksw_align_scores(q, t, qlen, tlen, h0, params: AlignmentParams,
                     has_n: bool | None = None) -> torch.Tensor:
    """ksw_extend scores only, [B] int32 (`pallas_ksw.ksw_align_scores_tpu`).
    Pass has_n=False only when the batch holds no N other than padding."""
    _check_codes(q, t, 0)
    _check_lengths(q, qlen, tlen, h0)
    q, t, with_n = _no_n_inputs(q, t, has_n)
    if on_cpu(q):
        return ksw_align_batch(q, t, qlen, tlen, h0, params).score
    return _ksw_launch("score", q, t, qlen, tlen, h0, params, with_n)[0]


def banded_ring(Lq: int, Lt: int, band_width_tiles: int) -> int:
    """The columns of banded_sw's carry ring over queries padded to Lq and
    targets padded to Lt (multiples of 8): a pair's band window is at most
    min(qr, (2 band - 1 + tr) // 2) tiles wide (qr, tr its tiles), so
    8 min(Lq // 8, (2 band - 1 + Lt // 8) // 2), at least 8.  A rule on
    the shape and the band: 104 of 152 columns at bench.py's shape
    (chip_smoke.band_windows counts the windows themselves)."""
    tiles = min(Lq // 8, (2 * band_width_tiles - 1 + Lt // 8) // 2)
    return 8 * max(1, tiles)


def banded_layout(ring: int) -> str:
    """Where banded_sw keeps its carry rings of `ring` columns: "shared"
    (32 threads a block, 8 ring bytes each) up to BANDED_SHARED_MAX_RING
    (908) columns, else "global" (a [B, ring] int2 scratch)."""
    return "shared" if ring <= BANDED_SHARED_MAX_RING else "global"


def banded_launch_args(mode: str, q, t, qlen, tlen, params: AlignmentParams,
                       band_width_tiles: int, with_n: bool,
                       force_global: bool = False,
                       ring: int | None = None) -> tuple:
    """banded_sw_launch's arguments but the stream, for checked [B, L]
    uint8 q, t read as they are (L % 8 == 0): the mode, the layout of
    `banded_layout` (or the global one under `force_global`), the inputs,
    the band, the carry's ring (default `banded_ring`'s; the
    timings and the card tests also ask for other rings and the global
    layout), the scratch (None in the shared layout) and the [B] outputs
    (qend, tend None in score mode), last."""
    q, t = q.contiguous(), t.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    B, Lq = q.shape
    if ring is None:
        ring = banded_ring(Lq, t.shape[1], band_width_tiles)
    shared = not force_global and banded_layout(ring) == "shared"
    eh = (None if shared else
          torch.empty((B, ring, 2), dtype=torch.int32, device=q.device))
    score, qend, tend = (torch.empty(B, dtype=torch.int32, device=q.device)
                         for _ in range(3))
    if mode == "score":
        qend = tend = None
    return (int(mode == "end"), int(with_n), int(shared), q, t, qlen, tlen,
            B, Lq, t.shape[1], band_width_tiles, params.match,
            params.mismatch, _n_score(params), params.gap_oe,
            params.gap_extend, ring, eh, score, qend, tend)


def launch_banded(args: tuple):
    """Launch banded_sw on `banded_launch_args`'s arguments (B > 0) and
    count it under banded_sw.end / banded_sw.score; returns (score, qend,
    tend) (qend, tend None in score mode)."""
    _call("banded_sw.end" if args[0] else "banded_sw.score", args[3].device,
          *args)
    return args[-3:]


def _banded_launch(mode: str, q, t, qlen, tlen, params: AlignmentParams,
                   band_width_tiles: int, with_n: bool):
    """Run banded_sw in `mode` on [B, L] uint8 q, t; returns (score, qend,
    tend), qend/tend None in score mode."""
    args = banded_launch_args(mode, q, t, qlen, tlen, params,
                              band_width_tiles, with_n)
    return launch_banded(args) if args[7] else args[-3:]


def _check_banded(q, t, qlen, tlen):
    _check_codes(q, t, 0)
    _check_lengths(q, qlen, tlen)
    if q.shape[1] % 8 or t.shape[1] % 8:
        raise ValueError(f"banded alignment walks 8-wide tiles; need "
                         f"Lq % 8 == Lt % 8 == 0, got {q.shape[1]}, "
                         f"{t.shape[1]}")


def banded_align(
    q: torch.Tensor,      # [B, Lq] uint8, N4-padded, Lq % 8 == 0
    t: torch.Tensor,      # [B, Lt] uint8, N4-padded, Lt % 8 == 0
    qlen: torch.Tensor,   # [B] int32
    tlen: torch.Tensor,   # [B] int32
    params: AlignmentParams,
    band_width_tiles: int,
) -> AlignResult:
    """GASAL2's banded local alignment: score and (qend, tend) as
    `pallas_ksw.banded_align_tpu` reports them (see
    `ops.scan_align.banded_align_batch`)."""
    _check_banded(q, t, qlen, tlen)
    if on_cpu(q):
        return banded_align_batch(q, t, qlen, tlen, params, band_width_tiles)
    return AlignResult(*_banded_launch("end", q, t, qlen, tlen, params,
                                       band_width_tiles, True))


def banded_align_scores(q, t, qlen, tlen, params: AlignmentParams,
                        band_width_tiles: int,
                        has_n: bool | None = None) -> torch.Tensor:
    """Banded scores only, [B] int32 (`pallas_ksw.banded_align_scores_tpu`).
    Pass has_n=False only when the batch holds no N other than padding;
    the scores equal the full kernel's (the TPU path's has_n=False scores
    pad cells as matches, ROADMAP C7)."""
    _check_banded(q, t, qlen, tlen)
    q, t, with_n = _no_n_inputs(q, t, has_n)
    if on_cpu(q):
        return banded_align_batch(q, t, qlen, tlen, params,
                                  band_width_tiles).score
    return _banded_launch("score", q, t, qlen, tlen, params,
                          band_width_tiles, with_n)[0]


def unpack_tb_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[..., Lt//8, Lq] int32 packed (row i in bits 4*(i%8)..) →
    [..., Lt, Lq] uint8 nibble matrix (the golds' tb_dirs format)."""
    *lead, Lt8, Lq = packed.shape
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=packed.device)
    rows = (packed[..., :, None, :] >> shifts[:, None]) & 0xF
    return rows.to(torch.uint8).reshape(*lead, Lt8 * 8, Lq)
