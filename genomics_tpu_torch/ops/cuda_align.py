"""The DP kernels on the card: the wrappers of `csrc/local_sw.cu`,
`csrc/global_sw.cu`, `csrc/semiglobal_sw.cu`, `csrc/local_start.cu`,
`csrc/semiglobal_start.cu`, `csrc/ksw_extend.cu` and `csrc/banded_sw.cu`.

The counterpart of `genomics_tpu/ops/pallas_align.py`,
`genomics_tpu/ops/pallas_gs.py` and `genomics_tpu/ops/pallas_ksw.py`.
Every function takes the plain version (`ops.scan_align`,
`ops.scan_align_full`) for tensors on the CPU and launches the
hand-written kernel for tensors on a CUDA device; any other device
raises.  There is no fallback from the kernel to the plain version.

One kernel (one thread per alignment) covers every batch size, so the
TPU's lanes / inter-task split has no counterpart here.  The modes
replace these Pallas kernels:

  local_sw.score       `_local_kernel_intertask_score` (pallas_align.py:482)
  local_sw.end         `_local_kernel_intertask` (pallas_align.py:221)
                       and the lanes kernel `_local_kernel` (:116)
  local_sw.tb          `_local_kernel_intertask_tb` (pallas_align.py:717)
                       and `_local_kernel` (:116) with traceback
  local_sw.second      `_local_kernel_intertask_second` (pallas_align.py:321)
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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core.encoding import N4
from genomics_tpu_torch.core.scoring import AlignmentParams, SemiGlobalSkip
from genomics_tpu_torch.ops import scan_align_full
from genomics_tpu_torch.ops.scan_align import (
    AlignResult,
    banded_align_batch,
    global_align_batch,
    ksw_align_batch,
    local_align_batch,
    semiglobal_align_batch,
)
from genomics_tpu_torch.ops.scan_align_full import SecondResult

# Kernel launches per kernel mode; a wrapper adds one where it launches.
LAUNCHES = {"local_sw.score": 0, "local_sw.end": 0, "local_sw.tb": 0,
            "local_sw.second": 0, "local_start": 0,
            "global_sw.score": 0, "global_sw.tb": 0,
            "semiglobal_sw.end": 0, "semiglobal_sw.tb": 0,
            "semiglobal_start": 0, "ksw.end": 0, "ksw.score": 0,
            "banded_sw.end": 0, "banded_sw.score": 0}
_LOCAL_MODES = {"score": 0, "end": 1, "tb": 2}

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# argument types of each exported entry point, by (library, entry)
_SIGNATURES = {
    # mode, with_n, Q, T, B, Lq, Lt, match, mismatch, n_score, goe, ge,
    # gH, gE, score, qend, tend, tb, stream
    ("local_sw", "local_sw_launch"):
        (_ci, _ci, _vp, _vp) + (_ci,) * 8 + (_vp,) * 7,
    # Q, T, qlen, tlen, B, Lq, Lt, match, mismatch, n_score, goe, ge, gH,
    # gE, score, qend, tend, score2, qend2, tend2, stream
    ("local_sw", "local_sw_second_launch"):
        (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 9,
    # Q, T, fwd, B, Lq, Lt, match, mismatch, n_score, goe, ge, gH, gE,
    # col, strip, row, stream
    ("local_start", "local_start_launch"): (_vp,) * 3 + (_ci,) * 8 + (_vp,) * 6,
    # mode, with_n_penalty, Q, T, qlen, tlen, B, Lq, Lt, match, mismatch,
    # n_penalty, gapo, ge, gH, gE, score, tb, stream
    ("global_sw", "global_sw_launch"):
        (_ci, _ci) + (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 5,
    # mode, flags, Q, T, qlen, tlen, B, Lq, Lt, match, mismatch, n_score,
    # gapo, ge, gH, gE, score, qend, tend, tb, stream
    ("semiglobal_sw", "semiglobal_sw_launch"):
        (_ci, _ci) + (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 7,
    # flags, Q, T, qlen, tlen, row_off, row_count, fwd_score, fwd_qend, B,
    # Lq, Lt, match, mismatch, n_score, gapo, ge, gH, gE, tstart, qstart,
    # stream
    ("semiglobal_start", "semiglobal_start_launch"):
        (_ci,) + (_vp,) * 8 + (_ci,) * 8 + (_vp,) * 5,
    # mode, with_n, Q, T, qlen, tlen, h0, B, Lq, Lt, match, mismatch,
    # n_score, goe, ge, ehh, ehe, score, qend, tend, stream
    ("ksw_extend", "ksw_extend_launch"):
        (_ci, _ci) + (_vp,) * 5 + (_ci,) * 8 + (_vp,) * 6,
    # mode, with_n, Q, T, qlen, tlen, B, Lq, Lt, k_band, match, mismatch,
    # n_score, goe, ge, gH, gE, score, qend, tend, stream
    ("banded_sw", "banded_sw_launch"):
        (_ci, _ci) + (_vp,) * 4 + (_ci,) * 9 + (_vp,) * 6,
}
# library of each launch-count key whose name is not the library's
_LIBRARY = {"ksw": "ksw_extend"}


@functools.cache
def _kernel(lib: str, entry: str):
    fn = getattr(_build.library(lib), entry)
    fn.argtypes = list(_SIGNATURES[lib, entry])
    fn.restype = _ci
    return fn


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor, False for a CUDA tensor; raises otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {x.device}")


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
    gH, gE = _carry(name, Q, T)
    Lq, B = Q.shape
    score, qend, tend = _per_pair(3, Q)
    tb = (torch.empty((T.shape[0] // 8, Lq, B), dtype=torch.int32,
                      device=Q.device) if mode == "tb" else None)
    return score, (qend if ends else None), (tend if ends else None), tb, gH, gE


def _carry(name: str, Q: torch.Tensor, T: torch.Tensor):
    """The per-column H/E carry between strips (GASAL2's global[] array):
    two [Lq, B] int32 scratch tensors on Q's device."""
    if T.shape[0] % 8:
        raise ValueError(f"{name} walks 8-row target strips; Lt={T.shape[0]}")
    return [torch.empty(Q.shape, dtype=torch.int32, device=Q.device)
            for _ in range(2)]


def _per_pair(n: int, Q: torch.Tensor):
    """n int32 [B] outputs on Q's device."""
    return [torch.empty(Q.shape[1], dtype=torch.int32, device=Q.device)
            for _ in range(n)]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _call(key: str, dev: torch.device, *args, entry: str | None = None):
    """Launch the kernel counted under `key` ("<name>[.<mode>]", the
    library csrc/<name>.cu unless `_LIBRARY` maps the name) on dev's
    current stream through its entry point (default <library>_launch);
    count the launch."""
    lib = key.split(".")[0]
    lib = _LIBRARY.get(lib, lib)
    fn = _kernel(lib, entry or f"{lib}_launch")
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{key} launch failed: CUDA error {err}")
    LAUNCHES[key] += 1


def _n_score(params: AlignmentParams) -> int:
    """What a pairing with N scores under the local macro."""
    return -params.n_penalty if params.n_penalty is not None else 0


def _skip_flags(head_q: bool, head_t: bool, tail_q: bool, tail_t: bool):
    return int(head_q) | int(head_t) << 1 | int(tail_q) << 2 | int(tail_t) << 3


def _launch(mode: str, Q: torch.Tensor, T: torch.Tensor,
            params: AlignmentParams, with_n: bool):
    """Run local_sw in `mode` on time-major Q [Lq, B], T [Lt, B] uint8.
    Returns (score, qend, tend, tb); qend/tend are None in score mode and
    tb is the sqb cube [Lt//8, Lq, B] in tb mode."""
    Q, T = Q.contiguous(), T.contiguous()
    Lq, B = Q.shape
    score, qend, tend, tb, gH, gE = _outputs("local_sw", mode, Q, T,
                                             mode != "score")
    if B:
        _call(f"local_sw.{mode}", Q.device, _LOCAL_MODES[mode], int(with_n),
              Q.data_ptr(), T.data_ptr(), B, Lq, T.shape[0], params.match,
              params.mismatch, _n_score(params), params.gap_oe,
              params.gap_extend,
              gH.data_ptr(), gE.data_ptr(), score.data_ptr(), _ptr(qend),
              _ptr(tend), _ptr(tb))
    return score, qend, tend, tb


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
    if _on_cpu(q):
        res = local_align_batch(q, t, params, with_tb=with_tb)
    else:
        res = AlignResult(*_launch("tb" if with_tb else "end", q.T, t.T,
                                   params, True))
    if with_tb and tb_layout == "bsq":
        res = res._replace(tb=res.tb.permute(2, 0, 1).contiguous())
    return res


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
    if _on_cpu(q):
        return global_align_batch(q, t, qlen, tlen, params, with_tb=with_tb)
    mode = "tb" if with_tb else "score"
    Q, T = q.T.contiguous(), t.T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    score, _, _, tb, gH, gE = _outputs("global_sw", mode, Q, T, False)
    if B:
        npen = params.n_penalty is not None
        _call(f"global_sw.{mode}", Q.device, int(with_tb), int(npen),
              Q.data_ptr(), T.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
              B, Lq, T.shape[0], params.match, params.mismatch,
              params.n_penalty if npen else 0, params.gap_open,
              params.gap_extend, gH.data_ptr(), gE.data_ptr(),
              score.data_ptr(), _ptr(tb))
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
    if _on_cpu(q):
        return semiglobal_align_batch(q, t, qlen, tlen, params, head=head,
                                      tail=tail, with_tb=with_tb)
    mode = "tb" if with_tb else "end"
    Q, T = q.T.contiguous(), t.T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    score, qend, tend, tb, gH, gE = _outputs("semiglobal_sw", mode, Q, T, True)
    if B:
        flags = _skip_flags(**scan_align_full.skip_flags(head, tail))
        _call(f"semiglobal_sw.{mode}", Q.device, int(with_tb), flags,
              Q.data_ptr(), T.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
              B, Lq, T.shape[0], params.match, params.mismatch,
              _n_score(params),
              params.gap_open, params.gap_extend, gH.data_ptr(),
              gE.data_ptr(), score.data_ptr(), qend.data_ptr(),
              tend.data_ptr(), _ptr(tb))
    return AlignResult(score, qend, tend, tb)


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
    if _on_cpu(q):
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
):
    """The LOCAL reverse pass: (cprime, sstrip, r0), [B] int32 each, as
    `pallas_align.local_start_tpu` returns them; build the inputs with
    `scan_align_full.local_start_inputs`."""
    _check_codes(rev_q, rev_t, 0)
    _check_lengths(rev_q, fwd_score)
    if _on_cpu(rev_q):
        return scan_align_full._local_start_core(rev_q, rev_t, fwd_score,
                                                 params)
    Q, T = rev_q.T.contiguous(), rev_t.T.contiguous()
    fwd = fwd_score.contiguous()
    Lq, B = Q.shape
    gH, gE = _carry("local_start", Q, T)
    col, strip, row = _per_pair(3, Q)
    if B:
        _call("local_start", Q.device, Q.data_ptr(), T.data_ptr(),
              fwd.data_ptr(), B, Lq, T.shape[0], params.match,
              params.mismatch, _n_score(params), params.gap_oe,
              params.gap_extend, gH.data_ptr(), gE.data_ptr(),
              col.data_ptr(), strip.data_ptr(), row.data_ptr())
    return col, strip, row


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
    if _on_cpu(rev_q):
        return scan_align_full._semiglobal_start_core(
            rev_q, rev_t, *per_pair, params, **flags)
    Q, T = rev_q.T.contiguous(), rev_t.T.contiguous()
    per_pair = [x.contiguous() for x in per_pair]
    Lq, B = Q.shape
    gH, gE = _carry("semiglobal_start", Q, T)
    tstart, qstart = _per_pair(2, Q)
    if B:
        _call("semiglobal_start", Q.device, _skip_flags(**flags),
              Q.data_ptr(), T.data_ptr(), *(x.data_ptr() for x in per_pair),
              B, Lq, T.shape[0], params.match, params.mismatch,
              _n_score(params), params.gap_open, params.gap_extend,
              gH.data_ptr(), gE.data_ptr(), tstart.data_ptr(),
              qstart.data_ptr())
    return tstart, qstart


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
    if _on_cpu(Q):
        return local_align_batch(Q.T, T.T, params).score
    return _launch("score", Q, T, params, with_n)[0]


def _no_n_inputs(q, t, has_n: bool | None):
    """(q, t, with_n) for a score-only call: under has_n=False the pads
    become the 16/17 sentinels, so the kernel can drop the N compare and
    still score what the full kernel scores."""
    with_n = True if has_n is None else bool(has_n)
    if not with_n:
        q, t = _pads_to_sentinels(q, 16), _pads_to_sentinels(t, 17)
    return q, t, with_n


def _ksw_launch(mode: str, q, t, qlen, tlen, h0, params: AlignmentParams,
                with_n: bool):
    """Run ksw_extend in `mode` on [B, L] uint8 q, t; returns (score,
    qend, tend), qend/tend None in score mode."""
    Q, T = q.T.contiguous(), t.T.contiguous()
    qlen, tlen, h0 = qlen.contiguous(), tlen.contiguous(), h0.contiguous()
    Lq, B = Q.shape
    # eh[] has a live slot at column end <= qlen: Lq + 1 rows
    ehh, ehe = (torch.empty((Lq + 1, B), dtype=torch.int32, device=Q.device)
                for _ in range(2))
    score, qend, tend = _per_pair(3, Q)
    if mode == "score":
        qend = tend = None
    if B:
        _call(f"ksw.{mode}", Q.device, int(mode == "end"), int(with_n),
              Q.data_ptr(), T.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
              h0.data_ptr(), B, Lq, T.shape[0], params.match,
              params.mismatch, _n_score(params), params.gap_oe,
              params.gap_extend, ehh.data_ptr(), ehe.data_ptr(),
              score.data_ptr(), _ptr(qend), _ptr(tend))
    return score, qend, tend


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
    if _on_cpu(q):
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
    if _on_cpu(q):
        return ksw_align_batch(q, t, qlen, tlen, h0, params).score
    return _ksw_launch("score", q, t, qlen, tlen, h0, params, with_n)[0]


def _banded_launch(mode: str, q, t, qlen, tlen, params: AlignmentParams,
                   band_width_tiles: int, with_n: bool):
    """Run banded_sw in `mode` on [B, L] uint8 q, t; returns (score, qend,
    tend), qend/tend None in score mode."""
    Q, T = q.T.contiguous(), t.T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    gH, gE = _carry("banded_sw", Q, T)
    score, qend, tend = _per_pair(3, Q)
    if mode == "score":
        qend = tend = None
    if B:
        _call(f"banded_sw.{mode}", Q.device, int(mode == "end"), int(with_n),
              Q.data_ptr(), T.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
              B, Lq, T.shape[0], band_width_tiles, params.match,
              params.mismatch, _n_score(params), params.gap_oe,
              params.gap_extend, gH.data_ptr(), gE.data_ptr(),
              score.data_ptr(), _ptr(qend), _ptr(tend))
    return score, qend, tend


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
    if _on_cpu(q):
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
    if _on_cpu(q):
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
