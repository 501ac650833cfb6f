"""The DP kernels on the card: the wrappers of `csrc/local_sw.cu`,
`csrc/global_sw.cu` and `csrc/semiglobal_sw.cu`.

The counterpart of `genomics_tpu/ops/pallas_align.py` and
`genomics_tpu/ops/pallas_gs.py`.  Every function takes the plain version
(`ops.scan_align`) for tensors on the CPU and launches the hand-written
kernel for tensors on a CUDA device; any other device raises.  There is
no fallback from the kernel to the plain version.

One kernel (one thread per alignment) covers every batch size, so the
TPU's lanes / inter-task split has no counterpart here.  The modes
replace these Pallas kernels:

  local_sw.score       `_local_kernel_intertask_score` (pallas_align.py:482)
  local_sw.end         `_local_kernel_intertask` (pallas_align.py:221)
                       and the lanes kernel `_local_kernel` (:116)
  local_sw.tb          `_local_kernel_intertask_tb` (pallas_align.py:717)
                       and `_local_kernel` (:116) with traceback
  global_sw.score      `_global_kernel_intertask` (pallas_gs.py:65)
  global_sw.tb         `_global_kernel` (pallas_align.py:1201) with traceback
  semiglobal_sw.end    `_semiglobal_kernel_intertask` (pallas_gs.py:181)
  semiglobal_sw.tb     `_semiglobal_kernel` (pallas_align.py:1325) with
                       traceback
"""
from __future__ import annotations

import ctypes
import functools

import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.core.encoding import N4
from genomics_tpu_torch.core.scoring import AlignmentParams, SemiGlobalSkip
from genomics_tpu_torch.ops.scan_align import (
    AlignResult,
    global_align_batch,
    local_align_batch,
    semiglobal_align_batch,
)

# Kernel launches per kernel mode; a wrapper adds one where it launches.
LAUNCHES = {"local_sw.score": 0, "local_sw.end": 0, "local_sw.tb": 0,
            "global_sw.score": 0, "global_sw.tb": 0,
            "semiglobal_sw.end": 0, "semiglobal_sw.tb": 0}
_LOCAL_MODES = {"score": 0, "end": 1, "tb": 2}

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# argument types of each csrc/<name>.cu entry point <name>_launch
_SIGNATURES = {
    # mode, with_n, Q, T, B, Lq, Lt, match, mismatch, n_score, goe, ge,
    # gH, gE, score, qend, tend, tb, stream
    "local_sw": (_ci, _ci, _vp, _vp) + (_ci,) * 8 + (_vp,) * 7,
    # mode, with_n_penalty, Q, T, qlen, tlen, B, Lq, Lt, match, mismatch,
    # n_penalty, gapo, ge, gH, gE, score, tb, stream
    "global_sw": (_ci, _ci) + (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 5,
    # mode, flags, Q, T, qlen, tlen, B, Lq, Lt, match, mismatch, n_score,
    # gapo, ge, gH, gE, score, qend, tend, tb, stream
    "semiglobal_sw": (_ci, _ci) + (_vp,) * 4 + (_ci,) * 8 + (_vp,) * 7,
}


@functools.cache
def _kernel(name: str):
    fn = getattr(_build.library(name), f"{name}_launch")
    fn.argtypes = list(_SIGNATURES[name])
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


def _check_lengths(qlen: torch.Tensor, tlen: torch.Tensor, q: torch.Tensor):
    B = q.shape[0]
    for x in (qlen, tlen):
        if x.shape != (B,) or x.dtype != torch.int32 or x.device != q.device:
            raise ValueError(f"qlen/tlen must be int32 [{B}] on {q.device}; "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _outputs(name: str, mode: str, Q: torch.Tensor, T: torch.Tensor,
             ends: bool):
    """Allocate a launch's outputs and scratch on Q's device.  Returns
    (score, qend, tend, tb, gH, gE); qend/tend are None without `ends`
    and tb is the sqb cube [Lt//8, Lq, B] in tb mode."""
    Lq, B = Q.shape
    Lt = T.shape[0]
    if Lt % 8:
        raise ValueError(f"{name} walks 8-row target strips; Lt={Lt}")
    dev, i32 = Q.device, torch.int32
    score = torch.empty(B, dtype=i32, device=dev)
    qend = torch.empty(B, dtype=i32, device=dev) if ends else None
    tend = torch.empty(B, dtype=i32, device=dev) if ends else None
    tb = (torch.empty((Lt // 8, Lq, B), dtype=i32, device=dev)
          if mode == "tb" else None)
    # per-column H/E carry between strips (GASAL2's global[] array)
    gH = torch.empty((Lq, B), dtype=i32, device=dev)
    gE = torch.empty((Lq, B), dtype=i32, device=dev)
    return score, qend, tend, tb, gH, gE


def _ptr(x):
    return None if x is None else x.data_ptr()


def _call(name: str, mode: str, dev: torch.device, *args):
    """Launch csrc/<name>.cu on dev's current stream; count the launch."""
    fn = _kernel(name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} ({mode}) launch failed: CUDA error {err}")
    LAUNCHES[f"{name}.{mode}"] += 1


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
        n_score = -params.n_penalty if params.n_penalty is not None else 0
        _call("local_sw", mode, Q.device, _LOCAL_MODES[mode], int(with_n),
              Q.data_ptr(), T.data_ptr(), B, Lq, T.shape[0], params.match,
              params.mismatch, n_score, params.gap_oe, params.gap_extend,
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
    _check_lengths(qlen, tlen, q)
    if _on_cpu(q):
        return global_align_batch(q, t, qlen, tlen, params, with_tb=with_tb)
    mode = "tb" if with_tb else "score"
    Q, T = q.T.contiguous(), t.T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    score, _, _, tb, gH, gE = _outputs("global_sw", mode, Q, T, False)
    if B:
        npen = params.n_penalty is not None
        _call("global_sw", mode, Q.device, int(with_tb), int(npen),
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
    _check_lengths(qlen, tlen, q)
    if _on_cpu(q):
        return semiglobal_align_batch(q, t, qlen, tlen, params, head=head,
                                      tail=tail, with_tb=with_tb)
    mode = "tb" if with_tb else "end"
    Q, T = q.T.contiguous(), t.T.contiguous()
    qlen, tlen = qlen.contiguous(), tlen.contiguous()
    Lq, B = Q.shape
    score, qend, tend, tb, gH, gE = _outputs("semiglobal_sw", mode, Q, T, True)
    if B:
        flags = (bool(head & SemiGlobalSkip.QUERY)
                 | bool(head & SemiGlobalSkip.TARGET) << 1
                 | bool(tail & SemiGlobalSkip.QUERY) << 2
                 | bool(tail & SemiGlobalSkip.TARGET) << 3)
        n_score = -params.n_penalty if params.n_penalty is not None else 0
        _call("semiglobal_sw", mode, Q.device, int(with_tb), flags,
              Q.data_ptr(), T.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
              B, Lq, T.shape[0], params.match, params.mismatch, n_score,
              params.gap_open, params.gap_extend, gH.data_ptr(),
              gE.data_ptr(), score.data_ptr(), qend.data_ptr(),
              tend.data_ptr(), _ptr(tb))
    return AlignResult(score, qend, tend, tb)


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
    with_n = True if has_n is None else bool(has_n)
    if not with_n:
        Q, T = _pads_to_sentinels(Q, 16), _pads_to_sentinels(T, 17)
    if _on_cpu(Q):
        return local_align_batch(Q.T, T.T, params).score
    return _launch("score", Q, T, params, with_n)[0]


def unpack_tb_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """[..., Lt//8, Lq] int32 packed (row i in bits 4*(i%8)..) →
    [..., Lt, Lq] uint8 nibble matrix (the golds' tb_dirs format)."""
    *lead, Lt8, Lq = packed.shape
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=packed.device)
    rows = (packed[..., :, None, :] >> shifts[:, None]) & 0xF
    return rows.to(torch.uint8).reshape(*lead, Lt8 * 8, Lq)
