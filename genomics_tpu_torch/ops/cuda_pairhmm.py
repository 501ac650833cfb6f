"""PairHMM forward likelihoods on the card: the wrappers of
`csrc/pairhmm_intertask.cu` and `csrc/pairhmm_wavefront.cu`, the
counterpart of `genomics_tpu/ops/pallas_pairhmm.py` (names drop `_tpu`).

Every function takes the plain version (`ops.scan_pairhmm`) for tensors on
the CPU and launches its hand-written kernel for tensors on a CUDA device;
any other device raises.  There is no fallback from a kernel to the plain
version.  Both kernels run one template (`csrc/pairhmm.cuh`): G lanes a
pair, K read rows a lane, each round's last row handed to the next round
in shared memory (or a device scratch past its limit).  They replace:

  pairhmm.intertask   `_intertask_kernel` (pallas_pairhmm.py:208): the
                      fewest lanes a pair whose rows cover R in one round
                      (`intertask_shape`; `compute_likelihoods`)
  pairhmm.wavefront   `_pairhmm_kernel` (pallas_pairhmm.py:140): one warp a
                      pair, 4, 5 or 8 rows a lane (`wavefront_rows` on R):
                      small batches of long pairs

Both read the natural [B, R] / [B, C] layout in place; the TPU's [R+C, B]
affine padding and pre-shifted alpha are Mosaic layout work and are not
carried over.  Both kernels compute the reference's three __fmaf_rn sites
single-rounded, so `exact=` is kept for API parity and has no effect: both
values give the gold's bits (ROADMAP C8).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.ops import cuda_align, scan_pairhmm
from genomics_tpu_torch.device import checked_device, on_cpu
from genomics_tpu_torch.utils import profiling

# Kernel launches; a wrapper adds one where it launches its kernel.
LAUNCHES = {"pairhmm.intertask": 0, "pairhmm.wavefront": 0}
PARAMS = ("Qm_1", "Qm", "delta", "xiksi", "alpha")
THREADS = 128            # pairhmm.cuh kThreads
SHARED_BYTES = 232_448   # pairhmm.cuh kMaxShared: a block's most on sm_90
# pairhmm_wavefront.cu's rows a lane (32 lanes a pair); the (lanes a
# pair, rows a lane) pairhmm_intertask.cu is built for, fewest lanes first
WAVEFRONT_ROWS = (4, 5, 8)
INTERTASK_SHAPES = ((4, 8), (8, 8), (16, 8), (16, 10), (32, 8))

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# [group,] rows_per_lane, shared, reads, haps, rlen, clen, 5 params, B, R,
# C, hand, out, stream
_INTERTASK_ARGS = (_ci,) * 3 + (_vp,) * 9 + (_ci,) * 3 + (_vp,) * 3
_WAVEFRONT_ARGS = _INTERTASK_ARGS[1:]


def prepare_params_np(base_quals, ins_quals, del_quals):
    """Host-side (numpy) params, [B, R] f32 each
    (`pallas_pairhmm.prepare_params_np`; the reference builds ph2pr on the
    host too, warp_based.cu:209-213, 341-360): the tables of
    `scan_pairhmm.param_tables` gathered with numpy."""
    return scan_pairhmm.gather_params(
        scan_pairhmm.param_tables(), *(np.asarray(q, np.int64)
                                       for q in (base_quals, ins_quals,
                                                 del_quals)))


def _check(reads, haps, rlen, clen, params):
    """Raises unless reads [B, R] / haps [B, C] are uint8, rlen / clen
    int32 [B] and the params f32 [B, R], all on one device."""
    B, R = reads.shape
    if reads.dtype != torch.uint8 or haps.dtype != torch.uint8:
        raise TypeError(f"reads and haps must be uint8 raw bytes; got "
                        f"{reads.dtype}, {haps.dtype}")
    if haps.dim() != 2 or haps.shape[0] != B:
        raise ValueError(f"mismatched batches: {tuple(reads.shape)} vs "
                         f"{tuple(haps.shape)}")
    for x in (rlen, clen):
        if x.shape != (B,) or x.dtype != torch.int32:
            raise ValueError(f"rlen / clen must be int32 [{B}]; got "
                             f"{x.dtype} {tuple(x.shape)}")
    for k in PARAMS:
        x = params[k]
        if x.shape != (B, R) or x.dtype != torch.float32:
            raise ValueError(f"param {k} must be f32 [{B}, {R}]; got "
                             f"{x.dtype} {tuple(x.shape)}")
    for x in (haps, rlen, clen, *(params[k] for k in PARAMS)):
        if x.device != reads.device:
            raise ValueError(f"inputs on {reads.device} and {x.device}")


def wavefront_rows(R: int) -> int:
    """K, the read rows each of the wavefront's 32 lanes holds for reads
    padded to R: the least of WAVEFRONT_ROWS whose 32 K rows cover R (one
    round, no handover), else the most.  A pair's chain of serial steps is
    then clen + ceil(R / K) - 1 steps of K cells: 4 at run_all.py's 128,
    5 at the candidates' 150, 8 at 250."""
    return next((k for k in WAVEFRONT_ROWS if 32 * k >= R), WAVEFRONT_ROWS[-1])


def intertask_shape(R: int, B: int, sms: int) -> tuple[int, int]:
    """(G lanes a pair, K rows a lane) of an inter-task launch of B pairs
    over reads padded to R on a card with `sms` SMs.  Up to 256 rows, one
    round with no handover: the first of INTERTASK_SHAPES whose G K rows
    cover R (4 x 8 to 32 rows, 8 x 8 to 64, 16 x 8 to 128, 16 x 10 to
    160, 32 x 8 to 256); B and `sms` do not enter.  Past 256 rows, rounds
    of 8 rows a lane on `cuda_align.split_group`'s 4 or 8 lanes, the rule
    on the launch size of the split alignment kernels.  One round
    measured faster than rounds with the handover in shared memory at
    run_all.py's 128 rows and the regions' 150 (PERF.md section 6)."""
    one_round = [(G, K) for G, K in INTERTASK_SHAPES if G * K >= R]
    return one_round[0] if one_round else (cuda_align.split_group(B, sms), 8)


def handover_layout(R: int, C: int, group: int, rows: int) -> str:
    """Where a launch of `group` lanes a pair and `rows` rows a lane keeps
    each round's last row for the next round, over reads padded to R and
    haplotypes padded to C: "none" where one round covers R; "shared"
    where a 128-thread block's 128 / group pairs' rows, 8 C bytes each,
    fit SHARED_BYTES (C up to 908 at 4 lanes a pair, 1,816 at 8, 3,632
    at 16, 7,264 at 32); else "global", a [2, C, B] f32 device scratch.
    A rule on the shape alone."""
    if R <= group * rows:
        return "none"
    return ("shared" if 8 * C * (THREADS // group) <= SHARED_BYTES
            else "global")


def _layout(lead: tuple, group: int, rows: int, reads, haps, rlen, clen,
            params, force_global: bool) -> tuple:
    """An entry point's arguments but the stream: `lead` (the group and
    the rows a lane, or the rows alone), the shared flag, the inputs as
    they are, B, R, C, the
    handover scratch (None but in the global layout) and the [B] f32
    output, last.  `force_global` (timings and card tests only) takes the
    device scratch wherever a read needs more than one round."""
    B, R = reads.shape
    C = haps.shape[1]
    kind = handover_layout(R, C, group, rows)
    if force_global and kind != "none":
        kind = "global"
    hand = (torch.empty((2, C, B), dtype=torch.float32, device=reads.device)
            if kind == "global" else None)
    return (*lead, int(kind != "global"),
            *(x.contiguous() for x in (reads, haps, rlen, clen,
                                       *(params[k] for k in PARAMS))),
            B, R, C, hand,
            torch.empty(B, dtype=torch.float32, device=reads.device))


def intertask_layout(reads, haps, rlen, clen, params, shape=None,
                     force_global: bool = False) -> tuple:
    """`pairhmm_intertask_launch`'s arguments but the stream, for checked
    inputs on the card: G lanes a pair and K rows a lane (`shape`, one of
    INTERTASK_SHAPES, default `intertask_shape`'s), the handover of
    `handover_layout` (or the global one under `force_global`)."""
    B, R = reads.shape
    G, K = shape or intertask_shape(
        R, B, cuda_align._sm_count(reads.device.index or 0))
    return _layout((G, K), G, K, reads, haps, rlen, clen, params,
                   force_global)


def launch_intertask(layout: tuple) -> torch.Tensor:
    """Launch csrc/pairhmm_intertask.cu on `intertask_layout`'s arguments
    (B > 0) and count it; returns the [B] output."""
    _build.launch("pairhmm_intertask", "pairhmm_intertask_launch",
                  _INTERTASK_ARGS, layout[3].device, *layout)
    LAUNCHES["pairhmm.intertask"] += 1
    return layout[-1]


def wavefront_layout(reads, haps, rlen, clen, params, rows_per_lane=None,
                     force_global: bool = False) -> tuple:
    """`pairhmm_wavefront_launch`'s arguments but the stream, for checked
    inputs on the card: one warp a pair, K rows a lane (`rows_per_lane`,
    default `wavefront_rows(R)`), the handover of `handover_layout` (or
    the global one under `force_global`)."""
    K = rows_per_lane or wavefront_rows(reads.shape[1])
    return _layout((K,), 32, K, reads, haps, rlen, clen, params,
                   force_global)


def launch_wavefront(layout: tuple) -> torch.Tensor:
    """Launch csrc/pairhmm_wavefront.cu on `wavefront_layout`'s arguments
    (B > 0) and count it; returns the [B] output."""
    _build.launch("pairhmm_wavefront", "pairhmm_wavefront_launch",
                  _WAVEFRONT_ARGS, layout[2].device, *layout)
    LAUNCHES["pairhmm.wavefront"] += 1
    return layout[-1]


def pairhmm_forward_intertask_prepared(reads, haps, rlen, clen, params,
                                       exact: bool = False) -> torch.Tensor:
    """G lanes a pair, K rows a lane (`intertask_shape`) → [B] f32
    (`pairhmm_forward_intertask_prepared`).
    reads [B, R] / haps [B, C] uint8 raw bytes, rlen / clen int32 [B],
    params the [B, R] f32 dict of `scan_pairhmm.prepare_params`, read in
    place (`intertask_layout`).  `exact` has no effect."""
    _check(reads, haps, rlen, clen, params)
    if on_cpu(reads):
        return scan_pairhmm.forward_prepared(reads, haps, rlen, clen, params)
    layout = intertask_layout(reads, haps, rlen, clen, params)
    return launch_intertask(layout) if reads.shape[0] else layout[-1]


def pairhmm_forward_prepared(reads, haps, rlen, clen, params,
                             exact: bool = False) -> torch.Tensor:
    """One warp a pair, anti-diagonal wavefront → [B] f32
    (`pairhmm_forward_tpu_prepared`).  Same inputs as
    `pairhmm_forward_intertask_prepared`, read in place
    (`wavefront_layout`).  `exact` has no effect."""
    _check(reads, haps, rlen, clen, params)
    if on_cpu(reads):
        return scan_pairhmm.forward_prepared(reads, haps, rlen, clen, params)
    layout = wavefront_layout(reads, haps, rlen, clen, params)
    return launch_wavefront(layout) if reads.shape[0] else layout[-1]


def pairhmm_forward(reads, haps, rlen, clen, base_quals, ins_quals,
                    del_quals, exact: bool = True) -> torch.Tensor:
    """Batched forward likelihoods through the wavefront kernel → [B] f32
    (`pairhmm_forward_tpu`).  The params are gathered on the inputs' device
    from the gold's numpy table, and D0 is divided in the kernel, so this
    wrapper is bit-equal to the gold too.  `exact` has no effect."""
    p = scan_pairhmm.prepare_params(base_quals, ins_quals, del_quals)
    return pairhmm_forward_prepared(reads, haps, rlen, clen, p)


def pairhmm_forward_dataset(records, pad_r=None, pad_c=None, exact=True,
                            device="cuda"):
    """Parsed dataset records → numpy [B] f32 through the wavefront kernel
    on `device` (`pairhmm_forward_tpu_dataset`).  On the card the copy
    out waits for the kernel."""
    with profiling.span("pairhmm.pack") as sp:
        packed = scan_pairhmm.pack_records(records, pad_r, pad_c)
        if sp:
            sp.count("pairhmm.pairs", len(records))
            sp.count("pairhmm.cells",
                     int(packed[2].astype(np.int64) @ packed[3]))
    with profiling.span("pairhmm.copy_in"):
        t, p = scan_pairhmm.device_inputs(packed, checked_device(device))
    with profiling.span("pairhmm.launch"):
        lik = pairhmm_forward_prepared(*t, p)
    with profiling.span("pairhmm.copy_out"):
        return lik.cpu().numpy()
