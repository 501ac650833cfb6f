"""Greedy clustering's window filters: the counterpart of `_filters_dev`
and `_word_min_sum` of `genomics_tpu/models/cluster.py` (func.cu's
kernel_preFilter and kernel_filter).

For S representatives against J jobs, pass 2 is the prefix filter (the
minimum-sum of the four base counts against the job's base cutoff) and
the word filter (the minimum-sum of the two reads' word counts against
the job's word cutoff); a column passes where any representative passes
it.  The reads' words reach the device once, as `pack_words` packs them:
each read's distinct words as uint32 word << 16 | count (past 255: 255),
padded with zeros to a multiple of 16 slots (the kernel loads 16 at a
time).

`window_filters` takes the plain version for tensors on the CPU and
launches `csrc/cluster_filter.cu` (one launch a window: the
representatives' count tables in shared memory, each job's words looked
up in them) for tensors on a CUDA device; any other device raises.  The
plain version is the JAX package's arithmetic: dense [rows, 4^wl] count
rows and the word min-sum as K 0/1 indicator products side by side, in
chunks of job columns under FILTER_BUDGET.  `word_min_sum` is the same
product as int8 x int8 -> int32 on the card (`torch._int_mm`), the
library yardstick `chip_smoke.py` times; no path of the port calls it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.device import on_cpu

# Kernel launches; the wrapper adds one where it launches its kernel.
LAUNCHES = {"cluster_filter": 0}
# Shared memory a block may take on Hopper (227 KB): the kernel's R
# representatives' tables of 4^wl + ROW_PAD bytes each.
SMEM_BYTES = 232448
ROW_PAD = 4            # bytes after each table row (bank spread)
TILE = 32              # jobs a group's tile: pass2's rows padded to 16
FOLD = 128             # quads of slots between folds of the 16-bit sums
SLOTS = 16             # slots a load step: packed rows a multiple of it
# Bytes of dense filter operands a chunk of job columns may take in the
# plain version: the scattered int32 counts and their uint8 copy (5 a
# bin), the K indicator bytes a bin and the product's f64 copies of them
# (8 each): C3's byte budget.
FILTER_BUDGET = 1 << 28

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# packed, wq, prefix, wcut, bcut, rp, S, jp, J, R, bins, pass2, ldp, work,
# stream
_ARGS = (_vp, _ci, _vp, _vp, _vp, _vp, _ci, _vp, _ci, _ci, _ci, _vp,
         ctypes.c_longlong, _vp, _vp)


def pack_words(words: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """[N, WP] int32 (the bits of uint32 word << 16 | count, a count past
    255 held as 255) of `_prepare`'s [N, W] uint16 words and counts, WP =
    W rounded up to a multiple of SLOTS (at least SLOTS), zeros past each
    read's words."""
    N, W = words.shape
    out = np.zeros((N, max(SLOTS, -(-W // SLOTS) * SLOTS)), np.uint32)
    out[:, :W] = (words.astype(np.uint32) << 16) | np.minimum(counts, 255)
    return out.view(np.int32)


def dense_rows(packed: torch.Tensor, idx: torch.Tensor, bins: int):
    """[len(idx), bins] uint8 word counts (past 255: 255) of the reads idx,
    from their packed words: the JAX package's dense matrix rows."""
    rows = packed[idx.long()]
    D = torch.zeros((rows.shape[0], bins), dtype=torch.int32,
                    device=packed.device)
    D.scatter_add_(1, ((rows >> 16) & 0xFFFF).long(), rows & 0xFFFF)
    return D.to(torch.uint8)


def word_min_sum_plain(Dreps, Djobs, K: int) -> torch.Tensor:
    """[S, J] int32: sum over the bins of min(Dreps[s], Djobs[j]) as the
    JAX package's `_word_min_sum` (cluster.py:375) computes it: min(a, b)
    over counts of at most K is sum_{k=1..K} [a >= k] [b >= k], so the
    min-sum is one product of the K indicator matrices laid side by side.
    In f64, exact on any device whatever the matmul flags (sums below
    2^53)."""
    A = _indicators(Dreps, K).double()
    B = _indicators(Djobs, K).double()
    return (A @ B.T).to(torch.int32)


def word_min_sum(Dreps, Djobs, K: int) -> torch.Tensor:
    """`word_min_sum_plain` for CPU tensors; on the card the same product
    as int8 x int8 -> int32 (`torch._int_mm`), exact whatever the global
    matmul flags say (bf16 reductions, TF32): the library call that
    `chip_smoke.py` times beside the kernel."""
    if on_cpu(Dreps):
        return word_min_sum_plain(Dreps, Djobs, K)
    S, J = Dreps.shape[0], Djobs.shape[0]
    A, B = int_mm_operands(Dreps, Djobs, K)
    return torch._int_mm(A, B.T)[:S, :J]


def int_mm_operands(Dreps, Djobs, K: int):
    """The int8 indicator operands of `word_min_sum`'s product, padded as
    `torch._int_mm` takes them (more than 16 rows, multiples of 8)."""
    A = _indicators(Dreps, K)
    B = _indicators(Djobs, K)
    return (_pad_to(A, max(24, _round8(A.shape[0])), _round8(A.shape[1])),
            _pad_to(B, _round8(B.shape[0]), _round8(B.shape[1])))


def _indicators(D, K: int) -> torch.Tensor:
    """[rows, K * bins] int8: [D >= k] for k = 1..K, side by side."""
    ks = torch.arange(1, K + 1, dtype=D.dtype, device=D.device)
    return (D[:, None, :] >= ks[None, :, None]).reshape(
        D.shape[0], -1).to(torch.int8)


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _pad_to(x, rows: int, cols: int):
    return torch.nn.functional.pad(x, (0, cols - x.shape[1],
                                       0, rows - x.shape[0]))


def filter_chunk(bins: int, K: int) -> int:
    """Job columns of one chunk of the plain filters under FILTER_BUDGET
    (a multiple of 8, at least 8)."""
    return max(8, FILTER_BUDGET // (bins * (5 + 9 * K)) // 8 * 8)


def window_filters_plain(packed, prefix, wcut, bcut, rp, jp, bins: int,
                         K: int):
    """The plain version of `window_filters`, on the inputs' device: the
    JAX package's _filters_dev in chunks of job columns under
    FILTER_BUDGET (C3: it builds the [J, 4^wl] operands whole)."""
    S, J = rp.shape[0], jp.shape[0]
    p2 = torch.zeros((S, J), dtype=torch.uint8, device=packed.device)
    if not S:
        return p2, torch.zeros(J, dtype=torch.bool, device=packed.device)
    rpl = rp.long()
    pre_r = prefix[rpl][:, None, :]
    D_r = dense_rows(packed, rpl, bins)
    step = filter_chunk(bins, K)
    for c0 in range(0, J, step):
        jc = jp[c0:c0 + step].long()
        pre = torch.minimum(pre_r, prefix[jc][None, :, :]).sum(-1)
        p1 = pre >= bcut[jc][None, :]
        got = word_min_sum_plain(D_r, dense_rows(packed, jc, bins), K)
        p2[:, c0:c0 + step] = p1 & (got >= wcut[jc][None, :])
    return p2, p2.amax(dim=0) != 0


def window_filters(packed, prefix, wcut, bcut, rp, jp, bins: int, K: int):
    """Prefix filter + word filter of representatives rp [S] against jobs
    jp [J] (int32 read indices) over `pack_words`' packed [N, WP] int32,
    prefix [N, 4] and the cutoffs [N] int32, 4^wl = bins, counts of at
    most K (the plain version's indicator count; the kernel needs none).
    Returns (pass2 [S, J] uint8, the [J] bool of columns any
    representative passes), on the inputs' device."""
    for x in (prefix, wcut, bcut, rp, jp):
        if x.device != packed.device:
            raise ValueError(f"packed words on {packed.device}, an input on "
                             f"{x.device}")
    if on_cpu(packed):
        return window_filters_plain(packed, prefix, wcut, bcut, rp, jp, bins,
                                    K)
    layout = filter_layout(packed, prefix, wcut, bcut, rp, jp, bins)
    if rp.shape[0] and jp.shape[0]:
        return launch_cluster_filter(layout)
    return (layout[11][:, :jp.shape[0]],
            layout[13][:jp.shape[0]].zero_().view(torch.bool))


def rep_rows(S: int, bins: int, most: int = 32) -> int:
    """Representatives a block of the kernel holds (R): `most` (32),
    halved while it is twice S or more or its tables (R x (bins +
    ROW_PAD) bytes) outgrow SMEM_BYTES."""
    if bins + ROW_PAD > SMEM_BYTES:
        raise ValueError(f"{bins} bins: one table outgrows a block's "
                         f"shared memory")
    R = most
    while R > 1 and (R >= 2 * S or R * (bins + ROW_PAD) > SMEM_BYTES):
        R //= 2
    return R


def filter_layout(packed, prefix, wcut, bcut, rp, jp, bins: int,
                  most: int = 32) -> tuple:
    """The kernel's arguments for inputs on the card, in the order of
    `cluster_filter_launch` but the stream: the per-read arrays in place,
    pass2 [S, ldp] (ldp = J rounded up to 16) and the work bytes (any [J]
    uint8, then ceil(S / R) int32 tickets at byte ldp) made here; `most`
    caps R (`rep_rows`), for timings and card tests."""
    N = packed.shape[0]
    if (packed.dtype != torch.int32 or packed.dim() != 2
            or packed.shape[1] % SLOTS or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"packed must be pack_words' contiguous, 16-byte "
                         f"aligned [N, {SLOTS} k] int32")
    if (prefix.shape != (N, 4) or prefix.dtype != torch.int32
            or not prefix.is_contiguous() or prefix.data_ptr() % 16):
        raise ValueError(f"prefix must be a contiguous, 16-byte aligned "
                         f"[{N}, 4] int32")
    for name, x in (("wcut", wcut), ("bcut", bcut), ("rp", rp), ("jp", jp)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d int32")
    if wcut.shape[0] != N or bcut.shape[0] != N:
        raise ValueError(f"the cutoffs must hold {N} reads")
    S, J = rp.shape[0], jp.shape[0]
    ldp = max(16, -(-J // 16) * 16)
    R = rep_rows(S, bins, most)
    pass2 = torch.empty((S, ldp), dtype=torch.uint8, device=packed.device)
    work = torch.empty(ldp + 4 * -(-S // R), dtype=torch.uint8,
                       device=packed.device)
    return (packed, packed.shape[1] // 4, prefix, wcut, bcut, rp, S, jp, J,
            R, bins, pass2, ldp, work)


def launch_cluster_filter(layout: tuple):
    """Launch csrc/cluster_filter.cu on `filter_layout`'s arguments (S and
    J at least 1) and count it; returns (pass2 [S, J], any [J] bool)."""
    _build.launch("cluster_filter", "cluster_filter_launch", _ARGS,
                  layout[0].device, *layout)
    LAUNCHES["cluster_filter"] += 1
    J = layout[8]
    return layout[11][:, :J], layout[13][:J].view(torch.bool)


def filter_work(packed, rp, jp) -> dict:
    """The work the bound charges: pairs = S x J, lookups = S x the jobs'
    distinct words (one table byte, a min and an add each)."""
    words = int((packed[jp.long()] & 0xFFFF).ne(0).sum())
    return {"pairs": rp.shape[0] * jp.shape[0],
            "lookups": rp.shape[0] * words}
