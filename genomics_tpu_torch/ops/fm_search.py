"""Batched exact FM-index backward search on the device: the counterpart of
`genomics_tpu/ops/fm_search.py` (nvbio's fmindex_device.h +
rank_dictionary.h).

The BWT is held as two bit-planes (low and high bit of each 2-bit code,
32 positions per uint32 word) plus occurrence checkpoints every 128
positions; rank(s, i) is a checkpoint gather plus an in-block masked
popcount.  The sentinel row (the '$' of the BWT) is stored out of band:
its plane bits alias 'A' and ranks of 'A' subtract one past it (BWA's
"primary index"), so the planes stay 2-bit.

`fm_search` takes the plain version for tensors on the CPU and launches
`csrc/fm_search.cu` (replacing `_bs_jit`, fm_search.py:121, and its
`_rank`, :93, which jnp runs on the TPU) for tensors on a CUDA device;
any other device raises.  `backward_search_device` is the JAX module's
host-array entry point, with the same (lo, hi) int64 results as
`index.fmindex.FMIndex.backward_search`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.device import checked_device, on_cpu

# Kernel launches; the wrapper adds one where it launches its kernel.
LAUNCHES = {"fm_search": 0}
RATE = 128         # occ_rate of the device index: 4 plane words a block
WORD = 0xFFFFFFFF

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# p0, p1, W, ckpt, NB, C, primary, n, queries, L, qs, qlen, S, lo, hi, stream
_ARGS = (_vp, _vp, _ci, _vp, _ci, _vp, _ci, _ci, _vp, _ci, ctypes.c_longlong,
         _vp, _ci, _vp, _vp, _vp)


@dataclasses.dataclass(frozen=True)
class DeviceFMIndex:
    """The packed FM-index, tensors on one device."""
    p0: torch.Tensor       # [W] int32: the uint32 low bit-plane's bits
    p1: torch.Tensor       # [W] int32: the high bit-plane's bits
    ckpt: torch.Tensor     # [4, NB] int32 occ checkpoints per base
    C: torch.Tensor        # [6] int32 cumulative symbol counts
    primary: int           # the sentinel's row
    n: int                 # BWT length (text + sentinel)


def build_device_index(fm, device="cuda") -> DeviceFMIndex:
    """Pack a host `index.fmindex.FMIndex` into bit-planes on `device`,
    array for array as the JAX package packs them (host bwt symbols: 0 =
    sentinel, 1..4 = ACGT).  SA ranges are int32 on the device, so a text
    of 2^31 - 1 symbols or more raises."""
    dev = checked_device(device)
    bwt = np.asarray(fm.bwt, np.int64)
    n = fm.n
    if n >= 2**31:
        raise ValueError(
            f"DeviceFMIndex uses int32 SA ranges; reference length {n} >= "
            "2^31 is not supported on device: use the host FMIndex for it")
    primary = int(np.nonzero(bwt == 0)[0][0])
    code = np.where(bwt == 0, 0, bwt - 1).astype(np.uint32)  # sentinel→'A'
    W = (n + 31) // 32
    pad = np.zeros(W * 32, np.uint32)
    pad[:n] = code
    bits = pad.reshape(W, 32)
    sh = np.arange(32, dtype=np.uint32)
    p0 = ((bits & 1) << sh).sum(axis=1, dtype=np.uint32)
    p1 = (((bits >> 1) & 1) << sh).sum(axis=1, dtype=np.uint32)
    NB = (n + RATE - 1) // RATE + 1
    ckpt = np.zeros((4, NB), np.int64)
    aliased = np.where(np.arange(len(pad)) == primary, -1,
                       pad.astype(np.int64))
    starts = np.arange(0, n, RATE)
    for s in range(4):
        cnt = np.add.reduceat((aliased[:n] == s), starts)
        ckpt[s, 1:] = np.cumsum(cnt)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return DeviceFMIndex(
        p0=put(p0.view(np.int32)), p1=put(p1.view(np.int32)),
        ckpt=put(ckpt.astype(np.int32)),
        C=put(np.asarray(fm.C, np.int64).astype(np.int32)),
        primary=primary, n=n)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 (torch has no popcount):
    the SWAR sum of bit pairs, nibbles and bytes, in int64 so that no
    value's sign bit is in play."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & WORD) >> 24


def _rank_plain(planes, ckpt, primary: int, s, i):
    """occ(s, i) for [S] int64 codes s (0..3) and positions i: the
    checkpoint plus the masked popcount of the block's 4 words, minus the
    sentinel; a word past the planes' end is read clamped and masked to
    nothing, as JAX's clamped gather is."""
    p0, p1 = planes
    W = p0.shape[0]
    k = torch.div(i, RATE, rounding_mode="floor")
    base = ckpt[s, k]
    w = k[:, None] * (RATE // 32) + torch.arange(RATE // 32, device=i.device)
    wc = w.clamp(max=W - 1)
    f0 = torch.where((s & 1) == 1, 0, WORD)[:, None]
    f1 = torch.where((s & 2) == 2, 0, WORD)[:, None]
    eq = (p0[wc] ^ f0) & (p1[wc] ^ f1)
    rem = (i[:, None] - w * 32).clamp(0, 32)
    cnt = _popcount32(eq & ((1 << rem) - 1)).sum(dim=1)
    sent = (s == 0) & (primary >= k * RATE) & (primary < i)
    return base + cnt - sent.long()


def backward_search_plain(idx: DeviceFMIndex, queries: torch.Tensor,
                          qlen: torch.Tensor, stats: dict | None = None):
    """The plain version of `fm_search`, on the inputs' device: every
    query steps together, L steps, a query's lo and hi kept where it is
    spent (k < 0) or its range is empty.  Returns (lo, hi) [S] int32;
    with `stats`, the work a bound counts: stats["steps"] = the steps the
    queries took, stats["ranks"] = their ranks (two a step) and
    stats["words"] = the plane words (of each plane) those ranks read,
    ceil((i mod RATE) / 32) for a rank at i, since the kernel reads no
    word that starts at or past i."""
    S, L = queries.shape
    dev = queries.device
    planes = (idx.p0.long() & WORD, idx.p1.long() & WORD)
    ckpt, C = idx.ckpt.long(), idx.C.long()
    q = queries.long() & 3
    ql = qlen.long()
    rows = torch.arange(S, device=dev)
    lo = torch.zeros(S, dtype=torch.int64, device=dev)
    hi = torch.full((S,), idx.n, dtype=torch.int64, device=dev)
    steps = words = 0
    for t in range(L):
        k = ql - 1 - t
        act = (hi > lo) & (k >= 0)
        if stats is not None:
            steps += int(act.sum())
            for i in (lo, hi):
                words += int(torch.where(act, (i % RATE + 31) // 32,
                                         0).sum())
        sym = torch.where(act, q[rows, k.clamp(0, L - 1)], 0)
        cbase = C[sym + 1]
        nlo = cbase + _rank_plain(planes, ckpt, idx.primary, sym, lo)
        nhi = cbase + _rank_plain(planes, ckpt, idx.primary, sym, hi)
        lo = torch.where(act, nlo, lo)
        hi = torch.where(act, nhi, hi)
    if stats is not None:
        stats.update(steps=steps, ranks=2 * steps, words=words)
    return lo.int(), hi.int()


def fm_search(idx: DeviceFMIndex, queries: torch.Tensor, qlen: torch.Tensor):
    """Batched exact backward search of [S, L] uint8 codes (only the low 2
    bits count: a code of 4 or 255 reads as its low bits, as in the JAX
    search) with [S] int32 lengths, on the index's device.  Returns (lo,
    hi) [S] int32 tensors: the SA range of each query (hi <= lo: none)."""
    if queries.dim() != 2 or queries.dtype != torch.uint8:
        raise ValueError(f"queries must be [S, L] uint8 codes; got "
                         f"{queries.dtype} {tuple(queries.shape)}")
    S = queries.shape[0]
    if qlen.shape != (S,) or qlen.dtype != torch.int32:
        raise ValueError(f"qlen must be int32 [{S}]; got {qlen.dtype} "
                         f"{tuple(qlen.shape)}")
    for x in (queries, qlen):
        if x.device != idx.p0.device:
            raise ValueError(f"index on {idx.p0.device}, input on {x.device}")
    if on_cpu(queries):
        return backward_search_plain(idx, queries, qlen)
    layout = fm_search_layout(idx, queries, qlen)
    return launch_fm_search(layout) if S else layout[-2:]


def fm_search_layout(idx: DeviceFMIndex, queries, qlen) -> tuple:
    """The kernel's arguments for checked inputs on the card, in the order
    of `fm_search_launch` but the stream: the index's tensors read in
    place, the queries at their row stride (copied only where a row's
    bytes are not contiguous), and the two [S] int32 outputs last."""
    S, L = queries.shape
    queries = queries if queries.stride(1) == 1 else queries.contiguous()
    out = [torch.empty(S, dtype=torch.int32, device=queries.device)
           for _ in range(2)]
    return (idx.p0, idx.p1, idx.p0.shape[0], idx.ckpt, idx.ckpt.shape[1],
            idx.C, idx.primary, idx.n, queries, L, queries.stride(0),
            qlen.contiguous(), S, *out)


def launch_fm_search(layout: tuple):
    """Launch csrc/fm_search.cu on `fm_search_layout`'s arguments (S > 0)
    and count it; returns (lo, hi)."""
    _build.launch("fm_search", "fm_search_launch", _ARGS, layout[0].device,
                  *layout)
    LAUNCHES["fm_search"] += 1
    return layout[-2:]


def backward_search_device(idx: DeviceFMIndex, queries, qlen):
    """Host arrays in and out, as the JAX function: queries [S, L] codes
    (read & 3), qlen [S]; returns (lo, hi) int64 numpy arrays, identical
    to FMIndex.backward_search on clean ACGT queries."""
    dev = idx.p0.device
    q = torch.from_numpy((np.asarray(queries, np.int32) & 3).astype(np.uint8))
    ql = torch.from_numpy(np.ascontiguousarray(qlen, np.int32))
    lo, hi = fm_search(idx, q.to(dev), ql.to(dev))
    return lo.cpu().numpy().astype(np.int64), hi.cpu().numpy().astype(np.int64)
