"""Batched exact FM-index backward search on the device: the counterpart of
`genomics_tpu/ops/fm_search.py` (nvbio's fmindex_device.h +
rank_dictionary.h).

The BWT is held as one 32-byte record per block of 64 positions: the
block's four occurrence counts, then its two bit-planes (low and high bit
of each 2-bit code) as two 32-position words each; rank(s, i) is one
record's count plus a masked popcount of its planes.  The sentinel row
(the '$' of the BWT) is stored out of band: its plane bits alias 'A' and
ranks of 'A' subtract one past it (BWA's "primary index"), so the planes
stay 2-bit.  A suffix table holds, for every string of the first tk
codes a search takes, the range those tk steps reach, so a query of tk
symbols or more starts tk steps in.

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
RATE = 64          # BWT positions a record: 4 counts and 2 x 2 plane words
TABLE_K = 10       # the longest suffix table: 4^10 (lo, hi) pairs, 8 MB
WORD = 0xFFFFFFFF

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# rec, NB, C, primary, n, table, tk, queries, L, qs, qlen, S, lo, hi, stream
_ARGS = (_vp, _ci, _vp, _ci, _ci, _vp, _ci, _vp, _ci, ctypes.c_longlong,
         _vp, _ci, _vp, _vp, _vp)


@dataclasses.dataclass(frozen=True)
class DeviceFMIndex:
    """The packed FM-index, tensors on one device."""
    rec: torch.Tensor      # [NB, 8] int32: block k's occ(s, 64k), s = 0-3,
    #                        then its low plane's two words, its high's two
    table: torch.Tensor    # [4^tk, 2] int32 (lo, hi) after tk steps
    tk: int                # codes the table takes (0: no table)
    C: torch.Tensor        # [6] int32 cumulative symbol counts
    primary: int           # the sentinel's row
    n: int                 # BWT length (text + sentinel)


def table_k(n: int) -> int:
    """Codes of the suffix table of an index of n rows: floor(log4 n), at
    most TABLE_K (about one row a string)."""
    return min(TABLE_K, (n.bit_length() - 1) // 2)


def build_device_index(fm, device="cuda") -> DeviceFMIndex:
    """Pack a host `index.fmindex.FMIndex` into records on `device` (host
    bwt symbols: 0 = sentinel, 1..4 = ACGT; the planes and counts of the
    JAX package's index, 64 positions a record), then its suffix table
    (`suffix_table`).  SA ranges are int32 on the device, so a text of
    2^31 - 1 symbols or more raises."""
    dev = checked_device(device)
    bwt = np.asarray(fm.bwt, np.int64)
    n = fm.n
    if n >= 2**31:
        raise ValueError(
            f"DeviceFMIndex uses int32 SA ranges; reference length {n} >= "
            "2^31 is not supported on device: use the host FMIndex for it")
    primary = int(np.nonzero(bwt == 0)[0][0])
    code = np.where(bwt == 0, 0, bwt - 1).astype(np.uint32)  # sentinel→'A'
    NB = (n + RATE - 1) // RATE + 1
    pad = np.zeros(NB * RATE, np.uint32)
    pad[:n] = code
    bits = pad.reshape(NB, 2, 32)
    sh = np.arange(32, dtype=np.uint32)
    rec = np.zeros((NB, 8), np.uint32)
    rec[:, 4:6] = ((bits & 1) << sh).sum(axis=2, dtype=np.uint32)
    rec[:, 6:8] = (((bits >> 1) & 1) << sh).sum(axis=2, dtype=np.uint32)
    aliased = np.where(np.arange(n) == primary, -1, code.astype(np.int64))
    starts = np.arange(0, n, RATE)
    for s in range(4):
        rec[1:len(starts) + 1, s] = np.cumsum(
            np.add.reduceat(aliased == s, starts))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    idx = DeviceFMIndex(
        rec=put(rec.view(np.int32)),
        table=torch.zeros((0, 2), dtype=torch.int32, device=dev), tk=0,
        C=put(np.asarray(fm.C, np.int64).astype(np.int32)),
        primary=primary, n=n)
    tk = table_k(n)
    if not tk:
        return idx
    return dataclasses.replace(idx, table=suffix_table(idx, tk), tk=tk)


def suffix_table(idx: DeviceFMIndex, k: int) -> torch.Tensor:
    """[4^k, 2] int32: the (lo, hi) a search of each string x of k codes
    reaches (key = sum x[m] 4^(k-1-m); a range that emptied early kept as
    the loop keeps it), by the search itself on idx (its own table
    unread: `_search` of all 4^k strings with tk = 0)."""
    bare = dataclasses.replace(idx, table=idx.table[:0], tk=0)
    keys = torch.arange(4**k, device=idx.rec.device)
    shifts = 2 * torch.arange(k - 1, -1, -1, device=keys.device)
    Q = ((keys[:, None] >> shifts) & 3).to(torch.uint8)
    ql = torch.full((4**k,), k, dtype=torch.int32, device=keys.device)
    return torch.stack(_search(bare, Q, ql), dim=1).contiguous()


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values held in int64 (torch has no popcount):
    the SWAR sum of bit pairs, nibbles and bytes, in int64 so that no
    value's sign bit is in play."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & WORD) >> 24


def _rank_plain(rec, primary: int, s, i):
    """occ(s, i) for [S] int64 codes s (0..3) and positions i over records
    rec [NB, 8] int64 (the low 32 bits): the record's count plus the
    masked popcount of its two words of each plane, minus the sentinel."""
    k = torch.div(i, RATE, rounding_mode="floor")
    r = rec[k]
    base = r.gather(1, s[:, None])[:, 0]
    f0 = torch.where((s & 1) == 1, 0, WORD)[:, None]
    f1 = torch.where((s & 2) == 2, 0, WORD)[:, None]
    eq = (r[:, 4:6] ^ f0) & (r[:, 6:8] ^ f1)
    w = torch.tensor([0, 32], device=i.device)
    rem = (i[:, None] - k[:, None] * RATE - w).clamp(0, 32)
    cnt = _popcount32(eq & ((1 << rem) - 1)).sum(dim=1)
    sent = (s == 0) & (primary >= k * RATE) & (primary < i)
    return base + cnt - sent.long()


def backward_search_plain(idx: DeviceFMIndex, queries: torch.Tensor,
                          qlen: torch.Tensor, stats: dict | None = None):
    """The plain version of `fm_search`, on the inputs' device: a query of
    tk <= qlen <= L codes starts from the suffix table's entry of its
    last tk codes, tk steps in; then every query steps together, to L
    steps, a query's lo and hi kept where it is spent (k < 0) or its range
    is empty.  Returns (lo, hi) [S] int32; with `stats`, the work a bound
    counts: stats["steps"] = the steps the queries took after the table,
    stats["ranks"] = their ranks (two a step, one record each),
    stats["lookups"] = the queries that took the table and
    stats["key_codes"] = the codes their keys read (tk each)."""
    S, L = queries.shape
    dev = queries.device
    rec = idx.rec.long() & WORD
    C = idx.C.long()
    q = queries.long() & 3
    ql = qlen.long()
    rows = torch.arange(S, device=dev)
    lo = torch.zeros(S, dtype=torch.int64, device=dev)
    hi = torch.full((S,), idx.n, dtype=torch.int64, device=dev)
    start = torch.zeros(S, dtype=torch.int64, device=dev)
    tk = idx.tk
    if tk and L >= tk:
        use = (ql >= tk) & (ql <= L)
        pos = (ql[:, None] - tk + torch.arange(tk, device=dev)).clamp(0, L - 1)
        shifts = 2 * torch.arange(tk - 1, -1, -1, device=dev)
        key = (q.gather(1, pos) << shifts).sum(dim=1)
        e = idx.table.long()[torch.where(use, key, 0)]
        lo = torch.where(use, e[:, 0], lo)
        hi = torch.where(use, e[:, 1], hi)
        start = torch.where(use, tk, 0)
        lookups = int(use.sum())
    else:
        lookups = 0
    steps = 0
    for t in range(L):
        k = ql - 1 - t
        act = (hi > lo) & (k >= 0) & (start <= t)
        if stats is not None:
            steps += int(act.sum())
        sym = torch.where(act, q[rows, k.clamp(0, L - 1)], 0)
        cbase = C[sym + 1]
        nlo = cbase + _rank_plain(rec, idx.primary, sym, lo)
        nhi = cbase + _rank_plain(rec, idx.primary, sym, hi)
        lo = torch.where(act, nlo, lo)
        hi = torch.where(act, nhi, hi)
    if stats is not None:
        stats.update(steps=steps, ranks=2 * steps, lookups=lookups,
                     key_codes=tk * lookups)
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
        if x.device != idx.rec.device:
            raise ValueError(f"index on {idx.rec.device}, input on {x.device}")
    return _search(idx, queries, qlen)


def _search(idx: DeviceFMIndex, queries, qlen):
    """fm_search past its checks (also the suffix table's build)."""
    if on_cpu(queries):
        return backward_search_plain(idx, queries, qlen)
    layout = fm_search_layout(idx, queries, qlen)
    return launch_fm_search(layout) if queries.shape[0] else layout[-2:]


def fm_search_layout(idx: DeviceFMIndex, queries, qlen) -> tuple:
    """The kernel's arguments for checked inputs on the card, in the order
    of `fm_search_launch` but the stream: the index's tensors read in
    place, the queries at their row stride (copied only where a row's
    bytes are not contiguous), and the two [S] int32 outputs last."""
    S, L = queries.shape
    queries = queries if queries.stride(1) == 1 else queries.contiguous()
    out = [torch.empty(S, dtype=torch.int32, device=queries.device)
           for _ in range(2)]
    return (idx.rec, idx.rec.shape[0], idx.C, idx.primary, idx.n, idx.table,
            idx.tk, queries, L, queries.stride(0), qlen.contiguous(), S,
            *out)


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
    dev = idx.rec.device
    q = torch.from_numpy((np.asarray(queries, np.int32) & 3).astype(np.uint8))
    ql = torch.from_numpy(np.ascontiguousarray(qlen, np.int32))
    lo, hi = fm_search(idx, q.to(dev), ql.to(dev))
    return lo.cpu().numpy().astype(np.int64), hi.cpu().numpy().astype(np.int64)
