"""Myers bit-vector approximate string matching, batched: the counterpart
of `genomics_tpu/ops/myers.py` (nvbio's `ed` aligner; Myers 1999).

Semantics: semiglobal edit distance — the pattern aligned globally, the
text's prefix and suffix free.  After consuming text char j, `score` is
the least edit distance of the whole pattern against any text substring
ending at j; `myers_batch` returns the least over j (best), its leftmost
end, and the score after the last active char (final).  Patterns and
texts are 2-bit codes (4 = N matches nothing, 255 = pad); the eq masks
are built per batch on the host.

`myers_batch` takes the plain version for tensors on the CPU and launches
`csrc/myers.cu` (replacing the Pallas `_myers_kernel`, myers.py:161) for
tensors on a CUDA device; any other device raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from genomics_tpu_torch import _build
from genomics_tpu_torch.device import checked_device, on_cpu

# Kernel launches; the wrapper adds one where it launches its kernel.
LAUNCHES = {"myers": 0}
WORD = 0xFFFFFFFF

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# eq, es, texts, ts, plen, tlen, B, W, Lt, state, best, end, final, stream
_ARGS = (_vp, _ci, _vp, ctypes.c_longlong, _vp, _vp) + (_ci,) * 3 + (_vp,) * 5

# bases → 2-bit codes, anything else 4 (models/cluster.py's _BASE_MAP)
_BASE_MAP = np.full(256, 4, np.uint8)
for _c, _v in [("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)]:
    _BASE_MAP[ord(_c)] = _v
    _BASE_MAP[ord(_c.lower())] = _v


def build_eq_masks(patterns: np.ndarray, plen: np.ndarray, W: int):
    """Per-pattern per-symbol match bitmasks: [B, 4, W] uint32 (bit k of
    word w set iff pattern[w*32+k] == symbol)."""
    B, Lp = patterns.shape
    eq = np.zeros((B, 4, W), np.uint32)
    for s in range(4):
        bits = patterns == s
        pad = np.zeros((B, W * 32), bool)
        pad[:, :Lp] = bits
        pb = pad.reshape(B, W, 32)
        eq[:, s, :] = (pb << np.arange(32, dtype=np.uint64)).sum(
            axis=2, dtype=np.uint64
        ).astype(np.uint32)
    return eq


def myers_batch_plain(eq, plen, texts, tlen):
    """The plain version of `myers_batch`, on the inputs' device: the
    recurrence over [B] tensors per word, 32-bit words held in int64 and
    masked, the adder's carry taken as `sum >> 32` (torch has no full
    uint32 arithmetic on the CPU)."""
    B, _, W = eq.shape
    Lt = texts.shape[1]
    dev = eq.device
    eq = eq.long()
    E = [[eq[:, k, w] for w in range(W)] for k in range(4)]
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    Pv = [zero + WORD for _ in range(W)]
    Mv = [zero for _ in range(W)]
    plen = plen.long()
    lastw = torch.div(plen - 1, 32, rounding_mode="floor")
    topb = torch.remainder(plen - 1, 32)
    score, best = plen.clone(), plen.clone()
    best_end = zero - 1
    tlen = tlen.long()
    for j in range(Lt):
        c = texts[:, j].long()
        active = (c != 255) & (j < tlen)
        cin = cbp = cbm = dp = dm = zero
        newP, newM = [], []
        for w in range(W):
            ev = zero
            for k in range(4):
                ev = ev | torch.where(c == k, E[k][w], zero)
            pv, mv = Pv[w], Mv[w]
            s = (ev & pv) + pv + cin
            cin = s >> 32
            s = s & WORD
            xh = (s ^ pv) | ev
            xv = ev | mv
            ph = mv | (~(xh | pv) & WORD)
            mh = pv & xh
            sel = lastw == w
            dp = dp | torch.where(sel, (ph >> topb) & 1, zero)
            dm = dm | torch.where(sel, (mh >> topb) & 1, zero)
            ph1 = ((ph << 1) & WORD) | cbp
            mh1 = ((mh << 1) & WORD) | cbm
            cbp, cbm = ph >> 31, mh >> 31
            newP.append(mh1 | (~(xv | ph1) & WORD))
            newM.append(ph1 & xv)
        Pv = [torch.where(active, n, o) for n, o in zip(newP, Pv)]
        Mv = [torch.where(active, n, o) for n, o in zip(newM, Mv)]
        score = torch.where(active, score + dp - dm, score)
        upd = active & (score < best)
        best = torch.where(upd, score, best)
        best_end = torch.where(upd, j, best_end)
    return best.int(), best_end.int(), score.int()


def myers_batch(
    eq: torch.Tensor,      # [B, 4, W] match masks, uint32, int32 or int64
    plen: torch.Tensor,    # [B] int32 pattern lengths
    texts: torch.Tensor,   # [B, Lt] uint8 2-bit codes (255 = pad)
    tlen: torch.Tensor,    # [B] int32
):
    """Batched Myers semiglobal matching (`myers.myers_batch` and its
    Pallas twin `myers_batch_tpu`).

    Returns (best [B] int32 — min edit distance over text end positions,
    best_end [B] int32 — leftmost text end attaining it, 0-based, -1 if
    none beats plen; final [B] int32 — distance at the last text char).
    The kernel serves every W (1..8 in registers, more in a scratch)."""
    B, four, W = eq.shape
    if four != 4 or texts.dim() != 2 or texts.shape[0] != B:
        raise ValueError(f"eq [B, 4, W] and texts [B, Lt] expected; got "
                         f"{tuple(eq.shape)}, {tuple(texts.shape)}")
    if texts.dtype != torch.uint8:
        raise TypeError(f"texts must be uint8 codes; got {texts.dtype}")
    if eq.dtype not in (torch.uint32, torch.int32, torch.int64):
        raise TypeError(f"eq must be uint32, int32 or int64 masks; got "
                        f"{eq.dtype}")
    for x in (plen, tlen):
        if x.shape != (B,) or x.dtype != torch.int32:
            raise ValueError(f"plen / tlen must be int32 [{B}]; got "
                             f"{x.dtype} {tuple(x.shape)}")
    for x in (plen, texts, tlen):
        if x.device != eq.device:
            raise ValueError(f"inputs on {eq.device} and {x.device}")
    if on_cpu(eq):
        return myers_batch_plain(eq, plen, texts, tlen)
    if W < 1:
        raise ValueError("W must be at least 1")
    layout = myers_layout(eq, plen, texts, tlen)
    return launch_myers(layout) if B else layout[-3:]


def myers_layout(eq, plen, texts, tlen) -> tuple:
    """The kernel's arguments for checked inputs on the card, in the order
    of `myers_launch`, read in place: the eq masks as 32-bit words (an
    int32 view of uint32 or int64 masks, which the kernel reads every
    `es`-th word: 2 takes the low words of int64), the texts with their
    row stride in bytes, the lengths, B, W, Lt, the [2W, B] scratch (None
    for W <= 8) and the three [B] int32 outputs (best, end, final), last.
    Nothing is permuted or converted: only masks that are not contiguous,
    or texts whose bytes are not contiguous within a row, are copied."""
    B, _, W = eq.shape
    dev = eq.device
    eq = eq.contiguous()
    eq_w = eq if eq.dtype == torch.int32 else eq.view(torch.int32)
    texts = texts if texts.stride(1) == 1 else texts.contiguous()
    state = (torch.empty((2 * W, B), dtype=torch.int32, device=dev)
             if W > 8 else None)
    return (eq_w, eq_w.shape[2] // W, texts, texts.stride(0),
            plen.contiguous(), tlen.contiguous(), B, W, texts.shape[1], state,
            *(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)))


def launch_myers(layout: tuple):
    """Launch csrc/myers.cu on `myers_layout`'s arguments (B > 0) and count
    it; returns (best, end, final)."""
    _build.launch("myers", "myers_launch", _ARGS, layout[0].device, *layout)
    LAUNCHES["myers"] += 1
    return layout[-3:]


def encode_batch(patterns, texts):
    """Lists of str → numpy (eq [B, 4, W] uint32, plen [B] int32, texts
    [B, Lt] uint8 codes padded with 255, tlen [B] int32)."""
    B = len(patterns)
    penc = [_BASE_MAP[np.frombuffer(p.encode(), np.uint8)] for p in patterns]
    tenc = [_BASE_MAP[np.frombuffer(t.encode(), np.uint8)] for t in texts]
    Lp = max(len(p) for p in penc)
    Lt = max(len(t) for t in tenc)
    W = (Lp + 31) // 32
    parr = np.full((B, Lp), 255, np.uint8)
    tarr = np.full((B, Lt), 255, np.uint8)
    plen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for i, (p, t) in enumerate(zip(penc, tenc)):
        parr[i, : len(p)] = p
        tarr[i, : len(t)] = t
        plen[i], tlen[i] = len(p), len(t)
    return build_eq_masks(parr, plen, W), plen, tarr, tlen


def edit_distance_semiglobal(patterns, texts, device="cuda"):
    """Lists of str → (best, end, final) numpy int32 arrays, on the card
    unless `device` says otherwise (`myers.edit_distance_semiglobal`)."""
    dev = checked_device(device)
    eq, plen, tarr, tlen = encode_batch(patterns, texts)
    args = [torch.from_numpy(a).to(dev) for a in (eq, plen, tarr, tlen)]
    return tuple(x.cpu().numpy() for x in myers_batch(*args))


def hamming_batch(a, b, length) -> torch.Tensor:
    """Batched Hamming distance over equal-length prefixes (nvbio's
    'hamming' aligner): a, b [B, L] codes, length [B] → [B] int32, on the
    inputs' device.  Plain PyTorch (jnp, not Pallas, in the JAX package)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    length = torch.as_tensor(length, device=a.device)
    idx = torch.arange(a.shape[1], device=a.device)[None, :]
    diff = (a != b) & (idx < length[:, None])
    return diff.sum(dim=1).int()
