"""Plain PairHMM forward likelihoods in f32: the reference the assembly
cells' haplotype likelihoods are judged by.

A frozen copy of the port's plain sweep (`genomics_tpu_torch/ops/
scan_pairhmm.py` fma_rn, param_tables, forward_prepared, pack_records),
which follows Non-CDP/PairHMM warp_based.cu:84-174 with its op order
and its three __fmaf_rn sites single-rounded, so it is bit-equal to the
plain recurrence on any device.  It imports nothing of the port.

`round_to`: None, or torch.bfloat16 for the control: every value the
recurrence makes is rounded to bf16, the step below f32.
"""
from __future__ import annotations

import numpy as np
import torch

INITIAL_CONSTANT = np.float32(1.329228e36)  # 2^120, warp_based.cu:89
EPS = np.float32(0.1)
BETA = np.float32(0.9)


def fma_rn(a, b, c):
    """Single-rounded f32 a*b+c: the f64 sum made round-to-odd from its
    exact error, then one rounding to f32."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    si = s.view(torch.int64)
    down = ((err.view(torch.int64) ^ si) < 0).long()
    odd = torch.where(err != 0, (si - down) | 1, si)
    return odd.view(torch.float64).float()


def param_tables() -> dict:
    """ph2pr[q] = 10^(-q/10) in f32 (warp_based.cu:209-213), 1 - ph2pr
    and ph2pr / 3, computed with numpy."""
    tab = np.float32(10.0) ** (-(np.arange(128, dtype=np.float32))
                               / np.float32(10.0))
    return {"ph2pr": tab, "one_minus": np.float32(1.0) - tab,
            "third": tab / np.float32(3.0)}


def pack(reads, haps, base_q, ins_q, del_q):
    """Equal-length lists -> numpy reads [B, R] / haps [B, C] raw bytes,
    lengths, and quals [B, R] (the same quality for every base)."""
    B = len(reads)
    R = max(len(r) for r in reads)
    C = max(len(h) for h in haps)
    rd = np.zeros((B, R), np.uint8)
    hp = np.zeros((B, C), np.uint8)
    rlen = np.zeros(B, np.int32)
    clen = np.zeros(B, np.int32)
    for i, (r, h) in enumerate(zip(reads, haps)):
        rb = r.encode() if isinstance(r, str) else r
        hb = h.encode() if isinstance(h, str) else h
        rd[i, :len(rb)] = np.frombuffer(rb, np.uint8)
        hp[i, :len(hb)] = np.frombuffer(hb, np.uint8)
        rlen[i], clen[i] = len(rb), len(hb)
    mask = np.arange(R)[None, :] < rlen[:, None]
    quals = [np.where(mask, q, 0).astype(np.int64) for q in
             (base_q, ins_q, del_q)]
    return rd, hp, rlen, clen, quals


def forward(reads, haps, rlen, clen, quals, device="cpu", round_to=None):
    """The anti-diagonal sweep -> [B] f32 likelihoods (2^120-scaled) on
    the host.  reads [B, R], haps [B, C] uint8; quals three [B, R]
    int64."""
    rnd = (lambda x: x) if round_to is None else \
        (lambda x: x.to(round_to).float())
    dev = torch.device(device)
    tabs = {k: torch.from_numpy(v).to(dev) for k, v in param_tables().items()}
    bq, iq, dq = (torch.from_numpy(q).to(dev) & 127 for q in quals)
    q1, q3 = tabs["one_minus"][bq], tabs["third"][bq]
    delta, xiksi = tabs["ph2pr"][iq], tabs["ph2pr"][dq]
    alpha = tabs["one_minus"][(iq + dq) & 127]
    reads = torch.from_numpy(reads).to(dev)
    haps = torch.from_numpy(haps).to(dev)
    rlen = torch.from_numpy(rlen).to(dev)
    clen = torch.from_numpy(clen).to(dev)
    B, R = reads.shape
    C = haps.shape[1]
    eps = torch.tensor(EPS, device=dev)
    beta = torch.tensor(BETA, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    d0 = rnd((torch.full(clen.shape, float(INITIAL_CONSTANT),
                         dtype=torch.float32, device=dev)
              / clen.float())[:, None])
    r_idx = torch.arange(R, device=dev)[None, :]
    rlen_ = rlen.long()[:, None]
    clen_ = clen.long()[:, None].clamp(max=C)
    last = (rlen_ - 1).clamp(0, max(R - 1, 0))
    has_last = (rlen_ >= 1) & (rlen_ <= R)

    def down(x, fill):
        return torch.cat([fill.expand(x.shape[0], 1), x[:, :-1]], dim=1)

    z = torch.zeros((B, R), dtype=torch.float32, device=dev)
    Mp = Ip = Dp = Mp2 = Ip2 = Dp2 = z
    hd = torch.zeros((B, R), dtype=haps.dtype, device=dev)
    res = torch.zeros(B, dtype=torch.float32, device=dev)
    for d in range(R + C - 1):
        c = d - r_idx
        hd = torch.cat([haps[:, min(d, C - 1)][:, None], hd[:, :-1]], dim=1)
        valid = (c >= 0) & (c < clen_) & (r_idx < rlen_)
        MM, II = down(Mp, zero), down(Ip, zero)
        MMM, III = down(Mp2, zero), down(Ip2, zero)
        DDD = down(Dp2, d0)
        MID = rnd(III + DDD)
        DDM = rnd(Mp * xiksi)
        IIMI = rnd(II * eps)
        MIIDD = rnd(beta * MID)
        prior = torch.where(hd == reads, q1, q3)
        Dn = rnd(fma_rn(Dp, eps, DDM))
        In = rnd(fma_rn(MM, delta, IIMI))
        MMID = rnd(fma_rn(alpha, MMM, MIIDD))
        Mn = rnd(prior * MMID)
        Mn = torch.where(valid, Mn, zero)
        In = torch.where(valid, In, zero)
        Dn = torch.where(valid, Dn, zero)
        at_last = rnd((Mn + In).gather(1, last)[:, 0])
        hit = (has_last & valid.gather(1, last))[:, 0]
        res = torch.where(hit, rnd(res + at_last), res)
        Mp2, Ip2, Dp2, Mp, Ip, Dp = Mp, Ip, Dp, Mn, In, Dn
    return res.cpu().numpy()


def likelihoods(reads, haps, base_q, ins_q, del_q, device="cpu",
                round_to=None, block=16384):
    """Per (read, hap) pair f32 likelihoods, in blocks of pairs."""
    out = []
    for a in range(0, len(reads), block):
        packed = pack(reads[a:a + block], haps[a:a + block], base_q, ins_q,
                      del_q)
        out.append(forward(*packed, device=device, round_to=round_to))
    return np.concatenate(out) if out else np.zeros(0, np.float32)
