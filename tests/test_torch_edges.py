"""The port's plain LOCAL modes and SEMI_GLOBAL start pass at the edges
that the card kernels' one-column-ahead loads touch (Lq 1 and 9, one
8-row strip, one pair and 129), integer-equal to the JAX package's scan
cores; and the arguments that the launch-alone helpers of
`ops.cuda_align` hand the kernels.  The kernels themselves run only on
the card (tests/test_torch_cuda.py holds them to these plain versions
at the same edges)."""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.ops import scan_align as jscan
from genomics_tpu.ops import scan_align_full as JF
from genomics_tpu_torch.core.scoring import (
    AlgoType,
    AlignmentParams,
    SemiGlobalSkip,
    params_from_jax,
)
from genomics_tpu_torch.ops import cuda_align
from genomics_tpu_torch.ops import scan_align_full as F
from genomics_tpu_torch.ops.scan_align import local_align_batch
from chip_smoke import band_cells, band_windows

ACGT = np.array([1, 3, 7, 4], np.uint8)
N4 = 14
SKIPS = [SemiGlobalSkip.NONE, SemiGlobalSkip.QUERY, SemiGlobalSkip.TARGET,
         SemiGlobalSkip.BOTH]


def _local_batch(seed, B, Lq, Lt):
    """Half the pairs related, ragged lengths padded with N4, a few Ns;
    pair 0 fills the bucket."""
    rng = np.random.default_rng(seed)
    q = ACGT[rng.integers(0, 4, (B, Lq))]
    t = ACGT[rng.integers(0, 4, (B, Lt))]
    k = min(Lq, Lt)
    q[::2, :k] = t[::2, :k]
    q[rng.random(q.shape) < 0.05] = N4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    ql[0], tl[0] = Lq, Lt
    q[np.arange(Lq)[None, :] >= ql[:, None]] = N4
    t[np.arange(Lt)[None, :] >= tl[:, None]] = N4
    return q, t, ql, tl


def _start_edges(seed, B=129, Lt=16):
    """Start-pass inputs at Lq 1: suffixes of 0 and 8 rows at offsets 0
    and 8, and half the forward scores out of any strip's reach."""
    rng = np.random.default_rng(seed)
    fwd = rng.integers(-12, 4, B).astype(np.int32)
    fwd[rng.random(B) < 0.5] = 1 << 20
    return (ACGT[rng.integers(0, 4, (B, 1))], ACGT[rng.integers(0, 4, (B, Lt))],
            np.ones(B, np.int32), rng.integers(1, Lt + 9, B).astype(np.int32),
            8 * rng.integers(0, 2, B).astype(np.int32),
            8 * rng.integers(0, 2, B).astype(np.int32), fwd,
            np.zeros(B, np.int32))


def _equal(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"field {k}")


@pytest.mark.parametrize("B", [1, 129])
@pytest.mark.parametrize("Lq", [1, 9])
def test_local_plain_at_the_edges_matches_jax(B, Lq):
    """Score, ends and TB cube on one strip (Lt = 8), and the inline
    second best, with an n_penalty."""
    jp = JParams(n_penalty=2)
    q, t, ql, tl = _local_batch(30 + B + Lq, B, Lq, 8)
    want = jscan.local_align_batch(jnp.asarray(q), jnp.asarray(t), jp,
                                   with_tb=True)
    got = local_align_batch(torch.from_numpy(q), torch.from_numpy(t),
                            params_from_jax(jp), with_tb=True)
    _equal(got[:3], want[:3])
    tb = np.asarray(want.tb)                        # [B, Lt, Lq] nibbles
    words = (tb.astype(np.int64).reshape(B, 1, 8, Lq)
             << (4 * np.arange(8))[None, None, :, None]).sum(2)
    np.testing.assert_array_equal(got.tb.numpy(),
                                  words.astype(np.uint32).view(np.int32)
                                  .transpose(1, 2, 0))
    want2 = JF.local_align_second_batch(q, t, ql, tl, jp)
    got2 = F.local_align_second_batch(*(torch.from_numpy(x)
                                        for x in (q, t, ql, tl)),
                                      params_from_jax(jp))
    _equal(got2, want2)


@pytest.mark.parametrize("head,tail", list(itertools.product(SKIPS, SKIPS)),
                         ids=lambda s: s.name)
def test_semiglobal_start_plain_at_the_edges_matches_jax(head, tail):
    args = _start_edges(31)
    flags = F.skip_flags(head, tail)
    want = JF._semiglobal_start_core(*args, JParams(), **flags)
    got = F._semiglobal_start_core(*(torch.from_numpy(x) for x in args),
                                   AlignmentParams(algo=AlgoType.SEMI_GLOBAL),
                                   **flags)
    _equal(got, want)


@pytest.mark.parametrize("mode", ["score", "end", "tb", "score16", "end16"])
def test_local_launch_args_lay_out_each_mode(mode):
    """One value per C parameter but the stream: the mode's number,
    with_n and the threads per pair (per two pairs in the 16-bit modes,
    the group asked for), the time-major inputs, the [Lq, B] carries
    ([Lq, ceil(B/2)] packed in the 16-bit modes), the [B] outputs, qend /
    tend only with ends and the sqb cube only in TB."""
    B, Lq, Lt = 7, 9, 16
    q, t, _, _ = _local_batch(32, B, Lq, Lt)
    Q, T = torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy())
    p = AlignmentParams(n_penalty=3)
    args = cuda_align.local_launch_args(mode, Q, T, p, True, group=8)
    sig = cuda_align._SIGNATURES["local_sw", "local_sw_launch"]
    assert len(args) + 1 == len(sig)
    assert args[:3] == (cuda_align._LOCAL_MODES[mode], 1,
                        8 if mode.endswith("16") else 1)
    assert args[3].data_ptr() == Q.data_ptr()
    assert args[4].data_ptr() == T.data_ptr()
    assert args[5:13] == (B, Lq, Lt, p.match, p.mismatch, -3, p.gap_oe,
                          p.gap_extend)
    width = (B + 1) // 2 if mode.endswith("16") else B
    assert all(x.shape == (Lq, width) and x.dtype == torch.int32
               for x in args[13:15])
    score, qend, tend, tb = args[-4:]
    assert score.shape == (B,)
    assert (qend is None) == (tend is None) == mode.startswith("score")
    assert (tb is None) == (mode != "tb")
    if tb is not None:
        assert tb.shape == (Lt // 8, Lq, B) and tb.dtype == torch.int32


@pytest.mark.parametrize("head,tail", [(SemiGlobalSkip.NONE, SemiGlobalSkip.BOTH),
                                       (SemiGlobalSkip.BOTH, SemiGlobalSkip.NONE),
                                       (SemiGlobalSkip.QUERY, SemiGlobalSkip.TARGET)],
                         ids=lambda s: s.name)
def test_semiglobal_start_launch_args(head, tail):
    """The skip flags' bits, the time-major inputs, the six [B] per-pair
    inputs in the C order, the scores, the [Lq, B] carries and the two
    [B] starts last."""
    args = [torch.from_numpy(x) for x in _start_edges(33, B=5, Lt=24)]
    Q, T = args[0].T.contiguous(), args[1].T.contiguous()
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL, n_penalty=4)
    flags = F.skip_flags(head, tail)
    got = cuda_align.semiglobal_start_launch_args(Q, T, *args[2:], p, **flags)
    sig = cuda_align._SIGNATURES["semiglobal_start", "semiglobal_start_launch"]
    assert len(got) + 1 == len(sig)
    assert got[0] == sum(int(v) << k for k, v in enumerate(
        (flags["head_q"], flags["head_t"], flags["tail_q"], flags["tail_t"])))
    assert got[1].data_ptr() == Q.data_ptr() and got[2].data_ptr() == T.data_ptr()
    for a, b in zip(got[3:9], args[2:]):
        assert torch.equal(a, b)
    assert got[9:17] == (5, 1, 24, p.match, p.mismatch, -4, p.gap_open,
                         p.gap_extend)
    assert all(x.shape == (1, 5) for x in got[17:19])
    assert all(x.shape == (5,) and x.dtype == torch.int32 for x in got[19:])


def test_by_row_count_orders_the_pairs():
    """The per-pair inputs and the inputs' columns gathered in row_count
    order, the sizes and scores passed on, the starts fresh."""
    args = [torch.from_numpy(x) for x in _start_edges(34, B=40, Lt=24)]
    Q, T = args[0].T.contiguous(), args[1].T.contiguous()
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    flags = F.skip_flags(SemiGlobalSkip.NONE, SemiGlobalSkip.BOTH)
    la = cuda_align.semiglobal_start_launch_args(Q, T, *args[2:], p, **flags)
    ordered, order = cuda_align.by_row_count(la)
    assert len(ordered) == len(la) and ordered[0] == la[0]
    assert bool((ordered[6][1:] >= ordered[6][:-1]).all())
    assert torch.equal(ordered[1], Q[:, order])
    assert torch.equal(ordered[2], T[:, order])
    for got, x in zip(ordered[3:9], la[3:9]):
        assert torch.equal(got, x[order])
    assert ordered[9:-4] == la[9:-4]
    assert ordered[-4] is la[-4] and ordered[-3] is la[-3]
    assert all(g is not x and g.shape == x.shape
               for g, x in zip(ordered[-2:], la[-2:]))


def test_launch_semiglobal_start_returns_the_launch_order(monkeypatch):
    """The starts that the ordered launch writes go back to each pair's
    own place: the kernel stood in for by the plain version on the
    ordered inputs."""
    def plain_kernel(key, dev, flags, Q, T, *rest):
        per, (B, Lq, Lt, match, mismatch, n_score, gapo, ge) = rest[:6], rest[6:14]
        tstart, qstart = rest[-2:]
        got = F._semiglobal_start_core(
            Q.T, T.T, *per, AlignmentParams(
                algo=AlgoType.SEMI_GLOBAL, match=match, mismatch=mismatch,
                gap_open=gapo, gap_extend=ge),
            head_q=bool(flags & 1), head_t=bool(flags & 2),
            tail_q=bool(flags & 4), tail_t=bool(flags & 8))
        tstart.copy_(got[0])
        qstart.copy_(got[1])

    monkeypatch.setattr(cuda_align, "_call", plain_kernel)
    args = [torch.from_numpy(x) for x in _start_edges(35, B=64, Lt=24)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    flags = F.skip_flags(SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH)
    la = cuda_align.semiglobal_start_launch_args(
        args[0].T.contiguous(), args[1].T.contiguous(), *args[2:], p, **flags)
    got = cuda_align.launch_semiglobal_start(la)
    want = F._semiglobal_start_core(*args, p, **flags)
    _equal(got, [w.numpy() for w in want])


def _start_inputs(seed, B=40, Lq=40, Lt=48, p=AlignmentParams(n_penalty=2)):
    """The reverse pass's inputs and extents from the plain forward
    result of a _local_batch, a third of the forward scores 0 (the first
    segment stops) and a third out of reach (the walk runs to the end)."""
    q, t, ql, tl = (torch.from_numpy(x) for x in _local_batch(seed, B, Lq, Lt))
    fwd = local_align_batch(q, t, p)
    rq, rt, qr8, tr8 = F.local_start_inputs(q, t, ql, tl, fwd.query_end,
                                            fwd.target_end)
    score = fwd.score.clone()
    score[0::3] = 0
    score[1::3] = 1 << 20
    return rq, rt, score, qr8, tr8


def _start_walk(q, t, target, ncol, nstrip, p: AlignmentParams, group):
    """One pair's reverse pass as csrc/local_start.cu walks it, its loops
    ending at ncol columns and nstrip strips: each strip tracks its own
    best and stop, and the strips of a round of `group` are combined in
    visit order.  Returns (cprime, sstrip, r0)."""
    n_score = -p.n_penalty if p.n_penalty is not None else 0
    H, E = [0] * ncol, [0] * ncol
    best, cell = -1, (0, 0, 0)
    for first in range(0, nstrip, group):
        strips = []
        for s in range(first, min(first + group, nstrip)):
            hp, f, diag0 = [0] * 8, [0] * 8, 0
            sbest, scell, found = -1, (0, s, 0), False
            for j in range(ncol):
                diag, e, hcol = diag0, (E[j] if s else 0), (H[j] if s else 0)
                for c in range(8):
                    tc = t[s * 8 + c]
                    sub = p.match if q[j] == tc else -p.mismatch
                    if N4 in (q[j], tc):
                        sub = n_score
                    tmp, u = diag + sub, f[c]
                    h = max(tmp, u, e, 0)
                    if h > sbest:
                        sbest, scell = h, (j, s, c)
                    f[c] = max(tmp - p.gap_oe, u - p.gap_extend)
                    e = max(tmp - p.gap_oe, e - p.gap_extend)
                    diag, hp[c] = hp[c], h
                diag0, H[j], E[j] = hcol, hp[7], e
                if sbest >= target:
                    found = True
                    break
            strips.append((sbest, scell, found))
            if found:
                break
        for sbest, scell, found in strips:
            if sbest > best:
                best, cell = sbest, scell
            if found:
                return cell
    return cell


def _plain_start_kernel(key, dev, Q, T, fwd, qext, text, order, B, Lq, Lt,
                        match, mismatch, n_score, goe, ge, group, gH, gE, col,
                        strip, row):
    """A stand-in for local_start_launch on the CPU: `_start_walk` on each
    slot of the (ordered) Q and T it is handed, for the pair the order
    puts there (its forward score, extents and outputs)."""
    p = AlignmentParams(match=match, mismatch=mismatch, gap_open=goe - ge,
                        gap_extend=ge, n_penalty=-n_score)
    for i in range(B):
        b = int(order[i]) if order is not None else i
        ncol = min(int(qext[b]), Lq) if qext is not None else Lq
        nstrip = (min(int(text[b]), Lt) if text is not None else Lt) // 8
        col[b], strip[b], row[b] = _start_walk(
            Q[:, i].tolist(), T[:, i].tolist(), int(fwd[b]), ncol,
            nstrip if ncol else 0, p, group)


def test_jax_start_pass_records_no_cell_past_the_extents():
    """The JAX package's start pass never records a cell past a pair's
    qr8 columns or tr8 / 8 strips (here with zero and unreachable forward
    scores, n_penalty set and unset, over related and random pairs): the
    padding never raises the running max, which is what lets the kernel's
    loops end at the extents."""
    for seed, p in ((36, AlignmentParams()), (37, AlignmentParams(n_penalty=2))):
        rq, rt, score, qr8, tr8 = _start_inputs(seed, B=96, p=p)
        cp, ss, r0 = (np.asarray(x) for x in JF._local_start_core(
            jnp.asarray(rq.numpy()), jnp.asarray(rt.numpy()),
            jnp.asarray(score.numpy()),
            JParams(n_penalty=p.n_penalty)))
        assert (cp < qr8.numpy()).all()
        assert (ss * 8 < tr8.numpy()).all()
        assert ((0 <= r0) & (r0 < 8)).all()


@pytest.mark.parametrize("group", [4, 8])
def test_launch_local_start_returns_the_launch_order(monkeypatch, group):
    """The kernel's walk (stood in for by `_start_walk`, loops ending at
    the extents, its strips `group` to a round) on the pairs ordered by
    qr8 x tr8 gives back, in each pair's own place, the JAX package's
    start pass on the full inputs; without extents, the full walk too."""
    monkeypatch.setattr(cuda_align, "_call", _plain_start_kernel)
    p = AlignmentParams(n_penalty=2)
    rq, rt, score, qr8, tr8 = _start_inputs(38 + group, p=p)
    want = JF._local_start_core(jnp.asarray(rq.numpy()),
                                jnp.asarray(rt.numpy()),
                                jnp.asarray(score.numpy()), JParams(n_penalty=2))
    for ext in ((qr8, tr8), (None, None)):
        args = cuda_align.local_start_launch_args(rq.T, rt.T, score, p, *ext,
                                                  group=group)
        _equal(cuda_align.launch_local_start(args), want)


def test_local_start_launch_args_and_order():
    """One value per C parameter but the stream, the extents passed on
    (or None), no order, the threads per pair, the [Lq, B] carries and
    the three [B] outputs last; the ordering gathers Q's and T's columns
    by qr8 x tr8, largest first, and passes that order on as int32 with
    every other argument as it was."""
    p = AlignmentParams(n_penalty=3)
    rq, rt, score, qr8, tr8 = _start_inputs(42, B=33, Lq=9, Lt=24)
    Q, T = rq.T.contiguous(), rt.T.contiguous()
    args = cuda_align.local_start_launch_args(Q, T, score, p, qr8, tr8,
                                              group=4)
    sig = cuda_align._SIGNATURES["local_start", "local_start_launch"]
    assert len(args) + 1 == len(sig)
    assert args[0].data_ptr() == Q.data_ptr() and args[1].data_ptr() == T.data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(args[2:5], (score, qr8, tr8)))
    assert args[5] is None
    assert args[6:15] == (33, 9, 24, p.match, p.mismatch, -3, p.gap_oe,
                          p.gap_extend, 4)
    assert all(x.shape == (9, 33) for x in args[15:17])
    assert all(x.shape == (33,) and x.dtype == torch.int32 for x in args[17:])
    bare = cuda_align.local_start_launch_args(Q, T, score, p, group=8)
    assert bare[3] is None and bare[4] is None and bare[14] == 8
    ordered = cuda_align.local_start_order(args)
    order = ordered[5]
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(33))
    key = (qr8 * tr8)[order.long()]
    assert bool((key[1:] <= key[:-1]).all())
    assert torch.equal(ordered[0], Q[:, order.long()])
    assert torch.equal(ordered[1], T[:, order.long()])
    assert len(ordered) == len(args)
    assert all(g is x for g, x in zip(ordered[2:5] + ordered[6:],
                                      args[2:5] + args[6:]))


def _banded_walk(q, t, ql, tl, Lq, Lt, band, p: AlignmentParams, ring,
                 with_n):
    """One pair's banded alignment as csrc/banded_sw.cu walks it, the
    carry a ring of `ring` columns (column j in slot j mod ring) whose
    slots start as garbage and read zero until a strip first reaches
    their column.  Returns (score, qend, tend)."""
    n_score = -p.n_penalty if p.n_penalty is not None else 0
    goe, ge = p.gap_oe, p.gap_extend
    qr, tr = (min(ql, Lq) + 7) // 8, (min(tl, Lt) + 7) // 8
    k_other = tr - (qr - band)
    slots = [(12345, -678)] * ring
    best = qend = tend = seen = 0
    for s in range(tr):
        tc = t[s * 8:s * 8 + 8]
        h, f, pp = [0] * 8, [0] * 8, [0] * 8
        lo, hi = max(0, s - k_other + 1), min(band + s, qr)
        for j in range(lo * 8, hi * 8):
            up, e = slots[j % ring] if j // 8 < seen else (0, 0)
            qc, top, brow = q[j], best, 0
            for c in range(8):
                sub = p.match if qc == tc[c] else -p.mismatch
                if with_n and N4 in (qc, tc[c]):
                    sub = n_score
                f[c] = max(h[c] - goe, f[c] - ge)
                e = max(up - goe, e - ge)
                hm = max(pp[c] + sub, f[c], 0, e)
                if hm > best:
                    best, brow = hm, c
                pp[c], h[c], up = up, hm, hm
            if best > top:
                qend, tend = j, s * 8 + brow
            slots[j % ring] = (h[7], e)
        seen = max(seen, hi)
    return best, qend, tend


def _plain_banded_kernel(key, dev, mode, with_n, shared, q, t, ql, tl, B,
                         Lq, Lt, band, match, mismatch, n_score, goe, ge,
                         ring, eh, score, qend, tend):
    """A stand-in for banded_sw_launch on the CPU: `_banded_walk` per
    pair."""
    p = AlignmentParams(algo=AlgoType.BANDED, match=match, mismatch=mismatch,
                        gap_open=goe - ge, gap_extend=ge, n_penalty=-n_score)
    for b in range(B):
        got = _banded_walk(q[b].tolist(), t[b].tolist(), int(ql[b]),
                           int(tl[b]), Lq, Lt, band, p, ring, bool(with_n))
        score[b] = got[0]
        if mode:
            qend[b], tend[b] = got[1:]


@pytest.mark.parametrize("band", [1, 4])
@pytest.mark.parametrize("ring", ["rule", "Lq", "widest"])
def test_banded_ring_walk_matches_jax(monkeypatch, band, ring):
    """The kernel's walk (stood in for by `_banded_walk`: no zeroing
    pass, the carry a ring of `banded_ring`'s columns, of the full Lq or
    of the launch's widest band window) gives the JAX package's banded
    alignment; END and SCORE."""
    monkeypatch.setattr(cuda_align, "_call", _plain_banded_kernel)
    q, t, ql, tl = _local_batch(43 + band, 48, 40, 48)
    ql[1], tl[1] = 40, 8        # k_other <= 0 at band 1: empty bands
    q[1, :] = q[0, :]
    t[1, 8:] = N4
    jp = JParams(n_penalty=2)
    want = jscan.banded_align_batch(*map(jnp.asarray, (q, t, ql, tl)), jp,
                                    band_width_tiles=band)
    q, t, ql, tl = (torch.from_numpy(x) for x in (q, t, ql, tl))
    p = params_from_jax(jp)
    r = {"rule": None, "Lq": 40,
         "widest": 8 * int(band_windows(ql, tl, band).max())}[ring]
    for mode in ("end", "score"):
        args = cuda_align.banded_launch_args(mode, q, t, ql, tl, p, band,
                                             True, ring=r)
        got = cuda_align.launch_banded(args)
        _equal(got if mode == "end" else got[:1], want[:3] if mode == "end"
               else want[:1])


def test_banded_launch_args_lay_out_each_mode():
    """One value per C parameter but the stream: the mode, with_n, the
    layout, the [B, L] inputs read as they are, the band, the ring of
    banded_ring, no scratch in the shared layout ([B, ring] int2 in the
    global one) and the [B] outputs last, qend / tend only with ends."""
    q, t, ql, tl = (torch.from_numpy(x) for x in _local_batch(44, 37, 40, 48))
    p = AlignmentParams(algo=AlgoType.BANDED, n_penalty=3)
    args = cuda_align.banded_launch_args("end", q, t, ql, tl, p, 2, True)
    sig = cuda_align._SIGNATURES["banded_sw", "banded_sw_launch"]
    assert len(args) + 1 == len(sig)
    assert args[:3] == (1, 1, 1)
    assert args[3].data_ptr() == q.data_ptr() and args[4].data_ptr() == t.data_ptr()
    assert args[5] is ql and args[6] is tl
    assert args[7:18] == (37, 40, 48, 2, p.match, p.mismatch, -3, p.gap_oe,
                          p.gap_extend, cuda_align.banded_ring(40, 48, 2),
                          None)
    assert all(x.shape == (37,) and x.dtype == torch.int32 for x in args[18:])
    score = cuda_align.banded_launch_args("score", q, t, ql, tl, p, 2, False,
                                          force_global=True, ring=16)
    assert score[:3] == (0, 0, 0) and score[16] == 16
    assert score[17].shape == (37, 16, 2) and score[-2:] == (None, None)


@pytest.mark.parametrize("band", [1, 2, 4, 9])
def test_banded_ring_covers_every_window(band):
    """banded_ring's columns cover the widest band window of any lengths
    that fit the shape (every qlen, tlen up to Lq, Lt here), and equal
    the widest where a pair reaches it: 104 of 152 columns at bench.py's
    shape and band 4."""
    for Lq, Lt in ((8, 8), (40, 48), (152, 152), (216, 328), (64, 16)):
        ql, tl = (np.arange(1, n + 1) for n in (Lq, Lt))
        ql, tl = ql.repeat(Lt), np.tile(tl, Lq)
        widest = int(band_windows(ql, tl, band).max())
        assert cuda_align.banded_ring(Lq, Lt, band) == 8 * max(1, widest)
    assert cuda_align.banded_ring(152, 152, 4) == 104


@pytest.mark.parametrize("ring,layout", [(8, "shared"), (104, "shared"),
                                         (904, "shared"), (912, "global")])
def test_banded_layout_is_a_rule_on_the_ring(ring, layout):
    """Shared memory while 32 threads' 8 ring bytes each fit 232,448 (up
    to 908 columns), the global scratch beyond."""
    assert cuda_align.banded_layout(ring) == layout
    assert (32 * 8 * ring <= 232_448) == (layout == "shared")


@pytest.mark.parametrize("band", [1, 2, 4, 9])
def test_band_windows_count_the_band(band):
    """band_windows' rows are the band's tiles strip by strip, as the
    plain walk visits them (`_banded_walk`'s loop bounds), and
    band_cells their sum x 64."""
    _, _, ql, tl = _local_batch(45, 200, 40, 48)
    got = band_windows(ql, tl, band)
    assert got.shape == (200, 6)
    for b in range(200):
        qr, tr = (int(ql[b]) + 7) // 8, (int(tl[b]) + 7) // 8
        k_other = tr - (qr - band)
        want = [max(0, min(band + s, qr) - max(0, s - k_other + 1))
                if s < tr else 0 for s in range(6)]
        assert got[b].tolist() == want
    assert band_cells(ql, tl, band) == int(got.sum()) * 64
