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
    """One value per C parameter but the stream: the mode's number and
    with_n, the time-major inputs, the [Lq, B] carries ([Lq, ceil(B/2)]
    packed in the 16-bit modes), the [B] outputs, qend / tend only with
    ends and the sqb cube only in TB."""
    B, Lq, Lt = 7, 9, 16
    q, t, _, _ = _local_batch(32, B, Lq, Lt)
    Q, T = torch.from_numpy(q.T.copy()), torch.from_numpy(t.T.copy())
    p = AlignmentParams(n_penalty=3)
    args = cuda_align.local_launch_args(mode, Q, T, p, True)
    sig = cuda_align._SIGNATURES["local_sw", "local_sw_launch"]
    assert len(args) + 1 == len(sig)
    assert args[:2] == (cuda_align._LOCAL_MODES[mode], 1)
    assert args[2].data_ptr() == Q.data_ptr()
    assert args[3].data_ptr() == T.data_ptr()
    assert args[4:12] == (B, Lq, Lt, p.match, p.mismatch, -3, p.gap_oe,
                          p.gap_extend)
    width = (B + 1) // 2 if mode.endswith("16") else B
    assert all(x.shape == (Lq, width) and x.dtype == torch.int32
               for x in args[12:14])
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
