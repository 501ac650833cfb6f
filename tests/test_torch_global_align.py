"""Parity of the port's plain GLOBAL alignment (`genomics_tpu_torch.ops`)
with the JAX package: its scan engine, its Pallas kernels in interpret
mode (the lanes kernel at B=128 with and without traceback, the
inter-task score kernel at B=1024) and its golds.  Scores, ends and
traceback words must be integer-equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu.core import golds as jgolds
from genomics_tpu.core.scoring import AlgoType as JAlgo
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.ops import pallas_align, pallas_gs, scan_align as jscan
from genomics_tpu.runtime.dispatch import _pack_nibbles_np
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.core.scoring import params_from_jax
from genomics_tpu_torch.ops import cuda_align
from genomics_tpu_torch.ops.scan_align import global_align_batch

ACGT = np.array([1, 3, 7, 4], np.uint8)  # 4-bit codes of A, C, G, T
N4 = 14


def _batch(rng, B, Lq, Lt, n_rate=0.0):
    """(q, t, qlen, tlen) as numpy: half the pairs related, ragged
    lengths padded with N4, in-sequence Ns at n_rate; pair 0 fills the
    bucket exactly (qlen == Lq, tlen == Lt)."""
    q = ACGT[rng.integers(0, 4, (B, Lq))]
    t = ACGT[rng.integers(0, 4, (B, Lt))]
    k = min(Lq, Lt)
    q[::2, :k] = t[::2, :k]
    flip = rng.random((B, Lq)) < 0.1
    q[flip] = ACGT[rng.integers(0, 4, flip.sum())]
    if n_rate:
        q[rng.random((B, Lq)) < n_rate] = N4
        t[rng.random((B, Lt)) < n_rate] = N4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    ql[0], tl[0] = Lq, Lt
    for b in range(B):
        q[b, ql[b]:] = N4
        t[b, tl[b]:] = N4
    return q, t, ql, tl


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _sqb(bsq):
    """[B, Lt8, Lq] packed words → sqb [Lt8, Lq, B]."""
    return np.ascontiguousarray(np.asarray(bsq).transpose(1, 2, 0))


def _assert_result(got, score, qend, tend, tb=None):
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(score))
    np.testing.assert_array_equal(got.query_end.numpy(), np.asarray(qend))
    np.testing.assert_array_equal(got.target_end.numpy(), np.asarray(tend))
    if tb is not None:
        np.testing.assert_array_equal(got.tb.numpy(), np.asarray(tb))


@pytest.mark.parametrize("B,Lq,Lt,jp", [
    (64, 24, 32, JParams(algo=JAlgo.GLOBAL)),
    (48, 40, 16, JParams(algo=JAlgo.GLOBAL, n_penalty=3)),
    (40, 17, 24, JParams(algo=JAlgo.GLOBAL, match=2, mismatch=3,
                         gap_open=5, gap_extend=2)),
], ids=["defaults", "n_penalty", "odd_lq_other_scores"])
def test_plain_matches_scan_engine(B, Lq, Lt, jp):
    rng = np.random.default_rng(B + Lq)
    q, t, ql, tl = _batch(rng, B, Lq, Lt, n_rate=0.05)
    want = jscan.global_align_batch(jnp.asarray(q), jnp.asarray(t),
                                    jnp.asarray(ql), jnp.asarray(tl), jp,
                                    with_tb=True)
    got = global_align_batch(*_torch(q, t, ql, tl), params_from_jax(jp),
                             with_tb=True)
    _assert_result(got, want.score, want.query_end, want.target_end,
                   _sqb(_pack_nibbles_np(np.asarray(want.tb))))


@pytest.mark.parametrize("B,with_tb", [(128, False), (128, True),
                                       (1024, False)],
                         ids=["lanes", "lanes_tb", "intertask"])
def test_plain_matches_pallas_kernels(B, with_tb):
    """B=128 reaches `_global_kernel`, B=1024 without traceback
    `_global_kernel_intertask`, both in interpret mode."""
    rng = np.random.default_rng(17 + B)
    jp = JParams(algo=JAlgo.GLOBAL)
    q, t, ql, tl = _batch(rng, B, 16, 24, n_rate=0.03)
    want = pallas_align.global_align_tpu(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl),
        jp, with_tb=with_tb)
    got = global_align_batch(*_torch(q, t, ql, tl), params_from_jax(jp),
                             with_tb=with_tb)
    _assert_result(got, want.score, want.query_end, want.target_end,
                   _sqb(want.tb) if with_tb else None)
    if B == 1024:
        direct = pallas_gs.global_align_scores_intertask(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
            jnp.asarray(tl), jp)
        np.testing.assert_array_equal(got.score.numpy(), np.asarray(direct))


@pytest.mark.parametrize("jp", [
    JParams(algo=JAlgo.GLOBAL),
    JParams(algo=JAlgo.GLOBAL, n_penalty=2, match=2),
], ids=["defaults", "n_penalty"])
def test_plain_matches_golds(jp):
    """Pairs through the JAX gold and the port's copy of it: score, ends
    and the nibble matrix over each pair's own 8-padded extent."""
    rng = np.random.default_rng(5)
    p = params_from_jax(jp)
    B, Lq, Lt = 24, 40, 56
    q, t, ql, tl = _batch(rng, B, Lq, Lt, n_rate=0.03)
    got = global_align_batch(*_torch(q, t, ql, tl), p, with_tb=True)
    dirs = cuda_align.unpack_tb_nibbles(got.tb.permute(2, 0, 1)).numpy()
    for b in range(B):
        qa, ta = q[b, :ql[b]], t[b, :tl[b]]
        want = jgolds.global_align(qa, ta, jp, with_tb=True)
        mine = golds.global_align(qa, ta, p, with_tb=True)
        for k in ("score", "query_end", "target_end"):
            assert mine[k] == want[k], (b, k)
        np.testing.assert_array_equal(mine["tb_dirs"], want["tb_dirs"])
        assert int(got.score[b]) == want["score"], b
        assert int(got.query_end[b]) == want["query_end"], b
        assert int(got.target_end[b]) == want["target_end"], b
        ht, wq = want["tb_dirs"].shape
        np.testing.assert_array_equal(dirs[b, :ht, :wq], want["tb_dirs"],
                                      err_msg=str(b))


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(3)
    p = params_from_jax(JParams(algo=JAlgo.GLOBAL))
    args = _torch(*_batch(rng, 24, 16, 24, n_rate=0.05))
    before = dict(cuda_align.LAUNCHES)
    for with_tb in (False, True):
        want = global_align_batch(*args, p, with_tb=with_tb)
        got = cuda_align.global_align(*args, p, with_tb=with_tb)
        _assert_result(got, want.score, want.query_end, want.target_end,
                       want.tb)
    assert cuda_align.LAUNCHES == before
    with pytest.raises(ValueError, match="qlen/tlen"):
        cuda_align.global_align(args[0], args[1], args[2].long(), args[3], p)
