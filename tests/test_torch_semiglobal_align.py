"""Parity of the port's plain SEMI_GLOBAL alignment
(`genomics_tpu_torch.ops`) with the JAX package, over all 16 HEAD x TAIL
combinations: its scan engine, its Pallas kernels in interpret mode (the
inter-task kernel at B=1024, the lanes kernel with traceback at B=128)
and its golds.  Scores, ends — the reference's quirky ones included —
and traceback words must be integer-equal."""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest

from genomics_tpu.core import golds as jgolds
from genomics_tpu.core.scoring import AlgoType as JAlgo
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.core.scoring import SemiGlobalSkip as JSkip
from genomics_tpu.ops import pallas_align, pallas_gs, scan_align as jscan
from genomics_tpu.runtime.dispatch import _pack_nibbles_np
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.core.scoring import SemiGlobalSkip, params_from_jax
from genomics_tpu_torch.ops import cuda_align
from genomics_tpu_torch.ops.scan_align import semiglobal_align_batch
from test_torch_global_align import _assert_result, _batch, _sqb, _torch

SKIPS = [JSkip.NONE, JSkip.QUERY, JSkip.TARGET, JSkip.BOTH]
COMBOS = list(itertools.product(SKIPS, SKIPS))
TB_COMBOS = [(s, s) for s in SKIPS]   # the engine's traceback combinations
JP = JParams(algo=JAlgo.SEMI_GLOBAL)


def _mine(skip: JSkip) -> SemiGlobalSkip:
    return SemiGlobalSkip(skip.value)


def _ids(s):
    return s.name


@pytest.mark.parametrize("head,tail", COMBOS, ids=_ids)
def test_plain_matches_scan_engine(head, tail):
    """With traceback, in-sequence Ns, and an n_penalty on half the
    combinations."""
    rng = np.random.default_rng(head.value * 4 + tail.value)
    jp = JParams(algo=JAlgo.SEMI_GLOBAL,
                 n_penalty=2 if head.value % 2 else None)
    q, t, ql, tl = _batch(rng, 48, 24, 40, n_rate=0.05)
    want = jscan.semiglobal_align_batch(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl), jp,
        head=head, tail=tail, with_tb=True)
    got = semiglobal_align_batch(*_torch(q, t, ql, tl), params_from_jax(jp),
                                 head=_mine(head), tail=_mine(tail),
                                 with_tb=True)
    _assert_result(got, want.score, want.query_end, want.target_end,
                   _sqb(_pack_nibbles_np(np.asarray(want.tb))))


@pytest.mark.parametrize("head,tail", COMBOS, ids=_ids)
def test_plain_matches_pallas_intertask(head, tail):
    """`_semiglobal_kernel_intertask` (B=1024), interpret mode."""
    rng = np.random.default_rng(30 + head.value * 4 + tail.value)
    q, t, ql, tl = _batch(rng, 1024, 16, 24, n_rate=0.03)
    s, x, y = pallas_gs.semiglobal_align_intertask(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl),
        JP, head=head, tail=tail)
    got = semiglobal_align_batch(*_torch(q, t, ql, tl), params_from_jax(JP),
                                 head=_mine(head), tail=_mine(tail))
    _assert_result(got, s, x, y)


@pytest.mark.parametrize("head,tail", TB_COMBOS, ids=_ids)
def test_plain_matches_pallas_lanes_tb(head, tail):
    """`_semiglobal_kernel` with traceback (B=128), interpret mode: the
    nibbles follow its E_used bookkeeping."""
    rng = np.random.default_rng(50 + head.value)
    q, t, ql, tl = _batch(rng, 128, 16, 24, n_rate=0.03)
    want = pallas_align.semiglobal_align_tpu(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl),
        JP, head=head, tail=tail, with_tb=True)
    got = semiglobal_align_batch(*_torch(q, t, ql, tl), params_from_jax(JP),
                                 head=_mine(head), tail=_mine(tail),
                                 with_tb=True)
    _assert_result(got, want.score, want.query_end, want.target_end,
                   _sqb(want.tb))


def test_plain_matches_golds():
    """Every combination on pairs through the JAX gold and the port's
    copy of it, the start pass included."""
    rng = np.random.default_rng(8)
    p = params_from_jax(JP)
    B, Lq, Lt = 12, 24, 40
    q, t, ql, tl = _batch(rng, B, Lq, Lt, n_rate=0.03)
    for head, tail in COMBOS:
        got = semiglobal_align_batch(*_torch(q, t, ql, tl), p,
                                     head=_mine(head), tail=_mine(tail))
        for b in range(B):
            qa, ta = q[b, :ql[b]], t[b, :tl[b]]
            want = jgolds.semiglobal_align(qa, ta, JP, head=head, tail=tail)
            mine = golds.semiglobal_align(qa, ta, p, head=_mine(head),
                                          tail=_mine(tail))
            assert mine == want, (head, tail, b)
            assert (int(got.score[b]), int(got.query_end[b]),
                    int(got.target_end[b])) == (
                want["score"], want["query_end"], want["target_end"]), \
                (head, tail, b)
    for head, tail in COMBOS:
        qa, ta = q[1, :ql[1]], t[1, :tl[1]]
        assert golds.semiglobal_align(
            qa, ta, p, head=_mine(head), tail=_mine(tail), with_start=True) \
            == jgolds.semiglobal_align(qa, ta, JP, head=head, tail=tail,
                                       with_start=True), (head, tail)


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(3)
    p = params_from_jax(JP)
    args = _torch(*_batch(rng, 24, 16, 24, n_rate=0.05))
    before = dict(cuda_align.LAUNCHES)
    for with_tb in (False, True):
        want = semiglobal_align_batch(*args, p, head=SemiGlobalSkip.BOTH,
                                      tail=SemiGlobalSkip.QUERY,
                                      with_tb=with_tb)
        got = cuda_align.semiglobal_align(*args, p, head=SemiGlobalSkip.BOTH,
                                          tail=SemiGlobalSkip.QUERY,
                                          with_tb=with_tb)
        _assert_result(got, want.score, want.query_end, want.target_end,
                       want.tb)
    assert cuda_align.LAUNCHES == before
    with pytest.raises(ValueError, match="Lt % 8"):
        semiglobal_align_batch(args[0], args[1][:, :20], args[2], args[3], p)
