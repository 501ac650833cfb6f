"""Parity of the port's plain second-best and WITH_START engines
(`genomics_tpu_torch.ops.scan_align_full`) with the JAX package: its
scan cores, its Pallas kernels in interpret mode (the inline second-best
kernel and the semiglobal start pass at B=1024, the local start pass
through `use_pallas=True`) and its golds.  Scores, ends, starts and
second-best fields must be integer-equal."""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu.core import golds as jgolds
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.core.scoring import SemiGlobalSkip as JSkip
from genomics_tpu.ops import pallas_align, pallas_gs
from genomics_tpu.ops import scan_align_full as JF
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.core.scoring import SemiGlobalSkip, params_from_jax
from genomics_tpu_torch.ops import cuda_align
from genomics_tpu_torch.ops import scan_align_full as F
from test_torch_global_align import _batch, _torch

SKIPS = [JSkip.NONE, JSkip.QUERY, JSkip.TARGET, JSkip.BOTH]
COMBOS = list(itertools.product(SKIPS, SKIPS))
JP = JParams()


def _mine(skip: JSkip) -> SemiGlobalSkip:
    return SemiGlobalSkip(skip.value)


def _ids(s):
    return s.name


def _assert_tuple(got, want, what=""):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{what} field {k}")


@pytest.mark.parametrize("jp,n_rate", [
    (JParams(), 0.0),
    (JParams(), 0.05),
    (JParams(n_penalty=2, match=2, mismatch=3, gap_open=5, gap_extend=2), 0.05),
], ids=["acgt", "with_ns", "n_penalty_other_scores"])
def test_second_best_matches_scan_core(jp, n_rate):
    rng = np.random.default_rng(int(n_rate * 100) + jp.match)
    q, t, ql, tl = _batch(rng, 64, 40, 48, n_rate=n_rate)
    want = JF.local_align_second_batch(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl), jp)
    got = F.local_align_second_batch(*_torch(q, t, ql, tl),
                                     params_from_jax(jp))
    _assert_tuple(got, want)
    assert (got.score_second > 0).any(), "no second best exercised"


def test_second_best_matches_pallas_kernel():
    """`_local_kernel_intertask_second` (B=1024), interpret mode."""
    rng = np.random.default_rng(21)
    q, t, ql, tl = _batch(rng, 1024, 16, 24, n_rate=0.03)
    want = pallas_align.local_align_second_tpu(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl), JP)
    got = cuda_align.local_align_second(*_torch(q, t, ql, tl),
                                        params_from_jax(JP))
    _assert_tuple(got, want)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["scan", "pallas"])
@pytest.mark.parametrize("n_rate", [0.0, 0.04], ids=["acgt", "with_ns"])
def test_local_with_start_matches_jax(use_pallas, n_rate):
    """The full 5-tuple; use_pallas=True runs `_local_kernel` and
    `_local_start_kernel` in interpret mode (B padded to 128)."""
    rng = np.random.default_rng(31 + int(use_pallas))
    q, t, ql, tl = _batch(rng, 40, 32, 48, n_rate=n_rate)
    want = JF.local_align_with_start(q, t, ql, tl, JP, use_pallas=use_pallas)
    got = F.local_align_with_start(*_torch(q, t, ql, tl), params_from_jax(JP))
    _assert_tuple(got, want)


@pytest.mark.parametrize("head,tail", COMBOS, ids=_ids)
def test_semiglobal_with_start_matches_scan_core(head, tail):
    """In-sequence Ns, and an n_penalty on half the combinations."""
    rng = np.random.default_rng(40 + head.value * 4 + tail.value)
    jp = JParams(n_penalty=2 if tail.value % 2 else None)
    q, t, ql, tl = _batch(rng, 32, 24, 40, n_rate=0.04)
    want = JF.semiglobal_align_with_start(q, t, ql, tl, jp, head=head,
                                          tail=tail, use_pallas=False)
    got = F.semiglobal_align_with_start(*_torch(q, t, ql, tl),
                                        params_from_jax(jp),
                                        head=_mine(head), tail=_mine(tail))
    _assert_tuple(got, want, f"{head} {tail}")


@pytest.mark.parametrize("skip", SKIPS, ids=_ids)
def test_semiglobal_start_matches_pallas_intertask(skip):
    """`_semiglobal_start_kernel` (B=1024), interpret mode, HEAD == TAIL,
    fed the forward result through the port's reversed inputs."""
    rng = np.random.default_rng(50 + skip.value)
    q, t, ql, tl = _batch(rng, 1024, 24, 32, n_rate=0.03)
    p = params_from_jax(JP)
    qt, tt, qlt, tlt = _torch(q, t, ql, tl)
    fwd = cuda_align.semiglobal_align(qt, tt, qlt, tlt, p, head=_mine(skip),
                                      tail=_mine(skip))
    rev = F.semiglobal_start_inputs(qt, tt, qlt, tlt, fwd.target_end)
    flags = F.skip_flags(_mine(skip), _mine(skip))
    want = pallas_gs.semiglobal_start_intertask(
        *(jnp.asarray(x.numpy()) for x in rev[:2]), jnp.asarray(ql),
        jnp.asarray(tl), *(jnp.asarray(x.numpy()) for x in rev[2:]),
        jnp.asarray(fwd.score.numpy()), jnp.asarray(fwd.query_end.numpy()),
        JP, **flags)
    got = cuda_align.semiglobal_start(rev[0], rev[1], qlt, tlt, *rev[2:],
                                      fwd.score, fwd.query_end, p, **flags)
    _assert_tuple(got, want)


def test_golds_match_jax_golds():
    """The port's golds, every flag on, against the JAX golds: LOCAL with
    both passes, SEMI_GLOBAL on all 16 skips."""
    rng = np.random.default_rng(60)
    p = params_from_jax(JP)
    q, t, ql, tl = _batch(rng, 16, 24, 40, n_rate=0.04)
    for b in range(16):
        qa, ta = q[b, :ql[b]], t[b, :tl[b]]
        assert golds.local_align(qa, ta, p, with_start=True,
                                 second_best=True) == jgolds.local_align(
            qa, ta, JP, with_start=True, second_best=True), b
        for head, tail in COMBOS:
            mine = golds.semiglobal_align(qa, ta, p, head=_mine(head),
                                          tail=_mine(tail), with_start=True,
                                          second_best=True)
            want = jgolds.semiglobal_align(qa, ta, JP, head=head, tail=tail,
                                           with_start=True, second_best=True)
            assert mine == want, (b, head, tail)


def test_plain_matches_golds():
    """Ragged pairs with Ns through the plain engines and the port's golds:
    second best, LOCAL starts (the reference's skewed target start
    included; 0 where the score is 0) and SEMI_GLOBAL starts on all 16
    skips."""
    rng = np.random.default_rng(70)
    p = params_from_jax(JP)
    B = 24
    q, t, ql, tl = _batch(rng, B, 32, 40, n_rate=0.03)
    args = _torch(q, t, ql, tl)
    sec = F.local_align_second_batch(*args, p)
    st = F.local_align_with_start(*args, p)
    sg = {c: F.semiglobal_align_with_start(*args, p, head=_mine(c[0]),
                                           tail=_mine(c[1])) for c in COMBOS}
    for b in range(B):
        qa, ta = q[b, :ql[b]], t[b, :tl[b]]
        g = golds.local_align(qa, ta, p, with_start=True, second_best=True)
        assert [int(x[b]) for x in sec] == [
            g["score"], g["query_end"], g["target_end"], g["score_second"],
            g["query_end_second"], g["target_end_second"]], b
        assert [int(x[b]) for x in st] == [
            g["score"], g["query_end"], g["target_end"], g["query_start"],
            g["target_start"]], b
        for (head, tail), res in sg.items():
            g = golds.semiglobal_align(qa, ta, p, head=_mine(head),
                                       tail=_mine(tail), with_start=True)
            assert [int(x[b]) for x in res] == [
                g["score"], g["query_end"], g["target_end"],
                g["query_start"], g["target_start"]], (b, head, tail)


def test_with_start_embedded_known():
    """tests/test_scan_align_full.py's hand case: the reference skew puts
    the target start at 10, not 4."""
    from genomics_tpu_torch.core.encoding import encode4

    q = torch.from_numpy(encode4("ACGTACGT"))[None]
    t = torch.from_numpy(encode4("TTTTACGTACGTTTTT"))[None]
    lens = torch.tensor([8], dtype=torch.int32), torch.tensor([16], dtype=torch.int32)
    score, qe, te, qs, ts = F.local_align_with_start(q, t, *lens,
                                                     params_from_jax(JP))
    assert (int(score), int(qs), int(ts)) == (8, 0, 10)


def test_cpu_wrappers_take_the_plain_version():
    rng = np.random.default_rng(80)
    p = params_from_jax(JP)
    q, t, ql, tl = _torch(*_batch(rng, 24, 16, 24, n_rate=0.05))
    before = dict(cuda_align.LAUNCHES)
    _assert_tuple(cuda_align.local_align_second(q, t, ql, tl, p),
                  F.local_align_second_batch(q, t, ql, tl, p))
    fwd = cuda_align.local_align(q, t, p)
    rq, rt, _, _ = F.local_start_inputs(q, t, ql, tl, fwd.query_end,
                                        fwd.target_end)
    _assert_tuple(cuda_align.local_start(rq, rt, fwd.score, p),
                  F._local_start_core(rq, rt, fwd.score, p))
    flags = F.skip_flags(SemiGlobalSkip.BOTH, SemiGlobalSkip.QUERY)
    fwd = cuda_align.semiglobal_align(q, t, ql, tl, p)
    rev = F.semiglobal_start_inputs(q, t, ql, tl, fwd.target_end)
    per_pair = (ql, tl, *rev[2:], fwd.score, fwd.query_end)
    _assert_tuple(
        cuda_align.semiglobal_start(*rev[:2], *per_pair, p, **flags),
        F._semiglobal_start_core(*rev[:2], *per_pair, p, **flags))
    assert cuda_align.LAUNCHES == before
    with pytest.raises(ValueError, match="per-pair inputs"):
        cuda_align.local_align_second(q, t, ql.long(), tl, p)
    with pytest.raises(ValueError, match="per-pair inputs"):
        cuda_align.local_start(rq, rt, fwd.score[:3], p)
    with pytest.raises(ValueError, match="Lt"):
        F.local_align_second_batch(q, t[:, :20], ql, tl, p)
