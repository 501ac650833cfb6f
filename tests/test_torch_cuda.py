"""The port's CUDA kernels against their plain PyTorch versions on the
card: integer-equal scores, ends, traceback words, op streams and starts.
Every test here needs a CUDA device and nvcc and skips without them.

This file imports neither JAX nor the JAX package, so it runs on a
machine without JAX:

    GENOMICS_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(the variable keeps tests/conftest.py from importing JAX).
"""
import itertools

import numpy as np
import pytest
import torch

from genomics_tpu_torch import AlgoType, AlignEngine, AlignmentParams
from genomics_tpu_torch.core.scoring import SemiGlobalSkip
from genomics_tpu_torch.ops import cuda_align, scan_align_full, tb_walk
from genomics_tpu_torch.ops.scan_align import (
    banded_align_batch,
    global_align_batch,
    ksw_align_batch,
    local_align_batch,
    semiglobal_align_batch,
)

pytestmark = pytest.mark.cuda

ACGT = np.array([1, 3, 7, 4], np.uint8)
N4 = 14
SKIPS = [SemiGlobalSkip.NONE, SemiGlobalSkip.QUERY, SemiGlobalSkip.TARGET,
         SemiGlobalSkip.BOTH]
TB_SKIPS = [(s, s) for s in SKIPS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(seed, B, Lq, Lt, n_rate):
    """(q, t, qlen, tlen): half the pairs related, random lengths padded
    with N4, in-sequence Ns at n_rate; pair 0 fills the bucket exactly."""
    rng = np.random.default_rng(seed)
    q = ACGT[rng.integers(0, 4, (B, Lq))]
    t = ACGT[rng.integers(0, 4, (B, Lt))]
    k = min(Lq, Lt)
    q[::2, :k] = t[::2, :k]
    flip = rng.random(q.shape) < 0.08
    q[flip] = ACGT[rng.integers(0, 4, flip.sum())]
    if n_rate:
        q[rng.random(q.shape) < n_rate] = N4
        t[rng.random(t.shape) < n_rate] = N4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    ql[0], tl[0] = Lq, Lt
    for b in range(B):
        q[b, ql[b]:] = N4
        t[b, tl[b]:] = N4
    return (torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(ql),
            torch.from_numpy(tl))


def _assert_equal(got, want):
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("with_tb", [False, True], ids=["end", "tb"])
@pytest.mark.parametrize("params", [
    AlignmentParams(), AlignmentParams(n_penalty=2),
], ids=["defaults", "n_penalty"])
def test_local_kernel_matches_plain(cuda, with_tb, params):
    q, t, _, _ = _batch(0, 1024 + 37, 40, 48, n_rate=0.03)
    want = local_align_batch(q.to(cuda), t.to(cuda), params, with_tb=with_tb)
    key = "local_sw.tb" if with_tb else "local_sw.end"
    before = cuda_align.LAUNCHES[key]
    got = cuda_align.local_align(q.to(cuda), t.to(cuda), params,
                                 with_tb=with_tb)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES[key] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("has_n", [True, False], ids=["has_n", "no_n"])
def test_score_kernel_matches_plain(cuda, has_n):
    q, t, _, _ = _batch(1, 2048 + 5, 152, 152, n_rate=0.02 if has_n else 0.0)
    q, t = q.to(cuda), t.to(cuda)
    want = local_align_batch(q, t, AlignmentParams()).score
    got = cuda_align.local_align_scores(q, t, AlignmentParams(), has_n=has_n)
    got_tm = cuda_align.local_align_scores_tm(
        q.T.contiguous(), t.T.contiguous(), AlignmentParams(), has_n=has_n)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_tm, want, rtol=0, atol=0)


@pytest.mark.parametrize("with_tb", [False, True], ids=["score", "tb"])
@pytest.mark.parametrize("params", [
    AlignmentParams(algo=AlgoType.GLOBAL),
    AlignmentParams(algo=AlgoType.GLOBAL, n_penalty=2, match=2),
], ids=["defaults", "n_penalty"])
def test_global_kernel_matches_plain(cuda, with_tb, params):
    args = [x.to(cuda) for x in _batch(4, 1024 + 37, 40, 48, n_rate=0.03)]
    want = global_align_batch(*args, params, with_tb=with_tb)
    key = "global_sw.tb" if with_tb else "global_sw.score"
    before = cuda_align.LAUNCHES[key]
    got = cuda_align.global_align(*args, params, with_tb=with_tb)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES[key] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("head,tail", list(itertools.product(SKIPS, SKIPS)),
                         ids=lambda s: s.name)
def test_semiglobal_end_kernel_matches_plain(cuda, head, tail):
    args = [x.to(cuda) for x in _batch(5, 1024 + 37, 40, 48, n_rate=0.03)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    want = semiglobal_align_batch(*args, p, head=head, tail=tail)
    before = cuda_align.LAUNCHES["semiglobal_sw.end"]
    got = cuda_align.semiglobal_align(*args, p, head=head, tail=tail)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["semiglobal_sw.end"] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("head,tail", TB_SKIPS, ids=lambda s: s.name)
def test_semiglobal_tb_kernel_matches_plain(cuda, head, tail):
    args = [x.to(cuda) for x in _batch(6, 1000, 64, 96, n_rate=0.02)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL, n_penalty=1)
    want = semiglobal_align_batch(*args, p, head=head, tail=tail,
                                  with_tb=True)
    got = cuda_align.semiglobal_align(*args, p, head=head, tail=tail,
                                      with_tb=True)
    torch.cuda.synchronize()
    _assert_equal(got, want)


def test_walk_kernel_matches_plain(cuda):
    p = AlignmentParams()
    q, t, _, _ = _batch(2, 1000, 64, 96, n_rate=0.02)
    res = cuda_align.local_align(q.to(cuda), t.to(cuda), p, with_tb=True)
    want = tb_walk.tb_walk_plain(res.tb, res.score, res.query_end,
                                 res.target_end, p)
    before = tb_walk.LAUNCHES["tb_walk"]
    got = tb_walk.tb_walk(res.tb, res.score, res.query_end, res.target_end, p)
    torch.cuda.synchronize()
    assert tb_walk.LAUNCHES["tb_walk"] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("algo", ["global", "semiglobal"])
def test_global_walks_match_plain(cuda, algo):
    """Walks from (tlen, qlen) — one cell past the end, the exact-fit pair
    0 included — and, for the semiglobal mode, from the resolved ends."""
    q, t, ql, tl = [x.to(cuda) for x in _batch(3, 1000, 64, 96, n_rate=0.02)]
    if algo == "global":
        p = AlignmentParams(algo=AlgoType.GLOBAL)
        res = cuda_align.global_align(q, t, ql, tl, p, with_tb=True)
        i0, j0 = tl, ql
    else:
        p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
        res = cuda_align.semiglobal_align(
            q, t, ql, tl, p, head=SemiGlobalSkip.TARGET,
            tail=SemiGlobalSkip.TARGET, with_tb=True)
        i0, j0 = res.target_end, ql - 1
    want = tb_walk.tb_walk_plain(res.tb, res.score, j0, i0, p, algo)
    key = f"tb_walk.{algo}"
    before = tb_walk.LAUNCHES[key]
    got = tb_walk.tb_walk(res.tb, res.score, j0, i0, p, algo)
    torch.cuda.synchronize()
    assert tb_walk.LAUNCHES[key] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("params", [
    AlignmentParams(), AlignmentParams(n_penalty=2),
], ids=["defaults", "n_penalty"])
def test_second_best_kernel_matches_plain(cuda, params):
    args = [x.to(cuda) for x in _batch(7, 1024 + 37, 40, 48, n_rate=0.03)]
    want = scan_align_full.local_align_second_batch(*args, params)
    before = cuda_align.LAUNCHES["local_sw.second"]
    got = cuda_align.local_align_second(*args, params)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["local_sw.second"] == before + 1
    _assert_equal(got, want)


def test_local_start_kernel_matches_plain(cuda):
    """Fed the END kernel's forward result, zero forward scores included."""
    p = AlignmentParams()
    q, t, ql, tl = [x.to(cuda) for x in _batch(8, 1024 + 37, 40, 48,
                                                n_rate=0.03)]
    fwd = cuda_align.local_align(q, t, p)
    rq, rt, _, _ = scan_align_full.local_start_inputs(
        q, t, ql, tl, fwd.query_end, fwd.target_end)
    score = fwd.score.clone()
    score[:16] = 0
    want = scan_align_full._local_start_core(rq, rt, score, p)
    before = cuda_align.LAUNCHES["local_start"]
    got = cuda_align.local_start(rq, rt, score, p)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["local_start"] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("head,tail", list(itertools.product(SKIPS, SKIPS)),
                         ids=lambda s: s.name)
def test_semiglobal_start_kernel_matches_plain(cuda, head, tail):
    args = [x.to(cuda) for x in _batch(9, 1024 + 37, 40, 48, n_rate=0.03)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    q, t, ql, tl = args
    fwd = cuda_align.semiglobal_align(*args, p, head=head, tail=tail)
    rev = scan_align_full.semiglobal_start_inputs(q, t, ql, tl,
                                                  fwd.target_end)
    flags = scan_align_full.skip_flags(head, tail)
    per_pair = (ql, tl, *rev[2:], fwd.score, fwd.query_end)
    want = scan_align_full._semiglobal_start_core(*rev[:2], *per_pair, p,
                                                  **flags)
    before = cuda_align.LAUNCHES["semiglobal_start"]
    got = cuda_align.semiglobal_start(*rev[:2], *per_pair, p, **flags)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["semiglobal_start"] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("algo,head,tail", [
    (AlgoType.LOCAL, SemiGlobalSkip.NONE, SemiGlobalSkip.NONE),
    (AlgoType.GLOBAL, SemiGlobalSkip.NONE, SemiGlobalSkip.NONE),
    (AlgoType.SEMI_GLOBAL, SemiGlobalSkip.TARGET, SemiGlobalSkip.TARGET),
    (AlgoType.SEMI_GLOBAL, SemiGlobalSkip.BOTH, SemiGlobalSkip.QUERY),
], ids=["local", "global", "semiglobal_glocal", "semiglobal_both_query"])
def test_engine_on_the_card_matches_cpu(cuda, algo, head, tail):
    rng = np.random.default_rng(3)
    ts = ["".join(rng.choice(list("ACGT"), rng.integers(60, 200)))
          for _ in range(300)]
    qs = [s[10:10 + int(rng.integers(20, 50))] for s in ts]
    for with_tb, score_only in ((True, False), (False, False), (False, True)):
        p = AlignmentParams(algo=algo)
        kw = dict(with_tb=with_tb, score_only=score_only, head=head,
                  tail=tail)
        got = AlignEngine(p, device=cuda, **kw).align(qs, ts)
        want = AlignEngine(p, device="cpu", **kw).align(qs, ts)
        for a, b in zip(got, want):
            assert (a.score, a.query_end, a.target_end, a.query_start,
                    a.target_start, a.cigar_string) == (
                b.score, b.query_end, b.target_end, b.query_start,
                b.target_start, b.cigar_string)


@pytest.mark.parametrize("params,with_tb,score_only,head,tail", [
    (AlignmentParams(compute_start=True), False, False, SemiGlobalSkip.NONE,
     SemiGlobalSkip.NONE),
    (AlignmentParams(compute_start=True), False, True, SemiGlobalSkip.NONE,
     SemiGlobalSkip.NONE),
    (AlignmentParams(algo=AlgoType.SEMI_GLOBAL, compute_start=True), False,
     False, SemiGlobalSkip.TARGET, SemiGlobalSkip.TARGET),
    (AlignmentParams(algo=AlgoType.SEMI_GLOBAL, compute_start=True), False,
     False, SemiGlobalSkip.NONE, SemiGlobalSkip.BOTH),
    (AlignmentParams(second_best=True), False, False, SemiGlobalSkip.NONE,
     SemiGlobalSkip.NONE),
    (AlignmentParams(second_best=True), True, False, SemiGlobalSkip.NONE,
     SemiGlobalSkip.NONE),
    (AlignmentParams(second_best=True, compute_start=True), False, True,
     SemiGlobalSkip.NONE, SemiGlobalSkip.NONE),
], ids=["start", "start_score_only", "semiglobal_start_glocal",
        "semiglobal_start_none_both", "second_best", "second_best_tb",
        "second_best_start_score_only"])
def test_engine_options_on_the_card_match_cpu(cuda, params, with_tb,
                                              score_only, head, tail):
    rng = np.random.default_rng(4)
    ts = ["".join(rng.choice(list("ACGTN"), rng.integers(60, 200),
                             p=[0.245] * 4 + [0.02])) for _ in range(300)]
    qs = [s[10:10 + int(rng.integers(20, 50))] for s in ts]
    kw = dict(with_tb=with_tb, score_only=score_only, head=head, tail=tail)
    got = AlignEngine(params, device=cuda, **kw).align(qs, ts)
    want = AlignEngine(params, device="cpu", **kw).align(qs, ts)
    for a, b in zip(got, want):
        assert (a.score, a.query_end, a.target_end, a.query_start,
                a.target_start, a.score_second, a.query_end_second,
                a.target_end_second, a.cigar_string) == (
            b.score, b.query_end, b.target_end, b.query_start,
            b.target_start, b.score_second, b.query_end_second,
            b.target_end_second, b.cigar_string)


@pytest.mark.parametrize("params", [
    AlignmentParams(algo=AlgoType.KSW),
    AlignmentParams(algo=AlgoType.KSW, n_penalty=2, match=2),
], ids=["defaults", "n_penalty"])
def test_ksw_kernel_matches_plain(cuda, params):
    """END with Ns; SCORE with has_n True on the same batch and False on
    an N-free one; seed scores 0-59 and a few above qlen * match."""
    q, t, ql, tl = [x.to(cuda) for x in _batch(10, 1024 + 37, 40, 48,
                                                n_rate=0.03)]
    rng = np.random.default_rng(10)
    h0 = torch.from_numpy(rng.integers(0, 60, q.shape[0]).astype(np.int32))
    h0[:16] = 0
    h0[16:32] = 200
    h0 = h0.to(cuda)
    want = ksw_align_batch(q, t, ql, tl, h0, params)
    before = dict(cuda_align.LAUNCHES)
    got = cuda_align.ksw_align(q, t, ql, tl, h0, params)
    got_s = cuda_align.ksw_align_scores(q, t, ql, tl, h0, params, has_n=True)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["ksw.end"] == before["ksw.end"] + 1
    assert cuda_align.LAUNCHES["ksw.score"] == before["ksw.score"] + 1
    _assert_equal(got, want)
    _assert_equal([got_s], [want.score])
    q, t, ql, tl = [x.to(cuda) for x in _batch(11, 1024 + 37, 40, 48,
                                                n_rate=0.0)]
    _assert_equal([cuda_align.ksw_align_scores(q, t, ql, tl, h0, params,
                                               has_n=False)],
                  [ksw_align_batch(q, t, ql, tl, h0, params).score])


@pytest.mark.parametrize("band", [1, 2, 4, 9])
@pytest.mark.parametrize("params", [
    AlignmentParams(algo=AlgoType.BANDED),
    AlignmentParams(algo=AlgoType.BANDED, n_penalty=2, match=2),
], ids=["defaults", "n_penalty"])
def test_banded_kernel_matches_plain(cuda, params, band):
    q, t, ql, tl = [x.to(cuda) for x in _batch(12, 1024 + 37, 40, 48,
                                                n_rate=0.03)]
    want = banded_align_batch(q, t, ql, tl, params, band)
    before = dict(cuda_align.LAUNCHES)
    got = cuda_align.banded_align(q, t, ql, tl, params, band)
    got_s = cuda_align.banded_align_scores(q, t, ql, tl, params, band,
                                           has_n=True)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["banded_sw.end"] == before["banded_sw.end"] + 1
    assert (cuda_align.LAUNCHES["banded_sw.score"]
            == before["banded_sw.score"] + 1)
    _assert_equal(got, want)
    _assert_equal([got_s], [want.score])
    q, t, ql, tl = [x.to(cuda) for x in _batch(13, 1024 + 37, 40, 48,
                                                n_rate=0.0)]
    _assert_equal([cuda_align.banded_align_scores(q, t, ql, tl, params, band,
                                                  has_n=False)],
                  [banded_align_batch(q, t, ql, tl, params, band).score])


@pytest.mark.parametrize("algo", [AlgoType.KSW, AlgoType.BANDED],
                         ids=["ksw", "banded"])
def test_ksw_and_banded_engine_on_the_card_match_cpu(cuda, algo):
    rng = np.random.default_rng(5)
    ts = ["".join(rng.choice(list("ACGTN"), rng.integers(60, 200),
                             p=[0.245] * 4 + [0.02])) for _ in range(300)]
    qs = [s[:int(rng.integers(20, 50))] for s in ts]
    h0 = rng.integers(0, 60, len(qs))
    for score_only in (False, True):
        kw = dict(score_only=score_only, band_width_tiles=2)
        got = AlignEngine(AlignmentParams(algo=algo), device=cuda,
                          **kw).align(qs, ts, h0=h0)
        want = AlignEngine(AlignmentParams(algo=algo), device="cpu",
                           **kw).align(qs, ts, h0=h0)
        for a, b in zip(got, want):
            assert (a.score, a.query_end, a.target_end) == (
                b.score, b.query_end, b.target_end)
