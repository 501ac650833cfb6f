"""The port's CUDA kernels against their plain PyTorch versions on the
card: integer-equal scores, ends, traceback words, op streams, starts and
edit distances; bit-equal PairHMM likelihoods (held to the gold too).
Every test here needs a CUDA device and nvcc and skips without them.

This file imports neither JAX nor the JAX package, so it runs on a
machine without JAX:

    GENOMICS_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(the variable keeps tests/conftest.py from importing JAX).
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from chip_smoke import (
    CLUSTER_SPEC,
    FILTER_CARD_EDGES,
    FM_EDGE_SPECS,
    NW_EDGE_N,
    PAIRHMM_EDGE_B,
    PAIRHMM_SHAPES,
    backtrack_edges,
    band_windows,
    as_reads,
    cluster_lcs_parity,
    cube_err,
    family_reads,
    fill_edges,
    filter_edge_inputs,
    fm_edge_text,
    fm_queries,
    host_min_sum,
    msa_edges,
    mutate,
    mutate_windows,
    ncbi_matrix,
    ngia_lcs_parity,
    nw_stripe_edges,
    pairhmm_edges,
    random_seq,
    sw_edges,
    sw_stripe_edges,
    walk_edges,
)

from genomics_tpu_torch import AlgoType, AlignEngine, AlignmentParams
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.core.scoring import SemiGlobalSkip
from genomics_tpu_torch.core.submat import load_scoring_matrix
from genomics_tpu_torch.index.fmindex import FMIndex
from genomics_tpu_torch.models import cluster, msa, ngia, nw, pairhmm, sw
from genomics_tpu_torch.models.mapper import ReadMapper
from genomics_tpu_torch.ops import (
    cluster_filter,
    cuda_align,
    cuda_pairhmm,
    fm_search,
    lcs,
    myers,
    scan_align_full,
    scan_pairhmm,
    tb_walk,
)
from genomics_tpu_torch.ops.scan_align import (
    banded_align_batch,
    global_align_batch,
    ksw_align_batch,
    local_align_batch,
    local_align_batch16,
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
def test_local_kernel_matches_plain(cuda, monkeypatch, with_tb, params):
    monkeypatch.delenv("GENOMICS_TPU_INT16_CELLS", raising=False)
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


def _same_pairs(B, Lq, Lt):
    """B copies of one random pair whose query is the target's first Lq
    bases: the best score is match x Lq."""
    rng = np.random.default_rng(13)
    t = np.repeat(ACGT[rng.integers(0, 4, (1, Lt))], B, axis=0)
    return torch.from_numpy(t[:, :Lq].copy()), torch.from_numpy(t)


@pytest.mark.parametrize("B,Lq,Lt,n_rate,params", [
    (4096 + 37, 152, 152, 0.0, AlignmentParams()),
    (1000, 216, 328, 0.01, AlignmentParams()),
    (1000, 216, 328, 0.01, AlignmentParams(n_penalty=2)),
    (257, 152, 152, 0.0, AlignmentParams(match=200)),
    (33, 258, 264, None, AlignmentParams(match=127)),
    (33, 33, 40, None, AlignmentParams(match=991)),
], ids=["odd_b", "with_ns", "n_penalty", "range_edge",
        "one_below_the_ends_limit", "one_below_the_score_limit"])
def test_int16_modes_match_plain_and_int32(cuda, monkeypatch, B, Lq, Lt,
                                           n_rate, params):
    """SCORE16 and END16 (the ends' mode under GENOMICS_TPU_INT16_CELLS=1
    and, on N-free batches, the scores' default) against their plain
    version and the int32 kernels; an odd B leaves the last thread one
    pair; match=200 at Lq 152 scores up to 30,400; 127 x 258 = 32,766 and
    991 x 33 = 32,703 are one below the ends' and the scores' limits, and
    identical pairs (n_rate None) score exactly that."""
    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    if n_rate is None:
        q, t = (x.to(cuda) for x in _same_pairs(B, Lq, Lt))
    else:
        q, t, _, _ = (x.to(cuda) for x in _batch(9, B, Lq, Lt, n_rate))
    top = params.match * Lq
    before = dict(cuda_align.LAUNCHES)
    got = cuda_align.local_align(q, t, params)
    want = cuda_align._launch("end", q.T, t.T, params, True)[:3]
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["local_sw.end16"] == before["local_sw.end16"] + 1
    _assert_equal(got[:3], local_align_batch16(q, t, params))
    _assert_equal(got[:3], want)
    if n_rate is None:
        assert int(got.score.max()) == top
    if not n_rate and top < cuda_align.SCORE16_LIMIT:
        got = cuda_align.local_align_scores(q, t, params, has_n=False)
        qs, ts = (cuda_align._pads_to_sentinels(x, c) for x, c in
                  ((q, 16), (t, 17)))
        plain = local_align_batch16(qs, ts, params, ends=False).score
        torch.cuda.synchronize()
        assert (cuda_align.LAUNCHES["local_sw.score16"]
                == before["local_sw.score16"] + 1)
        _assert_equal([got, got], [plain, want[0]])


@pytest.mark.parametrize("match,modes", [
    (195, ("end16", "score")), (196, ("end", "score"))])
def test_past_the_int16_range_takes_the_int32_modes(cuda, monkeypatch, match,
                                                    modes):
    """At Lq 168, match 195 passes the score limit (32,767 - 64) only and
    match 196 both (the ends under GENOMICS_TPU_INT16_CELLS=1, so that the
    range alone decides); the int32 kernels run and agree with the plain
    version."""
    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    p = AlignmentParams(match=match)
    q, t, _, _ = (x.to(cuda) for x in _batch(10, 300, 168, 96, 0.0))
    before = dict(cuda_align.LAUNCHES)
    got_end = cuda_align.local_align(q, t, p)
    got_score = cuda_align.local_align_scores(q, t, p, has_n=False)
    torch.cuda.synchronize()
    for mode in modes:
        assert cuda_align.LAUNCHES[f"local_sw.{mode}"] == \
            before[f"local_sw.{mode}"] + 1
    want = local_align_batch(q, t, p)
    _assert_equal(got_end[:3], want[:3])
    _assert_equal([got_score], [want.score])


@pytest.mark.parametrize("cells16", [False, True], ids=["default", "opted_in"])
def test_ends_take_end16_only_under_the_switch(cuda, monkeypatch, cells16):
    """A launch that fills the card takes END without
    GENOMICS_TPU_INT16_CELLS=1 and END16 with it; either equals the plain
    version."""
    monkeypatch.delenv("GENOMICS_TPU_INT16_CELLS", raising=False)
    if cells16:
        monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    mode = "end16" if cells16 else "end"
    q, t, _, _ = (x.to(cuda) for x in _batch(12, 65536, 24, 32, 0.02))
    before = cuda_align.LAUNCHES[f"local_sw.{mode}"]
    got = cuda_align.local_align(q, t, AlignmentParams())
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES[f"local_sw.{mode}"] == before + 1
    _assert_equal(got[:3], local_align_batch(q, t, AlignmentParams())[:3])


@pytest.mark.parametrize("mode,with_n", [(4, 1), (5, 0), (3, 1), (6, 0)],
                         ids=["score16_with_n", "end16_without_n", "second",
                              "unknown"])
def test_local_sw_launch_refuses_what_it_lacks(cuda, mode, with_n):
    """local_sw_launch runs SCORE16 (mode 4) without the N compare and
    END16 (mode 5) with it, through the argument types of the other modes;
    any other pairing, SECOND (its own entry point) and an unknown mode
    return cudaErrorInvalidValue, which the wrapper raises."""
    from genomics_tpu_torch import _build

    q, t, _, _ = (x.to(cuda) for x in _batch(14, 64, 24, 32, 0.0))
    Q, T = q.T.contiguous(), t.T.contiguous()
    # SCORE16 reads N-free input: the pads remapped to the 16/17 sentinels
    Qs, Ts = (cuda_align._pads_to_sentinels(x, c) for x, c in ((Q, 16),
                                                              (T, 17)))
    out = cuda_align._outputs("local_sw", "end16", Q, T, True)
    sig = cuda_align._SIGNATURES["local_sw", "local_sw_launch"]
    p = AlignmentParams()

    def run(m, n, Qx, Tx):
        group = 8 if m in (4, 5) else 1   # one the mode would take
        score, qend, tend, _, gH, gE = out
        _build.launch("local_sw", "local_sw_launch", sig, cuda, m, n, group,
                      Qx, Tx, 64, 24, 32, p.match, p.mismatch, 0, p.gap_oe,
                      p.gap_extend, gH, gE, score, qend, tend, None)
        torch.cuda.synchronize()
        return score

    want = local_align_batch(q, t, p)
    _assert_equal([run(4, 0, Qs, Ts).clone(), run(5, 1, Q, T)],
                  [want.score, want.score])
    _assert_equal(out[1:3], want[1:3])
    with pytest.raises(RuntimeError, match="local_sw_launch failed"):
        run(mode, with_n, Q, T)


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


def _walk_equal(got, want):
    """walk_cigars' outputs: the bytes that carry meaning, n_ops and the
    starts, equal."""
    assert got[0].shape == want[0].shape and got[0].dtype == torch.uint8
    assert torch.equal(tb_walk.valid_bytes(*got[:2]).cpu(),
                       tb_walk.valid_bytes(*want[:2]).cpu())
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w.cpu())


def test_walk_kernel_matches_plain(cuda):
    p = AlignmentParams()
    q, t, _, _ = _batch(2, 1000, 64, 96, n_rate=0.02)
    res = cuda_align.local_align(q.to(cuda), t.to(cuda), p, with_tb=True)
    args = (res.tb, res.score, res.query_end, res.target_end, p)
    want = tb_walk.walk_cigars_plain(*args)
    before = tb_walk.LAUNCHES["tb_walk"]
    got = tb_walk.walk_cigars(*args)
    torch.cuda.synchronize()
    assert tb_walk.LAUNCHES["tb_walk"] == before + 1
    _walk_equal(got, want)


@pytest.mark.parametrize("algo", ["global", "semiglobal"])
def test_global_walks_match_plain(cuda, algo):
    """Walks from (tlen, qlen) — one cell past the end, the exact-fit pair
    0 included — and, for the semiglobal mode, from the resolved ends,
    pads and starts included."""
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
    args = (res.tb, res.score, j0, i0, p, algo, False, algo == "semiglobal")
    want = tb_walk.walk_cigars_plain(*args)
    key = f"tb_walk.{algo}"
    before = tb_walk.LAUNCHES[key]
    got = tb_walk.walk_cigars(*args)
    torch.cuda.synchronize()
    assert tb_walk.LAUNCHES[key] == before + 1
    _walk_equal(got, want)


WALK_MODES = [("local", False, False), ("global", False, False)] + [
    ("semiglobal", hq, ht) for hq in (False, True) for ht in (False, True)]


@pytest.mark.parametrize("algo,head_q,head_t", WALK_MODES,
                         ids=[f"{a}-q{int(q)}-t{int(t)}"
                              for a, q, t in WALK_MODES])
@pytest.mark.parametrize("B", [37, 4133], ids=["under_a_wave", "a_wave"])
def test_walk_kernel_at_the_edges(cuda, algo, head_q, head_t, B):
    """chip_smoke.walk_edges: M runs of 63, 64 and 126, pads of 63 and 64,
    starts outside the cube, walks with no step, a LOCAL stop on the first
    step, D runs across word rows and I runs past a window."""
    p = AlignmentParams(algo={"local": AlgoType.LOCAL,
                              "global": AlgoType.GLOBAL,
                              "semiglobal": AlgoType.SEMI_GLOBAL}[algo])
    args = (*walk_edges(np.random.default_rng(B), B, cuda), p, algo, head_q,
            head_t)
    want = tb_walk.walk_cigars_plain(*args)
    got = tb_walk.walk_cigars(*args)
    torch.cuda.synchronize()
    _walk_equal(got, want)
    if algo == "global":
        runs = [int(x) >> 2 for x in got[0][2, :got[1][2]].cpu()]
        assert runs[:3] == [63, 1, 1]


def test_walk_kernel_over_many_waves(cuda):
    """1,048,576 walks on 16 x 16 cubes, more threads than stay resident;
    4,096 of them, from every part of the launch, held to the plain
    version."""
    p = AlignmentParams(algo=AlgoType.GLOBAL)
    B = 1 << 20
    tb, score, qend, tend = walk_edges(np.random.default_rng(8), B, cuda,
                                       L=16)
    got = tb_walk.walk_cigars(tb, score, qend, tend, p, "global")
    torch.cuda.synchronize()
    pick = torch.from_numpy(np.sort(np.random.default_rng(9).choice(
        B, 4096, replace=False))).to(cuda)
    want = tb_walk.walk_cigars_plain(tb[:, :, pick].contiguous(),
                                     score[pick], qend[pick], tend[pick], p,
                                     "global")
    _walk_equal([got[0][pick], *(x[pick] for x in got[1:])], want)


@pytest.mark.parametrize("algo,head", [
    (AlgoType.LOCAL, SemiGlobalSkip.NONE),
    (AlgoType.GLOBAL, SemiGlobalSkip.NONE),
    (AlgoType.SEMI_GLOBAL, SemiGlobalSkip.TARGET),
    (AlgoType.SEMI_GLOBAL, SemiGlobalSkip.NONE)],
    ids=["local", "global", "glocal", "semiglobal_none"])
def test_engine_traceback_on_the_card_needs_no_host_encode(cuda, monkeypatch,
                                                           algo, head):
    """AlignEngine with traceback on the card takes the walk's bytes as
    they come: rle_cigar and cigars_from_walk (the plain version's host
    loops) are never called, and every field equals the CPU engine's."""
    rng = np.random.default_rng(31)
    qs = ["".join(rng.choice(list("ACGT"), int(rng.integers(40, 150))))
          for _ in range(300)]
    ts = [q[5:] + "".join(rng.choice(list("ACGT"), 60)) for q in qs]
    kw = dict(with_tb=True, head=head, tail=head)
    want = AlignEngine(AlignmentParams(algo=algo), device="cpu",
                       **kw).align(qs, ts)

    def host_loop(*_a, **_k):
        raise AssertionError("the card path ran a host encode")
    monkeypatch.setattr(tb_walk, "rle_cigar", host_loop)
    monkeypatch.setattr(tb_walk, "cigars_from_walk", host_loop)
    got = AlignEngine(AlignmentParams(algo=algo), device=cuda,
                      **kw).align(qs, ts)
    for g, w in zip(got, want, strict=True):
        assert (g.score, g.query_end, g.target_end, g.query_start,
                g.target_start) == (w.score, w.query_end, w.target_end,
                                    w.query_start, w.target_start)
        np.testing.assert_array_equal(g.cigar, w.cigar)


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


def _local_start_inputs(q, t, ql, tl, p):
    """The reverse pass's inputs and extents from the END kernel's
    forward result, and its forward scores."""
    fwd = cuda_align.local_align(q, t, p)
    rq, rt, qr8, tr8 = scan_align_full.local_start_inputs(
        q, t, ql, tl, fwd.query_end, fwd.target_end)
    return rq, rt, fwd.score, qr8, tr8


def _every_group_matches(rq, rt, score, qr8, tr8, p):
    """The kernel with the extents at both threads-per-pair the launcher
    takes (4 and 8, what split_group picks), and the wrapper with
    and without them, each integer-equal to the plain version and
    counted once."""
    want = scan_align_full._local_start_core(rq, rt, score, p)
    for group in (4, 8):
        args = cuda_align.local_start_launch_args(rq.T, rt.T, score, p, qr8,
                                                  tr8, group=group)
        before = cuda_align.LAUNCHES["local_start"]
        got = cuda_align.launch_local_start(args)
        torch.cuda.synchronize()
        assert cuda_align.LAUNCHES["local_start"] == before + 1
        _assert_equal(got, want)
    _assert_equal(cuda_align.local_start(rq, rt, score, p), want)
    _assert_equal(cuda_align.local_start(rq, rt, score, p, qr8, tr8), want)


def test_local_start_launch_refuses_other_groups(cuda):
    """The launcher takes 4 or 8 threads a pair and nothing else."""
    p = AlignmentParams()
    q, t, ql, tl = [x.to(cuda) for x in _batch(43, 64, 16, 16, 0.0)]
    rq, rt, score, qr8, tr8 = _local_start_inputs(q, t, ql, tl, p)
    for group in (1, 2, 3, 16):
        args = cuda_align.local_start_launch_args(rq.T, rt.T, score, p, qr8,
                                                  tr8, group=group)
        with pytest.raises(RuntimeError, match="local_start_launch failed"):
            cuda_align.launch_local_start(args)


@pytest.mark.parametrize("B", [1, 129])
@pytest.mark.parametrize("Lq", [1, 9])
@pytest.mark.parametrize("scores", ["forward", "zero_unreachable"])
def test_local_start_at_the_edges_matches_plain(cuda, B, Lq, scores):
    """Lq 1 (no column loaded ahead) and 9 (qr8 16 past Lq), two strips,
    one pair and a block of 128 plus one; forward scores as the END
    kernel gives them, or a third each 0 (the first segment stops),
    unreachable (the walk runs to the extents) and as given."""
    p = AlignmentParams(n_penalty=2)
    q, t, ql, tl = [x.to(cuda) for x in _batch(40 + B + Lq, B, Lq, 16, 0.05)]
    rq, rt, score, qr8, tr8 = _local_start_inputs(q, t, ql, tl, p)
    if scores != "forward":
        score = score.clone()
        score[0::3] = 0
        score[1::3] = 1 << 20
    _every_group_matches(rq, rt, score, qr8, tr8, p)


@pytest.mark.parametrize("n_penalty", [None, 1], ids=["no_npen", "npen"])
def test_local_start_at_ties_matches_plain(cuda, n_penalty):
    """match = mismatch = gap_extend = 1 (gap_open 0) over two letters:
    the running max ties everywhere, so the first attainment in
    strip-major order and the stop after the segment decide the cell."""
    p = AlignmentParams(match=1, mismatch=1, gap_open=0, gap_extend=1,
                        n_penalty=n_penalty)
    q, t, ql, tl = [x.to(cuda) for x in _two_letters(41, 1024 + 37, 64, 0.03)]
    _every_group_matches(*_local_start_inputs(q, t, ql, tl, p), p)


@pytest.mark.parametrize("B,Lq,Lt", [(65536, 152, 152), (10000, 216, 328)],
                         ids=["bench", "engine"])
def test_local_start_at_launch_sizes_matches_plain(cuda, B, Lq, Lt):
    """bench.py's launch and an engine start launch (one bucket of the
    20,000 GASAL2-shaped pairs: under one wave of 128-thread blocks)."""
    p = AlignmentParams()
    q, t, ql, tl = [x.to(cuda) for x in _batch(42, B, Lq, Lt, 0.01)]
    _every_group_matches(*_local_start_inputs(q, t, ql, tl, p), p)


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


@pytest.mark.parametrize("h0", [0, 30, 200])
@pytest.mark.parametrize("Lq,Lt,force_global,layout", [
    (152, 152, False, "shared"), (250, 264, False, "shared"),
    (152, 152, True, "global"), (1000, 1000, False, "global"),
], ids=["shared152", "shared250", "global152_forced", "global1000"])
def test_ksw_layouts_match_plain(cuda, Lq, Lt, force_global, layout, h0):
    """Both row-state layouts of ksw_extend, END and SCORE, integer-equal
    to the plain version on a ragged B (the last block part-full) whose
    even pairs are related and odd ones random, so that the windows of a
    warp's threads part; Ns with n_penalty set and unset, and SCORE
    without the N compare on an N-free batch.  Each launch is counted."""
    B = 2048 + 37
    assert force_global or cuda_align.ksw_layout(Lq)[0] == layout
    q, t, ql, tl = [x.to(cuda) for x in _batch(20, B, Lq, Lt, n_rate=0.02)]
    hv = torch.full((B,), h0, dtype=torch.int32, device=cuda)
    for params in (AlignmentParams(algo=AlgoType.KSW),
                   AlignmentParams(algo=AlgoType.KSW, n_penalty=2)):
        want = ksw_align_batch(q, t, ql, tl, hv, params)
        before = dict(cuda_align.LAUNCHES)
        got = cuda_align._ksw_launch("end", q, t, ql, tl, hv, params, True,
                                     force_global=force_global)
        got_s = cuda_align._ksw_launch("score", q, t, ql, tl, hv, params,
                                       True, force_global=force_global)[0]
        torch.cuda.synchronize()
        assert cuda_align.LAUNCHES["ksw.end"] == before["ksw.end"] + 1
        assert cuda_align.LAUNCHES["ksw.score"] == before["ksw.score"] + 1
        _assert_equal(got, want)
        _assert_equal([got_s], [want.score])
    q, t, ql, tl = [x.to(cuda) for x in _batch(21, B, Lq, Lt, n_rate=0.0)]
    want = ksw_align_batch(q, t, ql, tl, hv, params).score
    q, t, with_n = cuda_align._no_n_inputs(q, t, False)
    _assert_equal([cuda_align._ksw_launch("score", q, t, ql, tl, hv, params,
                                          with_n,
                                          force_global=force_global)[0]],
                  [want])


def test_ksw_launch_refuses_what_it_lacks(cuda):
    """The launcher takes the shared layout only at a multiple of 32
    threads whose rows fit, and the global one only with its scratch."""
    q, t, ql, tl = [x.to(cuda) for x in _batch(22, 64, 40, 48, n_rate=0.0)]
    p = AlignmentParams(algo=AlgoType.KSW)
    args = cuda_align.ksw_launch_args("end", q, t, ql, tl, ql, p, True)
    for bad in ((1, 48), (1, 512), (0, 128)):   # shared / threads
        with pytest.raises(RuntimeError, match="ksw_extend_launch failed"):
            cuda_align.launch_ksw((*args[:2], *bad, *args[4:]))


def _two_letters(seed, B, L, n_rate):
    """_batch over a 2-letter alphabet (G as A, T as C, so related pairs
    stay related): at unit scores most cells tie."""
    q, t, ql, tl = _batch(seed, B, L, L, n_rate)
    for x in (q, t):
        x[x == int(ACGT[2])] = int(ACGT[0])
        x[x == int(ACGT[3])] = int(ACGT[1])
    return q, t, ql, tl


@pytest.mark.parametrize("n_penalty", [None, 1], ids=["no_npen", "npen"])
def test_global_tb_cube_at_ties_matches_plain(cuda, n_penalty):
    """Every word of the TB cube equal to the plain version's where match
    = mismatch = gap_extend = 1 (gap_open 0) over two letters, so that
    the maxima and the extension compares tie everywhere; the score mode
    too."""
    p = AlignmentParams(algo=AlgoType.GLOBAL, match=1, mismatch=1,
                        gap_open=0, gap_extend=1, n_penalty=n_penalty)
    args = [x.to(cuda) for x in _two_letters(23, 1024 + 37, 64, 0.03)]
    want = global_align_batch(*args, p, with_tb=True)
    got = cuda_align.global_align(*args, p, with_tb=True)
    got_s = cuda_align.global_align(*args, p)
    torch.cuda.synchronize()
    assert torch.equal(got.tb, want.tb)
    _assert_equal(got, want)
    _assert_equal(got_s[:3], want[:3])


@pytest.mark.parametrize("gap_open", [0, 6])
def test_global_engine_cigars_at_ties_match_cpu(cuda, gap_open):
    """GLOBAL with traceback through AlignEngine on the card: every CIGAR
    byte-equal to the CPU engine's, at unit scores over two letters."""
    rng = np.random.default_rng(24)
    ts = ["".join(rng.choice(list("AC"), rng.integers(60, 200)))
          for _ in range(300)]
    qs = [s[10:10 + int(rng.integers(20, 50))] for s in ts]
    p = AlignmentParams(algo=AlgoType.GLOBAL, match=1, mismatch=1,
                        gap_open=gap_open, gap_extend=1)
    got = AlignEngine(p, with_tb=True, device=cuda).align(qs, ts)
    want = AlignEngine(p, with_tb=True, device="cpu").align(qs, ts)
    assert [(a.score, a.cigar_string) for a in got] == [
        (b.score, b.cigar_string) for b in want]


@pytest.mark.parametrize("n_penalty", [None, 1], ids=["no_npen", "npen"])
def test_local_tb_cube_at_ties_matches_plain(cuda, n_penalty):
    """Every word of the LOCAL TB cube equal to the plain version's where
    match = mismatch = gap_extend = 1 (gap_open 0) over two letters, so
    that the maxima, the extension compares and the best tracking tie
    everywhere; END and SECOND too."""
    p = AlignmentParams(match=1, mismatch=1, gap_open=0, gap_extend=1,
                        n_penalty=n_penalty)
    q, t, ql, tl = [x.to(cuda) for x in _two_letters(25, 1024 + 37, 64, 0.03)]
    want = local_align_batch(q, t, p, with_tb=True)
    got = cuda_align.local_align(q, t, p, with_tb=True)
    got_e = cuda_align._launch("end", q.T, t.T, p, True)
    got_2 = cuda_align.local_align_second(q, t, ql, tl, p)
    torch.cuda.synchronize()
    assert torch.equal(got.tb, want.tb)
    _assert_equal(got, want)
    _assert_equal(got_e[:3], want[:3])
    _assert_equal(got_2, scan_align_full.local_align_second_batch(q, t, ql,
                                                                  tl, p))


@pytest.mark.parametrize("B", [1, 129])
@pytest.mark.parametrize("Lq", [1, 9])
def test_local_modes_at_the_edges_match_plain(cuda, B, Lq):
    """SCORE (with and without the N compare), END, TB and SECOND on one
    strip (Lt = 8) at Lq 1 (no column loaded ahead) and 9, on one pair
    and on a block of 128 plus one with a single live thread."""
    p = AlignmentParams(n_penalty=2)
    q, t, ql, tl = [x.to(cuda) for x in _batch(26 + B + Lq, B, Lq, 8, 0.05)]
    want = local_align_batch(q, t, p, with_tb=True)
    counts = dict(cuda_align.LAUNCHES)
    Qs, Ts = (cuda_align._pads_to_sentinels(x.T, c) for x, c in ((q, 16),
                                                                 (t, 17)))
    free = local_align_batch(Qs.T, Ts.T, p).score
    got = {m: cuda_align._launch(m, q.T, t.T, p, True)
           for m in ("score", "end", "tb")}
    got_free = cuda_align._launch("score", Qs, Ts, p, False)[0]
    got_2 = cuda_align.local_align_second(q, t, ql, tl, p)
    torch.cuda.synchronize()
    for key, n in (("local_sw.score", 2), ("local_sw.end", 1),
                   ("local_sw.tb", 1), ("local_sw.second", 1)):
        assert cuda_align.LAUNCHES[key] == counts[key] + n
    _assert_equal(got["score"][:1], want[:1])
    _assert_equal(got["end"][:3], want[:3])
    _assert_equal(got["tb"], want)
    _assert_equal([got_free], [free])
    _assert_equal(got_2, scan_align_full.local_align_second_batch(q, t, ql,
                                                                  tl, p))


@pytest.mark.parametrize("head,tail", list(itertools.product(SKIPS, SKIPS)),
                         ids=lambda s: s.name)
def test_semiglobal_start_at_the_edges_matches_plain(cuda, head, tail):
    """Lq = 1 (no column loaded ahead), suffixes of 0 and 8 rows, and
    forward scores that no strip reaches (the loop runs to row_count)
    beside reachable ones, B = 129."""
    rng = np.random.default_rng(27)
    B, Lt = 129, 16
    rev_q = torch.from_numpy(ACGT[rng.integers(0, 4, (B, 1))])
    rev_t = torch.from_numpy(ACGT[rng.integers(0, 4, (B, Lt))])
    row_off = torch.from_numpy(8 * rng.integers(0, 2, B).astype(np.int32))
    row_count = torch.from_numpy(8 * rng.integers(0, 2, B).astype(np.int32))
    tlen = torch.from_numpy(rng.integers(1, Lt + 9, B).astype(np.int32))
    fwd = rng.integers(-12, 4, B).astype(np.int32)
    fwd[rng.random(B) < 0.5] = 1 << 20
    per_pair = [x.to(cuda) for x in (
        torch.ones(B, dtype=torch.int32), tlen, row_off, row_count,
        torch.from_numpy(fwd), torch.zeros(B, dtype=torch.int32))]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    flags = scan_align_full.skip_flags(head, tail)
    args = (rev_q.to(cuda), rev_t.to(cuda), *per_pair, p)
    want = scan_align_full._semiglobal_start_core(*args, **flags)
    before = cuda_align.LAUNCHES["semiglobal_start"]
    got = cuda_align.semiglobal_start(*args, **flags)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES["semiglobal_start"] == before + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("kernel", ["local_sw.tb", "semiglobal_start",
                                    "local_start", "banded_sw.end",
                                    "banded_sw.score"])
def test_align_launch_alone_matches_the_wrapper(cuda, kernel):
    """The launch on laid-out inputs (what chip_smoke.py times) gives the
    wrapper's result and counts one launch."""
    q, t, ql, tl = [x.to(cuda) for x in _batch(28, 1024 + 37, 40, 48, 0.03)]
    if kernel == "local_start":
        p = AlignmentParams()
        rq, rt, score, qr8, tr8 = _local_start_inputs(q, t, ql, tl, p)
        want = cuda_align.local_start(rq, rt, score, p, qr8, tr8)
        args = cuda_align.local_start_launch_args(rq.T, rt.T, score, p, qr8,
                                                  tr8)
        before = cuda_align.LAUNCHES[kernel]
        got = cuda_align.launch_local_start(args)
    elif kernel.startswith("banded_sw"):
        p = AlignmentParams(algo=AlgoType.BANDED)
        mode = kernel.split(".")[1]
        want = cuda_align._banded_launch(mode, q, t, ql, tl, p, 4, True)
        args = cuda_align.banded_launch_args(mode, q, t, ql, tl, p, 4, True)
        before = cuda_align.LAUNCHES[kernel]
        got = cuda_align.launch_banded(args)
    elif kernel == "local_sw.tb":
        p = AlignmentParams()
        want = cuda_align.local_align(q, t, p, with_tb=True)
        args = cuda_align.local_launch_args("tb", q.T, t.T, p, True)
        before = cuda_align.LAUNCHES[kernel]
        got = cuda_align.launch_local(args)
    else:
        p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
        sg = dict(head=SemiGlobalSkip.NONE, tail=SemiGlobalSkip.BOTH)
        fwd = cuda_align.semiglobal_align(q, t, ql, tl, p, **sg)
        rev = scan_align_full.semiglobal_start_inputs(q, t, ql, tl,
                                                      fwd.target_end)
        per_pair = (ql, tl, *rev[2:], fwd.score, fwd.query_end)
        flags = scan_align_full.skip_flags(**sg)
        want = cuda_align.semiglobal_start(*rev[:2], *per_pair, p, **flags)
        args = cuda_align.semiglobal_start_launch_args(
            rev[0].T, rev[1].T, *per_pair, p, **flags)
        before = cuda_align.LAUNCHES[kernel]
        got = cuda_align.launch_semiglobal_start(args)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES[kernel] == before + 1
    _assert_equal(got, want)


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


def _banded_geometry(seed, B, Lq, Lt, qrange, trange, n_rate):
    """_batch with its lengths drawn from qrange / trange (inclusive),
    not multiples of 8, pair 0 at the largest."""
    q, t, _, _ = _batch(seed, B, Lq, Lt, n_rate)
    rng = np.random.default_rng(seed + 1)
    ql = rng.integers(qrange[0], qrange[1] + 1, B).astype(np.int32)
    tl = rng.integers(trange[0], trange[1] + 1, B).astype(np.int32)
    ql[0], tl[0] = qrange[1], trange[1]
    q[torch.arange(Lq)[None, :] >= torch.from_numpy(ql)[:, None]] = N4
    t[torch.arange(Lt)[None, :] >= torch.from_numpy(tl)[:, None]] = N4
    return q, t, torch.from_numpy(ql), torch.from_numpy(tl)


BANDED_GEOMETRIES = {   # B, Lq, Lt, qlen range, tlen range, bands
    # k_other = tr - (qr - band) <= 0: the band starts past the diagonal;
    # at band 1 every strip's band is empty (score 0)
    "k_other_le_0": (1024 + 37, 96, 16, (70, 96), (1, 16), (1, 2, 4)),
    "tr_gg_qr": (1024 + 37, 16, 160, (1, 16), (90, 160), (1, 4)),
    "ragged": (2048 + 37, 40, 48, (1, 40), (1, 48), (1, 2, 4, 9)),
    # past the shared limit: a ring of 912 / 952 columns, the global
    # layout by the rule
    "past_shared": (128 + 37, 912, 1776, (800, 912), (1500, 1776), (4, 9)),
}


@pytest.mark.parametrize("geometry", list(BANDED_GEOMETRIES))
@pytest.mark.parametrize("layout", ["rule", "ring", "global"])
def test_banded_geometries_match_plain(cuda, geometry, layout):
    """END and SCORE (with the N compare, and without it on an N-free
    batch) integer-equal to the plain version on bands that start past
    the diagonal or hold no tile, targets far longer than the query and
    ragged lengths: with the ring and layout the rules take (shared up to
    908 columns), with the ring cut to the launch's widest window, and
    with the global layout forced; every launch counted."""
    B, Lq, Lt, qrange, trange, bands = BANDED_GEOMETRIES[geometry]
    for band in bands:
        kind = cuda_align.banded_layout(cuda_align.banded_ring(Lq, Lt, band))
        assert kind == ("global" if geometry == "past_shared" else "shared")
        for n_rate, params in ((0.03, AlignmentParams(algo=AlgoType.BANDED)),
                               (0.03, AlignmentParams(algo=AlgoType.BANDED,
                                                      n_penalty=2, match=2)),
                               (0.0, AlignmentParams(algo=AlgoType.BANDED))):
            q, t, ql, tl = [x.to(cuda) for x in _banded_geometry(
                50 + band, B, Lq, Lt, qrange, trange, n_rate)]
            want = banded_align_batch(q, t, ql, tl, params, band)
            ring = None
            if layout == "ring":
                widest = int(band_windows(ql.cpu().numpy(), tl.cpu().numpy(),
                                          band).max())
                ring = max(8, 8 * widest)
            with_n = n_rate > 0
            if not with_n:
                q, t, _ = cuda_align._no_n_inputs(q, t, False)
            for mode in ("end", "score") if with_n else ("score",):
                args = cuda_align.banded_launch_args(
                    mode, q, t, ql, tl, params, band, with_n,
                    force_global=layout == "global", ring=ring)
                assert args[2] == (layout != "global" and cuda_align
                                   .banded_layout(args[16]) == "shared")
                key = f"banded_sw.{mode}"
                before = cuda_align.LAUNCHES[key]
                got = cuda_align.launch_banded(args)
                torch.cuda.synchronize()
                assert cuda_align.LAUNCHES[key] == before + 1
                _assert_equal(got[:1] if mode == "score" else got, want)


def test_banded_launch_refuses_what_it_lacks(cuda):
    """The launcher takes the shared layout only where 32 threads' rings
    fit, the global one only with its scratch, and a ring that is a
    positive multiple of 8."""
    q, t, ql, tl = [x.to(cuda) for x in _batch(22, 64, 40, 48, n_rate=0.0)]
    p = AlignmentParams(algo=AlgoType.BANDED)
    args = cuda_align.banded_launch_args("end", q, t, ql, tl, p, 4, True)
    assert args[2] == 1 and args[17] is None
    bad = [(*args[:16], 912, *args[17:]), (*args[:2], 0, *args[3:]),
           (*args[:16], 12, *args[17:]), (*args[:16], 0, *args[17:])]
    for a in bad:
        with pytest.raises(RuntimeError, match="banded_sw_launch failed"):
            cuda_align.launch_banded(a)


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


def _pairhmm_records(seed, B, R, C):
    """Reads of 5..R bases cut from haplotypes of 5..C with ~5%
    substitutions (a few reads unrelated), raw ASCII, quals 10-40."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for _ in range(B):
        cl = int(rng.integers(5, C + 1))
        rl = int(rng.integers(5, R + 1))
        hap = bases[rng.integers(0, 4, cl)]
        at = int(rng.integers(0, max(cl - rl, 0) + 1))
        read = np.resize(hap[at:], rl) if rng.random() > 0.05 else \
            bases[rng.integers(0, 4, rl)]
        flip = rng.random(rl) < 0.05
        read = np.where(flip, bases[rng.integers(0, 4, rl)], read)
        recs.append(dict(read=read.astype(np.uint8).tobytes(),
                         hap=hap.tobytes(),
                         base_quals=rng.integers(10, 41, rl),
                         ins_quals=rng.integers(10, 41, rl),
                         del_quals=rng.integers(10, 41, rl)))
    return recs


def _pairhmm_inputs(recs, dev):
    return scan_pairhmm.device_inputs(scan_pairhmm.pack_records(recs), dev)


_PAIRHMM = {"intertask": cuda_pairhmm.pairhmm_forward_intertask_prepared,
            "wavefront": cuda_pairhmm.pairhmm_forward_prepared}


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
@pytest.mark.parametrize("kernel", ["intertask", "wavefront"])
def test_pairhmm_kernel_matches_plain(cuda, kernel, exact):
    """Ragged 70 x 90 (R not a multiple of 8, three 32-row strips):
    bit-equal to the plain sweep on the card and to the gold on 24 pairs."""
    recs = _pairhmm_records(14, 1024 + 37, 70, 90)
    t, p = _pairhmm_inputs(recs, cuda)
    want = scan_pairhmm.forward_prepared(*t, p)
    key = f"pairhmm.{kernel}"
    before = cuda_pairhmm.LAUNCHES[key]
    got = _PAIRHMM[kernel](*t, p, exact=exact)
    torch.cuda.synchronize()
    assert cuda_pairhmm.LAUNCHES[key] == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got > 0).float().mean() > 0.9
    for i in range(0, len(recs), 45):
        r = recs[i]
        g = golds.pairhmm_forward(r["read"], r["hap"], r["base_quals"],
                                  r["ins_quals"], r["del_quals"])
        assert _bits(got[i:i + 1])[0] == np.float32(g).view(np.int32), i


@pytest.mark.parametrize("kernel", ["intertask", "wavefront", "myers"])
def test_launch_alone_matches_the_wrapper(cuda, kernel):
    """The launch on a prepared layout (what chip_smoke.py times) gives the
    wrapper's result and counts one launch."""
    if kernel == "myers":
        rng = np.random.default_rng(17)
        pats = rng.integers(0, 4, (300, 96)).astype(np.uint8)
        args = [torch.from_numpy(a).to(cuda) for a in (
            myers.build_eq_masks(pats, np.full(300, 96, np.int32), 3)
            .astype(np.int64), np.full(300, 96, np.int32),
            rng.integers(0, 4, (300, 152)).astype(np.uint8),
            np.full(300, 152, np.int32))]
        want = myers.myers_batch(*args)
        before = myers.LAUNCHES["myers"]
        got = myers.launch_myers(myers.myers_layout(*args))
        assert myers.LAUNCHES["myers"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        return
    t, p = _pairhmm_inputs(_pairhmm_records(18, 300, 70, 90), cuda)
    want = _PAIRHMM[kernel](*t, p)
    layout = getattr(cuda_pairhmm, f"{kernel}_layout")(*t, p)
    key = f"pairhmm.{kernel}"
    before = cuda_pairhmm.LAUNCHES[key]
    got = getattr(cuda_pairhmm, f"launch_{kernel}")(layout)
    assert cuda_pairhmm.LAUNCHES[key] == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("B", [1, 7, 64])
def test_pairhmm_wavefront_small_batches(cuda, B):
    recs = _pairhmm_records(15 + B, B, 150, 260)
    t, p = _pairhmm_inputs(recs, cuda)
    want = scan_pairhmm.forward_prepared(*t, p)
    got = cuda_pairhmm.pairhmm_forward_prepared(*t, p)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("force_global", [False, True],
                         ids=["rule", "global"])
@pytest.mark.parametrize("kernel,G,K", PAIRHMM_SHAPES,
                         ids=[f"{k}-G{g}-K{r}" for k, g, r in PAIRHMM_SHAPES])
@pytest.mark.parametrize("B", PAIRHMM_EDGE_B)
def test_pairhmm_edges_match_plain(cuda, B, kernel, G, K, force_global):
    """Every shape of lanes a pair and rows a lane, in the rule's handover
    layout and the forced global one, bit-equal to the plain version with
    rlen at every round edge (chip_smoke.pairhmm_edges: R = 2 G K + 2, two
    rounds and two rows), rlen 0 and past R, clen 1 and 0, and clen past C
    (cut at C, D0 from clen) at full and ragged reads."""
    t, p = pairhmm_edges(np.random.default_rng(B * 31 + G + K), B, G, K,
                         cuda)
    want = scan_pairhmm.forward_prepared(*t, p)
    if kernel == "intertask":
        lay = cuda_pairhmm.intertask_layout(*t, p, shape=(G, K),
                                            force_global=force_global)
        got = cuda_pairhmm.launch_intertask(lay)
    else:
        lay = cuda_pairhmm.wavefront_layout(*t, p, rows_per_lane=K,
                                            force_global=force_global)
        got = cuda_pairhmm.launch_wavefront(lay)
    assert (lay[-2] is not None) == force_global
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.isfinite(got).all()
    live = (t[2] >= 1) & (t[2] <= t[0].shape[1]) & (t[3] >= 1)
    assert (got[live] > 0).float().mean() > 0.9


def test_pairhmm_model_on_the_card_matches_cpu(cuda):
    recs = _pairhmm_records(16, 300, 60, 80)
    got = pairhmm.compute_likelihoods(recs, device=cuda)
    want = pairhmm.compute_likelihoods(recs, device="cpu")
    np.testing.assert_array_equal(got.likelihoods.view(np.int32),
                                  want.likelihoods.view(np.int32))
    assert got.cells == want.cells


@pytest.mark.parametrize("W", [1, 3, 5, 9])
def test_myers_kernel_matches_plain(cuda, W):
    """Interior 255s, Ns and empty patterns; W = 9 takes the scratch
    path."""
    rng = np.random.default_rng(20 + W)
    B, Lp, Lt = 1024 + 37, 32 * W, 32 * W + 48
    pats = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    texts = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    plen = rng.integers(1, Lp + 1, B).astype(np.int32)
    tlen = rng.integers(1, Lt + 1, B).astype(np.int32)
    plen[:3] = 0
    for i in range(0, B, 2):
        at = int(rng.integers(0, Lt - plen[i] + 1))
        texts[i, at:at + plen[i]] = pats[i, :plen[i]]
    texts[rng.random(texts.shape) < 0.03] = 4
    texts[rng.random(texts.shape) < 0.01] = 255
    eq = myers.build_eq_masks(pats, plen, W)
    args = [torch.from_numpy(a).to(cuda) for a in (eq, plen, texts, tlen)]
    want = [w.cpu() for w in myers.myers_batch_plain(*args)]
    _assert_equal(myers.myers_batch(*(a.cpu() for a in args)), want)
    before = myers.LAUNCHES["myers"]
    got = myers.myers_batch(*args)
    torch.cuda.synchronize()
    assert myers.LAUNCHES["myers"] == before + 1
    _assert_equal([g.cpu() for g in got], want)
    args[0] = args[0].long()
    _assert_equal([g.cpu() for g in myers.myers_batch(*args)], want)
    # texts that are a slice of a larger tensor: rows 3 bytes off a 16-byte
    # boundary, and rows with a stride past Lt
    flat = torch.zeros(3 + B * Lt + 16, dtype=torch.uint8, device=cuda)
    flat[3:3 + B * Lt] = args[2].reshape(-1)
    wide = torch.zeros((B, Lt + 21), dtype=torch.uint8, device=cuda)
    wide[:, 5:5 + Lt] = args[2]
    for texts in (flat[3:3 + B * Lt].view(B, Lt), wide[:, 5:5 + Lt]):
        lay = myers.myers_layout(args[0], args[1], texts, args[3])
        assert lay[2].data_ptr() == texts.data_ptr()
        _assert_equal([g.cpu() for g in myers.launch_myers(lay)], want)


def test_edit_distance_on_the_card_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    ps = ["".join(rng.choice(list("ACGT"), int(rng.integers(4, 150))))
          for _ in range(200)]
    ts = ["".join(rng.choice(list("ACGTN"), int(rng.integers(4, 60))))
          + p + "ACGT" for p in ps]
    got = myers.edit_distance_semiglobal(ps, ts, device=cuda)
    want = myers.edit_distance_semiglobal(ps, ts, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    {}, dict(with_tb=True),
    dict(params=AlignmentParams(compute_start=True, second_best=True)),
    dict(algo=AlgoType.SEMI_GLOBAL, with_tb=True, head=SemiGlobalSkip.TARGET,
         tail=SemiGlobalSkip.TARGET),
    dict(algo=AlgoType.KSW), dict(algo=AlgoType.BANDED, band_width_tiles=2),
], ids=["local", "tb", "start_second", "glocal_tb", "ksw", "banded"])
def test_align_fasta_pairs_on_the_card_matches_cpu(cuda, tmp_path,
                                                   monkeypatch, kw):
    """The facade over two FASTA files with all four header ops, in
    chunks of 50 over its two streams: every field of every job equal to
    the CPU run; LOCAL ends run END16 under GENOMICS_TPU_INT16_CELLS=1."""
    from genomics_tpu_torch.models import aligner

    rng = np.random.default_rng(11)
    comp = str.maketrans("ACGTN", "TGCAN")
    qf, tf = tmp_path / "q.fasta", tmp_path / "t.fasta"
    with open(qf, "w") as fq, open(tf, "w") as ft:
        for k in range(230):
            tgt = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 97))))
            read = list(tgt[5:5 + int(rng.integers(40, 55))])
            for i in range(len(read)):
                if rng.random() < 0.04:
                    read[i] = str(rng.choice(list("ACGTN")))
            op = ">", "<", "/", "+"
            read = "".join(read).translate(comp) if k % 4 > 1 else "".join(read)
            fq.write(f"{op[k % 4]}r{k}\n{read[::-1] if k % 2 else read}\n")
            ft.write(f">t{k}\n{tgt}\n")
    monkeypatch.setattr(aligner, "CHUNK", 50)
    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    before = cuda_align.LAUNCHES["local_sw.end16"]
    got = aligner.align_fasta_pairs(str(qf), str(tf), device=cuda, **kw)
    want = aligner.align_fasta_pairs(str(qf), str(tf), device="cpu", **kw)
    if not kw:
        assert cuda_align.LAUNCHES["local_sw.end16"] > before
    assert len(got) == len(want) == 230
    for a, b in zip(got, want):
        assert a == b if a.cigar is None else (
            a.cigar_string == b.cigar_string and
            (a.score, a.query_start, a.target_start, a.query_end,
             a.target_end) == (b.score, b.query_start, b.target_start,
                               b.query_end, b.target_end))


def _semi_groups_match(q, t, ql, tl, p, head, tail, with_tb, groups=(4, 8)):
    """semiglobal_sw at each threads-per-pair group and through the
    wrapper (the rule's group) equal to the plain version; TB's cube word
    for word."""
    want = semiglobal_align_batch(q, t, ql, tl, p, head=head, tail=tail,
                                  with_tb=with_tb)
    key = "semiglobal_sw.tb" if with_tb else "semiglobal_sw.end"
    before = cuda_align.LAUNCHES[key]
    for g in groups:
        args = cuda_align.semiglobal_launch_args(q.T, t.T, ql, tl, p, head,
                                                 tail, with_tb, group=g)
        got = cuda_align.launch_semiglobal(args)
        torch.cuda.synchronize()
        _assert_equal(got, want)
        if with_tb:
            assert torch.equal(got[3], want.tb)
    got = cuda_align.semiglobal_align(q, t, ql, tl, p, head=head, tail=tail,
                                      with_tb=with_tb)
    torch.cuda.synchronize()
    assert cuda_align.LAUNCHES[key] == before + len(groups) + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("B", [1, 2, 33, 1025])
@pytest.mark.parametrize("head,tail", list(itertools.product(SKIPS, SKIPS)),
                         ids=lambda s: s.name)
def test_semiglobal_end_groups_match_plain(cuda, head, tail, B):
    """END, walked to each pair's extents, at 4 and 8 threads a pair
    and through the wrapper under every HEAD x TAIL, on one pair, two, a
    warp and a bit and an odd B, ragged lengths with Ns."""
    args = [x.to(cuda) for x in _batch(43 + B, B, 40, 48, n_rate=0.03)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL, n_penalty=2)
    _semi_groups_match(*args, p, head, tail, False)


@pytest.mark.parametrize("B", [1, 33, 1025])
@pytest.mark.parametrize("head,tail", TB_SKIPS, ids=lambda s: s.name)
def test_semiglobal_tb_groups_match_plain(cuda, head, tail, B):
    """TB at every group writes every word of the cube as the plain
    version does, under the four skips the engine's traceback takes."""
    args = [x.to(cuda) for x in _batch(47 + B, B, 40, 48, n_rate=0.03)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    _semi_groups_match(*args, p, head, tail, True)


@pytest.mark.parametrize("with_tb", [False, True], ids=["end", "tb"])
@pytest.mark.parametrize("tail", [SemiGlobalSkip.TARGET, SemiGlobalSkip.BOTH],
                         ids=lambda s: s.name)
def test_semiglobal_groups_at_ties_match_plain(cuda, tail, with_tb):
    """Two letters at match = mismatch = gap_extend = 1 (gap_open 0): the
    maxima, TAIL_T's rows, TAIL_Q's columns and the extension bits tie
    everywhere."""
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL, match=1, mismatch=1,
                        gap_open=0, gap_extend=1, n_penalty=1)
    args = [x.to(cuda) for x in _two_letters(51, 1024 + 37, 64, 0.03)]
    _semi_groups_match(*args, p, SemiGlobalSkip.NONE, tail, with_tb)


@pytest.mark.parametrize("with_tb", [False, True], ids=["end", "tb"])
@pytest.mark.parametrize("B,Lq,Lt", [(3382, 216, 216), (16618, 216, 328),
                                     (65536, 152, 152)],
                         ids=["engine_small", "engine_large", "bench"])
def test_semiglobal_at_launch_sizes_matches_plain(cuda, B, Lq, Lt, with_tb):
    """The engine's two bucket launches over 20,000 GASAL2-shaped pairs and
    bench.py's, NONE/BOTH as the engine's glocal runs (BOTH/BOTH with
    traceback), every group and the rule's."""
    args = [x.to(cuda) for x in _batch(52, B, Lq, Lt, 0.01)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    head = SemiGlobalSkip.BOTH if with_tb else SemiGlobalSkip.NONE
    _semi_groups_match(*args, p, head, SemiGlobalSkip.BOTH, with_tb)


@pytest.mark.parametrize("kernel", ["local_start", "semiglobal_sw",
                                    "local_sw16"])
def test_split_group_boundaries_match_plain(cuda, kernel):
    """Launches one pair (pair pair) either side of the rule's group
    boundary on this card, through the wrappers: both groups the rule
    takes give the plain version's results."""
    sms = cuda_align._sm_count(cuda.index or 0)
    edge = -(-cuda_align.SPLIT_MIN_THREADS_PER_SM * sms // 4)
    seen = set()
    for n in (edge - 1, edge):
        B = 2 * n if kernel == "local_sw16" else n
        q, t, ql, tl = [x.to(cuda) for x in _batch(53 + n % 7, B, 16, 24,
                                                   0.01)]
        if kernel == "local_start":
            p = AlignmentParams()
            rq, rt, score, qr8, tr8 = _local_start_inputs(q, t, ql, tl, p)
            want = scan_align_full._local_start_core(rq, rt, score, p)
            got = cuda_align.local_start(rq, rt, score, p, qr8, tr8)
        elif kernel == "semiglobal_sw":
            p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
            want = semiglobal_align_batch(q, t, ql, tl, p,
                                          tail=SemiGlobalSkip.BOTH)
            got = cuda_align.semiglobal_align(q, t, ql, tl, p,
                                              tail=SemiGlobalSkip.BOTH)
        else:
            p = AlignmentParams()
            qs, ts = (cuda_align._pads_to_sentinels(x, c)
                      for x, c in ((q, 16), (t, 17)))
            want = local_align_batch16(qs, ts, p, ends=False)[:1]
            got = [cuda_align.local_align_scores(q, t, p, has_n=False)]
        torch.cuda.synchronize()
        _assert_equal(got, want)
        seen.add(cuda_align.split_group(n, sms))
    assert seen == {4, 8}


@pytest.mark.parametrize("with_tb", [False, True], ids=["end", "tb"])
def test_semiglobal_empty_targets_match_plain(cuda, with_tb):
    """Pairs with an empty target beside full ones, pair 0's TAIL_Q row
    in strip 3 (the lane before pair 1's at 4 threads a pair): each takes
    the plain version's results under every HEAD x TAIL at both groups,
    not a neighbour's TAIL_Q maximum."""
    q, t, ql, tl = _batch(58, 64, 24, 32, 0.0)
    tl[0] = 32
    for k in (1, 2, 5, 9, 33):
        tl[k] = 0
        t[k] = 14
    args = [x.to(cuda) for x in (q, t, ql, tl)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    for head, tail in itertools.product(SKIPS, SKIPS):
        _semi_groups_match(*args, p, head, tail, with_tb)


def _local16_groups_match(q, t, p, mode, groups=(4, 8)):
    """A 16-bit mode at each group (and the rule's) equal to its plain
    version and to the int32 mode; SCORE16 on the pads remapped."""
    Q, T = q.T.contiguous(), t.T.contiguous()
    if mode == "score16":
        Q, T = (cuda_align._pads_to_sentinels(x, c) for x, c in ((Q, 16),
                                                                 (T, 17)))
    n = 1 if mode == "score16" else 3
    want = local_align_batch16(Q.T, T.T, p, ends=mode == "end16")[:n]
    int32 = cuda_align._launch("score" if n == 1 else "end", Q, T, p,
                               mode == "end16")[:n]
    for g in (*groups, None):
        args = cuda_align.local_launch_args(mode, Q, T, p, mode == "end16",
                                            group=g)
        got = cuda_align.launch_local(args)[:n]
        torch.cuda.synchronize()
        _assert_equal(got, want)
        _assert_equal(got, int32)


@pytest.mark.parametrize("mode", ["score16", "end16"])
@pytest.mark.parametrize("B", [1, 2, 33, 1023, 1024])
def test_local16_groups_match_plain(cuda, mode, B):
    """SCORE16 and END16 at 4 and 8 threads per two pairs and the
    rule's, on one pair (partnered with the dummy), two, a warp and a bit,
    and an odd and an even B (the 16-bit loads take even B only)."""
    q, t, _, _ = (x.to(cuda) for x in _batch(
        54 + B, B, 40, 48, 0.03 if mode == "end16" else 0.0))
    _local16_groups_match(q, t, AlignmentParams(n_penalty=2), mode)


@pytest.mark.parametrize("mode", ["score16", "end16"])
@pytest.mark.parametrize("B,Lq,Lt", [(3382, 216, 216), (16618, 216, 328),
                                     (4150, 216, 328), (65536, 152, 152)],
                         ids=["engine_small", "engine_large", "cli_chunk",
                              "bench"])
def test_local16_at_launch_sizes_matches_plain(cuda, mode, B, Lq, Lt):
    """The engine's two bucket launches, the align CLI's largest chunk
    launch and bench.py's, every group."""
    q, t, _, _ = (x.to(cuda) for x in _batch(
        55, B, Lq, Lt, 0.01 if mode == "end16" else 0.0))
    _local16_groups_match(q, t, AlignmentParams(), mode)


@pytest.mark.parametrize("mode", ["score16", "end16"])
def test_local16_groups_at_ties_match_plain(cuda, mode):
    """Two letters at match = mismatch = gap_extend = 1 (gap_open 0): the
    maxima tie everywhere, so END16 keeps the earliest cell within a
    strip and across a round's strips."""
    p = AlignmentParams(match=1, mismatch=1, gap_open=0, gap_extend=1,
                        n_penalty=1)
    q, t, _, _ = [x.to(cuda) for x in _two_letters(
        56, 1024 + 37, 64, 0.03 if mode == "end16" else 0.0)]
    _local16_groups_match(q, t, p, mode)


@pytest.mark.parametrize("mode,match,Lq,Lt", [("end16", 127, 258, 264),
                                              ("score16", 991, 33, 40)])
def test_local16_groups_at_the_int16_limits_match_plain(cuda, mode, match,
                                                        Lq, Lt):
    """One below the ends' and the scores' limits (127 x 258 = 32,766,
    991 x 33 = 32,703) on identical pairs, every group, odd B."""
    p = AlignmentParams(match=match)
    q, t = (x.to(cuda) for x in _same_pairs(33, Lq, Lt))
    _local16_groups_match(q, t, p, mode)
    assert int(local_align_batch16(q, t, p).score.max()) == match * Lq


def test_split_launches_refuse_other_groups(cuda):
    """semiglobal_sw and the 16-bit local_sw modes take 4 or 8 threads;
    the int32 local_sw modes 1 only."""
    q, t, ql, tl = [x.to(cuda) for x in _batch(57, 64, 24, 32, 0.0)]
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL)
    for g in (0, 1, 2, 3, 16):
        args = cuda_align.semiglobal_launch_args(q.T, t.T, ql, tl, p,
                                                 group=g)
        with pytest.raises(RuntimeError, match="semiglobal_sw_launch failed"):
            cuda_align.launch_semiglobal(args)
    for mode, g in (("score16", 1), ("end16", 2), ("score16", 3),
                    ("end16", 16), ("end", 2), ("tb", 4)):
        args = list(cuda_align.local_launch_args(mode, q.T, t.T,
                                                 AlignmentParams(),
                                                 mode != "score16"))
        args[2] = g
        with pytest.raises(RuntimeError, match="local_sw_launch failed"):
            cuda_align.launch_local(tuple(args))


# -- the NW, SW and MSA apps' kernels --------------------------------------


@pytest.mark.parametrize("N", [*NW_EDGE_N, 1000])
def test_nw_kernel_matches_plain(cuda, N):
    rng = np.random.default_rng(N)
    ref = rng.integers(0, 256, N).astype(np.uint8)
    qry = nw.generate_query(ref, rng)
    r, q = torch.from_numpy(ref).to(cuda), torch.from_numpy(qry).to(cuda)
    before = nw.LAUNCHES["nw_app"]
    got = nw.nw_matrix(r, q)
    assert nw.LAUNCHES["nw_app"] == before + 1
    assert torch.equal(got, nw.nw_matrix_plain(r, q))
    if N <= 257:
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      golds.nw_cpu(ref, qry))


@pytest.mark.parametrize("N,grid", nw_stripe_edges(nw.STRIPE))
def test_nw_kernel_at_the_stripe_edges(cuda, N, grid):
    """A stripe's height and one row more or less, and launches with fewer
    warps than stripes (each warp takes several tickets)."""
    rng = np.random.default_rng(N + (grid or 0))
    ref = rng.integers(0, 256, N).astype(np.uint8)
    r = torch.from_numpy(ref).to(cuda)
    q = torch.from_numpy(nw.generate_query(ref, rng)).to(cuda)
    out = torch.empty((N, N), dtype=torch.int32, device=cuda)
    before = nw.LAUNCHES["nw_app"]
    nw.launch_nw(r, q, out, grid=grid)
    assert nw.LAUNCHES["nw_app"] == before + 1
    assert torch.equal(out, nw.nw_matrix_plain(r, q))


@pytest.mark.parametrize("case", range(len(fill_edges(
    np.random.default_rng(0)))))
def test_fill_kernel_at_its_edges(cuda, case, matrix_path):
    """msa_nw.cu's fill at a strip's and a round's height +- 1, pair
    counts around the sector group, 40,000 pairs (many waves of blocks),
    ragged lengths with 0, protein bytes the matrix does not name."""
    label, cenc, seqs, protein = fill_edges(np.random.default_rng(1))[case]
    c, a = torch.from_numpy(cenc).to(cuda), torch.from_numpy(seqs).to(cuda)
    t = (torch.from_numpy(load_scoring_matrix(matrix_path)).to(cuda)
         if protein else None)
    before = msa.LAUNCHES["msa_nw.fill"]
    M = msa.nw_matrices_batch(c, a, t)
    assert msa.LAUNCHES["msa_nw.fill"] == before + 1
    want = msa.nw_matrices_batch_plain(c, a, t)
    assert cube_err(M, want, msa.fill_args(c, a, None)[2][:len(seqs)]) == 0, \
        label


@pytest.mark.parametrize("case", range(len(sw_stripe_edges(
    np.random.default_rng(0)))))
def test_sw_kernel_matches_plain(cuda, case):
    """sw_app.cu at the edges of its stripes and tiles
    (chip_smoke.sw_stripe_edges), through sw_matrix_batch on the card's
    resident blocks and through launch_sw on fewer blocks than stripes
    (blocks take more than one ticket)."""
    label, x, wins, grid = sw_stripe_edges(np.random.default_rng(4))[case]
    xd, wd = torch.from_numpy(x).to(cuda), torch.from_numpy(wins).to(cuda)
    W, L = wins.shape
    want_H, want_best = sw.sw_matrix_batch_plain(xd, wd)
    before = sw.LAUNCHES["sw_app"]
    H, best = sw.sw_matrix_batch(xd, wd)
    assert sw.LAUNCHES["sw_app"] == before + 1
    assert torch.equal(H, want_H) and torch.equal(best, want_best), label
    assert grid < W * sw.stripes(len(x))
    H = torch.full_like(H, -5)
    best = torch.full((W,), -5, dtype=torch.int32, device=cuda)
    sw.launch_sw(xd, wd, H, best, grid=grid)
    assert sw.LAUNCHES["sw_app"] == before + 2
    assert torch.equal(H, want_H) and torch.equal(best, want_best), label


def test_sw_kernel_at_the_app_edges_matches_plain(cuda):
    """The edges of chip_smoke.sw_edges and a mid size (6 windows of 900
    against 300 bases)."""
    rng = np.random.default_rng(5)
    cases = sw_edges(rng) + [("mid", rng.integers(65, 69, 300).astype(
        np.uint8), rng.integers(65, 69, (6, 900)).astype(np.uint8))]
    for label, x, wins in cases:
        xd, wd = torch.from_numpy(x).to(cuda), torch.from_numpy(wins).to(cuda)
        before = sw.LAUNCHES["sw_app"]
        H, best = sw.sw_matrix_batch(xd, wd)
        assert sw.LAUNCHES["sw_app"] == before + 1
        want_H, want_best = sw.sw_matrix_batch_plain(xd, wd)
        assert torch.equal(H, want_H), label
        assert torch.equal(best, want_best), label


def test_sw_align_on_the_card_matches_cpu_and_gold(cuda):
    rng = np.random.default_rng(6)
    x = random_seq(rng, 120)
    y = random_seq(rng, 1500) + mutate(rng, x, 0.03, 0.02) + random_seq(
        rng, 2000)
    got = sw.align(x, y, device=cuda)
    assert got == sw.align(x, y, device="cpu")
    assert (got["score"], got["location"], got["window"], got["cigar"]) == \
        golds.sw_best_alignment(x, y)


def _msa_kernels_match(cuda, seqs, table):
    """Fill (within each pair's length) and backtrack, kernel == plain ==
    the host gold, at center 0."""
    cenc, arr, slens = msa.pack_pairs(seqs, 0)
    c, a, sl = (torch.from_numpy(v).to(cuda) for v in (cenc, arr, slens))
    t = None if table is None else torch.from_numpy(table).to(cuda)
    M = msa.nw_matrices_batch(c, a, t)
    want = msa.nw_matrices_batch_plain(c, a, t)
    for k, n in enumerate(slens):
        assert torch.equal(M[k, :, :n + 1], want[k, :, :n + 1])
    sp, so = msa.backtrack_batch(M, c, a, sl, t)
    w_sp, w_so = msa.backtrack_batch_plain(want, c, a, sl, t)
    assert torch.equal(sp, w_sp) and torch.equal(so, w_so)
    for k, s in enumerate(seqs[1:]):
        g_sp, g_so = msa.backtrack(M[k, :, :len(s) + 1].cpu().numpy(),
                                   seqs[0], s, table)
        np.testing.assert_array_equal(sp[k].cpu().numpy(), g_sp)
        np.testing.assert_array_equal(so[k, :len(s) + 1].cpu().numpy(), g_so)


@pytest.fixture
def matrix_path(tmp_path):
    path = tmp_path / "synthetic.txt"
    path.write_text(ncbi_matrix(np.random.default_rng(8)))
    return str(path)


@pytest.mark.parametrize("case", range(5))
def test_msa_kernels_at_the_edges_match_plain(cuda, case, matrix_path):
    label, seqs, protein = msa_edges(np.random.default_rng(0))[case]
    table = load_scoring_matrix(matrix_path) if protein else None
    _msa_kernels_match(cuda, seqs, table)
    path = matrix_path if protein else None
    assert msa.msa(seqs, matrix_path=path, device=cuda) == msa.msa(
        seqs, matrix_path=path, device="cpu"), label


@pytest.mark.parametrize("case", range(len(backtrack_edges(
    np.random.default_rng(0)))))
def test_backtrack_kernel_at_its_edges(cuda, case, matrix_path):
    """msa_nw.cu's backtrack on the fill's storage, whose pitch P is not
    the pair count B: a sequence of length 1, gap runs past a round's 32
    lanes, ties of a vertical and a horizontal run, 9 pairs (pitch 16)
    and one protein pair (pitch 8); one launch, == plain == the host."""
    label, seqs, protein = backtrack_edges(np.random.default_rng(2))[case]
    table = load_scoring_matrix(matrix_path) if protein else None
    cenc, arr, slens = msa.pack_pairs(seqs, 0)
    c, a, sl = (torch.from_numpy(v).to(cuda) for v in (cenc, arr, slens))
    t = None if table is None else torch.from_numpy(table).to(cuda)
    M = msa.nw_matrices_batch(c, a, t)
    args = msa.backtrack_args(M, c, a, sl, t)
    assert args[10] > args[11] == len(seqs) - 1, label   # pitch, count
    before = msa.LAUNCHES["msa_nw.backtrack"]
    sp, so = msa.launch_backtrack(args)
    assert msa.LAUNCHES["msa_nw.backtrack"] == before + 1
    w_sp, w_so = msa.backtrack_batch_plain(msa.nw_matrices_batch_plain(
        c, a, t), c, a, sl, t)
    assert torch.equal(sp, w_sp) and torch.equal(so, w_so), label
    for k, s in enumerate(seqs[1:]):
        g_sp, g_so = msa.backtrack(M[k, :, :len(s) + 1].cpu().numpy(),
                                   seqs[0], s, table)
        np.testing.assert_array_equal(sp[k].cpu().numpy(), g_sp)
        np.testing.assert_array_equal(so[k, :len(s) + 1].cpu().numpy(), g_so)


@pytest.mark.parametrize("letters", ["ACGT", "ACDEFGHIKLMNPQRSTVWY",
                                     "ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy"])
def test_msa_kernels_at_a_mid_size_match_plain(cuda, letters, matrix_path):
    """300 sequences of about 200 with substitutions and indels: DNA, and
    protein under the table (lower-case letters are bytes the matrix does
    not name, scoring 0: 41 codes with the pad)."""
    rng = np.random.default_rng(9)
    base = random_seq(rng, 200, letters)
    seqs = [mutate(rng, base, 0.05, 0.03, letters) for _ in range(300)]
    _msa_kernels_match(cuda, seqs, None if letters == "ACGT"
                       else load_scoring_matrix(matrix_path))


def test_msa_in_chunks_on_the_card_matches_one_call(cuda, monkeypatch):
    rng = np.random.default_rng(10)
    base = random_seq(rng, 90)
    seqs = [mutate(rng, base, 0.05, 0.05) for _ in range(70)]
    one = msa.msa(seqs, device=cuda)
    monkeypatch.setattr(msa, "pairs_per_call", lambda dev, m, n: 16)
    assert msa.msa(seqs, device=cuda) == one == msa.msa(seqs, device="cpu")


@pytest.mark.parametrize("spec", FM_EDGE_SPECS,
                         ids=[spec[0] for spec in FM_EDGE_SPECS])
def test_fm_search_matches_plain_at_the_edges(cuda, spec):
    """The kernel == its plain version == the host FMIndex at the edge
    texts, queries of 0-32 present and absent; also with the queries at a
    row stride past their length (read in place)."""
    codes = fm_edge_text(spec)
    fm = FMIndex(codes)
    idx = fm.to_device(device=cuda)
    Q, ql = fm_queries(np.random.default_rng(len(codes)), codes)
    q = torch.from_numpy((Q & 3).astype(np.uint8)).to(cuda)
    qlt = torch.from_numpy(ql).to(cuda)
    before = fm_search.LAUNCHES["fm_search"]
    got = fm_search.fm_search(idx, q, qlt)
    assert fm_search.LAUNCHES["fm_search"] == before + 1
    want = fm_search.backward_search_plain(idx, q, qlt)
    _assert_equal([g.cpu() for g in got], [w.cpu() for w in want])
    host = fm.backward_search(Q, ql)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g.cpu().numpy(), h)
    wide = torch.zeros((q.shape[0], q.shape[1] + 13), dtype=torch.uint8,
                       device=cuda)
    wide[:, :q.shape[1]] = q
    lay = fm_search.fm_search_layout(idx, wide[:, :q.shape[1]], qlt)
    assert lay[7].data_ptr() == wide.data_ptr() and lay[9] == q.shape[1] + 13
    _assert_equal([g.cpu() for g in fm_search.launch_fm_search(lay)],
                  [w.cpu() for w in want])


def test_fm_search_of_no_queries_launches_nothing(cuda):
    idx = FMIndex(np.zeros(50, np.uint8)).to_device(device=cuda)
    before = fm_search.LAUNCHES["fm_search"]
    lo, hi = fm_search.fm_search(
        idx, torch.zeros((0, 16), dtype=torch.uint8, device=cuda),
        torch.zeros(0, dtype=torch.int32, device=cuda))
    assert lo.shape == hi.shape == (0,)
    assert fm_search.LAUNCHES["fm_search"] == before


def test_fm_search_launch_refuses_an_empty_grid(cuda):
    idx = FMIndex(np.zeros(50, np.uint8)).to_device(device=cuda)
    q = torch.zeros((1, 16), dtype=torch.uint8, device=cuda)
    lay = list(fm_search.fm_search_layout(
        idx, q, torch.ones(1, dtype=torch.int32, device=cuda)))
    lay[11] = 0
    with pytest.raises(RuntimeError, match="fm_search_launch failed"):
        fm_search.launch_fm_search(tuple(lay))


@pytest.mark.parametrize("seeder,two_stage", [("fmdev", "ed"),
                                              ("qgram", False)])
def test_mapper_on_the_card_matches_cpu(cuda, seeder, two_stage):
    """ReadMapper on the card (the fmdev seeder's fm_search, the `ed`
    stage's Myers, LOCAL TB and the walk) == device="cpu", every Mapping
    field, over two contigs; pairs with rescue too."""
    rng = np.random.default_rng(70)
    codes = rng.integers(0, 4, 30000).astype(np.uint8)
    codes[20000:22000] = codes[3000:5000]          # a repeat
    text = "ACGT"
    contigs = [("c1", "".join(text[c] for c in codes[:18000])),
               ("c2", "".join(text[c] for c in codes[18000:]))]
    at = rng.integers(0, len(codes) - 153, 96)
    win = codes[at[:, None] + np.arange(153)]
    reads = as_reads(mutate_windows(rng, win, 150), np.arange(96) % 2 == 1)
    card = ReadMapper(contigs, seeder=seeder, device=cuda)
    cpu = ReadMapper(contigs, seeder=seeder, device="cpu")
    counts = dict(fm_search.LAUNCHES, **myers.LAUNCHES)
    got = card.map_batch(reads, two_stage=two_stage)
    if seeder == "fmdev":
        assert fm_search.LAUNCHES["fm_search"] > counts["fm_search"]
        assert myers.LAUNCHES["myers"] > counts["myers"]
    want = cpu.map_batch(reads, two_stage=two_stage)
    assert [dataclasses.asdict(m) for m in got] == \
        [dataclasses.asdict(m) for m in want]
    assert sum(m.pos > 0 for m in got) > 80
    half = len(reads) // 2
    assert card.map_pairs(reads[:half], reads[half:]) == \
        cpu.map_pairs(reads[:half], reads[half:])


def test_cluster_lcs_matches_plain_at_the_edges(cuda):
    """chip_smoke's phase 3 for cluster_lcs: nets at the word edges, one
    base, net 0, noisy reads, S of 1, 7 and 256, gated and not, registers
    and the global scratch."""
    before = lcs.LAUNCHES["cluster_lcs"]
    err, n = cluster_lcs_parity(np.random.default_rng(1), cuda)
    assert err == 0 and lcs.LAUNCHES["cluster_lcs"] - before >= n


def test_ngia_lcs_matches_plain_at_the_edges(cuda):
    """chip_smoke's phase 3 for ngia_lcs: bands clipped at both ends,
    empty bands, reads under 3 bases, a band past the register window,
    the fma pairs; windows and rounds."""
    before = lcs.LAUNCHES["ngia_lcs"]
    err, n = ngia_lcs_parity(np.random.default_rng(2), cuda)
    assert err == 0 and lcs.LAUNCHES["ngia_lcs"] - before >= n


def test_word_min_sum_is_exact_under_reduced_precision_flags(cuda,
                                                             monkeypatch):
    """torch._int_mm's min-sum equals the host's with TF32 and bf16
    reductions allowed (they must not reach it)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", True)
    reads = family_reads(np.random.default_rng(3), 1200, 140, 8, 6)
    p = cluster._prepare(reads, 0.95, 6)
    packed, K = cluster._packed_dev(p, cuda), cluster._dense_k(p, 6)
    for S in (1, 7, 256):
        reps, jobs = np.arange(S), np.arange(S, S + 901)
        got = cluster_filter.word_min_sum(*(cluster_filter.dense_rows(
            packed, torch.from_numpy(x).to(cuda), 4096) for x in (reps, jobs)),
            K)
        assert np.array_equal(got.cpu().numpy(),
                              host_min_sum(p, reps, jobs, 6))


@pytest.mark.parametrize("edge", FILTER_CARD_EDGES,
                         ids=[e[0] for e in FILTER_CARD_EDGES])
def test_cluster_filter_matches_plain_at_the_edges(cuda, edge):
    """chip_smoke's phase 3 for cluster_filter: one launch, pass2 and the
    any-column flags == the plain version, also from inputs whose pass2
    buffer held other bytes before (every column written)."""
    _, wl, K, S, J = edge
    words, counts, *rest, _ = filter_edge_inputs(*edge)
    packed = torch.from_numpy(cluster_filter.pack_words(words, counts)).to(
        cuda)
    args = [torch.from_numpy(x).to(cuda) for x in rest]
    before = cluster_filter.LAUNCHES["cluster_filter"]
    got = cluster_filter.window_filters(packed, *args, 1 << 2 * wl, K)
    assert cluster_filter.LAUNCHES["cluster_filter"] == before + 1
    want = cluster_filter.window_filters_plain(packed, *args, 1 << 2 * wl, K)
    _assert_equal([g.cpu() for g in got], [w.cpu() for w in want])
    lay = cluster_filter.filter_layout(packed, *args, 1 << 2 * wl)
    lay[11].fill_(7)
    lay[13].fill_(7)
    _assert_equal([g.cpu() for g in cluster_filter.launch_cluster_filter(
        lay)], [w.cpu() for w in want])


def test_cluster_filter_of_no_jobs_launches_nothing(cuda):
    words, counts, *rest, _ = filter_edge_inputs("J=1", 6, 2, 12, 1)
    packed = torch.from_numpy(cluster_filter.pack_words(words, counts)).to(
        cuda)
    prefix, wcut, bcut, rp, jp = (torch.from_numpy(x).to(cuda) for x in rest)
    before = cluster_filter.LAUNCHES["cluster_filter"]
    p2, anyv = cluster_filter.window_filters(packed, prefix, wcut, bcut, rp,
                                             jp[:0], 4096, 2)
    assert p2.shape == (12, 0) and anyv.shape == (0,)
    p2, anyv = cluster_filter.window_filters(packed, prefix, wcut, bcut,
                                             rp[:0], jp, 4096, 2)
    assert p2.shape == (0, 1) and not anyv.any()
    assert cluster_filter.LAUNCHES["cluster_filter"] == before


@pytest.mark.parametrize("speculate", [1, CLUSTER_SPEC])
def test_cluster_reads_on_the_card_matches_cpu(cuda, speculate):
    reads = family_reads(np.random.default_rng(4), 1500, 140, 8, 6)
    before = lcs.LAUNCHES["cluster_lcs"]
    filters = cluster_filter.LAUNCHES["cluster_filter"]
    got = cluster.cluster_reads(reads, speculate=speculate, device=cuda)
    assert lcs.LAUNCHES["cluster_lcs"] > before
    assert (cluster_filter.LAUNCHES["cluster_filter"] > filters) == (
        speculate > 1)
    want = cluster.cluster_reads(reads, speculate=speculate, device="cpu")
    assert np.array_equal(got.cluster, want.cluster)


@pytest.mark.parametrize("speculate", [1, 32])
def test_cluster_distributed_on_the_card_matches_cpu(cuda, speculate):
    reads = family_reads(np.random.default_rng(5), 300, 600, 16, 12)
    before = lcs.LAUNCHES["ngia_lcs"]
    got = ngia.cluster_distributed(reads, 0.95, speculate=speculate,
                                   device=cuda)
    assert lcs.LAUNCHES["ngia_lcs"] > before
    want = ngia.cluster_distributed(reads, 0.95, speculate=speculate,
                                    device="cpu")
    assert np.array_equal(got.cluster, want.cluster)


def test_lcs_wrappers_copy_codes_they_cannot_load_16_bytes_at_a_time(cuda):
    """Codes whose rows are not 16-byte aligned (an odd row stride, a view
    one byte in): lcs_accept and banded_lcs_accept (window and round) give
    their plain versions' accepts on the same codes."""
    def unaligned(codes):
        n, L = codes.shape
        wide = torch.full((n, L + 1), 255, dtype=torch.uint8, device=cuda)
        wide[:, 1:] = codes
        return wide[:, 1:], codes

    reads = family_reads(np.random.default_rng(7), 64, 140, 8, 6)
    p = cluster._prepare(reads, 0.95, 6)
    aux = cluster._aux_dev(p, cuda)
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    rp = torch.arange(4, dtype=torch.int32, device=cuda)
    jb = torch.arange(64, dtype=torch.int32, device=cuda)
    for codes in unaligned(torch.from_numpy(p.codes).to(cuda)):
        args[3] = codes
        assert codes.stride(0) % 16 or codes.data_ptr() % 16
        assert torch.equal(lcs.lcs_accept(*args, rp, jb),
                           lcs.lcs_accept_plain(*args, rp, jb))
    reads = family_reads(np.random.default_rng(8), 64, 300, 8, 6)
    _o, _l, net, words, low, high, codes = ngia._prepare(reads)
    a = ngia._device_arrays(net, words, low, high, codes, cuda)
    args = [a[k] for k in ("words", "net", "low", "high", "codes")]
    for codes in unaligned(torch.from_numpy(codes).to(cuda)):
        args[4] = codes
        assert codes.stride(0) % 16 or codes.data_ptr() % 16
        want = lcs.banded_lcs_accept_plain(*args, rp, jb, 0.95)
        assert want.any()
        assert torch.equal(lcs.banded_lcs_accept(*args, rp, jb, 0.95), want)
        cl = [torch.full((64,), -1, dtype=torch.int32, device=cuda)
              for _ in range(2)]
        lcs.banded_lcs_accept_plain(*args, rp[:1], jb, 0.95, cluster=cl[0])
        lcs.banded_lcs_accept(*args, rp[:1], jb, 0.95, cluster=cl[1])
        assert torch.equal(cl[1], cl[0])


def test_lcs_launches_refuse_a_bucket_they_do_not_have(cuda):
    reads = family_reads(np.random.default_rng(6), 64, 140, 8, 6)
    p = cluster._prepare(reads, 0.95, 6)
    aux = cluster._aux_dev(p, cuda)
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    rp = torch.zeros(1, dtype=torch.int32, device=cuda)
    jb = torch.arange(64, dtype=torch.int32, device=cuda)
    out = torch.empty((1, 64), dtype=torch.uint8, device=cuda)
    lay = list(lcs.lcs_layouts(*args, rp, jb, None, out, 5)[0])
    lay[15] = 3                         # nw: no such lane-group bucket
    with pytest.raises(RuntimeError, match="cluster_lcs_launch failed"):
        lcs.launch_cluster_lcs(tuple(lay))



def _pipeline_inputs(seed, B=300, L=40, R=40, C=60):
    q, t, ql, tl = (x.numpy() for x in _batch(seed, B, L, L, 0.01))
    rng = np.random.default_rng(seed)
    return (q, t, ql, tl,
            rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, R)),
            rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, C)),
            rng.integers(R // 2, R + 1, B).astype(np.int32),
            rng.integers(C // 2, C + 1, B).astype(np.int32),
            *(rng.integers(5, 60, (B, R)).astype(np.int32) for _ in range(3)))


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernels", "plain"])
def test_pipeline_step_on_the_card_equals_the_cpu(cuda, use_kernels):
    """`sharded_pipeline_step` on a one-rank mesh of the card (no process
    group: the collectives are the identity) against the same step on the
    CPU, field for field; with the kernels, each family's launch count
    moves."""
    from genomics_tpu_torch.parallel import data_mesh, multihost
    from genomics_tpu_torch.parallel.mesh import sharded_pipeline_step

    ins = _pipeline_inputs(21)
    P = AlignmentParams()
    before = {**cuda_align.LAUNCHES, **cuda_pairhmm.LAUNCHES,
              **myers.LAUNCHES}
    got = sharded_pipeline_step(data_mesh(device="cuda"), *ins, params=P,
                                use_pallas=use_kernels)
    after = {**cuda_align.LAUNCHES, **cuda_pairhmm.LAUNCHES,
             **myers.LAUNCHES}
    want = sharded_pipeline_step(data_mesh(device="cpu"), *ins, params=P,
                                 use_pallas=use_kernels)
    for k in want:
        if k == "total_likelihood":      # a float sum, in another order
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(multihost.fetch(got[k]),
                                          multihost.fetch(want[k]),
                                          err_msg=k)
    moved = {k for k in after if after[k] != before[k]}
    if use_kernels:
        assert {"local_sw.end", "local_sw.tb", "global_sw.score", "ksw.end",
                "banded_sw.end", "myers", "pairhmm.wavefront",
                "pairhmm.intertask"} <= moved
        assert moved & {"local_sw.score", "local_sw.score16"}
    else:
        assert not moved


def test_score_haplotypes_on_the_card_equals_the_cpu(cuda):
    """One wavefront launch over every (haplotype, read) pair of a window:
    the same likelihoods, order and variants as device="cpu"."""
    from genomics_tpu_torch.models import assembly

    rng = np.random.default_rng(22)
    ref = "".join(rng.choice(list("ACGT"), 120))
    alt = ref[:60] + ("A" if ref[60] != "A" else "C") + ref[61:]
    reads = [alt[p:p + 50] for p in rng.integers(0, 70, 24)]
    before = cuda_pairhmm.LAUNCHES["pairhmm.wavefront"]
    got = assembly.local_assembly(ref, reads, device=cuda)
    assert cuda_pairhmm.LAUNCHES["pairhmm.wavefront"] == before + 1
    want = assembly.local_assembly(ref, reads, device="cpu")
    assert [(h.seq, h.likelihood) for h in got[0]] == [
        (h.seq, h.likelihood) for h in want[0]]
    assert [vars(v) for v in got[1]] == [vars(v) for v in want[1]]
