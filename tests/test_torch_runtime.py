"""The port's AlignEngine against genomics_tpu.runtime.AlignEngine on the
CPU: every AlignmentJob field, CIGAR bytes included, over several
buckets, for LOCAL, GLOBAL and SEMI_GLOBAL; plus the parameter and
encoding carry-over and the engine's refusals."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from genomics_tpu.core import encoding as jenc
from genomics_tpu.core.scoring import AlgoType as JAlgo
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.core.scoring import SemiGlobalSkip as JSkip
from genomics_tpu.runtime.dispatch import AlignEngine as JEngine
from genomics_tpu_torch import AlignEngine, AlignmentParams, AlgoType
from genomics_tpu_torch.core import encoding
from genomics_tpu_torch.core.scoring import SemiGlobalSkip, params_from_jax
from genomics_tpu_torch.ops import cuda_align, tb_walk
from genomics_tpu_torch.runtime import dispatch

FIELDS = [f.name for f in dataclasses.fields(dispatch.AlignmentJob)]


def _pairs(seed, n=200):
    """Reads cut from random targets with substitutions, indels and a few
    Ns, at lengths that fall into six (query, target) buckets."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(n):
        short = k % 10 == 0
        tl = int(rng.integers(5, 17) if short else rng.integers(60, 97))
        tgt = "".join(rng.choice(list("ACGT"), tl))
        ql = int(rng.integers(3, 9) if short else rng.integers(40, 65))
        start = int(rng.integers(0, max(1, tl - ql)))
        read = list(tgt[start:start + ql])
        if rng.random() < 0.3 and len(read) > 10:
            i = int(rng.integers(2, len(read) - 2))
            if rng.random() < 0.5:
                del read[i:i + int(rng.integers(1, 4))]
            else:
                read[i:i] = list(rng.choice(list("ACGT"), 2))
        for i in range(len(read)):
            r = rng.random()
            if r < 0.03:
                read[i] = str(rng.choice(list("ACGT")))
            elif r < 0.035:
                read[i] = "N"
        if rng.random() < 0.2:     # unrelated pair
            read = list(rng.choice(list("ACGT"), len(read)))
        qs.append("".join(read))
        ts.append(tgt)
    return qs, ts


def _exact_fit_pairs(seed):
    """Pairs that fill their bucket exactly (48 x 64 and 64 x 96 bp),
    related and unrelated, one with Ns."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for lq, lt in ((48, 64), (64, 96), (48, 64)):
        tgt = "".join(rng.choice(list("ACGT"), lt))
        qs.append(tgt[5:5 + lq])
        ts.append(tgt)
    qs.append("".join(rng.choice(list("ACGTN"), 64)))
    ts.append("".join(rng.choice(list("ACGT"), 96)))
    return qs, ts


def _assert_jobs_equal(got, want, fields=FIELDS):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        for f in fields:
            va, vb = getattr(a, f), getattr(b, f)
            if f == "cigar" and va is not None and vb is not None:
                np.testing.assert_array_equal(va, vb, err_msg=str(k))
            else:
                assert va == vb, (k, f, va, vb)
        assert a.cigar_string == b.cigar_string, k


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
@pytest.mark.parametrize("with_tb,score_only", [
    (False, False), (True, False), (False, True)],
    ids=["ends", "traceback", "score_only"])
def test_engine_matches_jax_engine(with_tb, score_only, use_pallas):
    qs, ts = _pairs(0)
    jp = JParams()
    want = JEngine(jp, with_tb=with_tb, score_only=score_only,
                   use_pallas=use_pallas).align(qs, ts)
    got = AlignEngine(params_from_jax(jp), with_tb=with_tb,
                      score_only=score_only, device="cpu").align(qs, ts)
    fields = FIELDS
    if score_only and not use_pallas:
        # the JAX scan engine ignores score_only and reports ends too
        fields = ["score"]
    _assert_jobs_equal(got, want, fields)
    if with_tb:
        assert any(j.cigar_string.count("D") or j.cigar_string.count("I")
                   for j in got), "no gapped alignment exercised"


@pytest.mark.parametrize("cap,value,max_chunk", [
    ("MAX_PAIRS_PER_LAUNCH", 7, 7),
    # 15,360 bytes: 5 pairs of the 64x96 bucket, 10 of the 48x64 one
    ("MAX_TB_BYTES", 5 * (96 // 8) * 64 * 4, 10),
], ids=["pairs_cap", "tb_bytes_cap"])
def test_engine_n_penalty_and_chunking_do_not_change_results(
        monkeypatch, cap, value, max_chunk):
    qs, ts = _pairs(1, n=60)
    jp = JParams(n_penalty=2)
    want = JEngine(jp, with_tb=True, use_pallas=False).align(qs, ts)
    monkeypatch.setattr(dispatch, cap, value)
    eng = AlignEngine(params_from_jax(jp), with_tb=True, device="cpu")
    pending, n, _ = eng._dispatch(qs, ts)
    assert len(pending) > 6                # more chunks than buckets
    assert max(len(idxs) for idxs, _ in pending) <= max_chunk
    _assert_jobs_equal(eng._collect(pending, n), want)


def test_pack_nibbles_matches_jax_and_plain_layout():
    from genomics_tpu.runtime.dispatch import _pack_nibbles_np as jpack
    from genomics_tpu_torch.ops.cuda_align import unpack_tb_nibbles

    rng = np.random.default_rng(6)
    nibs = rng.integers(0, 16, (5, 24, 7)).astype(np.uint8)
    packed = dispatch._pack_nibbles_np(nibs)
    np.testing.assert_array_equal(packed, jpack(nibs))
    np.testing.assert_array_equal(
        unpack_tb_nibbles(torch.from_numpy(packed)).numpy(), nibs)


def test_engine_accepts_codes_and_bytes():
    qs, ts = _pairs(2, n=20)
    p = AlignmentParams()
    want = AlignEngine(p, with_tb=True, device="cpu").align(qs, ts)
    got = AlignEngine(p, with_tb=True, device="cpu").align(
        [encoding.encode4(s) for s in qs], [s.encode() for s in ts])
    _assert_jobs_equal(got, want)
    assert AlignEngine(p, device="cpu").align([], []) == []


def test_align_async_matches_align():
    qs, ts = _pairs(3, n=40)
    eng = AlignEngine(AlignmentParams(), with_tb=True, device="cpu")
    h1 = eng.align_async(qs[:20], ts[:20])
    h2 = eng.align_async(qs[20:], ts[20:])
    assert h1.done()             # CPU work is done at submission
    r1, r2 = h1.result(), h2.result()
    assert h1.result() is r1
    _assert_jobs_equal(r1 + r2, eng.align(qs, ts))


@pytest.mark.parametrize("jp", [
    JParams(),
    JParams(match=2, mismatch=3, gap_open=5, gap_extend=2, n_penalty=1),
    JParams(algo=JAlgo.SEMI_GLOBAL, head_skip=JSkip.QUERY,
            tail_skip=JSkip.BOTH, zdrop=50, end_bonus=3, band_width=16,
            second_best=True, compute_start=True, with_traceback=True),
], ids=["defaults", "scores", "every_field"])
def test_params_from_jax(jp):
    p = params_from_jax(jp)
    for f in dataclasses.fields(JParams):
        a, b = getattr(p, f.name), getattr(jp, f.name)
        if f.name in ("algo", "head_skip", "tail_skip"):
            assert a.value == b.value and a.name == b.name, f.name
        else:
            assert a == b, f.name
    assert p.gap_oe == jp.gap_oe
    assert [f.name for f in dataclasses.fields(AlignmentParams)] == \
        [f.name for f in dataclasses.fields(JParams)]
    assert AlignmentParams() == params_from_jax(JParams())
    assert isinstance(p.head_skip, SemiGlobalSkip)


def test_encoding_parity():
    rng = np.random.default_rng(4)
    seq = "".join(rng.choice(list("ACGTNacgtnRYKM"), 300))
    codes = encoding.encode4(seq)
    np.testing.assert_array_equal(codes, jenc.encode4(seq))
    np.testing.assert_array_equal(encoding.encode4(seq.encode()),
                                  jenc.encode4(seq.encode()))
    assert encoding.decode4(codes) == jenc.decode4(codes)
    np.testing.assert_array_equal(encoding.complement4(codes),
                                  jenc.complement4(codes))
    np.testing.assert_array_equal(encoding.reverse_complement4(codes),
                                  jenc.reverse_complement4(codes))
    assert (encoding.A4, encoding.C4, encoding.G4, encoding.T4,
            encoding.N4) == (jenc.A4, jenc.C4, jenc.G4, jenc.T4, jenc.N4)


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        AlignEngine(AlignmentParams(), device="cuda")


@pytest.mark.parametrize("algo", list(AlgoType), ids=lambda a: a.name)
def test_engine_defaults_to_the_card(algo):
    """No device given means the card: without one the engine raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert AlignEngine(AlignmentParams(algo=algo)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        AlignEngine(AlignmentParams(algo=algo))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
@pytest.mark.parametrize("with_tb", [False, True], ids=["ends", "traceback"])
@pytest.mark.parametrize("jp", [
    JParams(algo=JAlgo.GLOBAL),
    JParams(algo=JAlgo.GLOBAL, n_penalty=2, match=2),
], ids=["defaults", "n_penalty"])
def test_global_engine_matches_jax_engine(jp, with_tb, use_pallas):
    qs, ts = _pairs(7, n=80)
    eq, et = _exact_fit_pairs(8)
    qs, ts = qs + eq, ts + et
    want = JEngine(jp, with_tb=with_tb, use_pallas=use_pallas).align(qs, ts)
    got = AlignEngine(params_from_jax(jp), with_tb=with_tb,
                      device="cpu").align(qs, ts)
    _assert_jobs_equal(got, want)
    if with_tb:
        assert all(j.cigar_string for j in got)


SKIPS = [JSkip.NONE, JSkip.QUERY, JSkip.TARGET, JSkip.BOTH]


@pytest.mark.parametrize("head,tail", list(itertools.product(SKIPS, SKIPS)),
                         ids=lambda s: s.name)
def test_semiglobal_engine_ends_match_jax_engine(head, tail):
    qs, ts = _pairs(9, n=80)
    eq, et = _exact_fit_pairs(10)
    qs, ts = qs + eq, ts + et
    jp = JParams(algo=JAlgo.SEMI_GLOBAL, n_penalty=1 if head.value else None)
    want = JEngine(jp, head=head, tail=tail, use_pallas=False).align(qs, ts)
    got = AlignEngine(params_from_jax(jp), head=SemiGlobalSkip(head.value),
                      tail=SemiGlobalSkip(tail.value),
                      device="cpu").align(qs, ts)
    _assert_jobs_equal(got, want)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
@pytest.mark.parametrize("skip", SKIPS, ids=lambda s: s.name)
def test_semiglobal_engine_traceback_matches_jax_engine(skip, use_pallas):
    """HEAD == TAIL, the four combinations the JAX package's runtime test
    decodes, with exact-fit pairs and Ns."""
    qs, ts = _pairs(11, n=60)
    eq, et = _exact_fit_pairs(12)
    qs, ts = qs + eq, ts + et
    jp = JParams(algo=JAlgo.SEMI_GLOBAL)
    want = JEngine(jp, with_tb=True, head=skip, tail=skip,
                   use_pallas=use_pallas).align(qs, ts)
    got = AlignEngine(params_from_jax(jp), with_tb=True,
                      head=SemiGlobalSkip(skip.value),
                      tail=SemiGlobalSkip(skip.value),
                      device="cpu").align(qs, ts)
    _assert_jobs_equal(got, want)


def test_semiglobal_glocal_hand_case():
    """tests/test_runtime.py's hand case: the read inside its target."""
    eng = AlignEngine(AlignmentParams(algo=AlgoType.SEMI_GLOBAL),
                      with_tb=True, head=SemiGlobalSkip.TARGET,
                      tail=SemiGlobalSkip.TARGET, device="cpu")
    res = eng.align(["ACGT"], ["TTACGTTT"])[0]
    assert res.cigar_string == "4M"
    assert res.query_start == 0 and res.target_start == 2
    # the reference quirk: qend keeps its tlen init without a query tail
    assert res.query_end == 8 and res.target_end == 5
    # the skips come from head/tail, not from the params (as in the JAX
    # engine)
    p = AlignmentParams(algo=AlgoType.SEMI_GLOBAL,
                        head_skip=SemiGlobalSkip.TARGET,
                        tail_skip=SemiGlobalSkip.TARGET)
    assert AlignEngine(p, with_tb=True, device="cpu").align(
        ["ACGT"], ["TTACGTTT"])[0].cigar_string != "4M"


@pytest.mark.parametrize("jp,with_tb", [
    (JParams(compute_start=True), True),
    (JParams(algo=JAlgo.SEMI_GLOBAL, compute_start=True), True),
    (JParams(algo=JAlgo.GLOBAL, compute_start=True), False),
    (JParams(algo=JAlgo.GLOBAL, compute_start=True), True),
    (JParams(algo=JAlgo.GLOBAL, second_best=True), True),
    (JParams(algo=JAlgo.SEMI_GLOBAL, second_best=True), False),
], ids=["local_start_tb", "semiglobal_start_tb", "global_start",
        "global_start_tb", "global_second", "semiglobal_second"])
def test_start_and_second_best_gating_matches_jax_engine(jp, with_tb):
    """compute_start with traceback takes the walk's starts; GLOBAL
    ignores compute_start, and every algo but LOCAL ignores second_best,
    as genomics_tpu/runtime/dispatch.py:283-285 and :345 do."""
    qs, ts = _pairs(13, n=60)
    head = tail = JSkip.TARGET
    want = JEngine(jp, with_tb=with_tb, head=head, tail=tail,
                   use_pallas=False).align(qs, ts)
    got = AlignEngine(params_from_jax(jp), with_tb=with_tb,
                      head=SemiGlobalSkip.TARGET,
                      tail=SemiGlobalSkip.TARGET, device="cpu").align(qs, ts)
    _assert_jobs_equal(got, want)


def _one_bucket_pairs(seed, n=48):
    """Reads of 25-32 bp cut from 33-48 bp targets (one 32 x 48 bucket),
    with substitutions, a few Ns and some unrelated pairs."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(n):
        tgt = "".join(rng.choice(list("ACGT"), int(rng.integers(33, 49))))
        start = int(rng.integers(0, len(tgt) - 32))
        read = list(tgt[start:start + int(rng.integers(25, 33))])
        for i in range(len(read)):
            if rng.random() < 0.06:
                read[i] = str(rng.choice(list("ACGTN")))
        if k % 5 == 0:
            read = list(rng.choice(list("ACGT"), len(read)))
        qs.append("".join(read))
        ts.append(tgt)
    return qs, ts


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
@pytest.mark.parametrize("jp,with_tb,score_only,head,tail", [
    (JParams(compute_start=True), False, False, JSkip.NONE, JSkip.NONE),
    (JParams(algo=JAlgo.SEMI_GLOBAL, compute_start=True), False, False,
     JSkip.TARGET, JSkip.TARGET),
    (JParams(algo=JAlgo.SEMI_GLOBAL, compute_start=True, n_penalty=1), False,
     False, JSkip.NONE, JSkip.BOTH),
    (JParams(algo=JAlgo.SEMI_GLOBAL, compute_start=True), False, False,
     JSkip.QUERY, JSkip.QUERY),
    (JParams(algo=JAlgo.SEMI_GLOBAL, compute_start=True), False, False,
     JSkip.BOTH, JSkip.NONE),
    (JParams(second_best=True), False, False, JSkip.NONE, JSkip.NONE),
    (JParams(second_best=True), True, False, JSkip.NONE, JSkip.NONE),
    (JParams(second_best=True, n_penalty=2), False, True, JSkip.NONE,
     JSkip.NONE),
    (JParams(second_best=True, compute_start=True), False, False,
     JSkip.NONE, JSkip.NONE),
], ids=["start", "semiglobal_start", "semiglobal_start_none_both",
        "semiglobal_start_query_query", "semiglobal_start_both_none",
        "second_best", "second_best_tb", "second_best_score_only",
        "second_best_and_start"])
def test_start_and_second_best_match_jax_engine(jp, with_tb, score_only,
                                                head, tail, use_pallas):
    """compute_start without traceback (the reverse start passes) and
    LOCAL second_best, every field; the first four cases raised before
    the start passes and the second-best kernel were ported."""
    qs, ts = _pairs(14, n=40)
    if use_pallas and jp.second_best:
        # the JAX engine pads each bucket to its second-best kernel's
        # 1024-pair floor, so interpret mode pays per bucket: one bucket
        qs, ts = _one_bucket_pairs(15)
    want = JEngine(jp, with_tb=with_tb, score_only=score_only, head=head,
                   tail=tail, use_pallas=use_pallas).align(qs, ts)
    got = AlignEngine(params_from_jax(jp), with_tb=with_tb,
                      score_only=score_only, head=SemiGlobalSkip(head.value),
                      tail=SemiGlobalSkip(tail.value),
                      device="cpu").align(qs, ts)
    _assert_jobs_equal(got, want)
    if jp.compute_start and not with_tb:
        assert any(j.query_start or j.target_start for j in got)
    if jp.second_best:
        assert any(j.score_second for j in got)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
def test_score_only_start_reports_no_ends(use_pallas):
    """LOCAL score-only with compute_start: the Pallas engine's score
    kernel reports ends of 0 and a full forward pass feeds the starts;
    the JAX scan engine ignores score_only.  The port gives the Pallas
    engine's fields."""
    qs, ts = _pairs(16, n=40)
    jp = JParams(compute_start=True)
    want = JEngine(jp, score_only=True, use_pallas=use_pallas).align(qs, ts)
    got = AlignEngine(params_from_jax(jp), score_only=True,
                      device="cpu").align(qs, ts)
    fields = ["score", "query_start", "target_start"]
    if use_pallas:
        fields += ["query_end", "target_end"]
    _assert_jobs_equal(got, want, fields)
    assert all(j.query_end == j.target_end == 0 for j in got)


def test_cpu_engine_launches_no_kernel():
    before = dict(cuda_align.LAUNCHES), dict(tb_walk.LAUNCHES)
    qs, ts = _pairs(5, n=10)
    for algo in AlgoType:
        p = AlignmentParams(algo=algo)
        AlignEngine(p, with_tb=True, device="cpu").align(qs, ts)
        AlignEngine(p, score_only=True, device="cpu").align(qs, ts)
    assert (cuda_align.LAUNCHES, tb_walk.LAUNCHES) == before


def _extension_pairs(seed, n=48):
    """Seed-extension-shaped pairs in two buckets (queries of 17-32 bp
    against targets of 33-48): each query a mutated prefix of its target,
    with substitutions, a 1-2 bp indel, a few Ns and some unrelated
    queries; seed scores h0 of 0-59, with a few 0."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(n):
        tgt = "".join(rng.choice(list("ACGT"), int(rng.integers(33, 49))))
        read = list(tgt[:int(rng.integers(17, 33))])
        if k % 4 == 1:
            i = int(rng.integers(3, len(read) - 3))
            read[i:i + int(rng.integers(1, 3))] = []
        for i in range(len(read)):
            if rng.random() < 0.05:
                read[i] = str(rng.choice(list("ACGTN")))
        if k % 6 == 0:
            read = list(rng.choice(list("ACGT"), len(read)))
        qs.append("".join(read))
        ts.append(tgt)
    h0 = rng.integers(0, 60, n)
    h0[::7] = 0
    return qs, ts, h0


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
@pytest.mark.parametrize("algo,band,with_tb,score_only", [
    ("KSW", 4, False, False),
    ("KSW", 4, True, False),
    ("KSW", 4, False, True),
    ("BANDED", 1, False, False),
    ("BANDED", 4, False, False),
    ("BANDED", 4, True, False),
    ("BANDED", 1, False, True),
], ids=["ksw", "ksw_with_tb", "ksw_score_only", "banded_1", "banded_4",
        "banded_with_tb", "banded_score_only"])
def test_ksw_and_banded_engine_match_jax_engine(algo, band, with_tb,
                                                score_only, use_pallas):
    """Every field, with h0 per pair (KSW) and the band (BANDED).  KSW and
    BANDED give no CIGAR under with_tb, as the JAX engine does; score-only
    reports ends of 0, the JAX Pallas engine's fields (its scan engine
    ignores score_only).  The buckets hold under 1,024 pairs, so the JAX
    BANDED score-only path is its lanes kernel, which C7 does not touch."""
    qs, ts, h0 = _extension_pairs(17)
    jp = JParams(algo=JAlgo[algo])
    want = JEngine(jp, with_tb=with_tb, score_only=score_only,
                   band_width_tiles=band, use_pallas=use_pallas).align(
        qs, ts, h0=h0)
    eng = AlignEngine(params_from_jax(jp), with_tb=with_tb,
                      score_only=score_only, band_width_tiles=band,
                      device="cpu")
    got = eng.align(qs, ts, h0=h0)
    fields = ["score"] if score_only and not use_pallas else FIELDS
    _assert_jobs_equal(got, want, fields)
    assert all(j.cigar is None for j in got)
    if score_only:
        assert all(j.query_end == j.target_end == 0 for j in got)
    assert len({j.score for j in got}) > 5


@pytest.mark.parametrize("algo", ["KSW", "BANDED"])
def test_ksw_and_banded_align_async_matches_align(algo):
    qs, ts, h0 = _extension_pairs(18, n=24)
    eng = AlignEngine(AlignmentParams(algo=AlgoType[algo]), device="cpu")
    h1 = eng.align_async(qs[:10], ts[:10], h0=h0[:10])
    h2 = eng.align_async(qs[10:], ts[10:], h0=h0[10:])
    assert h1.done()
    _assert_jobs_equal(h1.result() + h2.result(), eng.align(qs, ts, h0=h0))


def test_ksw_h0_defaults_to_zero_and_is_checked():
    qs, ts, _ = _extension_pairs(19, n=12)
    eng = AlignEngine(AlignmentParams(algo=AlgoType.KSW), device="cpu")
    _assert_jobs_equal(eng.align(qs, ts), eng.align(qs, ts, h0=[0] * 12))
    with pytest.raises(ValueError, match="h0"):
        eng.align(qs, ts, h0=[1, 2])
