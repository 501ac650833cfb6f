"""Parity of the port's traceback walk and CIGAR encode with the JAX
package: the plain walk against `tb_walk.tb_walk_device` (op stream,
qstart, tstart), `rle_cigar` against the native decoder, and the GLOBAL
and SEMI_GLOBAL walks + host pads against the native decoder and the
golds."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu.core import golds as jgolds
from genomics_tpu.core.scoring import AlgoType as JAlgo
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.ops import scan_align as jscan
from genomics_tpu.ops import tb_walk as jwalk
from genomics_tpu.runtime import native
from genomics_tpu.runtime.dispatch import _pack_nibbles_np
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.core.scoring import (
    AlgoType,
    SemiGlobalSkip,
    params_from_jax,
)
from genomics_tpu_torch.ops import cuda_align, tb_walk
from genomics_tpu_torch.ops.scan_align import (
    global_align_batch,
    local_align_batch,
    semiglobal_align_batch,
)
from genomics_tpu_torch.runtime.dispatch import walk_start

ACGT = np.array([1, 3, 7, 4], np.uint8)
N4 = 14


def _related_batch(rng, B, Lq, Lt, n_rate):
    """Queries cut from their targets with substitutions and indels, so
    the walks cross gaps, plus N padding and in-sequence Ns."""
    q = np.full((B, Lq), N4, np.uint8)
    t = np.full((B, Lt), N4, np.uint8)
    for b in range(B):
        tl = int(rng.integers(Lt // 2, Lt + 1))
        tgt = ACGT[rng.integers(0, 4, tl)]
        start = int(rng.integers(0, max(1, tl // 3)))
        read = list(tgt[start:start + Lq])
        for _ in range(int(rng.integers(0, 3))):
            if len(read) > 4:
                k = int(rng.integers(1, len(read) - 1))
                if rng.random() < 0.5:
                    del read[k:k + int(rng.integers(1, 3))]
                else:
                    read[k:k] = list(ACGT[rng.integers(0, 4, 2)])
        read = np.array(read[:Lq], np.uint8)
        sub = rng.random(len(read)) < 0.05
        read[sub] = ACGT[rng.integers(0, 4, sub.sum())]
        read[rng.random(len(read)) < n_rate] = N4
        q[b, :len(read)] = read
        t[b, :tl] = tgt
    return q, t


@pytest.mark.parametrize("B,Lq,Lt,jp", [
    (96, 32, 40, JParams()),
    (64, 24, 48, JParams(match=2, mismatch=3, gap_open=4, gap_extend=2)),
], ids=["defaults", "other_scores"])
def test_plain_walk_matches_tb_walk_device(B, Lq, Lt, jp):
    rng = np.random.default_rng(B)
    q, t = _related_batch(rng, B, Lq, Lt, n_rate=0.03)
    p = params_from_jax(jp)
    res = local_align_batch(torch.from_numpy(q), torch.from_numpy(t), p,
                            with_tb=True)
    sqb = res.tb.numpy()
    ops, qst, tst = jwalk.tb_walk_device(
        jnp.asarray(sqb), jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32),
        jnp.asarray(res.score.numpy()), jnp.asarray(res.query_end.numpy()),
        jnp.asarray(res.target_end.numpy()), jp, algo="local")
    got_ops, got_qs, got_ts = tb_walk.tb_walk(
        res.tb, res.score, res.query_end, res.target_end, p)
    assert got_ops.dtype == torch.uint8 and got_ops.shape == (Lq + Lt, B)
    np.testing.assert_array_equal(got_ops.numpy(), np.asarray(ops))
    np.testing.assert_array_equal(got_qs.numpy(), np.asarray(qst))
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(tst))


def test_walk_and_rle_match_native_decoder():
    """The pattern of test_intertask_kernels.py's device-walk test, with
    the port's walk and encode on the JAX scan engine's nibbles."""
    jp = JParams()
    p = params_from_jax(jp)
    rng = np.random.default_rng(9)
    B, Lq, Lt = 256, 32, 40
    q, t = _related_batch(rng, B, Lq, Lt, n_rate=0.02)
    res = jscan.local_align_batch(jnp.asarray(q), jnp.asarray(t), jp,
                                  with_tb=True)
    packed = _pack_nibbles_np(np.asarray(res.tb))       # [B, Lt8, Lq]
    score = np.array(res.score)
    qend = np.array(res.query_end)
    tend = np.array(res.target_end)
    qlen = np.full(B, Lq, np.int32)
    tlen = np.full(B, Lt, np.int32)
    want_cig, want_n, want_qs, want_ts = native.decode_tb_batch(
        packed, qlen, tlen, "local", jp, score=score, qend=qend, tend=tend)
    sqb = torch.from_numpy(np.ascontiguousarray(packed.transpose(1, 2, 0)))
    ops, qst, tst = tb_walk.tb_walk(
        sqb, torch.from_numpy(score), torch.from_numpy(qend),
        torch.from_numpy(tend), p)
    got_cig, got_n = tb_walk.rle_cigar(ops.numpy(), max_ops=want_cig.shape[1])
    np.testing.assert_array_equal(got_n, want_n)
    for b in range(B):
        np.testing.assert_array_equal(
            got_cig[b, :got_n[b]], want_cig[b, :want_n[b]], err_msg=str(b))
    np.testing.assert_array_equal(qst.numpy(), want_qs)
    np.testing.assert_array_equal(tst.numpy(), want_ts)


def test_rle_cigar_matches_jax_rle():
    """Byte-identical encode, 63-run splitting and empty walks included."""
    rng = np.random.default_rng(1)
    T, B = 200, 40
    runs = rng.integers(0, 4, (T, B)).astype(np.uint8)
    ops = np.repeat(runs[: T // 50], 50, axis=0)   # runs of 50..200
    ops[:, ::3] = runs[:T, ::3]                    # short runs elsewhere
    stop = rng.integers(0, T + 1, B)
    for b in range(B):
        ops[stop[b]:, b] = 255
    got = tb_walk.rle_cigar(ops)
    want = jwalk.rle_cigar(ops)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cpu_walk_counts_no_launch_and_checks_inputs():
    p = params_from_jax(JParams())
    sqb = torch.zeros((2, 8, 5), dtype=torch.int32)
    z = torch.zeros(5, dtype=torch.int32)
    before = dict(tb_walk.LAUNCHES)
    ops, qs, ts = tb_walk.tb_walk(sqb, z, z, z, p)
    assert ops.shape == (24, 5)
    ops, qs, ts = tb_walk.tb_walk(sqb, z, z + 8, z + 16, p, "global")
    assert ops.shape == (24, 5)
    assert tb_walk.LAUNCHES == before
    with pytest.raises(ValueError):
        tb_walk.tb_walk(sqb.to(torch.int64), z, z, z, p)
    with pytest.raises(ValueError):
        tb_walk.tb_walk(sqb, z[:4], z, z, p)
    with pytest.raises(ValueError, match="algo"):
        tb_walk.tb_walk(sqb, z, z, z, p, "banded")


def _walk_batch(rng, B, Lq, Lt):
    """(q, t, qlen, tlen): related pairs with indels (_related_batch);
    pair 0 fills the bucket exactly, pair 1 is a 5 bp read against its
    whole target (a leading D pad past 63 for GLOBAL), pair 2 a 6 bp
    target; then in-sequence Ns."""
    q, t = _related_batch(rng, B, Lq, Lt, n_rate=0.0)
    ql = (q != N4).sum(axis=1).astype(np.int32)
    tl = (t != N4).sum(axis=1).astype(np.int32)
    q[0] = ACGT[rng.integers(0, 4, Lq)]
    t[0] = ACGT[rng.integers(0, 4, Lt)]
    q[1], t[2] = N4, N4
    q[1, :5] = t[1, 40:45]
    t[2, :6] = q[2, 10:16]
    ql[:2] = Lq, 5
    tl[0], tl[2] = Lt, 6
    for codes, lens in ((q, ql), (t, tl)):
        inside = np.arange(codes.shape[1]) < lens[:, None]
        codes[inside & (rng.random(codes.shape) < 0.02)] = N4
    return q, t, ql, tl


@pytest.mark.parametrize("algo,head,tail", [
    ("global", None, None),
    ("semiglobal", SemiGlobalSkip.NONE, SemiGlobalSkip.NONE),
    ("semiglobal", SemiGlobalSkip.TARGET, SemiGlobalSkip.TARGET),
    ("semiglobal", SemiGlobalSkip.QUERY, SemiGlobalSkip.QUERY),
    ("semiglobal", SemiGlobalSkip.BOTH, SemiGlobalSkip.BOTH),
], ids=["global", "semiglobal_none", "semiglobal_target",
        "semiglobal_query", "semiglobal_both"])
def test_global_walks_match_native_decoder(algo, head, tail):
    """The walk's GLOBAL and SEMI_GLOBAL modes and the host pads against
    native.decode_tb_batch (CIGAR bytes, n_ops, qstart, tstart) and both
    golds' decode_tb (bytes, n_ops, and the SEMI_GLOBAL starts)."""
    rng = np.random.default_rng(21)
    B, Lq, Lt = 64, 32, 96
    q, t, ql, tl = _walk_batch(rng, B, Lq, Lt)
    qt, tt, qlt, tlt = (torch.from_numpy(a) for a in (q, t, ql, tl))
    if algo == "global":
        jp = JParams(algo=JAlgo.GLOBAL)
        p = params_from_jax(jp)
        res = global_align_batch(qt, tt, qlt, tlt, p, with_tb=True)
        i0, j0 = tlt, qlt
        head_q = head_t = False
    else:
        jp = JParams(algo=JAlgo.SEMI_GLOBAL)
        p = params_from_jax(jp)
        res = semiglobal_align_batch(qt, tt, qlt, tlt, p, head=head,
                                     tail=tail, with_tb=True)
        i0, j0 = walk_start(AlgoType.SEMI_GLOBAL, tail, res, qlt, tlt)
        head_q = bool(head & SemiGlobalSkip.QUERY)
        head_t = bool(head & SemiGlobalSkip.TARGET)
    ops, qfin, tfin = tb_walk.tb_walk(res.tb, res.score, j0, i0, p, algo)
    got_cig, got_n, got_qs, got_ts = tb_walk.cigars_from_walk(
        ops.numpy(), qfin.numpy(), tfin.numpy(), algo, head_q, head_t)
    want_cig, want_n, want_qs, want_ts = native.decode_tb_batch(
        res.tb.numpy(), ql, tl, algo, jp, score=res.score.numpy(),
        qend=j0.numpy(), tend=i0.numpy(), head_q=head_q, head_t=head_t,
        layout="sqb")
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got_qs, want_qs)
    np.testing.assert_array_equal(got_ts, want_ts)
    assert (ops[-1] == tb_walk.STOP).all()     # no walk was cut short
    dirs = cuda_align.unpack_tb_nibbles(res.tb.permute(2, 0, 1)).numpy()
    long_pad = False
    for b in range(B):
        np.testing.assert_array_equal(got_cig[b, :got_n[b]],
                                      want_cig[b, :want_n[b]], err_msg=str(b))
        long_pad |= bool((got_cig[b, :got_n[b]] >> 2 == 63).any())
        kw = dict(score=int(res.score[b]), query_end=int(j0[b]),
                  target_end=int(i0[b]), head_q=head_q, head_t=head_t)
        mine = golds.decode_tb(dirs[b], int(ql[b]), int(tl[b]), algo, p, **kw)
        theirs = jgolds.decode_tb(dirs[b], int(ql[b]), int(tl[b]), algo, jp,
                                  **kw)
        for k in ("n_ops", "query_start", "target_start"):
            assert mine[k] == theirs[k], (b, k)
        np.testing.assert_array_equal(mine["cigar"], theirs["cigar"])
        np.testing.assert_array_equal(mine["cigar"], got_cig[b, :got_n[b]])
        if algo == "semiglobal":
            # the golds report GLOBAL starts unpadded; the engines (and
            # native/cigar.cpp) report 0
            assert (mine["query_start"], mine["target_start"]) == (
                got_qs[b], got_ts[b]), b
    if algo == "global":
        assert long_pad, "no pad run reached 63"


def _exact_fit_cube(Lq, Lt):
    """[1, Lt, Lq] nibbles on which GLOBAL's exact-fit walk (from
    (Lt, Lq), outside the cube) is the longest it can be: M, a D chain
    up column Lq-1, the M that ends it, an I chain along row 0."""
    nib = np.zeros((1, Lt, Lq), np.uint8)
    nib[0, 2:, Lq - 1] = 2 | 4       # D, extend
    nib[0, 0, :Lq - 1] = 3 | 8       # I, extend
    return nib


@pytest.mark.parametrize("case", ["exact_fit", "semiglobal_row_qlen"])
def test_walks_from_outside_the_cube_fit_the_stream(case):
    """A walk that starts outside the cube reads 0 (M) until it is
    inside, so Lq + Lt steps hold it: GLOBAL's exact fit (tlen == Lt,
    qlen == Lq, start (Lt, Lq)) at its longest, Lq + Lt - 1 steps, and
    SEMI_GLOBAL's TAIL_T quirk start row qlen past Lt."""
    jp = JParams(algo=JAlgo.GLOBAL if case == "exact_fit"
                 else JAlgo.SEMI_GLOBAL)
    p = params_from_jax(jp)
    if case == "exact_fit":
        Lq, Lt = 8, 16
        nib = _exact_fit_cube(Lq, Lt)
        i0, j0, ql, algo = Lt, Lq, Lq, "global"
    else:
        Lq, Lt = 24, 8
        nib = np.random.default_rng(2).integers(0, 16, (1, Lt, Lq))
        nib = nib.astype(np.uint8)
        i0, j0, ql, algo = 20, 19, 20, "semiglobal"
    packed = _pack_nibbles_np(nib)                       # [1, Lt8, Lq]
    sqb = torch.from_numpy(np.ascontiguousarray(packed.transpose(1, 2, 0)))
    one = torch.ones(1, dtype=torch.int32)
    ops, qfin, tfin = tb_walk.tb_walk(sqb, one * 0, one * j0, one * i0, p,
                                      algo)
    n_steps = int((ops[:, 0] != tb_walk.STOP).sum())
    assert ops.shape[0] == Lq + Lt and n_steps < Lq + Lt
    cig, n, qs, ts = tb_walk.cigars_from_walk(
        ops.numpy(), qfin.numpy(), tfin.numpy(), algo)
    want = native.decode_tb_batch(
        packed, np.array([ql], np.int32), np.array([Lt], np.int32), algo,
        jp, qend=np.array([j0], np.int32), tend=np.array([i0], np.int32))
    np.testing.assert_array_equal(cig[0, :n[0]], want[0][0, :want[1][0]])
    assert (n[0], qs[0], ts[0]) == (want[1][0], want[2][0], want[3][0])
    if case == "exact_fit":
        assert n_steps == Lq + Lt - 1
        assert golds.cigar_to_string(cig[0, :n[0]]) == "1D7I1M14D1M"
    else:
        assert (ops[:i0 - Lt + 1, 0] == 0).all()        # diagonal outside
