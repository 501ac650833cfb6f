"""Parity of the port's KSW seed extension and BANDED local alignment
with the JAX package: the golds, the JAX scan engine, the four Pallas
kernels in interpret mode (lanes at B=128, inter-task at B=1024) and the
score-only fast paths.  Every comparison is integer-equal.

The JAX package's BANDED score-only path with has_n=False scores the N4
padding as matches (ROADMAP C7); the port remaps the padding first, so
`test_banded_scores_without_n_keep_the_padding_out` shows the JAX path
differing where the port equals the full pass and the gold."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu.core import golds as jgolds
from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.ops import pallas_ksw, scan_align as jscan
from genomics_tpu_torch.core import golds
from genomics_tpu_torch.core.scoring import params_from_jax
from genomics_tpu_torch.ops import cuda_align
from genomics_tpu_torch.ops.scan_align import (
    banded_align_batch,
    ksw_align_batch,
)

ACGT = np.array([1, 3, 7, 4], np.uint8)  # 4-bit codes of A, C, G, T
N4 = 14
JP_OTHER = JParams(match=2, mismatch=3, gap_open=5, gap_extend=2, n_penalty=1)
# bands of 1, 2 and 4 tiles and one wider than any query here
BANDS = [1, 2, 4, 9]


def _batch(seed, B, Lq, Lt, n_rate=0.02):
    """(q, t, qlen, tlen, h0) as numpy: half the pairs related (the query
    a mutated prefix of the target, as a seed extension sees them),
    ragged N4-padded lengths with in-sequence Ns at n_rate, and per-pair
    seed scores.  The edge cases come first: h0 = 0, h0 above
    qlen * match, qlen < 8, tlen < qlen, a query much longer than its
    target, and pairs that fill the bucket."""
    rng = np.random.default_rng(seed)
    q = ACGT[rng.integers(0, 4, (B, Lq))]
    t = ACGT[rng.integers(0, 4, (B, Lt))]
    k = min(Lq, Lt)
    q[::2, :k] = t[::2, :k]
    flip = rng.random(q.shape) < 0.08
    q[flip] = ACGT[rng.integers(0, 4, int(flip.sum()))]
    if n_rate:
        q[rng.random(q.shape) < n_rate] = N4
        t[rng.random(t.shape) < n_rate] = N4
    ql = rng.integers(1, Lq + 1, B).astype(np.int32)
    tl = rng.integers(1, Lt + 1, B).astype(np.int32)
    h0 = rng.integers(0, 60, B).astype(np.int32)
    e = max(1, B // 16)
    h0[:e] = 0
    h0[e:2 * e] = ql[e:2 * e] + rng.integers(1, 30, e)   # match = 1
    ql[2 * e:3 * e] = rng.integers(1, 8, e)
    tl[3 * e:4 * e] = np.minimum(tl[3 * e:4 * e], ql[3 * e:4 * e] // 2 + 1)
    ql[4 * e:5 * e], tl[4 * e:5 * e] = Lq, rng.integers(1, 9, e)
    ql[5 * e:6 * e], tl[5 * e:6 * e] = Lq, Lt
    for b in range(B):
        q[b, ql[b]:] = N4
        t[b, tl[b]:] = N4
    return q, t, ql, tl, h0


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_result(got, want):
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _gold_ksw(q, t, ql, tl, h0, p, idx):
    return [golds.ksw_align(q[b, :ql[b]], t[b, :tl[b]], p, int(h0[b]))
            for b in idx]


def _gold_banded(q, t, ql, tl, p, band, idx):
    return [golds.banded_align(q[b, :ql[b]], t[b, :tl[b]], p, band)
            for b in idx]


def _assert_gold(got, gold, idx):
    for b, g in zip(idx, gold):
        assert (int(got.score[b]), int(got.query_end[b]),
                int(got.target_end[b])) == (
            g["score"], g["query_end"], g["target_end"]), (b, g)


@pytest.mark.parametrize("jp", [JParams(), JP_OTHER], ids=["defaults", "other"])
@pytest.mark.parametrize("algo", ["ksw", "banded"])
def test_golds_match_jax_golds(algo, jp):
    q, t, ql, tl, h0 = _batch(1, 64, 40, 32)
    p = params_from_jax(jp)
    for b in range(64):
        qs, ts = q[b, :ql[b]], t[b, :tl[b]]
        if algo == "ksw":
            assert golds.ksw_align(qs, ts, p, int(h0[b])) == \
                jgolds.ksw_align(qs, ts, jp, int(h0[b])), b
        else:
            for band in BANDS:
                assert golds.banded_align(qs, ts, p, band) == \
                    jgolds.banded_align(qs, ts, jp, band), (b, band)


@pytest.mark.parametrize("jp", [JParams(), JP_OTHER], ids=["defaults", "other"])
def test_ksw_plain_matches_scan_engine_and_gold(jp):
    q, t, ql, tl, h0 = _batch(2, 96, 40, 48)
    p = params_from_jax(jp)
    want = jscan.ksw_align_batch(*map(jnp.asarray, (q, t, ql, tl, h0)), jp)
    got = ksw_align_batch(*_torch(q, t, ql, tl, h0), p)
    _assert_result(got, want)
    idx = range(0, 96, 3)
    _assert_gold(got, _gold_ksw(q, t, ql, tl, h0, p, idx), idx)


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("jp", [JParams(), JP_OTHER], ids=["defaults", "other"])
def test_banded_plain_matches_scan_engine_and_gold(jp, band):
    q, t, ql, tl, _ = _batch(3, 96, 40, 48)
    p = params_from_jax(jp)
    want = jscan.banded_align_batch(*map(jnp.asarray, (q, t, ql, tl)), jp,
                                    band_width_tiles=band)
    got = banded_align_batch(*_torch(q, t, ql, tl), p, band)
    _assert_result(got, want)
    idx = range(0, 96, 3)
    _assert_gold(got, _gold_banded(q, t, ql, tl, p, band, idx), idx)


@pytest.mark.parametrize("B", [128, 1024], ids=["lanes", "intertask"])
def test_ksw_plain_matches_pallas_kernels(B):
    """B=128 reaches `_ksw_kernel`, B=1024 `_ksw_kernel_intertask`, in
    interpret mode."""
    q, t, ql, tl, h0 = _batch(4, B, 32, 40)
    jp = JParams()
    kernel = (pallas_ksw._ksw_align_lanes if B == 128
              else pallas_ksw._ksw_align_intertask)
    want = kernel(*map(jnp.asarray, (q, t, ql, tl, h0)), jp)
    got = cuda_align.ksw_align(*_torch(q, t, ql, tl, h0), params_from_jax(jp))
    _assert_result(got, want)


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("B", [128, 1024], ids=["lanes", "intertask"])
def test_banded_plain_matches_pallas_kernels(B, band):
    """B=128 reaches `_banded_kernel`, B=1024 `_banded_kernel_intertask`,
    in interpret mode, at bands of 1, 2, 4 tiles and one wider than the
    query."""
    Lq, Lt = (16, 24) if B == 1024 else (32, 40)
    q, t, ql, tl, _ = _batch(5, B, Lq, Lt)
    jp = JParams()
    kernel = (pallas_ksw._banded_align_lanes if B == 128
              else pallas_ksw._banded_align_intertask)
    want = kernel(*map(jnp.asarray, (q, t, ql, tl)), jp, band)
    got = cuda_align.banded_align(*_torch(q, t, ql, tl), params_from_jax(jp),
                                  band)
    _assert_result(got, want)


@pytest.mark.parametrize("has_n", [True, False], ids=["has_n", "no_n"])
def test_ksw_score_only_matches_pallas_fast_path(has_n):
    """`ksw_align_scores` equals the full pass and the inter-task
    score-only kernel, with and without the no-N contract (the KSW window
    never reads the padding, so the JAX path is right here too)."""
    q, t, ql, tl, h0 = _batch(6, 1024, 24, 32, n_rate=0.02 if has_n else 0.0)
    jp = JParams()
    p = params_from_jax(jp)
    want = pallas_ksw.ksw_align_scores_tpu(
        *map(jnp.asarray, (q, t, ql, tl, h0)), jp, has_n=has_n)
    args = _torch(q, t, ql, tl, h0)
    got = cuda_align.ksw_align_scores(*args, p, has_n=has_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  ksw_align_batch(*args, p).score.numpy())


@pytest.mark.parametrize("band", [1, 4])
def test_banded_score_only_matches_pallas_fast_path(band):
    """With in-sequence Ns (has_n=True) the inter-task score-only kernel
    is right, and `banded_align_scores` equals it and the full pass."""
    q, t, ql, tl, _ = _batch(7, 1024, 16, 24, n_rate=0.03)
    jp = JParams()
    p = params_from_jax(jp)
    want = pallas_ksw.banded_align_scores_tpu(
        *map(jnp.asarray, (q, t, ql, tl)), jp, band, has_n=True)
    args = _torch(q, t, ql, tl)
    for has_n in (True, None):
        got = cuda_align.banded_align_scores(*args, p, band, has_n=has_n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), banded_align_batch(*args, p, band).score.numpy())


def test_banded_scores_without_n_keep_the_padding_out():
    """C7: 1024 N-free self-pairs of 9-24 bases padded with N4 to 24, band
    4.  The JAX `banded_align_scores_tpu(has_n=False)` drops the N compare
    without remapping the padding, so pad-against-pad cells score as
    matches and its scores differ from its full pass; the port remaps the
    padding to the 16/17 sentinels and equals the full pass and the
    gold."""
    rng = np.random.default_rng(8)
    B, L = 1024, 24
    q = ACGT[rng.integers(0, 4, (B, L))]
    lens = rng.integers(9, L + 1, B).astype(np.int32)
    q[np.arange(L)[None, :] >= lens[:, None]] = N4
    jp = JParams()
    p = params_from_jax(jp)
    jargs = [jnp.asarray(x) for x in (q, q, lens, lens)]
    full = np.asarray(pallas_ksw.banded_align_tpu(*jargs, jp, 4).score)
    jax_no_n = np.asarray(pallas_ksw.banded_align_scores_tpu(
        *jargs, jp, 4, has_n=False))
    assert (jax_no_n != full).sum() > B // 2   # the reference-side fault
    args = _torch(q, q, lens, lens)
    got = cuda_align.banded_align_scores(*args, p, 4, has_n=False)
    np.testing.assert_array_equal(got.numpy(), full)
    np.testing.assert_array_equal(
        got.numpy(), banded_align_batch(*args, p, 4).score.numpy())
    for b in range(0, B, 32):
        assert int(got[b]) == golds.banded_align(
            q[b, :lens[b]], q[b, :lens[b]], p, 4)["score"] == lens[b], b


@pytest.mark.parametrize("what", ["banded_odd_widths", "h0_dtype",
                                  "h0_shape", "lengths_dtype"])
def test_wrappers_reject_bad_inputs(what):
    q, t, ql, tl, h0 = _torch(*_batch(9, 8, 16, 16))
    p = params_from_jax(JParams())
    with pytest.raises(ValueError):
        if what == "banded_odd_widths":
            cuda_align.banded_align(q[:, :15], t, ql.clamp_max(15), tl, p, 4)
        elif what == "h0_dtype":
            cuda_align.ksw_align(q, t, ql, tl, h0.long(), p)
        elif what == "h0_shape":
            cuda_align.ksw_align_scores(q, t, ql, tl, h0[:4], p)
        else:
            cuda_align.banded_align_scores(q, t, ql.long(), tl, p, 2)


def test_ksw_window_cells_count_the_walk():
    """`window_cells` counts the cells the reference's walk visits: here
    the gold's loop, instrumented, on every pair."""
    q, t, ql, tl, h0 = _batch(10, 48, 24, 32)
    p = params_from_jax(JParams())
    res, cells = ksw_align_batch(*_torch(q, t, ql, tl, h0), p,
                                 window_cells=True)
    _assert_result(res, ksw_align_batch(*_torch(q, t, ql, tl, h0), p))
    assert 0 < int(cells.sum()) < int((ql.astype(np.int64) * tl).sum())
    for b in range(48):
        assert int(cells[b]) == _gold_window_cells(q[b, :ql[b]], t[b, :tl[b]],
                                                   p, int(h0[b])), b


def _gold_window_cells(query, target, params, h0):
    """The gold ksw_align's row loop, counting end - beg per row run."""
    qlen, tlen = len(query), len(target)
    goe, ge = params.gap_oe, params.gap_extend
    ehh = np.zeros(qlen + 2, np.int64)
    ehe = np.zeros(qlen + 2, np.int64)
    ehh[0] = h0
    ehh[1] = h0 - goe if h0 > goe else 0
    j = 2
    while j <= qlen and ehh[j - 1] > ge:
        ehh[j] = ehh[j - 1] - ge
        j += 1
    beg, end, cells = 0, qlen, 0
    for i in range(tlen):
        f = m = 0
        h1 = max(h0 - (goe + ge * i), 0) if beg == 0 else 0
        cells += end - beg
        for j in range(beg, end):
            M, e = int(ehh[j]), int(ehe[j])
            ehh[j] = h1
            sub = golds._sub_score_local(int(query[j]), int(target[i]), params)
            M = M + sub if M else 0
            h1 = h = max(M, e, f)
            m = max(m, h)
            tt = max(M - goe, 0)
            ehe[j] = max(e - ge, tt)
            f = max(f - ge, tt)
        ehh[end], ehe[end] = h1, 0
        if m == 0:
            break
        j = beg
        while j < end and ehh[j] == 0 and ehe[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and ehh[j] == 0 and ehe[j] == 0:
            j -= 1
        end = min(j + 2, qlen)
    return cells
