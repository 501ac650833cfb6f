"""The packed-16-bit LOCAL modes against the JAX package: the port's plain
SCORE16 / END16 versions against `_local_kernel_intertask_score16` and
`_local_kernel_intertask16` in interpret mode, against the port's int32
plain version at the top of the range, and the port's choice of mode
(`cuda_align.local_mode`) against the kernel the JAX package picks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_tpu.core.scoring import AlignmentParams as JParams
from genomics_tpu.ops import pallas_align
from genomics_tpu_torch.core.scoring import params_from_jax
from genomics_tpu_torch.ops import cuda_align
from genomics_tpu_torch.ops.scan_align import (
    local_align_batch,
    local_align_batch16,
)

ACGT = np.array([1, 3, 7, 4], np.uint8)  # 4-bit codes of A, C, G, T
N4 = 14


def _batch(seed, B, Lq, Lt, n_rate=0.0):
    """Half the pairs related (~8% substitutions), ragged lengths padded
    with N4, in-sequence Ns at n_rate; pair 0 fills the bucket."""
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
    ql = rng.integers(1, Lq + 1, B)
    tl = rng.integers(1, Lt + 1, B)
    ql[0], tl[0] = Lq, Lt
    for b in range(B):
        q[b, ql[b]:] = N4
        t[b, tl[b]:] = N4
    return q, t


@pytest.mark.parametrize("jp", [
    JParams(), JParams(match=3, mismatch=2, gap_open=4, gap_extend=2)],
    ids=["defaults", "other_scores"])
def test_score16_matches_jax_int16_kernel(jp):
    """`_local_align_scores_jit(q, t, P, True, False)` runs
    `_local_kernel_intertask_score16` on the 16/17-remapped batch; the
    port's score path picks SCORE16 for the same batch and agrees."""
    q, t = _batch(1, 1024, 24, 32)
    p = params_from_jax(jp)
    want = np.asarray(pallas_align._local_align_scores_jit(
        jnp.asarray(q), jnp.asarray(t), jp, True, False))
    assert cuda_align.local_mode(False, 24, p, has_n=False) == "score16"
    got = cuda_align.local_align_scores(torch.from_numpy(q),
                                        torch.from_numpy(t), p, has_n=False)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = local_align_batch16(
        cuda_align._pads_to_sentinels(torch.from_numpy(q), 16),
        cuda_align._pads_to_sentinels(torch.from_numpy(t), 17), p,
        ends=False)
    np.testing.assert_array_equal(plain.score.numpy(), want)
    assert plain.query_end is None


@pytest.mark.parametrize("n_rate,jp", [
    (0.0, JParams()), (0.03, JParams()), (0.03, JParams(n_penalty=2))],
    ids=["acgt", "with_ns", "n_penalty"])
def test_end16_matches_jax_int16_kernel(monkeypatch, n_rate, jp):
    """`_local_align_intertask` itself (not the jitted `local_align_tpu`,
    whose trace cache may hold an int32 trace) under
    GENOMICS_TPU_INT16_CELLS=1 runs `_local_kernel_intertask16`; the
    port's END16 plain version gives the same score and ends."""
    ran = []
    kernel16 = pallas_align._local_kernel_intertask16

    def spy(*args, **kw):
        ran.append(True)
        return kernel16(*args, **kw)

    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    monkeypatch.setattr(pallas_align, "_local_kernel_intertask16", spy)
    q, t = _batch(2, 1024, 24, 32, n_rate)
    want = pallas_align._local_align_intertask(jnp.asarray(q), jnp.asarray(t),
                                               jp)
    assert ran, "the JAX int16 kernel did not run"
    p = params_from_jax(jp)
    got = cuda_align.local_align(torch.from_numpy(q), torch.from_numpy(t), p)
    plain = local_align_batch16(torch.from_numpy(q), torch.from_numpy(t), p)
    for res in (got, plain):
        for a, b in zip(res[:3], want[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.score.max()) > 0


def _same_pairs(B, Lq, Lt):
    """B copies of one random pair whose query is the target's first Lq
    bases, so that the best score is match x Lq."""
    rng = np.random.default_rng(5)
    t = np.repeat(ACGT[rng.integers(0, 4, (1, Lt))], B, axis=0)
    return t[:, :Lq].copy(), t


@pytest.mark.parametrize("B,Lq,Lt,n_rate,match", [
    (64, 152, 152, 0.0, 200), (37, 152, 96, 0.02, 200),
    (3, 258, 264, 0.0, 127), (3, 33, 40, 0.0, 991)],
    ids=["152x152", "ragged_ns", "one_below_the_ends_limit",
         "one_below_the_score_limit"])
def test_plain16_equals_plain32_at_the_top_of_the_range(monkeypatch, B, Lq,
                                                        Lt, n_rate, match):
    """match=200 at Lq 152 allows scores up to 30,400, and the related
    pairs reach most of that; 127 x 258 = 32,766 is one below the ends'
    limit and 991 x 33 = 32,703 one below the scores', where identical
    pairs score exactly that."""
    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    p = params_from_jax(JParams(match=match))
    if B > 3:
        q, t = (torch.from_numpy(a) for a in _batch(3, B, Lq, Lt, n_rate))
    else:
        q, t = (torch.from_numpy(a) for a in _same_pairs(B, Lq, Lt))
    want = local_align_batch(q, t, p)
    assert int(want.score.max()) > 0.7 * match * min(Lq, Lt)
    if B <= 3:
        assert int(want.score.max()) == match * Lq
    if match * Lq < cuda_align.END16_LIMIT:
        assert cuda_align.local_mode(True, Lq, p) == "end16"
        got = local_align_batch16(q, t, p)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
    if not n_rate and match * Lq >= cuda_align.SCORE16_LIMIT:
        assert cuda_align.local_mode(False, Lq, p, has_n=False) == "score"
    elif not n_rate:
        assert cuda_align.local_mode(False, Lq, p, has_n=False) == "score16"
        qs = cuda_align._pads_to_sentinels(q, 16)
        ts = cuda_align._pads_to_sentinels(t, 17)
        assert torch.equal(local_align_batch16(qs, ts, p, ends=False).score,
                           want.score)
        assert torch.equal(cuda_align.local_align_scores(q, t, p, has_n=False),
                           want.score)


class _Chosen(BaseException):
    """Raised by the stand-in pallas_call with the kernel's name; not an
    Exception, so the JAX package's int16 fallback does not catch it."""


def _jax_kernel(monkeypatch, fn, *args):
    """The name of the Pallas kernel `fn(*args)` launches, found by
    stopping at its pallas_call."""
    def stop(kernel, **kw):
        raise _Chosen(kernel.func.__name__)

    monkeypatch.setattr(pallas_align.pl, "pallas_call", stop)
    monkeypatch.setattr(pallas_align, "_INT16_DISABLED", False)
    with pytest.raises(_Chosen) as info:
        fn(*args)
    return str(info.value)


# (match, Lq) at and around the JAX package's limits, match x Lq < 32,767
# for the ends and < 32,704 for the scores: 194 x 168 = 32,592 is inside
# both, 195 x 168 = 32,760 past the scores' only, 196 x 168 = 32,928 past
# both; 127 x 258 = 32,766 and 4,087 x 8 = 32,696 are just inside, 217 x
# 151 = 32,767 and 4,088 x 8 = 32,704 exactly at the limit, so past it (the
# scores' JAX path needs Lq % 8 == 0, the ends' does not).
@pytest.mark.parametrize("match,Lq", [
    (194, 168), (195, 168), (196, 168), (127, 258), (217, 151), (4087, 8),
    (4088, 8)])
@pytest.mark.parametrize("has_n", [False, True], ids=["no_n", "has_n"])
def test_local_mode_matches_the_jax_gates(monkeypatch, match, Lq, has_n):
    """With both of the JAX package's switches on, the port picks the
    kernel the JAX package picks, at each limit and for has_n either way."""
    jp = JParams(match=match)
    p = params_from_jax(jp)
    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    monkeypatch.setenv("GENOMICS_TPU_INT16_SCORE", "1")
    q = jnp.zeros((1024, Lq), jnp.uint8)
    t = jnp.zeros((1024, 8), jnp.uint8)
    ends = _jax_kernel(monkeypatch, pallas_align._local_align_intertask,
                       q[:128], t[:128], jp)
    assert {"_local_kernel_intertask16": "end16",
            "_local_kernel_intertask": "end"}[ends] == \
        cuda_align.local_mode(True, Lq, p)
    if Lq % 8 == 0:
        score = _jax_kernel(monkeypatch, pallas_align.local_align_scores_tpu,
                            q, t, jp, has_n)
        assert {"_local_kernel_intertask_score16": "score16",
                "_local_kernel_intertask_score": "score"}[score] == \
            cuda_align.local_mode(False, Lq, p, has_n)


@pytest.mark.parametrize("B", [1, 1000, 65536])
@pytest.mark.parametrize("cells16", [False, True], ids=["default", "opted_in"])
def test_end16_runs_only_under_the_switch(monkeypatch, B, cells16):
    """The ends take END16 only under GENOMICS_TPU_INT16_CELLS=1, read at
    each call, whatever the launch size; the scores' choice reads neither
    switch."""
    monkeypatch.delenv("GENOMICS_TPU_INT16_CELLS", raising=False)
    monkeypatch.delenv("GENOMICS_TPU_INT16_SCORE", raising=False)
    p = params_from_jax(JParams())
    q, t = (torch.from_numpy(a) for a in _batch(6, B, 16, 16, 0.0))
    assert cuda_align.local_mode(True, 16, p) == "end"
    if cells16:
        monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    ran = []
    plain16 = cuda_align.local_align_batch16
    monkeypatch.setattr(cuda_align, "local_align_batch16",
                        lambda *a, **k: ran.append(k) or plain16(*a, **k))
    got = cuda_align.local_align(q, t, p)
    assert ran == ([{}] if cells16 else [])
    assert cuda_align.local_mode(True, 16, p) == ("end16" if cells16 else
                                                  "end")
    assert cuda_align.local_mode(False, 16, p, has_n=False) == "score16"
    assert cuda_align.local_mode(False, 16, p, has_n=True) == "score"
    for a, b in zip(got[:3], local_align_batch(q, t, p)[:3]):
        assert torch.equal(a, b)


# Each term of the int16 range past which both modes go back to int32,
# exactly at its edge (Lq 24, so match x Lq stays small): the gap chains'
# floor -(mismatch + gap_oe + gap_extend) with the defaults' gap_oe +
# gap_extend = 8, the kernels' packed -(match + mismatch), and the N score
# in the floor.
_EDGES = {"mismatch_gap_floor": lambda k: JParams(mismatch=32760 - k),
          "match_plus_mismatch": lambda k: JParams(match=100,
                                                   mismatch=32668 - k),
          "n_penalty": lambda k: JParams(n_penalty=32760 - k)}


@pytest.mark.parametrize("past", [True, False], ids=["past", "inside"])
@pytest.mark.parametrize("edge", list(_EDGES))
def test_int16_range_checks_the_mismatch_and_gap_terms(monkeypatch, edge,
                                                       past):
    """Just past each limit (a term of 32,768) both modes are the int32
    ones; just inside (32,767), the 16-bit ones, and their plain version
    still equals the int32 one.  The JAX package checks none of these
    terms (ROADMAP C13)."""
    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    p = params_from_jax(_EDGES[edge](0 if past else 1))
    want = ("end", "score") if past else ("end16", "score16")
    assert (cuda_align.local_mode(True, 24, p),
            cuda_align.local_mode(False, 24, p, has_n=False)) == want
    q, t = (torch.from_numpy(a) for a in _batch(4, 64, 24, 32, 0.05))
    ref = local_align_batch(q, t, p)
    runs = [cuda_align.local_align(q, t, p)]
    if not past:
        runs.append(local_align_batch16(q, t, p))
    for got in runs:
        for a, b in zip(got[:3], ref[:3]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n_score,mode", [(1365, "end16"), (1366, "end")])
def test_the_n_score_counts_as_a_match_in_the_range(monkeypatch, n_score,
                                                    mode):
    """A negative n_penalty scores an N above a match: at Lq 24, 1,365 x 24
    = 32,760 fits the ends' limit and 1,366 x 24 = 32,784 does not."""
    monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    p = params_from_jax(JParams(n_penalty=-n_score))
    assert cuda_align.local_mode(True, 24, p) == mode
    q, t = (torch.from_numpy(a) for a in _batch(7, 16, 24, 32, 0.3))
    got = cuda_align.local_align(q, t, p)
    for a, b in zip(got[:3], local_align_batch(q, t, p)[:3]):
        assert torch.equal(a, b)
