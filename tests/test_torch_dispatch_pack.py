"""AlignEngine's batch-wide preparation on the CPU: the array bucketing
against `_bucket_of`, and each chunk `_dispatch` launches (pair indices,
padded codes, lengths, `has_n`) against a plain per-pair packing written
here, for bytes, str, code-array and mixed batches; plus the
`dispatch.pairs_joined` counter."""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from genomics_tpu_torch.core.encoding import N4, encode4
from genomics_tpu_torch.core.scoring import AlgoType, AlignmentParams
from genomics_tpu_torch.runtime import dispatch
from genomics_tpu_torch.utils import profiling

CUSTOM_EDGES = [5, 12, 12, 40, 33, 100, 96]     # repeats, out of order


@pytest.mark.parametrize("edges", [dispatch.default_buckets(), CUSTOM_EDGES],
                         ids=["default", "custom"])
def test_buckets_of_matches_bucket_of(edges):
    lens = np.arange(6001, dtype=np.int32)   # past the last edge of both
    got = dispatch._buckets_of(lens, edges)
    want = [dispatch._bucket_of(int(n), edges) for n in lens]
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


def _seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), n))


def _shape(name, rng):
    """(queries, targets) as str, and the pairs-per-launch cap, for one
    shape of batch."""
    if name == "empty":
        qs = ["", _seq(rng, 20), "", _seq(rng, 7)]
        ts = [_seq(rng, 30), "", "", _seq(rng, 9)]
    elif name == "edges":      # at a bucket edge, and one past it
        qs = [_seq(rng, n) for n in (8, 9, 16, 17, 48, 49, 64, 65)]
        ts = [_seq(rng, n) for n in (64, 65, 96, 97, 8, 9, 16, 17)]
    elif name == "n_last":     # an N at the last base, before pads or none
        qs = [_seq(rng, 15) + "N", _seq(rng, 20), _seq(rng, 12) + "N",
              _seq(rng, 40)]
        ts = [_seq(rng, 30), _seq(rng, 47) + "N", _seq(rng, 60),
              _seq(rng, 70)]
    elif name == "buckets":    # one batch over many buckets
        lq = rng.integers(1, 300, 40)
        lt = rng.integers(1, 500, 40)
        qs = [_seq(rng, int(n), "ACGTN") for n in lq]
        ts = [_seq(rng, int(n)) for n in lt]
    else:                      # "split": 11 pairs of one bucket, 3 a chunk
        qs = [_seq(rng, int(n)) for n in rng.integers(17, 25, 11)]
        ts = [_seq(rng, int(n), "ACGTN") for n in rng.integers(33, 49, 11)]
        return qs, ts, 3
    return qs, ts, dispatch.MAX_PAIRS_PER_LAUNCH


def _as(kind, seqs, side):
    if kind == "bytes":
        return [s.encode() for s in seqs]
    if kind == "str":
        return list(seqs)
    if kind == "codes":
        return [encode4(s) for s in seqs]
    # mixed: queries str and bytes (joined), targets bytes and codes
    other = (lambda s: s) if side == "q" else encode4
    return [other(s) if k % 2 else s.encode() for k, s in enumerate(seqs)]


def _plain_chunks(qs, ts, edges, cap):
    """The per-pair packing: each pair's codes padded with N4 in its
    bucket, a bucket's pairs in submission order cut every `cap`."""
    groups = {}
    for i, (q, t) in enumerate(zip(qs, ts)):
        key = (dispatch._bucket_of(len(q), edges),
               dispatch._bucket_of(len(t), edges))
        groups.setdefault(key, []).append(i)
    out = []
    for (lq, lt), idxs in groups.items():
        for pos in range(0, len(idxs), cap):
            chunk = idxs[pos:pos + cap]
            qb = np.full((len(chunk), lq), N4, np.uint8)
            tb = np.full((len(chunk), lt), N4, np.uint8)
            for k, i in enumerate(chunk):
                q, t = encode4(qs[i]), encode4(ts[i])
                qb[k, :len(q)] = q
                tb[k, :len(t)] = t
            has_n = any("N" in qs[i] or "N" in ts[i] for i in chunk)
            out.append((chunk, qb, tb,
                        np.array([len(qs[i]) for i in chunk], np.int32),
                        np.array([len(ts[i]) for i in chunk], np.int32),
                        has_n))
    return sorted(out, key=lambda c: c[0][0])


@pytest.mark.parametrize("shape", ["empty", "edges", "n_last", "buckets",
                                   "split"])
@pytest.mark.parametrize("kind", ["bytes", "str", "codes", "mixed"])
def test_chunks_match_plain_packing(monkeypatch, kind, shape):
    qs, ts, cap = _shape(shape, np.random.default_rng(7))
    monkeypatch.setattr(dispatch, "MAX_PAIRS_PER_LAUNCH", cap)
    eng = dispatch.AlignEngine(AlignmentParams(algo=AlgoType.LOCAL),
                               device="cpu")
    launched = []
    monkeypatch.setattr(eng, "_run_chunk", lambda *a: launched.append(a))
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pending, n = eng._dispatch(_as(kind, qs, "q"), _as(kind, ts, "t"))
    counters = profiling.totals()["counters"]
    profiling.clear()
    assert n == len(qs)
    got = sorted(((idxs, *a[:4], a[5]) for (idxs, _), a
                  in zip(pending, launched)), key=lambda c: c[0][0])
    want = _plain_chunks(qs, ts, eng.buckets, cap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:5], w[1:5]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g[5] is w[5]
    if shape == "split":
        assert max(len(c[0]) for c in got) == cap < len(qs)
    if shape == "buckets":
        assert len(got) >= 3
    joined = kind in ("bytes", "str")
    assert counters["dispatch.pairs"] == len(qs)
    assert counters["dispatch.pairs_joined"] == (len(qs) if joined else 0)


def test_empty_batch_launches_nothing():
    eng = dispatch.AlignEngine(AlignmentParams(), device="cpu")
    pending, n = eng._dispatch([], [])
    assert (list(pending), n) == ([], 0)
    assert eng.align([], []) == []
