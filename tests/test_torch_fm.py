"""The port's FM-index stack against the JAX package on the CPU: native
SA-IS against prefix doubling, the host FMIndex (build arrays, rank,
backward search, sa_values with a full and a sampled SA, locate, inexact
and hybrid search, MEMs, SMEMs, save / load across the packages), the
device index's records (against the JAX package's planes and
checkpoints) and suffix table (against the steps of the search), and
`backward_search_plain` against the JAX device search (jnp on the CPU)
and the host search at the kernel's edges: texts of 1-4,096 bp with the
sentinel at a block's first and last row, texts of one letter, queries of
length 0-32 present and absent, every q-gram of a small text.  A
line-for-line emulation of csrc/fm_search.cu's thread, and of how its
launch deals the queries to threads, is held to the plain version too.
Tolerance zero."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from genomics_tpu.index import fmindex as jfm
from genomics_tpu.index.qgram import QGramIndex as JQGramIndex
from genomics_tpu.ops import fm_search as jfs
from genomics_tpu_torch.index import fmindex, qgram
from genomics_tpu_torch.ops import fm_search
from genomics_tpu_torch.runtime import native

from chip_smoke import FM_EDGE_SPECS, fm_edge_text, fm_queries

def _text(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def test_sais_matches_prefix_doubling():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 7, 64, 1000, 20000):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        sa = native.sais_u8(codes)
        assert sa.dtype == np.int32 and sa.shape == (n + 1,)
        ref = fmindex.suffix_array(np.concatenate(
            [codes.astype(np.int64), [-1]]) + 1)
        np.testing.assert_array_equal(sa, ref)
        np.testing.assert_array_equal(ref, jfm.suffix_array(np.concatenate(
            [codes.astype(np.int64), [-1]]) + 1))


def test_sais_int64_path_matches_int32():
    rng = np.random.default_rng(11)
    for n in (1, 5, 257, 4096):
        codes = rng.integers(0, 5, n).astype(np.uint8)
        sa32 = native.sais_u8(codes)
        sa64 = native.sais_u8(codes, force64=True)
        assert sa64.dtype == np.int64
        np.testing.assert_array_equal(sa32, sa64)
        np.testing.assert_array_equal(native.bwt_from_sa(codes, sa32),
                                      native.bwt_from_sa(codes, sa64))


def test_native_library_builds_outside_native(tmp_path, monkeypatch):
    """The loader compiles into its build directory through a temporary
    file (nothing is left but the library), does not rebuild a library
    newer than its sources, and raises when the compiler fails."""
    out = tmp_path / "b"
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setenv("CXX", "true")          # a compiler that writes nothing
    lib = native.build()
    assert lib == out / native.LIB_NAME
    assert sorted(p.name for p in out.iterdir()) == [native.LIB_NAME]
    monkeypatch.setenv("CXX", "false")         # fresh: no compiler runs
    assert native.build() == lib
    os.utime(lib, (0, 0))                      # stale: the compiler fails
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert sorted(p.name for p in out.iterdir()) == [native.LIB_NAME]


def test_native_library_is_built_from_the_makefile_flags():
    make = (native.NATIVE_DIR / "Makefile").read_text()
    flags = next(ln for ln in make.splitlines()
                 if ln.startswith("CXXFLAGS")).split("?=")[1].split()
    # all but -fopenmp and -march=native: SA-IS is serial, the CUDA
    # machine's g++ has no OpenMP runtime (lighter.cpp's omp loop then runs
    # on one core), and a library for the compiler's default target loads
    # on any machine of its kind
    assert [f for f in flags if f not in ("-fopenmp", "-march=native")] \
        + ["-shared"] == list(native.CXX_FLAGS)
    assert native.SOURCES == ("sais.cpp", "lighter.cpp")
    assert native.library().gt_sais_u8 is not None
    assert native.library().gt_lighter_pass3 is not None
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("bad", [[0, 1, 4], [0, -1, 2], [255, 0]])
def test_fmindex_refuses_codes_outside_0_to_3(bad):
    """C5: a code below 0 is refused as one above 3 is (the JAX package
    checks only the maximum, so -1 would wrap to 255)."""
    with pytest.raises(ValueError, match="2-bit codes"):
        fmindex.FMIndex(np.array(bad, np.int64))


def test_qgram_index_matches_jax():
    rng = np.random.default_rng(3)
    text = _text(rng, 3000)
    text = text[:100] + "N" + text[101:]
    for src in (text, qgram.encode2(text).astype(np.uint8)):
        a, b = qgram.QGramIndex(src, q=12), JQGramIndex(src, q=12)
        np.testing.assert_array_equal(a.sorted_keys, b.sorted_keys)
        np.testing.assert_array_equal(a.sorted_pos, b.sorted_pos)
        keys = qgram.qgrams_of(a.codes, 12)[::7]
        for x, y in zip(a.hits(keys, 5), b.hits(keys, 5)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sa_rate,occ_rate", [(1, 128), (4, 128), (4, 32)])
def test_fmindex_matches_jax(sa_rate, occ_rate):
    rng = np.random.default_rng(sa_rate + occ_rate)
    text = _text(rng, 5000)
    a = fmindex.FMIndex(text, occ_rate=occ_rate, sa_rate=sa_rate)
    b = jfm.FMIndex(text, occ_rate=occ_rate, sa_rate=sa_rate)
    for f in ("n", "bwt", "C", "ckpt", "occ_rate", "sa_rate"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    s = rng.integers(0, 5, 500)
    i = rng.integers(0, a.n + 1, 500)
    np.testing.assert_array_equal(a.rank(s, i), b.rank(s, i))
    rows = np.arange(a.n)
    np.testing.assert_array_equal(a.sa_values(rows), b.sa_values(rows))
    full = fmindex.FMIndex(text)
    np.testing.assert_array_equal(a.sa_values(rows), full.sa_values(rows))
    Q, ql = fm_queries(rng, qgram.encode2(text))
    for x, y in zip(a.backward_search(Q, ql), b.backward_search(Q, ql)):
        np.testing.assert_array_equal(x, y)
    lo, hi = a.backward_search(Q, ql)
    for s_ in range(0, 64):
        np.testing.assert_array_equal(a.locate(int(lo[s_]), int(hi[s_])),
                                      b.locate(int(lo[s_]), int(hi[s_])))
    for pat in ("ACGT", text[100:130], "ACGTNACG"[:4], text[-9:]):
        assert a.count(pat) == b.count(pat)


def test_inexact_and_hybrid_search_match_jax():
    rng = np.random.default_rng(9)
    text = _text(rng, 4000)
    a, b = fmindex.FMIndex(text), jfm.FMIndex(text)
    pats = [text[p:p + 20] for p in rng.integers(0, 3980, 10)]
    pats += [_text(rng, 14) for _ in range(4)]
    mutated = list(pats[0])
    mutated[3] = "ACGT"[("ACGT".index(mutated[3]) + 1) % 4]
    pats += ["".join(mutated), pats[1][:9] + "N" + pats[1][10:]]
    for p in pats:
        for mm in (0, 1, 2):
            assert a.inexact_search(p, max_mm=mm) == \
                b.inexact_search(p, max_mm=mm)
            assert a.hybrid_search(p, max_mm=mm) == \
                b.hybrid_search(p, max_mm=mm)
        assert a.inexact_search(p, max_mm=2, max_results=3) == \
            b.inexact_search(p, max_mm=2, max_results=3)


def test_mems_and_smems_match_jax():
    rng = np.random.default_rng(12)
    text = _text(rng, 3000)
    a, b = fmindex.BidirFMIndex(text), jfm.BidirFMIndex(text)
    assert a.n == b.n
    for i in range(8):
        p = int(rng.integers(0, 2800))
        q = list(text[p:p + 120])
        for j in rng.integers(0, 120, 3):
            q[j] = "ACGTN"[int(rng.integers(0, 5))]
        q = "".join(q)
        assert a.smems(q, min_len=15) == b.smems(q, min_len=15)
        assert fmindex.find_mems(a.fwd, q, 15) == jfm.find_mems(b.fwd, q, 15)
        assert fmindex.seed_positions(a.fwd, q, 15, 8) == \
            jfm.seed_positions(b.fwd, q, 15, 8)
    st = a.start()
    for c in (0, 2, 3, 1):
        assert a.extend_back(st, c) == b.extend_back(st, c)
        assert a.extend_forward(st, c) == b.extend_forward(st, c)
        st = a.extend_back(st, c)


@pytest.mark.parametrize("sa_rate", [1, 4])
def test_index_files_load_in_either_package(tmp_path, sa_rate):
    text = _text(np.random.default_rng(sa_rate), 2000)
    a = fmindex.FMIndex(text, sa_rate=sa_rate)
    b = jfm.FMIndex(text, sa_rate=sa_rate)
    fmindex.save_index(a, str(tmp_path / "port"))
    jfm.save_index(b, str(tmp_path / "jax"))
    for x, y in ((fmindex.load_index(str(tmp_path / "jax.npz")), b),
                 (jfm.load_index(str(tmp_path / "port")), a)):
        for f in ("n", "bwt", "C", "ckpt", "occ_rate", "sa_rate"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
        rows = np.arange(x.n)
        np.testing.assert_array_equal(x.sa_values(rows), y.sa_values(rows))


@pytest.mark.parametrize("spec", FM_EDGE_SPECS,
                         ids=[spec[0] for spec in FM_EDGE_SPECS])
def test_device_index_and_plain_search_match_jax_at_the_edges(spec):
    """The records hold the JAX package's plane words (64 positions a
    record, zeros past n) and its checkpoints (every second record's
    counts), and the plain search over them and the suffix table == the
    JAX device search == the host search."""
    codes = fm_edge_text(spec)
    fm = fmindex.FMIndex(codes)
    idx = fm.to_device(device="cpu")
    jidx = jfs.build_device_index(jfm.FMIndex(codes))
    assert idx.rec.dtype == torch.int32 and idx.rec.device.type == "cpu"
    rec = idx.rec.numpy().view(np.uint32)
    NB = (fm.n + 63) // 64 + 1
    assert rec.shape == (NB, 8)
    for plane, cols in ((jidx.p0, slice(4, 6)), (jidx.p1, slice(6, 8))):
        words = rec[:, cols].ravel()
        W = len(np.asarray(plane))
        np.testing.assert_array_equal(words[:W], np.asarray(plane))
        assert not words[W:].any()
    ck = np.asarray(jidx.ckpt)
    m = min(ck.shape[1], (NB + 1) // 2)
    np.testing.assert_array_equal(rec[0::2, :4][:m].T, ck[:, :m])
    np.testing.assert_array_equal(idx.C.numpy(), np.asarray(jidx.C))
    assert idx.primary == int(jidx.primary) and idx.n == jidx.n
    assert idx.tk == fm_search.table_k(fm.n)
    assert idx.table.shape == ((4**idx.tk, 2) if idx.tk else (0, 2))
    Q, ql = fm_queries(np.random.default_rng(len(codes)), codes)
    lo, hi = fm_search.backward_search_device(idx, Q, ql)
    assert lo.dtype == np.int64 and hi.dtype == np.int64
    jlo, jhi = jfs.backward_search_device(jidx, Q, ql)
    hlo, hhi = fm.backward_search(Q, ql)
    for got, want in ((lo, jlo), (hi, jhi), (lo, hlo), (hi, hhi)):
        np.testing.assert_array_equal(got, want)
    assert (lo[ql == 0] == 0).all() and (hi[ql == 0] == fm.n).all()


@pytest.mark.parametrize("n,k", [(300, 1), (300, 5), (4096, 6), (5000, 6),
                                 (129, 3)])
def test_suffix_table_is_k_steps_of_the_search(n, k):
    """Every entry of a table of k codes == k steps of the search of its
    string with no table, ranges that emptied early included; a table of
    tk codes then changes no search: queries of tk to L codes start from
    it, shorter ones take the loop from (0, n), and the JAX search agrees
    with both."""
    rng = np.random.default_rng(n + k)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    fm = fmindex.FMIndex(codes)
    idx = fm.to_device(device="cpu")
    bare = dataclasses.replace(idx, table=idx.table[:0], tk=0)
    table = fm_search.suffix_table(bare, k)
    keys = np.arange(4**k)
    Q = ((keys[:, None] >> (2 * np.arange(k - 1, -1, -1))) & 3)
    lo, hi = fm.backward_search(Q, np.full(4**k, k))
    np.testing.assert_array_equal(table[:, 0].numpy(), lo)
    np.testing.assert_array_equal(table[:, 1].numpy(), hi)
    if 4**k > n:
        assert (table[:, 1] <= table[:, 0]).any()   # some emptied early
    Q, ql = fm_queries(rng, codes, S=200, L=20)
    q = torch.from_numpy((Q & 3).astype(np.uint8))
    stats = {}
    got = fm_search.backward_search_plain(idx, q, torch.from_numpy(ql),
                                          stats=stats)
    want = fm_search.backward_search_plain(bare, q, torch.from_numpy(ql))
    for g, w, h in zip(got, want, fm.backward_search(Q, ql)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), h)
    tk = idx.tk
    assert stats["lookups"] == int(((ql >= tk) & (ql <= 20)).sum()) > 0
    assert stats["key_codes"] == tk * stats["lookups"]


def test_plain_search_of_every_qgram_matches_counts():
    """Every 1- to 8-gram of a 300 bp text: the range's width is its count
    in the text, and the JAX device search gives the same range."""
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    fm = fmindex.FMIndex(codes)
    idx = fm.to_device(device="cpu")
    jidx = jfs.build_device_index(jfm.FMIndex(codes))
    for q in (1, 4, 8):
        win = np.lib.stride_tricks.sliding_window_view(codes, q)
        lo, hi = fm_search.backward_search_device(
            idx, win, np.full(len(win), q))
        jlo, jhi = jfs.backward_search_device(jidx, win, np.full(len(win), q))
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(hi, jhi)
        keys = (win.astype(np.int64) << (2 * np.arange(q - 1, -1, -1))).sum(1)
        _, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
        np.testing.assert_array_equal(hi - lo, cnt[inv])
        pos = [fm.locate(int(a), int(b)) for a, b in zip(lo[:20], hi[:20])]
        assert all(i in p for i, p in enumerate(pos))


def _kernel_thread(rec, C, primary, n, table, tk, row, L, ql, work=None):
    """csrc/fm_search.cu's fm_search_kernel for one query, line for line:
    the suffix table's key and entry, the early exits, one record a rank,
    the sentinel's test.  With `work`, adds the steps, ranks, lookups and
    key codes the thread reads to its counts."""
    def occ(s, i, f0, f1):
        if work is not None:
            work["ranks"] += 1
        k = i // 64
        cnt = int(rec[k, s])
        p0 = int(rec[k, 4]) | int(rec[k, 5]) << 32
        p1 = int(rec[k, 6]) | int(rec[k, 7]) << 32
        below = (1 << (i % 64)) - 1
        cnt += bin((p0 ^ f0) & (p1 ^ f1) & below).count("1")
        if s == 0 and k * 64 <= primary < i:
            cnt -= 1
        return cnt

    lo, hi, t = 0, n, 0
    if tk > 0 and tk <= ql <= L:
        key = 0
        for m in range(ql - tk, ql):
            key = key << 2 | (int(row[m]) & 3)
        lo, hi, t = int(table[key, 0]), int(table[key, 1]), tk
        if work is not None:
            work["lookups"] += 1
            work["key_codes"] += tk
    while True:
        k = ql - 1 - t
        if t >= L or k < 0 or hi <= lo:
            break
        if work is not None:
            work["steps"] += 1
        s = int(row[min(k, L - 1)]) & 3
        f0 = 0 if s & 1 else (1 << 64) - 1
        f1 = 0 if s & 2 else (1 << 64) - 1
        c = int(C[s + 1])
        lo, hi = c + occ(s, lo, f0, f1), c + occ(s, hi, f0, f1)
        t += 1
    return lo, hi


def _thread_args(idx):
    return (idx.rec.numpy().view(np.uint32), idx.C.numpy(), idx.primary,
            idx.n, idx.table.numpy(), idx.tk)


@pytest.mark.parametrize("spec", FM_EDGE_SPECS[::3],
                         ids=[spec[0] for spec in FM_EDGE_SPECS[::3]])
def test_kernel_thread_emulation_matches_plain(spec):
    codes = fm_edge_text(spec)
    fm = fmindex.FMIndex(codes)
    idx = fm.to_device(device="cpu")
    Q, ql = fm_queries(np.random.default_rng(3), codes, S=96, L=20)
    q = torch.from_numpy((Q & 3).astype(np.uint8))
    lo, hi = fm_search.fm_search(idx, q, torch.from_numpy(ql))
    for s in range(len(ql)):
        got = _kernel_thread(*_thread_args(idx), Q[s], Q.shape[1],
                             int(ql[s]))
        assert got == (int(lo[s]), int(hi[s])), s


@pytest.mark.parametrize("spec", FM_EDGE_SPECS[1::3],
                         ids=[spec[0] for spec in FM_EDGE_SPECS[1::3]])
def test_plain_stats_count_the_kernels_work(spec):
    """backward_search_plain(stats=) counts the steps, ranks (one record
    each), table lookups and key codes the kernel's threads take (the
    work chip_smoke's bound charges)."""
    codes = fm_edge_text(spec)
    idx = fmindex.FMIndex(codes).to_device(device="cpu")
    Q, ql = fm_queries(np.random.default_rng(4), codes, S=96, L=20)
    stats = {}
    fm_search.backward_search_plain(
        idx, torch.from_numpy((Q & 3).astype(np.uint8)),
        torch.from_numpy(ql), stats=stats)
    work = dict(steps=0, ranks=0, lookups=0, key_codes=0)
    for s in range(len(ql)):
        _kernel_thread(*_thread_args(idx), Q[s], Q.shape[1], int(ql[s]),
                       work)
    assert stats == work
    assert work["ranks"] == 2 * work["steps"]


@pytest.mark.parametrize("S", [1, 255, 256, 257, 1000, 2048, 2049, 5000])
def test_launch_deals_every_query_once(S):
    """The entry point's QPT (1, 2 or 4: the fewest that fit S into the
    resident threads, else 4 with the threads looping) and grid, and the
    kernel's slots (first + u x threads, then threads x QPT on): every
    query in one slot, none twice, none past S; here for a card holding
    4 blocks of 256 threads."""
    threads_a_block, resident = 256, 1024
    qpt = 1 if S <= resident else 2 if S <= 2 * resident else 4
    blocks = min(-(-S // (qpt * threads_a_block)),
                 resident // threads_a_block)
    threads = blocks * threads_a_block
    seen = np.zeros(S, np.int64)
    for tid in range(threads):
        first = tid
        while first < S:
            for u in range(qpt):
                if first + u * threads < S:
                    seen[first + u * threads] += 1
            first += threads * qpt
    assert (seen == 1).all()
    assert blocks * threads_a_block * qpt >= min(S, qpt * resident)


def test_fm_search_checks_its_inputs(monkeypatch):
    fm = fmindex.FMIndex(np.zeros(40, np.uint8))
    idx = fm.to_device(device="cpu")
    q = torch.zeros((3, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        fm_search.fm_search(idx, q.int(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="qlen"):
        fm_search.fm_search(idx, q, torch.zeros(3, dtype=torch.int64))
    lo, hi = fm_search.fm_search(idx, q[:0], torch.zeros(0, dtype=torch.int32))
    assert lo.shape == (0,) and hi.shape == (0,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fm.to_device()          # the card by default, and no fallback


def test_device_index_keeps_the_int32_cap():
    class Huge:
        n = 2**31
        bwt = np.zeros(4, np.int8)
        C = np.zeros(6, np.int64)

    with pytest.raises(ValueError, match="int32 SA ranges"):
        fm_search.build_device_index(Huge(), device="cpu")


def test_popcount_of_every_bit_pattern_class():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2**32, 4000, dtype=np.uint64),
                        [0, 1, 2**31, 2**32 - 1, 0x80000001]])
    want = [bin(int(v)).count("1") for v in x]
    got = fm_search._popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
