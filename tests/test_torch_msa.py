"""The port's center-star MSA (`genomics_tpu_torch.models.msa`) and its
substitution-matrix loader on the CPU against the JAX package: the same
seeded numpy inputs through `nw_matrices_batch`, `backtrack_batch`,
`find_center_sequence` and `msa` of both, integer-equal, with DNA scoring
and a test-written NCBI matrix; the host backtrack gold; the MSA edges
chip_smoke.py's phase 3 runs on the card; the path that runs the pairs in
chunks, forced small; the `msa` subcommand byte for byte; and the walk of
csrc/msa_nw.cu's backtrack emulated word by word, which reads what the
plain version counts.  The CUDA kernels are held to these plain versions
on the card (tests/test_torch_cuda.py)."""
import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (backtrack_edges, msa_edges, mutate, ncbi_matrix,
                        random_seq)
from genomics_tpu import __main__ as jax_main
from genomics_tpu.core.submat import load_scoring_matrix as jax_load
from genomics_tpu.models import msa as jmsa
from genomics_tpu.utils.fasta import read_fasta
from genomics_tpu_torch import __main__ as torch_main
from genomics_tpu_torch.core.submat import dna_table, load_scoring_matrix
from genomics_tpu_torch.models import msa


@pytest.fixture(scope="module")
def matrix_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("scoring") / "synthetic.txt"
    path.write_text(ncbi_matrix(np.random.default_rng(8)))
    return str(path)


def test_load_scoring_matrix_matches_jax(matrix_path):
    got = load_scoring_matrix(matrix_path)
    np.testing.assert_array_equal(got, jax_load(matrix_path))
    with open(matrix_path) as fh:
        rows = [ln.split() for ln in fh if not ln.startswith("#")]
    cols = rows[0]
    for r in rows[1:]:
        for c, v in zip(cols, r[1:]):
            for a, b in ((r[0], c), (r[0].lower(), c.lower())):
                assert got[ord(a), ord(b)] == int(v)
    assert got[ord("A"), ord("J")] == 0 and got.dtype == np.int32
    np.testing.assert_array_equal(dna_table(2, -3)[[65, 65], [65, 67]],
                                  [2, -3])


def _dna_set(seed, n=7, L=50):
    rng = np.random.default_rng(seed)
    base = random_seq(rng, L)
    return [mutate(rng, base, 0.05, 0.06) for _ in range(n)]


def _protein_set(seed, n=6, L=40):
    rng = np.random.default_rng(seed)
    base = random_seq(rng, L, "ACDEFGHIKLMNPQRSTVWY")
    return [mutate(rng, base, 0.1, 0.1, "ACDEFGHIKLMNPQRSTVWY")
            for _ in range(n)]


def _jax_and_port(seqs, center_idx, table):
    """(JAX M, port M, cenc, arr, slens) of msa()'s pairs."""
    cenc, arr, slens = msa.pack_pairs(seqs, center_idx)
    jt = None if table is None else jnp.asarray(table)
    want = np.asarray(jmsa.nw_matrices_batch(jnp.asarray(cenc),
                                             jnp.asarray(arr), jt))
    got = msa.nw_matrices_batch(
        torch.from_numpy(cenc), torch.from_numpy(arr),
        None if table is None else torch.from_numpy(table))
    return want, got, cenc, arr, slens


@pytest.mark.parametrize("protein", [False, True])
def test_matrices_and_backtrack_match_jax_and_gold(protein, matrix_path):
    seqs = _protein_set(2) if protein else _dna_set(1)
    table = load_scoring_matrix(matrix_path) if protein else None
    want, got, cenc, arr, slens = _jax_and_port(seqs, 0, table)
    assert got.shape == want.shape and got.dtype == torch.int32
    for k, n in enumerate(slens):   # each pair within its own length
        np.testing.assert_array_equal(got[k, :, :n + 1].numpy(),
                                      want[k, :, :n + 1])
    jt = None if table is None else jnp.asarray(table)
    jsp, jso = jmsa.backtrack_batch(jnp.asarray(want), jnp.asarray(cenc),
                                    jnp.asarray(arr), jnp.asarray(slens),
                                    sub_table=jt, has_sub=protein)
    sp, so = msa.backtrack_batch(
        got, torch.from_numpy(cenc), torch.from_numpy(arr),
        torch.from_numpy(slens),
        None if table is None else torch.from_numpy(table))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(so.numpy(), np.asarray(jso))
    center = seqs[0]
    for k, s in enumerate(seqs[1:]):
        g_sp, g_so = msa.backtrack(got[k, :, :len(s) + 1].numpy(), center, s,
                                   table)
        w_sp, w_so = jmsa.backtrack(want[k, :, :len(s) + 1], center, s, table)
        np.testing.assert_array_equal(g_sp, w_sp)
        np.testing.assert_array_equal(g_so, w_so)
        np.testing.assert_array_equal(sp[k].numpy(), g_sp)
        np.testing.assert_array_equal(so[k, :len(s) + 1].numpy(), g_so)


def test_find_center_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(3):
        seqs = [random_seq(rng, int(rng.integers(5, 40))) for _ in range(6)]
        seqs.append(seqs[2] + "N")
        assert msa.find_center_sequence(seqs) == jmsa.find_center_sequence(
            seqs)
    assert msa.find_center_sequence(["ACGTACGTACGTACGT"] * 2 + [
        "TTTTGGGGCCCCAAAA"]) in (0, 1)


def _edges():
    return msa_edges(np.random.default_rng(0))


@pytest.mark.parametrize("case", range(5))
def test_msa_edges_match_jax(case, matrix_path):
    label, seqs, protein = _edges()[case]
    path = matrix_path if protein else None
    got = msa.msa(seqs, matrix_path=path, device="cpu")
    assert got == jmsa.msa(seqs, matrix_path=path), label
    aligned, _ = got
    assert len({len(a) for a in aligned}) == 1
    assert [a.replace("-", "") for a in aligned] == seqs


def test_msa_matches_jax_with_a_given_center():
    seqs = _dna_set(6, n=9, L=64)
    for c in (0, 4):
        assert msa.msa(seqs, center_idx=c, device="cpu") == jmsa.msa(
            seqs, center_idx=c)


def test_pairs_in_chunks_match_one_call(monkeypatch, matrix_path):
    seqs = _dna_set(3, n=8)
    prot = _protein_set(5, n=7)
    one = msa.msa(seqs, device="cpu"), msa.msa(prot, matrix_path=matrix_path,
                                               device="cpu")
    calls = []
    real = msa.nw_matrices_batch

    def counted(center, s, table=None):
        calls.append(s.shape[0])
        return real(center, s, table)

    monkeypatch.setattr(msa, "pairs_per_call", lambda dev, m, n: 3)
    monkeypatch.setattr(msa, "nw_matrices_batch", counted)
    assert (msa.msa(seqs, device="cpu"),
            msa.msa(prot, matrix_path=matrix_path, device="cpu")) == one
    assert calls == [3, 3, 1, 3, 3]


def test_the_chunk_rule_leaves_a_fifth_free():
    assert msa.pairs_per_call(torch.device("cpu"), 100, 100) >= 1 << 40
    assert msa.FREE_SHARE == 0.8


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_msa_subcommand_writes_the_jax_bytes(tmp_path, matrix_path):
    seqs = _dna_set(7, n=6, L=70) + ["ACGTTGCA" * 9]
    fa = tmp_path / "in.fasta"
    fa.write_text("".join(f">seq{k} sample {k}\n{s[:33]}\n{s[33:]}\n"
                          for k, s in enumerate(seqs)))
    want_out, got_out = tmp_path / "jax.fasta", tmp_path / "port.fasta"
    want = _stdout(jax_main.main, ["msa", str(fa), str(want_out)])
    got = _stdout(torch_main.main, ["msa", str(fa), str(got_out),
                                    "--device", "cpu"])
    assert got == want
    assert got_out.read_bytes() == want_out.read_bytes()
    # -p: read and not used by either subcommand, so the files agree byte
    # for byte on a protein set that the matrix would align otherwise
    prot = _protein_set(9, n=5)
    fa.write_text("".join(f">p{k}\n{s}\n" for k, s in enumerate(prot)))
    want = _stdout(jax_main.main, ["msa", str(fa), str(want_out), "-p",
                                   matrix_path])
    got = _stdout(torch_main.main, ["msa", str(fa), str(got_out), "-p",
                                    matrix_path, "--device", "cpu"])
    assert got == want
    assert got_out.read_bytes() == want_out.read_bytes()
    assert [r.seq for r in read_fasta(str(got_out))] == jmsa.msa(prot)[0]
    assert jmsa.msa(prot, matrix_path=matrix_path)[0] != jmsa.msa(prot)[0]


def _score(ci, sj, table):
    if table is not None:
        return int(table[ci, sj])
    return msa.MATCH if ci == sj else msa.MISMATCH


def _thread_walk(M, cenc, seq, table):
    """A one-thread-a-pair walk (nw.cc:96-150), word by word: (space, so,
    steps, matrix words read), the words the walk needs."""
    m, n = len(cenc), len(seq)
    space, so = np.zeros(m + 1, np.int64), np.zeros(n + 1, np.int64)
    i, j = m, n
    cur, reads, steps = M[i, j], 1, 0
    while i or j:
        steps += 1
        if i > 0 and j > 0:
            s = _score(int(cenc[i - 1]), int(seq[j - 1]), table)
            d = M[i - 1, j - 1]
            reads += 1
            if s + d == cur:
                i, j, cur = i - 1, j - 1, d
                continue
        for k in range(1, max(i, j) + 1):
            run = msa.GAP_START + msa.GAP_EXTEND * k
            if i >= k:
                reads += 1
                if M[i - k, j] + run == cur:
                    so[j] += k
                    i, cur = i - k, M[i - k, j]
                    break
            if j >= k:
                reads += 1
                if M[i, j - k] + run == cur:
                    space[i] += k
                    j, cur = j - k, M[i, j - k]
                    break
        else:
            break
    return space, so, steps, reads


def _walk_constants() -> dict:
    from genomics_tpu_torch import _build

    src = (_build.CSRC / "msa_nw.cu").read_text()
    return {k: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for k, name in (("lanes", "kLanes"), ("diag", "kDiag"),
                            ("run", "kRun"))}


def _round_walk(M, cenc, seq, table, D, K):
    """csrc/msa_nw.cu's backtrack for one pair, lane by lane.  Diagonal
    rounds: lane t < D, t <= min(i, j), at the cell (i-t, j-t), loads its
    diagonal word d_t (t < min(i, j)) and its k = 1 vertical and
    horizontal words; its diagonal holds where s_t + d_t == d_{t-1}; the
    first failure f ends the round's diagonal steps, and lane f's k = 1
    tests against d_{f-1} take the gap step there.  Where k = 1 fails,
    gap rounds of K lengths (lane t at k = base + t + 1, base from 1,
    vertical and horizontal words at once, the least k winning, vertical
    first).  Returns (space, so, rounds, words loaded, ties of a vertical
    and a horizontal hit at the winning k, the longest run of gap steps
    in one direction, the largest k taken)."""
    m, n = len(cenc), len(seq)
    space, so = np.zeros(m + 1, np.int64), np.zeros(n + 1, np.int64)
    i, j = m, n
    cur, loaded, rounds, ties, longest, kmax = M[i, j], 1, 0, 0, 0, 0
    diag, base, streak = True, 0, (None, 0)   # the run: direction, length
    run1 = msa.GAP_START + msa.GAP_EXTEND   # a gap of k = 1

    def gap(vert, horiz, k):
        """Take the gap step of length k (vertical first)."""
        nonlocal i, j, cur, ties, kmax, streak, longest
        ties += vert and horiz
        kmax = max(kmax, k)
        way = "v" if vert else "h"
        streak = (way, k + (streak[1] if streak[0] == way else 0))
        longest = max(longest, streak[1])
        if vert:
            so[j] += k
            i -= k
        else:
            space[i] += k
            j -= k
        cur = M[i, j]

    while i or j:
        rounds += 1
        if diag:
            mn = min(i, j)
            ok, d, vert, horiz = [], [], [], []
            here = cur   # lane t's cell: cur, then lane t - 1's word
            for t in range(D):
                if t > mn:
                    ok.append(False)
                    continue
                it, jt = i - t, j - t
                v = it >= 1 and M[it - 1, jt] + run1 == here
                h = jt >= 1 and M[it, jt - 1] + run1 == here
                loaded += (it >= 1) + (jt >= 1)
                vert.append(v)
                horiz.append(h)
                if t < mn:
                    d.append(M[it - 1, jt - 1])
                    loaded += 1
                    s = _score(int(cenc[it - 1]), int(seq[jt - 1]), table)
                    ok.append(s + d[t] == here)
                    here = d[t]
                else:
                    ok.append(False)
            f = ok.index(False) if False in ok else D
            if f:
                i, j, cur = i - f, j - f, d[f - 1]
                streak = (None, 0)
            if f < D:
                if vert[f] or horiz[f]:
                    gap(vert[f], horiz[f], 1)
                else:
                    diag, base = False, 1
                    if base >= max(i, j):
                        break
            continue
        vert, horiz = [], []
        for t in range(K):
            k = base + t + 1
            run = msa.GAP_START + msa.GAP_EXTEND * k
            loaded += (k <= i) + (k <= j)
            vert.append(k <= i and M[i - k, j] + run == cur)
            horiz.append(k <= j and M[i, j - k] + run == cur)
        hits = [t for t in range(K) if vert[t] or horiz[t]]
        if not hits:
            base += K
            if base >= max(i, j):
                break
            continue
        q = hits[0]
        gap(vert[q], horiz[q], base + q + 1)
        diag = True
    return space, so, rounds, loaded, ties, longest, kmax


@pytest.mark.parametrize("protein", [False, True])
def test_kernel_walk_reads_what_the_plain_version_counts(protein,
                                                         matrix_path):
    seqs = _protein_set(11) if protein else _dna_set(12, n=8)
    table = load_scoring_matrix(matrix_path) if protein else None
    cenc, arr, slens = msa.pack_pairs(seqs, 0)
    t = None if table is None else torch.from_numpy(table)
    M = msa.nw_matrices_batch(torch.from_numpy(cenc), torch.from_numpy(arr), t)
    stats = {}
    sp, so = msa.backtrack_batch_plain(M, torch.from_numpy(cenc),
                                       torch.from_numpy(arr),
                                       torch.from_numpy(slens), t, stats)
    const = _walk_constants()
    steps = reads = rounds = loaded = most = 0
    for k, n in enumerate(slens):
        w_sp, w_so, st, rd = _thread_walk(M[k].numpy(), cenc, arr[k, :n],
                                          table)
        np.testing.assert_array_equal(sp[k].numpy(), w_sp)
        np.testing.assert_array_equal(so[k, :n + 1].numpy(), w_so)
        *_, ro, ld, _, _, _ = _round_walk(M[k].numpy(), cenc, arr[k, :n], table,
                                       const["diag"], const["run"])
        steps, reads = steps + st, reads + rd
        rounds, loaded, most = rounds + ro, loaded + ld, max(most, ro)
    assert stats == {"steps": steps, "reads": reads, "rounds": rounds,
                     "loaded": loaded, "max_rounds": most}
    assert reads > steps   # the sets hold gaps: some steps search k-runs
    assert rounds < steps  # a round takes many diagonal steps
    assert loaded > reads  # and loads words past its first failure


def _walk_sets(matrix_path):
    """(label, seqs, table or None): a DNA and a protein set, the MSA
    edges and the backtrack's edges."""
    sets = [("dna", _dna_set(21, n=9, L=90), None),
            ("protein", _protein_set(22, n=7, L=60),
             load_scoring_matrix(matrix_path))]
    edges = (msa_edges(np.random.default_rng(0))
             + backtrack_edges(np.random.default_rng(1)))
    sets += [(label, seqs, load_scoring_matrix(matrix_path) if protein
              else None) for label, seqs, protein in edges]
    return sets


@pytest.mark.parametrize("case", range(12))
def test_round_walk_matches_plain_jax_and_host(case, matrix_path):
    """The backtrack's rounds, D diagonal words and K gap lengths a round
    as csrc/msa_nw.cu declares them, give the gap counts of the plain
    version, the JAX backtrack_batch and the host backtrack, and the
    rounds and words the plain version counts."""
    label, seqs, table = _walk_sets(matrix_path)[case]
    const = _walk_constants()
    D, K = const["diag"], const["run"]
    assert (D, K) == (msa.BACKTRACK_DIAG, msa.BACKTRACK_RUN)
    cenc, arr, slens = msa.pack_pairs(seqs, 0)
    c, a, sl = (torch.from_numpy(v) for v in (cenc, arr, slens))
    t = None if table is None else torch.from_numpy(table)
    M = msa.nw_matrices_batch(c, a, t)
    stats = {}
    sp, so = msa.backtrack_batch_plain(M, c, a, sl, t, stats)
    jt = None if table is None else jnp.asarray(table)
    jsp, jso = jmsa.backtrack_batch(jnp.asarray(M.numpy()), jnp.asarray(cenc),
                                    jnp.asarray(arr), jnp.asarray(slens),
                                    sub_table=jt, has_sub=table is not None)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(so.numpy(), np.asarray(jso))
    rounds = loaded = ties = longest = 0
    for k, s in enumerate(seqs[1:]):
        n = len(s)
        w_sp, w_so, ro, ld, ti, lo, _ = _round_walk(M[k].numpy(), cenc,
                                                 arr[k, :n], table, D, K)
        h_sp, h_so = msa.backtrack(M[k, :, :n + 1].numpy(), seqs[0], s, table)
        for got in (w_sp, sp[k].numpy()):
            np.testing.assert_array_equal(got, h_sp)
        for got in (w_so, so[k, :n + 1].numpy()):
            np.testing.assert_array_equal(got, h_so)
        rounds, loaded = rounds + ro, loaded + ld
        ties, longest = ties + ti, max(longest, lo)
    assert (stats["rounds"], stats["loaded"]) == (rounds, loaded), label
    if label == "a sequence of length 1":
        assert min(map(len, seqs)) == 1
    if label == "gap runs longer than 32":
        assert longest > max(32, K)
    if label == "ties at equal k":
        assert ties > 0


def test_wrappers_refuse_what_they_lack():
    c = torch.zeros(3, dtype=torch.uint8)
    s = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        msa.nw_matrices_batch(c.int(), s)
    with pytest.raises(ValueError):
        msa.nw_matrices_batch(c, s, torch.zeros((4, 4), dtype=torch.int32))
    M = msa.nw_matrices_batch(c, s)
    with pytest.raises(ValueError):
        msa.backtrack_batch(M, c, s, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        msa.backtrack_batch(M, c, s, torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("center_idx", [0, 2])
def test_pack_pairs_holds_every_other_sequence(center_idx):
    seqs = ["ACGTA", "AC", "GGGTTTA", "T"]
    cenc, arr, slens = msa.pack_pairs(seqs, center_idx)
    others = [s for k, s in enumerate(seqs) if k != center_idx]
    assert cenc.tobytes() == seqs[center_idx].encode()
    assert arr.dtype == np.uint8 and arr.shape == (3, max(map(len, others)))
    assert slens.dtype == np.int32 and list(slens) == list(map(len, others))
    for row, s in zip(arr, others):
        assert row[:len(s)].tobytes() == s.encode() and not row[len(s):].any()
    cenc, arr, slens = msa.pack_pairs(["ACG"], 0)
    assert arr.shape == (0, 1) and slens.shape == (0,)


def test_the_table_staging_variant_applies_to_the_fill():
    """tools/app_variants.py's shared-memory variant of csrc/msa_nw.cu
    edits this tree's fill once at each spot."""
    from genomics_tpu_torch import _build
    from tools.app_variants import SHARED_TABLE, edits

    src = (_build.CSRC / "msa_nw.cu").read_text()
    out = edits(src, SHARED_TABLE)
    assert "__ldg(table + code" not in out and out.count("__ldg(") == 1
    assert "stab[code[h] + ic]" in out


# -- csrc/msa_nw.cu's fill: its strip schedule, emulated -------------------

UNSET = np.iinfo(np.int64).min


def _fill_constants() -> dict:
    from genomics_tpu_torch import _build

    src = (_build.CSRC / "msa_nw.cu").read_text()
    return {k: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for k, name in (("pairs", "kPairs"), ("rows", "kRows"),
                            ("chunk", "kChunk"), ("max_strips", "kMaxStrips"))}


def _emulate_fill(cenc, seqs, slens, table, pairs, rows, chunk, max_strips):
    """csrc/msa_nw.cu's fill, step by step, on compact codes (table [A, A]
    or None for DNA): blocks of `pairs` pairs, rounds of `strips` strips of
    `rows` rows, strip g of warp w at column t + 1 - (w (chunk + 3) + g)
    at step t, the strip's last row handed on one step later inside a
    warp and through a ring of 2 chunk steps between warps, the ring of
    warp 0 filled a chunk ahead.  Every value a strip takes carries the
    column it belongs to and, from a ring, the chunk that wrote it, and
    the emulation asserts that these are the strip's column and an earlier
    chunk; a round reads only the row the round before wrote.  Returns (M
    [m+1, n_pad+1, B] int64, UNSET where never written, rounds)."""
    m = len(cenc)
    B, n_pad = seqs.shape
    groups = 32 // pairs
    lag_w = chunk + groups - 1
    need = max(1, -(-m // rows))
    rounds = -(-need // max_strips)
    strips = max(-(-need // rounds), chunk)
    strips = -(-strips // groups) * groups
    warps = strips // groups
    M = np.full((m + 1, n_pad + 1, B), UNSET, np.int64)
    by_round = np.full(M.shape, -1)

    def store(i, j, b, v, r):
        assert M[i, j, b] == UNSET, (i, j, b)
        M[i, j, b], by_round[i, j, b] = v, r

    def score(ci, c):
        if table is not None:
            return int(table[ci, c])
        return msa.MATCH if ci == c else msa.MISMATCH

    GSE = msa.GAP_START + msa.GAP_EXTEND
    GE, MIN = msa.GAP_EXTEND, msa.MIN_SCORE
    for b0 in range(0, B, pairs):
        n = [int(slens[b0 + p]) if b0 + p < B else -1 for p in range(pairs)]
        steps = max(n) + (warps - 1) * lag_w + groups - 1
        for r in range(rounds):
            top = r * strips * rows
            # ring[w][slot][p]: (M, Y, code, column, chunk that wrote it)
            ring = [[[(0, 0, 0, -1, -9)] * pairs for _ in range(2 * chunk)]
                    for _ in range(warps)]

            def load(j, p, c):
                b = b0 + p
                if j > n[p]:
                    return None
                code = int(seqs[b, j - 1])
                if r == 0:
                    store(0, j, b, MIN, r)
                    return (MIN, MIN, code, j, c)
                assert 0 <= by_round[top, j, b] < r
                v = int(M[top, j, b])
                return (v, v, code, j, c)

            for lk in range(chunk):
                for p in range(pairs):
                    e = load(lk + 1, p, -1)
                    if e:
                        ring[0][(lk + chunk) % (2 * chunk)][p] = e
            i0 = [top + s * rows + 1 for s in range(strips)]
            live = [[n[p] >= 0 and i0[s] <= m for p in range(pairs)]
                    for s in range(strips)]
            left = [[[MIN] * rows for _ in range(pairs)]
                    for _ in range(strips)]
            x = [[[MIN] * rows for _ in range(pairs)] for _ in range(strips)]
            diag = [[0 if i0[s] == 1 else MIN] * pairs for s in range(strips)]
            out = [[(0, 0, 0, -1)] * pairs for _ in range(strips)]
            for s in range(strips):
                for p in range(pairs):
                    if live[s][p]:
                        for i in range(i0[s], min(i0[s] + rows, m + 1)):
                            store(i, 0, b0 + p, MIN, r)
            if r == 0:
                for p in range(pairs):
                    if n[p] >= 0:
                        store(0, 0, b0 + p, 0, r)
            for c in range(-(-steps // chunk)):
                loads = [[load((c + 1) * chunk + lk + 1, p, c)
                          for p in range(pairs)] for lk in range(chunk)]
                for k in range(chunk):
                    t = c * chunk + k
                    prev = [row[:] for row in out]   # the shuffle's sources
                    for s in range(strips):
                        w, g = divmod(s, groups)
                        j = t + 1 - (w * lag_w + g)
                        for p in range(pairs):
                            if g == 0:
                                e = ring[w][(t + chunk) % (2 * chunk)][p]
                                im, iy, ic, col, wrote = e
                            else:
                                im, iy, ic, col = prev[s - 1][p]
                                wrote = -1
                            if live[s][p] and 1 <= j <= n[p]:
                                assert col == j and wrote < c, (s, p, t)
                                up, y, d = im, iy, diag[s][p]
                                L, X = left[s][p], x[s][p]
                                for h in range(rows):
                                    i = i0[s] + h
                                    ci = int(cenc[i - 1]) if i <= m else 0
                                    y = max(GSE + up, GE + y)
                                    X[h] = max(GSE + L[h], GE + X[h])
                                    v = max(d + score(ci, ic), X[h], y)
                                    d, L[h], up = L[h], v, v
                                    if i <= m:
                                        store(i, j, b0 + p, v, r)
                                diag[s][p] = im
                                out[s][p] = (up, y, ic, j)
                            if g == groups - 1 and w + 1 < warps:
                                ring[w + 1][t % (2 * chunk)][p] = (
                                    *out[s][p], c)
                for lk in range(chunk):
                    for p in range(pairs):
                        if loads[lk][p]:
                            ring[0][(c * chunk + lk) % (2 * chunk)][p] = \
                                loads[lk][p]
    return M, rounds


def _fill_case(case, matrix_path):
    """(cenc, seqs [B, n_pad], sub_table [256, 256] or None) of a case."""
    rng = np.random.default_rng(len(case))
    dna = np.frombuffer(b"ACGT", np.uint8)
    kind, m, lens = case
    if kind == "protein":
        # letters the matrix names, and J, O, U and digits it does not
        letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYJOU09", np.uint8)
        table = load_scoring_matrix(matrix_path)
    else:
        letters, table = dna, None
    cenc = letters[rng.integers(0, len(letters), m)]
    seqs = np.zeros((len(lens), max(max(lens), 1)), np.uint8)
    for k, n in enumerate(lens):
        base = cenc[rng.integers(0, m, n)] if m else letters[:1].repeat(n)
        flip = rng.random(n) < 0.3
        base[flip] = letters[rng.integers(0, len(letters), int(flip.sum()))]
        seqs[k, :n] = base
    return cenc, seqs, table


def _lens(B, lo, hi, seed, zero=True):
    lens = list(np.random.default_rng(seed).integers(lo, hi + 1, B))
    if zero and B > 2:
        lens[1] = 0
    return lens


# (kind, m, the sequences' lengths, (rows, chunk, max_strips) or None for
# the kernel's constants): m below one strip; m not a multiple of the
# strip; 1, 7, 9 and 33 pairs, ragged lengths with 0; protein with bytes
# the matrix does not name; strips of a second warp (m > 4 strips); and
# rounds (2 rows a strip, 8 strips a round)
FILL_CASES = [
    ("dna", 5, _lens(7, 1, 12, 1), None),
    ("dna", 19, [16], None),
    ("dna", 45, _lens(9, 0, 30, 2), None),
    ("dna", 11, _lens(33, 1, 14, 3), None),
    ("protein", 35, _lens(9, 3, 17, 4), None),
    ("dna", 37, _lens(7, 5, 20, 5), (2, 8, 8)),
    ("protein", 40, _lens(9, 0, 9, 6), (2, 4, 8)),
]


@pytest.mark.parametrize("kind,m,lens,shape", FILL_CASES)
def test_fill_strip_schedule_matches_plain_and_jax(kind, m, lens, shape,
                                                   matrix_path):
    const = _fill_constants()
    rows, chunk, max_strips = shape or (const["rows"], const["chunk"],
                                        const["max_strips"])
    cenc, seqs, table = _fill_case((kind, m, lens), matrix_path)
    c, s = torch.from_numpy(cenc), torch.from_numpy(seqs)
    t = None if table is None else torch.from_numpy(table)
    args = msa.fill_args(c, s, t)   # the launch's own inputs, on the CPU
    B, P = len(lens), args[8]
    assert args[9] == B and P % const["pairs"] == 0 and 0 <= P - B < 8
    compact = None if table is None else args[3].numpy()
    got, rounds = _emulate_fill(args[0].numpy(), args[1].numpy().T,
                                args[2].numpy(), compact, const["pairs"],
                                rows, chunk, max_strips)
    assert not args[2][B:].any()   # the pads: pairs of length 0
    # the pads: column 0 written, nothing past it
    assert (got[:, 0, B:] != UNSET).all() and (got[:, 1:, B:] == UNSET).all()
    assert rounds == -(-max(1, -(-m // rows)) // max_strips)
    if shape:
        assert rounds > 1
    want = msa.nw_matrices_batch_plain(c, s, t).numpy()
    jt = None if table is None else jnp.asarray(table)
    jax_M = np.asarray(jmsa.nw_matrices_batch(jnp.asarray(cenc),
                                              jnp.asarray(seqs), jt))
    got = got.transpose(2, 0, 1)
    assert list(args[2][:B].numpy()) == lens
    for k, n in enumerate(lens):   # each pair within its own length only
        np.testing.assert_array_equal(got[k, :, :n + 1], want[k, :, :n + 1])
        np.testing.assert_array_equal(got[k, :, :n + 1], jax_M[k, :, :n + 1])
        assert (got[k, :, n + 1:] == UNSET).all()


def test_fill_constants_are_the_wrappers():
    const = _fill_constants()
    assert (msa.FILL_PAIRS, msa.FILL_ROWS) == (const["pairs"], const["rows"])
    assert msa.FILL_ROUND_ROWS == const["rows"] * const["max_strips"]
    assert 4 * msa.FILL_PAIRS == 32   # a warp: 8 pairs x 4 strips


def test_round_walk_searches_past_a_round_and_breaks_a_tie():
    """A hand-made matrix (not a fill's: with GAP_START = 0 a fill's gaps
    are runs of k = 1) whose walk takes k = 40, past one round of K gap
    lengths, three times: vertical from (70, 40) where a horizontal run of
    40 ties with it, horizontal from (30, 40), vertical from (30, 0) to the
    end; every diagonal test fails.  The rounds, the plain version, the
    JAX backtrack_batch and the host backtrack agree."""
    const = _walk_constants()
    D, K = const["diag"], const["run"]
    rng = np.random.default_rng(3)
    m, n = 70, 40
    dna = np.frombuffer(b"ACGT", np.uint8)
    cenc, seq = dna[rng.integers(0, 4, m)], dna[rng.integers(0, 4, n)]
    M = -rng.choice(10 ** 8, (m + 1, n + 1), replace=False).astype(np.int32)
    M[70, 40], M[30, 40], M[70, 0] = 0, 40, 40   # the tie at k = 40
    M[30, 0], M[0, 0] = 80, 110
    w_sp, w_so, rounds, loaded, ties, longest, kmax = _round_walk(
        M, cenc, seq, None, D, K)
    assert (ties, kmax) == (1, 40) and kmax > K
    # three gap events: a diagonal round (k = 1 fails) and ceil(39 / K)
    # or ceil(29 / K) gap rounds from k = 2 each
    assert rounds == 3 + 2 * -(-39 // K) + -(-29 // K)
    h_sp, h_so = msa.backtrack(M, cenc.tobytes().decode(),
                               seq.tobytes().decode())
    np.testing.assert_array_equal(w_sp, h_sp)
    np.testing.assert_array_equal(w_so, h_so)
    assert (w_so[40], w_sp[30], w_so[0]) == (40, 40, 30)
    stats = {}
    sp, so = msa.backtrack_batch_plain(
        torch.from_numpy(M)[None], torch.from_numpy(cenc),
        torch.from_numpy(seq)[None], torch.tensor([n], dtype=torch.int32),
        None, stats)
    jsp, jso = jmsa.backtrack_batch(jnp.asarray(M)[None], jnp.asarray(cenc),
                                    jnp.asarray(seq)[None],
                                    jnp.asarray([n]))
    for got_sp, got_so in ((sp.numpy(), so.numpy()),
                           (np.asarray(jsp), np.asarray(jso))):
        np.testing.assert_array_equal(got_sp[0], h_sp)
        np.testing.assert_array_equal(got_so[0], h_so)
    assert (stats["rounds"], stats["loaded"]) == (rounds, loaded)


def _launch_walk(args, D, K):
    """msa_nw_backtrack_launch over `backtrack_args`, on the CPU: each of
    the launch's B pairs walked by rounds, reading M's storage at pitch
    P; returns (space, so, the pairs whose words were read)."""
    store, cenc, seqsT, slens, table, A, space, so, m, n_pad, P, B = args
    assert store.shape == (m + 1, n_pad + 1, P) and seqsT.shape == (n_pad, B)
    read = set()

    class Pair:   # M[i, j] of pair b, recording the pair read
        def __init__(self, b):
            self.b = b

        def __getitem__(self, ij):
            read.add(self.b)
            return int(store[ij[0], ij[1], self.b])

    tab = None if table is None else table.numpy()
    space, so = space.clone(), so.clone()
    for b in range(B):
        n = int(slens[b])
        sp, s_o, *_ = _round_walk(Pair(b), cenc.numpy(), seqsT[:n, b].numpy(),
                                  tab, D, K)
        space[b], so[b, :n + 1] = torch.from_numpy(sp), torch.from_numpy(s_o)
    return space, so, read


def test_backtrack_args_read_the_padded_storage_in_place(matrix_path):
    """The fill's [m+1, n_pad+1, P] storage (P: B rounded up to whole
    sectors) goes to the backtrack as it is, with its pitch P apart from
    the pair count B: the launch walks B pairs and never a pad, and its
    gap counts are the plain version's; any other layout is copied to
    [m+1, n_pad+1, B]; no pairs, no pads."""
    const = _walk_constants()
    for seqs, table in ((_dna_set(13, n=10, L=20), None),
                        (_protein_set(14, n=4), load_scoring_matrix(
                            matrix_path))):
        cenc, arr, slens = msa.pack_pairs(seqs, 0)
        c, a, sl = (torch.from_numpy(v) for v in (cenc, arr, slens))
        t = None if table is None else torch.from_numpy(table)
        B, (m1, n1) = len(slens), (len(cenc) + 1, arr.shape[1] + 1)
        want = msa.nw_matrices_batch_plain(c, a, t)
        P = -(-B // msa.FILL_PAIRS) * msa.FILL_PAIRS
        store = torch.full((m1, n1, P), -7, dtype=torch.int32)
        store[:, :, :B] = want.permute(1, 2, 0)
        view = store.permute(2, 0, 1)[:B]
        args = msa.backtrack_args(view, c, a, sl, t)
        assert args[0].data_ptr() == store.data_ptr() and args[10:] == (P, B)
        assert P > B and args[2].shape == (n1 - 1, B) and len(args[3]) == B
        assert args[6].shape == (B, m1) and args[7].shape == (B, n1)
        sp, so, read = _launch_walk(args, const["diag"], const["run"])
        assert read == set(range(B))   # every pair walked, no pad
        w_sp, w_so = msa.backtrack_batch_plain(want, c, a, sl, t)
        assert torch.equal(sp, w_sp) and torch.equal(so, w_so)
        args = msa.backtrack_args(want, c, a, sl, t)
        assert args[10:] == (B, B) and args[0].is_contiguous()
        assert torch.equal(args[0], want.permute(1, 2, 0))
        empty = msa.backtrack_args(view[:0], c, a[:0], sl[:0], t)
        assert empty[10:] == (0, 0)
