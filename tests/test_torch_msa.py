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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import msa_edges, mutate, ncbi_matrix, random_seq
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


def _kernel_walk(M, cenc, seq, table):
    """csrc/msa_nw.cu's backtrack for one pair, word by word: (space, so,
    steps, matrix words read)."""
    m, n = len(cenc), len(seq)
    space, so = np.zeros(m + 1, np.int64), np.zeros(n + 1, np.int64)
    i, j = m, n
    cur, reads, steps = M[i, j], 1, 0
    while i or j:
        steps += 1
        if i > 0 and j > 0:
            ci, sj = int(cenc[i - 1]), int(seq[j - 1])
            s = (table[ci, sj] if table is not None
                 else (msa.MATCH if ci == sj else msa.MISMATCH))
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
    steps = reads = 0
    for k, n in enumerate(slens):
        w_sp, w_so, st, rd = _kernel_walk(M[k].numpy(), cenc, arr[k, :n],
                                          table)
        np.testing.assert_array_equal(sp[k].numpy(), w_sp)
        np.testing.assert_array_equal(so[k, :n + 1].numpy(), w_so)
        steps, reads = steps + st, reads + rd
    assert stats == {"steps": steps, "reads": reads}
    assert reads > steps   # the sets hold gaps: some steps search k-runs


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
    assert "__ldg(trow" not in out and out.count("__ldg(") == 1
