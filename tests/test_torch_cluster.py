"""The port's greedy clustering (`genomics_tpu_torch.models.cluster`,
`ops/lcs.lcs_accept`'s plain version) against `genomics_tpu.models.cluster`
on the CPU, integer-equal: `_prepare`'s arrays, the bit-parallel LCS
(also against the DP gold), the device filters, the accept matrices,
`cluster_reads` serial and speculative, and the `cluster` subcommand's
stdout and file."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu import __main__ as jcli
from genomics_tpu.models import cluster as JC
from genomics_tpu_torch import __main__ as tcli
from genomics_tpu_torch.models import cluster as TC
from genomics_tpu_torch.ops import lcs

from test_models_cluster import lcs_gold

CPU = torch.device("cpu")


def families(rng, fam=4, per=4, L=(90, 200), noisy=True):
    """Reads of `fam` families of `per` members, a few substitutions each;
    with `noisy`, some gaps, Ns, lowercase bases and U."""
    seqs = []
    for _ in range(fam):
        base = rng.choice(list("ACGT"), int(rng.integers(*L)))
        for _ in range(per):
            s = base.copy()
            for pos in rng.integers(0, len(s), int(rng.integers(0, 6))):
                s[pos] = rng.choice(list("ACGT"))
            if noisy and rng.random() < 0.5:
                for pos in rng.integers(0, len(s), 3):
                    s[pos] = rng.choice(list("-NacgtU"))
            seqs.append("".join(s))
    return seqs


def planes(codes: np.ndarray, W: int):
    """(low, high) uint32 words of 2-bit codes."""
    pad = np.zeros(W * 32, np.uint8)
    pad[: len(codes)] = codes
    pb = pad.reshape(W, 32).astype(np.uint32)
    sh = np.arange(32, dtype=np.uint32)
    return (((pb & 1) << sh).sum(1, dtype=np.uint64).astype(np.uint32),
            (((pb >> 1) & 1) << sh).sum(1, dtype=np.uint64).astype(np.uint32))


@pytest.mark.parametrize("threshold,wl,seed", [
    (0.95, 0, 0), (0.9, 0, 1), (0.85, 0, 2), (0.98, 0, 3), (0.95, 4, 4)])
def test_prepare_matches_jax(threshold, wl, seed):
    seqs = families(np.random.default_rng(seed))
    wl = wl or JC.auto_word_length(threshold)
    a = JC._prepare(seqs, threshold, wl)
    b = TC._prepare(seqs, threshold, wl)
    for f in ("order", "lengths", "prefix", "words", "word_counts",
              "word_cutoff", "base_cutoff", "net_lengths", "low", "high",
              "codes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def lcs_texts(rng):
    """Texts and queries at the word edges: nets of 1, 31-33, 63-65, 96,
    a random mix, and a query of net 0."""
    nets = [1, 31, 32, 33, 63, 64, 65, 96] + list(rng.integers(2, 140, 6))
    return [rng.integers(0, 4, n).astype(np.uint8) for n in nets]


def test_lcs_matches_jax_and_the_gold():
    rng = np.random.default_rng(7)
    texts = lcs_texts(rng)
    queries = lcs_texts(rng) + [np.zeros(0, np.uint8)]
    W = max(len(t) for t in texts) // 32 + 1
    Lq = max(len(q) for q in queries)
    tl, th = map(np.stack, zip(*(planes(t, W) for t in texts)))
    tn = np.array([len(t) for t in texts], np.int32)
    qc = np.full((len(queries), Lq), 255, np.uint8)
    for i, q in enumerate(queries):
        qc[i, : len(q)] = q
    qn = np.array([len(q) for q in queries], np.int32)
    want = np.asarray(JC._lcs_multi(jnp.asarray(tl), jnp.asarray(th),
                                    jnp.asarray(tn), jnp.asarray(qc),
                                    jnp.asarray(qn)))
    S, B = len(texts), len(queries)
    r = np.repeat(np.arange(S), B)
    c = np.tile(np.arange(B), S)
    got = lcs._row_lcs(
        torch.from_numpy(tl[r].astype(np.int64)),
        torch.from_numpy(th[r].astype(np.int64)),
        torch.from_numpy(tn[r]), torch.from_numpy(qc[c]),
        torch.from_numpy(qn[c])).numpy().reshape(S, B)
    assert np.array_equal(got, want)
    for s in range(0, S, 3):
        for b in range(0, B, 2):
            assert got[s, b] == lcs_gold(texts[s], queries[b]), (s, b)


def _aux(p):
    return TC._aux_dev(p, CPU)


@pytest.mark.parametrize("gated", [False, True])
def test_lcs_accept_plain_matches_lcs_multi(gated):
    """lcs_accept (the CPU tensors' plain version) == _lcs_multi's
    matched > base_cutoff[job], ANDed with the gate."""
    seqs = families(np.random.default_rng(8), fam=3, per=5)
    p = TC._prepare(seqs, 0.9, 5)
    aux = _aux(p)
    rng = np.random.default_rng(9)
    reps = np.array([0, 4, 7, 11], np.int64)
    jobs = np.arange(len(seqs))
    gate = (rng.random((len(reps), len(jobs))) < 0.7 if gated
            else np.ones((len(reps), len(jobs)), bool))
    matched = np.asarray(JC._lcs_multi(
        jnp.asarray(p.low[reps]), jnp.asarray(p.high[reps]),
        jnp.asarray(p.net_lengths[reps], jnp.int32), jnp.asarray(p.codes[jobs]),
        jnp.asarray(p.net_lengths[jobs], jnp.int32)))
    want = gate & (matched > p.base_cutoff[jobs][None, :])
    got = lcs.lcs_accept(
        aux["low"], aux["high"], aux["net"], aux["codes"], aux["bcut"],
        torch.from_numpy(reps.astype(np.int32)),
        torch.from_numpy(jobs.astype(np.int32)),
        torch.from_numpy(gate.astype(np.uint8)) if gated else None)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy() != 0, want)


def test_lcs_accept_counts_its_work():
    """stats: the gated pairs, their active steps, the word-steps over
    each representative's ceil(net / 32) words, and one pair's most
    active steps."""
    seqs = families(np.random.default_rng(10), fam=2, per=3, noisy=False)
    p = TC._prepare(seqs, 0.9, 5)
    aux = _aux(p)
    reps = torch.tensor([0, 3], dtype=torch.int32)
    jobs = torch.arange(len(seqs), dtype=torch.int32)
    gate = torch.ones((2, len(seqs)), dtype=torch.uint8)
    gate[1, 0] = 0
    stats = {}
    lcs.lcs_accept_plain(aux["low"], aux["high"], aux["net"], aux["codes"],
                         aux["bcut"], reps, jobs, gate, stats=stats)
    net = p.net_lengths
    want_steps = int(net.sum()) * 2 - int(net[0])
    want_words = sum(int(net[j]) * int((net[r] + 31) // 32)
                     for r in (0, 3) for j in range(len(seqs))
                     if not (r == 3 and j == 0))
    assert stats == {"pairs": 2 * len(seqs) - 1, "steps": want_steps,
                     "word_steps": want_words, "longest": int(net.max())}


def test_word_min_sum_is_the_min_sum():
    rng = np.random.default_rng(11)
    Dr = rng.integers(0, 4, (5, 64)).astype(np.uint8)
    Dj = rng.integers(0, 4, (9, 64)).astype(np.uint8)
    want = np.minimum(Dr[:, None, :], Dj[None, :, :]).sum(-1)
    got = TC.word_min_sum(torch.from_numpy(Dr), torch.from_numpy(Dj), 3)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("budget", [None, 1 << 12])
def test_filters_match_jax(budget, monkeypatch):
    """The port's _filters_dev == the JAX one (p2 and its any-column
    vector), also in chunks of 8 job columns under a small byte budget
    (C3)."""
    if budget:
        monkeypatch.setattr(TC, "FILTER_BUDGET", budget)
        assert TC.filter_chunk(1 << 10, 2) == 8
    seqs = families(np.random.default_rng(12), fam=5, per=4)
    wl = 5
    p = TC._prepare(seqs, 0.9, wl)
    D, K = TC._dense_counts(p, wl, CPU)
    aux = _aux(p)
    reps = np.array([0, 1, 5, 9, 13], np.int32)
    jobs = np.arange(2, len(seqs), dtype=np.int32)
    jp = JC._prepare(seqs, 0.9, wl)
    Dj, Kj = JC._dense_counts(jp, wl)
    assert Kj == K and np.array_equal(np.asarray(Dj), D.numpy())
    jaux = JC._aux_dev(jp)
    want_p2, want_bits = JC._filters_dev(
        Dj, jaux["prefix"], jaux["wcut"], jaux["bcut"], jnp.asarray(reps),
        jnp.asarray(np.concatenate([jobs, jobs[:-len(jobs) % 8]])), K)
    want_p2 = np.asarray(want_p2)[:, : len(jobs)]
    want_any = np.unpackbits(np.asarray(want_bits), axis=1,
                             bitorder="little")[0, : len(jobs)]
    p2, anyv = TC._filters_dev(D, aux["prefix"], aux["wcut"], aux["bcut"],
                               torch.from_numpy(reps), torch.from_numpy(jobs),
                               K)
    assert np.array_equal(p2.numpy(), want_p2)
    assert np.array_equal(anyv.numpy(), want_any != 0)
    assert want_p2.any() and not want_p2.all()


@pytest.mark.parametrize("seed,threshold", [(13, 0.9), (14, 0.95)])
def test_accept_matrix_matches_host_and_jax(seed, threshold):
    seqs = families(np.random.default_rng(seed), fam=5, per=4)
    wl = TC.auto_word_length(threshold)
    p = TC._prepare(seqs, threshold, wl)
    reps = np.array([0, 2, 4, 9])
    jobs = np.arange(1, len(seqs))
    dev = TC._accept_matrix(p, reps, jobs, wl, 7, CPU)
    host = TC._accept_matrix_host(p, reps, jobs, wl, 7, CPU)
    want = JC._accept_matrix(JC._prepare(seqs, threshold, wl), reps, jobs, wl,
                             4096, s_pad=8)
    assert dev.dtype == bool and np.array_equal(dev, host)
    assert np.array_equal(dev, want) and want.any()


@pytest.mark.parametrize("speculate", [1, 2, 4, 8])
@pytest.mark.parametrize("seed,threshold", [(15, 0.95), (16, 0.9)])
def test_cluster_reads_match_jax(speculate, seed, threshold):
    rng = np.random.default_rng(seed)
    seqs = families(rng, fam=5, per=4)
    seqs += ["".join(rng.choice(list("ACGT"), int(rng.integers(40, 120))))
             for _ in range(5)]
    want = JC.cluster_reads(seqs, threshold=threshold, speculate=speculate)
    got = TC.cluster_reads(seqs, threshold=threshold, speculate=speculate,
                           batch_cap=5, device="cpu")
    assert np.array_equal(got.cluster, want.cluster)
    assert np.array_equal(got.order, want.order)
    assert got.n_clusters == want.n_clusters < len(seqs)


def test_wide_words_take_the_host_filters():
    """wl = 8 (4^8 bins) is past the dense matrix: the host filters, the
    same clustering as the JAX package's, serial and speculative."""
    seqs = families(np.random.default_rng(17), fam=3, per=3)
    p = TC._prepare(seqs, 0.95, 8)
    assert TC._dense_counts(p, 8, CPU) == (None, -1)
    for speculate in (1, 4):
        want = JC.cluster_reads(seqs, 0.95, word_length=8,
                                speculate=speculate)
        got = TC.cluster_reads(seqs, 0.95, word_length=8,
                               speculate=speculate, device="cpu")
        assert np.array_equal(got.cluster, want.cluster)


def _run(main, argv, workdir, capsys, monkeypatch):
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["-t", "0.9", "-w", "5", "-g", "4"]])
def test_cluster_cli_matches_jax(extra, tmp_path, capsys, monkeypatch):
    """stdout and the representatives' FASTA byte for byte; -g is read and
    dropped in both (C20)."""
    seqs = families(np.random.default_rng(18), fam=4, per=3)
    src = tmp_path / "in.fa"
    src.write_text("".join(f">r{i} some words\n{s[:60]}\n{s[60:]}\n"
                           for i, s in enumerate(seqs)))
    argv = ["cluster", "-i", str(src), "-o", "reps.fa", *extra]
    out_j = _run(jcli.main, argv, tmp_path / "jax", capsys, monkeypatch)
    out_t = _run(tcli.main, [*argv, "--device", "cpu"], tmp_path / "port",
                 capsys, monkeypatch)
    assert out_t == out_j and out_j.startswith("clusters: ")
    assert ((tmp_path / "port" / "reps.fa").read_bytes()
            == (tmp_path / "jax" / "reps.fa").read_bytes())


def test_cluster_reads_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TC.cluster_reads(["ACGT" * 10])


def test_buckets_and_layouts(monkeypatch):
    """The lane-group buckets (G x K words: the smallest that holds the
    launch's widest row or band, at most 128: wider pairs run a warp
    each), and layouts that give each C parameter but the stream:
    per-read arrays in place (the codes' rows padded to 16 bytes), the
    gate and out at row stride J, rows in shared memory up to
    SHARED_WORDS words, past it a global scratch of [S, blocks of
    CHUNK_MIN columns, WARPS, words] in chunks under SCRATCH_BYTES, and
    thread_min (a thread a pair in blocks of THREAD_MIN pairs) only where
    the rows are up to THREAD_WORDS words and in shared memory."""
    assert [lcs.cluster_bucket(w) for w in (0, 1, 3, 5, 32, 33, 65, 129)] \
        == [1, 1, 4, 8, 32, 64, 128, 128]
    assert [lcs.ngia_bucket(s) for s in (-3, 0, 1, 2, 3, 15, 16, 31, 32,
                                         64)] == \
        [1, 1, 4, 8, 8, 32, 64, 64, 128, 128]
    seqs = families(np.random.default_rng(19), fam=2, per=5)
    p = TC._prepare(seqs, 0.9, 5)
    aux = _aux(p)
    args = [aux[k] for k in ("low", "high", "net", "codes", "bcut")]
    S, J = 3, len(seqs)
    rp = torch.arange(S, dtype=torch.int32)
    jb = torch.arange(J, dtype=torch.int32)
    gate = torch.ones((S, J), dtype=torch.uint8)
    out = torch.empty((S, J), dtype=torch.uint8)
    (lay,) = lcs.lcs_layouts(*args, rp, jb, gate, out, 7)
    assert len(lay) + 1 == len(lcs._CLUSTER_ARGS)
    assert lay[0] is aux["low"] and lay[4] is aux["codes"]
    assert lay[5] == aux["codes"].stride(0) == 16 * -(-p.codes.shape[1]
                                                      // 16)
    assert lay[13:17] == (J, 7, 8, lcs.THREAD_MIN)
    assert lay[-1] is None
    (lay,) = lcs.lcs_layouts(*args, rp, jb, gate, out, lcs.THREAD_WORDS + 1)
    assert lay[14:17] == (lcs.THREAD_WORDS + 1, 128, 0)
    (lay,) = lcs.lcs_layouts(*args, rp, jb, gate, out, lcs.SHARED_WORDS)
    assert lay[14:17] == (lcs.SHARED_WORDS, 128, 0) and lay[-1] is None
    monkeypatch.setattr(lcs, "CHUNK_MIN", 2)
    monkeypatch.setattr(lcs, "SCRATCH_BYTES",
                        2 * 4 * S * lcs.WARPS * (lcs.SHARED_WORDS + 1))
    lays = lcs.lcs_layouts(*args, rp, jb, gate, out, lcs.SHARED_WORDS + 1)
    assert [x[10] for x in lays] == [4] * (J // 4) + [J % 4] * (J % 4 > 0)
    for k, x in enumerate(lays):
        assert x[11].data_ptr() == gate[:, 4 * k:].data_ptr()
        assert x[12].data_ptr() == out[:, 4 * k:].data_ptr()
        assert x[-1].numel() == (S * -(-x[10] // 2) * lcs.WARPS
                                 * (lcs.SHARED_WORDS + 1))
        assert x[15:17] == (128, 0)
    words = torch.zeros((J, 256), dtype=torch.int16)
    (nl,) = lcs.banded_layouts(words, aux["net"], aux["low"], aux["high"],
                               aux["codes"], rp, jb, 0.95, None, out, 7, 2)
    assert len(nl) + 1 == len(lcs._NGIA_ARGS)
    assert nl[11] == float(np.float32(0.95))
    assert nl[12] == float(np.float32(1.0 - 0.95))
    assert nl[16:19] == (7, 8, lcs.THREAD_MIN) and nl[-1] is None
