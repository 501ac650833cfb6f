"""The port's nGIA (`genomics_tpu_torch.models.ngia`,
`ops/lcs.banded_lcs_accept`'s plain version) against
`genomics_tpu.models.ngia` on the CPU, integer-equal: `_prepare`'s
arrays, one round (`round_body`) and the speculative window
(`accept_body`) at the band's edges and where the band's f32 fma matters,
`cluster_distributed` serial and speculative, and the `ngia`
subcommand's stdout and file.  Reads stay at 32 de-gapped bases or more
and similarity below 1 under `speculate > 1` (ROADMAP C1)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from genomics_tpu import __main__ as jcli
from genomics_tpu.models import ngia as JN
from genomics_tpu_torch import __main__ as tcli
from genomics_tpu_torch.models import ngia as TN
from genomics_tpu_torch.ops import lcs

# (rep net, read net, similarity) where the band rounds differently in
# separately rounded f32 and in the fma JAX's CPU compile makes of it
FMA_PAIRS = [(203, 180, 0.95), (113, 90, 0.9)]


def families(rng, fam=3, per=4, L=(120, 300), noisy=True):
    seqs = []
    for _ in range(fam):
        base = rng.choice(list("ACGT"), int(rng.integers(*L)))
        for _ in range(per):
            s = base.copy()
            for pos in rng.integers(0, len(s), int(rng.integers(0, 8))):
                s[pos] = rng.choice(list("ACGT"))
            if noisy and rng.random() < 0.5:
                for pos in rng.integers(0, len(s), 3):
                    s[pos] = rng.choice(list("-NacgtU"))
            cut = int(rng.integers(0, 12))
            seqs.append("".join(s[cut:]))
    return seqs


def test_prepare_matches_jax():
    rng = np.random.default_rng(0)
    seqs = families(rng) + ["", "A", "AC", "ACG", "ACGT", "NNa-cgU", "acgtn"]
    seqs += ["".join(rng.choice(list("ACGTN-acgu"), int(n)))
             for n in rng.integers(0, 90, 12)]
    want = JN._prepare(seqs)
    got = TN._prepare(seqs)
    for name, x, y in zip(("order", "lengths", "net", "words", "low", "high",
                           "codes"), want, got):
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _arrays(seqs):
    order, lengths, net, words, low, high, codes = TN._prepare(seqs)
    return net, TN._device_arrays(net, words, low, high, codes,
                                  torch.device("cpu")), (
        jnp.asarray(words), jnp.asarray(net, jnp.int32), jnp.asarray(low),
        jnp.asarray(high), jnp.asarray(codes))


def paired(rng, pairs):
    """Reads with one representative and one job of each (rep net, read
    net): the job a mutated prefix of the representative, so that the LCS
    lands near the cutoff."""
    seqs = []
    for rn, qn, _ in pairs:
        rep = rng.choice(list("ACGT"), rn)
        job = rep[:qn].copy()
        for pos in rng.integers(0, qn, max(qn // 40, 1)):
            job[pos] = rng.choice(list("ACGT"))
        seqs += ["".join(rep), "".join(job)]
    return seqs


def test_shift_is_the_fma_jax_computes():
    """shift_of == the jitted expression of ngia.py:113-116 over every job
    net below three representatives, and the two FMA_PAIRS differ from
    separately rounded f32 (the trap the port avoids)."""
    for sim in (0.95, 0.9, 0.8):
        @jax.jit
        def band(rep_net, net, sim=sim):
            shift_f = jnp.ceil(rep_net.astype(jnp.float32)
                               - net.astype(jnp.float32) * sim)
            return jnp.ceil(shift_f / 32.0).astype(jnp.int32)
        for rep in (203, 1213, 1500):
            nets = np.arange(0, rep + 1, dtype=np.int32)
            want = np.asarray(band(jnp.int32(rep), jnp.asarray(nets)))
            got = lcs.shift_of(torch.tensor(rep), torch.from_numpy(nets), sim)
            assert np.array_equal(got.numpy(), want), (sim, rep)
    for rn, qn, sim in FMA_PAIRS:
        f32 = np.float32
        naive = np.ceil(np.ceil(f32(rn) - f32(qn) * f32(sim)) / f32(32))
        assert int(lcs.shift_of(torch.tensor(rn), torch.tensor(qn), sim)) \
            != int(naive)


@pytest.mark.parametrize("sim", [0.95, 0.9, 0.8])
def test_round_body_matches_plain(sim):
    """Every round of a greedy pass: JAX's round_body and the plain
    banded_lcs_accept(cluster=) from the same cluster array, until every
    read is clustered.  The reads hold the fma pairs and a representative
    whose band reaches past the row's last word."""
    rng = np.random.default_rng(int(sim * 100))
    seqs = families(rng, fam=3, per=3) + paired(rng, FMA_PAIRS + [
        (260, 250, sim), (70, 40, sim)])
    net, arrays, jarr = _arrays(seqs)
    W, Lq = jarr[2].shape[1], jarr[4].shape[1]
    round_step, _ = JN._round_step_factory(sim, W, Lq)
    N = len(seqs)
    cl_j = jnp.full((N,), -1, jnp.int32)
    cl_t = torch.full((N,), -1, dtype=torch.int32)
    every = torch.arange(N, dtype=torch.int32)
    rounds = 0
    while (np.asarray(cl_j) == -1).any():
        rep = int(np.argmax(np.asarray(cl_j) == -1))
        cl_j = round_step(cl_j, jnp.int32(rep), *jarr)
        TN._accept(arrays, torch.tensor([rep], dtype=torch.int32), every, sim,
                   cl_t)
        assert np.array_equal(cl_t.numpy(), np.asarray(cl_j)), rounds
        rounds += 1
    assert 2 < rounds < N


@pytest.mark.parametrize("sim", [0.95, 0.9])
def test_spec_accept_matches_plain(sim):
    """accept_body's [S, J] window against the plain version, full width
    and with JAX's own band window, for S of 1, 7 and all reads against J
    not a multiple of 32."""
    rng = np.random.default_rng(int(sim * 1000))
    seqs = families(rng, fam=4, per=3) + paired(rng, FMA_PAIRS)
    net, arrays, jarr = _arrays(seqs)
    W, Lq, N = jarr[2].shape[1], jarr[4].shape[1], len(seqs)
    jobs = np.arange(2, N - 1, dtype=np.int32)
    maxs = int(max(np.ceil(np.ceil(float(net.max())
                                   - float(net.min()) * sim) / 32.0), 0))
    for S in (1, 7, N):
        reps = rng.choice(N, S, replace=False).astype(np.int32)
        got = TN._accept(arrays, torch.from_numpy(reps),
                         torch.from_numpy(jobs), sim)
        assert got.dtype == torch.uint8
        for window in (-1, maxs):
            body = JN._spec_accept_factory(sim, W, Lq, S, window)
            want = np.asarray(body(jnp.asarray(reps), jnp.asarray(jobs),
                                   *jarr))
            assert np.array_equal(got.numpy(), want), (S, window)
        inside = (reps >= 2) & (reps < N - 1)      # a rep accepts itself
        assert got.numpy()[np.nonzero(inside)[0], reps[inside] - 2].all()


def test_fma_pairs_accept_as_jax_does():
    """The two FMA_PAIRS' jobs against their representatives: the port's
    accept == accept_body's where the naive band would differ."""
    rng = np.random.default_rng(31)
    for rn, qn, sim in FMA_PAIRS:
        seqs = paired(rng, [(rn, qn, sim)])
        net, arrays, jarr = _arrays(seqs)
        body = JN._spec_accept_factory(sim, jarr[2].shape[1],
                                       jarr[4].shape[1], 2, -1)
        reps = np.array([0, 1], np.int32)
        jobs = np.array([0, 1], np.int32)
        want = np.asarray(body(jnp.asarray(reps), jnp.asarray(jobs), *jarr))
        got = TN._accept(arrays, torch.from_numpy(reps),
                         torch.from_numpy(jobs), sim).numpy()
        assert np.array_equal(got, want)


def test_plain_counts_its_work():
    """stats: every pair through the filter, the LCS pairs, the band
    words each step runs below ceil(rep net / 32), and one pair's most
    active steps."""
    seqs = paired(np.random.default_rng(32), [(100, 90, 0.9)])
    net, arrays, _ = _arrays(seqs)
    a = arrays
    stats = {}
    lcs.banded_lcs_accept_plain(
        a["words"], a["net"], a["low"], a["high"], a["codes"],
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([1], dtype=torch.int32), 0.9, stats=stats)
    # shift = ceil(ceil(100 - 81) / 32) = 1: words [iw - 1, iw + 1] of the
    # representative's 4, for query words iw = 0, 1, 2 (90 bases)
    assert stats == {"filtered": 1, "pairs": 1, "steps": 90,
                     "word_steps": 32 * 2 + 32 * 3 + 26 * 3, "longest": 90}


@pytest.mark.parametrize("speculate", [1, 2, 4, 8])
def test_cluster_distributed_matches_jax(speculate):
    rng = np.random.default_rng(40 + speculate)
    seqs = families(rng, fam=4, per=4)
    seqs += ["".join(rng.choice(list("ACGT"), int(rng.integers(100, 200))))
             for _ in range(4)]
    want = JN.cluster_distributed(seqs, 0.9, speculate=speculate)
    got = TN.cluster_distributed(seqs, 0.9, speculate=speculate,
                                 device="cpu")
    assert np.array_equal(got.cluster, want.cluster)
    assert np.array_equal(got.order, want.order)
    assert got.n_clusters == want.n_clusters < len(seqs)


def test_serial_rounds_size_the_band_from_the_reads_left(monkeypatch):
    """A short read widens the band only until it is clustered: each host
    check (here every round) sizes the next rounds' band from the reads
    still unclustered, and the clustering stays the JAX package's."""
    rng = np.random.default_rng(60)
    seqs = families(rng, fam=3, per=3, L=(280, 300), noisy=False)
    seqs.append(seqs[0][:40])
    seen = []
    accept = TN._accept

    def spy(*args, **bounds):
        seen.append(bounds["max_shift"])
        return accept(*args, **bounds)

    monkeypatch.setattr(TN, "ROUNDS", 1)
    monkeypatch.setattr(TN, "_accept", spy)
    got = TN.cluster_distributed(seqs, 0.9, device="cpu")
    want = JN.cluster_distributed(seqs, 0.9)
    assert np.array_equal(got.cluster, want.cluster)
    net = TN._prepare(seqs)[2]
    assert seen[0] == lcs.max_shift_of(net, net, 0.9) >= 8
    assert seen == sorted(seen, reverse=True) and seen[-1] <= 2


def test_a_read_failing_its_own_filter_raises():
    """A representative of under 4 bases fails its own word filter, so a
    serial round never assigns it: the JAX loop spins forever, the port
    raises."""
    with pytest.raises(RuntimeError, match="no progress"):
        TN.cluster_distributed(["ACGTACGTAC" * 5, "AC"], device="cpu")


def test_mesh_is_not_ported():
    """The mesh path is ported now (tests/test_torch_parallel.py runs it
    over 2 and 4 gloo ranks): on a one-rank mesh without a process group
    its serial rounds give the one-device clustering and JAX's, and with
    speculate > 1 the mesh is ignored (C2)."""
    from genomics_tpu_torch.parallel import data_mesh

    seqs = families(np.random.default_rng(70), fam=3, per=4)
    want = JN.cluster_distributed(seqs, 0.9)
    for spec in (1, 4):
        got = TN.cluster_distributed(seqs, 0.9, speculate=spec,
                                     mesh=data_mesh(device="cpu"))
        assert np.array_equal(got.cluster, want.cluster)
        assert got.n_clusters == want.n_clusters


def test_ngia_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """`cluster: N` and the representatives' FASTA, byte for byte."""
    seqs = families(np.random.default_rng(50), fam=3, per=3)
    src = tmp_path / "in.fa"
    src.write_text("".join(f">q{i} x\n{s}\n" for i, s in enumerate(seqs)))
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        capsys.readouterr()
        main(["ngia", "-i", str(src), "-o", "reps.fa", "-s", "0.9", *extra])
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"] and outs["jax"].startswith("cluster: ")
    assert ((tmp_path / "port" / "reps.fa").read_bytes()
            == (tmp_path / "jax" / "reps.fa").read_bytes())


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """Wrong types, non-contiguous indices or codes, inputs on two devices
    and a round of two representatives raise before any pointer is
    taken."""
    seqs = families(np.random.default_rng(60), fam=2, per=2)
    net, a, _ = _arrays(seqs)
    args = [a[k] for k in ("words", "net", "low", "high", "codes")]
    ok = torch.arange(len(seqs), dtype=torch.int32)
    bad = [(ok.long(), ok), (ok, ok.repeat(2)[::2]), (ok[:2], ok)]
    for reps, jobs in bad[:2]:
        with pytest.raises(ValueError):
            lcs.banded_lcs_accept(*args, reps, jobs, 0.9)
    with pytest.raises(ValueError, match="one representative"):
        lcs.banded_lcs_accept(*args, *bad[2], 0.9,
                              cluster=torch.full((len(seqs),), -1,
                                                 dtype=torch.int32))
    wide = torch.zeros((len(seqs), 2 * a["codes"].shape[1]),
                       dtype=torch.uint8)
    with pytest.raises(ValueError, match="contiguous rows"):
        lcs.banded_lcs_accept(*args[:4], wide[:, ::2], ok, ok, 0.9)
    with pytest.raises(ValueError, match="the reads on"):
        lcs.lcs_accept(a["low"], a["high"], a["net"], a["codes"], a["net"],
                       ok, ok.to("meta"))
