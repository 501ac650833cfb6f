"""The port's greedy clustering (`genomics_tpu_torch.models.cluster`,
`ops/lcs.lcs_accept`'s plain version) against `genomics_tpu.models.cluster`
on the CPU, integer-equal: `_prepare`'s arrays, the bit-parallel LCS
(also against the DP gold), the device filters (`ops/cluster_filter`'s
plain version at the kernel's edges, and a lane-by-lane emulation of
csrc/cluster_filter.cu), the accept matrices,
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
from genomics_tpu_torch.ops import cluster_filter as CF
from genomics_tpu_torch.ops import lcs

from chip_smoke import FILTER_EDGES, filter_edge_inputs
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
    got = CF.word_min_sum(torch.from_numpy(Dr), torch.from_numpy(Dj), 3)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def jax_filters(D, prefix, wcut, bcut, reps, jobs, K):
    """The JAX _filters_dev's (p2, any column) over numpy inputs, the job
    columns padded to a multiple of 8 (its bit packing) and cut back."""
    J = len(jobs)
    pad = np.concatenate([jobs, np.resize(jobs, -J % 8)])
    p2, bits = JC._filters_dev(
        jnp.asarray(D), jnp.asarray(prefix, jnp.int32),
        jnp.asarray(wcut, jnp.int32), jnp.asarray(bcut, jnp.int32),
        jnp.asarray(reps, jnp.int32), jnp.asarray(pad, jnp.int32), K)
    anyv = np.unpackbits(np.asarray(bits), axis=1, bitorder="little")[0]
    return np.asarray(p2)[:, :J], anyv[:J] != 0


def port_filters(packed, prefix, wcut, bcut, reps, jobs, bins, K):
    """The port's window_filters on CPU tensors, as numpy."""
    p2, anyv = CF.window_filters(
        torch.from_numpy(packed), *(torch.from_numpy(
            np.ascontiguousarray(x, np.int32)) for x in (prefix, wcut, bcut,
                                                         reps, jobs)),
        bins, K)
    assert p2.dtype == torch.uint8 and anyv.dtype == torch.bool
    return p2.numpy(), anyv.numpy()


@pytest.mark.parametrize("budget", [None, 1 << 12])
def test_filters_match_jax(budget, monkeypatch):
    """The port's window filters (the plain version on the CPU) == the JAX
    _filters_dev (p2 and its any-column vector), also in chunks of 8 job
    columns under a small byte budget (C3); the packed words' dense rows
    == the JAX package's dense matrix."""
    if budget:
        monkeypatch.setattr(CF, "FILTER_BUDGET", budget)
        assert CF.filter_chunk(1 << 10, 2) == 8
    seqs = families(np.random.default_rng(12), fam=5, per=4)
    wl = 5
    p = TC._prepare(seqs, 0.9, wl)
    K = TC._dense_k(p, wl)
    packed = TC._packed_dev(p, CPU)
    D = CF.dense_rows(packed, torch.arange(len(seqs)), 1 << 2 * wl)
    reps = np.array([0, 1, 5, 9, 13], np.int32)
    jobs = np.arange(2, len(seqs), dtype=np.int32)
    jp = JC._prepare(seqs, 0.9, wl)
    Dj, Kj = JC._dense_counts(jp, wl)
    assert Kj == K and np.array_equal(np.asarray(Dj), D.numpy())
    want_p2, want_any = jax_filters(Dj, jp.prefix, jp.word_cutoff,
                                    jp.base_cutoff, reps, jobs, K)
    p2, anyv = port_filters(packed.numpy(), p.prefix, p.word_cutoff,
                            p.base_cutoff, reps, jobs, 1 << 2 * wl, K)
    assert np.array_equal(p2, want_p2) and np.array_equal(anyv, want_any)
    assert want_p2.any() and not want_p2.all()


@pytest.mark.parametrize("budget", [None, 1 << 12])
@pytest.mark.parametrize("edge", FILTER_EDGES, ids=[e[0] for e in
                                                    FILTER_EDGES])
def test_filters_match_jax_at_the_kernels_edges(edge, budget, monkeypatch):
    if budget:
        monkeypatch.setattr(CF, "FILTER_BUDGET", budget)
    _, wl, K, S, J = edge
    words, counts, prefix, wcut, bcut, reps, jobs, D = filter_edge_inputs(
        *edge)
    want_p2, want_any = jax_filters(D, prefix, wcut, bcut, reps, jobs, K)
    packed = CF.pack_words(words, counts)
    p2, anyv = port_filters(packed, prefix, wcut, bcut, reps, jobs,
                            1 << 2 * wl, K)
    assert p2.shape == (S, J)
    assert np.array_equal(p2, want_p2) and np.array_equal(anyv, want_any)
    assert want_p2.any() and (J == 1 or not want_p2.all())


def emulate_kernel(packed, prefix, wcut, bcut, reps, jobs, bins, warps=2,
                   wave=8):
    """csrc/cluster_filter.cu lane by lane in numpy: the blocks of each
    group of R representatives (tables of 4^wl + ROW_PAD bytes zeroed,
    then scattered), the tiles of 32 jobs each group of R lanes of `warps`
    warps a block takes from its representatives' ticket in turn, each
    group walking a job's words 16 slots at a time to the first slot of
    count 0 (none where no lane passes the prefix filter), the lanes'
    mins and sums in 16-bit halves (two slots a pair, folded every FOLD
    quads), the lanes' 32-bit masks spread to bytes
    (two 16-byte stores a full tile), the OR of a group's masks setting
    any[].  The launch's blocks as the entry point counts them for a card
    holding `wave` blocks.  Returns (pass2 [S, ldp] with 7 where nothing
    was written, any [J])."""
    S, J = len(reps), len(jobs)
    lay = CF.filter_layout(torch.from_numpy(packed), *(torch.from_numpy(x)
                           for x in (prefix, wcut, bcut, reps, jobs)), bins)
    wq, R, ldp = lay[1], lay[9], lay[12]
    flat = packed.view(np.uint32)
    groups, tiles, per = -(-S // R), -(-J // CF.TILE), 32 // R
    chunks = max(1, min(wave // groups, -(-tiles // (warps * per))))
    pass2 = np.full((S, ldp), 7, np.uint8)
    anyv = np.zeros(J, np.uint8)
    tickets = [0] * groups
    tables = {}
    for block in range(groups * chunks):
        g = block // chunks
        tab = np.zeros((bins + CF.ROW_PAD) * R, np.uint8)
        for i in range(R * 4 * wq):
            r, k = divmod(i, 4 * wq)
            if g * R + r < S:
                v = int(flat[reps[g * R + r], k])
                if v & 0xFFFF:
                    tab[r * (bins + CF.ROW_PAD) + (v >> 16)] = min(
                        v & 0xFFFF, 255)
        tables[block] = tab
    # every lane group of every block takes tickets in turn until its
    # representatives' tiles run out
    takers = [(block, warp, grp) for block in range(groups * chunks)
              for warp in range(warps) for grp in range(per)]
    while any(tickets[b // chunks] < tiles for b, _, _ in takers):
        for block, _, _ in takers:
            g = block // chunks
            tile = tickets[g]
            tickets[g] += 1
            if tile >= tiles:
                continue
            tab = tables[block]
            j0 = tile * CF.TILE
            n = min(CF.TILE, J - j0)
            masks = [0] * R
            for t in range(n):
                j = jobs[j0 + t]
                pre = [int(np.minimum(prefix[reps[g * R + r]] if g * R + r
                                      < S else np.zeros(4), prefix[j]).sum())
                       for r in range(R)]
                first = [x >= bcut[j] for x in pre]
                for r in range(R):
                    got = 0
                    if any(first):          # else no lane can pass
                        acc = 0
                        for q in range(0, wq, 4):
                            quads = [[int(v) for v in flat[j, 4 * u:4 * u + 4]]
                                     for u in range(q, q + 4)]
                            for a, b in (x for quad in quads
                                         for x in (quad[:2], quad[2:])):
                                row = r * (bins + CF.ROW_PAD)
                                lo = min(int(tab[row + (a >> 16)]),
                                         a & 0xFFFF)
                                hi = min(int(tab[row + (b >> 16)]),
                                         b & 0xFFFF)
                                acc = (acc + (hi << 16 | lo)) & 0xFFFFFFFF
                            if (q + 4) % CF.FOLD == 0:
                                got += (acc & 0xFFFF) + (acc >> 16)
                                acc = 0
                            if quads[3][3] & 0xFFFF == 0:
                                break
                        got += (acc & 0xFFFF) + (acc >> 16)
                    ok = first[r] and got >= wcut[j]
                    masks[r] |= int(ok) << t
            for r in range(R):
                s, mask = g * R + r, masks[r]
                if s >= S:
                    mask = 0
                elif n == CF.TILE:
                    spread = [((mask >> 4 * i & 15) * 0x00204081)
                              & 0x01010101 for i in range(8)]
                    pass2[s, j0:j0 + 32] = np.array(
                        spread, np.uint32).view(np.uint8)
                else:
                    pass2[s, j0:j0 + n] = [mask >> t & 1 for t in range(n)]
                masks[r] = mask
            hit = np.bitwise_or.reduce(masks)
            for t in range(n):
                if hit >> t & 1:
                    anyv[j0 + t] = 1
    return pass2, anyv


@pytest.mark.parametrize("edge", FILTER_EDGES, ids=[e[0] for e in
                                                    FILTER_EDGES])
def test_kernel_emulation_matches_plain(edge):
    """The kernel's lookup order, tiles, masks and any[] == the plain
    version at its edges: every column below J written once, the row
    padding untouched."""
    _, wl, K, S, J = edge
    words, counts, prefix, wcut, bcut, reps, jobs, _ = filter_edge_inputs(
        *edge)
    packed = CF.pack_words(words, counts)
    want_p2, want_any = port_filters(packed, prefix, wcut, bcut, reps, jobs,
                                     1 << 2 * wl, K)
    p2, anyv = emulate_kernel(packed, prefix, wcut, bcut, reps, jobs,
                              1 << 2 * wl)
    assert np.array_equal(p2[:, :J], want_p2)
    assert (p2[:, J:] == 7).all()
    assert np.array_equal(anyv != 0, want_any)


def test_filter_layout_and_rows():
    """R (representatives a block): 32, halved below twice S and to the
    shared memory (8 at wl = 7); tables of 4^wl + 4 bytes; pass2's rows
    padded to 16 bytes, the work bytes any [J] and then a ticket a group
    at byte ldp; packed rows of a multiple of 16 slots, word << 16 |
    count."""
    assert [CF.rep_rows(s, 4096) for s in (1, 2, 3, 5, 16, 17, 256)] == \
        [1, 2, 4, 8, 16, 32, 32]
    assert CF.rep_rows(256, 1 << 14) == 8 and CF.rep_rows(3, 1 << 14) == 4
    with pytest.raises(ValueError, match="shared memory"):
        CF.rep_rows(1, 1 << 18)
    w = np.array([[3, 9, 0], [5, 0, 0]], np.uint16)
    c = np.array([[1, 300, 0], [2, 0, 0]], np.uint16)
    packed = CF.pack_words(w, c)
    assert packed.shape == (2, 16) and packed.dtype == np.int32
    assert list(packed.view(np.uint32)[0]) == [3 << 16 | 1, 9 << 16 | 255
                                               ] + [0] * 14
    z = torch.zeros(2, dtype=torch.int32)
    lay = CF.filter_layout(torch.from_numpy(packed),
                           torch.zeros((2, 4), dtype=torch.int32), z, z,
                           torch.zeros(3, dtype=torch.int32),
                           torch.zeros(17, dtype=torch.int32), 256)
    assert len(lay) + 1 == len(CF._ARGS)
    assert lay[1] == 4 and lay[6] == 3 and lay[8] == 17
    assert lay[9:11] == (4, 256) and lay[11].shape == (3, 32)
    assert lay[12] == 32 and lay[13].shape == (32 + 4 * 1,)
    with pytest.raises(ValueError, match="packed"):
        CF.filter_layout(torch.zeros((2, 8), dtype=torch.int32), *lay[2:6],
                         lay[7], 256)


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
    assert TC._dense_k(p, 8) == -1
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
