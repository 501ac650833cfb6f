"""The port's read mapper against the JAX package's on the CPU: every
`Mapping` field equal for each of the five seeders under each two_stage,
the report modes, re-seeding, two contigs, map_stream and map_pairs with
and without rescue; MAPQ over a grid of scores; SAM and BAM bytes equal,
BAM read back by either package; the set-BWT index, the wavelet tree and
the nvFM-server loop.  Inputs come from numpy seeds; tolerance zero."""
import dataclasses
import io

import numpy as np
import pytest
import torch

from genomics_tpu.index import setbwt as jsetbwt
from genomics_tpu.index import wavelet as jwavelet
from genomics_tpu.index.fmindex import FMIndex as JFMIndex
from genomics_tpu.models import mapq as jmapq
from genomics_tpu.models.mapper import ReadMapper as JReadMapper
from genomics_tpu.utils import bamio as jbamio
from genomics_tpu.utils import samio as jsamio
from genomics_tpu_torch.index import setbwt, wavelet
from genomics_tpu_torch.index.fmindex import FMIndex
from genomics_tpu_torch.models import mapq
from genomics_tpu_torch.models.mapper import ReadMapper, revcomp
from genomics_tpu_torch.ops import fm_search, myers
from genomics_tpu_torch.utils import bamio, samio

SEEDERS = ("qgram", "fm", "hybrid", "smem", "fmdev")
TWO_STAGE = (False, "ungapped", "ed")


def _seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate(rng, s, sub=0.01, indel=0.005, n_rate=0.003):
    out = []
    for c in s:
        r = rng.random()
        if r < indel / 2:
            continue                                   # deletion
        if r < indel:
            out.append(_seq(rng, int(rng.integers(1, 4))))   # insertion
        if rng.random() < sub:
            c = "ACGT"[("ACGT".index(c) + int(rng.integers(1, 4))) % 4]
        out.append("N" if rng.random() < n_rate else c)
    return "".join(out)


def genome_with_repeats(rng, n, repeats=2, rep_len=300):
    """A random genome with `repeats` segments copied elsewhere (second
    best and MAPQ have something to see)."""
    g = list(_seq(rng, n))
    for _ in range(repeats):
        a, b = rng.integers(0, n - rep_len, 2)
        g[b:b + rep_len] = g[a:a + rep_len]
    return "".join(g)


def reads_from(rng, ref, n, L=100):
    """n reads of about L bases: ~1% substitutions, a few indels, a few Ns,
    half from the reverse strand; the last two unmappable (random, and
    shorter than a seed)."""
    out = []
    for i in range(n - 2):
        p = int(rng.integers(0, len(ref) - L))
        r = _mutate(rng, ref[p:p + L])
        out.append(revcomp(r) if i % 2 else r)
    return out + [_seq(rng, L), "ACGTACGTAC"]


@pytest.fixture(scope="module")
def genome():
    return genome_with_repeats(np.random.default_rng(7), 12000)


@pytest.fixture(scope="module")
def reads(genome):
    return reads_from(np.random.default_rng(8), genome, 40)


def _fields(maps):
    """Every field of every Mapping (nested lists for report modes)."""
    if isinstance(maps, list):
        return [_fields(m) for m in maps]
    if isinstance(maps, tuple):
        return tuple(_fields(m) for m in maps)
    return dataclasses.asdict(maps)


def _pair(genome, **kw):
    return (JReadMapper(genome, **kw),
            ReadMapper(genome, device="cpu", **kw))


@pytest.mark.parametrize("two_stage", TWO_STAGE)
@pytest.mark.parametrize("seeder", SEEDERS)
def test_map_batch_matches_jax(genome, reads, seeder, two_stage):
    jm, tm = _pair(genome, seeder=seeder)
    rs = reads if seeder != "smem" else reads[::2]
    want = jm.map_batch(rs, two_stage=two_stage)
    got = tm.map_batch(rs, two_stage=two_stage)
    assert _fields(got) == _fields(want)
    assert sum(m.pos > 0 for m in got) >= len(rs) // 2


@pytest.mark.parametrize("report", ["all", 2])
@pytest.mark.parametrize("seeder", ["qgram", "fmdev"])
def test_report_modes_match_jax(genome, reads, seeder, report):
    jm, tm = _pair(genome, seeder=seeder, max_candidates=6)
    got = tm.map_batch(reads, report=report)
    assert _fields(got) == _fields(jm.map_batch(reads, report=report))
    assert any(len(row) > 1 for row in got)


@pytest.mark.parametrize("max_reseed", [0, 2])
def test_reseeding_rounds_match_jax(genome, max_reseed):
    rng = np.random.default_rng(max_reseed)
    # dense errors leave reads with weak first-round candidates
    rs = [_mutate(rng, genome[p:p + 100], sub=0.08)
          for p in rng.integers(0, len(genome) - 100, 24)]
    jm, tm = _pair(genome, max_reseed=max_reseed, seed_interval=20)
    assert _fields(tm.map_batch(rs)) == _fields(jm.map_batch(rs))


def test_effort_cap_and_ed_stage_match_jax(genome, reads):
    jm, tm = _pair(genome, max_effort=1, seed_len=12, seed_interval=4)
    assert _fields(tm.map_batch(reads)) == _fields(jm.map_batch(reads))
    assert _fields(tm.map_batch(reads, two_stage="ed")) == \
        _fields(jm.map_batch(reads, two_stage="ed"))


@pytest.mark.parametrize("seeder", ["qgram", "fmdev", "smem"])
def test_two_contigs_match_jax(seeder):
    rng = np.random.default_rng(31)
    contigs = [("chrA", _seq(rng, 5000)), ("chrB", _seq(rng, 4000))]
    rs = reads_from(rng, contigs[0][1], 8) + reads_from(rng, contigs[1][1], 8)
    # a read across the junction of the concatenated text
    rs.append(contigs[0][1][-50:] + contigs[1][1][:50])
    jm = JReadMapper(contigs, seeder=seeder)
    tm = ReadMapper(contigs, seeder=seeder, device="cpu")
    got = tm.map_batch(rs)
    assert _fields(got) == _fields(jm.map_batch(rs))
    assert {m.contig for m in got if m.pos > 0} == {"chrA", "chrB"}


def test_two_bit_reference_array_matches_jax(genome, reads):
    from genomics_tpu_torch.index.qgram import encode2

    codes = encode2(genome)
    jm = JReadMapper(codes, seeder="fmdev")
    tm = ReadMapper(codes, seeder="fmdev", device="cpu")
    assert _fields(tm.map_batch(reads[:12])) == \
        _fields(jm.map_batch(reads[:12]))


def test_map_stream_matches_jax_and_map_batch(genome, reads):
    jm, tm = _pair(genome)
    got = list(tm.map_stream(iter(reads), batch_size=7, two_stage="ed"))
    want = list(jm.map_stream(iter(reads), batch_size=7, two_stage="ed"))
    assert [r for r, _ in got] == reads
    assert [_fields(m) for _, m in got] == [_fields(m) for _, m in want]
    assert [_fields(m) for _, m in got] == \
        _fields(tm.map_batch(reads, two_stage="ed"))


def fr_pairs(rng, ref, n, L=100, lost=0.2):
    """n FR pairs, inserts 300-500; about `lost` of them with one mate made
    unmappable by dense errors, so rescue has something to do."""
    r1, r2 = [], []
    for i in range(n):
        ins = int(rng.integers(300, 501))
        p = int(rng.integers(0, len(ref) - ins))
        a = _mutate(rng, ref[p:p + L])
        b = revcomp(_mutate(rng, ref[p + ins - L:p + ins]))
        if rng.random() < lost:
            b = _mutate(rng, b, sub=0.12)
        if i % 3 == 2:
            a, b = b, a
        r1.append(a)
        r2.append(b)
    return r1, r2


@pytest.mark.parametrize("rescue", [True, False])
def test_map_pairs_matches_jax(genome, rescue):
    r1, r2 = fr_pairs(np.random.default_rng(40), genome, 24)
    jm, tm = _pair(genome)
    got = tm.map_pairs(r1, r2, max_insert=600, rescue=rescue)
    want = jm.map_pairs(r1, r2, max_insert=600, rescue=rescue)
    assert _fields(got) == _fields(want)
    assert sum(a.proper_pair for a, _ in got) >= 12


def test_rescue_recovers_pairs(genome):
    r1, r2 = fr_pairs(np.random.default_rng(41), genome, 24, lost=0.5)
    tm = ReadMapper(genome, device="cpu")
    with_r = tm.map_pairs(r1, r2, max_insert=600)
    without = tm.map_pairs(r1, r2, max_insert=600, rescue=False)
    assert sum(a.proper_pair for a, _ in with_r) > \
        sum(a.proper_pair for a, _ in without)


def test_fmdev_on_the_cpu_takes_the_plain_versions(genome, reads):
    """device="cpu" reaches the FM search and the `ed` stage: neither
    kernel is launched."""
    before = fm_search.LAUNCHES["fm_search"], myers.LAUNCHES["myers"]
    tm = ReadMapper(genome, seeder="fmdev", device="cpu")
    tm.map_batch(reads[:6], two_stage="ed")
    assert tm._dev_fm.rec.device.type == "cpu"
    assert (fm_search.LAUNCHES["fm_search"], myers.LAUNCHES["myers"]) == before


def test_mapper_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ReadMapper("ACGT" * 100)


@pytest.mark.parametrize("monotone", [False, True])
@pytest.mark.parametrize("paired", [False, True])
def test_mapq_matches_jax_over_a_grid(monotone, paired):
    t, j = (mapq.MapqScheme(match=2, monotone=monotone),
            jmapq.MapqScheme(match=2, monotone=monotone))
    for L in (20, 100, 150):
        top = 0 if monotone else 2 * L
        for best in range(-2 * L, top + 1, 7):
            for second in [None, *range(-2 * L, best + 1, 11)]:
                args = (best, second, L)
                assert mapq.bowtie_mapq2(*args, t, paired=paired,
                                         o_read_len=L) == \
                    jmapq.bowtie_mapq2(*args, j, paired=paired, o_read_len=L)
                assert mapq.bowtie_mapq3(*args, t, paired=paired) == \
                    jmapq.bowtie_mapq3(*args, j, paired=paired)


def _single_records(genome, reads, mapper):
    maps = mapper.map_batch(reads)
    return [(f"r{i}", r, m) for i, (r, m) in enumerate(zip(reads, maps))]


def test_sam_and_bam_bytes_match_jax(tmp_path, genome, reads):
    jm, tm = _pair(genome)
    got = _single_records(genome, reads, tm)
    want = _single_records(genome, reads, jm)
    samio.write_sam(str(tmp_path / "t.sam"), "ref", len(genome), got)
    jsamio.write_sam(str(tmp_path / "j.sam"), "ref", len(genome), want)
    bamio.write_bam(str(tmp_path / "t.bam"), "ref", len(genome), got)
    jbamio.write_bam(str(tmp_path / "j.bam"), "ref", len(genome), want)
    for ext in ("sam", "bam"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    assert "@PG\tID:genomics_tpu\tPN:genomics_tpu" in \
        (tmp_path / "t.sam").read_text()


def test_paired_sam_and_bam_bytes_match_jax(tmp_path, genome):
    r1, r2 = fr_pairs(np.random.default_rng(42), genome, 12)
    jm, tm = _pair(genome)
    recs = {}
    for key, m in (("t", tm), ("j", jm)):
        pairs = m.map_pairs(r1, r2, max_insert=600)
        recs[key] = [(f"p{i}", a, x, b, y)
                     for i, (a, b, (x, y)) in enumerate(zip(r1, r2, pairs))]
    contigs = [("ref", len(genome))]
    samio.write_sam_pairs(str(tmp_path / "t.sam"), "ref", len(genome),
                          recs["t"])
    jsamio.write_sam_pairs(str(tmp_path / "j.sam"), "ref", len(genome),
                           recs["j"])
    bamio.write_bam_pairs(str(tmp_path / "t.bam"), contigs, 0, recs["t"])
    jbamio.write_bam_pairs(str(tmp_path / "j.bam"), contigs, 0, recs["j"])
    for ext in ("sam", "bam"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


def test_read_bam_round_trips_across_packages(tmp_path, genome, reads):
    tm = ReadMapper([("c1", genome[:6000]), ("c2", genome[6000:])],
                    device="cpu")
    recs = _single_records(genome, reads, tm)
    contigs = [("c1", 6000), ("c2", len(genome) - 6000)]
    bamio.write_bam(str(tmp_path / "t.bam"), contigs, 0, recs)
    h1, refs1, got = bamio.read_bam(str(tmp_path / "t.bam"))
    h2, refs2, want = jbamio.read_bam(str(tmp_path / "t.bam"))
    assert (h1, refs1) == (h2, refs2) and refs1 == contigs
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    for (name, seq, m), r in zip(recs, got):
        assert r.name == name
        assert r.pos == m.pos - 1 if m.pos > 0 else r.pos == -1
        if m.pos > 0:
            assert r.seq == (revcomp(seq) if m.reverse else seq)
            assert r.ref_id == (0 if m.contig == "c1" else 1)
    data = bytes(range(256)) * 700
    assert bamio.bgzf_decompress(jbamio.bgzf_compress(data)) == data
    assert bamio.bgzf_compress(data) == jbamio.bgzf_compress(data)


def _read_set(rng, n=30):
    return [_seq(rng, int(rng.integers(20, 60))) for _ in range(n)]


def test_set_bwt_matches_jax(tmp_path):
    rng = np.random.default_rng(50)
    rs = _read_set(rng)
    a, b = setbwt.SetFMIndex(rs), jsetbwt.SetFMIndex(rs)
    for f in ("text", "offsets", "bwt", "sa", "C"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    pats = [r[3:9] for r in rs[:8]] + ["A", "ACG", "N", "TTTTTTTTTTTT"]
    for p in pats:
        assert a.count(p) == b.count(p)
        assert a.locate(p, limit=5) == b.locate(p, limit=5)
        assert a.backward_search(p) == b.backward_search(p)
    a.save(str(tmp_path / "t"))
    b.save(str(tmp_path / "j.npz"))
    for x in (setbwt.load_any_index(str(tmp_path / "j")),
              setbwt.SetFMIndex.load(str(tmp_path / "t.npz")),
              jsetbwt.load_any_index(str(tmp_path / "t"))):
        for p in pats:
            assert x.count(p) == a.count(p) and x.locate(p) == a.locate(p)
    with pytest.raises(ValueError, match="ACGT-only"):
        setbwt.SetFMIndex(["ACGN"])


@pytest.mark.parametrize("kind", ["set", "plain"])
def test_serve_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(51)
    rs = _read_set(rng)
    if kind == "set":
        idx, jidx = setbwt.SetFMIndex(rs), jsetbwt.SetFMIndex(rs)
    else:
        idx, jidx = FMIndex("".join(rs)), JFMIndex("".join(rs))
    lines = [rs[0][2:10] + "\n", "  \n", "ACNT\n", rs[3][:5] + "\n", "A\n",
             "QUIT\n", rs[4][:6] + "\n"]
    outs = []
    for fn, ix in ((setbwt.serve, idx), (jsetbwt.serve, jidx)):
        buf = io.StringIO()
        fn(ix, iter(lines), buf, locate_limit=4)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") == 4 and "ACNT\t0\n" in outs[0]


def test_wavelet_tree_matches_jax():
    rng = np.random.default_rng(52)
    data = rng.integers(0, 6, 3000).astype(np.uint8)
    a, b = wavelet.WaveletTree(data, bits=3), jwavelet.WaveletTree(data,
                                                                   bits=3)
    for i in rng.integers(0, 3000, 40):
        assert a.access(int(i)) == b.access(int(i)) == int(data[i])
    for c in range(6):
        for i in (0, 1, 63, 64, 511, 512, 2999, 3000):
            assert a.rank(c, i) == b.rank(c, i) == \
                int((data[:i] == c).sum())
        for k in (0, 1, 5, 10_000):
            assert a.select(c, k) == b.select(c, k)
    s = wavelet.WaveletTree("ACGTTGCA")
    assert s.access(3) == jwavelet.WaveletTree("ACGTTGCA").access(3)
