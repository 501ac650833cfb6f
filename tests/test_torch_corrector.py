"""The port's error correctors (`genomics_tpu_torch.models.corrector`,
`index/bloom.py`, `runtime.native.lighter_pass3`) against
`genomics_tpu.models.corrector` on the CPU: the Bloom filters' words,
Lighter's thresholds and trusted filter, every corrected read and count;
the native walk against the Python walk (its plain version); and
`python -m genomics_tpu_torch lighter` byte for byte against `python -m
genomics_tpu lighter`."""
import os

import numpy as np
import pytest

from genomics_tpu import __main__ as jcli
from genomics_tpu.index import bloom as jbloom
from genomics_tpu.models import corrector as JC
from genomics_tpu_torch import __main__ as tcli
from genomics_tpu_torch.index import bloom as tbloom
from genomics_tpu_torch.models import corrector as TC
from genomics_tpu_torch.runtime import native


def sampled_reads(seed, genome_len=3000, n=700, L=90, errors=4,
                  alphabet="ACGTN"):
    """Reads cut from a random genome with up to errors - 1 bases
    replaced by another of `alphabet` (N included by default)."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    reads = []
    for _ in range(n):
        p = rng.integers(0, len(genome) - L)
        r = list(genome[p:p + L])
        for q in rng.choice(L, size=rng.integers(0, errors), replace=False):
            r[q] = rng.choice([c for c in alphabet if c != r[q]])
        reads.append("".join(r))
    return genome, reads


def lighters(reads, genome_len, **kw):
    out = []
    for mod in (JC, TC):
        c = mod.LighterCorrector(k=17, genome_size=genome_len,
                                 bloom_bits=1 << 20, seed=3, **kw)
        c.build(reads)
        out.append(c)
    return out


def test_bloom_matches_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 40, 500, dtype=np.uint64)
    probes = np.concatenate([keys[:100],
                             rng.integers(0, 1 << 40, 300, dtype=np.uint64)])
    for n_bits in (1 << 12, 3001):
        j, t = jbloom.BloomFilter(n_bits, k=4), tbloom.BloomFilter(n_bits,
                                                                   k=4)
        j.insert(keys)
        t.insert(keys)
        np.testing.assert_array_equal(t.words, j.words)
        np.testing.assert_array_equal(t.query(probes), j.query(probes))
        assert [t.query_one(int(k)) for k in probes] == [
            j.query_one(int(k)) for k in probes]


def test_kmer_corrector_matches_jax():
    genome, reads = sampled_reads(1, 3000, 200, 100, 2, "ACGT")
    got, want = (mod.KmerCorrector(k=15, trust_threshold=3)
                 for mod in (TC, JC))
    got.build(reads)
    want.build(reads)
    np.testing.assert_array_equal(got.bloom.words, want.bloom.words)
    assert got.correct_batch(reads[:60]) == want.correct_batch(reads[:60])


def test_lighter_build_matches_jax():
    """Passes 1 and 2: the sampled and trusted filters' words, the
    threshold table and the filter's false-positive rate."""
    genome, reads = sampled_reads(7)
    want, got = lighters(reads, len(genome))
    np.testing.assert_array_equal(got.sampled.words, want.sampled.words)
    np.testing.assert_array_equal(got.trusted.words, want.trusted.words)
    np.testing.assert_array_equal(got.threshold, want.threshold)
    assert got.fp_rate == want.fp_rate and got._alpha == want._alpha


@pytest.mark.parametrize("quals", [False, True], ids=["q40", "quals"])
def test_native_walk_equals_python_walk(quals):
    """native/lighter.cpp's walk against the Python walk it transcribes,
    on reads with Ns, reads shorter than K and, with quals, bases at or
    below bad_quality weighing half in the correction cap."""
    genome, reads = sampled_reads(7)
    reads += [reads[0][:10], reads[1][:17], "N" * 40]
    _, corr = lighters(reads, len(genome), bad_quality=20,
                       max_correction=2.0)
    q = None
    if quals:
        rng = np.random.default_rng(9)
        q = [rng.integers(2, 41, len(r)).astype(np.int64) for r in reads]
    native_out = corr.correct_batch(reads, quals=q)
    python_out = corr.correct_batch(reads, quals=q, use_native=False)
    assert native_out == python_out
    assert any(c > 0 for _, c in native_out)
    assert any(c < 0 for _, c in native_out)


def test_lighter_matches_jax():
    genome, reads = sampled_reads(11, n=500)
    want, got = lighters(reads, len(genome))
    assert got.correct_batch(reads) == want.correct_batch(reads)
    assert [got.correct(r) for r in reads[:40]] == [
        want.correct(r) for r in reads[:40]]


def test_reads_past_the_native_buffers_take_the_python_walk():
    """The JAX package's rule: a batch with a read past 4,096 bases runs
    the Python walk (lighter.cpp's stack buffers hold 4,096), and the
    native entry refuses such a batch itself."""
    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 5000))
    reads = [genome[p:p + 100] for p in rng.integers(0, 4900, 600)]
    _, corr = lighters(reads, len(genome))
    long = list(genome[:4100])
    long[2000] = "A" if long[2000] != "A" else "C"
    batch = [reads[0], "".join(long)]
    assert corr.correct_batch(batch) == corr.correct_batch(
        batch, use_native=False)
    with pytest.raises(ValueError, match="4096"):
        native.lighter_pass3(np.zeros((1, 4100), np.uint8),
                             np.array([4100], np.int32),
                             corr.trusted.words, corr.trusted.n_bits, 4, 17,
                             4.0, -1)


def test_a_missing_library_raises(monkeypatch):
    """No fallback: where the native library does not build or load,
    correct_batch raises instead of running the Python walk."""
    genome, reads = sampled_reads(7, n=100)
    _, corr = lighters(reads, len(genome))

    def broken():
        raise RuntimeError("building libgenomics_native.so failed")
    monkeypatch.setattr(native, "library", broken)
    with pytest.raises(RuntimeError, match="failed"):
        corr.correct_batch(reads)
    assert corr.correct_batch(reads, use_native=False)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_lighter_cli_matches_jax(fmt, tmp_path, capsys, monkeypatch):
    """Each subcommand's stdout and corrected FASTA, byte for byte."""
    genome, reads = sampled_reads(13, n=300)
    src = tmp_path / f"reads.{'fa' if fmt == 'fasta' else 'fq'}"
    with open(src, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i} x\n{r}\n" if fmt == "fasta" else
                     f"@r{i} x\n{r}\n+\n{'I' * len(r)}\n")
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        main(["lighter", "-i", str(src), "-o", "out.fa", "-g",
              str(len(genome)), "--bloom-bits", str(1 << 20)])
        outs[name] = (capsys.readouterr().out, (d / "out.fa").read_bytes())
    assert outs["port"] == outs["jax"]
    assert os.path.getsize(tmp_path / "port" / "out.fa") > 0
    assert "corrected" in outs["port"][0]
