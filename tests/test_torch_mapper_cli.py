"""`python -m genomics_tpu_torch index | fmquery | fmserver | extract | map`
against `python -m genomics_tpu` on the same inputs, on the CPU: the same
stdout bytes and the same SAM, BAM and text files; an `.npz` index
written by either package loads in the other with equal arrays.  Both
`main`s run in this process, each from a directory of its own, so that
the paths they print are the same."""
import io
import os
import sys

import numpy as np
import pytest
import torch

from genomics_tpu import __main__ as jcli
from genomics_tpu.index import fmindex as jfm
from genomics_tpu.index import setbwt as jsetbwt
from genomics_tpu_torch import __main__ as tcli
from genomics_tpu_torch.index import fmindex, setbwt

from test_torch_mapper import fr_pairs, genome_with_repeats, reads_from


def _write_fasta(path, recs):
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i:i + 70] + "\n")


def _write_fastq(path, recs):
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f"@{name} extra words\n{seq}\n+\n{'I' * len(seq)}\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("in")
    rng = np.random.default_rng(60)
    c1 = genome_with_repeats(rng, 7000)
    c2 = genome_with_repeats(rng, 5000)
    reads = reads_from(rng, c1, 14) + reads_from(rng, c2, 12)
    r1, r2 = fr_pairs(rng, c1, 10)
    paths = {k: str(d / f) for k, f in (
        ("ref", "ref.fa"), ("ref1", "one.fa"), ("reads", "reads.fastq"),
        ("reads_fa", "reads.fa"), ("m1", "m1.fq"), ("m2", "m2.fq"),
        ("set", "set.fa"))}
    _write_fasta(paths["ref"], [("chr1 first", c1), ("chr2", c2)])
    _write_fasta(paths["ref1"], [("chr1", c1)])
    _write_fastq(paths["reads"], [(f"r{i}", r) for i, r in enumerate(reads)])
    _write_fasta(paths["reads_fa"], [(f"r{i}", r)
                                     for i, r in enumerate(reads)])
    _write_fastq(paths["m1"], [(f"p{i}", r) for i, r in enumerate(r1)])
    _write_fastq(paths["m2"], [(f"p{i}", r) for i, r in enumerate(r2)])
    _write_fasta(paths["set"], [(f"s{i}", c1[i * 50:i * 50 + 40])
                                for i in range(20)])
    return paths


def _run(main, argv, workdir, capsys, monkeypatch, stdin=None):
    """main(argv) run in `workdir`; returns its stdout."""
    os.makedirs(workdir, exist_ok=True)
    monkeypatch.chdir(workdir)
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _both(argv, tmp_path, capsys, monkeypatch, files=(), stdin=None,
          port_extra=()):
    """Run both CLIs on argv; assert equal stdout and equal bytes of each
    of `files` (paths relative to each run's directory); returns the two
    directories."""
    dj, dt = tmp_path / "jax", tmp_path / "port"
    out_j = _run(jcli.main, argv, dj, capsys, monkeypatch, stdin)
    out_t = _run(tcli.main, [*argv, *port_extra], dt, capsys, monkeypatch,
                 stdin)
    assert out_t == out_j
    for f in files:
        assert (dt / f).read_bytes() == (dj / f).read_bytes(), f
    return dj, dt, out_t


@pytest.mark.parametrize("sa_rate", [None, 4])
def test_index_matches_and_files_cross_load(inputs, tmp_path, capsys,
                                            monkeypatch, sa_rate):
    argv = ["index", "-r", inputs["ref"], "-o", "idx"]
    if sa_rate:
        argv += ["--sa-rate", str(sa_rate)]
    dj, dt, out = _both(argv, tmp_path, capsys, monkeypatch)
    assert out.startswith("indexed 12000 bp (2 sequences")
    a = fmindex.load_index(str(dj / "idx.npz"))   # JAX's file, port's loader
    b = jfm.load_index(str(dt / "idx.npz"))       # and the reverse
    for f in ("n", "bwt", "C", "ckpt", "occ_rate", "sa_rate"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    rows = np.arange(a.n)
    np.testing.assert_array_equal(a.sa_values(rows), b.sa_values(rows))
    with np.load(dj / "idx.npz") as zj, np.load(dt / "idx.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k])


def test_index_set_bwt_matches_and_cross_loads(inputs, tmp_path, capsys,
                                              monkeypatch):
    argv = ["index", "-r", inputs["set"], "-o", "sidx", "--set-bwt"]
    dj, dt, out = _both(argv, tmp_path, capsys, monkeypatch)
    assert out.startswith("set-BWT over 20 reads")
    a = setbwt.load_any_index(str(dj / "sidx"))
    b = jsetbwt.load_any_index(str(dt / "sidx.npz"))
    assert isinstance(a, setbwt.SetFMIndex)
    for f in ("text", "offsets", "bwt", "sa", "C"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("locate", [False, True])
@pytest.mark.parametrize("kind", ["plain", "set"])
def test_fmquery_matches(inputs, tmp_path, capsys, monkeypatch, kind,
                         locate):
    ref = inputs["ref"] if kind == "plain" else inputs["set"]
    extra = ["--set-bwt"] if kind == "set" else []
    _both(["index", "-r", ref, "-o", "x", *extra], tmp_path, capsys,
          monkeypatch)
    with open(inputs["set"]) as fh:
        seqs = [ln.strip() for ln in fh if not ln.startswith(">")]
    pats = [seqs[0][:8], seqs[3][5:17], "ACGTACGTACGTACGTTT", "A", seqs[7]]
    for own in ("jax", "port"):       # each package's file, both programs
        argv = ["fmquery", "-x", str(tmp_path / own / "x.npz"), "-p", *pats]
        if locate:
            argv.append("--locate")
        _, _, out = _both(argv, tmp_path / f"q-{own}", capsys, monkeypatch)
        assert out.count("\n") == len(pats)


@pytest.mark.parametrize("kind", ["plain", "set"])
def test_fmserver_matches(inputs, tmp_path, capsys, monkeypatch, kind):
    ref = inputs["ref1"] if kind == "plain" else inputs["set"]
    extra = ["--set-bwt"] if kind == "set" else []
    _both(["index", "-r", ref, "-o", "x", *extra], tmp_path, capsys,
          monkeypatch)
    with open(inputs["set"]) as fh:
        seqs = [ln.strip() for ln in fh if not ln.startswith(">")]
    stdin = "\n".join([seqs[1][:10], "ACGNT", "", seqs[2][4:9], "C", "QUIT",
                       seqs[5][:8]]) + "\n"
    _, _, out = _both(["fmserver", "-x", str(tmp_path / "port" / "x.npz"),
                       "--locate-limit", "3"], tmp_path / "s", capsys,
                      monkeypatch, stdin=stdin)
    assert out.startswith("ready\n") and "ACGNT\t0\n" in out
    assert out.count("\n") == 5


@pytest.mark.parametrize("ref", ["ref", "ref1"])
def test_map_sam_and_bam_match(inputs, tmp_path, capsys, monkeypatch, ref):
    for out in ("out.sam", "out.bam"):
        _, _, line = _both(
            ["map", "-r", inputs[ref], "-q", inputs["reads"], "-o", out],
            tmp_path / out, capsys, monkeypatch, files=[out],
            port_extra=["--device", "cpu"])
        assert line.startswith("mapped ") and line.endswith(f"→ {out}\n")
        n, total = map(int, line.split()[1].split("/"))
        assert total == 26 and n >= (20 if ref == "ref" else 12)


@pytest.mark.parametrize("out", ["pairs.sam", "pairs.bam"])
def test_map_paired_matches(inputs, tmp_path, capsys, monkeypatch, out):
    _, _, line = _both(
        ["map", "-r", inputs["ref"], "-q", inputs["m1"], "-2", inputs["m2"],
         "-o", out, "--max-insert", "600"], tmp_path, capsys, monkeypatch,
        files=[out], port_extra=["--device", "cpu"])
    assert "proper pairs" in line


def test_map_fasta_reads_matches(inputs, tmp_path, capsys, monkeypatch):
    _both(["map", "-r", inputs["ref1"], "-q", inputs["reads_fa"], "-o",
           "fa.sam", "--min-insert", "10"], tmp_path, capsys, monkeypatch,
          files=["fa.sam"], port_extra=["--device", "cpu"])


def test_map_defaults_to_the_card(inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tcli.main(["map", "-r", inputs["ref1"], "-q", inputs["reads"], "-o",
                   "x.sam"])


@pytest.mark.parametrize("src", ["bam", "fastq", "fasta"])
def test_extract_matches(inputs, tmp_path, capsys, monkeypatch, src):
    if src == "bam":
        _both(["map", "-r", inputs["ref"], "-q", inputs["reads"], "-o",
               "in.bam"], tmp_path / "m", capsys, monkeypatch,
              files=["in.bam"], port_extra=["--device", "cpu"])
        path = str(tmp_path / "m" / "port" / "in.bam")
    else:
        path = inputs["reads" if src == "fastq" else "reads_fa"]
    _, dt, out = _both(["extract", "-i", path, "-o", "reads.txt"], tmp_path,
                       capsys, monkeypatch, files=["reads.txt"])
    assert out == "extracted 26 reads → reads.txt\n"
    assert len((dt / "reads.txt").read_text().splitlines()) == 26
