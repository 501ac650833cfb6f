"""The port's nvbio-aln-diff (`genomics_tpu_torch.models.alndiff`) against
`genomics_tpu.models.alndiff` on the CPU: every statistic of the SE and PE
analyzers, the filter's binary file and the HTML report byte for byte,
over SAM files and over a BAM file written by the port's mapper IO; the
`alndiff` subcommand's stdout and report against `python -m genomics_tpu
alndiff`; and the port's CLI has the JAX package's fifteen subcommands."""
import argparse
import dataclasses

import numpy as np
import pytest

from genomics_tpu import __main__ as jcli
from genomics_tpu.models import alndiff as JA
from genomics_tpu_torch import __main__ as tcli
from genomics_tpu_torch.models import alndiff as TA

from test_alndiff import _mk_sam, _rand_rows


def _state(obj, prefix=""):
    """Every number and array an analyzer holds, by attribute path."""
    out = {}
    if isinstance(obj, np.ndarray):
        out[prefix] = obj
    elif isinstance(obj, (int, float, str, type(None))):
        out[prefix] = obj
    elif isinstance(obj, (list, tuple)):
        out[prefix] = list(obj)
    else:
        for k, v in vars(obj).items():
            out.update(_state(v, f"{prefix}.{k}"))
    return out


def _assert_same_state(got, want):
    g, w = _state(got), _state(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g[k] == w[k], k


def _se_files(tmp_path, seed=7, n=300):
    rng = np.random.default_rng(seed)
    rows1 = _rand_rows(rng, n)
    rows2 = _rand_rows(rng, n)
    rows2 = [(r1[0] if i % 17 else "zz", *r2[1:])
             for i, (r1, r2) in enumerate(zip(rows1, rows2))]
    f1, f2 = tmp_path / "a.sam", tmp_path / "b.sam"
    _mk_sam(f1, rows1)
    _mk_sam(f2, rows2)
    return str(f1), str(f2)


def _pe_files(tmp_path, seed=3, n=60):
    rng = np.random.default_rng(seed)
    rows1, rows2 = [], []
    for i in range(n):
        for mate, pos in ((64, 100 + 7 * i), (128, 400 + 7 * i)):
            base = 1 | (2 if rng.random() < 0.8 else 0) | mate
            flag2 = base | (16 if rng.random() < 0.2 else 0)
            rows1.append((f"p{i}", base, "chr1", pos, int(rng.integers(0, 60)),
                          "20M", "A" * 20, int(rng.integers(0, 4)),
                          int(rng.integers(0, 40)),
                          int(rng.integers(0, 40)) if i % 3 else None))
            rows2.append((f"p{i}", flag2, "chr2" if i % 5 == 0 else "chr1",
                          pos + int(rng.integers(-30, 30)),
                          int(rng.integers(0, 60)), "18M2I", "A" * 20,
                          int(rng.integers(0, 4)), int(rng.integers(0, 40)),
                          None))
    f1, f2 = tmp_path / "p1.sam", tmp_path / "p2.sam"
    _mk_sam(f1, rows1)
    _mk_sam(f2, rows2)
    return str(f1), str(f2)


def test_load_alignments_matches_jax(tmp_path):
    f1, _ = _se_files(tmp_path)
    got, want = TA.load_alignments(f1), JA.load_alignments(f1)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)))


@pytest.mark.parametrize("id_check", [True, False])
def test_se_analyzer_matches_jax(tmp_path, id_check):
    f1, f2 = _se_files(tmp_path)
    _assert_same_state(TA.diff(f1, f2, id_check=id_check),
                       JA.diff(f1, f2, id_check=id_check))


def test_pe_analyzer_matches_jax(tmp_path):
    f1, f2 = _pe_files(tmp_path)
    got = TA.diff(f1, f2, paired=True)
    _assert_same_state(got, JA.diff(f1, f2, paired=True))
    assert got.n == 60


def test_filter_and_report_bytes_match_jax(tmp_path):
    f1, f2 = _se_files(tmp_path, seed=11)
    out = {}
    for name, mod in (("jax", JA), ("port", TA)):
        flt = mod.Filter(str(tmp_path / f"{name}.ids"), mod.F_ALL,
                         mod.S_ED | mod.S_MAPQ, 2)
        mod.diff(f1, f2, report=str(tmp_path / f"{name}.html"), filter=flt)
        out[name] = ((tmp_path / f"{name}.ids").read_bytes(),
                     (tmp_path / f"{name}.html").read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][0] and b"<table" in out["port"][1]


def test_bam_input_matches_jax(tmp_path):
    """A BAM written by the port's bamio loads as the same batch, and
    diffs against its own SAM as the JAX package's does."""
    from genomics_tpu_torch.models.mapper import Mapping
    from genomics_tpu_torch.utils import bamio, samio

    rng = np.random.default_rng(5)
    recs = []
    for i in range(40):
        seq = "".join(rng.choice(list("ACGT"), 30))
        pos = int(rng.integers(0, 900)) or -1
        recs.append((f"r{i}", seq, Mapping(
            pos=pos, score=int(rng.integers(0, 60)),
            mapq=int(rng.integers(0, 60)) if pos >= 0 else 0,
            cigar_string="30M" if pos >= 0 else "", reverse=bool(i % 2))))
    bam, sam = tmp_path / "m.bam", tmp_path / "m.sam"
    bamio.write_bam(str(bam), "chr1", 1000, recs)
    samio.write_sam(str(sam), "chr1", 1000, recs)
    got, want = TA.load_alignments(str(bam)), JA.load_alignments(str(bam))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)))
    _assert_same_state(TA.diff(str(bam), str(sam)),
                       JA.diff(str(bam), str(sam)))


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_alndiff_cli_matches_jax(paired, tmp_path, capsys, monkeypatch):
    f1, f2 = (_pe_files if paired else _se_files)(tmp_path)
    argv = ["alndiff", f1, f2, "--report", "r.html"] + (
        ["--paired"] if paired else [])
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        main(argv)
        outs[name] = (capsys.readouterr().out, (d / "r.html").read_bytes())
    assert outs["port"] == outs["jax"]
    assert outs["port"][0].startswith("analyzed ")


def _subcommands(main, monkeypatch) -> set:
    """The subcommand names of a CLI's parser, taken where it parses."""
    seen = {}

    def grab(self, *args, **kw):
        seen["parser"] = self
        raise SystemExit(0)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main([])
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return set(sub.choices)


def test_subcommands_match_jax(monkeypatch):
    """All fifteen subcommands of the JAX package, and no other."""
    want = _subcommands(jcli.main, monkeypatch)
    assert len(want) == 15
    assert _subcommands(tcli.main, monkeypatch) == want
