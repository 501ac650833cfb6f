"""The port's GASAL2 facade (`models.aligner`), its `align` CLI, its FASTA
IO and its batch containers against the JAX package on the CPU."""
import numpy as np
import pytest

from genomics_tpu import __main__ as jmain
from genomics_tpu.core import batch as jbatch
from genomics_tpu.core import golds
from genomics_tpu.core import scoring as jscoring
from genomics_tpu.models import aligner as jaligner
from genomics_tpu.utils import fasta as jfasta
from genomics_tpu_torch import AlignmentParams, PairBatch, SeqBatch
from genomics_tpu_torch import __main__ as tmain
from genomics_tpu_torch.core import batch
from genomics_tpu_torch.core.encoding import encode4
from genomics_tpu_torch.core.scoring import params_from_jax
from genomics_tpu_torch.models import aligner as tal
from genomics_tpu_torch.models.aligner import (
    DataSource,
    GasalAligner,
    align_fasta_pairs,
    apply_op,
)
from genomics_tpu_torch.utils import fasta

P = AlignmentParams()
_COMP = str.maketrans("ACGTN", "TGCAN")
_OPS = ">", "<", "/", "+"


def _op(seq: str, op: str) -> str:
    """A header op on a base string (each op is its own inverse)."""
    if op in "/+":
        seq = seq.translate(_COMP)
    return seq[::-1] if op in "<+" else seq


def _write_pairs(tmp_path, n=40, seed=0):
    """n reads of 25-32 bp cut from 33-48 bp targets (one 32 x 48 bucket),
    with substitutions, a few Ns and some unrelated pairs; each side
    stored under a random header op, so that applying the op restores the
    pair."""
    rng = np.random.default_rng(seed)
    qf, tf = tmp_path / "q.fasta", tmp_path / "t.fasta"
    with open(qf, "w") as fq, open(tf, "w") as ft:
        for k in range(n):
            tgt = "".join(rng.choice(list("ACGT"), int(rng.integers(33, 49))))
            start = int(rng.integers(0, len(tgt) - 32))
            read = list(tgt[start:start + int(rng.integers(25, 33))])
            for i in range(len(read)):
                if rng.random() < 0.06:
                    read[i] = str(rng.choice(list("ACGTN")))
            if k % 7 == 3:
                read = list(rng.choice(list("ACGT"), len(read)))
            qop, top = _OPS[k % 4], _OPS[(k // 4) % 4]
            fq.write(f"{qop}read{k} x\n{_op(''.join(read), qop)}\n")
            ft.write(f"{top}ref{k}\n{_op(tgt, top)}\n")
    return str(qf), str(tf)


def test_stream_api_flow():
    rng = np.random.default_rng(0)
    qs = ["".join(rng.choice(list("ACGT"), 30)) for _ in range(6)]
    ts = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(6)]
    lib = GasalAligner(P, n_streams=2, with_tb=True, device="cpu")
    st = lib.free_stream()
    assert st.is_done() == -2
    for q, t in zip(qs, ts):
        st.fill(q, DataSource.QUERY)
        st.fill(t, DataSource.TARGET)
    st.aln_async()
    assert not st.is_free and lib.free_stream() is lib.streams[1]
    assert st.is_done() == 0 and st.is_free
    for i, job in enumerate(st.results):
        g = golds.local_align(qs[i], ts[i], P)
        assert job.score == g["score"]
        if g["score"]:
            assert job.cigar is not None


_FIELDS = ("score", "query_end", "target_end", "query_start",
           "target_start", "score_second", "query_end_second",
           "target_end_second", "cigar_string")


@pytest.mark.parametrize("jp,with_tb", [
    (jscoring.AlignmentParams(), True),
    (jscoring.AlignmentParams(second_best=True, compute_start=True), False),
    (jscoring.AlignmentParams(algo=jscoring.AlgoType.KSW), False),
], ids=["local_tb", "second_start", "ksw_seeded"])
def test_streams_match_the_jax_facade(jp, with_tb):
    """The same fills, header ops and seed scores through both facades'
    streams: every field of every job equal."""
    rng = np.random.default_rng(1)
    tgts = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(9)]
    qs = [t[4:34] if k % 3 else "".join(rng.choice(list("ACGTN"), 30))
          for k, t in enumerate(tgts)]
    ops = [_OPS[k % 4] for k in range(9)]
    h0 = rng.integers(0, 20, 9)
    results = []
    for mod, params, kw in ((jaligner, jp, {}),
                            (tal, params_from_jax(jp), {"device": "cpu"})):
        lib = mod.GasalAligner(params, with_tb=with_tb, **kw)
        st = lib.free_stream()
        for q, t, op in zip(qs, tgts, ops):
            st.fill(_op(q, op), mod.DataSource.QUERY)
            st.fill(t, mod.DataSource.TARGET)
        st.op_fill(ops, mod.DataSource.QUERY)
        if params.algo.value == "ksw":
            st.seed_scores(h0)
        st.aln_async()
        assert st.is_done() == 0
        results.append([tuple(getattr(j, f) for f in _FIELDS)
                        for j in st.results])
        st.reset()
        assert st.is_done() == -2 and st.is_free
    assert results[0] == results[1]


def test_op_transforms():
    codes = encode4("ACGT")
    np.testing.assert_array_equal(apply_op(codes, 0), codes)
    # reverse natural
    np.testing.assert_array_equal(apply_op(codes, 1), codes[::-1])
    # reverse complement of ACGT is ACGT
    np.testing.assert_array_equal(apply_op(codes, 3), codes)
    np.testing.assert_array_equal(apply_op(encode4("AACG"), 2),
                                  encode4("TTGC"))


def test_op_changes_alignment():
    lib = GasalAligner(P, device="cpu")
    st = lib.free_stream()
    st.fill("TTTTTTTT", DataSource.QUERY)
    st.fill("AAAAAAAA", DataSource.TARGET)
    st.op_fill(["/"], DataSource.QUERY)   # complement(T*8) = A*8
    st.aln_async()
    st.is_done()
    assert st.results[0].score == 8


def test_unbalanced_stream_raises():
    st = GasalAligner(P, device="cpu").free_stream()
    st.fill("ACGT", DataSource.QUERY)
    with pytest.raises(ValueError, match="unbalanced"):
        st.aln_async()


def test_fasta_round_trip_with_header_ops(tmp_path):
    qf, _ = _write_pairs(tmp_path, n=8)
    got = fasta.read_fasta(qf, with_ops=True)
    want = jfasta.read_fasta(qf, with_ops=True)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert [r.op for r in got] == list(_OPS) * 2
    assert {r.op for r in fasta.read_fasta(qf)} == {">"}
    out = tmp_path / "w.fasta"
    fasta.write_fasta(str(out), got, width=10)
    back = fasta.read_fasta(str(out))
    assert [(r.name, r.seq) for r in back] == [(r.name, r.seq) for r in got]
    jout = tmp_path / "jw.fasta"
    jfasta.write_fasta(str(jout), want, width=10)
    assert out.read_text() == jout.read_text()


def test_fastq_and_quals(tmp_path):
    path = tmp_path / "r.fastq"
    path.write_text("@r1 x\nACGTN\n+\nII#5!\n\n@r2\nGG\n+\n++\n")
    got = fasta.read_fastq(str(path))
    assert [tuple(r) for r in got] == [tuple(r) for r in
                                       jfasta.read_fastq(str(path))]
    np.testing.assert_array_equal(fasta.quals_to_phred(got[0].quals),
                                  jfasta.quals_to_phred(got[0].quals))


@pytest.mark.parametrize("kw", [{}, dict(pad_len=64, pad_batch=16)],
                         ids=["defaults", "padded"])
def test_batches_equal_jax(kw):
    qs = ["ACGTNACG", "", "GATTACA" * 5]
    ts = ["TTT", "ACGTACGTAC", "G"]
    got, want = SeqBatch.from_strings(qs, **kw), jbatch.SeqBatch.from_strings(
        qs, **kw)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert (got.size, got.padded_len) == (want.size, want.padded_len)
    np.testing.assert_array_equal(got[2], want[2])
    pk = {} if not kw else dict(q_pad=64, t_pad=32, pad_batch=16)
    pb, jpb = PairBatch.from_strings(qs, ts, **pk), \
        jbatch.PairBatch.from_strings(qs, ts, **pk)
    assert pb.size == jpb.size
    for a, b in ((pb.query, jpb.query), (pb.target, jpb.target)):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)
    assert (batch.LANE, batch.SUBLANE, batch.round_up(130, 128)) == (
        jbatch.LANE, jbatch.SUBLANE, jbatch.round_up(130, 128))
    with pytest.raises(ValueError):
        PairBatch.from_strings(qs, ts[:2])


def test_align_fasta_pairs_chunks_over_two_streams(tmp_path, monkeypatch):
    """Five chunks over two streams: each later chunk waits for the older
    stream, collects it and reuses it; the jobs come back in file order,
    equal to one engine call on the op-applied pairs."""
    import genomics_tpu_torch.models.aligner as aligner_mod
    from genomics_tpu_torch import AlignEngine

    qf, tf = _write_pairs(tmp_path, n=23, seed=3)
    q = fasta.read_fasta(qf, with_ops=True)
    t = fasta.read_fasta(tf, with_ops=True)
    want = AlignEngine(P, with_tb=True, device="cpu").align(
        [apply_op(encode4(r.seq), aligner_mod.OP_CHARS[r.op]) for r in q],
        [apply_op(encode4(r.seq), aligner_mod.OP_CHARS[r.op]) for r in t])
    assert aligner_mod.CHUNK == 5000
    launched = []
    align_async = AlignEngine.align_async

    def count(self, qs, ts, h0=None):
        launched.append(len(qs))
        return align_async(self, qs, ts, h0=h0)

    monkeypatch.setattr(AlignEngine, "align_async", count)
    monkeypatch.setattr(aligner_mod, "CHUNK", 5)
    jobs = align_fasta_pairs(qf, tf, params=P, with_tb=True, device="cpu")
    assert launched == [5, 5, 5, 5, 3]
    assert [(j.score, j.query_end, j.target_end, j.cigar_string)
            for j in jobs] == [(j.score, j.query_end, j.target_end,
                                j.cigar_string) for j in want]


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    [], ["--tb"], ["-s"], ["--second-best"], ["-y", "global"],
    ["-y", "global", "--tb"], ["-y", "semi_global", "-x", "query", "both",
                               "-s"],
    ["-y", "semi_global", "-x", "target", "target", "--tb"], ["-y", "ksw"],
    ["-y", "banded", "-k", "2"], ["--limit", "7"],
], ids=["local", "tb", "start", "second_best", "global", "global_tb",
        "semi_global_start", "semi_global_tb", "ksw", "banded", "limit"])
@pytest.mark.parametrize("cells16", [False, True], ids=["int32", "int16"])
def test_align_cli_prints_the_jax_bytes(tmp_path, capsys, monkeypatch, flags,
                                        cells16):
    """The port's CLI on the CPU prints the JAX CLI's bytes, and so it does
    with the ends in int16 cells (GENOMICS_TPU_INT16_CELLS=1 reaches the
    port's LOCAL ends only; the JAX engine on the CPU runs its scan)."""
    if cells16:
        monkeypatch.setenv("GENOMICS_TPU_INT16_CELLS", "1")
    qf, tf = _write_pairs(tmp_path)
    argv = ["align", "-q", qf, "-t", tf, *flags]
    want = _run(jmain.main, argv, capsys)
    got = _run(tmain.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert len(want.splitlines()) == (7 if "--limit" in flags else 40)


def test_align_cli_on_the_card_raises_without_one(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    qf, tf = _write_pairs(tmp_path, n=2)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tmain.main(["align", "-q", qf, "-t", tf])
