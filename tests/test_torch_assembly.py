"""The port's local micro-assembly (`genomics_tpu_torch.models.assembly`)
against `genomics_tpu.models.assembly` on the CPU: the de Bruijn graph's
k-best haplotypes and their graph scores; `score_haplotypes`' per-pair
likelihoods bit-equal to the gold and to JAX's exact wavefront kernel
with host prep (`pairhmm_forward_tpu_dataset`, interpret mode), and each
haplotype's summed log10 the same float; the variants of `call_variants`
(the GLOBAL engine with traceback); `local_assembly` end to end; and the
`assemble` subcommand, whose JAX twin raises on a missing attribute
(ROADMAP C24), against the JAX pipeline's own results."""
import numpy as np
import pytest

from genomics_tpu import __main__ as jcli
from genomics_tpu.core import golds
from genomics_tpu.models import assembly as JA
from genomics_tpu.ops import pallas_pairhmm
from genomics_tpu_torch import __main__ as tcli
from genomics_tpu_torch.models import assembly as TA
from genomics_tpu_torch.ops import cuda_pairhmm


def region(seed, L=80, read_len=30, n_reads=16):
    """A reference window, an alternative haplotype with a SNV at 40 and a
    2-base deletion at 55, and reads cut from the alternative."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), L))
    alt = ref[:40] + ("A" if ref[40] != "A" else "C") + ref[41:55] + ref[57:]
    reads = [alt[p:p + read_len]
             for p in rng.integers(0, len(alt) - read_len, n_reads)]
    return ref, alt, reads


def _records(haps, reads):
    return [{"read": r.encode(), "hap": h.seq.encode(),
             "base_quals": np.full(len(r), 30, np.int64),
             "ins_quals": np.full(len(r), 45, np.int64),
             "del_quals": np.full(len(r), 45, np.int64)}
            for h in haps for r in reads]


@pytest.mark.parametrize("seed", [0, 1])
def test_haplotypes_match_jax(seed):
    ref, alt, reads = region(seed)
    want = JA.assemble_region(ref, reads)
    got = TA.assemble_region(ref, reads)
    assert [(h.seq, h.graph_score) for h in got] == [
        (h.seq, h.graph_score) for h in want]
    assert any(h.seq == alt for h in got)


def test_score_haplotypes_is_the_gold_bits():
    """One wavefront launch's likelihoods over every (haplotype, read)
    pair: the gold's bits and JAX's exact kernel's; each haplotype's
    likelihood the same float64 sum as over those bits."""
    ref, _, reads = region(2, n_reads=12)
    haps = TA.assemble_region(ref, reads)
    recs = _records(haps, reads)
    lik = cuda_pairhmm.pairhmm_forward_dataset(recs, device="cpu")
    gold = np.array([golds.pairhmm_forward(r["read"], r["hap"],
                                           r["base_quals"], r["ins_quals"],
                                           r["del_quals"]) for r in recs],
                    np.float32)
    np.testing.assert_array_equal(lik, gold)
    np.testing.assert_array_equal(
        lik, np.asarray(pallas_pairhmm.pairhmm_forward_tpu_dataset(
            recs, exact=True)))
    log10 = np.log10(np.maximum(gold.astype(np.float64), 1e-300)).reshape(
        len(haps), len(reads)).sum(axis=1)
    want = sorted(zip(log10, [h.seq for h in haps]), key=lambda x: -x[0])
    got = TA.score_haplotypes(haps, reads, device="cpu")
    assert [(h.likelihood, h.seq) for h in got] == [
        (float(v), s) for v, s in want]


@pytest.mark.parametrize("edit", ["snv", "ins", "del", "mixed", "same"])
def test_call_variants_matches_jax(edit):
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), 90))
    hap = {"snv": ref[:30] + ("G" if ref[30] != "G" else "T") + ref[31:],
           "ins": ref[:45] + "TTAG" + ref[45:],
           "del": ref[:20] + ref[23:],
           "mixed": ref[:10] + ("A" if ref[10] != "A" else "C") + ref[11:50]
           + "GG" + ref[50:70] + ref[72:],
           "same": ref}[edit]
    got = TA.call_variants(ref, hap, device="cpu")
    want = JA.call_variants(ref, hap)
    assert [vars(v) for v in got] == [vars(v) for v in want]
    assert (edit == "same") == (got == [])


@pytest.mark.parametrize("seed", [0, 4])
def test_local_assembly_matches_jax(seed):
    """The pipeline end to end: the same haplotypes in the same order and
    the same variants; the likelihoods within 1e-6 of JAX's CPU path (its
    plain scan, which is not the gold's bits)."""
    ref, _, reads = region(seed)
    haps, variants = TA.local_assembly(ref, reads, device="cpu")
    jhaps, jvariants = JA.local_assembly(ref, reads)
    assert [h.seq for h in haps] == [h.seq for h in jhaps]
    np.testing.assert_allclose([h.likelihood for h in haps],
                               [h.likelihood for h in jhaps], rtol=1e-6)
    assert [vars(v) for v in variants] == [vars(v) for v in jvariants]
    assert {v.kind for v in variants} == {"snv", "del"}


def test_assemble_cli_prints_what_jax_computes(tmp_path, capsys,
                                               monkeypatch):
    """`python -m genomics_tpu assemble` raises on `h.score` (Haplotype has
    no such field, C24) before its first line; the port prints the
    likelihood there, and every other line as the JAX subcommand's code
    formats the JAX pipeline's results."""
    ref, _, reads = region(5)
    rf, qf = tmp_path / "ref.fa", tmp_path / "reads.fq"
    rf.write_text(f">win\n{ref}\n")
    qf.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    argv = ["assemble", "-r", str(rf), "-q", str(qf)]
    with pytest.raises(AttributeError, match="score"):
        jcli.main(argv)
    capsys.readouterr()
    tcli.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    haps, variants = JA.local_assembly(ref, reads)
    want = "".join(
        [f"hap {i}\tscore={h.likelihood:.4g}\t{h.seq}\n"
         for i, h in enumerate(haps)]
        + [f"variant\t{v.pos}\t{v.kind}\t{v.ref}>{v.alt}\n" for v in variants]
        + [f"{len(haps)} haplotypes, {len(variants)} variants\n"])
    assert got == want
