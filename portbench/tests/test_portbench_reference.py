"""The reference against the port's plain path (device="cpu") at tiny
sizes: the same answers, field for field and bit for bit.  The test
imports the port; the reference does not."""
import numpy as np
import pytest

from genomics_tpu_torch.core.scoring import AlgoType, AlignmentParams
from genomics_tpu_torch.models import assembly
from genomics_tpu_torch.ops import cuda_pairhmm
from genomics_tpu_torch.runtime.dispatch import AlignEngine
from portbench import generators
from portbench.reference import align, assembly as ref_asm, pairhmm


@pytest.fixture(scope="module")
def pairs():
    return generators.gasal_pairs(np.random.default_rng(2**33 + 11), 24,
                                  read_len=40, target_len=(50, 80))


@pytest.mark.parametrize("with_tb", [True, False])
def test_local_equals_the_engine(pairs, with_tb):
    qs, ts = pairs
    eng = AlignEngine(AlignmentParams(), with_tb=with_tb,
                      score_only=not with_tb, device="cpu")
    got = eng.align(qs, ts)
    want = align.align_local(qs, ts, (1, 4, 6, 1), with_tb=with_tb, block=7)
    for g, w in zip(got, want):
        assert (g.score, g.query_end, g.target_end, g.query_start,
                g.target_start) == (w["score"], w["query_end"],
                                    w["target_end"], w["query_start"],
                                    w["target_start"])
        assert (b"" if g.cigar is None else bytes(g.cigar)) == w["cigar"]


def test_global_equals_the_engine(pairs):
    qs, ts = pairs
    p = AlignmentParams(algo=AlgoType.GLOBAL, match=2, mismatch=4,
                        gap_open=6, gap_extend=1)
    got = AlignEngine(p, with_tb=True, device="cpu").align(qs, ts)
    want = align.align_global(qs, ts, (2, 4, 6, 1), block=5)
    for g, w in zip(got, want):
        assert g.score == w["score"] and bytes(g.cigar) == w["cigar"]
        assert g.cigar_string == align.cigar_string(w["cigar"])


def test_pairhmm_bit_equal_to_the_port():
    regions = generators.assembly_regions(np.random.default_rng(3), 2,
                                          window=60, reads=4, read_len=30,
                                          snv_at=(10, 20), indel_at=(30, 40))
    reads = [r for _, rd in regions for r in rd]
    haps = [ref for ref, rd in regions for _ in rd]
    recs = [{"read": r.encode(), "hap": h.encode(),
             "base_quals": np.full(len(r), 30, np.int64),
             "ins_quals": np.full(len(r), 45, np.int64),
             "del_quals": np.full(len(r), 45, np.int64)}
            for r, h in zip(reads, haps)]
    got = cuda_pairhmm.pairhmm_forward_dataset(recs, device="cpu")
    want = pairhmm.likelihoods(reads, haps, 30, 45, 45, block=3)
    assert got.tobytes() == want.tobytes()


def test_assembly_equals_the_port():
    regions = generators.assembly_regions(np.random.default_rng(9), 3,
                                          window=120, reads=10, read_len=60,
                                          snv_at=(30, 50), indel_at=(70, 90))
    want = ref_asm.local_assembly(regions)
    called = 0
    for (ref, rd), (wh, wv, _) in zip(regions, want):
        haps, var = assembly.local_assembly(ref, rd, device="cpu")
        assert [(h.seq, h.graph_score, h.likelihood) for h in haps] == wh
        assert [(v.pos, v.ref, v.alt, v.kind) for v in var] == wv
        called += bool(var)
    assert called
