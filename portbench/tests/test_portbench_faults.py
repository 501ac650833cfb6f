"""A run with the timed path broken underneath comes out not correct;
the same run unbroken comes out correct.  The runs skip the look for a
card and drive the rest of a run on the CPU at a small size, the
program on its plain path.  One chip: no exchange between chips to
leave out."""
import pytest

from genomics_tpu_torch.models import assembly
from genomics_tpu_torch.runtime import dispatch
from portbench import harness

# (configuration, traffic mix) entries at a size a test run holds
SMALL = {"engine": (dict(pool=24, batch=8), dict(sample=8, min_compared=8)),
         "assembly": (dict(pool=2), dict(reads=10, sample=4,
                                         min_compared=1))}


def run_cell(name, seconds=0.5):
    bench = harness.manifest()
    cell = harness.cell_of(bench, name)
    run = harness.new_run(bench, cell, 2**33 + 29, seconds, False, "cpu")
    config, mix = SMALL[run.traffic["driver"]]
    run.config.update(config)
    run.traffic.update(mix)
    line, checks = harness.execute(run, 0.0)
    return line, {c.name: c for c in checks}


def alter_one_answer(mp):
    collect = dispatch.AlignEngine._collect

    def altered(self, pending, n):
        jobs = collect(self, pending, n)
        jobs[0].score += 1
        return jobs
    mp.setattr(dispatch.AlignEngine, "_collect", altered)


def leave_out_half(mp):
    run = dispatch.AlignEngine._dispatch

    def half(self, queries, targets, h0=None):
        k = len(queries) // 2
        return run(self, queries[:k], targets[:k], h0)
    mp.setattr(dispatch.AlignEngine, "_dispatch", half)


def state_unchanged(mp):
    result = dispatch.AsyncHandle.result
    last = []

    def stale(self):
        out = result(self)
        last.append(out)
        return last[0]          # the first batch's answers, again
    mp.setattr(dispatch.AsyncHandle, "result", stale)


ENGINE_FAULTS = {"answer altered": (alter_one_answer, "score_mismatch"),
                 "half the batch left out": (leave_out_half, "missing"),
                 "state unchanged": (state_unchanged, "score_mismatch")}


def hap_altered(mp):
    call = assembly.call_variants

    def altered(ref, hap, device="cuda"):
        return [assembly.Variant(v.pos + 1, v.ref, v.alt, v.kind)
                for v in call(ref, hap, device=device)]
    mp.setattr(assembly, "call_variants", altered)


def half_the_reads(mp):
    score = assembly.score_haplotypes

    def half(haps, reads, **kw):
        out = score(haps, reads[:len(reads) // 2], **kw)
        for h in out:            # the mean over the rest, scaled back
            h.likelihood *= 2
        return out
    mp.setattr(assembly, "score_haplotypes", half)


def region_unchanged(mp):
    call = assembly.local_assembly
    first = []

    def stale(ref, reads, **kw):
        out = call(ref, reads, **kw)
        first.append(out)
        return first[0]
    mp.setattr(assembly, "local_assembly", stale)


ASSEMBLY_FAULTS = {"answer altered": (hap_altered, "variant_mismatch"),
                   "half the batch left out": (half_the_reads,
                                               "likelihood_mismatch"),
                   "state unchanged": (region_unchanged,
                                       "haplotype_mismatch")}


@pytest.mark.parametrize("cell", ["gasal2-testprog.tb",
                                  "gasal2-testprog.score"])
@pytest.mark.parametrize("fault", sorted(ENGINE_FAULTS))
def test_engine_fault_is_not_correct(monkeypatch, cell, fault):
    plant, number = ENGINE_FAULTS[fault]
    plant(monkeypatch)
    line, checks = run_cell(cell)
    assert not line["correct"] and not checks[number].ok


@pytest.mark.parametrize("fault", sorted(ASSEMBLY_FAULTS))
def test_assembly_fault_is_not_correct(monkeypatch, fault):
    plant, number = ASSEMBLY_FAULTS[fault]
    plant(monkeypatch)
    line, checks = run_cell("nvma-hc.wgs30", seconds=1.0)
    assert not line["correct"] and not checks[number].ok


@pytest.mark.parametrize("cell", ["gasal2-testprog.tb",
                                  "gasal2-testprog.score", "nvma-hc.wgs30"])
def test_sound_run_is_correct(cell):
    line, checks = run_cell(cell)
    assert line["correct"], {k: c.value for k, c in checks.items()}
    assert line["attempted"] > 0 and line["failed"] == 0
