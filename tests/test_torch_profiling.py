"""The program's spans and counters (`genomics_tpu_torch.utils.profiling`)
on the CPU: nothing recorded while no profiler runs; the spans of
`AlignEngine`, the PairHMM path and `local_assembly` with their parents,
batch ids and exact counters while one does; no span a pair; every span
inside the profiler's event of its name; and the same results either
way."""
import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from genomics_tpu_torch.core.scoring import AlgoType, AlignmentParams
from genomics_tpu_torch.models import assembly
from genomics_tpu_torch.runtime import dispatch
from genomics_tpu_torch.runtime.dispatch import AlignEngine
from genomics_tpu_torch.utils import profiling

ENGINE_PARENTS = {
    "dispatch": None, "dispatch.encode": "dispatch",
    "dispatch.pack": "dispatch", "dispatch.copy_in": "dispatch",
    "dispatch.launch": "dispatch", "collect": None,
    "collect.wait": "collect", "collect.copy_out": "collect",
    "collect.jobs": "collect"}
ASSEMBLY_PARENTS = {
    "assembly": None, "assembly.graph": "assembly",
    "assembly.paths": "assembly", "assembly.score": "assembly",
    "assembly.call": "assembly", "pairhmm.pack": "assembly.score",
    "pairhmm.copy_in": "assembly.score", "pairhmm.launch": "assembly.score",
    "pairhmm.copy_out": "assembly.score"}


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


def pairs(n, q=(20, 60), t=(30, 90), seed=0):
    rng = np.random.default_rng(seed)

    def seq(lo, hi):
        return "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
    return [seq(*q) for _ in range(n)], [seq(*t) for _ in range(n)]


def engine(**kw):
    return AlignEngine(AlignmentParams(algo=AlgoType.LOCAL), device="cpu",
                       **kw)


def region(seed, alt=True, L=80, read_len=30, n_reads=16):
    """A reference window and reads cut from it, or from an alternative
    haplotype with a SNV at 40 and a 2-base deletion at 55."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), L))
    src = (ref[:40] + ("A" if ref[40] != "A" else "C") + ref[41:55]
           + ref[57:]) if alt else ref
    reads = [src[p:p + read_len]
             for p in rng.integers(0, len(src) - read_len, n_reads)]
    return ref, reads


def named(records):
    """{name: [(parent name or None, batch)]} of profiling.spans()."""
    out = {}
    for name, _, _, parent, batch in records:
        out.setdefault(name, []).append(
            (None if parent < 0 else records[parent][0], batch))
    return out


def assert_jobs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("score", "query_end", "target_end", "query_start",
                  "target_start", "score_second", "query_end_second",
                  "target_end_second"):
            assert getattr(x, f) == getattr(y, f), f
        assert (x.cigar is None) == (y.cigar is None)
        if x.cigar is not None:
            np.testing.assert_array_equal(x.cigar, y.cigar)


def test_nothing_recorded_and_no_record_function_without_a_profiler(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not profiling.recording()
    qs, ts = pairs(12)
    engine(with_tb=True).align_async(qs, ts).result()
    engine(score_only=True).align(qs, ts)
    ref, reads = region(0)
    assembly.local_assembly(ref, reads, device="cpu")
    assert profiling.spans() == []
    assert profiling.totals() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("entry", ["align_async", "align"])
@pytest.mark.parametrize("mode", ["tb", "score_only"])
def test_engine_spans_parents_batch_and_counters(entry, mode):
    qs, ts = pairs(40)
    eng = engine(**{"with_tb" if mode == "tb" else mode: True})
    with recorded():
        assert profiling.recording()
        if entry == "align":
            jobs = eng.align(qs, ts)
        else:
            jobs = eng.align_async(qs, ts).result()
    assert not profiling.recording()
    got = named(profiling.spans())
    assert set(got) == set(ENGINE_PARENTS)
    for name, seen in got.items():
        assert {p for p, _ in seen} == {ENGINE_PARENTS[name]}, name
    batches = {b for seen in got.values() for _, b in seen}
    assert len(batches) == 1 and None not in batches
    edges = eng.buckets
    buckets = {(dispatch._bucket_of(len(q), edges),
                dispatch._bucket_of(len(t), edges)) for q, t in zip(qs, ts)}
    c = profiling.totals()["counters"]
    assert c["dispatch.batches"] == 1
    assert c["dispatch.pairs"] == c["collect.jobs"] == len(jobs) == len(qs)
    assert c["dispatch.chunks"] == len(buckets)
    assert c["dispatch.cells"] == sum(len(q) * len(t)
                                      for q, t in zip(qs, ts))
    assert c["dispatch.cells_launched"] == sum(
        dispatch._bucket_of(len(q), edges) * dispatch._bucket_of(len(t), edges)
        for q, t in zip(qs, ts))
    assert c["dispatch.bytes_in"] == sum(
        dispatch._bucket_of(len(q), edges) + dispatch._bucket_of(len(t), edges)
        + 8 for q, t in zip(qs, ts))
    s = profiling.totals()["spans"]
    assert s["dispatch.pack"]["count"] == 1 + len(buckets)
    assert s["dispatch"]["self_s"] < s["dispatch"]["total_s"]


def test_span_count_does_not_grow_with_the_pairs():
    counts = []
    for n in (10, 1000):
        qs, ts = pairs(n, q=(17, 25), t=(41, 49))
        profiling.clear()
        with recorded():
            engine().align(qs, ts)
        s = profiling.totals()["spans"]
        assert profiling.totals()["counters"]["dispatch.chunks"] == 1
        counts.append({k: v["count"] for k, v in s.items()})
    assert counts[0] == counts[1]


def test_spans_lie_inside_the_profilers_events():
    with recorded():                  # the first record_function is slow
        engine().align(*pairs(4))
    profiling.clear()
    qs, ts = pairs(30)
    eng = engine(with_tb=True)
    with recorded() as prof:
        eng.align_async(qs, ts).result()
        ref, reads = region(1)
        assembly.local_assembly(ref, reads, device="cpu")
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    mine = {}
    for name, start, end, _, _ in profiling.spans():
        mine.setdefault(name, []).append((start, end))
    assert set(ENGINE_PARENTS) | set(ASSEMBLY_PARENTS) <= set(mine)
    lags = []
    for name, spans in mine.items():
        assert len(events[name]) == len(spans), name
        for (a, b), (start, end) in zip(sorted(events[name]), sorted(spans)):
            assert a <= start <= end <= b, name
            lags += [start - a, b - end]
    # another clock would be off by far more than a span lasts; a worker
    # descheduled between the two clock reads on a loaded host can leave
    # one end some milliseconds off, so the 1 ms holds for the median
    assert sorted(lags)[len(lags) // 2] < 1_000_000
    assert max(lags) < 100_000_000


@pytest.mark.parametrize("mode", ["tb", "score_only", "compute_start"])
def test_results_equal_with_recording_on_and_off(mode):
    qs, ts = pairs(30, seed=3)
    if mode == "compute_start":
        eng = AlignEngine(AlignmentParams(algo=AlgoType.LOCAL,
                                          compute_start=True), device="cpu")
    else:
        eng = engine(**{"with_tb" if mode == "tb" else mode: True})
    off = eng.align(qs, ts)
    with recorded():
        on = eng.align_async(qs, ts).result()
    assert profiling.totals()["counters"]["dispatch.pairs"] == len(qs)
    assert_jobs_equal(on, off)
    ref, reads = region(4)
    want = assembly.local_assembly(ref, reads, device="cpu")
    with recorded():
        got = assembly.local_assembly(ref, reads, device="cpu")
    assert [(h.seq, h.graph_score, h.likelihood) for h in got[0]] == [
        (h.seq, h.graph_score, h.likelihood) for h in want[0]]
    assert got[1] == want[1]


@pytest.mark.parametrize("alt", [True, False], ids=["variant", "reference"])
def test_local_assembly_spans_and_counters(alt):
    ref, reads = region(2, alt=alt)
    with recorded():
        haps, variants = assembly.local_assembly(ref, reads, device="cpu")
    called = haps[0].seq != ref
    assert called == alt and bool(variants) == alt
    got = named(profiling.spans())
    want = dict(ASSEMBLY_PARENTS)
    if called:          # call_variants' GLOBAL engine, under assembly.call
        want.update({k: v or "assembly.call"
                     for k, v in ENGINE_PARENTS.items()})
    assert set(got) == set(want)
    for name, seen in got.items():
        assert {p for p, _ in seen} == {want[name]}, name
    region_id = got["assembly"][0][1]
    assert {b for _, b in got["assembly.score"]} == {region_id}
    c = profiling.totals()["counters"]
    assert c["assembly.regions"] == 1
    assert c["assembly.haplotypes"] == len(haps)
    assert c["assembly.calls"] == int(called)
    assert c["pairhmm.pairs"] == len(haps) * len(reads)
    assert c["pairhmm.cells"] == sum(len(r) * len(h.seq)
                                     for h in haps for r in reads)
    assert c.get("dispatch.pairs", 0) == int(called)


def test_self_time_is_total_less_the_children():
    with recorded():
        with profiling.span("outer", batch=profiling.NEW) as outer:
            with profiling.span("inner") as inner:
                inner.count("n", 2)
            with profiling.span("inner"):
                pass
            outer.count("n")
    (_, s0, e0, p0, b0), (_, s1, e1, p1, b1), (_, s2, e2, p2, b2) = \
        profiling.spans()
    assert (p0, p1, p2) == (-1, 0, 0) and b0 == b1 == b2 == outer.batch
    t = profiling.totals()
    assert t["counters"] == {"n": 3}
    assert t["spans"]["inner"]["count"] == 2
    assert t["spans"]["outer"]["self_s"] == pytest.approx(
        (e0 - s0 - (e1 - s1) - (e2 - s2)) / 1e9, abs=1e-12)
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_trace_reads_its_own_region_and_keeps_no_profiler_handles(tmp_path):
    with recorded():
        engine().align(*pairs(8))
    with profiling.trace(str(tmp_path)):
        engine().align(*pairs(5))
    assert profiling.totals()["counters"]["dispatch.pairs"] == 5
    assert profiling.totals()["spans"]["dispatch"]["count"] == 1
    assert all(s._rf is None for s in profiling._spans)
    assert (tmp_path / "trace.json").stat().st_size > 0
