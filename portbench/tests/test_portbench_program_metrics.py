"""The per-layer metrics read from the program's own spans and counters
(`genomics_tpu_torch.utils.profiling`): their arithmetic on given totals,
a value from a recorder filled by the program on the CPU, and None
without a profile or from a program that records no spans."""
import types

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness

ENGINE = ["engine_prepare_us_per_pair", "engine_launch_us_per_pair",
          "engine_wait_us_per_pair", "engine_results_us_per_pair",
          "engine_cell_fill_pct"]
ASSEMBLY = ["assembly_graph_ms_per_region", "assembly_score_ms_per_region",
            "assembly_call_ms_per_region"]


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"portbench_metric_{name}")


def fake_run():
    return types.SimpleNamespace(profile={"busy_s": 1.0, "window_s": 2.0})


def span(total, self_s=None):
    return {"count": 1, "total_s": total,
            "self_s": total if self_s is None else self_s}


TOTALS = {
    "spans": {"dispatch": span(10.0, 1.0), "dispatch.encode": span(2.0),
              "dispatch.pack": span(3.0), "dispatch.copy_in": span(1.5),
              "dispatch.launch": span(2.5), "collect": span(6.0, 0.5),
              "collect.wait": span(0.5), "collect.copy_out": span(1.0),
              "collect.jobs": span(4.0), "assembly": span(9.0, 0.0),
              "assembly.graph": span(4.0), "assembly.paths": span(1.0),
              "assembly.score": span(2.0, 0.5), "assembly.call": span(2.0)},
    "counters": {"dispatch.pairs": 1_000_000, "dispatch.cells": 600,
                 "dispatch.cells_launched": 800, "assembly.regions": 1000}}
WANT = {"engine_prepare_us_per_pair": 5.0, "engine_launch_us_per_pair": 4.0,
        "engine_wait_us_per_pair": 0.5, "engine_results_us_per_pair": 5.0,
        "engine_cell_fill_pct": 75.0, "assembly_graph_ms_per_region": 5.0,
        "assembly_score_ms_per_region": 2.0,
        "assembly_call_ms_per_region": 2.0}


def test_every_program_metric_is_in_the_manifest():
    names = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in ENGINE + ASSEMBLY:
        assert names[name]["source"] == "device_trace"


@pytest.mark.parametrize("name", ENGINE + ASSEMBLY)
def test_arithmetic_on_given_totals(monkeypatch, name):
    from genomics_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "totals", lambda: TOTALS)
    assert reader(name).read(fake_run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ENGINE + ASSEMBLY)
def test_none_without_a_profile_or_without_spans(monkeypatch, name):
    from genomics_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "totals", lambda: TOTALS)
    run = fake_run()
    run.profile = None
    assert reader(name).read(run) is None
    monkeypatch.setattr(profiling, "totals",
                        lambda: {"spans": {}, "counters": {}})
    assert reader(name).read(fake_run()) is None
    monkeypatch.delattr(profiling, "totals")     # a program with no spans
    assert reader(name).read(fake_run()) is None


@pytest.fixture(scope="module")
def filled():
    """The recorder after one engine batch and one assembled region on
    the CPU under the profiler, and the pairs and regions run."""
    from genomics_tpu_torch.core.scoring import AlgoType, AlignmentParams
    from genomics_tpu_torch.models import assembly
    from genomics_tpu_torch.runtime.dispatch import AlignEngine
    from genomics_tpu_torch.utils import profiling

    rng = np.random.default_rng(7)

    def seq(n):
        return "".join(rng.choice(list("ACGT"), n))
    qs = [seq(int(rng.integers(20, 40))) for _ in range(24)]
    ts = [seq(int(rng.integers(30, 60))) for _ in range(24)]
    ref = seq(80)
    alt = ref[:40] + ("A" if ref[40] != "A" else "C") + ref[41:]
    reads = [alt[p:p + 30] for p in rng.integers(0, 50, 12)]
    eng = AlignEngine(AlignmentParams(algo=AlgoType.LOCAL), with_tb=True,
                      device="cpu")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.align_async(qs, ts).result()
        assembly.local_assembly(ref, reads, device="cpu")
    yield profiling.totals()
    profiling.clear()


@pytest.mark.parametrize("name", ENGINE + ASSEMBLY)
def test_value_from_a_filled_recorder(filled, name):
    value = reader(name).read(fake_run())
    assert value is not None and value > 0
    s, c = filled["spans"], filled["counters"]
    if name == "engine_cell_fill_pct":
        assert value <= 100.0
    elif name.startswith("engine_"):
        # the engine's own batch and call_variants' one pair
        assert value <= 1e6 * (s["dispatch"]["total_s"]
                               + s["collect"]["total_s"]) \
            / c["dispatch.pairs"]
    else:
        assert value <= 1e3 * s["assembly"]["total_s"] \
            / c["assembly.regions"]
