"""Each cell's control (the reference one precision below the
configuration's, put in the program's place) comes out as not correct,
here at a size a test run holds; `portbench/control.py` runs it at the
cell's own size on the card through the driver's `control`."""
import pytest

from portbench import harness

# (configuration, traffic mix) entries at a size a test run holds
SMALL = {"engine": (dict(pool=300), dict(min_compared=300)),
         "assembly": (dict(pool=6), dict(reads=12, sample=6,
                                         min_compared=6))}


@pytest.mark.parametrize("cell", [c["name"] for c in
                                  harness.manifest()["workloads"]])
def test_control_is_not_correct(cell):
    bench = harness.manifest()
    c = harness.cell_of(bench, cell)
    run = harness.new_run(bench, c, 2**33 + 17, 0, False, "cpu")
    config, mix = SMALL[run.traffic["driver"]]
    run.config.update(config)
    run.traffic.update(mix)
    checks = harness.driver_of(run.traffic).control(run)
    assert checks[0].ok                      # it compared enough
    assert not all(ch.ok for ch in checks)   # and failed a number
