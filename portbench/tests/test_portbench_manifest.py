"""BENCHMARK.json against the contract, and every name it uses found as
a file of the benchmark's."""
import json
import re

from portbench import harness

ROOT = harness.ROOT
B = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"[^\t\n\r]{1,200}$")


def test_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert "portbench" in B["paths"]
    assert B["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in B[group]:
            assert set(e) == keys, e
            assert LINE.match(e["why"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])


def test_names_and_units():
    names = [e["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in B[g]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in B["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_and_configs():
    pairs = {(c["config"], c["traffic"]) for c in B["workloads"]}
    assert len(pairs) == len(B["workloads"])
    used = {c["config"] for c in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    assert all(c["chips"] in (1, 4) for c in B["workloads"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in B["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(B, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(B, cell, True)


def test_moves_is_reported_by_each_cell_of_the_metric():
    cells = {c["name"]: c for c in B["workloads"]}
    for m in B["per_layer"]:
        assert m["workloads"], m["name"]
        for name in m["workloads"]:
            e2e = {x["name"] for x in harness.metrics_of(B, cells[name],
                                                         False)}
            assert m["moves"] in e2e, (m["name"], name)


def test_found_by_name():
    for c in B["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for cell in B["workloads"]:
        run = harness.new_run(B, cell, 1, 1, False, "cpu")
        assert run.config["name"] == cell["config"]
        drv = harness.driver_of(run.traffic)
        for fn in ("setup", "serve", "release", "check", "control"):
            assert callable(getattr(drv, fn)), (cell["name"], fn)
    for m in B["end_to_end"] + B["per_layer"]:
        reader = harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py", "m")
        assert callable(reader.read)


def _window(scale):
    w = harness.Window()
    w.counts.update(done=100 * scale, attempted=120 * scale, failed=0)
    for name in ("batch", "submit", "collect", "region"):
        w.spans[name] = [0.001 * scale * (k + 1) for k in range(40)]
    return w


def test_host_clock_metrics_read_the_untraced_window():
    """A traced window's spans and counts never reach a host-clock
    metric; the device-trace metrics read only the trace."""
    cell = B["workloads"][0]
    values = []
    for traced in (_window(1), _window(7)):
        run = harness.new_run(B, cell, 1, 10, True, "cpu")
        run.host, run.traced = _window(1), traced
        values.append({m["name"]: harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py", "m").read(run)
            for m in B["end_to_end"] + B["per_layer"]
            if m["source"] == "host_clock" and m["name"] != "setup_s"})
        run.profile = None
        for m in B["per_layer"]:
            if m["source"] == "device_trace":
                assert harness.load_module(
                    harness.HERE / "metrics" / f"{m['name']}.py",
                    "m").read(run) is None, m["name"]
    assert values[0] == values[1] and None not in values[0].values()


def test_no_cell_name_in_code():
    names = [c["name"] for c in B["workloads"]]
    for path in harness.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert not any(n in text for n in names), path


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_metric_files_name_every_metric_and_no_other():
    files = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    names = {m["name"] for m in B["end_to_end"] + B["per_layer"]}
    assert files == names


def test_config_files_state_source_guarantee_and_cuts():
    for c in B["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(cfg["source"]) <= 200
        for key in ("guarantee", "precision", "assumed", "reduced"):
            assert cfg[key] is not None, key
        assert cfg["reduced"] == c["reduced"]
