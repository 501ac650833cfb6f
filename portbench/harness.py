"""One run of one cell: set-up, the measured window, the comparison
with the reference, and the result line.

Everything is found by name.  `BENCHMARK.json` names the cell's
configuration and traffic mix; `configs/<config>.json` holds the
configuration, `traffic/<traffic>.json` the mix and the driver that
serves it (`drivers/<driver>.py`); each metric is read by
`metrics/<metric>.py`.  A driver is a module with five functions:

    setup(run) -> state          inputs from the seed, the program built
                                 and warmed on every shape of the cell
    serve(run, state, win, t_end)
                                 the closed loop until t_end, then every
                                 item in flight finished; spans, counts
                                 and what it served go into the Window
    release(state)               drops the program's state
    check(run, state) -> list    the comparison with the reference over
                                 every window, as Check entries; fills
                                 run.work with the traced window's work
    control(run) -> list         the same comparison with the reference
                                 one precision below the configuration's
                                 in the program's place (control.py)

Every run serves one window untraced (`run.host`): the end-to-end
metrics (`--trace 0`) and the per-layer metrics taken by the host clock
read it.  A `--trace 1` run then serves a second window of the same
length under the profiler (`run.traced`), which the device-trace
metrics read, so that the profiler's own cost on the host reaches no
host-clock reading.  A metric reader is a module with
`read(run) -> float | None`; None leaves the metric out of the line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "genomics_tpu")


@dataclasses.dataclass
class Check:
    """One number compared: at most `max`, or at least `min`."""
    name: str
    value: float
    max: float | None = None
    min: float | None = None

    @property
    def ok(self) -> bool:
        return ((self.max is None or self.value <= self.max)
                and (self.min is None or self.value >= self.min))

    def entry(self) -> dict:
        out = {"value": self.value}
        out.update({k: v for k, v in (("max", self.max), ("min", self.min))
                    if v is not None})
        return out


@dataclasses.dataclass
class Window:
    """One measured window: the host-clock spans and counts it took, and
    the driver's record of what it served."""
    spans: dict = dataclasses.field(default_factory=lambda: defaultdict(list))
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    served: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Run:
    """What one run knows: the cell, and what its windows measured."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    setup_s: float = 0.0
    host: Window | None = None
    traced: Window | None = None
    work: dict = dataclasses.field(default_factory=dict)
    profile: dict | None = None
    peaks: dict | None = None

    @property
    def windows(self) -> list[Window]:
        return [w for w in (self.host, self.traced) if w is not None]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark's, by file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def driver_of(traffic: dict):
    return load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                       f"portbench_driver_{traffic['driver']}")


def new_run(bench, cell, seed, seconds, trace, device):
    """The Run of a cell, with its configuration and traffic mix."""
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return Run(cell, config, mix, seed, seconds, trace, device)


def serve_window(drv, run: Run, state, t_start: float) -> Window:
    """One window of run.seconds from t_start through the driver."""
    win = Window()
    drv.serve(run, state, win, t_start + run.seconds)
    return win


def execute(run: Run, t0: float) -> tuple[dict, list[Check]]:
    """Set up, serve the untraced window and, with --trace 1, the traced
    one, then check; returns the result line's entries and the checks."""
    import torch

    drv = driver_of(run.traffic)
    state = drv.setup(run)
    gc.collect()
    gc.freeze()       # the inputs stay out of the window's collections
    on_card = run.device.startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
    t_start = time.perf_counter()
    run.setup_s = t_start - t0
    run.host = serve_window(drv, run, state, t_start)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card
                       else "cpu"),
              "count": 1}
    if run.trace:
        from portbench import peaks
        from portbench.trace import Profile
        run.peaks = peaks.card_peaks(
            torch.cuda.get_device_properties(0).multi_processor_count,
            float(peaks.smi("clocks.max.sm").split()[0]))
        with Profile() as prof:
            run.traced = serve_window(drv, run, state, time.perf_counter())
        run.profile = prof.summary()
        run.profile["window_s"] = prof.window_s
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = prof.window_s
        del prof
        print("tracing's cost: done a second untraced "
              f"{run.host.counts['done'] / run.seconds}, traced "
              f"{run.traced.counts['done'] / run.seconds}", file=sys.stderr)
    device["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if on_card else 0)
    drv.release(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    a = time.perf_counter()
    checks = drv.check(run, state)
    print(f"set-up {run.setup_s:.2f} s; window {run.seconds} s; "
          f"reference and work {time.perf_counter() - a:.2f} s",
          file=sys.stderr)
    line = {"correct": all(c.ok for c in checks),
            "attempted": sum(w.counts["attempted"] for w in run.windows),
            "failed": sum(w.counts["failed"] for w in run.windows),
            "metrics": {}, "device": device}
    return line, checks


def read_metrics(run: Run, wanted: list[dict]) -> dict:
    out = {}
    for m in wanted:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{len(out)}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (genomics_tpu_torch is not genomics_tpu)."""
    return sorted({n for n in sys.modules if n.split(".")[0] in BANNED})


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    cell = cell_of(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    from portbench import peaks
    print("card: " + peaks.smi("name,clocks.sm,clocks.max.sm,power.limit"),
          file=sys.stderr)
    run = new_run(bench, cell, args.seed, args.seconds, bool(args.trace),
                  "cuda")
    line, checks = execute(run, t0)
    line["metrics"] = read_metrics(run, metrics_of(bench, cell, run.trace))
    if run.trace:
        line["breakdown"] = {k: [list(x) for x in run.profile[k]]
                             for k in ("device_ops", "idle_gaps")}
    found = banned_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    line["checks"] = {c.name: c.entry() for c in checks}
    print(json.dumps(line))
    sys.stdout.flush()
    for c in checks:
        bound = (f"<= {c.max}" if c.max is not None else f">= {c.min}")
        print(f"check {c.name}: {c.value} (limit {bound})"
              f"{'' if c.ok else '  FAILED'}", file=sys.stderr)
    return 0
