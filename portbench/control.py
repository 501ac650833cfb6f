"""The control of each cell's comparison: the reference put in the
program's place, computed one precision below the configuration's, must
come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--device cuda]

For each seed it makes the cell's inputs as a run does, and the cell's
driver (`drivers/<driver>.py`, its `control`) takes the reference's
answers at full precision and the control's (for the present drivers:
DP cells clamped to int8 where the configuration needs int16, PairHMM
values rounded to bf16 where it states f32) and compares them with the
cell's own comparison, over as many answers as a run compares.  Each
number is printed beside its limit.  It runs no program code.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = harness.manifest()
    cell = harness.cell_of(bench, args.workload)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.new_run(bench, cell, seed, 0, False, args.device)
        checks = harness.driver_of(run.traffic).control(run)
        correct = all(c.ok for c in checks)
        failed_all &= not correct
        print(f"{args.workload} seed {seed}: control correct={correct}; "
              + ", ".join(f"{c.name} {c.value} (limit "
                          f"{'<= %s' % c.max if c.max is not None else '>= %s' % c.min})"
                          for c in checks), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
