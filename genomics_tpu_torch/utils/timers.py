"""Wall-clock timers + GCUPS counters: the port's copy of
`genomics_tpu/utils/timers.py` (the reference has five hand-rolled timer
headers — CDP/NW/timer.h, PairHMM clock_gettime, STAR omp_get_wtime, SW
unixtimer.h, nGIA timer.h; this is the one shared replacement).  Host
clock: time the card's work after a `torch.cuda.synchronize()`, or with
CUDA events."""
from __future__ import annotations

import json
import time


class Timer:
    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t0: dict[str, float] = {}

    def start(self, name: str):
        self._t0[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._t0.pop(name)
        self.laps[name] = self.laps.get(name, 0.0) + dt
        return dt

    def gcups(self, name: str, cells: int) -> float:
        return cells / self.laps[name] / 1e9 if self.laps.get(name) else 0.0

    def report(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.laps.items()})


def runtimes_file_append(path: str, label: str, seconds: float) -> None:
    """Append 'label seconds' — the runtimes_*.txt convention of the NW
    app (CDP/NW/main.cu:186-194)."""
    with open(path, "a") as fh:
        fh.write(f"{label} {seconds:.6f}\n")
