"""Profiling hooks: the port's counterpart of
`genomics_tpu/utils/profiling.py` (the reference has per-app wall-clock
timers and checked-in Nsight traces; here `torch.profiler` and the shared
Timer/GCUPS counters of utils.timers)."""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region on the host and, where a card is present, on the
    card (CUPTI), and write it as a Chrome trace, `log_dir`/trace.json:

        with profiling.trace("prof") as prof:
            engine.align(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))

    Open the file in chrome://tracing or Perfetto.  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """The caching allocator's statistics of a card
    (`torch.cuda.memory_stats`); {} without one."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
