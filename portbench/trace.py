"""The traced window: `torch.profiler` over the card and the host, and
its reduction to device busy time, kernel time and a breakdown.

Device activity is what CUPTI records on the card: kernels, copies and
memsets (`DEVICE_KINDS`); the device-side copies of the benchmark's
own annotations are left out.  Busy time is the union of those
intervals; kernel time the sum of the kernels' durations.  An idle gap
is named by what the host was doing at its middle: the innermost
profiler event that covers it (an annotation of the benchmark's, a
torch operator or a CUDA runtime call), else "python".
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Profile:
    """`with Profile() as p:` traces the window; `p.summary()` reduces
    it.  `window_s` is the host clock's length of the traced window, to
    the card's last operation."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.window_s = None

    def __enter__(self):
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        return self.prof.__exit__(*exc)

    def summary(self) -> dict:
        return summarize(self.prof.profiler.kineto_results.events())


def _union(intervals):
    """Merged [start, end] intervals of a list sorted by start."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _kind(e, cuda, marks) -> str:
    """The event's activity kind; where the profiler does not give it,
    from the device and the name (a device event named as one of the
    host's annotations is that annotation's device copy)."""
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    if e.device_type() != cuda:
        return "cpu_op"
    if name in marks:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def summarize(events) -> dict:
    """busy_s, kernel_s, kernels (launch count), device_ops and
    idle_gaps (the breakdown's lists, seconds) from kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    marks = {e.name() for e in events
             if e.device_type() != cuda and e.is_user_annotation()}
    dev, host, kinds = [], [], set()
    for e in events:
        kind = _kind(e, cuda, marks)
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == cuda:
            kinds.add(kind)
            if kind in DEVICE_KINDS:
                dev.append((start, end, e.name(), kind))
        else:
            host.append((start, end, e.name()))
    print(f"trace: {len(dev)} device operations of the kinds "
          f"{sorted(kinds)}; {len(host)} host events", file=sys.stderr)
    dev.sort()
    busy = _union([[a, b] for a, b, _, _ in dev])
    kernels = [(b - a, n) for a, b, n, k in dev if k == "kernel"]
    by_name = defaultdict(float)
    for a, b, n, _ in dev:
        by_name[n[:96]] += (b - a) / 1e9
    gaps = defaultdict(float)
    mids = [((a + b) // 2, (b - a) / 1e9)
            for (_, a), (b, _) in zip(busy, busy[1:])]
    for (t, s), name in zip(mids, _doing(host, [t for t, _ in mids])):
        gaps[name] += s
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernel_s": sum(d for d, _ in kernels) / 1e9,
        "kernels": len(kernels),
        "device_ops": sorted(by_name.items(), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:TOP],
    }


def _doing(host, times) -> list[str]:
    """For each of the sorted `times`, the innermost host event that
    covers it (host events nest, so a stack of the open ones holds it on
    top), else "python"."""
    host = sorted(host)
    out, stack, k = [], [], 0
    for t in times:
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2][:96] if stack else "python")
    return out
