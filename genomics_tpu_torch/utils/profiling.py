"""Profiling: the port's counterpart of `genomics_tpu/utils/profiling.py`
(the reference has per-app wall-clock timers and checked-in Nsight
traces; here `torch.profiler`, and the program's own spans and counters
on its clock).

Spans and counters mark the host work of the main paths at batch,
chunk, bucket, region or launch granularity, never a pair's:

    with profiling.span("dispatch", batch=profiling.NEW) as sp:
        with profiling.span("dispatch.encode"):
            ...
        if sp:                      # work done only for a counter
            sp.count("dispatch.cells", int(qlen @ tlen))

They record exactly while a `torch.profiler` session records (`trace()`
below, or any `torch.profiler.profile`), with no switch of their own.
While none does, `span()` reads one flag and hands out a shared span
that does nothing and is false.  While one does, a span opens a
`torch.profiler.record_function` of its name, so it shows in the trace
beside the card's kernels and copies, and keeps its name, start, end,
parent span and batch id in memory.  Its times are `time.time_ns()`,
the epoch nanoseconds of the profiler's own events, taken inside the
`record_function`: each span lies within the profiler's event of its
name.  A batch id is drawn by `batch=NEW`, handed on by `batch=<id>`,
and otherwise taken from the parent span.  Counters are integer sums
kept beside the spans.

`totals()` reads each span name's count, total and self time (its
duration less what its direct child spans cover) and the counters;
`spans()` the spans themselves; `clear()` drops both.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

NEW = object()          # span(..., batch=NEW): draw a new batch id

_spans: list = []
_counters: dict = defaultdict(int)
_batch_ids = itertools.count(1)
_local = threading.local()


def recording() -> bool:
    """Whether a `torch.profiler` session records now."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The span handed out while nothing records: does nothing, is
    false, and has no batch id."""
    __slots__ = ()
    batch = None

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, name: str, n: int = 1):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "batch", "parent", "start", "end", "_rf")

    def __init__(self, name: str, batch):
        self.name = name
        self.batch = batch
        self.parent = None
        self.start = self.end = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.batch is NEW:
            self.batch = next(_batch_ids)
        elif self.batch is None and self.parent is not None:
            self.batch = self.parent.batch
        self._rf = _autograd_profiler.record_function(self.name)
        self._rf.__enter__()
        _spans.append(self)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        return False

    def count(self, name: str, n: int = 1):
        _counters[name] += n


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, batch=None):
    """A context manager that records `name` while a profiler records;
    see the module's docstring."""
    return _Span(name, batch) if _autograd_profiler._is_profiler_enabled \
        else _OFF


def spans() -> list[tuple]:
    """The spans recorded since the last clear(), in the order they
    opened: (name, start_ns, end_ns, parent index or -1, batch id);
    end_ns is None while a span is open."""
    done = list(_spans)
    index = {id(s): k for k, s in enumerate(done)}
    return [(s.name, s.start, s.end,
             -1 if s.parent is None else index.get(id(s.parent), -1),
             s.batch) for s in done]


def totals() -> dict:
    """{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: n}} over the spans ended and the counts made since the last
    clear()."""
    done = [s for s in list(_spans) if s.end is not None]
    children = defaultdict(int)
    for s in done:
        if s.parent is not None:
            children[id(s.parent)] += s.end - s.start
    out = {}
    for s in done:
        t = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        dur = s.end - s.start
        t["count"] += 1
        t["total_s"] += dur / 1e9
        t["self_s"] += (dur - children[id(s)]) / 1e9
    return {"spans": out, "counters": dict(_counters)}


def clear():
    """Drop every recorded span and counter."""
    _spans.clear()
    _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region on the host and, where a card is present, on the
    card (CUPTI), and write it as a Chrome trace, `log_dir`/trace.json,
    with the program's spans among its events.  Clears the spans and
    counters first, so totals() afterwards reads this region alone:

        with profiling.trace("prof") as prof:
            engine.align(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
        print(profiling.totals())

    Open the file in chrome://tracing or Perfetto.  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    clear()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
