"""The trace's reduction on made-up events: busy time is the union of
device intervals, kernel time their sum, idle gaps named by the host."""
import torch

from portbench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, dev, start, dur, kind=None, mark=False):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._mark = mark

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._mark


def test_summary():
    evs = [Ev("engine.submit", CPU, 0, 1000, mark=True),
           Ev("aten::copy_", CPU, 100, 50),
           Ev("engine.submit", CUDA, 0, 1000),       # device copy of a mark
           Ev("k1", CUDA, 10, 20), Ev("k2", CUDA, 25, 20),
           Ev("Memcpy HtoD (Pageable -> Device)", CUDA, 60, 5),
           Ev("k1", CUDA, 300, 100)]
    s = trace.summarize(evs)
    assert s["busy_s"] == (35 + 5 + 100) / 1e9
    assert s["kernel_s"] == (20 + 20 + 100) / 1e9
    assert s["kernels"] == 3
    assert dict(s["device_ops"])["k1"] == 120 / 1e9
    # gaps 45-60 and 65-300, both in the submit span (the copy ended)
    assert dict(s["idle_gaps"]) == {"engine.submit": (15 + 235) / 1e9}


def test_innermost_host_event_names_the_gap():
    host = [(0, 1000, "outer"), (100, 200, "inner"), (300, 310, "late")]
    assert trace._doing(host, [50, 150, 250, 305, 2000]) == [
        "outer", "inner", "outer", "late", "python"]
