"""Host time of AlignEngine's encoding and packing (buckets, padded
rows, the N count) per pair dispatched, in the traced window: the self
time of the program's `dispatch.encode` and `dispatch.pack` spans over
its `dispatch.pairs` counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import spans_per


def read(run):
    return spans_per(run, ("dispatch.encode", "dispatch.pack"),
                     "dispatch.pairs", 1e6, self_time=True)
