"""Host time AlignEngine's collect waits for the card per pair
dispatched, in the traced window: the program's `collect.wait` span (the
batch's event synchronized before any copy) over its `dispatch.pairs`
counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import spans_per


def read(run):
    return spans_per(run, ("collect.wait",), "dispatch.pairs", 1e6)
