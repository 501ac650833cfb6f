"""Host time of AlignEngine's copies in and kernel launches per pair
dispatched, in the traced window: the program's `dispatch.copy_in` and
`dispatch.launch` spans over its `dispatch.pairs` counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import spans_per


def read(run):
    return spans_per(run, ("dispatch.copy_in", "dispatch.launch"),
                     "dispatch.pairs", 1e6)
