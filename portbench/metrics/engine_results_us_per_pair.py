"""Host time of AlignEngine's copies out and `AlignmentJob`s per pair
dispatched, in the traced window: the program's `collect.copy_out` and
`collect.jobs` spans over its `dispatch.pairs` counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import spans_per


def read(run):
    return spans_per(run, ("collect.copy_out", "collect.jobs"),
                     "dispatch.pairs", 1e6)
