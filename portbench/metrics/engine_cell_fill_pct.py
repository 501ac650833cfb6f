"""Share of the DP cells AlignEngine launched that are the pairs' own
(query length x target length) rather than bucket padding, in the traced
window: the program's `dispatch.cells` over its `dispatch.cells_launched`
counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import counter_pct


def read(run):
    return counter_pct(run, "dispatch.cells", "dispatch.cells_launched")
