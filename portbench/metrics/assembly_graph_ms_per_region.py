"""Host time of local_assembly's de Bruijn graph (build, prune) and its
k best paths per region, in the traced window: the program's
`assembly.graph` and `assembly.paths` spans over its `assembly.regions`
counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import spans_per


def read(run):
    return spans_per(run, ("assembly.graph", "assembly.paths"),
                     "assembly.regions", 1e3)
