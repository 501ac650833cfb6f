"""Host time of local_assembly's variant call (call_variants: the GLOBAL
engine with traceback and the CIGAR walk, where the best haplotype is
not the reference) per region, in the traced window: the program's
`assembly.call` span over its `assembly.regions` counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import spans_per


def read(run):
    return spans_per(run, ("assembly.call",), "assembly.regions", 1e3)
