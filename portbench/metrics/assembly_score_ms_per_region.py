"""Host time of local_assembly's haplotype scoring (the PairHMM records,
copies, launch and copy out, the log10 sums and the sort) per region, in
the traced window: the program's `assembly.score` span over its
`assembly.regions` counter.
None where the program records nothing (`program_spans.py`)."""
from portbench.program_spans import spans_per


def read(run):
    return spans_per(run, ("assembly.score",), "assembly.regions", 1e3)
