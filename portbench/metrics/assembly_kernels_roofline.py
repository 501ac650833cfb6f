"""Share of the roofline: the least time of the traced window's work
at the card's peaks (`work/`, `peaks.py`) over the summed time of every
kernel in the trace, whatever its name."""
from portbench.peaks import least_seconds


def read(run):
    if run.profile is None or not run.profile["kernel_s"]:
        return None
    return 100.0 * least_seconds(run.work, run.peaks) \
        / run.profile["kernel_s"]
