"""Host time in AsyncHandle.result() (wait, copy out, AlignmentJobs),
summed over the untraced window, per pair submitted."""


def read(run):
    x = run.host.spans.get("collect")
    return sum(x) * 1e6 / run.host.counts["attempted"] if x else None
