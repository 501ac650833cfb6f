"""95th percentile of a batch's time from align_async to its results,
over every batch of the untraced window (the benchmark's span)."""
import numpy as np


def read(run):
    x = run.host.spans.get("batch")
    return float(np.percentile(x, 95)) * 1e3 if x else None
