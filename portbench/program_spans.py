"""The program's own spans and counters (`genomics_tpu_torch.utils.
profiling`) as the per-layer metrics read them.  The program records
only while a profiler does, so a reading is None without a profile, and
None from a program that records no spans."""


def _totals(run):
    if run.profile is None:
        return None
    from genomics_tpu_torch.utils import profiling
    if not hasattr(profiling, "totals"):
        return None
    return profiling.totals()


def spans_per(run, names, counter, scale, self_time=False):
    """scale x the summed total (or self) time in seconds of the spans
    `names` over the counter `counter`; None where the counter is 0 or
    none of the spans was recorded."""
    t = _totals(run)
    if t is None:
        return None
    spans, n = t["spans"], t["counters"].get(counter)
    got = [spans[k]["self_s" if self_time else "total_s"]
           for k in names if k in spans]
    return scale * sum(got) / n if n and got else None


def counter_pct(run, part, whole):
    """100 x the counter `part` over the counter `whole`; None where
    `whole` is 0."""
    t = _totals(run)
    if t is None or not t["counters"].get(whole):
        return None
    return 100.0 * t["counters"].get(part, 0) / t["counters"][whole]
