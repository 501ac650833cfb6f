"""Host time in AlignEngine.align_async (encode, bucket, pad, copy in,
launch), summed over the untraced window, per pair submitted."""


def read(run):
    x = run.host.spans.get("submit")
    return sum(x) * 1e6 / run.host.counts["attempted"] if x else None
