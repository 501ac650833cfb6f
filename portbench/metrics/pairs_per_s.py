"""Alignments whose results came back inside the untraced window, over
its length (host clock)."""


def read(run):
    return run.host.counts["done"] / run.seconds
