"""Process start to the first timed item: imports, kernel libraries,
inputs from the seed, warm-up (host clock)."""


def read(run):
    return run.setup_s
