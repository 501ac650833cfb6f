"""Share of the traced window in which no kernel, copy or memset ran
on the card."""


def read(run):
    if run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
