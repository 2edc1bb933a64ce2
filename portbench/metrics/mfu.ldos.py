"""mfu.ldos: the yardstick's least device time of the window's calls over the traced
window's wall time, in percent: the whole call's share of the card's peak."""


def read(run):
    if run.trace is None:
        return None
    least = run.least_seconds()
    return 100.0 * least / run.trace.window_s if least > 0 else None
