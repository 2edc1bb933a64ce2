"""descent_step_ms: the window's wall time over the descent steps it completed."""


def read(run):
    return 1e3 * run.window_s / run.units if run.units else None
