"""call_ms: the window's wall time over the calls it completed (host clock)."""


def read(run):
    return 1e3 * run.window_s / len(run.calls)
