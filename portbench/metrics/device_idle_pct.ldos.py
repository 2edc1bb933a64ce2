"""device_idle_pct.ldos: the share of the traced window in which no kernel runs on the device, in
percent (copies count as idle)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.kernel_busy_s() / run.trace.window_s)
