"""sweep_roofline: the yardstick's least device time of the window's calls over the device's
kernel-busy time in the traced window, in percent. Whatever kernels ran count."""


def read(run):
    if run.trace is None:
        return None
    busy, least = run.trace.kernel_busy_s(), run.least_seconds()
    return 100.0 * least / busy if busy > 0 and least > 0 else None
