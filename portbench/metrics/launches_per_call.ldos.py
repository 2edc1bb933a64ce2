"""launches_per_call.ldos: kernel launches of the port (its launch counters,
window's difference) over the window's calls."""


def read(run):
    n = run.kernel_launches()
    return n / len(run.calls) if n and run.calls else None
