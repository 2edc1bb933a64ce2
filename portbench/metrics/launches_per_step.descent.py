"""launches_per_step.descent: kernel launches of the port (its launch counters,
window's difference) over the window's descent steps."""


def read(run):
    n = run.kernel_launches()
    return n / run.units if n and run.units else None
