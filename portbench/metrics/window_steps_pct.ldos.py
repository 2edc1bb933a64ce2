"""window_steps_pct.ldos: the share of the window's Chebyshev step launches (ell_cheb_step,
ell_gather_cheb_step and their light-cone forms) that were light-cone forms, in percent, from the
program's launch counters. A program without the light-cone forms has no such counter: nothing."""

WINDOW = ("ell_cheb_step_window", "ell_gather_cheb_step_window")
WHOLE = ("ell_cheb_step", "ell_gather_cheb_step")


def read(run):
    if not all(name in run.launches for name in WINDOW):
        return None
    windowed = sum(run.launches[name] for name in WINDOW)
    steps = windowed + sum(run.launches.get(name, 0) for name in WHOLE)
    return 100.0 * windowed / steps if steps else None
