"""h2d_mb_per_call.ldos: bytes of the traced window's host-to-device copies over its
calls, in MB (10^6 bytes)."""


def read(run):
    if run.trace is None or not run.calls:
        return None
    return run.trace.copied_bytes("HtoD") / 1e6 / len(run.calls)
