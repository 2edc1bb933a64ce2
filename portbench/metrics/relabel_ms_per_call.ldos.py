"""relabel_ms_per_call.ldos: host milliseconds a call inside the program's spans bodge.gather.relabel
(the gather path's relabelling of the operator and the vectors) and bodge.gather.plan (a gather plan
built) in the traced window."""

SPANS = ("bodge.gather.relabel", "bodge.gather.plan")


def read(run):
    if run.trace is None or not run.calls:
        return None
    from portbench.harness.devtrace import union

    t = run.trace
    spans = [(s, e) for s, e, n in t.host if n in SPANS]
    if not spans:
        return None
    return 1e3 * union(spans, t.t0, t.t1) / len(run.calls)
