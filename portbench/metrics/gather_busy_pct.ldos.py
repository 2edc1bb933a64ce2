"""gather_busy_pct.ldos: the share of the traced window's kernel-busy time spent in the kernels of
bodge_tpu_torch/csrc/ell_gather.cu (gather_kernel, gather_cluster_kernel, found by name), in percent."""

import re

GATHER = re.compile(r"(?<![\w])(gather_kernel|gather_cluster_kernel)<")


def read(run):
    if run.trace is None:
        return None
    from portbench.harness.devtrace import union

    t = run.trace
    busy = t.kernel_busy_s()
    mine = union([(s, e) for s, e, c, n, _b in t.device if c == "kernel" and GATHER.search(n)], t.t0, t.t1)
    return 100.0 * mine / busy if busy > 0 and mine > 0 else None
