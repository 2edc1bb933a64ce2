"""call_p95_ms: the 95th percentile of the wall times of every call in the window."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile([c.seconds for c in run.calls], 95))
