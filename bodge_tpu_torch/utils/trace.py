"""Profiler trace hooks: ``torch.profiler`` and NVTX ranges.

The counterpart of ``bodge_tpu/utils/trace.py`` (``jax.profiler``).  A trace
is a Chrome trace file (chrome://tracing, ui.perfetto.dev); the spans of
:func:`annotate` show in it, and on a card also as NVTX ranges.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch


@contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed block into ``log_dir``
    (``trace.json``): host activity, and the card's kernels where a CUDA
    device is present.  Wrap whole sweeps, not single launches."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextmanager
def annotate(name: str):
    """Named region inside a trace (a span in the trace file, and an NVTX
    range on a card)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield
