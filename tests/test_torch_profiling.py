"""PyTorch port, tooling: ``utils.profiling`` (timers, roofline accounting,
the published memory rates) and ``utils.trace`` (``torch.profiler`` traces
with ``annotate`` spans), against the reference's ``bodge_tpu.utils`` where
both compute the same thing.  CPU activity only: the card's side runs in
``chip_smoke.py``."""

import json
import os

import pytest
import torch

from bodge_tpu.utils import profiling as jprof
from bodge_tpu_torch.utils import profiling as tprof
from bodge_tpu_torch.utils import trace as ttrace
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def test_roofline_matches_reference():
    for args in ((2.5e-4, 1_408_000_000, 80_000_000_000, 3.35e12), (1.0, 1, 0, 1.0)):
        ours, theirs = tprof.Roofline(*args), jprof.Roofline(*args)
        assert ours.achieved_bw == theirs.achieved_bw
        assert ours.fraction_of_roof == theirs.fraction_of_roof
        assert ours.roof_time_s == theirs.roof_time_s
        assert ours.summary() == theirs.summary()


def test_timers_give_positive_per_iteration_times():
    x = torch.ones(256)
    assert tprof.best_time(lambda: float(x.sum()), repeats=3, warmup=1) > 0

    def make_run(n):
        def run():
            y = x
            for _ in range(n):
                y = y * 1.0000001
            return float(y.sum())
        return run

    assert tprof.time_iterated(make_run, 2, 40, repeats=2) > 0


def test_published_memory_rates():
    assert tprof.hbm_roof_for_device("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tprof.hbm_roof_for_device("NVIDIA H100 NVL") == 3.9e12
    assert tprof.hbm_roof_for_device("NVIDIA H200") == 4.8e12
    with pytest.raises(ValueError, match="no published memory rate"):
        tprof.hbm_roof_for_device("Some Card")
    if not torch.cuda.is_available():  # a device measurement never falls back to the CPU
        with pytest.raises(RuntimeError, match="CUDA device"):
            tprof.measure_hbm_bandwidth(1 << 20)


def test_trace_writes_a_file_naming_the_annotated_span(tmp_path):
    log_dir = tmp_path / "trace"
    with ttrace.trace(str(log_dir)):
        with ttrace.annotate("bf16 sweep"):
            torch.arange(64.0).reshape(8, 8).sum()
    files = os.listdir(log_dir)
    assert files == ["trace.json"]
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "bf16 sweep" for e in events)
