"""Roofline accounting and benchmark timing helpers.

The counterpart of ``bodge_tpu/utils/profiling.py``: every hot kernel of the
port is measured against the card's device-memory rate ("speed of light"),
since block-sparse products of 4×4 blocks are bound by bytes.  On the card a
copy rate is measured with CUDA events (:func:`measure_hbm_bandwidth`); the
published rate (:data:`HBM_SPECS`, :func:`hbm_roof_for_device`) is the
roof.  Nothing here falls back to the CPU: a device measurement without a
card raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch


def best_time(fn: Callable[[], None], repeats: int = 5, warmup: int = 2) -> float:
    """Minimum wall-clock seconds of ``fn()`` over ``repeats`` calls after
    ``warmup`` calls (the reference's methodology).  ``fn`` must end in a
    synchronisation (e.g. a host read of a result) to time device work."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def time_iterated(make_run: Callable[[int], Callable[[], float]], n_lo: int, n_hi: int,
                  repeats: int = 3) -> float:
    """Per-iteration wall-clock seconds via a two-point slope fit.

    ``make_run(n)`` returns a zero-argument callable that runs ``n``
    sequentially dependent iterations and returns a Python scalar derived
    from the result (which forces the device to finish).  Timing the
    difference between ``n_hi`` and ``n_lo`` iterations cancels the
    per-call constants (launch, transfer)."""
    run_lo, run_hi = make_run(n_lo), make_run(n_hi)
    run_lo(), run_hi()  # warm both
    t_lo = best_time(run_lo, repeats=repeats, warmup=1)
    t_hi = best_time(run_hi, repeats=repeats, warmup=1)
    return max(t_hi - t_lo, 1e-12) / (n_hi - n_lo)


def measure_hbm_bandwidth(nbytes: int = 1 << 30, reps: int = 10, device=None) -> float:
    """Achievable device-memory rate (bytes/s) of a device-to-device copy of
    ``nbytes`` bytes, timed by CUDA events over ``reps`` copies after a
    warm-up; each byte counts once read and once written.  The default size
    is far beyond the L2 cache.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_hbm_bandwidth needs a CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda") if device is None else torch.device(device)
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    with torch.cuda.device(device):
        dst.copy_(src)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            dst.copy_(src)
        end.record()
        torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / reps * 1e-3
    return 2 * nbytes / seconds


# Published device-memory rates (bytes/s) by a substring of the CUDA device
# name, most specific first.  Sources: NVIDIA H100 Tensor Core GPU data sheet
# (H100 SXM5 80 GB HBM3: 3.35 TB/s; H100 NVL 94 GB HBM3: 3.9 TB/s; H100 PCIe
# 80 GB HBM2e: 2.0 TB/s), NVIDIA H200 data sheet (141 GB HBM3e: 4.8 TB/s),
# NVIDIA A100 data sheet (80 GB HBM2e: 2,039 GB/s; 40 GB HBM2: 1,555 GB/s).
HBM_SPECS = {
    "h100 nvl": 3.9e12,
    "h100 pcie": 2.0e12,
    "h100": 3.35e12,
    "h200": 4.8e12,
    "a100 80gb": 2.039e12,
    "a100": 1.555e12,
}


def hbm_roof_for_device(device=None) -> float:
    """Published device-memory rate (bytes/s) of ``device`` (a CUDA device,
    its index, or a name as ``torch.cuda.get_device_name`` gives it; default:
    the current card).  Raises for a device not in :data:`HBM_SPECS`."""
    name = device if isinstance(device, str) and not device.startswith("cuda") else torch.cuda.get_device_name(device)
    for key, rate in HBM_SPECS.items():
        if key in name.lower():
            return rate
    raise ValueError(f"no published memory rate for device {name!r} (known: {sorted(HBM_SPECS)})")


@dataclass
class Roofline:
    """Memory-roofline verdict for one measured kernel."""

    time_s: float
    bytes_moved: int
    flops: int
    hbm_bw: float

    @property
    def achieved_bw(self) -> float:
        return self.bytes_moved / self.time_s

    @property
    def fraction_of_roof(self) -> float:
        return self.achieved_bw / self.hbm_bw

    @property
    def roof_time_s(self) -> float:
        return self.bytes_moved / self.hbm_bw

    def summary(self) -> str:
        return (
            f"{self.time_s*1e6:.1f} µs ({self.achieved_bw/1e9:.1f} GB/s, "
            f"{100*self.fraction_of_roof:.1f}% of {self.hbm_bw/1e9:.0f} GB/s roof)"
        )
