"""What one run recorded, as the metric readers see it.

A reader (``portbench/metrics/<name>.py``) has one function, ``read(run)``, that
returns a number or ``None`` when the run holds nothing to read it from.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Call:
    t0: float  # host clock at the call's start and end, seconds
    t1: float
    units: int  # the work the cell counts: 1 a call, or descent steps
    work: list  # the call's work items for the yardstick
    output: object = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Run:
    cell: object
    traced: bool
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)  # the benchmark's own host-clock spans, seconds
    calls: list = field(default_factory=list)
    window_s: float = 0.0
    launches: dict = field(default_factory=dict)  # program counters: window's difference by kernel
    peak_bytes: int = 0
    trace: Optional[object] = None  # devtrace.DeviceTrace of the traced window
    _least: Optional[float] = None

    @property
    def units(self) -> int:
        return sum(c.units for c in self.calls)

    def kernel_launches(self) -> int:
        return sum(v for k, v in self.launches.items() if not k.endswith(".steps"))

    def least_seconds(self) -> float:
        """The yardstick's least device time of every call in the window."""
        if self._least is None:
            from portbench import yardstick
            from portbench.reference.bdg import nonzeros_per_site

            op = yardstick.Operator(self.cell.config["shape"], nonzeros_per_site(self.cell.config))
            self._least = sum(yardstick.least_seconds(op, c.work) for c in self.calls)
        return self._least
