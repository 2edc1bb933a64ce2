"""The traced window: ``torch.profiler`` over CPU and CUDA, reduced to intervals.

The profiler's Chrome trace is written to a file under ``TMPDIR``, read back and
deleted. Device operations are its ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events; the window runs from the start of the first call span to the end of the
last, on the host thread that opened them. All times below are in seconds.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

SPAN_PREFIX = "portbench."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def finish(prof) -> "DeviceTrace":
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return DeviceTrace(events["traceEvents"] if isinstance(events, dict) else events)


def union(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


class DeviceTrace:
    def __init__(self, events):
        spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                 and e.get("name", "").startswith(SPAN_PREFIX)]
        if not spans:
            raise RuntimeError("the trace holds no call span")
        self.tid = spans[0]["tid"]
        self.t0 = min(e["ts"] for e in spans) * 1e-6
        self.t1 = max(e["ts"] + e["dur"] for e in spans) * 1e-6
        self.device = []  # (start, end, category, name, bytes)
        self.host = []  # (start, end, name) on the calling thread
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, t = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            if e.get("cat") in DEVICE_CATEGORIES:
                if t > self.t0 and s < self.t1:
                    self.device.append((s, t, e["cat"], e["name"], e.get("args", {}).get("bytes", 0)))
            elif e.get("cat") in ("cpu_op", "user_annotation") and e.get("tid") == self.tid:
                self.host.append((s, t, e["name"]))
        self.device.sort()
        self.host.sort(key=lambda h: (h[0], -h[1]))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self, categories=DEVICE_CATEGORIES) -> float:
        return union([(s, t) for s, t, c, _n, _b in self.device if c in categories], self.t0, self.t1)

    def kernel_busy_s(self) -> float:
        return self.busy_s(("kernel",))

    def copied_bytes(self, direction: str) -> int:
        """Bytes of the window's copies whose name holds ``direction`` ("HtoD", ...)."""
        return sum(b for s, _t, c, n, b in self.device if c == "gpu_memcpy" and direction in n and s >= self.t0)

    def device_ops(self):
        """``[[name, seconds]]``: the device operations that took most time, by name."""
        by_name = defaultdict(float)
        for s, t, _c, n, _b in self.device:
            by_name[n[:160]] += min(t, self.t1) - max(s, self.t0)
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    def gaps(self):
        """``(start, end)`` of every stretch of the window with no device operation."""
        out, reach = [], self.t0
        for s, t, *_ in self.device:
            if s > reach:
                out.append((reach, min(s, self.t1)))
            reach = max(reach, t)
        if reach < self.t1:
            out.append((reach, self.t1))
        return [(s, t) for s, t in out if t > s]

    def idle_gaps(self):
        """``[[host operation, seconds]]``: the device's idle time, summed by the
        innermost host operation or call span open at the middle of each gap."""
        by_op = defaultdict(float)
        stack, i = [], 0
        for s, t in self.gaps():  # gaps come in time order, so the host ops are swept once
            mid = 0.5 * (s + t)
            while i < len(self.host) and self.host[i][0] <= mid:
                while stack and stack[-1][1] <= self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            by_op[stack[-1][2] if stack else "outside any call"] += t - s
        return [[n, v] for n, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]]
