"""The frozen roofline of the benchmark: published peaks, and the least work of a call.

Peaks of one NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU data sheet at
its 700 W limit: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores,
50 MB of L2; 132 SMs, each with 256 KB of L1 / shared memory and 64 K 32-bit registers.

The least time of a call is the larger of its floating-point work at the float32
peak and its least HBM bytes at the memory peak. The work is what the inputs need,
whatever implements it:

- a product with the operator costs 8 flops (one complex multiply-add) for each
  nonzero complex entry of the operator's rows that the vectors reach, and each
  column; a Chebyshev step adds 12 flops a vector entry (the axpy and two real inner
  products), a backward step the same (the adjoint's axpy and the field's contraction);
- vectors hold complex64 entries (8 bytes), as does the operator;
- a unit probe at a site reaches only the sites within m hops after m products (the
  operators are nearest-neighbour), so the m-th vector of a site probe counts the
  sites within Manhattan distance m; random probes count every site;
- bytes: each step moves at least the part of its working set (the operator rows it
  reads, the vectors it reads and writes) that exceeds the on-chip memory, and the
  call moves at least its inputs and outputs once; the least bytes are the larger
  of the two sums.

The estimate of the spectral bound is not counted in a call: a bound can be had from
one pass over the operator, which the sweep's first step already reads. Power
iterations are modelled all the same, for a kernel timed alone.
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SMS = 132
ON_CHIP_BYTES = 50 * 2**20 + SMS * (256 * 2**10 + 65536 * 4)
ENTRY_BYTES = 8  # complex64
STEP_FLOPS_PER_ENTRY = 12


def sweep_steps(order: int) -> int:
    """Products of a moment sweep of ``order`` moments, two moments a product."""
    return 1 + max(0, (order - 1) // 2)


class Operator:
    """The sizes of one configuration's operator that the least work depends on."""

    def __init__(self, shape, nonzeros_per_site: np.ndarray):
        self.shape = tuple(int(n) for n in shape)
        self.nnz_site = np.asarray(nonzeros_per_site, np.int64)
        self.n = len(self.nnz_site)
        self.nnz = int(self.nnz_site.sum())

    def distance(self, site: int) -> np.ndarray:
        """``[N]`` Manhattan distances of every site from ``site``."""
        d = 0
        for axis, (n, at) in enumerate(zip(self.shape, np.unravel_index(site, self.shape))):
            shape = [1, 1, 1]
            shape[axis] = n
            d = d + np.abs(np.arange(n) - at).reshape(shape)
        return d.ravel()

    def _cumulative(self, d: np.ndarray, radius: int, weights=None) -> np.ndarray:
        d = np.minimum(d, radius + 1)
        return np.cumsum(np.bincount(d, weights=weights, minlength=radius + 2)[:radius + 1])

    def reach(self, site: int, radius: int):
        """``(sites, nonzeros)`` within Manhattan distance 0..radius of ``site``:
        two ``[radius + 1]`` cumulative counts."""
        d = self.distance(site)
        return self._cumulative(d, radius), self._cumulative(d, radius, self.nnz_site)

    def union_reach(self, sites, radius: int) -> np.ndarray:
        """Nonzeros within distance 0..radius of any of ``sites`` (cumulative)."""
        d = np.minimum.reduce([self.distance(s) for s in set(int(s) for s in sites)])
        return self._cumulative(d, radius, self.nnz_site)


def _sweep(op: Operator, K: int, order: int, sites, backward: bool):
    """(flops, step bytes, input bytes) of one moment sweep over ``K`` columns:
    unit probes at ``sites`` (one per column) or, with ``sites=None``, dense ones;
    with ``backward`` also its reverse pass for a gradient."""
    steps = sweep_steps(order)
    m = np.arange(1, steps + 1)  # the product that makes t_m
    if sites is None:
        ent = np.full(steps + 1, 4.0 * op.n * K)  # vector entries of t_0 .. t_steps
        nnz = np.full(steps + 1, float(op.nnz) * K)  # operator entries reached, summed over columns
        op_rows = np.full(steps + 1, float(op.nnz))
        probe_bytes = 4 * op.n * K * ENTRY_BYTES
    else:
        ent, nnz = np.zeros(steps + 1), np.zeros(steps + 1)
        columns, repeats = np.unique(np.asarray(sites, np.int64), return_counts=True)
        for s, r in zip(columns, repeats):
            n_s, z_s = op.reach(int(s), steps)
            ent += 4 * r * n_s
            nnz += r * z_s
        op_rows = op.union_reach(sites, steps)
        probe_bytes = 0
    vec = lambda i: ent[np.maximum(i, 0)] * ENTRY_BYTES
    flops = float((8 * nnz[m] + STEP_FLOPS_PER_ENTRY * ent[m]).sum())
    ws = op_rows[m] * ENTRY_BYTES + vec(m) + vec(m - 1) + np.where(m >= 2, vec(m - 2), 0)
    step_bytes = float(np.maximum(ws - ON_CHIP_BYTES, 0).sum())
    inputs = op_rows[steps] * ENTRY_BYTES + probe_bytes
    if backward:  # the adjoint recursion, and the stored t_m read back
        flops *= 2
        ws_back = op_rows[m] * ENTRY_BYTES + 3 * vec(m) + vec(m - 1)
        step_bytes += float(np.maximum(ws_back - ON_CHIP_BYTES, 0).sum())
    return flops, step_bytes, float(inputs)


def _power(op: Operator, steps: int):
    """(flops, step bytes, input bytes) of ``steps`` normalised products with one
    dense vector: a product, a norm and a scaling (6 flops a vector entry) a step."""
    vec = 4 * op.n * ENTRY_BYTES
    flops = steps * (8.0 * op.nnz + 6.0 * 4 * op.n)
    step_bytes = steps * max(op.nnz * ENTRY_BYTES + 2 * vec - ON_CHIP_BYTES, 0)
    return flops, float(step_bytes), float(op.nnz * ENTRY_BYTES + vec)


def call_cost(op: Operator, work) -> tuple:
    """(flops, least bytes) of a call from its work items, each a dict with
    ``kind`` "moments" (a moment sweep), "gradient" (a sweep and its reverse) or
    "power" (``steps`` power iterations); ``order``, ``K``, and ``sites`` (one per
    column) for unit probes."""
    flops = step_bytes = inputs = 0.0
    for item in work:
        if item["kind"] == "power":
            f, b, i = _power(op, item["steps"])
        else:
            f, b, i = _sweep(op, item["K"], item["order"], item.get("sites"), item["kind"] == "gradient")
        flops += f * item.get("repeat", 1)
        step_bytes += b * item.get("repeat", 1)
        inputs = max(inputs, i)
    return flops, max(step_bytes, inputs)


def least_seconds(op: Operator, work) -> float:
    flops, nbytes = call_cost(op, work)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
