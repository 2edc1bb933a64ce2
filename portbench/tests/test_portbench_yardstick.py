"""The frozen roofline: never above 100 % of a time measured on the card, and the
light cone of a unit probe counted exactly."""

import json
from collections import deque

import numpy as np
import pytest

from portbench import yardstick as Y
from portbench.reference.bdg import nonzeros_per_site

from conftest import ROOT

SWAVE = json.loads((ROOT / "portbench/configs/swave_1000x1000.json").read_text())
RASHBA = json.loads((ROOT / "portbench/configs/rashba_dp_64x64x4.json").read_text())


def operator(config, shape=None):
    config = dict(config, shape=shape or config["shape"])
    return Y.Operator(config["shape"], nonzeros_per_site(config))


# Device times measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the work, and
# the seconds the kernel took for it.
MEASURED = {
    "power 200x200, 60 steps (PR 11: 0.3874 ms)": (SWAVE, [200, 200, 1], [{"kind": "power", "steps": 60}], 0.3874e-3),
    "power 64x64x4, 60 steps (PR 11: 0.3213 ms)": (RASHBA, None, [{"kind": "power", "steps": 60}], 0.3213e-3),
    "moments 64x64x4, K 8, order 256 (PR 10: 1.0973 ms)": (
        RASHBA, None, [{"kind": "moments", "order": 256, "K": 8}], 1.0973e-3),
    "moments 200x200, K 4, order 512 (PR 10: 256 x 15.83 us)": (
        SWAVE, [200, 200, 1], [{"kind": "moments", "order": 512, "K": 4}], 256 * 15.83e-6),
    "per-step sweep 10^6, K 64, order 1024 (PR 13: 512 x 3.54 ms)": (
        SWAVE, None, [{"kind": "moments", "order": 1024, "K": 64}], 512 * 3.54e-3),
}


@pytest.mark.parametrize("case", sorted(MEASURED))
def test_least_time_is_below_the_measured_time(case):
    config, shape, work, seconds = MEASURED[case]
    assert Y.least_seconds(operator(config, shape), work) <= seconds


def test_power_kernel_at_200x200_is_flop_bound_far_under_its_time():
    """PR 11's power kernel read 130 % of the per-step byte bound that counted the
    operator every step; the frozen model does not charge bytes kept on chip."""
    op = operator(SWAVE, [200, 200, 1])
    flops, nbytes = Y.call_cost(op, [{"kind": "power", "steps": 60}])
    assert nbytes == op.nnz * Y.ENTRY_BYTES + 4 * op.n * Y.ENTRY_BYTES
    assert 100 * Y.least_seconds(op, [{"kind": "power", "steps": 60}]) / 0.3874e-3 < 5


def test_reach_counts_sites_within_hops():
    op = operator(RASHBA, [5, 4, 3])
    site = int(np.ravel_multi_index((1, 2, 1), op.shape))
    hops = {site: 0}
    queue = deque([site])
    while queue:  # breadth-first over nearest neighbours
        c = np.array(np.unravel_index(queue.popleft(), op.shape))
        for step in np.vstack([np.eye(3, dtype=int), -np.eye(3, dtype=int)]):
            d = c + step
            if np.all(d >= 0) and np.all(d < op.shape):
                j = int(np.ravel_multi_index(tuple(d), op.shape))
                if j not in hops:
                    hops[j] = hops[int(np.ravel_multi_index(tuple(c), op.shape))] + 1
                    queue.append(j)
    sites, nnz = op.reach(site, 8)
    for r in range(9):
        inside = [j for j, h in hops.items() if h <= r]
        assert sites[r] == len(inside)
        assert nnz[r] == op.nnz_site[inside].sum()


def test_sweep_steps_match_the_program():
    from bodge_tpu_torch.ops.cuda_spmm import sweep_launches

    for order in (2, 3, 64, 255, 256, 1024):
        assert Y.sweep_steps(order) == sweep_launches(order)


def test_unit_probes_cost_less_than_dense_ones():
    op = operator(SWAVE, [64, 64, 1])
    sites = [int(np.ravel_multi_index((30 + k, 31, 0), op.shape)) for k in range(4) for _ in range(4)]
    sparse = Y.call_cost(op, [{"kind": "moments", "order": 128, "K": 16, "sites": sites}])
    dense = Y.call_cost(op, [{"kind": "moments", "order": 128, "K": 16}])
    assert sparse[0] < dense[0] and sparse[1] <= dense[1]
