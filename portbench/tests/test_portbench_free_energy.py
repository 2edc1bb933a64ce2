"""The free-energy cell's comparison passes the program and fails the control and
the planted faults: whole runs of the tiny box cell on the CPU."""

import functools
import time
import types

import numpy as np
import pytest
import torch

from portbench import calibrate_storage, run
from bodge_tpu_torch.ops import chebyshev
from bodge_tpu_torch.ops.cuda_spmm import StepPlan

CELL = "swave_1000x1000.free_energy"
SEED = 2**31 + 11


def correct(cell) -> bool:
    r, checks, failed = run.execute(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    return run.result(cell, r, checks, failed)["correct"]


def altered(monkeypatch):
    free_energy = chebyshev.free_energy_kpm
    monkeypatch.setattr(chebyshev, "free_energy_kpm", lambda *a, **k: free_energy(*a, **k) * (1 + 1e-3))


def half_the_probes(monkeypatch):
    moments = chebyshev.moments

    def half(data, sk, v0, order, scale, **kw):
        K = v0.shape[-1]
        mu = moments(data, sk, v0[..., :K // 2], order, scale, **kw)
        return torch.cat([mu, mu.mean(dim=1, keepdim=True).expand(-1, K - K // 2)], dim=1)

    monkeypatch.setattr(chebyshev, "moments", half)


def step_unchanged(monkeypatch):
    step = StepPlan.step

    def unchanged(self, data, t_cur, t_prev, scale, out=None, sums=True):
        _t_next, partials = step(self, data, t_cur, t_prev, scale, out=out, sums=sums)
        return t_cur.clone(), partials

    monkeypatch.setattr(StepPlan, "step", unchanged)


FAULTS = {"an F altered where it is produced": altered,
          "half of the probe columns left out, the mean taken over the rest": half_the_probes,
          "a step returns its state unchanged": step_unchanged}


def test_the_program_as_it_is_is_correct(small_cell):
    assert correct(small_cell(CELL))


def test_the_probes_are_the_programs(small_cell):
    n, samples, seed = 40, 3, 2**40 + 7
    got = chebyshev.rademacher_probes(n, samples, seed, np.complex64)
    assert np.array_equal(got, small_cell(CELL).driver.probes(n, samples, seed).astype(np.complex64))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_every_fault_is_not_correct(small_cell, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    assert not correct(small_cell(CELL))


def test_the_control_is_not_correct(small_cell):
    cell = small_cell(CELL)
    values = calibrate_storage.control_readings(cell, run_system(cell), SEED, "cpu")
    assert values["F_gap"] > cell.limits["F_gap"], values
    cell.driver = types.SimpleNamespace(Driver=functools.partial(cell.driver.Driver, operator_dtype="bf16"))
    assert not correct(cell)


def run_system(cell):
    from portbench.harness import system

    return system.build(cell.config, "cpu")
