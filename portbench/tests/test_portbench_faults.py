"""The comparison that decides ``correct`` fails the control and every fault a cell
can have, and passes the program as it is: whole runs of tiny cells on the CPU,
the look for a card skipped, with the timed path broken underneath."""

import functools
import time
import types

import pytest
import torch

from portbench import calibrate, run
from bodge_tpu_torch.models import selfconsistency
from bodge_tpu_torch.ops import chebyshev
from bodge_tpu_torch.ops.cuda_spmm import StepPlan

LDOS = ("swave_1000x1000.ldos_map", "rashba_dp_64x64x4.ldos_map")
DESCENT = "swave_1000x1000.gap_descent"
SEED = 2**31 + 3


def correct(cell) -> bool:
    r, checks, failed = run.execute(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    return run.result(cell, r, checks, failed)["correct"]


def step_unchanged(monkeypatch):
    step = StepPlan.step

    def unchanged(self, data, t_cur, t_prev, scale, out=None):
        _t_next, partials = step(self, data, t_cur, t_prev, scale, out=out)
        return t_cur.clone(), partials

    monkeypatch.setattr(StepPlan, "step", unchanged)


def product_unchanged(monkeypatch):
    """The descent's sweep on the CPU runs the plain product: it returns its input."""
    monkeypatch.setattr(selfconsistency, "spmm", lambda data, sk, v, impl=None: v)


def half_batch_ldos(monkeypatch):
    moments = chebyshev.moments

    def half(data, sk, v0, order, scale, **kw):
        K = v0.shape[-1]
        mu = moments(data, sk, v0[..., :K // 2], order, scale, **kw)
        return torch.cat([mu, mu.mean(dim=1, keepdim=True).expand(-1, K - K // 2)], dim=1)

    monkeypatch.setattr(chebyshev, "moments", half)


def answer_altered_ldos(monkeypatch):
    reconstruct = chebyshev.ldos_from_moments

    def altered(*args, **kw):
        out = reconstruct(*args, **kw)
        out[0, out.shape[1] // 2] += 0.01 * abs(out).max()
        return out

    monkeypatch.setattr(chebyshev, "ldos_from_moments", altered)


def descent_unchanged(monkeypatch):
    grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad", lambda out, inputs, *a, **k: tuple(
        torch.zeros_like(g) for g in grad(out, inputs, *a, **k)))


def half_batch_descent(monkeypatch):
    make = selfconsistency.make_total_free_energy

    def half(system, V, temperature=0.0, probes=None, **kw):
        return make(system, V, temperature, probes=probes[..., :probes.shape[-1] // 2], **kw)

    monkeypatch.setattr(selfconsistency, "make_total_free_energy", half)


def answer_altered_descent(monkeypatch):
    solve = selfconsistency.solve_gap

    def altered(*args, **kw):
        delta, F = solve(*args, **kw)
        return delta, F * (1 + 1e-3)

    monkeypatch.setattr(selfconsistency, "solve_gap", altered)


FAULTS = {
    "ldos: a step returns its state unchanged": (LDOS, step_unchanged),
    "ldos: half of the probe columns left out, the mean taken over the rest": (LDOS, half_batch_ldos),
    "ldos: an answer altered where it is produced": (LDOS, answer_altered_ldos),
    "descent: a sweep step returns its state unchanged": ((DESCENT,), product_unchanged),
    "descent: a descent step returns its state unchanged": ((DESCENT,), descent_unchanged),
    "descent: half of the probes left out, the mean taken over the rest": ((DESCENT,), half_batch_descent),
    "descent: an answer altered where it is produced": ((DESCENT,), answer_altered_descent),
}


@pytest.mark.parametrize("name", LDOS + (DESCENT,))
def test_the_program_as_it_is_is_correct(small_cell, name):
    assert correct(small_cell(name))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_every_fault_is_not_correct(small_cell, monkeypatch, fault):
    cells, plant = FAULTS[fault]
    plant(monkeypatch)
    for name in cells:
        assert not correct(small_cell(name)), name


def test_the_control_is_not_correct(small_cell):
    for name in LDOS:  # the program's own bf16 operator storage in its place
        cell = small_cell(name)
        cell.driver = types.SimpleNamespace(Driver=functools.partial(cell.driver.Driver, operator_dtype="bf16"))
        assert not correct(cell), name
    cell = small_cell(DESCENT)  # the reference with a bf16 operator, in complex64
    values = calibrate.control_readings(cell, None, SEED, "cpu")
    assert any(v > cell.limits[k] for k, v in values.items()), values
