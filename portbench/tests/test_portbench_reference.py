"""The float64 reference against the program's CPU path, on small lattices."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import loader, system
from portbench.reference import bdg, kpm

from conftest import ROOT, shrink

CELLS = {"swave": ("swave_1000x1000.ldos_map", [8, 8, 1]), "rashba": ("rashba_dp_64x64x4.ldos_map", [4, 4, 2])}


def config_of(which):
    name, shape = CELLS[which]
    config = dict(shrink(loader.cell(name, ROOT)).config)
    config["shape"] = shape
    if "feature" in config:
        config["params"] = {**config["params"], "profile": {**config["params"]["profile"], "center": 2}}
    return config


def program(config):
    return system.build({**config, "dtype": "complex128"}, "cpu")


@pytest.mark.parametrize("which", sorted(CELLS))
def test_operator_matches_program(which):
    config = config_of(which)
    ours = bdg.csr(config, "cpu").to_dense().numpy()
    theirs = program(config).matrix("dense")
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-14)


@pytest.mark.parametrize("which", sorted(CELLS))
def test_ldos_matches_program(which):
    config = config_of(which)
    n = int(np.prod(config["shape"]))
    sites = [(1, 1, 0), (2, 1, 1 if config["shape"][2] > 1 else 0)]
    energies = np.linspace(-1, 1, 9)
    theirs = program(config).ldos_map(sites, energies, method="kpm", order=96)
    A = bdg.csr(config, "cpu")
    a = kpm.spectral_bound(lambda v: torch.mm(A, v), n, "cpu")
    ours = kpm.ldos(A, n, [int(np.ravel_multi_index(s, config["shape"])) for s in sites], energies, 96, a)
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)


def test_free_energy_and_slope_match_program():
    from bodge_tpu_torch.models.selfconsistency import make_total_free_energy

    config, V, x, order = config_of("swave"), 2.5, 0.31, 64
    n = int(np.prod(config["shape"]))
    z = np.random.default_rng(5).choice([-1.0, 1.0], size=(n, 4, 3)) / np.sqrt(4 * n)
    F_total = make_total_free_energy(program(config), V, 0.0, method="kpm", order=order, impl="plain",
                                      probes=z, delta_max=2.0)
    xt = torch.tensor([x], dtype=torch.float64, requires_grad=True)
    F = F_total(xt.expand(n).to(torch.complex128))
    (g,) = torch.autograd.grad(F, xt)
    A = bdg.csr(config, "cpu", overrides={"delta": 0.0})
    a = kpm.spectral_bound(lambda v: bdg.add_onsite_singlet(torch.mm(A, v), v, 2.0), n, "cpu")
    c = kpm.chebyshev_series(lambda e: -np.abs(a * e) / 2, order) * kpm.jackson(order)
    F_ref, g_ref = kpm.free_energy_and_slope(A, bdg.add_onsite_singlet, x, torch.as_tensor(z).reshape(4 * n, -1)
                                             .to(torch.complex128), a, c, n, V)
    assert abs(float(F.detach()) - F_ref) <= 1e-10 * abs(F_ref)
    assert abs(float(g) - g_ref) <= 1e-8 * abs(g_ref)


def test_slope_is_the_derivative():
    config, V, order = config_of("swave"), 2.2, 48
    n = int(np.prod(config["shape"]))
    z = torch.as_tensor(np.random.default_rng(9).choice([-1.0, 1.0], size=(4 * n, 2)) / np.sqrt(4 * n)).to(torch.complex128)
    A = bdg.csr(config, "cpu", overrides={"delta": 0.0})
    c = kpm.chebyshev_series(lambda e: -np.abs(7.0 * e) / 2, order) * kpm.jackson(order)
    F = lambda x: kpm.free_energy_and_slope(A, bdg.add_onsite_singlet, x, z, 7.0, c, n, V)
    h = 1e-5
    numeric = (F(0.3 + h)[0] - F(0.3 - h)[0]) / (2 * h)
    assert abs(F(0.3)[1] - numeric) <= 1e-6 * abs(numeric)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.bdg as b, portbench.reference.kpm as k\n"
            "b.model('swave_superconductor'); b.model('rashba_dp_wave')\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'bodge_tpu_torch', 'bodge_tpu', 'jax'})\n"
            "print(bad); sys.exit(1 if bad else 0)") % str(ROOT)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
