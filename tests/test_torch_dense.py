"""PyTorch port, dense solvers: spectrum, dense free energy and exact LDOS
against ``bodge_tpu`` on the same assembled operators (complex128 on the CPU,
tolerance 1e-9 throughout: both sides call LAPACK on the same matrix), the
version-keyed eigendecomposition cache, and the reference's physics scenarios
(``tests/test_physics.py``) restated for the port at the smallest sizes that
still show each effect."""

import numpy as np
import pytest
import torch
from numpy.random import default_rng

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.models import systems as jsys
from bodge_tpu.ops import dense as jdense
from bodge_tpu_torch.models import systems as tsys
from bodge_tpu_torch.ops import dense as tdense
from bodge_tpu_torch.utils.convert import hamiltonian_from_numpy
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


TOL = 1e-9

RECIPES = [
    ("swave_superconductor", ((6, 5, 1),), {"zeeman": [0.1, 0.0, 0.2]}),
    ("rashba_dp_wave", ((4, 4, 2),), {}),
    ("josephson_junction", (), {"L": 16, "leads": 4, "phase": 0.7}),
]


def _pair(name, args, kwargs):
    sj = getattr(jsys, name)(*args, **kwargs)
    st = getattr(tsys, name)(*args, device="cpu", **kwargs)
    assert np.array_equal(st.host_data(), np.asarray(sj.host_data()))
    return sj, st


@pytest.mark.parametrize("name,args,kwargs", RECIPES)
def test_spectrum_matches_reference(name, args, kwargs):
    sj, st = _pair(name, args, kwargs)
    Ej, _ = sj.diagonalize(format="raw")
    Et, Xt = st.diagonalize(format="raw")
    assert Et.shape == Ej.shape and Xt.shape == (st.shape[0], st.shape[0] // 2)
    np.testing.assert_allclose(Et, Ej, atol=TOL, rtol=0)
    np.testing.assert_allclose(st.eigenvalues(), sj.eigenvalues(), atol=TOL, rtol=0)
    # Eigenvectors are fixed only up to rotations inside degenerate levels:
    # hold them to the eigen-equation instead of to the reference's columns.
    H = st.matrix("dense")
    assert np.abs(H @ Xt - Xt * Et[None, :]).max() < TOL
    assert np.abs(Xt.conj().T @ Xt - np.eye(Xt.shape[1])).max() < TOL
    E2, X2 = st.diagonalize()
    assert X2.shape == (Et.size, st.lattice.size, 4)
    assert np.array_equal(X2, Xt.T.reshape(Et.size, -1, 4))


@pytest.mark.parametrize("name,args,kwargs", RECIPES)
def test_dense_free_energy_matches_reference(name, args, kwargs):
    sj, st = _pair(name, args, kwargs)
    for temperature in (0.0, 0.01, 0.3):
        want = sj.free_energy(temperature)
        got = st.free_energy(temperature, method="dense")
        assert isinstance(got, float)
        assert abs(got - want) <= TOL * max(1.0, abs(want))


@pytest.mark.parametrize("name,args,kwargs", RECIPES[:2])
def test_exact_ldos_matches_reference(name, args, kwargs):
    sj, st = _pair(name, args, kwargs)
    energies = [-0.9, -0.3, 0.0, 0.05, 0.3, 0.9, 0.3]  # repeated and signed on purpose
    site = tuple(s // 2 for s in st.lattice.shape)
    np.testing.assert_allclose(st.ldos(site, energies), sj.ldos(site, energies), atol=TOL, rtol=0)
    sites = [(0, 0, 0), site, (1, 2, 0)]
    got = st.ldos_map(sites, energies)
    assert got.shape == (3, len(energies))
    np.testing.assert_allclose(got, sj.ldos_map(sites, energies), atol=TOL, rtol=0)
    with pytest.raises(TypeError, match="unexpected KPM keywords"):
        st.ldos(site, energies, eta=0.1)


def test_dense_ops_functions_match_reference():
    sj, st = _pair(*RECIPES[0])
    Hj, Ht = sj.matrix("dense"), st.matrix("dense_torch")
    Ej, Xj = jdense.eigh_positive(Hj)
    Et, Xt = tdense.eigh_positive(Ht)
    assert Et.dtype == torch.float64 and Xt.dtype == torch.complex128
    np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), atol=TOL, rtol=0)
    assert tuple(Xt.shape) == np.asarray(Xj).shape
    for temperature in (0.0, 0.2):
        want = float(jdense.free_energy_from_spectrum(Ej, temperature))
        assert abs(float(tdense.free_energy_from_spectrum(Et, temperature)) - want) < TOL * abs(want)
    with pytest.raises(ValueError, match="non-negative temperature"):
        tdense.free_energy_from_spectrum(Et, -0.1)
    energies = np.linspace(-1.0, 1.0, 9)
    np.testing.assert_allclose(
        tdense.ldos_exact(Ht, 7, energies), jdense.ldos_exact(Hj, 7, energies), atol=TOL, rtol=0
    )


def test_eigh_cache_follows_the_assembled_state():
    pairs = []
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        lattice = pkg.CubicLattice((5, 4, 1))
        system = pkg.Hamiltonian(lattice, **kw)
        with system as (H, Δ):
            for i in lattice.sites():
                H[i, i] = -0.5 * pkg.σ0
            for i, j in lattice.bonds():
                H[i, j] = -1.0 * pkg.σ0
        pairs.append((pkg, lattice, system))
    (_, _, sj), (_, lattice, st) = pairs

    E0 = st.eigenvalues()
    version, cached, vectors = st._eigh_cache
    assert vectors is None  # eigenvalues alone do not pay for eigenvectors
    assert st.free_energy(0.1) == st.free_energy(0.1) and st._eigh_cache[1] is cached
    st.diagonalize()
    assert st._eigh_cache[2] is not None
    X_cached = st._eigh_cache[2]
    st.ldos((2, 2, 0), [0.0, 0.1])
    st.ldos_map([(0, 0, 0)], [0.1, 0.2])
    assert st._eigh_cache[2] is X_cached  # one decomposition serves them all

    for pkg, lattice, system in pairs:  # re-assembly through the DSL invalidates it
        with system as (H, Δ):
            for i in lattice.sites():
                Δ[i, i] = 0.4 * pkg.jσ2
    E1 = st.eigenvalues()
    assert st._version > version and E1.min() > E0.min() + 0.1
    np.testing.assert_allclose(E1, sj.eigenvalues(), atol=TOL, rtol=0)

    st.assemble(onsite=lambda ci: -1.5 * T.σ0)  # so does the vectorized path
    sj.assemble(onsite=lambda ci: -1.5 * J.σ0)
    np.testing.assert_allclose(st.eigenvalues(), sj.eigenvalues(), atol=TOL, rtol=0)
    np.testing.assert_allclose(st.free_energy(0.2), sj.free_energy(0.2), atol=TOL, rtol=0)

    moved = hamiltonian_from_numpy(lattice, st.host_data(), device="cpu")
    np.testing.assert_allclose(moved.eigenvalues(), st.eigenvalues(), atol=TOL, rtol=0)


def test_dense_solver_argument_errors_match_reference():
    _, st = _pair(*RECIPES[0])
    sj = _pair(*RECIPES[0])[0]
    for system in (sj, st):
        with pytest.raises(RuntimeError):
            system.diagonalize(format="blah")
        with pytest.raises(RuntimeError):
            system.diagonalize(method="blah")
        with pytest.raises(RuntimeError):
            system.eigenvalues(method="blah")
        with pytest.raises(TypeError):
            system.diagonalize(tol=1e-3)
        with pytest.raises(TypeError):
            system.eigenvalues(k=3)
        with pytest.raises(ValueError):
            system.diagonalize(method="lanczos")
        with pytest.raises(RuntimeError):
            system.ldos((0, 0, 0), [0.0], method="blah")
    with pytest.raises(RuntimeError, match="device="):
        st.diagonalize(cuda=True)


# --------------------------------------------------------------------------
# The physics scenarios of tests/test_physics.py, on the port.
# --------------------------------------------------------------------------
def _chain(L, device="cpu"):
    lattice = T.CubicLattice((L, 1, 1))
    return lattice, T.Hamiltonian(lattice, device=device)


def test_superconducting_gap_opens():
    """Adding Δ must deplete the LDOS inside the gap and push ε_min up."""
    lattice = T.CubicLattice((12, 12, 1))
    system = T.Hamiltonian(lattice, device="cpu")
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -1.5 * T.σ0
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * T.σ0
    Δs = 0.5
    probe = (6, 6, 0)
    ω = np.array([-1.2 * Δs, -0.8 * Δs, +0.8 * Δs, 1.2 * Δs])
    ρ_normal = system.ldos(probe, ω)
    ε_normal = np.min(system.diagonalize()[0])
    with system as (H, Δ):
        for i in lattice.sites():
            Δ[i, i] = Δs * T.jσ2
    ρ_sc = system.ldos(probe, ω)
    ε_sc = np.min(system.diagonalize()[0])
    assert ρ_sc[1] < ρ_normal[1] and ρ_sc[2] < ρ_normal[2]
    assert ρ_sc[0] > ρ_normal[0] and ρ_sc[3] > ρ_normal[3]
    assert ε_sc > ε_normal


def test_gap_scales_with_order_parameter():
    lattice, system = _chain(16)
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -1.5 * T.σ0
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * T.σ0
    gaps = []
    for Δ0 in [0.0, 0.01, 0.03, 0.1, 0.3, 1.0]:
        with system as (H, Δ):
            for i in lattice.sites():
                Δ[i, i] = Δ0 * T.jσ2
        gaps.append(np.min(system.diagonalize()[0]))
    assert all(a < b for a, b in zip(gaps[:-1], gaps[1:]))


def test_magnetic_field_isotropy():
    """Free energy and LDOS depend on |M| but not on its direction."""
    rng = default_rng(42)
    lattice, system = _chain(32)
    probe, energies = (16, 0, 0), [0.0, 0.01]
    Δ0, M0, temperature = 0.1, 0.05, 0.01
    with system as (H, Δ):
        for i in lattice.sites():
            Δ[i, i] = -Δ0 * T.jσ2
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * T.σ0
    F0 = system.free_energy(temperature)
    ρ0 = system.ldos(probe, energies)[0]
    Fs, ρs = [], []
    for _ in range(4):
        θ, φ = 2 * T.π * rng.random(), 2 * T.π * rng.random()
        direction = np.cos(θ) * T.σ1 + np.sin(θ) * np.cos(φ) * T.σ2 + np.sin(θ) * np.sin(φ) * T.σ3
        with system as (H, Δ):
            for i in lattice.sites():
                H[i, i] = -M0 * direction
        Fs.append(system.free_energy(temperature))
        ρs.append(system.ldos(probe, energies)[0])
    assert all(not np.allclose(F0, F, rtol=1e-10) for F in Fs)
    assert all(not np.allclose(ρ0, ρ, rtol=1e-10) for ρ in ρs)
    assert all(np.allclose(F1, F2, rtol=1e-10) for F1, F2 in zip(Fs[:-1], Fs[1:]))
    assert all(np.allclose(ρ1, ρ2, rtol=1e-10) for ρ1, ρ2 in zip(ρs[:-1], ρs[1:]))


def test_superconducting_spin_valve():
    """F(antiparallel) < F(parallel) for an F/S/F junction."""
    L, lead = 48, 12
    lattice, system = _chain(L)
    Δ0, M0, temperature = 0.3, 0.7, 0.001
    with system as (H, Δ):
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * T.σ0
        for i in lattice.sites():
            if i[0] < lead or i[0] >= L - lead:
                H[i, i] = -M0 * T.σ3
            else:
                Δ[i, i] = -Δ0 * T.jσ2
    F_parallel = system.free_energy(temperature)
    with system as (H, Δ):
        for i in lattice.sites():
            if i[0] >= L - lead:
                H[i, i] = +M0 * T.σ3
    F_antiparallel = system.free_energy(temperature)
    assert F_antiparallel < F_parallel


def test_odd_frequency_zero_energy_peak():
    """A magnet converts singlets to odd-ω triplets → zero-energy peak."""
    lattice, system = _chain(48)
    Δ0, M0 = 0.3, 0.15
    probe, energies = (23, 0, 0), [0.0, 0.05 * 0.3]
    with system as (H, Δ):
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * T.σ0
        for i in lattice.sites():
            Δ[i, i] = -Δ0 * T.jσ2
    Z_clean = system.ldos(probe, energies)[0]
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -M0 * T.σ2
    Z_magnet = system.ldos(probe, energies)[0]
    assert Z_clean >= 0
    assert Z_magnet >= Z_clean


def test_free_energy_decreases_with_temperature():
    lattice = T.CubicLattice((6, 6, 1))
    system = T.Hamiltonian(lattice, device="cpu")
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -2.0 * T.σ0
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * T.σ0
    Fs = [system.free_energy(temperature) for temperature in [0.01, 0.1, 0.5, 1.0]]
    assert all(a > b for a, b in zip(Fs[:-1], Fs[1:]))


def test_pwave_edge_states():
    """pₓ-wave: the gap closes at x-normal edges, not elsewhere."""
    Lx, Ly = 31, 9  # the centre still outweighs the x edge on shorter strips (25 sites)
    lattice = T.CubicLattice((Lx, Ly, 1))
    system = T.Hamiltonian(lattice, device="cpu")
    Δ0 = 0.1
    σp = T.pwave("e_z * p_x")
    with system as (H, Δ):
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * T.σ0
            Δ[i, j] = -Δ0 * σp(i, j)
    energies = [0.0, Δ0 / 4]
    mx, my = Lx // 2, Ly // 2
    ρ_center, ρ_yedge, ρ_xedge, ρ_corner = system.ldos_map(
        [(mx, my, 0), (mx, 0, 0), (0, my, 0), (0, 0, 0)], energies
    )[:, 0]
    assert ρ_xedge > ρ_center and ρ_xedge > ρ_yedge
    assert ρ_corner > ρ_center and ρ_corner > ρ_yedge


def test_josephson_minigap_phase_dependence():
    """S/N/S minigap closes at φ = π and is symmetric under φ → 2π − φ."""
    L, lead = 32, 8
    lattice = T.CubicLattice((L, 1, 1))
    Δ0 = 3.0

    def minigap(φ):
        system = T.Hamiltonian(lattice, device="cpu")
        with system as (H, Δ):
            for i in lattice.sites():
                if i[0] < lead:
                    Δ[i, i] = -Δ0 * T.jσ2 * np.exp(-1j * φ / 2)
                elif i[0] >= L - lead:
                    Δ[i, i] = -Δ0 * T.jσ2 * np.exp(+1j * φ / 2)
            for i, j in lattice.bonds():
                H[i, j] = -1.0 * T.σ0
        return np.min(system.diagonalize()[0])

    gaps = [minigap(f * T.π) for f in (0.0, 0.5, 1.0, 1.5, 2.0)]
    assert gaps[0] > gaps[1] > gaps[2]
    assert np.allclose(gaps[0], gaps[4])
    assert np.allclose(gaps[1], gaps[3])
