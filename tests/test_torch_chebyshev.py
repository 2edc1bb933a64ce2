"""PyTorch port, Chebyshev/KPM layer against ``bodge_tpu`` on the CPU.

Moments in complex128 against the x64 stencil scan (1e-10: the same
recursion, sums in another order) and in complex64 against the fused Pallas
sweep in interpret mode (2e-4, as tests/test_pallas.py; the moment kernel's
plain version too); the observables
(LDOS, LDOS map, DOS, free energy) and the facade methods with a shared
``scale`` at 1e-9; probes, damping kernels and coefficient fits bit-equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bodge_tpu.models import systems as jsys
from bodge_tpu.ops import chebyshev as jkpm
from bodge_tpu.ops import pallas_spmm as pk
from bodge_tpu_torch.ops import chebyshev as tkpm
from bodge_tpu_torch.ops import cuda_filter as tf
from bodge_tpu_torch.ops import cuda_spmm as tk
from bodge_tpu_torch.utils.convert import hamiltonian_from_numpy
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

SCALE = 7.5  # shared Chebyshev scale, above the norm of both test systems


def _pair(name):
    """The same system in both packages (the port's carried across as NumPy)."""
    if name == "swave":
        sj = jsys.swave_superconductor((8, 8, 1), zeeman=[0.0, 0.0, 0.1])
    else:
        sj = jsys.rashba_dp_wave((4, 4, 3))
    st = hamiltonian_from_numpy(
        sj.lattice.shape, np.asarray(sj.host_data()), sj.skeleton.cols, sj.skeleton.trans_slot,
        device="cpu",
    )
    return sj, st


@pytest.fixture(scope="module")
def swave():
    return _pair("swave")


@pytest.fixture(scope="module")
def rashba():
    return _pair("rashba")


def _probes(N, K, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, 4, K)) + 1j * rng.normal(size=(N, 4, K))


@pytest.mark.parametrize("order", [1, 2, 7, 32])
def test_moments_match_jax_stencil(swave, order):
    sj, st = swave
    v0 = _probes(64, 3, seed=order)
    want = np.asarray(jkpm.moments(sj.data, sj.skeleton, jnp.asarray(v0), order, SCALE,
                                   impl="stencil"))
    for impl in (None, "plain", "stencil", "gather"):
        got = tkpm.moments(st.data, st.skeleton, v0, order, SCALE, impl=impl)
        assert got.shape == (order, 3) and got.dtype == torch.float64
        assert np.allclose(got.numpy(), want, atol=1e-10, rtol=0), impl
    with pytest.raises(RuntimeError, match="CPU"):
        tkpm.moments(st.data, st.skeleton, v0, order, SCALE, impl="cuda")
    with pytest.raises(ValueError):
        tkpm.moments(st.data, st.skeleton, v0, order, SCALE, impl="pallas")


def test_moments_match_pallas_fused_interpret():
    sj = jsys.swave_superconductor((6, 5, 1), dtype=np.complex64)
    sk, K, order = sj.skeleton, 4, 16
    data = np.asarray(sj.host_data())
    v0 = _probes(30, K, seed=5).astype(np.complex64)
    want = np.asarray(pk.moments_pallas_fused(
        pk.pack_operator(data, sk, K), pk.pack_vector(v0, sk), sk, jnp.float32(1 / SCALE), order, K
    ))
    st = hamiltonian_from_numpy((6, 5, 1), data, sk.cols, dtype=np.complex64, device="cpu")
    got = tk.moments_fused(st.data, st.skeleton, torch.as_tensor(v0), 1 / SCALE, order)
    assert got.dtype == torch.float32 and got.shape == (order, K)
    assert np.allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max(), rtol=2e-4)
    # the moment kernel's plain version against the same sweep, to the same tolerance
    plain = tf.ell_cheb_moments_plain(st.data, st.skeleton, torch.as_tensor(v0), 1 / SCALE, order)
    assert plain.dtype == torch.float32 and plain.shape == (order, K)
    assert np.allclose(plain.numpy(), want, atol=2e-4 * np.abs(want).max(), rtol=2e-4)


def test_probes_kernels_coefficients_bit_equal():
    for seed, default in ((None, 42), (None, 1), (7, 42)):
        ours = tkpm.rademacher_probes(10, 5, seed, np.complex128, default_seed=default)
        key = None if seed is None else np.array([0, seed], dtype=np.uint32)
        theirs = jkpm.rademacher_probes(10, 5, key, np.complex128, default_seed=default)
        assert np.array_equal(ours, theirs)
    assert np.array_equal(tkpm.ldos_site_probes(9, [2, 5], np.complex64),
                          jkpm.ldos_site_probes(9, [2, 5], np.complex64))
    for order in (1, 8, 33):
        assert np.array_equal(tkpm.jackson_kernel(order), jkpm.jackson_kernel(order))
        assert np.array_equal(tkpm.lorentz_kernel(order), jkpm.lorentz_kernel(order))
        g = lambda x: -np.abs(3.0 * x) / 2
        assert np.array_equal(tkpm.chebyshev_coefficients(g, order),
                              jkpm.chebyshev_coefficients(g, order))
    assert tkpm.DEFAULT_ORDER == jkpm.DEFAULT_ORDER
    assert tkpm.LORENTZ_LAMBDA == jkpm.LORENTZ_LAMBDA
    assert tkpm.MAX_EXACT_TRACE_ORBITALS == jkpm.MAX_EXACT_TRACE_ORBITALS
    with pytest.raises(ValueError, match="samples"):
        tkpm._identity_probes(4096, np.complex64, "trace")
    mu = np.random.default_rng(0).normal(size=(8, 2))
    x = np.array([-0.5, 0.0, 0.3])
    for kernel in ("jackson", "lorentz", "none"):
        want = np.asarray(jkpm.reconstruct_density(jnp.asarray(mu), jnp.asarray(x), 3.0, kernel))
        assert np.allclose(tkpm.reconstruct_density(mu, x, 3.0, kernel), want, atol=1e-13)


ENERGIES = np.linspace(-1.5, 1.5, 7)


@pytest.mark.parametrize("system", ["swave", "rashba"])
def test_observables_match_jax(system, request):
    sj, st = request.getfixturevalue(system)
    skj, skt = sj.skeleton, st.skeleton
    N = skt.n_sites
    order = 16
    kw = dict(order=order, scale=SCALE)

    def close(got, want):
        want = np.asarray(want)
        assert np.shape(got) == want.shape
        assert np.allclose(got, want, atol=1e-9 * max(1.0, np.abs(want).max()), rtol=0)

    close(tkpm.ldos_kpm(st.data, skt, N // 2, ENERGIES, **kw),
          jkpm.ldos_kpm(sj.data, skj, N // 2, ENERGIES, impl="stencil", **kw))
    # eta picks the Lorentz kernel and the order ceil(4·scale/eta) = 16
    eta = 4 * SCALE / order
    close(tkpm.ldos_kpm(st.data, skt, 3, ENERGIES, eta=eta, scale=SCALE),
          jkpm.ldos_kpm(sj.data, skj, 3, ENERGIES, eta=eta, scale=SCALE, impl="stencil"))
    sites = [1, N // 2, N - 2] if system == "swave" else [N - 2]
    close(tkpm.ldos_kpm_sites(st.data, skt, sites, ENERGIES, kernel="lorentz", **kw),
          jkpm.ldos_kpm_sites(sj.data, skj, sites, ENERGIES, kernel="lorentz", impl="stencil", **kw))
    close(tkpm.dos_kpm(st.data, skt, ENERGIES, samples=4, **kw),
          jkpm.dos_kpm(sj.data, skj, ENERGIES, samples=4, impl="stencil", **kw))
    # Exact-trace probes (samples=None, K = 4N columns) on one system only.
    cases = [(0.0, 4), (0.05, 4)] + ([(0.0, None), (0.05, None)] if system == "swave" else [])
    for T, samples in cases:
        close(tkpm.free_energy_kpm(st.data, skt, T, samples=samples, **kw),
              jkpm.free_energy_kpm(sj.data, skj, T, samples=samples, impl="stencil", **kw))


def test_facade_methods_match_jax(swave):
    sj, st = swave
    kw = dict(order=16, scale=SCALE)
    site = (4, 3, 0)

    def close(got, want):
        assert np.allclose(got, np.asarray(want), atol=1e-9 * max(1.0, np.abs(want).max()), rtol=0)

    close(st.ldos(site, ENERGIES, method="kpm", **kw),
          sj.ldos(site, ENERGIES, method="kpm", impl="stencil", **kw))
    sites = [(0, 0, 0), site, 17]
    close(st.ldos_map(sites, ENERGIES, method="kpm", **kw),
          sj.ldos_map(sites, ENERGIES, method="kpm", impl="stencil", **kw))
    close(st.dos(ENERGIES, samples=4, **kw), sj.dos(ENERGIES, samples=4, impl="stencil", **kw))
    F = [st.free_energy(T, method="kpm", samples=4, **kw) for T in (0.0, 0.05, 0.5)]
    close(F[1], sj.free_energy(0.05, method="kpm", samples=4, impl="stencil", **kw))
    assert F[0] > F[1] > F[2]  # the free energy falls with temperature
    v = _probes(64, 2, seed=3)
    close(st.apply(v).numpy(), sj.apply(jnp.asarray(v), impl="stencil"))


@pytest.mark.parametrize("system", ["swave", "rashba"])
def test_spectral_bound(system, request):
    sj, st = request.getfixturevalue(system)
    norm = np.abs(np.linalg.eigvalsh(st.matrix("dense"))).max()
    got = tkpm.spectral_bound(st.data, st.skeleton)
    assert got >= norm  # never below the true norm
    assert got <= 1.06 * norm  # the 5 % inflation of a converged estimate
    assert got == tkpm.spectral_bound(st.data, st.skeleton, seed=0)
    assert SCALE > norm
    if system == "swave":  # another start vector than JAX's: the same bound to 3 %
        want = jkpm.spectral_bound(sj.data, sj.skeleton, impl="stencil")
        assert abs(got - want) <= 0.03 * want
        gen = torch.Generator().manual_seed(3)
        assert abs(tkpm.spectral_bound(st.data, st.skeleton, generator=gen) - want) <= 0.03 * want
        # The power kernel's plain version from the reference's own start vector:
        # its norm is the reference's bound / 1.05 to 1e-10 in complex128 (the same
        # loop, products summed in another order), and to 1e-5 in complex64 (60
        # float32 products and norms).
        v = torch.as_tensor(np.array(jax.random.normal(jax.random.PRNGKey(0), (st.skeleton.n_sites, 4, 1),
                                                         dtype=jnp.complex128)))
        norm = want / 1.05
        got128 = tf.ell_power_iteration_plain(st.data.to(torch.complex128), st.skeleton, v, 60)
        assert got128.dtype == torch.float64 and abs(float(got128) - norm) <= 1e-10 * norm
        got64 = tf.ell_power_iteration_plain(st.data.to(torch.complex64), st.skeleton, v.to(torch.complex64), 60)
        assert got64.dtype == torch.float32 and abs(float(got64) - norm) <= 1e-5 * norm
