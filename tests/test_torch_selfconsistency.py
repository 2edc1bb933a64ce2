"""PyTorch port, self-consistency: the pairing-field inserts bit-equal to
``bodge_tpu``, ``F_total(Δ)`` and its gradient with respect to a real field
for the s-, d- and p-wave channels (dense at 1e-9, KPM with shared probes and
scale at 1e-8), ``solve_gap`` against the reference after the same steps, and
the error probes.  Everything runs on the CPU in complex128; the reference
runs its XLA stencil objective (never its Pallas objectives)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.models import selfconsistency as jsc
from bodge_tpu.ops import chebyshev as jkpm
from bodge_tpu_torch.models import selfconsistency as tsc
from bodge_tpu_torch.utils.convert import tensor_from_numpy
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


CHANNELS = [None, "dwave", ("pwave", "e_z * p_x")]
SHAPE = (8, 6, 1)


def normal_metal(pkg, shape, mu=0.0, t=1.0, **kw):
    system = pkg.Hamiltonian(pkg.CubicLattice(shape), **kw)
    system.assemble(
        onsite=lambda ci: -mu * pkg.σ0,
        hopping=lambda ci, cj: np.where(
            (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -t * pkg.σ0, 0
        ),
        check=False,
    )
    return system


def _both(shape=SHAPE, **kw):
    sj, st = normal_metal(J, shape, **kw), normal_metal(T, shape, device="cpu", **kw)
    assert np.array_equal(st.host_data(), np.asarray(sj.host_data()))
    return sj, st


def _field(N, seed=3):
    return 0.3 + 0.1 * np.random.default_rng(seed).normal(size=N)


def _reference_probes_and_scale(sj, pairing, samples, delta_max=2.0):
    """The probes ``make_total_free_energy`` of the reference draws from its
    default key, and the spectral bound its power iteration finds."""
    sk = sj.skeleton
    N = sk.n_sites
    z = jax.random.rademacher(jax.random.PRNGKey(11), (N, 4, samples), dtype=jnp.float64)
    z = np.asarray(z) / np.sqrt(4 * N)
    base = jnp.asarray(sj.data)
    probe = jnp.full((N,), delta_max, dtype=base.dtype)
    struct = jsc._resolve_pairing(pairing, sk)
    data = (jsc.data_with_onsite_swave(base, probe) if struct is None
            else jsc.data_with_bond_singlet(base, probe, sk, struct))
    return z, float(jkpm.spectral_bound(data, sk, impl="stencil"))


def test_field_inserts_bit_equal():
    sj, st = _both((5, 4, 2), mu=0.4)
    skj, skt = sj.skeleton, st.skeleton
    N = skt.n_sites
    rng = np.random.default_rng(0)
    delta = rng.normal(size=N) + 1j * rng.normal(size=N)
    base_j, base_t = jnp.asarray(sj.data), st.data

    got = tsc.data_with_onsite_swave(base_t, tensor_from_numpy(delta, device="cpu"))
    assert np.array_equal(got.numpy(), np.asarray(jsc.data_with_onsite_swave(base_j, jnp.asarray(delta))))
    assert np.array_equal(base_t.numpy(), np.asarray(sj.host_data()))  # the base is not written

    structs = {
        "dwave": (tsc.bond_structure_dwave(skt), jsc.bond_structure_dwave(skj)),
        "pwave": (tsc.bond_structure_pwave(skt, "e_z * p_x"), jsc.bond_structure_pwave(skj, "e_z * p_x")),
        "pwave_xy": (tsc.bond_structure_pwave(skt, "(e_x + je_y) * (p_x + jp_y)"),
                     jsc.bond_structure_pwave(skj, "(e_x + je_y) * (p_x + jp_y)")),
    }
    for name, (ours, theirs) in structs.items():
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), name
        assert np.array_equal(tsc._bond_weights(ours), jsc._bond_weights(theirs))
        for field in (delta, delta.real):
            m_t = tsc.bond_field(field, skt, ours)
            m_j = jsc.bond_field(field, skj, theirs)
            assert np.array_equal(m_t.numpy(), np.asarray(m_j)), name
            d_t = tsc.data_with_bond_singlet(base_t, tensor_from_numpy(field, device="cpu"), skt, ours)
            d_j = jsc.data_with_bond_singlet(base_j, jnp.asarray(field), skj, theirs)
            assert np.array_equal(d_t.numpy(), np.asarray(d_j)), name
            pen_t = float(tsc._bond_penalty(m_t, ours, 1.7))
            assert abs(pen_t - float(jsc._bond_penalty(m_j, theirs, 1.7))) <= 1e-12 * abs(pen_t)
    assert np.array_equal(tsc.bond_field(delta, skt).numpy(), np.asarray(jsc.bond_field(delta, skj)))
    assert np.array_equal(tsc._bond_mask(skt), jsc._bond_mask(skj))
    # The inserted operator is Hermitian (open boundaries: wrap links stay empty).
    from bodge_tpu_torch.ops.blocksparse import hermiticity_error

    assert float(hermiticity_error(d_t, skt)) < 1e-14


@pytest.mark.parametrize("method", ["dense", "kpm"])
@pytest.mark.parametrize("pairing", CHANNELS, ids=["swave", "dwave", "pwave"])
def test_total_free_energy_and_gradient_match_reference(pairing, method):
    """Value and gradient with respect to a REAL field.  Dense: 1e-9 (LAPACK
    on the same matrix).  KPM: 1e-8 with the reference's own probes and
    scale handed over (order 64, 8 samples, complex128 on both sides)."""
    sj, st = _both(mu=-0.4)
    N = st.skeleton.n_sites
    x0 = _field(N)
    kw = dict(V=1.5, temperature=0.1, method=method, pairing=pairing)
    if method == "kpm":
        z, scale = _reference_probes_and_scale(sj, pairing, samples=8)
        F_j = jsc.make_total_free_energy(sj, order=64, samples=8, impl="stencil", **kw)
        F_t = tsc.make_total_free_energy(st, order=64, samples=8, probes=z, scale=scale, **kw)
        tol = 1e-8
    else:
        F_j = jsc.make_total_free_energy(sj, **kw)
        F_t = tsc.make_total_free_energy(st, **kw)
        tol = 1e-9
    v_j, g_j = jax.value_and_grad(lambda x: F_j(x.astype(jnp.complex128)))(jnp.asarray(x0))
    x = tensor_from_numpy(x0, device="cpu", requires_grad=True)
    v_t = F_t(x.to(torch.complex128))
    (g_t,) = torch.autograd.grad(v_t, x)
    assert v_t.dtype == torch.float64 and g_t.dtype == torch.float64
    assert abs(float(v_t.detach()) - float(v_j)) <= tol * abs(float(v_j))
    assert np.abs(g_t.numpy() - np.asarray(g_j)).max() <= tol * max(1.0, np.abs(np.asarray(g_j)).max())
    assert np.abs(np.asarray(g_j)).max() > 1e-3  # a gradient worth comparing


def test_custom_structure_and_complex_field_match_reference():
    sj, st = _both(mu=-0.4)
    skt = st.skeleton
    N = skt.n_sites
    struct = 0.5 * tsc.bond_structure_dwave(skt)
    struct[3] = 0.3 * np.asarray(T.jσ2)  # an s-like admixture on the +y bonds …
    struct[4] = 0.3 * np.asarray(T.jσ2)  # … and on their −y partners
    F_j = jsc.make_total_free_energy(sj, V=2.0, temperature=0.0, pairing=jnp.asarray(struct))
    F_t = tsc.make_total_free_energy(st, V=2.0, temperature=0.0, pairing=struct)
    rng = np.random.default_rng(5)
    field = 0.3 * rng.normal(size=N)  # bond fields are real: the partner block is not conjugated
    want = float(F_j(jnp.asarray(field, dtype=jnp.complex128)))
    got = float(F_t(tensor_from_numpy(field, device="cpu", dtype=np.complex128)))
    assert abs(got - want) <= 1e-9 * abs(want)

    # A complex on-site field: PyTorch's gradient is the conjugate of JAX's.
    F_j = jsc.make_total_free_energy(sj, V=2.0, temperature=0.05)
    F_t = tsc.make_total_free_energy(st, V=2.0, temperature=0.05)
    delta = 0.3 * (rng.normal(size=N) + 1j * rng.normal(size=N))
    v_j, g_j = jax.value_and_grad(F_j)(jnp.asarray(delta))
    d = tensor_from_numpy(delta, device="cpu", requires_grad=True)
    v_t = F_t(d)
    (g_t,) = torch.autograd.grad(v_t, d)
    assert abs(float(v_t.detach()) - float(v_j)) <= 1e-9 * abs(float(v_j))
    assert np.abs(g_t.numpy() - np.conj(np.asarray(g_j))).max() <= 1e-9 * np.abs(np.asarray(g_j)).max()


@pytest.mark.parametrize("pairing", CHANNELS, ids=["swave", "dwave", "pwave"])
def test_kernel_path_formulation_equals_three_term_recursion(pairing):
    """The objective the card runs (doubled moments through ``ChebStep``, here
    with the plain versions) against the three-term recursion of the CPU
    path: same value and gradient to rounding (1e-9)."""
    _, st = _both(mu=-0.4)
    sk = st.skeleton
    N = sk.n_sites
    struct = tsc._resolve_pairing(pairing, sk)
    rng = np.random.default_rng(6)
    z = tensor_from_numpy((2.0 * rng.integers(0, 2, size=(N, 4, 4)) - 1.0) / np.sqrt(4 * N),
                          device="cpu", dtype=np.complex128)
    coeffs = torch.as_tensor(rng.normal(size=33))  # an odd order as well
    x0 = _field(N, seed=7)
    out = []
    for objective in ("kernel", "three_term"):
        x = tensor_from_numpy(x0, device="cpu", requires_grad=True)
        data = (tsc.data_with_onsite_swave(st.data, x) if struct is None
                else tsc.data_with_bond_singlet(st.data, x, sk, struct))
        if objective == "kernel":
            F = tsc._free_energy_kpm_cuda(data, sk, z, coeffs, 1.0 / 7.0, impl="plain")
        else:
            F = tsc._free_energy_kpm(data, sk, z, coeffs, 1.0 / 7.0, "plain")
        out.append((float(F.detach()), torch.autograd.grad(F, x)[0].numpy()))
    (f_a, g_a), (f_b, g_b) = out
    assert abs(f_a - f_b) <= 1e-9 * abs(f_b)
    assert np.abs(g_a - g_b).max() <= 1e-9 * np.abs(g_b).max()


def test_solve_gap_dense_matches_reference():
    """Same steps, same rate, same start: the two momentum loops land on the
    same gap to 1e-6 (rounding differences between two
    LAPACK calls do not grow over 60 steps)."""
    sj, st = _both((24, 1, 1), mu=0.9)
    kw = dict(V=2.5, temperature=0.05, delta0=0.2, steps=60, learning_rate=0.05)
    d_j, F_j = jsc.solve_gap(sj, **kw)
    d_t, F_t = tsc.solve_gap(st, **kw)
    assert d_t.shape == (24,) and d_t.dtype == np.complex128 and isinstance(F_t, float)
    assert np.abs(d_t - np.asarray(d_j)).max() <= 1e-6
    assert abs(F_t - F_j) <= 1e-6 * abs(F_j)
    assert d_t.real.min() > 0.05 and np.abs(d_t.imag).max() == 0.0


def test_solve_gap_kpm_uniform_matches_reference():
    sj, st = _both(mu=0.3)
    z, scale = _reference_probes_and_scale(sj, None, samples=8)
    kw = dict(V=2.5, temperature=0.0, delta0=0.3, steps=8, learning_rate=0.08 / 48,
              method="kpm", uniform=True, order=48, samples=8)
    d_j, F_j = jsc.solve_gap(sj, impl="stencil", **kw)
    d_t, F_t = tsc.solve_gap(st, probes=z, scale=scale, **kw)
    assert d_t.shape == (48,) and np.all(d_t == d_t[0])
    assert abs(d_t[0] - np.asarray(d_j)[0]) <= 1e-8
    assert abs(F_t - F_j) <= 1e-8 * abs(F_j)
    assert abs(d_t[0].real - 0.3) > 1e-3  # the field moved


def test_solve_gap_finds_and_loses_the_gap():
    """The README's drive: a gap at V = 2.5, none at V = 0.2 (μ = 0.9)."""
    st = normal_metal(T, (24, 1, 1), mu=0.9, device="cpu")
    strong, _ = tsc.solve_gap(st, V=2.5, temperature=0.05, uniform=True, delta0=0.2, steps=120)
    weak, _ = tsc.solve_gap(st, V=0.2, temperature=0.05, uniform=True, delta0=0.2, steps=120,
                            learning_rate=0.01)
    assert strong[0].real > 0.2
    assert abs(weak[0]) < 0.02


def test_pairing_and_option_errors_match_reference():
    sj, st = _both((4, 3, 1))
    with pytest.raises(ValueError, match=r"must have shape \(5, 2, 2\), got \(2, 2, 2\)"):
        tsc._resolve_pairing(np.zeros((2, 2, 2)), st.skeleton)
    for bad in ("pwave", "fwave", jnp.zeros((2, 2, 2))):
        with pytest.raises(ValueError) as e_j:
            jsc._resolve_pairing(bad, sj.skeleton)
        with pytest.raises(ValueError) as e_t:
            tsc._resolve_pairing(bad if isinstance(bad, str) else np.asarray(bad), st.skeleton)
        assert str(e_t.value) == str(e_j.value)
    for pairing in (None, "swave", "onsite_swave"):
        assert tsc._resolve_pairing(pairing, st.skeleton) is None
    for kwargs in ({"mesh": object()}, {"overlap": True}):
        with pytest.raises(ValueError) as e_j:
            jsc.make_total_free_energy(sj, V=1.0, **kwargs)
        with pytest.raises(ValueError) as e_t:
            tsc.make_total_free_energy(st, V=1.0, **kwargs)
        # The port's message names its own sharded implementations.
        assert str(e_j.value) == "mesh= and overlap= apply only to method='kpm', impl='pallas_sharded'"
        assert str(e_t.value) == "mesh= and overlap= apply only to method='kpm', impl='cuda_sharded' or 'plain_sharded'"
    with pytest.raises(ValueError, match="Unknown method"):
        tsc.make_total_free_energy(st, V=1.0, method="lanczos")
    with pytest.raises(ValueError, match="Unknown kernel implementation 'pallas_sharded'"):
        tsc.make_total_free_energy(st, V=1.0, method="kpm", impl="pallas_sharded")
    with pytest.raises(ValueError, match="apply only to method='kpm', impl='cuda_sharded'"):
        tsc.solve_gap(st, V=1.0, method="kpm", impl="pallas_sharded", mesh=object())
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsc.make_total_free_energy(st, V=1.0, method="kpm", impl="cuda")
    with pytest.raises(ValueError, match="Unknown kernel implementation"):
        tsc.make_total_free_energy(st, V=1.0, method="kpm", impl="pallas")
    with pytest.raises(ValueError, match="probes must have shape"):
        tsc.make_total_free_energy(st, V=1.0, method="kpm", probes=np.zeros((3, 4, 2)), scale=5.0)
    generic = T.Hamiltonian(_Ring(), device="cpu")
    with pytest.raises(ValueError, match="cubic stencil"):
        tsc.make_total_free_energy(generic, V=1.0, pairing="dwave")


class _Ring(T.Lattice):
    """Four sites on a ring: a generic (non-stencil) skeleton."""

    def __init__(self):
        super().__init__((4, 1, 1))

    def index(self, coord):
        return int(coord[0])

    def sites(self):
        for i in range(4):
            yield (i, 0, 0)

    def bonds(self, axis=None):
        for i in range(4):
            yield (i, 0, 0), ((i + 1) % 4, 0, 0)

    def edges(self, axis=None):
        return iter(())


def test_default_probes_are_seeded_and_normalised():
    st = normal_metal(T, (4, 3, 1), device="cpu")
    N = 12
    x = tensor_from_numpy(np.full(N, 0.2), device="cpu", dtype=np.complex128)
    kw = dict(V=2.0, method="kpm", order=16, samples=4, scale=7.0)
    F_a = float(tsc.make_total_free_energy(st, **kw)(x))
    assert F_a == float(tsc.make_total_free_energy(st, seed=11, **kw)(x))  # default seed 11
    assert F_a != float(tsc.make_total_free_energy(st, seed=12, **kw)(x))
    dense = float(tsc.make_total_free_energy(st, V=2.0)(x))
    exact = np.eye(4 * N).reshape(N, 4, 4 * N) / np.sqrt(4 * N) * np.sqrt(4 * N)
    # Identity probes (unit columns) make the trace exact: KPM → dense as the order grows.
    F_id = float(tsc.make_total_free_energy(st, V=2.0, method="kpm", order=400, probes=exact, scale=7.0)(x))
    assert abs(F_id - dense) < 2e-2 * abs(dense)
