"""PyTorch port, lowest-states solver (its NumPy pieces are held bit-equal to
the reference's in ``test_torch_lanczos_pieces.py``): ``lowest_eigenstates``
against dense LAPACK
and against one run of ``bodge_tpu``'s solver, the degenerate gap-edge shell,
the dense fallback, the three ``method=`` tiers of the façade, and a ring
through the gather step.  On the CPU the filter runs the plain versions of the
kernels in complex128."""

import numpy as np
import pytest

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.ops import lanczos as jlz
from bodge_tpu_torch.ops import lanczos as tlz
from tests.test_torch_gather import build_ring
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def swave_system(pkg, shape, delta=0.2, mu=0.5, m=0.0, pot=0.0, **kw):
    """Uniform s-wave BdG system; ``pot`` adds a weak incommensurate on-site
    modulation that lifts the gap-edge shell degeneracy (the system of the
    reference's own solver tests)."""
    system = pkg.Hamiltonian(pkg.CubicLattice(shape), **kw)

    def onsite(ci):
        v = (-mu + pot * np.cos(2.39996 * ci[:, 0] + 1.1 * ci[:, 1]))[:, None, None]
        return v * pkg.σ0 + m * pkg.σ3

    system.assemble(onsite=onsite, hopping=lambda ci, cj: -1.0 * pkg.σ0,
                    pairing_onsite=lambda ci: delta * pkg.jσ2)
    return system


SHAPE = (12, 12, 1)  # the smallest square lattice both packages iterate on (dim 576 > 512)


def bound_state_system(pkg, **kw):
    """12×12 open s-wave lattice (Δ = 0.3, μ = 0.5) with a local Zeeman field on
    six sites: magnetic impurities, each binding one ± pair of states inside
    the gap.  The lowest states are then isolated levels, which the iteration
    reaches at low orders — a tenth of the plain steps the gap edge's dense
    shell needs, which keeps these tests inside the suite's clock."""
    system = pkg.Hamiltonian(pkg.CubicLattice(SHAPE), **kw)
    spots = np.random.default_rng(5).integers(1, SHAPE[0] - 1, size=(6, 2))

    def onsite(ci):
        m = np.zeros(len(ci))
        for (x, y), j in zip(spots, [1.2, 1.5, 1.8, 2.2, 2.7, 3.3]):
            m[(ci[:, 0] == x) & (ci[:, 1] == y)] = j
        return -0.5 * pkg.σ0 - m[:, None, None] * pkg.σ3

    system.assemble(
        onsite=onsite, pairing_onsite=lambda ci: 0.3 * pkg.jσ2,
        hopping=lambda ci, cj: np.where((np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * pkg.σ0, 0),
    )
    return system


def lowest_reference(system, nev):
    E = np.linalg.eigvalsh(system.matrix("dense"))
    return np.sort(E[np.argsort(np.abs(E), kind="stable")[:nev]]), E


# --------------------------------------------------------------------------
# The solver.
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bound_states():
    """The bound-state lattice, nev = 8, seed 3: the port's run."""
    st = bound_state_system(T, device="cpu")
    E, X, info = tlz.lowest_eigenstates(st.data, st.skeleton, 8, full_output=True, seed=3)
    return st, E, X, info


def test_lowest_eigenstates_match_dense(bound_states):
    """Signed eigenvalues to 1e-6 against LAPACK (the reference's own gate:
    Ritz values carry the square of the block's residual)."""
    st, E, X, info = bound_states
    want, E_all = lowest_reference(st, 8)
    assert info["method"] == "chebyshev-filtered subspace iteration" and info["converged"], info
    np.testing.assert_allclose(E, want, atol=1e-6, rtol=0)
    dense = st.matrix("dense")
    assert np.linalg.norm(dense @ X - X * E[None, :], axis=0).max() < 1e-3 * np.abs(E_all).max()
    np.testing.assert_allclose(X.conj().T @ X, np.eye(8), atol=1e-10)
    # The record of the run: the keys of the reference's info, the step launches the history implies.
    assert {"iterations", "residuals", "scale", "spmm_applications", "history", "impl", "method",
            "converged"} <= set(info)
    assert info["impl"] == "plain" and info["iterations"] == len(info["history"])
    orders = [h[1] for h in info["history"]]
    assert info["spmm_applications"] == sum(orders)
    assert info["step_launches"] == sum(o - 1 for o in orders)


def test_lowest_eigenstates_match_one_reference_run(bound_states):
    """The same call in ``bodge_tpu`` (its XLA path on the CPU, complex128 like
    the port's plain path): with the scale shared, the two iterations take the
    same orders and blocks and hold the same Ritz values after two rounds to
    1e-6 — a parity of the whole round (filter, Rayleigh–Ritz, adaptation), not
    of the converged answer, which the test above holds against LAPACK.  (Two
    rounds, not a whole run: every further order costs the reference one more
    XLA compilation, and this suite has no seconds to spare.)"""
    st, _, _, info = bound_states
    sj = bound_state_system(J)
    kw = dict(full_output=True, seed=3, max_iter=2, scale=info["scale"])
    with pytest.warns(RuntimeWarning, match="not stabilized"):
        E_j, _, info_j = jlz.lowest_eigenstates(sj.host_data(), sj.skeleton, 8, **kw)
    with pytest.warns(RuntimeWarning, match="not stabilized"):
        E_t, _, info_t = tlz.lowest_eigenstates(st.data, st.skeleton, 8, **kw)
    assert [h[1] for h in info_t["history"]] == [h[1] for h in info_j["history"]]
    assert [h[4] for h in info_t["history"]] == [h[4] for h in info_j["history"]]
    np.testing.assert_allclose(E_t, np.asarray(E_j), atol=1e-6, rtol=0)
    assert set(info_j) <= set(info_t) and not info_t["converged"] and not info_j["converged"]


def test_degenerate_gap_edge_shell():
    """The clean lattice's gap edge is a degenerate ±Δ shell (48 states): |E| =
    gap and true-eigenvector residuals, whatever signs the shell's members take.
    The default block starts narrower than the shell and has to grow past it."""
    st = swave_system(T, SHAPE, device="cpu")
    _, E_all = lowest_reference(st, 8)
    gap = np.abs(E_all).min()
    assert np.sum(np.abs(np.abs(E_all) - gap) < 1e-9) == 48
    E, X, info = tlz.lowest_eigenstates(st.data, st.skeleton, 8, full_output=True, seed=3)
    assert info["converged"], info
    blocks = [h[4] for h in info["history"]]
    assert blocks[0] < 48 < blocks[-1], blocks
    np.testing.assert_allclose(np.abs(E), gap, atol=1e-6)
    dense = st.matrix("dense")
    assert np.linalg.norm(dense @ X - X * E[None, :], axis=0).max() < 1e-3 * np.abs(E_all).max()


def test_dense_fallback_and_arguments():
    st, sj = swave_system(T, (4, 4, 1), pot=0.08, device="cpu"), swave_system(J, (4, 4, 1), pot=0.08)
    E, X, info = tlz.lowest_eigenstates(st.data, st.skeleton, 4, full_output=True)
    E_j, _, info_j = jlz.lowest_eigenstates(sj.host_data(), sj.skeleton, 4, full_output=True)
    assert info["method"] == info_j["method"] == "dense-fallback" and info["iterations"] == 0
    np.testing.assert_allclose(E, np.asarray(E_j), atol=1e-12)
    np.testing.assert_allclose(E, lowest_reference(st, 4)[0], atol=1e-12)
    assert X.shape == (64, 4)
    # NumPy block data goes to the device that is asked for.
    E_np, _ = tlz.lowest_eigenstates(st.host_data(), st.skeleton, 4, device="cpu")
    np.testing.assert_array_equal(E_np, E)
    with pytest.raises(ValueError, match="nev"):
        tlz.lowest_eigenstates(st.data, st.skeleton, 0)
    big = swave_system(T, (12, 12, 1), pot=0.08, device="cpu")
    with pytest.raises(RuntimeError, match="CPU"):
        tlz.lowest_eigenstates(big.data, big.skeleton, 4, impl="cuda", scale=6.0)
    with pytest.warns(RuntimeWarning, match="not stabilized"):
        tlz.lowest_eigenstates(big.data, big.skeleton, 4, max_iter=1, scale=6.0)


@pytest.mark.parametrize("method", ["lanczos", "banded", "shift_invert"])
def test_facade_methods_match_dense(method):
    """The k lowest positive states of each tier against ``method="dense"``:
    1e-6 for the filtered iteration (its own gate), 1e-9 for the two exact
    host tiers, which are also held against the same call in ``bodge_tpu``
    (the iteration is held against the reference's in the test above)."""
    k = 3
    st = bound_state_system(T, device="cpu")
    tol = 1e-6 if method == "lanczos" else 1e-9
    kw = {} if method == "banded" else {"k": k}
    want = st.eigenvalues()[:k]
    if method != "lanczos":  # one run of the iteration is enough: diagonalize below
        np.testing.assert_allclose(st.eigenvalues(method=method, **kw)[:k], want, atol=tol, rtol=0)
    E, X = st.diagonalize(method=method, format="raw", **kw)
    np.testing.assert_allclose(E[:k], want, atol=tol, rtol=0)
    dense = st.matrix("dense")
    assert np.abs(dense @ X[:, :k] - X[:, :k] * E[:k]).max() < (1e-3 if method == "lanczos" else 1e-8)
    if method != "lanczos":
        sj = bound_state_system(J)
        np.testing.assert_allclose(E[:k], np.asarray(sj.eigenvalues(method=method, **kw))[:k], atol=tol, rtol=0)
        E, X = st.diagonalize(method=method, **kw)  # the default layout X[n, site, orbital]
        assert X.shape[1:] == (144, 4) and E.shape[0] == X.shape[0]
    if method != "banded":
        assert len(E) == k and (E > 0).all()
        with pytest.raises(ValueError, match="needs k"):
            st.eigenvalues(method=method)


def test_ring_through_the_gather_step():
    """A generic lattice: the filter runs the gather step in relabelled order
    (its plain version here) and the block comes back in the site order."""
    st = build_ring(T, 160, device="cpu")
    E, X, info = tlz.lowest_eigenstates(st.data, st.skeleton, 6, full_output=True, seed=3)
    assert info["impl"] == "plain_gather" and info["converged"], info
    want, E_all = lowest_reference(st, 6)
    np.testing.assert_allclose(E, want, atol=1e-6, rtol=0)
    dense = st.matrix("dense")
    assert np.linalg.norm(dense @ X - X * E[None, :], axis=0).max() < 1e-3 * np.abs(E_all).max()
