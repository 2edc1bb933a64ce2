"""PyTorch port, banded host solver: the RCM relabelling (rank and block
bandwidth) identical to ``bodge_tpu``'s, and the banded eigensolver against
the reference's on the same block data.  Both sides are NumPy / SciPy on the
host, so the tolerance is LAPACK round-off (1e-10)."""

import numpy as np
import pytest

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.ops import banded as jbanded
from bodge_tpu_torch.ops import banded as tbanded
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def ring_lattice(pkg, n):
    class RingLattice(pkg.Lattice):
        """1D ring of n sites with the closing link expressed through ``edges``."""

        def __init__(self, n):
            super().__init__((n, 1, 1))

        def index(self, coord):
            x = coord[0]
            if not (0 <= x < self.shape[0]) or coord[1] or coord[2]:
                raise ValueError(f"Coordinate {coord} out of bounds")
            return x

        def sites(self):
            for x in range(self.shape[0]):
                yield (x, 0, 0)

        def bonds(self):
            for x in range(self.shape[0] - 1):
                yield (x, 0, 0), (x + 1, 0, 0)
                yield (x + 1, 0, 0), (x, 0, 0)

        def edges(self):
            n = self.shape[0]
            yield (0, 0, 0), (n - 1, 0, 0)
            yield (n - 1, 0, 0), (0, 0, 0)

    return RingLattice(n)


def build(pkg, case, **kw):
    """Open or periodic 8×6 s-wave lattice with a Zeeman term, or a ring of 30."""
    if case == "ring":
        system = pkg.Hamiltonian(ring_lattice(pkg, 30), **kw)
        hopping = lambda ci, cj: -1.0 * pkg.σ0
    else:
        system = pkg.Hamiltonian(pkg.CubicLattice((8, 6, 1)), **kw)
        open_bond = lambda ci, cj: (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]
        hopping = (lambda ci, cj: -1.0 * pkg.σ0) if case == "periodic" else (
            lambda ci, cj: np.where(open_bond(ci, cj), -1.0 * pkg.σ0, 0))
    system.assemble(
        onsite=lambda ci: -0.4 * pkg.σ0 - 0.1 * pkg.σ3 + 0.01 * ci[:, 0, None, None] * pkg.σ0,
        pairing_onsite=lambda ci: 0.3 * pkg.jσ2,
        hopping=hopping,
    )
    return system


CASES = ["open", "periodic", "ring"]


@pytest.mark.parametrize("case", CASES)
def test_block_permutation_identical(case):
    st, sj = build(T, case, device="cpu"), build(J, case)
    assert np.array_equal(st.host_data(), np.asarray(sj.host_data()))
    for masked in (False, True):
        mt = tbanded.nonzero_block_mask(st.host_data(), st.skeleton) if masked else None
        mj = jbanded.nonzero_block_mask(np.asarray(sj.host_data()), sj.skeleton) if masked else None
        if masked:
            assert np.array_equal(mt, mj)
        rank_t, bwb_t = tbanded.block_permutation(st.skeleton, mt)
        rank_j, bwb_j = jbanded.block_permutation(sj.skeleton, mj)
        assert bwb_t == bwb_j
        assert np.array_equal(rank_t, rank_j)
    assert tbanded.scalar_bandwidth(st.host_data(), st.skeleton) == jbanded.scalar_bandwidth(
        np.asarray(sj.host_data()), sj.skeleton)
    if case == "open":  # wrap blocks are stored zeros and must not count
        assert tbanded.scalar_bandwidth(st.host_data(), st.skeleton) == 4 * 6 + 3


@pytest.mark.parametrize("case", CASES)
def test_banded_solver_matches_reference(case):
    st, sj = build(T, case, device="cpu"), build(J, case)
    data, sk = st.host_data(), st.skeleton
    E_j = jbanded.eigvalsh_banded(np.asarray(sj.host_data()), sj.skeleton)
    np.testing.assert_allclose(tbanded.eigvalsh_banded(data, sk), E_j, atol=1e-10, rtol=0)
    np.testing.assert_allclose(tbanded.eigvalsh_banded(data, sk, reorder=False), E_j, atol=1e-10, rtol=0)
    E, X = tbanded.eigh_banded(data, sk)
    np.testing.assert_allclose(E, E_j, atol=1e-10, rtol=0)
    H = st.matrix("dense")
    assert np.abs(H @ X - X * E).max() < 1e-10  # eigenvectors in the original site order
    np.testing.assert_allclose(X.conj().T @ X, np.eye(len(E)), atol=1e-10)
    np.testing.assert_allclose(E, np.linalg.eigvalsh(H), atol=1e-10, rtol=0)


def test_complex64_input_is_solved_in_double():
    """complex64 block data is upcast before LAPACK sees it: the spectrum equals
    the double-precision solve of the same rounded blocks to 1e-10, which a
    single-precision routine (errors near 1e-6) would miss."""
    st = build(T, "open", device="cpu", dtype=np.complex64)
    data32 = st.host_data()
    assert data32.dtype == np.complex64
    E32 = tbanded.eigvalsh_banded(data32, st.skeleton)
    assert E32.dtype == np.float64
    E64 = tbanded.eigvalsh_banded(data32.astype(np.complex128), st.skeleton)
    np.testing.assert_allclose(E32, E64, atol=1e-10, rtol=0)
    E_j = jbanded.eigvalsh_banded(data32, build(J, "open").skeleton)
    np.testing.assert_allclose(E32, E_j, atol=1e-10, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_facade_banded_methods_match_reference(case):
    st, sj = build(T, case, device="cpu"), build(J, case)
    np.testing.assert_allclose(st.eigenvalues(method="banded"), np.asarray(sj.eigenvalues(method="banded")),
                               atol=1e-10, rtol=0)
    assert st.free_energy(0.05, method="banded") == pytest.approx(sj.free_energy(0.05, method="banded"), abs=1e-9)
    E, X = st.diagonalize(method="banded")
    Ej, Xj = sj.diagonalize(method="banded")
    assert X.shape == np.asarray(Xj).shape == (len(E), st.skeleton.n_sites, 4)
    np.testing.assert_allclose(E, np.asarray(Ej), atol=1e-10, rtol=0)
    with pytest.raises(TypeError):
        st.diagonalize(method="banded", tol=1e-3)
