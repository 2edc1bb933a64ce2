"""PyTorch port, assembly and export: the block data must be bit-equal
(complex128) to what ``bodge_tpu`` assembles from the same recipe, through
the ``with`` DSL, the vectorized model recipes and a generic lattice; exports
match; the clean-error probes raise the same exception types and leave the
system usable."""

import numpy as np
import pytest

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.models import systems as jsys
from bodge_tpu_torch.models import systems as tsys
from bodge_tpu_torch.utils.convert import hamiltonian_from_numpy, to_numpy


def _quickstart(pkg, L=8, **kw):
    """The README quickstart through the ``with`` DSL."""
    lattice = pkg.CubicLattice((L, L, 1))
    system = pkg.Hamiltonian(lattice, **kw)
    t, μ, m, Δs = 1, -3, 0.05, 0.10
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -μ * pkg.σ0 - m * pkg.σ3
            Δ[i, i] = -Δs * pkg.jσ2
        for i, j in lattice.bonds():
            H[i, j] = -t * pkg.σ0
    return lattice, system


def _bit_equal(torch_system, jax_system):
    got = torch_system.host_data()
    want = np.asarray(jax_system.host_data())
    assert got.dtype == want.dtype == np.complex128
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_quickstart_dsl_bit_equal_and_exports():
    _, st = _quickstart(T, device="cpu")
    _, sj = _quickstart(J)
    _bit_equal(st, sj)
    assert np.array_equal(st.matrix("dense"), sj.matrix("dense"))
    a, b = st.matrix("csr"), sj.matrix("csr")
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)
    assert np.array_equal(st.matrix("dense_torch").numpy(), sj.matrix("dense"))
    assert st.index((1, 2, 0), (1, 3, 0)) == sj.index((1, 2, 0), (1, 3, 0))


@pytest.mark.parametrize(
    "name,args,kwargs",
    [
        ("swave_superconductor", ((6, 5, 1),), {"zeeman": [0.1, 0.0, 0.2]}),
        ("sf_bilayer", (8, 6), {}),
        ("rashba_dp_wave", ((4, 4, 3),), {}),
        ("rashba_dp_wave", ((2, 4, 1),), {"profile": lambda mid: 1.0 + 0.1 * mid[:, 1]}),
        ("josephson_junction", (), {"L": 16, "leads": 4, "phase": 0.7}),
    ],
)
def test_model_systems_bit_equal(name, args, kwargs):
    st = getattr(tsys, name)(*args, device="cpu", **kwargs)
    sj = getattr(jsys, name)(*args, **kwargs)
    assert st.device.type == "cpu" and st.data.device.type == "cpu"
    _bit_equal(st, sj)


def _ring(pkg):
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

    return RingLattice(10)


def _fill_ring_dsl(pkg, lattice, system):
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -0.4 * pkg.σ0
            Δ[i, i] = 0.3 * pkg.jσ2
        for i, j in list(lattice.bonds()) + list(lattice.edges()):
            H[i, j] = -1.0 * pkg.σ0 + 0.2j * np.sign(j[0] - i[0]) * pkg.σ2
            Δ[i, j] = 0.1 * np.sign(j[0] - i[0]) * pkg.σ1
    return system


def _fill_ring_assemble(pkg, system, device):
    def pairing(ci, cj):
        return 0.1 * np.sign(cj[:, 0] - ci[:, 0])[:, None, None] * pkg.σ1

    return system.assemble(
        onsite=lambda ci: -0.4 * pkg.σ0 - 0.01 * ci[:, 0, None, None] * pkg.σ3,
        pairing_onsite=lambda ci: 0.3 * pkg.jσ2,
        hopping=lambda ci, cj: -1.0 * pkg.σ0,
        pairing=pairing,
        reset=True,
        device=device,
    )


def test_generic_lattice_bit_equal():
    lt, lj = _ring(T), _ring(J)
    st = _fill_ring_dsl(T, lt, T.Hamiltonian(lt, device="cpu"))
    sj = _fill_ring_dsl(J, lj, J.Hamiltonian(lj))
    assert not st.skeleton.stencil
    assert np.array_equal(st.skeleton.cols, sj.skeleton.cols)
    assert np.array_equal(st.skeleton.trans_slot, sj.skeleton.trans_slot)
    _bit_equal(st, sj)
    # The vectorized path on the generic skeleton, with the writes done on
    # the device and on a host copy: both end on the Hamiltonian's device.
    sj = _fill_ring_assemble(J, sj, True)
    for device in (True, False):
        st = _fill_ring_assemble(T, st, device)
        assert st.data.device == st.device
        _bit_equal(st, sj)


def test_assemble_reset_and_partial_update_bit_equal():
    def build(pkg, **kw):
        system = pkg.Hamiltonian(pkg.CubicLattice((2, 5, 1)), **kw)  # extent 2: a cols = -1 slot
        bond = lambda ci, cj: (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]
        system.assemble(
            onsite=lambda ci: -0.5 * pkg.σ0,
            hopping=lambda ci, cj: np.where(bond(ci, cj), -1.0 * pkg.σ0, 0),
        )
        system.assemble(pairing_onsite=lambda ci: 0.2 * pkg.jσ2)  # leaves the rest
        system.assemble(
            pairing=lambda ci, cj: np.where(bond(ci, cj), 0.1 * pkg.jσ2, 0), device=False
        )
        return system

    st, sj = build(T, device="cpu"), build(J)
    _bit_equal(st, sj)
    st.assemble(onsite=lambda ci: 1.0 * T.σ0, reset=True)
    sj.assemble(onsite=lambda ci: 1.0 * J.σ0, reset=True)
    _bit_equal(st, sj)


def test_clean_error_probes_same_types():
    """Each probe raises the same exception type in both packages, and the
    system stays usable afterwards."""
    lt, st = _quickstart(T, L=4, device="cpu")
    lj, sj = _quickstart(J, L=4)
    before = st.host_data().copy()

    def nonhermitian(pkg, system):
        with system as (H, Δ):
            H[(0, 0, 0), (0, 1, 0)] = 1j * pkg.σ0  # partner block keeps -t σ0

    def non_neighbour(pkg, system):
        with system as (H, Δ):
            H[(0, 0, 0), (2, 2, 0)] = pkg.σ0

    probes = [
        (RuntimeError, lambda pkg, s: s.matrix("blah")),
        (ValueError, lambda pkg, s: s.free_energy(-1)),
        (ValueError, lambda pkg, s: s.free_energy(-1, method="kpm")),
        (RuntimeError, lambda pkg, s: s.free_energy(0.1, cuda=True)),
        (ValueError, lambda pkg, s: s.ldos((9, 9, 0), [0.0], method="kpm")),
        (KeyError, non_neighbour),
        (RuntimeError, nonhermitian),
    ]
    for exc, probe in probes:
        with pytest.raises(exc):
            probe(J, sj)
        with pytest.raises(exc):
            probe(T, st)

    # Usable afterwards: repair the block the failed assembly left behind.
    for pkg, s in ((T, st), (J, sj)):
        with s as (H, Δ):
            H[(0, 0, 0), (0, 1, 0)] = -1 * pkg.σ0
    assert np.array_equal(st.host_data(), before)
    _bit_equal(st, sj)
    assert np.isfinite(st.free_energy(0.01, method="kpm", order=8, scale=8.0))


def test_device_policy_and_unported_solvers():
    import torch

    lattice = T.CubicLattice((2, 2, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.Hamiltonian(lattice)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsys.swave_superconductor((2, 2, 1))
    system = T.Hamiltonian(lattice, device="cpu")
    assert system.dtype == np.complex128
    assert T.Hamiltonian(lattice, dtype=np.complex64, device="cpu").data.dtype == torch.complex64
    from bodge_tpu_torch.common import default_cdtype, default_rdtype

    assert default_cdtype("cuda") == np.complex64 and default_rdtype("cuda") == np.float32
    assert default_cdtype("cpu") == np.complex128 and default_rdtype("cpu") == np.float64
    for call in (
        lambda: system.diagonalize(),
        lambda: system.eigenvalues(method="banded"),
        lambda: system.free_energy(0.1),
        lambda: system.ldos((0, 0, 0), [0.0]),
        lambda: system.ldos_map([(0, 0, 0)], [0.0]),
        lambda: system.save("x.npz"),
        lambda: T.Hamiltonian.load("x.npz"),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            call()
    with pytest.raises(TypeError):
        T.Hamiltonian("not a lattice", device="cpu")


def test_convert_roundtrip():
    sj = jsys.rashba_dp_wave((4, 4, 3))
    skj = sj.skeleton
    st = hamiltonian_from_numpy((4, 4, 3), np.asarray(sj.host_data()), skj.cols, skj.trans_slot,
                                device="cpu")
    _bit_equal(st, sj)
    back = to_numpy(st)
    assert back["shape"] == (4, 4, 3) and back["slots"] == skj.slots
    assert np.array_equal(back["data"], np.asarray(sj.host_data()))
    assert np.array_equal(back["cols"], skj.cols)
    st64 = hamiltonian_from_numpy(st.lattice, back["data"], dtype=np.complex64, device="cpu")
    assert st64.dtype == np.complex64
    assert np.allclose(st64.host_data(), back["data"], atol=1e-6)
    with pytest.raises(ValueError):
        hamiltonian_from_numpy((4, 4, 3), back["data"], np.roll(skj.cols, 1, axis=0), device="cpu")
    with pytest.raises(ValueError):
        hamiltonian_from_numpy((4, 4, 2), back["data"], device="cpu")
