"""PyTorch port, checkpoints: round trips of a cubic and a generic system, files
crossing between the port and ``bodge_tpu`` both ways with identical data,
``cols`` and ``trans_slot``, and the ``FrozenLattice`` behind a restored generic
system."""

import numpy as np
import pytest
import torch

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu.utils import serialization as jser
from bodge_tpu_torch.utils import serialization as tser
from tests.test_torch_banded import ring_lattice
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def build(pkg, kind, **kw):
    lattice = ring_lattice(pkg, 14) if kind == "ring" else pkg.CubicLattice((4, 3, 2))
    system = pkg.Hamiltonian(lattice, **kw)
    system.assemble(
        onsite=lambda ci: -0.4 * pkg.σ0 - 0.01 * ci[:, 0, None, None] * pkg.σ3,
        pairing_onsite=lambda ci: 0.3 * pkg.jσ2,
        hopping=lambda ci, cj: -1.0 * pkg.σ0 + 0.1j * np.sign(cj[:, 0] - ci[:, 0])[:, None, None] * pkg.σ2,
    )
    return system


def _same(a, b):
    assert np.array_equal(np.asarray(a.host_data()), np.asarray(b.host_data()))
    assert np.array_equal(a.skeleton.cols, b.skeleton.cols)
    assert np.array_equal(a.skeleton.trans_slot, b.skeleton.trans_slot)
    assert a.skeleton.stencil == b.skeleton.stencil and np.dtype(a.dtype) == np.dtype(b.dtype)
    assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("kind", ["cubic", "ring"])
def test_round_trip(tmp_path, kind):
    system = build(T, kind, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    system.save(path)
    back = T.Hamiltonian.load(path, device="cpu")
    _same(back, system)
    assert back.data.device.type == "cpu" and back.device.type == "cpu"
    assert isinstance(back.lattice, T.CubicLattice if kind == "cubic" else tser.FrozenLattice)
    # The restored system answers like the original.
    energies = [0.0, 0.4]
    site = (1, 1, 0) if kind == "cubic" else 5
    orig_site = site if kind == "cubic" else (5, 0, 0)
    np.testing.assert_allclose(back.ldos(site, energies, method="kpm", order=32, scale=5.0),
                               system.ldos(orig_site, energies, method="kpm", order=32, scale=5.0), atol=1e-14)
    assert back.free_energy(0.1) == pytest.approx(system.free_energy(0.1), rel=1e-12)
    np.testing.assert_allclose(back.eigenvalues(method="banded"), system.eigenvalues(), atol=1e-10)
    # Still assemblable in place (the version moves, caches drop).
    v = back._version
    back.assemble(onsite=lambda ci: 0.0 * T.σ0, check=False) if kind == "cubic" else None
    assert back._version >= v
    # A complex64 system keeps its dtype through the file.
    s32 = build(T, kind, device="cpu", dtype=np.complex64)
    s32.save(path)
    assert T.Hamiltonian.load(path, device="cpu").data.dtype == torch.complex64


@pytest.mark.parametrize("kind", ["cubic", "ring"])
def test_files_cross_between_packages(tmp_path, kind):
    st, sj = build(T, kind, device="cpu"), build(J, kind)
    _same(st, sj)
    ours, theirs = str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz")
    st.save(ours)
    sj.save(theirs)
    with np.load(ours) as a, np.load(theirs) as b:  # the same keys, the same contents
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    _same(T.Hamiltonian.load(theirs, device="cpu"), sj)
    _same(J.Hamiltonian.load(ours), st)
    assert tser.FORMAT_VERSION == jser.FORMAT_VERSION == 1


def test_frozen_lattice_and_bad_files(tmp_path):
    system = build(T, "ring", device="cpu")
    path = str(tmp_path / "ring.npz")
    system.save(path)
    back = T.Hamiltonian.load(path, device="cpu")
    assert back.lattice.size == 14 and back.lattice.shape == (14, 1, 1) and back.lattice[3] == 3
    with pytest.raises(ValueError, match="flat index"):
        back.lattice[(3, 0, 0)]
    with pytest.raises(ValueError, match="flat index"):
        back.ldos((3, 0, 0), [0.0], method="kpm", order=8, scale=5.0)
    with pytest.raises(ValueError, match="flat index"):
        jser.FrozenLattice(14).index((3, 0, 0))  # the reference raises the same
    assert back.ldos_map([3, 4], [0.0], method="kpm", order=8, scale=5.0).shape == (2, 1)

    with np.load(path) as f:
        fields = {k: f[k] for k in f.files}
    newer = str(tmp_path / "newer.npz")
    np.savez_compressed(newer, **{**fields, "format_version": tser.FORMAT_VERSION + 1})
    with pytest.raises(ValueError, match="newer"):
        T.Hamiltonian.load(newer, device="cpu")

    cubic = build(T, "cubic", device="cpu")
    cpath = str(tmp_path / "cubic.npz")
    cubic.save(cpath)
    with np.load(cpath) as f:
        fields = {k: f[k] for k in f.files}
    wrong = str(tmp_path / "wrong.npz")
    np.savez_compressed(wrong, **{**fields, "cols": np.roll(fields["cols"], 1, axis=0)})
    with pytest.raises(ValueError, match="does not match"):
        T.Hamiltonian.load(wrong, device="cpu")
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.Hamiltonian.load(cpath)
