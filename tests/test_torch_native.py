"""PyTorch port, the native host tier (``bodge_tpu_torch.native``): the fused
assembly scatter, the Hermiticity gate and the mirror search against the
reference's native tier and against the port's own PyTorch / NumPy paths,
the input checks, and the build lock.  Skipped, like ``tests/test_native.py``,
where no C++ toolchain builds the library.  No Pallas call."""

import os
import subprocess
import sys
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import bodge_tpu as J
import bodge_tpu_torch as T
from bodge_tpu import native as jnative
from bodge_tpu.ops import blocksparse as jbs
from bodge_tpu_torch import native
from bodge_tpu_torch.ops import blocksparse as tbs
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)

SHAPE = (6, 5, 1)


@pytest.fixture(autouse=True, scope="module")
def toolchain():
    if not native.available():
        pytest.skip("native library unavailable (no toolchain)")


def _bits(a) -> np.ndarray:
    """The bit patterns of a complex array (so that -0.0 and 0.0 differ)."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32 if a.dtype == np.complex64 else np.int64)


def _assemble(pkg, dtype, **kw):
    """The reference test's random system (``tests/test_native.py``) on ``SHAPE``."""
    σ0, σ3, jσ2 = pkg.σ0, pkg.σ3, pkg.jσ2
    system = pkg.Hamiltonian(pkg.CubicLattice(SHAPE), dtype=dtype, **kw)
    L = SHAPE[0]
    args = dict(
        onsite=lambda ci: -0.5 * σ0 + 0.3 * σ3 * (ci[:, 0] < L // 2)[:, None, None],
        pairing_onsite=lambda ci: (0.4 + 0.1j) * jσ2,
        hopping=lambda ci, cj: np.where((np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0),
        pairing=lambda ci, cj: 0.05 * (ci[:, 0] - cj[:, 0])[:, None, None] * jσ2,
        check=False,
    )
    if pkg is J:
        system.assemble(device=False, **args)  # the reference's host assembly: its native scatter
    else:
        system.assemble(**args)
    return system


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_assembly_bit_equal_to_reference_and_torch_path(dtype):
    """Host assembly through the native scatter gives the reference's host
    assembly and the port's torch writes bit for bit, and the gate reads 0."""
    theirs = _assemble(J, dtype)
    assert isinstance(theirs.data, np.ndarray)
    ours = _assemble(T, dtype, device="cpu")
    with mock.patch.object(native, "available", return_value=False):
        torch_path = _assemble(T, dtype, device="cpu")
    assert np.array_equal(_bits(ours.host_data()), _bits(theirs.data))
    assert np.array_equal(_bits(ours.host_data()), _bits(torch_path.host_data()))
    assert ours._hermiticity_error() == 0.0 == torch_path._hermiticity_error()


def test_herm_error_against_reference_and_torch():
    """``herm_error`` on a CPU tensor and on NumPy: the reference's native
    value and ``blocksparse.hermiticity_error`` to 1e-12, and > 0.4 once one
    block is broken by 0.5."""
    system = _assemble(T, np.complex128, device="cpu")
    sk = system.skeleton
    d = system.data.clone()
    for broken in (False, True):
        if broken:
            d[3, 0, 0, 1] += 0.5
        ours = native.herm_error(d, sk.cols, sk.trans_slot)
        assert ours == native.herm_error(d.numpy(), sk.cols, sk.trans_slot)
        assert abs(ours - jnative.herm_error(d.numpy(), sk.cols, sk.trans_slot)) <= 1e-12
        assert abs(ours - float(tbs.hermiticity_error(d, sk))) <= 1e-12
    assert ours > 0.4


def test_mirror_slots_bit_equal_and_asymmetry_raises():
    """The mirror table of a generic skeleton: the reference's native table,
    and the port's searchsorted path inside ``skeleton_from_pairs``, bit for
    bit; a block without its mirror raises ``ValueError`` on both paths."""
    rng = np.random.default_rng(7)
    n = 40
    i, j = rng.integers(0, n, size=200), rng.integers(0, n, size=200)
    rows, cols = np.concatenate([i, j, np.arange(n)]), np.concatenate([j, i, np.arange(n)])
    sk = tbs.skeleton_from_pairs(n, rows, cols)
    with mock.patch.object(native, "available", return_value=False):
        sk_numpy = tbs.skeleton_from_pairs(n, rows, cols)
    assert np.array_equal(sk.trans_slot, sk_numpy.trans_slot)
    assert np.array_equal(native.mirror_slots(sk.cols), jnative.mirror_slots(sk.cols))
    assert np.array_equal(sk.trans_slot, jbs.skeleton_from_pairs(n, rows, cols).trans_slot)

    with pytest.raises(ValueError, match="asymmetric"):
        native.mirror_slots(np.array([[0, 1], [1, -1]], dtype=np.int32))  # (0,1) has no (1,0)
    for use in (True, False):
        with mock.patch.object(native, "available", return_value=use), pytest.raises(ValueError):
            tbs.skeleton_from_pairs(3, np.array([0, 1, 2, 0]), np.array([0, 1, 2, 1]))


def test_input_checks():
    """Host data only, contiguous and in the operator's dtype; ``cols`` inside
    the rows; an in-place scatter into a CPU tensor writes the tensor."""
    system = _assemble(T, np.complex64, device="cpu")
    sk = system.skeleton
    N, S = sk.cols.shape
    d = torch.zeros_like(system.data)
    native.assemble_scatter(d, sk.cols, onsite=np.full((N, 2, 2), 1 + 2j, np.complex64))
    assert bool((d[:, 0, 0:2, 0:2] == 1 + 2j).all()) and bool((d[:, 0, 2:4, 2:4] == -1 + 2j).all())
    with pytest.raises(ValueError, match="contiguous"):
        native.assemble_scatter(d.transpose(0, 1), sk.cols)
    with pytest.raises(ValueError, match="onsite"):
        native.assemble_scatter(d, sk.cols, onsite=np.zeros((N, 2, 2), np.complex128))
    with pytest.raises(TypeError):
        native.herm_error(d.real.contiguous(), sk.cols, sk.trans_slot)
    bad = sk.cols.copy()
    bad[0, 1] = N
    with pytest.raises(ValueError, match="outside"):
        native.herm_error(d, bad, sk.trans_slot)


@pytest.mark.parametrize("use_native", [False, True])
def test_one_site_assembly_warns_nothing(use_native):
    """A one-site lattice broadcasts its terms to a read-only view; neither
    assembly path may hand that view to ``torch`` (which warns that writing
    to the tensor is undefined)."""
    with warnings.catch_warnings(), mock.patch.object(native, "available", return_value=use_native):
        warnings.simplefilter("error")
        system = T.Hamiltonian(T.CubicLattice((1, 1, 1)), device="cpu")
        system.assemble(onsite=lambda ci: -0.5 * T.σ0, pairing_onsite=lambda ci: 0.2 * T.jσ2)
    assert float(system.data[0, 0, 0, 3].real) == pytest.approx(0.2)


# A process that imports the native module alone: the package is stubbed so
# that its __init__ (which imports torch) does not run, and the compiler is a
# stand-in that logs its call and copies the built library slowly.
_CHILD = r"""
import shutil, sys, time, types
root, built, log = sys.argv[1:4]
package = types.ModuleType("bodge_tpu_torch")
package.__path__ = [root + "/bodge_tpu_torch"]
sys.modules["bodge_tpu_torch"] = package
import bodge_tpu_torch.native as native

def slow_compiler(cmd, **kwargs):
    with open(log, "a") as f:
        f.write(" ".join(cmd) + "\n")
    time.sleep(0.3)
    shutil.copy(built, cmd[-1])

native.subprocess.run = slow_compiler
print(native._build())
assert "torch" not in sys.modules
"""


def test_build_lock_serves_two_processes(tmp_path):
    """Two processes that need the library at once in a fresh build
    directory: one compiles, the other waits on the lock and finds the same
    file.  The stand-in compiler is slow enough for the two to overlap
    without the lock."""
    built = native.library_path()
    log = tmp_path / "compiles.log"
    root = str(Path(__file__).resolve().parent.parent)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}  # no site hook may import torch or jax
    env["BODGE_TORCH_BUILD_DIR"] = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, root, str(built), str(log)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    target = tmp_path / "build" / built.name
    assert [out.strip() for out, _ in outs] == [str(target)] * 2
    assert len(log.read_text().splitlines()) == 1
    assert sorted(p.name for p in target.parent.iterdir()) == sorted([built.name, "libbodge_native.lock"])
