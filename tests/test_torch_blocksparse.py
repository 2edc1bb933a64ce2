"""PyTorch port, substrate: skeletons, slot lookup, format conversion, the
facade's names, and the rule that the port imports neither JAX nor the JAX
package.  Skeleton tables are compared for identity with ``bodge_tpu``."""

import subprocess
import sys

import numpy as np
import pytest

import bodge_tpu
import bodge_tpu_torch
from bodge_tpu.ops import blocksparse as jbs
from bodge_tpu_torch.ops import blocksparse as tbs
import torch
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


def _same_skeleton(a, b):
    assert a.shape == b.shape
    assert a.slots == b.slots
    assert a.cols.dtype == b.cols.dtype and np.array_equal(a.cols, b.cols)
    assert np.array_equal(a.trans_slot, b.trans_slot)
    assert a.nnz_blocks == b.nnz_blocks
    assert a.stencil == b.stencil
    assert a.n_slots == b.n_slots and a.matrix_dim == b.matrix_dim


@pytest.mark.parametrize("shape", [(6, 5, 1), (2, 6, 1), (4, 4, 3), (16, 1, 1), (1, 1, 1)])
def test_skeleton_identical(shape):
    _same_skeleton(tbs.skeleton(shape), jbs.skeleton(shape))


def _random_symmetric_pairs(n, extra, seed):
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.arange(n), rng.integers(0, n, size=extra)])
    c = np.concatenate([np.arange(n), rng.integers(0, n, size=extra)])
    return np.concatenate([r, c]), np.concatenate([c, r])


def test_skeleton_from_pairs_identical():
    rows, cols = _random_symmetric_pairs(17, 40, seed=3)
    _same_skeleton(tbs.skeleton_from_pairs(17, rows, cols), jbs.skeleton_from_pairs(17, rows, cols))


def test_skeleton_from_pairs_asymmetric_raises():
    with pytest.raises(ValueError):
        tbs.skeleton_from_pairs(3, np.array([0, 1, 2, 0]), np.array([0, 1, 2, 1]))


def test_skeleton_from_lattice_identical():
    lat_t = bodge_tpu_torch.CubicLattice((3, 2, 1))
    lat_j = bodge_tpu.CubicLattice((3, 2, 1))
    _same_skeleton(tbs.skeleton_from_lattice(lat_t), jbs.skeleton_from_lattice(lat_j))


def test_slot_lookup():
    sk = tbs.skeleton((4, 3, 1))
    rows = np.array([0, 5, 11])
    cols = sk.cols[rows, [1, 2, 3]]
    assert np.array_equal(tbs.slot_lookup(sk, rows, cols), [1, 2, 3])
    assert np.array_equal(
        tbs.slot_lookup(sk, rows, cols), jbs.slot_lookup(jbs.skeleton((4, 3, 1)), rows, cols)
    )
    with pytest.raises(KeyError):
        tbs.slot_lookup(sk, np.array([0]), np.array([7]))


@pytest.mark.parametrize("shape", [(4, 3, 1), (2, 3, 2)])
def test_dense_roundtrip(shape):
    import torch

    sk = tbs.skeleton(shape)
    rng = np.random.default_rng(0)
    N, S = sk.cols.shape
    data = rng.normal(size=(N, S, 4, 4)) + 1j * rng.normal(size=(N, S, 4, 4))
    data = data * sk.valid[..., None, None]
    dense = tbs.ell_to_dense(data, sk)
    assert np.array_equal(dense, jbs.ell_to_dense(data, jbs.skeleton(shape)))
    assert np.array_equal(tbs.dense_to_ell(dense, sk), data)
    assert np.array_equal(tbs.ell_to_dense_torch(torch.as_tensor(data), sk).numpy(), dense)
    assert np.array_equal(tbs.ell_to_bsr(data, sk).toarray(), dense)


def test_device_copies_cached():
    sk = tbs.skeleton((3, 2, 1))
    cols = sk.device_cols("cpu")
    assert cols is sk.device_cols("cpu")
    assert np.array_equal(cols.numpy(), sk.cols)
    assert (sk.device_safe_cols("cpu").numpy() >= 0).all()
    assert np.array_equal(sk.device_valid("cpu").numpy(), sk.valid)
    assert hash(sk) == object.__hash__(sk)  # identity hash survives the cache field


def test_hermiticity_error():
    import torch

    sk = tbs.skeleton((4, 3, 1))
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(48, 48)) + 1j * rng.normal(size=(48, 48))
    herm = tbs.dense_to_ell(dense + dense.conj().T, sk)
    assert float(tbs.hermiticity_error(torch.as_tensor(herm), sk)) == 0.0
    want = float(jbs.hermiticity_error(tbs.dense_to_ell(dense, sk), jbs.skeleton((4, 3, 1))))
    got = float(tbs.hermiticity_error(torch.as_tensor(tbs.dense_to_ell(dense, sk)), sk))
    assert got == pytest.approx(want, rel=1e-14) and got > 0.1


def test_facade_names():
    assert bodge_tpu_torch.__all__ == bodge_tpu.__all__
    assert len(bodge_tpu_torch.__all__) == 33
    for name in bodge_tpu_torch.__all__:
        ours, theirs = getattr(bodge_tpu_torch, name), getattr(bodge_tpu, name)
        if isinstance(theirs, np.ndarray):
            assert np.array_equal(ours, theirs)


def test_import_leaves_jax_out():
    """The port (and the GPU smoke script, guarded by ``__main__``) imports
    neither ``jax`` nor the JAX package."""
    code = (
        "import sys\n"
        "import bodge_tpu_torch, chip_smoke\n"
        "import bodge_tpu_torch.models.systems, bodge_tpu_torch.utils.convert\n"
        "import bodge_tpu_torch.ops.cuda_ell, bodge_tpu_torch.ops.cuda_spmm, bodge_tpu_torch.ops.chebyshev\n"
        "import bodge_tpu_torch.ops.cuda_filter\n"
        "import bodge_tpu_torch.ops.dense, bodge_tpu_torch.models.selfconsistency\n"
        "import bodge_tpu_torch.ops.banded, bodge_tpu_torch.ops.cuda_gather\n"
        "import bodge_tpu_torch.ops.lanczos, bodge_tpu_torch.utils.serialization\n"
        "import bodge_tpu_torch.parallel, bodge_tpu_torch.parallel.cuda_sharded\n"
        "import bodge_tpu_torch.utils.profiling, bodge_tpu_torch.utils.trace\n"
        "import bodge_tpu_torch.native, bodge_tpu_torch.ops.planar\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'bodge_tpu' or m.startswith('bodge_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # Run from the repository root without PYTHONPATH, so that no site hook
    # imports anything before the module under test.
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stderr
