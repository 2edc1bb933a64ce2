"""Checkpoint / resume for assembled Hamiltonians.

An assembled operator is worth persisting: million-site assemblies take
seconds and self-consistency loops produce converged gap fields one wants to
restart from.

Format: a single ``.npz`` with the ELL block data, the skeleton descriptor,
and dtype/shape metadata — the same keys and :data:`FORMAT_VERSION` as
``bodge_tpu/utils/serialization.py``, so a file written by either package
loads in the other.  The block data is pulled to the host on save; load puts
it on the requested device (``device=None`` means the card, as everywhere in
this package).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import resolve_device, torch_dtype

FORMAT_VERSION = 1


class FrozenLattice:
    """Placeholder lattice for checkpoints of non-cubic systems.

    The original :class:`~bodge_tpu_torch.lattice.Lattice` subclass cannot be
    reconstructed from a checkpoint; flat site indices keep working (the
    solvers only need them), while coordinate lookups raise.
    """

    def __init__(self, size: int):
        self.size = size
        self.shape = (size, 1, 1)
        self.dim = 1

    def __getitem__(self, coord):
        return self.index(coord)

    def index(self, coord):
        if np.isscalar(coord):
            return int(coord)
        raise ValueError(
            "This Hamiltonian was loaded from a checkpoint of a custom "
            "lattice; address sites by flat index instead of coordinates."
        )


def save_hamiltonian(system, path: str) -> None:
    """Persist an assembled Hamiltonian (skeleton + block data) to ``path``."""
    sk = system.skeleton
    np.savez_compressed(
        path,
        format_version=FORMAT_VERSION,
        data=system.host_data(),
        dtype=str(system.dtype),
        lattice_shape=np.asarray(system.lattice.shape, dtype=np.int64),
        stencil=np.asarray(sk.stencil),
        cols=sk.cols,
        trans_slot=sk.trans_slot,
    )


def load_hamiltonian(path: str, device=None):
    """Reconstruct a Hamiltonian saved by :func:`save_hamiltonian`.

    Cubic (stencil) skeletons are rebuilt from the lattice shape and
    verified against the stored column table; generic skeletons are
    restored verbatim behind a :class:`FrozenLattice`.  The stored dtype is
    kept; the data lands on ``device``.
    """
    from ..hamiltonian import Hamiltonian
    from ..lattice import CubicLattice
    from ..ops.blocksparse import BLOCK, Skeleton

    with np.load(path, allow_pickle=False) as f:
        ver = int(f["format_version"])
        if ver > FORMAT_VERSION:
            raise ValueError(f"Checkpoint format {ver} is newer than supported")
        data = f["data"]
        dtype = np.dtype(str(f["dtype"]))
        shape = tuple(int(v) for v in f["lattice_shape"])
        stencil = bool(f["stencil"])
        cols = f["cols"]
        trans = f["trans_slot"]

    if stencil:
        system = Hamiltonian(CubicLattice(shape), dtype=dtype, device=device)
        if not np.array_equal(system.skeleton.cols, cols):
            raise ValueError("Checkpoint skeleton does not match its lattice shape")
    else:
        n_sites = cols.shape[0]
        sk = Skeleton(
            shape=(n_sites, 1, 1),
            slots=(),
            cols=cols,
            trans_slot=trans,
            nnz_blocks=int((cols >= 0).sum()),
            stencil=False,
        )
        system = Hamiltonian.__new__(Hamiltonian)
        system.lattice = FrozenLattice(n_sites)
        system.device = resolve_device(device)
        system.dtype = dtype
        system._sk = sk
        system.shape = (BLOCK * n_sites, BLOCK * n_sites)
        system._eigh_cache = None
        system._version = 0

    system._data = torch.from_numpy(np.ascontiguousarray(data.astype(system.dtype, copy=False))).to(
        device=system.device, dtype=torch_dtype(system.dtype)
    )
    system._version += 1
    return system
