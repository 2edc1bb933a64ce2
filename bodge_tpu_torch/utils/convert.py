"""Operators carried between packages as NumPy arrays.

:func:`hamiltonian_from_numpy` takes what another implementation of the same
block-ELL layout hands out as NumPy — the block data ``[N, S, 4, 4]`` (e.g.
``system.host_data()``) and, for generic lattices, the skeleton's ``cols``
and ``trans_slot`` — and returns a :class:`~bodge_tpu_torch.hamiltonian.Hamiltonian`
holding the same blocks on the requested device.  :func:`to_numpy` is the
way back.  :func:`tensor_from_numpy` carries a pairing field, a probe block or
a structure array the same way, so that two implementations evaluate the
same ``F_total(Δ)``.  A ``.npz`` checkpoint another implementation saved is
read by ``Hamiltonian.load`` (one format, see
:mod:`bodge_tpu_torch.utils.serialization`), and
:func:`gather_layout_from_numpy` takes its site relabelling (``rank``,
``bwb``) so that both run the windowed product on the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import torch_dtype
from ..hamiltonian import Hamiltonian
from ..lattice import CubicLattice, Lattice
from ..ops.blocksparse import BLOCK


def hamiltonian_from_numpy(
    lattice, data, cols=None, trans_slot=None, *, dtype=None, device=None
) -> Hamiltonian:
    """A :class:`Hamiltonian` on ``device`` with the given block data.

    ``lattice`` is a :class:`Lattice` or a cubic shape ``(Lx, Ly, Lz)``.
    ``dtype=None`` follows the device policy (complex64 on the card,
    complex128 on the CPU).  Where ``cols`` / ``trans_slot`` are given they
    must equal the skeleton this package builds for the lattice, so that the
    blocks mean the same matrix; a mismatch raises ``ValueError``.
    """
    if not isinstance(lattice, Lattice):
        lattice = CubicLattice(tuple(int(v) for v in lattice))
    system = Hamiltonian(lattice, dtype=dtype, device=device)
    sk = system.skeleton

    data = np.asarray(data)
    expected = (*sk.cols.shape, BLOCK, BLOCK)
    if data.shape != expected:
        raise ValueError(f"data has shape {data.shape}, expected {expected} for {lattice!r}")
    for name, given, own in (("cols", cols, sk.cols), ("trans_slot", trans_slot, sk.trans_slot)):
        if given is not None and not np.array_equal(np.asarray(given), own):
            raise ValueError(f"{name} differs from this package's skeleton for {lattice!r}")

    system._data = torch.from_numpy(np.array(data, order="C")).to(
        device=system.device, dtype=torch_dtype(system.dtype)
    )
    system._version += 1
    return system


def gather_layout_from_numpy(sk, rank, bwb: int, K: int):
    """A :class:`~bodge_tpu_torch.ops.cuda_gather.GatherLayout` for ``sk`` on a
    relabelling handed over as NumPy — ``rank[i]`` the new index of site
    ``i`` and ``bwb`` the block bandwidth, e.g. the ``rank`` / ``bwb`` of a
    ``bodge_tpu`` ``GatherLayout`` — or ``None`` when no window fits."""
    from ..ops.cuda_gather import layout_from_rank

    return layout_from_rank(sk, np.asarray(rank), int(bwb), int(K))


def tensor_from_numpy(array, *, device, dtype=None, requires_grad: bool = False):
    """``array`` (a pairing field ``[N]``, probes ``[N, 4, K]``, a structure
    array ``[S, 2, 2]``, …) as a contiguous tensor on ``device``.

    ``dtype`` is a NumPy or ``torch`` dtype (``None`` keeps the array's own).
    With ``requires_grad`` the tensor is a leaf that ``torch.autograd``
    tracks, e.g. the real gap field a gradient is taken against.
    """
    t = torch.from_numpy(np.array(array, order="C")).to(
        device=device, dtype=None if dtype is None else torch_dtype(dtype)
    )
    return t.requires_grad_(requires_grad)


def to_numpy(system: Hamiltonian) -> dict:
    """``{"shape", "data", "cols", "slots", "trans_slot"}`` of a Hamiltonian as NumPy."""
    sk = system.skeleton
    return {
        "shape": tuple(system.lattice.shape),
        "data": system.host_data(),
        "cols": sk.cols.copy(),
        "slots": sk.slots,
        "trans_slot": sk.trans_slot.copy(),
    }
