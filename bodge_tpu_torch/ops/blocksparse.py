"""Block-sparse (ELL / stencil) storage for BdG Hamiltonians.

Design
------
The reference stores the 4N×4N Bogoliubov-de Gennes matrix as a SciPy BSR
matrix with 4×4 blocks whose sparsity skeleton is fixed at construction
(``bodge/hamiltonian.py:34-64``).  On an accelerator the idiomatic equivalent
is a *static-shape padded ELL layout*: for a cubic lattice each block row holds at
most ``S = 1 + 2·(active axes)`` blocks — the diagonal plus one neighbor per
axis direction, where a periodic wrap link occupies the slot its missing
neighbor would have used.  We therefore store

    ``data: [N, S, 4, 4] complex``   (block values; zero = structural zero)
    ``cols: [N, S] int32``           (block column per slot; −1 = padding)

with a fixed slot↔direction correspondence.  This gives fully static shapes,
is trivially shardable along N, and — because the slot of every neighbor is a
pure ±1 coordinate shift — lets SpMM be evaluated as a *stencil*: axis rolls
of the operand vector followed by batched 4×4 block products, with periodic
wrap-around handled exactly by the circular roll (non-periodic boundaries
contribute zero because their wrap blocks are structural zeros).

The skeleton (cols, slot table, Hermitian-transpose permutation) depends only
on the lattice shape and is cached host-side, with device copies of ``cols``
made once per device; only ``data`` is a ``torch`` tensor.  Export paths convert to SciPy BSR/CSR/CSC/COO/dense for API parity
with ``Hamiltonian.matrix()`` (``bodge/hamiltonian.py:128-155``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import scipy.sparse as sp

BLOCK = 4  # 4×4 blocks: Nambu ⊗ Spin.


@dataclass(frozen=True, eq=False)  # identity hash/eq: usable as a cache key
class Skeleton:
    """Host-side sparsity skeleton for a cubic lattice of a given shape.

    ``cols`` and ``valid`` are NumPy arrays; :meth:`device_cols`,
    :meth:`device_safe_cols` and :meth:`device_valid` hand out copies on a
    ``torch`` device, made once per device and kept with the skeleton.

    Attributes:
        shape: lattice extents ``(Lx, Ly, Lz)``.
        slots: per-slot ``(axis, dir)``; slot 0 is the diagonal ``(-1, 0)``.
        cols: ``[N, S]`` int32 block column per (row, slot); −1 marks padding.
        trans_slot: ``[S]`` int32 — slot of the mirror block: the block at
            ``(i, s)`` with column ``j`` has its Hermitian partner stored at
            ``(j, trans_slot[s])``.
        nnz_blocks: number of structurally-present blocks.
    """

    shape: Tuple[int, int, int]
    slots: Tuple[Tuple[int, int], ...]
    cols: np.ndarray
    trans_slot: np.ndarray
    nnz_blocks: int
    stencil: bool = True
    _device_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_sites(self) -> int:
        return int(np.prod(self.shape))

    @property
    def n_slots(self) -> int:
        # Derived from the column table, not the slot-direction table:
        # generic (non-stencil) skeletons have no direction table at all.
        return self.cols.shape[1]

    @property
    def valid(self) -> np.ndarray:
        return self.cols >= 0

    @property
    def matrix_dim(self) -> int:
        return BLOCK * self.n_sites

    def _device_copy(self, name: str, device, make):
        import torch

        key = (name, str(torch.device(device)))
        if key not in self._device_cache:
            self._device_cache[key] = torch.as_tensor(make()).to(device)
        return self._device_cache[key]

    def device_cols(self, device):
        """``cols`` as a contiguous int32 tensor on ``device`` (−1 = padding)."""
        return self._device_copy("cols", device, lambda: np.ascontiguousarray(self.cols))

    def device_safe_cols(self, device):
        """``cols`` as int64 gather indices on ``device``, padding mapped to row 0."""
        return self._device_copy(
            "safe_cols", device, lambda: np.where(self.valid, self.cols, 0).astype(np.int64)
        )

    def device_valid(self, device):
        """``valid`` as a bool tensor on ``device``."""
        return self._device_copy("valid", device, lambda: self.valid)


@functools.lru_cache(maxsize=64)
def skeleton(shape: Tuple[int, int, int]) -> Skeleton:
    """Build (and cache) the ELL skeleton for a cubic lattice shape.

    Slot layout: slot 0 = diagonal; then, for each axis with extent > 1 in
    order (0, 1, 2), a +1 slot and a −1 slot.  For extent-2 axes the −1
    neighbor coincides with the +1 neighbor (the wrap link and the bond are
    the same matrix block, mirroring COO coalescing in the reference
    ``bodge/hamiltonian.py:59``), so the −1 slot is marked invalid and its
    mirror maps back to the +1 slot.
    """
    Lx, Ly, Lz = shape
    N = Lx * Ly * Lz
    extents = np.array(shape)

    # Coordinates in index order (z fastest).
    x, y, z = np.meshgrid(
        np.arange(Lx, dtype=np.int64),
        np.arange(Ly, dtype=np.int64),
        np.arange(Lz, dtype=np.int64),
        indexing="ij",
    )
    coords = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    slots = [(-1, 0)]
    for axis in range(3):
        if shape[axis] > 1:
            slots.append((axis, +1))
            slots.append((axis, -1))
    S = len(slots)

    cols = np.full((N, S), -1, dtype=np.int32)
    cols[:, 0] = np.arange(N, dtype=np.int32)
    for s, (axis, d) in enumerate(slots[1:], start=1):
        if shape[axis] == 2 and d == -1:
            continue  # coalesced with the +1 slot
        nb = coords.copy()
        nb[:, axis] = (nb[:, axis] + d) % shape[axis]
        cols[:, s] = (nb[:, 2] + Lz * (nb[:, 1] + Ly * nb[:, 0])).astype(np.int32)

    trans = np.zeros(S, dtype=np.int32)
    slot_of = {ad: s for s, ad in enumerate(slots)}
    for s, (axis, d) in enumerate(slots):
        if axis < 0:
            trans[s] = s
        elif shape[axis] == 2:
            trans[s] = slot_of[(axis, +1)]
        else:
            trans[s] = slot_of[(axis, -d)]

    return Skeleton(
        shape=tuple(int(v) for v in shape),
        slots=tuple(slots),
        cols=cols,
        trans_slot=trans,
        nnz_blocks=int((cols >= 0).sum()),
    )


def skeleton_from_pairs(n_sites: int, rows: np.ndarray, cols: np.ndarray) -> Skeleton:
    """Generic ELL skeleton from an explicit (row, col) block-pair list.

    Fallback for user-defined :class:`~bodge_tpu_torch.lattice.Lattice` subclasses
    that are not cubic: no stencil structure is assumed, so SpMM uses the
    gather path.  Pairs are deduplicated (COO coalescing semantics, matching
    the reference skeleton construction ``bodge/hamiltonian.py:46-59``) and
    each row's slots are ordered by block column.
    """
    pairs = np.stack([np.asarray(rows), np.asarray(cols)], axis=1)
    pairs = np.unique(pairs, axis=0)  # sorted by (row, col)
    r, c = pairs[:, 0], pairs[:, 1]

    counts = np.bincount(r, minlength=n_sites)
    S = int(counts.max()) if len(counts) else 1
    cols_arr = np.full((n_sites, S), -1, dtype=np.int32)
    # Slot position = rank of the pair within its row (pairs are sorted).
    starts = np.zeros(n_sites + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_pos = np.arange(len(r)) - starts[r]
    cols_arr[r, slot_pos] = c

    # Hermitian-mirror slot for every entry: position of (c, r), found by a
    # searchsorted over the (row, col)-sorted pair list.
    keys = r.astype(np.int64) * n_sites + c.astype(np.int64)
    mirror_keys = c.astype(np.int64) * n_sites + r.astype(np.int64)
    idx = np.searchsorted(keys, mirror_keys)
    ok = (idx < len(keys)) & (keys[np.minimum(idx, len(keys) - 1)] == mirror_keys)
    if not ok.all():
        ri, ci = r[~ok][0], c[~ok][0]
        raise ValueError(
            f"Structurally asymmetric skeleton: block ({ri},{ci}) has no mirror"
        )
    trans = np.zeros((n_sites, S), dtype=np.int32)
    trans[r, slot_pos] = slot_pos[idx].astype(np.int32)

    return Skeleton(
        shape=(n_sites, 1, 1),
        slots=(),
        cols=cols_arr,
        trans_slot=trans,
        nnz_blocks=len(r),
        stencil=False,
    )


def skeleton_from_lattice(lattice) -> Skeleton:
    """ELL skeleton for any :class:`Lattice` via its traversal contract."""
    rows, cols = [], []
    for ci, cj in lattice:
        i, j = lattice.index(ci), lattice.index(cj)
        rows += [i, j]
        cols += [j, i]
    return skeleton_from_pairs(lattice.size, np.array(rows), np.array(cols))


def slot_lookup(sk: Skeleton, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Slot index of block (row, col) for batched row/col site indices.

    Raises ``KeyError`` if any requested block is not structurally present —
    the analog of the reference's ``Hamiltonian.index`` scan failing
    (``bodge/hamiltonian.py:157-170``).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    hit = sk.cols[rows] == cols[..., None]  # [..., S]
    found = hit.any(axis=-1)
    if not found.all():
        bad = np.argwhere(~found)[0]
        raise KeyError(
            f"No structural block for site pair (row={rows[tuple(bad)]}, col={cols[tuple(bad)]})"
        )
    return np.argmax(hit, axis=-1).astype(np.int32)


# --------------------------------------------------------------------------
# Format conversion (export parity with bodge/hamiltonian.py:128-155).
# --------------------------------------------------------------------------
def _sorted_block_lists(sk: Skeleton):
    """CSR-ordered (indptr, indices, row/slot gather order) for the skeleton."""
    N, S = sk.cols.shape
    valid = sk.valid
    counts = valid.sum(axis=1)
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])

    # Within each row, order slots by block column for canonical CSR layout.
    order_key = np.where(valid, sk.cols, np.iinfo(np.int32).max)
    slot_order = np.argsort(order_key, axis=1, kind="stable")  # [N, S]
    flat_rows = np.repeat(np.arange(N), S).reshape(N, S)
    take = valid[flat_rows, slot_order]
    rows_sel = flat_rows[take]
    slots_sel = slot_order[take]
    indices = sk.cols[rows_sel, slots_sel].astype(np.int32)
    return indptr, indices, rows_sel, slots_sel


def ell_to_bsr(data: np.ndarray, sk: Skeleton) -> sp.bsr_matrix:
    """Convert ELL block data ``[N, S, 4, 4]`` to a SciPy BSR matrix."""
    indptr, indices, rows_sel, slots_sel = _sorted_block_lists(sk)
    blocks = np.asarray(data)[rows_sel, slots_sel]
    dim = sk.matrix_dim
    return sp.bsr_matrix((blocks, indices, indptr), shape=(dim, dim), blocksize=(BLOCK, BLOCK))


def ell_to_dense(data: np.ndarray, sk: Skeleton) -> np.ndarray:
    """Convert ELL block data to a dense ``[4N, 4N]`` NumPy array."""
    N, S = sk.cols.shape
    data = np.asarray(data)
    dense = np.zeros((N, BLOCK, N, BLOCK), dtype=data.dtype)
    rows, slots = np.nonzero(sk.valid)
    cols = sk.cols[rows, slots]
    dense[rows, :, cols, :] = data[rows, slots]
    return dense.reshape(sk.matrix_dim, sk.matrix_dim)


def dense_to_ell(dense: np.ndarray, sk: Skeleton) -> np.ndarray:
    """Project a dense ``[4N, 4N]`` matrix onto the skeleton's ELL layout."""
    N, S = sk.cols.shape
    dense = np.asarray(dense).reshape(N, BLOCK, N, BLOCK)
    data = np.zeros((N, S, BLOCK, BLOCK), dtype=dense.dtype)
    rows, slots = np.nonzero(sk.valid)
    cols = sk.cols[rows, slots]
    data[rows, slots] = dense[rows, :, cols, :]
    return data


def ell_to_dense_torch(data, sk: Skeleton):
    """Densification of a ``torch`` block tensor on its own device."""
    import torch

    N, S = sk.cols.shape
    rows, slots = np.nonzero(sk.valid)
    cols = sk.cols[rows, slots]
    dev = data.device
    rows_t = torch.as_tensor(rows, device=dev)
    slots_t = torch.as_tensor(slots, device=dev)
    cols_t = torch.as_tensor(cols.astype(np.int64), device=dev)
    dense = torch.zeros((N, BLOCK, N, BLOCK), dtype=data.dtype, device=dev)
    dense[rows_t, :, cols_t, :] = data[rows_t, slots_t]
    return dense.reshape(sk.matrix_dim, sk.matrix_dim)


def hermiticity_error(data, sk: Skeleton):
    """Max-abs deviation from Hermiticity, reduced on the tensor's device.

    The block at ``(i, s)`` (column ``j``) must equal the conjugate
    transpose of the block at ``(j, trans_slot[s])``.  Padding slots hold
    zeros on both sides and contribute nothing.  This is the vectorized
    analog of the reference's post-assembly check
    (``bodge/hamiltonian.py:120-122``).  Returns a 0-d tensor; the caller
    moves it to the host once.
    """
    import torch

    safe_cols = sk.device_safe_cols(data.device)
    trans = sk.trans_slot if sk.trans_slot.ndim == 2 else sk.trans_slot[None, :]
    trans_t = torch.as_tensor(trans.astype(np.int64), device=data.device)
    mirror = data[safe_cols, trans_t]  # [N, S, 4, 4]
    mirror = mirror.transpose(-1, -2).conj()
    diff = (data - mirror).abs() * sk.device_valid(data.device)[..., None, None]
    return diff.max()
