"""Lattice geometry layer.

Parity target: ``bodge/lattice.py`` — an abstract ``Lattice`` contract
(sites/bonds/edges traversal, coord→index mapping) with one concrete
``CubicLattice``.  Semantics preserved:

- ``index`` is row-major with z fastest: ``z + y·Lz + x·Ly·Lz``
  (reference: ``bodge/lattice.py:108``), with bounds checking.
- ``bonds(axis)`` yields every nearest-neighbor pair in *both* directions;
  ``bonds()`` traverses axis 2, then 1, then 0 (reference order).
- ``edges(axis)`` yields wrap-around pairs on opposite faces, both
  directions, for periodic boundary conditions.
- ``__iter__`` yields on-site pairs, then bonds, then edges.

Vectorized additions: every concrete lattice also exposes *vectorized*
NumPy index/coordinate arrays (``site_coords``, ``bond_arrays``,
``edge_arrays``, ``index_array``) so that Hamiltonian assembly can be a
handful of batched array ops instead of a Python-level loop over sites —
the reference's own hot spot (SURVEY §3.1).
"""

from __future__ import annotations

from functools import cached_property
from typing import Iterator, Optional

import numpy as np

from .common import Coord, Coords, Index, typecheck


class Lattice:
    """Abstract traversal contract for an atomic lattice (1D/2D/3D).

    Subclasses must implement ``index``, ``sites``, ``bonds`` and ``edges``.
    The class is deliberately graph-like: sites are nodes, bonds are
    nearest-neighbor links, and edges are opposite-boundary pairs used to
    realize periodic boundary conditions.  (Reference contract:
    ``bodge/lattice.py:4-84``.)
    """

    @typecheck
    def __init__(self, shape: Coord):
        if self.__class__ is Lattice:
            raise ValueError("Lattice is an abstract base class; instantiate a subclass.")

        self.shape: Coord = shape
        self.size: Index = int(np.prod(shape))
        self.dim: int = sum(1 for extent in shape if extent > 1)

    # -- Syntactic sugar ---------------------------------------------------
    def __getitem__(self, coord: Coord) -> Index:
        return self.index(coord)

    def __iter__(self) -> Iterator[Coords]:
        for site in self.sites():
            yield (site, site)
        yield from self.bonds()
        yield from self.edges()

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}{self.shape}"

    # -- Abstract traversal ------------------------------------------------
    def index(self, coord: Coord) -> Index:
        """Map a 3D site coordinate to its flat index."""
        raise NotImplementedError

    def sites(self) -> Iterator[Coord]:
        """Yield every site coordinate in index order."""
        raise NotImplementedError

    def bonds(self) -> Iterator[Coords]:
        """Yield every nearest-neighbor pair (i, j), both directions."""
        raise NotImplementedError

    def edges(self) -> Iterator[Coords]:
        """Yield opposite-boundary pairs (i, j) for periodic BCs."""
        raise NotImplementedError


class CubicLattice(Lattice):
    """Primitive cubic lattice (also covers chains and square lattices).

    ``CubicLattice((Lx, Ly, Lz))`` models an Lx×Ly×Lz lattice; set trailing
    extents to 1 for lower dimensions, e.g. ``CubicLattice((30, 30, 1))``
    for a 30×30 square lattice.  Matches ``bodge/lattice.py:87-197``.
    """

    # -- Scalar API (reference parity) ------------------------------------
    @typecheck
    def index(self, coord: Coord) -> Index:
        x, y, z = coord
        Lx, Ly, Lz = self.shape
        if not (0 <= x < Lx and 0 <= y < Ly and 0 <= z < Lz):
            raise ValueError(f"Coordinate {coord} out of bounds")
        return z + Lz * (y + Ly * x)

    def sites(self) -> Iterator[Coord]:
        Lx, Ly, Lz = self.shape
        for x in range(Lx):
            for y in range(Ly):
                for z in range(Lz):
                    yield (x, y, z)

    @typecheck
    def bonds(self, axis: Optional[int] = None) -> Iterator[Coords]:
        """Nearest-neighbor pairs, both directions.

        With ``axis`` given, restrict to links along that axis; with
        ``axis=None`` traverse z-bonds, then y-bonds, then x-bonds (the
        reference's order, ``bodge/lattice.py:131-136``).
        """
        Lx, Ly, Lz = self.shape
        if axis is None:
            yield from self.bonds(axis=2)
            yield from self.bonds(axis=1)
            yield from self.bonds(axis=0)
            return
        if axis not in (0, 1, 2):
            raise ValueError("No such axis")

        step = [0, 0, 0]
        step[axis] = 1
        ranges = [range(Lx), range(Ly), range(Lz)]
        ranges[axis] = range(self.shape[axis] - 1)
        for x in ranges[0]:
            for y in ranges[1]:
                for z in ranges[2]:
                    a = (x, y, z)
                    b = (x + step[0], y + step[1], z + step[2])
                    yield a, b
                    yield b, a

    @typecheck
    def edges(self, axis: Optional[int] = None) -> Iterator[Coords]:
        """Opposite-face pairs for periodic BCs, both directions.

        With ``axis=None`` traverse z-edges, then y-edges, then x-edges
        (reference order, ``bodge/lattice.py:173-177``).
        """
        Lx, Ly, Lz = self.shape
        if axis is None:
            yield from self.edges(axis=2)
            yield from self.edges(axis=1)
            yield from self.edges(axis=0)
            return
        if axis not in (0, 1, 2):
            raise ValueError("No such axis")

        last = self.shape[axis] - 1
        ranges = [range(Lx), range(Ly), range(Lz)]
        ranges[axis] = range(1)
        for x in ranges[0]:
            for y in ranges[1]:
                for z in ranges[2]:
                    lo = [x, y, z]
                    hi = list(lo)
                    hi[axis] = last
                    yield tuple(lo), tuple(hi)
                    yield tuple(hi), tuple(lo)

    # -- Vectorized API ----------------------------------------------------
    @cached_property
    def site_coords(self) -> np.ndarray:
        """``[N, 3]`` int32 coordinates of every site, in index order."""
        Lx, Ly, Lz = self.shape
        x, y, z = np.meshgrid(
            np.arange(Lx, dtype=np.int32),
            np.arange(Ly, dtype=np.int32),
            np.arange(Lz, dtype=np.int32),
            indexing="ij",
        )
        return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    def index_array(self, coords: np.ndarray) -> np.ndarray:
        """Vectorized coord→index map for an ``[..., 3]`` coordinate array."""
        coords = np.asarray(coords)
        Lx, Ly, Lz = self.shape
        if np.any(coords < 0) or np.any(coords >= np.array(self.shape)):
            raise ValueError("Coordinate out of bounds")
        return coords[..., 2] + Lz * (coords[..., 1] + Ly * coords[..., 0])

    def bond_arrays(self, axis: Optional[int] = None):
        """Directed bond pairs as a ``([B, 3], [B, 3])`` coordinate-array pair.

        Covers the same pairs as :meth:`bonds` (both directions), in a
        vectorized layout suitable for batched assembly.
        """
        if axis is None:
            pairs = [self.bond_arrays(a) for a in (2, 1, 0)]
            src = np.concatenate([p[0] for p in pairs])
            dst = np.concatenate([p[1] for p in pairs])
            return src, dst
        if axis not in (0, 1, 2):
            raise ValueError("No such axis")

        coords = self.site_coords
        keep = coords[:, axis] < self.shape[axis] - 1
        lo = coords[keep]
        hi = lo.copy()
        hi[:, axis] += 1
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        return src, dst

    def edge_arrays(self, axis: Optional[int] = None):
        """Directed opposite-face pairs as ``([E, 3], [E, 3])`` arrays."""
        if axis is None:
            pairs = [self.edge_arrays(a) for a in (2, 1, 0)]
            src = np.concatenate([p[0] for p in pairs])
            dst = np.concatenate([p[1] for p in pairs])
            return src, dst
        if axis not in (0, 1, 2):
            raise ValueError("No such axis")

        coords = self.site_coords
        keep = coords[:, axis] == 0
        lo = coords[keep]
        hi = lo.copy()
        hi[:, axis] = self.shape[axis] - 1
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        return src, dst
