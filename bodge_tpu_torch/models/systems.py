"""Premade physical systems (vectorized assembly recipes).

The reference's tutorial and benchmark build these systems with hand-written
``with``-loops; here they are packaged as batched recipes on the fast
assembly path, serving both as a model zoo and as executable documentation
of the vectorized API.  Conventions follow the reference throughout
(e.g. the S/F bilayer with phase winding is the reference's benchmark
system, ``misc/benchmark.py:91-130``).

Every recipe takes ``dtype=None, device=None`` and hands them to
:class:`~bodge_tpu_torch.hamiltonian.Hamiltonian`: the system lives on the
CUDA device unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..common import jσ2, σ0, σ1, σ2, σ3
from ..hamiltonian import Hamiltonian
from ..lattice import CubicLattice, HoneycombLattice
from .order_parameters import dwave, pwave


def _bond_mask(ci, cj):
    """True for nearest-neighbor displacements (excludes periodic wraps)."""
    return (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]


def swave_superconductor(
    shape: Tuple[int, int, int],
    t: float = 1.0,
    mu: float = 0.5,
    delta: float | Callable = 0.3,
    zeeman: Optional[np.ndarray] = None,
    dtype=None,
    device=None,
) -> Hamiltonian:
    """Homogeneous (or profiled) s-wave superconductor with optional Zeeman.

    ``delta`` may be a scalar or a callable ``Δ(ci) -> [N]`` for an
    inhomogeneous gap; ``zeeman`` is a length-3 field vector m·σ.
    """
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice, dtype=dtype, device=device)

    m = np.zeros(3) if zeeman is None else np.asarray(zeeman, dtype=float)
    h_on = -mu * σ0 - (m[0] * σ1 + m[1] * σ2 + m[2] * σ3)

    def pairing_onsite(ci):
        Δi = delta(ci) if callable(delta) else np.full(len(ci), delta, dtype=complex)
        return np.asarray(Δi, dtype=complex)[:, None, None] * jσ2

    system.assemble(
        onsite=lambda ci: h_on,
        pairing_onsite=pairing_onsite,
        hopping=lambda ci, cj: np.where(_bond_mask(ci, cj), -t * σ0, 0),
    )
    return system


def graphene_swave(
    shape: Tuple[int, int, int],
    t: float = 1.0,
    mu: float = 0.3,
    delta: float = 0.1,
    dtype=None,
    device=None,
) -> Hamiltonian:
    """Graphene with on-site s-wave pairing induced by proximity, as a zigzag ribbon.

    ``shape = (Lx, Ly, 1)`` gives an Lx×Ly brick wall (:class:`HoneycombLattice`:
    Ly zigzag chains of Lx sites, open boundaries).  h_ii = −μσ0, Δ_ii = Δ jσ2,
    and the nearest-neighbour hopping −tσ0 on every bond the lattice lists
    (Castro Neto et al., Rev. Mod. Phys. 81, 109 (2009)).  The skeleton is
    generic, so the KPM sweeps take the windowed gather kernels.
    """
    Lx, Ly, Lz = shape
    if Lz != 1:
        raise ValueError(f"a graphene ribbon is flat: shape (Lx, Ly, 1), got {shape}")
    system = Hamiltonian(HoneycombLattice(Lx, Ly), dtype=dtype, device=device)
    system.assemble(
        onsite=lambda ci: -mu * σ0,
        pairing_onsite=lambda ci: delta * jσ2,
        hopping=lambda ci, cj: -t * σ0,
    )
    return system


def sf_bilayer(
    L: int,
    W: int,
    t: float = 1.0,
    mu: float = -3.0,
    m0: float = 1.5,
    delta0: float = 0.1,
    winding: float = 0.5,
    dtype=None,
    device=None,
) -> Hamiltonian:
    """The reference's benchmark system: superconductor/ferromagnet bilayer
    on an L×W square lattice with superconducting phase winding along x and
    anisotropic hopping (−t along x, −2t along y)."""
    lattice = CubicLattice((L, W, 1))
    system = Hamiltonian(lattice, dtype=dtype, device=device)

    def onsite(ci):
        sc = (ci[:, 0] < L // 2)[:, None, None]
        return np.where(sc, -mu * σ0, -mu * σ0 - m0 * σ3)

    def pairing_onsite(ci):
        sc = (ci[:, 0] < L // 2)[:, None, None]
        phase = np.exp(1j * winding * ci[:, 0] / L)[:, None, None]
        return np.where(sc, -delta0 * phase * jσ2, 0)

    def hopping(ci, cj):
        bond = _bond_mask(ci, cj)
        along_y = (ci[:, 1] != cj[:, 1])[:, None, None]
        return np.where(bond, np.where(along_y, -2 * t * σ0, -t * σ0), 0)

    system.assemble(onsite=onsite, pairing_onsite=pairing_onsite, hopping=hopping)
    return system


def rashba_dp_wave(
    shape: Tuple[int, int, int] = (64, 64, 4),
    t: float = 1.0,
    mu: float = 0.5,
    alpha: float = 0.4,
    delta_d: float = 0.3,
    delta_p: float = 0.2,
    dvector: str = "e_z * p_x",
    profile: Optional[Callable] = None,
    dtype=None,
    device=None,
) -> Hamiltonian:
    """3D lattice with Rashba spin-orbit coupling and mixed d-wave + p-wave
    pairing with an (optionally) inhomogeneous amplitude Δ(i).

    The Rashba term adds iα(σ×d̂)·ẑ = iα(σ1·d̂_y − σ2·d̂_x) to each
    nearest-neighbor hop along displacement d̂ — Hermitian because the term
    is odd under d̂ → −d̂.  ``profile(mid) -> [B]`` scales the pairing by
    position (midpoint of the bond), e.g. for domain walls or vortices.
    """
    lattice = CubicLattice(shape)
    system = Hamiltonian(lattice, dtype=dtype, device=device)
    σ_d = dwave()
    σ_p = pwave(dvector)

    def hopping(ci, cj):
        bond = _bond_mask(ci, cj)
        d = np.sign(cj - ci).astype(float)
        rashba = 1j * alpha * (d[:, 1, None, None] * σ1 - d[:, 0, None, None] * σ2)
        return np.where(bond, -t * σ0 + rashba, 0)

    def pairing(ci, cj):
        bond = _bond_mask(ci, cj)
        amp = profile((ci + cj) / 2) if profile is not None else np.ones(len(ci))
        Δij = delta_d * σ_d(ci, cj) + delta_p * σ_p(ci, cj)
        return np.where(bond, amp[:, None, None] * Δij, 0)

    system.assemble(
        onsite=lambda ci: -mu * σ0,
        hopping=hopping,
        pairing=pairing,
    )
    return system


def josephson_junction(
    L: int = 128,
    phase: float = 0.0,
    t: float = 1.0,
    delta0: float = 3.0,
    leads: int = 32,
    dtype=None,
    device=None,
) -> Hamiltonian:
    """1D S/N/S Josephson junction with phase difference across the leads
    (the reference's minigap test system, tests/test_physics.py analog)."""
    lattice = CubicLattice((L, 1, 1))
    system = Hamiltonian(lattice, dtype=dtype, device=device)

    def pairing_onsite(ci):
        x = ci[:, 0]
        left = (x < leads)[:, None, None]
        right = (x >= L - leads)[:, None, None]
        φl = np.exp(-1j * phase / 2)
        φr = np.exp(+1j * phase / 2)
        return -delta0 * (left * φl + right * φr) * jσ2

    system.assemble(
        onsite=lambda ci: 0 * σ0,
        pairing_onsite=pairing_onsite,
        hopping=lambda ci, cj: np.where(_bond_mask(ci, cj), -t * σ0, 0),
    )
    return system
