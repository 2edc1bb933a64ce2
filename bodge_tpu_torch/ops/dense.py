"""Dense spectral solvers: diagonalization, free energy, exact-resolvent LDOS.

The counterpart of ``bodge_tpu/ops/dense.py`` on ``torch.linalg`` (a library
call there, a library call here):

- :func:`eigh_positive`: ``torch.linalg.eigh`` + positive-spectrum
  extraction.  By particle-hole symmetry the BdG spectrum comes in ±ε pairs,
  so the ascending upper half *is* the positive subset
  (reference ``bodge/hamiltonian.py:228-230``).
- :func:`free_energy_from_spectrum`: F = U − T·S with U = −½Σε and
  S = Σ log(1+e^(−ε/T)) over positive ε (``bodge/hamiltonian.py:305-319``,
  Appendix C of Ouassou et al. PRB 109, 174506).
- :func:`ldos_exact`: the exact diagonal resolvent evaluated spectrally,
  G_αα(ε+iΓ) = Σ_n |X_{iα,n}|² / (ε+iΓ−E_n) — the same observable as the
  reference's sparse-LU solve (``bodge/hamiltonian.py:323-387``).  ρ(+ε)
  comes from the electron components and ρ(−ε) from the hole components at
  the same positive ε.

Everything runs on the device and in the precision of the tensor it is
given: complex128 on the CPU, the operator's dtype on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .blocksparse import BLOCK


def eigh_positive(H):
    """Eigenvalues/vectors of Hermitian ``H``, restricted to the upper half.

    Returns ``(E, X)`` with E ascending, ``X[:, n]`` the eigenvector of
    ``E[n]``; exactly ``dim/2`` pairs are returned (Nambu doubling).
    """
    E, X = torch.linalg.eigh(H)
    half = H.shape[-1] // 2
    return E[half:], X[:, half:]


def free_energy_from_spectrum(E_pos, temperature: float):
    """Landau free energy from the positive BdG spectrum (a 0-d tensor;
    differentiable in ``E_pos``)."""
    T = float(temperature)
    if T < 0:
        raise ValueError("Expected non-negative temperature!")
    E_pos = torch.as_tensor(E_pos)
    U = -0.5 * E_pos.sum()
    if T == 0:
        return U
    S = torch.log1p(torch.exp(-E_pos / T)).sum()
    return U - T * S


def _resolvent_ldos(E, w_e, w_h, energies, gammas):
    """ρ(±ε_n) from spectral weights at one site.

    Args:
        E: full spectrum ``[4N]``.
        w_e / w_h: electron / hole weights ``[4N]`` at the probed site
            (|X|² summed over spin).
        energies: positive probe energies ``[M]``.
        gammas: Lorentzian broadenings ``[M]``.

    Returns:
        ``(ρ_plus, ρ_minus)`` each ``[M]``.
    """
    z = torch.complex(energies, gammas)[:, None]  # [M, 1]
    denom = z - E[None, :]  # [M, 4N]
    G_e = (w_e[None, :] / denom).sum(dim=1)
    G_h = (w_h[None, :] / denom).sum(dim=1)
    return -G_e.imag / math.pi, -G_h.imag / math.pi


def ldos_from_spectrum(E, X, site_index: int, energies) -> np.ndarray:
    """LDOS at one site from a precomputed full eigendecomposition.

    Mirrors the reference's observable and broadening convention: probe
    energies are deduplicated by |ε| and the broadening is the grid spacing
    Γ = gradient(ε) (``bodge/hamiltonian.py:349-352``).
    """
    energies = np.array(energies, dtype=float)
    ε = np.unique(np.abs(energies))
    Γ = np.gradient(ε)

    i0 = BLOCK * site_index
    amp2 = X[i0 : i0 + BLOCK, :].abs() ** 2  # [4, 4N]
    w_e = amp2[0] + amp2[1]
    w_h = amp2[2] + amp2[3]

    def on_device(a):
        return torch.as_tensor(a).to(device=E.device, dtype=E.dtype)

    ρ_plus, ρ_minus = _resolvent_ldos(E, w_e, w_h, on_device(ε), on_device(Γ))
    ρ_plus = ρ_plus.double().cpu().numpy()
    ρ_minus = ρ_minus.double().cpu().numpy()

    table = {}
    for k, ε_k in enumerate(ε):
        table[+ε_k] = ρ_plus[k]
        table[-ε_k] = ρ_minus[k]
    return np.array([table[ε_k] for ε_k in energies])


def ldos_exact(H_dense, site_index: int, energies) -> np.ndarray:
    """Local density of states at one site, exact to numerical precision."""
    E, X = torch.linalg.eigh(H_dense)
    return ldos_from_spectrum(E, X, site_index, energies)
