"""Rashba spin-orbit coupling with mixed d- plus p-wave bond pairing on a cubic
lattice: the 2x2 terms of the plain reference.

With the bond displacement d = j - i (a unit vector) and the Pauli matrices s1, s2,
s3 (j s2 = i s2 = [[0, 1], [-1, 0]]):

- h_ii = -mu s0, no on-site pairing;
- h_ij = -t s0 + i alpha (d_y s1 - d_x s2)  (the Rashba term (s x d) . z);
- D_ij = A(m) [delta_d (d_x^2 - d_y^2) j s2 + delta_p (1/2) sum_k D[k, p] d_p s_k j s2],
  the d_{x^2-y^2} singlet and the triplet of the d-vector "e_a * p_b" (D[a, b] = 1),
  scaled by the profile A at the bond midpoint m = (i + j) / 2.

Parameters: ``t``, ``mu``, ``alpha``, ``delta_d``, ``delta_p``, ``dvector`` of the
form ``"e_a * p_b"``, and an optional ``profile`` ``{"kind": "tanh", "axis": 0,
"center": c, "width": w}`` for A(m) = tanh((m_axis - c) / w).
"""

import re

import numpy as np

S0 = np.eye(2, dtype=np.complex128)
S1 = np.array([[0, 1], [1, 0]], dtype=np.complex128)
S2 = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
S3 = np.array([[1, 0], [0, -1]], dtype=np.complex128)
JS2 = 1j * S2
AXES = {"x": 0, "y": 1, "z": 2}


def _profile(mid, p):
    prof = p.get("profile")
    if prof is None:
        return np.ones(len(mid))
    if prof["kind"] != "tanh":
        raise ValueError(f"unknown profile kind {prof['kind']!r}")
    return np.tanh((mid[:, prof["axis"]] - prof["center"]) / prof["width"])


def _dvector(expr):
    m = re.fullmatch(r"\s*e_([xyz])\s*\*\s*p_([xyz])\s*", expr)
    if m is None:
        raise ValueError(f"the reference reads d-vectors of the form 'e_a * p_b', not {expr!r}")
    D = np.zeros((3, 3))
    D[AXES[m.group(1)], AXES[m.group(2)]] = 1.0
    return D


def onsite(c, p):
    return -p["mu"] * S0


def pairing_onsite(c, p):
    return None


def hopping(ci, cj, p):
    d = (cj - ci).astype(float)
    rashba = 1j * p["alpha"] * (d[:, 1, None, None] * S1 - d[:, 0, None, None] * S2)
    return -p["t"] * S0 + rashba


def pairing(ci, cj, p):
    d = (cj - ci).astype(float)
    amp = _profile((ci + cj) / 2.0, p)
    singlet = (d[:, 0] ** 2 - d[:, 1] ** 2)[:, None, None] * JS2
    sigma = np.stack([S1, S2, S3])
    spin = np.einsum("kp,np->nk", _dvector(p["dvector"]), d)  # d-vector component k of this bond
    triplet = 0.5 * np.einsum("nk,kab,bc->nac", spin, sigma, JS2)
    return amp[:, None, None] * (p["delta_d"] * singlet + p["delta_p"] * triplet)
