"""Graphene with on-site s-wave pairing, as a zigzag ribbon: the 2x2 terms of the plain reference.

The honeycomb is drawn as a brick wall in the box's coordinates (Lz = 1): every
x-bond is a hop, and a y-bond between (x, y) and (x, y + 1) is a hop only where
x + y is even; the other y-bonds carry zero. That graph is the honeycomb's, with
zigzag edges at y = 0 and y = Ly - 1 (Castro Neto et al., RMP 81, 109 (2009)).

h_ii = -mu s0,  D_ii = delta j s2 (j s2 = [[0, 1], [-1, 0]]),  h_ij = -t s0 on the
honeycomb's bonds, zero on the missing y-bonds, no bond pairing. Parameters:
``t``, ``mu``, ``delta``.
"""

import numpy as np

S0 = np.eye(2, dtype=np.complex128)
JS2 = np.array([[0, 1], [-1, 0]], dtype=np.complex128)


def onsite(c, p):
    return -p["mu"] * S0


def pairing_onsite(c, p):
    return p["delta"] * JS2


def hopping(ci, cj, p):
    lower = np.minimum(ci, cj)  # of a y-bond, the site with the smaller y
    along_y = ci[:, 1] != cj[:, 1]
    bond = ~along_y | ((lower[:, 0] + lower[:, 1]) % 2 == 0)
    return np.where(bond[:, None, None], -p["t"] * S0, 0)


def pairing(ci, cj, p):
    return None
