"""s-wave superconductor on a cubic lattice: the 2x2 terms of the plain reference.

h_ii = -mu s0,  D_ii = delta j s2 (j s2 = [[0, 1], [-1, 0]]),  h_ij = -t s0 on bonds,
no bond pairing. Parameters: ``t``, ``mu``, ``delta`` (a real or complex number).
"""

import numpy as np

S0 = np.eye(2, dtype=np.complex128)
JS2 = np.array([[0, 1], [-1, 0]], dtype=np.complex128)


def onsite(c, p):
    return -p["mu"] * S0


def pairing_onsite(c, p):
    return p["delta"] * JS2


def hopping(ci, cj, p):
    return -p["t"] * S0


def pairing(ci, cj, p):
    return None
