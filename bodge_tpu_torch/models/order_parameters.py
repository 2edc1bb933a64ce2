"""Physics-model helpers: superconducting order parameters and deformations.

Parity targets (``bodge/hamiltonian.py:390-531``):

- :func:`swave`   — constant singlet structure jσ2.
- :func:`pwave`   — triplet order from a d-vector expression string.
- :func:`dwave`   — d_{x²−y²} singlet structure.
- :func:`ssd`     — sine-squared deformation profile.

All returned callables are *batched-native*: they accept either plain
coordinate tuples (scalar use, as in the reference) or ``[..., 3]`` NumPy
arrays of coordinates, returning ``[..., 2, 2]`` spin-structure matrices.
That makes them directly usable both inside the reference-style ``with``
assembly DSL and in the vectorized device-side assembly path.

The reference builds the p-wave D matrix by ``eval``-ing the d-vector string
against basis row/column vectors (``bodge/hamiltonian.py:427-446``).  We
reproduce the identical grammar (e_x/e_y/e_z, p_x/p_y/p_z, j-prefixed
imaginary versions, +, −, *, parentheses, numeric literals) with an
AST-whitelist evaluator instead of raw ``eval``.
"""

from __future__ import annotations

import ast
from typing import Callable

import numpy as np

from ..common import Coord, jσ2, σ


def swave() -> Callable:
    """Spin structure for (extended) s-wave singlet pairing: σ_s(...) = jσ2.

    Use as ``Δ[i, i] = Δ_s * σ_s(i, i)`` (on-site) or
    ``Δ[i, j] = Δ_s * σ_s(i, j)`` (extended s-wave on bonds).
    """

    def σ_s(*_args):
        return jσ2

    return σ_s


# -- d-vector expression grammar -------------------------------------------
_PWAVE_SYMBOLS = {}
for _k, _vec in (("x", [1, 0, 0]), ("y", [0, 1, 0]), ("z", [0, 0, 1])):
    _col = np.array(_vec, dtype=np.complex128).reshape(3, 1)
    _PWAVE_SYMBOLS[f"e_{_k}"] = _col
    _PWAVE_SYMBOLS[f"je_{_k}"] = 1j * _col
    _PWAVE_SYMBOLS[f"p_{_k}"] = _col.T
    _PWAVE_SYMBOLS[f"jp_{_k}"] = 1j * _col.T

_ALLOWED_BINOPS = {ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.matmul}
_ALLOWED_UNARY = {ast.UAdd: lambda v: v, ast.USub: np.negative}


def _eval_dvector(expr: str) -> np.ndarray:
    """Safely evaluate a d-vector expression to its 3×3 D matrix."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.BinOp) and type(node.op) in _ALLOWED_BINOPS:
            lhs, rhs = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Mult):
                # Scalar multiplication must not become matmul.
                if np.isscalar(lhs) or np.isscalar(rhs):
                    return np.multiply(lhs, rhs)
            return _ALLOWED_BINOPS[type(node.op)](lhs, rhs)
        if isinstance(node, ast.UnaryOp) and type(node.op) in _ALLOWED_UNARY:
            return _ALLOWED_UNARY[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Name) and node.id in _PWAVE_SYMBOLS:
            return _PWAVE_SYMBOLS[node.id]
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float, complex)):
            return node.value
        raise ValueError(f"Unsupported token in d-vector expression: {ast.dump(node)}")

    D = ev(ast.parse(expr, mode="eval"))
    D = np.asarray(D, dtype=np.complex128)
    if D.shape != (3, 3):
        raise ValueError(
            f"d-vector expression {expr!r} did not produce a 3×3 matrix "
            "(combine a spin basis vector e_* with a momentum basis vector p_*)"
        )
    return D


def pwave(dvector: str) -> Callable:
    """Triplet p-wave pairing structure from a d-vector expression.

    ``σ_p = pwave("e_z * p_x")`` returns a function σ_p(i, j) of two
    nearest-neighbor sites with Δ(p) = [d(p)·σ] jσ2, guaranteeing the
    antisymmetry σ_p(i, j) = −σ_p(j, i).  Algorithm per Sec. II-B of
    Ouassou et al. PRB 109, 174506 (2024).
    """
    D = _eval_dvector(dvector)

    # Precompute Δ_p = ½ D'σ jσ2 so that σ_p(i, j) = Δ_p · (j − i).
    Δp = np.einsum("kp,kab,bc->pac", D, σ, jσ2) / 2

    def σ_p(i, j):
        δ = np.subtract(j, i)
        return np.einsum("pab,...p->...ab", Δp, δ.astype(np.complex128))

    return σ_p


def dwave() -> Callable:
    """Singlet d_{x²−y²} pairing structure on a (presumed square) lattice.

    σ_d(i, j) = ((δx² − δy²)/|δ|²) jσ2 for the displacement δ = j − i;
    zero on-site, along z, and on diagonals.
    """

    def σ_d(i, j):
        δ = np.subtract(j, i).astype(np.float64)
        norm2 = np.sum(δ**2, axis=-1) + 1e-16
        amp = (δ[..., 0] ** 2 - δ[..., 1] ** 2) / norm2
        return amp[..., None, None] * jσ2

    return σ_d


def ssd(system) -> Callable:
    """Sine-squared deformation profile for a Hamiltonian on a cubic lattice.

    ``φ = ssd(system)`` returns φ(i, j) ∈ [0, 1] to be multiplied onto every
    Hamiltonian term: φ(i, i) for on-site terms and φ(i, j) for bonds.  The
    profile is ½(1 + cos(π r / (R + ½))) with r the distance of the bond
    midpoint from the lattice center and R the center-to-corner distance —
    identical to the reference (``bodge/hamiltonian.py:512-529``; Hodt et
    al. PRB 107, 224427).
    """
    shape = np.asarray(system.lattice.shape, dtype=np.float64)
    center = (shape - 1) / 2
    R = float(np.linalg.norm(center))

    def φ(i, j):
        mid = (np.asarray(i, dtype=np.float64) + np.asarray(j, dtype=np.float64)) / 2
        r = np.linalg.norm(mid - center, axis=-1)
        return 0.5 * (1 + np.cos(np.pi * r / (R + 0.5)))

    return φ
