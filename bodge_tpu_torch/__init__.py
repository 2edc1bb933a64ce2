"""
bodge_tpu_torch: the PyTorch / CUDA port of ``bodge_tpu``.

Real-space Bogoliubov-de Gennes Hamiltonians in Lattice⊗Nambu⊗Spin space as
padded block-ELL tensors, with coordinate-addressed assembly (automatic
particle-hole/Hermitian symmetry fill), matrix export, block-sparse SpMM and
the Chebyshev/KPM observables (LDOS, DOS, free energy) driven by hand-written
CUDA kernels.  The package imports ``torch``, ``numpy`` and ``scipy`` only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the default dtype is complex64 on the card and complex128
on the CPU.  The public names are those of ``bodge_tpu``.
"""

from .common import (
    Coord,
    Coords,
    Index,
    Indices,
    jsigma,
    jsigma0,
    jsigma1,
    jsigma2,
    jsigma3,
    jσ,
    jσ0,
    jσ1,
    jσ2,
    jσ3,
    pi,
    sigma,
    sigma0,
    sigma1,
    sigma2,
    sigma3,
    π,
    σ,
    σ0,
    σ1,
    σ2,
    σ3,
)
from .hamiltonian import Hamiltonian
from .lattice import CubicLattice, Lattice
from .models.order_parameters import dwave, pwave, ssd, swave

__version__ = "0.1.0"
__all__ = [
    # Core library (parity with bodge).
    "Lattice",
    "CubicLattice",
    "Hamiltonian",
    "Coord",
    "Coords",
    "Index",
    "Indices",
    # Helper functions.
    "ssd",
    "swave",
    "pwave",
    "dwave",
    # Constants.
    "π",
    "σ",
    "σ0",
    "σ1",
    "σ2",
    "σ3",
    "jσ",
    "jσ0",
    "jσ1",
    "jσ2",
    "jσ3",
    # ASCII alternatives.
    "pi",
    "sigma",
    "sigma0",
    "sigma1",
    "sigma2",
    "sigma3",
    "jsigma",
    "jsigma0",
    "jsigma1",
    "jsigma2",
    "jsigma3",
]
