"""Physics-model layer: order parameters and lattice deformations."""

from .order_parameters import dwave, pwave, ssd, swave

__all__ = ["swave", "pwave", "dwave", "ssd"]
