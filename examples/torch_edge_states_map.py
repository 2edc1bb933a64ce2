#!/usr/bin/env python
"""Zero-energy LDOS map of a pₓ-wave superconductor: topological edge modes.

The PyTorch/CUDA counterpart of ``examples/edge_states_map.py``.  Builds a 2D
pₓ-wave superconductor and computes the zero-energy local density of states
across the whole lattice in ONE batched KPM sweep (every site's orbitals ride
the same Chebyshev sweep as extra probe columns of the fused-step kernel).
Flat-band Majorana edge modes appear on the two x-normal edges.

    python examples/torch_edge_states_map.py                # on the card
    python examples/torch_edge_states_map.py --device cpu   # plain PyTorch on the CPU

The last line of output is one JSON object with the result.
"""

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or a CUDA device (default: the card)")
    ap.add_argument("--size", type=int, default=24, help="lattice edge L (an L×L sheet)")
    ap.add_argument("--order", type=int, default=512)
    args = ap.parse_args(argv)

    from bodge_tpu_torch import CubicLattice, Hamiltonian, pwave, σ0

    L = args.size
    lattice = CubicLattice((L, L, 1))
    system = Hamiltonian(lattice, device=args.device)
    σp = pwave("e_z * p_x")
    t, Δ0 = 1.0, 0.3

    bond = lambda ci, cj: (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]
    system.assemble(
        onsite=lambda ci: 0.0 * σ0,
        hopping=lambda ci, cj: np.where(bond(ci, cj), -t * σ0, 0),
        pairing=lambda ci, cj: np.where(bond(ci, cj), -Δ0 * σp(ci, cj), 0),
    )

    sites = [(x, y, 0) for x in range(L) for y in range(L)]
    ρ0 = system.ldos_map(sites, [0.0], method="kpm", order=args.order)[:, 0]
    grid = ρ0.reshape(L, L)

    # ASCII heat map: darker = higher zero-energy LDOS.
    shades = " .:-=+*#%@"
    lo, hi = grid.min(), grid.max()
    for row in grid:
        print("".join(shades[int((v - lo) / (hi - lo + 1e-12) * (len(shades) - 1))] for v in row))

    edge = float(grid[[0, -1], :].mean())
    bulk = float(grid[L // 4: 3 * L // 4, L // 4: 3 * L // 4].mean())
    ratio = edge / max(bulk, 1e-12)
    print(json.dumps({"example": "torch_edge_states_map", "device": str(system.device), "L": L,
                      "order": args.order, "edge_ldos": edge, "bulk_ldos": bulk, "edge_over_bulk": ratio}))
    if not edge > 3 * bulk:
        sys.exit(f"no edge modes: edge {edge} against bulk {bulk}")


if __name__ == "__main__":
    main()
