#!/usr/bin/env python
"""Generic (user-defined) lattices on the card's kernels.

The PyTorch/CUDA counterpart of ``examples/generic_lattice.py``.  Any
:class:`bodge_tpu_torch.Lattice` subclass — not just ``CubicLattice`` — runs
on hand-written kernels: the windowed gather kernels
(``bodge_tpu_torch/ops/cuda_gather.py``) relabel the sites by reverse
Cuthill–McKee and keep a sliding window of vector rows in shared memory.
They are chosen by default for a generic skeleton on the card (``impl=None``;
``impl="cuda_gather"`` asks for them by name).

Here: a ring with a twist defect — a graph no cubic stencil describes —
assembled through the reference-style ``with`` DSL and probed via KPM LDOS.

    python examples/torch_generic_lattice.py                # on the card
    python examples/torch_generic_lattice.py --device cpu   # plain PyTorch on the CPU

The last line of output is one JSON object with the result.
"""

import argparse
import json
import sys

import numpy as np

from bodge_tpu_torch import Hamiltonian, Lattice, jσ2, σ0


class TwistedRing(Lattice):
    """Ring of n sites with one long-range chord (a twist defect)."""

    def __init__(self, n, chord_at=0, chord_span=None):
        super().__init__((n, 1, 1))
        self.chord = (chord_at, (chord_at + (chord_span or n // 3)) % n)

    def index(self, coord):
        x = coord[0]
        if not (0 <= x < self.shape[0]) or coord[1] or coord[2]:
            raise ValueError(f"Coordinate {coord} out of bounds")
        return x

    def sites(self):
        for x in range(self.shape[0]):
            yield (x, 0, 0)

    def bonds(self):
        n = self.shape[0]
        for x in range(n - 1):
            yield (x, 0, 0), (x + 1, 0, 0)
            yield (x + 1, 0, 0), (x, 0, 0)
        a, b = self.chord
        yield (a, 0, 0), (b, 0, 0)
        yield (b, 0, 0), (a, 0, 0)

    def edges(self):
        n = self.shape[0]
        yield (0, 0, 0), (n - 1, 0, 0)
        yield (n - 1, 0, 0), (0, 0, 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or a CUDA device (default: the card)")
    ap.add_argument("--sites", type=int, default=240)
    ap.add_argument("--order", type=int, default=1024)
    args = ap.parse_args(argv)

    from bodge_tpu_torch.ops import chebyshev as kpm
    from bodge_tpu_torch.ops.cuda_spmm import launch_counts, resolve_path

    n = args.sites
    lattice = TwistedRing(n)
    system = Hamiltonian(lattice, device=args.device)
    with system as (H, Δ):
        for i in lattice.sites():
            H[i, i] = -0.5 * σ0
            Δ[i, i] = 0.3 * jσ2
        for i, j in lattice.bonds():
            H[i, j] = -1.0 * σ0
        for i, j in lattice.edges():
            H[i, j] = -1.0 * σ0

    sk = system.skeleton
    if sk.stencil:
        sys.exit("a generic graph should give a generic skeleton")
    path = resolve_path(None, system.data, sk, 4)  # the step the LDOS sweep runs

    energies = np.linspace(-1.5, 1.5, 61)
    before = launch_counts()["ell_gather_cheb_step"]
    ρ = kpm.ldos_kpm(system.data, sk, n // 2, energies, order=args.order)
    gather_steps = launch_counts()["ell_gather_cheb_step"] - before
    inside = float(ρ[np.abs(energies) < 0.2].mean())
    outside = float(ρ[np.abs(energies) > 0.5].mean())
    print(f"in-gap LDOS : {inside:.4f}")
    print(f"band LDOS   : {outside:.4f}")
    print(f"gap contrast: {outside / max(inside, 1e-6):.0f}x  (s-wave gap resolved through the {path} step)")
    print(json.dumps({"example": "torch_generic_lattice", "device": str(system.device), "sites": n,
                      "order": args.order, "path": path, "gather_step_launches": gather_steps,
                      "in_gap_ldos": inside, "band_ldos": outside, "contrast": outside / max(inside, 1e-6)}))
    if not outside > 10 * inside:
        sys.exit(f"no gap resolved: in-gap {inside} against band {outside}")


if __name__ == "__main__":
    main()
