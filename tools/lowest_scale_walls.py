"""Walls of one lowest-states run at scales a rounding apart, on the package of a
given checkout.

The run is ``chip_smoke.py``'s phase ``lowest`` call on the 100×100 s-wave
lattice with six magnetic impurities, ``lowest_eigenstates(nev=10,
max_iter=10, max_order=8192)``.  Its filter adapts its orders and block widths
to what it sees, so a spectral bound that moves by a rounding may send it down
another path.  This script runs the call with ``scale=`` set to the bound of
the per-step power iteration (one ``ell_spmm`` launch, a norm and a division a
step, from ``spectral_bound``'s seed-0 start vector), to ``spectral_bound``'s
own result (one ``ell_power_iteration`` launch where its plan fits), and to
that result moved by ±2⁻²⁰ of itself, and prints for each the wall, the
iterations, orders and block widths, ``info["seconds"]`` and the eigenvalues'
largest distance from the first run's.  Run it on a machine with one NVIDIA
card and ``nvcc``::

    python3 tools/lowest_scale_walls.py --root <checkout> --out scales.jsonl

``--root`` is the checkout whose ``bodge_tpu_torch`` is imported (its kernels
built into its own ``build/``).  One JSON line per run, after a line with the
card's name and power limit; appended to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose bodge_tpu_torch is imported")
    ap.add_argument("--out", default=None, help="JSON lines appended here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lowest_scale_walls: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from bodge_tpu_torch import CubicLattice, Hamiltonian, jσ2, σ0, σ3
    from bodge_tpu_torch.ops import cuda_spmm as ck
    from bodge_tpu_torch.ops import lanczos as lz
    from bodge_tpu_torch.ops.blocksparse import BLOCK
    from bodge_tpu_torch.ops.chebyshev import spectral_bound

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)

    # chip_smoke.py's with_impurities(100, [1.2, 1.5, 1.8, 2.2, 2.7, 3.3])
    L, couplings = 100, [1.2, 1.5, 1.8, 2.2, 2.7, 3.3]
    system = Hamiltonian(CubicLattice((L, L, 1)), device="cuda")
    spots = np.random.default_rng(5).integers(L // 8, L - L // 8, size=(len(couplings), 2))

    def onsite(ci):
        m = np.zeros(len(ci))
        for (x, y), j in zip(spots, couplings):
            m[(ci[:, 0] == x) & (ci[:, 1] == y)] = j
        return -0.5 * σ0 - m[:, None, None] * σ3

    system.assemble(
        onsite=onsite, pairing_onsite=lambda ci: 0.3 * jσ2,
        hopping=lambda ci, cj: np.where((np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0),
    )
    data, sk = system.data, system.skeleton
    shape = (sk.n_sites, BLOCK, 1)
    rng = np.random.default_rng(0)  # spectral_bound's start vector at seed 0
    v = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).to("cuda", torch.complex64)
    per_step = float(ck.power_recursion(lambda w: ck.ell_spmm(data, sk, w), v, 60)) * 1.05
    bound = spectral_bound(data, sk)
    scales = {"per-step bound": per_step, "spectral_bound": bound,
              "spectral_bound * (1 + 2^-20)": bound * (1 + 2.0 ** -20),
              "spectral_bound * (1 - 2^-20)": bound * (1 - 2.0 ** -20)}
    lines, first = [], None
    for label, scale in scales.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E, _, info = lz.lowest_eigenstates(data, sk, 10, max_iter=10, max_order=8192, scale=scale,
                                           full_output=True)
        wall = time.perf_counter() - t0
        first = E if first is None else first
        lines.append({"tool": "lowest_scale_walls", "root": args.root, "nvidia_smi": smi, "scale_of": label,
                      "scale": scale, "rel_to_spectral_bound": scale / bound - 1.0, "wall_s": wall,
                      "iterations": info["iterations"], "converged": bool(info["converged"]),
                      "orders": [h[1] for h in info["history"]], "blocks": [h[4] for h in info["history"]],
                      "seconds": info["seconds"], "E_max_abs_from_first": float(np.abs(E - first).max())})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
