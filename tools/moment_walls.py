"""Walls of the KPM calls whose moment sweeps fit one launch, on the package of a
given checkout.

The three calls are those of ``chip_smoke.py``'s phase ``main`` at the sizes
where a sweep's steps are launch-bound: on ``rashba_dp_wave((64,64,4))``
(N = 16384, S = 7) ``free_energy(T=0.01, method="kpm", order=256, samples=8)``
(K = 8) and ``ldos((32,32,2), order=512)`` (K = 4), and on
``swave_superconductor((200,200,1))`` (N = 40000, S = 5)
``ldos((100,100,0), order=512)`` (K = 4); each computes its own spectral bound
(60 power iterations), as the phase's calls do.  Beside each call the bound
alone (``spectral_bound`` on the same operator) is measured the same way, so
a wall splits into the bound and the rest (the moment sweep and host work).
Run it on a machine with one NVIDIA card and ``nvcc``, once per checkout, in
turns, on the same card::

    python3 tools/moment_walls.py --root <checkout> --tag parent --out walls.jsonl

``--root`` is the checkout whose ``bodge_tpu_torch`` is imported (its kernels
built into its own ``build/``).  Each call runs once to warm up, then
``--reps`` times (5), each wall on the host clock between two
``torch.cuda.synchronize()``; one JSON line per call gives the walls, their
least, and the launches one call made (``launch_counts``, the kernels it
launched only), and the same three for its bound alone (``bound_*``),
appended to ``--out`` and printed, after a line with the card's name and
power limit.
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
    ap.add_argument("--tag", default="", help="label written into each line")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="JSON lines appended here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("moment_walls: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from bodge_tpu_torch.models.systems import rashba_dp_wave, swave_superconductor
    from bodge_tpu_torch.ops import cuda_spmm as ck
    from bodge_tpu_torch.ops.chebyshev import spectral_bound

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    energies = np.linspace(-1.0, 1.0, 41)
    rashba = rashba_dp_wave((64, 64, 4))
    square = swave_superconductor((200, 200, 1))
    calls = {  # label: (the call, its operator)
        "rashba 64x64x4: free_energy(T=0.01, order=256, samples=8)":
            (lambda: rashba.free_energy(0.01, method="kpm", order=256, samples=8), rashba),
        "rashba 64x64x4: ldos((32,32,2), order=512)":
            (lambda: rashba.ldos((32, 32, 2), energies, method="kpm", order=512), rashba),
        "200x200: ldos((100,100,0), order=512)":
            (lambda: square.ldos((100, 100, 0), energies, method="kpm", order=512), square),
    }

    def measure(fn):
        """(least wall, walls, launches of one call) of ``fn`` after a warm-up."""
        fn()
        torch.cuda.synchronize()
        before = ck.launch_counts()
        fn()
        torch.cuda.synchronize()
        after = ck.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return min(walls), walls, launched

    lines = []
    for label, (fn, system) in calls.items():
        least, walls, launched = measure(fn)
        b_least, b_walls, b_launched = measure(lambda: spectral_bound(system.data, system.skeleton))
        lines.append({"tool": "moment_walls", "tag": args.tag, "root": args.root, "nvidia_smi": smi,
                      "call": label, "wall_s_least": least, "walls_s": walls, "launches": launched,
                      "bound_wall_s_least": b_least, "bound_walls_s": b_walls, "bound_launches": b_launched})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
