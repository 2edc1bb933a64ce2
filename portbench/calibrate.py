"""Readings that the correctness limits of a cell are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --controls 3 --first-seed <n>

On the chip, at the cell's own size, in one process (set-up once): for each of
``--seeds`` seeds the first call of the cell's traffic through the program and its
comparison with the float64 reference; then for ``--controls`` of those seeds the
control in the program's place and the same comparison. The control is the nearest
precision below the configuration's complex64: where the program has such a path of
its own (``ldos_map(operator_dtype="bf16")``) that path, else the reference with its
operator rounded to bfloat16 and computed in complex64. One JSON line a reading, and
a last line with the largest program reading and the smallest control reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def bf16_operator(A):
    """``A`` with the real and imaginary part of every entry rounded to bfloat16."""
    import torch

    v = A.values().clone()
    r = torch.complex(v.real.to(torch.bfloat16).to(v.real.dtype), v.imag.to(torch.bfloat16).to(v.real.dtype))
    return torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(), r, A.shape, check_invariants=False)


def control_readings(cell, program, seed, device):
    """The control's readings for ``seed``, named as the cell's checks."""
    import torch

    from portbench.harness.record import Call

    if cell.mix["driver"] == "ldos_map":
        driver = cell.driver.Driver(program, cell.config, cell.mix, seed, operator_dtype="bf16")
        units, work, output = driver.call(0)
        return driver.compare([Call(0.0, 0.0, units, work, output)], device)
    driver = cell.driver.Driver(program, cell.config, cell.mix, seed)
    V, delta0 = driver.coupling(0), driver.delta
    exact = driver.reference(device)
    x_ref = driver.replay(exact, V, delta0)
    bf16 = lambda x: float(torch.tensor(x).to(torch.bfloat16))
    low = driver.reference(device, torch.complex64, (bf16_operator, bf16))
    x_low = driver.replay(low, V, delta0)
    F_low = low(V, x_low)[0]
    F_ref = exact(V, x_low)[0]
    return {"delta_gap": abs(x_low - x_ref) / abs(x_ref), "F_gap": abs(F_low - F_ref) / abs(F_ref)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as harness

    harness.use_checkout_caches()
    from portbench.harness import loader, system
    from portbench.harness.record import Call

    cell = loader.cell(args.workload, ROOT)
    program = system.build(cell.config, args.device)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    highest, lowest = {}, {}
    for seed in seeds:
        t = time.perf_counter()
        driver = cell.driver.Driver(program, cell.config, cell.mix, seed)
        units, work, output = driver.call(0)
        values = driver.compare([Call(0.0, 0.0, units, work, output)], args.device)
        print(json.dumps({"side": "program", "seed": seed, **values, "seconds": time.perf_counter() - t}), flush=True)
        for k, v in values.items():
            highest[k] = max(highest.get(k, 0.0), v)
    for seed in seeds[:args.controls]:
        t = time.perf_counter()
        values = control_readings(cell, program, seed, args.device)
        print(json.dumps({"side": "control", "seed": seed, **values, "seconds": time.perf_counter() - t}), flush=True)
        for k, v in values.items():
            lowest[k] = min(lowest.get(k, float("inf")), v)
    print(json.dumps({"cell": cell.name, "program_highest": highest, "control_lowest": lowest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
