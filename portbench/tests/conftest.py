"""CPU tests of the benchmark: tiny cells on the program's plain (CPU) paths.

Run from the root of a checkout: ``python -m pytest portbench/tests -q``.
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "swave_1000x1000": {"shape": [16, 16, 1]},
    "rashba_dp_64x64x4": {"shape": [12, 8, 2], "wall": 6},
}


def shrink(cell):
    """``cell`` at a size a CPU test holds: a small lattice, rows of 4 sites, short sweeps."""
    cell.config = copy.deepcopy(cell.config)
    small = SMALL[cell.workload["config"]]
    cell.config["shape"] = small["shape"]
    if "wall" in small:
        cell.config["feature"]["at"] = small["wall"]
        cell.config["params"]["profile"]["center"] = small["wall"]
    if cell.mix["driver"] == "ldos_map":
        cell.mix = {**cell.mix, "order": 128, "row": {**cell.mix["row"], "length": 4}}
    else:
        cell.mix = {**cell.mix, "order": 64, "steps": 5}
    return cell


@pytest.fixture
def small_cell():
    from portbench.harness import loader

    return lambda name: shrink(loader.cell(name, ROOT))
