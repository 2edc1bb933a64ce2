"""The graphene ribbon's plain reference against the program's CPU path on a small
brick wall, and the graphene cell run whole on the CPU."""

import copy
import functools
import subprocess
import sys
import time
import types

import numpy as np
import torch

from portbench import run
from portbench.harness import loader, system
from portbench.reference import bdg, kpm

from conftest import ROOT

CELL = "graphene_zz_4096x256.ldos_map"
SEED = 2**31 + 5


def small(shape=(16, 8, 1), dtype="complex128"):
    """The cell at a size a CPU test holds: a small ribbon, rows of 4 sites, short sweeps."""
    cell = loader.cell(CELL, ROOT)
    cell.config = {**copy.deepcopy(cell.config), "shape": list(shape), "dtype": dtype}
    cell.mix = {**cell.mix, "order": 128, "row": {**cell.mix["row"], "length": 4}}
    return cell


def test_operator_matches_program():
    config = small().config
    ours = bdg.csr(config, "cpu").to_dense().numpy()
    program = system.build(config, "cpu")
    assert not program.skeleton.stencil and program.skeleton.n_slots == 4
    np.testing.assert_allclose(ours, program.matrix("dense"), rtol=0, atol=1e-14)
    # the zero y-bonds are no entries: each site keeps its honeycomb neighbours' blocks only
    count = bdg.nonzeros_per_site(config)
    assert count.sum() == np.count_nonzero(program.matrix("dense"))


def test_ldos_matches_program():
    """Both float64: the gap is the summation order of the same sums (1e-10)."""
    config = small((20, 6, 1)).config
    n, shape = 120, tuple(config["shape"])
    program = system.build(config, "cpu")
    A = bdg.csr(config, "cpu")
    a = kpm.spectral_bound(lambda v: torch.mm(A, v), n, "cpu")
    sites, energies = [(5, 2, 0), (6, 2, 0), (7, 3, 0)], np.linspace(-1, 1, 9)
    theirs = program.ldos_map(sites, energies, method="kpm", order=96)
    ours = kpm.ldos(A, n, [int(np.ravel_multi_index(s, shape)) for s in sites], energies, 96, a)
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=1e-12)


def correct(cell) -> bool:
    r, checks, failed = run.execute(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    return run.result(cell, r, checks, failed)["correct"]


def test_the_cell_is_correct_and_its_control_is_not():
    cell = small((32, 16, 1), "complex64")
    assert correct(cell)
    cell.driver = types.SimpleNamespace(Driver=functools.partial(cell.driver.Driver, operator_dtype="bf16"))
    assert not correct(cell)


def test_new_pieces_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "import portbench.reference.bdg as b\n"
            "from portbench.harness.loader import load_module\n"
            "b.model('graphene_swave')\n"
            "load_module(Path(%r) / 'portbench/drivers/free_energy.py', 'free_energy_driver')\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'bodge_tpu_torch', 'bodge_tpu', 'jax'})\n"
            "print(bad); sys.exit(1 if bad else 0)") % (str(ROOT), str(ROOT))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
