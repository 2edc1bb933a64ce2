"""No module the benchmark loads has the top-level name of JAX or of the JAX package."""

import json
import subprocess
import sys
import types

from conftest import ROOT

LOAD_ALL = """
import json, sys
sys.path.insert(0, %(root)r)
sys.argv = ["run.py"]
import portbench.run as run
run.use_checkout_caches()
from portbench import calibrate, yardstick
from portbench.harness import devtrace, loader, record, system
from portbench.reference import bdg, kpm
bench = json.load(open(%(root)r + "/BENCHMARK.json"))
for w in bench["workloads"]:
    cell = loader.cell(w["name"], run.ROOT)
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m)
for s in ("swave_superconductor", "rashba_dp_wave"):
    bdg.model(s)
import bodge_tpu_torch, bodge_tpu_torch.models.systems, bodge_tpu_torch.models.selfconsistency
import bodge_tpu_torch.ops.cuda_spmm, bodge_tpu_torch.ops.chebyshev, torch.profiler
print(json.dumps(run.forbidden_modules()))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    done = subprocess.run([sys.executable, "-c", LOAD_ALL % {"root": str(ROOT)}], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "bodge_tpu_torch_extra", types.ModuleType("bodge_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "bodge_tpu.ops", types.ModuleType("bodge_tpu.ops"))
    assert run.forbidden_modules() == ["bodge_tpu", "jax"]


def test_without_a_card_a_run_fails_and_prints_nothing():
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "rashba_dp_64x64x4.ldos_map",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          timeout=300, cwd=ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0 and done.stdout.strip() == ""
