"""Run one cell of the benchmark of bodge_tpu_torch once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the cell asks
for. Set-up (imports, the CUDA context, the kernels' build on a checkout's first
run, the assembly, a warm-up call of the cell's own shapes) runs first; then the
cell's driver calls the program in a closed loop until the first call that ends
after ``--seconds``. With ``--trace 1`` that window runs under ``torch.profiler``
and the cell's per-layer metrics are reported instead of its end-to-end ones.
After the window the program's state is freed and its outputs are judged against
the float64 reference. The last line of standard output is the result as one JSON
object; the numbers judged, each beside its limit, are the last lines of standard
error and the ``checks`` of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "bodge_tpu"}


def use_checkout_caches():
    """Every build and kernel cache of the program at a fixed path in the checkout."""
    build = ROOT / "build"
    os.environ["BODGE_TORCH_BUILD_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its kin's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def launch_counts() -> dict:
    from bodge_tpu_torch.ops.cuda_spmm import launch_counts as counts

    return counts()


def execute(cell, seed: int, seconds: float, traced: bool, device, t_start: float):
    """Set up, run the window and judge the outputs; returns ``(run, checks, failed)``."""
    import torch

    from portbench.harness import devtrace, system
    from portbench.harness.record import Call, Run

    run = Run(cell, traced)
    t = time.perf_counter()
    program = system.build(cell.config, device)
    synchronize(device)
    run.spans["assemble_s"] = time.perf_counter() - t
    driver = cell.driver.Driver(program, cell.config, cell.mix, seed)
    driver.warm_up()
    synchronize(device)
    run.setup_s = time.perf_counter() - t_start

    before = launch_counts()
    prof = devtrace.start() if traced else None
    span = f"portbench.{cell.mix['driver']}"
    failed, i = 0, 0
    t_window = time.perf_counter()
    while True:
        with torch.profiler.record_function(span) if traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            try:
                units, work, output = driver.call(i)
            except Exception:  # a failed call counts against the attempted ones; the loop goes on
                traceback.print_exc(file=sys.stderr)
                failed, units, work, output = failed + 1, 0, [], None
            t1 = time.perf_counter()
        run.calls.append(Call(t0, t1, units, work, output))
        i += 1
        if t1 - t_window >= seconds:
            break
    run.window_s = t1 - t_window
    after = launch_counts()
    run.launches = {k: after[k] - before[k] for k in after}
    if traced:
        run.trace = devtrace.finish(prof)
    if torch.device(device).type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated())

    driver.release()
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = driver.compare(run.calls, device)
    print(f"portbench: set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s ({len(run.calls)} calls), "
          f"check {time.perf_counter() - t:.3f} s", file=sys.stderr)
    checks = {name: {"value": v, "limit": cell.limits[name]} for name, v in values.items()}
    return run, checks, failed


def result(cell, run, checks: dict, failed: int) -> dict:
    metrics = {}
    for metric in cell.metrics(run.traced):
        value = cell.reader(metric).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": len(run.calls), "failed": failed, "metrics": metrics}


def device_info(cell, run) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.workload["chips"],
            "memory_peak_bytes": run.peak_bytes}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                               capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit_w"] = float(limit)
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
    return info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    use_checkout_caches()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import loader

    cell = loader.cell(args.workload, ROOT)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {cell.name} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    run, checks, failed = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    out = result(cell, run, checks, failed)
    out["device"] = device_info(cell, run)
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = checks

    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; it may load none of {sorted(FORBIDDEN)}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        verdict = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}): {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
