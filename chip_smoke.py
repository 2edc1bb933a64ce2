#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``bodge_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``bodge_tpu_torch/csrc`` into ``build/``,
holds each kernel against its plain PyTorch version on the card, drives eight
paths through the normal entry points at full size — the KPM observables
(assemble → block SpMM → fused Chebyshev step → free energy / LDOS / LDOS map
/ DOS / apply, on 1000×1000 sites; free energy and LDOS on
``rashba_dp_wave((64,64,4))`` and LDOS on a 200×200 s-wave, each sweep one
cooperative launch of ``ell_cheb_moments`` and each spectral bound one of
``ell_power_iteration``), the differentiable path (``solve_gap``
on 512×512 sites at order 512: the fused step forward, the adjoint-product
and block-outer-product kernels backward, with a dense control on the card),
a generic lattice (a user-defined sheet with a hole, about 2.5·10⁵ sites,
assembled, saved, loaded and evaluated through the windowed gather kernels),
the tiled step (``impl="cuda_tiled"`` at 1000×1000 and 64×64×4) and the
lowest-states solver (``diagonalize(method="lanczos")`` at 32×32 against three
exact solvers; at 100×100 with magnetic impurities against shift-invert, and
with a uniform Zeeman field, bounded, against ``eigvalsh`` on the card; each
filter application one cooperative launch of ``ell_cheb_filter``, each bound
one of ``ell_power_iteration``), the
row-sharded path (the halo kernels on x-slabs of the 1000×1000 operator;
the sharded KPM entry points and ``solve_gap(impl="cuda_sharded")`` in a
world of one over NCCL, the gradient with √steps checkpointing on and off;
four gloo ranks sharing the card, spawned after the build) and bf16 operator
storage (``operator_dtype="bf16"`` through the KPM entry points, the gather
and tiled steps, a sharded world of one and the lowest-states solver: the
seven bf16 instantiations of the forward kernels) and the planar entry points
(``BODGE_PLANAR=1`` through the façade via ``device_operator()``, bit for bit
against the complex calls with the same launches) — checks them against
complex128 at small sizes, and exits non-zero if any phase fails.  Beside the
card it holds the native host tier (``bodge_tpu_torch.native``, built with
``g++``) against the ``torch`` path on CPU tensors, and runs the four examples
of ``examples/torch_*.py`` as a user would.  Every line of output is one JSON object except the
``nvidia-smi`` lines; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it fails at once.  ``--quick`` stops after the small
kernel checks (for a first look at a new kernel) and prints no result line;
``--phases main,widths,grad,gap,dwave,generic,tiled,lowest,bf16,sharded,native,planar,examples,window``
runs only the named phases (and prints no result line unless all ran); ``--profile`` adds a
``torch.profiler`` table of one gradient to the ``gap`` phase; ``--log PATH``
also writes the JSON records of the run to ``PATH``.

Phases: device, build, kernels (small awkward shapes); ``main``: the KPM path
at full size (launch counters read here, the moment and power kernels' launches
following their plans), its kernels at its shapes (times, bounds, library
yardstick; the moment kernel a step beside the per-step path and the
graph-replayed step; the power kernel a step beside the per-step bound's
iteration, host loop and graph-replayed, and ``ell_spmm`` at K = 1), and the
path checked against complex128;
``widths``: the forward kernels at the other probe widths the entry points
use; ``grad``: gradients through the kernels against autograd through the
plain complex128 product; ``gap``: ``solve_gap`` at full width (launch
counters read here), its dense control, and all four kernels at its shape;
``dwave``: one d-wave gradient at order 1024; ``generic``: the generic-lattice
path (launch counters read here), the gather kernels at its shape and widths
beside the general kernels in natural and relabelled order, variants of their
plan, one gradient against complex128; ``tiled``:
``free_energy(impl="cuda_tiled")`` against the untiled call (launch counters
read here) and the tiled step timed at N = 10⁶ beside ``ell_cheb_step`` at
K = 1, 8, 64, with variants of its plan; ``lowest``: the lowest-states solver
(launch counters read here, held to each run's history: one ``ell_cheb_filter``
launch an application, Σ(order − 1) steps, and one ``ell_power_iteration`` launch
a bound), and its kernels against their plain versions and timed on each run's
operator at the block widths the run took (the power kernel as in ``main``; the
filter kernel in both modes at orders 256 and 4096, beside ``ell_cheb_step``
replayed from a CUDA graph and the per-step path it replaced); ``bf16``: the
entry points with ``operator_dtype="bf16"`` beside the float32 calls (launch
counters read here: the bf16 instantiations, and of the float32 forward
kernels only the spectral bounds' products), the drift of each observable,
and the bf16 instantiations timed beside their float32 forms (the bf16 gather
pair, in the cluster form of its plan, also beside ``ell_spmm_bf16`` /
``ell_cheb_step_bf16`` on the same relabelled operator, with its plan, and
its step's partials repeated bit for bit); ``native``:
host assembly and gate at 10⁶ sites and the mirror search of the generic sheet,
each against the ``torch`` / NumPy path (bit-equal, both walls, the host's CPU
model); ``planar``: the planar façade calls at 1000×1000 (launch counters read
here), the conversion's time and memory, the planar dense spectra at 16×16, a
planar operator through the sharded free energy, and the sharded ``solve_gap``
at 512² against the field write before the packed inserts; ``examples``: the
four example scripts as subprocesses, each ending in its JSON result line;
``window``: the two light-cone steps (``ell_cheb_step_window``,
``ell_gather_cheb_step_window``) at 10⁶ sites and K = 64 on three window widths
against the whole-lattice steps (bit-equal on the window, zero outside, the
partial sums to rounding), each form timed in µs per 1000 rows.  The LDOS
calls of ``main`` and ``generic`` take the light-cone step while their
probes' cone grows, and their launch counters say so.
The small kernel checks hold the filter and moment kernels in both modes and both
operator forms, and the power kernel in both modes (also at the lattices of the
main path's bounds), against their plain versions and the per-step kernels, and the bf16
instantiations too, on the bf16 form of
every small operator (the gather pair on the bf16 operator's plans: the
cluster form at the planned and forced tiles and stage counts, near 227 KB
and at 48-56 KB of shared memory), and the light-cone steps on the middle
half of each small operator's rows against the whole-lattice steps.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = None  # the card's published memory rate, set in main (bodge_tpu_torch.utils.profiling)
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
# The bounded lowest-states run on the uniform 100×100 lattice (phase `lowest`).
UNIFORM_MAX_ITER, UNIFORM_MAX_ORDER = 12, 16384  # about a minute on one H100; 8 / 8192 leaves the eigenvalues 3.7e-3 off

_LOG = []


def emit(record: dict) -> None:
    line = json.dumps(record)
    _LOG.append(line)
    print(line, flush=True)


def fail(message: str) -> None:
    emit({"ok": False, "error": message})
    sys.exit(1)


def check(condition: bool, message: str) -> None:
    if not condition:
        fail(message)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "unknown, unknown"


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_rank(rank: int, world: int, port: int, backend: str, task: dict, queue) -> None:
    """One rank of a process group on the one card (phase ``sharded``).

    With ``task["expect_refusal"]`` it checks only what ``make_row_mesh`` says
    of the group.  Otherwise it runs the four-rank side of the comparisons:
    the free energy at 1000×1000 (250 planes a rank), moments on the rows
    mesh and on a 2×2 rows × probes mesh, and the value and gradient of each
    objective in ``task["objectives"]``; rank 0 puts the results on ``queue``.
    An exception ends the process with a non-zero exit code, which the
    parent reads."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bodge_tpu_torch import CubicLattice, Hamiltonian, σ0
    from bodge_tpu_torch.models import selfconsistency as sc
    from bodge_tpu_torch.models.systems import swave_superconductor
    from bodge_tpu_torch.ops import cuda_spmm as ck
    from bodge_tpu_torch.parallel import (RowSharding, free_energy_kpm_sharded_cuda, initialize_multihost,
                                          make_row_mesh, moments_sharded_cuda)

    torch.cuda.set_device(0)
    check(initialize_multihost(f"localhost:{port}", world, rank, backend=backend), "no process group")
    try:
        if task.get("expect_refusal"):
            try:
                make_row_mesh()
                refused = None
            except ValueError as e:
                refused = str(e)
            queue.put((rank, {"refused": refused}))
            return
        out = {}
        mesh = make_row_mesh()
        big = swave_superconductor((1000, 1000, 1))
        sk = big.skeleton
        rs = RowSharding(sk, mesh)
        data_l = rs.shard_data(big.data)
        rs2 = RowSharding(sk, make_row_mesh(probe_shards=2))
        data_2d = rs2.shard_data(big.data)
        del big
        torch.cuda.synchronize()
        dist.barrier()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        F = free_energy_kpm_sharded_cuda(rs, data_l, 0.01, task["scale"], order=256, samples=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["free_energy"] = {"F": F, "wall_s": wall, "planes": rs.slab.planes, "launches": ck.launch_counts(),
                              **rs.stats}
        z = np.asarray(task["probes"])
        out["mu_rows"] = moments_sharded_cuda(rs, data_l, z, 64, task["scale"]).cpu().numpy()
        out["mu_2d"] = moments_sharded_cuda(rs2, data_2d, z, 64, task["scale"]).cpu().numpy()
        del data_l, data_2d
        for name, (shape, kw, field) in task["objectives"].items():
            metal = Hamiltonian(CubicLattice(shape), device="cuda")
            metal.assemble(onsite=lambda ci: 0.0 * σ0, check=False, hopping=lambda ci, cj: np.where(
                (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0))
            F_total = sc.make_total_free_energy(metal, impl="cuda_sharded", mesh=mesh, **kw)
            x = torch.as_tensor(field, device="cuda").requires_grad_(True)
            rs.stats.update(exchanges=0, exchange_s=0.0, staging_s=0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = F_total(x.to(torch.complex64))
            (grad,) = torch.autograd.grad(value, x)
            torch.cuda.synchronize()
            out[name] = {"F": float(value.detach()), "grad": grad.cpu().numpy(),
                         "wall_s": time.perf_counter() - t0}
            del metal, F_total
        if rank == 0:
            queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, backend: str, task: dict, timeout: float) -> dict:
    """Spawn ``world`` ranks of :func:`sharded_rank` on the one card and wait
    for them: ``{rank: result}``.  Fails if a rank exits with a non-zero code
    or the results do not come within ``timeout`` seconds."""
    import queue as queue_module

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=sharded_rank, args=(r, world, port, backend, task, results))
             for r in range(world)]
    for proc in procs:
        proc.start()
    want = world if task.get("expect_refusal") else 1
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < want:
            try:
                rank, out = results.get(timeout=5.0)
                got[rank] = out
            except queue_module.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    break
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world and len(got) == want,
          f"{world} {backend} ranks ended with exit codes {codes} and {len(got)} of {want} results")
    return got


def main(argv) -> int:
    quick = "--quick" in argv
    profile = "--profile" in argv
    log_path = argv[argv.index("--log") + 1] if "--log" in argv else None
    all_phases = ("main", "widths", "grad", "gap", "dwave", "generic", "tiled", "lowest", "bf16", "sharded",
                  "native", "planar", "examples", "window")
    phases = tuple(argv[argv.index("--phases") + 1].split(",")) if "--phases" in argv else all_phases
    if not set(phases) <= set(all_phases):
        print(f"chip_smoke: unknown phase in {phases} (known: {all_phases})", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from bodge_tpu_torch import CubicLattice, Hamiltonian, Lattice, jσ2, σ0, σ2, σ3
    from bodge_tpu_torch.models import selfconsistency as sc
    from bodge_tpu_torch.models.systems import rashba_dp_wave, swave_superconductor
    from bodge_tpu_torch.ops import _build
    from bodge_tpu_torch.ops import blocksparse as bs
    from bodge_tpu_torch.ops import chebyshev as kpm
    from bodge_tpu_torch.ops import cuda_ell as ce
    from bodge_tpu_torch.ops import cuda_filter as cf
    from bodge_tpu_torch.ops import cuda_gather as cg
    from bodge_tpu_torch.ops import cuda_probes as cp
    from bodge_tpu_torch.ops import cuda_spmm as ck
    from bodge_tpu_torch.ops import lanczos as lz
    from bodge_tpu_torch.ops.blocksparse import BLOCK
    from bodge_tpu_torch.ops.spmm import chebyshev_step_bytes, spmm_bytes, spmm_flops
    from bodge_tpu_torch.parallel import cuda_sharded as cs
    from bodge_tpu_torch.utils import profiling
    from bodge_tpu_torch.utils.trace import annotate, trace

    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S = profiling.hbm_roof_for_device(0)

    dev = torch.device("cuda")
    c64, c128 = torch.complex64, torch.complex128

    def counts(**launched) -> dict:
        """Launch counts of every kernel (and the filter kernels' steps), zero where not named."""
        return {**dict.fromkeys(ck.launch_counts(), 0), **launched}

    def launched_since(before: dict) -> dict:
        after = ck.launch_counts()
        return {k: after[k] - before[k] for k in after}

    def timed_ms(fn, reps: int) -> float:
        """Mean device time of ``fn`` over ``reps`` launches (CUDA events), after a warm-up."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, launches: int = 200) -> float:
        """Device ms of one call of ``fn``: ``launches`` calls captured in one CUDA
        graph, replayed three times between CUDA events, the least replay over
        ``launches``.  The kernels' own time, without the host's launch rate.  A
        measurement only: the port launches no graph."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm-up outside the capture (cached column tables, the library)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        best = math.inf
        for _ in range(3):
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / launches)
        del graph
        return best

    def cone_steps(data, sk, sites, K, order) -> int:
        """Light-cone launches of an LDOS sweep from ``sites`` (flat indices):
        one a fused step while its probes' cone (``StepPlan.light_cone``) is
        not yet the whole lattice; the sweep's other steps run on all of it."""
        cone = ck.StepPlan(sk, K, None, data).light_cone(data, sites)
        return 0 if cone is None else sum(cone.rows(m) is not None for m in range(1, ce.sweep_launches(order) + 1))

    # ------------------------------------------------------------------ 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    copy_bytes_per_s = profiling.measure_hbm_bandwidth(1 << 30, reps=10)  # 1 GiB each way, beyond the L2 cache
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "copy_GBps_measured": copy_bytes_per_s / 1e9, "datasheet_GBps": HBM_BYTES_PER_S / 1e9,
    })

    # ------------------------------------------------------------------ 2. build
    built = _build.build_all(verbose=True)
    ptxas = [l for log in built["log"].values() for l in log.splitlines()
             if "registers" in l or "spill" in l]
    registers, entry = {}, None  # registers of each kernel instantiation, by its mangled name
    for line in (l for log in built["log"].values() for l in log.splitlines()):
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry is not None and "Used" in line and "registers" in line:
            registers[entry] = int(line.split("Used")[1].split()[0])
            entry = None
    emit({"phase": "build", "seconds": built["seconds"], "sources": built["built"],
          "nvcc": _build.find_nvcc(), "ptxas": ptxas, "registers": registers})

    # ------------------------------------------------------------------ 3a. kernels, small shapes
    def random_system(shape, seed, pbc=True):
        """Random Hermitian 2x2 spin blocks on every slot: periodic wrap blocks
        included, or (``pbc=False``) zero as on an open lattice."""
        system = Hamiltonian(CubicLattice(shape), dtype=np.complex64, device=dev)
        rng = np.random.default_rng(seed)
        σ1 = np.array([[0, 1], [1, 0]])

        def herm2(n):
            c = rng.normal(size=(4, n, 1, 1))
            return c[0] * σ0 + c[1] * σ1 + c[2] * σ2 + c[3] * σ3

        def bond(ci, cj):
            return 1.0 if pbc else (np.abs(ci - cj).max(axis=1) == 1)[:, None, None]

        system.assemble(
            onsite=lambda ci: herm2(len(ci)),
            pairing_onsite=lambda ci: herm2(len(ci)) @ jσ2,
            hopping=lambda ci, cj: herm2(len(ci)) * bond(ci, cj),
            pairing=lambda ci, cj: herm2(len(ci)) * bond(ci, cj),
            check=False,
        )
        return system.data, system.skeleton

    def random_vector(N, K, seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn((N, 4, K), dtype=c64, generator=g).to(dev)

    # Tolerances.  y / t_next: atol = rtol = 2e-4 against the complex64 plain
    # version — float32 sums of up to 7*4 products in another order (the
    # tolerance the Pallas kernels are held to).  Reduced partials: 1e-4
    # against the plain version in complex128, relative to the largest of the
    # 2K sums — each is a float32 sum over all 4N entries, and <t_next,t_cur>
    # may cancel, so its error scales with the terms, not with the result.
    def window_agrees(window, plain_window, whole_next, N):
        """A light-cone step ``window(rows)`` on rows [N/4, N − N/4) against the
        whole-lattice step's ``whole_next`` (bit-equal there), zero elsewhere
        (its buffer comes zeroed), and its partial sums against the plain
        version's in complex128 (1e-4 of the largest, as the whole step's)."""
        rows = (N // 4, N - N // 4)
        t_n, pp = window(rows)
        torch.cuda.synchronize()
        _, pp_want = plain_window(rows)
        sums, want = pp.double().sum(dim=0), pp_want[0]
        rel = float((sums - want).abs().max() / want.abs().max())
        as_bits = lambda t: torch.view_as_real(t).view(torch.int32)
        r0, r1 = rows
        ok = (torch.equal(as_bits(t_n[r0:r1]), as_bits(whole_next[r0:r1])) and not bool((t_n[:r0] != 0).any())
              and not bool((t_n[r1:] != 0).any()) and rel <= 1e-4)
        return ok, rel

    def compare(data, sk, K, seed):
        N = sk.n_sites
        t_cur, t_prev = random_vector(N, K, seed), random_vector(N, K, seed + 1)
        inv = 0.125
        y = ce.ell_spmm(data, sk, t_cur)
        torch.cuda.synchronize()
        y_ref = ce.ell_spmm_plain(data, sk, t_cur)
        t_next, pp = ce.ell_cheb_step(data, sk, t_cur, t_prev, inv)
        torch.cuda.synchronize()
        n_ref, _ = ce.ell_cheb_step_plain(data, sk, t_cur, t_prev, inv)
        _, pp_ref = ce.ell_cheb_step_plain(data.to(c128), sk, t_cur.to(c128), t_prev.to(c128), inv)
        first, pp0 = ce.ell_cheb_step(data, sk, t_cur, None, inv)  # t_prev = 0
        again, pp_again = ce.ell_cheb_step(data, sk, t_cur, t_prev.clone(), inv)
        alias_buf = t_prev.clone()
        aliased, pp_alias = ce.ell_cheb_step(data, sk, t_cur, alias_buf, inv, out=alias_buf)
        torch.cuda.synchronize()
        first_ref, _ = ce.ell_cheb_step_plain(data, sk, t_cur, None, inv)
        sums, sums_ref = pp.double().sum(dim=0), pp_ref[0]
        ok_window, rel_window = window_agrees(
            lambda rows: ce.ell_cheb_step_window(data, sk, t_cur, t_prev, inv, rows),
            lambda rows: ce.ell_cheb_step_window_plain(data.to(c128), sk, t_cur.to(c128), t_prev.to(c128), inv, rows),
            t_next, N)
        ok = ok_window and (
            torch.allclose(y, y_ref, atol=2e-4, rtol=2e-4)
            and torch.allclose(t_next, n_ref, atol=2e-4, rtol=2e-4)
            and torch.allclose(first, first_ref, atol=2e-4, rtol=2e-4)
            and bool((sums - sums_ref).abs().max() <= 1e-4 * sums_ref.abs().max())
            and torch.equal(again, t_next) and torch.equal(pp_again, pp)  # repeats bit for bit
            and torch.equal(aliased, t_next) and torch.equal(pp_alias, pp)  # out may be t_prev
            and aliased.data_ptr() == alias_buf.data_ptr()
        )
        return ok, {
            "ell_spmm": float((y - y_ref).abs().max()),
            "ell_cheb_step": float((t_next - n_ref).abs().max()),
            "partials_rel": float((sums - sums_ref).abs().max() / sums_ref.abs().max()),
            "window_partials_rel": rel_window,
        }

    def random_blocks(sk, seed):
        """Independent random entries in every block, padding slots included: not Hermitian."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn((*sk.cols.shape, 4, 4), dtype=c64, generator=g).to(dev)

    # The backward kernels on non-Hermitian data.  ell_spmm_adjoint: atol =
    # rtol = 2e-4 against the complex64 plain version, as ell_spmm.
    # ell_block_outer: the same tolerance (float32 sums of K <= 33 products in
    # another order), with `accumulate` off (fresh and overwritten buffer) and
    # on (added to a random buffer); a second launch must repeat bit for bit.
    # The fused forms the backward pass uses (G = g + shift*t formed in the
    # outer kernel with -G written out, g absent; alpha, add and two axpy terms
    # in the adjoint's epilogue, written over `add`) to the same tolerance.
    def compare_backward(sk, K, seed):
        N = sk.n_sites
        data = random_blocks(sk, seed + 2)
        v, g = random_vector(N, K, seed), random_vector(N, K, seed + 1)
        y = ce.ell_spmm_adjoint(data, sk, v)
        y_again = ce.ell_spmm_adjoint(data, sk, v)
        h = ce.ell_block_outer(g, sk, v, 0.75)
        h_again = ce.ell_block_outer(g, sk, v, 0.75, out=torch.full_like(h, 7.0))
        start = random_blocks(sk, seed + 3)
        h_acc = ce.ell_block_outer(g, sk, v, 0.75, out=start.clone(), accumulate=True)
        h_acc_again = ce.ell_block_outer(g, sk, v, 0.75, out=start.clone(), accumulate=True)
        shift = torch.linspace(-0.5, 1.5, K, device=dev)
        c2 = torch.linspace(1.0, -2.0, K, device=dev)
        x1, x2, add = (random_vector(N, K, seed + 4 + i) for i in range(3))
        neg, neg0 = torch.empty_like(v), torch.empty_like(v)
        h_fused = ce.ell_block_outer(g, sk, v, 0.75, shift=shift, neg_out=neg)
        h_shift = ce.ell_block_outer(None, sk, v, 0.75, shift=shift, neg_out=neg0)
        buf = add.clone()
        y_fused = ce.ell_spmm_adjoint(data, sk, v, alpha=-0.3, add=buf, axpy=((shift, x1), (c2, x2)), out=buf)
        torch.cuda.synchronize()
        y_ref = ce.ell_spmm_adjoint_plain(data, sk, v)
        h_ref = ce.ell_block_outer_plain(g, sk, v, 0.75)
        G = g + shift * v
        y_fused_ref = -0.3 * y_ref + add + shift * x1 + c2 * x2
        h_fused_ref = ce.ell_block_outer_plain(G, sk, v, 0.75)
        close = lambda a, b: torch.allclose(a, b, atol=2e-4, rtol=2e-4)
        ok = (
            close(y, y_ref) and close(h, h_ref) and close(h_acc, start + h_ref)
            and torch.equal(y_again, y) and torch.equal(h_again, h) and torch.equal(h_acc_again, h_acc)
            and bool((h[~sk.device_valid(dev)] == 0).all())  # padding slots get zero
            and close(neg, -G) and close(h_fused, h_fused_ref)
            and close(neg0, -shift * v) and close(h_shift, ce.ell_block_outer_plain(shift * v, sk, v, 0.75))
            and close(y_fused, y_fused_ref) and y_fused.data_ptr() == buf.data_ptr()
        )
        return ok, {
            "ell_spmm_adjoint": float(max((y - y_ref).abs().max(), (y_fused - y_fused_ref).abs().max())),
            "ell_block_outer": float(max((h - h_ref).abs().max(), (h_acc - start - h_ref).abs().max(),
                                         (h_fused - h_fused_ref).abs().max(), (neg + G).abs().max())),
        }

    # The bf16 instantiations of the general product and step on the bf16 form
    # of the same operator: against the plain versions on that form (2e-4;
    # partials 1e-4 of the largest sum against complex128 — the rounding is the
    # same, only float32 arithmetic differs), second launch bit-equal, out =
    # t_prev, t_prev = 0, and each launch counted under its own name.
    def compare_bf16(data, sk, K, seed):
        N = sk.n_sites
        form = ce.bf16_operator(data)
        t_cur, t_prev = random_vector(N, K, seed), random_vector(N, K, seed + 1)
        before = ck.launch_counts()
        y = ce.ell_spmm(form, sk, t_cur)
        y_again = ce.ell_spmm_bf16(form, sk, t_cur)
        t_next, pp = ce.ell_cheb_step(form, sk, t_cur, t_prev, 0.125)
        again, pp_again = ce.ell_cheb_step_bf16(form, sk, t_cur, t_prev.clone(), 0.125)
        first, _ = ce.ell_cheb_step(form, sk, t_cur, None, 0.125)
        buf = t_prev.clone()
        aliased, pp_alias = ce.ell_cheb_step(form, sk, t_cur, buf, 0.125, out=buf)
        torch.cuda.synchronize()
        launched = launched_since(before)
        y_ref = ce.ell_spmm_plain(form, sk, t_cur)
        n_ref, _ = ce.ell_cheb_step_plain(form, sk, t_cur, t_prev, 0.125)
        first_ref, _ = ce.ell_cheb_step_plain(form, sk, t_cur, None, 0.125)
        _, pp_ref = ce.ell_cheb_step_plain(form, sk, t_cur.to(c128), t_prev.to(c128), 0.125)
        sums, sums_ref = pp.double().sum(dim=0), pp_ref[0]
        rel = float((sums - sums_ref).abs().max() / sums_ref.abs().max())
        close = lambda a, b: torch.allclose(a, b, atol=2e-4, rtol=2e-4)
        ok = (close(y, y_ref) and close(t_next, n_ref) and close(first, first_ref) and rel <= 1e-4
              and torch.equal(y_again, y) and torch.equal(again, t_next) and torch.equal(pp_again, pp)
              and torch.equal(aliased, t_next) and torch.equal(pp_alias, pp) and aliased.data_ptr() == buf.data_ptr()
              and launched == counts(ell_spmm_bf16=2, ell_cheb_step_bf16=4))
        return ok, {"ell_spmm_bf16": float((y - y_ref).abs().max()),
                    "ell_cheb_step_bf16": float((t_next - n_ref).abs().max()), "bf16_partials_rel": rel}

    ck.reset_launch_counts()
    shapes = [(6, 5, 1), (4, 7, 1), (4, 4, 3), (3, 1, 5), (5, 6, 4), (16, 1, 1), (2, 6, 1)]
    probe_counts = [1, 3, 4, 8, 33]
    small_err = {"ell_spmm": 0.0, "ell_cheb_step": 0.0, "partials_rel": 0.0, "window_partials_rel": 0.0,
                 "ell_spmm_adjoint": 0.0, "ell_block_outer": 0.0,
                 "ell_spmm_bf16": 0.0, "ell_cheb_step_bf16": 0.0, "bf16_partials_rel": 0.0}
    cases = [(str(shape), *random_system(shape, seed=i)) for i, shape in enumerate(shapes)]
    rng = np.random.default_rng(11)
    r = np.concatenate([np.arange(23), rng.integers(0, 23, size=60)])
    c = np.concatenate([np.arange(23), rng.integers(0, 23, size=60)])
    sk_pairs = bs.skeleton_from_pairs(23, np.concatenate([r, c]), np.concatenate([c, r]))
    data_pairs = random_vector(23 * sk_pairs.n_slots, 4, 5).reshape(23, sk_pairs.n_slots, 4, 4)
    data_pairs = (data_pairs * sk_pairs.device_valid(dev)[..., None, None]).contiguous()
    cases.append((f"pairs(23, S={sk_pairs.n_slots})", data_pairs, sk_pairs))
    for name, data, sk in cases:
        worst = dict.fromkeys(small_err, 0.0)
        for K in probe_counts:
            ok, err = compare(data, sk, K, seed=100 + K)
            ok_bwd, err_bwd = compare_backward(sk, K, seed=200 + K)
            ok_bf16, err_bf16 = compare_bf16(data, sk, K, seed=300 + K)
            err.update(err_bwd)
            err.update(err_bf16)
            worst = {k: max(worst[k], err[k]) for k in worst}
            check(ok, f"kernel disagrees with its plain version on {name}, K={K}: {err}")
            check(ok_bwd, f"backward kernel disagrees with its plain version on {name}, K={K}: {err_bwd}")
            check(ok_bf16, f"bf16 kernel disagrees with its plain version on {name}, K={K}: {err_bf16}")
        small_err = {k: max(small_err[k], worst[k]) for k in worst}
        emit({"phase": "kernels", "shape": name, "S": sk.n_slots, "K": probe_counts,
              "padding_slots": bool((sk.cols < 0).any()), "max_abs_err": worst})
    emit({"phase": "kernels", "held": [n for n in ck.KERNELS if n not in ck.SWEEP_KERNELS], "small_shapes": len(cases),
          "tolerance": {"y_t_next": "atol=rtol=2e-4 vs complex64 plain",
                        "partials": "1e-4 of the largest sum vs complex128 plain",
                        "adjoint_outer": "atol=rtol=2e-4 vs complex64 plain, non-Hermitian data, "
                                         "accumulate off and on, second launch bit-equal",
                        "bf16": "atol=rtol=2e-4 vs complex64 plain on the same bf16 form; partials 1e-4 "
                                "vs complex128 plain on that form; second launch bit-equal"},
          "max_abs_err": small_err, "launches": ck.launch_counts()})

    # ------------------------------------------------------------------ 3a'. the gather and the tiled kernels, small shapes
    # Same tolerances as above.  Each kernel against its plain version (2e-4;
    # partial sums 1e-4 of the largest against complex128) and against the
    # general ELL kernel on the same operands (2e-4); a second launch must
    # repeat bit for bit; `out` may be the t_prev buffer.
    def step_agrees(step, plain_step, general_step, t_cur, t_prev, inv=0.125):
        """``step(t_prev, out)`` and friends are closures over the operator."""
        t_next, pp = step(t_prev, None)
        torch.cuda.synchronize()
        want, _ = plain_step(t_cur, t_prev, c64)
        _, pp_want = plain_step(t_cur, t_prev, c128)
        general, pp_general = general_step(t_prev)
        first, _ = step(None, None)
        first_want, _ = plain_step(t_cur, None, c64)
        again, pp_again = step(t_prev.clone(), None)
        buf = t_prev.clone()
        aliased, pp_alias = step(buf, buf)
        torch.cuda.synchronize()
        sums, sums_want = pp.double().sum(dim=0), pp_want[0]
        rel = float((sums - sums_want).abs().max() / sums_want.abs().max())
        close = lambda a, b: torch.allclose(a, b, atol=2e-4, rtol=2e-4)
        ok = (close(t_next, want) and close(t_next, general) and close(first, first_want) and rel <= 1e-4
              and bool((sums - pp_general.double().sum(dim=0)).abs().max() <= 1e-4 * sums_want.abs().max())
              and torch.equal(again, t_next) and torch.equal(pp_again, pp)
              and torch.equal(aliased, t_next) and torch.equal(pp_alias, pp) and aliased.data_ptr() == buf.data_ptr())
        return ok, float((t_next - want).abs().max()), rel

    def compare_gather(sk, gl, data, K, seed, gl16=None):
        """``data`` in the original order; everything else in relabelled order.
        The bf16 instantiations run on ``gl16``, the bf16 operator's plan
        (by default the planned one at this K: the cluster form where it fits)."""
        gl16 = gl16 or cg.plan_gather(sk, K, operator_dtype="bf16")
        N = sk.n_sites
        d = gl.relabel(data).contiguous()
        t_cur, t_prev = random_vector(N, K, seed), random_vector(N, K, seed + 1)
        y = cg.ell_gather_spmm(d, gl, t_cur)
        y_again = cg.ell_gather_spmm(d, gl, t_cur)
        torch.cuda.synchronize()
        y_want = cg.ell_gather_spmm_plain(d, gl, t_cur)
        y_general = ce.ell_spmm(d, gl.sk, t_cur)
        y_natural = gl.relabel(ce.ell_spmm(data, sk, gl.restore(t_cur)))  # the same product in the original order
        close = lambda a, b: torch.allclose(a, b, atol=2e-4, rtol=2e-4)
        ok_step, err_step, rel = step_agrees(
            lambda prev, out: cg.ell_gather_cheb_step(d, gl, t_cur, prev, 0.125, out=out),
            lambda cur, prev, dt: cg.ell_gather_cheb_step_plain(d.to(dt), gl, cur.to(dt), None if prev is None else prev.to(dt), 0.125),
            lambda prev: ce.ell_cheb_step(d, gl.sk, t_cur, prev, 0.125), t_cur, t_prev)
        whole_next, _ = cg.ell_gather_cheb_step(d, gl, t_cur, t_prev, 0.125)
        ok_window, rel_window = window_agrees(
            lambda rows: cg.ell_gather_cheb_step_window(d, gl, t_cur, t_prev, 0.125, rows),
            lambda rows: cg.ell_gather_cheb_step_window_plain(d.to(c128), gl, t_cur.to(c128), t_prev.to(c128), 0.125,
                                                              rows),
            whole_next, N)
        # The bf16 instantiations on the bf16 form of the relabelled operator.
        d16 = ce.bf16_operator(d)
        y16 = cg.ell_gather_spmm(d16, gl16, t_cur)
        y16_again = cg.ell_gather_spmm_bf16(d16, gl16, t_cur)
        torch.cuda.synchronize()
        y16_want = cg.ell_gather_spmm_plain(d16, gl16, t_cur)
        y16_general = ce.ell_spmm(d16, gl16.sk, t_cur)
        ok16_step, err16_step, rel16 = step_agrees(
            lambda prev, out: cg.ell_gather_cheb_step(d16, gl16, t_cur, prev, 0.125, out=out),
            lambda cur, prev, dt: cg.ell_gather_cheb_step_plain(d16, gl16, cur.to(dt), None if prev is None else prev.to(dt), 0.125),
            lambda prev: ce.ell_cheb_step(d16, gl16.sk, t_cur, prev, 0.125), t_cur, t_prev)
        ok16 = close(y16, y16_want) and close(y16, y16_general) and torch.equal(y16, y16_again) and ok16_step
        ok = (close(y, y_want) and close(y, y_general) and close(y, y_natural) and torch.equal(y, y_again) and ok_step
              and ok_window)
        return ok and ok16, {"ell_gather_spmm": float((y - y_want).abs().max()), "ell_gather_cheb_step": err_step,
                             "gather_partials_rel": rel, "gather_window_partials_rel": rel_window,
                             "ell_gather_spmm_bf16": float((y16 - y16_want).abs().max()),
                             "ell_gather_cheb_step_bf16": err16_step, "gather_bf16_partials_rel": rel16}

    def compare_tiled(data, sk, K, seed, tile=None, bf16=False):
        """The tiled step on ``data`` (with ``bf16``: its bf16 instantiation on
        the bf16 form, against the plain version and the general bf16 step on
        that form)."""
        N = sk.n_sites
        t_cur, t_prev = random_vector(N, K, seed), random_vector(N, K, seed + 1)
        if bf16:
            data = ce.bf16_operator(data)
            as_dt = lambda dt: data
        else:
            as_dt = lambda dt: data.to(dt)
        ok, err, rel = step_agrees(
            lambda prev, out: ce.stencil_cheb_step_tiled(data, sk, t_cur, prev, 0.125, out=out, tile=tile),
            lambda cur, prev, dt: ce.stencil_cheb_step_tiled_plain(as_dt(dt), sk, cur.to(dt), None if prev is None else prev.to(dt), 0.125),
            lambda prev: ce.ell_cheb_step(data, sk, t_cur, prev, 0.125), t_cur, t_prev)
        suffix = "_bf16" if bf16 else ""
        return ok, {"stencil_cheb_step_tiled" + suffix: err, "tiled" + suffix + "_partials_rel": rel}

    def ring_skeleton(n):
        i = np.arange(n)
        j = (i + 1) % n
        return bs.skeleton_from_pairs(n, np.concatenate([i, i, j]), np.concatenate([i, j, i]))

    def gather_tile_between(sk, K, lo, hi, operator_dtype=None):
        """A forced tile T whose block takes lo < bytes <= hi of shared memory
        in the planned form and TK (the largest such T), or None."""
        gl = cg.plan_gather(sk, K, operator_dtype=operator_dtype)
        for T in range(6000, 0, -4 if gl.cluster == 2 else -1):
            plan = cg._launch_plan(sk.n_sites, gl.bwb, K, T, operator_dtype, sk.n_slots)
            if plan is not None and plan.cluster == gl.cluster and plan[1] == gl.TK and lo < plan[6] <= hi:
                return T
        return None

    def plan_of(gl):
        """A gather plan as it is printed beside its kernels."""
        return {"cluster": gl.cluster, "stages": gl.depth + 1 if gl.cluster == 2 else None, "depth": gl.depth,
                "T": gl.T, "TK": gl.TK, "run": gl.run, "ctas": gl.ctas, "threads": gl.threads,
                "smem_bytes": gl.smem_bytes, "stage_bytes": gl.stage_bytes}

    ck.reset_launch_counts()
    gather_cases = [("ring(300)", ring_skeleton(300)),
                    ("generic 10x40", bs.skeleton_from_lattice(CubicLattice((10, 40, 1)))),
                    ("generic 12x9", bs.skeleton_from_lattice(CubicLattice((12, 9, 1)))),
                    (f"pairs(23, S={sk_pairs.n_slots})", sk_pairs)]
    gather_err = {"ell_gather_spmm": 0.0, "ell_gather_cheb_step": 0.0, "gather_partials_rel": 0.0,
                  "gather_window_partials_rel": 0.0,
                  "ell_gather_spmm_bf16": 0.0, "ell_gather_cheb_step_bf16": 0.0, "gather_bf16_partials_rel": 0.0}
    # Each case at the planned tile; T = 32 (pairs(23): N smaller than one tile,
    # and not a multiple of it); runs of one tile and of five (more tiles than
    # the ring has stages); T = 160; and the T whose ring comes closest to the
    # 227 KB a block may use.  One ring of 48-56 KB (the launch raises the
    # 48 KB default) must be among them.  The bf16 instantiations run on the
    # bf16 operator's plan at the same tile (the cluster form where it fits,
    # with two and four stages besides the planned count), and at the tiles
    # whose cluster-form block comes closest to 227 KB and takes 48-56 KB.
    above_48k = near_limit = False
    above_48k16 = near_limit16 = False
    cluster_cases = 0
    for name, sk in gather_cases:
        data = random_blocks(sk, 400)  # not Hermitian, padding slots filled with garbage
        worst = dict.fromkeys(gather_err, 0.0)
        plans = {}
        for K in probe_counts:
            tiles = [None, 32, (32, 32), (32, 160), 160, gather_tile_between(sk, K, 220 * 1024, cg.SMEM_LIMIT)]
            if name == "ring(300)":
                tiles.append(gather_tile_between(sk, K, 48 * 1024, 56 * 1024))
            tiles16 = [(tile, tile) for tile in tiles] + [(None, (64, None, 2)), (None, (32, 160, 4)),
                       (None, gather_tile_between(sk, K, 220 * 1024, cg.SMEM_LIMIT, "bf16"))]
            if name == "ring(300)":
                tiles16.append((None, gather_tile_between(sk, K, 48 * 1024, 56 * 1024, "bf16")))
            for tile, tile16 in tiles16:
                gl = cg.plan_gather(sk, K, tile)
                gl16 = cg.plan_gather(sk, K, tile16, operator_dtype="bf16")
                check(gl is not None and gl16 is not None, f"no gather plan for {name} at K={K}, tile={tile16}")
                above_48k = above_48k or 48 * 1024 < gl.smem_bytes <= 56 * 1024
                near_limit = near_limit or gl.smem_bytes > 220 * 1024
                if gl16.cluster == 2:
                    cluster_cases += 1
                    above_48k16 = above_48k16 or 48 * 1024 < gl16.smem_bytes <= 56 * 1024
                    near_limit16 = near_limit16 or gl16.smem_bytes > 220 * 1024
                ok, err = compare_gather(sk, gl, data, K, seed=500 + K, gl16=gl16)
                check(ok, f"gather kernel disagrees on {name}, K={K}, tile={tile}, bf16 tile={tile16}: {err}")
                worst = {k: max(worst[k], err[k]) for k in worst}
                plans[f"K={K},tile={tile}"] = [gl.T, gl.TK, gl.depth, gl.run, gl.ctas, gl.threads, gl.smem_bytes]
                plans[f"K={K},bf16 tile={tile16}"] = plan_of(gl16)
        gather_err = {k: max(gather_err[k], worst[k]) for k in worst}
        emit({"phase": "kernels", "shape": name, "N": sk.n_sites, "S": sk.n_slots, "K": probe_counts, "bwb": gl.bwb,
              "padding_slots": bool((sk.cols < 0).any()),
              "plans_T_TK_depth_run_ctas_threads_smem": plans, "max_abs_err": worst})
    check(above_48k and near_limit, "no gather case with a ring of 48-56 KB, or none near 227 KB")
    check(above_48k16 and near_limit16 and cluster_cases > 0,
          "no cluster-form gather case of 48-56 KB, or none near 227 KB")
    tiled_err = {"stencil_cheb_step_tiled": 0.0, "tiled_partials_rel": 0.0,
                 "stencil_cheb_step_tiled_bf16": 0.0, "tiled_bf16_partials_rel": 0.0}
    sk = bs.skeleton((5, 6, 4))  # a ring of six rows of 24 + 8 sites: 52 KB, past the 48 KB default
    for K in (8, 33):
        check(48 * 1024 < ce.tile_plan(sk, K, tile=(24, 5, 6))["smem_bytes"] + 2 * ce.TILED_THREADS * 4 <= 56 * 1024,
              "tile (24, 5, 6) is not 48-56 KB")
        for bf16 in (False, True):
            ok, err = compare_tiled(random_blocks(sk, 650), sk, K, seed=750 + K, tile=(24, 5, 6), bf16=bf16)
            check(ok, f"tiled kernel disagrees on (5, 6, 4) with a 52 KB ring, K={K}, bf16={bf16}: {err}")
    # The seven stencil skeletons and three more (Lx = 1 with y and z, all
    # extents 2), periodic and open, K up to 64, at the planned tile and at
    # three forced ones: strips of 2 (every halo wraps modulo M) in runs of 3
    # (ragged, across strips) with one row in flight; strips of 3 in runs of 5
    # without a row in flight (NR = 3); strips of 4 in runs of 7 with three in
    # flight (NR = 6).
    tiled_shapes = shapes + [(1, 6, 4), (1, 1, 7), (2, 2, 2)]
    tiled_counts = probe_counts + [64]
    for i, shape in enumerate(tiled_shapes):
        sk = bs.skeleton(shape)
        M = shape[1] * shape[2]
        worst = dict.fromkeys(tiled_err, 0.0)
        variants = (("periodic", random_blocks(sk, 600 + i)),  # every slot random, padding slots garbage
                    ("open", random_system(shape, seed=i, pbc=False)[0]))
        forced = [(min(M, 2), 3), (min(M, 3), 5, 3), (min(M, 4), 7, 6)]
        for label, data in variants:
            for K in tiled_counts:
                for tile in [None, *forced]:
                    ok, err = compare_tiled(data, sk, K, seed=700 + K, tile=tile)
                    ok16, err16 = compare_tiled(data, sk, K, seed=800 + K, tile=tile, bf16=True)
                    err.update(err16)
                    check(ok and ok16, f"tiled kernel disagrees on {shape} {label}, K={K}, tile={tile}: {err}")
                    worst = {k: max(worst[k], err[k]) for k in worst}
        tiled_err = {k: max(tiled_err[k], worst[k]) for k in worst}
        emit({"phase": "kernels", "shape": str(shape), "S": sk.n_slots, "K": tiled_counts,
              "boundaries": ["periodic", "open"], "tiles": ["planned", *forced],
              "planned_K8": ce.tile_plan(sk, 8), "max_abs_err": worst})
    try:
        ce.stencil_cheb_step_tiled(data_pairs, sk_pairs, random_vector(23, 4, 1), None, 0.1)
        fail("the tiled step accepted a generic skeleton")
    except ValueError:
        pass
    emit({"phase": "kernels", "held": ["ell_gather_spmm", "ell_gather_cheb_step", "ell_gather_cheb_step_window",
                                       "stencil_cheb_step_tiled",
                                       "ell_gather_spmm_bf16", "ell_gather_cheb_step_bf16",
                                       "stencil_cheb_step_tiled_bf16"],
          "gather_shapes": len(gather_cases), "tiled_shapes": len(tiled_shapes),
          "tolerance": {"against_plain_and_general": "atol=rtol=2e-4 vs complex64 plain and vs ell_spmm / ell_cheb_step",
                        "partials": "1e-4 of the largest sum vs complex128 plain", "repeat": "second launch bit-equal"},
          "max_abs_err": {**gather_err, **tiled_err}, "launches": ck.launch_counts()})
    # ------------------------------------------------------------------ 3a''. the halo kernels, small shapes
    # The four halo entry points on one slab of x-planes [x0, x0 + Lxl), the
    # neighbour planes cut from the whole vector into allocations of their own.
    # Each against its plain version (2e-4; partials 1e-4 of the largest sum
    # against complex128) and against the rows of the whole-lattice kernel
    # (2e-4; bit-equality is recorded), second launch bit-equal, `out` = the
    # t_prev buffer, t_prev = 0, the interior / boundary split into one buffer
    # (bit-equal to one launch), and the backward pair in the fused forms the
    # sharded sweep launches.
    def compare_halo(data, data_nh, sk, K, Lxl, seed):
        Lx, Ly, Lz = sk.shape
        P, N = Ly * Lz, sk.n_sites
        planes = min(Lxl, Lx)
        x0 = min(1, Lx - planes)
        slab = ce.halo_slab(sk, x0, planes)
        r, n = slab.rows, slab.n_local
        before, after = ((x0 - 1) % Lx) * P, ((x0 + planes) % Lx) * P
        v, t_prev, g = (random_vector(N, K, seed + i) for i in range(3))
        cut = lambda x, start: x[start:start + P].clone()  # a separate allocation
        own = lambda x: x[r].contiguous()
        d_l, v_l, tp_l, g_l, dn_l = own(data), own(v), own(t_prev), own(g), own(data_nh)
        hm, hp = cut(v, before), cut(v, after)
        close = lambda a, b: torch.allclose(a, b, atol=2e-4, rtol=2e-4)
        y = ce.ell_spmm_halo(d_l, slab, v_l, hm, hp)
        y_again = ce.ell_spmm_halo(d_l, slab, v_l, hm, hp)
        y_plain = ce.ell_spmm_halo_plain(d_l, slab, v_l, hm, hp)
        y_whole = ce.ell_spmm(data, sk, v)[r]
        t, pp = ce.ell_cheb_step_halo(d_l, slab, v_l, hm, hp, tp_l, 0.125)
        t_again, pp_again = ce.ell_cheb_step_halo(d_l, slab, v_l, hm, hp, tp_l.clone(), 0.125)
        buf = tp_l.clone()
        t_alias, pp_alias = ce.ell_cheb_step_halo(d_l, slab, v_l, hm, hp, buf, 0.125, out=buf)
        t0_, _ = ce.ell_cheb_step_halo(d_l, slab, v_l, hm, hp, None, 0.125)
        torch.cuda.synchronize()
        t_plain, _ = ce.ell_cheb_step_halo_plain(d_l, slab, v_l, hm, hp, tp_l, 0.125)
        t0_plain, _ = ce.ell_cheb_step_halo_plain(d_l, slab, v_l, hm, hp, None, 0.125)
        _, pp128 = ce.ell_cheb_step_halo_plain(d_l.to(c128), slab, v_l.to(c128), hm.to(c128), hp.to(c128),
                                               tp_l.to(c128), 0.125)
        t_whole, _ = ce.ell_cheb_step(data, sk, v, t_prev, 0.125)
        sums, sums_want = pp.double().sum(dim=0), pp128[0]
        rel = float((sums - sums_want).abs().max() / sums_want.abs().max())
        ok = (close(y, y_plain) and close(y, y_whole) and torch.equal(y, y_again)
              and close(t, t_plain) and close(t, t_whole[r]) and close(t0_, t0_plain) and rel <= 1e-4
              and torch.equal(t_again, t) and torch.equal(pp_again, pp)
              and torch.equal(t_alias, t) and torch.equal(pp_alias, pp) and t_alias.data_ptr() == buf.data_ptr())
        bit_equal = torch.equal(y, y_whole) and torch.equal(t, t_whole[r])
        if planes >= 3:  # the split: interior rows without halo planes, then the two boundary planes
            ys, ts = torch.empty_like(v_l), tp_l.clone()
            ce.ell_spmm_halo(d_l, slab, v_l, None, None, rows=(P, n - P), out=ys)
            _, p_int = ce.ell_cheb_step_halo(d_l, slab, v_l, None, None, ts, 0.125, rows=(P, n - P), out=ts)
            ce.ell_spmm_halo(d_l, slab, v_l, hm, hp, rows=(0, P), out=ys)
            ce.ell_spmm_halo(d_l, slab, v_l, hm, hp, rows=(n - P, n), out=ys)
            _, p_lo = ce.ell_cheb_step_halo(d_l, slab, v_l, hm, hp, ts, 0.125, rows=(0, P), out=ts)
            _, p_hi = ce.ell_cheb_step_halo(d_l, slab, v_l, hm, hp, ts, 0.125, rows=(n - P, n), out=ts)
            split_sums = torch.cat([p_lo, p_int, p_hi]).double().sum(dim=0)
            ok = (ok and torch.equal(ys, y) and torch.equal(ts, t)
                  and bool((split_sums - sums_want).abs().max() <= 1e-4 * sums_want.abs().max()))
        # Backward on non-Hermitian blocks: the neighbour planes' operator rows and cotangent planes.
        dm, dp, gm, gp = cut(data_nh, before), cut(data_nh, after), cut(g, before), cut(g, after)
        adj = ce.ell_spmm_adjoint_halo(dn_l, slab, g_l, gm, gp, dm, dp)
        adj_again = ce.ell_spmm_adjoint_halo(dn_l, slab, g_l, gm, gp, dm, dp)
        adj_plain = ce.ell_spmm_adjoint_halo_plain(dn_l, slab, g_l, gm, gp, dm, dp)
        adj_whole = ce.ell_spmm_adjoint(data_nh, sk, g)[r]
        h = ce.ell_block_outer_halo(g_l, slab, v_l, hm, hp, 0.75)
        h_again = ce.ell_block_outer_halo(g_l, slab, v_l, hm, hp, 0.75, out=torch.full_like(h, 7.0))
        h_plain = ce.ell_block_outer_halo_plain(g_l, slab, v_l, hm, hp, 0.75)
        h_whole = ce.ell_block_outer(g, sk, v, 0.75)[r]
        shift = torch.linspace(-0.5, 1.5, K, device=dev)
        c2 = torch.linspace(1.0, -2.0, K, device=dev)
        start = random_blocks(sk, seed + 5)[r].contiguous()
        neg = torch.empty_like(v_l)
        h_fused = ce.ell_block_outer_halo(g_l, slab, v_l, hm, hp, 0.75, out=start.clone(), accumulate=True,
                                          shift=shift, neg_out=neg)
        x1, x2, add = own(t_prev), random_vector(n, K, seed + 6), random_vector(n, K, seed + 7)
        abuf = add.clone()
        adj_fused = ce.ell_spmm_adjoint_halo(dn_l, slab, g_l, gm, gp, dm, dp, alpha=-0.3, add=abuf,
                                             axpy=((shift, x1), (c2, x2)), out=abuf)
        torch.cuda.synchronize()
        G = g_l + shift * v_l
        h_fused_want = start + ce.ell_block_outer_halo_plain(G, slab, v_l, hm, hp, 0.75)
        adj_fused_want = -0.3 * adj_plain + add + shift * x1 + c2 * x2
        ok_bwd = (close(adj, adj_plain) and close(adj, adj_whole) and torch.equal(adj, adj_again)
                  and close(h, h_plain) and close(h, h_whole) and torch.equal(h, h_again)
                  and bool((h[~slab.device_valid(dev)] == 0).all())
                  and close(neg, -G) and close(h_fused, h_fused_want)
                  and close(adj_fused, adj_fused_want) and adj_fused.data_ptr() == abuf.data_ptr())
        bit_equal = bit_equal and torch.equal(adj, adj_whole) and torch.equal(h, h_whole)
        # The forward forms' bf16 instantiations on the bf16 form of the slab's rows.
        f_l, f_whole = ce.bf16_operator(d_l), ce.bf16_operator(data)
        y16 = ce.ell_spmm_halo(f_l, slab, v_l, hm, hp)
        y16_again = ce.ell_spmm_halo_bf16(f_l, slab, v_l, hm, hp)
        t16, pp16 = ce.ell_cheb_step_halo(f_l, slab, v_l, hm, hp, tp_l, 0.125)
        buf16 = tp_l.clone()
        t16_alias, pp16_alias = ce.ell_cheb_step_halo_bf16(f_l, slab, v_l, hm, hp, buf16, 0.125, out=buf16)
        torch.cuda.synchronize()
        y16_plain = ce.ell_spmm_halo_plain(f_l, slab, v_l, hm, hp)
        t16_plain, _ = ce.ell_cheb_step_halo_plain(f_l, slab, v_l, hm, hp, tp_l, 0.125)
        _, pp16_128 = ce.ell_cheb_step_halo_plain(f_l, slab, v_l.to(c128), hm.to(c128), hp.to(c128), tp_l.to(c128),
                                                  0.125)
        y16_whole = ce.ell_spmm(f_whole, sk, v)[r]
        t16_whole = ce.ell_cheb_step(f_whole, sk, v, t_prev, 0.125)[0][r]
        sums16, want16 = pp16.double().sum(dim=0), pp16_128[0]
        rel16 = float((sums16 - want16).abs().max() / want16.abs().max())
        ok16 = (close(y16, y16_plain) and close(y16, y16_whole) and torch.equal(y16, y16_again)
                and close(t16, t16_plain) and close(t16, t16_whole) and rel16 <= 1e-4
                and torch.equal(t16_alias, t16) and torch.equal(pp16_alias, pp16))
        bit_equal = bit_equal and torch.equal(y16, y16_whole) and torch.equal(t16, t16_whole)
        return ok and ok_bwd and ok16, bit_equal, {
            "ell_spmm_halo_bf16": float(max((y16 - y16_plain).abs().max(), (y16 - y16_whole).abs().max())),
            "ell_cheb_step_halo_bf16": float(max((t16 - t16_plain).abs().max(), (t16 - t16_whole).abs().max())),
            "halo_bf16_partials_rel": rel16,
            "ell_spmm_halo": float(max((y - y_plain).abs().max(), (y - y_whole).abs().max())),
            "ell_cheb_step_halo": float(max((t - t_plain).abs().max(), (t - t_whole[r]).abs().max())),
            "halo_partials_rel": rel,
            "ell_spmm_adjoint_halo": float(max((adj - adj_plain).abs().max(), (adj_fused - adj_fused_want).abs().max())),
            "ell_block_outer_halo": float(max((h - h_plain).abs().max(), (h_fused - h_fused_want).abs().max())),
        }

    ck.reset_launch_counts()
    halo_err = dict.fromkeys(("ell_spmm_halo", "ell_cheb_step_halo", "halo_partials_rel",
                              "ell_spmm_adjoint_halo", "ell_block_outer_halo", "ell_spmm_halo_bf16",
                              "ell_cheb_step_halo_bf16", "halo_bf16_partials_rel"), 0.0)
    all_bit_equal = True
    for i, shape in enumerate(shapes):
        sk = bs.skeleton(shape)
        worst = dict.fromkeys(halo_err, 0.0)
        variants = (("periodic", random_blocks(sk, 800 + i)),  # every slot random, padding slots garbage
                    ("open", random_system(shape, seed=i, pbc=False)[0]))
        for label, data in variants:
            for Lxl in (1, 2, 3, shape[0]):
                for K in probe_counts:
                    ok, same, err = compare_halo(data, random_blocks(sk, 850 + i), sk, K, Lxl, seed=900 + K)
                    check(ok, f"halo kernel disagrees on {shape} {label}, Lxl={Lxl}, K={K}: {err}")
                    all_bit_equal = all_bit_equal and same
                    worst = {k: max(worst[k], err[k]) for k in worst}
        halo_err = {k: max(halo_err[k], worst[k]) for k in worst}
        emit({"phase": "kernels", "shape": str(shape), "S": sk.n_slots, "K": probe_counts, "Lxl": [1, 2, 3, shape[0]],
              "boundaries": ["periodic", "open"], "max_abs_err": worst})
    emit({"phase": "kernels", "held": ["ell_spmm_halo", "ell_cheb_step_halo", "ell_spmm_adjoint_halo",
                                       "ell_block_outer_halo", "ell_spmm_halo_bf16", "ell_cheb_step_halo_bf16"],
          "halo_shapes": len(shapes), "rows_of_whole_lattice_kernels_bit_equal": all_bit_equal,
          "tolerance": {"against_plain_and_whole": "atol=rtol=2e-4 vs complex64 plain and vs the rows of "
                                                   "ell_spmm / ell_cheb_step / ell_spmm_adjoint / ell_block_outer",
                        "partials": "1e-4 of the largest sum vs complex128 plain",
                        "repeat": "second launch and the three-launch split bit-equal"},
          "max_abs_err": halo_err, "launches": ck.launch_counts()})

    # ------------------------------------------------------------------ 3a'''. the filter kernel, small shapes
    # ell_cheb_filter (and ell_cheb_filter_bf16 on the bf16 form) in each mode that
    # fits, against: its plain version (the per-step recursion in torch, complex64,
    # the same inputs) within 8·M·eps of scale = max|v|·Σ|c_m| — M float32 steps, each
    # rounding its sums, in another order; and the per-step kernel path on the same
    # block and coefficients (ell_cheb_step launches and torch axpys) bit for bit —
    # the steps are the same FMAs and the axpy rounds as torch's does — also with
    # the last coefficient alone (y = t_{M-1}).  A second launch repeats bit for
    # bit; each launch is counted once with its M − 1 steps.
    EPS32 = 2.0 ** -24

    def compare_filter(data, sk, K, coeffs, inv, seed, modes=cf.MODES):
        """``(ok, errors, modes run)`` of the checks above; a mode whose plan does
        not fit (register mode at 100×100 widths) is skipped."""
        N, S = sk.cols.shape
        M = len(coeffs)
        bf16 = ce.is_bf16_operator(data)
        name = "ell_cheb_filter_bf16" if bf16 else "ell_cheb_filter"
        v = random_vector(N, K, seed)

        def step(t_cur, t_prev, scale, out):
            return ce.ell_cheb_step(data, sk, t_cur, t_prev, scale, out=out)[0]

        last = np.zeros(M)
        last[-1] = 1.0
        plain = cf.ell_cheb_filter_plain(data, sk, v, coeffs, inv)
        per_step, per_step_last = ce.filter_recursion(step, v, coeffs, inv), ce.filter_recursion(step, v, last, inv)
        scale = float(v.abs().max()) * float(np.abs(coeffs).sum())
        ok, errs, ran = True, {"vs_plain_rel": 0.0, "vs_per_step_rel": 0.0}, []
        for mode in modes:
            try:
                cf.filter_plan(N, K, S, bf16=bf16, mode=mode)
            except ValueError:
                continue
            before = ck.launch_counts()
            y = cf.ell_cheb_filter(data, sk, v, coeffs, inv, mode=mode)
            y_again = cf.ell_cheb_filter(data, sk, v, coeffs, inv, mode=mode)
            y_last = cf.ell_cheb_filter(data, sk, v, last, inv, mode=mode)
            torch.cuda.synchronize()
            launched = launched_since(before)
            e_plain = float((y - plain).abs().max()) / scale
            e_step = float((y - per_step).abs().max()) / scale
            errs = {"vs_plain_rel": max(errs["vs_plain_rel"], e_plain),
                    "vs_per_step_rel": max(errs["vs_per_step_rel"], e_step)}
            ok = (ok and e_plain <= 8 * M * EPS32 and torch.equal(y, per_step) and torch.equal(y_again, y)
                  and torch.equal(y_last, per_step_last)
                  and launched == counts(**{name: 3, f"{name}.steps": 3 * (M - 1)}))
            ran.append(mode)
        return ok, errs, ran

    ck.reset_launch_counts()
    filter_err, filter_modes = {"vs_plain_rel": 0.0, "vs_per_step_rel": 0.0}, set()
    rng = np.random.default_rng(13)
    for name, data, sk in cases:
        inv = 1.0 / (4 * sk.n_slots * float(data.abs().max()))  # row sums of |H| below 1: inv·H within [-1, 1]
        for form in (data, ce.bf16_operator(data)):
            for K in (1, 3, 18, 33):
                for M in (1, 2, 3, 64):
                    coeffs = rng.normal(size=M)
                    coeffs[3::4] = 0.0  # zero coefficients add nothing
                    ok, err, ran = compare_filter(form, sk, K, coeffs, inv, seed=400 + K)
                    check(ok and ran, f"filter kernel on {name}, K={K}, M={M}, bf16={form is not data}: {err}, {ran}")
                    filter_err = {k: max(filter_err[k], err[k]) for k in filter_err}
                    filter_modes.update(ran)
    check(filter_modes == set(cf.MODES), f"the small shapes held the filter kernel only in {filter_modes}")
    occupancy = {}
    for bf16 in (False, True):
        for mode, (N_o, K_o) in (("registers", (1024, 112)), ("global", (10000, 128))):
            plan = cf.filter_plan(N_o, K_o, 5, bf16=bf16, mode=mode)
            occupancy[f"{mode}{'_bf16' if bf16 else ''}"] = cf.occupancy(plan, 5, bf16=bf16)
    check(min(occupancy.values()) >= cf.FILTER_BLOCKS_PER_SM,
          f"the filter kernel holds {occupancy} blocks an SM, the plans assume {cf.FILTER_BLOCKS_PER_SM}")
    emit({"phase": "kernels", "held": list(ck.FILTER_KERNELS), "small_shapes": len(cases), "K": [1, 3, 18, 33],
          "orders": [1, 2, 3, 64], "modes": sorted(filter_modes), "blocks_per_sm": occupancy,
          "tolerance": {"vs_plain": "8*M*2^-24 of max|v|*sum|c| (complex64 plain, same inputs)",
                        "vs_per_step_kernels": "bit-equal, also with the last coefficient alone; a second "
                                               "launch bit-equal"},
          "max_rel_err": filter_err, "launches": ck.launch_counts()})

    # ------------------------------------------------------------------ 3a''''. the moment kernel, small shapes
    # ell_cheb_moments (and ell_cheb_moments_bf16 on the bf16 form) in each mode that
    # fits, forced, against: its plain version (the per-step recursion in torch,
    # complex64, the same inputs) within (1e-5 + order²·2⁻²⁴/4)·max|μ| — two float32
    # recursions whose rounding errors grow at most with the square of the order;
    # and the per-step kernel path (ce.moment_recursion over ell_cheb_step: a launch
    # and a torch sum a fused step) within 1e-5·max|μ| — the t_m are the same FMAs, the column sums
    # differ only in the order of their float32 additions, and each ⟨t_m,t_m⟩ ≤ μ0
    # while inv·H lies within [-1, 1].  A second launch repeats bit for bit; each
    # launch is counted once with its 1 + ceil((order − 2)/2) steps.
    def per_step_kernel(data, sk):
        """The per-step path's step: one ell_cheb_step launch (out = the t_prev buffer)."""
        return lambda t_cur, t_prev, scale, out: ce.ell_cheb_step(data, sk, t_cur, t_prev, scale, out=out)

    def compare_moments(data, sk, K, order, inv, seed, plans, modes=cf.MODES):
        """``(ok, errors, modes run)`` of the checks above; ``plans`` collects
        each plan run, for the occupancy check."""
        N, S = sk.cols.shape
        bf16 = ce.is_bf16_operator(data)
        name = "ell_cheb_moments_bf16" if bf16 else "ell_cheb_moments"
        v = random_vector(N, K, seed)
        plain = cf.ell_cheb_moments_plain(data, sk, v, inv, order)
        per_step = ce.moment_recursion(per_step_kernel(data, sk), v, inv, order)
        scale = float(plain.abs().max())
        ok, errs, ran = True, {"vs_plain_rel": 0.0, "vs_per_step_rel": 0.0}, []
        for mode in modes:
            try:
                plan = cf.moments_plan(N, K, S, order, bf16=bf16, mode=mode)
            except ValueError:
                continue
            plans[(mode, plan["sites_per_block"], S, K, bf16)] = plan
            before = ck.launch_counts()
            mu = cf.ell_cheb_moments(data, sk, v, inv, order, mode=mode)
            mu_again = cf.ell_cheb_moments(data, sk, v, inv, order, mode=mode)
            torch.cuda.synchronize()
            launched = launched_since(before)
            e_plain = float((mu - plain).abs().max()) / scale
            e_step = float((mu - per_step).abs().max()) / scale
            errs = {"vs_plain_rel": max(errs["vs_plain_rel"], e_plain),
                    "vs_per_step_rel": max(errs["vs_per_step_rel"], e_step)}
            ok = (ok and tuple(mu.shape) == (order, K) and mu.dtype == torch.float32
                  and e_plain <= 1e-5 + order ** 2 * EPS32 / 4 and e_step <= 1e-5 and torch.equal(mu_again, mu)
                  and launched == counts(**{name: 2, f"{name}.steps": 2 * ce.sweep_launches(order)}))
            ran.append(mode)
        return ok, errs, ran

    moments_err, moments_modes, moment_plans, moment_S = {"vs_plain_rel": 0.0, "vs_per_step_rel": 0.0}, set(), {}, set()
    moment_orders = [1, 2, 3, 4, 17, 256]
    # The small shapes above have at most 120 sites, so each of their plans has one
    # site a block.  Two of 4096 sites beside them (S = 5 and 7) run register mode
    # with 32 sites a block and, at K = 33, global mode with 8 sites — 264 pairs on
    # 256 threads, so some threads own two pairs of different columns and the
    # block's tree over sites has eight leaves.
    moment_cases = [case for case in cases if case[2].n_slots in (5, 7)]
    moment_cases += [(str(shape), *random_system(shape, seed=600 + i))
                     for i, shape in enumerate(((64, 64, 1), (32, 32, 4)))]
    for name, data, sk in moment_cases:
        moment_S.add(sk.n_slots)
        inv = 1.0 / (4 * sk.n_slots * float(data.abs().max()))  # row sums of |H| below 1: inv·H within [-1, 1]
        for form in (data, ce.bf16_operator(data)):
            for K in (1, 3, 4, 33):
                for order in moment_orders:
                    ok, err, ran = compare_moments(form, sk, K, order, inv, seed=500 + K, plans=moment_plans)
                    check(ok and ran, f"moment kernel on {name}, K={K}, order={order}, bf16={form is not data}: "
                                      f"{err}, {ran}")
                    moments_err = {k: max(moments_err[k], err[k]) for k in moments_err}
                    moments_modes.update(ran)
    check(moments_modes == set(cf.MODES) and moment_S == {5, 7},
          f"the small shapes held the moment kernel only in {moments_modes}, S in {moment_S}")
    wide = {(m, S_o, K_o, bf16) for (m, sb, S_o, K_o, bf16) in moment_plans if sb > 1 and sb * K_o > cf.FILTER_THREADS}
    check({("global", S_o, 33, bf16) for S_o in (5, 7) for bf16 in (False, True)} <= wide
          and {("registers", S_o, 4, bf16) for S_o in (5, 7) for bf16 in (False, True)}
          <= {(m, S_o, K_o, bf16) for (m, sb, S_o, K_o, bf16) in moment_plans if sb > 1},
          f"the small shapes missed a plan with several sites a block: {sorted(moment_plans)}")
    # Beside them the plans of the main path's moment sweeps (rashba 64×64×4 at
    # K = 8 and 4, 200×200 at K = 4), in both operator forms.
    for N_o, K_o, S_o, order_o in ((16384, 8, 7, 256), (16384, 4, 7, 512), (40000, 4, 5, 512)):
        for bf16 in (False, True):
            plan = cf.moments_plan(N_o, K_o, S_o, order_o, bf16=bf16)
            moment_plans[(plan["mode"], plan["sites_per_block"], S_o, K_o, bf16)] = plan
    moment_occupancy = {f"{m}_SB{sb}_S{S_o}_K{K_o}{'_bf16' if bf16 else ''}":
                        cf.occupancy(plan, S_o, K_o, bf16=bf16, kind="moment")
                        for (m, sb, S_o, K_o, bf16), plan in moment_plans.items()}
    check(min(moment_occupancy.values()) >= cf.FILTER_BLOCKS_PER_SM,
          f"the moment kernel holds {moment_occupancy} blocks an SM, the plans assume {cf.FILTER_BLOCKS_PER_SM}")
    emit({"phase": "kernels", "held": list(ck.MOMENT_KERNELS), "shapes": [name for name, _, _ in moment_cases],
          "S": sorted(moment_S), "K": [1, 3, 4, 33],
          "orders": moment_orders, "modes": sorted(moments_modes), "plans": len(moment_plans),
          "blocks_per_sm_least": min(moment_occupancy.values()), "blocks_per_sm": moment_occupancy,
          "tolerance": {"vs_plain": "(1e-5 + order^2*2^-24/4) of max|mu| (complex64 plain, same inputs)",
                        "vs_per_step_kernels": "1e-5 of max|mu| (ell_cheb_step launches and torch sums); "
                                               "a second launch bit-equal"},
          "max_rel_err": moments_err, "launches": ck.launch_counts()})

    # ------------------------------------------------------------------ 3a'''''. the power kernel, small shapes
    # ell_power_iteration in each mode, forced, against: its plain version (the
    # per-step loop in torch, complex64, the same v) and the per-step kernel path
    # (ce.power_recursion over ell_spmm: a launch, a norm and a division a step),
    # each within 1e-5 of the norm — float32 products and norms, the kernel's sums
    # in another order and its division after the product.  A second launch
    # repeats bit for bit; each launch is counted once with its steps.  At the
    # small shapes with S = 5 or 7 (one site a block; 4096 sites: 32 a block in
    # register mode, 8 in global), and at the lattices of the main path's bounds,
    # 64×64×4 (S = 7), 200×200, 32×32 and 100×100 (S = 5), random blocks.
    POWER_TOL = 1e-5

    def compare_power(data, sk, iters, seed, plans):
        """``(ok, errors, modes run)`` of the checks above; ``plans`` collects
        each plan run, for the occupancy check."""
        N, S = sk.cols.shape
        v = random_vector(N, 1, seed)
        plain = float(cf.ell_power_iteration_plain(data, sk, v, iters))
        per_step = float(ce.power_recursion(lambda w: ce.ell_spmm(data, sk, w), v, iters))
        ok, errs, ran = True, {"vs_plain_rel": 0.0, "vs_per_step_rel": 0.0}, []
        for mode in cf.MODES:
            plan = cf.power_plan(N, S, iters, mode=mode)  # every shape here fits both
            plans[(mode, plan["sites_per_block"], S)] = plan
            before = ck.launch_counts()
            n = cf.ell_power_iteration(data, sk, v, iters, mode=mode)
            n_again = cf.ell_power_iteration(data, sk, v, iters, mode=mode)
            torch.cuda.synchronize()
            launched = launched_since(before)
            e_plain, e_step = abs(float(n) - plain) / plain, abs(float(n) - per_step) / per_step
            errs = {"vs_plain_rel": max(errs["vs_plain_rel"], e_plain),
                    "vs_per_step_rel": max(errs["vs_per_step_rel"], e_step)}
            ok = (ok and n.dim() == 0 and n.dtype == torch.float32 and math.isfinite(float(n))
                  and e_plain <= POWER_TOL and e_step <= POWER_TOL and torch.equal(n_again, n)
                  and launched == counts(ell_power_iteration=2, **{"ell_power_iteration.steps": 2 * iters}))
            ran.append(mode)
        return ok, errs, ran

    power_err, power_plans, power_S = {"vs_plain_rel": 0.0, "vs_per_step_rel": 0.0}, {}, set()
    power_cases = list(moment_cases)
    power_cases += [(str(shape), *random_system(shape, seed=650 + i))
                    for i, shape in enumerate(((64, 64, 4), (200, 200, 1), (32, 32, 1), (100, 100, 1)))]
    for name, data, sk in power_cases:
        power_S.add(sk.n_slots)
        for iters in ((1, 2, 3, 60) if sk.n_sites <= 4096 else (60,)):
            ok, err, ran = compare_power(data, sk, iters, seed=700 + iters, plans=power_plans)
            check(ok and ran == list(cf.MODES), f"power kernel on {name}, iters={iters}: {err}, {ran}")
            power_err = {k: max(power_err[k], err[k]) for k in power_err}
    check(power_S == {5, 7}, f"the small shapes held the power kernel only at S in {power_S}")
    power_occupancy = {f"{m}_SB{sb}_S{S_o}": cf.occupancy(plan, S_o, kind="power")
                       for (m, sb, S_o), plan in power_plans.items()}
    check(min(power_occupancy.values()) >= cf.FILTER_BLOCKS_PER_SM,
          f"the power kernel holds {power_occupancy} blocks an SM, the plans assume {cf.FILTER_BLOCKS_PER_SM}")
    emit({"phase": "kernels", "held": list(ck.POWER_KERNELS), "shapes": [name for name, _, _ in power_cases],
          "S": sorted(power_S), "iters": [1, 2, 3, 60], "modes": list(cf.MODES), "plans": len(power_plans),
          "blocks_per_sm_least": min(power_occupancy.values()), "blocks_per_sm": power_occupancy,
          "tolerance": {"vs_plain": f"{POWER_TOL} of the norm (complex64 plain, same v)",
                        "vs_per_step_kernels": f"{POWER_TOL} of the norm (ell_spmm launches, torch norms and "
                                               "divisions); a second launch bit-equal"},
          "max_rel_err": power_err, "launches": ck.launch_counts()})
    del power_cases

    # ------------------------------------------------------------------ 3a''''''. the probe kernel, small shapes
    # Bit for bit against its plain version at this card's stride and against
    # NumPy's draw; the last case has more outputs than threads (several strides).
    probe_cases = [(1, 1, 0, c64), (7, 3, None, torch.float32), (1000, 8, 7919, c64),
                   (1000, 8, 2**62 - 1, torch.float32), (70_000, 8, 3, c64)]
    launched = cp.rademacher.launches
    for N_p, K_p, seed, dtype in probe_cases:
        np_dtype = np.complex64 if dtype == c64 else np.float32
        got = cp.rademacher(N_p, K_p, seed, dtype, dev).cpu()
        blocks = cp.draw_plan(N_p * 2 * K_p, ce.sm_count())
        check(torch.equal(got, torch.from_numpy(cp.rademacher_plain(N_p, K_p, seed, np_dtype, blocks=blocks))),
              f"the probe kernel disagrees with its plain version at N={N_p}, samples={K_p}, seed={seed}, {dtype}")
        check(torch.equal(got, torch.from_numpy(kpm.rademacher_probes(N_p, K_p, seed, np_dtype))),
              f"the probe kernel disagrees with NumPy's draw at N={N_p}, samples={K_p}, seed={seed}, {dtype}")
    check(cp.rademacher.launches - launched == len(probe_cases), "the probe kernel's launches were not counted")
    emit({"phase": "kernels", "held": ["rademacher"], "cases": [[n, k, s, str(d)] for n, k, s, d in probe_cases],
          "tolerance": "bit-equal to its plain version and to rademacher_probes",
          "launches": cp.rademacher.launches})
    if quick:
        return 0

    def normal_metal(shape, dtype=None):
        """Tight-binding metal at half filling, open boundaries: the system of the
        reference's self-consistency showcase (t = 1, μ = 0)."""
        system = Hamiltonian(CubicLattice(shape), dtype=dtype, device=dev)
        system.assemble(
            onsite=lambda ci: 0.0 * σ0,
            hopping=lambda ci, cj: np.where(
                (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0
            ),
            check=False,
        )
        return system

    def bound_row(name, label, sk, K, ms, plain_ms, nbytes, flops, err, library_ms, library, runs):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        row = {
            "phase": "kernels", "shape": label, "N": sk.n_sites, "S": sk.n_slots, "K": K, "name": name,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_ms_measured_copy": nbytes / copy_bytes_per_s * 1e3,
            "achieved_GBps": nbytes / ms / 1e6, "library_ms": library_ms, "library": library,
            "runs_ms": runs,
        }
        emit(row)
        return row

    def library_spmm(data, sk, v):
        """One PyTorch sparse product for the same function, or the reason there is none."""
        N, K = sk.n_sites, v.shape[-1]
        indptr, indices, rows_sel, slots_sel = bs._sorted_block_lists(sk)
        blocks = data[torch.as_tensor(rows_sel, device=dev), torch.as_tensor(slots_sel, device=dev)]
        dense_v = v.reshape(4 * N, K)
        errors = []
        for layout in ("bsr", "csr"):
            try:
                A = torch.sparse_bsr_tensor(
                    torch.as_tensor(indptr, device=dev), torch.as_tensor(indices.astype(np.int64), device=dev),
                    blocks, size=(4 * N, 4 * N),
                )
                if layout == "csr":
                    A = A.to_sparse_csr()
                y = (A @ dense_v).reshape(N, 4, K)
                torch.cuda.synchronize()
                return layout, (lambda: A @ dense_v), y, errors
            except Exception as e:  # only the yardstick may be missing; the port never calls it
                errors.append(f"{layout}: {type(e).__name__}: {str(e)[:120]}")
        return None, None, None, errors

    def library_sddmm(sk, g, t, alpha, start):
        """``torch.sparse.sampled_addmm`` for the function of ell_block_outer, or
        the reason there is none.  The block pattern is expanded to CSR once (16
        entries per stored block, sorted by row and column) with the entries of
        ``start`` as its values.  Returns the form that worked, a call with
        beta = 1 to time, and the beta = 0 result scattered back to
        ``[N, S, 4, 4]``."""
        N, K = sk.n_sites, g.shape[-1]
        n_idx, s_idx = sk.device_valid(dev).nonzero(as_tuple=True)
        four = torch.arange(BLOCK, device=dev)
        rows = (BLOCK * n_idx[:, None, None] + four[None, :, None]).expand(-1, BLOCK, BLOCK).reshape(-1)
        cols = (BLOCK * sk.device_safe_cols(dev)[n_idx, s_idx][:, None, None] + four[None, None, :])
        cols = cols.expand(-1, BLOCK, BLOCK).reshape(-1)
        key, order = torch.sort(rows * (BLOCK * N) + cols)
        if bool((key[1:] == key[:-1]).any()):
            return None, None, None, ["two slots of a row name the same column: no CSR pattern"]
        crow = torch.zeros(BLOCK * N + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=BLOCK * N), 0)
        G2, t2 = g.reshape(BLOCK * N, K), t.reshape(BLOCK * N, K)
        errors = []
        forms = (("mat2 = conj(t).T, conjugate bit set", lambda: t2.conj().T),
                 ("mat2 = conj(t).T, conjugate resolved inside the timed call", lambda: t2.conj().resolve_conj().T))
        for form, mat2 in forms:
            try:
                pattern = torch.sparse_csr_tensor(crow, cols[order], start[n_idx, s_idx].reshape(-1)[order],
                                                  size=(BLOCK * N, BLOCK * N))
                values = torch.sparse.sampled_addmm(pattern, G2, mat2(), alpha=alpha, beta=0.0).values()
                flat = torch.empty_like(values)
                flat[order] = values
                h_lib = torch.zeros_like(start)
                h_lib[n_idx, s_idx] = flat.reshape(-1, BLOCK, BLOCK)
                torch.cuda.synchronize()
                fn = lambda: torch.sparse.sampled_addmm(pattern, G2, mat2(), alpha=alpha, beta=1.0)
                return form, fn, h_lib, errors
            except Exception as e:  # only the yardstick may be missing; the port never calls it
                errors.append(f"{form}: {type(e).__name__}: {str(e)[:120]}")
        return None, None, None, errors

    def moments_row(name, label, system, K, order, bf16=False):
        """One sweep of ``order`` moments at width K on ``system``'s operator (its
        bf16 form with ``bf16``) through the moment kernel in the planned mode:
        against its plain version (complex64, the same inputs), and timed in turns
        with the per-step path it replaced (ce.moment_recursion over ell_cheb_step:
        a launch and a torch sum a fused step, CUDA events around the host's loop) — per-step
        path, kernel, kernel, per-step path — beside ell_cheb_step from 200
        launches replayed in a CUDA graph.  ms is the wrapper's call (the launch,
        the sum over the grid, the assembly).  bound_ms for the function: the
        operator, cols and v0 read once and the moments written once over the
        memory rate, or the operations of its fused steps (product, tail, sums) at
        the float32 rate; beside it the per-step byte bound the steps would take
        apart (chebyshev_step_bytes a step)."""
        sk = system.skeleton
        N, S = sk.cols.shape
        form = ce.bf16_operator(system.data) if bf16 else system.data
        inv = 1.0 / kpm.spectral_bound(system.data, sk)
        steps = ce.sweep_launches(order)
        v, t_prev = random_vector(N, K, 995), random_vector(N, K, 996)
        out = torch.empty_like(v)
        mu = cf.ell_cheb_moments(form, sk, v, inv, order)
        step = per_step_kernel(form, sk)
        per_step = lambda: ce.moment_recursion(step, v, inv, order)
        # Held as the small shapes are: the plain version within
        # (1e-5 + order²·2⁻²⁴/4)·max|μ|, the per-step kernels within 1e-5·max|μ|.
        plain = cf.ell_cheb_moments_plain(form, sk, v, inv, order)
        scale = float(plain.abs().max())
        err = float((mu - plain).abs().max())
        err_step = float((mu - per_step()).abs().max())
        check(tuple(mu.shape) == (order, K) and bool(torch.isfinite(mu).all())
              and err <= (1e-5 + order ** 2 * EPS32 / 4) * scale and err_step <= 1e-5 * scale,
              f"{name} on {label}: {err / scale} of max|mu| from its plain version, {err_step / scale} "
              "from the per-step kernels")
        kernel = lambda: cf.ell_cheb_moments(form, sk, v, inv, order)
        per_step_a = timed_ms(per_step, 3)
        runs = [timed_ms(kernel, 5), timed_ms(kernel, 5)]
        per_step_b = timed_ms(per_step, 3)
        plain_ms = timed_ms(lambda: cf.ell_cheb_moments_plain(form, sk, v, inv, order), 1)
        graph = graph_ms(lambda: ce.ell_cheb_step(form, sk, v, t_prev, 0.125, out=out))
        op_item = 2 if bf16 else None
        entries = N * BLOCK * K
        nbytes = spmm_bytes(sk, K, 8, operator_itemsize=op_item) - entries * 8 + N * S * 4 + order * K * 4
        flops = steps * (spmm_flops(sk, K) + 12 * entries)
        row = bound_row(name, label, sk, K, min(runs), plain_ms, nbytes, flops, err, None,
                        "none (no torch call runs a Chebyshev recursion)", runs)
        step_bound = chebyshev_step_bytes(sk, K, 8, operator_itemsize=op_item) / HBM_BYTES_PER_S * 1e3
        per_step_ms = min(per_step_a, per_step_b)
        row.update(order=order, steps=steps, plan=cf.moments_plan(N, K, S, order, bf16=bf16),
                   max_rel_err=err / scale, vs_per_step_rel=err_step / scale,
                   ms_per_step=row["ms"] / steps, step_bound_ms=step_bound,
                   share_of_step_bound=step_bound * steps / row["ms"], per_step_path_ms=per_step_ms,
                   per_step_path_runs_ms=[per_step_a, per_step_b], per_step_path_ms_per_step=per_step_ms / steps,
                   ell_cheb_step_graph_ms=graph, over_per_step_path=row["ms"] / per_step_ms,
                   over_graph_replayed_steps=row["ms"] / (graph * steps))
        emit({"phase": "main" if not bf16 else "bf16", "timing": name, "sweep": label, "K": K, "order": order,
              "ms": row["ms"], "ms_per_step": row["ms_per_step"], "step_bound_ms": step_bound,
              "vs_plain_rel": err / scale, "vs_per_step_rel": err_step / scale,
              "share_of_step_bound": row["share_of_step_bound"], "per_step_path_ms_per_step":
              row["per_step_path_ms_per_step"], "ell_cheb_step_graph_ms": graph, "bound_ms": row["bound_ms"],
              "bound_by": row["bound_by"], "plan": row["plan"]})
        return row

    ITERS = 60  # spectral_bound's power iterations

    def expected_bound(sk) -> dict:
        """Launches one spectral bound on ``sk`` makes on the general step: one
        ell_power_iteration launch of ITERS steps where power_plan fits, else
        ITERS ell_spmm launches."""
        if cf.power_plan(sk.n_sites, sk.n_slots, ITERS)["mode"] == "per_step":
            return {"ell_spmm": ITERS}
        return {"ell_power_iteration": 1, "ell_power_iteration.steps": ITERS}

    def power_row(label, system, phase):
        """One spectral bound's power iteration (ITERS steps, K = 1) on
        ``system``'s operator through the power kernel in the planned mode:
        against its plain version and the per-step path it replaced
        (ce.power_recursion over ell_spmm: a launch, a norm and a division a
        step) within POWER_TOL of the norm, a second call bit-equal; then timed
        in turns with that per-step path (CUDA events around the host's loop) —
        per-step path, kernel, kernel, per-step path — beside one iteration of
        it (ell_spmm, norm, division) and ell_spmm alone, each replayed from a
        CUDA graph, ell_spmm back to back from the host, and the library's
        product at K = 1 (torch.sparse BSR @ dense).  ms is the wrapper's call
        (the normalisation, the launch, the sum and square root).  bound_ms for
        the function: operator, cols and v read once and the norm written, over
        the memory rate, or the operations of ITERS steps (product, division,
        squared norm) at the float32 rate; beside it the per-step byte bound
        (spmm_bytes at K = 1)."""
        sk = system.skeleton
        N, S = sk.cols.shape
        data = system.data
        plan = cf.power_plan(N, S, ITERS)
        v = random_vector(N, 1, 997)
        u = v / torch.linalg.norm(v)
        kernel = lambda: cf.ell_power_iteration(data, sk, v, ITERS)
        per_step = lambda: ce.power_recursion(lambda w: ce.ell_spmm(data, sk, w), v, ITERS)
        n, n_again = kernel(), kernel()
        plain, n_step = float(cf.ell_power_iteration_plain(data, sk, v, ITERS)), float(per_step())
        err, err_step = abs(float(n) - plain), abs(float(n) - n_step)
        check(math.isfinite(float(n)) and err <= POWER_TOL * plain and err_step <= POWER_TOL * n_step
              and torch.equal(n, n_again),
              f"ell_power_iteration on {label}: {err / plain} of the norm from its plain version, "
              f"{err_step / n_step} from the per-step kernels, repeat bit-equal {torch.equal(n, n_again)}")
        per_step_a = timed_ms(per_step, 3)
        runs = [timed_ms(kernel, 5), timed_ms(kernel, 5)]
        per_step_b = timed_ms(per_step, 3)
        plain_ms = timed_ms(lambda: cf.ell_power_iteration_plain(data, sk, v, ITERS), 1)

        def one_iteration():
            w = ce.ell_spmm(data, sk, u)
            return w / torch.linalg.norm(w)

        iteration_graph = graph_ms(one_iteration)
        spmm_graph = graph_ms(lambda: ce.ell_spmm(data, sk, u))
        spmm_host = timed_ms(lambda: ce.ell_spmm(data, sk, u), 200)
        lib_layout, lib_fn, lib_y, lib_errors = library_spmm(data, sk, u)
        lib_ms = None
        if lib_fn is not None:
            check(torch.allclose(lib_y, ce.ell_spmm(data, sk, u), atol=2e-4, rtol=2e-4),
                  "library product disagrees with the kernel at K = 1")
            lib_ms = timed_ms(lib_fn, 50)
        entries = N * BLOCK
        nbytes = data.numel() * 8 + N * S * 4 + entries * 8 + 4
        flops = ITERS * (spmm_flops(sk, 1) + 6 * entries)
        row = bound_row("ell_power_iteration", label, sk, 1, min(runs), plain_ms, nbytes, flops, err, lib_ms,
                        f"torch.sparse {lib_layout} @ dense, one product of the {ITERS}" if lib_fn is not None
                        else "none: " + "; ".join(lib_errors), runs)
        step_bound = spmm_bytes(sk, 1, 8) / HBM_BYTES_PER_S * 1e3
        per_step_ms = min(per_step_a, per_step_b)
        row.update(steps=ITERS, plan=plan, max_rel_err=err / plain, vs_per_step_rel=err_step / n_step,
                   ms_per_step=row["ms"] / ITERS, step_bound_ms=step_bound,
                   share_of_step_bound=step_bound * ITERS / row["ms"], per_step_path_ms=per_step_ms,
                   per_step_path_runs_ms=[per_step_a, per_step_b], per_step_path_ms_per_step=per_step_ms / ITERS,
                   iteration_graph_ms=iteration_graph, over_per_step_path=row["ms"] / per_step_ms,
                   over_graph_replayed_iterations=row["ms"] / (iteration_graph * ITERS),
                   ell_spmm_K1={"graph_ms": spmm_graph, "host_issue_ms": spmm_host, "bound_ms": step_bound,
                                "share_of_bound_graph": step_bound / spmm_graph})
        emit({"phase": phase, "timing": "ell_power_iteration", "bound_of": label, "N": N, "S": S, "steps": ITERS,
              "ms": row["ms"], "ms_per_step": row["ms_per_step"], "step_bound_ms": step_bound,
              "vs_plain_rel": err / plain, "vs_per_step_rel": err_step / n_step,
              "per_step_path_ms_per_step": row["per_step_path_ms_per_step"], "iteration_graph_ms": iteration_graph,
              "ell_spmm_K1": row["ell_spmm_K1"], "library_ms": lib_ms, "bound_ms": row["bound_ms"],
              "bound_by": row["bound_by"], "plan": plan})
        del lib_fn, lib_y
        return row

    shared = {}  # results one phase hands to a later one

    def phase_main():
        """The first path: the KPM observables at 1000×1000, their kernels at that
        shape, and the path checked against complex128."""
        # ------------------------------------------------------------------ 4. main path, full size
        energies = np.linspace(-1.0, 1.0, 41)
        expected = counts()  # the backward kernels stay at 0 on this path

        def call(label, fn, order, K, sk, bound=False, products=0, window=0):
            """Run one entry point, synchronised; account for the launches it must
            make: its moment sweep (``order``; ``window`` of its steps in the
            light-cone form), its spectral bound (``bound``) and ``products``
            ell_spmm launches besides."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = ce.sweep_launches(order) if order else 0
            mode = cf.moments_plan(sk.n_sites, K, sk.n_slots, order)["mode"] if order else None
            if mode == "per_step":  # 10⁶ sites: one ell_cheb_step launch a fused step
                expected["ell_cheb_step"] += steps - window
                expected["ell_cheb_step_window"] += window
            elif mode is not None:  # one launch of the moment kernel a sweep
                expected["ell_cheb_moments"] += 1
                expected["ell_cheb_moments.steps"] += steps
            bound_mode = cf.power_plan(sk.n_sites, sk.n_slots, ITERS)["mode"] if bound else None
            for name, n in expected_bound(sk).items() if bound else ():
                expected[name] += n
            expected["ell_spmm"] += products
            rec = {"phase": "main", "call": label, "wall_s": wall, "fused_steps": steps, "moments_mode": mode,
                   "bound_mode": bound_mode, "spmm_launches": products + (ITERS if bound_mode == "per_step" else 0)}
            if steps:
                step_bytes = chebyshev_step_bytes(sk, K, 8)
                rec.update({
                    "K": K, "step_bytes": step_bytes,
                    "achieved_GBps_over_wall": steps * step_bytes / wall / 1e9,
                    "bound_ms_per_step_datasheet": step_bytes / HBM_BYTES_PER_S * 1e3,
                    "bound_ms_per_step_measured_copy": step_bytes / copy_bytes_per_s * 1e3,
                })
            emit(rec)
            return out

        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        big = swave_superconductor((1000, 1000, 1))  # on the card, complex64, Hermiticity-gated
        torch.cuda.synchronize()
        sk_big = big.skeleton
        check(big.data.is_cuda and big.data.dtype == c64, "the full-size system is not complex64 on the card")
        emit({"phase": "main", "call": "swave_superconductor((1000,1000,1))", "wall_s": time.perf_counter() - t0,
              "N": sk_big.n_sites, "S": sk_big.n_slots, "data_MB": big.data.numel() * 8 / 1e6,
              "hermiticity_error": big._hermiticity_error()})

        scale_big = call("spectral_bound", lambda: kpm.spectral_bound(big.data, sk_big), 0, 1, sk_big, bound=True)
        kpm.reset_probe_draw_counts()
        F_cold = call("free_energy(T=0.01, kpm, order=256, samples=8)",
                      lambda: big.free_energy(0.01, method="kpm", order=256, samples=8), 256, 8, sk_big, bound=True)
        F_warm = call("free_energy(T=0.5, kpm, order=256, samples=8)",
                      lambda: big.free_energy(0.5, method="kpm", order=256, samples=8, scale=scale_big),
                      256, 8, sk_big)
        probe_draws = kpm.probe_draw_counts()  # both free-energy calls drew their probes on the card
        check(probe_draws == {"probes.card": 2, "probes.host": 0}, f"the probes were drawn as {probe_draws}")
        centre = [big.lattice[(500, 500, 0)]]
        rho = call("ldos((500,500,0), order=512)",
                   lambda: big.ldos((500, 500, 0), energies, method="kpm", order=512, scale=scale_big),
                   512, 4, sk_big, window=cone_steps(big.data, sk_big, centre, 4, 512))
        sites = [(100 + 50 * i, 100 + 50 * j, 0) for i in range(4) for j in range(4)]
        flat = [big.lattice[c] for c in sites]
        rho_map = call("ldos_map(16 sites, order=512)",
                       lambda: big.ldos_map(sites, energies, method="kpm", order=512, scale=scale_big),
                       512, 64, sk_big, window=cone_steps(big.data, sk_big, flat, 64, 512))
        dos = call("dos(order=256, samples=8)",
                   lambda: big.dos(energies, order=256, samples=8, scale=scale_big), 256, 8, sk_big)
        v_big = random_vector(sk_big.n_sites, 8, 7)
        y_big = call("apply(K=8)", lambda: big.apply(v_big), 0, 8, sk_big, products=1)

        t0 = time.perf_counter()
        rashba = rashba_dp_wave((64, 64, 4))
        torch.cuda.synchronize()
        sk_r = rashba.skeleton
        emit({"phase": "main", "call": "rashba_dp_wave((64,64,4))", "wall_s": time.perf_counter() - t0,
              "N": sk_r.n_sites, "S": sk_r.n_slots, "hermiticity_error": rashba._hermiticity_error()})
        F_r = call("rashba free_energy(T=0.01, kpm, order=256, samples=8)",
                   lambda: rashba.free_energy(0.01, method="kpm", order=256, samples=8), 256, 8, sk_r, bound=True)
        rho_r = call("rashba ldos((32,32,2), order=512)",
                     lambda: rashba.ldos((32, 32, 2), energies, method="kpm", order=512), 512, 4, sk_r, bound=True)

        t0 = time.perf_counter()
        square = swave_superconductor((200, 200, 1))  # BASELINE config 3: KPM LDOS on 200×200 s-wave
        torch.cuda.synchronize()
        sk_q = square.skeleton
        emit({"phase": "main", "call": "swave_superconductor((200,200,1))", "wall_s": time.perf_counter() - t0,
              "N": sk_q.n_sites, "S": sk_q.n_slots, "hermiticity_error": square._hermiticity_error()})
        rho_q = call("200x200 ldos((100,100,0), order=512)",
                     lambda: square.ldos((100, 100, 0), energies, method="kpm", order=512), 512, 4, sk_q,
                     bound=True)

        main_launches = ck.launch_counts()  # read right after the main path
        peak_GB = torch.cuda.max_memory_allocated() / 1e9

        mid = len(energies) // 2
        outside = np.abs(energies) >= 0.5  # beyond the s-wave gap Δ = 0.3
        check(main_launches == expected, f"launch counters {main_launches} != expected {expected}")
        check(main_launches["ell_spmm"] > 0 and main_launches["ell_cheb_step"] > 0
              and main_launches["ell_cheb_step_window"] == 2 * ce.sweep_launches(512)
              and main_launches["ell_cheb_moments"] == 3 and main_launches["ell_power_iteration"] == 3
              and cf.power_plan(sk_big.n_sites, sk_big.n_slots, ITERS)["mode"] == "per_step",
              "a kernel of the main path was never launched, or the 10⁶ bounds were not per step")
        check(rho.shape == (41,) and np.isfinite(rho).all() and rho.min() >= -1e-6, "LDOS not finite / negative")
        check(rho[mid] < 0.1 * rho[outside].mean(), f"no s-wave gap: rho(0)={rho[mid]} vs {rho[outside].mean()}")
        check(rho_map.shape == (16, 41) and np.isfinite(rho_map).all() and rho_map.min() >= -1e-6, "LDOS map wrong")
        check(bool((rho_map[:, mid] < 0.1 * rho_map[:, outside].mean(axis=1)).all()), "LDOS map shows no gap")
        check(dos.shape == (41,) and np.isfinite(dos).all() and dos[mid] < 0.1 * dos[outside].mean(), "DOS shows no gap")
        check(math.isfinite(F_cold) and math.isfinite(F_warm) and F_warm < F_cold < 0, "F not finite or not falling with T")
        check(tuple(y_big.shape) == (sk_big.n_sites, 4, 8) and bool(torch.isfinite(torch.view_as_real(y_big)).all()),
              "apply output wrong")
        check(math.isfinite(F_r) and F_r < 0 and np.isfinite(rho_r).all() and rho_r.min() >= -1e-6,
              "Rashba free energy / LDOS wrong")
        check(rho_q.shape == (41,) and np.isfinite(rho_q).all() and rho_q.min() >= -1e-6
              and rho_q[mid] < 0.1 * rho_q[outside].mean(), f"200x200 LDOS wrong or without a gap: {rho_q}")
        emit({"phase": "main", "launches": main_launches, "expected": expected, "scale": scale_big,
              "F(T=0.01)": F_cold, "F(T=0.5)": F_warm, "F_per_site": F_cold / sk_big.n_sites,
              "rho(0)": float(rho[mid]), "rho(|e|>=0.5) mean": float(rho[outside].mean()),
              "rashba_F": F_r, "200x200 rho(0)": float(rho_q[mid]), "peak_device_GB": peak_GB,
              "probe_draws_of_the_two_free_energy_calls": probe_draws})

        # ------------------------------------------------------------------ 3b'. the probe kernel at the free-energy call's shape
        N_p, K_p = sk_big.n_sites, 8
        for seed in (3, 2**62 - 1, 2_718_281_828):
            got = cp.rademacher(N_p, K_p, seed, c64, dev)
            check(torch.equal(got.cpu(), torch.from_numpy(kpm.rademacher_probes(N_p, K_p, seed, np.complex64))),
                  f"the probe kernel disagrees with NumPy's draw at N={N_p}, samples={K_p}, seed={seed}")
        del got
        probe_bytes = N_p * BLOCK * K_p * 8  # written once; nothing read
        probe_ms = timed_ms(lambda: cp.rademacher(N_p, K_p, 5, c64, dev), 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_block = kpm._as_tensor(kpm.rademacher_probes(N_p, K_p, 5, np.complex64), big.data)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(host_block, cp.rademacher(N_p, K_p, 5, c64, dev)), "the timed draws differ")
        del host_block
        blocks = cp.draw_plan(N_p * 2 * K_p, ce.sm_count())
        emit({"phase": "main", "timing": "rademacher", "N": N_p, "samples": K_p, "dtype": "complex64",
              "seeds_held": 3, "blocks": blocks, "threads": blocks * cp.THREADS, "ms": probe_ms,
              "bound_ms": probe_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes written",
              "share_of_bound": probe_bytes / HBM_BYTES_PER_S * 1e3 / probe_ms,
              "replaced_host_draw_cast_and_upload_ms": host_ms})

        # ------------------------------------------------------------------ 3b. kernels, main path's shapes
        kernel_rows = {}
        for label, system, sk in (("swave 1000x1000x1", big, sk_big), ("rashba 64x64x4", rashba, sk_r)):
            K, N, data = 8, sk.n_sites, system.data
            ok, err = compare(data, sk, K, seed=21)
            check(ok, f"kernel disagrees with its plain version at {label}, K={K}: {err}")
            t_cur, t_prev = random_vector(N, K, 31), random_vector(N, K, 32)
            out = torch.empty_like(t_cur)
            reps = 20 if N > 100_000 else 200
            lib_layout, lib_fn, lib_y, lib_errors = library_spmm(data, sk, t_cur)
            if lib_fn is not None:
                check(torch.allclose(lib_y, ce.ell_spmm(data, sk, t_cur), atol=2e-4, rtol=2e-4),
                      "library product disagrees with the kernel")
            # plain, kernel, kernel, plain: both versions in turns on the one card
            spmm_plain_a = timed_ms(lambda: ce.ell_spmm_plain(data, sk, t_cur), 5)
            spmm_a = timed_ms(lambda: ce.ell_spmm(data, sk, t_cur), reps)
            cheb_a = timed_ms(lambda: ce.ell_cheb_step(data, sk, t_cur, t_prev, 0.125, out=out), reps)
            cheb_plain_a = timed_ms(lambda: ce.ell_cheb_step_plain(data, sk, t_cur, t_prev, 0.125), 5)
            lib_ms = timed_ms(lib_fn, 5) if lib_fn is not None else None
            cheb_b = timed_ms(lambda: ce.ell_cheb_step(data, sk, t_cur, t_prev, 0.125, out=out), reps)
            spmm_b = timed_ms(lambda: ce.ell_spmm(data, sk, t_cur), reps)
            spmm_plain_b = timed_ms(lambda: ce.ell_spmm_plain(data, sk, t_cur), 5)
            del lib_fn, lib_y
            for name, runs, plain_ms, nbytes, library in (
                ("ell_spmm", [spmm_a, spmm_b], min(spmm_plain_a, spmm_plain_b), spmm_bytes(sk, K, 8), lib_ms),
                ("ell_cheb_step", [cheb_a, cheb_b], cheb_plain_a, chebyshev_step_bytes(sk, K, 8), None),
            ):
                row = bound_row(
                    name, label, sk, K, min(runs), plain_ms, nbytes, spmm_flops(sk, K), err[name], library,
                    (f"torch.sparse {lib_layout} @ dense" if library is not None else
                     ("none: " + "; ".join(lib_errors) if name == "ell_spmm" else "none")), runs,
                )
                kernel_rows.setdefault(name, row)  # the first shape is the main path's own

        # The moment kernel at the main path's three sweeps that launch it: the first
        # is its line in the kernels table.
        for label, system, K, order in (("rashba 64x64x4, free_energy's sweep", rashba, 8, 256),
                                        ("rashba 64x64x4, ldos' sweep", rashba, 4, 512),
                                        ("swave 200x200x1, ldos' sweep", square, 4, 512)):
            kernel_rows.setdefault("ell_cheb_moments", moments_row("ell_cheb_moments", label, system, K, order))
        # The power kernel at the two lattices of the main path whose bounds launch it.
        for label, system in (("rashba 64x64x4", rashba), ("swave 200x200x1", square)):
            kernel_rows.setdefault("ell_power_iteration", power_row(label, system, "main"))

        # ------------------------------------------------------------------ 5. main path, checked
        # impl="cuda" (kernels, complex64 after the down-cast) against impl="plain"
        # in complex128, both on the card, same scale and probes.  Moments to
        # 2e-4 of the largest moment (float32 recursion over `order` steps);
        # free energy to 1e-4 relative (a float32 sum over 4N entries per probe,
        # then a short series); LDOS to 1e-3 of the curve's maximum (the series
        # weights amplify moment errors by about the order).
        for label, system in (
            ("swave (48,48,1)", swave_superconductor((48, 48, 1), dtype=np.complex128)),
            ("rashba (12,12,4)", rashba_dp_wave((12, 12, 4), dtype=np.complex128)),
        ):
            sk = system.skeleton
            N = sk.n_sites
            scale = kpm.spectral_bound(system.data, sk, impl="plain")
            probes = kpm.rademacher_probes(N, 8, 3, np.complex128)
            site = tuple(s // 2 for s in sk.shape)
            mu, F, ld = {}, {}, {}
            for impl in ("cuda", "plain"):
                before = ck.launch_counts()
                mu[impl] = kpm.moments(system.data, sk, probes, 64, scale, impl=impl).double().cpu().numpy()
                F[impl] = system.free_energy(0.01, method="kpm", order=128, samples=8, scale=scale, impl=impl)
                ld[impl] = system.ldos(site, energies, method="kpm", order=128, scale=scale, impl=impl)
                launched = launched_since(before)
                want = counts(ell_cheb_moments=3, **{"ell_cheb_moments.steps": ce.sweep_launches(64)
                                                     + 2 * ce.sweep_launches(128)}) if impl == "cuda" else counts()
                check(launched == want, f"{label}: impl={impl} launched {launched}, expected {want}")
            errs = {
                "moments_rel_to_max": float(np.abs(mu["cuda"] - mu["plain"]).max() / np.abs(mu["plain"]).max()),
                "free_energy_rel": abs(F["cuda"] - F["plain"]) / abs(F["plain"]),
                "ldos_rel_to_max": float(np.abs(ld["cuda"] - ld["plain"]).max() / np.abs(ld["plain"]).max()),
            }
            emit({"phase": "checked", "system": label, "scale": scale, "F_cuda": F["cuda"], "F_plain": F["plain"], **errs})
            check(errs["moments_rel_to_max"] <= 2e-4, f"{label}: moments off by {errs['moments_rel_to_max']}")
            check(errs["free_energy_rel"] <= 1e-4, f"{label}: free energy off by {errs['free_energy_rel']}")
            check(errs["ldos_rel_to_max"] <= 1e-3, f"{label}: LDOS off by {errs['ldos_rel_to_max']}")
        return main_launches, kernel_rows

    # ------------------------------------------------------------------ 6. other probe widths
    def phase_widths():
        """The forward kernels at the probe widths the entry points use beside
        K = 8, at N = 10⁶: K = 1 (spectral bound), K = 4 (LDOS), K = 64 (LDOS map)."""
        big = swave_superconductor((1000, 1000, 1))
        sk = big.skeleton
        N, flops1 = sk.n_sites, spmm_flops(sk, 1)
        for name, K in (("ell_spmm", 1), ("ell_spmm", 8), ("ell_cheb_step", 4),
                        ("ell_cheb_step", 8), ("ell_cheb_step", 64)):
            t_cur, t_prev = random_vector(N, K, 41), random_vector(N, K, 42)
            out = torch.empty_like(t_cur)
            if name == "ell_spmm":
                fn, nbytes = (lambda: ce.ell_spmm(big.data, sk, t_cur)), spmm_bytes(sk, K, 8)
            else:
                fn = lambda: ce.ell_cheb_step(big.data, sk, t_cur, t_prev, 0.125, out=out)
                nbytes = chebyshev_step_bytes(sk, K, 8)
            runs = [timed_ms(fn, 20), timed_ms(fn, 20)]
            by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, K * flops1 / FP32_FLOPS_PER_S * 1e3
            emit({"phase": "widths", "name": name, "N": N, "S": sk.n_slots, "K": K, "ms": min(runs),
                  "runs_ms": runs, "bytes": nbytes, "bound_ms": max(by_bytes, by_ops),
                  "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                  "achieved_GBps": nbytes / min(runs) / 1e6})
            del t_cur, t_prev, out

    # ------------------------------------------------------------------ 7. gradients on the card
    def chebstep_on_card(sk, K, label):
        """One ChebStep.apply through the kernels, forward and backward, on
        non-Hermitian complex64 data, against torch.autograd through the plain
        step in complex128: cotangents of the operator and of both vectors to
        2e-4 of the largest entry of each, three launches in all."""
        N = sk.n_sites
        data = random_blocks(sk, 301)
        t_cur, t_prev, w_next = (random_vector(N, K, 302 + i) for i in range(3))
        w_sums = torch.linspace(0.5, -1.0, 2 * K, device=dev)
        got_want = []
        before = ck.launch_counts()
        for impl, dtype in (("cuda", c64), ("plain", c128)):
            d, a, b = (x.to(dtype).requires_grad_(True) for x in (data, t_cur, t_prev))
            if impl == "cuda":
                t_next, sums = ck.ChebStep.apply(d, a, b, sk, 0.11, "cuda")
            else:
                t_next, pp = ce.ell_cheb_step_plain(d, sk, a, b, 0.11)
                sums = pp[0]
            loss = (t_next * w_next.to(dtype).conj()).real.sum() + (sums * w_sums.to(sums.dtype)).sum()
            got_want.append(torch.autograd.grad(loss, (d, a, b)))
        torch.cuda.synchronize()
        after = ck.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        check(launched == counts(ell_cheb_step=1, ell_spmm_adjoint=1, ell_block_outer=1),
              f"{label}: ChebStep forward and backward launched {launched}, expected one of each step kernel")
        errs = {}
        for name, got, want in zip(("d_data", "d_t_cur", "d_t_prev"), *got_want):
            errs[name + "_rel_to_max"] = float((got - want).abs().max() / want.abs().max())
            check(errs[name + "_rel_to_max"] <= 2e-4, f"{label}: ChebStep cotangent {name} off by {errs}")
        return errs

    def phase_grad():
        """d(Σ_m w_m Σ_k μ_m[k]) / d(data) and / d(v0) through moments_fused_ad with
        the kernels (complex64) against torch.autograd through separate plain
        products and inner products in complex128.  Order 64, K = 8; the error
        is taken relative to the largest gradient entry, tolerance 2e-4 (float32
        recursions of 32 steps forward and backward)."""
        order, K = 64, 8
        w = torch.linspace(1.0, 0.3, order, dtype=torch.float64, device=dev)
        for label, system in (
            ("swave (48,48,1)", swave_superconductor((48, 48, 1), dtype=np.complex128)),
            ("rashba (12,12,4)", rashba_dp_wave((12, 12, 4), dtype=np.complex128)),
        ):
            sk = system.skeleton
            scale = kpm.spectral_bound(system.data, sk, impl="plain")
            v0 = torch.as_tensor(kpm.rademacher_probes(sk.n_sites, K, 3, np.complex128)).to(dev)
            step_errs = chebstep_on_card(sk, K, label)
            grads = {}
            before = ck.launch_counts()
            for impl in ("cuda", "gather"):
                data = system.data.clone().requires_grad_(True)
                v = v0.clone().requires_grad_(True)
                if impl == "cuda":
                    mu = ck.moments_fused_ad(data, sk, v, 1.0 / scale, order, impl="cuda")
                else:
                    mu = kpm.moments(data, sk, v, order, scale, impl="gather")
                loss = (w * mu.double().sum(dim=1)).sum()
                grads[impl] = torch.autograd.grad(loss, (data, v))
            torch.cuda.synchronize()
            after = ck.launch_counts()
            steps = ce.sweep_launches(order)
            launched = {k: after[k] - before[k] for k in after}
            check(launched == counts(ell_cheb_step=steps, ell_spmm_adjoint=steps, ell_block_outer=steps),
                  f"{label}: one gradient launched {launched}, expected {steps} of each step kernel")
            errs = {}
            for name, got, want in zip(("d_data", "d_v0"), grads["cuda"], grads["gather"]):
                check(got.dtype == want.dtype == c128 and got.shape == want.shape, f"{label}: {name} has a wrong type")
                errs[name + "_rel_to_max"] = float((got - want).abs().max() / want.abs().max())
            emit({"phase": "grad", "system": label, "order": order, "K": K, "scale": scale,
                  "launches_per_gradient": launched, **errs, "chebstep": step_errs, "tolerance": 2e-4})
            for name, e in errs.items():
                check(e <= 2e-4, f"{label}: gradient {name} off by {e}")

    # ------------------------------------------------------------------ 8. solve_gap at full width
    def phase_gap():
        """The differentiable path: solve_gap on 512×512 at order 512 with 8 probes
        through the kernels, a dense control on 16×16 on the card, and the four
        kernels timed at the path's shape."""
        shape, order, samples, steps = (512, 512, 1), 512, 8, 60
        V, delta0 = 2.5, 0.3
        t0 = time.perf_counter()
        metal = normal_metal(shape)
        torch.cuda.synchronize()
        sk = metal.skeleton
        N = sk.n_sites
        check(metal.data.is_cuda and metal.data.dtype == c64, "the full-size metal is not complex64 on the card")
        emit({"phase": "gap", "call": f"normal_metal({shape})", "wall_s": time.perf_counter() - t0,
              "N": N, "S": sk.n_slots, "data_MB": metal.data.numel() * 8 / 1e6})
        kw = dict(V=V, temperature=0.0, method="kpm", order=order, samples=samples)
        per_sweep = ce.sweep_launches(order)

        # One gradient alone first: its device time, its peak memory, and
        # whether the whole solve fits the time this script may take.
        F_total = sc.make_total_free_energy(metal, **kw)
        x = torch.full((1,), delta0, device=dev, requires_grad=True)

        def one_gradient():
            (g,) = torch.autograd.grad(F_total(x.expand(N).to(c64)), x)
            return g

        one_gradient()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = ck.launch_counts()
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        start.record()
        F0 = F_total(x.expand(N).to(c64))
        mid.record()
        (g0,) = torch.autograd.grad(F0, x)
        end.record()
        torch.cuda.synchronize()
        gradient_wall = time.perf_counter() - t0
        after = ck.launch_counts()
        per_gradient = {k: after[k] - before[k] for k in after}
        gradient_peak_GB = torch.cuda.max_memory_allocated() / 1e9
        check(per_gradient == counts(ell_cheb_step=per_sweep, ell_spmm_adjoint=per_sweep,
                                     ell_block_outer=per_sweep),
              f"one gradient launched {per_gradient}, expected {per_sweep} of each step kernel")
        check(bool(torch.isfinite(g0).all()) and math.isfinite(float(F0.detach())), "F_total or its gradient is not finite")
        emit({"phase": "gap", "call": "one gradient of F_total (order 512, K = 8)", "wall_s": gradient_wall,
              "forward_device_ms": start.elapsed_time(mid), "backward_device_ms": mid.elapsed_time(end),
              "launches_per_gradient": per_gradient, "peak_device_GB": gradient_peak_GB,
              "F_total(0.3)": float(F0.detach()), "dF/dDelta": float(g0[0])})
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                one_gradient()
                torch.cuda.synchronize()
            rows = sorted(prof.key_averages(), key=lambda e: -getattr(e, "device_time_total", 0.0))[:14]
            emit({"phase": "gap", "profile_of": "one gradient", "top_by_device_time_ms": [
                {"name": e.key[:80], "calls": e.count, "device_ms": getattr(e, "device_time_total", 0.0) / 1e3}
                for e in rows]})
        short = start.elapsed_time(end) > 1000.0  # more than 1 s a gradient: take 20 steps
        if short:
            steps = 20
        del F_total, F0, g0

        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        delta, F = sc.solve_gap(metal, uniform=True, delta0=delta0, learning_rate=0.08 / N, steps=steps, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gap_launches = ck.launch_counts()  # read right after the path
        peak_GB = torch.cuda.max_memory_allocated() / 1e9
        # 60 power iterations for the one-time spectral bound, one sweep forward
        # and backward per step, and one more sweep forward for the returned F.
        expected = counts(ell_spmm=60, ell_cheb_step=(steps + 1) * per_sweep,
                          ell_spmm_adjoint=steps * per_sweep, ell_block_outer=steps * per_sweep)
        check(gap_launches == expected, f"solve_gap launched {gap_launches}, expected {expected}")
        check(all(gap_launches[k] > 0 for k in ("ell_spmm", "ell_cheb_step", "ell_spmm_adjoint", "ell_block_outer")),
              "a kernel of the differentiable path was never launched")
        gap_kpm = float(delta[0].real)
        shared.update(gap_delta=gap_kpm, gap_steps=steps)  # phase sharded holds its solve against this one
        check(delta.shape == (N,) and np.isfinite(delta).all() and math.isfinite(F), "solve_gap result not finite")

        t0 = time.perf_counter()
        control, F_control = sc.solve_gap(normal_metal((16, 16, 1)), V=V, temperature=0.0, uniform=True,
                                          delta0=delta0, steps=150, learning_rate=0.02)
        torch.cuda.synchronize()
        control_wall = time.perf_counter() - t0
        gap_dense = float(control[0].real)
        emit({"phase": "gap", "call": f"solve_gap(normal_metal({shape}), V=2.5, T=0, uniform, order=512, samples=8)",
              "steps": steps, "wall_s": wall, "seconds_per_iteration": wall / (steps + 1),
              "launches": gap_launches, "expected": expected, "peak_device_GB": peak_GB,
              "delta_kpm": gap_kpm, "F_total": F, "delta_dense_16x16": gap_dense, "F_dense_16x16": F_control,
              "dense_control_wall_s": control_wall, "abs_diff": abs(gap_kpm - gap_dense),
              "short_run": short})
        if short:  # the descent check: more than half the way from the start to the control
            check(abs(gap_kpm - delta0) > 0.5 * abs(gap_dense - delta0) and
                  (gap_kpm - delta0) * (gap_dense - delta0) > 0,
                  f"after {steps} steps Δ = {gap_kpm} has not moved half the way from {delta0} to {gap_dense}")
        else:
            check(abs(gap_kpm - gap_dense) < 0.02, f"Δ_kpm = {gap_kpm} is not within 0.02 of the dense control {gap_dense}")
            check(gap_kpm > 0.3, f"Δ_kpm = {gap_kpm} did not grow beyond its start")

        # The four kernels at this path's shape: N = 262144, S = 5, K = 8.
        K, label = samples, "metal 512x512x1"
        data = sc.data_with_onsite_swave(metal.data, torch.full((N,), gap_kpm, device=dev, dtype=c64))
        ok, err = compare(data, sk, K, seed=51)
        check(ok, f"kernel disagrees with its plain version at {label}: {err}")
        # The backward kernels at this shape on independent random blocks (not
        # Hermitian, so a wrong transpose or conjugate shows), bare and in the
        # fused forms the path launches: the same comparisons and tolerance as
        # at the small shapes.
        ok_bwd, err_bwd = compare_backward(sk, K, seed=71)
        check(ok_bwd, f"backward kernel disagrees with its plain version at {label}: {err_bwd}")
        err.update(err_bwd)
        t_cur, t_prev, g = random_vector(N, K, 61), random_vector(N, K, 62), random_vector(N, K, 63)
        out, h_out = torch.empty_like(t_cur), torch.zeros_like(data)
        # Library yardsticks, each checked against the kernel to 2e-4 and used
        # nowhere in the port.  Adjoint: the torch.sparse product with the
        # conjugate transpose, built once in the same ELL layout.  Outer
        # product: torch.sparse.sampled_addmm on the block pattern as CSR.
        y_adj = ce.ell_spmm_adjoint(data, sk, g)
        dagger = data[sk.device_safe_cols(dev), sk.device_mirror_index(dev)].transpose(-1, -2).conj().contiguous()
        lib_layout, lib_fn, lib_y, lib_errors = library_spmm(dagger, sk, g)
        if lib_fn is not None:
            check(torch.allclose(lib_y, y_adj, atol=2e-4, rtol=2e-4), "library adjoint product disagrees with the kernel")
        del y_adj, lib_y, dagger
        h = ce.ell_block_outer(g, sk, t_cur, 0.25)
        sddmm_form, sddmm_fn, h_lib, sddmm_errors = library_sddmm(sk, g, t_cur, 0.25, h)
        if sddmm_fn is not None:
            err["ell_block_outer_vs_library"] = float((h_lib - h).abs().max())
            check(torch.allclose(h_lib, h, atol=2e-4, rtol=2e-4),
                  f"library sampled product disagrees with the kernel: {err}")
        del h, h_lib
        # The backward kernels in the form the path launches them (G formed and
        # -G written by the outer kernel, accumulating; the adjoint with its
        # epilogue of one added vector and two axpy terms), and bare.
        shift = torch.linspace(0.5, 1.5, K, device=dev) * 1e-3
        neg, add = torch.empty_like(t_cur), random_vector(N, K, 64)
        fns = {
            "ell_spmm": lambda: ce.ell_spmm(data, sk, t_cur),
            "ell_cheb_step": lambda: ce.ell_cheb_step(data, sk, t_cur, t_prev, 0.125, out=out),
            "ell_spmm_adjoint": lambda: ce.ell_spmm_adjoint(  # written over `add`, as the sweep does
                data, sk, g, alpha=-0.25, add=add, axpy=((shift, t_cur), (shift, t_prev)), out=add),
            "ell_block_outer": lambda: ce.ell_block_outer(
                g, sk, t_cur, 0.25, out=h_out, accumulate=True, shift=shift, neg_out=neg),
            "ell_spmm_adjoint bare": lambda: ce.ell_spmm_adjoint(data, sk, g),
            "ell_block_outer bare": lambda: ce.ell_block_outer(g, sk, t_cur, 0.25, out=h_out),
        }
        plain = {
            "ell_spmm": lambda: ce.ell_spmm_plain(data, sk, t_cur),
            "ell_cheb_step": lambda: ce.ell_cheb_step_plain(data, sk, t_cur, t_prev, 0.125),
            "ell_spmm_adjoint": lambda: ce.ell_spmm_adjoint_plain(data, sk, g),
            "ell_block_outer": lambda: ce.ell_block_outer_plain(g, sk, t_cur, 0.25),
        }
        first = {name: timed_ms(fn, 50) for name, fn in fns.items()}  # kernel, plain, library, kernel
        plain_ms = {name: timed_ms(fn, 5) for name, fn in plain.items()}
        lib_ms = timed_ms(lib_fn, 5) if lib_fn is not None else None
        sddmm_ms = timed_ms(sddmm_fn, 5) if sddmm_fn is not None else None
        second = {name: timed_ms(fn, 50) for name, fn in fns.items()}
        vec, op = N * 4 * K * 8, data.numel() * 8
        # Bytes: every input once, every output once.  Adjoint on the path:
        # operator, -G, add, t_cur, t_next in, one vector out.  Outer on the
        # path: g and t in, -G out, the operator cotangent read and written.
        nbytes = {"ell_spmm": spmm_bytes(sk, K, 8), "ell_cheb_step": chebyshev_step_bytes(sk, K, 8),
                  "ell_spmm_adjoint": op + 5 * vec, "ell_block_outer": 3 * vec + 2 * op,
                  "ell_spmm_adjoint bare": spmm_bytes(sk, K, 8), "ell_block_outer bare": 2 * vec + op}
        rows = {}
        for name in fns:
            base = name.split(" ")[0]
            library, library_ms = "none", None
            if base == "ell_spmm_adjoint":
                library_ms = lib_ms
                library = (f"torch.sparse {lib_layout} @ dense with the conjugate transpose (the product alone)"
                           if lib_ms is not None else "none: " + "; ".join(lib_errors))
            elif base == "ell_block_outer":
                library_ms = sddmm_ms
                library = (f"torch.sparse.sampled_addmm on the CSR block pattern, beta = 1, {sddmm_form} "
                           "(the accumulating product alone)"
                           if sddmm_ms is not None else "none: " + "; ".join(sddmm_errors))
            rows[name] = bound_row(name, label, sk, K, min(first[name], second[name]), plain_ms[base],
                                   nbytes[name], spmm_flops(sk, K), err[base], library_ms, library,
                                   [first[name], second[name]])
        kernel_ms = sum(rows[k]["ms"] for k in ("ell_cheb_step", "ell_spmm_adjoint", "ell_block_outer")) * per_sweep
        emit({"phase": "gap", "one_gradient_split_ms": {
            "ell_cheb_step": rows["ell_cheb_step"]["ms"] * per_sweep,
            "ell_spmm_adjoint": rows["ell_spmm_adjoint"]["ms"] * per_sweep,
            "ell_block_outer": rows["ell_block_outer"]["ms"] * per_sweep,
            "kernels_total": kernel_ms, "launches_each": per_sweep}})
        return gap_launches, rows

    # ------------------------------------------------------------------ 9. one d-wave gradient
    def phase_dwave():
        """One gradient of the d-wave objective on (64,64,1) at order 1024 (below
        that the KPM minimiser is biased low for nodal gaps): kernels in
        complex64 against the plain three-term recursion in complex128, same
        probes and scale.  Tolerance 1e-3 of the largest gradient entry and
        1e-5 relative on F: float32 recursions of 512 steps forward and back."""
        shape, order, samples = (64, 64, 1), 1024, 8
        metal = normal_metal(shape, dtype=np.complex128)
        N = metal.skeleton.n_sites
        field = 0.2 + 0.05 * np.random.default_rng(9).normal(size=N)
        kw = dict(V=2.5, temperature=0.0, method="kpm", order=order, samples=samples, pairing="dwave")
        sk = metal.skeleton
        headroom = torch.full((N,), 2.0, device=dev, dtype=c128)  # delta_max of make_total_free_energy
        scale = kpm.spectral_bound(
            sc.data_with_bond_singlet(metal.data, headroom, sk, sc.bond_structure_dwave(sk)), sk, impl="plain"
        )
        out = {}
        before = ck.launch_counts()
        for impl in ("plain", "cuda"):  # both objectives on the same scale and probes
            t0 = time.perf_counter()
            F_total = sc.make_total_free_energy(metal, impl=impl, scale=scale, **kw)
            x = torch.as_tensor(field, device=dev).requires_grad_(True)
            F = F_total(x.to(c128))
            (g,) = torch.autograd.grad(F, x)
            torch.cuda.synchronize()
            out[impl] = (float(F.detach()), g, time.perf_counter() - t0)
        after = ck.launch_counts()
        (F_p, g_p, s_p), (F_c, g_c, s_c) = out["plain"], out["cuda"]
        steps = ce.sweep_launches(order)
        check(after["ell_spmm_adjoint"] - before["ell_spmm_adjoint"] == steps
              and after["ell_block_outer"] - before["ell_block_outer"] == steps,
              "the d-wave gradient did not go through the backward kernels")
        errs = {"F_rel": abs(F_c - F_p) / abs(F_p),
                "grad_rel_to_max": float((g_c - g_p).abs().max() / g_p.abs().max())}
        emit({"phase": "dwave", "shape": shape, "order": order, "samples": samples, "scale": scale,
              "F_cuda": F_c, "F_plain": F_p, "grad_max": float(g_p.abs().max()), **errs,
              "wall_s_cuda": s_c, "wall_s_plain": s_p})
        check(errs["F_rel"] <= 1e-5, f"d-wave F off by {errs['F_rel']}")
        check(errs["grad_rel_to_max"] <= 1e-3, f"d-wave gradient off by {errs['grad_rel_to_max']}")


    # ------------------------------------------------------------------ 10. a generic lattice at full size
    class HoleSheet(Lattice):
        """An Lx×Ly square sheet, open boundaries, with a circular hole: a lattice
        no stencil describes.  What remains is numbered row by row: with
        ``major="y"`` along x within a row of constant y (neighbours in y lie Lx
        apart), with ``major="x"`` along y (neighbours in x lie Ly apart).
        Beside the scalar traversal contract it offers the vectorised arrays
        (``site_coords``, ``bond_arrays``, ``edge_arrays``, ``index_array``)."""

        def __init__(self, Lx, Ly, radius, major="y"):
            super().__init__((Lx, Ly, 1))
            x, y = np.meshgrid(np.arange(Lx), np.arange(Ly), indexing="ij")
            keep = (x - Lx / 2) ** 2 + (y - Ly / 2) ** 2 > radius**2
            if major == "y":
                x, y, keep = x.T, y.T, keep.T
            xs, ys = x[keep], y[keep]
            self.site_coords = np.stack([xs, ys, np.zeros(len(xs), dtype=np.int64)], axis=1)
            self.size = len(xs)
            self._number = np.full((Lx, Ly), -1, dtype=np.int64)
            self._number[xs, ys] = np.arange(self.size)

        def index(self, coord):
            x, y, z = coord
            if not (0 <= x < self.shape[0] and 0 <= y < self.shape[1]) or z or self._number[x, y] < 0:
                raise ValueError(f"Coordinate {coord} is not a site")
            return int(self._number[x, y])

        def index_array(self, coords):
            coords = np.asarray(coords)
            idx = self._number[coords[..., 0], coords[..., 1]]
            if (idx < 0).any():
                raise ValueError("Coordinate is not a site")
            return idx

        def sites(self):
            for c in self.site_coords:
                yield (int(c[0]), int(c[1]), 0)

        def bond_arrays(self):
            src, dst = [], []
            for axis in (1, 0):
                hi = self.site_coords.copy()
                hi[:, axis] += 1
                inside = hi[:, axis] < self.shape[axis]
                inside[inside] = self._number[hi[inside, 0], hi[inside, 1]] >= 0
                lo, hi = self.site_coords[inside], hi[inside]
                src += [lo, hi]
                dst += [hi, lo]
            return np.concatenate(src), np.concatenate(dst)

        def edge_arrays(self):
            empty = np.zeros((0, 3), dtype=np.int64)
            return empty, empty

        def bonds(self):
            for a, b in zip(*self.bond_arrays()):
                yield (int(a[0]), int(a[1]), 0), (int(b[0]), int(b[1]), 0)

        def edges(self):
            return iter(())

    class ScalarOnly:
        """A lattice seen through its scalar traversal contract alone."""

        def __init__(self, lattice):
            self._lattice, self.size = lattice, lattice.size

        def index(self, coord):
            return self._lattice.index(coord)

        def __iter__(self):
            return iter(self._lattice)

    def swave_on(lattice, dtype=None, delta=0.3, mu=0.5):
        system = Hamiltonian(lattice, dtype=dtype, device=dev)
        system.assemble(
            onsite=lambda ci: -mu * σ0,
            pairing_onsite=lambda ci: delta * jσ2,
            hopping=lambda ci, cj: -1.0 * σ0,  # the generic skeleton holds bonds only
        )
        return system

    def phase_generic():
        """The generic-lattice path: a sheet with a hole through skeleton_from_lattice,
        the façade's assembly, save, load (FrozenLattice), the KPM entry points and
        one gradient, all through the windowed gather kernels; those kernels at the
        path's shape beside the general kernels in natural and relabelled order."""
        import tempfile

        energies = np.linspace(-1.0, 1.0, 41)
        t0 = time.perf_counter()
        lattice = HoleSheet(1024, 256, 60)
        t_lattice = time.perf_counter() - t0
        t0 = time.perf_counter()
        sk_loop = bs.skeleton_from_lattice(ScalarOnly(lattice))  # the general case: a Python loop over the pairs
        t_loop = time.perf_counter() - t0
        t0 = time.perf_counter()
        system = swave_on(lattice)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        sk = system.skeleton
        N, S = sk.cols.shape
        check(not sk.stencil and np.array_equal(sk.cols, sk_loop.cols)
              and np.array_equal(sk.trans_slot, sk_loop.trans_slot),
              "the vectorised skeleton differs from the one the pair loop builds")
        check(system.data.is_cuda and system.data.dtype == c64, "the generic system is not complex64 on the card")
        emit({"phase": "generic", "call": "HoleSheet(1024, 256, 60) -> Hamiltonian -> assemble", "N": N, "S": S,
              "data_MB": system.data.numel() * 8 / 1e6, "lattice_s": t_lattice,
              "skeleton_from_lattice_pair_loop_s": t_loop, "hamiltonian_and_assemble_s": t_build,
              "hermiticity_error": system._hermiticity_error(), "padding_slots": int((sk.cols < 0).sum())})

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sheet.npz")
            t0 = time.perf_counter()
            system.save(path)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            frozen = Hamiltonian.load(path)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            file_MB = os.path.getsize(path) / 1e6
        sk = frozen.skeleton
        check(type(frozen.lattice).__name__ == "FrozenLattice" and frozen.data.is_cuda
              and torch.equal(frozen.data, system.data) and np.array_equal(sk.cols, system.skeleton.cols),
              "the checkpoint did not come back as it went")
        emit({"phase": "generic", "call": "save -> load", "save_s": t_save, "load_s": t_load, "file_MB": file_MB})
        del system

        t0 = time.perf_counter()
        gl = cg.plan_gather(sk, 8)
        t_plan = time.perf_counter() - t0
        check(gl is not None, "no gather plan for the sheet")
        rows_nat, slots_nat = np.nonzero(sk.cols >= 0)
        natural_bwb = int(np.abs(sk.cols[rows_nat, slots_nat] - rows_nat).max())
        emit({"phase": "generic", "call": "plan_gather(K=8): RCM relabelling and launch plan", "wall_s": t_plan,
              "natural_bwb": natural_bwb, "relabelled": bool((gl.rank != np.arange(N)).any()), "bwb": gl.bwb, "T": gl.T,
              "TK": gl.TK, "threads": gl.threads, "window_sites": gl.window, "ring_rows": gl.ring,
              "depth": gl.depth, "run": gl.run, "ctas": gl.ctas, "smem_bytes": gl.smem_bytes})

        expected = counts()

        def call(label, fn, order, K, bound_iters=0, sites=None):
            """As phase main's: an LDOS sweep from ``sites`` takes the light-cone step while its cone grows."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = ce.sweep_launches(order) if order else 0
            window = 0 if sites is None else cone_steps(frozen.data, sk, sites, K, order)
            expected["ell_gather_cheb_step"] += steps - window
            expected["ell_gather_cheb_step_window"] += window
            expected["ell_gather_spmm"] += bound_iters
            emit({"phase": "generic", "call": label, "wall_s": wall, "K": K, "gather_cheb_launches": steps,
                  "light_cone_launches": window, "gather_spmm_launches": bound_iters})
            return out

        ITERS = 60
        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        site = int(lattice.index((200, 128, 0)))
        scale = call("spectral_bound", lambda: kpm.spectral_bound(frozen.data, sk), 0, 1, ITERS)
        F_cold = call("free_energy(T=0.01, kpm, order=256, samples=8)",
                      lambda: frozen.free_energy(0.01, method="kpm", order=256, samples=8), 256, 8, ITERS)
        F_warm = call("free_energy(T=0.5, kpm, order=256, samples=8, scale=)",
                      lambda: frozen.free_energy(0.5, method="kpm", order=256, samples=8, scale=scale), 256, 8)
        rho = call("ldos(flat index, order=512)",
                   lambda: frozen.ldos(site, energies, method="kpm", order=512, scale=scale), 512, 4, sites=[site])
        map_sites = [site, site + 1000, site + 5000, 17]
        rho_map = call("ldos_map(4 flat indices, order=512)",
                       lambda: frozen.ldos_map(map_sites, energies, method="kpm", order=512, scale=scale), 512, 16,
                       sites=map_sites)
        dos = call("dos(order=256, samples=8)",
                   lambda: frozen.dos(energies, order=256, samples=8, scale=scale), 256, 8)
        v = random_vector(N, 8, 7)
        y = call("apply(K=8)", lambda: frozen.apply(v), 0, 8, 1)
        generic_launches = ck.launch_counts()  # read right after the path
        peak_GB = torch.cuda.max_memory_allocated() / 1e9
        mid, outside = len(energies) // 2, np.abs(energies) >= 0.5
        check(generic_launches == expected and expected["ell_gather_spmm"] == 121
              and expected["ell_gather_cheb_step"] + expected["ell_gather_cheb_step_window"] == 896,
              f"launch counters {generic_launches} != expected {expected} (121 / 896)")
        check(generic_launches["ell_gather_spmm"] > 0 and generic_launches["ell_gather_cheb_step"] > 0
              and generic_launches["ell_spmm"] == 0 and generic_launches["ell_cheb_step"] == 0
              and generic_launches["ell_cheb_step_window"] == 0,
              "the generic path did not go through the gather kernels alone")
        check(math.isfinite(F_cold) and F_warm < F_cold < 0, "F not finite or not falling with T")
        check(rho.shape == (41,) and np.isfinite(rho).all() and rho.min() >= -1e-6
              and rho[mid] < 0.1 * rho[outside].mean(), "LDOS on the sheet shows no s-wave gap")
        check(rho_map.shape == (4, 41) and np.isfinite(rho_map).all(), "LDOS map wrong")
        check(dos.shape == (41,) and np.isfinite(dos).all() and dos[mid] < 0.1 * dos[outside].mean(), "DOS shows no gap")
        check(torch.allclose(y, ce.ell_spmm(frozen.data, sk, v), atol=2e-4, rtol=2e-4),
              "apply through the gather kernel disagrees with the general kernel")
        emit({"phase": "generic", "launches": generic_launches, "expected": expected, "scale": scale,
              "F(T=0.01)": F_cold, "F(T=0.5)": F_warm, "F_per_site": F_cold / N, "rho(0)": float(rho[mid]),
              "rho(|e|>=0.5) mean": float(rho[outside].mean()), "peak_device_GB": peak_GB})

        # One gradient of F_total at full size: gather step forward, the adjoint
        # and block-outer kernels backward on the relabelled skeleton.
        order, samples = 256, 8
        per_sweep = ce.sweep_launches(order)
        F_total = sc.make_total_free_energy(frozen, V=2.5, temperature=0.0, method="kpm", order=order,
                                            samples=samples, scale=scale * 1.3)
        x = torch.full((1,), 0.3, device=dev, requires_grad=True)
        before = ck.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F0 = F_total(x.expand(N).to(c64))
        (g0,) = torch.autograd.grad(F0, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_gradient = launched_since(before)
        check(per_gradient == counts(ell_gather_cheb_step=per_sweep, ell_spmm_adjoint=per_sweep,
                                     ell_block_outer=per_sweep),
              f"one gradient on the generic lattice launched {per_gradient}")
        check(bool(torch.isfinite(g0).all()) and math.isfinite(float(F0.detach())), "F_total on the sheet is not finite")
        emit({"phase": "generic", "call": "one gradient of F_total (order 256, K = 8)", "wall_s": wall,
              "launches_per_gradient": per_gradient, "F_total(0.3)": float(F0.detach()), "dF/dDelta": float(g0[0])})
        del F_total, F0, g0

        # The same gradient at a small size against torch.autograd through the
        # plain three-term recursion in complex128, same probes and scale: 2e-4
        # of the largest entry (float32 recursions of 32 steps forward and back).
        small = swave_on(HoleSheet(48, 24, 5), dtype=np.complex128, delta=0.0)
        n = small.skeleton.n_sites
        field = 0.3 + 0.05 * np.random.default_rng(9).normal(size=n)
        kw = dict(V=2.5, temperature=0.0, method="kpm", order=64, samples=8, scale=8.0, seed=4)
        got = {}
        before = ck.launch_counts()
        for impl in ("cuda_gather", "plain"):
            F_small = sc.make_total_free_energy(small, impl=impl, **kw)
            xs = torch.as_tensor(field, device=dev).requires_grad_(True)
            Fs = F_small(xs.to(c128))
            got[impl] = (float(Fs.detach()), torch.autograd.grad(Fs, xs)[0])
        small_launched = launched_since(before)
        steps = ce.sweep_launches(64)
        check(small_launched == counts(ell_gather_cheb_step=steps, ell_spmm_adjoint=steps, ell_block_outer=steps),
              f"the small gradient launched {small_launched}")
        errs = {"F_rel": abs(got["cuda_gather"][0] - got["plain"][0]) / abs(got["plain"][0]),
                "grad_rel_to_max": float((got["cuda_gather"][1] - got["plain"][1]).abs().max()
                                         / got["plain"][1].abs().max())}
        emit({"phase": "generic", "check": "gradient through gather-forward / adjoint+outer-backward vs complex128 "
              "autograd of the plain recursion", "lattice": "HoleSheet(48, 24, 5)", "N": n, "order": 64, "K": 8,
              **errs, "tolerance": 2e-4})
        check(errs["grad_rel_to_max"] <= 2e-4 and errs["F_rel"] <= 1e-5, f"gradient on the generic lattice off: {errs}")

        # The kernels at the path's shape, K = 8: gather against general, natural
        # against relabelled order, the tile sizes, the library yardstick.
        K, label = 8, "sheet 1024x256 with a hole, numbered along x"
        data_nat = frozen.data
        data_rel = gl.relabel(data_nat).contiguous()
        ok, err = compare_gather(sk, gl, data_nat, K, seed=81)
        check(ok, f"gather kernel disagrees at {label}: {err}")
        for K_path in (1, 4, 16):  # the other widths the path above ran: the bound, ldos, ldos_map
            gl_k = cg.plan_gather(sk, K_path)
            ok, err_k = compare_gather(sk, gl_k, data_nat, K_path, seed=84 + K_path)
            check(ok, f"gather kernel disagrees at {label}, K={K_path}: {err_k}")
            # Device ms at this width, beside the general kernels on the same relabelled operator.
            d_k, v_k, p_k = gl_k.relabel(data_nat).contiguous(), random_vector(N, K_path, 88), random_vector(N, K_path, 89)
            o_k = torch.empty_like(v_k)
            ms_k = {"ell_gather_spmm": timed_ms(lambda: cg.ell_gather_spmm(d_k, gl_k, v_k), 50),
                    "ell_gather_cheb_step": timed_ms(lambda: cg.ell_gather_cheb_step(d_k, gl_k, v_k, p_k, 0.125, out=o_k), 50),
                    "ell_spmm": timed_ms(lambda: ce.ell_spmm(d_k, gl_k.sk, v_k), 50),
                    "ell_cheb_step": timed_ms(lambda: ce.ell_cheb_step(d_k, gl_k.sk, v_k, p_k, 0.125, out=o_k), 50)}
            emit({"phase": "generic", "held": label, "K": K_path, "max_abs_err": err_k,
                  "tolerance": "atol=rtol=2e-4 vs complex64 plain; sums 1e-4 vs complex128 plain",
                  "plan_T_TK_depth_run_ctas": [gl_k.T, gl_k.TK, gl_k.depth, gl_k.run, gl_k.ctas], "ms": ms_k})
            del d_k, v_k, p_k, o_k
        t_cur, t_prev = random_vector(N, K, 82), random_vector(N, K, 83)
        out = torch.empty_like(t_cur)
        lib_layout, lib_fn, lib_y, lib_errors = library_spmm(data_rel, gl.sk, t_cur)
        if lib_fn is not None:
            check(torch.allclose(lib_y, cg.ell_gather_spmm(data_rel, gl, t_cur), atol=2e-4, rtol=2e-4),
                  "library product disagrees with the gather kernel")
        fns = {
            "ell_gather_spmm": lambda: cg.ell_gather_spmm(data_rel, gl, t_cur),
            "ell_gather_cheb_step": lambda: cg.ell_gather_cheb_step(data_rel, gl, t_cur, t_prev, 0.125, out=out),
            "ell_spmm natural": lambda: ce.ell_spmm(data_nat, sk, t_cur),
            "ell_cheb_step natural": lambda: ce.ell_cheb_step(data_nat, sk, t_cur, t_prev, 0.125, out=out),
            "ell_spmm relabelled": lambda: ce.ell_spmm(data_rel, gl.sk, t_cur),
            "ell_cheb_step relabelled": lambda: ce.ell_cheb_step(data_rel, gl.sk, t_cur, t_prev, 0.125, out=out),
        }
        first = {name: timed_ms(fn, 50) for name, fn in fns.items()}  # kernel, plain, library, kernel
        plain_ms = {"ell_gather_spmm": timed_ms(lambda: cg.ell_gather_spmm_plain(data_rel, gl, t_cur), 5),
                    "ell_gather_cheb_step": timed_ms(
                        lambda: cg.ell_gather_cheb_step_plain(data_rel, gl, t_cur, t_prev, 0.125), 5)}
        lib_ms = timed_ms(lib_fn, 5) if lib_fn is not None else None
        second = {name: timed_ms(fn, 50) for name, fn in fns.items()}
        del lib_fn, lib_y
        rel_bytes = N * S * 4  # the int32 offsets, read in place of cols
        rows = {}
        for name, nbytes, library in (("ell_gather_spmm", spmm_bytes(sk, K, 8) + rel_bytes, lib_ms),
                                      ("ell_gather_cheb_step", chebyshev_step_bytes(sk, K, 8) + rel_bytes, None)):
            rows[name] = bound_row(
                name, label, sk, K, min(first[name], second[name]), plain_ms[name], nbytes, spmm_flops(sk, K),
                err[name], library,
                (f"torch.sparse {lib_layout} @ dense on the relabelled operator" if library is not None else
                 ("none: " + "; ".join(lib_errors) if name == "ell_gather_spmm" else "none")),
                [first[name], second[name]])
            rows[name]["plan"] = plan_of(gl)
            emit({"phase": "generic", "timing": name, "plan": plan_of(gl), "ms": rows[name]["ms"]})
        emit({"phase": "generic", "comparison": "gather against general kernels, natural against relabelled order",
              "N": N, "S": S, "K": K, "natural_bwb": natural_bwb, "bwb": gl.bwb, "T": gl.T, "TK": gl.TK,
              "depth": gl.depth, "run": gl.run, "ctas": gl.ctas, "threads": gl.threads, "smem_bytes": gl.smem_bytes,
              "ms": {name: min(first[name], second[name]) for name in fns},
              "runs_ms": {name: [first[name], second[name]] for name in fns},
              "ratio_step": min(first["ell_gather_cheb_step"], second["ell_gather_cheb_step"])
              / min(first["ell_cheb_step relabelled"], second["ell_cheb_step relabelled"]),
              "ratio_product": min(first["ell_gather_spmm"], second["ell_gather_spmm"])
              / min(first["ell_spmm relabelled"], second["ell_spmm relabelled"])})
        # Measured variants of the plan on the same operands: tiles of 64 and 32
        # rows (deeper rings), and two waves of blocks (runs of half the length).
        variants = {"planned": fns["ell_gather_cheb_step"], "ell_cheb_step relabelled": fns["ell_cheb_step relabelled"]}
        for tile in (64, 32, (gl.T, -(-gl.run // 2))):
            gl_v = cg.plan_gather(sk, K, tile)
            variants[f"tile={tile} T={gl_v.T} depth={gl_v.depth} run={gl_v.run} threads={gl_v.threads}"] = (
                lambda gl_v=gl_v: cg.ell_gather_cheb_step(data_rel, gl_v, t_cur, t_prev, 0.125, out=out))
        var_runs = {name: [timed_ms(fn, 50)] for name, fn in variants.items()}
        for name, fn in reversed(list(variants.items())):
            var_runs[name].append(timed_ms(fn, 50))
        emit({"phase": "generic", "variants_of": "ell_gather_cheb_step", "K": K,
              "ms": {name: min(r) for name, r in var_runs.items()}, "runs_ms": var_runs})
        del data_rel, t_cur, t_prev, out, fns, variants

        # The same sheet numbered along y: its natural band is one row of 256
        # sites, no relabelling beats it, and the window fits at TK = 8.  The
        # tile sizes T are measured here.
        sheet_x = HoleSheet(1024, 256, 60, major="x")
        sk_x = bs.skeleton_from_lattice(sheet_x)
        gl_x = cg.plan_gather(sk_x, K)
        check(gl_x is not None and gl_x.TK == 8 and not (gl_x.rank != np.arange(sk_x.n_sites)).any(),
              f"expected the natural order and TK = 8 on the sheet numbered along y: {gl_x}")
        data_x = random_blocks(sk_x, 85)
        ok, err_x = compare_gather(sk_x, gl_x, data_x, K, seed=86)
        check(ok, f"gather kernel disagrees on the sheet numbered along y: {err_x}")
        tx, px = random_vector(sk_x.n_sites, K, 87), random_vector(sk_x.n_sites, K, 88)
        ox = torch.empty_like(tx)
        variants = {"ell_cheb_step": lambda: ce.ell_cheb_step(data_x, sk_x, tx, px, 0.125, out=ox),
                    "ell_gather_cheb_step planned": lambda: cg.ell_gather_cheb_step(data_x, gl_x, tx, px, 0.125, out=ox)}
        for tile in (32, 64, 128, 256):
            gl_t = cg.plan_gather(sk_x, K, tile)
            if gl_t is not None:
                variants[f"ell_gather_cheb_step T={tile} TK={gl_t.TK} threads={gl_t.threads}"] = (
                    lambda gl_t=gl_t: cg.ell_gather_cheb_step(data_x, gl_t, tx, px, 0.125, out=ox))
        runs_x = {name: [timed_ms(fn, 50)] for name, fn in variants.items()}
        for name, fn in variants.items():
            runs_x[name].append(timed_ms(fn, 50))
        emit({"phase": "generic", "case": "HoleSheet(1024, 256, 60) numbered along y", "N": sk_x.n_sites, "K": K,
              "bwb": gl_x.bwb, "T": gl_x.T, "TK": gl_x.TK, "threads": gl_x.threads, "smem_bytes": gl_x.smem_bytes,
              "max_abs_err": err_x, "ms": {name: min(r) for name, r in runs_x.items()}, "runs_ms": runs_x})
        del data_x, tx, px, ox, variants

        # A 512-wide sheet: the band no longer fits a TK = 8 window, the plan falls to TK = 4.
        wide = HoleSheet(512, 512, 40, major="x")
        sk_w = bs.skeleton_from_lattice(wide)
        gl_w = cg.plan_gather(sk_w, 8)
        check(gl_w is not None and gl_w.TK == 4, f"expected the 512-wide plan to fall to TK = 4: {gl_w}")
        data_w = random_blocks(sk_w, 91)
        ok, err_w = compare_gather(sk_w, gl_w, data_w, 8, seed=92)
        check(ok, f"gather kernel disagrees on the 512-wide sheet: {err_w}")
        d_w = gl_w.relabel(data_w).contiguous()
        tw, pw = random_vector(sk_w.n_sites, 8, 93), random_vector(sk_w.n_sites, 8, 94)
        ow = torch.empty_like(tw)
        emit({"phase": "generic", "case": "HoleSheet(512, 512, 40)", "N": sk_w.n_sites, "bwb": gl_w.bwb,
              "T": gl_w.T, "TK": gl_w.TK, "threads": gl_w.threads, "smem_bytes": gl_w.smem_bytes, "max_abs_err": err_w,
              "ell_gather_cheb_step_ms": timed_ms(lambda: cg.ell_gather_cheb_step(d_w, gl_w, tw, pw, 0.125, out=ow), 50),
              "ell_cheb_step_relabelled_ms": timed_ms(lambda: ce.ell_cheb_step(d_w, gl_w.sk, tw, pw, 0.125, out=ow), 50)})
        return generic_launches, rows

    # ------------------------------------------------------------------ 11. the tiled step
    def phase_tiled():
        """free_energy through the tiled step against the untiled call, and the
        tiled kernel at N = 10⁶ beside ell_cheb_step."""
        tiled_launches = counts()
        rows = {}
        for label, system in (("swave 1000x1000x1", swave_superconductor((1000, 1000, 1))),
                              ("rashba 64x64x4", rashba_dp_wave((64, 64, 4)))):
            sk = system.skeleton
            N = sk.n_sites
            scale = kpm.spectral_bound(system.data, sk)
            kw = dict(method="kpm", order=256, samples=8, scale=scale)
            F_untiled = system.free_energy(0.01, **kw)
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            F_tiled = system.free_energy(0.01, impl="cuda_tiled", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = ck.launch_counts()  # read right after the path
            check(launched == counts(stencil_cheb_step_tiled=128),
                  f"{label}: free_energy(impl='cuda_tiled') launched {launched}")
            rel = abs(F_tiled - F_untiled) / abs(F_untiled)
            rho_t = system.ldos(tuple(e // 2 for e in sk.shape), [0.0, 0.6], method="kpm", order=128,
                                scale=scale, impl="cuda_tiled")
            rho_u = system.ldos(tuple(e // 2 for e in sk.shape), [0.0, 0.6], method="kpm", order=128, scale=scale)
            emit({"phase": "tiled", "call": f"{label}: free_energy(order=256, samples=8, impl='cuda_tiled')",
                  "wall_s": wall, "F_tiled": F_tiled, "F_untiled": F_untiled, "F_rel": rel,
                  "ldos_abs_diff": float(np.abs(rho_t - rho_u).max()), "launches": launched,
                  "tile_plan": ce.tile_plan(sk, 8)})
            check(rel <= 1e-5, f"{label}: F through the tiled step differs from the untiled call by {rel}")
            check(np.abs(rho_t - rho_u).max() <= 1e-3 * np.abs(rho_u).max(), f"{label}: tiled LDOS differs")
            tiled_launches = {k: tiled_launches[k] + launched[k] for k in launched}
            for K in ((8, 1, 64) if N > 100_000 else (8,)):
                ok, err = compare_tiled(system.data, sk, K, seed=95)
                check(ok, f"tiled kernel disagrees with its plain version at {label}, K={K}: {err}")
                t_cur, t_prev = random_vector(N, K, 96), random_vector(N, K, 97)
                out = torch.empty_like(t_cur)
                reps = 20 if N > 100_000 else 200
                tiled = lambda: ce.stencil_cheb_step_tiled(system.data, sk, t_cur, t_prev, 0.125, out=out)
                untiled = lambda: ce.ell_cheb_step(system.data, sk, t_cur, t_prev, 0.125, out=out)
                runs = [timed_ms(tiled, reps)]
                untiled_runs = [timed_ms(untiled, reps)]
                plain = timed_ms(lambda: ce.stencil_cheb_step_tiled_plain(system.data, sk, t_cur, t_prev, 0.125), 3)
                untiled_runs.append(timed_ms(untiled, reps))
                runs.append(timed_ms(tiled, reps))
                row = bound_row("stencil_cheb_step_tiled", label, sk, K, min(runs), plain,
                                chebyshev_step_bytes(sk, K, 8), spmm_flops(sk, K),
                                err["stencil_cheb_step_tiled"], None, "none", runs)
                plan = ce.tile_plan(sk, K)
                emit({"phase": "tiled", "shape": label, "K": K, "stencil_cheb_step_tiled_ms": min(runs),
                      "ell_cheb_step_ms": min(untiled_runs), "ratio": min(runs) / min(untiled_runs),
                      "bound_ms": row["bound_ms"], "runs_ms": runs, "ell_cheb_step_runs_ms": untiled_runs,
                      "plan": plan})
                if N > 100_000 and K == 8:
                    # Measured variants of the plan: the ring's depth (rows in
                    # flight), a strip of two sites a thread, and four waves.
                    items = plan["n_strips"] * sk.shape[0]
                    forced = {"NR=4 (one row in flight)": (plan["PB"], plan["XR"], 4),
                              "NR=3 (no row in flight)": (plan["PB"], plan["XR"], 3),
                              "PB=64": (64, -(-(-(-(sk.shape[1] * sk.shape[2]) // 64) * sk.shape[0]) // plan["ctas"]), 5),
                              "XR/4 (four waves)": (plan["PB"], -(-plan["XR"] // 4), 5)}
                    variants = {"planned": tiled, "ell_cheb_step": untiled}
                    for name, tile in forced.items():
                        check(ce.tile_plan(sk, K, tile)["smem_bytes"] > 0, name)
                        variants[f"{name} {tile}"] = (
                            lambda tile=tile: ce.stencil_cheb_step_tiled(system.data, sk, t_cur, t_prev, 0.125,
                                                                         out=out, tile=tile))
                    var_runs = {name: [timed_ms(fn, reps)] for name, fn in variants.items()}
                    for name, fn in reversed(list(variants.items())):
                        var_runs[name].append(timed_ms(fn, reps))
                    emit({"phase": "tiled", "variants_of": label, "K": K, "items": items,
                          "ms": {name: min(r) for name, r in var_runs.items()}, "runs_ms": var_runs})
                if K == 8:
                    rows.setdefault("stencil_cheb_step_tiled", row)  # the first shape is N = 10⁶
                del t_cur, t_prev, out
            del system
        return tiled_launches, rows

    # ------------------------------------------------------------------ 12. lowest states
    def expected_filter(sk, history, bf16=False):
        """Launch counts the solver's filter makes over ``history``: at each
        application's width the filter kernel once with order − 1 steps, or, where
        filter_plan answers "per_step", one step launch an order beyond the zeroth."""
        name, step = ("ell_cheb_filter_bf16", "ell_cheb_step_bf16") if bf16 else ("ell_cheb_filter", "ell_cheb_step")
        out = {name: 0, f"{name}.steps": 0, step: 0}
        for _, order, _, _, b in history:
            if cf.filter_plan(sk.n_sites, b, sk.n_slots, bf16=bf16)["mode"] == "per_step":
                out[step] += order - 1
            else:
                out[name] += 1
                out[f"{name}.steps"] += order - 1
        return out

    # The solver's low-pass filters at two of its orders: its first (plateau 0,
    # width 0.09) and a sharp one of its later rounds.
    lowpass = {256: lz._lowpass_coeffs(0.0, 0.09, 256), 4096: lz._lowpass_coeffs(2e-4, 4e-4, 4096)}

    def held_at_widths(label, system, widths, tiled=False, bf16=False):
        """The solver's kernels on ``system``'s operator (its bf16 form with
        ``bf16``) at the widths the filter ran and K = 1 (the spectral bound's
        product): the general product and step (and with ``tiled`` the tiled
        step) against their plain versions with the small shapes' tolerances;
        the filter kernel in each mode that fits (forced) at orders 256 and 4096
        of the solver's low-pass by compare_filter.  Then at each width the
        device ms a step: the filter kernel in each mode (one launch at order
        4096, over its 4095 steps); ell_cheb_step from 200 launches replayed from
        one CUDA graph; the same back to back from the host (the host's issue
        rate: at N = 1024 not the kernel's time); the per-step path the filter
        replaced (filter_recursion over ell_cheb_step and torch axpys at order
        256, CUDA events around the host's loop); the step's byte bound."""
        sk = system.skeleton
        N_l, S = sk.cols.shape
        form = ce.bf16_operator(system.data) if bf16 else system.data
        inv = 1.0 / kpm.spectral_bound(system.data, sk)
        worst, modes = {}, {}
        for K in sorted({1, *widths}):
            ok, err = (compare_bf16 if bf16 else compare)(system.data, sk, K, seed=900 + K)
            check(ok, f"{label}: kernel disagrees with its plain version at K={K}: {err}")
            if tiled:
                ok, err_t = compare_tiled(system.data, sk, K, seed=950 + K)
                check(ok, f"{label}: tiled kernel disagrees with its plain version at K={K}: {err_t}")
                err.update(err_t)
            for order, coeffs in lowpass.items():
                ok, err_f, modes[K] = compare_filter(form, sk, K, coeffs, inv, seed=970 + K)
                check(ok and modes[K], f"{label}: filter kernel at K={K}, order {order}: {err_f} in {modes[K]}")
                err.update({f"filter_{order}_{key}": e for key, e in err_f.items()})
            worst = {n: max(worst.get(n, 0.0), v) for n, v in err.items()}
        by_width = {}
        coeffs = lowpass[4096]
        for K in sorted(widths):
            v, t_prev = random_vector(N_l, K, 960), random_vector(N_l, K, 961)
            out = torch.empty_like(v)

            def one_step():
                ce.ell_cheb_step(form, sk, v, t_prev, 0.125, out=out)

            def step(t_cur, t_prev_, scale, out_):
                return ce.ell_cheb_step(form, sk, t_cur, t_prev_, scale, out=out_)[0]

            bound = chebyshev_step_bytes(sk, K, 8, operator_itemsize=2 if bf16 else None) / HBM_BYTES_PER_S * 1e3
            row = {"plan": cf.filter_plan(N_l, K, S, bf16=bf16), "step_bound_ms": bound,
                   "ell_cheb_step_graph_ms": graph_ms(one_step),
                   "ell_cheb_step_host_issue_ms": timed_ms(one_step, 200),
                   "per_step_path_ms_per_step": timed_ms(lambda: ce.filter_recursion(step, v, lowpass[256], inv), 3)
                   / 255}
            if tiled:
                def tiled_step():
                    ce.stencil_cheb_step_tiled(form, sk, v, t_prev, 0.125, out=out)

                row.update(stencil_cheb_step_tiled_graph_ms=graph_ms(tiled_step),
                           stencil_cheb_step_tiled_host_issue_ms=timed_ms(tiled_step, 200))
            for mode in modes[K]:
                row[f"filter_{mode}_ms_per_step"] = timed_ms(
                    lambda: cf.ell_cheb_filter(form, sk, v, coeffs, inv, mode=mode), 3) / (len(coeffs) - 1)
            best = min(row[f"filter_{mode}_ms_per_step"] for mode in modes[K])
            row.update(filter_share_of_step_bound=bound / best,
                       filter_over_per_step_path=best / row["per_step_path_ms_per_step"],
                       filter_over_graph_replayed_step=best / row["ell_cheb_step_graph_ms"])
            by_width[K] = row
            del v, t_prev, out
        emit({"phase": "lowest", "held": label, "N": N_l, "K": sorted({1, *widths}), "bf16": bf16,
              "filter_modes": modes, "filter_orders": sorted(lowpass),
              "tolerance": "atol=rtol=2e-4 vs complex64 plain; sums 1e-4 vs complex128 plain; the filter kernel "
                           "by compare_filter (phase kernels)",
              "max_abs_err": worst, "step_ms_by_width": by_width})
        return by_width

    def filter_row(name, label, system, K, bf16=False):
        """The filter kernel's line in the kernels table: one sweep of the solver's
        order-4096 low-pass at width K on ``system`` in the planned mode, against
        its plain version; bound_ms for the function (operator, cols, v,
        coefficients and y once; the operations of 4095 steps at the float32 rate),
        and beside it the per-step byte bound the steps would take apart."""
        sk = system.skeleton
        N_l, S = sk.cols.shape
        form = ce.bf16_operator(system.data) if bf16 else system.data
        inv = 1.0 / kpm.spectral_bound(system.data, sk)
        coeffs, steps = lowpass[4096], len(lowpass[4096]) - 1
        v = random_vector(N_l, K, 990)
        y = cf.ell_cheb_filter(form, sk, v, coeffs, inv)
        err = float((y - cf.ell_cheb_filter_plain(form, sk, v, coeffs, inv)).abs().max())
        runs = [timed_ms(lambda: cf.ell_cheb_filter(form, sk, v, coeffs, inv), 3) for _ in range(2)]
        plain_ms = timed_ms(lambda: cf.ell_cheb_filter_plain(form, sk, v, coeffs, inv), 1)
        op_item = 2 if bf16 else None
        nbytes = spmm_bytes(sk, K, 8, operator_itemsize=op_item) + N_l * S * 4 + 4 * len(coeffs)
        entries = N_l * BLOCK * K
        flops = steps * (spmm_flops(sk, K) + 4 * entries) + 4 * entries * int(np.count_nonzero(coeffs[1:]))
        row = bound_row(name, label, sk, K, min(runs), plain_ms, nbytes, flops, err, None,
                        "none (no torch call runs a Chebyshev recursion)", runs)
        step_bound = chebyshev_step_bytes(sk, K, 8, operator_itemsize=op_item) / HBM_BYTES_PER_S * 1e3
        row.update(order=len(coeffs), steps=steps, plan=cf.filter_plan(N_l, K, S, bf16=bf16),
                   ms_per_step=row["ms"] / steps, step_bound_ms=step_bound,
                   share_of_step_bound=step_bound * steps / row["ms"])
        emit({"phase": "lowest" if not bf16 else "bf16", "timing": name, "K": K, "ms": row["ms"],
              "ms_per_step": row["ms_per_step"], "step_bound_ms": step_bound, "bound_ms": row["bound_ms"],
              "bound_by": row["bound_by"], "plan": row["plan"]})
        return row

    def steps_by_width(history) -> dict:
        widths = {}
        for _, order, _, _, b in history:
            widths[b] = widths.get(b, 0) + order - 1
        return widths

    def phase_lowest():
        """diagonalize(method="lanczos") at 32×32 against eigvalsh on the card, the
        banded and the shift-invert solvers, and once more through the tiled step;
        at 100×100 (dim 40 000) with magnetic impurities against shift-invert and
        with a uniform Zeeman field, bounded, against eigvalsh on the card.  Each
        call's filter runs through ell_cheb_filter, one launch an application
        (asserted against its history).  After each run the kernels it launched
        are held against their plain versions on its own operator at the block
        widths its history reports, and timed there."""

        def modulated(shape, pot):
            """s-wave lattice (Δ = 0.2, μ = 0.5, periodic) with a weak incommensurate
            on-site potential that splits the gap-edge shell."""
            system = Hamiltonian(CubicLattice(shape), device=dev)

            def onsite(ci):
                w = (-0.5 + pot * np.cos(2.39996 * ci[:, 0] + 1.1 * ci[:, 1]))[:, None, None]
                return w * σ0

            system.assemble(onsite=onsite, hopping=lambda ci, cj: -1.0 * σ0, pairing_onsite=lambda ci: 0.2 * jσ2)
            return system

        k = 4
        lowest_launches = counts()
        small = modulated((32, 32, 1), 0.08)
        E_exact = torch.linalg.eigvalsh(small.matrix("dense_torch").to(c128))
        want = E_exact[E_exact > 0][:k].cpu().numpy()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        E_l, X_l = small.diagonalize(method="lanczos", k=k, format="raw")
        wall = time.perf_counter() - t0
        launched = ck.launch_counts()  # read right after the path
        lowest_launches = {n: lowest_launches[n] + launched[n] for n in launched}
        E_b = small.eigenvalues(method="banded")[:k]
        E_s = small.eigenvalues(method="shift_invert", k=k)
        errs = {"vs_eigvalsh": float(np.abs(E_l - want).max()), "vs_banded": float(np.abs(E_l - E_b).max()),
                "vs_shift_invert": float(np.abs(E_l - E_s).max()),
                "banded_vs_eigvalsh": float(np.abs(E_b - want).max())}
        H = small.matrix("dense")
        # The same call with its record (the one diagonalize makes: same seed,
        # kernels that repeat bit for bit): the history its counters are held to.
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        E_rec, _, info = lz.lowest_eigenstates(small.data, small.skeleton, 2 * k + 2, full_output=True)
        wall_rec = time.perf_counter() - t0
        recorded = ck.launch_counts()
        lowest_launches = {n: lowest_launches[n] + recorded[n] for n in recorded}
        want_launches = counts(**expected_filter(small.skeleton, info["history"]), **expected_bound(small.skeleton))
        emit({"phase": "lowest", "call": "32x32: diagonalize(method='lanczos', k=4)", "wall_s": wall, "E": E_l.tolist(),
              "residual_max": float(np.abs(H @ X_l - X_l * E_l).max()), **errs,
              "launches": {n: v for n, v in launched.items() if v}, "tolerance": 1e-6,
              "record": {"wall_s": wall_rec, "iterations": info["iterations"], "seconds": info["seconds"],
                         "orders": [h[1] for h in info["history"]], "blocks": [h[4] for h in info["history"]],
                         "filter_launches": info["filter_launches"], "step_launches": info["step_launches"]}})
        check(launched == recorded == want_launches and info["filter_launches"] == info["iterations"]
              and launched["ell_cheb_filter"] == info["iterations"] and launched["ell_cheb_step"] == 0,
              f"32x32 lanczos launched {launched}, its record {recorded}, the history says {want_launches}")
        errs["record_vs_eigvalsh"] = float(np.abs(E_rec[E_rec > 0][:k] - want).max())
        check(max(errs.values()) <= 1e-6, f"32x32 lowest states disagree: {errs}")
        untiled_steps = launched["ell_cheb_filter.steps"]
        history_32 = info["history"]

        # Once more with the opt-in knob: the tiled step driven by its real caller.
        os.environ["BODGE_PLANE_TILED"] = "1"
        try:
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            # The call eigenvalues(method="lanczos", k=k) makes, with its record.
            E_all, _, info = lz.lowest_eigenstates(small.data, small.skeleton, 2 * k + 2, full_output=True)
            wall = time.perf_counter() - t0
            launched = ck.launch_counts()
        finally:
            del os.environ["BODGE_PLANE_TILED"]
        E_t = E_all[E_all > 0][:k]
        lowest_launches = {n: lowest_launches[n] + launched[n] for n in launched}
        emit({"phase": "lowest", "call": "32x32 with BODGE_PLANE_TILED=1", "wall_s": wall,
              "iterations": info["iterations"], "converged": bool(info["converged"]),
              "orders": [h[1] for h in info["history"]], "blocks": [h[4] for h in info["history"]],
              "vs_eigvalsh": float(np.abs(E_t - want).max()), "launches": {n: v for n, v in launched.items() if v}})
        check(launched["stencil_cheb_step_tiled"] == sum(h[1] - 1 for h in info["history"])
              and launched["ell_cheb_step"] == 0 and launched["ell_cheb_filter"] == 0,
              f"the knob did not send the filter through the tiled step: {launched}")
        check(np.abs(E_t - want).max() <= 1e-6, "32x32 lowest states through the tiled step disagree")
        # Same seed, same adaptation: the untiled run above took these orders and widths too.
        check(untiled_steps == launched["stencil_cheb_step_tiled"],
              f"the untiled run took {untiled_steps} steps, the tiled one {launched['stencil_cheb_step_tiled']}")
        held_at_widths("32x32 modulated s-wave", small, {h[4] for h in info["history"]}, tiled=True)
        by_width = steps_by_width(history_32)
        rows = {"ell_cheb_filter": filter_row("ell_cheb_filter", "32x32 modulated s-wave", small,
                                              max(by_width, key=by_width.get)),
                "ell_power_iteration": power_row("32x32 modulated s-wave", small, "lowest")}
        del small, H

        # The 100×100 s-wave lattice (dim 40 000, open boundaries, Δ = 0.3, μ = 0.5)
        # with a local Zeeman field on six sites: magnetic impurities, each binding
        # one pair of states inside the gap, which is what a lowest-states query is
        # for.  (With a uniform Zeeman field the lowest states are the gap edge's
        # dense cluster, on which ARPACK's shift-invert itself does not finish:
        # that lattice follows below, with eigvalsh on the card as its comparator.)
        def with_impurities(L, couplings):
            system = Hamiltonian(CubicLattice((L, L, 1)), device=dev)
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
            return system

        big = with_impurities(100, [1.2, 1.5, 1.8, 2.2, 2.7, 3.3])
        sk = big.skeleton
        t0 = time.perf_counter()
        E_si = big.eigenvalues(method="shift_invert", k=k)
        wall_si = time.perf_counter() - t0
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        E_all, X_all, info = lz.lowest_eigenstates(big.data, sk, 2 * k + 2, full_output=True,
                                                   max_iter=10, max_order=8192)
        wall = time.perf_counter() - t0
        launched = ck.launch_counts()  # read right after the path
        lowest_launches = {n: lowest_launches[n] + launched[n] for n in launched}
        E_big = E_all[E_all > 0][:k]
        derived = sum(h[1] - 1 for h in info["history"])
        diff = float(np.abs(E_big - E_si).max())
        limit = 1e-6 if info["converged"] else 1e-4
        emit({"phase": "lowest", "call": "100x100 + six magnetic impurities: lowest_eigenstates(nev=10, max_iter=10, max_order=8192)",
              "dim": 4 * sk.n_sites, "wall_s": wall, "shift_invert_wall_s": wall_si, "iterations": info["iterations"],
              "final_order": info["history"][-1][1], "final_block": info["history"][-1][4],
              "orders": [h[1] for h in info["history"]], "blocks": [h[4] for h in info["history"]],
              "converged": bool(info["converged"]), "residual_max_rel": float(np.max(info["residuals"])),
              "E": E_big.tolist(), "E_shift_invert": E_si.tolist(), "abs_diff_vs_shift_invert": diff, "limit": limit,
              "filter_launches": launched["ell_cheb_filter"], "filter_steps": launched["ell_cheb_filter.steps"],
              "derived_from_history": derived, "steps_by_width": steps_by_width(info["history"]),
              "seconds": info["seconds"], "host_share": info["seconds"]["host"] / wall,
              "filter_share": info["seconds"]["filter"] / wall})
        want_launches = counts(**expected_filter(sk, info["history"]), **expected_bound(sk))
        check(launched == want_launches and launched["ell_cheb_filter.steps"] + launched["ell_cheb_step"] == derived,
              f"100x100 launched {launched}, the history says {want_launches}")
        check(len(E_big) == k and diff <= limit,
              f"100x100 lowest states differ from shift-invert by {diff} (converged={info['converged']})")
        held_at_widths("100x100 + six magnetic impurities", big, {h[4] for h in info["history"]})
        power_row("100x100 + six magnetic impurities", big, "lowest")
        del big, X_all

        # The 100×100 s-wave lattice with a uniform Zeeman field (t = 1, μ = −3,
        # m = 0.05, Δ = 0.10, open boundaries): here the lowest states are the gap
        # edge's cluster, so the run is bounded and may end unconverged.  Exact
        # comparator: eigvalsh of the dense matrix on the card, in float64 where
        # the matrix is real (it is: σ0, σ3 and jσ2 are), else complex128, and
        # sector by sector where the orbitals (e↑, h↓) and (e↓, h↑) do not couple
        # (checked on the matrix; cuSOLVER's syevd refuses dim 40 000 in one piece,
        # CUSOLVER_STATUS_INVALID_VALUE); the closed form √(ξ² + Δ²) − m over the
        # open lattice's sine modes beside it.
        L, mu, m, delta = 100, -3.0, 0.05, 0.10
        uniform = swave_superconductor((L, L, 1), mu=mu, delta=-delta, zeeman=(0.0, 0.0, m))
        sk = uniform.skeleton
        dense = uniform.matrix("dense_torch")
        dense = dense.real.double() if float(dense.imag.abs().max()) == 0.0 else dense.to(c128)
        exact_dtype = str(dense.dtype)
        by_orbital = dense.view(sk.n_sites, BLOCK, sk.n_sites, BLOCK)
        sectors = ([0, 3], [1, 2])
        check(float(by_orbital[:, sectors[0]][:, :, :, sectors[1]].abs().max()) == 0.0,
              "uniform 100x100: the (e↑, h↓) and (e↓, h↑) sectors couple")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E_exact = torch.cat([
            torch.linalg.eigvalsh(by_orbital[:, a][:, :, :, a].reshape(2 * sk.n_sites, 2 * sk.n_sites))
            for a in sectors]).sort().values
        torch.cuda.synchronize()
        wall_exact = time.perf_counter() - t0
        del dense, by_orbital
        want = E_exact[E_exact > 0][:k].cpu().numpy()
        cluster = int(((E_exact > 0) & (E_exact < float(want[0]) + 1e-3)).sum())
        q = np.pi * np.arange(1, L + 1) / (L + 1)
        xi = (-2.0 * (np.cos(q)[:, None] + np.cos(q)[None, :]) - mu).ravel()
        closed = np.sort(np.sqrt(xi**2 + delta**2) - m)[:k]
        check(np.abs(want - closed).max() <= 1e-6, f"eigvalsh on the card differs from the closed form: {want} / {closed}")
        bounds = dict(max_iter=UNIFORM_MAX_ITER, max_order=UNIFORM_MAX_ORDER)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # "not stabilized": reported below as converged=false
            E_all, X_all, info = lz.lowest_eigenstates(uniform.data, sk, 2 * k + 2, full_output=True, **bounds)
        wall = time.perf_counter() - t0
        launched = ck.launch_counts()  # read right after the path
        lowest_launches = {n: lowest_launches[n] + launched[n] for n in launched}
        E_uni = E_all[E_all > 0][:k]
        derived = sum(h[1] - 1 for h in info["history"])
        check(len(E_uni) == k, f"uniform 100x100: {len(E_uni)} positive states of {k}")
        diff = float(np.abs(E_uni - want).max())
        limit = 1e-6 if info["converged"] else 1e-4
        emit({"phase": "lowest", "call": f"100x100 s-wave + uniform Zeeman: lowest_eigenstates(nev=10, {bounds})",
              "dim": 4 * sk.n_sites, "wall_s": wall, "eigvalsh_on_card_wall_s": wall_exact, "eigvalsh_dtype": exact_dtype, "eigvalsh_sectors": 2,
              "iterations": info["iterations"], "final_order": info["history"][-1][1],
              "final_block": info["history"][-1][4], "orders": [h[1] for h in info["history"]],
              "blocks": [h[4] for h in info["history"]], "converged": bool(info["converged"]),
              "residual_max_rel": float(np.max(info["residuals"])), "E": E_uni.tolist(), "E_eigvalsh": want.tolist(),
              "abs_diff_vs_eigvalsh": diff, "limit": limit, "eigvalsh_vs_closed_form": float(np.abs(want - closed).max()),
              "positive_states_within_1e-3_of_the_lowest": cluster,
              "filter_launches": launched["ell_cheb_filter"], "filter_steps": launched["ell_cheb_filter.steps"],
              "derived_from_history": derived, "steps_by_width": steps_by_width(info["history"]),
              "seconds": info["seconds"], "host_share": info["seconds"]["host"] / wall,
              "filter_share": info["seconds"]["filter"] / wall})
        want_launches = counts(**expected_filter(sk, info["history"]), **expected_bound(sk))
        check(launched == want_launches and launched["ell_cheb_filter.steps"] + launched["ell_cheb_step"] == derived,
              f"uniform 100x100 launched {launched}, the history says {want_launches}")
        check(diff <= limit, f"uniform 100x100 lowest states differ from eigvalsh by {diff} (converged={info['converged']})")
        held_at_widths("100x100 s-wave + uniform Zeeman", uniform, {h[4] for h in info["history"]})
        return lowest_launches, rows

    # ------------------------------------------------------------------ 13. the row-sharded path
    def phase_sharded():
        """The row-sharded path: the halo kernels on four slabs of the 1000×1000
        operator against the whole-lattice kernels and timed beside them (the
        backward pair at 512²); a world of one over NCCL through the sharded
        KPM entry points and solve_gap(impl="cuda_sharded") at full width
        (launch counters read here), each against its single-device call on the
        same probes; four gloo ranks on the one card against the world of one;
        and two NCCL ranks on the one card, which make_row_mesh must refuse."""
        import torch.distributed as dist
        from bodge_tpu_torch.parallel import (RowSharding, dos_kpm_sharded_cuda, free_energy_kpm_sharded_cuda,
                                              initialize_multihost, ldos_kpm_sharded_cuda, make_row_mesh)
        from bodge_tpu_torch.parallel.cuda_sharded import moments_sharded_ad

        def replayed(order):
            """Steps the gradient's backward pass replays under remat="auto" (the objective's schedule)."""
            chunk, steps = cs.remat_chunk_for(order, "auto"), ce.sweep_launches(order) - 1
            return (steps // chunk) * chunk if 0 < chunk < steps else 0

        phase_t0 = time.perf_counter()
        rows_out = {}
        big = swave_superconductor((1000, 1000, 1))
        sk = big.skeleton
        Lx, P = sk.shape[0], sk.shape[1] * sk.shape[2]
        N, S, K = sk.n_sites, sk.n_slots, 8

        def halo_bytes(slab, K, vectors, extra=0):
            """Operator rows of the slab once, ``vectors`` slab vectors, the two halo planes."""
            return slab.n_local * S * 128 + vectors * slab.n_local * 4 * K * 8 + 2 * P * 4 * K * 8 + extra

        # -------- four slabs of 250 planes against the whole lattice, K = 8
        v, t_prev = random_vector(N, K, 1001), random_vector(N, K, 1002)
        t_whole, pp_whole = ce.ell_cheb_step(big.data, sk, v, t_prev, 0.125)
        y_whole = ce.ell_spmm(big.data, sk, v)
        sums, same, worst = torch.zeros(2 * K, dtype=torch.float64, device=dev), True, 0.0
        slabs = [ce.halo_slab(sk, 250 * r, 250) for r in range(4)]
        for slab in slabs:
            before, after = ((slab.x0 - 1) % Lx) * P, ((slab.x0 + slab.planes) % Lx) * P
            hm, hp = v[before:before + P].clone(), v[after:after + P].clone()
            r = slab.rows
            t_r, pp_r = ce.ell_cheb_step_halo(big.data[r], slab, v[r], hm, hp, t_prev[r], 0.125)
            y_r = ce.ell_spmm_halo(big.data[r], slab, v[r], hm, hp)
            same = same and torch.equal(t_r, t_whole[r]) and torch.equal(y_r, y_whole[r])
            worst = max(worst, float((t_r - t_whole[r]).abs().max()), float((y_r - y_whole[r]).abs().max()))
            sums += pp_r.double().sum(dim=0)
        want = pp_whole.double().sum(dim=0)
        sums_rel = float((sums - want).abs().max() / want.abs().max())
        emit({"phase": "sharded", "check": "4 slabs of 250 planes against the whole 1000x1000 lattice, K = 8",
              "t_next_and_y_bit_equal": same, "max_abs_diff": worst, "summed_partials_rel": sums_rel})
        check(worst <= 2e-4, f"slabs differ from the whole-lattice kernels by {worst}")
        check(sums_rel <= 1e-6, f"summed slab partials differ by {sums_rel} relative")
        del t_whole, y_whole, pp_whole

        # -------- the forward halo kernels timed: one slab, the whole lattice as one slab, ell_cheb_step
        whole = ce.halo_slab(sk, 0, Lx)
        hm, hp = v[(Lx - 1) * P:].clone(), v[:P].clone()  # the ring of one: own last and first plane
        out = torch.empty_like(v)
        one, r1 = slabs[1], slabs[1].rows
        d1, v1, tp1, out1 = big.data[r1], v[r1].contiguous(), t_prev[r1].contiguous(), torch.empty_like(v[r1])
        h1m, h1p = v[249 * P:250 * P].clone(), v[500 * P:501 * P].clone()
        fns = {
            "ell_cheb_step_halo": lambda: ce.ell_cheb_step_halo(big.data, whole, v, hm, hp, t_prev, 0.125, out=out),
            "ell_spmm_halo": lambda: ce.ell_spmm_halo(big.data, whole, v, hm, hp, out=out),
            "ell_cheb_step_halo one slab": lambda: ce.ell_cheb_step_halo(d1, one, v1, h1m, h1p, tp1, 0.125, out=out1),
            "ell_spmm_halo one slab": lambda: ce.ell_spmm_halo(d1, one, v1, h1m, h1p, out=out1),
            "ell_cheb_step": lambda: ce.ell_cheb_step(big.data, sk, v, t_prev, 0.125, out=out),
            "ell_spmm": lambda: ce.ell_spmm(big.data, sk, v),
        }
        t_h, _ = ce.ell_cheb_step_halo(big.data, whole, v, hm, hp, t_prev, 0.125)
        t_p, _ = ce.ell_cheb_step_halo_plain(big.data, whole, v, hm, hp, t_prev, 0.125)
        y_h = ce.ell_spmm_halo(big.data, whole, v, hm, hp)
        y_p = ce.ell_spmm_halo_plain(big.data, whole, v, hm, hp)
        err_w = {"ell_cheb_step_halo": float((t_h - t_p).abs().max()), "ell_spmm_halo": float((y_h - y_p).abs().max())}
        check(all(e <= 2e-4 * max(1.0, float(t_p.abs().max())) for e in err_w.values()),
              f"halo kernels at 1000x1000 disagree with their plain versions: {err_w}")
        del t_h, t_p, y_h, y_p
        first = {name: timed_ms(fn, 20) for name, fn in fns.items()}
        plain_ms = {"ell_cheb_step_halo": timed_ms(lambda: ce.ell_cheb_step_halo_plain(
                        big.data, whole, v, hm, hp, t_prev, 0.125), 3),
                    "ell_spmm_halo": timed_ms(lambda: ce.ell_spmm_halo_plain(big.data, whole, v, hm, hp), 3)}
        second = {name: timed_ms(fn, 20) for name, fn in fns.items()}
        ms = {name: min(first[name], second[name]) for name in fns}
        for name, vectors in (("ell_cheb_step_halo", 3), ("ell_spmm_halo", 2)):
            rows_out[name] = bound_row(name, "swave 1000x1000x1, whole lattice as one slab", sk, K, ms[name],
                                       plain_ms[name], halo_bytes(whole, K, vectors), spmm_flops(sk, K),
                                       err_w[name], None, "none (the rows of ell_cheb_step / ell_spmm are the "
                                       "yardstick)", [first[name], second[name]])
        emit({"phase": "sharded", "timing": "halo kernels at 1000x1000, K = 8", "ms": ms,
              "one_slab_bound_ms": {"ell_cheb_step_halo": halo_bytes(one, K, 3) / HBM_BYTES_PER_S * 1e3,
                                    "ell_spmm_halo": halo_bytes(one, K, 2) / HBM_BYTES_PER_S * 1e3},
              "ratio_whole_halo_to_ell": {"step": ms["ell_cheb_step_halo"] / ms["ell_cheb_step"],
                                          "product": ms["ell_spmm_halo"] / ms["ell_spmm"]}})
        del v, t_prev, out, hm, hp, d1, v1, tp1, out1, fns

        # -------- the backward pair at 512², K = 8, in the form the sweep launches
        metal = normal_metal((512, 512, 1))
        sk_m = metal.skeleton
        N_m, Lx_m = sk_m.n_sites, sk_m.shape[0]
        P_m = sk_m.shape[1] * sk_m.shape[2]
        data_m = sc.data_with_onsite_swave(metal.data, torch.full((N_m,), 0.6, device=dev, dtype=c64))
        whole_m = ce.halo_slab(sk_m, 0, Lx_m)
        t_cur, g, add = random_vector(N_m, K, 1201), random_vector(N_m, K, 1202), random_vector(N_m, K, 1203)
        t_next = random_vector(N_m, K, 1204)
        tm, tp = t_cur[(Lx_m - 1) * P_m:].clone(), t_cur[:P_m].clone()
        gm, gp = g[(Lx_m - 1) * P_m:].clone(), g[:P_m].clone()
        dm, dp = data_m[(Lx_m - 1) * P_m:].clone(), data_m[:P_m].clone()
        shift = torch.linspace(0.5, 1.5, K, device=dev) * 1e-3
        h_out, neg = torch.zeros_like(data_m), torch.empty_like(t_cur)
        adj_h = ce.ell_spmm_adjoint_halo(data_m, whole_m, g, gm, gp, dm, dp, alpha=-0.25)
        adj_w = ce.ell_spmm_adjoint(data_m, sk_m, g, alpha=-0.25)
        adj_p = ce.ell_spmm_adjoint_halo_plain(data_m, whole_m, g, gm, gp, dm, dp, alpha=-0.25)
        out_h = ce.ell_block_outer_halo(g, whole_m, t_cur, tm, tp, 0.25)
        out_w = ce.ell_block_outer(g, sk_m, t_cur, 0.25)
        out_p = ce.ell_block_outer_halo_plain(g, whole_m, t_cur, tm, tp, 0.25)
        torch.cuda.synchronize()
        err_b = {"ell_spmm_adjoint_halo": float(max((adj_h - adj_p).abs().max(), (adj_h - adj_w).abs().max())),
                 "ell_block_outer_halo": float(max((out_h - out_p).abs().max(), (out_h - out_w).abs().max()))}
        check(torch.allclose(adj_h, adj_p, atol=2e-4, rtol=2e-4) and torch.allclose(adj_h, adj_w, atol=2e-4, rtol=2e-4)
              and torch.allclose(out_h, out_p, atol=2e-4, rtol=2e-4) and torch.allclose(out_h, out_w, atol=2e-4, rtol=2e-4),
              f"halo backward kernels at 512x512 disagree: {err_b}")
        del adj_h, adj_w, adj_p, out_h, out_w, out_p
        bwd = {
            "ell_spmm_adjoint_halo": lambda: ce.ell_spmm_adjoint_halo(
                data_m, whole_m, g, gm, gp, dm, dp, alpha=-0.25, add=add, axpy=((shift, t_cur), (shift, t_next)), out=add),
            "ell_block_outer_halo": lambda: ce.ell_block_outer_halo(
                g, whole_m, t_cur, tm, tp, 0.25, out=h_out, accumulate=True, shift=shift, neg_out=neg),
            "ell_spmm_adjoint": lambda: ce.ell_spmm_adjoint(
                data_m, sk_m, g, alpha=-0.25, add=add, axpy=((shift, t_cur), (shift, t_next)), out=add),
            "ell_block_outer": lambda: ce.ell_block_outer(
                g, sk_m, t_cur, 0.25, out=h_out, accumulate=True, shift=shift, neg_out=neg),
        }
        first = {name: timed_ms(fn, 50) for name, fn in bwd.items()}
        plain_b = {"ell_spmm_adjoint_halo": timed_ms(lambda: ce.ell_spmm_adjoint_halo_plain(
                       data_m, whole_m, g, gm, gp, dm, dp), 5),
                   "ell_block_outer_halo": timed_ms(lambda: ce.ell_block_outer_halo_plain(
                       g, whole_m, t_cur, tm, tp, 0.25), 5)}
        second = {name: timed_ms(fn, 50) for name, fn in bwd.items()}
        ms_b = {name: min(first[name], second[name]) for name in bwd}
        vec, op = N_m * 4 * K * 8, data_m.numel() * 8
        plane_v, plane_d = P_m * 4 * K * 8, P_m * S * 128
        nbytes_b = {"ell_spmm_adjoint_halo": op + 5 * vec + 2 * plane_v + 2 * plane_d,
                    "ell_block_outer_halo": 3 * vec + 2 * op + 2 * plane_v}
        for name in ("ell_spmm_adjoint_halo", "ell_block_outer_halo"):
            rows_out[name] = bound_row(name, "metal 512x512x1, whole lattice as one slab", sk_m, K, ms_b[name],
                                       plain_b[name], nbytes_b[name], spmm_flops(sk_m, K), err_b[name], None,
                                       "none (ell_spmm_adjoint / ell_block_outer on the same rows are the yardstick)",
                                       [first[name], second[name]])
        emit({"phase": "sharded", "timing": "halo backward pair at 512x512, K = 8, the sweep's form", "ms": ms_b})
        del t_cur, g, add, t_next, h_out, neg, bwd, data_m

        # -------- single-device references on the same probes and scale (not part of the path's read)
        energies = np.linspace(-1.0, 1.0, 41)
        sites = [(100 + 50 * i, 100 + 50 * j, 0) for i in range(4) for j in range(4)]
        scale = kpm.spectral_bound(big.data, sk)
        ref = {"F": big.free_energy(0.01, method="kpm", order=256, samples=8, scale=scale),
               "ldos": big.ldos_map(sites, energies, method="kpm", order=512, scale=scale),
               "dos": big.dos(energies, order=256, samples=8, scale=scale)}
        kw_gap = dict(V=2.5, temperature=0.0, method="kpm", order=512, samples=8)
        steps, delta0 = 60, 0.3
        if shared.get("gap_steps") != steps:  # phase gap did not run, or ran a short solve
            shared["gap_delta"] = float(np.real(sc.solve_gap(metal, uniform=True, delta0=delta0, steps=steps,
                                                             learning_rate=0.08 / N_m, **kw_gap)[0][0]))
        gap_delta = shared["gap_delta"]
        rng = np.random.default_rng(17)
        field_s = (0.3 + 0.05 * rng.standard_normal(N_m)).astype(np.float32)
        dwave_shape = (64, 64, 1)
        field_d = (0.2 + 0.05 * rng.standard_normal(64 * 64)).astype(np.float32)
        scale_s = kpm.spectral_bound(
            sc.data_with_onsite_swave(metal.data, torch.full((N_m,), 2.0, device=dev, dtype=c64)), sk_m)
        metal_d = normal_metal(dwave_shape)
        sk_d = metal_d.skeleton
        scale_d = kpm.spectral_bound(sc.data_with_bond_singlet(
            metal_d.data, torch.full((sk_d.n_sites,), 2.0, device=dev, dtype=c64), sk_d, sc.bond_structure_dwave(sk_d)), sk_d)
        objectives = {"swave 512x512": ((512, 512, 1), dict(kw_gap, scale=scale_s), field_s),
                      "dwave 64x64 order 256": (dwave_shape, dict(kw_gap, order=256, pairing="dwave", scale=scale_d), field_d)}

        # -------- the path: a world of one over NCCL (launch counters read here)
        check(initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl"), "no process group")
        try:
            mesh = make_row_mesh()
            rs = RowSharding(sk, mesh)
            check(mesh.backend == "nccl" and rs.slab.planes == Lx, f"world of one: {mesh}")
            ck.reset_launch_counts()
            expected = counts()
            got = {}
            for overlap in (False, True):
                per = 3 if overlap else 1
                for label, fn, order in (
                    ("free_energy", lambda: free_energy_kpm_sharded_cuda(rs, big.data, 0.01, scale, order=256, samples=8,
                                                                         overlap=overlap), 256),
                    ("ldos", lambda: ldos_kpm_sharded_cuda(rs, big.data, [big.lattice.index(c) for c in sites], energies,
                                                           order=512, scale=scale, overlap=overlap), 512),
                    ("dos", lambda: dos_kpm_sharded_cuda(rs, big.data, energies, order=256, scale=scale, samples=8,
                                                         overlap=overlap), 256),
                ):
                    rs.stats.update(exchanges=0, exchange_s=0.0, staging_s=0.0)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got[(label, overlap)] = fn()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    expected["ell_cheb_step_halo"] += per * ce.sweep_launches(order)
                    emit({"phase": "sharded", "call": f"world of one (nccl): {label}_kpm_sharded_cuda", "overlap": overlap,
                          "order": order, "wall_s": wall, "step_launches": per * ce.sweep_launches(order),
                          "ms_per_step_wall": wall / ce.sweep_launches(order) * 1e3, **rs.stats})
            for overlap in (False, True):
                F_s, ldos_s, dos_s = (got[(k, overlap)] for k in ("free_energy", "ldos", "dos"))
                errs = {"F_rel": abs(F_s - ref["F"]) / abs(ref["F"]),
                        "ldos_rel_to_max": float(np.abs(ldos_s - ref["ldos"]).max() / np.abs(ref["ldos"]).max()),
                        "dos_rel_to_max": float(np.abs(dos_s - ref["dos"]).max() / np.abs(ref["dos"]).max())}
                emit({"phase": "sharded", "check": "world of one against the single-device calls, same probes and scale",
                      "overlap": overlap, "F_sharded": F_s, "F_single": ref["F"], **errs})
                check(max(errs.values()) <= 1e-5, f"world of one differs from the single-device calls: {errs}")

            # solve_gap through the sharded objective at the showcase shape, 60 steps
            F_total = sc.make_total_free_energy(metal, impl="cuda_sharded", **kw_gap)
            x = torch.full((1,), delta0, device=dev, requires_grad=True)
            F_total(x.expand(N_m).to(c64))
            before = ck.launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (g0,) = torch.autograd.grad(F_total(x.expand(N_m).to(c64)), x)
            torch.cuda.synchronize()
            grad_wall = time.perf_counter() - t0
            per_gradient = launched_since(before)
            sweep = ce.sweep_launches(512)
            check(per_gradient == counts(ell_cheb_step_halo=sweep + replayed(512), ell_spmm_adjoint_halo=sweep,
                                         ell_block_outer_halo=sweep),
                  f"one sharded gradient launched {per_gradient}")
            expected["ell_spmm_halo"] += 60  # the objective's spectral bound
            # the warm-up value, the gradient's forward sweep and the steps its backward pass replays
            expected["ell_cheb_step_halo"] += 2 * sweep + replayed(512)
            expected["ell_spmm_adjoint_halo"] += sweep
            expected["ell_block_outer_halo"] += sweep
            del F_total
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            delta, F_gap = sc.solve_gap(metal, uniform=True, delta0=delta0, learning_rate=0.08 / N_m, steps=steps,
                                        impl="cuda_sharded", **kw_gap)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = peak_gap = torch.cuda.max_memory_allocated() / 1e9
            expected["ell_spmm_halo"] += 60
            expected["ell_cheb_step_halo"] += (steps + 1) * sweep + steps * replayed(512)
            expected["ell_spmm_adjoint_halo"] += steps * sweep
            expected["ell_block_outer_halo"] += steps * sweep
            diff = abs(float(np.real(delta[0])) - gap_delta)
            emit({"phase": "sharded", "call": "solve_gap(normal_metal((512,512,1)), V=2.5, T=0, uniform, order=512, "
                                              "samples=8, impl='cuda_sharded'), world of one (nccl)",
                  "steps": steps, "wall_s": wall, "seconds_per_iteration": wall / (steps + 1),
                  "one_gradient_wall_s": grad_wall, "launches_per_gradient": per_gradient, "peak_device_GB": peak,
                  "delta": float(np.real(delta[0])), "delta_single_device": gap_delta, "abs_diff": diff, "F_total": F_gap})
            check(diff <= 1e-5, f"sharded solve_gap Δ differs from the single-device Δ by {diff}")

            # the world-of-one side of the four-rank comparisons
            world_one = {}
            for name, (shape, kw, field) in objectives.items():
                system = metal if shape == (512, 512, 1) else metal_d
                F_total = sc.make_total_free_energy(system, impl="cuda_sharded", **kw)
                x = torch.as_tensor(field, device=dev).requires_grad_(True)
                value = F_total(x.to(c64))
                (grad,) = torch.autograd.grad(value, x)
                order = kw["order"]
                expected["ell_cheb_step_halo"] += ce.sweep_launches(order) + replayed(order)
                expected["ell_spmm_adjoint_halo"] += ce.sweep_launches(order)
                expected["ell_block_outer_halo"] += ce.sweep_launches(order)
                world_one[name] = (float(value.detach()), grad.cpu().numpy())
                del F_total
            sharded_launches = ck.launch_counts()  # read right after the path
            check(sharded_launches == expected, f"sharded path launched {sharded_launches}, expected {expected}")
            emit({"phase": "sharded", "launches": sharded_launches, "expected": expected})

            # The gradient at 512², order 512, K = 8 with √steps checkpointing off
            # and on (the objective's "auto": chunks of 15): peak memory, seconds a
            # gradient (an iteration of solve_gap is one gradient and a few small
            # passes), and the gradients bit-equal.  Off, on, on, off.
            rs_m = RowSharding(sk_m, mesh)
            coeffs = torch.linspace(1.0, -1.0, 512, device=dev, dtype=torch.float32)
            z = torch.as_tensor(kpm.rademacher_probes(N_m, 8, 11, np.complex64) / np.sqrt(4 * N_m), device=dev)

            def sharded_gradient(remat):
                delta = torch.full((N_m,), 0.3, device=dev, requires_grad=True)
                data = sc.data_with_onsite_swave(metal.data, delta.to(c64))
                dm, dp = data[(Lx_m - 1) * P_m:].detach(), data[:P_m].detach()  # the ring of one
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                mu = moments_sharded_ad(rs_m, data, z, 1.0 / scale_s, 512, dm, dp, remat=remat)
                (g,) = torch.autograd.grad((coeffs * mu.sum(dim=1)).sum(), delta)
                torch.cuda.synchronize()
                return g, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9

            remat_runs = {False: [], "auto": []}
            grads = {}
            for remat in (False, "auto", "auto", False):
                g, wall, peak = sharded_gradient(remat)
                remat_runs[remat].append({"s_per_gradient": wall, "peak_device_GB": peak})
                grads[remat] = g
            emit({"phase": "sharded", "gradient": "512x512, order 512, K = 8, world of one: remat off and 'auto'",
                  "chunk_auto": cs.remat_chunk_for(512, "auto"), "replayed_steps": replayed(512),
                  "off": remat_runs[False], "auto": remat_runs["auto"],
                  "gradients_bit_equal": bool(torch.equal(grads[False], grads["auto"])),
                  "solve_gap_peak_device_GB": peak_gap})
            check(torch.equal(grads[False], grads["auto"]), "the gradient with remat differs from the one without")
            del grads
        finally:
            dist.destroy_process_group()

        # -------- four gloo ranks on the one card
        probes = kpm.rademacher_probes(N, 8, 5, np.complex64)
        single_mu = kpm.moments(big.data, sk, probes, 64, scale).cpu().numpy()
        del big
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        four = run_ranks(4, "gloo", {"scale": scale, "probes": probes, "objectives": objectives}, timeout=600)[0]
        four_wall = time.perf_counter() - t0
        fe = four["free_energy"]
        errs = {"F_rel_vs_world_one": abs(fe["F"] - got[("free_energy", False)]) / abs(got[("free_energy", False)]),
                "mu_rows_rel_vs_single": float(np.abs(four["mu_rows"] - single_mu).max() / np.abs(single_mu).max()),
                "mu_2x2_rel_vs_rows": float(np.abs(four["mu_2d"] - four["mu_rows"]).max() / np.abs(four["mu_rows"]).max())}
        for name, (F1, g1) in world_one.items():
            errs[f"{name}: F_rel"] = abs(four[name]["F"] - F1) / abs(F1)
            errs[f"{name}: grad_rel_to_max"] = float(np.abs(four[name]["grad"] - g1).max() / np.abs(g1).max())
        steps_fe = ce.sweep_launches(256)
        emit({"phase": "sharded", "call": "4 gloo ranks on the one card, 250 planes each",
              "wall_s_all_ranks_incl_start": four_wall, "free_energy_wall_s": fe["wall_s"],
              "ms_per_step_wall": fe["wall_s"] / steps_fe * 1e3, "exchanges": fe["exchanges"],
              "exchange_share": fe["exchange_s"] / fe["wall_s"], "host_staging_share": fe["staging_s"] / fe["wall_s"],
              "rank0_launches": fe["launches"],
              "objective_wall_s": {name: four[name]["wall_s"] for name in objectives}, **errs})
        check(fe["launches"]["ell_cheb_step_halo"] == steps_fe, f"rank 0 launched {fe['launches']}")
        check(max(errs.values()) <= 1e-5, f"four ranks differ: {errs}")

        # -------- NCCL with two ranks on the one card is refused, naming gloo
        refused = run_ranks(2, "nccl", {"expect_refusal": True}, timeout=120)
        messages = [refused[r]["refused"] for r in sorted(refused)]
        emit({"phase": "sharded", "check": "two NCCL ranks on the one card", "messages": messages})
        check(all(m is not None and "gloo" in m for m in messages), f"make_row_mesh did not refuse: {messages}")
        emit({"phase": "sharded", "wall_s": time.perf_counter() - phase_t0})
        return sharded_launches, rows_out

    # ------------------------------------------------------------------ 13. bf16 operator storage
    def phase_bf16():
        """bf16 operator storage at full width (launch counters read here): the
        KPM entry points on swave_superconductor((1000,1000,1)) with
        operator_dtype="bf16" beside the float32 calls, apply, the tiled step,
        the generic sheet through the gather step, a world of one through
        pack_operator_sharded, and diagonalize(method="lanczos", k=4) at 32×32
        against eigvalsh of the rounded operator; then the seven bf16
        instantiations timed at the path's shapes beside their float32 forms, and
        one call traced with utils.trace."""
        from bodge_tpu_torch.parallel import (RowSharding, free_energy_kpm_sharded_cuda, make_row_mesh,
                                              pack_operator_sharded, spmm_sharded_cuda)

        phase_t0 = time.perf_counter()
        energies = np.linspace(-1.0, 1.0, 41)
        sites = [(100 + 50 * i, 100 + 50 * j, 0) for i in range(4) for j in range(4)]
        big = swave_superconductor((1000, 1000, 1))
        sk = big.skeleton
        N, S = sk.cols.shape
        sheet = swave_on(HoleSheet(1024, 256, 60))
        sk_s = sheet.skeleton
        small = Hamiltonian(CubicLattice((32, 32, 1)), device=dev)  # phase lowest's 32×32 lattice
        small.assemble(onsite=lambda ci: (-0.5 + 0.08 * np.cos(2.39996 * ci[:, 0] + 1.1 * ci[:, 1]))[:, None, None] * σ0,
                       hopping=lambda ci, cj: -1.0 * σ0, pairing_onsite=lambda ci: 0.2 * jσ2)
        rashba = rashba_dp_wave((64, 64, 4))  # phase main's: the bf16 moment kernel's sweep
        scale = kpm.spectral_bound(big.data, sk)
        scale_s = kpm.spectral_bound(sheet.data, sk_s)
        scale_r = kpm.spectral_bound(rashba.data, rashba.skeleton)
        rs = RowSharding(sk, make_row_mesh())  # a world of one without a process group: the ring is a local copy
        v8, v8_s = random_vector(N, 8, 71), random_vector(sk_s.n_sites, 8, 72)
        steps, kw, k = ce.sweep_launches, dict(method="kpm", order=256, samples=8), 4
        # label: (the call at an operator_dtype, the launches its bf16 call makes, their probe width K)
        calls = {
            "free_energy(T=0.01, order=256, samples=8)": (
                lambda dt: big.free_energy(0.01, operator_dtype=dt, **kw),
                {"ell_cheb_step_bf16": steps(256), "ell_spmm": 60}, 8),
            "ldos((500,500,0), order=512)": (
                lambda dt: big.ldos((500, 500, 0), energies, method="kpm", order=512, scale=scale, operator_dtype=dt),
                {"ell_cheb_step_bf16": steps(512)}, 4),
            "ldos_map(16 sites, order=512)": (
                lambda dt: big.ldos_map(sites, energies, method="kpm", order=512, scale=scale, operator_dtype=dt),
                {"ell_cheb_step_bf16": steps(512)}, 64),
            "dos(order=256, samples=8)": (
                lambda dt: big.dos(energies, order=256, samples=8, scale=scale, operator_dtype=dt),
                {"ell_cheb_step_bf16": steps(256)}, 8),
            "apply(K=8)": (lambda dt: big.apply(v8, operator_dtype=dt), {"ell_spmm_bf16": 1}, 8),
            "free_energy(T=0.01, order=256, samples=8, impl='cuda_tiled')": (
                lambda dt: big.free_energy(0.01, scale=scale, impl="cuda_tiled", operator_dtype=dt, **kw),
                {"stencil_cheb_step_tiled_bf16": steps(256)}, 8),
            "sheet: free_energy(T=0.05, order=256, samples=8)": (
                lambda dt: sheet.free_energy(0.05, scale=scale_s, operator_dtype=dt, **kw),
                {"ell_gather_cheb_step_bf16": steps(256)}, 8),
            "sheet: apply(K=8)": (lambda dt: sheet.apply(v8_s, operator_dtype=dt), {"ell_gather_spmm_bf16": 1}, 8),
            "rashba 64x64x4: free_energy(T=0.01, order=256, samples=8)": (
                lambda dt: rashba.free_energy(0.01, scale=scale_r, operator_dtype=dt, **kw),
                {"ell_cheb_moments_bf16": 1, "ell_cheb_moments_bf16.steps": steps(256)}, 8),
            "world of one: free_energy_kpm_sharded_cuda(pack_operator_sharded(...))": (
                lambda dt: free_energy_kpm_sharded_cuda(rs, pack_operator_sharded(rs, big.data, dt), 0.01, scale,
                                                        order=256, samples=8),
                {"ell_cheb_step_halo_bf16": steps(256)}, 8),
            "world of one: spmm_sharded_cuda(pack_operator_sharded(...), K=8)": (
                lambda dt: spmm_sharded_cuda(rs, pack_operator_sharded(rs, big.data, dt), v8),
                {"ell_spmm_halo_bf16": 1}, 8),
        }
        f32 = {label: fn(None) for label, (fn, _, _) in calls.items()}  # beside the path, not in its read
        torch.cuda.synchronize()

        ck.reset_launch_counts()
        got, walls, per_call = {}, {}, {}
        for label, (fn, want, _) in calls.items():
            before = ck.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with annotate(f"bf16: {label}"):
                got[label] = fn("bf16")
                torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            per_call[label] = launched_since(before)
            check(per_call[label] == counts(**want), f"bf16 {label} launched {per_call[label]}, expected {want}")
        label_l = "32x32: diagonalize(method='lanczos', k=4, operator_dtype='bf16')"
        before = ck.launch_counts()
        t0 = time.perf_counter()
        with annotate(f"bf16: {label_l}"):
            E16, X16 = small.diagonalize(method="lanczos", k=k, format="raw", operator_dtype="bf16")
        walls[label_l] = time.perf_counter() - t0
        per_call[label_l] = launched_since(before)
        bf16_launches = ck.launch_counts()  # read right after the path
        # The same call with its record (same seed, kernels that repeat bit for bit):
        # one ell_cheb_filter_bf16 launch an application, and the float32 bound's
        # 60 products.
        before = ck.launch_counts()
        _, _, info16 = lz.lowest_eigenstates(small.data, small.skeleton, 2 * k + 2, full_output=True,
                                             operator_dtype="bf16")
        recorded = launched_since(before)
        want16 = counts(**expected_filter(small.skeleton, info16["history"], bf16=True),
                        **expected_bound(small.skeleton))
        check(per_call[label_l] == recorded == want16 and recorded["ell_cheb_filter_bf16"] == info16["iterations"],
              f"bf16 lanczos launched {per_call[label_l]}, its record {recorded}, the history says {want16}")
        float32_forward = {n: v for n, v in bf16_launches.items() if v and "_bf16" not in n}
        bounds_launches = {"ell_spmm": ITERS, "ell_power_iteration": 1, "ell_power_iteration.steps": ITERS}
        check(float32_forward == bounds_launches,  # the 10⁶ bound per step, the 32×32 one a launch
              f"float32 launches in the bf16 path beyond the bounds': {float32_forward}")

        # Held: each observable finite and of the float32 call's shape, the s-wave gap
        # visible; the drift of each against the float32 call; the world of one against
        # the single-device bf16 calls; the lowest states against eigvalsh of the rounded
        # operator (float64, on the card) to the solver's tolerance.
        mid, outside = len(energies) // 2, np.abs(energies) >= 0.5
        drift = {}
        for label in calls:
            a, b = got[label], f32[label]
            if isinstance(a, float):
                check(math.isfinite(a), f"bf16 {label}: {a}")
                drift[label] = {"value_bf16": a, "value_float32": b, "rel": abs(a - b) / abs(b)}
            else:
                a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
                check(a.shape == b.shape and np.isfinite(a).all(), f"bf16 {label}: wrong shape or not finite")
                drift[label] = {"max_abs": float(np.abs(a - b).max()),
                                "rel_to_max": float(np.abs(a - b).max() / np.abs(b).max())}
        rho, rho_map = got["ldos((500,500,0), order=512)"], got["ldos_map(16 sites, order=512)"]
        check(rho.min() >= -1e-6 and rho[mid] < 0.1 * rho[outside].mean(), "bf16 LDOS shows no s-wave gap")
        check(bool((rho_map[:, mid] < 0.1 * rho_map[:, outside].mean(axis=1)).all()), "bf16 LDOS map shows no gap")
        F16 = got["free_energy(T=0.01, order=256, samples=8)"]
        sharded_rel = abs(got["world of one: free_energy_kpm_sharded_cuda(pack_operator_sharded(...))"] - F16) / abs(F16)
        tiled_rel = abs(got["free_energy(T=0.01, order=256, samples=8, impl='cuda_tiled')"] - F16) / abs(F16)
        y16, y16_sh = got["apply(K=8)"], got["world of one: spmm_sharded_cuda(pack_operator_sharded(...), K=8)"]
        check(sharded_rel <= 1e-5 and tiled_rel <= 1e-5, f"bf16 F: sharded {sharded_rel}, tiled {tiled_rel} apart")
        check(torch.allclose(y16_sh, y16, atol=2e-4, rtol=2e-4), "bf16 sharded product differs from apply")
        sharded_product_bit_equal = bool(torch.equal(y16_sh, y16))
        check(max(d.get("rel", d.get("rel_to_max", 0.0)) for d in drift.values()) <= 5e-2,
              f"bf16 drift beyond 5e-2 of the float32 result: {drift}")
        rounded = ce.operator_values(ce.bf16_operator(small.data), c128)
        E_r = torch.linalg.eigvalsh(bs.ell_to_dense_torch(rounded, small.skeleton))
        E_f = torch.linalg.eigvalsh(small.matrix("dense_torch").to(c128))
        want_r, want_f = (E[E > 0][:k].cpu().numpy() for E in (E_r, E_f))
        lowest = {"vs_eigvalsh_of_rounded": float(np.abs(E16 - want_r).max()),
                  "vs_float32_spectrum": float(np.abs(E16 - want_f).max()),
                  "rounded_vs_float32_spectrum": float(np.abs(want_r - want_f).max())}
        check(lowest["vs_eigvalsh_of_rounded"] <= 1e-6, f"bf16 lowest states off the rounded operator's: {lowest}")
        del rounded, E_r, E_f
        # The filter's bf16 form on the bf16 operator at the call's widths (both
        # modes, orders 256 and 4096), timed there, and its line of the table.
        held_at_widths("32x32 modulated s-wave, bf16 form", small, {h[4] for h in info16["history"]}, bf16=True)
        by_width = steps_by_width(info16["history"])
        filter16 = filter_row("ell_cheb_filter_bf16", "32x32 modulated s-wave, bf16 form", small,
                              max(by_width, key=by_width.get), bf16=True)

        # The seven bf16 instantiations at the path's shapes, each beside its
        # float32 form on the same operands: float32, bf16, bf16, float32.
        rows, kernel_ms = {"ell_cheb_filter_bf16": filter16}, {}
        rows["ell_cheb_moments_bf16"] = moments_row("ell_cheb_moments_bf16", "rashba 64x64x4 bf16 form, "
                                                    "free_energy's sweep", rashba, 8, 256, bf16=True)
        kernel_ms[("ell_cheb_moments_bf16", 8)] = rows["ell_cheb_moments_bf16"]["ms"]
        form = ce.bf16_operator(big.data)
        lib = "none (no torch call takes a bf16 (re, im) operator; the float32 kernel beside it is the yardstick)"

        def measure(name, name32, label, sk_m, K, fn16, fn32, plain16, nbytes, err, reps=20):
            a32, a16 = timed_ms(fn32, reps), timed_ms(fn16, reps)
            plain = timed_ms(plain16, 3) if plain16 is not None else None
            b16, b32 = timed_ms(fn16, reps), timed_ms(fn32, reps)
            row = bound_row(name, label, sk_m, K, min(a16, b16), plain, nbytes, spmm_flops(sk_m, K), err, None, lib,
                            [a16, b16])
            row.update(float32_form=name32, float32_ms=min(a32, b32), float32_runs_ms=[a32, b32],
                       ratio_to_float32=min(a16, b16) / min(a32, b32))
            emit({"phase": "bf16", "timing": name, "K": K, "ms": row["ms"], "float32_ms": row["float32_ms"],
                  "ratio_to_float32": row["ratio_to_float32"], "bound_ms": row["bound_ms"],
                  "share_of_bound": row["bound_ms"] / row["ms"]})
            kernel_ms[(name, K)] = row["ms"]
            return row

        label = "swave 1000x1000x1"
        for K in (8, 1, 4, 64):
            t_cur, t_prev = random_vector(N, K, 73), random_vector(N, K, 74)
            out = torch.empty_like(t_cur)
            t16, _ = ce.ell_cheb_step(form, sk, t_cur, t_prev, 0.125)
            t16_plain, _ = ce.ell_cheb_step_plain(form, sk, t_cur, t_prev, 0.125)
            err = float((t16 - t16_plain).abs().max())
            check(torch.allclose(t16, t16_plain, atol=2e-4, rtol=2e-4), f"ell_cheb_step_bf16 at 10^6, K={K}: {err}")
            del t16, t16_plain
            row = measure("ell_cheb_step_bf16", "ell_cheb_step", label, sk, K,
                          lambda: ce.ell_cheb_step(form, sk, t_cur, t_prev, 0.125, out=out),
                          lambda: ce.ell_cheb_step(big.data, sk, t_cur, t_prev, 0.125, out=out),
                          (lambda: ce.ell_cheb_step_plain(form, sk, t_cur, t_prev, 0.125)) if K <= 8 else None,
                          chebyshev_step_bytes(sk, K, 8, operator_itemsize=2), err, reps=20 if K < 64 else 5)
            if K == 8:
                rows["ell_cheb_step_bf16"] = row
            if K in (8, 1):
                y16, y16_plain = ce.ell_spmm(form, sk, t_cur), ce.ell_spmm_plain(form, sk, t_cur)
                err = float((y16 - y16_plain).abs().max())
                check(torch.allclose(y16, y16_plain, atol=2e-4, rtol=2e-4), f"ell_spmm_bf16 at 10^6, K={K}: {err}")
                del y16, y16_plain
                row = measure("ell_spmm_bf16", "ell_spmm", label, sk, K, lambda: ce.ell_spmm(form, sk, t_cur),
                              lambda: ce.ell_spmm(big.data, sk, t_cur), lambda: ce.ell_spmm_plain(form, sk, t_cur),
                              spmm_bytes(sk, K, 8, operator_itemsize=2), err)
                if K == 8:
                    rows["ell_spmm_bf16"] = row
            if K == 8:
                # The tiled step and the halo forms (the whole lattice as one slab, the world of one's form).
                t16, _ = ce.stencil_cheb_step_tiled(form, sk, t_cur, t_prev, 0.125)
                t16_plain, _ = ce.stencil_cheb_step_tiled_plain(form, sk, t_cur, t_prev, 0.125)
                err = float((t16 - t16_plain).abs().max())
                check(torch.allclose(t16, t16_plain, atol=2e-4, rtol=2e-4), f"tiled bf16 step at 10^6: {err}")
                del t16, t16_plain
                rows["stencil_cheb_step_tiled_bf16"] = measure(
                    "stencil_cheb_step_tiled_bf16", "stencil_cheb_step_tiled", label, sk, K,
                    lambda: ce.stencil_cheb_step_tiled(form, sk, t_cur, t_prev, 0.125, out=out),
                    lambda: ce.stencil_cheb_step_tiled(big.data, sk, t_cur, t_prev, 0.125, out=out),
                    lambda: ce.stencil_cheb_step_tiled_plain(form, sk, t_cur, t_prev, 0.125),
                    chebyshev_step_bytes(sk, K, 8, operator_itemsize=2), err)
                whole = ce.halo_slab(sk, 0, sk.shape[0])
                P = whole.plane
                hm, hp = t_cur[(sk.shape[0] - 1) * P:].clone(), t_cur[:P].clone()
                halo_16 = N * S * 64 + 2 * P * 4 * K * 8  # the slab's bf16 operator rows and the two halo planes
                t16, _ = ce.ell_cheb_step_halo(form, whole, t_cur, hm, hp, t_prev, 0.125)
                t16_plain, _ = ce.ell_cheb_step_halo_plain(form, whole, t_cur, hm, hp, t_prev, 0.125)
                y16 = ce.ell_spmm_halo(form, whole, t_cur, hm, hp)
                y16_plain = ce.ell_spmm_halo_plain(form, whole, t_cur, hm, hp)
                errs = {"step": float((t16 - t16_plain).abs().max()), "product": float((y16 - y16_plain).abs().max())}
                check(torch.allclose(t16, t16_plain, atol=2e-4, rtol=2e-4)
                      and torch.allclose(y16, y16_plain, atol=2e-4, rtol=2e-4), f"bf16 halo forms at 10^6: {errs}")
                del t16, t16_plain, y16, y16_plain
                label_h = "swave 1000x1000x1, whole lattice as one slab"
                rows["ell_cheb_step_halo_bf16"] = measure(
                    "ell_cheb_step_halo_bf16", "ell_cheb_step_halo", label_h, sk, K,
                    lambda: ce.ell_cheb_step_halo(form, whole, t_cur, hm, hp, t_prev, 0.125, out=out),
                    lambda: ce.ell_cheb_step_halo(big.data, whole, t_cur, hm, hp, t_prev, 0.125, out=out),
                    lambda: ce.ell_cheb_step_halo_plain(form, whole, t_cur, hm, hp, t_prev, 0.125),
                    halo_16 + 3 * N * 4 * K * 8, errs["step"])
                rows["ell_spmm_halo_bf16"] = measure(
                    "ell_spmm_halo_bf16", "ell_spmm_halo", label_h, sk, K,
                    lambda: ce.ell_spmm_halo(form, whole, t_cur, hm, hp, out=out),
                    lambda: ce.ell_spmm_halo(big.data, whole, t_cur, hm, hp, out=out),
                    lambda: ce.ell_spmm_halo_plain(form, whole, t_cur, hm, hp),
                    halo_16 + 2 * N * 4 * K * 8, errs["product"])
                del hm, hp
            del t_cur, t_prev, out
        # The gather pair on the sheet, relabelled, at K = 8: the bf16
        # instantiations on the bf16 operator's plan (the cluster form), the
        # float32 forms on theirs; the general bf16 kernels on the same
        # relabelled operator (the relabelled skeleton's cols) as the yardstick.
        K, N_s, S_s = 8, sk_s.n_sites, sk_s.n_slots
        gl, gl16 = cg.plan_gather(sk_s, K), cg.plan_gather(sk_s, K, operator_dtype="bf16")
        d_rel = gl.relabel(sheet.data).contiguous()
        f_rel = ce.bf16_operator(d_rel)
        t_cur, t_prev = random_vector(N_s, K, 75), random_vector(N_s, K, 76)
        out = torch.empty_like(t_cur)
        t16, pp16 = cg.ell_gather_cheb_step(f_rel, gl16, t_cur, t_prev, 0.125)
        t16_again, pp16_again = cg.ell_gather_cheb_step(f_rel, gl16, t_cur, t_prev, 0.125)
        t16_plain, _ = cg.ell_gather_cheb_step_plain(f_rel, gl16, t_cur, t_prev, 0.125)
        y16, y16_plain = cg.ell_gather_spmm(f_rel, gl16, t_cur), cg.ell_gather_spmm_plain(f_rel, gl16, t_cur)
        errs = {"step": float((t16 - t16_plain).abs().max()), "product": float((y16 - y16_plain).abs().max())}
        check(torch.allclose(t16, t16_plain, atol=2e-4, rtol=2e-4) and torch.allclose(y16, y16_plain, atol=2e-4, rtol=2e-4),
              f"bf16 gather kernels on the sheet: {errs}")
        check(torch.equal(t16, t16_again) and torch.equal(pp16, pp16_again),
              "the bf16 gather step's t_next or partials differ between two runs on the sheet")
        del t16, t16_again, pp16, pp16_again, t16_plain, y16, y16_plain
        rel_bytes, label_s = N_s * S_s * 4, "HoleSheet(1024, 256, 60), relabelled"
        yardstick = {"ell_gather_cheb_step_bf16": lambda: ce.ell_cheb_step(f_rel, gl.sk, t_cur, t_prev, 0.125, out=out),
                     "ell_gather_spmm_bf16": lambda: ce.ell_spmm(f_rel, gl.sk, t_cur)}
        yard_runs = {name: [timed_ms(fn, 50)] for name, fn in yardstick.items()}
        rows["ell_gather_cheb_step_bf16"] = measure(
            "ell_gather_cheb_step_bf16", "ell_gather_cheb_step", label_s, sk_s, K,
            lambda: cg.ell_gather_cheb_step(f_rel, gl16, t_cur, t_prev, 0.125, out=out),
            lambda: cg.ell_gather_cheb_step(d_rel, gl, t_cur, t_prev, 0.125, out=out),
            lambda: cg.ell_gather_cheb_step_plain(f_rel, gl16, t_cur, t_prev, 0.125),
            chebyshev_step_bytes(sk_s, K, 8, operator_itemsize=2) + rel_bytes, errs["step"], reps=50)
        rows["ell_gather_spmm_bf16"] = measure(
            "ell_gather_spmm_bf16", "ell_gather_spmm", label_s, sk_s, K,
            lambda: cg.ell_gather_spmm(f_rel, gl16, t_cur), lambda: cg.ell_gather_spmm(d_rel, gl, t_cur),
            lambda: cg.ell_gather_spmm_plain(f_rel, gl16, t_cur),
            spmm_bytes(sk_s, K, 8, operator_itemsize=2) + rel_bytes, errs["product"], reps=50)
        for name, fn in yardstick.items():
            yard_runs[name].append(timed_ms(fn, 50))
            rows[name].update(plan=plan_of(gl16), float32_plan=plan_of(gl),
                              yardstick="ell_spmm_bf16" if "spmm" in name else "ell_cheb_step_bf16",
                              yardstick_ms=min(yard_runs[name]), yardstick_runs_ms=yard_runs[name])
            emit({"phase": "bf16", "timing": name, "plan": plan_of(gl16), "float32_plan": plan_of(gl),
                  "ms": rows[name]["ms"], "bound_ms": rows[name]["bound_ms"],
                  "yardstick": rows[name]["yardstick"] + " on the same relabelled operator",
                  "yardstick_ms": rows[name]["yardstick_ms"],
                  "ratio_to_yardstick": rows[name]["ms"] / rows[name]["yardstick_ms"]})
        del d_rel, f_rel, t_cur, t_prev, out, form, yardstick

        # Each call's wall, launches and device ms (launches × the kernel's ms at
        # the call's width in this run; the bound's float32 products at K = 1 from
        # phase widths' shape are not timed here and left out), and its drift.
        for label, (_, want, K) in calls.items():
            dev_ms = sum(n * kernel_ms.get((name, K), float("nan")) for name, n in want.items() if name.endswith("_bf16"))
            emit({"phase": "bf16", "call": label, "wall_s": walls[label], "launches": want, "K": K,
                  "device_ms_bf16_kernels": dev_ms, "busy_share": dev_ms / 1e3 / walls[label], "drift": drift[label]})
        emit({"phase": "bf16", "call": label_l, "wall_s": walls[label_l], "launches": per_call[label_l],
              "E": E16.tolist(), **lowest, "tolerance": 1e-6,
              "record": {"iterations": info16["iterations"], "seconds": info16["seconds"],
                         "orders": [h[1] for h in info16["history"]], "blocks": [h[4] for h in info16["history"]],
                         "steps_by_width": steps_by_width(info16["history"])}})
        emit({"phase": "bf16", "checks": {"sharded_F_rel_vs_single": sharded_rel, "tiled_F_rel_vs_general": tiled_rel,
                                          "sharded_product_bit_equal_to_apply": sharded_product_bit_equal},
              "launches": bf16_launches, "float32_forward_launches": float32_forward})

        # One call under utils.trace: the profiler's device time of the bf16 ldos.
        trace_dir = os.path.join(str(_build.build_dir()), "traces", "bf16_ldos")
        with trace(trace_dir) as prof:
            with annotate("bf16: traced ldos"):
                calls["ldos((500,500,0), order=512)"][0]("bf16")
                torch.cuda.synchronize()
        # Self device time by event: the kernels, the copies, and the span's own GPU-side record.
        top = sorted(((e.key[:80], (getattr(e, "self_device_time_total", 0) or 0) / 1e3, e.count)
                      for e in prof.key_averages()), key=lambda t: -t[1])
        with open(os.path.join(trace_dir, "trace.json")) as f:
            span = "bf16: traced ldos" in f.read()
        emit({"phase": "bf16", "trace": trace_dir, "annotated_span_in_trace": span,
              "profiler_ell_kernel_ms": sum(ms for key, ms, _ in top if "ell_kernel" in key),
              "profiler_top_self_device_ms_count": top[:8],
              "expected_device_ms": steps(512) * kernel_ms[("ell_cheb_step_bf16", 4)]})
        check(span, "the annotated span is not in the trace file")
        emit({"phase": "bf16", "wall_s": time.perf_counter() - phase_t0})
        return bf16_launches, rows

    # ------------------------------------------------------------------ 14. the native host tier
    def cpu_model() -> str:
        """The host's CPU: lscpu's or /proc/cpuinfo's model name, else its vendor,
        family and model numbers; with the cores and torch's threads."""
        fields = {}
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        except (OSError, subprocess.TimeoutExpired):
            out = ""
        if os.path.exists("/proc/cpuinfo"):
            with open("/proc/cpuinfo") as f:
                out += "\n" + f.read()
        for line in out.splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip().lower(), value.strip())
        name = fields.get("model name") or " ".join(
            f"{k} {fields[k]}" for k in ("vendor_id", "vendor id", "cpu family", "model") if fields.get(k)) or "unknown"
        return f"{name}, {os.cpu_count()} cores, torch threads {torch.get_num_threads()}"

    def bits(t):
        """The bit patterns of a complex tensor (so that -0.0 and 0.0 differ)."""
        return torch.view_as_real(t).view(torch.int32 if t.dtype == c64 else torch.int64)

    def phase_native():
        """The native host tier (bodge_tpu_torch.native, g++ at first use): host
        assembly + Hermiticity gate of the 1000×1000 s-wave system on CPU tensors
        against the torch path, herm_error against blocksparse.hermiticity_error,
        and the mirror search of the 1024×256 hole sheet against the searchsorted
        path — bit-equal, and both walls, beside the host's CPU model."""
        from unittest import mock

        from bodge_tpu_torch import native

        phase_t0 = time.perf_counter()
        t0 = time.perf_counter()
        check(native.available(), "the native library did not build (its error is on stderr)")
        t_build = time.perf_counter() - t0

        def host_system(use_native):
            with mock.patch.object(native, "available", return_value=use_native):
                t0 = time.perf_counter()
                system = Hamiltonian(CubicLattice((1000, 1000, 1)), dtype=np.complex64, device="cpu")
                t_new = time.perf_counter() - t0
                t0 = time.perf_counter()
                system.assemble(onsite=lambda ci: -0.5 * σ0, pairing_onsite=lambda ci: 0.3 * jσ2,
                                hopping=lambda ci, cj: np.where(
                                    (np.abs(ci - cj).max(axis=1) == 1)[:, None, None], -1.0 * σ0, 0),
                                check=False)
                t_assemble = time.perf_counter() - t0
                t0 = time.perf_counter()
                err = system._hermiticity_error()
                t_gate = time.perf_counter() - t0
            return system, {"hamiltonian_s": t_new, "assemble_s": t_assemble, "gate_s": t_gate,
                            "assemble_and_gate_s": t_assemble + t_gate, "hermiticity_error": err}

        walls = []  # torch, native, native, torch
        for use in (False, True, True, False):
            system, wall = host_system(use)
            walls.append({"path": "native" if use else "torch", **wall})
            if use:
                native_data = system.data
            else:
                torch_data = system.data
            del system
        same = bool(torch.equal(bits(native_data), bits(torch_data)))
        emit({"phase": "native", "call": "swave 1000x1000 on CPU tensors (complex64): assemble + gate",
              "host_cpu": cpu_model(), "build_s": t_build, "walls": walls, "data_bit_equal": same})
        check(same, "the native host assembly differs from the torch path")
        check(all(w["hermiticity_error"] == 0.0 for w in walls), f"gate: {walls}")

        sk = bs.skeleton((1000, 1000, 1))
        broken = native_data.clone()
        broken[12345, 1, 0, 1] += 0.5
        errs = {}
        for label, d in (("hermitian", native_data), ("one block broken", broken)):
            t0 = time.perf_counter()
            e_native = native.herm_error(d, sk.cols, sk.trans_slot)
            t_native = time.perf_counter() - t0
            t0 = time.perf_counter()
            e_torch = float(bs.hermiticity_error(d, sk))
            t_torch = time.perf_counter() - t0
            errs[label] = {"native": e_native, "torch": e_torch, "native_s": t_native, "torch_s": t_torch}
        emit({"phase": "native", "call": "herm_error against blocksparse.hermiticity_error (CPU, 10^6 sites)",
              **errs})
        check(errs["hermitian"]["native"] == 0.0 == errs["hermitian"]["torch"]
              and abs(errs["one block broken"]["native"] - errs["one block broken"]["torch"]) <= 1e-6
              and errs["one block broken"]["native"] > 0.4, f"herm_error: {errs}")
        del native_data, torch_data, broken

        sheet = HoleSheet(1024, 256, 60)
        skeleton_walls, built = [], {}  # searchsorted, native, native, searchsorted
        for use in (False, True, True, False):
            with mock.patch.object(native, "available", return_value=use):
                t0 = time.perf_counter()
                built[use] = bs.skeleton_from_lattice(sheet)
                skeleton_walls.append({"path": "native" if use else "searchsorted", "s": time.perf_counter() - t0})
        cols = built[True].cols
        r, slot_pos = np.nonzero(cols >= 0)  # the (row, col)-sorted pair list: a row's slots go by column
        mirror_walls = []  # the mirror search alone: searchsorted, native, native, searchsorted
        for use in (False, True, True, False):
            t0 = time.perf_counter()
            trans = (native.mirror_slots(cols) if use
                     else bs.mirror_slots_sorted(r, cols[r, slot_pos], slot_pos, *cols.shape))
            mirror_walls.append({"path": "native" if use else "searchsorted", "s": time.perf_counter() - t0})
            check(np.array_equal(trans, built[False].trans_slot), "mirror slots differ between the paths")
        same = (np.array_equal(built[True].trans_slot, built[False].trans_slot)
                and np.array_equal(built[True].cols, built[False].cols))
        emit({"phase": "native", "call": "skeleton_from_lattice(HoleSheet(1024, 256, 60)): mirror slots",
              "N": sheet.size, "S": int(cols.shape[1]), "skeleton_walls": skeleton_walls,
              "mirror_search_walls": mirror_walls, "bit_equal": bool(same), "host_cpu": cpu_model()})
        check(same, "the native mirror slots differ from the searchsorted path")
        emit({"phase": "native", "wall_s": time.perf_counter() - phase_t0})

    # ------------------------------------------------------------------ 15. the planar entry points
    def phase_planar():
        """The planar entry points at 1000×1000 on device_operator() under
        BODGE_PLANAR=1 (free_energy / ldos / dos through the KPM functions,
        apply through spmm_planar) against the façade's complex calls:
        bit-equal results, equal launches (launch counters read here), and the
        façade unchanged by the flag; the conversion's
        time and memory; the planar dense spectra at 16×16; a planar operator
        through the sharded free energy; and solve_gap(impl="cuda_sharded") at
        512² in a world of one against the same solve with the pre-insert
        field write."""
        import contextlib

        import torch.distributed as dist
        from unittest import mock

        from bodge_tpu_torch.ops import planar as pl
        from bodge_tpu_torch.parallel import (RowSharding, free_energy_kpm_sharded_cuda, initialize_multihost,
                                              make_row_mesh)

        phase_t0 = time.perf_counter()
        energies = np.linspace(-1.0, 1.0, 41)
        big = swave_superconductor((1000, 1000, 1))
        sk = big.skeleton
        scale = kpm.spectral_bound(big.data, sk)
        v = random_vector(sk.n_sites, 8, 77)
        centre = big.lattice[(500, 500, 0)]
        calls = (  # (label, the façade's complex call, the planar entry point on op)
            ("free_energy(T=0.01, order=256, samples=8)",
             lambda: big.free_energy(0.01, method="kpm", order=256, samples=8),
             lambda op: kpm.free_energy_kpm(op, sk, 0.01, order=256, samples=8)),
            ("ldos((500,500,0), order=512)",
             lambda: big.ldos((500, 500, 0), energies, method="kpm", order=512, scale=scale),
             lambda op: kpm.ldos_kpm(op, sk, centre, energies, order=512, scale=scale)),
            ("dos(order=256, samples=8)", lambda: big.dos(energies, order=256, samples=8, scale=scale),
             lambda op: kpm.dos_kpm(op, sk, energies, order=256, samples=8, scale=scale)),
            ("apply(K=8)", lambda: big.apply(v),
             lambda op: pl.from_planar(pl.spmm_planar(op, sk, pl.to_planar(v)))),
        )

        def run_calls(op=None):
            out, launched, walls = {}, {}, {}
            for label, facade, planar in calls:
                before = ck.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[label] = facade() if op is None else planar(op)
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t0
                launched[label] = launched_since(before)
            return out, launched, walls

        check(not pl.use_planar_device_path() and kpm.default_impl() == "auto", "BODGE_PLANAR is set before the phase")
        complex_out, complex_launches, complex_walls = run_calls()  # complex, planar, planar, complex
        os.environ["BODGE_PLANAR"] = "1"
        try:
            check(pl.use_planar_device_path() and kpm.default_impl() == "planar", "BODGE_PLANAR=1 not read")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            op = big.device_operator()
            torch.cuda.synchronize()
            t_convert = time.perf_counter() - t0
            conversion = {"to_planar_s": t_convert,
                          "planar_operator_MB": op.numel() * op.element_size() / 1e6,
                          "peak_extra_MB": (torch.cuda.max_memory_allocated() - base) / 1e6,
                          "from_planar_ms": timed_ms(lambda: pl.from_planar(op), 20),
                          "cached": big.device_operator() is op}
            check(op.shape == (2, *big.data.shape) and op.dtype == torch.float32 and conversion["cached"],
                  f"device_operator(): {op.shape} {op.dtype}")
            ck.reset_launch_counts()
            planar_out, planar_launches, planar_walls = run_calls(op)
            planar_path = ck.launch_counts()  # read right after the planar path
            planar_again, _, planar_walls_again = run_calls(op)
            complex_again, _, complex_walls_again = run_calls()  # the façade under the flag
        finally:
            del os.environ["BODGE_PLANAR"]
        same = {}
        for label, *_ in calls:
            a = complex_out[label]
            if isinstance(a, torch.Tensor):
                same[label] = all(bool(a.dtype == b.dtype and torch.equal(bits(a), bits(b)))
                                  for b in (planar_out[label], planar_again[label], complex_again[label]))
            else:
                same[label] = all(bool(np.array_equal(np.asarray(a), np.asarray(b)))
                                  for b in (planar_out[label], planar_again[label], complex_again[label]))
        emit({"phase": "planar", "call": "planar entry points on device_operator() under BODGE_PLANAR=1 at "
                                         "1000x1000 against the facade's complex calls (and the facade again "
                                         "under the flag)",
              "conversion": conversion, "walls_in_order": {"complex": complex_walls, "planar": planar_walls,
                                                           "planar again": planar_walls_again,
                                                           "complex again": complex_walls_again},
              "launches": planar_launches, "complex_launches": complex_launches, "bit_equal": same})
        check(all(same.values()), f"planar calls differ from the complex calls: {same}")
        check(planar_launches == complex_launches, "planar calls launched otherwise than the complex calls")
        check(planar_path["ell_cheb_step"] > 0 and planar_path["ell_spmm"] > 0, "the planar path launched no kernel")

        small = swave_superconductor((16, 16, 1))
        dp = pl.to_planar(small.data)
        H = small.matrix("dense_jnp")
        E_ref, X_ref = torch.linalg.eigh(H)
        E_v = pl.eigvalsh_planar(dp, small.skeleton)
        E, X = pl.eigh_planar(dp, small.skeleton)
        gap = E_ref[E_ref > 0].min()
        edge = (E_ref > 0) & (E_ref < gap + 1e-3)  # the gap-edge multiplet
        proj = lambda Y: Y[:, edge] @ Y[:, edge].conj().T
        dense = {"eigvalsh_max_abs": float((E_v - torch.linalg.eigvalsh(H)).abs().max()),
                 "eigh_values_max_abs": float((E - E_ref).abs().max()),
                 "residual_max_abs": float((H @ X - X * E).abs().max()),
                 "gap_edge_projector_max_abs": float((proj(X) - proj(X_ref)).abs().max()),
                 "gap_edge_multiplet": int(edge.sum())}
        emit({"phase": "planar", "call": "eigvalsh_planar / eigh_planar at 16x16 against torch.linalg.eigh",
              "tolerance": "1e-5 (float32 eigensolver on the same complex64 matrix)", **dense})
        check(dense["eigvalsh_max_abs"] <= 1e-5 and dense["eigh_values_max_abs"] <= 1e-5
              and dense["residual_max_abs"] <= 1e-4 and dense["gap_edge_projector_max_abs"] <= 1e-4,
              f"planar dense spectra: {dense}")

        def pre_insert_write(b, delta, sk):
            """The objective's on-site field write before the packed inserts, restated."""
            blk = (delta[:, None, None] * torch.as_tensor(np.asarray(jσ2)).to(device=b.device, dtype=b.dtype)).to(b.dtype)
            out = b.clone()
            out[:, 0, 0:2, 2:4] = blk
            out[:, 0, 2:4, 0:2] = blk.transpose(-1, -2).conj()
            return out

        metal = normal_metal((512, 512, 1))
        kw_gap = dict(V=2.5, temperature=0.0, method="kpm", order=512, samples=8, impl="cuda_sharded")
        steps = 10
        check(initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl"), "no process group")
        try:
            rs = RowSharding(sk, make_row_mesh())
            F_c = free_energy_kpm_sharded_cuda(rs, big.data, 0.01, scale, order=256, samples=8)
            F_p = free_energy_kpm_sharded_cuda(rs, op, 0.01, scale, order=256, samples=8)
            del op
            gaps = {}
            for label in ("inserts", "pre-insert write", "inserts again"):
                patch = contextlib.nullcontext()
                if label == "pre-insert write":
                    patch = mock.patch.object(sc, "plane_packed_insert_swave", pre_insert_write)
                with patch:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    delta, F_gap = sc.solve_gap(metal, uniform=True, delta0=0.3, steps=steps,
                                                learning_rate=0.08 / metal.skeleton.n_sites, **kw_gap)
                    torch.cuda.synchronize()
                    gaps[label] = (delta, F_gap, (time.perf_counter() - t0) / (steps + 1))
        finally:
            dist.destroy_process_group()
        equal = bool(all(np.array_equal(gaps[k][0], gaps["inserts"][0]) and gaps[k][1] == gaps["inserts"][1]
                         for k in gaps))
        emit({"phase": "planar", "call": f"world of one (nccl): free_energy_kpm_sharded_cuda on the planar operator; "
                                         f"solve_gap(normal_metal((512,512,1)), V=2.5, uniform, order=512, "
                                         f"samples=8, impl='cuda_sharded'), {steps} steps",
              "sharded_F_complex": F_c, "sharded_F_planar": F_p, "sharded_bit_equal": F_c == F_p,
              "delta": {k: float(np.real(g[0][0])) for k, g in gaps.items()},
              "F_total": {k: g[1] for k, g in gaps.items()},
              "seconds_per_iteration": {k: g[2] for k, g in gaps.items()},
              "delta_and_F_bit_equal_to_pre_insert_write": equal})
        check(F_c == F_p, f"the sharded free energy on the planar operator differs: {F_p} against {F_c}")
        check(equal, "the sharded solve_gap through the inserts differs from the pre-insert write")
        emit({"phase": "planar", "wall_s": time.perf_counter() - phase_t0})
        return planar_path, {}

    # ------------------------------------------------------------------ 16. the examples
    def phase_examples():
        """The four examples of the port as a user runs them (one process each, on
        the card), at reduced arguments where they are large: each must exit 0
        and end with its JSON result line."""
        runs = (
            ("torch_edge_states_map.py", []),
            ("torch_generic_lattice.py", []),
            ("torch_self_consistent_gap.py", ["--steps", "100", "--profile-steps", "150"]),
            ("torch_weak_scaling.py", ["--reps", "2"]),
        )
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)}
        phase_t0 = time.perf_counter()
        for script, args in runs:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.join(root, "examples", script), *args], env=env,
                                  cwd=root, capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1])
            except (IndexError, ValueError):
                result = None
            emit({"phase": "examples", "script": f"examples/{script}", "args": args, "wall_s": wall,
                  "exit_code": proc.returncode, "result": result,
                  **({"stderr_tail": proc.stderr[-2000:]} if proc.returncode else {})})
            check(proc.returncode == 0 and isinstance(result, dict) and result.get("example") == script[:-3],
                  f"examples/{script} failed (exit {proc.returncode})")
        emit({"phase": "examples", "wall_s": time.perf_counter() - phase_t0})

    def phase_window():
        """The two light-cone steps at 10⁶ sites, K = 64, against their
        whole-lattice steps on the card: ell_cheb_step_window on the 1000×1000
        s-wave lattice, ell_gather_cheb_step_window on the 4096×256 graphene
        ribbon in its relabelled order, each on centred windows of N/64, N/8 and
        N/2 rows.  The inputs are what a sweep leaves: random on the window less
        one band at each end, zero elsewhere.  t_next must be bit-equal to the
        whole step's on the window and zero outside it, the partial sums within
        1e-5 of the largest (other block boundaries); each form is timed (CUDA
        events, 20 launches) and reported in µs per 1000 rows."""
        from bodge_tpu_torch.models.systems import graphene_swave

        K, inv = 64, 0.125
        before = ck.launch_counts()
        big = swave_superconductor((1000, 1000, 1))
        ribbon = graphene_swave((4096, 256, 1))
        gl = cg.plan_gather(ribbon.skeleton, K)
        data_r = gl.relabel(ribbon.data).contiguous()
        del ribbon
        forms = (("ell_cheb_step_window", "swave 1000x1000", big.data, big.skeleton, big.skeleton,
                  ck.nonzero_bandwidth(big.data, big.skeleton), ce.ell_cheb_step, ce.ell_cheb_step_window,
                  ce.ell_cheb_step_window_plain, 0),
                 ("ell_gather_cheb_step_window", "graphene 4096x256, relabelled", data_r, gl.sk, gl, gl.bwb,
                  cg.ell_gather_cheb_step, cg.ell_gather_cheb_step_window, cg.ell_gather_cheb_step_window_plain,
                  gl.sk.n_sites * gl.sk.n_slots * 4))
        gen = torch.Generator(device=dev).manual_seed(1801)
        rows_out = {}
        for name, label, data, sk, where, band, whole, window, plain, extra_bytes in forms:
            N = sk.n_sites
            t_cur, t_prev = (torch.zeros((N, 4, K), dtype=c64, device=dev) for _ in range(2))
            whole_out, win_out = torch.empty_like(t_cur), torch.zeros_like(t_cur)
            per_width = []
            for share in (64, 8, 2):
                width = N // share
                r0 = (N - width) // 2
                rows = (r0, r0 + width)
                inner = slice(r0 + band, r0 + width - band)
                for t in (t_cur, t_prev):
                    t.zero_()
                    t[inner] = torch.randn(t[inner].shape, dtype=c64, device=dev, generator=gen)
                win_out.zero_()
                t_w, p_w = whole(data, where, t_cur, t_prev, inv, out=whole_out, impl="cuda")
                t_n, p_n = window(data, where, t_cur, t_prev, inv, rows, out=win_out, impl="cuda")
                torch.cuda.synchronize()
                as_bits = lambda t: torch.view_as_real(t).view(torch.int32)
                bit_equal = torch.equal(as_bits(t_n[rows[0]:rows[1]]), as_bits(t_w[rows[0]:rows[1]]))
                zero_outside = not bool((t_n[:rows[0]] != 0).any() or (t_n[rows[1]:] != 0).any()
                                        or (t_w[:rows[0]] != 0).any() or (t_w[rows[1]:] != 0).any())
                sums_w, sums_n = p_w.double().sum(dim=0), p_n.double().sum(dim=0)
                rel = float((sums_n - sums_w).abs().max() / sums_w.abs().max())
                whole_ms = timed_ms(lambda: whole(data, where, t_cur, t_prev, inv, out=whole_out, impl="cuda"), 20)
                window_ms = timed_ms(lambda: window(data, where, t_cur, t_prev, inv, rows, out=win_out, impl="cuda"),
                                     20)
                rec = {"phase": "window", "form": name, "shape": label, "N": N, "K": K, "band": band,
                       "rows": list(rows), "width": width, "bit_equal_on_window": bit_equal,
                       "zero_outside": zero_outside, "partials_rel": rel, "whole_ms": whole_ms,
                       "window_ms": window_ms, "us_per_1000_rows_whole": whole_ms * 1e6 / N,
                       "us_per_1000_rows_window": window_ms * 1e6 / width,
                       "window_over_whole_per_row": (window_ms / width) / (whole_ms / N)}
                emit(rec)
                per_width.append(rec)
                check(bit_equal and zero_outside and rel <= 1e-5,
                      f"{name} on rows {rows} differs from the whole-lattice step: {rec}")
            # Both forms on inputs random on every row, beside the sweep's inputs above (zero
            # outside the window): whether a row's cost depends on what it holds.
            rows = tuple(per_width[-1]["rows"])
            for t in (t_cur, t_prev):
                t.copy_(torch.randn(t.shape, dtype=c64, device=dev, generator=gen))
            dense = {"whole_ms": timed_ms(lambda: whole(data, where, t_cur, t_prev, inv, out=whole_out, impl="cuda"), 20),
                     "window_ms": timed_ms(lambda: window(data, where, t_cur, t_prev, inv, rows, out=win_out,
                                                          impl="cuda"), 20)}
            emit({"phase": "window", "form": name, "inputs": "random on every row", "rows": list(rows), **dense,
                  "us_per_1000_rows_whole": dense["whole_ms"] * 1e6 / N,
                  "us_per_1000_rows_window": dense["window_ms"] * 1e6 / (rows[1] - rows[0])})
            # The plain version beside the widest window, for the kernels' table.
            t_n, _ = window(data, where, t_cur, t_prev, inv, rows, out=win_out.zero_(), impl="cuda")
            want, _ = plain(data, where, t_cur, t_prev, inv, rows)
            err = float((t_n - want).abs().max())
            check(torch.allclose(t_n, want, atol=2e-4, rtol=2e-4), f"{name} differs from its plain version by {err}")
            plain_ms = timed_ms(lambda: plain(data, where, t_cur, t_prev, inv, rows), 3)
            width = rows[1] - rows[0]
            rows_out[name] = bound_row(name, f"{label}, rows {rows[0]}..{rows[1]}", sk, K,
                                       per_width[-1]["window_ms"], plain_ms,
                                       chebyshev_step_bytes(sk, K, 8) * width // N + extra_bytes * width // N,
                                       spmm_flops(sk, K) * width // N, err, None, "none", [per_width[-1]["window_ms"]])
            del t_cur, t_prev, whole_out, win_out, t_n, want
            torch.cuda.empty_cache()
        launched = launched_since(before)
        check(launched["ell_cheb_step_window"] > 0 and launched["ell_gather_cheb_step_window"] > 0,
              f"the window phase launched no light-cone step: {launched}")
        return launched, rows_out

    results = {}
    if "main" in phases:
        results["main"] = phase_main()
    if "widths" in phases:
        phase_widths()
    if "grad" in phases:
        phase_grad()
    if "gap" in phases:
        results["gap"] = phase_gap()
    if "dwave" in phases:
        phase_dwave()
    for name, phase in (("generic", phase_generic), ("tiled", phase_tiled), ("lowest", phase_lowest),
                        ("bf16", phase_bf16), ("sharded", phase_sharded), ("native", phase_native),
                        ("planar", phase_planar), ("examples", phase_examples), ("window", phase_window)):
        if name in phases:
            results[name] = phase()

    def write_log():
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
            with open(log_path, "w") as f:
                f.write("\n".join(_LOG) + "\n")

    if set(phases) != set(all_phases):
        write_log()
        return 0
    # ------------------------------------------------------------------ result
    # Each kernel with the numbers of the path it belongs to: the general
    # forward kernels at the KPM path's shape (N = 10⁶), the backward kernels at
    # the differentiable path's (N = 262144), the gather kernels at the generic
    # sheet's, the tiled step at N = 10⁶, the halo forms at the row-sharded
    # path's (the whole lattice as one slab: the world of one's form), the bf16
    # instantiations at those shapes on the bf16 form, the moment kernels at the
    # rashba 64×64×4 free energy's sweep; `launches` adds the eight paths' reads
    # (the planar calls' too).
    replaces = {
        "ell_spmm": "bodge_tpu/ops/pallas_spmm.py:440",  # also :985 (plane layout)
        "ell_cheb_step": "bodge_tpu/ops/pallas_spmm.py:468",  # also :1081 (plane layout)
        "ell_spmm_adjoint": "bodge_tpu/ops/pallas_spmm.py:1397",  # the VJP's vector cotangent
        "ell_block_outer": "bodge_tpu/ops/pallas_spmm.py:1397",  # the VJP's operator cotangent
        "ell_gather_spmm": "bodge_tpu/ops/pallas_gather.py:261",
        "ell_gather_cheb_step": "bodge_tpu/ops/pallas_gather.py:261",  # under the scan at :364
        "stencil_cheb_step_tiled": "bodge_tpu/ops/pallas_spmm.py:916",
        "ell_spmm_halo": "bodge_tpu/ops/pallas_spmm.py:1163",
        "ell_cheb_step_halo": "bodge_tpu/ops/pallas_spmm.py:1219",
        "ell_spmm_adjoint_halo": "bodge_tpu/ops/pallas_spmm.py:1449",  # the halo VJPs' vector cotangent (also :1430)
        "ell_block_outer_halo": "bodge_tpu/ops/pallas_spmm.py:1449",  # the halo VJPs' operator cotangent (also :1430)
        # The reference's filter scan over the fused step (pallas_spmm.py:468 / :1081), one launch a sweep here.
        "ell_cheb_filter": "bodge_tpu/ops/lanczos.py:122",
        "ell_cheb_filter_bf16": "bodge_tpu/ops/lanczos.py:122",
        # The reference's doubled-moment scan over the same fused step, one launch a sweep here.
        "ell_cheb_moments": "bodge_tpu/ops/pallas_spmm.py:1547",
        "ell_cheb_moments_bf16": "bodge_tpu/ops/pallas_spmm.py:1547",
        # The product under the reference's power-iteration scan (bodge_tpu/ops/chebyshev.py:134), one launch here.
        "ell_power_iteration": "bodge_tpu/ops/pallas_spmm.py:440",
        # The same fused steps on the rows an LDOS sweep's probes have reached (the reference steps all rows).
        "ell_cheb_step_window": "bodge_tpu/ops/pallas_spmm.py:468",
        "ell_gather_cheb_step_window": "bodge_tpu/ops/pallas_gather.py:261",
    }
    for name in ("ell_spmm", "ell_cheb_step", "ell_spmm_halo", "ell_cheb_step_halo", "ell_gather_spmm",
                 "ell_gather_cheb_step", "stencil_cheb_step_tiled"):
        replaces[name + "_bf16"] = replaces[name]  # the bf16 operator storage of the same Pallas kernel
    sources = dict.fromkeys(ck.KERNELS, "bodge_tpu_torch/csrc/ell_spmm.cu")
    sources["ell_block_outer"] = "bodge_tpu_torch/csrc/ell_block_outer.cu"
    sources["ell_gather_spmm"] = sources["ell_gather_cheb_step"] = "bodge_tpu_torch/csrc/ell_gather.cu"
    sources["ell_gather_cheb_step_window"] = "bodge_tpu_torch/csrc/ell_gather.cu"
    sources["stencil_cheb_step_tiled"] = "bodge_tpu_torch/csrc/stencil_tiled.cu"
    sources["ell_block_outer_halo"] = "bodge_tpu_torch/csrc/ell_block_outer.cu"
    sources["ell_gather_spmm_bf16"] = sources["ell_gather_cheb_step_bf16"] = "bodge_tpu_torch/csrc/ell_gather.cu"
    sources["stencil_cheb_step_tiled_bf16"] = "bodge_tpu_torch/csrc/stencil_tiled.cu"
    for name in ck.SWEEP_KERNELS:
        sources[name] = "bodge_tpu_torch/csrc/ell_filter.cu"
    paths = {"kpm_observables": "main", "solve_gap": "gap", "generic_lattice": "generic",
             "tiled_step": "tiled", "lowest_states": "lowest", "bf16_storage": "bf16", "row_sharded": "sharded",
             "planar_entry_points": "planar"}
    kernels = []
    for name in ck.KERNELS:
        row = next(results[p][1][name] for p in ("main", "gap", "generic", "tiled", "sharded", "bf16", "lowest",
                                                 "window") if name in results[p][1])
        by_path = {label: results[p][0][name] for label, p in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape": row["shape"], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **{key: row[key] for key in ("plan", "yardstick", "yardstick_ms", "order", "ms_per_step", "step_bound_ms",
                                         "share_of_step_bound", "library", "per_step_path_ms_per_step",
                                         "iteration_graph_ms") if key in row},
        })
        if name in ck.SWEEP_KERNELS:
            steps_by_path = {label: results[p][0][name + ".steps"] for label, p in paths.items()}
            kernels[-1].update(steps=sum(steps_by_path.values()), steps_by_path=steps_by_path)
        check(sum(by_path.values()) > 0, f"{name} was launched on none of the driven paths")
    print(smi, flush=True)
    emit({"kernels": kernels})
    write_log()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
