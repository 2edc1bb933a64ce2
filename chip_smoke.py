#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``bodge_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``bodge_tpu_torch/csrc`` into ``build/``,
holds each kernel against its plain PyTorch version on the card, drives the
KPM main path (assemble → block SpMM → fused Chebyshev step → free energy /
LDOS / LDOS map / DOS / apply) through the normal entry points at full size,
checks it against the complex128 plain path at a small size, and exits
non-zero if any phase fails.  Every line of output is one JSON object except
the ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it fails at once.  ``--quick`` stops after the small
kernel checks (for a first look at a new kernel) and prints no result line;
``--log PATH`` also writes the JSON records of a full run to ``PATH``.

Phases: device, build, kernels (small awkward shapes), main path at full
size (launch counters read here), kernels at the main path's shapes (times,
bounds, library yardstick), main path checked against complex128.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores

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


def main(argv) -> int:
    quick = "--quick" in argv
    log_path = argv[argv.index("--log") + 1] if "--log" in argv else None
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from bodge_tpu_torch import CubicLattice, Hamiltonian, jσ2, σ0, σ2, σ3
    from bodge_tpu_torch.models.systems import rashba_dp_wave, swave_superconductor
    from bodge_tpu_torch.ops import _build
    from bodge_tpu_torch.ops import blocksparse as bs
    from bodge_tpu_torch.ops import chebyshev as kpm
    from bodge_tpu_torch.ops import cuda_spmm as ck
    from bodge_tpu_torch.ops.spmm import chebyshev_step_bytes, spmm_bytes, spmm_flops

    dev = torch.device("cuda")
    c64, c128 = torch.complex64, torch.complex128

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

    # ------------------------------------------------------------------ 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    n_copy = 1 << 30  # 1 GiB each way: far beyond the L2 cache
    src = torch.empty(n_copy, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = timed_ms(lambda: dst.copy_(src), 10)
    copy_bytes_per_s = 2 * n_copy / (copy_ms * 1e-3)  # each byte read once and written once
    del src, dst
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "copy_GBps_measured": copy_bytes_per_s / 1e9, "datasheet_GBps": HBM_BYTES_PER_S / 1e9,
    })

    # ------------------------------------------------------------------ 2. build
    built = _build.build_all(verbose=True)
    ptxas = [l for log in built["log"].values() for l in log.splitlines()
             if "registers" in l or "spill" in l]
    emit({"phase": "build", "seconds": built["seconds"], "sources": built["built"],
          "nvcc": _build.find_nvcc(), "ptxas": ptxas})

    # ------------------------------------------------------------------ 3a. kernels, small shapes
    def random_system(shape, seed):
        """Random Hermitian 2x2 spin blocks on every slot, periodic wrap blocks included."""
        system = Hamiltonian(CubicLattice(shape), dtype=np.complex64, device=dev)
        rng = np.random.default_rng(seed)
        σ1 = np.array([[0, 1], [1, 0]])

        def herm2(n):
            c = rng.normal(size=(4, n, 1, 1))
            return c[0] * σ0 + c[1] * σ1 + c[2] * σ2 + c[3] * σ3

        system.assemble(
            onsite=lambda ci: herm2(len(ci)),
            pairing_onsite=lambda ci: herm2(len(ci)) @ jσ2,
            hopping=lambda ci, cj: herm2(len(ci)),
            pairing=lambda ci, cj: herm2(len(ci)),
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
    def compare(data, sk, K, seed):
        N = sk.n_sites
        t_cur, t_prev = random_vector(N, K, seed), random_vector(N, K, seed + 1)
        inv = 0.125
        y = ck.ell_spmm(data, sk, t_cur)
        torch.cuda.synchronize()
        y_ref = ck.ell_spmm_plain(data, sk, t_cur)
        t_next, pp = ck.ell_cheb_step(data, sk, t_cur, t_prev, inv)
        torch.cuda.synchronize()
        n_ref, _ = ck.ell_cheb_step_plain(data, sk, t_cur, t_prev, inv)
        _, pp_ref = ck.ell_cheb_step_plain(data.to(c128), sk, t_cur.to(c128), t_prev.to(c128), inv)
        first, pp0 = ck.ell_cheb_step(data, sk, t_cur, None, inv)  # t_prev = 0
        again, pp_again = ck.ell_cheb_step(data, sk, t_cur, t_prev.clone(), inv)
        alias_buf = t_prev.clone()
        aliased, pp_alias = ck.ell_cheb_step(data, sk, t_cur, alias_buf, inv, out=alias_buf)
        torch.cuda.synchronize()
        first_ref, _ = ck.ell_cheb_step_plain(data, sk, t_cur, None, inv)
        sums, sums_ref = pp.double().sum(dim=0), pp_ref[0]
        ok = (
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
        }

    ck.reset_launch_counts()
    shapes = [(6, 5, 1), (4, 7, 1), (4, 4, 3), (3, 1, 5), (5, 6, 4), (16, 1, 1), (2, 6, 1)]
    probe_counts = [1, 3, 4, 8, 33]
    small_err = {"ell_spmm": 0.0, "ell_cheb_step": 0.0, "partials_rel": 0.0}
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
            worst = {k: max(worst[k], err[k]) for k in worst}
            check(ok, f"kernel disagrees with its plain version on {name}, K={K}: {err}")
        small_err = {k: max(small_err[k], worst[k]) for k in worst}
        emit({"phase": "kernels", "shape": name, "S": sk.n_slots, "K": probe_counts,
              "padding_slots": bool((sk.cols < 0).any()), "max_abs_err": worst})
    emit({"phase": "kernels", "held": list(ck.KERNELS), "small_shapes": len(cases),
          "tolerance": {"y_t_next": "atol=rtol=2e-4 vs complex64 plain",
                        "partials": "1e-4 of the largest sum vs complex128 plain"},
          "max_abs_err": small_err, "launches": ck.launch_counts()})
    if quick:
        return 0

    # ------------------------------------------------------------------ 4. main path, full size
    energies = np.linspace(-1.0, 1.0, 41)
    expected = {"ell_spmm": 0, "ell_cheb_step": 0}

    def call(label, fn, order, K, sk, bound_iters=0):
        """Run one entry point, synchronised; account for the launches it must make."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = ck.sweep_launches(order) if order else 0
        expected["ell_cheb_step"] += steps
        expected["ell_spmm"] += bound_iters
        rec = {"phase": "main", "call": label, "wall_s": wall, "cheb_launches": steps,
               "spmm_launches": bound_iters}
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

    ITERS = 60  # spectral_bound's power iterations, one ell_spmm each
    scale_big = call("spectral_bound", lambda: kpm.spectral_bound(big.data, sk_big), 0, 1, sk_big, ITERS)
    F_cold = call("free_energy(T=0.01, kpm, order=256, samples=8)",
                  lambda: big.free_energy(0.01, method="kpm", order=256, samples=8), 256, 8, sk_big, ITERS)
    F_warm = call("free_energy(T=0.5, kpm, order=256, samples=8)",
                  lambda: big.free_energy(0.5, method="kpm", order=256, samples=8, scale=scale_big),
                  256, 8, sk_big)
    rho = call("ldos((500,500,0), order=512)",
               lambda: big.ldos((500, 500, 0), energies, method="kpm", order=512, scale=scale_big),
               512, 4, sk_big)
    sites = [(100 + 50 * i, 100 + 50 * j, 0) for i in range(4) for j in range(4)]
    rho_map = call("ldos_map(16 sites, order=512)",
                   lambda: big.ldos_map(sites, energies, method="kpm", order=512, scale=scale_big),
                   512, 64, sk_big)
    dos = call("dos(order=256, samples=8)",
               lambda: big.dos(energies, order=256, samples=8, scale=scale_big), 256, 8, sk_big)
    v_big = random_vector(sk_big.n_sites, 8, 7)
    y_big = call("apply(K=8)", lambda: big.apply(v_big), 0, 8, sk_big, 1)

    t0 = time.perf_counter()
    rashba = rashba_dp_wave((64, 64, 4))
    torch.cuda.synchronize()
    sk_r = rashba.skeleton
    emit({"phase": "main", "call": "rashba_dp_wave((64,64,4))", "wall_s": time.perf_counter() - t0,
          "N": sk_r.n_sites, "S": sk_r.n_slots, "hermiticity_error": rashba._hermiticity_error()})
    F_r = call("rashba free_energy(T=0.01, kpm, order=256, samples=8)",
               lambda: rashba.free_energy(0.01, method="kpm", order=256, samples=8), 256, 8, sk_r, ITERS)
    rho_r = call("rashba ldos((32,32,2), order=512)",
                 lambda: rashba.ldos((32, 32, 2), energies, method="kpm", order=512), 512, 4, sk_r, ITERS)

    main_launches = ck.launch_counts()  # read right after the main path
    peak_GB = torch.cuda.max_memory_allocated() / 1e9

    mid = len(energies) // 2
    outside = np.abs(energies) >= 0.5  # beyond the s-wave gap Δ = 0.3
    check(main_launches == expected, f"launch counters {main_launches} != expected {expected}")
    check(all(v > 0 for v in main_launches.values()), "a kernel of the main path was never launched")
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
    emit({"phase": "main", "launches": main_launches, "expected": expected, "scale": scale_big,
          "F(T=0.01)": F_cold, "F(T=0.5)": F_warm, "F_per_site": F_cold / sk_big.n_sites,
          "rho(0)": float(rho[mid]), "rho(|e|>=0.5) mean": float(rho[outside].mean()),
          "rashba_F": F_r, "peak_device_GB": peak_GB})

    # ------------------------------------------------------------------ 3b. kernels, main path's shapes
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
            check(torch.allclose(lib_y, ck.ell_spmm(data, sk, t_cur), atol=2e-4, rtol=2e-4),
                  "library product disagrees with the kernel")
        # plain, kernel, kernel, plain: both versions in turns on the one card
        spmm_plain_a = timed_ms(lambda: ck.ell_spmm_plain(data, sk, t_cur), 5)
        spmm_a = timed_ms(lambda: ck.ell_spmm(data, sk, t_cur), reps)
        cheb_a = timed_ms(lambda: ck.ell_cheb_step(data, sk, t_cur, t_prev, 0.125, out=out), reps)
        cheb_plain_a = timed_ms(lambda: ck.ell_cheb_step_plain(data, sk, t_cur, t_prev, 0.125), 5)
        lib_ms = timed_ms(lib_fn, 5) if lib_fn is not None else None
        cheb_b = timed_ms(lambda: ck.ell_cheb_step(data, sk, t_cur, t_prev, 0.125, out=out), reps)
        spmm_b = timed_ms(lambda: ck.ell_spmm(data, sk, t_cur), reps)
        spmm_plain_b = timed_ms(lambda: ck.ell_spmm_plain(data, sk, t_cur), 5)
        del lib_fn, lib_y
        flops = spmm_flops(sk, K)
        for name, ms, plain_ms, nbytes, library in (
            ("ell_spmm", min(spmm_a, spmm_b), min(spmm_plain_a, spmm_plain_b), spmm_bytes(sk, K, 8), lib_ms),
            ("ell_cheb_step", min(cheb_a, cheb_b), cheb_plain_a, chebyshev_step_bytes(sk, K, 8), None),
        ):
            by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
            row = {
                "phase": "kernels", "shape": label, "N": N, "S": sk.n_slots, "K": K, "name": name,
                "max_abs_err": err[name], "partials_rel_err": err["partials_rel"], "ms": ms,
                "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
                "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "bound_ms_measured_copy": nbytes / copy_bytes_per_s * 1e3,
                "achieved_GBps": nbytes / ms / 1e6, "library_ms": library,
                "library": (f"torch.sparse {lib_layout} @ dense" if library is not None else
                            ("none: " + "; ".join(lib_errors) if name == "ell_spmm" else "none")),
                "runs_ms": [spmm_a, spmm_b] if name == "ell_spmm" else [cheb_a, cheb_b],
            }
            emit(row)
            kernel_rows.setdefault(name, row)  # the first shape is the main path's own

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
        mu = {impl: kpm.moments(system.data, sk, probes, 64, scale, impl=impl).double().cpu().numpy()
              for impl in ("cuda", "plain")}
        F = {impl: system.free_energy(0.01, method="kpm", order=128, samples=8, scale=scale, impl=impl)
             for impl in ("cuda", "plain")}
        site = tuple(s // 2 for s in sk.shape)
        ld = {impl: system.ldos(site, energies, method="kpm", order=128, scale=scale, impl=impl)
              for impl in ("cuda", "plain")}
        errs = {
            "moments_rel_to_max": float(np.abs(mu["cuda"] - mu["plain"]).max() / np.abs(mu["plain"]).max()),
            "free_energy_rel": abs(F["cuda"] - F["plain"]) / abs(F["plain"]),
            "ldos_rel_to_max": float(np.abs(ld["cuda"] - ld["plain"]).max() / np.abs(ld["plain"]).max()),
        }
        emit({"phase": "checked", "system": label, "scale": scale, "F_cuda": F["cuda"], "F_plain": F["plain"], **errs})
        check(errs["moments_rel_to_max"] <= 2e-4, f"{label}: moments off by {errs['moments_rel_to_max']}")
        check(errs["free_energy_rel"] <= 1e-4, f"{label}: free energy off by {errs['free_energy_rel']}")
        check(errs["ldos_rel_to_max"] <= 1e-3, f"{label}: LDOS off by {errs['ldos_rel_to_max']}")

    # ------------------------------------------------------------------ result
    replaces = {
        "ell_spmm": "bodge_tpu/ops/pallas_spmm.py:440",  # also :985 (plane layout)
        "ell_cheb_step": "bodge_tpu/ops/pallas_spmm.py:468",  # also :1081 (plane layout)
    }
    kernels = [{
        "name": name, "route": "cuda", "source": "bodge_tpu_torch/csrc/ell_spmm.cu",
        "replaces": replaces[name], "launches": main_launches[name],
        "max_abs_err": kernel_rows[name]["max_abs_err"], "ms": kernel_rows[name]["ms"],
        "plain_ms": kernel_rows[name]["plain_ms"], "bound_ms": kernel_rows[name]["bound_ms"],
        "bound_by": kernel_rows[name]["bound_by"], "library_ms": kernel_rows[name]["library_ms"],
    } for name in ck.KERNELS]
    print(smi, flush=True)
    emit({"kernels": kernels})
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        with open(log_path, "w") as f:
            f.write("\n".join(_LOG) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
