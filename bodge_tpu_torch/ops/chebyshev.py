"""Chebyshev / kernel-polynomial (KPM) spectral expansion.

The reference computes LDOS with a per-energy sparse-LU resolvent solve
(``bodge/hamiltonian.py:323-387``).  This module computes the same
observables through Chebyshev polynomial expansion driven by repeated
block-sparse SpMM — the classic KPM (Weiße et al., Rev. Mod. Phys. 78, 275
(2006)): a loop of fused Chebyshev-step launches, Jackson/Lorentz kernel
damping, and batched probe vectors.

Pieces:

- :func:`spectral_bound` — power-iteration estimate of ‖H‖₂ used to map
  the spectrum into [−1, 1].
- :func:`moments` — μ_m = ⟨v₀|T_m(H̃)|v₀⟩ for a batch of probe vectors
  (two moments per SpMM through the product identities).
- :func:`ldos_kpm` — local density of states from one site's four orbital
  probes.
- :func:`free_energy_kpm` — Landau free energy as ½ Tr G(H) with
  G(E) = −|E|/2 − T·log(1+e^(−|E|/T)), via Chebyshev fitting of G and
  (exact or stochastic Hutchinson) trace estimation.

Devices and precision.  ``data`` is a ``torch`` tensor; everything runs on
its device.  ``impl=None`` picks the hand-written kernels (complex64) for a
CUDA tensor and their plain versions for a CPU tensor — the general ELL
kernels on a stencil skeleton, the windowed gather kernels on a generic one
(``"cuda_gather"``), the tiled step under ``BODGE_PLANE_TILED=1``
(``"cuda_tiled"``); a ``"cuda*"`` name on a CPU tensor raises; ``"plain"``,
``"stencil"`` and ``"gather"`` stay forceable for cross-checks and keep the
tensor's own precision.  ``data`` may also be the planar form ``[2, N, S, 4,
4]`` float32 of :mod:`bodge_tpu_torch.ops.planar`, as in the reference: each
entry point turns it into complex64 once and runs the complex path on it
(:func:`default_impl` is ``"planar"`` under ``BODGE_PLANAR=1``; ``"planar"``
and ``"auto"`` mean ``None`` for the step).  ``operator_dtype="bf16"`` (or
``BODGE_OPERATOR_STORAGE=bf16``, read where the argument is ``None``) stores
the operator in the bf16 form for the moment sweep — half the operator's
bytes; vectors and sums stay in the vectors' precision — as the reference's
Pallas paths do; :func:`spectral_bound` stays on the complex operator, its
5 % margin covering the ≤ 2⁻⁹·‖H‖ by which the rounding can move the
spectrum.  Any probe
count K goes through one launch per step.  Probes are drawn with NumPy from
an integer ``seed``.  The moments come off the device once; the
reconstruction (damping kernels, Chebyshev series, coefficient fits) is tiny
host mathematics in float64 whatever the operator's dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common import numpy_dtype
from .blocksparse import BLOCK, Skeleton
from .cuda_spmm import (StepPlan, bf16_operator, moments_fused, operator_values, power_mode, power_recursion,
                        resolve_operator_storage)
from .planar import complex_operator
from .spmm import spmm

DEFAULT_ORDER = 512


def default_impl() -> str:
    """The implementation ``impl=None`` stands for in the KPM entry points:
    ``"planar"`` under :func:`~bodge_tpu_torch.hamiltonian.use_planar_device_path`
    (``BODGE_PLANAR=1``: the operator crosses the planar boundary and the
    sweep runs the complex kernels on its complex form), else ``"auto"``: the
    step :func:`~bodge_tpu_torch.ops.cuda_spmm.resolve_path` chooses from the
    tensor's device and the skeleton."""
    from ..hamiltonian import use_planar_device_path

    return "planar" if use_planar_device_path() else "auto"


def _resolve_impl(impl):
    return default_impl() if impl in (None, "auto") else impl


def _operator_and_impl(data, impl):
    """``(operator, impl)`` as the sweeps take them: a planar operator in its
    complex form, and ``"auto"`` / ``"planar"`` as ``None``."""
    impl = _resolve_impl(impl)
    return complex_operator(data), (None if impl in ("auto", "planar") else impl)


def _as_tensor(v, like):
    """``v`` (NumPy or tensor) as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(v).to(device=like.device, dtype=like.dtype)


def spectral_bound(
    data,
    sk: Skeleton,
    iters: int = 60,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    impl: Optional[str] = None,
) -> float:
    """Estimate ‖H‖₂ by power iteration on the Hermitian operator.

    The Rayleigh-quotient estimate never overshoots λ_max but can sit
    slightly below it when the top of the spectrum clusters; the returned
    bound is inflated by 5% (standard KPM practice) so spec(H/a) ⊂ (−1, 1)
    robustly — Chebyshev recursions diverge exponentially if any
    eigenvalue escapes the interval.

    The start vector is complex normal, drawn with NumPy from ``seed`` or
    with ``torch.randn`` from ``generator`` when one is given.  On the general
    step on the card where :func:`~bodge_tpu_torch.ops.cuda_filter.power_plan`
    fits (:func:`~bodge_tpu_torch.ops.cuda_spmm.power_mode`), the ``iters``
    iterations are one launch of
    :func:`~bodge_tpu_torch.ops.cuda_filter.ell_power_iteration`; elsewhere
    (the gather and tiled steps, lattices too large for a plan, the plain
    versions) a loop of one product a step with no host synchronisation
    inside.
    """
    data, impl = _operator_and_impl(data, impl)
    shape = (sk.n_sites, BLOCK, 1)
    if generator is not None:
        v = torch.randn(shape, dtype=torch.complex128, generator=generator,
                        device=generator.device)
    else:
        rng = np.random.default_rng(seed)
        v = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    v = _as_tensor(v, data)
    if impl in ("stencil", "gather"):
        product = lambda w: spmm(data, sk, w, impl=impl)
    else:  # cast (and, on a generic skeleton, relabel) once, not in every iteration
        plan = StepPlan(sk, 1, impl, data)
        data, v = plan.operator(data), plan.enter(v)
        if power_mode(plan, data, iters) in ("registers", "global"):
            from .cuda_filter import ell_power_iteration

            return float(ell_power_iteration(data, plan.sk, v, iters, impl="cuda")) * 1.05
        product = lambda w: plan.spmm(data, w)
    return float(power_recursion(product, v, iters)) * 1.05


def rademacher_probes(N, samples, seed, dtype, default_seed=42) -> np.ndarray:
    """Deterministic host-side Rademacher probes ``[N, 4, samples]``.

    Built in NumPy from an integer ``seed`` (``None`` → ``default_seed``)
    so identical seeds give identical estimates on every device.
    """
    rng = np.random.default_rng(default_seed if seed is None else int(seed))
    z = 2.0 * rng.integers(0, 2, size=(N, BLOCK, samples)) - 1.0
    return z.astype(dtype)


def _doubled_moment_scan(H, inner, v0, order: int):
    """Shared moment recursion with the product doubling trick.

    One SpMM yields TWO moments via the Chebyshev product identities
    T_{2m} = 2·T_m² − 1 and T_{2m+1} = 2·T_{m+1}·T_m − T_1:

        μ_{2m}   = 2⟨t_m, t_m⟩     − μ_0
        μ_{2m+1} = 2⟨t_{m+1}, t_m⟩ − μ_1

    halving the SpMM count versus the plain three-term recursion (Weiße et
    al. RMP 78, 275, Sec. II-D).  ``inner`` must be the *real* inner
    product.  The inner products stay on the device and are stacked at the
    end.
    """
    t0 = v0
    t1 = H(v0)
    mu0 = inner(v0, t0)
    mu1 = inner(v0, t1)

    steps = max(0, (order - 2 + 1) // 2)  # ceil((order-2)/2)
    if steps == 0:
        return torch.stack([mu0, mu1])[:order]

    t_prev, t_cur = t0, t1
    rest = []
    for _ in range(steps):
        t_next = 2.0 * H(t_cur) - t_prev
        rest.append(2.0 * inner(t_cur, t_cur) - mu0)  # μ_{2m}
        rest.append(2.0 * inner(t_next, t_cur) - mu1)  # μ_{2m+1}
        t_prev, t_cur = t_cur, t_next
    return torch.stack([mu0, mu1, *rest])[:order]


def _moments_scan(data, sk: Skeleton, v0, inv_scale: float, order: int, impl: str):
    """μ_m[k] = Re ⟨v0_k | T_m(H̃) | v0_k⟩ through separate SpMM and inner products."""

    def H(v):
        return spmm(data, sk, v, impl=impl) * inv_scale

    def inner(a, b):
        return (a.conj() * b).sum(dim=(0, 1)).real

    return _doubled_moment_scan(H, inner, v0, order)  # [order, K]


# Identity trace probes materialize a (4N)² dense array; past this many
# orbitals that silently becomes a multi-GB allocation, so demand an
# explicit stochastic estimator instead.
MAX_EXACT_TRACE_ORBITALS = 8192


def _identity_probes(N: int, dtype, what: str) -> np.ndarray:
    if N * BLOCK > MAX_EXACT_TRACE_ORBITALS:
        raise ValueError(
            f"samples=None requests exact-trace probes: a {4 * N}×{4 * N} "
            f"identity (> {MAX_EXACT_TRACE_ORBITALS} orbitals). Pass "
            f"samples=<int> for a stochastic {what} on systems this large."
        )
    return np.eye(N * BLOCK, dtype=dtype).reshape(N, BLOCK, N * BLOCK)


def moments(data, sk: Skeleton, v0, order: int, scale: float, impl: Optional[str] = None,
            operator_dtype=None):
    """Chebyshev moments of H/scale against probe vectors ``v0: [N, 4, K]``.

    Returns a real ``[order, K]`` tensor on ``data``'s device.  ``v0`` may be
    a NumPy array or a tensor; it is moved to the operator's device.

    ``impl``: ``None`` → the kernels on a CUDA tensor, their plain versions
    on a CPU tensor; on a generic skeleton with a feasible window plan the
    gather step, else the general ELL step
    (:func:`~bodge_tpu_torch.ops.cuda_spmm.resolve_path`).  A name of
    :data:`~bodge_tpu_torch.ops.cuda_spmm.PATHS` (``"cuda"``,
    ``"cuda_gather"``, ``"cuda_tiled"``, ``"plain"``, …) asks for that step
    and raises where it cannot run.  All of these run the fused-step
    recursion (:func:`~bodge_tpu_torch.ops.cuda_spmm.moments_fused`).
    ``"stencil"`` / ``"gather"`` run separate SpMMs and inner products in
    plain PyTorch.

    ``operator_dtype``: the operator's storage (``"f32"`` / ``"bf16"``;
    ``None`` reads ``BODGE_OPERATOR_STORAGE``,
    :func:`~bodge_tpu_torch.ops.cuda_spmm.resolve_operator_storage`).  With
    bf16 the sweep runs on the bf16 form — the kernels' bf16 instantiations
    on the card, the plain versions on its exact upcast on the CPU; the
    ``"stencil"`` / ``"gather"`` scans multiply with the same rounded blocks.
    """
    data, impl = _operator_and_impl(data, impl)
    v0 = _as_tensor(v0, data)
    inv = 1.0 / float(scale)
    storage = resolve_operator_storage(operator_dtype)
    if impl in ("stencil", "gather"):
        if storage is not None:
            data = operator_values(bf16_operator(data), data.dtype)
        return _moments_scan(data, sk, v0, inv, order, impl)
    return moments_fused(data, sk, v0, inv, order, impl=impl, operator_dtype=storage)


def _host_moments(mu) -> np.ndarray:
    """The moments as float64 on the host (the one transfer of a sweep)."""
    return mu.detach().to("cpu", torch.float64).numpy()


def jackson_kernel(order: int) -> np.ndarray:
    """Jackson damping coefficients g_m (positivity-preserving)."""
    m = np.arange(order)
    M = order + 1
    return (
        (M - m) * np.cos(np.pi * m / M) + np.sin(np.pi * m / M) / np.tan(np.pi / M)
    ) / M


def lorentz_kernel(order: int, lam: float = 4.0) -> np.ndarray:
    """Lorentz damping coefficients (resolvent-like broadening)."""
    m = np.arange(order)
    return np.sinh(lam * (1 - m / order)) / np.sinh(lam)


_KERNELS = {"jackson": jackson_kernel, "lorentz": lorentz_kernel, "none": lambda M: np.ones(M)}


def reconstruct_density(mu, energies_scaled, scale: float, kernel: str = "jackson") -> np.ndarray:
    """KPM density reconstruction ρ(ε) from damped moments (host, float64).

    Args:
        mu: ``[order, K]`` moments (tensor or array).
        energies_scaled: x = ε/scale in (−1, 1), shape ``[M]``.
        scale: the Chebyshev scale `a` (restores 1/a measure factor).
        kernel: damping kernel name.

    Returns:
        ``[M, K]`` densities.
    """
    mu = _host_moments(mu) if isinstance(mu, torch.Tensor) else np.asarray(mu, dtype=np.float64)
    order = mu.shape[0]
    g = _KERNELS[kernel](order)
    x = np.asarray(energies_scaled, dtype=np.float64)
    m = np.arange(order)
    # T_m(x) = cos(m·arccos x), evaluated for all orders at once.
    Tmx = np.cos(m[None, :] * np.arccos(x)[:, None])  # [M, order]
    weights = np.where(m == 0, 1.0, 2.0) * g
    series = Tmx @ (weights[:, None] * mu)  # [M, K]
    return series / (np.pi * scale * np.sqrt(1.0 - x[:, None] ** 2))


LORENTZ_LAMBDA = 4.0


def ldos_site_probes(N: int, site_indices, dtype) -> np.ndarray:
    """One-hot orbital probes for LDOS: ``[N, 4, 4·n_sites]`` with a unit
    column per (site, orbital)."""
    site_indices = np.asarray(site_indices, dtype=np.int64)
    n_sites = len(site_indices)
    K = BLOCK * n_sites
    v0 = np.zeros((N, BLOCK, K), dtype=dtype)
    cols = np.arange(K)
    v0[np.repeat(site_indices, BLOCK), np.tile(np.arange(BLOCK), n_sites), cols] = 1.0
    return v0


def ldos_from_moments(mu, energies, scale: float, kernel: str, n_sites: int) -> np.ndarray:
    """Electron-component LDOS ``[n_sites, n_energies]`` from the moments of
    :func:`ldos_site_probes` probes (shared reconstruction tail)."""
    energies = np.array(energies, dtype=float)
    x = np.clip(energies / scale, -0.999999, 0.999999)
    dens = reconstruct_density(mu, x, scale, kernel=kernel)
    dens = dens.reshape(len(energies), n_sites, BLOCK)
    return (dens[:, :, 0] + dens[:, :, 1]).T  # electron ↑+↓ per site


def _kpm_setup(data, sk, order, kernel, scale, eta, impl):
    """Shared resolution of ``scale`` / ``eta`` / ``order`` / ``kernel``."""
    if scale is None:
        scale = spectral_bound(data, sk, impl=impl)
    if eta is not None:
        kernel = "lorentz"
        if order is None:
            order = max(8, int(np.ceil(LORENTZ_LAMBDA * scale / eta)))
    return order or DEFAULT_ORDER, kernel, scale


def ldos_kpm(
    data,
    sk: Skeleton,
    site_index: int,
    energies,
    order: Optional[int] = None,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    eta: Optional[float] = None,
    impl: Optional[str] = None,
    operator_dtype=None,
) -> np.ndarray:
    """Local density of states at one site via KPM.

    Probes the four orbitals {e↑, e↓, h↑, h↓} of ``site_index`` with unit
    vectors and sums the electron components; by particle-hole symmetry
    this matches the reference's ± convention (``bodge/hamiltonian.py:
    377-382``) for any signed probe energy.

    Passing ``eta`` requests a target Lorentzian broadening: the Lorentz
    kernel is selected and the expansion order is chosen as λ·a/η, which
    reproduces the resolvent at ε+iη — the direct analog of the
    reference's broadened sparse solve.
    """
    return ldos_kpm_sites(
        data, sk, [site_index], energies, order=order, kernel=kernel,
        scale=scale, eta=eta, impl=impl, operator_dtype=operator_dtype,
    )[0]


def ldos_kpm_sites(
    data,
    sk: Skeleton,
    site_indices,
    energies,
    order: Optional[int] = None,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    eta: Optional[float] = None,
    impl: Optional[str] = None,
    operator_dtype=None,
) -> np.ndarray:
    """Batched KPM LDOS for many sites in one moment sweep.

    All 4·n_sites orbital probes ride a single Chebyshev scan as extra SpMM
    columns, so an LDOS *map* costs barely more than one site.
    Returns ``[n_sites, n_energies]`` (electron component, as in
    :func:`ldos_kpm`).
    """
    data, impl = _operator_and_impl(data, impl)
    order, kernel, scale = _kpm_setup(data, sk, order, kernel, scale, eta, impl)
    site_indices = np.asarray(site_indices, dtype=np.int64)
    v0 = ldos_site_probes(sk.n_sites, site_indices, numpy_dtype(data.dtype))
    mu = moments(data, sk, v0, order, scale, impl=impl, operator_dtype=operator_dtype)  # [order, 4·n_sites]
    return ldos_from_moments(mu, energies, scale, kernel, len(site_indices))


def dos_kpm(
    data,
    sk: Skeleton,
    energies,
    order: Optional[int] = None,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    eta: Optional[float] = None,
    samples: Optional[int] = 16,
    seed: Optional[int] = None,
    impl: Optional[str] = None,
    operator_dtype=None,
) -> np.ndarray:
    """Total density of states Tr δ(ε−H) via KPM.

    The global analog of :func:`ldos_kpm`.  With ``samples=None`` the trace
    probes are the full identity (exact, small systems only); otherwise
    ``samples`` Rademacher vectors give an unbiased stochastic estimate.
    Counts all 4N Nambu⊗Spin orbitals (particle-hole symmetric around ε = 0).
    """
    data, impl = _operator_and_impl(data, impl)
    order, kernel, scale = _kpm_setup(data, sk, order, kernel, scale, eta, impl)
    N = sk.n_sites
    dtype = numpy_dtype(data.dtype)
    if samples is None:
        v0 = _identity_probes(N, dtype, "DOS")
        norm = 1.0
    else:
        v0 = rademacher_probes(N, samples, seed, dtype, default_seed=1)
        norm = 1.0 / samples

    mu = moments(data, sk, v0, order, scale, impl=impl, operator_dtype=operator_dtype)  # [order, K]
    mu_tr = _host_moments(mu.sum(dim=1)) * norm  # trace estimate per order

    energies = np.array(energies, dtype=float)
    x = np.clip(energies / scale, -0.999999, 0.999999)
    return reconstruct_density(mu_tr[:, None], x, scale, kernel=kernel)[:, 0]


def chebyshev_coefficients(fn, order: int, quad_points: Optional[int] = None) -> np.ndarray:
    """Chebyshev-series coefficients of ``fn`` on [−1, 1] via Gauss quadrature."""
    Q = quad_points or max(2 * order, 256)
    theta = np.pi * (np.arange(Q) + 0.5) / Q
    fx = fn(np.cos(theta))
    m = np.arange(order)
    c = 2.0 / Q * np.cos(np.outer(m, theta)) @ fx
    c[0] /= 2.0
    return c


def trace_function(
    data,
    sk: Skeleton,
    fn,
    order: int,
    scale: float,
    samples: Optional[int] = None,
    seed: Optional[int] = None,
    kernel: str = "jackson",
    impl: Optional[str] = None,
    operator_dtype=None,
) -> float:
    """Tr fn(H) by Chebyshev expansion.

    With ``samples=None`` the trace is exact: probes are the full identity,
    batched as K = 4N columns (refused above
    :data:`MAX_EXACT_TRACE_ORBITALS` orbitals — O((4N)²) memory).
    Otherwise a Hutchinson estimator with ``samples`` Rademacher vectors is
    used — unbiased, with O(1/√samples) stochastic error.
    """
    data, impl = _operator_and_impl(data, impl)
    coeffs = chebyshev_coefficients(lambda x: fn(scale * x), order)
    coeffs = coeffs * _KERNELS[kernel](order)
    N = sk.n_sites

    dtype = numpy_dtype(data.dtype)
    if samples is None:
        probes = _identity_probes(N, dtype, "trace")
        norm = 1.0
    else:
        probes = rademacher_probes(N, samples, seed, dtype)
        norm = 1.0 / samples

    mu = moments(data, sk, probes, order, scale, impl=impl, operator_dtype=operator_dtype)  # [order, K]
    mu_tr = _host_moments(mu.sum(dim=1))
    return float(np.dot(coeffs[: mu_tr.shape[0]], mu_tr)) * norm


def free_energy_kpm(
    data,
    sk: Skeleton,
    temperature: float = 0.0,
    order: int = DEFAULT_ORDER,
    samples: Optional[int] = None,
    seed: Optional[int] = None,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
    operator_dtype=None,
) -> float:
    """Landau free energy F = U − T·S without diagonalization.

    Uses F = ½ Tr G(H) with G(E) = −|E|/2 − T·log(1+e^(−|E|/T)): summing
    G over the positive spectrum (the reference formula,
    ``bodge/hamiltonian.py:305-319``) equals half the trace over the full
    particle-hole-symmetric spectrum.  Scales as O(order · nnz) — the
    large-lattice path where dense eigh is infeasible.
    """
    T = float(temperature)
    if T < 0:
        raise ValueError("Expected non-negative temperature!")
    data, impl = _operator_and_impl(data, impl)
    if scale is None:
        scale = spectral_bound(data, sk, impl=impl)

    if T == 0:
        g = lambda E: -np.abs(E) / 2
    else:
        g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))

    tr = trace_function(data, sk, g, order, scale, samples=samples, seed=seed, impl=impl,
                        operator_dtype=operator_dtype)
    return 0.5 * tr
