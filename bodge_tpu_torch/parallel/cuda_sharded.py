"""Row-sharded KPM sweeps driven by the fused halo step.

Counterpart of ``bodge_tpu/parallel/pallas_sharded.py``: every rank runs
:func:`~bodge_tpu_torch.ops.cuda_spmm.ell_cheb_step_halo` on its x-slab, the
one plane of operand needed from each neighbour comes round the ring
(:meth:`~bodge_tpu_torch.parallel.sharded.RowSharding.exchange`), and the
kernel's fused per-block moment partials are summed over the ranks once per
sweep.  There is no packing pass: the slabs are rows of the natural tensors.

Entry points and the reference functions they stand for:

- :func:`spmm_sharded_cuda` — ``spmm_sharded_pallas`` (P6: ``ell_spmm_halo``);
- :func:`moments_sharded_cuda` — ``moments_sharded_pallas``, rows only and
  rows × probes (P7: ``ell_cheb_step_halo``);
- :func:`chebyshev_scan_sharded` — ``chebyshev_scan_sharded``;
- :func:`free_energy_kpm_sharded_cuda` — ``free_energy_kpm_sharded_pallas``;
- :func:`ldos_kpm_sharded_cuda` — ``ldos_kpm_sharded_pallas``;
- :func:`dos_kpm_sharded_cuda` — ``dos_kpm_sharded_pallas``;
- :func:`moments_sharded_ad` — the differentiable sweep of the reference's
  ``_moments_pallas_sharded_jit`` under ``jax.grad``
  (:class:`~bodge_tpu_torch.ops.cuda_spmm.ShardedMomentSweep`), for the
  row-sharded gap objective.

``impl`` is ``None`` (the kernels for CUDA tensors, their plain versions for
CPU tensors), ``"cuda"`` or ``"plain"``.  Inputs are the whole lattice's
(every rank takes its slab) or this rank's slabs.

The interior/boundary overlap split (``overlap=True`` or
``BODGE_HALO_OVERLAP=1``): each step begins the exchange, launches the slab's
interior planes ``[1, Lxl−1)``, which read no halo, ends the exchange and
launches the two boundary planes — three launches a step, the interior one
running while the planes travel.  Slabs thinner than three planes use one
launch.  ``remat=`` is accepted for the reference's signature; the sweep
keeps every vector for its backward pass, as
:class:`~bodge_tpu_torch.ops.cuda_spmm.MomentSweep` does (√steps
checkpointing is an open knob in ``ROADMAP.md``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.chebyshev import (
    _KERNELS,
    chebyshev_coefficients,
    ldos_from_moments,
    ldos_site_probes,
    rademacher_probes,
    reconstruct_density,
)
from ..ops.cuda_spmm import (
    ShardedMomentSweep,
    _resolve,
    as_kernel_operand,
    ell_spmm_halo,
    halo_cheb_step,
    halo_sweep,
    moments_from_sums,
)
from .sharded import RowSharding, RowSum, _whole_result


def _require_rows_only(rs: RowSharding):
    if rs.has_probe_axis:
        raise ValueError(
            "This CUDA sharded entry point partitions rows only; "
            "rows×probes meshes are supported by moments_sharded_cuda"
        )
    Lx, Ly, Lz = rs.sk.shape
    if Lx < 2 or Ly * Lz < 2:
        raise ValueError("CUDA sharded path needs a cubic lattice with Lx > 1 and Ly·Lz > 1")


def _overlap_from_env() -> bool:
    """Default for the interior/boundary overlap split."""
    return os.environ.get("BODGE_HALO_OVERLAP") == "1"


def _resolve_overlap(overlap, Lxl: int) -> bool:
    if overlap is None:
        overlap = _overlap_from_env()
    # The split needs a non-empty interior; thin slabs are all boundary.
    return bool(overlap) and Lxl >= 3


def _check_remat(remat):
    if not (remat in (None, "auto", False) or isinstance(remat, int)):
        raise ValueError(f"remat must be None, 'auto', False or an int, got {remat!r}")


def _operands(rs: RowSharding, data, v, impl):
    """``(backend, data slab, vector slab)`` in the backend's form (complex64 for the kernels)."""
    data_l, v_l = rs.shard_data(data), rs.shard_vector(v)
    backend = _resolve(impl, v_l)
    if backend == "cuda":
        data_l, v_l = as_kernel_operand(data_l), as_kernel_operand(v_l)
    elif v_l.dtype != data_l.dtype:
        v_l = v_l.to(data_l.dtype)
    return backend, data_l, v_l


def _split(rs: RowSharding, overlap) -> bool:
    return _resolve_overlap(overlap, rs.slab.planes)


def spmm_sharded_cuda(rs: RowSharding, data, v, overlap: Optional[bool] = None,
                      impl: Optional[str] = None):
    """``H @ v`` with H row-partitioned, by :func:`ell_spmm_halo` on every slab.

    Whole-lattice inputs give the whole ``[N, 4, K]`` result on every rank;
    slabs give this rank's slab.  ``overlap`` selects the split (the interior
    rows, then the two boundary planes after the exchange)."""
    _require_rows_only(rs)
    whole = rs.is_whole(torch.as_tensor(v))
    backend, data_l, v_l = _operands(rs, data, v, impl)
    slab = rs.slab
    handle = rs.exchange_start(v_l)
    if _split(rs, overlap):
        P, n = slab.plane, slab.n_local
        y = torch.empty_like(v_l)
        ell_spmm_halo(data_l, slab, v_l, None, None, rows=(P, n - P), out=y, impl=backend)
        hm, hp = rs.exchange_finish(handle)
        ell_spmm_halo(data_l, slab, v_l, hm, hp, rows=(0, P), out=y, impl=backend)
        ell_spmm_halo(data_l, slab, v_l, hm, hp, rows=(n - P, n), out=y, impl=backend)
    else:
        hm, hp = rs.exchange_finish(handle)
        y = ell_spmm_halo(data_l, slab, v_l, hm, hp, impl=backend)
    return _whole_result(rs, y, whole)


def moments_sharded_cuda(rs: RowSharding, data, v0, order: int, scale: float,
                         overlap: Optional[bool] = None, remat="auto", impl: Optional[str] = None):
    """Chebyshev moments ``μ_m[k]`` ``[order, K]`` through the fused halo step,
    on every rank.  On a rows × probes mesh each probe shard sweeps its
    share of the columns over the rows and the shares are gathered."""
    _check_remat(remat)
    backend, data_l, v_l = _operands(rs, data, v0, impl)
    K = v_l.shape[-1]
    sums, _, _ = halo_sweep(data_l, rs.slab, rs, v_l, 1.0 / float(scale), order, backend=backend,
                            split=_split(rs, overlap))
    mu = moments_from_sums(rs.row_sum(sums), K, order)
    return rs.gather_probes(mu) if rs.has_probe_axis else mu


def moments_sharded_ad(rs: RowSharding, data_l, v0_l, inv: float, order: int, dm, dp,
                       overlap: Optional[bool] = None, impl: Optional[str] = None):
    """Differentiable moments ``[order, K]`` of this rank's slabs ``data_l``,
    ``v0_l`` (rows only): :class:`ShardedMomentSweep`, then the column sums
    summed over the ranks (:class:`~bodge_tpu_torch.parallel.sharded.RowSum`,
    identity backward).  ``dm`` / ``dp`` are the operator rows of the planes
    before and after the slab (:meth:`RowSharding.halo_rows`).  Every rank
    must take the gradient, in step with the others."""
    backend = _resolve(impl, v0_l)
    if backend == "cuda":
        data_l, v0_l, dm, dp = (as_kernel_operand(x) for x in (data_l, v0_l, dm, dp))
    split = _split(rs, overlap)
    if torch.is_grad_enabled() and (data_l.requires_grad or v0_l.requires_grad):
        sums = ShardedMomentSweep.apply(data_l, v0_l, rs.slab, rs, float(inv), order, backend, split,
                                        dm.detach(), dp.detach())
    else:  # three buffers, as moments_sharded_cuda
        sums, _, _ = halo_sweep(data_l, rs.slab, rs, v0_l, float(inv), order, backend=backend, split=split)
    return moments_from_sums(RowSum.apply(sums, rs), v0_l.shape[-1], order)


def chebyshev_scan_sharded(rs: RowSharding, data, v, inv: float, steps: int,
                           overlap: bool = False, impl: Optional[str] = None):
    """``steps`` fused Chebyshev steps from ``(t_prev, t_cur) = (v, v)``;
    returns this rank's slab of the last vector.  One exchange and one
    kernel pass (three with ``overlap``) per step."""
    _require_rows_only(rs)
    backend, data_l, v_l = _operands(rs, data, v, impl)
    split = _split(rs, overlap)
    t_prev, t_cur = v_l, v_l
    for i in range(steps):
        out = t_prev if (backend == "cuda" and i > 1) else None  # the first two steps' t_prev is the caller's v
        t_next, _, _ = halo_cheb_step(data_l, rs.slab, rs, t_cur, t_prev, inv, backend=backend, split=split,
                                      out=out)
        t_prev, t_cur = t_cur, t_next
    return t_cur


def _free_energy_coefficients(temperature: float, scale: float, order: int, kernel: str):
    T = float(temperature)
    if T < 0:
        raise ValueError("Expected non-negative temperature!")
    if T == 0:
        g = lambda E: -np.abs(E) / 2
    else:
        g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))
    return chebyshev_coefficients(lambda x: g(scale * x), order) * _KERNELS[kernel](order)


def free_energy_kpm_sharded_cuda(
    rs: RowSharding,
    data,
    temperature: float,
    scale: float,
    order: int = 512,
    samples: int = 64,
    seed: Optional[int] = None,
    kernel: str = "jackson",
    overlap: Optional[bool] = None,
    impl: Optional[str] = None,
) -> float:
    """Row-partitioned KPM free energy through the fused halo step: the same
    estimator and probes (``seed``, default 42) as
    :func:`~bodge_tpu_torch.parallel.sharded.free_energy_kpm_sharded`."""
    _require_rows_only(rs)
    coeffs = _free_energy_coefficients(temperature, scale, order, kernel)
    z = rademacher_probes(rs.sk.n_sites, samples, seed, np.complex64)
    mu = moments_sharded_cuda(rs, data, z, order, scale, overlap=overlap, impl=impl)
    est = float(np.dot(coeffs, mu.sum(dim=1).double().cpu().numpy()))
    return 0.5 * est / samples


def spectral_bound_sharded(rs: RowSharding, data, iters: int = 60, seed: int = 0,
                           impl: Optional[str] = None) -> float:
    """‖H‖₂ by power iteration through :func:`ell_spmm_halo`, norms summed over
    the ranks: the start vector and the 5 % margin of
    :func:`~bodge_tpu_torch.ops.chebyshev.spectral_bound`."""
    _require_rows_only(rs)
    rng = np.random.default_rng(seed)
    shape = (rs.sk.n_sites, 4, 1)
    v = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    backend, data_l, v_l = _operands(rs, data, v, impl)
    v_l = v_l.to(data_l.dtype)

    def norm(w):
        return rs.row_sum((w.real * w.real + w.imag * w.imag).sum()).sqrt()

    v_l = v_l / norm(v_l)
    n = None
    for _ in range(iters):
        hm, hp = rs.exchange(v_l)
        w = ell_spmm_halo(data_l, rs.slab, v_l, hm, hp, impl=backend)
        n = norm(w)
        v_l = w / n
    return float(n) * 1.05


def ldos_kpm_sharded_cuda(
    rs: RowSharding,
    data,
    site_indices,
    energies,
    order: int = 512,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    overlap: Optional[bool] = None,
    impl: Optional[str] = None,
):
    """Batched KPM LDOS ``[n_sites, n_energies]`` (electron component) at
    ``site_indices``: the probes and reconstruction of
    :func:`~bodge_tpu_torch.ops.chebyshev.ldos_kpm_sites`, all 4·n_sites
    orbital probes in one sharded sweep.  ``scale=None`` runs
    :func:`spectral_bound_sharded`."""
    _require_rows_only(rs)
    if scale is None:
        scale = spectral_bound_sharded(rs, data, impl=impl)
    site_indices = np.asarray(site_indices, dtype=np.int64)
    v0 = ldos_site_probes(rs.sk.n_sites, site_indices, np.complex64)
    mu = moments_sharded_cuda(rs, data, v0, order, scale, overlap=overlap, impl=impl)
    return ldos_from_moments(mu, energies, scale, kernel, len(site_indices))


def dos_kpm_sharded_cuda(
    rs: RowSharding,
    data,
    energies,
    order: int = 512,
    kernel: str = "jackson",
    scale: Optional[float] = None,
    samples: int = 16,
    seed: Optional[int] = None,
    overlap: Optional[bool] = None,
    impl: Optional[str] = None,
):
    """Total density of states through the sharded sweep: the Rademacher
    probes (``seed``, default 1) and reconstruction of
    :func:`~bodge_tpu_torch.ops.chebyshev.dos_kpm`."""
    _require_rows_only(rs)
    if scale is None:
        scale = spectral_bound_sharded(rs, data, impl=impl)
    z = rademacher_probes(rs.sk.n_sites, samples, seed, np.complex64, default_seed=1)
    mu = moments_sharded_cuda(rs, data, z, order, scale, overlap=overlap, impl=impl)
    mu_tr = mu.sum(dim=1).double().cpu().numpy() / samples
    energies = np.array(energies, dtype=float)
    x = np.clip(energies / scale, -0.999999, 0.999999)
    return reconstruct_density(mu_tr[:, None], x, scale, kernel=kernel)[:, 0]
