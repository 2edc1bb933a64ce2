"""Row-sharded KPM sweeps driven by the fused halo step.

Counterpart of ``bodge_tpu/parallel/pallas_sharded.py``: every rank runs
:func:`~bodge_tpu_torch.ops.cuda_ell.ell_cheb_step_halo` on its x-slab, the
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
  (:class:`ShardedMomentSweep`), for the row-sharded gap objective.

``impl`` is ``None`` (the kernels for CUDA tensors, their plain versions for
CPU tensors), ``"cuda"`` or ``"plain"``.  Inputs are the whole lattice's
(every rank takes its slab) or this rank's slabs; the operator may also come
as :func:`pack_operator_sharded` gives it (the reference's pre-packed
operator), in particular in the bf16 form, which the forward halo kernels
take as their bf16 instantiations (``ell_cheb_step_halo_bf16``,
``ell_spmm_halo_bf16``).

The interior/boundary overlap split (``overlap=True`` or
``BODGE_HALO_OVERLAP=1``): each step begins the exchange, launches the slab's
interior planes ``[1, Lxl−1)``, which read no halo, ends the exchange and
launches the two boundary planes — three launches a step, the interior one
running while the planes travel.  Slabs thinner than three planes use one
launch.  ``remat=`` is the gradient's checkpointing schedule
(:func:`remat_chunk_for`: ``"auto"`` keeps O(√order) vectors for one more
forward sweep, bit-equal values); the forward-only entry points take it for
the reference's signature.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.chebyshev import (
    _KERNELS,
    _seeded_start_vector,
    chebyshev_coefficients,
    ldos_from_moments,
    ldos_site_probes,
    rademacher_probes,
    reconstruct_density,
)
from ..ops.cuda_ell import (
    HaloSlab,
    _require_complex_operator,
    _resolve,
    as_kernel_operand,
    bf16_operator,
    ell_block_outer_halo,
    ell_cheb_step_halo,
    ell_spmm_adjoint_halo,
    ell_spmm_halo,
    is_bf16_operator,
    moments_from_sums,
    resolve_operator_storage,
    sweep_launches,
)
from .sharded import RowSharding, RowSum, _whole_result


# --------------------------------------------------------------------------
# The sweep on one slab, with its halo exchange.
# --------------------------------------------------------------------------
def halo_cheb_step(data, slab: HaloSlab, ring, t_cur, t_prev, inv: float, *, backend: str,
                   split: bool = False, out=None):
    """One fused step on a slab with its halo exchange: ``(t_next, partials,
    (hm, hp))``.  ``ring`` is the exchange (``exchange_start(t)`` /
    ``exchange_finish(handle)``, :class:`bodge_tpu_torch.parallel.RowSharding`).

    ``split`` is the interior/boundary overlap split: the exchange begins,
    the slab's interior planes ``[1, Lxl − 1)`` (which read no halo) are
    launched, the exchange ends and the two boundary planes are launched —
    three launches of :func:`ell_cheb_step_halo` into one ``t_next`` buffer.
    ``out`` may be ``t_prev``'s buffer (kernel only)."""
    handle = ring.exchange_start(t_cur)
    if not split:
        hm, hp = ring.exchange_finish(handle)
        t_next, pp = ell_cheb_step_halo(data, slab, t_cur, hm, hp, t_prev, inv, out=out, impl=backend)
        return t_next, pp, (hm, hp)
    P, n = slab.plane, slab.n_local
    if out is None:
        out = torch.empty_like(t_cur)
    _, pp_int = ell_cheb_step_halo(data, slab, t_cur, None, None, t_prev, inv, rows=(P, n - P), out=out,
                                   impl=backend)
    hm, hp = ring.exchange_finish(handle)
    _, pp_lo = ell_cheb_step_halo(data, slab, t_cur, hm, hp, t_prev, inv, rows=(0, P), out=out, impl=backend)
    _, pp_hi = ell_cheb_step_halo(data, slab, t_cur, hm, hp, t_prev, inv, rows=(n - P, n), out=out,
                                  impl=backend)
    return out, torch.cat([pp_lo, pp_int, pp_hi]), (hm, hp)


def halo_steps(data, slab: HaloSlab, ring, t_prev, t_cur, inv: float, n: int, *, backend: str,
               split: bool = False, keep: bool = False, own_cur: bool = False):
    """``n`` full fused steps on a slab from the carry ``(t_prev, t_cur)``:
    ``(sums, ts, halos, carry)`` with this rank's column sums of each step,
    and, with ``keep``, every new vector and every step's halo planes of its
    ``t_cur`` (else empty lists: ``t_next`` overwrites a ``t_prev`` buffer of
    this run once the carry's vectors have left it, so a carry — a boundary
    the backward pass replays from — is never written; ``own_cur`` marks the
    carry's ``t_cur`` as this run's own, free from the second step on).
    ``carry`` is the last ``(t_prev, t_cur)``."""
    sums, ts, halos = [], [], []
    first_reuse = 1 if own_cur else 2
    for i in range(n):
        out = t_prev if (not keep and backend == "cuda" and i >= first_reuse) else None
        t_next, pp, h = halo_cheb_step(data, slab, ring, t_cur, t_prev, inv, backend=backend, split=split,
                                       out=out)
        sums.append(pp.sum(dim=0))
        if keep:
            ts.append(t_next)
            halos.append(h)
        t_prev, t_cur = t_cur, t_next
    return sums, ts, halos, (t_prev, t_cur)


def halo_sweep(data, slab: HaloSlab, ring, v0, inv: float, order: int, *, backend: str,
               split: bool = False, keep: bool = False):
    """The doubled-moment sweep of
    :func:`~bodge_tpu_torch.ops.cuda_spmm.moments_fused` on one slab: this
    rank's column sums ``[1 + steps, 2K]`` (not yet summed over the ranks),
    and, with ``keep``, every vector and every step's halo planes for the
    backward pass (else ``t_next`` overwrites ``t_prev``'s buffer from the
    third step on: three vectors in all)."""
    inv = float(inv)
    t1, pp, halos0 = halo_cheb_step(data, slab, ring, v0, None, 0.5 * inv, backend=backend, split=split)
    sums, ts, halos, _ = halo_steps(data, slab, ring, v0, t1, inv, sweep_launches(order) - 1, backend=backend,
                                    split=split, keep=keep, own_cur=True)
    return torch.stack([pp.sum(dim=0), *sums]), [v0, t1, *ts], [halos0, *halos]


def halo_step_backward(data, slab: HaloSlab, ring, t_cur, halos, t_next, inv: float, g_next, cc_bar,
                       nc_bar, dm, dp, *, h_bar=None, g_cur_add=None, backend: str):
    """Cotangents ``(H̄, t̄_cur, t̄_prev)`` of one step on a slab: the
    equations of :func:`~bodge_tpu_torch.ops.cuda_spmm.cheb_step_backward`.
    :func:`ell_block_outer_halo` forms ``G``, writes ``−G`` and accumulates
    ``H̄`` over the slab's rows, reading the forward step's halo planes
    ``halos`` of ``t_cur``; ``−G``'s boundary planes then go round the ring in
    the forward direction, and :func:`ell_spmm_adjoint_halo` gathers ``H†G``
    with them and the neighbour planes' operator rows ``dm`` / ``dp``.  Every
    row of ``t̄_cur`` is complete on its own rank: nothing is sent back."""
    real = torch.float32 if t_cur.dtype == torch.complex64 else torch.float64
    if g_next is None and nc_bar is None:
        g_next = torch.zeros_like(t_cur)
    if g_next is not None:
        g_next = g_next.contiguous()
    shift = None if nc_bar is None else nc_bar.to(real).contiguous()
    neg_G = torch.empty_like(t_cur)
    h_bar = ell_block_outer_halo(g_next, slab, t_cur, *halos, 2.0 * inv, out=h_bar,
                                 accumulate=h_bar is not None, shift=shift, neg_out=neg_G, impl=backend)
    gm, gp = ring.exchange(neg_G)
    axpy = []
    if cc_bar is not None:
        axpy.append(((2.0 * cc_bar).to(real).contiguous(), t_cur))
    if shift is not None:
        axpy.append((shift, t_next))
    g_cur = ell_spmm_adjoint_halo(data, slab, neg_G, gm, gp, dm, dp, alpha=-2.0 * inv, add=g_cur_add,
                                  axpy=tuple(axpy), out=g_cur_add, impl=backend)
    return h_bar, g_cur, neg_G


class ShardedMomentSweep(torch.autograd.Function):
    """The sweep on one slab of a row-sharded lattice as one differentiable
    function: the counterpart of
    :class:`~bodge_tpu_torch.ops.cuda_spmm.MomentSweep` on the halo kernels.

    ``ShardedMomentSweep.apply(data, v0, slab, ring, inv, order, backend,
    split, dm, dp, chunk)`` returns this rank's column sums ``[1 + steps, 2K]``
    (sum them over the ranks with
    :class:`bodge_tpu_torch.parallel.sharded.RowSum`).  Forward: one exchange
    and one :func:`ell_cheb_step_halo` step (three with ``split``) per step.
    Backward: per step, one :func:`ell_block_outer_halo`, one exchange of
    ``−G`` and one :func:`ell_spmm_adjoint_halo`.  Gradients flow to ``data``
    and ``v0``; ``dm`` / ``dp`` (the neighbour planes' operator rows, whose
    gradients their own ranks compute) get none.  Every rank must run the
    backward pass, in step with the others.

    ``chunk`` is the two-level checkpointing schedule of the reference's
    sharded scan (``_remat_chunk_for``; :func:`remat_chunk_for` here): with
    ``0 < chunk < steps`` the forward pass keeps only the carry ``(t_prev,
    t_cur)`` at the start of each of the ``steps // chunk`` chunks, and the
    ragged tail's vectors and halos; the backward pass replays each chunk
    from its carry (steps and exchanges, every rank in step) before it walks
    that chunk's steps back.  O(steps / chunk + chunk) vectors instead of
    ``2 + steps``, for one more forward sweep; the same kernels replay on the
    same inputs, so the values are bit-equal.  ``chunk = 0`` keeps every
    vector and halo.
    """

    @staticmethod
    def forward(ctx, data, v0, slab, ring, inv, order, backend, split, dm, dp, chunk=0):
        _require_complex_operator(data, "ShardedMomentSweep")
        inv = float(inv)
        steps = sweep_launches(order) - 1
        chunk = int(chunk) if 0 < int(chunk) < steps else 0
        full = steps // chunk if chunk else 0
        t1, pp, (h0m, h0p) = halo_cheb_step(data, slab, ring, v0, None, 0.5 * inv, backend=backend, split=split)
        sums, carries = [pp.sum(dim=0)], []
        carry = (v0, t1)
        for _ in range(full):
            carries.extend(carry)
            chunk_sums, _, _, carry = halo_steps(data, slab, ring, *carry, inv, chunk, backend=backend,
                                                 split=split)
            sums.extend(chunk_sums)
        tail_sums, tail_ts, tail_halos, _ = halo_steps(data, slab, ring, *carry, inv, steps - full * chunk,
                                                       backend=backend, split=split, keep=True)
        sums.extend(tail_sums)
        ctx.save_for_backward(data, dm, dp, h0m, h0p, *carries, *carry, *tail_ts,
                              *(h for pair in tail_halos for h in pair))
        ctx.slab, ctx.ring, ctx.inv, ctx.backend, ctx.split = slab, ring, inv, backend, split
        ctx.chunk, ctx.full, ctx.rem = chunk, full, len(tail_ts)
        return torch.stack(sums)

    @staticmethod
    def backward(ctx, g_sums):
        data, dm, dp, h0m, h0p, *rest = ctx.saved_tensors
        chunk, full, rem = ctx.chunk, ctx.full, ctx.rem
        carries, rest = rest[:2 * full], rest[2 * full:]
        tail = list(rest[:2 + rem])  # the tail's carry, then its vectors
        flat = rest[2 + rem:]
        tail_halos = [(flat[2 * i], flat[2 * i + 1]) for i in range(rem)]
        need_data, need_v0 = ctx.needs_input_grad[:2]
        K = tail[0].shape[-1]
        real = torch.float32 if tail[0].dtype == torch.complex64 else torch.float64
        cc_bar = g_sums[:, :K].to(real).contiguous()
        nc_bar = g_sums[:, K:].to(real).contiguous()
        state = {"h_bar": None, "g_later": None, "g_cur_add": None}

        def walk(ts, halos, base):
            """Steps ``m = base + j`` for ``j = len(halos) − 1 … 1`` back, from
            ``ts[j]`` (= t_m), ``halos[j]`` and ``ts[j + 1]``."""
            for j in range(len(halos) - 1, 0, -1):
                m = base + j
                state["h_bar"], g_cur, neg_G = halo_step_backward(
                    data, ctx.slab, ctx.ring, ts[j], halos[j], ts[j + 1], ctx.inv, state["g_later"],
                    cc_bar[m], nc_bar[m], dm, dp, h_bar=state["h_bar"], g_cur_add=state["g_cur_add"],
                    backend=ctx.backend,
                )
                state["g_later"], state["g_cur_add"] = g_cur, neg_G

        walk(tail, [None, *tail_halos], full * chunk)
        for c in range(full - 1, -1, -1):  # replay each chunk from its carry, then walk it back
            carry = carries[2 * c:2 * c + 2]
            _, ts, halos, _ = halo_steps(data, ctx.slab, ctx.ring, *carry, ctx.inv, chunk, backend=ctx.backend,
                                         split=ctx.split, keep=True)
            walk([*carry, *ts], [None, *halos], c * chunk)
            del ts, halos
        v0, t1 = carries[:2] if full else tail[:2]
        h_bar, g_cur, _ = halo_step_backward(  # the half-scaled first step: no t_prev, its −G is dropped
            data, ctx.slab, ctx.ring, v0, (h0m, h0p), t1, 0.5 * ctx.inv, state["g_later"], cc_bar[0], nc_bar[0],
            dm, dp, h_bar=state["h_bar"], g_cur_add=state["g_cur_add"], backend=ctx.backend,
        )
        return ((h_bar if need_data else None), (g_cur if need_v0 else None),
                None, None, None, None, None, None, None, None, None)


def remat_chunk_for(order: int, remat) -> int:
    """The checkpointing chunk of a sharded sweep's gradient (the reference's
    ``_remat_chunk_for``): ``None`` / ``"auto"`` give ⌊√steps⌋ for
    ``steps = ceil((order − 2) / 2) ≥ 32`` (else 0), an int forces the chunk,
    ``0`` / ``False`` turn it off."""
    steps = max(0, (order - 1) // 2)
    if remat is False or remat == 0:
        return 0
    if remat is None or remat == "auto":
        return int(np.sqrt(steps)) if steps >= 32 else 0
    return int(remat)


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


def pack_operator_sharded(rs: RowSharding, data, operator_dtype=None):
    """This rank's slab of the ELL data ``[N, S, 4, 4]`` (NumPy or tensor, the
    whole lattice or the slab) in the form the forward halo kernels take, on
    the mesh's device: complex64 on the card (the complex dtype as it is on
    the CPU), or with ``operator_dtype="bf16"`` the bf16 form
    ``[n_local, S, 4, 4, 2]`` (:func:`~bodge_tpu_torch.ops.cuda_ell.bf16_operator`).
    The counterpart of the reference's ``pack_operator_sharded``; as there,
    ``None`` means float32 storage.  The forward halo kernels read only the
    slab's own operator rows (the neighbours' planes they need are vectors,
    exchanged every step), so the slab is all a rank keeps."""
    slab = rs.shard_data(data)
    if operator_dtype is not None and resolve_operator_storage(operator_dtype) is not None:
        return bf16_operator(slab)
    return as_kernel_operand(slab) if slab.is_cuda else slab


def _operands(rs: RowSharding, data, v, impl):
    """``(backend, data slab, vector slab)`` in the backend's form (complex64
    for the kernels; an operator in the bf16 form stays so, and the plain
    versions then take complex128 vectors, the CPU's default)."""
    data_l, v_l = rs.shard_data(data), rs.shard_vector(v)
    backend = _resolve(impl, v_l)
    bf16 = is_bf16_operator(data_l)
    if backend == "cuda":
        v_l = as_kernel_operand(v_l)
        if not bf16:
            data_l = as_kernel_operand(data_l)
    else:
        v_l = v_l.to(torch.complex128 if bf16 else data_l.dtype)
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
                       overlap: Optional[bool] = None, impl: Optional[str] = None, remat="auto"):
    """Differentiable moments ``[order, K]`` of this rank's slabs ``data_l``,
    ``v0_l`` (rows only): :class:`ShardedMomentSweep`, then the column sums
    summed over the ranks (:class:`~bodge_tpu_torch.parallel.sharded.RowSum`,
    identity backward).  ``dm`` / ``dp`` are the operator rows of the planes
    before and after the slab (:meth:`RowSharding.halo_rows`).  ``remat``:
    the checkpointing schedule of the gradient
    (:func:`remat_chunk_for`; ``"auto"``:
    ⌊√steps⌋ at order ≥ 66, bit-equal values either way).  Every rank must
    take the gradient, in step with the others."""
    _check_remat(remat)
    backend = _resolve(impl, v0_l)
    if backend == "cuda":
        data_l, v0_l, dm, dp = (as_kernel_operand(x) for x in (data_l, v0_l, dm, dp))
    split = _split(rs, overlap)
    if torch.is_grad_enabled() and (data_l.requires_grad or v0_l.requires_grad):
        sums = ShardedMomentSweep.apply(data_l, v0_l, rs.slab, rs, float(inv), order, backend, split,
                                        dm.detach(), dp.detach(), remat_chunk_for(order, remat))
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
    draw = _seeded_start_vector(rs.sk.n_sites, seed, torch.empty(0, dtype=torch.complex128))  # NumPy's own dtype
    backend, data_l, v_l = _operands(rs, data, draw, impl)

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
