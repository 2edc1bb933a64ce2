"""The sweep layer: which step a Chebyshev sweep runs, and the sweeps on it.

The kernels and their plain versions lie below: :mod:`.cuda_ell` (the general
ELL, tiled and halo kernels, the operator's storage, the recursions one step
a call), :mod:`.cuda_gather` (the windowed kernels of generic skeletons) and
:mod:`.cuda_filter` (the filter, moment and power sweeps in one launch each).

Paths.  A sweep runs one of three steps, chosen by :func:`resolve_path`:
``"cuda"`` (the general ELL kernels, any skeleton), ``"cuda_gather"`` (generic
skeletons with a feasible window plan: the default there) and
``"cuda_tiled"`` (stencil skeletons, opt-in); ``"plain"``, ``"plain_gather"``
and ``"plain_tiled"`` are their plain PyTorch versions, the default for CPU
tensors.  :class:`StepPlan` holds the choice for one sweep — the operator and
the vectors in the order the step wants, the step, the product — and
:func:`moments_fused`, :func:`moments_fused_ad`, :func:`filter_sweep` and
:func:`power_sweep` run on it.  Asking for a path that cannot run
(``"cuda_gather"`` without a feasible plan, ``"cuda_tiled"`` on a generic
skeleton, any ``"cuda*"`` on a CPU tensor) raises; nothing gives way to
another path.  On the general step on the card each of those sweeps is one
launch of its :mod:`.cuda_filter` kernel where that kernel's plan fits, else
one launch a step: :func:`sweep_mode` says which.

Light-cone forms.  From probes nonzero on a few sites alone (the LDOS
probes) a sweep's vectors are zero beyond ``m`` bands of the operator's
nonzero blocks after ``m`` products (:class:`LightCone`); :func:`moments_fused`
steps only those rows where its caller names the sites (``support``).

:class:`ChebStep` and :class:`MomentSweep` are the differentiable step and
moment sweep.  The scale ``inv`` is a Python float and gets no gradient: the
self-consistency objective fixes it once (the reference differentiates it
formally and never uses that cotangent).  :func:`launch_counts` reads every
kernel's launch counter.
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_gather as cg
from .blocksparse import BLOCK, Skeleton
from .cuda_ell import (
    _require_complex_operator, _require_stencil, _resolve, as_kernel_operand, bf16_operator, ell_block_outer,
    ell_block_outer_halo, ell_cheb_step, ell_cheb_step_bf16, ell_cheb_step_halo, ell_cheb_step_halo_bf16,
    ell_cheb_step_plain, ell_cheb_step_window, ell_spmm, ell_spmm_adjoint, ell_spmm_adjoint_halo, ell_spmm_bf16,
    ell_spmm_halo, ell_spmm_halo_bf16, filter_recursion, is_bf16_operator, moment_recursion,
    moments_from_sums, power_recursion, sm_count, stencil_cheb_step_tiled, stencil_cheb_step_tiled_bf16,
    stencil_cheb_step_tiled_plain,
)
from .cuda_ell import sweep_launches  # noqa: F401  (read here by portbench's tests, with StepPlan and launch_counts)
from .cuda_filter import (
    ell_cheb_filter, ell_cheb_filter_bf16, ell_cheb_moments, ell_cheb_moments_bf16, ell_power_iteration,
    filter_plan, moments_plan, power_plan,
)
from .spmm import default_impl

# Every kernel of the port, in the order launch_counts reports them.
_WRAPPERS = (ell_spmm, ell_cheb_step, ell_spmm_adjoint, ell_block_outer,
             cg.ell_gather_spmm, cg.ell_gather_cheb_step, stencil_cheb_step_tiled,
             ell_spmm_halo, ell_cheb_step_halo, ell_spmm_adjoint_halo, ell_block_outer_halo,
             ell_spmm_bf16, ell_cheb_step_bf16, ell_spmm_halo_bf16, ell_cheb_step_halo_bf16,
             cg.ell_gather_spmm_bf16, cg.ell_gather_cheb_step_bf16, stencil_cheb_step_tiled_bf16,
             ell_cheb_filter, ell_cheb_filter_bf16, ell_cheb_moments, ell_cheb_moments_bf16,
             ell_power_iteration, ell_cheb_step_window, cg.ell_gather_cheb_step_window)
KERNELS = tuple(fn.__name__ for fn in _WRAPPERS)
FILTER_KERNELS = ("ell_cheb_filter", "ell_cheb_filter_bf16")
MOMENT_KERNELS = ("ell_cheb_moments", "ell_cheb_moments_bf16")
POWER_KERNELS = ("ell_power_iteration",)
# One launch a sweep: they also count their steps, "<name>.steps".
SWEEP_KERNELS = FILTER_KERNELS + MOMENT_KERNELS + POWER_KERNELS
SWEEPS = ("moments", "filter", "power")  # the sweeps sweep_mode rules on


def launch_counts() -> dict:
    """``{kernel name: launches so far}`` for every kernel of the port, in the
    order of :data:`KERNELS`, then ``{"<name>.steps": steps so far}`` for the
    one-launch sweeps (:data:`SWEEP_KERNELS`: the filter kernels' Σ(order − 1),
    the moment kernels' Σ :func:`~bodge_tpu_torch.ops.cuda_ell.sweep_launches`,
    the power kernel's Σ iters over their launches)."""
    return {**{fn.__name__: fn.launches for fn in _WRAPPERS},
            **{f"{fn.__name__}.steps": fn.steps for fn in _WRAPPERS if fn.__name__ in SWEEP_KERNELS}}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
        if fn.__name__ in SWEEP_KERNELS:
            fn.steps = 0


# --------------------------------------------------------------------------
# Paths: which step a sweep runs.
# --------------------------------------------------------------------------
PATHS = {
    "cuda": ("cuda", "ell"), "cuda_gather": ("cuda", "gather"), "cuda_tiled": ("cuda", "tiled"),
    "plain": ("plain", "ell"), "plain_gather": ("plain", "gather"), "plain_tiled": ("plain", "tiled"),
}


def use_tiled_step() -> bool:
    """The opt-in knob of the tiled step (``BODGE_PLANE_TILED=1``), as in the reference."""
    return os.environ.get("BODGE_PLANE_TILED") == "1"


def resolve_path(impl: Optional[str], tensor, sk: Skeleton, K: int) -> str:
    """The name in :data:`PATHS` a sweep over ``tensor`` on ``sk`` runs.

    ``None`` chooses by what can be observed: the device of ``tensor``
    (kernels on the card, plain versions on the CPU), and the skeleton — a
    generic skeleton with a feasible window plan takes the gather step, a
    stencil skeleton the general ELL step, or the tiled one under
    ``BODGE_PLANE_TILED=1``; a generic skeleton without a plan takes the
    general ELL step.  A name is honoured or raises.
    """
    if impl is None:
        backend = default_impl(tensor)
        if sk.stencil:
            kind = "tiled" if use_tiled_step() else "ell"
        else:
            kind = "gather" if cg.plan_gather(sk, K) is not None else "ell"
        return backend if kind == "ell" else f"{backend}_{kind}"
    if impl not in PATHS:
        raise ValueError(f"Unknown kernel implementation '{impl}' (expected one of {sorted(PATHS)})")
    backend, kind = PATHS[impl]
    if backend == "cuda" and not tensor.is_cuda:
        raise RuntimeError(
            f"impl='{impl}' needs tensors on a CUDA device; this one lies on the CPU "
            "(use the plain version, or move the operator with device='cuda')"
        )
    if kind == "tiled":
        _require_stencil(sk)
    if kind == "gather" and cg.plan_gather(sk, K) is None:
        raise ValueError(
            f"impl='{impl}': no feasible gather plan for this skeleton at K = {K} "
            "(the window of relabelled rows does not fit shared memory)"
        )
    return impl


class StepPlan:
    """The step one sweep runs, and the order it runs in.

    ``StepPlan(sk, K, impl, like, operator_dtype)`` resolves the path for a
    sweep of ``K`` probe columns over tensors like ``like``
    (:func:`resolve_path`).  :meth:`operator` and :meth:`enter` bring block
    data and vectors into the form the step takes — complex64 for the
    kernels, relabelled rows for the gather step — and :meth:`leave` brings a
    vector back; all are differentiable except the bf16 form.  On the gather
    path each relabelling runs in the span ``bodge.gather.relabel`` and is
    counted by :func:`~bodge_tpu_torch.ops.cuda_gather.gather_counts`.
    ``operator_dtype`` is the operator's storage as
    :func:`~bodge_tpu_torch.ops.cuda_ell.resolve_operator_storage` gives it:
    ``None`` (complex) or ``torch.bfloat16``, for which :meth:`operator` ends
    in :func:`~bodge_tpu_torch.ops.cuda_ell.bf16_operator` and the steps launch
    their bf16 instantiations.  :meth:`step` and :meth:`spmm` then work on
    those.  ``plan.sk`` is the
    skeleton in the sweep's order (the relabelled one on the gather path),
    which the backward kernels take, and ``plan.backend`` (``"cuda"`` /
    ``"plain"``) the ``impl`` they run with.
    """

    def __init__(self, sk: Skeleton, K: int, impl: Optional[str], like, operator_dtype=None):
        if operator_dtype not in (None, torch.bfloat16):
            raise ValueError(f"operator_dtype {operator_dtype!r}: None or torch.bfloat16 "
                             "(resolve a name with resolve_operator_storage)")
        self.operator_dtype = operator_dtype
        self.impl = resolve_path(impl, like, sk, K)
        self.backend, self.kind = PATHS[self.impl]
        self.layout = None
        self.sk = sk
        if self.kind == "gather":
            self.layout = cg.plan_gather(sk, K, operator_dtype=operator_dtype)
            self.sk = self.layout.sk
            self._traced = cg.traced_relabel
            self._step, self._plain_step, self._product = (
                cg.ell_gather_cheb_step, cg.ell_gather_cheb_step_plain, cg.ell_gather_spmm)
            self._window_step = cg.ell_gather_cheb_step_window
        elif self.kind == "tiled":  # a step only: its product is the general ELL kernel's
            self._step, self._plain_step, self._product = (
                stencil_cheb_step_tiled, stencil_cheb_step_tiled_plain, ell_spmm)
            self._window_step = None
        else:
            self._step, self._plain_step, self._product = ell_cheb_step, ell_cheb_step_plain, ell_spmm
            self._window_step = ell_cheb_step_window
        self._where = self.sk if self.layout is None else self.layout  # what the step's wrapper takes

    def _form(self, x, count: str):
        if self.backend == "cuda":
            x = as_kernel_operand(x)
        return x if self.layout is None else self._traced(self.layout.relabel, x, count)

    def operator(self, data):
        """Block data ``[N, S, 4, 4]`` in the sweep's form (the bf16 form
        where the plan stores the operator so)."""
        data = self._form(data, "operator_relabels")
        return data if self.operator_dtype is None else bf16_operator(data)

    def enter(self, v):
        """A vector ``[N, 4, K]`` in the sweep's form."""
        return self._form(v, "vector_relabels")

    def leave(self, y):
        """A vector of the sweep back in the original site order."""
        return y if self.layout is None else self._traced(self.layout.restore, y, "vector_relabels")

    rows = None  # the rows the steps run on: None, all of them; (r0, r1), the light-cone form on those

    def step(self, data, t_cur, t_prev, inv: float, out=None, sums: bool = True):
        """One fused Chebyshev step ``(t_next, partials)`` on operands in the
        sweep's form.  ``sums=False`` tells a plain version to skip the column
        sums (``partials`` is then ``None``); the kernels form them in the same
        pass either way.  With ``self.rows = (r0, r1)`` (:func:`moments_fused`
        sets it step by step from :meth:`light_cone`) the light-cone form runs
        on those rows alone."""
        if self.rows is not None:
            return self._window_step(data, self._where, t_cur, t_prev, inv, self.rows, out=out, impl=self.backend)
        if self.backend == "plain":
            return self._plain_step(data, self._where, t_cur, t_prev, inv, sums)
        return self._step(data, self._where, t_cur, t_prev, inv, out=out, impl="cuda")

    def spmm(self, data, v):
        """``H v`` on operands in the sweep's form."""
        return self._product(data, self._where, v, impl=self.backend)

    def light_cone(self, data, sites) -> Optional["LightCone"]:
        """The :class:`LightCone` of a sweep from probes that are nonzero on the
        sites ``sites`` (original indices) alone, in the sweep's order, or
        ``None`` where this plan has no light-cone step (the tiled step, the
        bf16 form) or the cone is the whole lattice from the first step.
        ``data`` is the operator in the original order.  The band is the gather
        plan's ``bwb`` on the gather path, else :func:`nonzero_bandwidth`."""
        if self._window_step is None or self.operator_dtype is not None:
            return None
        N = self.sk.n_sites
        rows = np.asarray(sites, dtype=np.int64).reshape(-1) % N
        if self.layout is not None:
            rows, band = self.layout.rank[rows], self.layout.bwb
        else:
            band = nonzero_bandwidth(data, self.sk)
        cone = LightCone(int(rows.min()), int(rows.max()), band, N)
        return None if cone.rows(1) is None else cone


@dataclass(frozen=True)
class LightCone:
    """The rows a sweep's vectors can be nonzero on.  Probes nonzero on rows
    ``[lo, hi]`` alone, and an operator whose nonzero blocks lie within
    ``band`` rows of the diagonal (in the sweep's order), give ``t_m`` zero
    outside ``[lo − m·band, hi + m·band]``."""

    lo: int
    hi: int
    band: int
    n: int

    def rows(self, m: int) -> Optional[Tuple[int, int]]:
        """``(r0, r1)``, the rows ``t_m`` can be nonzero on, cut to ``[0, n)``;
        ``None`` once they are the whole lattice."""
        r0, r1 = max(0, self.lo - m * self.band), min(self.n, self.hi + m * self.band + 1)
        return None if (r0, r1) == (0, self.n) else (r0, r1)


def nonzero_bandwidth(data, sk: Skeleton) -> int:
    """``max |n − cols[n, s]|`` over the slots whose block holds a nonzero
    entry: the band that bounds a product's reach, which the column table
    alone does not (a stencil skeleton names its wrap-around columns on open
    boundaries too, with zero blocks).  Computed on ``data``'s device with no
    temporary larger than ``[N, S]``, and kept beside ``sk``'s device copies
    until another operator, or this one after an in-place write (its
    ``_version``), asks."""
    kept = sk._device_cache.get("nonzero_band")
    if kept is not None and kept[0]() is data and kept[1] == data._version:
        return kept[2]
    with torch.no_grad():
        cols = sk.device_cols(data.device)
        nonzero = torch.zeros(cols.shape, dtype=torch.bool, device=data.device)
        for a in range(BLOCK):
            for b in range(BLOCK):
                nonzero |= data[:, :, a, b] != 0
        nonzero &= cols >= 0
        reach = (cols - torch.arange(cols.shape[0], dtype=cols.dtype, device=cols.device)[:, None]).abs_()
        band = int(reach.masked_fill_(~nonzero, 0).max()) if cols.numel() else 0
    sk._device_cache["nonzero_band"] = (weakref.ref(data), data._version, band)
    return band


# --------------------------------------------------------------------------
# The differentiable step.
# --------------------------------------------------------------------------
def cheb_step_backward(data, sk: Skeleton, t_cur, t_next, inv: float, g_next, cc_bar, nc_bar, *,
                       h_bar=None, g_cur_add=None, impl: Optional[str] = None):
    """Cotangents ``(H̄, t̄_cur, t̄_prev)`` of one fused step.

    The step is ``t_next = 2·inv·H t_cur − t_prev`` with the column sums
    ``cc = Σ|t_cur|²`` and ``nc = Re⟨t_next, t_cur⟩``.  Given the cotangents
    ``g_next`` of ``t_next`` and ``cc_bar``, ``nc_bar`` (real ``[K]``) of the
    sums — any of them ``None`` = zero — with ``G = g_next + n̄c·t_cur``::

        t̄_prev = −G
        t̄_cur  = 2·inv·H†G + 2·c̄c·t_cur + n̄c·t_next   (+ g_cur_add)
        H̄[n,s] = 2·inv · Σ_k G[n,:,k] ⊗ conj(t_cur[cols[n,s],:,k])   (+ h_bar)

    in PyTorch's convention for complex gradients.  Two launches on CUDA
    tensors: :func:`~bodge_tpu_torch.ops.cuda_ell.ell_block_outer` forms
    ``G``, writes ``−G`` and sums (or, given the buffer ``h_bar``,
    accumulates) ``H̄``; :func:`~bodge_tpu_torch.ops.cuda_ell.ell_spmm_adjoint`
    takes ``−G`` and folds the other terms of ``t̄_cur`` into its epilogue,
    ``g_cur_add`` (what later steps already sent to ``t_cur``) included; the
    kernel writes ``t̄_cur`` over the ``g_cur_add`` buffer, which the caller
    gives up.  Both kernels are launched whichever cotangents the caller
    goes on to use.
    """
    real = torch.float32 if t_cur.dtype == torch.complex64 else torch.float64
    if g_next is None and nc_bar is None:
        g_next = torch.zeros_like(t_cur)
    if g_next is not None:
        g_next = g_next.contiguous()
    shift = None if nc_bar is None else nc_bar.to(real).contiguous()
    neg_G = torch.empty_like(t_cur)
    h_bar = ell_block_outer(g_next, sk, t_cur, 2.0 * inv, out=h_bar, accumulate=h_bar is not None,
                            shift=shift, neg_out=neg_G, impl=impl)
    axpy = []
    if cc_bar is not None:
        axpy.append(((2.0 * cc_bar).to(real).contiguous(), t_cur))
    if shift is not None:
        axpy.append((shift, t_next))
    g_cur = ell_spmm_adjoint(data, sk, neg_G, alpha=-2.0 * inv, add=g_cur_add, axpy=tuple(axpy),
                             out=g_cur_add, impl=impl)
    return h_bar, g_cur, neg_G


class ChebStep(torch.autograd.Function):
    """The fused Chebyshev step with hand-written forward and backward.

    ``ChebStep.apply(data, t_cur, t_prev, sk, inv, impl)`` returns
    ``(t_next, sums)`` with ``sums[:K] = Σ|t_cur|²`` and ``sums[K:] =
    Re⟨t_next, t_cur⟩`` per probe column (the kernel's per-thread-block
    partials, summed).  ``t_prev`` may be ``None`` (zero).  Forward is
    :func:`~bodge_tpu_torch.ops.cuda_ell.ell_cheb_step`, backward
    :func:`cheb_step_backward`; on CUDA tensors both launch kernels or raise.  Gradients flow to ``data``,
    ``t_cur`` and ``t_prev``; ``inv`` is a Python float without gradient.

    The counterpart of ``cheb_step_pallas_ad`` (``pallas_spmm.py:1397``).
    ``t_cur`` and ``t_next`` are kept for the backward pass, so neither may
    be overwritten afterwards (no ``out=`` aliasing here).
    """

    @staticmethod
    def forward(ctx, data, t_cur, t_prev, sk, inv, impl):
        _require_complex_operator(data, "ChebStep")
        inv = float(inv)
        t_next, partials = ell_cheb_step(data, sk, t_cur, t_prev, inv, impl=impl)
        ctx.save_for_backward(data, t_cur, t_next)
        ctx.sk, ctx.inv, ctx.impl = sk, inv, impl
        ctx.set_materialize_grads(False)
        return t_next, partials.sum(dim=0)

    @staticmethod
    def backward(ctx, g_next, g_sums):
        data, t_cur, t_next = ctx.saved_tensors
        need_data, need_cur, need_prev = ctx.needs_input_grad[:3]
        K = t_cur.shape[-1]
        cc_bar, nc_bar = (None, None) if g_sums is None else (g_sums[:K], g_sums[K:])
        h_bar, g_cur, g_prev = cheb_step_backward(
            data, ctx.sk, t_cur, t_next, ctx.inv, g_next, cc_bar, nc_bar, impl=ctx.impl,
        )
        grads = (h_bar if need_data else None, g_cur if need_cur else None, g_prev if need_prev else None)
        return (*grads, None, None, None)


class MomentSweep(torch.autograd.Function):
    """The whole doubled-moment sweep as one differentiable function.

    ``MomentSweep.apply(data, v0, sk, inv, order, impl)`` returns the stacked
    column sums ``[1 + steps, 2K]`` of the half-scaled first step and the
    ``steps = ceil((order−2)/2)`` full steps.  ``impl`` is ``None`` /
    ``"cuda"`` / ``"plain"`` (the general ELL step) or a :class:`StepPlan`,
    whose step then runs forward — the gather or the tiled one — on ``data``
    and ``v0`` already in the plan's form, with ``sk = plan.sk``; the
    backward pass is the same two kernels on that skeleton either way.  The
    same launches as a loop over :class:`ChebStep`, but the backward pass
    walks the steps itself: the operator cotangent is accumulated in place
    in one ``[N, S, 4, 4]`` buffer (``accumulate`` of
    :func:`~bodge_tpu_torch.ops.cuda_ell.ell_block_outer`) and each vector's
    cotangent is completed inside the adjoint kernel's epilogue, so a step
    costs two launches and no elementwise pass.  Forward runs
    :func:`~bodge_tpu_torch.ops.cuda_ell.moment_recursion`, which keeps every
    ``t_m`` from forward to backward (``2 + steps`` vectors).
    """

    @staticmethod
    def forward(ctx, data, v0, sk, inv, order, impl):
        _require_complex_operator(data, "MomentSweep")
        inv = float(inv)
        plan = impl if isinstance(impl, StepPlan) else StepPlan(sk, v0.shape[-1], _resolve(impl, v0), v0)
        ts = [v0]
        sums = moment_recursion(lambda t_cur, t_prev, scale, out: plan.step(data, t_cur, t_prev, scale, out=out),
                                v0, inv, order, keep=ts)
        ctx.save_for_backward(data, *ts)
        ctx.sk, ctx.inv, ctx.impl = plan.sk, inv, plan.backend
        return sums

    @staticmethod
    def backward(ctx, g_sums):
        data, *ts = ctx.saved_tensors
        need_data, need_v0 = ctx.needs_input_grad[:2]
        K = ts[0].shape[-1]
        real = torch.float32 if ts[0].dtype == torch.complex64 else torch.float64
        cc_bar = g_sums[:, :K].to(real).contiguous()  # one row per step, sliced without a launch
        nc_bar = g_sums[:, K:].to(real).contiguous()
        h_bar = None
        g_later = None  # cotangent of t_{i+1}, complete when step i is reached
        g_cur_add = None  # what step i+1 sent to t_i as its t_prev
        for i in range(len(ts) - 2, -1, -1):
            h_bar, g_cur, neg_G = cheb_step_backward(
                data, ctx.sk, ts[i], ts[i + 1], ctx.inv if i > 0 else 0.5 * ctx.inv,
                g_later, cc_bar[i], nc_bar[i], h_bar=h_bar, g_cur_add=g_cur_add, impl=ctx.impl,
            )
            g_later, g_cur_add = g_cur, neg_G  # step 0 has no t_prev: its −G is dropped
        return (h_bar if need_data else None), (g_later if need_v0 else None), None, None, None, None


# --------------------------------------------------------------------------
# The sweeps: one launch of a cuda_filter kernel, or one launch a step.
# --------------------------------------------------------------------------
def sweep_mode(plan: StepPlan, data, sweep: str, K: int = 1, order: int = 0) -> str:
    """How ``sweep`` runs on ``plan``, ``data`` in the plan's form:
    ``"moments"`` (:func:`moments_fused`, ``order`` moments of ``K``
    columns), ``"filter"`` (:func:`filter_sweep`, ``K`` columns) or
    ``"power"`` (:func:`power_sweep`, ``order`` iterations of one column).
    ``"registers"`` / ``"global"``: one launch of its :mod:`.cuda_filter`
    kernel, in the mode of that kernel's plan.  ``"per_step"``: one launch a
    step — the gather and tiled steps, the bf16 form's power iteration (its
    kernel takes complex64 only), the general step where no plan fits.
    ``"plain"``: the plain versions."""
    if sweep not in SWEEPS:
        raise ValueError(f"sweep {sweep!r}: one of {SWEEPS}")
    if plan.backend == "plain":
        return "plain"
    bf16 = is_bf16_operator(data)
    if plan.kind != "ell" or (sweep == "power" and bf16):
        return "per_step"
    N, S = plan.sk.cols.shape
    if sweep == "moments":
        return moments_plan(N, K, S, order, bf16=bf16, sms=sm_count())["mode"]
    if sweep == "filter":
        return filter_plan(N, K, S, bf16=bf16, sms=sm_count())["mode"]
    return power_plan(N, S, order, sms=sm_count())["mode"]


def moments_fused(data, sk: Skeleton, v0, inv: float, order: int, *, impl: Optional[str] = None,
                  operator_dtype=None, support=None):
    """KPM moments ``μ_m[k] = Re⟨v0_k|T_m(inv·H)|v0_k⟩`` as a ``[order, K]`` real tensor.

    The counterpart of ``moments_pallas_fused``: one half-scaled first step
    with ``t_prev = 0`` gives ``t1 = H̃ t0`` and, from its partials, μ0 and
    μ1; then ``ceil((order−2)/2)`` steps each give two moments through
    ``μ_{2m} = 2⟨t_m,t_m⟩ − μ0`` and ``μ_{2m+1} = 2⟨t_{m+1},t_m⟩ − μ1``.

    Where :func:`sweep_mode` says so (the general step on the card where a
    moment plan fits), the whole scan is one launch of
    :func:`~bodge_tpu_torch.ops.cuda_filter.ell_cheb_moments` and one sum of
    its partials.  Otherwise — the gather and tiled steps, the plain versions,
    lattices too large for a plan — it is
    :func:`~bodge_tpu_torch.ops.cuda_ell.moment_recursion` on
    :meth:`StepPlan.step`, with no host synchronisation: the reduced partials
    stay on the device and are stacked at the end.  With the kernels, a
    complex128 operator or probe is cast down to complex64 first, and from
    the third step on ``t_next`` overwrites the ``t_prev`` buffer, so three
    vectors exist in all (``v0`` is never written).

    ``impl`` is a name of :data:`PATHS`, ``None`` (:func:`resolve_path`
    chooses) or a :class:`StepPlan`; ``data`` and ``v0`` come in the original
    site order and the plan brings them into its own (inner products do not
    depend on the order, so the moments need no way back).
    ``operator_dtype`` (``None`` or ``torch.bfloat16``, see :class:`StepPlan`)
    stores the operator in the bf16 form for the sweep.

    ``support`` names the sites (original indices) outside which every probe
    column is zero, where the caller knows them: the per-step recursion then
    runs each step on the rows the probes' :class:`LightCone` has reached
    (:meth:`StepPlan.light_cone`), the light-cone forms while those are not
    the whole lattice, counted in
    :func:`~bodge_tpu_torch.ops.cuda_ell.window_counts`.  Without it the
    steps run on the whole lattice.
    """
    K = v0.shape[-1]
    plan = impl if isinstance(impl, StepPlan) else StepPlan(sk, K, impl, v0, operator_dtype)
    operator, v0 = plan.operator(data), plan.enter(v0)
    inv = float(inv)
    if sweep_mode(plan, operator, "moments", K, order) in ("registers", "global"):
        return ell_cheb_moments(operator, plan.sk, v0, inv, order, impl="cuda")
    cone = None if support is None else plan.light_cone(data, support)

    def step(t_cur, t_prev, scale, out, rows=None):
        plan.rows = rows
        return plan.step(operator, t_cur, t_prev, scale, out=out)

    try:
        return moment_recursion(step, v0, inv, order, cone)
    finally:
        plan.rows = None


def moments_fused_ad(data, sk: Skeleton, v0, inv: float, order: int, *,
                     impl: Optional[str] = None):
    """Differentiable :func:`moments_fused`: the same recursion as one
    :class:`MomentSweep`, so gradients with respect to ``data`` and ``v0``
    ride the backward kernels.  The counterpart of ``moments_pallas_fused_ad``
    (``pallas_spmm.py:1585``).

    Every step's vector stays alive until the backward pass
    (``2 + ceil((order−2)/2)`` vectors of ``[N, 4, K]``), so ``t_next`` never
    overwrites a buffer here.  One gradient launches ``sweep_launches(order)``
    steps forward and as many
    :func:`~bodge_tpu_torch.ops.cuda_ell.ell_spmm_adjoint` and
    :func:`~bodge_tpu_torch.ops.cuda_ell.ell_block_outer` backward.  Where
    nothing asks for a gradient it is :func:`moments_fused` with its three
    buffers.  ``impl`` as in :func:`moments_fused`: on a generic skeleton the
    forward step is the gather kernel and the backward kernels see the
    relabelled skeleton.
    """
    if not (torch.is_grad_enabled() and (data.requires_grad or v0.requires_grad)):
        return moments_fused(data, sk, v0, inv, order, impl=impl)
    K = v0.shape[-1]
    plan = impl if isinstance(impl, StepPlan) else StepPlan(sk, K, impl, v0)
    data, v0 = plan.operator(data), plan.enter(v0)  # the cast and the relabelling carry gradients
    return moments_from_sums(MomentSweep.apply(data, v0, plan.sk, float(inv), order, plan), K, order)


def _gather_impl(impl: Optional[str], tensor) -> str:
    return {"cuda": "cuda_gather", "plain": "plain_gather"}[_resolve(impl, tensor)]


def moments_gather(data, sk: Skeleton, v0, inv: float, order: int, *, impl: Optional[str] = None):
    """KPM moments ``[order, K]`` of a generic skeleton through the gather step.

    The counterpart of ``moments_gather_packed``: ``data`` and ``v0`` come in
    the original site order, are relabelled once, and the doubled-moment
    recursion (:func:`moments_fused`: three vector buffers, one fused launch
    per step) runs in relabelled order.  ``impl``: ``None`` / ``"cuda"``
    (kernel, CUDA tensors) or ``"plain"``.  Raises ``ValueError`` when no
    plan is feasible.
    """
    return moments_fused(data, sk, v0, inv, order, impl=_gather_impl(impl, v0))


def moments_gather_ad(data, sk: Skeleton, v0, inv: float, order: int, *, impl: Optional[str] = None):
    """Differentiable :func:`moments_gather`: the gather step forward, the
    adjoint-product and block-outer-product kernels backward on the
    relabelled skeleton (the counterpart of ``spmm_gather_packed_ad`` under
    ``moments_gather_packed``); the relabelling itself is an indexed copy that
    ``torch.autograd`` differentiates."""
    return moments_fused_ad(data, sk, v0, inv, order, impl=_gather_impl(impl, v0))


def filter_sweep(plan: StepPlan, data, v, coeffs, inv: float):
    """``y = Σ_m c_m T_m(inv·H) v``, the counterpart of the reference's
    ``_filter_apply_packed``.

    ``data`` and ``v`` are in ``plan``'s form (:meth:`StepPlan.operator`,
    :meth:`StepPlan.enter`); ``coeffs`` are host numbers.  On the general step
    (``plan.kind == "ell"``) this is :func:`~bodge_tpu_torch.ops.cuda_filter.ell_cheb_filter`:
    one launch of the filter kernel on the card where its plan fits
    (:func:`sweep_mode`), the plain recursion on the CPU.  Otherwise, and
    where no filter plan fits, it is
    :func:`~bodge_tpu_torch.ops.cuda_ell.filter_recursion` on
    :meth:`StepPlan.step`: one step launch an order beyond the zeroth, three
    vector buffers and the accumulator on the device, no host synchronisation
    inside.  A zero coefficient adds nothing; no partial sums are used.
    """
    if plan.kind == "ell" and sweep_mode(plan, data, "filter", v.shape[-1]) != "per_step":
        return ell_cheb_filter(data, plan.sk, v, coeffs, inv, impl=plan.backend)

    def step(t_cur, t_prev, scale, out):
        return plan.step(data, t_cur, t_prev, scale, out=out, sums=False)[0]

    return filter_recursion(step, v, coeffs, inv)


def filter_launches(order: int, fused: bool = False) -> int:
    """Launches of one :func:`filter_sweep` with ``order`` coefficients: one
    with the filter kernel (``fused``), else one step launch an order beyond
    the zeroth."""
    return 1 if fused else max(0, order - 1)


def power_sweep(plan: StepPlan, data, v, iters: int):
    """``‖H w‖`` after ``iters`` normalised applications of the operator to
    ``v`` ``[N, 4, 1]`` (the reference's ``_power_iteration``), a 0-d real
    tensor, on operands in ``plan``'s form.  One launch of
    :func:`~bodge_tpu_torch.ops.cuda_filter.ell_power_iteration` where
    :func:`sweep_mode` says so; else
    :func:`~bodge_tpu_torch.ops.cuda_ell.power_recursion` on
    :meth:`StepPlan.spmm`, one product a step with no host synchronisation
    inside."""
    if sweep_mode(plan, data, "power", order=iters) in ("registers", "global"):
        return ell_power_iteration(data, plan.sk, v, iters, impl="cuda")
    return power_recursion(lambda w: plan.spmm(data, w), v, iters)
