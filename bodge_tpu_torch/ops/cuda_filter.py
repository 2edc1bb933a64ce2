"""The Chebyshev filter sweep, the KPM moment sweep and the spectral bound's
power iteration in one launch each, with their plain versions.

:func:`ell_cheb_filter` computes ``y = Σ_{m<M} c_m T_m(inv·H) v`` — the
filter of the lowest-states solver (:mod:`.lanczos`) — by the three-term
recursion on the general block-ELL step, the first step half-scaled with
``t_prev = 0``, a zero coefficient adding nothing.  It is the counterpart of
the reference's whole ``_filter_apply_packed`` scan
(``bodge_tpu/ops/lanczos.py:122-143``), whose body is the fused step of
``pallas_spmm.py:468`` / ``:1081`` (P2/P4) and an axpy.

The kernel (``csrc/ell_filter.cu``) is one cooperative launch a sweep: each
thread owns fixed (site, column) pairs, each block stages its sites' operator
rows in shared memory once, and a grid-wide barrier separates the steps.  In
*register mode* (one pair a thread) ``t_prev``, ``t_cur`` and the running sum
of a pair live in registers for the whole sweep; in *global mode* (any number
of pairs a thread) the owner reads ``t_prev`` from the buffer it overwrites
and adds into the output.  Why one barrier a step is enough, and what bounds
the kernel (the bytes of :func:`~bodge_tpu_torch.ops.spmm.chebyshev_step_bytes`
a step), is said at the top of the source.

:func:`filter_plan` is the launch plan, pure arithmetic: the mode, the grid,
the sites a block and the pairs a thread.  Where no plan fits — a block's
sites would not fit its share of shared memory, which happens from about
44 000 sites at S = 5 (85 000 in the bf16 form) — it answers ``"per_step"``, and
:func:`~bodge_tpu_torch.ops.cuda_spmm.filter_sweep` runs one
:func:`~bodge_tpu_torch.ops.cuda_spmm.ell_cheb_step` launch an order there.

Counters: ``ell_cheb_filter.launches`` (one a sweep) and
``ell_cheb_filter.steps`` (Σ(order − 1)), and the same pair on the bf16
instantiation :func:`ell_cheb_filter_bf16`;
:func:`~bodge_tpu_torch.ops.cuda_spmm.launch_counts` reads all four.

:func:`ell_cheb_moments` is the same kernel under its ``MOMENTS`` flag: the
whole doubled-moment recursion of
:func:`~bodge_tpu_torch.ops.cuda_spmm.moments_fused` — the half-scaled first
step and ``ceil((order − 2) / 2)`` full ones — in one launch, the counterpart
of the reference's ``moments_pallas_fused`` scan
(``bodge_tpu/ops/pallas_spmm.py:1547-1582``).  In place of the filter's axpy
each step forms the two column sums of its owned pairs, each block reduces
them over its sites in a fixed tree in shared memory and writes one row a step
into a ``[steps, grid, 2K]`` float32 buffer, summed over the grid after the
launch.  :func:`moments_plan` is :func:`filter_plan` with that reduction
buffer (two floats a pair) in each block's shared memory and the partials
buffer at most :data:`MOMENTS_PARTIALS_CAP`; where no plan fits, ``"per_step"``,
and ``moments_fused`` launches one step at a time there.  Its counters are
``ell_cheb_moments.launches`` (one a sweep) and ``ell_cheb_moments.steps``
(the fused steps the launch ran, ``1 + ceil((order − 2) / 2)``: the
``ell_cheb_step`` launches it stands for), and the same on
:func:`ell_cheb_moments_bf16`.

:func:`ell_power_iteration` is a sibling kernel of the same source on the
same staging and grid: the power iteration of
:func:`~bodge_tpu_torch.ops.chebyshev.spectral_bound` (``w_0 = H v``, ``w_k =
H w_{k−1} / ‖w_{k−1}‖``) in one launch, the counterpart of the reference's
``_power_iteration`` scan (``bodge_tpu/ops/chebyshev.py:134-141``) over the
product of ``pallas_spmm.py:440`` / ``:985`` (P1/P3), complex64 and one column
only.  Each block writes its sum of ``|w_k|²`` into a ``[iters, grid]`` row;
after the grid barrier every block sums the row in the same order and divides
by the same norm.  :func:`power_plan` is :func:`filter_plan` at K = 1 with a
block's 32-byte reduction buffer; where it answers ``"per_step"``,
``spectral_bound`` keeps one ``ell_spmm`` launch a step.  Its counters are
``ell_power_iteration.launches`` (one a bound) and
``ell_power_iteration.steps`` (``iters``: the ``ell_spmm`` launches it stands
for).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import cuda_spmm as ck
from .blocksparse import Skeleton
from .spmm import batched_operator, spmm_batched

FILTER_THREADS = 256  # threads a block (THREADS in csrc/ell_filter.cu)
FILTER_BLOCKS_PER_SM = 4  # __launch_bounds__(256, 4): at most 64 registers a thread
# Shared memory a block may stage so that four blocks fit an SM.
FILTER_SMEM_CAP = ck.SM_SHARED // FILTER_BLOCKS_PER_SM - ck.BLOCK_RESERVED
MODES = ("registers", "global")
MOMENTS_PARTIALS_CAP = 1 << 28  # bytes of a moment sweep's [steps, grid, 2K] float32 partials, at most
POWER_BLOCK_BYTES = 32  # a power block's reduction buffer: one float a warp (WARPS in csrc/ell_filter.cu)
SWEEPS = {"filter": 0, "moment": 1, "power": 2}  # the kernel kinds of ell_cheb_sweep_occupancy


def _site_bytes(S: int, bf16: bool, K: int = 0) -> int:
    """Shared memory a staged site takes: its S blocks (8 float4 each, 4 uint4
    in the bf16 form), a 16-byte pad, its S column indices and, for the
    moment sweep (``K`` > 0), the reduction buffer of its K pairs."""
    return (S * (4 if bf16 else 8) + 1) * 16 + 4 * S + 8 * K


def filter_plan(N: int, K: int, S: int, *, bf16: bool = False, mode: Optional[str] = None,
                sms: Optional[int] = None) -> dict:
    """Launch plan of :func:`ell_cheb_filter` for ``N`` sites, ``K`` columns,
    ``S`` slots: ``{"mode", "grid", "threads", "sites_per_block",
    "pairs_per_thread", "smem_bytes", "lanes_used"}``.

    A block of :data:`FILTER_THREADS` threads owns ``sites_per_block``
    consecutive sites, every column of them; the grid is at most
    :data:`FILTER_BLOCKS_PER_SM` × ``sms`` blocks (all resident at once, as a
    cooperative launch needs), and a block stages at most
    :data:`FILTER_SMEM_CAP` bytes.  Register mode (one pair a thread) takes
    ``min(256 // K, ceil(N / sms))`` sites a block and fits where that grid
    does; global mode takes ``ceil(N / (4·sms))`` sites a block.  ``mode=None``
    takes register mode where it fits, else global mode, else ``"per_step"``
    (no kernel plan fits: the caller runs one step launch an order); a named
    mode that does not fit raises ``ValueError``.  ``sms`` defaults to the
    card's SM count (132 without one)."""
    return _plan("filter", N, K, S, bf16, mode, sms)


def moments_plan(N: int, K: int, S: int, order: int, *, bf16: bool = False, mode: Optional[str] = None,
                 sms: Optional[int] = None) -> dict:
    """Launch plan of :func:`ell_cheb_moments` for a sweep of ``order``
    moments: :func:`filter_plan`'s, with each block's reduction buffer (two
    floats a pair, ``8·K`` bytes a site) counted against
    :data:`FILTER_SMEM_CAP`, and with ``"steps"`` (``1 + ceil((order − 2) /
    2)``) and ``"partials_bytes"`` (``steps × grid × 2K`` float32) besides.  A
    plan whose partials exceed :data:`MOMENTS_PARTIALS_CAP` does not fit:
    ``mode=None`` then answers ``"per_step"``, a named mode raises."""
    order = int(order)
    if order < 1:
        raise ValueError(f"moments_plan needs order >= 1, got {order}")
    return _plan("moment", N, K, S, bf16, mode, sms, steps=ck.sweep_launches(order))


def power_plan(N: int, S: int, iters: int, *, mode: Optional[str] = None, sms: Optional[int] = None) -> dict:
    """Launch plan of :func:`ell_power_iteration` for ``iters`` steps on ``N``
    sites, ``S`` slots: :func:`filter_plan`'s at K = 1 on the complex64
    operator, with each block's reduction buffer (:data:`POWER_BLOCK_BYTES`)
    counted against :data:`FILTER_SMEM_CAP`, and with ``"steps"`` (``iters``)
    and ``"partials_bytes"`` (``iters × grid`` float32) besides.  A plan whose
    partials exceed :data:`MOMENTS_PARTIALS_CAP` does not fit.  ``mode=None``
    answers ``"registers"``, ``"global"`` or ``"per_step"`` (the caller runs
    one ``ell_spmm`` launch a step); a named mode that does not fit raises
    ``ValueError``."""
    iters = int(iters)
    if iters < 1:
        raise ValueError(f"power_plan needs iters >= 1, got {iters}")
    return _plan("power", N, 1, S, False, mode, sms, steps=iters)


def _plan(what: str, N: int, K: int, S: int, bf16: bool, mode: Optional[str], sms: Optional[int],
          steps: int = 0) -> dict:
    """The plan of the ``"filter"``, ``"moment"`` or ``"power"`` kernel; the
    last two write ``steps`` rows of partials (``2K`` floats a block a row for
    the moment sweep, one for the power iteration)."""
    N, K, S = int(N), int(K), int(S)
    if N < 1 or K < 1 or S < 1:
        raise ValueError(f"{what} plan needs N, K, S >= 1, got {N}, {K}, {S}")
    if mode not in (None, *MODES):
        raise ValueError(f"mode {mode!r}: None, 'registers' or 'global'")
    sms = ck.sm_count() if sms is None else int(sms)
    slots = FILTER_BLOCKS_PER_SM * sms
    site = _site_bytes(S, bf16, K if what == "moment" else 0)
    block = POWER_BLOCK_BYTES if what == "power" else 0
    most = (FILTER_SMEM_CAP - block) // site  # sites a block may stage
    row = {"moment": 2 * K, "power": 1}.get(what, 0)  # floats a block writes a step

    def partials_fit(sb):
        return steps * -(-N // sb) * row * 4 <= MOMENTS_PARTIALS_CAP

    fits = {}
    if K <= FILTER_THREADS:
        sb = min(FILTER_THREADS // K, -(-N // sms), most)
        if sb >= 1 and -(-N // sb) <= slots and partials_fit(sb):
            fits["registers"] = sb
    sb = -(-N // slots)
    if sb <= most and partials_fit(sb):
        fits["global"] = sb
    if mode is None:
        mode = next((m for m in MODES if m in fits), "per_step")
    elif mode not in fits:
        raise ValueError(f"the {what} kernel's {mode} mode does not fit N = {N}, K = {K}, S = {S} "
                         f"on {sms} SMs ({slots} blocks of {FILTER_THREADS} threads, {most} sites a block"
                         + (f", {steps} steps of partials)" if steps else ")"))
    extra = {"steps": steps, "partials_bytes": 0} if steps else {}
    if mode == "per_step":
        return {"mode": mode, "grid": 0, "threads": 0, "sites_per_block": 0, "pairs_per_thread": 0,
                "smem_bytes": 0, "lanes_used": 0.0, **extra}
    sb = fits[mode]
    grid = -(-N // sb)
    per_thread = -(-sb * K // FILTER_THREADS)
    if steps:
        extra["partials_bytes"] = steps * grid * row * 4
    return {"mode": mode, "grid": grid, "threads": FILTER_THREADS, "sites_per_block": sb,
            "pairs_per_thread": per_thread, "smem_bytes": sb * site + block,
            "lanes_used": N * K / (grid * FILTER_THREADS * per_thread), **extra}


def _coefficients(coeffs) -> list:
    c = np.asarray(coeffs, dtype=np.float64)
    if c.ndim != 1 or c.size < 1:
        raise ValueError(f"coeffs must be a non-empty 1-D sequence of host numbers, got shape {c.shape}")
    return [float(x) for x in c]


def ell_cheb_filter_plain(data, sk: Skeleton, v, coeffs, inv: float):
    """Plain version of :func:`ell_cheb_filter`: the per-step recursion of
    :func:`~bodge_tpu_torch.ops.cuda_spmm.ell_cheb_step_plain` (any device,
    complex64 or complex128, either operator form), the operator brought into
    the batched product's form once a sweep, as the kernel stages it once."""
    A = batched_operator(ck.operator_values(data, v.dtype), sk)

    def step(t_cur, t_prev, scale, out):
        return ck.cheb_tail_plain(spmm_batched(A, sk, t_cur), t_cur, t_prev, scale, sums=False)[0]

    return ck.filter_recursion(step, v, _coefficients(coeffs), inv)


@functools.lru_cache(maxsize=64)
def _occupancy(device: int, kind: str, bf16: bool, registers: bool, sb: int, S: int, K: int) -> int:
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = ck._library().ell_cheb_sweep_occupancy(SWEEPS[kind], int(bf16), int(registers), sb, S, K,
                                                     ctypes.byref(blocks), ctypes.byref(smem))
    ck._raise_on(err, "ell_cheb_sweep_occupancy")
    return blocks.value


def occupancy(plan: dict, S: int, K: int = 1, *, bf16: bool = False, kind: str = "filter") -> int:
    """Blocks of the plan's kernel one SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the plan's shared
    memory): what :func:`filter_plan`, :func:`moments_plan` and
    :func:`power_plan` assume to be :data:`FILTER_BLOCKS_PER_SM`.  ``kind``
    names the kernel (a key of :data:`SWEEPS`); only the moment kernel's
    reduction buffer grows with ``K``."""
    if kind not in SWEEPS:
        raise ValueError(f"kind {kind!r}: one of {sorted(SWEEPS)}")
    return _occupancy(torch.cuda.current_device(), kind, bool(bf16), plan["mode"] == "registers",
                      plan["sites_per_block"], int(S), int(K) if kind == "moment" else 1)


def _launch_sweep(counter, kind: str, plan: dict, v, S: int, K: int, bf16: bool, steps: int, launch) -> None:
    """What the wrappers share: refuse a ``"per_step"`` plan and a grid larger
    than the card holds at once, call ``launch(p0, p1, stream)`` with the two
    scratch vectors of the sweep on ``v``'s device, raise on its error, and
    count the launch and its ``steps`` on ``counter``.  ``kind`` is the
    kernel's key in :data:`SWEEPS`."""
    if plan["mode"] == "per_step":
        caller = {"filter": "filter_sweep", "moment": "moments_fused", "power": "spectral_bound"}[kind]
        raise ValueError(f"no plan of the {kind} kernel fits N = {v.shape[0]}, K = {K}, S = {S}"
                         + (f", {steps} steps" if kind != "filter" else "")
                         + f" ({caller} runs the per-step path there)")
    with torch.cuda.device(v.device):
        held = occupancy(plan, S, K, bf16=bf16, kind=kind) * ck.sm_count()
        if plan["grid"] > held:
            raise RuntimeError(f"{counter.__name__}: the plan's {plan['grid']} blocks exceed the {held} the card "
                               f"holds at once ({FILTER_BLOCKS_PER_SM} an SM assumed)")
        scratch = torch.empty((2, *v.shape), dtype=v.dtype, device=v.device)
        err = launch(scratch[0].data_ptr(), scratch[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
    ck._raise_on(err, counter.__name__)
    counter.launches += 1
    counter.steps += steps


def ell_cheb_filter(data, sk: Skeleton, v, coeffs, inv: float, *, mode: Optional[str] = None,
                    impl: Optional[str] = None):
    """``y = Σ_m coeffs[m] · T_m(inv·H) v`` in one launch of the filter kernel.

    ``coeffs`` are host numbers (at least one), uploaded as float32 once;
    ``mode`` forces ``"registers"`` or ``"global"`` (:func:`filter_plan`;
    ``None`` lets the plan choose, and raises where it answers
    ``"per_step"``).  On a CUDA tensor this launches the kernel or raises
    (refused launch, or a grid larger than the card holds); on a CPU tensor,
    or with ``impl="plain"``, it runs :func:`ell_cheb_filter_plain`.
    ``data`` in the bf16 form launches the bf16 instantiation, counted as
    :func:`ell_cheb_filter_bf16`."""
    coeffs = _coefficients(coeffs)
    if ck._resolve(impl, v) == "plain":
        return ell_cheb_filter_plain(data, sk, v, coeffs, inv)
    N, S, K, bf16 = ck._check_forward(data, sk, v)
    plan = filter_plan(N, K, S, bf16=bf16, mode=mode, sms=ck.sm_count())
    c = torch.tensor(coeffs, dtype=torch.float32).to(v.device)
    y = torch.empty_like(v)
    _launch_sweep(
        ell_cheb_filter_bf16 if bf16 else ell_cheb_filter, "filter", plan, v, S, K, bf16, len(coeffs) - 1,
        lambda p0, p1, stream: ck._library().ell_cheb_filter_launch(
            data.data_ptr(), int(bf16), sk.device_cols(v.device).data_ptr(), v.data_ptr(), c.data_ptr(),
            len(coeffs), float(inv), p0, p1, y.data_ptr(), N, S, K, plan["sites_per_block"],
            int(plan["mode"] == "registers"), stream))
    return y


ell_cheb_filter.launches = 0
ell_cheb_filter.steps = 0


def ell_cheb_filter_bf16(data, sk: Skeleton, v, coeffs, inv: float, *, mode: Optional[str] = None,
                         impl: Optional[str] = None):
    """:func:`ell_cheb_filter` with the operator in the bf16 form, which it requires."""
    ck._require_bf16(data, "ell_cheb_filter_bf16")
    return ell_cheb_filter(data, sk, v, coeffs, inv, mode=mode, impl=impl)


ell_cheb_filter_bf16.launches = 0
ell_cheb_filter_bf16.steps = 0


def ell_cheb_moments_plain(data, sk: Skeleton, v0, inv: float, order: int):
    """Plain version of :func:`ell_cheb_moments`: the per-step recursion of
    :func:`~bodge_tpu_torch.ops.cuda_spmm.ell_cheb_step_plain` with its column
    sums (any device, complex64 or complex128, either operator form), the
    operator brought into the batched product's form once a sweep, as the
    kernel stages it once.  ``[order, K]`` real moments."""
    order = int(order)
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    A = batched_operator(ck.operator_values(data, v0.dtype), sk)

    def step(t_cur, t_prev, scale, out):
        return ck.cheb_tail_plain(spmm_batched(A, sk, t_cur), t_cur, t_prev, scale)

    return ck.moment_recursion(step, v0, inv, order)


def ell_cheb_moments(data, sk: Skeleton, v0, inv: float, order: int, *, mode: Optional[str] = None,
                     impl: Optional[str] = None):
    """KPM moments ``μ_m[k] = Re⟨v0_k|T_m(inv·H)|v0_k⟩``, ``[order, K]``
    float32, in one launch of the moment kernel.

    The same recursion and result as
    :func:`~bodge_tpu_torch.ops.cuda_spmm.moments_fused` on the general step:
    ``1 + ceil((order − 2) / 2)`` fused steps (one for ``order`` ≤ 2), then
    one sum of the partials over the grid and the doubled-moment assembly.
    ``mode`` forces ``"registers"`` or ``"global"`` (:func:`moments_plan`;
    ``None`` lets the plan choose, and raises where it answers
    ``"per_step"``).  On a CUDA tensor this launches the kernel or raises
    (refused launch, a grid larger than the card holds); on a CPU tensor, or
    with ``impl="plain"``, it runs :func:`ell_cheb_moments_plain`.  ``data``
    in the bf16 form launches the bf16 instantiation, counted as
    :func:`ell_cheb_moments_bf16`."""
    order = int(order)
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if ck._resolve(impl, v0) == "plain":
        return ell_cheb_moments_plain(data, sk, v0, inv, order)
    N, S, K, bf16 = ck._check_forward(data, sk, v0)
    plan = moments_plan(N, K, S, order, bf16=bf16, mode=mode, sms=ck.sm_count())
    steps = plan["steps"]
    partials = torch.empty((steps, plan["grid"], 2 * K), dtype=torch.float32, device=v0.device)
    _launch_sweep(
        ell_cheb_moments_bf16 if bf16 else ell_cheb_moments, "moment", plan, v0, S, K, bf16, steps,
        lambda p0, p1, stream: ck._library().ell_cheb_moments_launch(
            data.data_ptr(), int(bf16), sk.device_cols(v0.device).data_ptr(), v0.data_ptr(), steps, float(inv),
            p0, p1, partials.data_ptr(), N, S, K, plan["sites_per_block"], int(plan["mode"] == "registers"),
            stream))
    return ck.moments_from_sums(partials.sum(dim=1), K, order)


ell_cheb_moments.launches = 0
ell_cheb_moments.steps = 0


def ell_cheb_moments_bf16(data, sk: Skeleton, v0, inv: float, order: int, *, mode: Optional[str] = None,
                          impl: Optional[str] = None):
    """:func:`ell_cheb_moments` with the operator in the bf16 form, which it requires."""
    ck._require_bf16(data, "ell_cheb_moments_bf16")
    return ell_cheb_moments(data, sk, v0, inv, order, mode=mode, impl=impl)


ell_cheb_moments_bf16.launches = 0
ell_cheb_moments_bf16.steps = 0


def _iterations(iters) -> int:
    iters = int(iters)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    return iters


def ell_power_iteration_plain(data, sk: Skeleton, v, iters: int):
    """Plain version of :func:`ell_power_iteration`: the per-step loop of
    :func:`~bodge_tpu_torch.ops.cuda_spmm.power_recursion` (the reference's
    ``_power_iteration``) on the batched product (any device, complex64 or
    complex128), the operator brought into the batched product's form once, as
    the kernel stages it once.  A 0-d real tensor."""
    iters = _iterations(iters)
    A = batched_operator(ck.operator_values(data, v.dtype), sk)
    return ck.power_recursion(lambda w: spmm_batched(A, sk, w), v, iters)


def ell_power_iteration(data, sk: Skeleton, v, iters: int, *, mode: Optional[str] = None,
                        impl: Optional[str] = None):
    """``‖H w‖`` after ``iters`` normalised applications of the operator to
    ``v`` ``[N, 4, 1]`` (:func:`~bodge_tpu_torch.ops.cuda_spmm.power_recursion`'s
    result, the reference's ``norms[-1]``), a 0-d float32 tensor, in one launch
    of the power kernel.

    ``v`` is normalised on the device first; the kernel then runs every step,
    and the last norm is the square root of one sum of its last partials row.
    ``mode`` forces ``"registers"`` or ``"global"`` (:func:`power_plan`;
    ``None`` lets the plan choose, and raises where it answers
    ``"per_step"``).  On a CUDA tensor this launches the kernel or raises
    (refused launch, a grid larger than the card holds, an operator in the
    bf16 form); on a CPU tensor, or with ``impl="plain"``, it runs
    :func:`ell_power_iteration_plain`."""
    iters = _iterations(iters)
    if ck._resolve(impl, v) == "plain":
        return ell_power_iteration_plain(data, sk, v, iters)
    N, S, K = ck._check_call(data, sk, v)
    if K != 1:
        raise ValueError(f"ell_power_iteration takes one column, got K = {K}")
    plan = power_plan(N, S, iters, mode=mode, sms=ck.sm_count())
    v = v / torch.linalg.norm(v)
    partials = torch.empty((iters, plan["grid"]), dtype=torch.float32, device=v.device)
    _launch_sweep(
        ell_power_iteration, "power", plan, v, S, 1, False, iters,
        lambda p0, p1, stream: ck._library().ell_power_iteration_launch(
            data.data_ptr(), sk.device_cols(v.device).data_ptr(), v.data_ptr(), iters, p0, p1,
            partials.data_ptr(), N, S, plan["sites_per_block"], stream))
    return partials[-1].sum().sqrt()


ell_power_iteration.launches = 0
ell_power_iteration.steps = 0
