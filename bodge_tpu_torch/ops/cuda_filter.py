"""The Chebyshev filter sweep in one launch, with its plain version.

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


def _site_bytes(S: int, bf16: bool) -> int:
    """Shared memory a staged site takes: its S blocks (8 float4 each, 4 uint4
    in the bf16 form), a 16-byte pad, and its S column indices."""
    return (S * (4 if bf16 else 8) + 1) * 16 + 4 * S


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
    N, K, S = int(N), int(K), int(S)
    if N < 1 or K < 1 or S < 1:
        raise ValueError(f"filter_plan needs N, K, S >= 1, got {N}, {K}, {S}")
    if mode not in (None, *MODES):
        raise ValueError(f"mode {mode!r}: None, 'registers' or 'global'")
    sms = ck.sm_count() if sms is None else int(sms)
    slots = FILTER_BLOCKS_PER_SM * sms
    most = FILTER_SMEM_CAP // _site_bytes(S, bf16)  # sites a block may stage
    fits = {}
    if K <= FILTER_THREADS:
        sb = min(FILTER_THREADS // K, -(-N // sms), most)
        if -(-N // sb) <= slots:
            fits["registers"] = sb
    sb = -(-N // slots)
    if sb <= most:
        fits["global"] = sb
    if mode is None:
        mode = next((m for m in MODES if m in fits), "per_step")
    elif mode not in fits:
        raise ValueError(f"the filter kernel's {mode} mode does not fit N = {N}, K = {K}, S = {S} "
                         f"on {sms} SMs ({slots} blocks of {FILTER_THREADS} threads, {most} sites a block)")
    if mode == "per_step":
        return {"mode": mode, "grid": 0, "threads": 0, "sites_per_block": 0, "pairs_per_thread": 0,
                "smem_bytes": 0, "lanes_used": 0.0}
    sb = fits[mode]
    grid = -(-N // sb)
    per_thread = -(-sb * K // FILTER_THREADS)
    return {"mode": mode, "grid": grid, "threads": FILTER_THREADS, "sites_per_block": sb,
            "pairs_per_thread": per_thread, "smem_bytes": sb * _site_bytes(S, bf16),
            "lanes_used": N * K / (grid * FILTER_THREADS * per_thread)}


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
def _occupancy(device: int, bf16: bool, registers: bool, sb: int, S: int) -> int:
    blocks, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = ck._library().ell_cheb_filter_occupancy(int(bf16), int(registers), sb, S, ctypes.byref(blocks),
                                                      ctypes.byref(smem))
    ck._raise_on(err, "ell_cheb_filter_occupancy")
    return blocks.value


def filter_occupancy(plan: dict, S: int, *, bf16: bool = False) -> int:
    """Blocks of the plan's kernel one SM of the current card holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the plan's shared
    memory): what :func:`filter_plan` assumes to be :data:`FILTER_BLOCKS_PER_SM`."""
    return _occupancy(torch.cuda.current_device(), bool(bf16), plan["mode"] == "registers",
                      plan["sites_per_block"], int(S))


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
    if plan["mode"] == "per_step":
        raise ValueError(f"no plan of the filter kernel fits N = {N}, K = {K}, S = {S} "
                         "(filter_sweep runs the per-step path there)")
    with torch.cuda.device(v.device):
        held = filter_occupancy(plan, S, bf16=bf16) * ck.sm_count()
        if plan["grid"] > held:
            raise RuntimeError(f"ell_cheb_filter: the plan's {plan['grid']} blocks exceed the {held} the card "
                               f"holds at once ({FILTER_BLOCKS_PER_SM} an SM assumed)")
        c = torch.tensor(coeffs, dtype=torch.float32).to(v.device)
        y = torch.empty_like(v)
        scratch = torch.empty((2, *v.shape), dtype=v.dtype, device=v.device)
        err = ck._library().ell_cheb_filter_launch(
            data.data_ptr(), int(bf16), sk.device_cols(v.device).data_ptr(), v.data_ptr(), c.data_ptr(),
            len(coeffs), float(inv), scratch[0].data_ptr(), scratch[1].data_ptr(), y.data_ptr(),
            N, S, K, plan["sites_per_block"], int(plan["mode"] == "registers"),
            torch.cuda.current_stream().cuda_stream,
        )
    counter = ell_cheb_filter_bf16 if bf16 else ell_cheb_filter
    ck._raise_on(err, counter.__name__)
    counter.launches += 1
    counter.steps += len(coeffs) - 1
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
