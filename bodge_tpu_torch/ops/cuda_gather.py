"""Windowed CUDA kernels for generic (non-stencil) skeletons, with their plain versions.

The counterpart of ``bodge_tpu/ops/pallas_gather.py``.  A user-defined
lattice has no stencil structure, so its product is a true gather.  The
reference relabels the sites by reverse Cuthill–McKee
(:func:`~bodge_tpu_torch.ops.banded.block_permutation`, shared with the banded
eigensolver) so that every neighbour lies within ``bwb`` rows of its row, and
then reads a *window* of vector rows per tile of sites from fast memory.  The
port keeps that idea and drops the TPU's way of gathering (a one-hot matrix
product):

- :func:`ell_gather_spmm` — ``y = H v`` in relabelled order.
- :func:`ell_gather_cheb_step` — the fused Chebyshev step
  ``t_next = 2·inv·(H t_cur) − t_prev`` with per-thread-block partial sums of
  ``Re⟨t_cur,t_cur⟩`` and ``Re⟨t_next,t_cur⟩`` per probe column.
- :func:`ell_gather_cheb_step_window` — the same step on a range of
  relabelled rows, the light-cone form of a sweep from probes on a few sites.

All are CUDA C++ in ``csrc/ell_gather.cu`` (replacing ``_gather_kernel``
under ``spmm_gather_packed``, ``pallas_gather.py:261``): each run of ``run``
relabelled rows and each column tile has one SM, which walks the run in tiles
of ``T``; the window ``[a − bwb, a + T + bwb)`` of vector rows slides through
a ring in shared memory, the rows of the next ``depth`` tiles copied in while
a tile is computed, and each thread finds its neighbours there through a
per-(site, slot) offset ``rel[n, s] = column − n`` (int32 in ``[−bwb, bwb]``;
:data:`PAD_REL` marks a padding slot).  Two forms (``layout.cluster``): one
thread block a run with ``TK`` probe columns, the operator read from device
memory (the complex64 operator's plan); or, for the bf16 operator where it
fits, a cluster of two blocks that split ``2·TK`` columns, the room the
halved ring rows free holding ``depth + 1`` stages of a tile's operator rows
(multicast to both blocks by bulk copies) and offsets, filled by a producer
warp ahead of the consumers.  What bounds them: bytes — the operator, the
offsets (in place of ``cols``) and the vectors once; a run copies its rows
and ``2·bwb`` more once, so each vector row crosses from L2 to the SMs about
``1 + 2·bwb/run`` times instead of ``S`` — and, in the one-block form, the
chain of round trips a tile takes to read its operator.

Order.  Everything these functions take — ``data``, vectors, partial sums —
is in *relabelled* order: relabelled row ``r`` holds original site
``layout.inv_rank[r]``.  A sweep relabels once (:meth:`GatherLayout.relabel`)
and stays there; inner products are invariant under the permutation, so the
moments need no way back, and vectors return through
:meth:`GatherLayout.restore`.  ``layout.sk`` is the relabelled skeleton
(``cols`` and the per-row ``trans_slot`` permuted consistently; the slot order
within a row is unchanged), which the backward kernels
(:func:`~bodge_tpu_torch.ops.cuda_ell.ell_spmm_adjoint`,
:func:`~bodge_tpu_torch.ops.cuda_ell.ell_block_outer`) take as it is.

:func:`plan_gather` picks ``TK``, ``T``, the depth, the run and the thread
count so that the ring fits the 227 KB of shared memory a block may use; it
returns ``None`` when not even the window at ``TK = 1`` fits.  The wrappers launch their kernel on
a CUDA tensor or raise; the plain versions run only for a CPU tensor or on
``impl="plain"``.

Tracing.  A plan built (a miss of :func:`plan_gather`'s cache: the RCM
relabelling on a skeleton's first plan, and the window plan) runs inside the
span :data:`PLAN_SPAN`; :class:`~bodge_tpu_torch.ops.cuda_spmm.StepPlan`'s
relabelling of the operator and the vectors, and its way back, inside
:data:`RELABEL_SPAN` (:func:`bodge_tpu_torch.utils.trace.annotate`).
:func:`gather_counts` counts all three; they are copies and host work, not
launches, so :func:`~bodge_tpu_torch.ops.cuda_spmm.launch_counts` leaves them out.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.trace import annotate
from . import cuda_ell as ce
from .blocksparse import BLOCK, Skeleton

PAD_REL = -(2**31)  # rel entry of a padding slot (INT_MIN in the kernel)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
TREE_BYTES = 8192  # room the feasibility rule keeps beside the window (2 × 1024 floats)
MIN_TILE = 32
MAX_WINDOW_TK = 8  # probe columns per window; more columns go to gridDim.y
THREADS = 1024  # threads a block at most: one block an SM
MAX_DEPTH = 2  # tiles in flight at most (MAX_DEPTH in the kernel)
CLUSTER_CONSUMERS = 512  # consumer threads a block of the cluster form at most (beside a producer warp)
CLUSTER_MIN_TILE = 64  # rows a tile of the cluster form at least, unless forced
CLUSTER_STAGES = 3  # operator stages of the cluster form (depth + 1) where a forced tile names none
BF16_BLOCK_BYTES = 64  # a 4x4 block in the bf16 form
PLAN_SPAN = "bodge.gather.plan"
RELABEL_SPAN = "bodge.gather.relabel"

_counts = {"plans": 0, "operator_relabels": 0, "vector_relabels": 0}


def gather_counts() -> dict:
    """``{"plans": …, "operator_relabels": …, "vector_relabels": …}`` since the
    last :func:`reset_gather_counts`: the plans :func:`plan_gather` built (its
    cache's misses), and the operators and the vectors (into the sweep's order
    and back) that :class:`~bodge_tpu_torch.ops.cuda_spmm.StepPlan` relabelled
    on the gather path."""
    return dict(_counts)


def reset_gather_counts() -> None:
    for key in _counts:
        _counts[key] = 0


def traced_relabel(move, x, count: str):
    """``move(x)`` — a layout's :meth:`GatherLayout.relabel` or
    :meth:`GatherLayout.restore` — inside :data:`RELABEL_SPAN`, counted as
    ``count`` ("operator_relabels" or "vector_relabels") in :func:`gather_counts`."""
    _counts[count] += 1
    with annotate(RELABEL_SPAN):
        return move(x)


@dataclass(frozen=True, eq=False)  # identity hash: usable as a cache key
class GatherLayout:
    """Relabelling and launch plan of the gather kernels for one (skeleton, K).

    Attributes:
        sk: the relabelled skeleton (generic, ``trans_slot`` per row).
        source: the skeleton the layout was planned for.
        rank: ``[N]`` int64 — new index of each original site.
        inv_rank: ``[N]`` int64 — original site held by each relabelled row.
        bwb: block bandwidth after relabelling.
        rel: ``[N, S]`` int32 — ``column − row`` per slot in relabelled order,
            :data:`PAD_REL` for padding slots.
        K, TK: probe columns, and probe columns a thread block.
        T: rows a tile; a thread block computes one tile at a time.
        depth: tiles in flight while one is computed (0: none).
        run: relabelled rows a thread block walks, ``ctas`` blocks a column
            tile (``ceil(N / run)``: one wave, a block an SM).
        threads: threads a block (the cluster form: its consumers, beside
            one producer warp).
        smem_bytes: the block's shared memory: the ring of ``ring`` rows
            (and, in the cluster form, the stages and their barriers).
        cluster: 1 (one block a run, ``TK`` columns) or 2 (a pair of
            blocks a run, ``TK`` columns each, the operator staged).
        stage_bytes: bytes of one stage of the cluster form (a tile's
            operator rows and offsets; ``depth + 1`` stages); 0 otherwise.
            The cluster form takes the operator in the bf16 form only.
    """

    sk: Skeleton
    source: Skeleton
    rank: np.ndarray
    inv_rank: np.ndarray
    bwb: int
    rel: np.ndarray
    K: int
    T: int
    TK: int
    depth: int
    run: int
    ctas: int
    threads: int
    smem_bytes: int
    cluster: int = 1
    stage_bytes: int = 0

    @property
    def window(self) -> int:
        """Rows one tile reads: ``T + 2·bwb``."""
        return self.T + 2 * self.bwb

    @property
    def ring(self) -> int:
        """Rows of the ring in shared memory: the window and the tiles in flight."""
        return 2 * self.bwb + (self.depth + 1) * self.T

    def device_rel(self, device):
        """``rel`` on ``device``, its rows padded with :data:`PAD_REL` to a
        multiple of 4 (the cluster form copies a tile's offsets in 16-byte units)."""
        def make():
            pad = -len(self.rel) % 4
            return np.concatenate([self.rel, np.full((pad, self.rel.shape[1]), PAD_REL, dtype=np.int32)])

        return self.sk._device_copy("gather_rel", device, make)

    def device_window_index(self, device):
        """``[N, S]`` int64 rows named by ``rel`` (padding mapped to the row itself)."""

        def make():
            rows = np.arange(self.sk.n_sites, dtype=np.int64)[:, None]
            return rows + np.where(self.rel == PAD_REL, 0, self.rel).astype(np.int64)

        return self.sk._device_copy("gather_window_index", device, make)

    def relabel(self, x):
        """Rows of ``x`` (block data ``[N, S, 4, 4]`` or a vector ``[N, 4, K]``)
        in relabelled order.  Differentiable."""
        idx = self.sk._device_copy("gather_inv_rank", x.device, lambda: self.inv_rank)
        return x.index_select(0, idx)

    def restore(self, y):
        """Inverse of :meth:`relabel`: rows back in the original site order."""
        idx = self.sk._device_copy("gather_rank", y.device, lambda: self.rank)
        return y.index_select(0, idx)


def _relabelled(sk: Skeleton, rank: np.ndarray, bwb: int):
    """``(rank, inv_rank, bwb, relabelled skeleton, rel)`` for a given relabelling."""
    N, S = sk.cols.shape
    rank = np.asarray(rank, dtype=np.int64)
    inv_rank = np.empty(N, dtype=np.int64)
    inv_rank[rank] = np.arange(N, dtype=np.int64)
    cols = sk.cols[inv_rank]  # row r = original site inv_rank[r]
    valid = cols >= 0
    cols_r = np.where(valid, rank[np.where(valid, cols, 0)], -1).astype(np.int32)
    # trans_slot names a slot of the partner's row; rows move, slots do not.
    trans_r = np.ascontiguousarray(np.broadcast_to(sk.trans_slot, sk.cols.shape)[inv_rank], dtype=np.int32)
    rel = np.where(valid, cols_r.astype(np.int64) - np.arange(N, dtype=np.int64)[:, None], PAD_REL)
    if valid.any() and np.abs(rel[valid]).max() > bwb:
        raise ValueError("the relabelling does not keep every neighbour within bwb rows")
    sk_r = Skeleton(
        shape=(N, 1, 1), slots=(), cols=cols_r, trans_slot=trans_r,
        nnz_blocks=sk.nnz_blocks, stencil=False,
    )
    return rank, inv_rank, int(bwb), sk_r, rel.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _rcm_relabelled(sk: Skeleton):
    from .banded import block_permutation

    rank, bwb = block_permutation(sk)
    return _relabelled(sk, rank, bwb)


def _site_bytes(TK: int, K: int) -> int:
    """Shared memory a ring row: 4·TK float2 and the bank padding (2 with
    16-byte copies, where K and TK are even, else 1)."""
    return (BLOCK * TK + (2 if TK % 2 == 0 and K % 2 == 0 else 1)) * 8


def _feasible(bwb: int, TK: int, T: int) -> bool:
    """Whether a window of ``T + 2·bwb`` rows at 8·(4·TK + 2) bytes fits
    beside 8 KB.  :func:`supported_gather`, and with it the step's dispatch,
    answers by this rule alone, whatever ring the plan then builds."""
    return T <= (SMEM_LIMIT - TREE_BYTES) // ((BLOCK * TK + 2) * 8) - 2 * bwb


class LaunchPlan(tuple):
    """``(T, TK, depth, run, ctas, threads, smem_bytes)``, with ``cluster``
    (1 or 2) and ``stage_bytes`` beside the tuple."""

    def __new__(cls, values, cluster: int = 1, stage_bytes: int = 0):
        plan = super().__new__(cls, values)
        plan.cluster, plan.stage_bytes = cluster, stage_bytes
        return plan


def _cluster_smem(bwb: int, TK: int, K: int, T: int, stages: int, slots: int) -> int:
    """Shared memory of a block of the cluster form (the kernel's layout):
    the ring, ``stages`` stages of a tile's bf16 operator rows and offsets,
    then two mbarriers a stage."""
    round16 = lambda v: -(-v // 16) * 16
    rel_off = round16((2 * bwb + stages * T) * _site_bytes(TK, K)) + stages * T * slots * BF16_BLOCK_BYTES
    return round16(rel_off + stages * T * slots * 4) + 16 * stages


def _cluster_plan(N: int, bwb: int, K: int, slots: int, tile=None):
    """The cluster form's :class:`LaunchPlan` for a bf16 operator, or ``None``
    where it does not apply (``K = 1``: no columns to split) or does not fit.

    The pair splits a column tile of ``min(probe_tile(K), 8)`` columns, ``TK``
    each.  For 3 and for 2 stages, ``T`` is the largest multiple of 32 up to
    ``512 / TK`` (or the lattice, rounded up to 32) whose ring and stages
    fit, at least :data:`CLUSTER_MIN_TILE` (shorter tiles lose to the
    one-block form); of the two the plan with more rows in flight,
    ``(stages − 1)·T``, wins, a tie to the longer tile.  ``tile``
    forces ``T``, ``(T, run)`` or ``(T, run, stages)`` (``run`` ``None``:
    planned; :data:`CLUSTER_STAGES` stages unless given), each a multiple of
    4 rows.  ``threads`` counts the consumers.  Runs: one pair for every two
    SMs, rounded up to a multiple of 4 rows.
    """
    forced = (tile,) if isinstance(tile, int) else tuple(tile or ())
    T_forced, run_forced, stages_forced = (forced + (None, None, None))[:3]
    tkc = min(ce.probe_tile(K), MAX_WINDOW_TK)
    if tkc < 2:
        return None
    TK = tkc // 2
    fits = lambda T, stages: _cluster_smem(bwb, TK, K, T, stages, slots) <= SMEM_LIMIT
    if T_forced is not None:
        T, stages = int(T_forced), stages_forced or CLUSTER_STAGES
        if T % 4 or (run_forced is not None and run_forced % 4) or not fits(T, stages):
            return None
    else:
        plans = []
        for stages in (3, 2):
            T = min(CLUSTER_CONSUMERS // TK, max(CLUSTER_MIN_TILE, -(-N // 32) * 32)) // 32 * 32
            while T >= CLUSTER_MIN_TILE and not fits(T, stages):
                T -= 32
            if T >= CLUSTER_MIN_TILE:
                plans.append(((stages - 1) * T, T, stages))
        if not plans:
            return None
        _, T, stages = max(plans)
    threads = min(CLUSTER_CONSUMERS, max(32, 1 << (T * TK - 1).bit_length()))
    pairs = max(1, ce.sm_count() // (2 * -(-K // tkc)))
    run = max(T, -(-N // pairs // 4) * 4) if run_forced is None else int(run_forced)
    return LaunchPlan((T, TK, stages - 1, run, -(-N // run), threads, _cluster_smem(bwb, TK, K, T, stages, slots)),
                      cluster=2, stage_bytes=T * slots * (BF16_BLOCK_BYTES + 4))


def _launch_plan(N: int, bwb: int, K: int, tile=None, operator_dtype=None, slots: int = 0):
    """A :class:`LaunchPlan` ``(T, TK, depth, run, ctas, threads, smem_bytes)``
    or ``None`` when no window fits.

    For a bf16 ``operator_dtype`` (``slots`` slots a row) the cluster form
    (:func:`_cluster_plan`) where it applies and fits; otherwise, and for
    the complex64 operator, the one-block form, by the rules below.  Whether
    a plan exists at all depends on the one-block rule alone.

    TK is the widest (at most :data:`MAX_WINDOW_TK`) whose window fits with
    ``T = MIN_TILE`` (or the forced ``T``), by the rule of :func:`_feasible`.
    Then ``T`` is a block's ``1024 / TK`` rows of sites with one or two tiles
    in flight (``depth``) where that fits, else the largest ``T`` with one in
    flight, else the window alone (``depth = 0``).  The run gives every
    SM one block: ``run = max(T, ceil(N / (sms // column tiles)))``.
    ``tile`` forces ``T``, or ``(T, run)`` both (``(T, run, stages)``: the
    cluster form's stages too).
    """
    T_forced, run_forced = (tile, None) if tile is None or isinstance(tile, int) else tuple(tile)[:2]
    tk_cap = min(ce.probe_tile(K), MAX_WINDOW_TK)
    for TK in (8, 4, 2, 1):
        if TK > tk_cap or not _feasible(bwb, TK, MIN_TILE if T_forced is None else T_forced):
            continue
        site = _site_bytes(TK, K)
        beyond = SMEM_LIMIT // site - 2 * bwb  # ring rows past the band
        if T_forced is not None:
            T = int(T_forced)
            depth = min(MAX_DEPTH, beyond // T - 1)
        elif beyond >= 2 * (THREADS // TK):
            T = min(THREADS // TK, max(MIN_TILE, -(-N // 32) * 32))  # small lattices: one short tile
            depth = min(MAX_DEPTH, beyond // T - 1)
        elif beyond // 2 >= MIN_TILE:
            T, depth = beyond // 2, 1
        else:
            T, depth = beyond, 0
        threads = min(THREADS, max(32, 1 << (T * TK - 1).bit_length()))
        blocks = max(1, ce.sm_count() // -(-K // TK))
        run = max(T, -(-N // blocks)) if run_forced is None else int(run_forced)
        ring = 2 * bwb + (depth + 1) * T
        if _is_bf16(operator_dtype):
            clustered = _cluster_plan(N, bwb, K, slots, tile)
            if clustered is not None:
                return clustered
        return LaunchPlan((T, TK, depth, run, -(-N // run), threads, ring * site))
    return None


def _is_bf16(operator_dtype) -> bool:
    """Whether ``operator_dtype`` names the bf16 form (``None``: complex64;
    otherwise the names :func:`~bodge_tpu_torch.ops.cuda_ell.resolve_operator_storage` takes)."""
    return operator_dtype is not None and ce.resolve_operator_storage(operator_dtype) is not None


def _layout(sk: Skeleton, K: int, relabelled, tile, bf16: bool) -> Optional[GatherLayout]:
    rank, inv_rank, bwb, sk_r, rel = relabelled
    launch = _launch_plan(sk.n_sites, bwb, K, tile, "bf16" if bf16 else None, sk.n_slots)
    if launch is None:
        return None
    T, TK, depth, run, ctas, threads, smem = launch
    return GatherLayout(sk=sk_r, source=sk, rank=rank, inv_rank=inv_rank, bwb=bwb, rel=rel, K=K, T=T, TK=TK,
                        depth=depth, run=run, ctas=ctas, threads=threads, smem_bytes=smem, cluster=launch.cluster,
                        stage_bytes=launch.stage_bytes)


def plan_gather(sk: Skeleton, K: int, tile: Optional[int] = None, operator_dtype=None) -> Optional[GatherLayout]:
    """Gather-kernel plan for ``K`` probe columns and the operator form
    ``operator_dtype`` (``None``: complex64; ``"bf16"`` / ``torch.bfloat16``:
    the bf16 form, which may take the cluster form), or ``None`` when the
    window of ``T + 2·bwb`` sites does not fit shared memory even at
    ``TK = 1`` — the same answer for either form.

    ``tile`` forces ``T``, ``(T, run)`` or, for the cluster form, ``(T, run,
    stages)`` (for measurements).  Plans are cached per
    ``(skeleton, K, tile, form)``, however the form is named, and every plan
    of one skeleton shares the relabelled skeleton, so device copies are
    made once.
    """
    return _plan(sk, int(K), tile, _is_bf16(operator_dtype))


@functools.lru_cache(maxsize=256)
def _plan(sk: Skeleton, K: int, tile, bf16: bool) -> Optional[GatherLayout]:
    if sk.n_sites < 1 or K < 1:
        return None
    _counts["plans"] += 1
    with annotate(PLAN_SPAN):
        return _layout(sk, K, _rcm_relabelled(sk), tile, bf16)


plan_gather.cache_clear = _plan.cache_clear  # empties the plans' cache


def layout_from_rank(sk: Skeleton, rank, bwb: int, K: int, tile=None):
    """A :class:`GatherLayout` (the complex64 operator's plan) on a relabelling
    computed elsewhere (``rank[i]`` = new index of site ``i``, ``bwb`` its
    block bandwidth), or ``None`` when no window fits.  Raises ``ValueError``
    if a neighbour lies outside the band."""
    return _layout(sk, int(K), _relabelled(sk, rank, bwb), tile, False)


def supported_gather(sk: Skeleton, K: int = 4) -> bool:
    return plan_gather(sk, K) is not None


# --------------------------------------------------------------------------
# Plain PyTorch versions (any device, complex64 or complex128), relabelled order.
# --------------------------------------------------------------------------
def ell_gather_spmm_plain(data, gl: GatherLayout, v):
    """Plain version of :func:`ell_gather_spmm`: the neighbours are the rows
    ``n + rel[n, s]``, resolved by indexing; padding slots contribute nothing."""
    gathered = v[gl.device_window_index(v.device)]  # [N, S, 4, K]
    data = ce.operator_values(data, v.dtype)
    if gl.sk.has_padding:
        data = data * gl.sk.device_valid(v.device)[..., None, None]
    N, S = gl.sk.cols.shape
    return torch.bmm(data.transpose(1, 2).reshape(N, BLOCK, S * BLOCK), gathered.reshape(N, S * BLOCK, -1))


def ell_gather_cheb_step_plain(data, gl: GatherLayout, t_cur, t_prev, inv: float, sums: bool = True):
    """Plain version of :func:`ell_gather_cheb_step`: ``(t_next, partials[1, 2K])``."""
    return ce.cheb_tail_plain(ell_gather_spmm_plain(data, gl, t_cur), t_cur, t_prev, inv, sums)


def ell_gather_cheb_step_window_plain(data, gl: GatherLayout, t_cur, t_prev, inv: float, rows, sums: bool = True):
    """Plain version of :func:`ell_gather_cheb_step_window`: :func:`ell_gather_cheb_step_plain`
    on relabelled rows ``rows = (r0, r1)`` alone, ``t_next`` zero elsewhere."""
    r0, r1 = rows
    gathered = t_cur[gl.device_window_index(t_cur.device)[r0:r1]]  # [rows, S, 4, K]
    data = ce.operator_values(data[r0:r1], t_cur.dtype)
    if gl.sk.has_padding:
        data = data * gl.sk.device_valid(t_cur.device)[r0:r1, :, None, None]
    S = gl.sk.n_slots
    hv = torch.bmm(data.transpose(1, 2).reshape(r1 - r0, BLOCK, S * BLOCK), gathered.reshape(r1 - r0, S * BLOCK, -1))
    return ce.cheb_tail_window_plain(hv, t_cur, t_prev, inv, rows, sums)


# --------------------------------------------------------------------------
# Wrappers.
# --------------------------------------------------------------------------
def _check_layout(gl: GatherLayout):
    if not isinstance(gl, GatherLayout):
        raise TypeError(f"expected a GatherLayout, got {type(gl).__name__}")


def ell_gather_spmm(data, gl: GatherLayout, v, *, impl: Optional[str] = None):
    """``y[n] = Σ_s data[n, s] · v[n + rel[n, s]]`` in relabelled order (padding slots skipped).

    On a CUDA tensor this launches the kernel (complex64, contiguous
    tensors; anything else raises; ``data`` in the bf16 form: the bf16
    instantiation, counted as :func:`ell_gather_spmm_bf16`; a layout in the
    cluster form, ``plan_gather(..., operator_dtype="bf16")``, takes the bf16
    form only and refuses a complex64 operator).  On a CPU
    tensor, or with ``impl="plain"``, it is :func:`ell_gather_spmm_plain`.
    """
    _check_layout(gl)
    if ce._resolve(impl, v) == "plain":
        return ell_gather_spmm_plain(data, gl, v)
    N, S, K, bf16 = ce._check_forward(data, gl.sk, v)
    rel = gl.device_rel(v.device)
    y = torch.empty_like(v)
    lib = ce._library()
    with torch.cuda.device(v.device):
        err = lib.ell_gather_spmm_launch(
            data.data_ptr(), int(bf16), rel.data_ptr(), v.data_ptr(), y.data_ptr(), N, S, K, gl.TK, gl.T,
            gl.bwb, gl.depth, gl.run, gl.ctas, gl.threads, gl.cluster, torch.cuda.current_stream().cuda_stream,
        )
    ce._raise_on(err, "ell_gather_spmm_bf16" if bf16 else "ell_gather_spmm")
    (ell_gather_spmm_bf16 if bf16 else ell_gather_spmm).launches += 1
    return y


ell_gather_spmm.launches = 0


def ell_gather_spmm_bf16(data, gl: GatherLayout, v, *, impl: Optional[str] = None):
    """:func:`ell_gather_spmm` with the operator in the bf16 form, which it requires."""
    ce._require_bf16(data, "ell_gather_spmm_bf16")
    return ell_gather_spmm(data, gl, v, impl=impl)


ell_gather_spmm_bf16.launches = 0


def ell_gather_cheb_step(
    data, gl: GatherLayout, t_cur, t_prev, inv: float, *, out=None, impl: Optional[str] = None
):
    """Fused Chebyshev step in relabelled order: ``(t_next, partials)`` as
    :func:`~bodge_tpu_torch.ops.cuda_ell.ell_cheb_step`, with one row of
    partials per thread block (``gl.ctas`` rows).  ``out`` (kernel only) may be
    ``t_prev`` itself, never ``t_cur``.  ``data`` in the bf16 form launches
    the bf16 instantiation, counted as :func:`ell_gather_cheb_step_bf16`.
    """
    _check_layout(gl)
    if ce._resolve(impl, t_cur) == "plain":
        return ell_gather_cheb_step_plain(data, gl, t_cur, t_prev, inv)
    N, S, K, bf16 = ce._check_forward(data, gl.sk, t_cur)
    shape = (N, BLOCK, K)
    if t_prev is not None:
        ce._check_operand("t_prev", t_prev, shape, t_cur.device)
    if out is None:
        out = torch.empty_like(t_cur)
    else:
        ce._check_operand("out", out, shape, t_cur.device)
    if out.untyped_storage().data_ptr() == t_cur.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with t_cur (other thread blocks stage it)")
    rel = gl.device_rel(t_cur.device)
    partials = torch.empty((gl.ctas, 2 * K), dtype=torch.float32, device=t_cur.device)
    lib = ce._library()
    with torch.cuda.device(t_cur.device):
        err = lib.ell_gather_cheb_step_launch(
            data.data_ptr(), int(bf16), rel.data_ptr(), t_cur.data_ptr(), ce._ptr(t_prev), out.data_ptr(),
            partials.data_ptr(), float(inv), N, S, K, gl.TK, gl.T, gl.bwb, gl.depth, gl.run, gl.ctas,
            gl.threads, gl.cluster, torch.cuda.current_stream().cuda_stream,
        )
    ce._raise_on(err, "ell_gather_cheb_step_bf16" if bf16 else "ell_gather_cheb_step")
    (ell_gather_cheb_step_bf16 if bf16 else ell_gather_cheb_step).launches += 1
    return out, partials


ell_gather_cheb_step.launches = 0


def ell_gather_cheb_step_bf16(data, gl: GatherLayout, t_cur, t_prev, inv: float, *, out=None,
                              impl: Optional[str] = None):
    """:func:`ell_gather_cheb_step` with the operator in the bf16 form, which it requires."""
    ce._require_bf16(data, "ell_gather_cheb_step_bf16")
    return ell_gather_cheb_step(data, gl, t_cur, t_prev, inv, out=out, impl=impl)


ell_gather_cheb_step_bf16.launches = 0


def window_runs(gl: GatherLayout, rows) -> tuple:
    """``(run, ctas)`` of the light-cone step on ``rows = (r0, r1)``: the
    plan's ``gl.ctas`` runs split the range, ``run = max(T, ceil(W / ctas))``
    rows each, so every SM of the plan keeps a run as the range narrows."""
    width = rows[1] - rows[0]
    run = max(gl.T, -(-width // gl.ctas))
    return run, -(-width // run)


def ell_gather_cheb_step_window(data, gl: GatherLayout, t_cur, t_prev, inv: float, rows, *, out=None,
                                impl: Optional[str] = None):
    """:func:`ell_gather_cheb_step` on relabelled rows ``rows = (r0, r1)``
    alone, the light-cone step
    (:class:`~bodge_tpu_torch.ops.cuda_spmm.LightCone`): ``t_next`` is
    written on those rows and nowhere else (``out=None``: a zeroed buffer),
    one row of partials a run (:func:`window_runs`).  The kernel is an
    instantiation of its own of the one-block form; the complex64 operator
    only."""
    _check_layout(gl)
    rows = ce._window_rows(rows, gl.sk.n_sites)
    if ce._resolve(impl, t_cur) == "plain":
        return ell_gather_cheb_step_window_plain(data, gl, t_cur, t_prev, inv, rows)
    N, S, K = ce._check_call(data, gl.sk, t_cur)
    if gl.cluster != 1:
        raise ValueError("the light-cone step takes the one-block form's plan (the complex64 operator's)")
    shape = (N, BLOCK, K)
    if t_prev is not None:
        ce._check_operand("t_prev", t_prev, shape, t_cur.device)
    if out is None:
        out = torch.zeros_like(t_cur)
    else:
        ce._check_operand("out", out, shape, t_cur.device)
    if out.untyped_storage().data_ptr() == t_cur.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with t_cur (other thread blocks stage it)")
    run, ctas = window_runs(gl, rows)
    partials = torch.empty((ctas, 2 * K), dtype=torch.float32, device=t_cur.device)
    with torch.cuda.device(t_cur.device):
        err = ce._library().ell_gather_cheb_step_window_launch(
            data.data_ptr(), gl.device_rel(t_cur.device).data_ptr(), t_cur.data_ptr(), ce._ptr(t_prev),
            out.data_ptr(), partials.data_ptr(), float(inv), N, rows[0], rows[1], S, K, gl.TK, gl.T, gl.bwb,
            gl.depth, run, ctas, gl.threads, torch.cuda.current_stream().cuda_stream,
        )
    ce._raise_on(err, "ell_gather_cheb_step_window")
    ell_gather_cheb_step_window.launches += 1
    return out, partials


ell_gather_cheb_step_window.launches = 0

