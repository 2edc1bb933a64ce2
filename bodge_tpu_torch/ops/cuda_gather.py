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

Both are CUDA C++ in ``csrc/ell_gather.cu`` (replacing ``_gather_kernel``
under ``spmm_gather_packed``, ``pallas_gather.py:261``): one thread block per
SM and column tile (``TK`` probe columns) walks a run of ``run`` relabelled
rows in tiles of ``T``; the window ``[a − bwb, a + T + bwb)`` of vector rows
slides through a ring in shared memory, the rows of the next ``depth`` tiles
copied in by ``cp.async`` while a tile is computed, and each thread finds its
neighbours there through a per-(site, slot) offset ``rel[n, s] = column − n``
(int32 in ``[−bwb, bwb]``; :data:`PAD_REL` marks a padding slot).  What bounds
them: bytes — the operator, the offsets (in place of ``cols``) and the vectors
once; a block copies its run and ``2·bwb`` rows once, so each vector row
crosses from L2 to the SMs about ``1 + 2·bwb/run`` times instead of ``S``.

Order.  Everything these functions take — ``data``, vectors, partial sums —
is in *relabelled* order: relabelled row ``r`` holds original site
``layout.inv_rank[r]``.  A sweep relabels once (:meth:`GatherLayout.relabel`)
and stays there; inner products are invariant under the permutation, so the
moments need no way back, and vectors return through
:meth:`GatherLayout.restore`.  ``layout.sk`` is the relabelled skeleton
(``cols`` and the per-row ``trans_slot`` permuted consistently; the slot order
within a row is unchanged), which the backward kernels
(:func:`~bodge_tpu_torch.ops.cuda_spmm.ell_spmm_adjoint`,
:func:`~bodge_tpu_torch.ops.cuda_spmm.ell_block_outer`) take as it is.

:func:`plan_gather` picks ``TK``, ``T``, the depth, the run and the thread
count so that the ring fits the 227 KB of shared memory a block may use; it
returns ``None`` when not even the window at ``TK = 1`` fits.  The wrappers launch their kernel on
a CUDA tensor or raise; the plain versions run only for a CPU tensor or on
``impl="plain"``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import cuda_spmm as ck
from .blocksparse import BLOCK, Skeleton

PAD_REL = -(2**31)  # rel entry of a padding slot (INT_MIN in the kernel)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
TREE_BYTES = 8192  # room the feasibility rule keeps beside the window (2 × 1024 floats)
MIN_TILE = 32
MAX_WINDOW_TK = 8  # probe columns per window; more columns go to gridDim.y
THREADS = 1024  # threads a block at most: one block an SM
MAX_DEPTH = 2  # tiles in flight at most (MAX_DEPTH in the kernel)


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
        threads: threads a block.
        smem_bytes: the ring's shared memory, ``ring`` rows.
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

    @property
    def window(self) -> int:
        """Rows one tile reads: ``T + 2·bwb``."""
        return self.T + 2 * self.bwb

    @property
    def ring(self) -> int:
        """Rows of the ring in shared memory: the window and the tiles in flight."""
        return 2 * self.bwb + (self.depth + 1) * self.T

    def device_rel(self, device):
        return self.sk._device_copy("gather_rel", device, lambda: self.rel)

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


def _launch_plan(N: int, bwb: int, K: int, tile=None):
    """``(T, TK, depth, run, ctas, threads, smem_bytes)`` or ``None`` when no
    window fits.

    TK is the widest (at most :data:`MAX_WINDOW_TK`) whose window fits with
    ``T = MIN_TILE`` (or the forced ``T``), by the rule of :func:`_feasible`.
    Then ``T`` is a block's ``1024 / TK`` rows of sites with one or two tiles
    in flight (``depth``) where that fits, else the largest ``T`` with one in
    flight, else the window alone (``depth = 0``).  The run gives every
    SM one block: ``run = max(T, ceil(N / (sms // column tiles)))``.
    ``tile`` forces ``T``, or ``(T, run)`` both.
    """
    T_forced, run_forced = (tile, None) if tile is None or isinstance(tile, int) else tuple(tile)
    tk_cap = min(ck.probe_tile(K), MAX_WINDOW_TK)
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
        blocks = max(1, ck.sm_count() // -(-K // TK))
        run = max(T, -(-N // blocks)) if run_forced is None else int(run_forced)
        ring = 2 * bwb + (depth + 1) * T
        return T, TK, depth, run, -(-N // run), threads, ring * site
    return None


def _layout(sk: Skeleton, K: int, relabelled, tile) -> Optional[GatherLayout]:
    rank, inv_rank, bwb, sk_r, rel = relabelled
    launch = _launch_plan(sk.n_sites, bwb, K, tile)
    if launch is None:
        return None
    T, TK, depth, run, ctas, threads, smem = launch
    return GatherLayout(sk=sk_r, source=sk, rank=rank, inv_rank=inv_rank, bwb=bwb, rel=rel, K=K, T=T, TK=TK,
                        depth=depth, run=run, ctas=ctas, threads=threads, smem_bytes=smem)


@functools.lru_cache(maxsize=256)
def plan_gather(sk: Skeleton, K: int, tile: Optional[int] = None) -> Optional[GatherLayout]:
    """Gather-kernel plan for ``K`` probe columns, or ``None`` when the window
    of ``T + 2·bwb`` sites does not fit shared memory even at ``TK = 1``.

    ``tile`` forces ``T``, or ``(T, run)`` (for measurements).  Plans are cached per
    ``(skeleton, K, tile)``, and every plan of one skeleton shares the
    relabelled skeleton, so device copies are made once.
    """
    if sk.n_sites < 1 or K < 1:
        return None
    return _layout(sk, int(K), _rcm_relabelled(sk), tile)


def layout_from_rank(sk: Skeleton, rank, bwb: int, K: int, tile=None):
    """A :class:`GatherLayout` on a relabelling computed elsewhere (``rank[i]`` =
    new index of site ``i``, ``bwb`` its block bandwidth), or ``None`` when no
    window fits.  Raises ``ValueError`` if a neighbour lies outside the band."""
    return _layout(sk, int(K), _relabelled(sk, rank, bwb), tile)


def supported_gather(sk: Skeleton, K: int = 4) -> bool:
    return plan_gather(sk, K) is not None


# --------------------------------------------------------------------------
# Plain PyTorch versions (any device, complex64 or complex128), relabelled order.
# --------------------------------------------------------------------------
def ell_gather_spmm_plain(data, gl: GatherLayout, v):
    """Plain version of :func:`ell_gather_spmm`: the neighbours are the rows
    ``n + rel[n, s]``, resolved by indexing; padding slots contribute nothing."""
    gathered = v[gl.device_window_index(v.device)]  # [N, S, 4, K]
    data = ck.operator_values(data, v.dtype)
    if gl.sk.has_padding:
        data = data * gl.sk.device_valid(v.device)[..., None, None]
    N, S = gl.sk.cols.shape
    return torch.bmm(data.transpose(1, 2).reshape(N, BLOCK, S * BLOCK), gathered.reshape(N, S * BLOCK, -1))


def ell_gather_cheb_step_plain(data, gl: GatherLayout, t_cur, t_prev, inv: float, sums: bool = True):
    """Plain version of :func:`ell_gather_cheb_step`: ``(t_next, partials[1, 2K])``."""
    return ck.cheb_tail_plain(ell_gather_spmm_plain(data, gl, t_cur), t_cur, t_prev, inv, sums)


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
    instantiation, counted as :func:`ell_gather_spmm_bf16`).  On a CPU
    tensor, or with ``impl="plain"``, it is :func:`ell_gather_spmm_plain`.
    """
    _check_layout(gl)
    if ck._resolve(impl, v) == "plain":
        return ell_gather_spmm_plain(data, gl, v)
    N, S, K, bf16 = ck._check_forward(data, gl.sk, v)
    rel = gl.device_rel(v.device)
    y = torch.empty_like(v)
    lib = ck._library()
    with torch.cuda.device(v.device):
        err = lib.ell_gather_spmm_launch(
            data.data_ptr(), int(bf16), rel.data_ptr(), v.data_ptr(), y.data_ptr(), N, S, K, gl.TK, gl.T,
            gl.bwb, gl.depth, gl.run, gl.ctas, gl.threads, torch.cuda.current_stream().cuda_stream,
        )
    ck._raise_on(err, "ell_gather_spmm_bf16" if bf16 else "ell_gather_spmm")
    (ell_gather_spmm_bf16 if bf16 else ell_gather_spmm).launches += 1
    return y


ell_gather_spmm.launches = 0


def ell_gather_spmm_bf16(data, gl: GatherLayout, v, *, impl: Optional[str] = None):
    """:func:`ell_gather_spmm` with the operator in the bf16 form, which it requires."""
    ck._require_bf16(data, "ell_gather_spmm_bf16")
    return ell_gather_spmm(data, gl, v, impl=impl)


ell_gather_spmm_bf16.launches = 0


def ell_gather_cheb_step(
    data, gl: GatherLayout, t_cur, t_prev, inv: float, *, out=None, impl: Optional[str] = None
):
    """Fused Chebyshev step in relabelled order: ``(t_next, partials)`` as
    :func:`~bodge_tpu_torch.ops.cuda_spmm.ell_cheb_step`, with one row of
    partials per thread block (``gl.ctas`` rows).  ``out`` (kernel only) may be
    ``t_prev`` itself, never ``t_cur``.  ``data`` in the bf16 form launches
    the bf16 instantiation, counted as :func:`ell_gather_cheb_step_bf16`.
    """
    _check_layout(gl)
    if ck._resolve(impl, t_cur) == "plain":
        return ell_gather_cheb_step_plain(data, gl, t_cur, t_prev, inv)
    N, S, K, bf16 = ck._check_forward(data, gl.sk, t_cur)
    shape = (N, BLOCK, K)
    if t_prev is not None:
        ck._check_operand("t_prev", t_prev, shape, t_cur.device)
    if out is None:
        out = torch.empty_like(t_cur)
    else:
        ck._check_operand("out", out, shape, t_cur.device)
    if out.untyped_storage().data_ptr() == t_cur.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with t_cur (other thread blocks stage it)")
    rel = gl.device_rel(t_cur.device)
    partials = torch.empty((gl.ctas, 2 * K), dtype=torch.float32, device=t_cur.device)
    lib = ck._library()
    with torch.cuda.device(t_cur.device):
        err = lib.ell_gather_cheb_step_launch(
            data.data_ptr(), int(bf16), rel.data_ptr(), t_cur.data_ptr(), ck._ptr(t_prev), out.data_ptr(),
            partials.data_ptr(), float(inv), N, S, K, gl.TK, gl.T, gl.bwb, gl.depth, gl.run, gl.ctas,
            gl.threads, torch.cuda.current_stream().cuda_stream,
        )
    ck._raise_on(err, "ell_gather_cheb_step_bf16" if bf16 else "ell_gather_cheb_step")
    (ell_gather_cheb_step_bf16 if bf16 else ell_gather_cheb_step).launches += 1
    return out, partials


ell_gather_cheb_step.launches = 0


def ell_gather_cheb_step_bf16(data, gl: GatherLayout, t_cur, t_prev, inv: float, *, out=None,
                              impl: Optional[str] = None):
    """:func:`ell_gather_cheb_step` with the operator in the bf16 form, which it requires."""
    ck._require_bf16(data, "ell_gather_cheb_step_bf16")
    return ell_gather_cheb_step(data, gl, t_cur, t_prev, inv, out=out, impl=impl)


ell_gather_cheb_step_bf16.launches = 0


# --------------------------------------------------------------------------
# The moment sweep on the gather step.
# --------------------------------------------------------------------------
def _gather_impl(impl: Optional[str], tensor) -> str:
    return {"cuda": "cuda_gather", "plain": "plain_gather"}[ck._resolve(impl, tensor)]


def moments_gather(data, sk: Skeleton, v0, inv: float, order: int, *, impl: Optional[str] = None):
    """KPM moments ``[order, K]`` of a generic skeleton through the gather step.

    The counterpart of ``moments_gather_packed``: ``data`` and ``v0`` come in
    the original site order, are relabelled once, and the doubled-moment
    recursion (:func:`~bodge_tpu_torch.ops.cuda_spmm.moments_fused`: three
    vector buffers, one fused launch per step) runs in relabelled order.
    ``impl``: ``None`` / ``"cuda"`` (kernel, CUDA tensors) or ``"plain"``.
    Raises ``ValueError`` when no plan is feasible.
    """
    return ck.moments_fused(data, sk, v0, inv, order, impl=_gather_impl(impl, v0))


def moments_gather_ad(data, sk: Skeleton, v0, inv: float, order: int, *, impl: Optional[str] = None):
    """Differentiable :func:`moments_gather`: the gather step forward, the
    adjoint-product and block-outer-product kernels backward on the
    relabelled skeleton (the counterpart of ``spmm_gather_packed_ad`` under
    ``moments_gather_packed``); the relabelling itself is an indexed copy that
    ``torch.autograd`` differentiates."""
    return ck.moments_fused_ad(data, sk, v0, inv, order, impl=_gather_impl(impl, v0))
