"""Block-sparse matrix–vector / matrix–matrix products (SpMM).

Interchangeable implementations of ``y = H @ v`` for the ELL/stencil layout
of :mod:`bodge_tpu_torch.ops.blocksparse`, all on ``torch`` tensors that
live on one device:

- :func:`spmm_stencil` — plain PyTorch.  Every off-diagonal slot is a ±1
  coordinate shift on the cubic lattice, so the product is a 7-point
  (2·dim+1) stencil: circular rolls of the operand along each lattice axis
  followed by batched 4×4 block products.  Circular rolls implement periodic
  wrap-around *exactly* — for open boundaries the wrap blocks are structural
  zeros, so the rolled-in values are annihilated.

- :func:`spmm_gather` — plain PyTorch, layout-agnostic gather + batched
  product; the plain version of the CUDA kernel.

- ``impl="cuda"`` — the hand-written kernel of
  :mod:`bodge_tpu_torch.ops.cuda_spmm` (complex64, CUDA tensors only);
  ``impl="cuda_gather"`` — the windowed kernel of
  :mod:`bodge_tpu_torch.ops.cuda_gather` for generic skeletons.

All treat ``v`` as ``[N, 4, K]`` (K right-hand sides).  :func:`spmm` picks
a kernel for a CUDA tensor (the windowed one on a generic skeleton with a
feasible plan) and the plain version for a CPU tensor; the other
implementations stay forceable for cross-checks.
"""

from __future__ import annotations

from typing import Optional

import torch

from .blocksparse import BLOCK, Skeleton


def spmm_gather(data, sk: Skeleton, v):
    """Gather-based reference SpMM: ``y[i] = Σ_s data[i, s] @ v[cols[i, s]]``.

    Padding slots (``cols = −1``) are read from row 0 and contribute
    nothing, whatever their blocks hold (the kernels skip them), so the
    gradient with respect to a padding block is zero.
    """
    return spmm_batched(batched_operator(data, sk), sk, v)


def batched_operator(data, sk: Skeleton):
    """``data`` as the left factor ``[N, 4, 4S]`` of :func:`spmm_batched`
    (padding blocks zeroed): a caller that multiplies by one operator many
    times forms it once."""
    if sk.has_padding:
        data = data * sk.device_valid(data.device)[..., None, None]
    N, S = sk.cols.shape
    return data.transpose(1, 2).reshape(N, BLOCK, S * BLOCK)


def spmm_batched(A, sk: Skeleton, v):
    """:func:`spmm_gather` on the operator's :func:`batched_operator` form: one
    batched product per row over the joint (slot, orbital) index, the sum
    Σ_s Σ_b data[n,s,a,b] · v[cols[n,s],b,k] as [4, 4S] @ [4S, K]."""
    N, S = sk.cols.shape
    gathered = v[sk.device_safe_cols(v.device)]  # [N, S, 4, K]
    return torch.bmm(A, gathered.reshape(N, S * BLOCK, -1))


def spmm_stencil(data, sk: Skeleton, v):
    """Stencil SpMM via axis rolls.

    Args:
        data: ``[N, S, 4, 4]`` complex block data.
        sk: the lattice skeleton (slot ↔ axis/direction table).
        v: ``[N, 4, K]`` operand.

    Returns:
        ``[N, 4, K]`` result of the block-sparse product.
    """
    Lx, Ly, Lz = sk.shape
    K = v.shape[-1]
    v3 = v.reshape(Lx, Ly, Lz, BLOCK, K)
    d3 = data.reshape(Lx, Ly, Lz, sk.n_slots, BLOCK, BLOCK)

    # Diagonal slot.
    y = torch.einsum("xyzab,xyzbk->xyzak", d3[..., 0, :, :], v3)

    # Off-diagonal slots: the slot (axis, +1) holds the block coupling site
    # r to site r+ê, so its contribution needs v shifted by −1 along `axis`
    # (bringing v[r+ê] to position r); wrap-around is the periodic link.
    for s, (axis, d) in enumerate(sk.slots):
        if axis < 0 or (sk.shape[axis] == 2 and d == -1):
            continue  # the diagonal (done above); the padding slot of an extent-2 axis
        shifted = torch.roll(v3, shifts=-d, dims=axis)
        y = y + torch.einsum("xyzab,xyzbk->xyzak", d3[..., s, :, :], shifted)

    return y.reshape(-1, BLOCK, K)


def default_impl(tensor) -> str:
    """``"cuda"`` (the hand-written kernel) for a CUDA tensor, ``"plain"`` for a CPU one."""
    return "cuda" if tensor.is_cuda else "plain"


def spmm(data, sk: Skeleton, v, *, impl: Optional[str] = None, operator_dtype=None):
    """Dispatch SpMM by implementation name.

    ``None`` and the names of :data:`bodge_tpu_torch.ops.cuda_spmm.PATHS`
    (``"cuda"``, ``"cuda_gather"``, ``"plain_gather"``, …) go through
    :class:`~bodge_tpu_torch.ops.cuda_spmm.StepPlan`: kernels for CUDA
    tensors, plain versions for CPU tensors, the windowed product on generic
    skeletons (operands relabelled for the call and the result brought
    back); a ``"cuda*"`` name on a CPU tensor raises.  ``"plain"`` and
    ``"gather"`` are the gather product, ``"stencil"`` the roll formulation
    (gather on generic skeletons).

    ``operator_dtype="bf16"`` multiplies with the operator in the bf16 form
    (the kernels' bf16 instantiations on the card); ``None`` keeps the
    complex operator, as the reference's ``spmm_gather_pallas`` does.
    """
    from .cuda_spmm import StepPlan, bf16_operator, operator_values, resolve_operator_storage

    storage = None if operator_dtype is None else resolve_operator_storage(operator_dtype)
    if storage is not None and impl in ("gather", "plain", "stencil"):
        data = operator_values(bf16_operator(data), v.dtype)
    if impl in ("gather", "plain") or (impl == "stencil" and not sk.stencil):
        return spmm_gather(data, sk, v)
    if impl == "stencil":
        return spmm_stencil(data, sk, v)
    plan = StepPlan(sk, v.shape[-1], impl, v, storage)  # raises on an unknown name
    if plan.impl == "plain":
        return spmm_gather(operator_values(plan.operator(data), v.dtype), sk, v)
    # The kernels are complex64 only; wider input is cast down and back.
    y = plan.leave(plan.spmm(plan.operator(data), plan.enter(v)))
    return y.to(v.dtype)


def spmm_bytes(sk: Skeleton, K: int, itemsize: int, operator_itemsize: int = None) -> int:
    """Minimum device-memory traffic of one SpMM pass (for roofline accounting).

    Counts one read of the block data, one read of the operand, and one
    write of the result; padding slots still occupy memory and are counted,
    since the hardware must stream them.  ``operator_itemsize`` as in
    :func:`chebyshev_step_bytes` (2 for the bf16 form: 4 bytes a complex entry).
    """
    N, S = sk.cols.shape
    op_item = itemsize if operator_itemsize is None else 2 * operator_itemsize
    data_bytes = N * S * BLOCK * BLOCK * op_item
    vec_bytes = 2 * N * BLOCK * K * itemsize
    return data_bytes + vec_bytes


def chebyshev_step_bytes(sk: Skeleton, K: int, itemsize: int,
                         operator_itemsize: int = None) -> int:
    """Minimum device-memory traffic of one fused Chebyshev step.

    The recursion ``t_next = 2·H̃ t_cur − t_prev`` unavoidably reads the
    block data and *two* vectors and writes one — one vector read more
    than a plain SpMM.  ``operator_itemsize`` accounts for reduced-
    precision operator storage (bf16 = 2 bytes per real scalar, i.e. 4
    per complex entry); vectors always move at full precision.
    """
    N, S = sk.cols.shape
    op_item = itemsize if operator_itemsize is None else 2 * operator_itemsize
    data_bytes = N * S * BLOCK * BLOCK * op_item
    vec_bytes = 3 * N * BLOCK * K * itemsize
    return data_bytes + vec_bytes


def spmm_flops(sk: Skeleton, K: int, complex_data: bool = True) -> int:
    """FLOP count of one SpMM pass over the structural nonzeros."""
    per_mac = 8 if complex_data else 2  # complex multiply-add = 8 real flops
    return sk.nnz_blocks * BLOCK * BLOCK * K * per_mac
