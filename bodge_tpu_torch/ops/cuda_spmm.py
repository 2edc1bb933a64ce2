"""Hand-written CUDA kernels for the block-ELL operator, with their plain versions.

Two kernels, both in ``csrc/ell_spmm.cu`` (CUDA C++ for ``sm_90a``, built by
``nvcc`` at first use and bound through ``ctypes``, see :mod:`._build`):

- :func:`ell_spmm` — ``y = H v``.  Replaces ``_flat_spmm_kernel`` and
  ``_plane_stencil_kernel`` of ``bodge_tpu/ops/pallas_spmm.py``.
- :func:`ell_cheb_step` — the fused Chebyshev step
  ``t_next = 2·inv·(H t_cur) − t_prev`` together with per-thread-block
  partial sums of ``Re⟨t_cur,t_cur⟩`` and ``Re⟨t_next,t_cur⟩`` per probe
  column.  Replaces ``_flat_cheb_kernel`` and ``_plane_cheb_kernel``.

The TPU kernels come in a flat and a plane layout with a packing pass each,
because of that machine's small fast memory and missing gather; on the GPU
each pair collapses into one kernel that reads ``cols`` and works on the
natural ``[N, S, 4, 4]`` / ``[N, 4, K]`` complex64 tensors.  The same kernel
is right on generic (``skeleton_from_pairs``) skeletons.

What bounds them: bytes.  A step moves ``chebyshev_step_bytes(sk, K, 8)``
bytes (operator once, two vectors in, one out; ``spmm_bytes`` for the plain
product) and does about K real operations per operator byte — far below the
card's ridge of some hundred operations per byte — so the least time is
those bytes over the device-memory rate.  What the design does about it is
said at the top of the ``.cu`` source: coalesced vector access with the
probe column as the fastest thread index, broadcast operator loads, and the
recursion tail and both reductions fused into the one pass.

Precision and devices.  The kernels take complex64 CUDA tensors only.  A
wrapper called on a CUDA tensor launches its kernel or raises — it never
gives way to the plain version; the plain version runs only for a CPU tensor
or on an explicit ``impl="plain"``.  A complex128 operator on the card is
cast down to complex64 by the callers that choose the kernel
(:func:`moments_fused`, :func:`bodge_tpu_torch.ops.spmm.spmm`), as the TPU
path casts when it packs; ``impl="plain"`` keeps complex128.

Each wrapper counts its launches in a plain integer attribute
(``ell_spmm.launches``, ``ell_cheb_step.launches``), raised where the kernel
is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .blocksparse import BLOCK, Skeleton
from .spmm import default_impl, spmm_gather

THREADS = 256  # threads per block in csrc/ell_spmm.cu
KERNELS = ("ell_spmm", "ell_cheb_step")


# --------------------------------------------------------------------------
# Plain PyTorch versions (any device, complex64 or complex128).
# --------------------------------------------------------------------------
def ell_spmm_plain(data, sk: Skeleton, v):
    """Plain version of :func:`ell_spmm` (the gather product)."""
    return spmm_gather(data, sk, v)


def ell_cheb_step_plain(data, sk: Skeleton, t_cur, t_prev, inv: float):
    """Plain version of :func:`ell_cheb_step`.

    Returns ``(t_next, partials)`` with ``partials`` of shape ``[1, 2K]``:
    the per-column sums of ``Re⟨t_cur,t_cur⟩`` then ``Re⟨t_next,t_cur⟩``.
    """
    t_next = (2.0 * inv) * spmm_gather(data, sk, t_cur)
    if t_prev is not None:
        t_next = t_next - t_prev
    cur = torch.view_as_real(t_cur)
    nxt = torch.view_as_real(t_next)
    cc = (cur * cur).sum(dim=(0, 1, 3))
    nc = (nxt * cur).sum(dim=(0, 1, 3))
    return t_next, torch.cat([cc, nc])[None, :]


# --------------------------------------------------------------------------
# Binding.
# --------------------------------------------------------------------------
_bound = None


def _library():
    """The built library with ``argtypes`` set (pointers and the stream as
    ``c_void_p``: without them ctypes would cut a pointer to 32 bits)."""
    global _bound
    if _bound is None:
        lib = _build.load("ell_spmm")
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ell_spmm_launch.argtypes = [p, p, p, p, ll, i, i, i, p]
        lib.ell_spmm_launch.restype = i
        lib.ell_cheb_step_launch.argtypes = [p, p, p, p, p, p, f, ll, i, i, i, p]
        lib.ell_cheb_step_launch.restype = i
        _bound = lib
    return _bound


def probe_tile(K: int) -> int:
    """Probe columns per thread block: the smallest power of two covering min(K, 32)."""
    tk = 1
    while tk < min(K, 32):
        tk *= 2
    return tk


def _resolve(impl: Optional[str], tensor) -> str:
    if impl is None:
        impl = default_impl(tensor)
    if impl not in ("cuda", "plain"):
        raise ValueError(f"Unknown kernel implementation '{impl}' (expected 'cuda' or 'plain')")
    if impl == "cuda" and not tensor.is_cuda:
        raise RuntimeError(
            "impl='cuda' needs tensors on a CUDA device; this one lies on the CPU "
            "(use impl='plain', or move the operator with device='cuda')"
        )
    return impl


def _check_operand(name: str, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise RuntimeError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.complex64:
        raise TypeError(f"{name} must be complex64 for the CUDA kernel, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the CUDA kernel")


def _check_call(data, sk: Skeleton, v) -> Tuple[int, int, int]:
    if not isinstance(v, torch.Tensor) or v.dim() != 3 or v.shape[1] != BLOCK:
        raise ValueError("operand must be a tensor of shape [N, 4, K]")
    N, S = sk.cols.shape
    K = int(v.shape[2])
    if K < 1:
        raise ValueError("operand needs at least one probe column")
    _check_operand("operand", v, (N, BLOCK, K), v.device)
    _check_operand("data", data, (N, S, BLOCK, BLOCK), v.device)
    return N, S, K


def as_kernel_operand(t):
    """``t`` as the contiguous complex64 tensor the kernels take (itself if it already is)."""
    return t.to(torch.complex64).contiguous()


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: the CUDA launch was refused (cudaError {err})")


# --------------------------------------------------------------------------
# Wrappers.
# --------------------------------------------------------------------------
def ell_spmm(data, sk: Skeleton, v, *, impl: Optional[str] = None):
    """``y[n,a,k] = Σ_s Σ_b data[n,s,a,b] · v[cols[n,s],b,k]`` (padding slots skipped).

    On a CUDA tensor this launches the kernel (complex64, contiguous
    tensors; anything else raises).  On a CPU tensor, or with
    ``impl="plain"``, it is :func:`ell_spmm_plain`.
    """
    if _resolve(impl, v) == "plain":
        return ell_spmm_plain(data, sk, v)
    N, S, K = _check_call(data, sk, v)
    cols = sk.device_cols(v.device)
    y = torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.ell_spmm_launch(
            data.data_ptr(), cols.data_ptr(), v.data_ptr(), y.data_ptr(),
            N, S, K, probe_tile(K), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_spmm")
    ell_spmm.launches += 1
    return y


ell_spmm.launches = 0


def ell_cheb_step(
    data, sk: Skeleton, t_cur, t_prev, inv: float, *, out=None, impl: Optional[str] = None
):
    """Fused Chebyshev step: ``(t_next, partials)``.

    ``t_next = 2·inv·(H t_cur) − t_prev`` (``t_prev=None`` means zero), and
    ``partials[:, :K].sum(0)`` = ``Re⟨t_cur,t_cur⟩``, ``partials[:, K:].sum(0)``
    = ``Re⟨t_next,t_cur⟩`` per probe column.  The kernel writes one row of
    partials per thread block, without atomics, so the sums repeat exactly.

    ``out`` (kernel only) is the buffer ``t_next`` is written into; it may be
    ``t_prev`` itself, never ``t_cur``.
    """
    if _resolve(impl, t_cur) == "plain":
        return ell_cheb_step_plain(data, sk, t_cur, t_prev, inv)
    N, S, K = _check_call(data, sk, t_cur)
    shape = (N, BLOCK, K)
    if t_prev is not None:
        _check_operand("t_prev", t_prev, shape, t_cur.device)
    if out is None:
        out = torch.empty_like(t_cur)
    else:
        _check_operand("out", out, shape, t_cur.device)
    if out.untyped_storage().data_ptr() == t_cur.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with t_cur (other threads read it)")
    cols = sk.device_cols(t_cur.device)
    tk = probe_tile(K)
    n_blocks = -(-N // (THREADS // tk))
    partials = torch.empty((n_blocks, 2 * K), dtype=torch.float32, device=t_cur.device)
    lib = _library()
    with torch.cuda.device(t_cur.device):
        err = lib.ell_cheb_step_launch(
            data.data_ptr(), cols.data_ptr(), t_cur.data_ptr(),
            None if t_prev is None else t_prev.data_ptr(), out.data_ptr(),
            partials.data_ptr(), float(inv), N, S, K, tk,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_cheb_step")
    ell_cheb_step.launches += 1
    return out, partials


ell_cheb_step.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches so far}`` for every kernel of this module."""
    return {"ell_spmm": ell_spmm.launches, "ell_cheb_step": ell_cheb_step.launches}


def reset_launch_counts() -> None:
    ell_spmm.launches = 0
    ell_cheb_step.launches = 0


# --------------------------------------------------------------------------
# The doubled-moment recursion over the fused step.
# --------------------------------------------------------------------------
def sweep_launches(order: int) -> int:
    """Fused-step launches of one moment sweep: ``1 + ceil((order − 2) / 2)``."""
    return 1 + max(0, (order - 2 + 1) // 2)


def moments_fused(data, sk: Skeleton, v0, inv: float, order: int, *, impl: Optional[str] = None):
    """KPM moments ``μ_m[k] = Re⟨v0_k|T_m(inv·H)|v0_k⟩`` as a ``[order, K]`` real tensor.

    The counterpart of ``moments_pallas_fused``: one half-scaled first step
    with ``t_prev = 0`` gives ``t1 = H̃ t0`` and, from its partials, μ0 and
    μ1; then ``ceil((order−2)/2)`` steps each give two moments through
    ``μ_{2m} = 2⟨t_m,t_m⟩ − μ0`` and ``μ_{2m+1} = 2⟨t_{m+1},t_m⟩ − μ1``.

    The scan is a Python loop of launches with no host synchronisation: the
    reduced partials stay on the device and are stacked at the end.  With the
    kernel, a complex128 operator or probe is cast down to complex64 first,
    and from the third step on ``t_next`` overwrites the ``t_prev`` buffer,
    so three vectors exist in all (``v0`` is never written).
    """
    impl = _resolve(impl, v0)
    if impl == "cuda":
        data, v0 = as_kernel_operand(data), as_kernel_operand(v0)
    K = v0.shape[-1]
    inv = float(inv)

    t1, pp0 = ell_cheb_step(data, sk, v0, None, 0.5 * inv, impl=impl)
    first = pp0.sum(dim=0)
    mu0, mu1 = first[:K], first[K:]

    steps = max(0, (order - 2 + 1) // 2)
    if steps == 0:
        return torch.stack([mu0, mu1])[:order]

    t_prev, t_cur = v0, t1
    sums = []
    for i in range(steps):
        out = t_prev if (impl == "cuda" and i > 0) else None  # i == 0: t_prev is the caller's v0
        t_next, pp = ell_cheb_step(data, sk, t_cur, t_prev, inv, out=out, impl=impl)
        sums.append(pp.sum(dim=0))
        t_prev, t_cur = t_cur, t_next
    sums = torch.stack(sums)  # [steps, 2K]
    alphas = 2.0 * sums[:, :K] - mu0
    betas = 2.0 * sums[:, K:] - mu1
    rest = torch.stack([alphas, betas], dim=1).reshape(2 * steps, K)
    return torch.cat([mu0[None], mu1[None], rest], dim=0)[:order]
