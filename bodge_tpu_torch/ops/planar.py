"""Planar (split-complex) entry points: float32 re/im planes at the boundary.

Counterpart of ``bodge_tpu/ops/planar.py``.  The reference keeps a second
device representation because a TPU has no complex arithmetic:

    operator  ``dp: [2, N, S, 4, 4] float32``   (plane 0 = Re, 1 = Im)
    vectors   ``vp: [2, N, 4, K] float32``

On the card complex arithmetic is native, so here the planar form exists only
at the boundary: every function converts its planar arguments to complex64
(``torch.complex(dp[0], dp[1])``, exact), runs the port's complex entry point
— on the card the hand-written kernels (``ell_spmm`` / ``ell_cheb_step``
through :class:`~bodge_tpu_torch.ops.cuda_spmm.StepPlan` and
:func:`~bodge_tpu_torch.ops.cuda_spmm.moments_fused`, the gather pair on
generic skeletons), on the CPU their plain versions — and splits a vector
result back into planes (``torch.stack((z.real, z.imag))``).  Tensors stay on
their device; NumPy input goes to the card, as in every entry point of the
port, unless :func:`to_planar` / :func:`from_planar` are asked for
``device="cpu"``.  A planar call
therefore gives bit for bit what the complex call gives on the same complex64
operator, with the same launches.  No second layout is kept: the conversion
costs one pass over the operator per call (``PERF.md`` has its time on the
card).

The reference's stencil and gather formulations (``spmm_planar_stencil`` /
``spmm_planar_gather``) both become the port's block-ELL product, which reads
``cols`` on any skeleton.  The dense spectra (:func:`eigvalsh_planar`,
:func:`eigh_planar`) take ``torch.linalg.eigh`` of the complex64 matrix, not
of the reference's 2d×2d real embedding (:func:`dense_embedding`, kept for
callers that want it): the same d eigenvalues, each once, and complex
eigenvectors directly — within a degenerate multiplet any orthonormal basis,
so compare them by the projector onto the multiplet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..common import resolve_device, torch_dtype
from .blocksparse import Skeleton, ell_to_dense_torch, hermiticity_error

REAL_DTYPE = torch.float32


def use_planar_device_path() -> bool:
    """Whether the device representation is the planar (split-complex
    float32) form: ``BODGE_PLANAR=1`` / ``0`` as in the reference, and False
    by default — complex arithmetic is native on the card (the reference
    defaults to True only on a TPU).
    :meth:`~bodge_tpu_torch.hamiltonian.Hamiltonian.device_operator` and
    :func:`bodge_tpu_torch.ops.chebyshev.default_impl` read it; the façade's
    own calls compute on the complex operator either way."""
    return os.environ.get("BODGE_PLANAR") == "1"


def is_planar(arr, base_ndim: int = 4) -> bool:
    """Whether ``arr`` is a planar array: a float32 / float64 ``[2, ...]`` of
    ``base_ndim`` trailing axes (4 for an operator, 3 for vectors) — not the
    complex form, nor the bf16 form of :mod:`.cuda_ell`."""
    if isinstance(arr, torch.Tensor):
        real = arr.dtype in (torch.float32, torch.float64)
    else:
        real = np.dtype(arr.dtype) in (np.float32, np.float64)
    return arr.ndim == base_ndim + 1 and arr.shape[0] == 2 and real


def _placed(data, device) -> torch.Tensor:
    """``data`` as a tensor: NumPy input on ``device`` (``None``: the card, as
    every entry point of the port), a tensor on its own device unless
    ``device`` is given."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    return torch.as_tensor(data).to(resolve_device(device))


def to_planar(data, device=None) -> torch.Tensor:
    """Complex array → planar ``[2, ...]`` float32 tensor.  NumPy input is
    split on the host and lands on ``device`` (``None``: the card); a tensor
    stays on its device unless ``device`` is given."""
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.stack((data.real, data.imag)).astype(np.float32))
        return data.to(resolve_device(device))
    data = _placed(data, device)
    if not data.is_complex():
        return torch.stack((data, torch.zeros_like(data))).to(REAL_DTYPE)
    return torch.stack((data.real, data.imag)).to(REAL_DTYPE)


def from_planar(vp, dtype=np.complex64, device=None) -> torch.Tensor:
    """Planar ``[2, ...]`` → complex tensor of ``dtype``, placed as by
    :func:`to_planar`."""
    vp = _placed(vp, device)
    return torch.complex(vp[0].to(REAL_DTYPE), vp[1].to(REAL_DTYPE)).to(torch_dtype(dtype))


def complex_operator(data):
    """The complex64 form of a planar operator; a complex one as it is."""
    return from_planar(data) if is_planar(data) else data


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------
def spmm_planar(dp, sk: Skeleton, vp):
    """``y = H @ v`` in planar form: ``dp: [2, N, S, 4, 4]``, ``vp: [2, N, 4, K]``
    → ``[2, N, 4, K]``, through :func:`bodge_tpu_torch.ops.spmm.spmm`."""
    from .spmm import spmm

    data = from_planar(dp)
    return to_planar(spmm(data, sk, from_planar(vp, device=data.device)))


def spmm_planar_stencil(dp, sk: Skeleton, vp):
    """:func:`spmm_planar` on a cubic (stencil) skeleton, which it requires."""
    if not sk.stencil:
        raise ValueError("spmm_planar_stencil needs a cubic (stencil) skeleton")
    return spmm_planar(dp, sk, vp)


def spmm_planar_gather(dp, sk: Skeleton, vp):
    """:func:`spmm_planar` on any skeleton (the block-ELL product reads ``cols``)."""
    return spmm_planar(dp, sk, vp)


# ---------------------------------------------------------------------------
# KPM moment sweeps
# ---------------------------------------------------------------------------
def moments_planar(dp, sk: Skeleton, vp, inv_scale, order: int):
    """Chebyshev moments ``μ_m[k]`` ``[order, K]`` of H·inv_scale against the
    planar probes ``vp``, by the fused sweep
    (:func:`~bodge_tpu_torch.ops.cuda_spmm.moments_fused`)."""
    from .cuda_spmm import moments_fused

    data = from_planar(dp)
    return moments_fused(data, sk, from_planar(vp, device=data.device), float(inv_scale), order)


def trace_fn_planar(dp, sk: Skeleton, probes, coeffs, inv_scale, order: int):
    """Σ_m c_m Σ_k ⟨z_k|T_m(H̃)|z_k⟩ over planar probes (a 0-d tensor)."""
    mu = moments_planar(dp, sk, probes, inv_scale, order)
    c = torch.as_tensor(coeffs).to(device=mu.device, dtype=mu.dtype)
    return torch.dot(c[: mu.shape[0]], mu.sum(dim=1))


def spectral_bound_planar(dp, sk: Skeleton, iters: int = 60, seed: int = 0) -> float:
    """‖H‖₂ estimate by power iteration (+5% headroom): the complex call's
    :func:`~bodge_tpu_torch.ops.chebyshev.spectral_bound` on the complex form."""
    from .chebyshev import spectral_bound

    return spectral_bound(from_planar(dp), sk, iters=iters, seed=seed)


def hermiticity_error_planar(dp, sk: Skeleton):
    """max elementwise |H−H†| (a 0-d tensor), the quantity the reference gates
    at 1e-6 (``bodge/hamiltonian.py:121-122``)."""
    return hermiticity_error(from_planar(dp), sk)


# ---------------------------------------------------------------------------
# Dense spectra
# ---------------------------------------------------------------------------
def _dense(dp, sk: Skeleton):
    return ell_to_dense_torch(from_planar(dp), sk)


def dense_embedding(dp, sk: Skeleton):
    """Planar ELL → real-symmetric embedding ``A = [[R, −I], [I, R]]``:
    ``[2d, 2d]`` float32 with d = 4N, whose spectrum is spec(H) doubled."""
    H = _dense(dp, sk)
    R, I = H.real, H.imag
    return torch.cat((torch.cat((R, -I), dim=1), torch.cat((I, R), dim=1)), dim=0)


def eigvalsh_planar(dp, sk: Skeleton):
    """All d eigenvalues of H (each once), ascending, float32, on the operator's device."""
    return torch.linalg.eigvalsh(_dense(dp, sk))


def eigh_planar(dp, sk: Skeleton):
    """``(E, X)`` of H: d eigenvalues and the complex64 eigenvectors as columns."""
    return torch.linalg.eigh(_dense(dp, sk))

