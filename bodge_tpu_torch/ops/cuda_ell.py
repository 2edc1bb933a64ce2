"""Hand-written CUDA kernels for the block-ELL operator, with their plain versions.

Kernels in ``csrc/`` (CUDA C++ for ``sm_90a``, built by ``nvcc`` at
first use and bound through ``ctypes``, see :mod:`._build`).  Forward, in
``csrc/ell_spmm.cu``:

- :func:`ell_spmm` — ``y = H v``.  Replaces ``_flat_spmm_kernel`` and
  ``_plane_stencil_kernel`` of ``bodge_tpu/ops/pallas_spmm.py``.
- :func:`ell_cheb_step` — the fused Chebyshev step
  ``t_next = 2·inv·(H t_cur) − t_prev`` together with per-thread-block
  partial sums of ``Re⟨t_cur,t_cur⟩`` and ``Re⟨t_next,t_cur⟩`` per probe
  column.  Replaces ``_flat_cheb_kernel`` and ``_plane_cheb_kernel``.
- :func:`ell_cheb_step_window` — the same step on a range of rows alone, the
  light-cone form (:class:`~bodge_tpu_torch.ops.cuda_spmm.LightCone`).

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
cast down to complex64 by the callers that choose the kernel (the sweeps of
:mod:`.cuda_spmm`, :func:`bodge_tpu_torch.ops.spmm.spmm`), as the TPU path
casts when it packs; ``impl="plain"`` keeps complex128.

Operator storage.  The forward kernels (the products and steps, general,
gather, tiled and halo) also take the operator in the *bf16 form*
(:func:`bf16_operator`): ``[N, S, 4, 4, 2]`` bfloat16, one (re, im) pair of 4
bytes per entry, half the operator's bytes; vectors, sums and arithmetic stay
float32.  It is the reference's ``operator_dtype=jnp.bfloat16`` /
``BODGE_OPERATOR_STORAGE=bf16`` (:func:`resolve_operator_storage`), and each
bf16 instantiation counts its launches under its own name
(``ell_spmm_bf16``, …).  The plain versions take it too and upcast it
exactly.  The adjoint and outer-product kernels, and so the differentiable
sweeps, take complex64 only, as the reference's differentiable paths take a
float32 operator only: the bf16 form raises there.

Backward (the gradient of the step, which the reference takes from the XLA
VJP of its ``_flat_cheb_step_ref`` / ``_plane_cheb_step_halo_ref``
restatements inside ``cheb_step_pallas_ad``, ``pallas_spmm.py:1397``):

- :func:`ell_spmm_adjoint` — ``y = H† v`` for any stored blocks, Hermitian or
  not: the vector cotangent.  The same device body as :func:`ell_spmm` with
  the mirror block (``sk.trans_slot``) read conjugate-transposed; bound by
  the same bytes.
- :func:`ell_block_outer` — ``H̄[n,s] (+)= α Σ_k g[n,:,k] ⊗ conj(t[cols[n,s],:,k])``:
  the operator cotangent, in ``csrc/ell_block_outer.cu``.  Bound by bytes:
  ``g`` and ``t`` once, ``H̄`` written (and read when accumulating).

The tiled step, in ``csrc/stencil_tiled.cu``:

- :func:`stencil_cheb_step_tiled` — the same function as :func:`ell_cheb_step`
  on a stencil skeleton, streaming the lattice along x through a ring of
  strip rows (and their halo) in shared memory, the next rows copied in by
  ``cp.async``, and finding the neighbours by stencil arithmetic (no ``cols``
  read).  Replaces ``_plane_cheb_kernel_tiled`` (``pallas_spmm.py:916``) and,
  like it, is opt-in: ``impl="cuda_tiled"``, or ``BODGE_PLANE_TILED=1`` for
  ``impl=None`` on stencil skeletons.

Halo forms, for one x-slab of a row-sharded lattice (:class:`HaloSlab`;
the exchange that fills the halo planes, and the sweeps over it, live in
:mod:`bodge_tpu_torch.parallel`).  Template flags of the two kernel bodies
above, in the same sources:

- :func:`ell_spmm_halo` and :func:`ell_cheb_step_halo` — the product and the
  fused step on a slab, the planes before and after it given as separate
  buffers ``hm`` / ``hp``, over a range of the slab's rows (the interior and
  boundary launches of the overlap split).  They replace
  ``_plane_stencil_kernel_halo`` and ``_plane_cheb_kernel_halo``
  (``pallas_spmm.py:1163``, ``:1219``).
- :func:`ell_spmm_adjoint_halo` and :func:`ell_block_outer_halo` — their
  backward pass (the reference's XLA VJPs ``plane_spmm_halo_ad`` and
  ``plane_cheb_step_halo_ad``, ``:1430``, ``:1449``): the adjoint gathers the
  cotangent's halo planes, exchanged in the forward direction, and reads
  the mirror blocks of the neighbour planes' rows (``dm`` / ``dp``); the
  outer product reads the forward step's halo planes.  No scatter back, no
  atomics.

The recursions one step a call (:func:`moment_recursion`,
:func:`filter_recursion`, :func:`power_recursion`) are here: the plain
versions of :mod:`.cuda_filter`'s one-launch sweeps run them, and the sweep
layer, :mod:`.cuda_spmm`, runs them on the step it chooses.  Each wrapper
counts its launches in a plain integer attribute (``ell_spmm.launches``, …),
raised where the kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import jσ2
from . import _build
from .blocksparse import BLOCK, Skeleton
from .spmm import batched_operator, default_impl, spmm_gather, spmm_stencil

THREADS = 256  # threads per block in csrc/ell_spmm.cu
TILED_THREADS = 256  # threads per block in csrc/stencil_tiled.cu
TILED_BLOCKS_PER_SM = 3  # its occupancy (at most 80 registers a thread)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
SM_SHARED = 233472  # bytes of shared memory an SM has on sm_90 ...
BLOCK_RESERVED = 1024  # ... of which each resident block takes this much
DEFAULT_SMS = 132  # streaming multiprocessors of an H100 SXM, for plans made without a card
PAD_COLUMN = -(2 ** 31)  # padding in a slab's column table (below every halo index)


# --------------------------------------------------------------------------
# Operator storage: the complex form and the bf16 form.
# --------------------------------------------------------------------------
def resolve_operator_storage(operator_dtype=None) -> Optional[torch.dtype]:
    """The operator storage a call asks for: ``None`` (the complex operator)
    or ``torch.bfloat16`` (:func:`bf16_operator`).

    The counterpart of the reference's ``_operator_storage``: ``None`` reads
    ``BODGE_OPERATOR_STORAGE``; ``""``, ``"f32"``, ``"float32"`` and
    ``torch.float32`` mean the complex operator, ``"bf16"``, ``"bfloat16"``
    and ``torch.bfloat16`` the bf16 form.  Anything else raises
    ``ValueError`` (the reference passes it on to its packer).
    """
    if operator_dtype is None:
        operator_dtype = os.environ.get("BODGE_OPERATOR_STORAGE", "")
    if operator_dtype in ("", "f32", "float32", torch.float32):
        return None
    if operator_dtype in ("bf16", "bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"Unknown operator storage {operator_dtype!r} (expected 'f32' or 'bf16')")


def bf16_operator(data):
    """Block data ``[N, S, 4, 4]`` in the bf16 form: ``[N, S, 4, 4, 2]``
    bfloat16, the (re, im) parts of each entry rounded to nearest even from
    float32 (the reference's ``.astype(bfloat16)`` of its float32 planes).
    A tensor already in that form is returned as it is."""
    if is_bf16_operator(data):
        return data
    return torch.view_as_real(data.to(torch.complex64)).to(torch.bfloat16).contiguous()


def is_bf16_operator(data) -> bool:
    return isinstance(data, torch.Tensor) and data.dtype == torch.bfloat16


def operator_values(data, dtype):
    """The block data the plain versions multiply with: the bf16 form upcast
    (exactly) to complex ``dtype``, a complex operator as it is."""
    if is_bf16_operator(data):
        return torch.view_as_complex(data.float().contiguous()).to(dtype)
    return data


# --------------------------------------------------------------------------
# Pairing-field inserts into an operator form (the reference's packed inserts).
# --------------------------------------------------------------------------
def _write_blocks(b, index, value):
    """``b[index] = value``: in ``b``'s dtype for the complex operator; for the
    bf16 form the (re, im) pairs rounded to bfloat16, as the reference rounds
    its float32 planes."""
    if is_bf16_operator(b):
        b[index] = torch.view_as_real(value.to(torch.complex64).resolve_conj()).to(torch.bfloat16)
    else:
        b[index] = value.to(b.dtype)


def _insert_dtype(b):
    return b.dtype if b.is_complex() else torch.complex64


def plane_packed_insert_swave(b, delta_real, sk: Skeleton):
    """Insert an on-site s-wave field Δ_i·jσ2 into the diagonal blocks of an
    operator form: the counterpart of the reference's insert into its
    plane-packed operator (``bodge_tpu/ops/pallas_spmm.py:521``).

    ``b`` is the complex ELL data ``[n, S, 4, 4]`` of a stencil skeleton — the
    whole lattice or a rank's slab with its halo rows, in any row order — or
    its bf16 form ``[n, S, 4, 4, 2]`` (:func:`bf16_operator`); ``delta_real``
    holds the field on the same ``n`` rows (real, or complex as
    :func:`~bodge_tpu_torch.models.selfconsistency.solve_gap` passes it).  All
    eight pairing positions of slot 0 are written, zeros included: Δ·jσ2 at
    rows 0:2 × columns 2:4 and its conjugate transpose at rows 2:4 × columns
    0:2.  Returns a new tensor; differentiable in the field.
    """
    if not sk.stencil:
        raise ValueError("plane_packed_insert_swave needs a stencil skeleton (the diagonal block at slot 0)")
    return insert_onsite_pairing(b, delta_real, (slice(None), 0))


def insert_onsite_pairing(b, delta, diag):
    """``b`` with Δ_i·jσ2 and its conjugate transpose written into the pairing
    sub-blocks of the diagonal blocks ``b[diag]`` (``(slice(None), 0)`` on a
    stencil skeleton, ``(rows, slots)`` on a generic one), for any operator
    form of :func:`plane_packed_insert_swave`.  A new tensor; differentiable."""
    cdt = _insert_dtype(b)
    delta = torch.as_tensor(delta, device=b.device)
    blk = (delta[:, None, None] * torch.as_tensor(np.asarray(jσ2)).to(device=b.device, dtype=cdt)).to(cdt)
    out = b.clone()
    _write_blocks(out, (*diag, slice(0, 2), slice(2, 4)), blk)
    _write_blocks(out, (*diag, slice(2, 4), slice(0, 2)), blk.transpose(-1, -2).conj())
    return out


def plane_packed_insert_bond(b, m, sk: Skeleton, struct):
    """Insert a bond pairing field into an operator form: the counterpart of
    the reference's ``plane_packed_insert_bond``
    (``bodge_tpu/ops/pallas_spmm.py:556``).

    ``m: [n, S]`` holds the amplitude per (row, slot) of ``b``'s rows (zero
    where the field does not reach; :func:`~bodge_tpu_torch.models.selfconsistency.bond_field`
    makes it from a site field) and ``struct: [S, 2, 2]`` the per-slot
    structure.  The pairing block of slot s is ``m·struct[s]``; its partner
    ``m·struct[trans_slot[s]]†``, so the operator stays Hermitian for a
    symmetric ``m``.  All pairing positions of every slot are written, zeros
    included.  ``b`` takes the forms of :func:`plane_packed_insert_swave`.
    Returns a new tensor; differentiable in ``m``.
    """
    if not sk.stencil:
        raise ValueError("plane_packed_insert_bond needs a stencil skeleton (one structure per slot)")
    cdt = _insert_dtype(b)
    struct = np.asarray(struct)
    like = lambda a: torch.as_tensor(np.asarray(a)).to(device=b.device, dtype=cdt)
    struct_t = like(struct)
    structH = like(np.conj(np.swapaxes(struct[np.asarray(sk.trans_slot)], -1, -2)))
    m = torch.as_tensor(m, device=b.device).to(cdt)
    out = b.clone()
    _write_blocks(out, (slice(None), slice(None), slice(0, 2), slice(2, 4)), m[:, :, None, None] * struct_t[None])
    _write_blocks(out, (slice(None), slice(None), slice(2, 4), slice(0, 2)), m[:, :, None, None] * structH[None])
    return out


def _require_complex_operator(data, what: str):
    if is_bf16_operator(data):
        raise TypeError(f"{what} takes a complex operator: the bf16 form is for the forward kernels only "
                        "(the reference's differentiable paths take a float32 operator)")


# --------------------------------------------------------------------------
# Plain PyTorch versions (any device, complex64 or complex128).
# --------------------------------------------------------------------------
def ell_spmm_plain(data, sk: Skeleton, v):
    """Plain version of :func:`ell_spmm` (the gather product)."""
    return spmm_gather(operator_values(data, v.dtype), sk, v)


def ell_cheb_step_plain(data, sk: Skeleton, t_cur, t_prev, inv: float, sums: bool = True):
    """Plain version of :func:`ell_cheb_step`.

    Returns ``(t_next, partials)`` with ``partials`` of shape ``[1, 2K]``:
    the per-column sums of ``Re⟨t_cur,t_cur⟩`` then ``Re⟨t_next,t_cur⟩``.
    """
    return cheb_tail_plain(ell_spmm_plain(data, sk, t_cur), t_cur, t_prev, inv, sums)


def cheb_tail_plain(hv, t_cur, t_prev, inv: float, sums: bool = True):
    """The recursion tail and the column sums every plain step shares:
    ``t_next = 2·inv·hv − t_prev`` and ``partials[1, 2K]`` from ``hv = H t_cur``
    (``None`` with ``sums=False``, for callers that drop them)."""
    t_next = (2.0 * inv) * hv
    if t_prev is not None:
        t_next = t_next - t_prev
    if not sums:
        return t_next, None
    cc = (t_cur.real * t_cur.real + t_cur.imag * t_cur.imag).sum(dim=(0, 1))
    nc = (t_next.real * t_cur.real + t_next.imag * t_cur.imag).sum(dim=(0, 1))
    return t_next, torch.cat([cc, nc])[None, :]


def cheb_tail_window_plain(hv, t_cur, t_prev, inv: float, rows, sums: bool = True):
    """:func:`cheb_tail_plain` on rows ``rows = (r0, r1)``, from ``hv``, those
    rows of ``H t_cur``: ``(t_next, partials[1, 2K])`` with ``t_next`` zero
    outside the rows, as the light-cone steps leave them."""
    r0, r1 = rows
    prev = None if t_prev is None else t_prev[r0:r1]
    part, partials = cheb_tail_plain(hv, t_cur[r0:r1], prev, inv, sums)
    t_next = torch.zeros_like(t_cur, dtype=part.dtype)
    t_next[r0:r1] = part
    return t_next, partials


def ell_cheb_step_window_plain(data, sk: Skeleton, t_cur, t_prev, inv: float, rows, sums: bool = True):
    """Plain version of :func:`ell_cheb_step_window`: :func:`ell_cheb_step_plain`
    on rows ``rows = (r0, r1)`` alone (the same batched product on those rows)."""
    r0, r1 = rows
    A = batched_operator(operator_values(data, t_cur.dtype), sk)[r0:r1]
    gathered = t_cur[sk.device_safe_cols(t_cur.device)[r0:r1]]  # [rows, S, 4, K]
    hv = torch.bmm(A, gathered.reshape(r1 - r0, A.shape[-1], -1))
    return cheb_tail_window_plain(hv, t_cur, t_prev, inv, rows, sums)


def stencil_cheb_step_tiled_plain(data, sk: Skeleton, t_cur, t_prev, inv: float, sums: bool = True):
    """Plain version of :func:`stencil_cheb_step_tiled`: the product by
    ``torch.roll`` stencil arithmetic on ``sk.slots`` (no ``cols`` read), then
    the shared tail."""
    _require_stencil(sk)
    return cheb_tail_plain(spmm_stencil(operator_values(data, t_cur.dtype), sk, t_cur), t_cur, t_prev, inv, sums)


def _require_stencil(sk: Skeleton):
    if not sk.stencil:
        raise ValueError("the tiled step needs a stencil (cubic-lattice) skeleton")


def _valid_mask(sk: Skeleton, device):
    return sk.device_valid(device)[..., None, None]


def ell_spmm_adjoint_plain(data, sk: Skeleton, v, alpha: float = 1.0, add=None, axpy=()):
    """Plain version of :func:`ell_spmm_adjoint`: ``y[n] = Σ_s B(n,s)† v[cols[n,s]]``
    with ``B(n,s) = data[cols[n,s], mirror(n,s)]`` the block that row
    ``cols[n,s]`` stores for column ``n``; then ``alpha·y + add + Σ c·x``."""
    safe = sk.device_safe_cols(v.device)
    mirror = data[safe, sk.device_mirror_index(v.device)]  # [N, S, 4, 4]
    if sk.has_padding:
        mirror = mirror * _valid_mask(sk, v.device)
    y = alpha * torch.einsum("nsba,nsbk->nak", mirror.conj(), v[safe])
    if add is not None:
        y = y + add
    for c, x in axpy:
        y = y + c.to(x.dtype) * x
    return y


def ell_block_outer_plain(g, sk: Skeleton, t, alpha: float = 1.0, out=None, accumulate=False,
                          shift=None, neg_out=None):
    """Plain version of :func:`ell_block_outer`."""
    G = g
    if shift is not None:
        G = shift.to(t.dtype) * t if g is None else g + shift.to(t.dtype) * t
    if neg_out is not None:
        neg_out.copy_(-G)
    gathered = t[sk.device_safe_cols(t.device)]  # [N, S, 4, K]
    h = alpha * torch.einsum("nak,nsbk->nsab", G, gathered.conj())
    if sk.has_padding:
        h = h * _valid_mask(sk, t.device)
    if out is None:
        return h
    return out.add_(h) if accumulate else out.copy_(h)


# --------------------------------------------------------------------------
# Binding.
# --------------------------------------------------------------------------
_bound = None


def _library():
    """The launch functions of the built libraries with ``argtypes`` set
    (pointers and the stream as ``c_void_p``: without them ctypes would cut a
    pointer to 32 bits).  The first call compiles every source that is not
    built yet, all compilers started together."""
    global _bound
    if _bound is None:
        _build.build_all()
        spmm, outer = _build.load("ell_spmm"), _build.load("ell_block_outer")
        gather, tiled = _build.load("ell_gather"), _build.load("stencil_tiled")
        filt = _build.load("ell_filter")
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        ip, llp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
        signatures = {
            "ell_spmm_halo_launch": (spmm, [p, i, p, p, p, p, p, ll, i, ll, ll, i, i, i, p]),
            "ell_cheb_step_halo_launch": (spmm, [p, i] + [p] * 7 + [f, ll, i, ll, ll, i, i, i, p]),
            "ell_spmm_adjoint_halo_launch": (spmm, [p] * 9 + [f] + [p] * 5 + [ll, i, i, i, i, p]),
            "ell_block_outer_halo_launch": (outer, [p] * 8 + [f, i, ll, i, i, i, i, p]),
            "ell_spmm_launch": (spmm, [p, i, p, p, p, ll, i, i, i, p]),
            "ell_cheb_step_launch": (spmm, [p, i, p, p, p, p, p, f, ll, i, i, i, p]),
            "ell_cheb_step_window_launch": (spmm, [p] * 6 + [f, ll, ll, ll, i, i, i, p]),
            "ell_spmm_adjoint_launch": (spmm, [p, p, p, i, p, p, f, p, p, p, p, p, ll, i, i, i, p]),
            "ell_block_outer_launch": (outer, [p, p, p, p, p, p, f, i, ll, i, i, i, p]),
            "ell_gather_spmm_launch": (gather, [p, i, p, p, p, ll, i, i, i, i, i, i, ll, i, i, i, p]),
            "ell_gather_cheb_step_launch": (gather, [p, i, p, p, p, p, p, f, ll, i, i, i, i, i, i, ll, i, i, i, p]),
            "ell_gather_cheb_step_window_launch": (gather, [p] * 6 + [f, ll, ll, ll, i, i, i, i, i, i, ll, i, i, p]),
            "stencil_cheb_step_tiled_launch": (
                tiled, [p, i, p, p, p, p, f, i, i, i, i, i, i, i, i, i, i, i, ip, ip, p]),
            "ell_cheb_filter_launch": (filt, [p, i, p, p, p, i, f, p, p, p, ll, i, i, i, i, p]),
            "ell_cheb_moments_launch": (filt, [p, i, p, p, i, f, p, p, p, ll, i, i, i, i, p]),
            "ell_power_iteration_launch": (filt, [p, p, p, i, p, p, p, ll, i, i, p]),
            "ell_cheb_sweep_occupancy": (filt, [i, i, i, i, i, i, ip, llp]),
        }
        bound = SimpleNamespace()
        for name, (lib, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, i
            setattr(bound, name, fn)
        _bound = bound
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


def _check_operand(name: str, t, shape, device, dtype=torch.complex64):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise RuntimeError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).replace('torch.', '')} for the CUDA kernel, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the CUDA kernel")


def _check_call(data, sk: Skeleton, v) -> Tuple[int, int, int]:
    """``(N, S, K)`` of a kernel call on a complex64 operator."""
    N, S, K, bf16 = _check_forward(data, sk, v)
    if bf16:
        _require_complex_operator(data, "this kernel")
    return N, S, K


def _check_forward(data, sk: Skeleton, v) -> Tuple[int, int, int, bool]:
    """``(N, S, K, bf16)`` of a forward kernel's call: the operator complex64
    ``[N, S, 4, 4]`` or in the bf16 form ``[N, S, 4, 4, 2]``."""
    if not isinstance(v, torch.Tensor) or v.dim() != 3 or v.shape[1] != BLOCK:
        raise ValueError("operand must be a tensor of shape [N, 4, K]")
    N, S = sk.cols.shape
    K = int(v.shape[2])
    if K < 1:
        raise ValueError("operand needs at least one probe column")
    _check_operand("operand", v, (N, BLOCK, K), v.device)
    bf16 = is_bf16_operator(data)
    if bf16:
        _check_operand("data", data, (N, S, BLOCK, BLOCK, 2), v.device, torch.bfloat16)
    else:
        _check_operand("data", data, (N, S, BLOCK, BLOCK), v.device)
    return N, S, K, bf16


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
    tensors; anything else raises); ``data`` in the bf16 form
    (:func:`bf16_operator`) launches its bf16 instantiation, counted as
    :func:`ell_spmm_bf16`.  On a CPU tensor, or with ``impl="plain"``, it is
    :func:`ell_spmm_plain`.
    """
    if _resolve(impl, v) == "plain":
        return ell_spmm_plain(data, sk, v)
    N, S, K, bf16 = _check_forward(data, sk, v)
    cols = sk.device_cols(v.device)
    y = torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.ell_spmm_launch(
            data.data_ptr(), int(bf16), cols.data_ptr(), v.data_ptr(), y.data_ptr(),
            N, S, K, probe_tile(K), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_spmm_bf16" if bf16 else "ell_spmm")
    (ell_spmm_bf16 if bf16 else ell_spmm).launches += 1
    return y


ell_spmm.launches = 0


def _require_bf16(data, what: str):
    if not is_bf16_operator(data):
        raise TypeError(f"{what} takes the operator in the bf16 form (bf16_operator), got {data.dtype}")


def ell_spmm_bf16(data, sk: Skeleton, v, *, impl: Optional[str] = None):
    """:func:`ell_spmm` with the operator in the bf16 form, which it requires."""
    _require_bf16(data, "ell_spmm_bf16")
    return ell_spmm(data, sk, v, impl=impl)


ell_spmm_bf16.launches = 0


def ell_cheb_step(
    data, sk: Skeleton, t_cur, t_prev, inv: float, *, out=None, impl: Optional[str] = None
):
    """Fused Chebyshev step: ``(t_next, partials)``.

    ``t_next = 2·inv·(H t_cur) − t_prev`` (``t_prev=None`` means zero), and
    ``partials[:, :K].sum(0)`` = ``Re⟨t_cur,t_cur⟩``, ``partials[:, K:].sum(0)``
    = ``Re⟨t_next,t_cur⟩`` per probe column.  The kernel writes one row of
    partials per thread block, without atomics, so the sums repeat exactly.

    ``out`` (kernel only) is the buffer ``t_next`` is written into; it may be
    ``t_prev`` itself, never ``t_cur``.  ``data`` in the bf16 form launches
    the bf16 instantiation, counted as :func:`ell_cheb_step_bf16`.
    """
    if _resolve(impl, t_cur) == "plain":
        return ell_cheb_step_plain(data, sk, t_cur, t_prev, inv)
    N, S, K, bf16 = _check_forward(data, sk, t_cur)
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
            data.data_ptr(), int(bf16), cols.data_ptr(), t_cur.data_ptr(),
            None if t_prev is None else t_prev.data_ptr(), out.data_ptr(),
            partials.data_ptr(), float(inv), N, S, K, tk,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_cheb_step_bf16" if bf16 else "ell_cheb_step")
    (ell_cheb_step_bf16 if bf16 else ell_cheb_step).launches += 1
    return out, partials


ell_cheb_step.launches = 0


def ell_cheb_step_bf16(data, sk: Skeleton, t_cur, t_prev, inv: float, *, out=None, impl: Optional[str] = None):
    """:func:`ell_cheb_step` with the operator in the bf16 form, which it requires."""
    _require_bf16(data, "ell_cheb_step_bf16")
    return ell_cheb_step(data, sk, t_cur, t_prev, inv, out=out, impl=impl)


ell_cheb_step_bf16.launches = 0


def _window_rows(rows, N: int) -> Tuple[int, int]:
    r0, r1 = (int(r) for r in rows)
    if not 0 <= r0 <= r1 <= N:
        raise ValueError(f"rows {rows} do not lie in [0, {N}]")
    return r0, r1


def ell_cheb_step_window(data, sk: Skeleton, t_cur, t_prev, inv: float, rows, *, out=None,
                         impl: Optional[str] = None):
    """:func:`ell_cheb_step` on rows ``rows = (r0, r1)`` alone, the light-cone
    step (:class:`~bodge_tpu_torch.ops.cuda_spmm.LightCone`): ``t_next`` is
    written on those rows and nowhere else, so rows outside keep what ``out``
    holds (``None``: a zeroed buffer), and ``partials`` has one row per thread
    block of the range.  The kernel is an instantiation of its own; the
    complex64 operator only."""
    N = sk.n_sites
    rows = _window_rows(rows, N)
    if _resolve(impl, t_cur) == "plain":
        return ell_cheb_step_window_plain(data, sk, t_cur, t_prev, inv, rows)
    N, S, K = _check_call(data, sk, t_cur)
    shape = (N, BLOCK, K)
    if t_prev is not None:
        _check_operand("t_prev", t_prev, shape, t_cur.device)
    if out is None:
        out = torch.zeros_like(t_cur)
    else:
        _check_operand("out", out, shape, t_cur.device)
    if out.untyped_storage().data_ptr() == t_cur.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with t_cur (other threads read it)")
    tk = probe_tile(K)
    r0, r1 = rows
    partials = torch.empty((-(-(r1 - r0) // (THREADS // tk)), 2 * K), dtype=torch.float32, device=t_cur.device)
    with torch.cuda.device(t_cur.device):
        err = _library().ell_cheb_step_window_launch(
            data.data_ptr(), sk.device_cols(t_cur.device).data_ptr(), t_cur.data_ptr(), _ptr(t_prev),
            out.data_ptr(), partials.data_ptr(), float(inv), N, r0, r1, S, K, tk,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_cheb_step_window")
    ell_cheb_step_window.launches += 1
    return out, partials


ell_cheb_step_window.launches = 0


def sm_count() -> int:
    """Streaming multiprocessors of the current card (:data:`DEFAULT_SMS` without one)."""
    return _sm_count(torch.cuda.current_device()) if torch.cuda.is_available() else DEFAULT_SMS


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_plan(sk: Skeleton, K: int, tile: Optional[Tuple[int, ...]] = None) -> dict:
    """Launch plan of :func:`stencil_cheb_step_tiled`: ``{"TK", "PB", "h", "NR",
    "XR", "threads", "ctas", "n_strips", "smem_bytes"}``.

    The plane (``M = Ly·Lz`` sites) is cut into ``n_strips`` strips of ``PB``
    sites; a work item is one strip of one x-row.  A thread block holds a ring
    of ``NR`` strip rows of ``PB + 2h`` sites (``h`` the farthest in-plane
    neighbour: ``Lz`` where the lattice extends in y, ``Lz − 1`` otherwise)
    and ``TK`` probe columns, and walks ``XR`` consecutive items; ``NR − 3``
    rows are in flight while one is computed.  ``ctas`` blocks a column tile,
    one wave on the card: the default plan takes ``PB`` as the block's rows of
    sites (``256 / TK``), raised to cover ``2h`` and capped at ``M``, the
    deepest ring (``NR`` ≤ 5) with which three blocks fit an SM (fewer, or a
    ring of three rows without a row in flight, or a narrower strip, where they
    do not), and ``XR`` so that the blocks of all column tiles fill the card
    once.  ``tile=(PB, XR)`` or ``(PB, XR, NR)`` forces one (for measurements)
    and raises if it does not fit.  Raises ``ValueError`` on a generic skeleton.
    """
    _require_stencil(sk)
    return dict(_tile_plan(sk, int(K), None if tile is None else tuple(int(t) for t in tile), sm_count()))


@functools.lru_cache(maxsize=256)
def _tile_plan(sk: Skeleton, K: int, tile: Optional[Tuple[int, ...]], sms: int) -> dict:
    Lx, Ly, Lz = sk.shape
    M = Ly * Lz
    h = Lz if Ly > 1 else Lz - 1
    TK = min(probe_tile(K), 8)
    vec = 2 if TK % 2 == 0 and K % 2 == 0 else 1
    site = (BLOCK * TK + vec) * 8  # bytes a ring site, bank padding included
    tree = 2 * TILED_THREADS * 4  # the reduction tree, static shared memory

    def smem(PB, NR):
        return NR * (PB + 2 * h) * site

    if tile is not None:
        if len(tile) not in (2, 3):
            raise ValueError(f"tile {tile} is not (PB, XR) or (PB, XR, NR)")
        PB, XR, NR = (tile + (4,))[:3]
        if not (1 <= PB <= M and XR >= 1 and 3 <= NR <= 6):
            raise ValueError(f"tile {tile} does not fit a plane of {M} sites (1 <= PB <= M, XR >= 1, 3 <= NR <= 6)")
        if smem(PB, NR) + tree > SMEM_LIMIT:
            raise ValueError(f"tile {tile} does not fit {SMEM_LIMIT - tree} bytes of shared memory at TK = {TK}")
        per_sm = 1
    else:
        rows = TILED_THREADS // TK
        PB = min(M, rows * max(1, -(-2 * h // rows)))
        while True:
            choice = None
            for per_sm, depths in ((TILED_BLOCKS_PER_SM, (5, 4)), (2, (4,)), (1, (4, 3))):
                room = min(SM_SHARED // per_sm - BLOCK_RESERVED, SMEM_LIMIT) - tree
                NR = next((nr for nr in depths if smem(PB, nr) <= room), None)
                if NR is not None:
                    choice = per_sm, NR
                    break
            if choice is not None or PB == 1:
                break
            PB //= 2
        if choice is None:
            raise ValueError(f"no tile of lattice {sk.shape} fits shared memory (halo {h})")
        per_sm, NR = choice
    n_strips = -(-M // PB)
    items = n_strips * Lx
    if tile is None:
        blocks = max(1, per_sm * sms // -(-K // TK))  # a column tile's share of one wave
        XR = -(-items // min(items, blocks))
    ctas = -(-items // XR)
    return {"TK": TK, "PB": PB, "h": h, "NR": NR, "XR": XR, "threads": TILED_THREADS, "ctas": ctas,
            "n_strips": n_strips, "smem_bytes": smem(PB, NR)}


def _slot_table(sk: Skeleton):
    """``(axis[S], dir[S])`` as C int arrays: axis −1 marks the diagonal and −2
    a slot that is padding on every row (the −1 slot of an axis of extent 2)."""
    table = sk._device_cache.get("slot_table")
    if table is None:
        axes = [-1 if a < 0 else (-2 if sk.shape[a] == 2 and d == -1 else a) for a, d in sk.slots]
        dirs = [d for _, d in sk.slots]
        ints = ctypes.c_int * len(sk.slots)
        table = sk._device_cache["slot_table"] = (ints(*axes), ints(*dirs))
    return table


def stencil_cheb_step_tiled(
    data, sk: Skeleton, t_cur, t_prev, inv: float, *, out=None, impl: Optional[str] = None,
    tile: Optional[Tuple[int, int]] = None,
):
    """The fused Chebyshev step on a stencil skeleton, tiled: ``(t_next, partials)``
    as :func:`ell_cheb_step`, with one row of partials per thread block.

    The kernel streams ``t_cur`` along x through a ring of strip rows in
    shared memory and finds the neighbours by stencil arithmetic on
    ``sk.shape`` and ``sk.slots``; it reads no ``cols``.  ``out`` (kernel only)
    may be ``t_prev`` itself, never ``t_cur``; ``tile=(PB, XR)`` or
    ``(PB, XR, NR)`` overrides :func:`tile_plan`.  Raises ``ValueError`` on a generic skeleton.  ``data``
    in the bf16 form launches the bf16 instantiation, counted as
    :func:`stencil_cheb_step_tiled_bf16`.  On a CPU tensor, or with
    ``impl="plain"``, it is :func:`stencil_cheb_step_tiled_plain`.
    """
    _require_stencil(sk)
    if _resolve(impl, t_cur) == "plain":
        return stencil_cheb_step_tiled_plain(data, sk, t_cur, t_prev, inv)
    N, S, K, bf16 = _check_forward(data, sk, t_cur)
    shape = (N, BLOCK, K)
    if t_prev is not None:
        _check_operand("t_prev", t_prev, shape, t_cur.device)
    if out is None:
        out = torch.empty_like(t_cur)
    else:
        _check_operand("out", out, shape, t_cur.device)
    if out.untyped_storage().data_ptr() == t_cur.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with t_cur (other thread blocks stage it)")
    plan = _tile_plan(sk, K, None if tile is None else tuple(int(t) for t in tile), sm_count())  # read only
    axes, dirs = _slot_table(sk)
    partials = torch.empty((plan["ctas"], 2 * K), dtype=torch.float32, device=t_cur.device)
    Lx, Ly, Lz = sk.shape
    lib = _library()
    with torch.cuda.device(t_cur.device):
        err = lib.stencil_cheb_step_tiled_launch(
            data.data_ptr(), int(bf16), t_cur.data_ptr(), _ptr(t_prev), out.data_ptr(), partials.data_ptr(),
            float(inv), Lx, Ly, Lz, S, K, plan["TK"], plan["PB"], plan["h"], plan["NR"], plan["XR"],
            plan["ctas"], axes, dirs, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "stencil_cheb_step_tiled_bf16" if bf16 else "stencil_cheb_step_tiled")
    (stencil_cheb_step_tiled_bf16 if bf16 else stencil_cheb_step_tiled).launches += 1
    return out, partials


stencil_cheb_step_tiled.launches = 0


def stencil_cheb_step_tiled_bf16(data, sk: Skeleton, t_cur, t_prev, inv: float, *, out=None,
                                 impl: Optional[str] = None, tile: Optional[Tuple[int, int]] = None):
    """:func:`stencil_cheb_step_tiled` with the operator in the bf16 form, which it requires."""
    _require_bf16(data, "stencil_cheb_step_tiled_bf16")
    return stencil_cheb_step_tiled(data, sk, t_cur, t_prev, inv, out=out, impl=impl, tile=tile)


stencil_cheb_step_tiled_bf16.launches = 0


def _check_column_weights(name: str, c, K: int, device):
    if not isinstance(c, torch.Tensor) or c.dtype != torch.float32 or tuple(c.shape) != (K,):
        raise TypeError(f"{name} must be a float32 tensor of shape ({K},) for the CUDA kernel")
    if c.device != device or not c.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def ell_spmm_adjoint(data, sk: Skeleton, v, *, alpha: float = 1.0, add=None, axpy=(), out=None,
                     impl: Optional[str] = None):
    """``y = alpha · H† v + add + Σ_j c_j ⊙ x_j``, with
    ``(H† v)[n,a,k] = Σ_s Σ_b conj(data[j,m,b,a]) · v[j,b,k]``, ``j = cols[n,s]`` and
    ``m = trans_slot`` of ``(n, s)`` (padding slots skipped).  Right for any
    blocks, not only for Hermitian data: it is the vector cotangent of
    :func:`ell_spmm`.

    ``add`` (``[N, 4, K]``) and up to two ``axpy`` terms ``(c, x)`` — ``c`` a
    real ``[K]`` weight per probe column, ``x`` of ``v``'s shape — are folded
    into the kernel's epilogue, so the step's whole vector cotangent is one
    pass.  ``out`` (kernel only) is the buffer written; it may be ``add``
    itself, never ``v``.

    On a CUDA tensor this launches the kernel (complex64, contiguous
    tensors; anything else raises).  On a CPU tensor, or with
    ``impl="plain"``, it is :func:`ell_spmm_adjoint_plain`.
    """
    if len(axpy) > 2:
        raise ValueError("at most two axpy terms fit the kernel's epilogue")
    _require_complex_operator(data, "ell_spmm_adjoint")
    if _resolve(impl, v) == "plain":
        return ell_spmm_adjoint_plain(data, sk, v, alpha, add, axpy)
    N, S, K = _check_call(data, sk, v)
    shape = (N, BLOCK, K)
    if add is not None:
        _check_operand("add", add, shape, v.device)
    for c, x in axpy:
        _check_column_weights("axpy weight", c, K, v.device)
        _check_operand("axpy vector", x, shape, v.device)
    if out is None:
        out = torch.empty_like(v)
    else:
        _check_operand("out", out, shape, v.device)
    if out.untyped_storage().data_ptr() == v.untyped_storage().data_ptr():
        raise ValueError("out must not share memory with v (other threads read it)")
    (c1, x1), (c2, x2) = (*axpy, (None, None), (None, None))[:2]
    cols = sk.device_cols(v.device)
    mirror = sk.device_trans_slot(v.device)
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.ell_spmm_adjoint_launch(
            data.data_ptr(), cols.data_ptr(), mirror.data_ptr(), int(mirror.dim() == 2),
            v.data_ptr(), out.data_ptr(), float(alpha), _ptr(add), _ptr(x1), _ptr(c1),
            _ptr(x2), _ptr(c2), N, S, K, probe_tile(K),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_spmm_adjoint")
    ell_spmm_adjoint.launches += 1
    return out


ell_spmm_adjoint.launches = 0


def ell_block_outer(
    g, sk: Skeleton, t, alpha: float = 1.0, *, out=None, accumulate: bool = False,
    shift=None, neg_out=None, impl: Optional[str] = None,
):
    """``H̄[n,s,a,b] (+)= α · Σ_k G[n,a,k] · conj(t[cols[n,s],b,k])`` as a
    ``[N, S, 4, 4]`` tensor, with ``G = g + shift ⊙ t``; padding slots get zero.

    The operator cotangent of ``y = H t`` given the cotangent ``G`` of ``y``
    (PyTorch's convention for complex gradients).  ``out`` is the buffer
    written; with ``accumulate`` the sums are added to what it holds.
    ``shift`` is a real ``[K]`` weight per probe column (``None``: ``G = g``;
    then ``g`` may be ``None``, meaning zero) and ``neg_out`` a buffer of
    ``t``'s shape that receives ``−G`` — in the step's backward pass
    ``G = g_next + n̄c ⊙ t_cur`` and ``−G`` is the cotangent of ``t_prev``.
    The kernel gives each row to one group of threads and uses no atomics,
    so results repeat exactly.
    """
    if accumulate and out is None:
        raise ValueError("accumulate=True needs the buffer to add into (out=)")
    if g is None and shift is None:
        raise ValueError("g and shift cannot both be absent")
    if _resolve(impl, t) == "plain":
        return ell_block_outer_plain(g, sk, t, alpha, out=out, accumulate=accumulate,
                                     shift=shift, neg_out=neg_out)
    if not isinstance(t, torch.Tensor) or t.dim() != 3 or t.shape[1] != BLOCK:
        raise ValueError("operand must be a tensor of shape [N, 4, K]")
    N, S = sk.cols.shape
    K = int(t.shape[2])
    if K < 1:
        raise ValueError("operand needs at least one probe column")
    _check_operand("t", t, (N, BLOCK, K), t.device)
    if g is not None:
        _check_operand("g", g, (N, BLOCK, K), t.device)
    if shift is not None:
        _check_column_weights("shift", shift, K, t.device)
    if neg_out is not None:
        _check_operand("neg_out", neg_out, (N, BLOCK, K), t.device)
        own = neg_out.untyped_storage().data_ptr()
        if own == t.untyped_storage().data_ptr() or (g is not None and own == g.untyped_storage().data_ptr()):
            raise ValueError("neg_out must be a buffer of its own (g and t are read after it is written)")
    if out is None:
        out = torch.empty((N, S, BLOCK, BLOCK), dtype=t.dtype, device=t.device)
    else:
        _check_operand("out", out, (N, S, BLOCK, BLOCK), t.device)
    cols = sk.device_cols(t.device)
    lib = _library()
    with torch.cuda.device(t.device):
        err = lib.ell_block_outer_launch(
            _ptr(g), t.data_ptr(), _ptr(shift), _ptr(neg_out), cols.data_ptr(), out.data_ptr(),
            float(alpha), int(bool(accumulate)), N, S, K, probe_tile(K),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_block_outer")
    ell_block_outer.launches += 1
    return out


ell_block_outer.launches = 0


# --------------------------------------------------------------------------
# Halo forms: one x-slab of a row-sharded lattice.
# --------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class HaloSlab:
    """The x-planes ``[x0, x0 + planes)`` of a stencil skeleton ``sk`` as one
    slab with local indices, the form the halo kernels take.

    ``cols`` ``[n_local, S]`` int32: a column in ``[0, n_local)`` is a row of
    the slab, one in ``[−P, 0)`` a site of the plane before it (``hm``), one in
    ``[n_local, n_local + P)`` a site of the plane after it (``hp``), and
    :data:`PAD_COLUMN` is padding; ``P = Ly·Lz``.  Which plane a link reads is
    decided by its slot, not by its target: the ``−x`` link of the slab's
    first plane reads ``hm`` and the ``+x`` link of its last plane ``hp``,
    whatever planes the ring delivers there (on one rank, the slab's own last
    and first planes), as in the reference.  Built by :func:`halo_slab`, once
    per slab; the device copies are kept.
    """

    sk: Skeleton
    x0: int
    planes: int
    cols: np.ndarray
    _device_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def plane(self) -> int:
        """Sites of one x-plane (``P``)."""
        return self.sk.shape[1] * self.sk.shape[2]

    @property
    def n_local(self) -> int:
        return self.planes * self.plane

    @property
    def rows(self) -> slice:
        """The slab's rows of the whole lattice."""
        return slice(self.x0 * self.plane, (self.x0 + self.planes) * self.plane)

    @property
    def has_padding(self) -> bool:
        return bool((self.cols == PAD_COLUMN).any())

    def _copy(self, name, device, make):
        key = (name, str(torch.device(device)))
        if key not in self._device_cache:
            self._device_cache[key] = torch.as_tensor(make()).to(device)
        return self._device_cache[key]

    def device_cols(self, device):
        """``cols`` as a contiguous int32 tensor on ``device`` (what the kernels read)."""
        return self._copy("cols", device, lambda: np.ascontiguousarray(self.cols))

    def device_ext_index(self, device):
        """int64 gather indices into ``cat([hm, slab, hp])`` (padding → 0), for the plain versions."""
        return self._copy("ext", device, lambda: np.where(self.cols == PAD_COLUMN, 0, self.cols + self.plane))

    def device_valid(self, device):
        return self._copy("valid", device, lambda: self.cols != PAD_COLUMN)

    def device_mirror_index(self, device):
        return self._copy("mirror", device,
                          lambda: np.broadcast_to(self.sk.trans_slot, self.cols.shape).astype(np.int64))


def halo_slab(sk: Skeleton, x0: int, planes: int) -> HaloSlab:
    """The slab of x-planes ``[x0, x0 + planes)`` of the stencil skeleton ``sk``."""
    _require_stencil(sk)
    Lx, Ly, Lz = sk.shape
    if not (0 <= x0 and planes >= 1 and x0 + planes <= Lx):
        raise ValueError(f"planes [{x0}, {x0 + planes}) do not lie in a lattice of {Lx} x-planes")
    P = Ly * Lz
    n_local = planes * P
    glob = sk.cols[x0 * P:(x0 + planes) * P].astype(np.int64)
    local = glob - x0 * P
    plane = np.arange(n_local) // P
    for s, (axis, d) in enumerate(sk.slots):
        if axis != 0:
            continue
        edge = plane == (planes - 1 if d > 0 else 0)
        local[edge, s] = glob[edge, s] % P + (n_local if d > 0 else -P)
    local[glob < 0] = PAD_COLUMN
    real = local[local != PAD_COLUMN]
    assert real.size == 0 or (real.min() >= -P and real.max() < n_local + P)
    return HaloSlab(sk, int(x0), int(planes), local.astype(np.int32))


def _extended(slab: HaloSlab, hm, v, hp):
    """``cat([hm, v, hp])``, what the slab's gather indices address; an absent
    plane (for rows that read none) is zeros."""
    if hm is None or hp is None:
        zeros = v.new_zeros((slab.plane, *v.shape[1:]))
        hm, hp = (zeros if hm is None else hm), (zeros if hp is None else hp)
    return torch.cat([hm, v, hp])


def ell_spmm_halo_plain(data, slab: HaloSlab, v, hm, hp, rows=None):
    """Plain version of :func:`ell_spmm_halo`: ``y`` for the rows ``rows``
    (``(row0, row1)``, default all), by a gather from ``cat([hm, v, hp])``."""
    r0, r1 = (0, slab.n_local) if rows is None else rows
    idx = slab.device_ext_index(v.device)[r0:r1]
    gathered = _extended(slab, hm, v, hp)[idx]  # [R, S, 4, K]
    d = operator_values(data[r0:r1], v.dtype)
    if slab.has_padding:
        d = d * slab.device_valid(v.device)[r0:r1, :, None, None]
    R, S = idx.shape
    return torch.bmm(d.transpose(1, 2).reshape(R, BLOCK, S * BLOCK), gathered.reshape(R, S * BLOCK, -1))


def ell_cheb_step_halo_plain(data, slab: HaloSlab, t_cur, hm, hp, t_prev, inv: float, rows=None,
                             sums: bool = True):
    """Plain version of :func:`ell_cheb_step_halo`: ``(t_next, partials[1, 2K])``
    for the rows ``rows`` (``t_next`` holds those rows only)."""
    r0, r1 = (0, slab.n_local) if rows is None else rows
    hv = ell_spmm_halo_plain(data, slab, t_cur, hm, hp, (r0, r1))
    return cheb_tail_plain(hv, t_cur[r0:r1], None if t_prev is None else t_prev[r0:r1], inv, sums)


def ell_spmm_adjoint_halo_plain(data, slab: HaloSlab, v, vm, vp, dm, dp, alpha: float = 1.0,
                                add=None, axpy=()):
    """Plain version of :func:`ell_spmm_adjoint_halo`: :func:`ell_spmm_adjoint_plain`
    on ``cat([dm, data, dp])`` and ``cat([vm, v, vp])`` through the slab's table."""
    return ell_spmm_adjoint_plain(_extended(slab, dm, data, dp), _SlabGather(slab), _extended(slab, vm, v, vp),
                                  alpha, add, axpy)


def ell_block_outer_halo_plain(g, slab: HaloSlab, t, tm, tp, alpha: float = 1.0, out=None,
                               accumulate=False, shift=None, neg_out=None):
    """Plain version of :func:`ell_block_outer_halo`: ``G = g + shift ⊙ t`` on
    the slab's rows, ``t`` gathered from ``cat([tm, t, tp])``."""
    G = g
    if shift is not None:
        G = shift.to(t.dtype) * t if g is None else g + shift.to(t.dtype) * t
    if neg_out is not None:
        neg_out.copy_(-G)
    return ell_block_outer_plain(G, _SlabGather(slab), _extended(slab, tm, t, tp), alpha, out=out,
                                 accumulate=accumulate)


class _SlabGather:
    """A slab seen by the plain gather functions as a skeleton over ``cat([hm, slab, hp])``."""

    def __init__(self, slab: HaloSlab):
        self.slab, self.cols, self.has_padding = slab, slab.cols, slab.has_padding

    def device_safe_cols(self, device):
        return self.slab.device_ext_index(device)

    def device_mirror_index(self, device):
        return self.slab.device_mirror_index(device)

    def device_valid(self, device):
        return self.slab.device_valid(device)


def _check_halo(slab: HaloSlab, K: int, device, **planes):
    for name, t in planes.items():
        _check_operand(name, t, (slab.plane, BLOCK, K), device)


def _row_range(slab: HaloSlab, rows, hm, hp):
    """``(row0, row1)``; the halo planes may be absent only for rows that read none."""
    r0, r1 = (0, slab.n_local) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= r0 <= r1 <= slab.n_local:
        raise ValueError(f"rows {rows} do not lie in the slab's {slab.n_local} rows")
    if (hm is None or hp is None) and not (slab.plane <= r0 and r1 <= slab.n_local - slab.plane):
        raise ValueError("hm and hp are needed for rows of the slab's first or last plane")
    return r0, r1


def _distinct(out, *others):
    own = out.untyped_storage().data_ptr()
    return all(o is None or o.untyped_storage().data_ptr() != own for o in others)


def ell_spmm_halo(data, slab: HaloSlab, v, hm, hp, *, rows=None, out=None,
                  impl: Optional[str] = None):
    """``y = H v`` on a slab: ``y[n] = Σ_s data[n,s] · w[cols[n,s]]`` with ``w``
    the slab ``v`` ``[n_local, 4, K]`` and its neighbour planes ``hm`` / ``hp``
    ``[P, 4, K]`` (separate buffers).  ``rows=(row0, row1)`` computes those
    rows only, into ``out`` (required then); ``hm`` / ``hp`` may be ``None``
    where the rows read no halo (the interior of the overlap split).

    On a CUDA tensor this launches the kernel (``data`` in the bf16 form: the
    bf16 instantiation, counted as :func:`ell_spmm_halo_bf16`); on a CPU
    tensor, or with ``impl="plain"``, it is :func:`ell_spmm_halo_plain`."""
    r0, r1 = _row_range(slab, rows, hm, hp)
    if rows is not None and out is None:
        raise ValueError("rows= writes into a buffer of the whole slab: pass out=")
    if _resolve(impl, v) == "plain":
        y = ell_spmm_halo_plain(data, slab, v, hm, hp, (r0, r1))
        if out is None:
            return y
        out[r0:r1] = y
        return out
    N, S, K, bf16 = _check_forward(data, slab, v)
    _check_halo(slab, K, v.device, **{k: t for k, t in (("hm", hm), ("hp", hp)) if t is not None})
    if out is None:
        out = torch.empty_like(v)
    else:
        _check_operand("out", out, (N, BLOCK, K), v.device)
    if not _distinct(out, v, hm, hp):
        raise ValueError("out must not share memory with v, hm or hp (other threads read them)")
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.ell_spmm_halo_launch(
            data.data_ptr(), int(bf16), slab.device_cols(v.device).data_ptr(), v.data_ptr(),
            (hm if hm is not None else v).data_ptr(), (hp if hp is not None else v).data_ptr(),
            out.data_ptr(), N, slab.plane, r0, r1, S, K, probe_tile(K),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_spmm_halo_bf16" if bf16 else "ell_spmm_halo")
    (ell_spmm_halo_bf16 if bf16 else ell_spmm_halo).launches += 1
    return out


ell_spmm_halo.launches = 0


def ell_spmm_halo_bf16(data, slab: HaloSlab, v, hm, hp, *, rows=None, out=None, impl: Optional[str] = None):
    """:func:`ell_spmm_halo` with the operator in the bf16 form, which it requires."""
    _require_bf16(data, "ell_spmm_halo_bf16")
    return ell_spmm_halo(data, slab, v, hm, hp, rows=rows, out=out, impl=impl)


ell_spmm_halo_bf16.launches = 0


def ell_cheb_step_halo(data, slab: HaloSlab, t_cur, hm, hp, t_prev, inv: float, *, rows=None,
                       out=None, impl: Optional[str] = None):
    """The fused Chebyshev step on a slab: ``(t_next, partials)`` as
    :func:`ell_cheb_step`, with ``t_cur``'s neighbour planes ``hm`` / ``hp``
    (separate ``[P, 4, K]`` buffers).  ``rows=(row0, row1)`` computes those
    rows of ``t_next`` only, into ``out`` (required then), and the partials
    of those rows; ``hm`` / ``hp`` may be ``None`` where the rows read no
    halo.  ``out`` may be ``t_prev`` itself, never ``t_cur``, ``hm`` or ``hp``.

    On a CUDA tensor this launches the kernel (``data`` in the bf16 form: the
    bf16 instantiation, counted as :func:`ell_cheb_step_halo_bf16`); on a CPU
    tensor, or with ``impl="plain"``, it is :func:`ell_cheb_step_halo_plain`."""
    r0, r1 = _row_range(slab, rows, hm, hp)
    if rows is not None and out is None:
        raise ValueError("rows= writes into a buffer of the whole slab: pass out=")
    if _resolve(impl, t_cur) == "plain":
        t_next, pp = ell_cheb_step_halo_plain(data, slab, t_cur, hm, hp, t_prev, inv, (r0, r1))
        if out is None:
            return t_next, pp
        out[r0:r1] = t_next
        return out, pp
    N, S, K, bf16 = _check_forward(data, slab, t_cur)
    shape = (N, BLOCK, K)
    _check_halo(slab, K, t_cur.device, **{k: t for k, t in (("hm", hm), ("hp", hp)) if t is not None})
    if t_prev is not None:
        _check_operand("t_prev", t_prev, shape, t_cur.device)
    if out is None:
        out = torch.empty_like(t_cur)
    else:
        _check_operand("out", out, shape, t_cur.device)
    if not _distinct(out, t_cur, hm, hp):
        raise ValueError("out must not share memory with t_cur, hm or hp (other threads read them)")
    tk = probe_tile(K)
    n_blocks = -(-(r1 - r0) // (THREADS // tk))
    partials = torch.empty((n_blocks, 2 * K), dtype=torch.float32, device=t_cur.device)
    lib = _library()
    with torch.cuda.device(t_cur.device):
        err = lib.ell_cheb_step_halo_launch(
            data.data_ptr(), int(bf16), slab.device_cols(t_cur.device).data_ptr(), t_cur.data_ptr(),
            (hm if hm is not None else t_cur).data_ptr(), (hp if hp is not None else t_cur).data_ptr(),
            _ptr(t_prev), out.data_ptr(), partials.data_ptr(), float(inv), N, slab.plane, r0, r1,
            S, K, tk, torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_cheb_step_halo_bf16" if bf16 else "ell_cheb_step_halo")
    (ell_cheb_step_halo_bf16 if bf16 else ell_cheb_step_halo).launches += 1
    return out, partials


ell_cheb_step_halo.launches = 0


def ell_cheb_step_halo_bf16(data, slab: HaloSlab, t_cur, hm, hp, t_prev, inv: float, *, rows=None, out=None,
                            impl: Optional[str] = None):
    """:func:`ell_cheb_step_halo` with the operator in the bf16 form, which it requires."""
    _require_bf16(data, "ell_cheb_step_halo_bf16")
    return ell_cheb_step_halo(data, slab, t_cur, hm, hp, t_prev, inv, rows=rows, out=out, impl=impl)


ell_cheb_step_halo_bf16.launches = 0


def ell_spmm_adjoint_halo(data, slab: HaloSlab, v, vm, vp, dm, dp, *, alpha: float = 1.0, add=None,
                          axpy=(), out=None, impl: Optional[str] = None):
    """``y = alpha · H† v + add + Σ_j c_j ⊙ x_j`` on a slab (see
    :func:`ell_spmm_adjoint`): ``v``'s neighbour planes are ``vm`` / ``vp``
    ``[P, 4, K]`` and the operator rows of those planes ``dm`` / ``dp``
    ``[P, S, 4, 4]`` (the mirror blocks of the slab's boundary rows live
    there).  ``out`` may be ``add`` itself, never ``v``, ``vm`` or ``vp``.

    On a CUDA tensor this launches the kernel; on a CPU tensor, or with
    ``impl="plain"``, it is :func:`ell_spmm_adjoint_halo_plain`."""
    if len(axpy) > 2:
        raise ValueError("at most two axpy terms fit the kernel's epilogue")
    for d in (data, dm, dp):
        _require_complex_operator(d, "ell_spmm_adjoint_halo")
    if _resolve(impl, v) == "plain":
        return ell_spmm_adjoint_halo_plain(data, slab, v, vm, vp, dm, dp, alpha, add, axpy)
    N, S, K = _check_call(data, slab, v)
    shape = (N, BLOCK, K)
    _check_halo(slab, K, v.device, vm=vm, vp=vp)
    for name, d in (("dm", dm), ("dp", dp)):
        _check_operand(name, d, (slab.plane, S, BLOCK, BLOCK), v.device)
    if add is not None:
        _check_operand("add", add, shape, v.device)
    for c, x in axpy:
        _check_column_weights("axpy weight", c, K, v.device)
        _check_operand("axpy vector", x, shape, v.device)
    if out is None:
        out = torch.empty_like(v)
    else:
        _check_operand("out", out, shape, v.device)
    if not _distinct(out, v, vm, vp):
        raise ValueError("out must not share memory with v, vm or vp (other threads read them)")
    (c1, x1), (c2, x2) = (*axpy, (None, None), (None, None))[:2]
    mirror = slab.sk.device_trans_slot(v.device)
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.ell_spmm_adjoint_halo_launch(
            data.data_ptr(), dm.data_ptr(), dp.data_ptr(), slab.device_cols(v.device).data_ptr(),
            mirror.data_ptr(), v.data_ptr(), vm.data_ptr(), vp.data_ptr(), out.data_ptr(),
            float(alpha), _ptr(add), _ptr(x1), _ptr(c1), _ptr(x2), _ptr(c2), N, slab.plane, S, K,
            probe_tile(K), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_spmm_adjoint_halo")
    ell_spmm_adjoint_halo.launches += 1
    return out


ell_spmm_adjoint_halo.launches = 0


def ell_block_outer_halo(g, slab: HaloSlab, t, tm, tp, alpha: float = 1.0, *, out=None,
                         accumulate: bool = False, shift=None, neg_out=None,
                         impl: Optional[str] = None):
    """``H̄[n,s] (+)= α · Σ_k G[n,a,k] · conj(w[cols[n,s],b,k])`` on a slab (see
    :func:`ell_block_outer`), ``w`` the slab ``t`` with its neighbour planes
    ``tm`` / ``tp`` — in the step's backward pass the forward step's halo
    planes of ``t_cur``.  ``G = g + shift ⊙ t`` on the slab's rows.

    On a CUDA tensor this launches the kernel; on a CPU tensor, or with
    ``impl="plain"``, it is :func:`ell_block_outer_halo_plain`."""
    if accumulate and out is None:
        raise ValueError("accumulate=True needs the buffer to add into (out=)")
    if g is None and shift is None:
        raise ValueError("g and shift cannot both be absent")
    if _resolve(impl, t) == "plain":
        return ell_block_outer_halo_plain(g, slab, t, tm, tp, alpha, out=out, accumulate=accumulate,
                                          shift=shift, neg_out=neg_out)
    if not isinstance(t, torch.Tensor) or t.dim() != 3 or t.shape[1] != BLOCK:
        raise ValueError("operand must be a tensor of shape [n_local, 4, K]")
    N, S = slab.cols.shape
    K = int(t.shape[2])
    shape = (N, BLOCK, K)
    _check_operand("t", t, shape, t.device)
    _check_halo(slab, K, t.device, tm=tm, tp=tp)
    if g is not None:
        _check_operand("g", g, shape, t.device)
    if shift is not None:
        _check_column_weights("shift", shift, K, t.device)
    if neg_out is not None:
        _check_operand("neg_out", neg_out, shape, t.device)
        if not _distinct(neg_out, t, g, tm, tp):
            raise ValueError("neg_out must be a buffer of its own (g and t are read after it is written)")
    if out is None:
        out = torch.empty((N, S, BLOCK, BLOCK), dtype=t.dtype, device=t.device)
    else:
        _check_operand("out", out, (N, S, BLOCK, BLOCK), t.device)
    lib = _library()
    with torch.cuda.device(t.device):
        err = lib.ell_block_outer_halo_launch(
            _ptr(g), t.data_ptr(), tm.data_ptr(), tp.data_ptr(), _ptr(shift), _ptr(neg_out),
            slab.device_cols(t.device).data_ptr(), out.data_ptr(), float(alpha), int(bool(accumulate)),
            N, slab.plane, S, K, probe_tile(K), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "ell_block_outer_halo")
    ell_block_outer_halo.launches += 1
    return out


ell_block_outer_halo.launches = 0


# --------------------------------------------------------------------------
# The recursions, one step a call (the plain versions of the one-launch
# sweeps run them, and the sweep layer runs them on the step it chooses).
# --------------------------------------------------------------------------
def sweep_launches(order: int) -> int:
    """Fused steps of one moment sweep, ``1 + ceil((order − 2) / 2)``: the
    per-step path's launches, the moment kernel's ``.steps``."""
    return 1 + max(0, (order - 2 + 1) // 2)


_windows = {"steps": 0, "window_steps": 0, "rows": 0, "lattice_rows": 0}


def window_counts() -> dict:
    """Of the sweeps :func:`moment_recursion` ran on a light cone
    (:class:`~bodge_tpu_torch.ops.cuda_spmm.LightCone`) since
    :func:`reset_window_counts`: their ``steps``, the ``window_steps`` among
    them that ran on part of the lattice (light-cone launches, on the card),
    the ``rows`` all steps computed, and ``lattice_rows`` = N × ``steps``,
    what the whole-lattice steps would have computed.  Sweeps without a cone
    count nothing."""
    return dict(_windows)


def reset_window_counts() -> None:
    for key in _windows:
        _windows[key] = 0


def moment_recursion(step, v0, inv: float, order: int, cone=None, keep: Optional[list] = None):
    """The doubled-moment recursion one ``step`` a fused step: ``[order, K]``
    moments.  ``step(t_cur, t_prev, scale, out)`` returns ``(2·scale·H t_cur −
    t_prev, partials[rows, 2K])`` (``t_prev=None`` means zero), written into
    ``out`` where it is not ``None`` and the step takes it.  The first step is
    half-scaled; from the third on ``t_next`` goes into ``t_prev``'s buffer
    (the caller's ``v0`` is never written).  Each step's partials are reduced
    on the device and stacked at the end.

    With a light cone (:class:`~bodge_tpu_torch.ops.cuda_spmm.LightCone`) the
    step producing ``t_m`` takes a fifth argument, ``cone.rows(m)`` (``None``
    once that is the whole lattice), and the two buffers the recursion
    allocates come zeroed, so that the rows a light-cone step leaves are zero
    when the buffer comes back as ``t_prev``; the steps are counted in
    :func:`window_counts`.  With a list ``keep`` (the differentiable sweep's
    forward pass) no buffer is reused (``out`` is ``None`` from the second
    step on), every ``t_m``, ``m ≥ 1``, is appended to it, and the stacked
    column sums ``[1 + steps, 2K]`` are returned in place of the moments."""
    inv = float(inv)
    first = second = None
    if cone is not None:
        first, second = torch.zeros_like(v0), torch.zeros_like(v0)

    def run(m, t_cur, t_prev, scale, out):
        if cone is None:
            return step(t_cur, t_prev, scale, out)
        rows = cone.rows(m)
        _windows["steps"] += 1
        _windows["window_steps"] += rows is not None
        _windows["rows"] += cone.n if rows is None else rows[1] - rows[0]
        _windows["lattice_rows"] += cone.n
        return step(t_cur, t_prev, scale, out, rows)

    t_cur, pp = run(1, v0, None, 0.5 * inv, first)
    sums, t_prev = [pp.sum(dim=0)], v0
    if keep is not None:
        keep.append(t_cur)
    for i in range(sweep_launches(order) - 1):
        out = None if keep is not None else t_prev if i > 0 else second  # i == 0: t_prev is the caller's v0
        t_next, pp = run(i + 2, t_cur, t_prev, inv, out)
        sums.append(pp.sum(dim=0))
        if keep is not None:
            keep.append(t_next)
        t_prev, t_cur = t_cur, t_next
    stacked = torch.stack(sums)
    return stacked if keep is not None else moments_from_sums(stacked, v0.shape[-1], order)


def moments_from_sums(sums, K: int, order: int):
    """Moments ``[order, K]`` from the stacked column sums ``[1 + steps, 2K]``
    of a sweep (the first row is the half-scaled first step's μ0, μ1):
    ``μ_{2m} = 2⟨t_m,t_m⟩ − μ0``, ``μ_{2m+1} = 2⟨t_{m+1},t_m⟩ − μ1``."""
    mu0, mu1 = sums[0, :K], sums[0, K:]
    if sums.shape[0] == 1:
        return torch.stack([mu0, mu1])[:order]
    alphas = 2.0 * sums[1:, :K] - mu0
    betas = 2.0 * sums[1:, K:] - mu1
    rest = torch.stack([alphas, betas], dim=1).reshape(2 * (sums.shape[0] - 1), K)
    return torch.cat([mu0[None], mu1[None], rest], dim=0)[:order]


def filter_recursion(step, v, coeffs, inv: float):
    """``Σ_m c_m T_m(inv·H) v`` by the three-term recursion, one ``step`` an
    order beyond the zeroth: ``step(t_cur, t_prev, scale, out)`` returns
    ``2·scale·H t_cur − t_prev`` (``t_prev=None`` means zero), written into
    ``out`` where it is not ``None`` and the step takes it.  The first step is
    half-scaled with ``t_prev = 0``; from the third on ``t_next`` goes into
    ``t_prev``'s buffer (the caller's ``v`` is never written), and a zero
    coefficient costs no pass."""
    coeffs = [float(c) for c in coeffs]
    inv = float(inv)
    acc = coeffs[0] * v
    if len(coeffs) == 1:
        return acc
    t_cur = step(v, None, 0.5 * inv, None)  # t1 = H̃ t0
    if coeffs[1] != 0.0:
        acc.add_(t_cur, alpha=coeffs[1])
    t_prev = v
    for m, c in enumerate(coeffs[2:]):
        t_next = step(t_cur, t_prev, inv, t_prev if m > 0 else None)  # m == 0: t_prev is the caller's v
        if c != 0.0:
            acc.add_(t_next, alpha=c)
        t_prev, t_cur = t_cur, t_next
    return acc


def power_recursion(product, v, iters: int):
    """Last norm ``‖H w‖`` of ``iters`` normalised applications of ``product``
    to ``v`` (the reference's ``_power_iteration``: ``w ← H w / ‖H w‖`` from
    ``v / ‖v‖``), a 0-d real tensor; nothing is moved to the host inside the
    loop."""
    v = v / torch.linalg.norm(v)
    norm = None
    for _ in range(iters):
        w = product(v)
        norm = torch.linalg.norm(w)
        v = w / norm
    return norm.real
