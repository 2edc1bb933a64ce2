"""Self-consistent order-parameter solvers via automatic differentiation.

The reference documents that self-consistent calculations must add the
condensation energy Σ|Δ_i|²/V to ``free_energy()`` by hand and iterate
externally (``bodge/hamiltonian.py:264-269``); it provides no solver.
Because the free energy here is a differentiable ``torch`` program (dense
``eigvalsh`` or a Chebyshev/KPM trace over block-sparse products), the BCS
gap equation — the stationarity condition ∂F_total/∂Δ* = 0 — can be solved
directly by gradient descent on

    F_total(Δ) = F_BdG(H[Δ]) + Σ_i |Δ_i|² / V,

which is the domain analog of a training loop: forward = free energy,
backward = ``torch.autograd`` through the spectral solver, update = momentum
descent.

The KPM path is preferred at scale: gradients flow through the moment sweep
without the eigenvector-degeneracy pathologies of eigh derivatives
(spin-degenerate BdG spectra are the common case).  On the card the sweep is
:func:`bodge_tpu_torch.ops.cuda_spmm.moments_fused_ad`: the fused Chebyshev
step forward and the adjoint-product and block-outer-product kernels
backward.  On the CPU, or with ``impl="plain"``, it is the three-term
recursion over the plain product, differentiated by ``torch.autograd``.

Counterpart of ``bodge_tpu/models/selfconsistency.py``.  Differences on
purpose: ``key=`` is ``seed=`` (an integer; probes are drawn with NumPy);
``probes=`` and ``scale=`` let a caller hand over the very probes and
Chebyshev scale another implementation used; the Chebyshev scale gets no
gradient (it is fixed once per objective in the reference too); the
row-sharded objective is ``impl="cuda_sharded"`` (the reference's
``"pallas_sharded"``) or ``"plain_sharded"``, and it inserts the field into
each rank's slab of the natural ELL data (no packed insert).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..common import jσ2
from ..ops import blocksparse as bs
from ..ops.blocksparse import BLOCK, Skeleton
from ..ops.chebyshev import _KERNELS, chebyshev_coefficients, rademacher_probes, spectral_bound
from ..ops.cuda_spmm import moments_fused_ad, resolve_path
from ..ops.dense import free_energy_from_spectrum
from ..ops.spmm import spmm


def _like(array, data):
    """``array`` as a tensor of ``data``'s dtype on its device."""
    return torch.as_tensor(np.asarray(array)).to(device=data.device, dtype=data.dtype)


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def data_with_onsite_swave(base_data, delta, sk: Optional[Skeleton] = None):
    """Insert an on-site singlet pairing field Δ_i·jσ2 into ELL block data.

    ``delta: [N]`` complex (or real).  Differentiable in ``delta`` — the
    building block for self-consistency loops.  ``base_data`` is not
    written; the result is a new tensor.

    The diagonal block is slot 0 of every row on a stencil skeleton (and
    without ``sk``, as in the reference).  On a generic skeleton a row's
    diagonal block sits wherever its own column sorts, so ``sk`` must be
    given there and the field goes to that slot; the reference writes slot 0
    on every skeleton, which on a generic lattice is a neighbour's block.
    """
    delta = torch.as_tensor(delta, device=base_data.device)
    blk = (delta[:, None, None] * _like(jσ2, base_data)).to(base_data.dtype)
    blkH = blk.transpose(-1, -2).conj()
    data = base_data.clone()
    if sk is None or sk.stencil:
        data[:, 0, 0:2, 2:4] = blk
        data[:, 0, 2:4, 0:2] = blkH
    else:
        rows, slots = _diagonal_slots(sk, base_data.device)
        data[rows, slots, 0:2, 2:4] = blk
        data[rows, slots, 2:4, 0:2] = blkH
    return data


def _diagonal_slots(sk: Skeleton, device):
    """``(rows, slots)`` index tensors of every row's diagonal block on a generic skeleton."""

    def make():
        hits = sk.cols == np.arange(sk.n_sites)[:, None]
        if not hits.any(axis=1).all():
            raise ValueError("On-site pairing needs every row to have a diagonal block")
        return np.argmax(hits, axis=1).astype(np.int64)

    slots = sk._device_copy("diagonal_slots", device, make)
    return torch.arange(sk.n_sites, device=slots.device), slots


# ---------------------------------------------------------------------------
# Bond-singlet pairing fields (d-wave / extended-s gap equations)
# ---------------------------------------------------------------------------
def bond_structure_dwave(sk: Skeleton) -> np.ndarray:
    """Per-slot singlet structure ``[S, 2, 2]`` of the d_{x²−y²} order
    parameter on the cubic stencil: +jσ2 on x-bonds, −jσ2 on y-bonds,
    zero elsewhere — the slot-table form of the reference's ``dwave()``
    form factor ((δx²−δy²)/|δ|²)·jσ2 on unit bonds
    (``bodge/hamiltonian.py:461-484``)."""
    if not sk.stencil:
        raise ValueError("bond_structure_dwave needs a cubic stencil skeleton")
    j2 = np.asarray(jσ2, np.complex128)
    struct = np.zeros((sk.n_slots, 2, 2), np.complex128)
    for s, (axis, _d) in enumerate(sk.slots):
        if axis == 0:
            struct[s] = j2
        elif axis == 1:
            struct[s] = -j2
    return struct


def bond_structure_pwave(sk: Skeleton, dvector: str = "e_z * p_x") -> np.ndarray:
    """Per-slot triplet structure ``[S, 2, 2]`` of a p-wave order
    parameter on the cubic stencil, from the same d-vector grammar as
    :func:`bodge_tpu_torch.models.pwave` (reference ``bodge/hamiltonian.py:409-459``).

    The slot structure is odd under bond reversal — struct(+δ) = −struct(−δ)
    — which carries the triplet antisymmetry Δ(i→j) = −Δ(j→i); the bond
    amplitude from :func:`bond_field` stays symmetric, m(i→j) = (δ_i+δ_j)/2,
    so the product has exactly the reference's pwave placement for a uniform
    field."""
    from .order_parameters import pwave as _pwave

    if not sk.stencil:
        raise ValueError("bond_structure_pwave needs a cubic stencil skeleton")
    σ_p = _pwave(dvector)
    origin = np.zeros((3,))
    struct = np.zeros((sk.n_slots, 2, 2), np.complex128)
    for s, (axis, d) in enumerate(sk.slots):
        if axis < 0:
            continue
        δ = np.zeros((3,))
        δ[axis] = d
        struct[s] = σ_p(origin, δ)
    return struct


@lru_cache(maxsize=32)
def _bond_mask(sk: Skeleton) -> np.ndarray:
    """``[N, S]`` float mask of genuine nearest-neighbor bonds.

    The stencil skeleton's column table wraps at every boundary (periodic
    links are *data* zeros, not structural holes), so a bond field must
    not leak pairing onto wrap links of an open-boundary system — the
    same ``|ci − cj| == 1`` mask users apply in vectorized assembly."""
    Lx, Ly, Lz = sk.shape
    x, y, z = np.meshgrid(
        np.arange(Lx), np.arange(Ly), np.arange(Lz), indexing="ij"
    )
    coords = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    mask = np.zeros(sk.cols.shape, np.float64)
    for s, (axis, d) in enumerate(sk.slots):
        if axis < 0:
            continue
        inside = (coords[:, axis] + d >= 0) & (coords[:, axis] + d < sk.shape[axis])
        mask[:, s] = inside & (sk.cols[:, s] >= 0)
    return mask


def bond_field(delta_site, sk: Skeleton, struct=None, rows=None):
    """Directed bond amplitudes ``m: [N, S]`` from a per-site field.

    ``m(i→j) = (δ_i + δ_j)/2`` on genuine bonds, zero on wrap links,
    padding, and slots whose ``struct`` entry vanishes.  Symmetric in
    (i, j), so the inserted operator is Hermitian.  Differentiable; the
    result lies on ``delta_site``'s device (the CPU for a NumPy array).
    ``rows`` (global row indices) gives those rows only, from the whole
    field: a slab's rows and its neighbour planes' in the row-sharded
    objective."""
    mask = _bond_mask(sk)
    if struct is not None:
        active = (np.abs(np.asarray(struct)).sum(axis=(1, 2)) > 0).astype(float)
        mask = mask * active[None, :]
    d = torch.as_tensor(delta_site)
    cols, own = sk.device_safe_cols(d.device), d
    if rows is not None:
        mask = mask[np.asarray(rows)]
        rows = torch.as_tensor(np.asarray(rows), device=d.device)
        cols, own = cols[rows], d[rows]
    m = 0.5 * (own[:, None] + d[cols])
    return m * torch.as_tensor(mask).to(device=d.device, dtype=_real_dtype(m.dtype))


def data_with_bond_singlet(base_data, delta_site, sk: Skeleton, struct, rows=None):
    """Insert a bond-singlet pairing field into ELL block data.

    ``delta_site: [N]`` is a per-site amplitude; the pairing block on bond
    (i, j) at slot s is ``((δ_i+δ_j)/2)·struct[s]`` with the Hermitian
    partner ``struct[trans_slot[s]]†`` filled automatically.  ALL pairing
    sub-blocks are overwritten (on-site pairing included — pass a struct
    with a slot-0 entry to combine).  Differentiable in ``delta_site``.
    With ``rows`` (global row indices), ``base_data`` holds those rows only
    and ``delta_site`` is the whole field.
    """
    struct = np.asarray(struct)
    struct_t = _like(struct, base_data)
    structH = _like(np.conj(np.swapaxes(struct[np.asarray(sk.trans_slot)], -1, -2)), base_data)
    delta_site = torch.as_tensor(delta_site, device=base_data.device)
    m = bond_field(delta_site, sk, struct, rows).to(base_data.dtype)
    data = base_data.clone()
    data[:, :, 0:2, 2:4] = m[:, :, None, None] * struct_t[None]
    data[:, :, 2:4, 0:2] = m[:, :, None, None] * structH[None]
    return data


def _bond_weights(struct) -> np.ndarray:
    """Per-slot condensation weight w_s = ‖struct_s‖²_F / 2 (=1 for jσ2)."""
    s = np.asarray(struct)
    return (np.abs(s) ** 2).sum(axis=(1, 2)) / 2.0


def _bond_penalty(m, struct, V: float):
    """Condensation energy Σ_bonds |Δ_b|²/V from directed amplitudes
    (each undirected bond counted twice in ``m`` → the ½ below)."""
    w = torch.as_tensor(_bond_weights(struct)).to(device=m.device, dtype=_real_dtype(m.dtype))
    return (w[None, :] * m.abs() ** 2).sum() / (2.0 * V)


def _resolve_pairing(pairing, sk: Skeleton):
    """None/'swave' → on-site path; 'dwave', ('pwave', dvector), or an
    [S,2,2] array → bond path."""
    if pairing is None or (isinstance(pairing, str) and pairing in ("swave", "onsite_swave")):
        return None
    if isinstance(pairing, str):
        if pairing == "dwave":
            return bond_structure_dwave(sk)
        if pairing == "pwave":
            raise ValueError(
                "pairing='pwave' needs a d-vector: pass "
                "pairing=('pwave', 'e_z * p_x')"
            )
        raise ValueError(f"Unknown pairing '{pairing}' (use 'swave', 'dwave', "
                         "('pwave', dvector), or an [S, 2, 2] structure array)")
    if (
        isinstance(pairing, tuple)
        and len(pairing) == 2
        and pairing[0] == "pwave"
    ):
        return bond_structure_pwave(sk, pairing[1])
    if isinstance(pairing, torch.Tensor):
        pairing = pairing.detach().cpu().numpy()
    struct = np.asarray(pairing)
    if struct.shape != (sk.n_slots, 2, 2):
        raise ValueError(
            f"pairing structure must have shape {(sk.n_slots, 2, 2)}, "
            f"got {struct.shape}"
        )
    return struct


def _free_energy_dense(data, sk: Skeleton, T: float):
    E = torch.linalg.eigvalsh(bs.ell_to_dense_torch(data, sk))
    return free_energy_from_spectrum(E[E.shape[0] // 2 :], T)


def _free_energy_kpm_cuda(data, sk: Skeleton, probes, coeffs, inv_scale: float, impl="cuda"):
    """KPM free-energy trace through the fused step kernel, differentiable
    end to end: the sweep is one ``torch.autograd.Function`` with
    hand-written backward kernels
    (:class:`bodge_tpu_torch.ops.cuda_spmm.MomentSweep`), so the gap
    equation's gradient rides kernels forward and backward.  No packing pass
    exists here: the kernels take the natural tensors."""
    K = probes.shape[-1]
    mu = moments_fused_ad(data, sk, probes, inv_scale, coeffs.shape[0], impl=impl)
    acc = torch.dot(coeffs.to(mu.dtype), mu.sum(dim=1))
    return 0.5 * acc / K * (sk.n_sites * BLOCK)


def _free_energy_kpm(data, sk: Skeleton, probes, coeffs, inv_scale: float, impl):
    """KPM free-energy trace by the three-term recursion over the plain
    product, differentiated by ``torch.autograd``."""

    def H(v):
        return spmm(data, sk, v, impl=impl) * inv_scale

    def inner(a, b):
        return (a.conj() * b).sum().real

    t0 = probes
    t1 = H(probes)
    acc = coeffs[0] * inner(probes, t0) + coeffs[1] * inner(probes, t1)
    t_prev, t_cur = t0, t1
    for c_m in coeffs[2:]:
        t_next = 2.0 * H(t_cur) - t_prev
        acc = acc + c_m * inner(probes, t_next)
        t_prev, t_cur = t_cur, t_next
    return 0.5 * acc / probes.shape[-1] * (sk.n_sites * BLOCK)


def make_total_free_energy(
    system,
    V: float,
    temperature: float = 0.0,
    method: str = "dense",
    order: int = 256,
    samples: int = 32,
    seed: Optional[int] = None,
    impl: Optional[str] = None,
    mesh=None,
    overlap=None,
    delta_max: float = 2.0,
    pairing=None,
    probes=None,
    scale: Optional[float] = None,
) -> Callable:
    """Return a differentiable ``F_total(Δ)`` over a pairing field Δ.

    ``system`` supplies the normal-state Hamiltonian (its pairing blocks
    are overwritten by the field) and the device.  ``V > 0`` is the
    attractive interaction strength in F_total = F_BdG + (condensation
    term).  The returned callable takes a ``[N]`` tensor on the system's
    device and returns a 0-d tensor.

    ``pairing`` selects the order-parameter channel:

    - ``None``/"swave" (default): on-site singlet Δ_i·jσ2, condensation
      term Σ_i |Δ_i|²/V.
    - ``"dwave"``: bond singlet with the d_{x²−y²} form factor — the bond
      amplitude is (δ_i+δ_j)/2 with ±jσ2 on x/y bonds
      (:func:`bond_structure_dwave`); condensation term Σ_bonds |Δ_b|²/V.
    - ``("pwave", dvector)``: bond triplet with the d-vector grammar of
      :func:`bodge_tpu_torch.models.pwave` (:func:`bond_structure_pwave`),
      e.g. ``("pwave", "e_z * p_x")``.
    - an ``[S, 2, 2]`` array: custom per-slot bond structure.

    ``delta_max`` is the KPM paths' validity envelope: the Chebyshev scale
    is estimated once with |Δ| = delta_max headroom, and the recursion
    diverges silently if the optimizer ever drives max|Δ| beyond it.  For
    strong coupling (BCS estimate Δ ≈ 2·bandwidth·exp(−1/(V·DOS)) above
    ~2, or V ≳ 4t), raise ``delta_max`` accordingly.

    ``impl="cuda_sharded"`` (``method="kpm"``) is the row-sharded objective
    over the ranks of ``mesh`` (default :func:`~bodge_tpu_torch.parallel.make_row_mesh`
    on the system's device): every rank inserts the field into its slab and
    its neighbour planes, the moment sweep runs on the halo kernels forward
    and backward, the moment sums and the field's gradient are summed over
    the ranks, and ``overlap`` selects the interior/boundary split;
    ``"plain_sharded"`` is the same through the kernels' plain versions.

    ``impl`` (``method="kpm"``): ``None`` is the kernels for a system on the
    card (``"cuda"``, or ``"cuda_gather"`` on a generic lattice with a
    feasible window plan, ``"cuda_tiled"`` under ``BODGE_PLANE_TILED=1``) and
    ``"plain"`` on the CPU; a ``"cuda*"`` name runs the moment sweep and its
    gradient through the hand-written kernels (complex64): that step
    forward, the adjoint-product and block-outer-product kernels backward;
    ``"plain"`` runs the three-term recursion over the plain product in the
    system's own precision; ``"plain_gather"`` / ``"plain_tiled"`` the
    kernels' formulation through their plain versions.  ``seed`` draws the
    Rademacher probes with NumPy (default 11); ``probes=`` (``[N, 4, samples]``, columns normalised to unit
    length) and ``scale=`` replace the drawn probes and the estimated
    spectral bound.
    """
    sk = system.skeleton
    T = float(temperature)
    struct = _resolve_pairing(pairing, sk)

    if method == "kpm" and impl in SHARDED:
        return _make_total_free_energy_sharded(
            system, V, T, order, samples, seed, mesh=mesh, overlap=overlap, delta_max=delta_max,
            struct=struct, probes=probes, scale=scale, backend=SHARDED[impl],
        )
    if mesh is not None or overlap is not None:
        # Silently dropping these would let a user believe their solve ran
        # on a custom mesh / with the overlap split.
        raise ValueError(
            "mesh= and overlap= apply only to method='kpm', "
            "impl='cuda_sharded' or 'plain_sharded'"
        )

    base = system.data.detach()

    if struct is None:
        insert = lambda b, delta: data_with_onsite_swave(b, delta, sk)
        penalty = lambda delta: (delta.abs() ** 2).sum() / V
    else:
        insert = lambda b, delta: data_with_bond_singlet(b, delta, sk, struct)
        penalty = lambda delta: _bond_penalty(bond_field(delta, sk, struct), struct, V)

    if method == "dense":

        def F_total(delta):
            data = insert(base, delta)
            return _free_energy_dense(data, sk, T) + penalty(delta)

        return F_total

    if method == "kpm":
        rdtype = _real_dtype(base.dtype)
        # Spectral bound from a generous Δ headroom so the scale stays valid
        # across the optimization trajectory (a one-time power iteration).
        if scale is None:
            probe_delta = torch.full((sk.n_sites,), float(delta_max), dtype=base.dtype,
                                     device=base.device)
            scale = spectral_bound(insert(base, probe_delta), sk, impl=impl)
        scale = float(scale)

        if T == 0:
            g = lambda E: -np.abs(E) / 2
        else:
            g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))
        coeffs = chebyshev_coefficients(lambda x: g(scale * x), order)
        coeffs = torch.as_tensor(coeffs * _KERNELS["jackson"](order)).to(
            device=base.device, dtype=rdtype
        )
        inv = 1.0 / scale

        if probes is None:
            # Normalized Hutchinson probes: E[z z†] = I with ⟨z,z⟩ = 4N per column.
            z = rademacher_probes(sk.n_sites, samples, seed, np.float64, default_seed=11)
            probes = z / np.sqrt(sk.n_sites * BLOCK)
        z = _like(probes, base).contiguous()
        if z.shape[:2] != (sk.n_sites, BLOCK) or z.dim() != 3:
            raise ValueError(
                f"probes must have shape ({sk.n_sites}, {BLOCK}, samples), got {tuple(z.shape)}"
            )

        # The step the sweep runs: on the card the kernels the skeleton calls
        # for (the gather step on a generic lattice), on the CPU the plain
        # three-term recursion; a name asks for one path and raises where it
        # cannot run.
        if impl is None:
            impl = resolve_path(None, base, sk, z.shape[-1]) if base.is_cuda else "plain"
        elif impl != "plain":
            impl = resolve_path(impl, base, sk, z.shape[-1])
        if impl != "plain":

            def F_total(delta):
                data = insert(base, delta)
                return _free_energy_kpm_cuda(data, sk, z, coeffs, inv, impl) + penalty(delta)

            return F_total

        def F_total(delta):
            data = insert(base, delta)
            return _free_energy_kpm(data, sk, z, coeffs, inv, impl) + penalty(delta)

        return F_total

    raise ValueError(f"Unknown method '{method}'")


SHARDED = {"cuda_sharded": "cuda", "plain_sharded": "plain"}  # impl → the backend of the halo kernels


def _make_total_free_energy_sharded(system, V: float, T: float, order: int, samples: int, seed, *,
                                    mesh, overlap, delta_max: float, struct, probes, scale, backend: str):
    """``F_total(Δ)`` of :func:`make_total_free_energy` over a row mesh: the
    reference's ``_make_total_free_energy_pallas_sharded``.

    Every rank holds the whole field Δ.  It inserts Δ into the rows of its
    slab and of the planes before and after it (bond fields at the slab's
    edge read Δ of the neighbour's rows), sweeps the slab through
    :func:`~bodge_tpu_torch.parallel.cuda_sharded.moments_sharded_ad` and
    evaluates F from the moment sums of all ranks, so every rank returns the
    same F.  The gradient of the sweep term with respect to Δ is summed over
    the ranks (:class:`~bodge_tpu_torch.parallel.sharded.Replicated`); the
    condensation term is taken on the whole field and counted once.  Every
    rank must evaluate the objective and its gradient, in step."""
    from ..parallel.cuda_sharded import _require_rows_only, moments_sharded_ad, spectral_bound_sharded
    from ..parallel.sharded import Replicated, RowSharding, make_row_mesh

    sk = system.skeleton
    if not sk.stencil:
        raise ValueError("the row-sharded objective needs a cubic lattice (a stencil skeleton)")
    rs = RowSharding(sk, make_row_mesh(devices=system.device) if mesh is None else mesh)
    _require_rows_only(rs)
    N, P, n_local = sk.n_sites, rs.slab.plane, rs.slab.n_local
    before, after = rs.halo_rows()
    rows = np.concatenate([before, np.arange(N)[rs.slab.rows], after])
    dev = rs.device
    base = system.data.detach()[torch.as_tensor(rows, device=system.data.device)].to(dev)

    if struct is None:
        insert = lambda b, delta: data_with_onsite_swave(b, delta[torch.as_tensor(rows, device=dev)])
        penalty = lambda delta: (delta.abs() ** 2).sum() / V
    else:
        insert = lambda b, delta: data_with_bond_singlet(b, delta, sk, struct, rows)
        penalty = lambda delta: _bond_penalty(bond_field(delta, sk, struct), struct, V)

    def slabs(data_ext):
        """``(slab, dm, dp)`` of the inserted rows."""
        return data_ext[P:P + n_local], data_ext[:P], data_ext[P + n_local:]

    if scale is None:
        headroom = torch.full((N,), float(delta_max), dtype=base.dtype, device=dev)
        scale = spectral_bound_sharded(rs, slabs(insert(base, headroom))[0], impl=backend)
    scale = float(scale)
    if T == 0:
        g = lambda E: -np.abs(E) / 2
    else:
        g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))
    coeffs = chebyshev_coefficients(lambda x: g(scale * x), order) * _KERNELS["jackson"](order)
    coeffs = torch.as_tensor(coeffs).to(device=dev, dtype=_real_dtype(base.dtype))
    if probes is None:
        z = rademacher_probes(N, samples, seed, np.float64, default_seed=11)
        probes = z / np.sqrt(N * BLOCK)
    z = _like(probes, base)
    if z.shape[:2] != (N, BLOCK) or z.dim() != 3:
        raise ValueError(f"probes must have shape ({N}, {BLOCK}, samples), got {tuple(z.shape)}")
    z_l = rs.shard_vector(z)
    K = z_l.shape[-1]

    def F_total(delta):
        delta = torch.as_tensor(delta, device=dev)
        slab, dm, dp = slabs(insert(base, Replicated.apply(delta, rs)))
        mu = moments_sharded_ad(rs, slab, z_l, 1.0 / scale, order, dm, dp, overlap=overlap, impl=backend,
                                remat="auto")  # √steps checkpointing, as the reference's objective asks
        F = 0.5 * torch.dot(coeffs.to(mu.dtype), mu.sum(dim=1)) / K * (N * BLOCK)
        return F + penalty(delta)

    return F_total


def solve_gap(
    system,
    V: float,
    temperature: float = 0.0,
    delta0=0.2,
    steps: int = 300,
    learning_rate: float = 0.05,
    method: str = "dense",
    uniform: bool = False,
    **kwargs,
) -> Tuple[np.ndarray, float]:
    """Minimize F_total over the pairing field Δ_i by gradient descent.

    Returns ``(Δ, F_total(Δ))`` with Δ a NumPy array ``[N]``.  With
    ``uniform=True`` a single scalar gap is optimized (broadcast over
    sites) — the homogeneous BCS problem.  Extra keywords go to
    :func:`make_total_free_energy`.

    ``learning_rate`` acts on the EXTENSIVE objective: the uniform-gap
    gradient scales like N · (per-site gradient), so on large lattices
    scale the rate like 1/N (e.g. ``learning_rate=15/N``) or the momentum
    loop diverges.

    The loop runs on the system's device and moves nothing to the host
    until it ends.
    """
    F_total = make_total_free_energy(system, V, temperature, method=method, **kwargs)
    N = system.skeleton.n_sites
    device = system.device
    cdtype = system.data.dtype
    rdtype = _real_dtype(cdtype)

    # Optimize a REAL gap field (the global U(1) phase is a gauge choice;
    # complex / phase-textured problems should drive F_total directly).
    if uniform:
        x0 = np.real(np.atleast_1d(delta0))[:1]
        expand = lambda x: x.expand(N).to(cdtype)
    else:
        x0 = np.broadcast_to(np.real(delta0), (N,))
        expand = lambda x: x.to(cdtype)
    x = torch.as_tensor(np.array(x0)).to(device=device, dtype=rdtype)

    # Plain momentum descent keeps dependencies light; for custom loops
    # (torch.optim, complex fields) use make_total_free_energy directly.
    m = torch.zeros_like(x)
    for _ in range(steps):
        x.requires_grad_(True)
        (grad,) = torch.autograd.grad(F_total(expand(x)), x)
        with torch.no_grad():
            m = 0.9 * m + grad
            x = x - learning_rate * m

    with torch.no_grad():
        F = float(F_total(expand(x)))
        delta = expand(x).cpu().numpy()
    return delta, F
