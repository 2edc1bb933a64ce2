"""The `Hamiltonian` operator/solver facade (PyTorch port).

Parity target: ``bodge/hamiltonian.py:5-387``.  Semantics preserved:

- Coordinate-addressed assembly through a ``with system as (H, Δ)`` context
  manager; unspecified symmetry partners are autofilled — hopping blocks get
  particle-hole partners (+v / −v*) and pairing blocks get their Hermitian
  conjugates (``bodge/hamiltonian.py:102-118``).
- Hermiticity is verified after every assembly block with the reference's
  1e-6 gate (``bodge/hamiltonian.py:120-122``).
- The sparsity skeleton is fixed at construction; re-entering the ``with``
  block updates terms in place without clearing others.
- ``matrix(format=…)`` exports dense / BSR / CSR / CSC (sparse formats have
  explicit zeros trimmed, while the *stored* matrix never does, so new
  terms can still be added later — ``bodge/hamiltonian.py:140-141``).

Storage is a padded block-ELL ``torch`` tensor ``[N, S, 4, 4]`` on one
device; assembly writes are batched indexed writes on that device; the
spectral observables run on the Chebyshev/KPM path driven by the
hand-written CUDA kernels of :mod:`bodge_tpu_torch.ops.cuda_ell`.

Device and precision policy: ``Hamiltonian(lattice, dtype=None,
device=None)`` lives on the CUDA device unless the caller asks for the CPU
(``device="cpu"``); without a card ``device=None`` raises.  The default
dtype is complex64 on the card and complex128 on the CPU.

The dense solvers (``diagonalize``, ``eigenvalues``, ``free_energy`` with
``method="dense"``, ``ldos`` / ``ldos_map`` with ``method="exact"``) run
``torch.linalg.eigh`` on the Hamiltonian's device and share one
eigendecomposition per assembled state.  ``method="banded"`` and
``method="shift_invert"`` are host tiers (LAPACK's banded routine after an RCM
relabelling; ARPACK with a sparse LU) on data pulled from the device once;
``method="lanczos"`` filters a block of vectors on the device with the fused
Chebyshev step and does the Rayleigh–Ritz algebra on the host in float64.
``save`` / ``load`` exchange checkpoints with ``bodge_tpu``.

Host-side assembly (data on the CPU) and its Hermiticity gate go through the
native C++ tier (:mod:`bodge_tpu_torch.native`) where it builds, and through
``torch`` otherwise; assembly on the card is always the indexed ``torch``
writes.  The façade's own calls always compute on the complex operator:
complex arithmetic is native on the card.  :meth:`Hamiltonian.device_operator`
hands out the planar split-complex form under ``BODGE_PLANAR=1``
(:func:`~bodge_tpu_torch.ops.planar.use_planar_device_path`) for callers of
the planar entry points (:mod:`bodge_tpu_torch.ops.planar`), which give the
complex calls' results.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .common import (
    Coord,
    Index,
    Indices,
    default_cdtype,
    resolve_device,
    torch_dtype,
    typecheck,
)
from . import native
from .lattice import CubicLattice, Lattice
from .ops import blocksparse as bs
from .ops import chebyshev
from .ops import dense as dense_ops
from .ops.blocksparse import BLOCK, Skeleton
from .ops.planar import to_planar, use_planar_device_path
from .ops.spmm import spmm as _spmm

HERMITICITY_TOL = 1e-6


class Hamiltonian:
    """Block-sparse 4N×4N Bogoliubov-de Gennes Hamiltonian on a lattice.

    The matrix acts on Lattice⊗Nambu⊗Spin space; each lattice site carries a
    4×4 block over the basis {e↑, e↓, h↑, h↓}.  Assembly can go through the
    reference-compatible ``with`` DSL::

        with system as (H, Δ):
            H[i, i] = -μ * σ0
            Δ[i, i] = Δ0 * jσ2

    or through the vectorized :meth:`assemble` fast path, where per-term
    callables are evaluated over whole coordinate arrays at once.
    """

    @typecheck
    def __init__(self, lattice: Lattice, dtype=None, device=None):
        self.lattice = lattice
        self.shape: Indices = (BLOCK * lattice.size, BLOCK * lattice.size)
        self.device = resolve_device(device)
        self.dtype = np.dtype(dtype or default_cdtype(self.device))

        if isinstance(lattice, CubicLattice):
            self._sk: Skeleton = bs.skeleton(tuple(lattice.shape))
        else:
            self._sk = bs.skeleton_from_lattice(lattice)

        N, S = self._sk.cols.shape
        self._data = torch.zeros(
            (N, S, BLOCK, BLOCK), dtype=torch_dtype(self.dtype), device=self.device
        )

        # Monotonic version for spectral-artifact caching: bumped on every
        # write path so the dense solvers reuse one eigendecomposition across
        # repeated observable queries on an unchanged Hamiltonian.
        self._version = 0
        self._eigh_cache = None

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    @property
    def data(self):
        """ELL block data ``[N, S, 4, 4]`` (complex tensor on ``self.device``)."""
        return self._data

    @property
    def skeleton(self) -> Skeleton:
        return self._sk

    def host_data(self) -> np.ndarray:
        """The complex block data as a host NumPy array."""
        return self._data.detach().cpu().numpy()

    def device_operator(self):
        """The operator in the device representation, cached per version: the
        complex block tensor on the Hamiltonian's device, or its planar form
        ``[2, N, S, 4, 4]`` float32 there under
        :func:`~bodge_tpu_torch.ops.planar.use_planar_device_path`."""
        kind = "planar" if use_planar_device_path() else "complex"
        cache = getattr(self, "_dev_cache", None)
        if cache is not None and cache[0] == self._version and cache[1] == kind:
            return cache[2]
        op = to_planar(self._data) if kind == "planar" else self._data
        self._dev_cache = (self._version, kind, op)
        return op

    @typecheck
    def index(self, row: Coord, col: Coord) -> Index:
        """Flat block index k of block (row, col): ``data.reshape(-1,4,4)[k]``.

        Analog of the reference's BSR scan (``bodge/hamiltonian.py:157-170``).
        """
        i = self.lattice[row]
        j = self.lattice[col]
        s = bs.slot_lookup(self._sk, np.array([i]), np.array([j]))[0]
        return Index(i * self._sk.n_slots + int(s))

    # ------------------------------------------------------------------
    # Assembly: reference-compatible context-manager DSL
    # ------------------------------------------------------------------
    def __enter__(self):
        self._hopp: dict = {}
        self._pair: dict = {}
        return self._hopp, self._pair

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            del self._hopp, self._pair
            return False

        hopp, pair = self._hopp, self._pair
        del self._hopp, self._pair
        self._scatter_terms(hopp, pair)
        self._check_hermitian()
        return False

    def _site_indices(self, coords: np.ndarray) -> np.ndarray:
        """Vectorized coord→site-index, falling back to the scalar API."""
        if isinstance(self.lattice, CubicLattice):
            return self.lattice.index_array(coords)
        return np.array([self.lattice.index(tuple(int(v) for v in c)) for c in coords])

    def _to_device(self, array, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(array), dtype=dtype).to(self.device)

    def _scatter_terms(self, hopp: dict, pair: dict) -> None:
        """Batched symmetry-respecting block writes for both term dicts.

        Slots are resolved on the host first (a missing block raises
        ``KeyError`` before anything is written); the writes themselves are
        indexed in-place writes on the data's device.
        """
        sk = self._sk
        writes = []

        def resolve(terms):
            ci = np.array([k[0] for k in terms.keys()], dtype=np.int64)
            cj = np.array([k[1] for k in terms.keys()], dtype=np.int64)
            vals = np.array(list(terms.values()), dtype=self.dtype)
            return self._site_indices(ci), self._site_indices(cj), vals

        if hopp:
            rows, cols, vals = resolve(hopp)
            slots = bs.slot_lookup(sk, rows, cols)
            writes.append((rows, slots, slice(0, 2), slice(0, 2), vals))
            writes.append((rows, slots, slice(2, 4), slice(2, 4), -np.conj(vals)))
        if pair:
            rows, cols, vals = resolve(pair)
            s_fwd = bs.slot_lookup(sk, rows, cols)
            s_rev = bs.slot_lookup(sk, cols, rows)
            writes.append((rows, s_fwd, slice(0, 2), slice(2, 4), vals))
            writes.append((cols, s_rev, slice(2, 4), slice(0, 2), np.conj(np.swapaxes(vals, -1, -2))))

        for rows, slots, a, b, vals in writes:
            r = self._to_device(rows, torch.int64)
            s = self._to_device(slots, torch.int64)
            self._data[r, s, a, b] = self._to_device(vals)
        self._version += 1

    # ------------------------------------------------------------------
    # Assembly: vectorized fast path
    # ------------------------------------------------------------------
    def assemble(
        self,
        *,
        onsite: Optional[Callable] = None,
        hopping: Optional[Callable] = None,
        pairing_onsite: Optional[Callable] = None,
        pairing: Optional[Callable] = None,
        reset: bool = False,
        check: bool = True,
        device: bool = True,
    ) -> "Hamiltonian":
        """Populate the Hamiltonian from batched per-term callables.

        Each callable receives coordinate arrays and returns 2×2 spin
        blocks, broadcastable to the batch:

        - ``onsite(ci)`` with ``ci: [N, 3]`` → ``[N, 2, 2]`` (or ``[2, 2]``)
        - ``hopping(ci, cj)`` over all directed structural neighbor pairs
          (bonds *and* periodic edges) → ``[B, 2, 2]``
        - ``pairing_onsite(ci)`` / ``pairing(ci, cj)`` likewise for Δ.

        Returning ``None`` from a callable (or passing ``None``) leaves the
        corresponding terms untouched.  With ``reset=True`` all stored terms
        are zeroed first.  Symmetry autofill matches the ``with`` DSL.

        The callables are evaluated on the host in NumPy; the symmetry
        writes are ``torch`` indexed writes.  ``device=True`` does them on
        the Hamiltonian's own device, ``device=False`` on a host copy that
        is uploaded in one transfer.  Either way, and for generic
        (non-stencil) lattices too, the data ends on the Hamiltonian's
        device.  Host writes on a stencil skeleton go through the native tier's fused
        scatter (:func:`bodge_tpu_torch.native.assemble_scatter`) where it
        builds: the same values, bit for bit.
        """
        sk = self._sk
        if isinstance(self.lattice, CubicLattice):
            coords_all = self.lattice.site_coords.astype(np.int64)
        elif hasattr(self.lattice, "site_coords"):  # a generic lattice offering the vectorised array
            coords_all = np.asarray(self.lattice.site_coords, dtype=np.int64)
        else:
            coords_all = np.array([c for c in self.lattice.sites()], dtype=np.int64)
        N, S = sk.cols.shape

        def as_blocks(v):
            v = np.asarray(v, dtype=self.dtype)
            if v.ndim == 2:
                v = np.broadcast_to(v, (N, 2, 2))
            return np.ascontiguousarray(v)

        def evaluate(fn, *args):
            v = fn(*args) if fn is not None else None
            return None if v is None else as_blocks(v)

        row_ids = np.arange(N)
        if sk.stencil:
            diag = (slice(None), 0)  # the diagonal block is slot 0 of every row
            off_slots = [(s, sk.cols[:, s] >= 0) for s in range(1, S)]
        else:
            # Generic skeleton: the diagonal block of row i may sit at any
            # slot, so writes are mask-driven per slot.
            diag = None
            off_slots = [
                (s, (sk.cols[:, s] >= 0) & (sk.cols[:, s] != row_ids)) for s in range(S)
            ]
            off_slots = [(s, mask) for s, mask in off_slots if mask.any()]
            if onsite is not None or pairing_onsite is not None:
                diag_hits = sk.cols == row_ids[:, None]
                if not diag_hits.any(axis=1).all():
                    raise ValueError(
                        "On-site terms require every row to have a diagonal block"
                    )
                diag = (row_ids, np.argmax(diag_hits, axis=1))

        # Evaluate all user callables host-side (NumPy) before any write, in
        # a fixed order: on-site terms, then per slot hopping, pairing and
        # the reversed pairing.
        onsite_v = evaluate(onsite, coords_all)
        pair_onsite_v = evaluate(pairing_onsite, coords_all)
        slot_terms = []  # (slot, mask, hop, pair, pair_rev)
        if hopping is not None or pairing is not None:
            for s, mask in off_slots:
                safe_cols = np.where(sk.cols[:, s] >= 0, sk.cols[:, s], 0)
                ci, cj = coords_all, coords_all[safe_cols]
                hop = evaluate(hopping, ci, cj)
                pair = evaluate(pairing, ci, cj)
                pair_rev = evaluate(pairing, cj, ci)
                if sk.stencil:  # on a stencil a None return clears the slot's term
                    zero = np.zeros((N, 2, 2), self.dtype)
                    if hopping is not None and hop is None:
                        hop = zero
                    if pairing is not None:
                        pair = zero if pair is None else pair
                        pair_rev = zero if pair_rev is None else pair_rev
                if mask.any():  # an all-padding slot is evaluated but never written
                    slot_terms.append((s, mask, hop, pair, pair_rev))

        d = self._data if device else self._data.cpu()
        if d.device.type == "cpu" and d.is_contiguous() and sk.stencil and self._native_host():
            self._scatter_native(d, onsite_v, pair_onsite_v, slot_terms, reset)
            return self._finish_assembly(d, check)

        def up(v):
            # A broadcast of one site is a read-only view: torch must not wrap it.
            return torch.as_tensor(np.require(v, requirements="W")).to(d.device)

        def dagger(v):
            return v.transpose(-1, -2).conj()

        def neg_conj(v):
            # −v*, written so that a zero entry gets the sign NumPy and C++
            # give it (torch's vectorised complex negation returns +0.0).
            return torch.complex(-v.real, v.imag)

        if reset:
            d.zero_()
        if diag is not None:
            rows_t, slot_t = diag if sk.stencil else (up(diag[0]), up(diag[1]))
            if onsite_v is not None:
                v = up(onsite_v)
                d[rows_t, slot_t, 0:2, 0:2] = v
                d[rows_t, slot_t, 2:4, 2:4] = neg_conj(v)
            if pair_onsite_v is not None:
                v = up(pair_onsite_v)
                d[rows_t, slot_t, 0:2, 2:4] = v
                d[rows_t, slot_t, 2:4, 0:2] = dagger(v)
        for s, mask, hop, pair, pair_rev in slot_terms:
            m = up(mask)[:, None, None]
            if hop is not None:
                v = up(hop)
                d[:, s, 0:2, 0:2] = torch.where(m, v, d[:, s, 0:2, 0:2])
                d[:, s, 2:4, 2:4] = torch.where(m, neg_conj(v), d[:, s, 2:4, 2:4])
            if pair is not None and pair_rev is not None:
                d[:, s, 0:2, 2:4] = torch.where(m, up(pair), d[:, s, 0:2, 2:4])
                d[:, s, 2:4, 0:2] = torch.where(m, dagger(up(pair_rev)), d[:, s, 2:4, 0:2])
        return self._finish_assembly(d, check)

    def _finish_assembly(self, d, check: bool) -> "Hamiltonian":
        self._data = d.to(self.device)
        self._version += 1
        if check:
            self._check_hermitian()
        return self

    def _native_host(self) -> bool:
        """Whether host-resident block data goes through the native tier."""
        return self.dtype in (np.complex64, np.complex128) and native.available()

    def _scatter_native(self, d, onsite_v, pair_onsite_v, slot_terms, reset: bool) -> None:
        """The symmetry writes of :meth:`assemble` on host data ``d`` of a
        stencil skeleton, in one call of the native fused scatter: the
        per-slot terms stacked into its ``[S-1, N, 2, 2]`` layout (slots that
        are padding on every row stay zero and are never written)."""
        N, S = self._sk.cols.shape

        def stacked(k):
            if not slot_terms or slot_terms[0][2 + k] is None:
                return None
            out = np.zeros((S - 1, N, 2, 2), self.dtype)
            for s, _mask, *terms in slot_terms:
                out[s - 1] = terms[k]
            return out

        native.assemble_scatter(d, self._sk.cols, onsite=onsite_v, pair_onsite=pair_onsite_v,
                                hop=stacked(0), pair=stacked(1), pair_rev=stacked(2), reset=reset)

    def _hermiticity_error(self) -> float:
        """Max |H − H†|: on the host by the native tier when the data lies on
        the CPU, else reduced on the device and moved to the host once."""
        if self._data.device.type == "cpu" and self._native_host():
            return native.herm_error(self._data, self._sk.cols, self._sk.trans_slot)
        return float(bs.hermiticity_error(self._data, self._sk))

    def _check_hermitian(self) -> None:
        if self._hermiticity_error() > HERMITICITY_TOL:
            raise RuntimeError("The constructed Hamiltonian is not Hermitian!")

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------
    @typecheck
    def matrix(self, format: str = "dense"):
        """Export the Hamiltonian in a requested matrix format.

        ``"dense"`` → NumPy array; ``"bsr"``/``"csr"``/``"csc"``/``"coo"`` →
        SciPy sparse with explicit zeros eliminated (parity with
        ``bodge/hamiltonian.py:128-155``); ``"dense_torch"`` (or the
        reference's name ``"dense_jnp"``) → dense tensor on the Hamiltonian's
        device.
        """
        if format in ("dense_torch", "dense_jnp"):
            return bs.ell_to_dense_torch(self._data, self._sk)

        if format == "dense":
            return bs.ell_to_dense(self.host_data(), self._sk)

        if format in ("bsr", "csr", "csc", "coo"):
            H = bs.ell_to_bsr(self.host_data(), self._sk)
            if format == "csr":
                H = H.tocsr()
            elif format == "csc":
                H = H.tocsc()
            elif format == "coo":
                H = H.tocoo()
            H.eliminate_zeros()
            return H

        raise RuntimeError("Requested matrix format is not yet supported")

    # ------------------------------------------------------------------
    # Operator application
    # ------------------------------------------------------------------
    def apply(self, v, *, impl: Optional[str] = None, operator_dtype=None):
        """Block-sparse product ``H @ v`` for ``v: [N, 4, K]`` (array or tensor).

        Returns a tensor on the Hamiltonian's device.  ``impl=None`` is the
        CUDA kernel on the card and the plain product on the CPU;
        ``operator_dtype="bf16"`` multiplies with the operator in the bf16
        form (:func:`bodge_tpu_torch.ops.spmm.spmm`).
        """
        v = torch.as_tensor(v).to(device=self.device, dtype=self._data.dtype)
        return _spmm(self._data, self._sk, v.contiguous(), impl=impl, operator_dtype=operator_dtype)

    # ------------------------------------------------------------------
    # Solvers
    # ------------------------------------------------------------------
    def _shift_invert(self, nev: int, sigma: float = 0.0, tol: float = 0.0):
        """The ``nev`` eigenpairs nearest ``sigma`` via host shift-invert
        ARPACK (SuperLU factorization of A − σI in complex128).

        σ=0 targets the lowest-|ε| BdG states directly — exact, and fast for
        open systems whose band fits a sparse LU.  Factorization fill grows
        with bandwidth (∝ L in 2D, ∝ L² in 3D), so beyond medium sizes use
        the device-side ``method="lanczos"`` path, which needs no
        factorization at all.  A host tier on purpose: the block data comes
        off the device once, as the CSR export.
        """
        import scipy.sparse.linalg as spla

        A = self.matrix("csr").astype(np.complex128)
        E, X = spla.eigsh(A, k=min(nev, A.shape[0] - 1), sigma=float(sigma),
                          which="LM", tol=tol)
        order = np.argsort(E, kind="stable")
        return E[order], X[:, order]

    def _cached_spectrum(self, vectors: bool):
        """The version-keyed cache entry ``(E, X)`` if it is current (and
        holds eigenvectors when ``vectors`` asks for them), else ``None``."""
        cache = self._eigh_cache
        if cache is None or cache[0] != self._version:
            return None
        if vectors and cache[2] is None:
            return None
        return cache[1], cache[2]

    def _full_spectrum(self):
        """Full ``(E, X)`` eigendecomposition as tensors on the Hamiltonian's
        device, cached per Hamiltonian version."""
        hit = self._cached_spectrum(vectors=True)
        if hit is not None:
            return hit
        E, X = torch.linalg.eigh(self.matrix(format="dense_torch"))
        self._eigh_cache = (self._version, E, X)
        return E, X

    @typecheck
    def diagonalize(
        self,
        cuda: bool = False,
        format: str = "reshape",
        method: str = "dense",
        k: Optional[int] = None,
        **solver_kwargs,
    ):
        """Positive eigenvalues and eigenvectors of the dense Hamiltonian.

        ``format="raw"``: ``(E, X)`` with eigenvectors as columns, exactly
        as a direct LAPACK call would return them.  The default
        ``"reshape"`` returns ``X[n, i, α]`` with α ∈ {e↑, e↓, h↑, h↓}
        (reference layout contract, ``bodge/hamiltonian.py:239-248``).
        Both are NumPy arrays.

        ``method="banded"`` solves the same eigenproblem through LAPACK's
        banded Hermitian routine after a bandwidth-minimizing RCM site
        relabeling — exact, and O(dim²·bandwidth) instead of O(dim³) for
        open-boundary lattices (see :mod:`bodge_tpu_torch.ops.banded`).

        ``method="lanczos"`` computes only the ``k`` smallest *positive*
        eigenpairs (the states physics queries use: minigaps, gap edges,
        bound states) by Chebyshev-filtered subspace iteration on the fused
        Chebyshev-step kernels — O(order·nnz·k) on the device instead of an
        O(dim³) factorization; see
        :func:`bodge_tpu_torch.ops.lanczos.lowest_eigenstates` for the knobs
        (``tol``, ``max_iter``, ``max_order``, ``impl``, ``operator_dtype``…).

        ``method="shift_invert"`` computes the same k states by host ARPACK
        with a SuperLU factorization of A − σI (``sigma=0`` default) — exact
        while the sparse LU fits (bandwidth ∝ L in 2D).
        """
        if cuda:
            raise RuntimeError(_CUDA_FLAG_MESSAGE)
        if method in ("lanczos", "shift_invert"):
            if k is None:
                raise ValueError(
                    f"diagonalize(method='{method}') needs k = number of "
                    "positive eigenpairs to compute"
                )
            E_all, X_all = self._lowest(method, k, solver_kwargs)
            pos = E_all > 0
            return _format_eigenpairs(E_all[pos][:k], X_all[:, pos][:, :k], format)
        if solver_kwargs:
            raise TypeError(
                f"diagonalize(method='{method}') got unexpected keywords: "
                f"{sorted(solver_kwargs)}"
            )
        if method == "banded":
            hit = self._cached_spectrum(vectors=True)
            if hit is None:
                from .ops import banded as banded_ops

                E, X = banded_ops.eigh_banded(self.host_data(), self._sk)
                hit = self._cache_spectrum(E, X)
            E, X = hit
        elif method == "dense":
            E, X = self._full_spectrum()
        else:
            raise RuntimeError(f"diagonalize method '{method}' is not supported")
        half = E.shape[0] // 2
        return _format_eigenpairs(E[half:].cpu().numpy(), X[:, half:].cpu().numpy(), format)

    def _cache_spectrum(self, E, X):
        """Keep a host-computed spectrum in the version-keyed cache, as
        tensors on the Hamiltonian's device like the dense solver's."""
        E = torch.as_tensor(E).to(self.device)
        X = None if X is None else torch.as_tensor(X).to(self.device)
        self._eigh_cache = (self._version, E, X)
        return E, X

    def _lowest(self, method: str, k: int, solver_kwargs: dict):
        """Signed lowest-|ε| eigenpairs ``(E, X)`` for the two k-state tiers.

        2k+2 are asked for: |ε| ties can split the ± signs unevenly, so a
        strict 2k request occasionally yields only k−1 positive states.
        """
        if method == "lanczos":
            from .ops import lanczos as lanczos_ops

            return lanczos_ops.lowest_eigenstates(self._data, self._sk, 2 * k + 2, **solver_kwargs)
        return self._shift_invert(2 * k + 2, **solver_kwargs)

    def eigenvalues(self, method: str = "dense", k: Optional[int] = None, **solver_kwargs):
        """Positive eigenvalues only (no eigenvectors), as a NumPy array.

        ``method="banded"`` computes the identical spectrum via LAPACK's
        banded routine (O(dim²·bandwidth)) on the host; ``method="lanczos"``
        returns only the ``k`` smallest positive eigenvalues via the
        device-side filtered subspace iteration
        (:mod:`bodge_tpu_torch.ops.lanczos`); ``method="shift_invert"`` the
        same via host ARPACK + SuperLU.  The full spectra are cached so
        repeated ``free_energy()`` calls on an unchanged Hamiltonian skip the
        solve; eigenvectors stay uncomputed until ``diagonalize()`` needs
        them.
        """
        if method in ("lanczos", "shift_invert"):
            if k is None:
                raise ValueError(
                    f"eigenvalues(method='{method}') needs k = number of "
                    "positive eigenvalues to compute"
                )
            E_all, _ = self._lowest(method, k, solver_kwargs)
            return np.asarray(E_all[E_all > 0])[:k]
        if solver_kwargs or k is not None:
            raise TypeError(f"eigenvalues(method='{method}') got unexpected keywords")
        if method not in ("dense", "banded"):
            raise RuntimeError(f"eigenvalues method '{method}' is not supported")
        hit = self._cached_spectrum(vectors=False)
        if hit is not None:
            E = hit[0]
        elif method == "banded":
            from .ops import banded as banded_ops

            E, _ = self._cache_spectrum(banded_ops.eigvalsh_banded(self.host_data(), self._sk), None)
        else:
            E = torch.linalg.eigvalsh(self.matrix(format="dense_torch"))
            self._eigh_cache = (self._version, E, None)
        return E[E.shape[0] // 2 :].cpu().numpy()

    def free_energy(
        self,
        temperature: float = 0.0,
        cuda: bool = False,
        method: str = "dense",
        **kpm_kwargs,
    ) -> float:
        """Landau free energy F = U − T·S.

        Same formulas as ``bodge/hamiltonian.py:305-319`` (Appendix C of
        Ouassou et al. PRB 109, 174506); the mean-field condensation
        constant is *not* included and must be added by the caller for
        self-consistent calculations.

        ``method="kpm"`` computes it by Chebyshev expansion of the
        free-energy integrand plus (stochastic) trace estimation —
        O(order·nnz); see :func:`bodge_tpu_torch.ops.chebyshev.free_energy_kpm`
        for the knobs (``order``, ``samples``, ``scale=``,
        ``operator_dtype=``, ``impl=``).  ``method="dense"`` sums over the positive spectrum
        of :meth:`eigenvalues`, ``"banded"`` over the same spectrum from the
        banded host solver.  The
        reference's ``cuda`` flag raises: the device is chosen with
        ``Hamiltonian(..., device=)``.
        """
        if cuda:
            raise RuntimeError(_CUDA_FLAG_MESSAGE)
        if temperature < 0:
            raise ValueError("Expected non-negative temperature!")
        if method == "kpm":
            return chebyshev.free_energy_kpm(self._data, self._sk, temperature, **kpm_kwargs)
        if method not in ("dense", "banded"):
            raise RuntimeError(f"free_energy method '{method}' is not supported")
        E = self.eigenvalues(method=method)
        return float(dense_ops.free_energy_from_spectrum(E, temperature))

    def dos(self, energies, method: str = "kpm", **kpm_kwargs) -> np.ndarray:
        """Total density of states over all 4N orbitals (KPM-based)."""
        return chebyshev.dos_kpm(self._data, self._sk, energies, **kpm_kwargs)

    def ldos(
        self,
        site: Coord,
        energies,
        method: str = "exact",
        order: Optional[int] = None,
        kernel: str = "jackson",
        **kpm_kwargs,
    ) -> np.ndarray:
        """Local density of states at ``site`` for the given energies.

        ``method="kpm"`` uses the Chebyshev/KPM expansion driven by the
        block-sparse SpMM kernels.  Extra keywords (``eta=`` for a target
        Lorentzian broadening, ``scale=``, ``operator_dtype=``, ``impl=``) are forwarded to
        :func:`bodge_tpu_torch.ops.chebyshev.ldos_kpm`.  ``method="exact"``
        evaluates the exact diagonal resolvent elements spectrally, with the
        reference's grid-adaptive broadening Γ = gradient(unique(|ε|)).
        """
        i = self.lattice[site]
        if method == "exact":
            if kpm_kwargs:
                raise TypeError(
                    f"ldos(method='exact') got unexpected KPM keywords: "
                    f"{sorted(kpm_kwargs)}"
                )
            return dense_ops.ldos_from_spectrum(*self._full_spectrum(), i, energies)
        if method == "kpm":
            return chebyshev.ldos_kpm(
                self._data, self._sk, i, energies, order=order, kernel=kernel, **kpm_kwargs
            )
        raise RuntimeError(f"LDOS method '{method}' is not supported")

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Checkpoint the assembled operator (skeleton + blocks) to ``path``."""
        from .utils.serialization import save_hamiltonian

        save_hamiltonian(self, path)

    @classmethod
    def load(cls, path: str, device=None) -> "Hamiltonian":
        """Restore a Hamiltonian checkpointed with :meth:`save` (by this
        package or by ``bodge_tpu``) onto ``device`` (``None``: the card)."""
        from .utils.serialization import load_hamiltonian

        return load_hamiltonian(path, device=device)

    def ldos_map(self, sites, energies, method: str = "exact", **kwargs) -> np.ndarray:
        """LDOS at many sites at once → ``[n_sites, n_energies]``.

        The dense path reuses one cached eigendecomposition for all sites;
        the KPM path batches all probe orbitals into a single moment sweep
        (4·n_sites probe columns per launch).
        """
        site_idx = [self.lattice[tuple(s)] if not np.isscalar(s) else int(s) for s in sites]
        if method == "exact":
            E, X = self._full_spectrum()
            return np.stack([dense_ops.ldos_from_spectrum(E, X, i, energies) for i in site_idx])
        if method == "kpm":
            return chebyshev.ldos_kpm_sites(self._data, self._sk, site_idx, energies, **kwargs)
        raise RuntimeError(f"LDOS method '{method}' is not supported")


_CUDA_FLAG_MESSAGE = (
    "The `cuda` flag is not applicable: choose the device with "
    "Hamiltonian(lattice, device='cuda') (the default) or device='cpu'."
)


def _format_eigenpairs(eigval, eigvec, format: str):
    """``(E, X)`` in the requested eigenstate layout (``"raw"`` / ``"reshape"``)."""
    if format == "raw":
        return eigval, eigvec
    if format == "reshape":
        return eigval, eigvec.T.reshape(eigval.size, -1, BLOCK)
    raise RuntimeError(f"Eigenstate format '{format}' is not yet supported.")
