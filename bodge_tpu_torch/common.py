"""Shared constants, type aliases, and small utilities.

API parity target: the reference exposes Pauli matrices, their imaginary
versions, π, ASCII aliases, and coordinate/matrix type aliases from
``bodge/common.py:13-61``.  We keep the *host-side* constants as NumPy
complex128 arrays so that user scripts written against the reference work
unchanged (``H[i, i] = -μ * σ0`` etc. are host-side expressions).  The
device and precision policy of the PyTorch port lives at the bottom.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Iterator, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Runtime type checking.
#
# The reference decorates every public method with beartype
# (`bodge/common.py:9`).  beartype is preferred when installed; otherwise a
# small vendored checker enforces the same contract for the annotation
# forms this API actually uses (scalar builtins, Coord/Coords tuples,
# Optional/Union, ndarray) and skips anything it cannot interpret.
# Disable with BODGE_TYPECHECK=0.
# --------------------------------------------------------------------------
def _vendored_typecheck():
    import inspect
    import typing

    def matches(value, ann) -> bool:
        if ann is None or ann is type(None):
            return value is None
        if ann is typing.Any:
            return True
        origin = typing.get_origin(ann)
        if origin is typing.Union:
            return any(matches(value, a) for a in typing.get_args(ann))
        if origin is tuple:
            if not isinstance(value, tuple):
                return False
            args = typing.get_args(ann)
            if len(args) == 2 and args[1] is Ellipsis:
                return all(matches(v, args[0]) for v in value)
            if args and len(args) != len(value):
                return False
            return all(matches(v, a) for v, a in zip(value, args))
        if origin is not None:  # other generics (Iterator, list[...], …)
            try:
                return isinstance(value, origin)
            except TypeError:
                return True
        if isinstance(ann, type):
            if ann is int:
                return isinstance(value, (int, np.integer)) and not isinstance(value, bool)
            if ann is float:
                return isinstance(value, (int, float, np.integer, np.floating)) and not isinstance(
                    value, bool
                )
            if ann is complex:
                return isinstance(
                    value, (int, float, complex, np.integer, np.floating, np.complexfloating)
                ) and not isinstance(value, bool)
            try:
                return isinstance(value, ann)
            except TypeError:
                return True
        return True  # string forwards / unresolvable annotations: skip

    def typecheck(fn):
        if os.environ.get("BODGE_TYPECHECK") == "0":
            return fn
        sig = inspect.signature(fn)
        hints_cache = {}

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if "h" not in hints_cache:
                try:  # resolve PEP-563 string annotations once, lazily
                    hints_cache["h"] = typing.get_type_hints(fn)
                except Exception:
                    hints_cache["h"] = {}
            hints = hints_cache["h"]
            if hints:
                bound = sig.bind(*args, **kwargs)
                for name, value in bound.arguments.items():
                    ann = hints.get(name)
                    if ann is None:
                        continue
                    param = sig.parameters[name]
                    if param.kind in (
                        inspect.Parameter.VAR_POSITIONAL,
                        inspect.Parameter.VAR_KEYWORD,
                    ):
                        continue
                    if not matches(value, ann):
                        raise TypeError(
                            f"{fn.__qualname__}(): argument {name}={value!r} does not "
                            f"match annotation {ann}"
                        )
            return fn(*args, **kwargs)

        return wrapper

    return typecheck


try:  # pragma: no cover - depends on environment
    from beartype import beartype as typecheck  # type: ignore
except ImportError:
    typecheck = _vendored_typecheck()


# --------------------------------------------------------------------------
# Coordinate and index aliases (parity with bodge/common.py:13-16).
# --------------------------------------------------------------------------
Index = int
Coord = Tuple[int, int, int]
Indices = Tuple[Index, Index]
Coords = Tuple[Coord, Coord]

# --------------------------------------------------------------------------
# Matrix-format aliases (parity with bodge/common.py:19-25).  We re-export
# the SciPy sparse types because `matrix(format=...)` hands back SciPy
# objects for interoperability, exactly like the reference does.  They are
# looked up at first use (module __getattr__): importing scipy.sparse takes
# about half a second, which every process importing the package — each
# rank of a process group among them — would otherwise pay.
# --------------------------------------------------------------------------
Matrix = np.ndarray
_SCIPY_ALIASES = {
    "CooMatrix": "coo_matrix",
    "DiaMatrix": "dia_matrix",
    "BsrMatrix": "bsr_matrix",
    "CsrMatrix": "csr_matrix",
    "CscMatrix": "csc_matrix",
    "SpMatrix": "spmatrix",
}


def __getattr__(name):
    if name in _SCIPY_ALIASES:
        import scipy.sparse

        return getattr(scipy.sparse, _SCIPY_ALIASES[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# --------------------------------------------------------------------------
# Fundamental constants (parity with bodge/common.py:28-61).
# --------------------------------------------------------------------------
π = np.pi

σ0: Matrix = np.array([[1, 0], [0, 1]], dtype=np.complex128)
σ1: Matrix = np.array([[0, 1], [1, 0]], dtype=np.complex128)
σ2: Matrix = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
σ3: Matrix = np.array([[1, 0], [0, -1]], dtype=np.complex128)

σ = np.stack([σ1, σ2, σ3])

jσ0: Matrix = 1j * σ0
jσ1: Matrix = 1j * σ1
jσ2: Matrix = 1j * σ2
jσ3: Matrix = 1j * σ3

jσ = np.stack([jσ1, jσ2, jσ3])

# ASCII aliases.
pi = π

sigma0 = σ0
sigma1 = σ1
sigma2 = σ2
sigma3 = σ3
sigma = σ

jsigma0 = jσ0
jsigma1 = jσ1
jsigma2 = jσ2
jsigma3 = jσ3
jsigma = jσ


# --------------------------------------------------------------------------
# Device and precision policy.
#
# Every entry point that touches the operator runs on the CUDA device unless
# the caller asks for the CPU: ``device=None`` means ``"cuda"`` and raises
# when there is none; nothing carries on on the CPU by itself.  The default
# complex dtype is complex64 on the card (the throughput path; the
# hand-written kernels take complex64 only) and complex128 on the CPU (the
# parity mode the tests run in).
# --------------------------------------------------------------------------
def resolve_device(device=None):
    """``torch.device`` for an entry point: the card unless the CPU is asked for."""
    import torch

    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available. bodge_tpu_torch runs on the GPU by "
            "default; pass device='cpu' to run on the CPU explicitly."
        )
    return device


def default_cdtype(device=None):
    """The default complex dtype for Hamiltonian storage on ``device``."""
    import torch

    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    return np.complex64 if on_card else np.complex128


def default_rdtype(device=None):
    """The default real dtype matching :func:`default_cdtype`."""
    return np.float32 if default_cdtype(device) == np.complex64 else np.float64


def device_pauli(dtype=None, device=None):
    """The Pauli matrices (σ0..σ3) stacked as ``[4, 2, 2]``, a tensor on
    ``device`` (``None``: the card, as :func:`resolve_device`) of ``dtype``
    (default :func:`default_cdtype` of that device): constants for assembly
    callables written in ``torch``, made once instead of per call."""
    import torch

    device = resolve_device(device)
    dtype = torch_dtype(dtype or default_cdtype(device))
    return torch.as_tensor(np.stack([σ0, σ1, σ2, σ3])).to(device=device, dtype=dtype)


def torch_dtype(dtype):
    """The ``torch.dtype`` for a NumPy dtype (or a ``torch.dtype`` unchanged)."""
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def numpy_dtype(dtype):
    """The NumPy dtype for a ``torch.dtype`` (or a NumPy dtype unchanged)."""
    import torch

    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)
