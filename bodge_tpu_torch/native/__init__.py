"""Native (C++) host-runtime tier, bound via ctypes.

Counterpart of ``bodge_tpu/native``.  The device path is PyTorch and the
CUDA kernels of ``csrc/``; this package is the native host-side runtime
around it, for block data that lives in host memory:

- :func:`assemble_scatter` — fused symmetry-autofill writes over the whole
  ELL array in one parallel pass (vs. one indexed write per sub-block and
  slot).
- :func:`herm_error` — max \\|H − H†\\| without leaving the host.
- :func:`mirror_slots` — Hermitian-mirror slot resolution for generic
  (non-cubic) skeletons.

The functions take contiguous CPU NumPy arrays or CPU tensors (a CUDA tensor
raises: assembly on the card stays the indexed ``torch`` writes).  Each runs
on ``torch.get_num_threads()`` OpenMP threads.

The shared library is compiled from ``src/bodge_native.cpp`` at first use
with ``g++ -O3 -fopenmp`` (no ``-march=native``: the build directory may be
copied between machines) into the build directory of
:mod:`bodge_tpu_torch.ops._build` (``build/``), keyed by a hash of the source
and the flags.  A file lock lets one compile serve every process that asks at
once; each compiles to a name of its own and renames it into place.  Building
and loading import neither ``torch`` nor the rest of the package.  When
the build fails the error goes to stderr and :func:`available` is False:
every caller keeps its PyTorch / NumPy version for that case.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "bodge_native.cpp"
CXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the shared library of the current source and flags is built."""
    from ..ops._build import build_dir

    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return build_dir() / f"libbodge_native-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library unless it is there; the lock makes concurrent
    callers wait for one compile instead of starting their own."""
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "libbodge_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.is_file():
                tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
                cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
                try:
                    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
                except subprocess.CalledProcessError as e:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ exited with {e.returncode}:\n{e.stderr}") from e
                os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:  # no toolchain, or it failed
            print(f"[bodge_tpu_torch.native] build failed ({e}); using the PyTorch / NumPy versions",
                  file=sys.stderr)
            return None
        c_p, i32, i64, c_i = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int
        for suffix in ("c64", "c128"):
            fn = getattr(lib, f"bodge_assemble_{suffix}")
            fn.argtypes = [c_p, c_p, i64, i32, c_p, c_p, c_p, c_p, c_p, c_i, c_i]
            fn.restype = None
            fe = getattr(lib, f"bodge_herm_error_{suffix}")
            fe.argtypes = [c_p, c_p, c_p, i64, i32, c_i, c_i]
            fe.restype = ctypes.c_double
        lib.bodge_mirror_slots.argtypes = [c_p, i64, i32, c_p, c_i]
        lib.bodge_mirror_slots.restype = c_i
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the library is built and loaded (building it at the first call)."""
    return _load() is not None


def _threads() -> int:
    import torch

    return max(1, torch.get_num_threads())


def _suffix(dtype) -> str:
    dt = np.dtype(dtype)
    if dt == np.complex64:
        return "c64"
    if dt == np.complex128:
        return "c128"
    raise TypeError(f"native tier supports complex64/128, got {dt}")


def _host(a, name: str, writable: bool = False) -> np.ndarray:
    """``a`` as a C-contiguous NumPy array sharing its memory (a CPU tensor's
    own buffer); anything else raises."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name}: the native tier takes host data, got a tensor on {a.device}")
        a = a.detach().resolve_conj().numpy()
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        raise ValueError(f"{name} must be C-contiguous")
    if writable and not a.flags.writeable:
        raise ValueError(f"{name} must be writable")
    return a


def _cols(cols, N: int = None) -> np.ndarray:
    """The column table as contiguous int32 ``[N, S]``, every entry a row index or −1."""
    import torch

    if isinstance(cols, torch.Tensor):
        cols = cols.detach().cpu().numpy()
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    if cols.ndim != 2 or (N is not None and cols.shape[0] != N):
        raise ValueError(f"cols must be [N, S]{'' if N is None else f' with N = {N}'}, got {cols.shape}")
    if cols.size and (cols.min() < -1 or cols.max() >= cols.shape[0]):
        raise ValueError("cols holds an entry outside [-1, N)")
    return cols


def _ptr(arr):
    return ctypes.c_void_p(0) if arr is None else ctypes.c_void_p(arr.ctypes.data)


def assemble_scatter(data, cols, *, onsite=None, pair_onsite=None,
                     hop=None, pair=None, pair_rev=None, reset=False) -> None:
    """In-place fused symmetry scatter on host ELL data ``[N, S, 4, 4]``.

    ``onsite``/``pair_onsite``: ``[N, 2, 2]``; ``hop``/``pair``/``pair_rev``:
    ``[S-1, N, 2, 2]`` — all C-contiguous, same complex dtype as ``data``.
    Slot 0 is the diagonal block (a stencil skeleton).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    data = _host(data, "data", writable=True)
    suffix = _suffix(data.dtype)
    N = data.shape[0]
    cols = _cols(cols, N)
    S = cols.shape[1]
    if data.shape != (N, S, 4, 4):
        raise ValueError(f"data must be [N, S, 4, 4] = {(N, S, 4, 4)}, got {data.shape}")
    if (pair is None) != (pair_rev is None):
        raise ValueError("pair and pair_rev must be given together")
    args = []
    for name, a, shape in (("onsite", onsite, (N, 2, 2)), ("pair_onsite", pair_onsite, (N, 2, 2)),
                           ("hop", hop, (S - 1, N, 2, 2)), ("pair", pair, (S - 1, N, 2, 2)),
                           ("pair_rev", pair_rev, (S - 1, N, 2, 2))):
        if a is not None:
            a = _host(a, name)
            if a.dtype != data.dtype or a.shape != shape:
                raise ValueError(f"{name} must be {shape} {data.dtype}, got {a.shape} {a.dtype}")
        args.append(a)
    fn = getattr(lib, f"bodge_assemble_{suffix}")
    fn(_ptr(data), _ptr(cols), N, S, *map(_ptr, args), int(reset), _threads())


def herm_error(data, cols, trans) -> float:
    """Max \\|H − H†\\| over structural blocks of host ELL data."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    if not isinstance(data, np.ndarray):
        data = _host(data, "data")
    data = np.ascontiguousarray(data)
    suffix = _suffix(data.dtype)
    cols = _cols(cols, data.shape[0])
    N, S = cols.shape
    if data.shape != (N, S, 4, 4):
        raise ValueError(f"data must be [N, S, 4, 4] = {(N, S, 4, 4)}, got {data.shape}")
    trans = np.ascontiguousarray(trans, dtype=np.int32)
    if trans.shape not in ((S,), (N, S)) or (trans.size and (trans.min() < 0 or trans.max() >= S)):
        raise ValueError(f"trans must be [S] or [N, S] with entries in [0, S), got {trans.shape}")
    fn = getattr(lib, f"bodge_herm_error_{suffix}")
    return float(fn(_ptr(data), _ptr(cols), _ptr(trans), N, S, int(trans.ndim == 2), _threads()))


def mirror_slots(cols) -> np.ndarray:
    """Per-entry Hermitian-mirror slots; raises if structurally asymmetric."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    cols = _cols(cols)
    N, S = cols.shape
    out = np.zeros((N, S), dtype=np.int32)
    rc = lib.bodge_mirror_slots(_ptr(cols), N, S, _ptr(out), _threads())
    if rc != 0:
        raise ValueError(
            "Structurally asymmetric skeleton: some block (i,j) has no (j,i) mirror"
        )
    return out
