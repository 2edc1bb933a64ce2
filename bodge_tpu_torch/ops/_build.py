"""Build and load the CUDA kernels of ``bodge_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``<build dir>/<name>-<hash>.so`` at first use, then
loaded with :mod:`ctypes`.  The hash covers every source under ``csrc/`` and
the compiler flags, so an edited source rebuilds and an unchanged one is
reused.  The build directory is ``build/`` beside the package (listed in
``.gitignore``), or ``$BODGE_TORCH_BUILD_DIR``.

Nothing here runs at import time: the first kernel launch (or an explicit
:func:`build_all`) triggers the build.  A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_libraries: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("BODGE_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build"


def find_nvcc() -> str:
    candidates = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)
    ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of bodge_tpu_torch are compiled from source at first use."
    )


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return build_dir() / f"{name}-{_source_hash()}.so"


def _start_compile(name: str, extra_flags=()):
    """Start ``nvcc`` for one source; returns ``(process, tmp path, target)``."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise RuntimeError(f"No kernel source {src}")
    target = _target(name)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_compile(name: str, proc, tmp: Path, target: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent build sees a whole file or none
    return out


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source that is not built yet, all ``nvcc``
    processes started together.  Returns ``{"seconds", "built", "log"}``;
    with ``verbose`` the compiler prints each kernel's registers and spills."""
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose else ()
    todo = [n for n in sources() if verbose or not _target(n).is_file()]
    started = [(n, *_start_compile(n, extra)) for n in todo]
    log = {n: _finish_compile(n, proc, tmp, target) for n, proc, tmp, target in started}
    return {"seconds": time.perf_counter() - t0, "built": todo, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _libraries.get(name)
    if lib is None:
        target = _target(name)
        if not target.is_file():
            _finish_compile(name, *_start_compile(name))
        lib = _libraries[name] = ctypes.CDLL(str(target))
    return lib
