"""The Rademacher probe block drawn on the card, bit for bit NumPy's draw, with its plain version.

:func:`rademacher` gives the ``[N, 4, samples]`` block of ±1 that
:func:`~bodge_tpu_torch.ops.chebyshev.rademacher_probes` draws on the host —
``2 * numpy.random.default_rng(seed).integers(0, 2, size) - 1`` — as complex64
or float32, written on the card by one launch of ``csrc/rademacher.cu``: no
block is drawn, cast or uploaded on the host.  The reference draws these
probes on the host too; no TPU kernel is replaced.

How the bits are kept: ``default_rng(seed)`` is PCG64 on the 128-bit state and
increment NumPy's ``SeedSequence`` makes of the seed (:func:`pcg64_state`, on
the host, microseconds).  For a range of one, ``integers`` returns bit 31 of
each 32-bit half of the 64-bit outputs, low half first, and never rejects, so
entry 2j of the flat block is bit 31 of output j and entry 2j+1 its bit 63.
PCG64 is an LCG underneath, so the state ``d`` draws ahead is one affine map
of the state now (:func:`jump`, O(log d)): thread t of T jumps by t + 1 and
then steps by T, and the draw runs on every thread at once.  Why this is
bound by the bytes written, and how the stores are laid out, is said at the
top of the source.

:func:`rademacher_plain` is the kernel's own algorithm in NumPy — the
per-thread jump, the stride T of :func:`draw_plan`, the two bit positions — on
128-bit numbers held as two ``uint64`` arrays; the tests hold it against
:func:`~bodge_tpu_torch.ops.chebyshev.rademacher_probes`, and ``chip_smoke.py``
the kernel against both.  The wrapper counts its launches in
``rademacher.launches``, kept out of
:func:`~bodge_tpu_torch.ops.cuda_spmm.launch_counts`, which counts the sweeps'
kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import numpy_dtype
from . import _build
from .blocksparse import BLOCK
from .cuda_ell import DEFAULT_SMS, _raise_on, sm_count

MULT = 0x2360ED051FC65DA44385DF649FCCF645  # PCG64's multiplier
MASK128 = (1 << 128) - 1
THREADS = 256  # threads per block in csrc/rademacher.cu
BLOCKS_PER_SM = 4  # blocks launched per SM at most: 1024 threads a SM keep its stores streaming
DTYPES = (torch.complex64, torch.float32)  # what the kernel writes

_M32 = np.uint64(0xFFFFFFFF)


def pcg64_state(seed: int) -> Tuple[int, int]:
    """``(state, inc)``: the 128-bit state and increment of
    ``numpy.random.default_rng(seed)``'s PCG64 before its first draw."""
    st = np.random.PCG64(int(seed)).state["state"]
    return int(st["state"]), int(st["inc"])


def jump(delta: int, inc: int, mult: int = MULT) -> Tuple[int, int]:
    """``(A, C)`` with ``s_{j+delta} = A·s_j + C`` (mod 2¹²⁸): ``delta`` steps of
    ``s ← s·mult + inc`` composed by binary squaring, as the kernel jumps."""
    acc_mult, acc_plus = 1, 0
    while delta:
        if delta & 1:
            acc_mult = acc_mult * mult & MASK128
            acc_plus = (acc_plus * mult + inc) & MASK128
        inc = (mult + 1) * inc & MASK128
        mult = mult * mult & MASK128
        delta >>= 1
    return acc_mult, acc_plus


def draw_plan(pairs: int, sms: int = DEFAULT_SMS) -> int:
    """Blocks of :data:`THREADS` the kernel launches for ``pairs`` outputs: one
    output a thread up to :data:`BLOCKS_PER_SM` blocks on each SM, more
    outputs a thread beyond.  The stride T is ``blocks · THREADS``."""
    return max(1, min(-(-pairs // THREADS), sms * BLOCKS_PER_SM))


def _halves(x: int):
    return np.uint64(x >> 64), np.uint64(x & 0xFFFFFFFFFFFFFFFF)


def _mul64(a, b):
    """The full 128-bit product of ``uint64`` arrays, as ``(hi, lo)``."""
    a0, a1, b0, b1 = a & _M32, a >> np.uint64(32), b & _M32, b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    return p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32)), a * b


def _muladd(a, b, c):
    """``a·b + c`` mod 2¹²⁸ on ``(hi, lo)`` pairs of ``uint64`` arrays."""
    hi, lo = _mul64(a[1], b[1])
    hi = hi + a[1] * b[0] + a[0] * b[1]
    out_lo = lo + c[1]
    return hi + c[0] + (out_lo < lo).astype(np.uint64), out_lo


def _output(s):
    """PCG64's XSL-RR output of states ``(hi, lo)``: ``rotr64(hi ^ lo, hi >> 58)``."""
    x, r = s[0] ^ s[1], s[0] >> np.uint64(58)
    return (x >> r) | (x << ((np.uint64(64) - r) & np.uint64(63)))


def rademacher_plain(N: int, samples: int, seed: Optional[int], dtype, default_seed: int = 42,
                     blocks: Optional[int] = None) -> np.ndarray:
    """The kernel's draw in NumPy: ``[N, 4, samples]`` of ±1 in ``dtype``, thread t
    of ``T = blocks · THREADS`` (``blocks``: :func:`draw_plan`'s) jumping by
    t + 1 and stepping by T.  Equal, for any ``blocks``, to
    :func:`~bodge_tpu_torch.ops.chebyshev.rademacher_probes`."""
    pairs = N * BLOCK * samples // 2
    T = (draw_plan(pairs) if blocks is None else int(blocks)) * THREADS
    state, inc = pcg64_state(default_seed if seed is None else seed)
    bits = np.empty((pairs, 2), dtype=np.int64)
    with np.errstate(over="ignore"):
        d = np.arange(1, min(T, pairs) + 1, dtype=np.uint64)  # thread t jumps by t + 1
        one = np.ones_like(d)
        acc_mult, acc_plus = (0 * one, one), (0 * one, 0 * one)
        mult, plus = MULT, inc  # the same for every thread: Python integers
        while d.any():
            take = (d & np.uint64(1)).astype(bool)
            m, p = _halves(mult), _halves(plus)
            new_mult = _muladd(acc_mult, m, (np.uint64(0), np.uint64(0)))
            new_plus = _muladd(acc_plus, m, p)
            acc_mult = tuple(np.where(take, n, o) for n, o in zip(new_mult, acc_mult))
            acc_plus = tuple(np.where(take, n, o) for n, o in zip(new_plus, acc_plus))
            plus, mult = (mult + 1) * plus & MASK128, mult * mult & MASK128
            d >>= np.uint64(1)
        s = _muladd(acc_mult, _halves(state), acc_plus)
        step = tuple(_halves(v) for v in jump(T, inc))
        for j0 in range(0, pairs, T):
            n = min(T, pairs - j0)
            x = _output((s[0][:n], s[1][:n]))
            bits[j0:j0 + n, 0] = (x >> np.uint64(31)) & np.uint64(1)
            bits[j0:j0 + n, 1] = x >> np.uint64(63)
            s = _muladd(s, step[0], step[1])
    return (2.0 * bits.reshape(N, BLOCK, samples) - 1.0).astype(dtype)


_bound = None


def _library():
    global _bound
    if _bound is None:
        fn = _build.load("rademacher").rademacher_launch
        u, ll, i, p = ctypes.c_ulonglong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes, fn.restype = [u] * 8 + [ll, i, i, p, p], i
        _bound = fn
    return _bound


def rademacher(N: int, samples: int, seed: Optional[int], dtype, device, default_seed: int = 42) -> torch.Tensor:
    """``[N, 4, samples]`` of ±1 in ``dtype`` (complex64 or float32) on ``device``:
    the block of :func:`~bodge_tpu_torch.ops.chebyshev.rademacher_probes` for
    ``seed`` (``None`` → ``default_seed``), bit for bit.

    On a CUDA device this is one launch of the kernel, counted in
    ``rademacher.launches``; on the CPU it is :func:`rademacher_plain`.
    Another dtype raises ``TypeError``."""
    if dtype not in DTYPES:
        raise TypeError(f"the probe kernel writes complex64 or float32, not {dtype}")
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(rademacher_plain(N, samples, seed, numpy_dtype(dtype), default_seed))
    out = torch.empty((N, BLOCK, samples), dtype=dtype, device=device)
    pairs = out.numel() // 2
    state, inc = pcg64_state(default_seed if seed is None else seed)
    with torch.cuda.device(device):
        blocks = draw_plan(pairs, sm_count())
        step_mult, step_plus = jump(blocks * THREADS, inc)
        halves = [h for v in (state, inc, step_mult, step_plus) for h in (v >> 64, v & 0xFFFFFFFFFFFFFFFF)]
        err = _library()(*halves, pairs, int(dtype == torch.complex64), blocks, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "rademacher")
    rademacher.launches += 1
    return out


rademacher.launches = 0
