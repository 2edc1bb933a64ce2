"""Row-partitioned block-sparse operators over ``torch.distributed`` ranks.

Counterpart of ``bodge_tpu/parallel/sharded.py``.  The lattice's leading
(x) axis is block-partitioned over the ranks of a row mesh, giving each rank
a contiguous slab of x-planes.  Because the flat site index is x-major, a
slab is a contiguous block of rows of the ELL data and of every probe block.

The stencil product needs one x-plane of the operand from each neighbour
rank per application.  :meth:`RowSharding.exchange` sends them around the
ring of ranks (``batch_isend_irecv``); the ring wrap delivers rank P−1's last
plane to rank 0, which is the periodic partner plane, so periodic and open
boundaries work unmodified (open boundaries have zero wrap blocks).  On one
rank the ring is a local copy.  The kernels take the two planes as separate
buffers (:class:`~bodge_tpu_torch.ops.cuda_ell.HaloSlab`), so the slab is
never copied.  Reductions (Chebyshev inner products, trace estimates) are
``all_reduce`` over the same ranks.

Backends.  NCCL carries CUDA tensors directly and needs one card per rank:
:func:`make_row_mesh` refuses two NCCL ranks on one card.  Gloo carries host
tensors: with CUDA tensors the halo planes and the reductions pass through
pinned host buffers (the kernels stay on the card) — a property of that
backend's exchange, said once in the log, which lets several ranks share one
card.  Nothing here swaps one backend for another: the process group the
caller made is the one used.

The reference's planar split-complex variants are not carried over.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..common import numpy_dtype
from ..ops.blocksparse import Skeleton
from ..ops.chebyshev import _KERNELS, _doubled_moment_scan, chebyshev_coefficients, rademacher_probes
from ..ops.cuda_ell import HaloSlab, ell_spmm_halo, halo_slab
from ..ops.planar import complex_operator, is_planar

AXIS = "rows"
PROBE_AXIS = "probes"

_log = logging.getLogger(__name__)
_said_staging = False


@dataclass(frozen=True, eq=False)
class RowMesh:
    """This rank's place in a ``rows`` × ``probes`` grid of ranks.

    ``shape`` maps the axis names to their sizes; ``row`` / ``probe`` are this
    rank's coordinates; ``rows_group`` joins the ranks of this rank's probe
    column (the ring and the row reductions run there) and ``probes_group``
    those of its row (``None`` on an axis of size one).  ``row_ranks`` are the
    global ranks of the rows group in row order.  ``device`` is where this
    rank's slabs live, ``backend`` the process group's backend (``None`` for
    a world of one).
    """

    shape: dict
    row: int
    probe: int
    rows_group: object
    probes_group: object
    row_ranks: Tuple[int, ...]
    device: torch.device
    backend: Optional[str]


def _rank_device(devices) -> torch.device:
    """This rank's device: ``devices`` (one, or one per rank) or the card of the local rank."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is not None:
        if isinstance(devices, (str, torch.device)):
            return torch.device(devices)
        return torch.device(list(devices)[rank])
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_row_mesh() places slabs on a CUDA card by default and none is present: "
            "pass devices='cpu' to run the plain versions on the CPU"
        )
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _refuse_shared_nccl_cards(device: torch.device, world: int):
    """NCCL cannot run two ranks on one card ("Duplicate GPU detected"): find
    out through a gloo side group, and raise on every rank alike."""
    side = dist.new_group(backend="gloo")
    props = torch.cuda.get_device_properties(device)
    key = (socket.gethostname(), str(getattr(props, "uuid", device.index)))
    keys = [None] * world
    dist.all_gather_object(keys, key, group=side)
    dist.destroy_process_group(side)
    if len(set(keys)) < world:
        raise ValueError(
            "an NCCL process group with two ranks on one card: NCCL refuses that "
            "(\"Duplicate GPU detected\"); give each rank its own card, or make the "
            "process group with backend='gloo' to share a card"
        )


def make_row_mesh(n_devices: Optional[int] = None, devices=None, probe_shards: int = 1) -> RowMesh:
    """The mesh of ranks over which lattice rows (x-slabs) are partitioned.

    With no process group initialised (or ``n_devices=1``) it is a world of
    one.  Otherwise it spans every rank of the default group: ``n_devices``,
    where given, must equal the world size.  With ``probe_shards > 1`` a
    second axis partitions the probe columns (the data-parallel analog): the
    grid is ``(world/probe_shards, probe_shards)`` with axes ``(rows,
    probes)``, rank ``r`` at row ``r // probe_shards``.  Every rank must call
    this, in the same order as its other collective calls.  ``devices`` is
    this rank's device, or a sequence of one device per rank; by default
    the card ``LOCAL_RANK`` (or the rank) modulo the cards present.
    """
    device = _rank_device(devices)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices == 1 or world == 1:
        if probe_shards > 1:
            raise ValueError(f"1 device does not split into {probe_shards} probe shards")
        return RowMesh({AXIS: 1}, 0, 0, None, None, (dist.get_rank() if dist.is_initialized() else 0,),
                       device, dist.get_backend() if dist.is_initialized() else None)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} differs from the {world} ranks of the process group")
    if world % probe_shards != 0:
        raise ValueError(f"{world} devices do not split into {probe_shards} probe shards")
    backend = dist.get_backend()
    if backend == "nccl":
        _refuse_shared_nccl_cards(device, world)
    rank, ps = dist.get_rank(), probe_shards
    n = world // ps
    rows_group, probes_group = None, None
    if ps == 1:
        rows_group = dist.group.WORLD
    else:
        for p in range(ps):  # every rank makes every group, in one order
            g = dist.new_group([i * ps + p for i in range(n)])
            if p == rank % ps:
                rows_group = g
        for i in range(n):
            g = dist.new_group([i * ps + j for j in range(ps)])
            if i == rank // ps:
                probes_group = g
    shape = {AXIS: n, PROBE_AXIS: ps} if ps > 1 else {AXIS: n}
    row_ranks = tuple(i * ps + rank % ps for i in range(n))
    return RowMesh(shape, rank // ps, rank % ps, rows_group, probes_group, row_ranks, device, backend)


@dataclass(frozen=True, eq=False)
class RowSharding:
    """An x-axis row partition of a cubic lattice over a :class:`RowMesh`:
    this rank's slab, its halo exchange and its reductions.

    ``stats`` counts the exchanges and the seconds they took on the host
    (``exchange_s``), of which ``staging_s`` went to copies through host
    memory on a gloo group with CUDA tensors.
    """

    sk: Skeleton
    mesh: RowMesh
    slab: HaloSlab = field(init=False)
    stats: dict = field(init=False, repr=False)
    _buffers: dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        Lx = self.sk.shape[0]
        if not self.sk.stencil:
            raise ValueError("Row sharding requires a cubic (stencil) skeleton")
        if AXIS not in self.mesh.shape:
            raise ValueError(f"Mesh must have a '{AXIS}' axis")
        n = self.n_shards
        if Lx % n != 0:
            raise ValueError(f"Lattice x-extent {Lx} must divide evenly over {n} devices")
        Lxl = Lx // n
        object.__setattr__(self, "slab", halo_slab(self.sk, self.mesh.row * Lxl, Lxl))
        object.__setattr__(self, "stats", {"exchanges": 0, "exchange_s": 0.0, "staging_s": 0.0})
        global _said_staging
        if self.mesh.backend == "gloo" and self.mesh.device.type == "cuda" and not _said_staging:
            _said_staging = True
            _log.info("gloo process group with CUDA tensors: halo planes and reductions pass "
                      "through pinned host buffers; the kernels stay on the card")

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[AXIS])

    @property
    def has_probe_axis(self) -> bool:
        return PROBE_AXIS in self.mesh.shape

    @property
    def probe_shards(self) -> int:
        return int(self.mesh.shape.get(PROBE_AXIS, 1))

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ------------------------------------------------------------ placement
    def is_whole(self, x) -> bool:
        """Whether ``x`` has the whole lattice's rows (else it is this rank's slab)."""
        n = int(x.shape[0])
        if n not in (self.sk.n_sites, self.slab.n_local):
            raise ValueError(f"{n} rows: neither the lattice's {self.sk.n_sites} nor the slab's "
                             f"{self.slab.n_local}")
        return n == self.sk.n_sites

    def _local_rows(self, x):
        x = torch.as_tensor(x)
        if self.is_whole(x):
            x = x[self.slab.rows]
        return x.to(self.device).contiguous()

    def shard_data(self, data):
        """This rank's slab ``[n_local, S, 4, 4]`` of the host ELL data
        ``[N, S, 4, 4]`` (NumPy or tensor; a slab is taken as it is), on the
        mesh's device; a planar operator ``[2, N, S, 4, 4]``
        (:mod:`bodge_tpu_torch.ops.planar`) in its complex64 form."""
        return self._local_rows(complex_operator(data))

    def halo_rows(self):
        """Global row indices of the x-planes before and after the slab (ring
        wrap): the rows whose blocks the adjoint kernel reads for the mirror
        blocks of the slab's boundary rows."""
        P, Lx = self.slab.plane, self.sk.shape[0]
        before = (self.slab.x0 - 1) % Lx
        after = (self.slab.x0 + self.slab.planes) % Lx
        return np.arange(before * P, (before + 1) * P), np.arange(after * P, (after + 1) * P)

    def shard_vector(self, v):
        """This rank's part of a probe block ``[N, 4, K]``: its slab's rows and,
        on a rows × probes mesh, its share of the columns."""
        v = torch.as_tensor(v)
        if self.has_probe_axis:
            K = int(v.shape[-1])
            if K % self.probe_shards:
                raise ValueError(f"probe count K={K} must divide evenly over {self.probe_shards} probe shards")
            Kl = K // self.probe_shards
            v = v[..., self.mesh.probe * Kl:(self.mesh.probe + 1) * Kl]
        return self._local_rows(v)

    # ------------------------------------------------------------ collectives
    def _staged(self, t) -> bool:
        return self.mesh.backend == "gloo" and t.is_cuda

    def _pinned(self, name, like, shape):
        key = (name, tuple(shape), like.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return buf

    def _post(self, last, first, recv_m, recv_p):
        ranks, r, n = self.mesh.row_ranks, self.mesh.row, self.n_shards
        prev, nxt = ranks[(r - 1) % n], ranks[(r + 1) % n]
        g = self.mesh.rows_group
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, last, nxt, g, tag=0),  # my last plane is my successor's hm
            dist.P2POp(dist.isend, first, prev, g, tag=1),  # my first plane is my predecessor's hp
            dist.P2POp(dist.irecv, recv_m, prev, g, tag=0),
            dist.P2POp(dist.irecv, recv_p, nxt, g, tag=1),
        ])

    def exchange_start(self, t):
        """Begin the ring exchange of the slab vector ``t``'s boundary planes;
        :meth:`exchange_finish` returns ``(hm, hp)``.  Work queued between
        the two (the interior launch of the overlap split) runs while the
        planes travel."""
        t0 = time.perf_counter()
        P = self.slab.plane
        last, first = t[-P:], t[:P]
        if self.n_shards == 1:  # the ring of one: a local copy (a send to oneself is refused)
            handle = ("local", last.clone(), first.clone())
        elif self._staged(t):
            send = self._pinned("send", t, (2, *first.shape))
            send[0].copy_(last, non_blocking=True)
            send[1].copy_(first, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            handle = ("staged", send, ready, t.device)
        else:
            recv_m, recv_p = torch.empty_like(first), torch.empty_like(first)
            handle = ("posted", self._post(last, first, recv_m, recv_p), recv_m, recv_p)
        self.stats["exchange_s"] += time.perf_counter() - t0
        return handle

    def exchange_finish(self, handle):
        """``(hm, hp)`` of an exchange begun by :meth:`exchange_start`: the
        predecessor's last plane and the successor's first plane, each a
        buffer of its own on the mesh's device."""
        t0 = time.perf_counter()
        kind = handle[0]
        if kind == "local":
            hm, hp = handle[1], handle[2]
        elif kind == "posted":
            for work in handle[1]:
                work.wait()
            hm, hp = handle[2], handle[3]
        else:
            _, send, ready, device = handle
            ready.synchronize()
            t1 = time.perf_counter()
            recv = self._pinned("recv", send, send.shape)
            for work in self._post(send[0], send[1], recv[0], recv[1]):
                work.wait()
            t2 = time.perf_counter()
            hm, hp = recv[0].to(device), recv[1].to(device)
            self.stats["staging_s"] += (t1 - t0) + (time.perf_counter() - t2)
        self.stats["exchanges"] += 1
        self.stats["exchange_s"] += time.perf_counter() - t0
        return hm, hp

    def exchange(self, t):
        """``(hm, hp)`` of the slab vector ``t`` (see :meth:`exchange_finish`)."""
        return self.exchange_finish(self.exchange_start(t))

    def _reduce(self, t, group):
        if group is None:
            return t
        if self._staged(t):
            host = t.detach().cpu()
            dist.all_reduce(host, group=group)
            return host.to(t.device)
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    def row_sum(self, t):
        """Σ over the ranks of this rank's rows group (a new tensor)."""
        return self._reduce(t, self.mesh.rows_group if self.n_shards > 1 else None)

    def _gather(self, t, group, dim):
        if group is None:
            return t
        host = t.detach().cpu() if self._staged(t) else t.detach().contiguous()
        parts = [torch.empty_like(host) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def gather_rows(self, t):
        """The whole lattice's rows of a slab tensor, on every rank of the rows group."""
        return self._gather(t, self.mesh.rows_group if self.n_shards > 1 else None, 0)

    def gather_probes(self, t, dim: int = -1):
        """The probe columns of every probe shard, concatenated along ``dim``."""
        return self._gather(t, self.mesh.probes_group, dim)


class RowSum(torch.autograd.Function):
    """Σ over the rows group forward; identity backward.  Every rank computes
    the same objective from the reduced sums, so the cotangent of each
    rank's own sums is the cotangent of the total."""

    @staticmethod
    def forward(ctx, t, rs):
        return rs.row_sum(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Replicated(torch.autograd.Function):
    """Identity forward on a field every rank holds whole; Σ over the rows
    group backward: each rank's gradient covers the terms of its own rows."""

    @staticmethod
    def forward(ctx, t, rs):
        ctx.rs = rs
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.rs.row_sum(g.contiguous()), None


def _numpy_dtype(data):
    if is_planar(data):
        return np.dtype(np.complex64)
    return numpy_dtype(data.dtype) if isinstance(data, torch.Tensor) else np.asarray(data).dtype


def _halo_product(rs: RowSharding, data_l, v_l, impl):
    hm, hp = rs.exchange(v_l)
    return ell_spmm_halo(data_l, rs.slab, v_l, hm, hp, impl=impl)


def _whole_result(rs: RowSharding, y, whole: bool):
    """The whole lattice's result where the caller gave whole inputs, else the slab's."""
    if rs.has_probe_axis:
        y = rs.gather_probes(y)
    return rs.gather_rows(y) if whole else y


def spmm_sharded(rs: RowSharding, data, v, impl: Optional[str] = None):
    """``H @ v`` with H row-partitioned over the mesh (halo-exchange product).

    ``data`` / ``v`` are the whole lattice's ``[N, S, 4, 4]`` / ``[N, 4, K]``
    (every rank takes its slab; the result is the whole ``[N, 4, K]`` on
    every rank) or this rank's slabs (the result is its slab).  ``impl`` as
    for :func:`~bodge_tpu_torch.ops.cuda_ell.ell_spmm_halo`: the kernel for
    CUDA tensors, the plain version for CPU tensors.
    """
    whole = rs.is_whole(torch.as_tensor(v))
    y = _halo_product(rs, rs.shard_data(data), rs.shard_vector(v), impl)
    return _whole_result(rs, y, whole)


def moments_sharded(rs: RowSharding, data, v0, order: int, scale: float, impl: Optional[str] = None):
    """Chebyshev moments ``[order, K]`` with the row-partitioned product and
    inner products reduced over the rows: separate products and reductions,
    the reference's formulation (the fused step is
    :func:`bodge_tpu_torch.parallel.cuda_sharded.moments_sharded_cuda`)."""
    data_l, v_l = rs.shard_data(data), rs.shard_vector(v0)
    inv = 1.0 / float(scale)

    def H(v):
        return _halo_product(rs, data_l, v, impl) * inv

    def inner(a, b):
        return rs.row_sum((a.conj() * b).sum(dim=(0, 1)).real)

    mu = _doubled_moment_scan(H, inner, v_l, order)
    return rs.gather_probes(mu) if rs.has_probe_axis else mu


def free_energy_kpm_sharded(
    rs: RowSharding,
    data,
    temperature: float,
    scale: float,
    order: int = 512,
    samples: int = 64,
    seed: Optional[int] = None,
    kernel: str = "jackson",
    impl: Optional[str] = None,
) -> float:
    """Row-partitioned KPM free energy (the multi-card sweep workhorse):
    the probes of :func:`~bodge_tpu_torch.ops.chebyshev.rademacher_probes`
    (``seed``, default 42) in the data's precision, :func:`moments_sharded`."""
    T = float(temperature)
    if T < 0:
        raise ValueError("Expected non-negative temperature!")
    if T == 0:
        g = lambda E: -np.abs(E) / 2
    else:
        g = lambda E: -np.abs(E) / 2 - T * np.log1p(np.exp(-np.abs(E) / T))
    coeffs = chebyshev_coefficients(lambda x: g(scale * x), order) * _KERNELS[kernel](order)
    z = rademacher_probes(rs.sk.n_sites, samples, seed, _numpy_dtype(data))
    mu = moments_sharded(rs, data, z, order, scale, impl=impl)
    est = float(np.dot(coeffs[: mu.shape[0]], mu.detach().sum(dim=1).double().cpu().numpy()))
    return 0.5 * est / samples
