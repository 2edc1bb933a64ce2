"""Multi-process entry point: ``torch.distributed`` set-up.

Counterpart of ``bodge_tpu/parallel/multihost.py``.  One process per card
calls :func:`initialize_multihost`, after which :func:`make_row_mesh`
(:mod:`.sharded`) spans every process and the same row-sharded programs run
from one card to many:

    from bodge_tpu_torch.parallel import initialize_multihost, make_row_mesh
    initialize_multihost()                    # env as torchrun sets it
    mesh = make_row_mesh()                    # every process, one card each
    ...                                       # identical single-card code

Calling :func:`initialize_multihost` with no arguments in a plain process is a
no-op, so the same script runs unchanged from a laptop to a cluster.  Nothing
here runs at import time.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_multihost", "local_device_count"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    **kwargs,
) -> bool:
    """Initialise the default ``torch.distributed`` process group (idempotent).

    ``coordinator_address`` is ``"host:port"`` of rank 0's store,
    ``num_processes`` the world size and ``process_id`` this rank; given any
    of them, the group is made from them, else from the environment that
    ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` > 1,
    ``RANK``).  ``backend`` defaults to ``"nccl"`` where a card is present and
    ``"gloo"`` otherwise; ``kwargs`` go to ``init_process_group``.  Returns
    ``True`` if a process group exists afterwards, ``False`` for the
    single-process no-op (no arguments and no multi-process environment).
    """
    if dist.is_initialized():
        return True
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if not explicit and not _env_looks_multihost():
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return True


def _env_looks_multihost() -> bool:
    """True when the environment advertises a multi-process run: a
    coordinator address and a world of more than one process."""
    if not os.environ.get("MASTER_ADDR"):
        return False
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return False


def is_multihost() -> bool:
    """Whether this run spans more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_device_count() -> int:
    """Cards attached to this host (0 on a host without CUDA)."""
    return torch.cuda.device_count()
