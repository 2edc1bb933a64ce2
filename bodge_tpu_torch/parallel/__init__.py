"""Multi-card layer: row-partitioned lattices, halo-exchange products and
sharded Chebyshev sweeps over ``torch.distributed`` ranks.  Counterpart of
``bodge_tpu/parallel``; the reference's ``*_pallas`` entry points are the
``*_cuda`` ones of :mod:`.cuda_sharded` here."""

from .cuda_sharded import (
    dos_kpm_sharded_cuda,
    free_energy_kpm_sharded_cuda,
    ldos_kpm_sharded_cuda,
    moments_sharded_cuda,
    pack_operator_sharded,
    spmm_sharded_cuda,
)
from .multihost import initialize_multihost, is_multihost, local_device_count
from .sharded import (
    RowSharding,
    free_energy_kpm_sharded,
    make_row_mesh,
    moments_sharded,
    spmm_sharded,
)

__all__ = [
    "RowSharding",
    "make_row_mesh",
    "spmm_sharded",
    "moments_sharded",
    "free_energy_kpm_sharded",
    "initialize_multihost",
    "is_multihost",
    "local_device_count",
    "spmm_sharded_cuda",
    "moments_sharded_cuda",
    "free_energy_kpm_sharded_cuda",
    "ldos_kpm_sharded_cuda",
    "dos_kpm_sharded_cuda",
    "pack_operator_sharded",
]
