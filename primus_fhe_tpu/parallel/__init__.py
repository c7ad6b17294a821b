"""Mesh sharding for multi-device execution."""

from .mesh import make_mesh, residue_sharding, batch_sharding, replicate
from .coeff_sharded import (
    coeff_sharded_forward32,
    coeff_sharded_forward64,
    coeff_sharded_inverse32,
    coeff_sharded_inverse64,
)
from .sharded import (
    shard_dcrt_values,
    sharded_dcrt_forward32,
    sharded_dcrt_inverse32,
    sharded_external_product,
)

__all__ = [
    "coeff_sharded_forward32",
    "coeff_sharded_forward64",
    "coeff_sharded_inverse32",
    "coeff_sharded_inverse64",
    "make_mesh",
    "residue_sharding",
    "batch_sharding",
    "replicate",
    "shard_dcrt_values",
    "sharded_dcrt_forward32",
    "sharded_dcrt_inverse32",
    "sharded_external_product",
]
