"""Scenario-axis sharding over torch.distributed (one process per shard)."""

from rapidnet_tpu_torch.parallel.sharding import (
    AXIS, Mesh, make_mesh, make_sharded_apg, make_sharded_quasi_newton,
    shard_factor_arrays)

__all__ = ["AXIS", "Mesh", "make_mesh", "make_sharded_apg",
           "make_sharded_quasi_newton", "shard_factor_arrays"]
