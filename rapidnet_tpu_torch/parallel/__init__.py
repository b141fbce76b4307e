"""Scenario-axis sharding over torch.distributed (one process per shard),
and the 2-D (batch, scenario) mesh of batched solves."""

from rapidnet_tpu_torch.parallel.sharding import (
    AXIS, BATCH_AXIS, Mesh, Mesh2D, make_mesh, make_mesh_2d,
    make_sharded_apg, make_sharded_apg_batch, make_sharded_batch_shared,
    make_sharded_qn_batch, make_sharded_quasi_newton, shard_factor_arrays)

__all__ = ["AXIS", "BATCH_AXIS", "Mesh", "Mesh2D", "make_mesh",
           "make_mesh_2d", "make_sharded_apg", "make_sharded_apg_batch",
           "make_sharded_batch_shared", "make_sharded_qn_batch",
           "make_sharded_quasi_newton", "shard_factor_arrays"]
