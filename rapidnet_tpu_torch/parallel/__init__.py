"""Scenario-axis sharding over torch.distributed (one process per shard)."""

from rapidnet_tpu_torch.parallel.sharding import AXIS, Mesh, make_mesh

__all__ = ["AXIS", "Mesh", "make_mesh"]
