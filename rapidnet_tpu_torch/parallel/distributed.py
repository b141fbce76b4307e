"""Process-group initialisation and the scenario mesh over all ranks.

Counterpart of ``rapidnet_tpu/parallel/distributed.py``.  JAX runs one
controller per host over every device of a slice; here one process runs
per shard of the scenario axis (SPMD), launched by ``torchrun`` (or by
any launcher that sets its variables), and ``torch.distributed`` joins
them:

* ``initialize`` once per process: the backend (NCCL for CUDA ranks, gloo
  otherwise), the rendezvous (torchrun's ``env://`` by default, or an
  ``init_method`` such as ``file:///shared/path``), and a finite timeout
  for every collective;
* ``scenario_mesh`` over all ranks, one shard each;
* ``host_local_scenario_slice``: the contiguous block of scenarios a
  process owns.

Not ported: ``make_global_fan_array``, ``_make_global`` and
``shard_problem_multihost`` assemble JAX global arrays from each host's
block; in SPMD every rank already holds its own slice (``Mesh.shard``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from rapidnet_tpu_torch.parallel import sharding
from rapidnet_tpu_torch.parallel.sharding import (DEFAULT_TIMEOUT, Mesh,
                                                  make_mesh)


def initialize(backend: str | None = None, init_method: str | None = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               rank: int | None = None, world_size: int | None = None
               ) -> None:
    """Join the process group (a no-op when it is already initialised).

    ``rank`` and ``world_size`` default to torchrun's RANK and WORLD_SIZE;
    ``init_method`` to ``env://`` (MASTER_ADDR, MASTER_PORT).
    ``backend``: 'nccl' when CUDA is available, else 'gloo'.  Two ranks
    on one card need 'gloo' (NCCL refuses them).  ``timeout``: how long a
    collective waits for the other ranks before it fails (also on the
    row and column groups of ``make_mesh_2d``)."""
    if dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=timeout)
    sharding._world_timeout = timeout


def scenario_mesh(devices=None) -> Mesh:
    """The 1-D scenario mesh over every rank of the group."""
    return make_mesh(devices=devices)


def host_local_scenario_slice(total_ns: int) -> slice:
    """The contiguous block of scenarios this process owns."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    if total_ns % n_proc:
        raise ValueError(f"ns={total_ns} not divisible by "
                         f"{n_proc} processes")
    per = total_ns // n_proc
    return slice(pid * per, (pid + 1) * per)
