"""The scenario mesh: one process per shard of the scenario axis.

Counterpart of the single-controller part of
``rapidnet_tpu/parallel/sharding.py`` (``AXIS``, ``make_mesh`` and the
slot slicing that ``_fa_specs``/``_step_specs`` describe).  JAX runs one
program over a ``Mesh`` through ``shard_map``; here every rank of an
initialised ``torch.distributed`` process group runs the per-shard body
itself (SPMD), and the collectives stand where the JAX code has
``lax.psum``, ``pmax``, ``pmin``, ``axis_index`` and the gather of the
``out_specs``:

* ``Mesh.psum``, ``pmax``, ``pmin``: ``dist.all_reduce`` with SUM, MAX or
  MIN, returning a new tensor (the argument is not touched);
* ``Mesh.axis_index``: the rank;
* ``Mesh.all_gather``: the shards concatenated along a dimension (the
  slot axis by default), the global layout on every rank;
* ``Mesh.slots`` and ``Mesh.shard``: the rank's contiguous block of
  scenario slots (``ns % size == 0`` or a ValueError), and a tensor's
  slice of it.  Factor and step tensors of shape (N, ns, d) and the
  (N, ns) lines are cut on dimension 1; the shared matrices and the
  per-stage rows are whole on every rank.

Every backend gets the tensor itself.  gloo takes CUDA tensors (SUM, MAX,
MIN and the gather) and reduces them on the host: it copies them there
and back itself, so each call waits for the card and cannot be captured
in a CUDA graph.  NCCL reduces them on the card.

Each collective is a ``mesh.<name>`` span in a ``torch.profiler`` trace,
which ``chip_smoke.py`` reads as the collectives' host time.

Every rank must call the same collectives in the same order; the group's
timeout (``parallel.distributed.initialize``) makes a rank that waits on
one that never comes fail instead of hanging.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.profiler import record_function

AXIS = "scen"


def _check_device(device: torch.device) -> None:
    """Raise when ``device`` is a CUDA card this process cannot see."""
    if device.type == "cpu":
        return
    if device.type != "cuda":
        raise ValueError(f"a mesh runs on cpu or cuda devices, not "
                         f"{device.type}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {device} requested but no CUDA GPU "
                           "is available")
    index = 0 if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device {device} does not exist: "
                           f"{torch.cuda.device_count()} CUDA device(s) "
                           "visible")


class Mesh:
    """A 1-D scenario mesh over the default process group: this process's
    ``rank`` of ``size`` shards and the ``device`` its shard lives on.
    Built by ``make_mesh``; constructing one directly runs no
    collective."""

    axis_names = (AXIS,)

    def __init__(self, rank: int, size: int, device):
        if not 0 <= int(rank) < int(size):
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        _check_device(self.device)

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device='{self.device}')")

    def _all_reduce(self, t: torch.Tensor, op, name) -> torch.Tensor:
        with record_function(f"mesh.{name}"):
            out = t.detach().clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, op=op)
            return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum`` over the slot axis."""
        return self._all_reduce(t, dist.ReduceOp.SUM, "psum")

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.pmax`` over the slot axis."""
        return self._all_reduce(t, dist.ReduceOp.MAX, "pmax")

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.pmin`` over the slot axis."""
        return self._all_reduce(t, dist.ReduceOp.MIN, "pmin")

    def axis_index(self) -> int:
        """``lax.axis_index``: this shard's position on the axis."""
        return self.rank

    def all_gather(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (the
        global layout of a slot-sharded tensor), on every rank."""
        with record_function("mesh.all_gather"):
            src = t.detach().contiguous()
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src)
            return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        dist.barrier()

    def slots(self, ns: int) -> slice:
        """This rank's contiguous block of ``ns`` scenario slots."""
        if ns % self.size:
            raise ValueError(f"ns={ns} not divisible by {self.size} shards")
        nsl = ns // self.size
        return slice(self.rank * nsl, (self.rank + 1) * nsl)

    def shard(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's slot block of ``t`` along ``dim``, contiguous."""
        sl = self.slots(t.shape[dim])
        return t.narrow(dim, sl.start, sl.stop - sl.start).contiguous()


def local_rank() -> int:
    """The process's rank on its host: torchrun's LOCAL_RANK, else the
    global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The scenario mesh over the ranks of the initialised process group.

    ``n_devices``: the shard count asked for; a ValueError unless it is
    the group's world size (JAX's ``make_mesh`` raises when fewer devices
    are visible).  ``devices``: one device per rank, in rank order; a
    card may be named more than once (two ranks on one card share it).
    Default: ``cuda:<local rank>``, which raises when that card does not
    exist."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call rapidnet_tpu_torch.parallel.distributed."
                           "initialize() first (one process per shard)")
    size = dist.get_world_size()
    rank = dist.get_rank()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"requested a {n_devices}-device mesh but the "
                         f"process group has {size} ranks (one process per "
                         "shard: launch as many)")
    if devices is None:
        device = torch.device("cuda", local_rank())
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"devices: {len(devices)} given for a mesh of "
                             f"{size} ranks (one per rank)")
        device = torch.device(devices[rank])
    return Mesh(rank, size, device)
