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

The plain scenario-sharded solves (``make_sharded_apg``,
``make_sharded_quasi_newton``, JAX's ``shard_map`` solves) run the
plain PyTorch solve of ``solver/apg.py`` or ``solver/quasi_newton.py``
with ``mesh=`` on every rank's block: ``shard_factor_arrays`` cuts the
factor dict as JAX's ``_fa_specs`` lays it out, the step and the warm
start are cut inside, and the outputs come back in the global layout on
every rank, as the sharded streaming solves return them.

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
    collective.  A mesh of one rank needs no process group: its
    collectives are local copies (JAX compiles a 1-device shard_map's to
    nothing), so ``Mesh(0, 1, device)`` serves a single process."""

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
            if self.size > 1:
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
            if self.size == 1:
                return src.clone()
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src)
            return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        if self.size > 1:
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


def shard_factor_arrays(fa: dict, mesh: Mesh) -> dict:
    """This rank's cut of a factor dict (JAX's ``_fa_specs``,
    ``rapidnet_tpu/parallel/sharding.py:58-76``): the (N, ns, d) arrays
    and ``rep`` on the slot axis, ``prefix_C`` and ``prefix_Bp`` on
    their rows, ``prefix_Cp`` on its columns (the (Rp, d) parent block
    it makes is summed over the ranks); everything else whole."""
    out = {}
    for k, v in fa.items():
        if k in ("prefix_C", "prefix_Bp"):
            out[k] = {s: mesh.shard(m, dim=0) for s, m in v.items()}
        elif k == "prefix_Cp":
            out[k] = {s: mesh.shard(m, dim=1) for s, m in v.items()}
        elif k == "rep" or v.dim() == 3:
            out[k] = mesh.shard(v, dim=1)
        else:
            out[k] = v
    return out


def shard_step(step: dict, mesh: Mesh) -> dict:
    """This rank's cut of a step dict (JAX's ``_step_specs``): the
    (N, ns, d) arrays on the slot axis, x0, prev_u and prev_uhat whole."""
    return {k: mesh.shard(v) if v.dim() == 3 else v for k, v in step.items()}


def _broadcast_root_control(out: dict, mesh: Mesh) -> dict:
    """The stage-0 control lives in slot 0, on rank 0: the core's
    ``control``, already clipped there to the physical bounds (its cut
    holds slot 0's), summed over the mesh from zeros elsewhere
    (``sharding.py:130-141``)."""
    u0 = out["control"]
    if mesh.axis_index() != 0:
        u0 = torch.zeros_like(u0)
    out["control"] = mesh.psum(u0)
    return out


def _sharded(mesh: Mesh, fa_template: dict, step_template: dict, core,
             traces: tuple):
    """run(fa, step, y0=None) around one rank's ``core`` solve: ``fa``
    is ``shard_factor_arrays``' cut, ``step`` and ``y0`` are global (the
    same on every rank; each takes its block), and x, u, v and y come
    back in the global layout on every rank (``Mesh.all_gather``), with
    the control broadcast from rank 0 and ``traces`` as the core returns
    them (already the same on every rank)."""
    ns = fa_template["d1"].shape[1]
    nsl = ns // mesh.size
    mesh.slots(ns)                # raises unless the mesh divides ns
    if step_template["beta"].shape[1] != ns:
        raise ValueError(f"the step has {step_template['beta'].shape[1]} "
                         f"slots, the factors {ns}")

    def run(fa, step, y0=None):
        if fa["d1"].shape[1] != nsl:
            raise ValueError(f"fa has {fa['d1'].shape[1]} slots, a rank's "
                             f"block {nsl}: pass shard_factor_arrays(fa, "
                             "mesh)")
        if y0 is not None:
            y0 = {k: mesh.shard(y0[k]) for k in ("xi", "psi")}
        out = _broadcast_root_control(core(fa, shard_step(step, mesh), y0),
                                      mesh)
        res = {k: mesh.all_gather(out[k]) for k in ("x", "u", "v")}
        res["y"] = {k: mesh.all_gather(out["y"][k]) for k in ("xi", "psi")}
        res.update({k: out[k] for k in ("control", "iterations") + traces})
        return res

    return run


def make_sharded_apg(mesh: Mesh, fa_template: dict, step_template: dict, *,
                     prefix_stages: tuple, inv_step: float, step_size: float,
                     penalty_state: float, penalty_safety: float,
                     xs_upper: float, max_iterations: int,
                     tolerance: float | None = None):
    """The scenario-sharded plain APG solve (``sharding.py:192-224``):
    run(fa, step, y0=None), collective, every rank calling it with its
    ``shard_factor_arrays`` cut and the same global step (and warm
    start).  Returns control (slot 0's u projected and broadcast), x, u,
    v and y in the global layout, the trace ``primal_infeasibility`` and
    ``iterations``, the same on every rank; under a ``tolerance`` every
    rank stops at the same iteration (the stopping rule is a ``pmax``).
    A slot count the mesh does not divide raises ValueError."""
    from rapidnet_tpu_torch.solver import apg as apg_mod
    core = apg_mod.make_apg(
        prefix_stages=prefix_stages, inv_step=inv_step, step_size=step_size,
        penalty_state=penalty_state, penalty_safety=penalty_safety,
        xs_upper=xs_upper, max_iterations=max_iterations,
        tolerance=tolerance, mesh=mesh)
    return _sharded(mesh, fa_template, step_template, core,
                    ("primal_infeasibility",))


def make_sharded_quasi_newton(mesh: Mesh, fa_template: dict,
                              step_template: dict, *, algorithm: str,
                              prefix_stages: tuple, inv_step: float,
                              step_size: float, penalty_state: float,
                              penalty_safety: float, xs_upper: float,
                              max_iterations: int, lbfgs_buffer_size: int,
                              tolerance: float | None = None):
    """The scenario-sharded plain FBE/NAMA solve (``sharding.py:430-462``):
    the layout and run(fa, step, y0=None) of ``make_sharded_apg``, with
    the traces ``value_fbe`` and ``tau`` too.  Every dot, norm and value
    is summed over the ranks before a branch reads it, so the line
    searches and the exit decide alike on every rank."""
    from rapidnet_tpu_torch.solver import quasi_newton
    core = quasi_newton.make_solver(
        algorithm=algorithm, prefix_stages=prefix_stages,
        inv_step=inv_step, step_size=step_size, penalty_state=penalty_state,
        penalty_safety=penalty_safety, xs_upper=xs_upper,
        max_iterations=max_iterations, lbfgs_buffer_size=lbfgs_buffer_size,
        tolerance=tolerance, mesh=mesh)
    return _sharded(mesh, fa_template, step_template, core,
                    ("primal_infeasibility", "value_fbe", "tau",
                     "line_search_trials", "lbfgs_skips"))
