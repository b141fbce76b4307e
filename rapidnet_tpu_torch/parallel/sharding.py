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

The 2-D (batch, scenario) mesh (``make_mesh_2d``, JAX's
``make_mesh_2d`` and its batched solves ``make_sharded_apg_batch``,
``make_sharded_qn_batch`` and ``make_sharded_batch_shared``) is a
``Mesh2D`` of two 1-D meshes over rank groups: ``scen`` over the rank's
row, ``batch`` over its column.  A ``Mesh`` built over a group passes
``group=`` to every collective; the default group's mesh passes none.
Each rank solves its row's block of instances on its column's slot
block with the plain batched solve on its row's scenario mesh (JAX's
2-D mesh runs only its XLA path too), and the outputs are gathered to
the global layout on every rank.

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

import datetime
import os

import torch
import torch.distributed as dist
from torch.profiler import record_function

AXIS = "scen"
BATCH_AXIS = "batch"
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)
# how long the collectives of the world's groups wait: the timeout the
# world was joined with (``distributed.initialize`` records it), which
# the groups ``make_mesh_2d`` creates take too
_world_timeout = DEFAULT_TIMEOUT


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
    """A 1-D scenario mesh: this process's ``rank`` of ``size`` shards
    and the ``device`` its shard lives on.  Built by ``make_mesh`` over
    the default process group, or by ``make_mesh_2d`` over a ``group``
    of its ranks, whose collectives pass ``group=`` (``rank`` and
    ``size`` are then the place and the count within the group).
    Constructing one directly runs no collective.  A mesh of one rank
    needs no process group: its collectives are local copies (JAX
    compiles a 1-device shard_map's to nothing), so ``Mesh(0, 1,
    device)`` serves a single process."""

    axis_names = (AXIS,)

    def __init__(self, rank: int, size: int, device, group=None):
        if not 0 <= int(rank) < int(size):
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.group = group
        _check_device(self.device)

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device='{self.device}')")

    def _all_reduce(self, t: torch.Tensor, op, name) -> torch.Tensor:
        with record_function(f"mesh.{name}"):
            out = t.detach().clone(memory_format=torch.contiguous_format)
            if self.size > 1:
                dist.all_reduce(out, op=op, group=self.group)
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
            dist.all_gather(parts, src, group=self.group)
            return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (any picklable object) on every rank of the
        mesh; the other ranks' ``obj`` is not read."""
        if self.size == 1:
            return obj
        root = 0 if self.group is None else dist.get_global_rank(
            self.group, 0)
        box = [obj if self.rank == 0 else None]
        # NCCL moves the pickled bytes through this rank's card, gloo
        # through the host
        nccl = dist.get_backend(self.group) == "nccl"
        dist.broadcast_object_list(box, src=root, group=self.group,
                                   device=self.device if nccl else None)
        return box[0]

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


class Mesh2D:
    """A 2-D (batch, scenario) mesh of ``n_batch * n_scen`` ranks, built by
    ``make_mesh_2d``: rank r sits at batch row ``r // n_scen`` and
    scenario column ``r % n_scen`` (JAX's row-major ``reshape(n_batch,
    n_scen)``).  ``scen`` is the 1-D scenario ``Mesh`` over the rank's
    row (the ranks that hold one block of instances), ``batch`` the 1-D
    ``Mesh`` over its column (the ranks that hold one block of slots).
    ``shard`` cuts the slot axis, so ``shard_factor_arrays`` takes either
    mesh."""

    axis_names = (BATCH_AXIS, AXIS)

    def __init__(self, rank: int, n_batch: int, n_scen: int, device,
                 row_group=None, column_group=None):
        self.rank, self.shape = int(rank), (int(n_batch), int(n_scen))
        row, column = divmod(self.rank, self.shape[1])
        self.scen = Mesh(column, self.shape[1], device, row_group)
        self.batch = Mesh(row, self.shape[0], device, column_group)
        self.device = self.scen.device

    def __repr__(self):
        return (f"Mesh2D({{'{BATCH_AXIS}': {self.shape[0]}, '{AXIS}': "
                f"{self.shape[1]}}}, rank={self.rank}, "
                f"device='{self.device}')")

    def shard(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's slot block of ``t`` along ``dim`` (its column's)."""
        return self.scen.shard(t, dim)


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
    return Mesh(rank, size, _mesh_device(devices, size, rank))


def _mesh_device(devices, size: int, rank: int) -> torch.device:
    """This rank's device: ``devices[rank]`` (one per rank, in rank
    order), else ``cuda:<local rank>``."""
    if devices is None:
        return torch.device("cuda", local_rank())
    devices = list(devices)
    if len(devices) != size:
        raise ValueError(f"devices: {len(devices)} given for a mesh of "
                         f"{size} ranks (one per rank)")
    return torch.device(devices[rank])


def make_mesh_2d(n_batch: int, n_scen: int, devices=None) -> Mesh2D:
    """The 2-D (batch, scenario) mesh over the ranks of the initialised
    process group (``rapidnet_tpu/parallel/sharding.py:226-244``):
    independent instances shard the batch axis, each instance's tree
    the scenario axis, and the scenario collectives stay inside a row.

    Collective: every rank creates every row group, then every column
    group, with ``dist.new_group`` in one fixed order (gloo and NCCL
    both require it), each with the timeout the world was joined with
    (``distributed.initialize``'s; 120 s where the caller joined it
    otherwise).  The group must have
    ``n_batch * n_scen`` ranks, or a ValueError.  ``devices``: one
    device per rank, in rank order, as ``make_mesh`` takes them.  One
    rank (1 x 1) needs no process group."""
    n_batch, n_scen = int(n_batch), int(n_scen)
    if n_batch < 1 or n_scen < 1:
        raise ValueError(f"a {n_batch}x{n_scen} mesh has no rank")
    size = n_batch * n_scen
    if not dist.is_initialized():
        if size == 1:
            return Mesh2D(0, 1, 1, _mesh_device(devices, 1, 0))
        raise RuntimeError("make_mesh_2d needs an initialised process "
                           "group: call rapidnet_tpu_torch.parallel."
                           "distributed.initialize() first (one process per "
                           "rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != size:
        raise ValueError(f"requested a {n_batch}x{n_scen} mesh but the "
                         f"process group has {world} ranks (one process "
                         "per rank: launch as many)")
    device = _mesh_device(devices, size, rank)
    rows = [list(range(i * n_scen, (i + 1) * n_scen))
            for i in range(n_batch)]
    columns = [list(range(j, size, n_scen)) for j in range(n_scen)]
    mine = {}
    for axis, groups in (("row", rows), ("column", columns)):
        for ranks in groups:
            # a group of one rank needs no process group (local copies)
            group = (dist.new_group(ranks, timeout=_world_timeout)
                     if len(ranks) > 1 else None)
            if rank in ranks:
                mine[axis] = group
    return Mesh2D(rank, n_batch, n_scen, device, mine["row"],
                  mine["column"])


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


# ------------------------------------------------- the 2-D (batch, scen) mesh


def _check_mesh_2d(mesh) -> None:
    if not isinstance(mesh, Mesh2D):
        raise TypeError(f"a batched sharded solve runs on a Mesh2D "
                        f"(make_mesh_2d), got {type(mesh).__name__}")


def _rows(mesh: Mesh2D, tensors: dict) -> dict:
    """This rank's instances of (B, ...) tensors: its row's block of the
    batch axis (``B % n_batch == 0`` or a ValueError)."""
    B = next(iter(tensors.values())).shape[0]
    if B % mesh.batch.size:
        raise ValueError(f"B={B} instances not divisible by "
                         f"{mesh.batch.size} batch rows")
    return {k: mesh.batch.shard(v, dim=0) for k, v in tensors.items()}


def _block(mesh: Mesh2D, tensors: dict) -> dict:
    """This rank's block of batched tensors: its instances, and of the
    (B, N, ns, d) ones its column's slots; (B, d) vectors whole."""
    return {k: mesh.scen.shard(v, dim=2) if v.dim() == 4 else v
            for k, v in _rows(mesh, tensors).items()}


def _sharded_batch(mesh: Mesh2D, fa_template: dict, slots: int, core,
                   traces: tuple):
    """run(fa, args, y0) around one rank's batched ``core`` solve of its
    block: ``fa`` is ``shard_factor_arrays``' cut, ``args`` the core's
    step arguments already cut to the block, ``y0`` global.  The control
    is broadcast from scenario column 0 over the row; x, u, v and y come
    back in the global layout (gathered over the row on the slot axis,
    then over the column on the batch axis), ``control`` (B, nu), the
    traces and ``iterations`` per instance, the same on every rank."""
    ns = fa_template["d1"].shape[1]
    mesh.scen.slots(ns)           # raises unless the mesh divides ns
    nsl = ns // mesh.scen.size
    if slots != ns:
        raise ValueError(f"the step has {slots} slots, the factors {ns}")

    def gather(t, dim=None):
        if dim is not None:
            t = mesh.scen.all_gather(t, dim=dim)
        return mesh.batch.all_gather(t, dim=0)

    def run(fa, args, y0=None):
        if fa["d1"].shape[1] != nsl:
            raise ValueError(f"fa has {fa['d1'].shape[1]} slots, a rank's "
                             f"block {nsl}: pass shard_factor_arrays(fa, "
                             "mesh)")
        if y0 is not None:
            y0 = _block(mesh, {k: y0[k] for k in ("xi", "psi")})
        out = core(fa, *args, y0)
        u0 = out["control"]
        if mesh.scen.axis_index() != 0:
            u0 = torch.zeros_like(u0)
        res = {k: gather(out[k], 2) for k in ("x", "u", "v")}
        res["y"] = {k: gather(out["y"][k], 2) for k in ("xi", "psi")}
        res["control"] = gather(mesh.scen.psum(u0))
        res.update({k: gather(out[k]) for k in ("iterations",) + traces})
        return res

    return run


def _batch_core(mesh: Mesh2D, algorithm: str, kw: dict):
    """The plain batched core on the rank's scenario ``Mesh`` and the
    traces it returns."""
    from rapidnet_tpu_torch.model.config import ALGORITHM_APG
    from rapidnet_tpu_torch.solver import apg as apg_mod
    from rapidnet_tpu_torch.solver import quasi_newton
    if algorithm == ALGORITHM_APG:
        kw = {k: v for k, v in kw.items() if k != "lbfgs_buffer_size"}
        return (apg_mod.make_apg_batch(mesh=mesh.scen, **kw),
                ("primal_infeasibility",))
    return (quasi_newton.make_solver_batch(algorithm=algorithm,
                                           mesh=mesh.scen, **kw),
            ("primal_infeasibility", "value_fbe", "tau",
             "line_search_trials", "lbfgs_skips"))


def _sharded_stacked(mesh, fa_template, step_template, algorithm, kw):
    _check_mesh_2d(mesh)
    core, traces = _batch_core(mesh, algorithm, kw)
    run = _sharded_batch(mesh, fa_template,
                         step_template["beta"].shape[-2], core, traces)
    return lambda fa, steps, y0=None: run(fa, (_block(mesh, steps),), y0)


def make_sharded_apg_batch(mesh: Mesh2D, fa_template: dict,
                           step_template: dict, *, prefix_stages: tuple,
                           inv_step: float, step_size: float,
                           penalty_state: float, penalty_safety: float,
                           xs_upper: float, max_iterations: int,
                           tolerance: float | None = None):
    """Batched and scenario-sharded APG over a 2-D (batch, scen) mesh
    (``sharding.py:247-289``): run(fa, steps, y0=None), collective, every
    rank calling it with its ``shard_factor_arrays`` cut and the same
    global (B, ...) steps (and warm start).  Each rank solves its
    instances' slot block with the plain batched APG on its row's
    scenario ``Mesh``; the outputs are global on every rank (control
    (B, nu), the traces and ``iterations`` per instance).  ``B`` the
    mesh's batch rows do not divide, or ``ns`` its columns, raise
    ValueError.  ``step_template``: one instance's step (or a batch)."""
    from rapidnet_tpu_torch.model.config import ALGORITHM_APG
    return _sharded_stacked(mesh, fa_template, step_template, ALGORITHM_APG,
                            dict(prefix_stages=prefix_stages,
                                 inv_step=inv_step, step_size=step_size,
                                 penalty_state=penalty_state,
                                 penalty_safety=penalty_safety,
                                 xs_upper=xs_upper,
                                 max_iterations=max_iterations,
                                 tolerance=tolerance))


def make_sharded_qn_batch(mesh: Mesh2D, fa_template: dict,
                          step_template: dict, *, algorithm: str,
                          prefix_stages: tuple, inv_step: float,
                          step_size: float, penalty_state: float,
                          penalty_safety: float, xs_upper: float,
                          max_iterations: int, lbfgs_buffer_size: int,
                          tolerance: float | None = None):
    """Batched and scenario-sharded FBE/NAMA over a 2-D mesh
    (``sharding.py:386-418``): the contract of
    ``make_sharded_apg_batch``, with the traces ``value_fbe``, ``tau``,
    ``line_search_trials`` and ``lbfgs_skips``.  A rank solves its
    instances in turn (``quasi_newton.make_solver_batch``), each on its
    row's scenario ``Mesh``."""
    return _sharded_stacked(mesh, fa_template, step_template, algorithm,
                            dict(prefix_stages=prefix_stages,
                                 inv_step=inv_step, step_size=step_size,
                                 penalty_state=penalty_state,
                                 penalty_safety=penalty_safety,
                                 xs_upper=xs_upper,
                                 max_iterations=max_iterations,
                                 lbfgs_buffer_size=lbfgs_buffer_size,
                                 tolerance=tolerance))


def make_sharded_batch_shared(mesh: Mesh2D, fa_template: dict,
                              base_template: dict, *,
                              algorithm: str = "proximalAlgorithm",
                              prefix_stages: tuple, inv_step: float,
                              step_size: float, penalty_state: float,
                              penalty_safety: float, xs_upper: float,
                              max_iterations: int,
                              lbfgs_buffer_size: int = 0,
                              tolerance: float | None = None):
    """Batched and scenario-sharded solve of any of the three algorithms
    over a shared forecast (``sharding.py:314-383``): run(fa, base, inst,
    y0=None) with ``(base, inst)`` from ``Engine.prepare_step_shared``,
    global on every rank.  Each rank assembles its instances' steps
    from its column's slots of ``base`` and its row's instances of
    ``inst`` (``apg.expand_shared_step``); the outputs as
    ``make_sharded_apg_batch``'s.  JAX's ``inst_template`` is not
    taken: the per-instance vectors need no layout of their own."""
    from rapidnet_tpu_torch.solver.apg import expand_shared_step
    _check_mesh_2d(mesh)
    core, traces = _batch_core(mesh, algorithm, dict(
        prefix_stages=prefix_stages, inv_step=inv_step, step_size=step_size,
        penalty_state=penalty_state, penalty_safety=penalty_safety,
        xs_upper=xs_upper, max_iterations=max_iterations,
        lbfgs_buffer_size=lbfgs_buffer_size, tolerance=tolerance))
    run = _sharded_batch(mesh, fa_template,
                         base_template["beta"].shape[-2], core, traces)

    def run_shared(fa, base, inst, y0=None):
        base_l = {k: mesh.scen.shard(v, dim=1) for k, v in base.items()}
        steps = expand_shared_step(base_l, **_rows(mesh, inst))
        return run(fa, (steps,), y0)

    return run_shared
