"""Checkpoint / resume of long closed-loop runs.

The port's copy of ``rapidnet_tpu/utils/checkpoint.py``, with the same
file format.  The reference's only persistence is the config-JSON state
store (currentX/prevU/prevDemand, src/SmpcConfiguration.cu:240-293).
We keep that contract (see SmpcController.update_smpc_configuration)
and add a full checkpoint: closed-loop time, state, KPI accumulators,
solve-time history, and (optionally) the last dual iterate for warm
starts, as an .npz plus a JSON manifest.

The port has one dual layout, ``{"xi", "psi"}`` unpadded (the JAX
package's XLA layout), saved as float32 and restored as tensors on the
controller's device.  A file holding the JAX package's padded Pallas
layout (``dual_xi1``/``dual_xi2``) is refused.

On a mesh (``SmpcController(mesh=...)``) both routes return the duals in
the global layout on every rank, so a mesh run's file is the
single-device file: the same keys, shapes and dtypes.  Saving, loading
and ``checkpoint_exists(path, mesh)`` are then collective, and only the
mesh's rank 0 touches ``path``: it writes while every rank waits on
``mesh.barrier()``, and it reads and broadcasts what it read (or the
error it met) to the other ranks.  So ``path`` need exist only on rank
0's file system, and the ranks of a mesh that spans hosts resume from
the same state.  The global carry is what each sharded solve cuts its
block from.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

DUAL_KEYS = {"xi", "psi"}


def save_checkpoint(controller, path: str, *, sim_time: int,
                    include_duals: bool = True) -> None:
    """Atomic checkpoint: tmp-file + rename for both artifacts, so a
    crash mid-save never corrupts the previous checkpoint.  On a mesh,
    collective: rank 0 writes, every rank returns after it has."""
    mesh = controller.mesh
    if mesh is None or mesh.rank == 0:
        _write(controller, path, sim_time, include_duals)
    if mesh is not None:
        mesh.barrier()


def _write(controller, path: str, sim_time: int, include_duals: bool
           ) -> None:
    arrays = {
        "current_x": controller.config.current_x,
        "prev_u": controller.config.prev_u,
        "prev_demand": controller.config.prev_demand,
    }
    if include_duals and controller._last is not None:
        for k, v in controller._last["y"].items():
            arrays[f"dual_{k}"] = v.detach().float().cpu().numpy()
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path + ".npz")
    manifest = {
        "sim_time": sim_time,
        "economic_kpi_acc": controller.economic_kpi_acc,
        "smooth_kpi_acc": controller.smooth_kpi_acc,
        "safe_kpi_acc": controller.safe_kpi_acc,
        "network_kpi_acc": controller.network_kpi_acc,
        "solve_times_ms": controller.solve_times_ms,
        "algorithm": controller.config.algorithm,
    }
    tmp = path + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path + ".json")


def load_checkpoint(controller, path: str) -> int:
    """Restore controller state; returns the sim_time to resume from.
    The duals become the warm-start carry of a ``warm_start``
    controller (global, on a mesh too).  On a mesh every rank calls it:
    rank 0 reads ``path`` and the others receive what it read, or raise
    the error it met."""
    mesh = controller.mesh
    if mesh is None:
        manifest, arrays = _read(path)
    else:
        got = None
        if mesh.rank == 0:
            try:
                got = _read(path)
            except Exception as exc:     # raised on every rank below
                got = exc
        got = mesh.broadcast_object(got)
        if isinstance(got, Exception):
            raise got
        manifest, arrays = got
    duals = {k[len("dual_"):]: v for k, v in arrays.items()
             if k.startswith("dual_")}
    if duals and set(duals) != DUAL_KEYS:
        raise ValueError(
            f"{path}.npz holds the duals {sorted(duals)}: the port reads "
            f"only the unpadded layout {sorted(DUAL_KEYS)} (the JAX "
            f"package's XLA layout), not its padded Pallas layout "
            f"(dual_xi1/dual_xi2)")
    controller.config.set_current_state(arrays["current_x"])
    controller.config.set_previous_control(arrays["prev_u"])
    controller.config.set_previous_demand(arrays["prev_demand"])
    controller.economic_kpi_acc = manifest["economic_kpi_acc"]
    controller.smooth_kpi_acc = manifest["smooth_kpi_acc"]
    controller.safe_kpi_acc = manifest["safe_kpi_acc"]
    controller.network_kpi_acc = manifest["network_kpi_acc"]
    controller.solve_times_ms = list(manifest["solve_times_ms"])
    if duals and controller.warm_start:
        controller._y_carry = {
            k: torch.as_tensor(v, dtype=torch.float32,
                               device=controller.device)
            for k, v in duals.items()}
    return int(manifest["sim_time"])


def _read(path: str) -> tuple:
    with open(path + ".json") as f:
        manifest = json.load(f)
    with np.load(path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, arrays


def checkpoint_exists(path: str, mesh=None) -> bool:
    """Whether both files are there; on a ``mesh`` (collective) rank 0's
    answer on every rank."""
    found = os.path.exists(path + ".json") and os.path.exists(path + ".npz")
    return found if mesh is None else bool(mesh.broadcast_object(found))
