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
layout (``dual_xi1``/``dual_xi2``) is refused, and so is a controller on
a mesh, whose ranks each hold only their slice of the duals.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

DUAL_KEYS = {"xi", "psi"}
MESH_CHECKPOINT = ("checkpoints of a controller on a mesh are not ported "
                   "(each rank holds only its slice of the duals; "
                   "ROADMAP.md queue 1, item 11b)")


def _refuse_mesh(controller) -> None:
    if controller.mesh is not None:
        raise NotImplementedError(MESH_CHECKPOINT)


def save_checkpoint(controller, path: str, *, sim_time: int,
                    include_duals: bool = True) -> None:
    """Atomic checkpoint: tmp-file + rename for both artifacts, so a
    crash mid-save never corrupts the previous checkpoint."""
    _refuse_mesh(controller)
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
    controller."""
    _refuse_mesh(controller)
    with open(path + ".json") as f:
        manifest = json.load(f)
    with np.load(path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
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


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path + ".json") and os.path.exists(path + ".npz")
