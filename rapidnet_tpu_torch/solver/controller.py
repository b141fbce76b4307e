"""Closed-loop SMPC controller (receding horizon driver), in PyTorch.

Counterpart of ``rapidnet_tpu/solver/controller.py`` (reference:
``SmpcController``, src/SmpcController.cu, and the closed loop of
src/main.cu:34-68).  API parity:

  controller = SmpcController(config_path, device="cuda")
  controller.initialise()                          # factor step
  u = controller.control_action(sim_time)          # one solve
  controller.move_forward_in_time()                # built-in simulator
  controller.economic_kpi(T), ...                  # KPI getters

The three algorithms of the reference run on one device: APG, global
FBE and NAMA (``config.algorithm``; FBE and NAMA with the config's
``lbfgs_buffer_size``).  ``backend``:

* ``'auto'`` (default): on a CUDA device, the solve ``auto_route``
  picks from the tree's sizes: the algorithm's whole-solve kernel
  (ops/apg_solve.py for APG, ops/qn_solve.py for FBE and NAMA) when the
  tree fits it; past its limits, with no tolerance, the streaming
  solve when its kernels take the tree (APG: ops/apg_stream.py; FBE and
  NAMA: solver/qn_stream.py over ops/stream_qn.py and ops/lbfgs.py);
  else the plain PyTorch solve, as the JAX package keeps its XLA path
  there (``rapidnet_tpu/solver/controller.py:348-411``).  On the CPU,
  the whole-solve kernel wrapper, which runs its plain version there;
* ``'cuda'``: the whole-solve kernel wrapper, and raises unless
  ``device`` is a CUDA device;
* ``'stream'``: the streaming solve of the algorithm (the kernels' plain
  versions on the CPU); raises with a tolerance, as the JAX package
  does;
* ``'torch'``: the plain PyTorch solve (solver/apg.py,
  solver/quasi_newton.py) on any device.

``mesh``: a ``parallel.Mesh`` (one process per shard of the scenario
axis; every rank builds the same controller and runs the same loop).
The solve then runs scenario-sharded on the mesh's device, on one of two
routes (``rapidnet_tpu/solver/controller.py:243-346``):

* ``'stream'``: the sharded streaming solve
  (``ops/apg_stream_sharded.make_apg_stream_sharded`` for APG,
  ``solver/qn_stream.make_qn_stream(mesh=...)`` for FBE and NAMA), with
  ``backend='stream'``, or ``'auto'`` when ``auto_route`` picks
  ``'stream'`` for the whole tree on a CUDA mesh;
* ``'plain'``: the plain sharded solve (``parallel.make_sharded_apg``,
  ``make_sharded_quasi_newton``; JAX's XLA shard_map solve) everywhere
  else: under a tolerance, with ``'torch'``, with ``'auto'`` on a CPU
  mesh or on a tree ``auto_route`` does not send to ``'stream'``, and
  with ``'auto'`` when the sharded streaming pack refuses the tree
  (``apg_stream.NotStreamable``; JAX's ``except ValueError``), its
  message kept in ``route_reason``.

``'cuda'`` raises (the whole-solve kernels are single-device), as the
JAX package's ``'pallas'`` does, and so does ``'stream'`` under a
tolerance.  Both routes return x, u, v and the duals y in the global
layout on every rank, so a warm start carries over either.

Differences from the reference (intentional, as in the JAX package):
  * the built-in simulator applies the demand disturbance e to the state
    update (the reference adds it to a dead buffer,
    src/SmpcController.cu:1695);
  * closed-loop state lives in a plain dataclass with JSON import/export
    instead of rewriting the config file.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                        step_arrays, step_tensors)
from rapidnet_tpu_torch.engine.engine import XS_UPPER, Engine
from rapidnet_tpu_torch.io import jsonio
from rapidnet_tpu_torch.model.config import (ALGORITHM_APG, ALGORITHM_FBE,
                                             ALGORITHM_NAMA, SmpcConfig)
from rapidnet_tpu_torch.model.forecaster import Forecaster, JsonForecaster
from rapidnet_tpu_torch.model.network import DwnNetwork
from rapidnet_tpu_torch.model.scenario_tree import ScenarioTree
from rapidnet_tpu_torch.ops import apg_solve, apg_stream, lbfgs, qn_solve
from rapidnet_tpu_torch.ops import apg_stream_sharded
from rapidnet_tpu_torch.parallel.sharding import (
    Mesh, make_sharded_apg, make_sharded_quasi_newton, shard_factor_arrays)
from rapidnet_tpu_torch.ops import stream_qn
from rapidnet_tpu_torch.solver import apg as apg_mod
from rapidnet_tpu_torch.solver import qn_stream
from rapidnet_tpu_torch.solver import quasi_newton as qn_mod

BACKENDS = ("auto", "cuda", "stream", "torch")
ALGORITHMS = (ALGORITHM_APG, ALGORITHM_FBE, ALGORITHM_NAMA)
STREAM_PRECISIONS = (None, "highest")
STREAM_LBFGS_DTYPES = (None, "float32", "bfloat16")


def auto_route(algorithm: str, *, tolerance, N: int, ns: int, nx: int,
               nu: int, nv: int, smem_limit: int | None = None,
               lbfgs_buffer_size: int | None = None) -> str:
    """The solve ``backend='auto'`` runs on a CUDA device, from the
    tree's sizes: 'kernel' (the whole-solve kernel) when the tree fits
    it; else, with no tolerance, 'stream' when the algorithm's streaming
    kernels take the tree (for FBE and NAMA, also a history of
    ``lbfgs_buffer_size`` + 1 columns); else 'plain'.  ``smem_limit``:
    the card's opt-in shared memory per block (default: the current
    device's)."""
    dims = (N, ns, nx, nu, nv)
    if algorithm == ALGORITHM_APG:
        whole, stream_fits = apg_solve.fits, apg_stream.stream_fits
    else:
        whole, stream_fits = qn_solve.fits, stream_qn.stream_fits
    if whole(*dims, smem_limit=smem_limit):
        return "kernel"
    history_fits = (algorithm == ALGORITHM_APG or lbfgs_buffer_size is None
                    or int(lbfgs_buffer_size) + 1 <= lbfgs.MAX_COLS)
    if (tolerance is None and history_fits and
            stream_fits(*dims, smem_limit=smem_limit)):
        return "stream"
    return "plain"


def tree_dims(fa: dict) -> dict:
    """N, ns, nx, nu and nv of a factor dict, for ``auto_route``."""
    N, ns, nx = fa["d1"].shape
    return dict(N=N, ns=ns, nx=nx, nu=fa["g"].shape[-1],
                nv=fa["invWbar"].shape[0])


def resolve_device(device) -> torch.device:
    """A torch.device; raises for a CUDA device when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' requested but no CUDA GPU is available "
            "(pass device='cpu' to run the plain PyTorch version)")
    return dev


class SmpcController:
    def __init__(self, config: SmpcConfig | str,
                 network: Optional[DwnNetwork] = None,
                 tree: Optional[ScenarioTree] = None,
                 forecaster: Optional[Forecaster] = None,
                 warm_start: bool = False,
                 tolerance: Optional[float] = None,
                 backend: str = "auto",
                 device="cuda",
                 mesh=None,
                 stream_precision: Optional[str] = None,
                 stream_lbfgs_dtype: Optional[str] = None):
        """device: where the solve runs ('cuda' by default; raises when
        no GPU is present).  stream_precision: the streaming kernels'
        products, None or 'highest' (full float32; no reduced-precision
        knob is measured yet).  stream_lbfgs_dtype: the storage of the
        streaming FBE/NAMA solve's L-BFGS history, 'float32' (the
        default, also None) or 'bfloat16' (half the history's bytes; the
        history holds differences, and the line search guards the
        direction).  mesh: a ``parallel.Mesh``, the scenario-sharded
        solve (module docstring); the solve then runs on the mesh's
        device, and ``device`` must name the same kind (cpu or cuda)."""
        if isinstance(config, str):
            config = SmpcConfig.from_json(config)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend '{backend}' "
                             f"(expected one of {BACKENDS})")
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a rapidnet_tpu_torch."
                                f"parallel.Mesh, got {type(mesh).__name__}")
            if backend == "cuda":
                raise ValueError(
                    "the whole-solve CUDA kernels are single-device; with a "
                    "mesh use backend='stream' (per-shard streaming "
                    "kernels) or 'auto'")
        if stream_precision not in STREAM_PRECISIONS:
            raise ValueError(
                f"stream_precision must be None or 'highest' (the "
                f"streaming kernels' products run in full float32), got "
                f"'{stream_precision}'")
        if stream_lbfgs_dtype not in STREAM_LBFGS_DTYPES:
            raise ValueError(
                f"stream_lbfgs_dtype must be 'float32' or 'bfloat16', got "
                f"'{stream_lbfgs_dtype}'")
        self.stream_lbfgs_dtype = stream_lbfgs_dtype or "float32"
        if config.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm '{config.algorithm}'")
        if backend == "stream" and tolerance is not None:
            raise ValueError(apg_stream.TOLERANCE_MESSAGE)
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if self.device.type != mesh.device.type:
                raise ValueError(f"device '{device}' and the mesh's device "
                                 f"{mesh.device} differ")
            self.device = mesh.device
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend='cuda' needs a CUDA device, got '{device}'")
        self.backend = backend
        self.route = None        # the solve initialise() picked
        self.warm_start = warm_start
        self.tolerance = tolerance
        self._y_carry = None
        self.config = config
        self.network = network or DwnNetwork.from_json(
            config.path_to_network)
        self.tree = tree or ScenarioTree.from_json(
            config.path_to_scenario_tree)
        self.forecaster = forecaster or JsonForecaster(
            config.path_to_forecaster)
        self.engine = Engine(self.network, self.tree, config)

        self.simulator_flag = True
        self._fa = None
        self._solver = None
        self._last = None
        self._last_control = None
        self.solve_times_ms: list[float] = []

        # KPI accumulators (reference: src/SmpcController.cu:1778-1818)
        self.economic_kpi_acc = 0.0
        self.smooth_kpi_acc = 0.0
        self.safe_kpi_acc = 0.0
        self.network_kpi_acc = 0.0

    # ------------------------------------------------------------------
    def initialise(self) -> None:
        """Factor step + solver set-up (reference:
        initialiseSmpcController, src/SmpcController.cu:476-487)."""
        self._fa = factor_tensors(factor_arrays(self.engine), self.device)
        cfg = self.config
        kw = dict(prefix_stages=self.engine.factor_step().prefix_stages,
                  inv_step=float(1.0 / cfg.step_size),
                  step_size=float(cfg.step_size),
                  penalty_state=float(cfg.penalty_state),
                  penalty_safety=float(cfg.penalty_safety),
                  xs_upper=float(XS_UPPER),
                  max_iterations=int(cfg.max_iterations),
                  tolerance=self.tolerance)
        if cfg.algorithm == ALGORITHM_APG:
            make_plain = apg_mod.make_apg
            make_kernel = apg_solve.make_apg_kernel
        else:
            kw.update(algorithm=cfg.algorithm,
                      lbfgs_buffer_size=int(cfg.lbfgs_buffer_size))
            make_plain = qn_mod.make_solver
            make_kernel = qn_solve.make_qn_kernel
        if self.mesh is not None:
            self._initialise_sharded(kw)
            return
        route, consts = self._route(kw)
        self.route = route
        if route == "plain":
            run = make_plain(**kw)
            fa = self._fa
            self._solver = lambda step, y0: run(fa, step, y0)
        elif route == "stream" and cfg.algorithm == ALGORITHM_APG:
            self._solver = apg_stream.make_apg_stream_kernel(
                self._fa, consts=consts, **kw)
        elif route == "stream":
            self._solver = qn_stream.make_qn_stream(
                self._fa, consts=consts,
                lbfgs_dtype=self.stream_lbfgs_dtype, **kw)
        else:
            self._solver = make_kernel(self._fa, **kw)

    def _initialise_sharded(self, kw: dict) -> None:
        """The scenario-sharded solve over ``self.mesh``
        (``_initialise_sharded`` of the JAX controller): the sharded
        streaming solve with ``stream``, or with ``auto`` when
        ``_auto_streams`` says so and the sharded pack takes the tree;
        else the plain sharded solve (module docstring).  Only the
        pack's ``NotStreamable`` sends ``auto`` to the plain solve: the
        streaming wrapper is built outside the gate, so any other error
        of it raises."""
        self.route_reason = None
        consts = None
        if self.backend == "auto" and self._auto_streams():
            try:
                consts = apg_stream_sharded.pack_stream_sharded(
                    self._fa, self.mesh.size, self.mesh.rank,
                    prefix_stages=kw["prefix_stages"],
                    max_iterations=kw["max_iterations"])
            except apg_stream.NotStreamable as exc:
                self.route_reason = str(exc)
        if self.backend == "stream" or consts is not None:
            if self.config.algorithm == ALGORITHM_APG:
                self._solver = apg_stream_sharded.make_apg_stream_sharded(
                    self.mesh, self._fa, consts=consts, **kw)
            else:
                self._solver = qn_stream.make_qn_stream(
                    self._fa, mesh=self.mesh, consts=consts,
                    lbfgs_dtype=self.stream_lbfgs_dtype, **kw)
            self.route = "stream"
            return
        N, ns = self._fa["d1"].shape[:2]
        step_shape = {"beta": torch.empty(N, ns, self._fa["invWbar"].shape[0],
                                          device="meta")}
        if self.config.algorithm == ALGORITHM_APG:
            run = make_sharded_apg(self.mesh, self._fa, step_shape, **kw)
        else:
            run = make_sharded_quasi_newton(self.mesh, self._fa, step_shape,
                                            **kw)
        fa = shard_factor_arrays(self._fa, self.mesh)
        self.route = "plain"
        self._solver = lambda step, y0: run(fa, step, y0)

    def _auto_streams(self) -> bool:
        """Whether ``auto`` on the mesh asks for the sharded streaming
        solve: a fixed budget on a CUDA mesh whose whole tree
        ``auto_route`` sends to 'stream'."""
        if self.tolerance is not None or self.device.type != "cuda":
            return False
        with torch.cuda.device(self.device):
            return auto_route(
                self.config.algorithm, tolerance=None,
                lbfgs_buffer_size=self.config.lbfgs_buffer_size,
                **tree_dims(self._fa)) == "stream"

    def _route(self, kw: dict):
        """'kernel', 'stream' or 'plain', and the streaming constants
        when the gate built them.  ``auto`` on a CUDA device follows
        ``auto_route``; a tree the rank-1 or 0/1 pack refuses goes to
        the plain solve, as the JAX package's does
        (``controller.py:381-390``), with the refusal kept in
        ``route_reason``."""
        self.route_reason = None
        if self.backend in ("torch", "stream"):
            return ("plain" if self.backend == "torch" else "stream"), None
        if self.backend == "cuda" or self.device.type != "cuda":
            return "kernel", None
        route = auto_route(self.config.algorithm, tolerance=self.tolerance,
                           lbfgs_buffer_size=self.config.lbfgs_buffer_size,
                           **tree_dims(self._fa))
        if route != "stream":
            return route, None
        try:
            return route, apg_stream.stream_constants(
                self._fa, prefix_stages=kw["prefix_stages"],
                max_iterations=kw["max_iterations"])
        except apg_stream.NotStreamable as exc:
            self.route_reason = str(exc)
            return "plain", None

    # ------------------------------------------------------------------
    def prepare_step(self, sim_time: int) -> dict:
        """Forecast + disturbance elimination for one control step."""
        ok_d = self.forecaster.predict_demand(sim_time)
        ok_p = self.forecaster.predict_prices(sim_time)
        if not (ok_d and ok_p):
            raise IndexError(f"forecaster exhausted at t={sim_time}")
        step = self.engine.prepare_step(
            self.forecaster.nominal_demand, self.forecaster.nominal_prices,
            self.config.current_x, self.config.prev_u,
            self.config.prev_demand)
        return step_tensors(step_arrays(step), self.device)

    def control_action(self, sim_time: int) -> np.ndarray:
        """Run one receding-horizon solve; returns the control u0 (nu,)."""
        if self._solver is None:
            self.initialise()
        step = self.prepare_step(sim_time)
        t0 = time.perf_counter()
        y0 = self._y_carry if self.warm_start else None
        out = self._solver(step, y0)
        control = out["control"].cpu().numpy()     # waits for the solve
        self.solve_times_ms.append((time.perf_counter() - t0) * 1e3)
        if self.warm_start:
            self._y_carry = out["y"]
        self._last = out
        self._last_control = control
        return control

    # ------------------------------------------------------------------
    def move_forward_in_time(self) -> np.ndarray:
        """Advance the closed loop by one time instance.

        With ``simulator_flag`` (default) runs the built-in simulator
        x+ = x + B u + Gd d (mass balance; reference moveForewardInTime,
        src/SmpcController.cu:1679-1717, minus its dead-buffer e bug).
        Without it, the reference's external-simulator contract applies:
        the updated state is written into the config JSON and the
        (possibly externally-modified) state is re-read from it.
        """
        u = self._last_control
        if u is None:
            raise RuntimeError("call control_action first")
        d = self.forecaster.nominal_demand[0]          # realised demand
        x = (self.config.current_x + self.network.matB @ u +
             self.network.matGd @ d).astype(np.float32)
        self._update_kpi(x, u)
        if self.simulator_flag:
            self.config.set_current_state(x)
            self.config.set_previous_control(u)
            self.config.set_previous_demand(d)
        else:
            self.update_smpc_configuration(x, u, d)
            self.reload_state_from_config()
        return x

    # ------------------------------------------------------------------
    # external-simulator JSON state contract
    def update_smpc_configuration(self, state, control, demand,
                                  path: Optional[str] = None) -> None:
        """Write currentX/prevU/prevDemand back into the config JSON
        (reference updateSmpcConfiguration,
        src/SmpcController.cu:1725-1773)."""
        path = path or self.config.path_to_config
        if not path:
            raise ValueError("config has no backing JSON file")
        doc = jsonio.load_json(path)
        doc["currentX"] = np.asarray(state, np.float32).tolist()
        doc["prevU"] = np.asarray(control, np.float32).tolist()
        doc["prevDemand"] = np.asarray(demand, np.float32).tolist()
        jsonio.dump_json(path, doc)

    def reload_state_from_config(self, path: Optional[str] = None) -> None:
        """Re-read closed-loop state from the config JSON (reference
        SmpcConfiguration file-based setters,
        src/SmpcConfiguration.cu:240-293, without its
        setPreviousDemand-writes-to-prevU bug at :290)."""
        path = path or self.config.path_to_config
        doc = jsonio.load_json(path)
        self.config.set_current_state(
            np.asarray(doc["currentX"], np.float32))
        self.config.set_previous_control(
            np.asarray(doc["prevU"], np.float32))
        self.config.set_previous_demand(
            np.asarray(doc["prevDemand"], np.float32))

    def _update_kpi(self, state: np.ndarray, control: np.ndarray) -> None:
        net, cfg = self.network, self.config
        prices = self.forecaster.nominal_prices[0]
        eco = float(np.sum(cfg.weight_economical *
                           (net.alpha1 + prices) * np.abs(control)))
        du = cfg.prev_u - control
        smooth = float(du @ du)
        level = np.minimum(state - net.xsafe, 0.0)
        safe = float(np.abs(level).sum())
        netk = float(np.abs(state).sum())
        self.economic_kpi_acc += eco
        self.smooth_kpi_acc += smooth
        self.safe_kpi_acc += safe
        self.network_kpi_acc += netk

    # KPI getters (reference: src/SmpcController.cu:1824-1859)
    def economic_kpi(self, sim_time: int) -> float:
        return self.economic_kpi_acc / 3600.0 / max(sim_time, 1)

    def smooth_kpi(self, sim_time: int) -> float:
        return self.smooth_kpi_acc / 3600.0 / max(sim_time, 1)

    def safety_kpi(self, sim_time: int) -> float:
        return self.safe_kpi_acc

    def network_kpi(self, sim_time: int) -> float:
        safe_norm = float(np.sum(self.network.xsafe))
        if self.network_kpi_acc == 0:
            return 0.0
        return 100.0 * max(sim_time, 1) * safe_norm / self.network_kpi_acc

    def device_bytes_in_use(self) -> int:
        """Bytes held by live tensors on the solve's CUDA device (the
        reference's cudaMemGetInfo leak probe,
        src/SmpcController.cu:1612-1624): the bytes they asked for, not
        the allocator's blocks (``memory_allocated``), since a request
        may be served whole by a cached block up to 1 MB larger, so two
        solves holding the same tensors could count differently; 0 on
        the CPU, which keeps no such census.

        A dead tensor that another stream used (a gloo collective on the
        mesh records its copy stream on the tensors it is given) is
        freed once the allocator sees that stream's work done, which it
        checks at its next allocation: so the census waits for the card
        and allocates once before it counts."""
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        torch.empty(1, device=self.device)
        return torch.cuda.memory_stats(self.device)[
            "requested_bytes.all.current"]

    # ------------------------------------------------------------------
    def closed_loop(self, steps: int, output_json: Optional[str] = None
                    ) -> dict:
        """Run a closed-loop simulation (reference main.cu:45-69).

        Mirrors the reference's per-solve memory-leak invariant: the
        device memory held by live tensors must not grow across warm
        solves; growth is reported in the log.
        """
        log = {}
        bytes0 = None
        for t in range(steps):
            u = self.control_action(t)
            if t == 0:
                bytes0 = self.device_bytes_in_use()   # post-warmup census
            log[f"control{t}"] = u.tolist()
            log[f"time{t}"] = [self.solve_times_ms[-1]]
            self.move_forward_in_time()
        if steps > 1 and bytes0 is not None:
            growth = self.device_bytes_in_use() - bytes0
            if growth > 0:
                log["memoryLeakWarning"] = (
                    f"RUNTIME ERROR: MEMORY LEAKS ({growth} device bytes "
                    f"gained across {steps - 1} warm solves)")
                print(log["memoryLeakWarning"], file=sys.stderr)
        log["economicKpi"] = self.economic_kpi(steps)
        log["smoothKpi"] = self.smooth_kpi(steps)
        log["safetyKpi"] = self.safety_kpi(steps)
        log["networkKpi"] = self.network_kpi(steps)
        if output_json:
            with open(output_json, "w") as f:
                json.dump(log, f, indent=1)
        return log

    # diagnostics
    @property
    def primal_infeasibility(self) -> np.ndarray:
        if self._last is None:
            return np.zeros(0, np.float32)
        return self._last["primal_infeasibility"].cpu().numpy()
