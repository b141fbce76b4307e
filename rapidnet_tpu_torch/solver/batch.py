"""Batched receding-horizon closed loops, in PyTorch.

Counterpart of ``rapidnet_tpu/solver/batch.py``: B independent
closed-loop SMPC instances in lockstep over one network, tree and factor
step.  Per time step, every instance's forecast and disturbance
elimination run on the host (NumPy), the B solves run as one batched
call, and the built-in simulator advances each instance (NumPy).

Typical uses: Monte-Carlo evaluation of a controller over initial
conditions or demand realisations, tuning sweeps, and throughput
benchmarking.

The three algorithms of the reference run on one device: APG, global
FBE and NAMA (``config.algorithm``; FBE and NAMA with the config's
``lbfgs_buffer_size``).  ``backend`` as in ``solver/controller.py``:

* ``'auto'`` (default): the algorithm's batched whole-solve kernel
  wrapper (``ops/apg_solve.apg_solve_batch`` for APG,
  ``ops/qn_solve.qn_solve_batch`` for FBE and NAMA), which launches the
  CUDA kernel on a CUDA device, with or without a tolerance, and runs
  its plain version on the CPU; on a CUDA device, a tree past the
  kernel's limits (``fits``) runs the plain batched solve, as the JAX
  package keeps its XLA path there (``rapidnet_tpu/solver/batch.py:163-184``);
* ``'cuda'``: the batched kernel wrapper, and raises unless ``device``
  is a CUDA device;
* ``'torch'``: the plain batched PyTorch solve (``solver/apg.py``,
  ``solver/quasi_newton.py``) on any device.

``'stream'`` is refused, as the JAX package's batched controller refuses
it: the streaming kernels run one solve.

``mesh``: a ``parallel.Mesh2D`` (``parallel.make_mesh_2d``), the 2-D
(batch, scenario) mesh of ``rapidnet_tpu/solver/batch.py:128-161``: the
instances shard the batch axis and each instance's tree the scenario
axis, every rank calling ``control_action`` with the same global state.
The solves are the plain batched ones (``parallel.make_sharded_batch_shared``
with a shared forecaster, else ``make_sharded_apg_batch`` or
``make_sharded_qn_batch``; route ``'plain'``), as the JAX controller
forces its XLA path on a mesh; ``backend='cuda'`` with a mesh raises
instead of being dropped.  The controls, the warm start's duals and the
outputs come back global on every rank, so the simulator and the KPIs
run alike on every rank.

The built-in simulator advances each instance as ``SmpcController``
does, so an instance of a batch with its own forecaster runs the single
closed loop.

With one forecaster shared by every instance, the disturbance
elimination runs once per step (``Engine.prepare_step_shared``) and the
batch is assembled on the device from the shared base plus O(B nu)
per-instance vectors.  With one forecaster per instance, B step dicts
are prepared and stacked.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                        shared_step_tensors, step_arrays,
                                        stacked_step_tensors)
from rapidnet_tpu_torch.engine.engine import XS_UPPER, Engine
from rapidnet_tpu_torch.model.config import ALGORITHM_APG, SmpcConfig
from rapidnet_tpu_torch.model.forecaster import Forecaster
from rapidnet_tpu_torch.model.network import DwnNetwork
from rapidnet_tpu_torch.model.scenario_tree import ScenarioTree
from rapidnet_tpu_torch.ops import apg_solve, qn_solve
from rapidnet_tpu_torch.parallel.sharding import (
    Mesh2D, make_sharded_apg_batch, make_sharded_batch_shared,
    make_sharded_qn_batch, shard_factor_arrays)
from rapidnet_tpu_torch.solver import apg as apg_mod
from rapidnet_tpu_torch.solver import quasi_newton as qn_mod
from rapidnet_tpu_torch.solver.controller import (ALGORITHMS, BACKENDS,
                                                  resolve_device, tree_dims)


class BatchedSmpcController:
    """B closed-loop instances, one batched solve per time step.

    Instances share the network, scenario tree, factor step and
    iteration budget; they differ in initial state (``x0_batch``) and,
    optionally, in demand realisation (pass one forecaster per instance
    in ``forecasters``).  KPIs are tracked per instance.
    """

    def __init__(self, config: SmpcConfig, network: DwnNetwork,
                 tree: ScenarioTree,
                 forecasters: Forecaster | Sequence[Forecaster],
                 x0_batch: np.ndarray,
                 backend: str = "auto",
                 warm_start: bool = False,
                 tolerance: Optional[float] = None,
                 device="cuda",
                 mesh=None):
        """device: where the solves run ('cuda' by default; raises when
        no GPU is present).  mesh: a ``parallel.Mesh2D``, the batched
        solves sharded over its (batch, scenario) ranks (module
        docstring); they then run on the mesh's device, and ``device``
        must name the same kind (cpu or cuda)."""
        backends = tuple(b for b in BACKENDS if b != "stream")
        if backend not in backends:
            raise ValueError(f"unknown backend '{backend}' "
                             f"(expected one of {backends})")
        if mesh is not None:
            if not isinstance(mesh, Mesh2D):
                raise TypeError(f"mesh must be a rapidnet_tpu_torch."
                                f"parallel.Mesh2D (make_mesh_2d), got "
                                f"{type(mesh).__name__}")
            if backend == "cuda":
                raise ValueError(
                    "backend='cuda' with a mesh: the batched whole-solve "
                    "kernels are single-device; the 2-D mesh runs the "
                    "plain batched solves (backend 'auto' or 'torch')")
        if config.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm '{config.algorithm}'")
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
        self.tolerance = tolerance
        self.config = config
        self.network = network
        self.tree = tree
        x0_batch = np.asarray(x0_batch, np.float32)
        if x0_batch.ndim != 2:
            raise ValueError("x0_batch must be (B, nx)")
        self.batch = x0_batch.shape[0]
        if isinstance(forecasters, Forecaster):
            forecasters = [forecasters] * self.batch
        if len(forecasters) != self.batch:
            raise ValueError("need one forecaster (shared) or B")
        self.forecasters = list(forecasters)
        # one shared forecaster -> one elimination per time step with a
        # per-instance root correction, the batch assembled on the device
        self._shared_forecast = all(f is self.forecasters[0]
                                    for f in self.forecasters)
        self.engine = Engine(network, tree, config)
        self.warm_start = warm_start
        self.route = None        # 'kernel' or 'plain': what initialise()
        self._y_carry = None     # picked
        self._solver = None
        self._fa = None
        self._last = None
        self._last_control: Optional[np.ndarray] = None
        self.solve_times_ms: list[float] = []

        # per-instance closed-loop state
        self.current_x = x0_batch.copy()
        self.prev_u = np.tile(np.asarray(config.prev_u, np.float32),
                              (self.batch, 1))
        self.prev_demand = np.tile(
            np.asarray(config.prev_demand, np.float32), (self.batch, 1))

        # per-instance KPI accumulators
        self.economic_kpi_acc = np.zeros(self.batch)
        self.smooth_kpi_acc = np.zeros(self.batch)
        self.safe_kpi_acc = np.zeros(self.batch)
        self.network_kpi_acc = np.zeros(self.batch)

    # ------------------------------------------------------------------
    def initialise(self) -> None:
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
        shared = self._shared_forecast
        if cfg.algorithm == ALGORITHM_APG:
            plain = (apg_mod.make_apg_batch_shared if shared
                     else apg_mod.make_apg_batch)
            kernel = (apg_solve.make_apg_kernel_batch_shared if shared
                      else apg_solve.make_apg_kernel_batch)
        else:
            kw.update(algorithm=cfg.algorithm,
                      lbfgs_buffer_size=int(cfg.lbfgs_buffer_size))
            plain = (qn_mod.make_solver_batch_shared if shared
                     else qn_mod.make_solver_batch)
            kernel = (qn_solve.make_qn_kernel_batch_shared if shared
                      else qn_solve.make_qn_kernel_batch)
        if self.mesh is not None:
            self._initialise_sharded(kw)
            return
        fits = apg_solve.fits if cfg.algorithm == ALGORITHM_APG \
            else qn_solve.fits
        past_limits = (self.backend == "auto" and self.device.type == "cuda"
                       and not fits(**tree_dims(self._fa)))
        if self.backend == "torch" or past_limits:
            run, fa = plain(**kw), self._fa
            self.route = "plain"
            self._solver = lambda *args: run(fa, *args)
        else:
            self.route = "kernel"
            self._solver = kernel(self._fa, **kw)

    def _initialise_sharded(self, kw: dict) -> None:
        """The batched solves on the 2-D mesh
        (``rapidnet_tpu/solver/batch.py:128-161``): the shared-base form
        with a shared forecaster, else the stacked APG or FBE/NAMA form;
        the factor cut of this rank's column."""
        N, ns = self._fa["d1"].shape[:2]
        template = {"beta": torch.empty(N, ns, self._fa["invWbar"].shape[0],
                                        device="meta")}
        if self._shared_forecast:
            kw.setdefault("algorithm", self.config.algorithm)
            run = make_sharded_batch_shared(self.mesh, self._fa, template,
                                            **kw)
        elif self.config.algorithm == ALGORITHM_APG:
            run = make_sharded_apg_batch(self.mesh, self._fa, template, **kw)
        else:
            run = make_sharded_qn_batch(self.mesh, self._fa, template, **kw)
        fa = shard_factor_arrays(self._fa, self.mesh)
        self.route = "plain"
        self._solver = lambda *args: run(fa, *args)

    # ------------------------------------------------------------------
    def _forecast(self, fc: Forecaster, sim_time: int) -> None:
        if not (fc.predict_demand(sim_time) and fc.predict_prices(sim_time)):
            raise IndexError(f"forecaster exhausted at t={sim_time}")

    def control_action(self, sim_time: int) -> np.ndarray:
        """One batched solve; returns the (B, nu) stage-0 controls."""
        if self._solver is None:
            self.initialise()
        if self._shared_forecast:
            fc = self.forecasters[0]
            self._forecast(fc, sim_time)
            args = shared_step_tensors(*self.engine.prepare_step_shared(
                fc.nominal_demand, fc.nominal_prices, self.current_x,
                self.prev_u, self.prev_demand), self.device)
        else:
            steps = []
            for b, fc in enumerate(self.forecasters):
                self._forecast(fc, sim_time)
                steps.append(step_arrays(self.engine.prepare_step(
                    fc.nominal_demand, fc.nominal_prices,
                    self.current_x[b], self.prev_u[b],
                    self.prev_demand[b])))
            args = (stacked_step_tensors(steps, self.device),)
        t0 = time.perf_counter()
        y0 = self._y_carry if self.warm_start else None
        out = self._solver(*args, y0)
        control = out["control"].cpu().numpy()     # waits for the solves
        self.solve_times_ms.append((time.perf_counter() - t0) * 1e3)
        if self.warm_start:
            self._y_carry = out["y"]
        self._last = out
        self._last_control = control
        return control

    # ------------------------------------------------------------------
    def move_forward_in_time(self) -> np.ndarray:
        """Built-in simulator for every instance: x+ = x + B u + Gd d."""
        u = self._last_control
        if u is None:
            raise RuntimeError("call control_action first")
        net = self.network
        d = np.stack([fc.nominal_demand[0] for fc in self.forecasters])
        # each instance as SmpcController.move_forward_in_time computes it
        x = np.stack([(self.current_x[b] + net.matB @ u[b] +
                       net.matGd @ d[b]).astype(np.float32)
                      for b in range(self.batch)])
        self._update_kpi(x, u)
        self.current_x = x
        self.prev_u = u.copy()
        self.prev_demand = d
        return x

    def _update_kpi(self, state, control) -> None:
        net, cfg = self.network, self.config
        prices = np.stack([fc.nominal_prices[0]
                           for fc in self.forecasters])
        self.economic_kpi_acc += np.sum(
            cfg.weight_economical * (net.alpha1 + prices) *
            np.abs(control), axis=1)
        du = self.prev_u - control
        self.smooth_kpi_acc += np.sum(du * du, axis=1)
        level = np.minimum(state - net.xsafe, 0.0)
        self.safe_kpi_acc += np.abs(level).sum(axis=1)
        self.network_kpi_acc += np.abs(state).sum(axis=1)

    # per-instance KPI getters (same normalisation as SmpcController)
    def economic_kpi(self, sim_time: int) -> np.ndarray:
        return self.economic_kpi_acc / 3600.0 / max(sim_time, 1)

    def smooth_kpi(self, sim_time: int) -> np.ndarray:
        return self.smooth_kpi_acc / 3600.0 / max(sim_time, 1)

    def safety_kpi(self, sim_time: int) -> np.ndarray:
        return self.safe_kpi_acc.copy()

    def network_kpi(self, sim_time: int) -> np.ndarray:
        safe_norm = float(np.sum(self.network.xsafe))
        out = np.zeros(self.batch)
        nz = self.network_kpi_acc != 0
        out[nz] = (100.0 * max(sim_time, 1) * safe_norm /
                   self.network_kpi_acc[nz])
        return out

    # ------------------------------------------------------------------
    def closed_loop(self, steps: int) -> dict:
        """Run all B instances for ``steps`` time instances; returns the
        per-step (B, nu) controls, solve times and per-instance KPIs."""
        controls = []
        for t in range(steps):
            controls.append(self.control_action(t))
            self.move_forward_in_time()
        return {
            "controls": np.stack(controls),      # (T, B, nu)
            "solve_times_ms": list(self.solve_times_ms),
            "economicKpi": self.economic_kpi(steps),
            "smoothKpi": self.smooth_kpi(steps),
            "safetyKpi": self.safety_kpi(steps),
            "networkKpi": self.network_kpi(steps),
        }
