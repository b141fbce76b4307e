"""Real Barcelona-scale problem assembly from the reference's data.

NumPy copy of ``rapidnet_tpu/io/datasource.py``.  Every function takes
the data directory ``ds_dir`` from its caller: the port fixes no default
location outside its checkout.

The reference ships real Barcelona-scale data in
``src/paser/dataSource/`` (consumed by its MATLAB preprocessing,
src/paser/createDwnDataJson.m):

* ``controllerConfig32.json`` — the REAL controller problem at
  Barcelona scale (nx=63, nu=114, nd=88, nv=97): null-space basis
  matL, particular solution matLhat, smoothing cost costW, the
  per-stage dual preconditioner, production cost alpha1, a 24-hour
  price profile alpha2, penalties (1e10/1e7), step size and the real
  initial state;
* ``scenarioTree32.json`` / ``scenarioTree65.json`` — real 136-node
  (K=6) and 667-node (K=30) scenario trees with real demand/price
  uncertainty vectors at the 88-demand dimension;
* ``dwn.mat`` — the 3-tank network with a full year of real hourly
  demands and prices (see io/matio.py);
* ``germany2016.xls`` — real hourly electricity prices (io/xls.py).

What the reference does NOT ship is the Barcelona network topology
itself: ``controllerConfig32.json:pathToNetwork`` points to
``systemData/network.json``, which is absent from the repository, so
the mass-balance matrices B/Gd and the volume/flow bounds cannot be
recovered (matE/matEd only up to the row space: E is reconstructed
here as the orthogonal complement of matL, Ed := -E @ matLhat, which
reproduces the real null-space geometry exactly).  ``real_network()``
therefore combines the REAL cost/preconditioner/null-space/initial
state with synthetic-but-deterministic topology and bounds, and every
consumer labels which components are real vs synthetic.
"""

from __future__ import annotations

import os

import numpy as np

from rapidnet_tpu_torch.io import jsonio
from rapidnet_tpu_torch.model.config import SmpcConfig
from rapidnet_tpu_torch.model.forecaster import ArrayForecaster
from rapidnet_tpu_torch.model.network import DwnNetwork
from rapidnet_tpu_torch.model.scenario_tree import ScenarioTree

# component provenance of the assembled Barcelona problem (kept with
# the code so benchmarks/reports can label rows mechanically)
BARCELONA_PROVENANCE = {
    "real": ["matL", "matLhat", "costW", "diag_precnd", "penalties",
             "step_size", "alpha1", "alpha2 (24h price profile)",
             "current_x", "prev_u", "prev_demand", "scenario tree "
             "(topology, probabilities, demand/price uncertainty)"],
    "synthetic": ["matB", "matGd", "x/u bounds", "nominal demand "
                  "forecast (scaled to the tree's real demand errors)"],
}


def available(ds_dir: str) -> bool:
    return os.path.isfile(os.path.join(ds_dir, "controllerConfig32.json"))


def _complement_basis(L: np.ndarray) -> np.ndarray:
    """Orthonormal basis of the orthogonal complement of span(L),
    as rows: the unique E (up to row rotation) with E @ L = 0."""
    nu, nv = L.shape
    U = np.linalg.svd(L, full_matrices=True)[0]
    return np.ascontiguousarray(U[:, nv:].T.astype(np.float32))


def real_config(ds_dir: str,
                max_iterations: int | None = None) -> SmpcConfig:
    """The real Barcelona controller config (controllerConfig32.json)."""
    cfg = SmpcConfig.from_json(
        os.path.join(ds_dir, "controllerConfig32.json"))
    if max_iterations is not None:
        cfg.max_iterations = int(max_iterations)
    return cfg


def real_network(cfg: SmpcConfig, ds_dir: str,
                 seed: int = 32) -> DwnNetwork:
    """Barcelona-dims network: REAL null-space geometry (E/Ed
    reconstructed from the real matL/matLhat), REAL production cost
    alpha1; synthetic deterministic B/Gd/bounds (see module docstring —
    the reference does not ship them)."""
    doc = jsonio.load_json(os.path.join(ds_dir, "controllerConfig32.json"))
    alpha1 = jsonio.vector(doc, "costAlpha1")
    nx, nu, nd = cfg.nx, cfg.nu, cfg.nd
    E = _complement_basis(cfg.mat_l)
    ne = E.shape[0]
    Ed = (-E @ cfg.mat_lhat).astype(np.float32)

    rng = np.random.default_rng(seed)
    B = (rng.uniform(-1, 1, (nx, nu)) *
         (rng.random((nx, nu)) < 3.0 / nx)).astype(np.float32)
    for j in range(nu):
        if not B[:, j].any():
            B[rng.integers(nx), j] = 1.0
    Gd = np.zeros((nx, nd), np.float32)
    for k in range(nd):
        Gd[rng.integers(nx), k] = -1.0

    # bounds anchored to the REAL initial volumes: tanks start inside
    # [xmin, xmax] with the MATLAB xsafe convention (0.35 * xmax,
    # src/paser/createDwnDataJson.m)
    x0 = np.asarray(cfg.current_x, np.float32)
    xmax = (2.5 * np.maximum(x0, 100.0)).astype(np.float32)
    net = DwnNetwork(
        nx=nx, nu=nu, nd=nd, ne=ne,
        matA=np.eye(nx, dtype=np.float32),
        matB=B, matGd=Gd, matE=E, matEd=Ed,
        xmin=np.zeros(nx, np.float32), xmax=xmax,
        xsafe=(0.35 * xmax).astype(np.float32),
        umin=np.zeros(nu, np.float32),
        umax=rng.uniform(100, 2000, nu).astype(np.float32),
        alpha1=alpha1.astype(np.float32),
    )
    net.validate()
    return net


def real_forecaster(cfg: SmpcConfig, tree: ScenarioTree,
                    ds_dir: str, sim_horizon: int = 8,
                    seed: int = 32) -> ArrayForecaster:
    """Forecaster with the REAL 24h price profile (costAlpha2) and a
    synthetic diurnal nominal demand scaled to the tree's REAL demand
    uncertainty magnitudes (so solver conditioning matches the real
    problem's)."""
    doc = jsonio.load_json(os.path.join(ds_dir, "controllerConfig32.json"))
    alpha2 = jsonio.vector(doc, "costAlpha2").reshape(cfg.N, cfg.nu)
    T = sim_horizon + cfg.N
    reps = int(np.ceil(T / cfg.N))
    prices = np.tile(alpha2, (reps, 1))[:T]

    scale = float(np.abs(tree.err_demand).mean()) * 5.0
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    base = rng.uniform(0.5, 1.5, cfg.nd) * max(scale, 1e-3)
    demand = (base[None, :] *
              (1.0 + 0.4 * np.sin(2 * np.pi * t[:, None] / 24.0 +
                                  rng.uniform(0, 6, cfg.nd)[None, :])))
    return ArrayForecaster(demand.astype(np.float32),
                           prices.astype(np.float32), cfg.N)


def load_barcelona_problem(ds_dir: str,
                           tree_file: str = "scenarioTree32.json",
                           max_iterations: int | None = None):
    """Assemble the real-data Barcelona problem.

    Returns (config, network, tree, forecaster).  Provenance of each
    component: see BARCELONA_PROVENANCE.
    """
    cfg = real_config(ds_dir, max_iterations)
    tree = ScenarioTree.from_json(os.path.join(ds_dir, tree_file))
    net = real_network(cfg, ds_dir)
    fc = real_forecaster(cfg, tree, ds_dir)
    return cfg, net, tree, fc
