"""Reference-format JSON writers.

NumPy copy of ``rapidnet_tpu/io/writers.py``: equal objects give
byte-equal files from either package (the port's ``jsonio.dump_json``
is the JAX package's code).

Counterpart of the MATLAB ``generateJsonFile.m`` / ``createDwnDataJson.m``
(src/paser/): serialise ScenarioTree / Forecaster / SmpcConfig objects
into the exact JSON schemas the reference parses
(src/ScenarioTree.cuh:23-40, src/Forecaster.cuh:23-30,
src/SmpcConfiguration.cuh:24-47), so problems generated here can be fed
back to the CUDA reference (and vice versa).
"""

from __future__ import annotations

import numpy as np

from rapidnet_tpu_torch.io import jsonio


def tree_to_json(tree, path) -> None:
    """ScenarioTree -> reference scenarioTree.json (1-based ids)."""
    n_children_cumul = np.zeros(tree.n_nodes, np.int64)
    acc = 0
    for node in range(tree.n_nodes):
        acc += len(tree.children_of[node])
        n_children_cumul[node] = acc
    children = np.concatenate(
        [c for c in tree.children_of if len(c)]) + 1 \
        if tree.n_nodes > 1 else np.zeros(0, np.int64)
    doc = {
        "N": [tree.N], "K": [tree.ns],
        "dimDemand": [tree.dim_demand], "dimPrice": [tree.dim_price],
        "nodes": [tree.n_nodes],
        "nChildrenTot": [tree.n_children_tot],
        "nNonLeafNodes": [tree.n_nonleaf],
        "stages": tree.stage,
        "nodesPerStage": tree.nodes_per_stage,
        "nodesPerStageCumul": tree.nodes_per_stage_cumul,
        "leaves": tree.leaves + 1,
        "children": children,
        "ancestor": tree.ancestor + 1,
        "nChildren": tree.n_children,
        "nChildrenCumul": n_children_cumul,
        "probNode": tree.prob,
        "errorDemandNode": tree.err_demand.reshape(-1),
        "errorPriceNode": tree.err_price.reshape(-1),
    }
    jsonio.dump_json(path, doc)


def forecaster_to_json(forecaster, path, *, start_id: int = 4875) -> None:
    """ArrayForecaster -> reference forecastor.json (time-indexed keys,
    member offsets 4+2t / 5+2t, src/Forecaster.cu:93-119)."""
    doc = {
        "N": [forecaster.N],
        "simHorizon": [forecaster.sim_horizon],
        "dimDemand": [forecaster.dim_demand],
        "dimPrices": [forecaster.dim_prices],
    }
    for t in range(forecaster.sim_horizon):
        assert forecaster.predict_demand(t) and forecaster.predict_prices(t)
        doc[f"timeIdDemand{start_id + t}"] = \
            forecaster.nominal_demand.reshape(-1)
        doc[f"timeIdPrice{start_id + t}"] = \
            forecaster.nominal_prices.reshape(-1)
    jsonio.dump_json(path, doc)


def config_to_json(cfg, path, *, network_path="network.json",
                   tree_path="scenarioTree.json",
                   forecaster_path="forecastor.json",
                   mat_l=None, mat_lhat=None) -> None:
    """SmpcConfig -> reference controllerConfig.json (column-major mats)."""
    L = mat_l if mat_l is not None else cfg.mat_l
    Lhat = mat_lhat if mat_lhat is not None else cfg.mat_lhat
    doc = {
        "nx": [cfg.nx], "nu": [cfg.nu], "ne": [cfg.nu - cfg.nv],
        "nv": [cfg.nv], "nd": [cfg.nd], "N": [cfg.N],
        "matDiagPrecnd": np.asarray(cfg.diag_precnd).reshape(-1),
        "costW": np.asarray(cfg.cost_w).T.reshape(-1),
        "currentX": cfg.current_x,
        "prevDemand": cfg.prev_demand,
        "prevU": cfg.prev_u,
        "prevUhat": np.zeros(cfg.nu, np.float32),
        "prevV": np.zeros(cfg.nv, np.float32),
        "stepSize": [cfg.step_size],
        "maxIterations": [cfg.max_iterations],
        "penaltyStateX": [cfg.penalty_state],
        "penaltySafetyX": [cfg.penalty_safety],
        "pathToNetwork": str(network_path),
        "pathToScenarioTree": str(tree_path),
        "pathToForecaster": str(forecaster_path),
        "algorithmName": cfg.algorithm,
        "lbfgsBufferSize": [cfg.lbfgs_buffer_size],
    }
    # L / Lhat are optional: when absent the Engine recomputes them from
    # the network topology via the SVD null-space elimination
    # (engine/nullspace.py; reference src/Engine.cu:466-669).
    if L is not None:
        doc["matL"] = np.asarray(L).T.reshape(-1)
    if Lhat is not None:
        doc["matLhat"] = np.asarray(Lhat).T.reshape(-1)
    jsonio.dump_json(path, doc)


def export_problem(network, tree, forecaster, cfg, directory,
                   mat_l=None, mat_lhat=None) -> dict[str, str]:
    """Write the 4-file reference problem set into a directory."""
    import os

    os.makedirs(directory, exist_ok=True)
    paths = {
        "network": os.path.join(directory, "network.json"),
        "tree": os.path.join(directory, "scenarioTree.json"),
        "forecaster": os.path.join(directory, "forecastor.json"),
        "config": os.path.join(directory, "controllerConfig.json"),
    }
    network.to_json(paths["network"])
    tree_to_json(tree, paths["tree"])
    forecaster_to_json(forecaster, paths["forecaster"])
    config_to_json(cfg, paths["config"], network_path=paths["network"],
                   tree_path=paths["tree"],
                   forecaster_path=paths["forecaster"],
                   mat_l=mat_l, mat_lhat=mat_lhat)
    return paths
