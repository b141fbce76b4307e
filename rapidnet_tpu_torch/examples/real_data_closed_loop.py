"""Closed-loop SMPC over the reference's real data.

The port's ``examples/real_data_closed_loop.py``.  Two real-data
problems from the reference's ``src/paser/dataSource`` directory
(``--data-dir``, required: the port names no default directory):

1. ``--problem dwn``: the 3-tank network from dwn.mat driven by its full
   year of measured hourly demands and real electricity tariffs
   (``io/matio.py``).
2. ``--problem barcelona``: the Barcelona-scale controller
   (controllerConfig32.json: real null-space geometry, costs,
   preconditioner, penalties, initial state) with the real 136-node
   scenario tree (scenarioTree32.json); the network topology is
   synthetic-deterministic (``io/datasource.py`` documents each
   component's provenance).

Usage:
  python -m rapidnet_tpu_torch.examples.real_data_closed_loop \\
      --data-dir DIR --problem dwn --steps 24
  python -m rapidnet_tpu_torch.examples.real_data_closed_loop \\
      --data-dir DIR --problem barcelona --steps 4
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rapidnet_tpu_torch.examples import add_device, kpis


def run_dwn(data_dir: str, steps: int, iters: int, start_hour: int,
            device):
    from rapidnet_tpu_torch.io.matio import (load_dwn_forecaster,
                                             load_dwn_network)
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.controller import SmpcController
    from rapidnet_tpu_torch.solver.tuning import auto_tune

    mat = os.path.join(data_dir, "dwn.mat")
    net = load_dwn_network(mat)
    # units: volumes m^3, controls/demands m^3/s; the .mat's B/Gd
    # already integrate the 3600 s control step (entries are +/-3600)
    N = 24
    tree = generate_tree(N=N, branching=[3], nd=net.nd, nu=net.nu,
                         seed=7, demand_sigma=0.002)
    fc = load_dwn_forecaster(mat, N=N, start=start_hour,
                             hours=N + steps + 1)
    cfg = synthetic_config(net, tree, max_iterations=iters)
    # start just above the safety levels so the controller has to pump
    # (with half-full tanks the economic optimum is u = 0 for hours)
    cfg.current_x = np.maximum(0.12 * net.xmax,
                               1.1 * net.xsafe).astype(np.float32)
    cfg, _ = auto_tune(net, tree, cfg, device=device)
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          device=device)


def run_barcelona(data_dir: str, steps: int, iters: int, device):
    from rapidnet_tpu_torch.io.datasource import load_barcelona_problem
    from rapidnet_tpu_torch.solver.controller import SmpcController

    cfg, net, tree, fc = load_barcelona_problem(data_dir,
                                                max_iterations=iters)
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True,
                    help="the reference's src/paser/dataSource directory")
    ap.add_argument("--problem", choices=["dwn", "barcelona"],
                    default="dwn")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--start-hour", type=int, default=3000,
                    help="dwn: hour of the year to start at")
    add_device(ap)
    args = ap.parse_args(argv)

    from rapidnet_tpu_torch.solver.controller import resolve_device
    device = resolve_device(args.device)
    if args.problem == "dwn":
        ctrl = run_dwn(args.data_dir, args.steps, args.iterations,
                       args.start_hour, device)
    else:
        ctrl = run_barcelona(args.data_dir, args.steps, args.iterations,
                             device)

    controls = []
    for t in range(args.steps):
        u = ctrl.control_action(t)
        x = ctrl.move_forward_in_time()
        controls.append(u)
        print(f"t={t}: |u|={np.abs(u).sum():9.3f}  "
              f"x in [{x.min():9.2f}, {x.max():10.2f}]  "
              f"solve {ctrl.solve_times_ms[-1]:7.1f} ms")
    print(f"economic kpi {ctrl.economic_kpi(args.steps):.6f}")
    print(f"smooth   kpi {ctrl.smooth_kpi(args.steps):.6f}")
    print(f"safety   kpi {ctrl.safety_kpi(args.steps):.6f}")
    print(f"network  kpi {ctrl.network_kpi(args.steps):.6f}")
    return {"controls": np.array(controls),
            "kpis": kpis(ctrl, args.steps), "route": ctrl.route,
            "config": ctrl.config, "network": ctrl.network}


if __name__ == "__main__":
    main()
