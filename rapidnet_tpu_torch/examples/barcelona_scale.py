"""Barcelona-scale synthetic problem with auto-tuning and warm starts.

The port's ``examples/barcelona_scale.py``.  The reference ships
preprocessing for the Barcelona drinking-water network (src/paser/: 63
tanks, 114 controls) but computes the APG step size and diagonal
preconditioner out-of-band in MATLAB; ``solver/tuning.py`` derives both
on the device (a Jacobi dual preconditioner from Hutchinson probes of
the dual Hessian diagonal and a power-iteration Lipschitz estimate).

Run:
    python -m rapidnet_tpu_torch.examples.barcelona_scale [--device cpu]
        [--steps 3]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rapidnet_tpu_torch.examples import add_device, kpis


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    add_device(ap)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--scenarios", type=int, default=25,
                    help="5*ceil(K/5) scenarios via branching [5, K/5]")
    args = ap.parse_args(argv)

    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.controller import (SmpcController,
                                                      resolve_device)
    from rapidnet_tpu_torch.solver.tuning import auto_tune

    device = resolve_device(args.device)
    # Barcelona DWN dimensions (reference src/paser/dataSource/dwn.mat)
    net = synthetic_network(nx=63, nu=114, nd=88, ne=17, seed=42)
    b2 = max(args.scenarios // 5, 1)
    tree = generate_tree(N=24, branching=[5, b2], nd=88, nu=114, seed=42)
    fc = synthetic_forecaster(N=24, nd=88, nu=114,
                              sim_horizon=args.steps + 1, seed=42)
    cfg0 = synthetic_config(net, tree, max_iterations=args.iterations)

    t0 = time.perf_counter()
    cfg, _ = auto_tune(net, tree, cfg0, device=device)
    print(f"auto-tune (preconditioner + step size): "
          f"{time.perf_counter() - t0:.1f} s, step={cfg.step_size:.3e}")

    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          warm_start=True, device=device)
    controls = []
    for t in range(args.steps):
        controls.append(ctrl.control_action(t))
        ctrl.move_forward_in_time()
        print(f"t={t}  solve={ctrl.solve_times_ms[-1]:7.1f} ms  "
              f"final infeasibility "
              f"{abs(ctrl.primal_infeasibility[-1]):.2e}")
    print(f"economic kpi {ctrl.economic_kpi(args.steps):.4f}")
    return {"controls": np.array(controls), "kpis": kpis(ctrl, args.steps),
            "route": ctrl.route, "config": cfg, "network": net,
            "solve_ms": list(ctrl.solve_times_ms)}


if __name__ == "__main__":
    main()
