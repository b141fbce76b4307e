"""Batched Monte-Carlo closed-loop evaluation (BASELINE config #5).

The port's ``examples/batched_monte_carlo.py``: one SMPC controller
over B perturbed initial conditions and per-instance demand realisations
at once; each time step runs ONE batched solve for all instances
(``BatchedSmpcController``: the batched whole-solve kernel on a GPU),
then every instance's plant advances on its own.

Run:
    python -m rapidnet_tpu_torch.examples.batched_monte_carlo
        [--device cpu] [--batch 8] [--steps 4]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rapidnet_tpu_torch.examples import add_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=150)
    add_device(ap)
    args = ap.parse_args(argv)

    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.batch import BatchedSmpcController
    from rapidnet_tpu_torch.solver.controller import resolve_device

    device = resolve_device(args.device)
    nx, nu, nd, ne, N = 10, 18, 12, 4, 12
    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=1)
    tree = generate_tree(N=N, branching=[3, 2], nd=nd, nu=nu, seed=1)
    cfg = synthetic_config(net, tree, max_iterations=args.iterations,
                           step_size=1e-3)

    # B perturbed initial tank levels + B demand realisations
    rng = np.random.default_rng(0)
    x0s = cfg.current_x * (0.8 + 0.4 * rng.random((args.batch, nx)))
    forecasters = [
        synthetic_forecaster(N=N, nd=nd, nu=nu,
                             sim_horizon=args.steps + 2, seed=100 + b)
        for b in range(args.batch)
    ]

    bctrl = BatchedSmpcController(cfg, net, tree, forecasters, x0s,
                                  device=device)
    t0 = time.perf_counter()
    log = bctrl.closed_loop(args.steps)
    wall = time.perf_counter() - t0

    n_solves = args.batch * args.steps
    print(f"{n_solves} solves ({args.batch} instances x {args.steps} "
          f"steps) in {wall:.2f}s -> {n_solves / wall:.1f} solves/s")
    print(f"controls shape {log['controls'].shape}")
    print(f"economic KPI  mean {log['economicKpi'].mean():.4f}  "
          f"spread [{log['economicKpi'].min():.4f}, "
          f"{log['economicKpi'].max():.4f}]")
    print(f"safety  KPI   mean {log['safetyKpi'].mean():.4f}")
    print(f"network KPI   mean {log['networkKpi'].mean():.2f}")
    if not np.all(np.isfinite(log["controls"])):
        raise RuntimeError("non-finite controls")
    print("OK")
    return {"controls": log["controls"],
            "kpis": {"economic": log["economicKpi"],
                     "smooth": log["smoothKpi"],
                     "safety": log["safetyKpi"],
                     "network": log["networkKpi"]},
            "route": bctrl.route, "network": net, "wall_s": wall,
            "solves_per_s": n_solves / wall}


if __name__ == "__main__":
    main()
