"""Large-tree streaming solves: all three algorithms on the streaming path.

The port's ``examples/large_tree_streaming.py``.  In the BASELINE config
5 regime (1000+ scenarios, ~20k tree nodes) the whole-solve kernels no
longer fit the card's shared memory, so ``backend='auto'`` (or an
explicit ``'stream'``, as here) runs the streaming solves: APG
(``ops/apg_stream.py``), FBE/NAMA (``solver/qn_stream.py``), and, with
``--devices N``, the sharded streaming path over N ranks of a scenario
mesh (``ops/apg_stream_sharded.py``), whose only traffic between ranks
is the distinct-parent all-reduce.

Run:
    python -m rapidnet_tpu_torch.examples.large_tree_streaming
        [--device cpu] [--scenarios 64] [--iters 60]
        [--algorithm proximalAlgorithm] [--devices N]
    torchrun --nproc-per-node N -m rapidnet_tpu_torch.examples.
        large_tree_streaming --devices N

``--devices N`` builds the mesh as the CLI's ``--devices`` does: one
process per rank (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
and MASTER_PORT, or ``--dist-init``), gloo with ``--device cpu``, NCCL
on cards (``cuda:<LOCAL_RANK>``); rank 0 alone prints.  (CPU runs use
the kernels' plain versions: keep --scenarios/--iters small.)
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rapidnet_tpu_torch.examples import (add_device, add_mesh, join_mesh,
                                         kpis)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--algorithm", default="proximalAlgorithm",
                    choices=["proximalAlgorithm", "globalFbeAlgorithm",
                             "namaAlgorithm"])
    add_mesh(ap, default=0)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)

    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.controller import (SmpcController,
                                                      resolve_device)

    device = resolve_device(args.device)
    # branching chosen so ns == --scenarios (power-of-2 fan)
    ns = args.scenarios
    branching = []
    while np.prod(branching or [1]) < ns:
        branching.append(2)
    nd, nu = 8, 13
    net = synthetic_network(nx=6, nu=nu, nd=nd, ne=3, seed=3)
    tree = generate_tree(N=12, branching=branching, nd=nd, nu=nu,
                         seed=3)
    fc = synthetic_forecaster(N=12, nd=nd, nu=nu,
                              sim_horizon=args.steps, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=args.iters,
                           step_size=1e-3)
    cfg.algorithm = args.algorithm

    mesh, rank = None, 0
    if args.devices:
        mesh = join_mesh(device, args.devices, args.dist_init)
        rank = mesh.rank
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend="stream", mesh=mesh, device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"tree: {tree.n_nodes} nodes, {tree.ns} scenarios, "
        f"algorithm {args.algorithm}, "
        f"mesh {args.devices or 'none'}")
    controls, solve_ms = [], []
    for t in range(args.steps):
        t0 = time.perf_counter()
        u = ctrl.control_action(t)
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        controls.append(u)
        ctrl.move_forward_in_time()
        say(f"t={t}: solve {solve_ms[-1]:.1f} ms  "
            f"u0[:4]={np.round(u[:4], 4)}")
    say("economic KPI", ctrl.economic_kpi(args.steps))
    return {"controls": np.array(controls), "kpis": kpis(ctrl, args.steps),
            "route": ctrl.route, "network": net, "solve_ms": solve_ms,
            "rank": rank}


if __name__ == "__main__":
    main()
