"""Scenario-axis sharded solve over a mesh of ranks.

The port's ``examples/multichip_sharded.py``: the scenario (fan-layout
slot) axis is sharded over ``--devices N`` ranks of a scenario mesh, one
process per rank (``parallel.make_sharded_apg``).  The non-branching
tail of both tree sweeps is local to a rank; the branching prefix's
child-to-parent sums and the global prox norms are all-reduced.

Run:
    torchrun --nproc-per-node N -m rapidnet_tpu_torch.examples.
        multichip_sharded --devices N [--iterations 100] [--device cpu]

The ranks join the process group as ``large_tree_streaming --devices N``
does (torchrun's variables or ``--dist-init``; gloo with ``--device
cpu``, NCCL on cards, ``cuda:<LOCAL_RANK>``); rank 0 alone prints.
"""

from __future__ import annotations

import argparse

from rapidnet_tpu_torch.examples import (add_device, add_mesh, join_mesh,
                                         solve_keywords)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    add_mesh(ap, default=8)
    ap.add_argument("--iterations", type=int, default=100)
    args = ap.parse_args(argv)

    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            step_arrays, step_tensors)
    from rapidnet_tpu_torch.engine.engine import Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.parallel import (AXIS, make_sharded_apg,
                                             shard_factor_arrays)
    from rapidnet_tpu_torch.solver.controller import resolve_device

    D = args.devices
    mesh = join_mesh(resolve_device(args.device), D, args.dist_init)
    net = synthetic_network(nx=16, nu=30, nd=20, ne=5, seed=3)
    # ns must be divisible by the mesh size; branching [D, 4] gives 4D
    tree = generate_tree(N=12, branching=[D, 4], nd=20, nu=30, seed=3)
    fc = synthetic_forecaster(N=12, nd=20, nu=30, sim_horizon=2, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=args.iterations,
                           step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_tensors(factor_arrays(eng), mesh.device)
    step = step_tensors(step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand)), mesh.device)

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"mesh: {{'{AXIS}': {mesh.size}}} on {mesh.device.type} "
        f"({tree.ns} scenarios, {tree.ns // D} per rank)")
    run = make_sharded_apg(mesh, fa, step, **solve_keywords(cfg, eng))
    out = run(shard_factor_arrays(fa, mesh), step)
    control = out["control"].cpu().numpy()
    trace = out["primal_infeasibility"].cpu().numpy()
    say("control u0:", control[:6])
    say(f"u layout: {tuple(out['u'].shape)} (N, ns, nu), global on every "
        f"rank")
    say("final infeasibility:", abs(trace[-1]))
    return {"control": control, "primal_infeasibility": trace,
            "u": out["u"].cpu().numpy(), "rank": mesh.rank,
            "network": net}


if __name__ == "__main__":
    main()
