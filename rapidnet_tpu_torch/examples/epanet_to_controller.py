"""EPANET .inp -> reference-format JSONs -> closed-loop controller.

The port's ``examples/epanet_to_controller.py``: pipeline parity with the
reference's MATLAB preprocessing (src/paser/parserEpanet.m +
createDwnDataJson.m + generateJsonFile.m), done natively: parse an EPANET
network, build the mass-balance system, generate a scenario tree from a
demand forecaster, export everything in the reference JSON schemas
(``io/writers.py``), then run the controller on the exported files.

Run:
    python -m rapidnet_tpu_torch.examples.epanet_to_controller
        --inp my_network.inp --out DIR [--device cpu]
(without --inp a small built-in 3-tank network is used; --out defaults
to ``dwn_export`` in the temporary directory)
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from rapidnet_tpu_torch.examples import add_device, kpis


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inp", default=None, help="EPANET .inp file")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "dwn_export"))
    add_device(ap)
    args = ap.parse_args(argv)

    from rapidnet_tpu_torch.io import writers
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.controller import (SmpcController,
                                                      resolve_device)
    from rapidnet_tpu_torch.solver.tuning import auto_tune

    device = resolve_device(args.device)
    if args.inp:
        from rapidnet_tpu_torch.io.epanet import parse_epanet
        net = parse_epanet(args.inp)
    else:
        from rapidnet_tpu_torch.model.network import synthetic_network
        net = synthetic_network(nx=3, nu=6, nd=4, ne=2, seed=1)

    nd, nu = net.nd, net.nu
    N = 12
    fc = synthetic_forecaster(N=N, nd=nd, nu=nu, sim_horizon=4, seed=1)
    tree = generate_tree(N=N, branching=[2, 2], nd=nd, nu=nu, seed=1)
    cfg0 = synthetic_config(net, tree, max_iterations=150)
    cfg, _ = auto_tune(net, tree, cfg0, device=device)

    paths = writers.export_problem(net, tree, fc, cfg, args.out)
    print("exported reference-format JSONs:")
    for k, v in paths.items():
        print(f"  {k}: {v}")

    # round-trip: build the controller purely from the exported files
    ctrl = SmpcController(paths["config"], device=device)
    controls = []
    for t in range(2):
        u = ctrl.control_action(t)
        controls.append(u)
        ctrl.move_forward_in_time()
        print(f"t={t}  u0[:3]={np.round(u[:3], 4)}")
    print("KPIs:", ctrl.economic_kpi(2), ctrl.smooth_kpi(2))
    return {"controls": np.array(controls), "kpis": kpis(ctrl, 2),
            "route": ctrl.route, "paths": paths, "config": cfg,
            "network": net}


if __name__ == "__main__":
    main()
