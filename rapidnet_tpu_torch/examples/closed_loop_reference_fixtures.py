"""Closed-loop SMPC on a reference-format problem.

The port's ``examples/closed_loop_reference_fixtures.py``, the
reference's product entry point (main.cu:34-69): build a controller from
the 4-file JSON config graph, then loop forecast -> controlAction ->
moveForwardInTime and report the KPIs.

Run:
    python -m rapidnet_tpu_torch.examples.closed_loop_reference_fixtures \\
        --config path/to/controllerConfig.json [--steps 3] [--device cpu]

Any reference-format controllerConfig.json works (the reference's
src/test/testDataFiles, or files written by ``io/writers.py``); the paths
inside it (pathToNetwork / pathToScenarioTree / pathToForecaster) are
resolved against the config file's directory.  The port names no
default file: ``--config`` is required.
"""

from __future__ import annotations

import argparse

import numpy as np

from rapidnet_tpu_torch.examples import add_device, kpis


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=3)
    add_device(ap)
    args = ap.parse_args(argv)

    from rapidnet_tpu_torch import SmpcController

    ctrl = SmpcController(args.config, device=args.device)
    controls = []
    for t in range(args.steps):
        u = ctrl.control_action(t)          # one receding-horizon solve
        x_next = ctrl.move_forward_in_time()  # built-in simulator + KPIs
        controls.append(u)
        print(f"t={t}  u0[:3]={u[:3]}  x+[:3]={x_next[:3]}  "
              f"solve={ctrl.solve_times_ms[-1]:.1f} ms")

    T = args.steps
    print(f"economic kpi {ctrl.economic_kpi(T):.4f}")
    print(f"smooth   kpi {ctrl.smooth_kpi(T):.4f}")
    print(f"safety   kpi {ctrl.safety_kpi(T):.4f}")
    print(f"network  kpi {ctrl.network_kpi(T):.4f}")
    return {"controls": np.array(controls), "kpis": kpis(ctrl, T),
            "route": ctrl.route, "network": ctrl.network}


if __name__ == "__main__":
    main()
