"""The port's counterparts of ``examples/*.py`` that run on one device.

Each module is the JAX example of its name on the port: the same
problem, seeds, defaults and printed lines, with ``--device`` (default
``cuda``, which raises when no GPU is present; ``cpu`` runs the plain
versions) where the JAX example has ``--platform``.  Each has
``main(argv=None)``, which prints as the JAX example does and returns a
dict of what it computed (the controls, the KPIs, the route and the
network whose bounds the controls obey), and runs as ``python -m
rapidnet_tpu_torch.examples.<name>``:

* ``barcelona_scale``: the Barcelona-scale synthetic problem, auto-tuned,
  a warm-started closed loop;
* ``batched_monte_carlo``: B perturbed instances, one batched solve a
  step;
* ``epanet_to_controller``: a network (EPANET or synthetic) exported to
  the reference's JSON files and run from them;
* ``large_tree_streaming``: the streaming solves on a larger tree, one
  device or ``--devices N`` ranks of a scenario mesh;
* ``closed_loop_reference_fixtures``: a closed loop on a reference-format
  ``controllerConfig.json`` (``--config``);
* ``real_data_closed_loop``: the dwn.mat network and the Barcelona
  dataSource (``--data-dir``).

``multichip_sharded`` and ``__graft_entry__.dryrun_multichip`` are not ported
yet.
"""

from __future__ import annotations


def add_device(parser) -> None:
    """The examples' ``--device`` flag."""
    parser.add_argument("--device", default="cuda",
                        help="torch device of the solves (default cuda; "
                             "raises when no GPU is present; cpu runs the "
                             "plain versions)")


def kpis(ctrl, steps: int) -> dict:
    """A controller's four KPIs after ``steps`` steps."""
    return {"economic": ctrl.economic_kpi(steps),
            "smooth": ctrl.smooth_kpi(steps),
            "safety": ctrl.safety_kpi(steps),
            "network": ctrl.network_kpi(steps)}
