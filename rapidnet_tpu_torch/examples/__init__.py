"""The port's counterparts of ``examples/*.py`` and ``__graft_entry__.py``.

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
  dataSource (``--data-dir``);
* ``multichip_sharded``: one scenario-sharded APG solve over
  ``--devices N`` ranks (``examples/multichip_sharded.py``);
* ``dryrun``: the counterparts of ``__graft_entry__.py``, ``entry()``
  (a single-device solve) and ``dryrun_multichip(n)`` (the sharded
  solves and the 2-D mesh, run on every rank).

The examples with ``--devices N`` join the process group as the CLI
does (``join_mesh``): one process per rank, torchrun's variables or
``--dist-init``, gloo with ``--device cpu`` and NCCL on cards.
"""

from __future__ import annotations


def add_device(parser) -> None:
    """The examples' ``--device`` flag."""
    parser.add_argument("--device", default="cuda",
                        help="torch device of the solves (default cuda; "
                             "raises when no GPU is present; cpu runs the "
                             "plain versions)")


def add_mesh(parser, default: int) -> None:
    """The flags of the examples that run on a mesh of ranks."""
    parser.add_argument("--devices", type=int, default=default,
                        help="shard the scenario axis over N processes")
    parser.add_argument("--dist-init", default=None,
                        help="the process group's init method (default "
                             "env://, torchrun's variables)")


def join_mesh(device, n_devices: int, init_method=None):
    """Join the process group of ``n_devices`` ranks (a no-op when this
    process has joined it) and return the scenario mesh over it: gloo on
    the CPU, NCCL on cards (``cuda:<LOCAL_RANK>``)."""
    from rapidnet_tpu_torch.parallel import distributed, make_mesh
    cpu = device.type == "cpu"
    distributed.initialize(backend="gloo" if cpu else "nccl",
                           init_method=init_method)
    return make_mesh(n_devices,
                     devices=["cpu"] * n_devices if cpu else None)


def solve_keywords(cfg, eng) -> dict:
    """The keywords of the APG solves (``make_apg``, ``make_sharded_apg``
    and the like) for a config and its engine."""
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    return dict(prefix_stages=eng.factor_step().prefix_stages,
                inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                penalty_state=cfg.penalty_state,
                penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER),
                max_iterations=cfg.max_iterations)


def kpis(ctrl, steps: int) -> dict:
    """A controller's four KPIs after ``steps`` steps."""
    return {"economic": ctrl.economic_kpi(steps),
            "smooth": ctrl.smooth_kpi(steps),
            "safety": ctrl.safety_kpi(steps),
            "network": ctrl.network_kpi(steps)}
