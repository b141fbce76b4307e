"""Entry points: a single-device solve and the multi-rank dry run.

The port's ``__graft_entry__.py``: ``entry()`` returns the full APG solve
and its arguments on one device; ``dryrun_multichip(n)``, run on every
rank of an n-rank process group, runs one solve of each sharded path on
a toy problem and raises ``AssertionError`` when a check fails:

1. the plain scenario-sharded APG (``parallel.make_sharded_apg``), 5
   iterations (APG_ITERATIONS);
2. the sharded streaming APG (``ops/apg_stream_sharded.py``: K1a, the
   partial parent block and K2 on the card), whose control must lie
   within 1e-3 * max(|c|, 1) of the plain sharded solve's;
3. 3 iterations (QN_ITERATIONS) of the sharded streaming FBE
   (``solver/qn_stream.make_qn_stream(mesh=...)``: the sharded S1 and S2
   and the history passes on the card);
4. when n is even and at least 4, the 2-D (batch, scenario) mesh of 2 x
   n/2 ranks, B = 4 instances, through ``parallel.make_sharded_apg_batch``.

On CPU tensors the kernels' plain versions run.

Run:
    python -m rapidnet_tpu_torch.examples.dryrun [--device cpu]
    torchrun --nproc-per-node N -m rapidnet_tpu_torch.examples.dryrun
        --devices N [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rapidnet_tpu_torch.examples import (add_device, add_mesh, join_mesh,
                                         solve_keywords)

STREAM_FACTOR = 1e-3      # the sharded streaming control against the plain
BATCH = 4                 # the 2-D mesh's instances
APG_ITERATIONS = 5        # the dry run's APG budgets
QN_ITERATIONS = 3         # its sharded streaming FBE's


def _toy_problem(*, N=8, branching=(2, 2), nx=4, nu=7, nd=3, ne=2,
                 max_iterations=50, seed=5, device="cpu"):
    """``__graft_entry__._toy_problem``: (config, engine, factor tensors,
    step tensors) on ``device``."""
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            step_arrays, step_tensors)
    from rapidnet_tpu_torch.engine.engine import Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=seed)
    tree = generate_tree(N=N, branching=list(branching), nd=nd, nu=nu,
                         seed=seed)
    fc = synthetic_forecaster(N=N, nd=nd, nu=nu, sim_horizon=4, seed=seed)
    cfg = synthetic_config(net, tree, max_iterations=max_iterations,
                           step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_tensors(factor_arrays(eng), device)
    step = step_tensors(step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand)), device)
    return cfg, eng, fa, step


def entry(device="cuda"):
    """(fn, example_args): the full APG solve (``solver.apg.make_apg``)
    and the toy problem's (fa, step) tensors on ``device``; fn(fa, step)
    runs every iteration of the receding-horizon solve."""
    from rapidnet_tpu_torch.solver import apg as apg_mod
    from rapidnet_tpu_torch.solver.controller import resolve_device
    cfg, eng, fa, step = _toy_problem(device=resolve_device(device))
    return apg_mod.make_apg(**solve_keywords(cfg, eng)), (fa, step)


def _check(ok: bool, message: str) -> None:
    """A dry-run check: AssertionError when it fails (also under -O)."""
    if not ok:
        raise AssertionError(message)


def _finite(name, c) -> np.ndarray:
    c = c.cpu().numpy()
    _check(np.isfinite(c).all(), f"{name} dry run produced NaNs")
    return c


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One solve of each sharded path on an ``n_devices``-rank mesh, run
    on every rank of the initialised process group (its size must be
    ``n_devices``, or a ValueError).  ``devices``: one per rank, as
    ``parallel.make_mesh`` takes them (default ``cuda:<local rank>``).
    Returns the controls: ``control`` (plain sharded), ``stream_control``,
    ``qn_control`` and, on the 2-D mesh, ``batch_control`` (B, nu)."""
    from rapidnet_tpu_torch.model.config import ALGORITHM_FBE
    from rapidnet_tpu_torch.ops.apg_stream_sharded import \
        make_apg_stream_sharded
    from rapidnet_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                             make_sharded_apg,
                                             make_sharded_apg_batch,
                                             shard_factor_arrays)
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream

    mesh = make_mesh(n_devices, devices=devices)
    # ns must be divisible by n_devices: branching (n_devices, 2)
    cfg, eng, fa, step = _toy_problem(N=6, branching=(int(n_devices), 2),
                                      max_iterations=APG_ITERATIONS,
                                      device=mesh.device)
    kw = solve_keywords(cfg, eng)
    control = _finite("multichip", make_sharded_apg(mesh, fa, step, **kw)(
        shard_factor_arrays(fa, mesh), step)["control"])

    # the sharded streaming path: K1a, the partial parent block and K2
    c_s = _finite("sharded-stream",
                  make_apg_stream_sharded(mesh, fa, **kw)(step)["control"])
    _check(np.abs(c_s - control).max() <=
           STREAM_FACTOR * max(np.abs(control).max(), 1.0),
           "sharded-stream control diverged from the plain sharded solve")

    # the sharded streaming FBE, a few iterations (sanity only)
    c_q = _finite("sharded-QN", make_qn_stream(
        fa, algorithm=ALGORITHM_FBE, lbfgs_buffer_size=5, mesh=mesh,
        **dict(kw, max_iterations=QN_ITERATIONS))(step)["control"])
    out = {"control": control, "stream_control": c_s, "qn_control": c_q}

    # the 2-D (batch, scen) mesh: instances over the batch axis,
    # scenario-tree shards within each row
    if n_devices % 2 == 0 and n_devices >= 4:
        n_scen = n_devices // 2
        cfg, eng, fa, step = _toy_problem(N=6, branching=(n_scen, 2),
                                          max_iterations=APG_ITERATIONS,
                                          device=mesh.device)
        steps = {k: torch.stack([v] * BATCH) for k, v in step.items()}
        mesh2 = make_mesh_2d(2, n_scen, devices=devices)
        c2 = _finite("2-D mesh", make_sharded_apg_batch(
            mesh2, fa, step, **solve_keywords(cfg, eng))(
                shard_factor_arrays(fa, mesh2), steps)["control"])
        _check(c2.shape[0] == BATCH, "2-D mesh dry run: wrong batch")
        out["batch_control"] = c2
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    add_mesh(ap, default=0)
    args = ap.parse_args(argv)
    from rapidnet_tpu_torch.solver.controller import resolve_device
    device = resolve_device(args.device)
    fn, fargs = entry(device)
    out = {"single": fn(*fargs)["control"].cpu().numpy()}
    rank = 0
    if args.devices:
        mesh = join_mesh(device, args.devices, args.dist_init)
        rank = mesh.rank
        out.update(dryrun_multichip(
            args.devices,
            devices=["cpu"] * args.devices if device.type == "cpu" else None))
    if rank == 0:
        print("single-device:", out["single"][:4])
        if args.devices:
            print("dryrun_multichip OK")
    return out


if __name__ == "__main__":
    main()
