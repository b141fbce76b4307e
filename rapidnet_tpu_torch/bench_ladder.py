"""BASELINE.md's config ladder (configs 1-5) on the port.

    python -m rapidnet_tpu_torch.bench_ladder [--repeats 5] [--max-iter 500]
        [--only SUBSTR] [--device cuda|cpu] [--out PATH]

The port's counterpart of ``bench_ladder.py``: the same problems (its
``_build`` recipe, ``bench_ladder.py:50-78``, from the port's own
``model/`` and ``tuning.auto_tune``, seeds 42; states ``_rand_x0`` from
numpy seed 7, ``:181-184``), the same timing (``_time``, ``:168-178``:
inputs staged on the device, one warm call, then the median wall ms of
``--repeats`` calls, each synchronised) and the same row schema
(``:206-211``).  Config 5's rows take ``max(2, repeats // 2)`` calls, as
there.  ``device`` is the card's name and power limit as nvidia-smi
gives them; ``--device cpu`` runs every wrapper's plain version, which
measures PyTorch's CPU kernels and no device.

Rows and the solve each runs (``path``):

* ``1_toy_deterministic_H8``, ``2_binary_tree_H12``,
  ``3_barcelona_subset_100node_H24``, ``4_barcelona_556node_H24``: the
  route ``controller.auto_route`` picks on the card, the whole-solve APG
  kernel (``ops/apg_solve.make_apg_kernel``);
* ``4_barcelona_556node_H24_batch16``: ``make_apg_kernel_batch``, 16
  stacked instances;
* ``5_1024scenario_H24``: ``auto_route``'s route, the streaming kernels.
  The JAX ladder ran XLA there: its default route off the TPU kernel's
  VMEM differs;
* ``5_1024scenario_H24_bf16z``: the plain ``solver/apg.make_apg`` with
  the Nesterov difference stored in bf16 (``dual_dtype``);
* ``5_1024scenario_H24_stream``: ``make_apg_stream_kernel``;
* ``5_1024scenario_H24_shardmap_1dev``: the plain sharded APG solve
  (``parallel.make_sharded_apg``) on a mesh of one rank
  (``Mesh(0, 1, device)``, no process group: its collectives are local
  copies, as a 1-device shard_map's compile to nothing); the JAX
  ladder's shard_map row (``bench_ladder.py:215-246``): the sharded
  wrapper's own cost (the cuts, the gathers, the copies) over the plain
  solve, not a collective's;
* ``5_1024scenario_H24_stream_fused``: ``make_apg_stream_fused``, one
  cooperative launch an iteration (the JAX ladder's opt-in
  ``RAPIDNET_LADDER_FUSED`` guarded a remote TPU compile; here it runs by
  default);
* ``5h_512scenario_H24_stream_halfwidth``: ``make_apg_stream_kernel`` on
  branching [8, 8, 4, 2];
* ``5h_512scenario_H24_fbe_stream_halfwidth``: ``solver/qn_stream.
  make_qn_stream``, FBE, buffer 5, on the same tree.

Left out (ROADMAP.md lists each with the item that brings it): the real
Barcelona row ``3R`` (reference files this checkout lacks), the
emulated-shard rows (the "Do not port" list), and the TPU tooling
(virtual-device scaling, HLO collectives, transport latency, the
regression check against TPU numbers).

Every row records the wrappers it launched (``launches``).  A row that
raises is recorded with its ``error`` and the script exits nonzero once
the others have run.  It writes ``--out`` (default
``ladder_out/LADDER_torch.json``), never the JAX package's
``LADDER.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MAX_ITER = 500
CONFIG5 = dict(dims=(63, 114, 88, 17), N=24, branching=[8, 8, 4, 4])
HALF5 = dict(CONFIG5, branching=[8, 8, 4, 2])
DEFAULT_OUT = "ladder_out/LADDER_torch.json"
QN_BUFFER = 5        # bench_ladder.py:136


def build(nx, nu, nd, ne, N, branching, *, device, seed=42, tune=True,
          max_iter=MAX_ITER):
    """``bench_ladder._build``'s problem on the port: (cfg, engine, fa,
    make_step, tree), the factors and the steps on ``device``."""
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            step_arrays, step_tensors)
    from rapidnet_tpu_torch.engine.engine import Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.tuning import auto_tune

    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=seed)
    tree = generate_tree(N=N, branching=list(branching), nd=nd, nu=nu,
                         seed=seed)
    fc = synthetic_forecaster(N=N, nd=nd, nu=nu, sim_horizon=4, seed=seed)
    cfg0 = synthetic_config(net, tree, max_iterations=max_iter)
    if tune:
        cfg, eng = auto_tune(net, tree, cfg0, device=device)
    else:
        cfg, eng = cfg0, Engine(net, tree, cfg0)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_tensors(factor_arrays(eng), device)

    def make_step(x0):
        return step_tensors(step_arrays(eng.prepare_step(
            fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
            cfg.prev_demand)), device)

    return cfg, eng, fa, make_step, tree


def rand_x0(cfg, rng):
    """``bench_ladder._rand_x0``: the tanks at 0.9-1.1 of the state."""
    return (cfg.current_x *
            (0.9 + 0.2 * rng.random(cfg.current_x.shape))).astype(np.float32)


def solver_kw(cfg):
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    return dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                penalty_state=cfg.penalty_state,
                penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER),
                max_iterations=cfg.max_iterations)


def solver(problem, backend=None, *, batch=None):
    """(fn(step or stacked steps), path) for a row: ``backend`` None is
    the ``auto`` route (with ``batch``, the batched whole-solve kernel),
    else "bf16z", "stream", "stream_fused", "fbe_stream" or "shardmap"."""
    from rapidnet_tpu_torch.model.config import (ALGORITHM_APG,
                                                 ALGORITHM_FBE)
    from rapidnet_tpu_torch.ops import apg_solve, apg_stream
    from rapidnet_tpu_torch.solver import apg as apg_mod
    from rapidnet_tpu_torch.solver.controller import auto_route, tree_dims
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream

    cfg, eng, fa, make_step, _ = problem
    kw = dict(solver_kw(cfg), prefix_stages=eng.factor_step().prefix_stages)
    dev = fa["d1"].device
    if backend is None:
        # on the CPU every wrapper runs its plain version; the controller
        # keeps the whole-solve wrapper there
        backend = "kernel" if dev.type != "cuda" else auto_route(
            ALGORITHM_APG, tolerance=None, **tree_dims(fa))
    if backend == "kernel":
        if batch:
            run = apg_solve.make_apg_kernel_batch(fa, **kw)
            return run, "apg_solve_batch"
        return apg_solve.make_apg_kernel(fa, **kw), "apg_solve"
    if backend == "bf16z":
        plain = apg_mod.make_apg(dual_dtype=torch.bfloat16, **kw)
        return (lambda step: plain(fa, step)), "make_apg(dual_dtype=bf16)"
    if backend == "stream":
        return apg_stream.make_apg_stream_kernel(fa, **kw), "apg_stream"
    if backend == "shardmap":
        from rapidnet_tpu_torch.parallel import (Mesh, make_sharded_apg,
                                                 shard_factor_arrays)
        mesh = Mesh(0, 1, dev)
        run = make_sharded_apg(mesh, fa, make_step(cfg.current_x), **kw)
        fa_l = shard_factor_arrays(fa, mesh)
        return (lambda step: run(fa_l, step)), "make_sharded_apg(1 rank)"
    if backend == "stream_fused":
        return apg_stream.make_apg_stream_fused(fa, **kw), "apg_stream_fused"
    if backend == "fbe_stream":
        run = make_qn_stream(fa, algorithm=ALGORITHM_FBE,
                             lbfgs_buffer_size=QN_BUFFER, **kw)
        return run, "qn_stream(fbe)"
    raise ValueError(f"unknown ladder backend {backend!r}")


def wrappers():
    """Every kernel wrapper's launch count, by name."""
    from rapidnet_tpu_torch.ops import apg_solve, apg_stream
    from rapidnet_tpu_torch.ops import lbfgs as LB
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    return {"apg_solve": apg_solve.apg_solve,
            "apg_solve_batch": apg_solve.apg_solve_batch,
            "apg_stream": apg_stream.apg_stream,
            "apg_stream_fused": apg_stream.apg_stream_fused,
            "stream_qn.s1": SQ.s1_call, "stream_qn.s2": SQ.s2_call,
            "lbfgs.dots": LB.dots, "lbfgs.combine": LB.combine}


def time_ms(fn, arg, repeats, sync):
    """``bench_ladder._time``: one warm call, then the median wall ms of
    ``repeats`` calls, each synchronised (inputs already staged)."""
    sync()
    fn(arg)
    sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(arg)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def run_config(name, problem, repeats, *, backend=None, batch=None,
               max_iter=MAX_ITER):
    """One row: the solve of ``solver`` timed on states from numpy seed
    7, with the row schema of ``bench_ladder.run_config``."""
    cfg, _, fa, make_step, tree = problem
    dev = fa["d1"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn, path = solver(problem, backend, batch=batch)
    rng = np.random.default_rng(7)
    before = {k: w.launches for k, w in wrappers().items()}
    if batch:
        steps = [make_step(rand_x0(cfg, rng)) for _ in range(batch)]
        arg = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    else:
        arg = make_step(rand_x0(cfg, rng))
    ms = time_ms(fn, arg, repeats, sync)
    launches = {k: w.launches - before[k] for k, w in wrappers().items()
                if w.launches != before[k]}
    rec = {"config": name, "nodes": int(tree.n_nodes),
           "scenarios": int(tree.ns), "N": int(tree.N), "iters": max_iter,
           "path": f"{dev.type}:{path}", "data": "synthetic",
           "batch": batch or 1, "p50_ms": ms,
           "solves_per_s": (batch or 1) * 1e3 / ms, "launches": launches}
    print(json.dumps(rec), flush=True)
    return rec


def device_name(dev) -> str:
    """The card's name and power limit (nvidia-smi), or what ran."""
    if dev.type != "cuda":
        return "cpu (the plain versions; no device measured)"
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return (f"{torch.cuda.get_device_name(dev)} (nvidia-smi failed: "
                "power limit not read)")
    return lines[dev.index or 0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--max-iter", type=int, default=MAX_ITER,
                    help="iteration budget (500 = reference parity)")
    ap.add_argument("--only", default=None,
                    help="run only the rows whose name contains this")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_ladder: no CUDA GPU available (--device cpu runs the "
              "plain versions)", file=sys.stderr)
        return 1
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    rep, rep5 = args.repeats, max(2, args.repeats // 2)
    it = args.max_iter
    rows, problems = [], {}

    def problem(key, dims, N, branching, tune=True):
        if key not in problems:
            problems[key] = build(*dims, N, branching, device=dev,
                                  tune=tune, max_iter=it)
        return problems[key]

    # (name, problem key, its recipe, repeats, backend, batch)
    small = (3, 6, 4, 2)
    barcelona = (CONFIG5["dims"], 24, [5, 5])
    c5 = (CONFIG5["dims"], CONFIG5["N"], CONFIG5["branching"])
    half = (HALF5["dims"], HALF5["N"], HALF5["branching"])
    ladder = [
        ("1_toy_deterministic_H8", "1", (small, 8, [1], False), rep, None,
         None),
        ("2_binary_tree_H12", "2", (small, 12, [2], False), rep, None,
         None),
        ("3_barcelona_subset_100node_H24", "3", ((20, 35, 25, 5), 24, [4]),
         rep, None, None),
        ("4_barcelona_556node_H24", "4", barcelona, rep, None, None),
        ("4_barcelona_556node_H24_batch16", "4", barcelona, rep, None, 16),
        ("5_1024scenario_H24", "5", c5, rep5, None, None),
        ("5_1024scenario_H24_bf16z", "5", c5, rep5, "bf16z", None),
        ("5_1024scenario_H24_stream", "5", c5, rep5, "stream", None),
        ("5_1024scenario_H24_shardmap_1dev", "5", c5, rep5, "shardmap",
         None),
        ("5_1024scenario_H24_stream_fused", "5", c5, rep5, "stream_fused",
         None),
        ("5h_512scenario_H24_stream_halfwidth", "5h", half, rep5, "stream",
         None),
        ("5h_512scenario_H24_fbe_stream_halfwidth", "5h", half, rep5,
         "fbe_stream", None),
    ]
    for name, key, recipe, reps, backend, batch in ladder:
        if args.only is not None and args.only not in name:
            continue
        try:
            rows.append(run_config(name, problem(key, *recipe), reps,
                                   backend=backend, batch=batch,
                                   max_iter=it))
        except Exception as exc:  # noqa: BLE001 - recorded, exits nonzero
            rows.append({"config": name, "error": repr(exc)[:300]})
            print(json.dumps(rows[-1]), flush=True)
    results = {"backend": "torch", "torch": torch.__version__,
               "device": device_name(dev), "max_iter": it, "repeats": rep,
               "rows": rows}
    by = {r["config"]: r for r in rows if "p50_ms" in r}
    r4, r5 = by.get("4_barcelona_556node_H24"), by.get("5_1024scenario_H24")
    if r4 and r5:
        # bench_ladder.py:638-641: the per-scenario rate at ns = 1024
        # against ns = 25 on the same card
        results["weak_scaling_1024_vs_25_scenarios"] = (
            (r5["scenarios"] / r5["p50_ms"]) /
            (r4["scenarios"] / r4["p50_ms"]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    failed = [r["config"] for r in rows if "error" in r]
    print(json.dumps({"ladder": "done", "rows": len(rows),
                      "failed": failed, "out": str(out),
                      "weak_scaling_1024_vs_25_scenarios":
                          results.get("weak_scaling_1024_vs_25_scenarios")}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
