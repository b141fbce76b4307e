#!/usr/bin/env python3
"""The config ladder's whole-solve APG rows on several copies of the
kernel's source, in turns, on one GPU.

    python3 tools/apg_ladder_ab.py NAME=DIR [NAME=DIR ...]
                                   [--rounds R] [--calls K] [--out FILE]

Each DIR holds an ``apg_solve.cu`` with this checkout's C ABI (an
earlier commit's ``rapidnet_tpu_torch/csrc``, say); each is built with
``ops/build.py``'s flags.  For each of the ladder's rows that the card
routes to the whole-solve kernel (ROWS: ``rapidnet_tpu_torch/
bench_ladder.py``'s problems at their recipes, the states from numpy
seed 7 as the ladder draws them) it first holds every source's call to
the first source's bit for bit, then runs R rounds of K calls of each
source in turns (the sources' order reversed every other round), each
call timed three ways: host ms until the call returns (the outputs'
allocation, the variant's planning and the enqueue of its launches),
device ms between CUDA events around it, and wall ms until synchronised
(what the ladder's ``p50_ms`` reads).  Where a source exports
``apg_solve_variant``, it also times that call alone (the planning of
a launch's variant, without a launch) over PLAN_CALLS calls.  Prints
every median beside the card's name and power limit, and the whole as
one JSON object on the last line (and into ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the ladder's whole-solve rows (bench_ladder.main): (dims, N, branching,
# tune, batch)
BARCELONA = ((63, 114, 88, 17), 24, [5, 5], True)
ROWS = {
    "1_toy_deterministic_H8": ((3, 6, 4, 2), 8, [1], False, None),
    "2_binary_tree_H12": ((3, 6, 4, 2), 12, [2], False, None),
    "3_barcelona_subset_100node_H24": ((20, 35, 25, 5), 24, [4], True, None),
    "4_barcelona_556node_H24": (*BARCELONA, None),
    "4_barcelona_556node_H24_batch16": (*BARCELONA, 16),
}
PLAN_CALLS = 200


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from rapidnet_tpu_torch import bench_ladder as L
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import build

    names, dirs = zip(*(s.split("=", 1) for s in args.sources))
    with ThreadPoolExecutor(len(dirs)) as pool:   # one nvcc a source
        paths = list(pool.map(lambda d: build.build(
            "apg_solve", source=pathlib.Path(d) / "apg_solve.cu"), dirs))
    libs = dict(zip(names, (ctypes.CDLL(str(p)) for p in paths)))
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "rounds": args.rounds, "calls": args.calls,
              "rows": {}}
    problems = {}
    for row, (dims, N, branching, tune, batch) in ROWS.items():
        key = (dims, N, tuple(branching), tune)
        if key not in problems:
            problems[key] = L.build(*dims, N, branching, device=dev,
                                    tune=tune)
        cfg, eng, fa, make_step, tree = problems[key]
        rng = np.random.default_rng(7)
        if batch:
            steps = [make_step(L.rand_x0(cfg, rng)) for _ in range(batch)]
            step = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        else:
            step = make_step(L.rand_x0(cfg, rng))
        kc = K.kernel_constants(
            fa, prefix_stages=eng.factor_step().prefix_stages,
            max_iterations=cfg.max_iterations)
        hyper = dict(L.solver_kw(cfg), tolerance=None)
        stream = torch.cuda.current_stream().cuda_stream

        def solve(name):
            return K._launch(libs[name], stream, kc, step, None, batch=batch,
                             **K._strides(kc, step, batch), **hyper)

        first = solve(names[0])
        for name in names[1:]:
            out = solve(name)
            for k in ("x", "u", "primal_infeasibility", "iterations"):
                if not torch.equal(out[k], first[k]):
                    raise SystemExit(f"{row}: {name} differs from "
                                     f"{names[0]} in {k}")
        torch.cuda.synchronize()
        times = {n: {"host": [], "device": [], "wall": []} for n in names}
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                for _ in range(args.calls):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ev0.record()
                    solve(name)
                    ev1.record()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    rec = times[name]
                    rec["host"].append((t1 - t0) * 1e3)
                    rec["device"].append(ev0.elapsed_time(ev1))
                    rec["wall"].append((t2 - t0) * 1e3)
        nv = fa["invWbar"].shape[0]
        vdims = (*fa["d1"].shape, fa["g"].shape[-1], nv, batch or 1)
        out = {}
        for name in names:
            med = {k: float(np.median(v)) for k, v in times[name].items()}
            plan_us = plan_time(libs[name], vdims)
            out[name] = {"median_ms": med, "plan_us": plan_us,
                         "ms": times[name]}
            plan = ("not exported" if plan_us is None else
                    f"{plan_us:.3f} us a call")
            print(f"[ab] {row} {name:9s} wall {med['wall']:.3f} ms, device "
                  f"{med['device']:.3f}, host {med['host']:.3f}; variant "
                  f"planning {plan} ({card})", flush=True)
        result["rows"][row] = {"scenarios": int(tree.ns), "N": int(tree.N),
                               "batch": batch or 1, "sources": out}
    print(card)
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line)
    print(line)
    return 0


def plan_time(lib, dims):
    """Median µs of one ``apg_solve_variant`` call at ``dims`` (N, ns, nx,
    nu, nv, B) over PLAN_CALLS calls, or None where the source has no
    such export."""
    fn = getattr(lib, "apg_solve_variant", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    ts = []
    for _ in range(PLAN_CALLS):
        t0 = time.perf_counter()
        code = fn(*dims)
        ts.append((time.perf_counter() - t0) * 1e6)
        if code < 0:
            raise SystemExit(f"apg_solve_variant failed: error {-code}")
    return float(np.median(ts))


if __name__ == "__main__":
    sys.exit(main())
