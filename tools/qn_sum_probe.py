#!/usr/bin/env python3
"""Which float32 sum of the plain FBE/NAMA solve parts it from a float64
witness, on one GPU.

    python3 tools/qn_sum_probe.py

Runs the case of ``tests/test_torch_cuda.py``'s L-BFGS wrap tests (the
synthetic problem from tanks at 1.2 times their maximum, buffer 3, 8
iterations) through the whole-solve QN kernel, through the plain float32
version (``ops/qn_solve.qn_solve_plain``) as it is and with one site's
reductions at a time (``SITES``: the dual-space dots, the FBE value,
the prox's sums of squares, each sweep's products) computed in float64
and cast back, then all of them, and through the plain version in
float64 (the witness).  For each algorithm it prints
the infeasibility traces, each one's largest distance from the
witness's in units of the wrap test's bound (rtol 2e-3, atol 1e-4), and
whether the kernel holds that variant under the bound.  Then the
witness's own conditioning: the witness again from the step's floats
perturbed by relative noise of PERTURB (numpy seed 0), each draw's
distance from the unperturbed witness in the same units.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rapidnet_tpu_torch.ops import qn_solve as Q  # noqa: E402
from rapidnet_tpu_torch.solver import quasi_newton as qn  # noqa: E402
from rapidnet_tpu_torch.solver import solve_step as ss  # noqa: E402

RTOL, ATOL = 2e-3, 1e-4      # the wrap test's bound on the infeasibility
PERTURB, DRAWS = 1e-7, 4     # about float32's rounding, relative


def card_tests():
    spec = importlib.util.spec_from_file_location(
        "card_tests", ROOT / "tests" / "test_torch_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def as64(x):
    if isinstance(x, dict):
        return {k: as64(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(as64(v) for v in x)
    return (x.double() if torch.is_tensor(x) and x.dtype == torch.float32
            else x)


def as32(x):
    if isinstance(x, dict):
        return {k: as32(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(as32(v) for v in x)
    return (x.float() if torch.is_tensor(x) and x.dtype == torch.float64
            else x)


def promoted(fn):
    """fn on its float32 inputs taken to float64, its outputs cast back:
    its sums and products accumulate in float64."""
    def run(*args, **kwargs):
        return as32(fn(*as64(args), **as64(kwargs)))
    return run


# the functions whose reductions a variant takes to float64
SITES = {"masked_dot": (qn, "masked_dot"), "value_fbe": (qn, "value_fbe"),
         "prox sums": (ss, "_masked_sumsq"),
         "backward sweep": (ss, "backward_sweep"),
         "forward sweep": (ss, "forward_sweep")}
VARIANTS = {"float32": (), **{name: (name,) for name in SITES},
            "all": tuple(SITES)}


def main() -> int:
    if not torch.cuda.is_available():
        print("qn_sum_probe: no CUDA GPU available", file=sys.stderr)
        return 1
    t = card_tests()
    dev = torch.device("cuda")
    kc, step, kw = t._qn_problem(dev, **t.QN_CASES["stressed"],
                                 max_iterations=t.QN_WRAP)
    kw["lbfgs_buffer_size"] = t.QN_WRAP_BS
    saved = {name: getattr(*site) for name, site in SITES.items()}
    for algorithm in t.QN_ALGORITHMS:
        kern = Q.qn_solve(kc, step, None, algorithm=algorithm, **kw)
        wit = Q.qn_solve_plain(dict(kc, fa=t._float64(kc["fa"])),
                               t._float64(step), None, algorithm=algorithm,
                               **kw)
        w = wit["primal_infeasibility"].cpu().numpy()

        def units(tr):
            return float(np.max(np.abs(tr - w) / (RTOL * np.abs(w) + ATOL)))

        k = kern["primal_infeasibility"].cpu().numpy()
        print(f"{algorithm} float64 witness: {w.tolist()}")
        print(f"{algorithm} kernel: {k.tolist()} (from the witness "
              f"{units(k):.3f} bounds)")
        for name, sites in VARIANTS.items():
            for site in sites:
                setattr(*SITES[site], promoted(saved[site]))
            out = Q.qn_solve_plain(kc, step, None, algorithm=algorithm, **kw)
            tr = out["primal_infeasibility"].cpu().numpy()
            gap = float(np.max(np.abs(k - tr) / (RTOL * np.abs(tr) + ATOL)))
            print(f"{algorithm} plain, {name}: {tr.tolist()} (from the "
                  f"witness {units(tr):.3f} bounds; the kernel from it "
                  f"{gap:.3f} bounds: {'held' if gap <= 1 else 'NOT held'}"
                  f"; trials {int(out['line_search_trials'])} against the "
                  f"kernel's {int(kern['line_search_trials'])})")
            for site, fn in saved.items():
                setattr(*SITES[site], fn)
        rng = np.random.default_rng(0)
        step64 = t._float64(step)
        for d in range(DRAWS):
            noisy = {k: v * (1 + PERTURB * torch.as_tensor(
                rng.standard_normal(tuple(v.shape)), device=v.device))
                if torch.is_tensor(v) and v.is_floating_point() else v
                for k, v in step64.items()}
            out = Q.qn_solve_plain(dict(kc, fa=t._float64(kc["fa"])), noisy,
                                   None, algorithm=algorithm, **kw)
            tr = out["primal_infeasibility"].cpu().numpy()
            print(f"{algorithm} witness from the step perturbed by "
                  f"{PERTURB:g} (draw {d}): from the witness "
                  f"{units(tr):.3f} bounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
