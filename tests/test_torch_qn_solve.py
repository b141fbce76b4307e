"""The whole-solve FBE/NAMA kernel module (rapidnet_tpu_torch/ops/
qn_solve.py).

On the CPU the wrapper runs the kernel's plain version; it is held to
the JAX package's whole-solve QN kernel, ``pallas_qn.make_qn_pallas``,
in interpret mode, with the JAX package's own bounds between that kernel
and its XLA path (tests/test_pallas_qn.py:59-89): over the first TRACK
iterations tau rtol 1e-4 / atol 1e-6, the FBE value rtol 2e-3 / atol
2e-4 * max(|value|, 1), the infeasibility rtol 2e-3 / atol 1e-4; control
rtol 1e-3 / atol 1e-4, u rtol 1e-3 / atol 1e-3.  The line search
branches on value comparisons, so two float32 implementations part after
some iterations; past TRACK only the converged quality is compared
(tests/test_pallas_qn.py:141-166).  The CUDA kernel itself is checked
against the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).

The problem is the JAX QN tests' (tests/test_pallas_qn.py:33-56).  The
trajectories are compared at a step size of 1e-3, at the generators'
state and with the tanks above their box, where the penalties are
active and u is ~100: there u and the control are held as the JAX
package holds them on its reference problem, whose penalties are
active too (atol 2e-3 * max|ref|, tests/test_pallas_qn.py:131-138).  At
the JAX tests' step size of 1e-4 the FBE trace's second entry is a
difference of near-equal terms: float32 implementations land 4e-4 to
6e-4 from a float64 solve on either side of it, so no bound of the JAX
tests' holds between two of them that err on opposite sides (the TPU
kernel and the XLA path err on the same side).  The warm start (the
JAX tests' own case, whose first iterations start away from that
cancellation) and the tolerance exit (which compares no trace; there
the residual magnitude crosses a tolerance early) are checked at 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_parity import SMALL, assert_close, jax_problem, port_inputs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGORITHMS = ["globalFbeAlgorithm", "namaAlgorithm"]
TRACK = 4           # tests/test_pallas_qn.py:28-30
BS = 5              # lbfgsBufferSize of the JAX tests and bench.py
CASES = {"nominal": dict(step_size=1e-3),
         "stressed": dict(step_size=1e-3, x0_scale=1.2),
         "jax_tests": dict(step_size=1e-4)}


def _problem(case="nominal", max_iterations=TRACK):
    eng, fa, step, kw = jax_problem(**SMALL, **CASES[case],
                                    max_iterations=max_iterations)
    return eng, fa, step, dict(kw, lbfgs_buffer_size=BS)


def _assert_solution_close(got, ref, case):
    if case == "stressed":
        for k in ("control", "u"):
            scale = max(float(np.abs(np.asarray(ref[k])).max()), 1.0)
            assert_close(got[k], ref[k], rtol=0.0, atol=2e-3 * scale)
    else:
        assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)
        assert_close(got["u"], ref["u"], rtol=1e-3, atol=1e-3)


def _port(fa, step, kw, prefix, algorithm, y0=None, tolerance=None):
    from rapidnet_tpu_torch.ops import qn_solve as Q
    fa_t, step_t = port_inputs(fa, step)
    kc = Q.kernel_constants(fa_t, prefix_stages=prefix)
    if y0 is not None:
        y0 = {k: torch.tensor(np.asarray(v)) for k, v in y0.items()}
    n0 = Q.qn_solve.launches
    out = Q.qn_solve(kc, step_t, y0, algorithm=algorithm,
                     tolerance=tolerance, **kw)
    assert Q.qn_solve.launches == n0      # the CPU never launches
    return out


def _pallas(fa, step, kw, algorithm, y0=None, tolerance=None):
    from rapidnet_tpu.ops import pallas_qn
    run = pallas_qn.make_qn_pallas(fa, algorithm=algorithm, interpret=True,
                                   tolerance=tolerance, **kw)
    return run(step) if y0 is None else run(step, y0)


def _trace_parity(got, ref, n):
    vscale = max(float(np.abs(np.asarray(ref["value_fbe"])).max()), 1.0)
    assert_close(got["tau"][:n], np.asarray(ref["tau"])[:n],
                 rtol=1e-4, atol=1e-6)
    assert_close(got["value_fbe"][:n], np.asarray(ref["value_fbe"])[:n],
                 rtol=2e-3, atol=2e-4 * vscale)
    assert_close(got["primal_infeasibility"][:n],
                 np.asarray(ref["primal_infeasibility"])[:n],
                 rtol=2e-3, atol=1e-4)


def _pad_dual(y, fa):
    """The port's unpadded dual -> the TPU kernel's padded
    {"xi1", "xi2", "psi"} (tests/test_pallas_qn.py:190-201)."""
    import jax.numpy as jnp
    from rapidnet_tpu.ops import pallas_apg
    N, ns, nx = np.asarray(fa["d1"]).shape
    nu = np.asarray(fa["g"]).shape[-1]
    NSP = pallas_apg._pad_to(ns, 8)
    PX = pallas_apg._pad_to(nx, pallas_apg.LANE)
    PU = pallas_apg._pad_to(nu, pallas_apg.LANE)

    def pad(a, P):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, NSP - a.shape[1]),
                                        (0, P - a.shape[2])))

    return {"xi1": pad(y["xi"][..., :nx], PX),
            "xi2": pad(y["xi"][..., nx:], PX), "psi": pad(y["psi"], PU)}


@pytest.mark.parametrize("case", ["nominal", "stressed"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_wrapper_tracks_pallas_interpret(algorithm, case):
    eng, fa, step, kw = _problem(case)
    prefix = eng.factor_step().prefix_stages
    ref = _pallas(fa, step, kw, algorithm)
    got = _port(fa, step, kw, prefix, algorithm)
    assert int(got["iterations"]) == TRACK
    assert set(got) == {"control", "x", "u", "y", "primal_infeasibility",
                        "value_fbe", "tau", "iterations",
                        "line_search_trials", "lbfgs_skips"}
    _trace_parity(got, ref, TRACK)
    _assert_solution_close(got, ref, case)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_wrapper_converged_quality_against_pallas(algorithm):
    """At 120 iterations both drive the residual to comparable levels,
    and the applied control lies within the physical bounds."""
    iters = 120
    eng, fa, step, kw = _problem(max_iterations=iters)
    prefix = eng.factor_step().prefix_stages
    ref = _pallas(fa, step, kw, algorithm)
    got = _port(fa, step, kw, prefix, algorithm)
    tail_p = np.median(np.abs(got["primal_infeasibility"].numpy())[-20:])
    tail_x = np.median(np.abs(np.asarray(ref["primal_infeasibility"]))[-20:])
    assert tail_p < 10 * max(tail_x, 1e-6), (tail_p, tail_x)
    u0 = got["control"].numpy()
    assert (u0 >= np.asarray(fa["umin_phys"]) - 1e-5).all()
    assert (u0 <= np.asarray(fa["umax_phys"]) + 1e-5).all()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_wrapper_warm_start_matches_pallas(algorithm):
    """The port's unpadded warm start {"xi", "psi"} against the TPU
    kernel's padded one, built from the same numbers: the L-BFGS buffer
    starts fresh on both sides.  The JAX tests' problem and warm start
    (tests/test_pallas_qn.py:169-208)."""
    eng, fa, step, kw = _problem("jax_tests")
    prefix = eng.factor_step().prefix_stages
    N, ns, nx = np.asarray(fa["d1"]).shape
    nu = np.asarray(fa["g"]).shape[-1]
    rng = np.random.default_rng(3)
    y0 = {"xi": (0.05 * rng.standard_normal((N, ns, 2 * nx))
                 ).astype(np.float32),
          "psi": (0.05 * rng.standard_normal((N, ns, nu))
                  ).astype(np.float32)}
    ref = _pallas(fa, step, kw, algorithm, y0=_pad_dual(y0, fa))
    got = _port(fa, step, kw, prefix, algorithm, y0=y0)
    _trace_parity(got, ref, TRACK)
    assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_wrapper_tolerance_exit_matches_pallas(algorithm):
    """With a tolerance both stop at the same iteration and zero-pad
    the three traces (tests/test_pallas_qn.py:307-342).  The tolerance
    comes from the plain solve's residual magnitudes: of those that stop
    it past the first iteration, the one farthest from the edges of its
    exit (quasi_newton.exit_tolerances)."""
    from rapidnet_tpu_torch.solver import quasi_newton as qn_mod

    eng, fa, step, kw = _problem("jax_tests", max_iterations=20)
    prefix = eng.factor_step().prefix_stages
    fa_t, step_t = port_inputs(fa, step)
    mags = qn_mod.make_solver(algorithm=algorithm, prefix_stages=prefix,
                              trace_magnitude=True, **kw)(fa_t, step_t)
    found = qn_mod.exit_tolerances(mags["residual_magnitude"].numpy(),
                                  kw["max_iterations"] - 1)
    assert found, "no tolerance stops the solve mid-budget"
    tol, it, _ = found[0]
    got = _port(fa, step, kw, prefix, algorithm, tolerance=tol)
    ref = _pallas(fa, step, kw, algorithm, tolerance=tol)
    assert int(ref["iterations"]) == int(got["iterations"]) == it
    assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)
    for key in ("primal_infeasibility", "value_fbe", "tau"):
        assert (got[key][it:] == 0).all(), key


def test_make_qn_kernel_warm_starts_from_its_own_output():
    """make_qn_kernel's run(step, y0): the output dual is the unpadded
    {"xi", "psi"} and feeds the next solve as it is."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    eng, fa, step, kw = _problem()
    fa_t, step_t = port_inputs(fa, step)
    run = Q.make_qn_kernel(fa_t, algorithm="namaAlgorithm",
                           prefix_stages=eng.factor_step().prefix_stages,
                           **kw)
    N, ns, nx = fa_t["d1"].shape
    nu = fa_t["g"].shape[-1]
    cold = run(step_t)
    assert cold["y"]["xi"].shape == (N, ns, 2 * nx)
    assert cold["y"]["psi"].shape == (N, ns, nu)
    warm = run(step_t, cold["y"])
    assert torch.isfinite(warm["u"]).all()
    assert not torch.equal(warm["u"], cold["u"])


def test_wrapper_rejects_inputs_the_kernel_does_not_take():
    from rapidnet_tpu_torch.ops import qn_solve as Q

    eng, fa, step, kw = _problem()
    fa_t, step_t = port_inputs(fa, step)
    kc = Q.kernel_constants(fa_t, prefix_stages=eng.factor_step()
                            .prefix_stages)
    fbe = dict(kw, algorithm="globalFbeAlgorithm")
    bad = [dict(step_t, beta=step_t["beta"].double()),
           dict(step_t, alpha_price=step_t["alpha_price"][:, :2]),
           dict(step_t, e=step_t["e"].transpose(0, 1).contiguous()
                .transpose(0, 1))]
    for b in bad:
        with pytest.raises(ValueError):
            Q.qn_solve(kc, b, None, **fbe)
    no_alpha = {k: v for k, v in step_t.items() if k != "alpha_price"}
    with pytest.raises(KeyError):
        Q.qn_solve(kc, no_alpha, None, **fbe)
    with pytest.raises(ValueError, match="unknown quasi-Newton"):
        Q.qn_solve(kc, step_t, None, **dict(fbe, algorithm="apg"))
    with pytest.raises(ValueError, match="lbfgs_buffer_size"):
        Q.qn_solve(kc, step_t, None, **dict(fbe, lbfgs_buffer_size=0))
    meta = {k: v.to("meta") for k, v in step_t.items()}
    with pytest.raises(ValueError, match="meta"):
        Q.qn_solve(kc, meta, None, **fbe)


def test_import_builds_nothing():
    """Importing the kernel module runs no nvcc and needs none."""
    code = ("from rapidnet_tpu_torch.ops import build, qn_solve\n"
            "assert build.load.cache_info().currsize == 0\n"
            "assert qn_solve.qn_solve.launches == 0\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
