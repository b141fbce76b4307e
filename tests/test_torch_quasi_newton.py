"""The port's plain FBE/NAMA solvers (rapidnet_tpu_torch/solver/
quasi_newton.py) against the JAX package's XLA path.

The same inputs, made with the JAX package's generators from a seed (or
with numpy), go to both packages as numpy arrays.  Tolerances:

* the pieces (FBE value, L-BFGS update and direction, line searches)
  compute the same float32 arithmetic in another order: rtol 1e-5 with
  an atol of 1e-5 of the largest magnitude;
* whole solves use the JAX package's own bounds between two
  implementations of this solve (tests/test_pallas_qn.py:59-70, 85-89):
  tau rtol 1e-4 / atol 1e-6, value rtol 2e-3 / atol 2e-4 * max(|value|,
  1), infeasibility rtol 2e-3 / atol 1e-4 over the first TRACK
  iterations, control rtol 1e-3 / atol 1e-4, u rtol 1e-3 / atol 1e-3.
  The line search branches on value comparisons, so two float32
  implementations part after some iterations (test_pallas_qn.py:1-15);
  past that horizon only the converged quality is compared.

The JAX sweeps run their stage recursions as a sequential scan, the
branch the port mirrors (solve_step.SCAN_MIN_NS, as
tests/test_batch.py:195-210 selects it): at ns = 4 the JAX package's
default is a stage-axis cumsum that sums in another order, and the FBE
trace, a difference of near-equal terms, already parts by 1e-3 at the
second iteration between those two f32 orders (each as far from a
float64 solve as the other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (SMALL, assert_close, jax_problem,
                                 port_inputs, to_numpy)

torch.set_num_threads(2)

FBE, NAMA = "globalFbeAlgorithm", "namaAlgorithm"
ALGORITHMS = [FBE, NAMA]
TRACK = 4           # tests/test_pallas_qn.py:28-30
BS = 5              # lbfgsBufferSize of the JAX tests and bench.py


@pytest.fixture(autouse=True)
def _jax_sequential_sweeps(monkeypatch):
    from rapidnet_tpu.solver import solve_step as jss
    monkeypatch.setattr(jss, "SCAN_MIN_NS", 1)


def _qn_problem(max_iterations=TRACK, **kw):
    eng, fa, step, skw = jax_problem(**SMALL, step_size=1e-4,
                                     max_iterations=max_iterations, **kw)
    return eng, fa, step, dict(skw, lbfgs_buffer_size=BS)


def _close_rel(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    assert_close(got, ref, rtol=rtol,
                 atol=rtol * max(float(np.abs(ref).max()), 1.0))


def _trace_parity(got, ref, n):
    vscale = max(float(np.abs(np.asarray(ref["value_fbe"])).max()), 1.0)
    assert_close(got["tau"][:n], np.asarray(ref["tau"])[:n],
                 rtol=1e-4, atol=1e-6)
    assert_close(got["value_fbe"][:n], np.asarray(ref["value_fbe"])[:n],
                 rtol=2e-3, atol=2e-4 * vscale)
    assert_close(got["primal_infeasibility"][:n],
                 np.asarray(ref["primal_infeasibility"])[:n],
                 rtol=2e-3, atol=1e-4)


def _t(tree):
    """numpy (nested dicts too) -> float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def test_convert_carries_the_jax_keys():
    """factor_arrays/step_arrays have every key of the JAX package's
    _factor_arrays/_step_arrays, with the same values."""
    from rapidnet_tpu.solver.controller import _factor_arrays, _step_arrays
    from rapidnet_tpu_torch.convert import factor_arrays, step_arrays
    from rapidnet_tpu_torch.engine.engine import Engine as PortEngine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    eng, fa_j, step_j, _ = jax_problem(**SMALL)
    p = SMALL
    net = synthetic_network(nx=p["nx"], nu=p["nu"], nd=p["nd"], ne=p["ne"],
                            seed=p["seed"])
    tree = generate_tree(N=p["N"], branching=list(p["branching"]),
                         nd=p["nd"], nu=p["nu"], seed=p["seed"])
    fc = synthetic_forecaster(N=p["N"], nd=p["nd"], nu=p["nu"],
                              sim_horizon=4, seed=p["seed"])
    cfg = synthetic_config(net, tree, max_iterations=25, step_size=1e-4)
    peng = PortEngine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_arrays(peng)
    step = step_arrays(peng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand))
    assert set(fa) == set(fa_j)
    assert set(step) == set(step_j)
    for k in ("prob", "W", "Wv", "alpha1"):
        np.testing.assert_allclose(np.asarray(fa[k]), np.asarray(fa_j[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(step["alpha_price"],
                               np.asarray(step_j["alpha_price"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["nominal", "stressed"])
def test_value_fbe_matches_jax(case):
    from rapidnet_tpu.solver import quasi_newton as jqn
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    eng, fa, step, kw = _qn_problem(
        x0_scale=1.2 if case == "stressed" else None)
    fa_t, step_t = port_inputs(fa, step)
    N, ns, nx = np.asarray(fa["d1"]).shape
    nu = np.asarray(fa["g"]).shape[-1]
    rng = np.random.default_rng(4)

    def dual():
        return {"xi": rng.standard_normal((N, ns, 2 * nx)).astype(np.float32),
                "psi": rng.standard_normal((N, ns, nu)).astype(np.float32)}

    w, res = dual(), dual()
    u = rng.standard_normal((N, ns, nu)).astype(np.float32)
    vg = np.float32(0.37)
    ref = jqn.value_fbe(fa, step, w, u, res, vg, step_size=kw["step_size"])
    got = qn.value_fbe(fa_t, step_t, _t(w), _t(u), _t(res), torch.tensor(vg),
                       step_size=kw["step_size"])
    _close_rel(got, ref)


def _lbfgs_case(fa, kind):
    """A buffer about to wrap (col == size, mem == size), random history,
    and a curvature pair that is accepted or rejected."""
    N, ns, nx = np.asarray(fa["d1"]).shape
    nu = np.asarray(fa["g"]).shape[-1]
    rng = np.random.default_rng(9)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    n_cols = BS + 1
    lb = {"mat_s": {"xi": rnd(n_cols, N, ns, 2 * nx),
                    "psi": rnd(n_cols, N, ns, nu)},
          "mat_y": {"xi": rnd(n_cols, N, ns, 2 * nx),
                    "psi": rnd(n_cols, N, ns, nu)},
          "rho": np.abs(rnd(n_cols)) + 0.1, "col": BS, "mem": BS,
          "skips": 2, "hessian": np.float32(0.7)}
    for m in ("mat_s", "mat_y"):
        for k in ("xi", "psi"):
            lb[m][k][0] = 0.0
    lb["rho"][0] = 0.0
    y, y_prev = {"xi": rnd(N, ns, 2 * nx), "psi": rnd(N, ns, nu)}, None
    s = {"xi": 0.1 * rnd(N, ns, 2 * nx), "psi": 0.1 * rnd(N, ns, nu)}
    y_prev = {k: y[k] - s[k] for k in s}
    yvec_prev = {"xi": rnd(N, ns, 2 * nx), "psi": rnd(N, ns, nu)}
    sign = 1.0 if kind == "accepted" else -1.0
    yvec = {k: yvec_prev[k] + sign * 2.0 * s[k] for k in s}
    return lb, y, y_prev, yvec, yvec_prev


@pytest.mark.parametrize("kind", ["accepted", "rejected"])
def test_lbfgs_update_and_direction_matches_jax(kind):
    from rapidnet_tpu.solver import quasi_newton as jqn
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    _, fa, _, _ = _qn_problem()
    fa_t, _ = port_inputs(fa, {})
    lb, y, y_prev, yvec, yvec_prev = _lbfgs_case(fa, kind)
    lb_j = dict(lb, col=jnp.int32(lb["col"]), mem=jnp.int32(lb["mem"]),
                skips=jnp.int32(lb["skips"]))
    ref_lb, ref_d = jqn.lbfgs_update_and_direction(
        fa, lb_j, y, y_prev, yvec, yvec_prev, buffer_size=BS)
    lb_t = dict(_t({k: lb[k] for k in ("mat_s", "mat_y", "rho",
                                       "hessian")}),
                col=lb["col"], mem=lb["mem"], skips=lb["skips"])
    got_lb, got_d = qn.lbfgs_update_and_direction(
        fa_t, lb_t, _t(y), _t(y_prev), _t(yvec), _t(yvec_prev),
        buffer_size=BS)
    accepted = kind == "accepted"
    # the wrap: col == size goes to column 1 when the pair is accepted
    assert got_lb["col"] == int(ref_lb["col"]) == (1 if accepted else BS)
    assert got_lb["mem"] == int(ref_lb["mem"]) == BS
    assert got_lb["skips"] == int(ref_lb["skips"]) == (2 if accepted else 3)
    _close_rel(got_lb["hessian"], ref_lb["hessian"])
    _close_rel(got_lb["rho"], ref_lb["rho"])
    for m in ("mat_s", "mat_y"):
        for k in ("xi", "psi"):
            _close_rel(got_lb[m][k], ref_lb[m][k])
            assert not got_lb[m][k][0].any()
    for k in ("xi", "psi"):
        _close_rel(got_d[k], ref_d[k])


def _ls_state(fa, step, kw, prefix):
    """One iteration's pre-search state on both sides (from y = 0), the
    gradient and the first L-BFGS direction (-yvec, empty buffer)."""
    from rapidnet_tpu.solver import quasi_newton as jqn
    from rapidnet_tpu.solver import solve_step as jss

    N, ns, nx = np.asarray(fa["d1"]).shape
    nu = np.asarray(fa["g"]).shape[-1]
    w = {"xi": jnp.zeros((N, ns, 2 * nx)), "psi": jnp.zeros((N, ns, nu))}
    sol = jss.solve_step(fa, w["xi"], w["psi"], step["beta"], step["uhat"],
                         step["e"], step["x0"], step["prev_u"],
                         step["prev_uhat"], prefix_stages=prefix)
    prox = dict(inv_step=kw["inv_step"], penalty_state=kw["penalty_state"],
                penalty_safety=kw["penalty_safety"],
                xs_upper=kw["xs_upper"])
    dxi, dpsi, vg = jss.prox_g(fa, sol["prim_xi"], sol["prim_psi"],
                               w["xi"], w["psi"], **prox)
    res = {"xi": sol["prim_xi"] - dxi, "psi": sol["prim_psi"] - dpsi}
    state = {"x": sol["x"], "u": sol["u"], "w": w,
             "prim": {"xi": sol["prim_xi"], "psi": sol["prim_psi"]},
             "dual": {"xi": dxi, "psi": dpsi}, "res": res, "value_g": vg}
    h = jqn.oracle(fa, res["xi"], res["psi"], prefix_stages=prefix)
    grad = {"xi": -res["xi"] - kw["step_size"] * h["prim_xi"],
            "psi": -res["psi"] - kw["step_size"] * h["prim_psi"]}
    direction = {k: -grad[k] for k in grad}
    value = jqn.value_fbe(fa, step, w, sol["u"], res, vg,
                          step_size=kw["step_size"])
    return state, grad, direction, value, prox


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_line_search_matches_jax(algorithm):
    from rapidnet_tpu.solver import quasi_newton as jqn
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    eng, fa, step, kw = _qn_problem(x0_scale=1.2)
    prefix = eng.factor_step().prefix_stages
    fa_t, step_t = port_inputs(fa, step)
    state, grad, direction, value, prox = _ls_state(fa, step, kw, prefix)
    ls_kw = dict(prefix_stages=prefix, prox_kwargs=prox,
                 step_size=kw["step_size"])
    if algorithm == FBE:
        ref_st, ref_tau = jqn.fbe_line_search(fa, step, state, grad,
                                              direction, value, **ls_kw)
        got_st, got_tau = qn.fbe_line_search(
            fa_t, step_t, _t(to_numpy(state)), _t(to_numpy(grad)),
            _t(to_numpy(direction)), torch.tensor(np.asarray(value)),
            **ls_kw)
    else:
        ref_st, ref_tau = jqn.ame_line_search(fa, step, state, direction,
                                              value, **ls_kw)
        got_st, got_tau = qn.ame_line_search(
            fa_t, step_t, _t(to_numpy(state)), _t(to_numpy(direction)),
            torch.tensor(np.asarray(value)), **ls_kw)
    assert got_tau == pytest.approx(float(ref_tau), rel=1e-6)
    for k in ("x", "u"):
        _close_rel(got_st[k], ref_st[k], rtol=1e-4)
    for k in ("xi", "psi"):
        _close_rel(got_st["w"][k], ref_st["w"][k], rtol=1e-4)
        _close_rel(got_st["res"][k], ref_st["res"][k], rtol=1e-4)


def test_nan_trial_stops_the_line_search():
    """A trial whose FBE value is NaN fails ``val <= value_ref``: the
    search stops with that trial applied (quasi_newton.py:209), on both
    sides."""
    from rapidnet_tpu.solver import quasi_newton as jqn
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    eng, fa, step, kw = _qn_problem()
    prefix = eng.factor_step().prefix_stages
    fa_t, step_t = port_inputs(fa, step)
    state, grad, direction, value, prox = _ls_state(fa, step, kw, prefix)
    h = jqn.oracle(fa, direction["xi"], direction["psi"],
                   prefix_stages=prefix)
    dirs = {k: np.array(h[k]) for k in ("x", "u", "prim_xi", "prim_psi")}
    dirs["u"][0, 0, 0] = np.nan     # u enters the FBE value
    ls_kw = dict(prox_kwargs=prox, step_size=kw["step_size"])
    dval = jqn.dual_dot(grad, direction, fa["rep"])
    ref_st, ref_tau = jqn.tau_line_search(fa, step, state, direction, dirs,
                                          value, dval, **ls_kw)
    got_st, got_tau = qn.tau_line_search(
        fa_t, step_t, _t(to_numpy(state)), _t(to_numpy(direction)),
        _t(dirs), torch.tensor(np.asarray(value)),
        torch.tensor(np.asarray(dval)), **ls_kw)
    assert float(ref_tau) == got_tau == 1.0
    assert got_st["trials"] == 1
    # one trial applied: w moved by exactly one direction step
    for k in ("xi", "psi"):
        _close_rel(got_st["w"][k],
                   np.asarray(state["w"][k]) + np.asarray(direction[k]))
        _close_rel(got_st["w"][k], ref_st["w"][k])
    assert torch.isnan(got_st["u"]).any()


def _solve(algorithm, fa, step, kw, prefix, y0=None, tolerance=None,
           **extra):
    from rapidnet_tpu_torch.solver import quasi_newton as qn
    fa_t, step_t = port_inputs(fa, step)
    run = qn.make_solver(algorithm=algorithm, prefix_stages=prefix,
                         tolerance=tolerance, **kw, **extra)
    return run(fa_t, step_t, None if y0 is None else _t(y0))


def _jax_solve(algorithm, fa, step, kw, prefix, y0=None, tolerance=None):
    from rapidnet_tpu.solver import quasi_newton as jqn
    return jax.jit(jqn.make_solver(algorithm=algorithm, prefix_stages=prefix,
                                   tolerance=tolerance, **kw))(fa, step, y0)


@pytest.mark.parametrize("case", ["nominal", "stressed"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_solver_tracks_jax(algorithm, case):
    eng, fa, step, kw = _qn_problem(
        x0_scale=1.2 if case == "stressed" else None)
    prefix = eng.factor_step().prefix_stages
    ref = _jax_solve(algorithm, fa, step, kw, prefix)
    got = _solve(algorithm, fa, step, kw, prefix)
    assert int(got["iterations"]) == TRACK
    _trace_parity(got, ref, TRACK)
    assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)
    assert_close(got["u"], ref["u"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", ["nominal", "stressed"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_solver_tracks_jax_across_the_lbfgs_wrap(algorithm, case,
                                                 monkeypatch):
    """Over BS + 3 iterations the ring wraps (col = 1 + col % size, with
    the buffer full; the two-loop then visits the zero column and the
    columns below col), and the bounds of test_solver_tracks_jax still
    hold."""
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    columns = []
    update = qn.lbfgs_update_and_direction

    def recorded(*args, **kw):
        lb, d = update(*args, **kw)
        columns.append((lb["col"], lb["mem"]))
        return lb, d

    monkeypatch.setattr(qn, "lbfgs_update_and_direction", recorded)
    n = BS + 3
    eng, fa, step, kw = _qn_problem(
        max_iterations=n, x0_scale=1.2 if case == "stressed" else None)
    prefix = eng.factor_step().prefix_stages
    ref = _jax_solve(algorithm, fa, step, kw, prefix)
    got = _solve(algorithm, fa, step, kw, prefix)
    assert (1, BS) in columns, columns
    assert int(got["iterations"]) == n
    _trace_parity(got, ref, n)
    assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)
    assert_close(got["u"], ref["u"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_solver_counts_trials_and_rejected_pairs(algorithm, monkeypatch):
    """``line_search_trials`` is the number of trials the searches ran
    (one per cumulative application), and ``lbfgs_skips`` the number of
    curvature pairs the buffer rejected."""
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    calls, rejected = [], []
    apply, update = qn._ls_apply, qn.lbfgs_update_and_direction

    def counted(*args, **kw):
        calls.append(1)
        return apply(*args, **kw)

    def judged(fa, lb, *args, **kw):
        new, d = update(fa, lb, *args, **kw)
        rejected.append(new["skips"] - lb["skips"])
        return new, d

    monkeypatch.setattr(qn, "_ls_apply", counted)
    monkeypatch.setattr(qn, "lbfgs_update_and_direction", judged)
    eng, fa, step, kw = _qn_problem(max_iterations=12)
    out = _solve(algorithm, fa, step, kw, eng.factor_step().prefix_stages)
    assert len(calls) > 11
    assert int(out["line_search_trials"]) == len(calls)
    assert len(rejected) == 11 and set(rejected) <= {0, 1}
    assert int(out["lbfgs_skips"]) == sum(rejected)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_solver_converged_quality(algorithm):
    """At 120 iterations both drive the residual to comparable levels
    (the JAX package's own check between its two implementations,
    tests/test_pallas_qn.py:141-166), and the control is feasible."""
    iters = 120
    eng, fa, step, kw = _qn_problem(max_iterations=iters)
    prefix = eng.factor_step().prefix_stages
    ref = _jax_solve(algorithm, fa, step, kw, prefix)
    got = _solve(algorithm, fa, step, kw, prefix)
    tail_p = np.median(np.abs(got["primal_infeasibility"].numpy())[-20:])
    tail_x = np.median(np.abs(np.asarray(ref["primal_infeasibility"]))[-20:])
    assert tail_p < 10 * max(tail_x, 1e-6), (tail_p, tail_x)
    u0 = got["control"].numpy()
    assert (u0 >= np.asarray(fa["umin_phys"]) - 1e-5).all()
    assert (u0 <= np.asarray(fa["umax_phys"]) + 1e-5).all()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_solver_warm_start_matches_jax(algorithm):
    """A synthetic (non-plateau) warm start, as tests/test_pallas_qn.py:
    169-208: the L-BFGS buffer starts fresh on both sides."""
    eng, fa, step, kw = _qn_problem()
    prefix = eng.factor_step().prefix_stages
    N, ns, nx = np.asarray(fa["d1"]).shape
    nu = np.asarray(fa["g"]).shape[-1]
    rng = np.random.default_rng(3)
    y0 = {"xi": (0.05 * rng.standard_normal((N, ns, 2 * nx))
                 ).astype(np.float32),
          "psi": (0.05 * rng.standard_normal((N, ns, nu))
                  ).astype(np.float32)}
    ref = _jax_solve(algorithm, fa, step, kw, prefix, y0=y0)
    got = _solve(algorithm, fa, step, kw, prefix, y0=y0)
    _trace_parity(got, ref, TRACK)
    assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_solver_tolerance_exit_matches_jax(algorithm):
    """With a tolerance both stop at the same iteration, on the true
    residual magnitude, and zero-pad all three traces."""
    eng, fa, step, kw = _qn_problem(max_iterations=20)
    prefix = eng.factor_step().prefix_stages
    full = _solve(algorithm, fa, step, kw, prefix)
    peak = float(full["primal_infeasibility"].abs().max())
    for mult in (1e4, 1e3, 100.0, 10.0, 3.0, 1.0, 0.3):
        got = _solve(algorithm, fa, step, kw, prefix, tolerance=peak * mult)
        if 1 < int(got["iterations"]) < kw["max_iterations"]:
            break
    else:
        pytest.fail("no tolerance gave a mid-budget exit")
    ref = _jax_solve(algorithm, fa, step, kw, prefix, tolerance=peak * mult)
    it = int(ref["iterations"])
    assert int(got["iterations"]) == it
    assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)
    for key in ("primal_infeasibility", "value_fbe", "tau"):
        assert (got[key][it:] == 0).all(), key


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_magnitude_trace_predicts_the_tolerance_exit(algorithm):
    """``trace_magnitude``: the residual magnitude a tolerance tests,
    per iteration.  A tolerance stops the solve at the first iteration
    whose magnitude is at most it, and the trace is zero past the
    exit."""
    eng, fa, step, kw = _qn_problem(max_iterations=20)
    prefix = eng.factor_step().prefix_stages
    full = _solve(algorithm, fa, step, kw, prefix, trace_magnitude=True)
    mags = full["residual_magnitude"].numpy()
    assert mags.shape == (20,) and (mags > 0).all()
    for tol in np.quantile(mags, [0.2, 0.5, 0.8]):
        got = _solve(algorithm, fa, step, kw, prefix, tolerance=float(tol),
                     trace_magnitude=True)
        it = int(np.argmax(mags <= tol)) + 1
        assert int(got["iterations"]) == it
        np.testing.assert_array_equal(got["residual_magnitude"][:it],
                                      mags[:it])
        assert not got["residual_magnitude"][it:].any()
