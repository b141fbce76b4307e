"""The batched FBE/NAMA slice: the port's batched QN solves, their kernel
wrapper and the batched controller's FBE/NAMA branch against JAX's.

The problem is the QN tests' small one (tests/_torch_parity.SMALL:
nx=4, nu=7, nd=3, ne=2, N=6, branching [2, 2], seed 11) at a step size
of 1e-3, where float32 solves of it track each other
(tests/test_torch_qn_solve.py says why), with an L-BFGS buffer of 5 and
B = 3 instances whose states are x0 * (1 + 0.02 N(0, 1)) (numpy seed 7,
as bench.py:133-136).  Inputs are made from seeds with numpy and reach
the port through ``rapidnet_tpu_torch.convert``.
Tolerances, with their sources:

* against JAX's ``make_solver`` per instance, and against the
  interpret-mode Pallas batch: the JAX package's bounds between two
  implementations of this solve (tests/test_pallas_qn.py:59-89), over
  the first TRACK iterations tau rtol 1e-4 / atol 1e-6, the FBE value
  rtol 2e-3 / atol 2e-4 * max(|value|, 1), the infeasibility rtol 2e-3
  / atol 1e-4; control rtol 1e-3 / atol 1e-4, u rtol 1e-3 / atol 1e-3
  (tests/test_torch_quasi_newton.py, tests/test_torch_qn_solve.py);
* against JAX's ``make_solver_batch`` (a vmap whose line searches run
  in masked lockstep): JAX's own bound between its batch and its single
  solves, control rtol 1e-2 / atol 2e-3 (tests/test_batch.py:233-235);
* the port's batch against its own single solves, and its shared form
  against its stacked form: the same arithmetic, compared exactly;
* the batched controller against JAX's Pallas batch at 6 iterations:
  control rtol 1e-3 / atol 1e-3 * max(|u|, 1) (tests/test_batch.py:
  349-370).

The Pallas kernel sums in other orders than the XLA path: on
tests/test_batch.py's own problem (N = 8, seed 3) its infeasibility
trace parts from the XLA path's by 2.8e-3 relative at the fourth
iteration, where the port keeps within 1e-6 of the XLA path, so the
small problem of tests/test_torch_qn_solve.py is used here.

The JAX sweeps run their stage recursions as a sequential scan, the
branch the port mirrors (tests/test_torch_quasi_newton.py says why).
The batched CUDA kernel itself is held to the single-solve kernel and
to this plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import SMALL, assert_close, to_numpy

torch.set_num_threads(2)

FBE, NAMA = "globalFbeAlgorithm", "namaAlgorithm"
ALGORITHMS = [FBE, NAMA]
B = 3
BS = 5              # lbfgsBufferSize of the JAX tests and bench.py
TRACK = 4           # tests/test_pallas_qn.py:28-30
PALLAS_ITERS = 6    # tests/test_batch.py:330-346


@pytest.fixture(autouse=True)
def _jax_sequential_sweeps(monkeypatch):
    from rapidnet_tpu.solver import solve_step as jss
    monkeypatch.setattr(jss, "SCAN_MIN_NS", 1)


def _models(pkg):
    import importlib
    return {k: importlib.import_module(f"{pkg}.model.{k}")
            for k in ("network", "scenario_tree", "forecaster", "config")}


def _build(pkg, max_iterations=TRACK, step_size=1e-3):
    """network, tree, forecaster, config from either package's
    generators (the SMALL problem)."""
    m, p = _models(pkg), SMALL
    net = m["network"].synthetic_network(nx=p["nx"], nu=p["nu"],
                                         nd=p["nd"], ne=p["ne"],
                                         seed=p["seed"])
    tree = m["scenario_tree"].generate_tree(
        N=p["N"], branching=list(p["branching"]), nd=p["nd"], nu=p["nu"],
        seed=p["seed"])
    fc = m["forecaster"].synthetic_forecaster(N=p["N"], nd=p["nd"],
                                              nu=p["nu"], sim_horizon=4,
                                              seed=p["seed"])
    cfg = m["config"].synthetic_config(net, tree,
                                       max_iterations=max_iterations,
                                       step_size=step_size)
    return net, tree, fc, cfg


def _states(cfg):
    rng = np.random.default_rng(7)
    return (cfg.current_x * (1.0 + 0.02 * rng.standard_normal(
        (B, cfg.current_x.size)))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _problem(step_size=1e-3):
    """The JAX side's factor arrays, per-instance steps and shared
    (base, inst), all as numpy arrays, and the solver settings."""
    from rapidnet_tpu.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu.solver.controller import _factor_arrays, _step_arrays

    net, tree, fc, cfg = _build("rapidnet_tpu", step_size=step_size)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    x0s = _states(cfg)
    prev_us = np.tile(cfg.prev_u, (B, 1)).astype(np.float32)
    prev_ds = np.tile(cfg.prev_demand, (B, 1)).astype(np.float32)
    steps = [to_numpy(_step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, x0s[b], prev_us[b],
        prev_ds[b]))) for b in range(B)]
    base, inst = eng.prepare_step_shared(
        fc.nominal_demand, fc.nominal_prices, x0s, prev_us, prev_ds)
    kw = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety,
              xs_upper=float(XS_UPPER), lbfgs_buffer_size=BS)
    return dict(fa=to_numpy(_factor_arrays(eng)), steps=steps, base=base,
                inst=inst, kw=kw, prefix=eng.factor_step().prefix_stages)


@pytest.fixture
def problem():
    return _problem()


def _port_args(problem, form):
    """The port's (fa, solver arguments) for the stacked or the shared
    form of the batch."""
    from rapidnet_tpu_torch.convert import (factor_tensors,
                                            shared_step_tensors,
                                            stacked_step_tensors)
    fa = factor_tensors(problem["fa"], "cpu")
    if form == "stacked":
        return fa, (stacked_step_tensors(problem["steps"], "cpu"),)
    return fa, shared_step_tensors(problem["base"], problem["inst"], "cpu")


def _port_plain(problem, form, algorithm, max_iterations=TRACK, **extra):
    from rapidnet_tpu_torch.solver import quasi_newton as qn
    make = (qn.make_solver_batch if form == "stacked"
            else qn.make_solver_batch_shared)
    fa, args = _port_args(problem, form)
    run = make(algorithm=algorithm, prefix_stages=problem["prefix"],
               max_iterations=max_iterations, **problem["kw"], **extra)
    return run(fa, *args)


@functools.lru_cache(maxsize=None)
def _jax_solver(problem_key, algorithm, max_iterations, tolerance):
    """JAX's jitted make_solver for _problem(*problem_key), compiled once
    per setting."""
    from rapidnet_tpu.solver import quasi_newton as jqn
    problem = _problem(*problem_key)
    return jax.jit(jqn.make_solver(algorithm=algorithm,
                                   prefix_stages=problem["prefix"],
                                   max_iterations=max_iterations,
                                   tolerance=tolerance, **problem["kw"]))


def _jax_single(problem, algorithm, b, max_iterations=TRACK, tolerance=None,
                y0=None, problem_key=()):
    run = _jax_solver(problem_key, algorithm, max_iterations, tolerance)
    return run(problem["fa"], problem["steps"][b], y0)


def _jax_stacked(problem):
    return {k: jnp.stack([s[k] for s in problem["steps"]])
            for k in problem["steps"][0]}


def _instance(out, b):
    """Instance b of a batched output dict (nested dicts too)."""
    return {k: _instance(v, b) if isinstance(v, dict) else v[b]
            for k, v in out.items()}


def _trace_parity(got, ref, n):
    vscale = max(float(np.abs(np.asarray(ref["value_fbe"])).max()), 1.0)
    assert_close(got["tau"][:n], np.asarray(ref["tau"])[:n],
                 rtol=1e-4, atol=1e-6)
    assert_close(got["value_fbe"][:n], np.asarray(ref["value_fbe"])[:n],
                 rtol=2e-3, atol=2e-4 * vscale)
    assert_close(got["primal_infeasibility"][:n],
                 np.asarray(ref["primal_infeasibility"])[:n],
                 rtol=2e-3, atol=1e-4)


def _solution_parity(got, ref):
    assert_close(got["control"], ref["control"], rtol=1e-3, atol=1e-4)
    assert_close(got["u"], ref["u"], rtol=1e-3, atol=1e-3)


OUT_KEYS = {"control", "x", "u", "v", "y", "primal_infeasibility",
            "value_fbe", "tau", "iterations", "line_search_trials",
            "lbfgs_skips"}


@pytest.mark.parametrize("form", ["stacked", "shared"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_plain_batch_tracks_jax_per_instance(problem, algorithm, form):
    """(a) make_solver_batch / _shared against JAX's make_solver on each
    instance's step."""
    got = _port_plain(problem, form, algorithm)
    assert set(got) == OUT_KEYS
    assert got["control"].shape == (B, 7)
    assert got["tau"].shape == (B, TRACK)
    for k in ("iterations", "line_search_trials", "lbfgs_skips"):
        assert got[k].shape == (B,), k
    assert got["iterations"].tolist() == [TRACK] * B
    for b in range(B):
        ref = _jax_single(problem, algorithm, b)
        _trace_parity(_instance(got, b), ref, TRACK)
        _solution_parity(_instance(got, b), ref)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_plain_batch_within_jax_batch_bound(problem, algorithm):
    """(b) against JAX's make_solver_batch (vmap), within JAX's own bound
    between its batch and its single solves."""
    from rapidnet_tpu.solver import quasi_newton as jqn
    n = 15              # tests/test_batch.py:222-235
    ref = jax.jit(jqn.make_solver_batch(
        algorithm=algorithm, prefix_stages=problem["prefix"],
        max_iterations=n, **problem["kw"]))(problem["fa"],
                                            _jax_stacked(problem))
    got = _port_plain(problem, "stacked", algorithm, max_iterations=n)
    assert_close(got["control"], ref["control"], rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("form", ["stacked", "shared"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batch_wrapper_tracks_pallas_interpret(problem, algorithm, form):
    """(c) qn_solve_batch on the CPU against the interpret-mode Pallas
    batch (make_qn_pallas_batch, _batch_shared); the CPU never
    launches."""
    from rapidnet_tpu.ops import pallas_qn
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kw = dict(problem["kw"], algorithm=algorithm,
              max_iterations=PALLAS_ITERS)
    if form == "stacked":
        ref = pallas_qn.make_qn_pallas_batch(
            problem["fa"], interpret=True, **kw)(_jax_stacked(problem))
        make = Q.make_qn_kernel_batch
    else:
        ref = pallas_qn.make_qn_pallas_batch_shared(
            problem["fa"], interpret=True, **kw)(problem["base"],
                                                 problem["inst"])
        make = Q.make_qn_kernel_batch_shared
    fa, args = _port_args(problem, form)
    n0 = Q.qn_solve_batch.launches
    got = make(fa, prefix_stages=problem["prefix"], **kw)(*args)
    assert Q.qn_solve_batch.launches == n0
    assert "v" not in got
    assert got["iterations"].tolist() == [PALLAS_ITERS] * B
    for b in range(B):
        _trace_parity(_instance(got, b), _instance(ref, b), TRACK)
        _solution_parity(_instance(got, b), _instance(ref, b))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_plain_batch_is_its_single_solves(problem, algorithm):
    """(d) The shared form equals the stacked form on the steps it
    assembles, and each instance equals the single plain solve of its
    step, exactly."""
    from rapidnet_tpu_torch.solver import quasi_newton as qn
    from rapidnet_tpu_torch.solver.apg import expand_shared_step

    fa, (base, inst) = _port_args(problem, "shared")
    kw = dict(problem["kw"], algorithm=algorithm,
              prefix_stages=problem["prefix"], max_iterations=TRACK + 2)
    shared = qn.make_solver_batch_shared(**kw)(fa, base, inst)
    steps = expand_shared_step(base, **inst)
    assert steps["alpha_price"].stride(0) == 0
    stacked = qn.make_solver_batch(**kw)(
        fa, {k: v.contiguous() for k, v in steps.items()})
    single = qn.make_solver(**kw)
    for b in range(B):
        one = single(fa, {k: v[b] for k, v in steps.items()})
        for out in (shared, stacked):
            got = _instance(out, b)
            for k in OUT_KEYS - {"y"}:
                assert torch.equal(got[k], one[k]), k
            for k in ("xi", "psi"):
                assert torch.equal(got["y"][k], one["y"][k]), k


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tolerance_exits_per_instance(problem, algorithm):
    """(e) Under a tolerance each instance stops at JAX's iteration for it
    and its traces are zero past its exit.  The tolerance: of those that
    stop instance 0 past its first iteration (by its residual
    magnitudes), the first that stops every instance mid-budget."""
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    n = 20
    mags = _port_plain(problem, "stacked", algorithm, max_iterations=n,
                       trace_magnitude=True)["residual_magnitude"].numpy()
    for tol, _, _ in qn.exit_tolerances(mags[0], n - 1):
        got = _port_plain(problem, "stacked", algorithm, max_iterations=n,
                          tolerance=tol)
        its = got["iterations"].tolist()
        if all(1 < it < n for it in its):
            break
    else:
        pytest.fail("no tolerance gave mid-budget exits")
    for b, it in enumerate(its):
        ref = _jax_single(problem, algorithm, b, max_iterations=n,
                          tolerance=tol)
        assert int(ref["iterations"]) == it
        assert_close(got["control"][b], ref["control"], rtol=1e-3,
                     atol=1e-4)
        for key in ("primal_infeasibility", "value_fbe", "tau"):
            assert (got[key][b, it:] == 0).all(), key


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_warm_start_with_a_leading_batch(algorithm):
    """(e) A warm start {"xi", "psi"} with a leading B (the JAX tests'
    synthetic one, tests/test_pallas_qn.py:169-208) against JAX's warm
    single solves, at the JAX tests' step size of 1e-4, as
    tests/test_torch_qn_solve.py checks the warm start; the batched
    wrapper warm-starts from its own output."""
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver import quasi_newton as qn

    key = (1e-4,)
    problem = _problem(*key)
    N, ns, nx = problem["fa"]["d1"].shape
    rng = np.random.default_rng(3)
    y0 = {"xi": (0.05 * rng.standard_normal((B, N, ns, 2 * nx))
                 ).astype(np.float32),
          "psi": (0.05 * rng.standard_normal((B, N, ns, 7))
                  ).astype(np.float32)}
    fa, (steps,) = _port_args(problem, "stacked")
    kw = dict(problem["kw"], algorithm=algorithm,
              prefix_stages=problem["prefix"], max_iterations=TRACK)
    got = qn.make_solver_batch(**kw)(
        fa, steps, {k: torch.tensor(v) for k, v in y0.items()})
    for b in range(B):
        ref = _jax_single(problem, algorithm, b, problem_key=key,
                          y0={k: v[b] for k, v in y0.items()})
        _trace_parity(_instance(got, b), ref, TRACK)
        assert_close(got["control"][b], ref["control"], rtol=1e-3,
                     atol=1e-4)

    kernel = Q.make_qn_kernel_batch(fa, **kw)
    cold = kernel(steps)
    assert cold["y"]["xi"].shape == (B, N, ns, 2 * nx)
    again = kernel(steps, cold["y"])
    assert torch.isfinite(again["u"]).all()
    assert not torch.equal(again["u"], cold["u"])


def _controllers(algorithm, **kw):
    """The JAX (backend='pallas', interpret mode on the CPU) and the port
    (device='cpu') batched controllers, FBE or NAMA, on the same problem
    and states."""
    from rapidnet_tpu.solver.batch import BatchedSmpcController as JB
    from rapidnet_tpu_torch import BatchedSmpcController as TB

    out = []
    for pkg, cls, extra in (("rapidnet_tpu", JB, dict(backend="pallas")),
                            ("rapidnet_tpu_torch", TB,
                             dict(device="cpu", **kw))):
        net, tree, fc, cfg = _build(pkg, max_iterations=PALLAS_ITERS)
        cfg.algorithm = algorithm
        out.append(cls(cfg, net, tree, fc, _states(cfg), **extra))
    return out


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batched_controller_matches_jax_pallas(algorithm):
    """(f) One batched control step of FBE or NAMA against JAX's
    BatchedSmpcController(backend='pallas')."""
    jctrl, tctrl = _controllers(algorithm)
    ref = jctrl.control_action(0)
    got = tctrl.control_action(0)
    assert got.shape == (B, 7)
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=1e-3 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batched_controller_backends_agree_on_cpu(algorithm):
    """(f) 'auto' on the CPU takes the batched kernel wrapper's plain
    version, which is the 'torch' backend's solve: the same numbers, in
    a 2-step loop with a warm start."""
    from rapidnet_tpu_torch import BatchedSmpcController

    logs = []
    for backend in ("auto", "torch"):
        net, tree, fc, cfg = _build("rapidnet_tpu_torch")
        cfg.algorithm = algorithm
        x0s = np.tile(cfg.current_x, (B, 1))
        ctrl = BatchedSmpcController(cfg, net, tree, fc, x0s,
                                     backend=backend, warm_start=True,
                                     device="cpu")
        logs.append(ctrl.closed_loop(2))
        assert ctrl._y_carry["xi"].shape[0] == B
    np.testing.assert_array_equal(logs[0]["controls"], logs[1]["controls"])
    assert np.isfinite(logs[0]["controls"]).all()


def test_batch_wrapper_rejects_inputs_the_kernel_does_not_take(problem):
    """(g) uhat, e and alpha_price: batch stride 0 or one instance after
    another, nothing else; the per-instance inputs contiguous; shapes,
    dtypes and devices."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    fa, (steps,) = _port_args(problem, "stacked")
    kc = Q.kernel_constants(fa, prefix_stages=problem["prefix"])
    kw = dict(problem["kw"], algorithm=FBE, max_iterations=TRACK)

    def wide(k):
        return torch.stack([steps[k]] * 2, dim=1).reshape(
            B * 2, *steps[k].shape[1:])[::2]

    bad = {
        "batch stride": [dict(steps, **{k: wide(k)})
                         for k in ("uhat", "e", "alpha_price")],
        # beta is per instance: no batch stride 0
        "not contiguous": [dict(steps, beta=steps["beta"][:1].expand(
            B, *steps["beta"].shape[1:]))],
        "an instance is not contiguous": [dict(
            steps, alpha_price=steps["alpha_price"].transpose(1, 2)
            .contiguous().transpose(1, 2))],
        "shape": [dict(steps, x0=steps["x0"][:, :2]),
                  dict(steps, alpha_price=steps["alpha_price"][:, :2])],
        "dtype": [dict(steps, prev_u=steps["prev_u"].double())],
        "meta": [{k: v.to("meta") for k, v in steps.items()}],
    }
    for match, cases in bad.items():
        for b in cases:
            with pytest.raises(ValueError, match=match):
                Q.qn_solve_batch(kc, b, None, **kw)
    with pytest.raises(ValueError, match="shape"):
        Q.qn_solve_batch(kc, steps, {"xi": torch.zeros(B, 1),
                                     "psi": torch.zeros(B, 1)}, **kw)
    with pytest.raises(ValueError, match="unknown quasi-Newton"):
        Q.qn_solve_batch(kc, steps, None, **dict(kw, algorithm="apg"))
    with pytest.raises(ValueError, match="lbfgs_buffer_size"):
        Q.qn_solve_batch(kc, steps, None, **dict(kw, lbfgs_buffer_size=0))
    if not torch.cuda.is_available():
        # a CUDA request without a GPU raises; nothing runs on the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            Q.qn_solve_batch(kc, {k: v.to("cuda") for k, v in
                                  steps.items()}, None, **kw)
