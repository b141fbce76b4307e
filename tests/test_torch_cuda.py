"""The CUDA kernels on the card: the whole-solve kernels, APG single and
batched, FBE and NAMA single and batched (float32 and bf16 history), the
streaming APG kernels (two kernels an iteration, or the fused one), the
streaming FBE/NAMA sweeps and history passes (the bf16 dots' vector and
one-value bodies), and the partial parent block of the sharded sweeps
(bit for bit against a float32 sum in the index lists' order).

These tests need a CUDA GPU and skip without one.  They import neither
jax nor the JAX package, because the card's machine has no JAX; since
tests/conftest.py imports jax, run them there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the kernel sums in another order than PyTorch's float32
products; over 25 iterations that stays within 1e-4 of the largest
magnitude (chip_smoke.py holds the 500-iteration solve at Barcelona
scale to 1e-3, the JAX package's bound between two implementations).
An instance of a batched kernel call runs the same code on the same
inputs as a single-solve call, with its own reductions in the same
order, so the two are compared bit for bit.

FBE and NAMA: the line search branches on value comparisons, so the
kernel and the plain version part after a few iterations
(tests/test_pallas_qn.py:1-15).  Over the first QN_TRACK iterations
they are held to the JAX package's bounds between two implementations
of this solve (tests/test_pallas_qn.py:59-89): tau rtol 1e-4 / atol
1e-6, the FBE value rtol 2e-3 / atol 2e-4 * max(|value|, 1), the
infeasibility rtol 2e-3 / atol 1e-4, control rtol 1e-3 / atol 1e-4 and
u rtol 1e-3 / atol 1e-3; with the penalties active (tanks above their
box) u and the control to atol 2e-3 * max|plain|, the JAX package's
bound on its reference problem (tests/test_pallas_qn.py:131-138).  The
same bounds hold over QN_WRAP iterations with a buffer of QN_WRAP_BS,
across the wrap of the L-BFGS ring, as they do between the plain
version and the JAX package's (tests/test_torch_quasi_newton.py).  The
step size is 1e-3, where float32 solves of this problem track each
other (tests/test_torch_qn_solve.py says why not 1e-4); the tolerance
exit runs at 3e-4, where the residual magnitude crosses a tolerance
within the iterations over which the two track.  The kernel's
reductions run in a fixed order, so two calls are compared bit for
bit.
"""

import numpy as np
import pytest
import torch

# tanks at 30% of their maximum (the generators' state), and above the
# box, which makes the state penalties and the global shrinks active
CASES = {"nominal": dict(step_size=1e-4, x0_scale=None),
         "stressed": dict(step_size=1e-3, x0_scale=1.2)}
ITERS = 25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _problem(device, step_size, x0_scale, max_iterations=ITERS):
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            step_arrays, step_tensors)
    from rapidnet_tpu_torch.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import apg_solve as K

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=11)
    tree = generate_tree(N=6, branching=[2, 2], nd=3, nu=7, seed=11)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=11)
    cfg = synthetic_config(net, tree, max_iterations=max_iterations,
                           step_size=step_size)
    if x0_scale is not None:
        cfg.current_x = (x0_scale * net.xmax).astype(np.float32)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_tensors(factor_arrays(eng), device)
    step = step_tensors(step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand)), device)
    kc = K.kernel_constants(fa, prefix_stages=eng.factor_step()
                            .prefix_stages, max_iterations=max_iterations)
    kw = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety,
              xs_upper=float(XS_UPPER), max_iterations=max_iterations)
    return kc, step, kw


def _close(got, ref):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * max(np.abs(ref).max(), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_gpu(cuda_device, case):
    from rapidnet_tpu_torch.ops import apg_solve as K

    kc, step, kw = _problem(cuda_device, **CASES[case])
    n0 = K.apg_solve.launches
    got = K.apg_solve(kc, step, None, **kw)
    assert K.apg_solve.launches == n0 + 1
    ref = K.apg_solve_plain(kc, step, None, **kw)
    assert int(got["iterations"]) == ITERS
    for k in ("control", "u", "x", "primal_infeasibility"):
        _close(got[k], ref[k])
    for k in ("xi", "psi"):
        _close(got["y"][k], ref["y"][k])


@pytest.mark.cuda
def test_kernel_tolerance_exit_matches_plain(cuda_device):
    """The device-side done flag stops at the plain version's iteration
    and leaves the trace zero past it."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    kc, step, kw = _problem(cuda_device, step_size=1e-3, x0_scale=None)
    for tol in np.geomspace(1e5, 1e-3, 33):
        ref = K.apg_solve_plain(kc, step, None, tolerance=float(tol), **kw)
        if 1 < int(ref["iterations"]) < ITERS:
            break
    else:
        pytest.fail("no tolerance gave a mid-budget exit")
    got = K.apg_solve(kc, step, None, tolerance=float(tol), **kw)
    it = int(ref["iterations"])
    assert int(got["iterations"]) == it
    assert bool((got["primal_infeasibility"][it:] == 0).all())
    _close(got["control"], ref["control"])


@pytest.mark.cuda
def test_controller_launches_the_kernel(cuda_device):
    """SmpcController(device='cuda') with backend 'auto' solves through
    the kernel, once per control step, and agrees with 'torch'."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import apg_solve as K

    def run(backend):
        net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
        tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=7, seed=7)
        fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=3, seed=7)
        cfg = synthetic_config(net, tree, max_iterations=40,
                               step_size=1e-3)
        return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              backend=backend).closed_loop(3)

    n0 = K.apg_solve.launches
    got = run("auto")
    assert K.apg_solve.launches == n0 + 3
    ref = run("torch")
    for t in range(3):
        _close(torch.tensor(got[f"control{t}"]),
               torch.tensor(ref[f"control{t}"]))


def _batch(device, batch=3, step_size=1e-4, max_iterations=ITERS):
    """The small problem of ``_problem`` with ``batch`` states around the
    nominal one, assembled on the device from the shared base."""
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            shared_step_tensors)
    from rapidnet_tpu_torch.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.solver.apg import expand_shared_step

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=11)
    tree = generate_tree(N=6, branching=[2, 2], nd=3, nu=7, seed=11)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=11)
    cfg = synthetic_config(net, tree, max_iterations=max_iterations,
                           step_size=step_size)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    rng = np.random.default_rng(7)
    x0s = (cfg.current_x * (1.0 + 0.02 * rng.standard_normal(
        (batch, cfg.current_x.size)))).astype(np.float32)
    base, inst = shared_step_tensors(*eng.prepare_step_shared(
        fc.nominal_demand, fc.nominal_prices, x0s,
        np.tile(cfg.prev_u, (batch, 1)), np.tile(cfg.prev_demand,
                                                 (batch, 1))), device)
    fa = factor_tensors(factor_arrays(eng), device)
    kc = K.kernel_constants(fa, prefix_stages=eng.factor_step()
                            .prefix_stages, max_iterations=max_iterations)
    kw = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety,
              xs_upper=float(XS_UPPER), max_iterations=max_iterations)
    return kc, expand_shared_step(base, **inst), kw


def _instance(batched, b):
    """Instance b of a batched step or output dict (nested dicts too)."""
    return {k: _instance(v, b) if isinstance(v, dict) else v[b].contiguous()
            for k, v in batched.items()}


def _assert_equal(got, ref):
    for k in ("control", "u", "x", "primal_infeasibility", "iterations"):
        assert torch.equal(got[k], ref[k]), k
    for k in ("xi", "psi"):
        assert torch.equal(got["y"][k], ref["y"][k]), k


@pytest.mark.cuda
def test_batched_kernel_matches_single_kernel(cuda_device):
    """Each instance of a batched call (uhat and e shared with batch
    stride 0) equals the single-solve kernel on that instance's step,
    bit for bit; and the batch stays within bound of its plain version."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    kc, steps, kw = _batch(cuda_device)
    assert steps["uhat"].stride(0) == 0
    n0 = K.apg_solve_batch.launches
    got = K.apg_solve_batch(kc, steps, None, **kw)
    assert K.apg_solve_batch.launches == n0 + 1
    for b in range(steps["beta"].shape[0]):
        one = K.apg_solve(kc, _instance(steps, b), None, **kw)
        _assert_equal(_instance(got, b), one)
    ref = K.apg_solve_plain(kc, steps, None, **kw)
    for k in ("control", "u", "x", "primal_infeasibility"):
        _close(got[k], ref[k])


@pytest.mark.cuda
def test_batch_of_one_matches_single_solve(cuda_device):
    """The batched entry at B = 1, cold and warm, is the single solve."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    kc, steps, kw = _batch(cuda_device, batch=1, step_size=1e-3,
                           max_iterations=ITERS)
    one = K.apg_solve(kc, _instance(steps, 0), None, **kw)
    got = K.apg_solve_batch(kc, steps, None, **kw)
    _assert_equal(_instance(got, 0), one)
    warm1 = K.apg_solve(kc, _instance(steps, 0), one["y"], **kw)
    warmb = K.apg_solve_batch(kc, steps, got["y"], **kw)
    assert torch.equal(warmb["u"][0], warm1["u"])


@pytest.mark.cuda
def test_batched_kernel_tolerance_exits_match_plain(cuda_device):
    """Under a tolerance each instance stops at its plain version's
    iteration and its trace is zero past it."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    kc, steps, kw = _batch(cuda_device, batch=4, step_size=1e-3)
    for tol in np.geomspace(1e5, 1e-3, 33):
        ref = K.apg_solve_plain(kc, steps, None,
                                      tolerance=float(tol), **kw)
        its = ref["iterations"].tolist()
        if all(1 < it < ITERS for it in its):
            break
    else:
        pytest.fail("no tolerance gave mid-budget exits")
    got = K.apg_solve_batch(kc, steps, None, tolerance=float(tol), **kw)
    assert got["iterations"].tolist() == its
    for b, it in enumerate(its):
        assert bool((got["primal_infeasibility"][b, it:] == 0).all())
    _close(got["control"], ref["control"])


@pytest.mark.cuda
def test_batched_controller_launches_the_kernel(cuda_device):
    """BatchedSmpcController(device='cuda') with backend 'auto' solves
    each step's batch through one kernel call and agrees with 'torch'."""
    from rapidnet_tpu_torch import BatchedSmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import apg_solve as K

    def run(backend):
        net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
        tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=7, seed=7)
        fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=3, seed=7)
        cfg = synthetic_config(net, tree, max_iterations=40,
                               step_size=1e-3)
        x0s = cfg.current_x * np.linspace(0.9, 1.1, 3)[:, None]
        return BatchedSmpcController(cfg, net, tree, fc, x0s,
                                     backend=backend).closed_loop(3)

    n0 = K.apg_solve_batch.launches
    got = run("auto")
    assert K.apg_solve_batch.launches == n0 + 3
    ref = run("torch")
    _close(torch.tensor(got["controls"]), torch.tensor(ref["controls"]))


QN_ALGORITHMS = ["globalFbeAlgorithm", "namaAlgorithm"]
QN_TRACK = 4
QN_BS = 5           # the config's lbfgs_buffer_size
# Every iteration past the first offers a curvature pair, and the ring
# wraps (col = 1 + col % size; the two-loop then visits the zero column
# and the columns below it) at the (size + 1)-th accepted one.  From
# tanks at 1.2 times their maximum the two solves track over the first 8
# iterations at a buffer of 3, which hold 4 iterations past the wrap;
# from the nominal state they part sooner.
QN_WRAP_BS, QN_WRAP = 3, 8
# a kernel may stray from a float64 witness at most this many times as
# far as the plain float32 version does (chip_smoke.py's APG rule)
WITNESS_FACTOR = 4.0
QN_CASES = {"nominal": dict(step_size=1e-3, x0_scale=None),
            "stressed": dict(step_size=1e-3, x0_scale=1.2)}


def _qn_problem(device, step_size, x0_scale, max_iterations=QN_TRACK):
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, step, kw = _problem(device, step_size, x0_scale, max_iterations)
    return (Q.kernel_constants(kc["fa"], prefix_stages=kc["prefix_stages"]),
            step, dict(kw, lbfgs_buffer_size=QN_BS))


def _np(t):
    return t.detach().cpu().numpy()


def _qn_traces_close(got, ref, n=QN_TRACK):
    vscale = max(float(np.abs(_np(ref["value_fbe"])).max()), 1.0)
    for k, rtol, atol in (("tau", 1e-4, 1e-6),
                          ("value_fbe", 2e-3, 2e-4 * vscale),
                          ("primal_infeasibility", 2e-3, 1e-4)):
        np.testing.assert_allclose(_np(got[k])[:n], _np(ref[k])[:n],
                                   rtol=rtol, atol=atol, err_msg=k)


def _qn_close(got, ref, stressed, n=QN_TRACK):
    _qn_traces_close(got, ref, n)
    _qn_solution_close(got, ref, stressed)


def _qn_solution_close(got, ref, stressed):
    for k, rtol, atol in (("control", 1e-3, 1e-4), ("u", 1e-3, 1e-3)):
        if stressed:
            rtol, atol = 0.0, 2e-3 * max(float(np.abs(_np(ref[k])).max()),
                                         1.0)
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(QN_CASES))
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_kernel_matches_plain_on_gpu(cuda_device, algorithm, case):
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, step, kw = _qn_problem(cuda_device, **QN_CASES[case])
    n0 = Q.qn_solve.launches
    got = Q.qn_solve(kc, step, None, algorithm=algorithm, **kw)
    assert Q.qn_solve.launches == n0 + 1
    ref = Q.qn_solve_plain(kc, step, None, algorithm=algorithm, **kw)
    assert int(got["iterations"]) == QN_TRACK
    _qn_close(got, ref, stressed=case == "stressed")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_kernel_tracks_plain_across_the_lbfgs_wrap(cuda_device,
                                                      algorithm):
    """Over QN_WRAP iterations, in which the ring wraps, the kernel keeps
    to the plain version's solution, rejected pairs and count of
    line-search trials, and its traces keep to the JAX bounds: NAMA's
    of the plain float32 version's traces, FBE's of a float64 witness's
    (the plain version in float64), at the same bounds.

    FBE is so conditioned from this state that any two float32 orders
    part by about one bound at iteration 6: the witness itself moves by
    up to 0.775 bounds when the step's inputs are perturbed by 1e-7
    (float32's rounding), and no one sum of the plain version taken to
    float64 brings it closer to the witness than the kernel is (PERF.md
    §6, fault F4; tools/qn_sum_probe.py).  The exact trajectory is the
    reference there; the kernel must keep to it within the unchanged
    bounds."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, step, kw = _qn_problem(cuda_device, **QN_CASES["stressed"],
                               max_iterations=QN_WRAP)
    kw["lbfgs_buffer_size"] = QN_WRAP_BS
    got = Q.qn_solve(kc, step, None, algorithm=algorithm, **kw)
    ref = Q.qn_solve_plain(kc, step, None, algorithm=algorithm, **kw)
    assert int(got["iterations"]) == QN_WRAP
    skips = int(ref["lbfgs_skips"])
    assert QN_WRAP - 1 - skips > QN_WRAP_BS, "the ring did not wrap"
    assert int(got["lbfgs_skips"]) == skips
    traces_ref = ref
    if algorithm == "globalFbeAlgorithm":
        traces_ref = Q.qn_solve_plain(dict(kc, fa=_float64(kc["fa"])),
                                      _float64(step), None,
                                      algorithm=algorithm, **kw)
    _qn_traces_close(got, traces_ref, n=QN_WRAP)
    _qn_solution_close(got, ref, stressed=True)
    assert int(got["line_search_trials"]) == int(ref["line_search_trials"])


def _float64(d):
    """A dict of tensors (nested dicts too) with its floats in float64."""
    return {k: _float64(v) if isinstance(v, dict) else
            v.double() if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_kernel_across_the_wrap_against_a_float64_witness(cuda_device,
                                                             algorithm):
    """Over the wrap test's iterations (stressed state, buffer
    QN_WRAP_BS) the kernel keeps to a float64 witness (the plain version
    in float64): its traces within the JAX bounds of the witness's, as
    the plain float32 version's are required to be of each other, or no
    farther from the witness than WITNESS_FACTOR times the plain float32
    version is.  Over these iterations two float32 solves that sum in
    other orders part by rounding alone; the witness says which keeps to
    the exact trajectory.  The three infeasibility traces are printed."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, step, kw = _qn_problem(cuda_device, **QN_CASES["stressed"],
                               max_iterations=QN_WRAP)
    kw["lbfgs_buffer_size"] = QN_WRAP_BS
    got = Q.qn_solve(kc, step, None, algorithm=algorithm, **kw)
    ref = Q.qn_solve_plain(kc, step, None, algorithm=algorithm, **kw)
    wit = Q.qn_solve_plain(dict(kc, fa=_float64(kc["fa"])), _float64(step),
                           None, algorithm=algorithm, **kw)
    for name, out in (("kernel", got), ("plain float32", ref),
                      ("float64 witness", wit)):
        print(f"{algorithm} {name}: infeasibility "
              f"{_np(out['primal_infeasibility']).tolist()}")
    w = {k: _np(wit[k]) for k in ("tau", "value_fbe",
                                  "primal_infeasibility")}
    vscale = max(float(np.abs(w["value_fbe"]).max()), 1.0)
    for k, rtol, atol in (("tau", 1e-4, 1e-6),
                          ("value_fbe", 2e-3, 2e-4 * vscale),
                          ("primal_infeasibility", 2e-3, 1e-4)):
        d_k = np.abs(_np(got[k]) - w[k]) / (rtol * np.abs(w[k]) + atol)
        d_p = np.abs(_np(ref[k]) - w[k]) / (rtol * np.abs(w[k]) + atol)
        assert d_k.max() <= max(1.0, WITNESS_FACTOR * d_p.max()), k


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_kernel_is_deterministic(cuda_device, algorithm):
    """Two calls give the same bits."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, step, kw = _qn_problem(cuda_device, step_size=1e-3, x0_scale=None,
                               max_iterations=ITERS)
    runs = [Q.qn_solve(kc, step, None, algorithm=algorithm, **kw)
            for _ in range(2)]
    for k in ("u", "x", "primal_infeasibility", "value_fbe", "tau",
              "iterations", "line_search_trials", "lbfgs_skips"):
        assert torch.equal(runs[1][k], runs[0][k]), k
    for k in ("xi", "psi"):
        assert torch.equal(runs[1]["y"][k], runs[0]["y"][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_kernel_tolerance_exit_matches_plain(cuda_device, algorithm):
    """The device-side done flag stops at the plain version's iteration
    and leaves the three traces zero past it.  The tolerance comes from
    the plain version's residual magnitudes: of those that stop it past
    the first iteration, the one farthest from the edges of its exit
    (quasi_newton.exit_tolerances)."""
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver import quasi_newton as qn_mod

    n = 20
    kc, step, kw = _qn_problem(cuda_device, step_size=3e-4, x0_scale=None,
                               max_iterations=n)
    mags = qn_mod.make_solver(algorithm=algorithm,
                              prefix_stages=kc["prefix_stages"],
                              trace_magnitude=True, **kw)(kc["fa"], step)
    found = qn_mod.exit_tolerances(_np(mags["residual_magnitude"]), n - 1)
    assert found, "no tolerance stops the solve mid-budget"
    tol, it, _ = found[0]
    ref = Q.qn_solve_plain(kc, step, None, algorithm=algorithm,
                           tolerance=tol, **kw)
    got = Q.qn_solve(kc, step, None, algorithm=algorithm, tolerance=tol,
                     **kw)
    assert int(ref["iterations"]) == int(got["iterations"]) == it
    for k in ("primal_infeasibility", "value_fbe", "tau"):
        assert bool((got[k][it:] == 0).all()), k
    np.testing.assert_allclose(_np(got["control"]), _np(ref["control"]),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_controller_launches_the_kernel(cuda_device, algorithm):
    """SmpcController with backend 'cuda' solves FBE or NAMA through the
    kernel, once per control step, and agrees with 'torch'."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import qn_solve as Q

    def run(backend):
        net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
        tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=7, seed=7)
        fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=3, seed=7)
        cfg = synthetic_config(net, tree, max_iterations=QN_TRACK,
                               step_size=1e-3)
        cfg.algorithm = algorithm
        return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              backend=backend).closed_loop(3)

    n0 = Q.qn_solve.launches
    got = run("cuda")
    assert Q.qn_solve.launches == n0 + 3
    ref = run("torch")
    for t in range(3):
        b = np.asarray(ref[f"control{t}"])
        np.testing.assert_allclose(np.asarray(got[f"control{t}"]), b,
                                   rtol=1e-3,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0))


def _qn_batch(device, batch=3, step_size=1e-3, max_iterations=QN_TRACK):
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, steps, kw = _batch(device, batch=batch, step_size=step_size,
                           max_iterations=max_iterations)
    return (Q.kernel_constants(kc["fa"], prefix_stages=kc["prefix_stages"]),
            steps, dict(kw, lbfgs_buffer_size=QN_BS))


def _qn_assert_equal(got, ref):
    for k in ("control", "u", "x", "primal_infeasibility", "value_fbe",
              "tau", "iterations", "line_search_trials", "lbfgs_skips"):
        assert torch.equal(got[k], ref[k]), k
    for k in ("xi", "psi"):
        assert torch.equal(got["y"][k], ref["y"][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 2, 3, 7])
@pytest.mark.parametrize("form", ["shared", "stacked"])
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_batched_kernel_matches_single_kernel(cuda_device, algorithm,
                                                 form, batch, dtype):
    """Each instance of a batched FBE or NAMA call (uhat, e and
    alpha_price shared with batch stride 0, or one instance after
    another) equals the single-solve kernel on that instance's step, bit
    for bit, over ITERS iterations, in which the L-BFGS ring wraps; at
    batch sizes that fill the flat passes' grid unevenly (their chunks
    do not depend on B), with the history in float32 and in bf16."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, steps, kw = _qn_batch(cuda_device, batch=batch,
                              max_iterations=ITERS)
    kw = dict(kw, algorithm=algorithm, lbfgs_dtype=dtype)
    if form == "stacked":
        steps = {k: v.contiguous() for k, v in steps.items()}
    if batch > 1:
        assert (steps["alpha_price"].stride(0) == 0) == (form == "shared")
    n0 = Q.qn_solve_batch.launches
    got = Q.qn_solve_batch(kc, steps, None, **kw)
    assert Q.qn_solve_batch.launches == n0 + 1
    assert got["iterations"].tolist() == [ITERS] * batch
    for b in range(batch):
        one = Q.qn_solve(kc, _instance(steps, b), None, **kw)
        _qn_assert_equal(_instance(got, b), one)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_batch_of_32_tracks_the_plain_batch(cuda_device, algorithm):
    """Instances 0-3 of a B = 32 call keep to the plain batch over
    QN_TRACK iterations (9a's bounds), with the same counts of
    line-search trials and rejected curvature pairs."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, steps, kw = _qn_batch(cuda_device, batch=32)
    kw["algorithm"] = algorithm
    got = Q.qn_solve_batch(kc, steps, None, **kw)
    ref = Q.qn_solve_batch_plain(kc, {k: v[:4] for k, v in steps.items()},
                                 None, **kw)
    for b in range(4):
        _qn_close(_instance(got, b), _instance(ref, b), stressed=False)
        for k in ("line_search_trials", "lbfgs_skips"):
            assert int(got[k][b]) == int(ref[k][b]), (b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_batch_of_one_matches_single_solve(cuda_device, algorithm):
    """The batched entry at B = 1 (compiled with the batch axis), cold and
    warm, equals the single solve (compiled without it) bit for bit; and
    over QN_TRACK iterations the batch keeps to its plain version."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, steps, kw = _qn_batch(cuda_device, batch=1)
    kw["algorithm"] = algorithm
    one = Q.qn_solve(kc, _instance(steps, 0), None, **kw)
    got = Q.qn_solve_batch(kc, steps, None, **kw)
    _qn_assert_equal(_instance(got, 0), one)
    warm1 = Q.qn_solve(kc, _instance(steps, 0), one["y"], **kw)
    warmb = Q.qn_solve_batch(kc, steps, got["y"], **kw)
    _qn_assert_equal(_instance(warmb, 0), warm1)
    ref = Q.qn_solve_batch_plain(kc, steps, None, **kw)
    _qn_close(_instance(got, 0), _instance(ref, 0), stressed=False)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_batched_kernel_tolerance_exits_match_plain(cuda_device,
                                                       algorithm):
    """Under a tolerance each instance stops at its plain version's
    iteration and its three traces are zero past it.  The tolerance:
    of those that stop instance 0 of the plain version past its first
    iteration (quasi_newton.exit_tolerances), the first that stops every
    instance mid-budget."""
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver import quasi_newton as qn_mod

    n = 20
    kc, steps, kw = _qn_batch(cuda_device, step_size=3e-4, max_iterations=n)
    kw["algorithm"] = algorithm
    mags = qn_mod.make_solver_batch(
        prefix_stages=kc["prefix_stages"], trace_magnitude=True,
        **kw)(kc["fa"], steps)["residual_magnitude"]
    for tol, _, _ in qn_mod.exit_tolerances(_np(mags[0]), n - 1):
        ref = Q.qn_solve_batch_plain(kc, steps, None, tolerance=tol, **kw)
        its = ref["iterations"].tolist()
        if all(1 < it < n for it in its):
            break
    else:
        pytest.fail("no tolerance gave mid-budget exits")
    got = Q.qn_solve_batch(kc, steps, None, tolerance=tol, **kw)
    assert got["iterations"].tolist() == its
    for b, it in enumerate(its):
        for k in ("primal_infeasibility", "value_fbe", "tau"):
            assert bool((got[k][b, it:] == 0).all()), k
    np.testing.assert_allclose(_np(got["control"]), _np(ref["control"]),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_batched_controller_launches_the_kernel(cuda_device, algorithm):
    """BatchedSmpcController(device='cuda') with backend 'auto' solves
    each step's FBE or NAMA batch through one kernel call and agrees
    with 'torch'."""
    from rapidnet_tpu_torch import BatchedSmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import qn_solve as Q

    def run(backend):
        net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
        tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=7, seed=7)
        fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=3, seed=7)
        cfg = synthetic_config(net, tree, max_iterations=QN_TRACK,
                               step_size=1e-3)
        cfg.algorithm = algorithm
        x0s = cfg.current_x * np.linspace(0.9, 1.1, 3)[:, None]
        return BatchedSmpcController(cfg, net, tree, fc, x0s,
                                     backend=backend).closed_loop(3)

    n0, s0 = Q.qn_solve_batch.launches, Q.qn_solve.launches
    got = run("auto")
    assert Q.qn_solve_batch.launches == n0 + 3
    assert Q.qn_solve.launches == s0
    ref = run("torch")
    b = ref["controls"]
    np.testing.assert_allclose(got["controls"], b, rtol=1e-3,
                               atol=1e-4 * max(np.abs(b).max(), 1.0))


# ---------------------------------------------------------------------------
# The streaming APG kernels (csrc/apg_stream.cu).  One K1 or K2 pass and a
# 25-iteration solve on the branchy tree of tests/test_pallas_stream.py
# (three prefix aggregations) are held to their plain halves within 1e-4
# of the largest magnitude, as the whole-solve kernel is; repeats are bit
# for bit (the reductions run in a fixed order).

STREAM_SHRINKS = (0.25, 0.5)   # given to the single passes: the solves at
                               # these penalties never shrink


def _stream_problem(device, x0_scale=1.2, branching=(3, 2, 2), N=8,
                    widths=(4, 7, 3, 2), max_iterations=ITERS):
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            step_arrays, step_tensors)
    from rapidnet_tpu_torch.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    nx, nu, nd, ne = widths
    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=11)
    tree = generate_tree(N=N, branching=list(branching), nd=nd, nu=nu,
                         seed=11)
    fc = synthetic_forecaster(N=N, nd=nd, nu=nu, sim_horizon=4, seed=11)
    cfg = synthetic_config(net, tree, max_iterations=max_iterations,
                           step_size=1e-3)
    cfg.current_x = (x0_scale * net.xmax).astype(np.float32)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_tensors(factor_arrays(eng), device)
    step = step_tensors(step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand)), device)
    kw = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety,
              xs_upper=float(XS_UPPER), max_iterations=max_iterations)
    return fa, eng.factor_step().prefix_stages, step, kw


@pytest.mark.cuda
def test_stream_single_passes_match_plain_halves(cuda_device):
    from rapidnet_tpu_torch.ops import apg_stream as S

    fa, prefix, step, kw = _stream_problem(cuda_device)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    st = S.plain_iterations(kc, step, iterations=5, **kw)
    sc = (kc["lams"][4], kc["lams"][5], 1.0) + STREAM_SHRINKS
    scal = dict(lam_prev=sc[0], lam_i=sc[1], upd=1.0, k1f=sc[3], k2f=sc[4],
                c=kw["inv_step"], xs_upper=kw["xs_upper"])
    n0 = S.k1_call.launches
    yk, zk, vk, chk = S.k1_call(kc, step, st["pre"], st["y"], st["z"], sc,
                                **kw)
    assert S.k1_call.launches == n0 + 1
    yp, zp, vp, chp = S.k1_plain(kc, step["beta"], st["pre"], st["y"],
                                 st["z"], step=kw["step_size"], **scal)
    for k in ("xi", "psi"):
        _close(yk[k], yp[k])
        _close(zk[k], zp[k])
    _close(vk, vp)
    _close(chk, chp)
    pdu = step["prev_u"] - step["prev_uhat"]
    got = S.k2_call(kc, step, vp, yp, zp, sc, **kw)
    ref = S.k2_plain(kc, vp, step["uhat"], step["e"], step["x0"], pdu, yp,
                     zp, lam_i=sc[1], c=kw["inv_step"],
                     xs_upper=kw["xs_upper"])
    for g, r in zip(got[:2] + (got[2]["xi"], got[2]["psi"]) + got[3:],
                    ref[:2] + (ref[2]["xi"], ref[2]["psi"]) + ref[3:]):
        _close(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("branching,N", [((3, 2, 2), 8), ((3, 3, 3), 6),
                                         ((16, 16), 4)])
def test_stream_solve_matches_plain(cuda_device, branching, N):
    """Trees whose slots fill the last tile of 8 or not, with one to
    three prefix aggregations; cold and warm-started."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    fa, prefix, step, kw = _stream_problem(cuda_device, branching=branching,
                                           N=N)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    n0 = S.apg_stream.launches
    got = S.apg_stream(kc, step, None, **kw)
    assert S.apg_stream.launches == n0 + 1
    ref = S.apg_stream_plain(kc, step, None, **kw)
    for k in ("control", "u", "x", "v", "primal_infeasibility"):
        _close(got[k], ref[k])
    for k in ("xi", "psi"):
        _close(got["y"][k], ref["y"][k])
    warm = S.apg_stream(kc, step, ref["y"], **kw)
    _close(warm["u"], S.apg_stream_plain(kc, step, ref["y"], **kw)["u"])


@pytest.mark.cuda
def test_stream_repeats_bit_for_bit(cuda_device):
    from rapidnet_tpu_torch.ops import apg_stream as S

    fa, prefix, step, kw = _stream_problem(cuda_device)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    a = S.apg_stream(kc, step, None, **kw)
    b = S.apg_stream(kc, step, None, **kw)
    for k in ("control", "u", "x", "v", "primal_infeasibility"):
        assert torch.equal(a[k], b[k]), k
    for k in ("xi", "psi"):
        assert torch.equal(a["y"][k], b["y"][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [181, 182])
def test_fits_agrees_with_the_launch(cuda_device, ns):
    """At the Barcelona-scale widths the whole-solve kernels take ns 181
    and refuse ns 182 at the launch, as ``fits`` says; the streaming
    kernels take both."""
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import qn_solve as Q

    fa, prefix, step, kw = _stream_problem(
        cuda_device, x0_scale=0.3, branching=(ns,), N=4,
        widths=(63, 114, 88, 17), max_iterations=2)
    dims = (4, ns, 63, 114, 97)
    kc = K.kernel_constants(fa, prefix_stages=prefix, max_iterations=2)
    kq = Q.kernel_constants(fa, prefix_stages=prefix)
    runs = {K.fits: lambda: K.apg_solve(kc, step, None, **kw),
            Q.fits: lambda: Q.qn_solve(kq, step, None, lbfgs_buffer_size=5,
                                       algorithm="namaAlgorithm", **kw)}
    for fits, run in runs.items():
        assert fits(*dims) == (ns <= 181)
        if fits(*dims):
            assert bool(torch.isfinite(run()["u"]).all())
        else:
            with pytest.raises(RuntimeError, match="kernel failed"):
                run()
    assert S.stream_fits(*dims)
    ks = S.stream_constants(fa, prefix_stages=prefix, max_iterations=2)
    _close(S.apg_stream(ks, step, None, **kw)["u"],
           S.apg_stream_plain(ks, step, None, **kw)["u"])


@pytest.mark.cuda
def test_smem_formulas_match_the_sources(cuda_device):
    """Each gate's shared-memory formula equals its source's, at the
    Barcelona-scale and BASELINE config 5 sizes and at a tiny tree."""
    from rapidnet_tpu_torch.ops import (apg_solve, apg_stream, build,
                                        qn_solve, stream_qn)

    shapes = [(24, 25, 63, 114, 97), (24, 181, 63, 114, 97),
              (24, 1024, 63, 114, 97), (153, 25, 63, 114, 97),
              (8, 12, 4, 7, 5)]
    for name, mod in (("apg_solve", apg_solve), ("qn_solve", qn_solve),
                      ("apg_stream", apg_stream), ("stream_qn", stream_qn)):
        lib = build.load(name)
        for dims in shapes:
            build.check_smem(lib, name, dims, mod.smem(*dims))
    # the whole-solve APG kernel's variants: each phase's shared memory
    # (apg_solve_sweep_smem) as apg_solve.sweep_smem computes it
    import ctypes
    fn = build.load("apg_solve").apg_solve_sweep_smem
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    for dims in shapes + [(152, 25, 63, 114, 97), (6, 27, 5, 9, 7)]:
        for C, Cp in ((1, 1), (2, 8), (5, 4), (8, 8), (3, 2)):
            for staged in range(8):
                st = tuple(bool(staged >> j & 1) for j in range(3))
                v = {"cluster": C, "prefix_cluster": Cp,
                     "staged": dict(zip(apg_solve.SWEEP_PHASES, st))}
                want = apg_solve.sweep_smem(*dims, C, Cp, st)
                got = {ph: fn(*dims, apg_solve.encode(v), j)
                       for j, ph in enumerate(apg_solve.SWEEP_PHASES)}
                assert got == want, (dims, v)


@pytest.mark.cuda
def test_qn_partials_formula_matches_the_source(cuda_device):
    """The wrapper's sizing of the QN kernel's partial buffers equals the
    source's (qn_solve_partials) at the Barcelona-scale, the widest
    whole-solve and a tiny tree, for batches of 1, 2, 7 and 32."""
    from rapidnet_tpu_torch.ops import build, qn_solve

    lib = build.load("qn_solve")
    for dims in [(24, 25, 63, 114, 97), (24, 181, 63, 114, 97),
                 (152, 25, 63, 114, 97), (6, 4, 4, 7, 5), (8, 12, 4, 7, 5)]:
        for B in (1, 2, 7, 32):
            qn_solve.check_partials(lib, dims, B)


@pytest.mark.cuda
def test_auto_streams_a_tree_past_the_whole_solve_kernel(cuda_device):
    """SmpcController(device='cuda') with backend 'auto' on a tree of
    182 scenarios at the Barcelona-scale widths: one streaming launch per
    step, no whole-solve launch, and the controls of 'stream' bit for
    bit and of 'torch' within bound."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import apg_stream as S

    def run(backend):
        net = synthetic_network(nx=63, nu=114, nd=88, ne=17, seed=7)
        tree = generate_tree(N=4, branching=[182], nd=88, nu=114, seed=7)
        fc = synthetic_forecaster(N=4, nd=88, nu=114, sim_horizon=3, seed=7)
        cfg = synthetic_config(net, tree, max_iterations=20,
                               step_size=1e-3)
        ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              backend=backend)
        return ctrl, ctrl.closed_loop(3)

    n0, k0 = S.apg_stream.launches, K.apg_solve.launches
    ctrl, auto = run("auto")
    assert ctrl.route == "stream"
    assert S.apg_stream.launches == n0 + 3 and K.apg_solve.launches == k0
    _, stream = run("stream")
    _, plain = run("torch")
    for t in range(3):
        assert auto[f"control{t}"] == stream[f"control{t}"]
        _close(torch.tensor(auto[f"control{t}"]),
               torch.tensor(plain[f"control{t}"]))


# The streaming FBE/NAMA path: the sweeps S1/S2 (csrc/stream_qn.cu), in
# the solve-step and the Hessian-oracle variants, and the history passes
# (csrc/lbfgs.cu), in float32 and bfloat16 storage, each against its
# plain version on seeded inputs: a sweep within 1e-4 of the largest
# magnitude (as the streaming APG passes), the dots within 1e-5 of the
# rep-weighted sum of the products' magnitudes and combine within 1e-6 *
# max(|plain|, 1) (tests/test_torch_qn_stream.py's bounds against the JAX
# package); the kernels reduce in a fixed order, so repeats are bit for
# bit.  The whole solve on the card is held to the same solve on the CPU
# (the plain versions) over 3 (FBE) and 2 (NAMA) iterations, with the
# short-horizon bounds of tests/test_qn_stream.py:67-84.


def _seeded(shape, device, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("affine", [True, False], ids=["solve", "oracle"])
@pytest.mark.parametrize("branching,N", [((3, 2, 2), 8), ((3, 3, 3), 6)])
def test_stream_sweeps_match_plain(cuda_device, affine, branching, N):
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    fa, prefix, step, kw = _stream_problem(cuda_device, branching=branching,
                                           N=N)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    N, ns, nx, nu, nv = SQ.dims(kc)
    w = _seeded((N, ns, 2 * nx + nu), cuda_device, 3)
    v = _seeded((N, ns, nv), cuda_device, 4)
    pdu = step["prev_u"] - step["prev_uhat"]
    aff = ((step["uhat"], step["e"], step["x0"], pdu) if affine
           else (None,) * 4)
    beta = step["beta"] if affine else None
    n1, n2 = SQ.s1_call.launches, SQ.s2_call.launches
    got_v = SQ.s1_call(kc, w, beta)
    got = SQ.s2_call(kc, v, *aff)
    assert (SQ.s1_call.launches, SQ.s2_call.launches) == (n1 + 1, n2 + 1)
    _close(got_v, SQ.s1_plain(kc, w, beta))
    for g, r in zip(got, SQ.s2_plain(kc, v, *aff)):
        _close(g, r)
    assert torch.equal(SQ.s1_call(kc, w, beta), got_v)
    assert torch.equal(SQ.s2_call(kc, v, *aff)[2], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_history_passes_match_plain(cuda_device, dtype):
    from rapidnet_tpu_torch.ops import lbfgs as LB

    M, N, ns, D = 6, 8, 37, 15
    mat_s = _seeded((M, N, ns, D), cuda_device, 5, dtype)
    mat_y = _seeded((M, N, ns, D), cuda_device, 6, dtype)
    mat_s[0] = 0
    mat_y[0] = 0
    s = _seeded((N, ns, D), cuda_device, 7, dtype)
    yv = _seeded((N, ns, D), cuda_device, 8, dtype)
    g = _seeded((N, ns, D), cuda_device, 9)
    rep = (_seeded((N, ns), cuda_device, 10) > -0.5).float()
    n0 = LB.dots.launches
    got = LB.dots(rep, mat_s, mat_y, s, yv, g)
    assert LB.dots.launches == n0 + 1
    ref = LB.dots_plain(rep, mat_s, mat_y, s, yv, g)
    mag = LB.dots_plain(rep, mat_s.abs(), mat_y.abs(), s.abs(), yv.abs(),
                        g.abs())
    for a, b, m in zip(got, ref, mag):
        assert bool(((a - b).abs() <= 1e-5 * m).all()), (a - b).abs().max()
    assert all(torch.equal(a, b) for a, b in
               zip(got, LB.dots(rep, mat_s, mat_y, s, yv, g)))
    coef = _seeded((2 * M + 1,), cuda_device, 11)
    out = LB.combine(coef, mat_s, mat_y, g)
    ref = LB.combine_plain(coef, mat_s, mat_y, g)
    bound = 1e-6 * max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= bound
    assert torch.equal(out, LB.combine(coef, mat_s, mat_y, g))


# The bf16 dots' two bodies (csrc/lbfgs.cu): the vector body (16-byte
# loads) where D and E are multiples of 8 and every operand is 16-byte
# aligned, the one-value body otherwise (D = 15, or a history viewed at
# an odd offset); M = 1, 6 and 16 columns.  Each within 1e-5 of the
# magnitude sum of dots_plain, repeats bit for bit.
BF16_DOTS = {"vector_m1": (1, 24, False, True),
             "vector_m6": (6, 24, False, True),
             "vector_m16": (16, 24, False, True),
             "scalar_m1": (1, 15, False, False),
             "scalar_m16": (16, 15, False, False),
             "offset_view": (6, 24, True, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BF16_DOTS))
def test_bf16_dots_bodies_match_plain(cuda_device, case):
    from rapidnet_tpu_torch.ops import lbfgs as LB

    M, D, offset, vector = BF16_DOTS[case]
    N, ns = 8, 37
    E = N * ns * D
    bf16 = torch.bfloat16
    if offset:      # both histories in one buffer, one value off alignment
        buf = _seeded((2 * M * E + 1,), cuda_device, 5, bf16)
        mat_s = buf[1:1 + M * E].view(M, N, ns, D)
        mat_y = buf[1 + M * E:].view(M, N, ns, D)
    else:
        mat_s = _seeded((M, N, ns, D), cuda_device, 5, bf16)
        mat_y = _seeded((M, N, ns, D), cuda_device, 6, bf16)
    s = _seeded((N, ns, D), cuda_device, 7, bf16)
    yv = _seeded((N, ns, D), cuda_device, 8, bf16)
    g = _seeded((N, ns, D), cuda_device, 9)
    rep = (_seeded((N, ns), cuda_device, 10) > -0.5).float()
    assert LB.vector_path(mat_s, mat_y, s, yv, g) is vector
    n0 = LB.dots.launches
    got = LB.dots(rep, mat_s, mat_y, s, yv, g)
    assert LB.dots.launches == n0 + 1
    ref = LB.dots_plain(rep, mat_s, mat_y, s, yv, g)
    mag = LB.dots_plain(rep, mat_s.abs(), mat_y.abs(), s.abs(), yv.abs(),
                        g.abs())
    for a, b, m in zip(got, ref, mag):
        assert bool(((a - b).abs() <= 1e-5 * m).all()), (a - b).abs().max()
    assert all(torch.equal(a, b) for a, b in
               zip(got, LB.dots(rep, mat_s, mat_y, s, yv, g)))


# The partial parent block (csrc/stream_sharded.cu) on lists built here:
# parents with no child, one child, 5, 64, 130 and 1100 children, at
# widths below, just above and well above a warp of columns; held bit for
# bit to a float32 sum taken in each parent's index-list order from zero
# (the order the kernel keeps), repeats bit for bit.
PARENT_CHILDREN = (0, 1, 130, 1100, 5, 0, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [7, 33, 160])
def test_partial_parents_equals_the_index_order_fold(cuda_device, W):
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS

    rng = np.random.default_rng(W)
    nsl = sum(PARENT_CHILDREN) + 3
    slots = rng.permutation(nsl)
    x_Cp = torch.zeros((len(PARENT_CHILDREN), nsl))
    start = 0
    for r, n in enumerate(PARENT_CHILDREN):
        x_Cp[r, slots[start:start + n]] = 1.0
        start += n
    kc = SS.parent_block(x_Cp.to(cuda_device), W)
    scale = 10.0 ** rng.uniform(-3, 3, (nsl, 1))
    carry = torch.from_numpy((rng.standard_normal((nsl, W)) *
                              scale).astype(np.float32)).to(cuda_device)
    n0 = SS.partial_parents.launches
    got = SS.partial_parents(kc, carry)
    assert SS.partial_parents.launches == n0 + 1
    fold = torch.zeros((len(PARENT_CHILDREN), W), device=cuda_device)
    ptr, idx = kc["x_ptr"].tolist(), kc["x_idx"].tolist()
    for r in range(len(PARENT_CHILDREN)):
        for m in idx[ptr[r]:ptr[r + 1]]:
            fold[r] += carry[m]
    assert torch.equal(got, fold)
    for r, n in enumerate(PARENT_CHILDREN):
        if n == 0:
            assert bool((got[r] == 0).all())
    _close(got, SS.partial_parents_plain(kc, carry))
    assert torch.equal(SS.partial_parents(kc, carry), got)


@pytest.mark.cuda
@pytest.mark.parametrize("lbfgs_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algorithm,iters", [("globalFbeAlgorithm", 4),
                                             ("namaAlgorithm", 3)])
def test_qn_stream_solve_matches_cpu(cuda_device, algorithm, iters,
                                     lbfgs_dtype):
    """The streaming solve through the kernels (its third iteration
    captured and replayed as a CUDA graph) against the same solve on the
    CPU (every wrapper's plain version, every iteration enqueued);
    repeats bit for bit."""
    from rapidnet_tpu_torch.ops import lbfgs as LB
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        fa, prefix, step, kw = _stream_problem(dev, max_iterations=iters)
        run = make_qn_stream(fa, algorithm=algorithm, prefix_stages=prefix,
                             lbfgs_buffer_size=5, lbfgs_dtype=lbfgs_dtype,
                             **kw)
        n0 = LB.dots.launches
        out[dev.type] = run(step)
        if dev.type == "cuda":
            assert LB.dots.launches == n0 + min(iters, 3) - 1
            again = run(step)
            for k in ("u", "x", "v", "value_fbe", "tau"):
                assert torch.equal(again[k], out["cuda"][k]), k
    got, ref = out["cuda"], out["cpu"]

    def scaled(k, a, b):
        b = b.cpu()
        bound = 5e-4 * max(float(b.abs().max()), 1.0)
        assert float((a.cpu() - b).abs().max()) <= bound, k

    for k in ("control", "u", "x", "v"):
        scaled(k, got[k], ref[k])
    for k in ("xi", "psi"):
        scaled(k, got["y"][k], ref["y"][k])
    np.testing.assert_allclose(_np(got["value_fbe"]), _np(ref["value_fbe"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got["tau"]), _np(ref["tau"]), atol=1e-6)
    np.testing.assert_allclose(_np(got["primal_infeasibility"]),
                               _np(ref["primal_infeasibility"]), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.cuda
def test_auto_streams_qn_past_the_whole_solve_kernel(cuda_device):
    """SmpcController(device='cuda') with FBE and backend 'auto' on a tree
    of 182 scenarios at the Barcelona-scale widths: the streaming QN
    kernels run (three sweep pairs an iteration after the first, one dots
    and one combine pass; the wrappers are called for the first three
    iterations, the third captured and replayed), the whole-solve QN
    kernel does not, and the bf16 history runs too."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import lbfgs as LB
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    iters, steps = 6, 2

    def run(backend, **kw):
        net = synthetic_network(nx=63, nu=114, nd=88, ne=17, seed=7)
        tree = generate_tree(N=4, branching=[182], nd=88, nu=114, seed=7)
        fc = synthetic_forecaster(N=4, nd=88, nu=114, sim_horizon=3, seed=7)
        cfg = synthetic_config(net, tree, max_iterations=iters,
                               step_size=1e-3)
        cfg.algorithm = "globalFbeAlgorithm"
        ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              backend=backend, **kw)
        return ctrl, ctrl.closed_loop(steps)

    n0 = (SQ.s1_call.launches, LB.dots.launches, LB.combine.launches,
          Q.qn_solve.launches)
    ctrl, auto = run("auto")
    assert ctrl.route == "stream"
    assert (SQ.s1_call.launches - n0[0], LB.dots.launches - n0[1],
            LB.combine.launches - n0[2], Q.qn_solve.launches - n0[3]) == (
        steps * (2 + 3 * 2), steps * 2, steps * 2, 0)
    _, stream = run("stream")
    _, bf16 = run("stream", stream_lbfgs_dtype="bfloat16")
    for t in range(steps):
        assert auto[f"control{t}"] == stream[f"control{t}"]
        assert np.isfinite(bf16[f"control{t}"]).all()


@pytest.mark.cuda
def test_leak_census_counts_what_tensors_hold(cuda_device):
    """``device_bytes_in_use`` counts the bytes live tensors asked for: a
    request served by a cached block up to 1 MB larger (which the
    allocator hands out whole) counts its own size, so two solves that
    hold the same tensors count the same."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=4, branching=[2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=4, nd=3, nu=7, sim_horizon=3, seed=7)
    ctrl = SmpcController(synthetic_config(net, tree), network=net,
                          tree=tree, forecaster=fc)
    big = torch.empty(11436032 // 4, device=cuda_device)
    del big                                       # a cached block
    base = ctrl.device_bytes_in_use()
    held = torch.cuda.memory_allocated(cuda_device)
    t = torch.empty(11206656 // 4, device=cuda_device)
    assert ctrl.device_bytes_in_use() - base == t.numel() * 4
    assert torch.cuda.memory_allocated(cuda_device) - held >= t.numel() * 4


@pytest.mark.cuda
def test_leak_census_waits_for_other_streams(cuda_device):
    """A dead tensor that another stream used (as a gloo collective's
    copy stream uses the mesh's tensors) counts nothing once that
    stream's work is done, though the allocator frees it only when it
    next looks: the census looks."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=4, branching=[2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=4, nd=3, nu=7, sim_horizon=3, seed=7)
    ctrl = SmpcController(synthetic_config(net, tree), network=net,
                          tree=tree, forecaster=fc)
    base = ctrl.device_bytes_in_use()
    t = torch.ones(1 << 20, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        t.mul_(2.0)
    t.record_stream(side)
    del t
    assert ctrl.device_bytes_in_use() == base


# ------------------------------------------------- two ranks on one card


MESH_RANKS = 2


def _mesh_rank(rank, init, job, results):
    """One rank of a gloo group on card 0 (a spawned process)."""
    import datetime
    import traceback
    try:
        from rapidnet_tpu_torch.parallel import distributed, make_mesh
        torch.cuda.set_device(0)
        distributed.initialize(backend="gloo", init_method=init, rank=rank,
                               world_size=MESH_RANKS,
                               timeout=datetime.timedelta(seconds=60))
        mesh = make_mesh(MESH_RANKS, devices=["cuda:0"] * MESH_RANKS)
        results.put((rank, job(mesh)))
        mesh.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc()))


def _on_two_ranks(job, timeout=300.0):
    """``job(mesh)`` on two spawned ranks sharing card 0 over gloo (NCCL
    refuses two ranks on one card); their results, or a failure."""
    import multiprocessing as mp
    import os
    import tempfile
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=_mesh_rank, args=(r, init, job, results))
             for r in range(MESH_RANKS)]
    out = {}
    try:
        for p in procs:
            p.start()
        for _ in range(MESH_RANKS):
            rank, res = results.get(timeout=timeout)
            assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
            out[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    return [out[r] for r in range(MESH_RANKS)]


def _sharded_passes(mesh):
    """One K1a pass, one partial parent block and one sharded S1 pass in
    each variant on this rank's block of the [3, 2, 2] tree (a cross stage
    below the top one at two ranks), kernels against the plain halves on
    the card, from the state after 5 plain iterations from tanks above
    their box; returns the launches counted."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    fa, prefix, step, kw = _stream_problem(mesh.device)
    kc1 = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    ps = S.plain_iterations(kc1, step, iterations=5, **kw)
    kc = SS.make_apg_stream_sharded(mesh, fa, prefix_stages=prefix,
                                    **kw).consts
    assert kc["s_hi"] == 2 and 1 in kc["low"]
    sl = kc["slots"]
    stl = SS.shard_step(kc, step)
    sc = torch.stack([kc["lams"][4], kc["lams"][5],
                      torch.ones((), device=mesh.device)] +
                     [torch.tensor(s, device=mesh.device)
                      for s in STREAM_SHRINKS])

    def state():
        st = SS.new_state(kc, stl, None, ITERS)
        for k in ("xi", "psi"):
            st[f"pre_{k}"].copy_(ps["pre"][k][:, sl])
            st[f"y_{k}"].copy_(ps["y"][k][:, sl])
            st[f"z_{k}"].copy_(ps["z"][k][:, sl])
        st["sc"].copy_(sc)
        return st

    n0 = {f: f.launches for f in (SS.k1a_call, SS.partial_parents,
                                  SQ.s1a_call)}
    st_k, st_p = state(), state()
    ext_k, par_k = SS.k1a_call(kc, stl, st_k, **kw)
    ext_p, par_p = SS.k1a_plain(kc, stl, st_p, **kw)
    hi = slice(kc["s_hi"], None)
    for k in ("y_xi", "y_psi", "z_xi", "z_psi", "v"):
        _close(st_k[k][hi], st_p[k][hi])
    _close(ext_k, ext_p)
    _close(par_k, par_p)
    last = st_k["carry"][(len(kc["ranges"]) - 1) & 1]
    _close(SS.partial_parents(kc, last), SS.partial_parents_plain(kc, last))
    w = torch.cat([ps["y"]["xi"], ps["y"]["psi"]], dim=-1)[:, sl].contiguous()
    for beta in (stl["beta"], None):
        _close(SQ.s1a_call(kc, w, mesh, beta),
               SQ.s1a_plain(kc, w, mesh, beta))
    return {f.__name__: f.launches - n for f, n in n0.items()}


@pytest.mark.cuda
def test_sharded_passes_match_plain_on_two_ranks(cuda_device):
    """The sharded kernels on two ranks sharing the card: K1a (K1 over
    the shard's stage ranges and the partial parent block), the partial
    parent block alone, and the sharded S1 pass (its all-reduce and
    root-side stages included) in both variants, each against its plain
    halves on the same card within 1e-4 of the largest magnitude."""
    for counts in _on_two_ranks(_sharded_passes):
        assert counts == {"k1a_call": 1, "partial_parents": 4,
                          "s1a_call": 2}, counts


@pytest.mark.cuda
def test_fused_iteration_matches_plain(cuda_device):
    """One fused iteration (one cooperative launch) against K1's and
    K2's plain halves with the same scalars."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    fa, prefix, step, kw = _stream_problem(cuda_device)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    st = S.plain_iterations(kc, step, iterations=5, **kw)
    sc = (kc["lams"][4], kc["lams"][5], 1.0) + STREAM_SHRINKS
    state = {"pre": st["pre"], "y": st["y"], "z": st["z"]}
    n0 = S.fused_call.launches
    got = S.fused_call(kc, step, state, sc, **kw)
    assert S.fused_call.launches == n0 + 1
    ref = S.fused_iteration_plain(kc, step, state, sc, **kw)
    for a in ("y", "z", "pre"):
        for k in ("xi", "psi"):
            _close(got[a][k], ref[a][k])
    for k in ("v", "champion", "x", "u", "d1sq", "d2sq"):
        _close(got[k], ref[k])


@pytest.mark.cuda
@pytest.mark.parametrize("branching,N", [((3, 2, 2), 8), ((3, 3, 3), 6),
                                         ((16, 16), 4)])
def test_fused_solve_equals_the_two_kernel_solve(cuda_device, branching, N):
    """The fused kernel runs K1's and K2's stage bodies in their order:
    its solve equals the two-kernel solve bit for bit, cold and
    warm-started, and repeats itself."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    fa, prefix, step, kw = _stream_problem(cuda_device, branching=branching,
                                           N=N)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    n0 = S.apg_stream_fused.launches
    y0 = S.apg_stream_plain(kc, step, None, **kw)["y"]
    for warm in (None, y0):
        got = S.apg_stream_fused(kc, step, warm, **kw)
        ref = S.apg_stream(kc, step, warm, **kw)
        again = S.apg_stream_fused(kc, step, warm, **kw)
        for out in (ref, again):
            for k in ("control", "u", "x", "v", "primal_infeasibility"):
                assert torch.equal(got[k], out[k]), k
            for k in ("xi", "psi"):
                assert torch.equal(got["y"][k], out["y"][k]), k
    assert S.apg_stream_fused.launches == n0 + 4


@pytest.mark.cuda
def test_fused_smem_matches_the_source(cuda_device):
    from rapidnet_tpu_torch.ops import apg_stream, build

    lib = build.load("apg_stream")
    for dims in [(24, 1024, 63, 114, 97), (24, 512, 63, 114, 97),
                 (8, 12, 4, 7, 5), (80, 64, 63, 114, 97)]:
        build.check_smem(lib, "apg_stream_fused", dims,
                         apg_stream.fused_smem(*dims))


# The variants of the streaming kernels: at BASELINE config 5's widths
# the matrices and a stage's operands fit in shared memory (staged); at
# twice those widths they do not, and the same stage bodies read them
# from device memory.  Each single pass is held to its plain half by
# chip_smoke.py phase 15's bound.
PASS_FACTOR = 1e-4
CONFIG5_WIDTHS = (63, 114, 88, 17)         # nx, nu, nd, ne: nv = 97
WIDE_WIDTHS = (126, 228, 44, 34)           # nv = 194: matrices ~425 KB
STAGE_VARIANTS = {"staged": ((8, 8, 4, 4), 24, CONFIG5_WIDTHS),
                  "unstaged": ((3, 2, 2), 8, WIDE_WIDTHS)}


def _held(got, ref, factor=PASS_FACTOR):
    got, ref = got.double().cpu(), ref.double().cpu()
    bound = factor * max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= bound


def _single_pass_case(device, variant):
    from rapidnet_tpu_torch.ops import apg_stream as S

    branching, N, widths = STAGE_VARIANTS[variant]
    fa, prefix, step, kw = _stream_problem(device, branching=branching, N=N,
                                           widths=widths)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    st = S.plain_iterations(kc, step, iterations=3, **kw)
    sc = (kc["lams"][2], kc["lams"][3], 1.0) + STREAM_SHRINKS
    return kc, step, kw, st, sc


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(STAGE_VARIANTS))
def test_stream_variant_passes_match_plain_halves(cuda_device, variant):
    """One K1 and one K2 pass of the variant the source picks (staged at
    config 5's widths, unstaged past them) against the plain halves."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    kc, step, kw, st, sc = _single_pass_case(cuda_device, variant)
    picked = S.staged(*S._dims(kc))
    want = variant == "staged"
    assert picked["k1"] == want and picked["k2"] == want, picked
    scal = dict(lam_prev=sc[0], lam_i=sc[1], upd=1.0, k1f=sc[3], k2f=sc[4],
                c=kw["inv_step"], xs_upper=kw["xs_upper"])
    yk, zk, vk, chk = S.k1_call(kc, step, st["pre"], st["y"], st["z"], sc,
                                **kw)
    yp, zp, vp, chp = S.k1_plain(kc, step["beta"], st["pre"], st["y"],
                                 st["z"], step=kw["step_size"], **scal)
    for k in ("xi", "psi"):
        _held(yk[k], yp[k])
        _held(zk[k], zp[k])
    _held(vk, vp)
    _held(chk, chp)
    pdu = step["prev_u"] - step["prev_uhat"]
    got = S.k2_call(kc, step, vp, yp, zp, sc, **kw)
    ref = S.k2_plain(kc, vp, step["uhat"], step["e"], step["x0"], pdu, yp,
                     zp, lam_i=sc[1], c=kw["inv_step"],
                     xs_upper=kw["xs_upper"])
    for g, r in zip(got[:2] + (got[2]["xi"], got[2]["psi"]) + got[3:],
                    ref[:2] + (ref[2]["xi"], ref[2]["psi"]) + ref[3:]):
        _held(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(STAGE_VARIANTS))
def test_instrumented_build_equals_the_plain_build(cuda_device, variant):
    """The clock64 build (apg_stream.CLOCK_DEFINES) adds barriers and
    nothing else: its K1 and K2 passes equal the plain build's bit for
    bit, and it reports cycles for every part its variant runs."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    kc, step, kw, st, sc = _single_pass_case(cuda_device, variant)
    spans = S.stage_spans(kc, step, st["pre"], st["y"], st["z"], sc, **kw)
    k1 = S.k1_call(kc, step, st["pre"], st["y"], st["z"], sc, **kw)
    k2 = S.k2_call(kc, step, k1[2], k1[0], k1[1], sc, **kw)
    for a, b in ((spans["k1"][0], k1[0]), (spans["k1"][1], k1[1]),
                 (spans["k2"][2], k2[2])):
        for k in ("xi", "psi"):
            assert torch.equal(a[k], b[k]), k
    for a, b in zip((spans["k1"][2], spans["k1"][3]) + spans["k2"][:2] +
                    spans["k2"][3:], (k1[2], k1[3]) + k2[:2] + k2[3:]):
        assert torch.equal(a, b)
    cycles = spans["cycles"]
    assert all(cycles[p] > 0 for p in S.SPAN_PARTS), cycles


def _sweep_case(device, variant):
    """The sweeps' inputs at a variant's widths: the dual triple after
    three plain APG iterations, and per kind (solve step, oracle) S1's
    and S2's affine operands."""
    kc, step, kw, st, sc = _single_pass_case(device, variant)
    w = torch.cat([st["y"]["xi"], st["y"]["psi"]], dim=-1).contiguous()
    pdu = (step["prev_u"] - step["prev_uhat"]).contiguous()
    kinds = {"solve": ((step["beta"],),
                       (step["uhat"], step["e"], step["x0"], pdu)),
             "oracle": ((), ())}
    return kc, w, kinds


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(STAGE_VARIANTS))
def test_stream_qn_variant_passes_match_plain_halves(cuda_device, variant):
    """One S1 and one S2 pass, solve step and oracle, of the variant the
    source picks (``stream_qn.staged``: staged at config 5's widths,
    unstaged past them) against ``s1_plain``/``s2_plain``."""
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    kc, w, kinds = _sweep_case(cuda_device, variant)
    picked = SQ.staged(*SQ.dims(kc))
    want = variant == "staged"
    assert picked["s1"] == want and picked["s2"] == want, picked
    for a1, a2 in kinds.values():
        v = SQ.s1_call(kc, w, *a1)
        _held(v, SQ.s1_plain(kc, w, *a1))
        for got, ref in zip(SQ.s2_call(kc, v, *a2), SQ.s2_plain(kc, v, *a2)):
            _held(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(STAGE_VARIANTS))
def test_stream_qn_instrumented_build_equals_the_plain_build(cuda_device,
                                                             variant):
    """The clock64 build of the sweeps (stream_qn.CLOCK_DEFINES) adds
    barriers and nothing else: its S1 and S2 passes equal the plain
    build's bit for bit, solve step and oracle, and it reports cycles for
    every part its variant runs."""
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    kc, w, kinds = _sweep_case(cuda_device, variant)
    for a1, a2 in kinds.values():
        spans = SQ.sweep_spans(kc, w, *a1, *a2)
        v = SQ.s1_call(kc, w, *a1)
        assert torch.equal(spans["v"], v)
        for got, ref in zip(spans["s2"], SQ.s2_call(kc, v, *a2)):
            assert torch.equal(got, ref)
        cycles = spans["cycles"]
        assert all(cycles[p] > 0 for p in SQ.SPAN_PARTS), cycles


@pytest.mark.cuda
def test_stream_qn_launches_at_the_gate_edge(cuda_device):
    """A tree at the edge of ``stream_fits``: S2's tile takes the device's
    whole opt-in shared memory per block (to the float column).  Neither
    staged variant fits there, and the unstaged S1 and S2, of the plain
    and of the instrumented build, launch (they ask for no shared memory
    beyond the gate's formula) and hold their plain halves, solve step
    and oracle."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    fa, prefix, _, _ = _stream_problem(cuda_device)
    kc = dict(S.stream_constants(fa, prefix_stages=prefix,
                                 max_iterations=ITERS))
    optin = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    column = optin // (4 * SQ.TILE)        # floats of a slot's tile rows
    nx = 4
    nv = 6 + (column - 10) % 2
    nu = (column - nx - nv) // 2           # 2 nu + nx + nv = column
    N, ns = kc["sq"].shape
    assert optin - 4 * SQ.TILE < SQ.smem(N, ns, nx, nu, nv) <= optin
    assert SQ.stream_fits(N, ns, nx, nu, nv)
    g = torch.Generator().manual_seed(13)

    def rnd(*shape, fan=1):
        return (torch.randn(shape, generator=g) / fan ** 0.5).to(cuda_device)

    kc.update(cx1=rnd(N, nx), cx2=rnd(N, nx), cu=rnd(N, nu),
              L=rnd(nu, nv, fan=nu), BbT=rnd(nx, nv), iWT=rnd(nv, nv, fan=nv),
              BT=rnd(nu, nx, fan=nu))
    kc["LT"] = kc["L"].T.contiguous()
    picked = SQ.staged(N, ns, nx, nu, nv)
    assert not picked["s1"] and not picked["s2"], picked
    w = rnd(N, ns, 2 * nx + nu)
    pdu = rnd(nu)
    kinds = (((rnd(N, ns, nv),),
              (rnd(N, ns, nu), rnd(N, ns, nx), rnd(nx), pdu)), ((), ()))
    for a1, a2 in kinds:
        v = SQ.s1_call(kc, w, *a1)
        _held(v, SQ.s1_plain(kc, w, *a1))
        s2 = SQ.s2_call(kc, v, *a2)
        for got, ref in zip(s2, SQ.s2_plain(kc, v, *a2)):
            _held(got, ref)
        spans = SQ.sweep_spans(kc, w, *a1, *a2)
        assert torch.equal(spans["v"], v)
        for got, ref in zip(spans["s2"], s2):
            assert torch.equal(got, ref)


@pytest.mark.cuda
def test_staged_formulas_match_the_source(cuda_device):
    """``apg_stream.staged_smem`` equals the source's
    ``apg_stream_staged_smem`` for each kernel, at config 5, its shard,
    twice its widths and a tiny tree."""
    import ctypes

    from rapidnet_tpu_torch.ops import apg_stream, build

    fn = build.load("apg_stream").apg_stream_staged_smem
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    for dims in [(24, 1024, 63, 114, 97), (24, 512, 63, 114, 97),
                 (8, 12, 126, 228, 194), (8, 12, 4, 7, 5),
                 (6, 27, 5, 9, 7)]:
        assert tuple(fn(*dims, k) for k in range(3)) == \
            apg_stream.staged_smem(*dims), dims


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", QN_ALGORITHMS)
def test_qn_bf16_history(cuda_device, algorithm):
    """The bf16 history: the first iteration (no history yet) equals the
    float32 history's, the kernel tracks its plain version over QN_TRACK
    iterations by the bounds above, and a batch of one equals the
    single solve bit for bit."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    kc, step, kw = _qn_problem(cuda_device, **QN_CASES["nominal"])
    bf16 = dict(kw, algorithm=algorithm, lbfgs_dtype="bfloat16")
    one = Q.qn_solve(kc, step, None, **dict(bf16, max_iterations=1))
    one32 = Q.qn_solve(kc, step, None, algorithm=algorithm,
                       **dict(kw, max_iterations=1))
    assert torch.equal(one["primal_infeasibility"],
                       one32["primal_infeasibility"])
    got = Q.qn_solve(kc, step, None, **bf16)
    ref = Q.qn_solve_plain(kc, step, None, **bf16)
    _qn_close(got, ref, stressed=False)
    steps = {k: v[None] for k, v in step.items()}
    b1 = Q.qn_solve_batch(kc, steps, None, **bf16)
    for k in ("control", "u", "x", "primal_infeasibility", "value_fbe",
              "tau"):
        assert torch.equal(b1[k][0], got[k]), k


# The whole-solve APG kernel's variants: slot clusters of C CTAs, prefix
# clusters of Cp, staged or unstaged matrices per phase.  Every variant
# keeps every sum in the order of the one-block design (C = Cp = 1,
# unstaged), so each equals it bit for bit.  Small penalties make the
# global shrinks act, so the norm partials' order shows in the outputs.
BARCELONA = dict(branching=(5, 5), N=24, widths=(63, 114, 88, 17))
BRANCHY = dict(branching=(3, 2, 2), N=8, widths=(4, 7, 3, 2))
ONE_BLOCK = 0x110       # apg_solve.encode: C = Cp = 1, nothing staged
VARIANT_ITERS = 40


def _variant_case(device, case, penalised):
    from rapidnet_tpu_torch.ops import apg_solve as K

    fa, prefix, step, kw = _stream_problem(
        device, x0_scale=1.2, max_iterations=VARIANT_ITERS,
        **{"barcelona": BARCELONA, "branchy": BRANCHY}[case])
    if penalised:
        kw = dict(kw, penalty_state=1e-3, penalty_safety=1e-3)
    kc = K.kernel_constants(fa, prefix_stages=prefix,
                            max_iterations=VARIANT_ITERS)
    return kc, step, kw


def _assert_same_solve(got, ref):
    """The kernel's outputs equal bit for bit (what every launch returns:
    the wrappers add the clamped control)."""
    for k in ("u", "x", "primal_infeasibility", "iterations"):
        assert torch.equal(got[k], ref[k]), k
    for k in ("xi", "psi"):
        assert torch.equal(got["y"][k], ref["y"][k]), k


def _limits():
    props = torch.cuda.get_device_properties(0)
    return dict(sm_count=props.multi_processor_count,
                smem_limit=props.shared_memory_per_block_optin,
                smem_per_sm=getattr(props, "shared_memory_per_multiprocessor",
                                    233472))


@pytest.mark.cuda
@pytest.mark.parametrize("penalised", [False, True],
                         ids=["nominal", "shrinking"])
@pytest.mark.parametrize("case", ["barcelona", "branchy"])
def test_apg_variants_equal_the_one_block_variant(cuda_device, case,
                                                  penalised):
    """The variant the source picks (at Barcelona scale clustered and
    staged), a few forced ones and the one-block variant give the same
    bits, single and at B = 1 of the batched entry; the branchy tree has
    fp >= 2 prefix stages."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    kc, step, kw = _variant_case(cuda_device, case, penalised)
    assert kc["fp"] >= 2
    dims = (*kc["fa"]["d1"].shape, kc["fa"]["g"].shape[-1],
            kc["iWT"].shape[0])
    picked = K.variant(*dims, 1)
    if case == "barcelona":
        assert picked["cluster"] > 1 and picked["prefix_cluster"] > 1
        assert all(picked["staged"].values()), picked
    single = K.apg_solve(kc, step, None, **kw)
    one = {k: v[None] for k, v in step.items()}
    for code in (ONE_BLOCK, K.encode(picked), 0x827, 0x457, 0x282):
        got = _instance(K.solve_as(kc, one, None, code=code, **kw), 0)
        _assert_same_solve(got, single)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["N152", "ns181"])
def test_apg_gate_edge_takes_the_exported_variant(cuda_device, edge):
    """A tree at the gate's edge (Barcelona widths, N = 152 or ns = 181)
    launches, takes the variant the export names, which is
    ``apg_solve.pick``'s for this card, and equals the one-block
    variant bit for bit."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    shape = (dict(branching=(5, 5), N=152) if edge == "N152" else
             dict(branching=(181,), N=4))
    fa, prefix, step, kw = _stream_problem(
        cuda_device, x0_scale=0.3, widths=(63, 114, 88, 17),
        max_iterations=2, **shape)
    kc = K.kernel_constants(fa, prefix_stages=prefix, max_iterations=2)
    dims = (*fa["d1"].shape, fa["g"].shape[-1], kc["iWT"].shape[0])
    assert K.fits(*dims) and K.smem(*dims) > 200 * 1024
    picked = K.variant(*dims, 1)
    assert picked == K.pick(*dims, 1, **_limits())
    got = K.apg_solve(kc, step, None, **kw)
    assert bool(torch.isfinite(got["u"]).all())
    one = {k: v[None] for k, v in step.items()}
    _assert_same_solve(_instance(K.solve_as(kc, one, None, code=ONE_BLOCK,
                                       **kw), 0), got)


@pytest.mark.cuda
def test_apg_variant_export_matches_the_pick_rule(cuda_device):
    """``apg_solve.variant`` (the source's pick on this card) equals
    ``apg_solve.pick`` (the rule written out) for single and batched
    launches over a range of trees."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    lim = _limits()
    for dims in [(24, 25, 63, 114, 97), (24, 181, 63, 114, 97),
                 (152, 25, 63, 114, 97), (8, 12, 4, 7, 5),
                 (6, 4, 4, 7, 5), (48, 40, 63, 114, 97)]:
        for B in (1, 2, 7, 32):
            assert K.variant(*dims, B) == K.pick(*dims, B, **lim), (dims, B)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 3])
def test_apg_instrumented_build_equals_the_plain_build(cuda_device, batch):
    """The clock64 build (apg_solve.CLOCK_DEFINES) adds barriers and
    nothing else: its outputs equal the plain build's bit for bit, and it
    reports cycles for the parts every phase runs."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    kc, step, kw = _variant_case(cuda_device, "barcelona", True)
    if batch:
        step = {k: torch.stack([v] * batch) for k, v in step.items()}
        plain = K.apg_solve_batch(kc, step, None, **kw)
    else:
        plain = K.apg_solve(kc, step, None, **kw)
    spans = K.phase_spans(kc, step, None, batch=batch, **kw)
    _assert_same_solve(spans["out"], plain)
    cycles = spans["cycles"]
    for part in ("tail.elementwise", "tail.L", "tail.BbT", "prefix.BbT",
                 "prefix.children", "forward.iW", "forward.LT",
                 "forward.BT", "forward.prox", "dual.update"):
        assert cycles[part] > 0, (part, cycles)


# stream_precision="default": the _bf16 entries of csrc/apg_stream.cu,
# csrc/stream_qn.cu and csrc/stream_sharded.cu (chip_smoke.py phases 23d-e
# and 35 hold them to their "default" plain versions)
@pytest.mark.cuda
def test_bf16_smem_formulas_match_the_sources(cuda_device):
    """The "default" gates (``smem``, ``fused_smem`` and ``staged_smem``
    of ``apg_stream``, ``smem`` of ``stream_qn``) equal the sources'
    ``_bf16`` formulas, and the "default" variants pick staged at config
    5's widths and unstaged at twice them."""
    import ctypes

    from rapidnet_tpu_torch.ops import apg_stream, build, stream_qn

    lib = build.load("apg_stream")
    fn = lib.apg_stream_bf16_staged_smem
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    for dims in [(24, 1024, 63, 114, 97), (24, 512, 63, 114, 97),
                 (8, 12, 126, 228, 194), (8, 12, 4, 7, 5)]:
        build.check_smem(lib, "apg_stream_bf16", dims,
                         apg_stream.smem(*dims, "default"))
        build.check_smem(lib, "apg_stream_fused_bf16", dims,
                         apg_stream.fused_smem(*dims, "default"))
        build.check_smem(build.load("stream_qn"), "stream_qn_bf16", dims,
                         stream_qn.smem(*dims, "default"))
        assert tuple(fn(*dims, k) for k in range(3)) == \
            apg_stream.staged_smem(*dims, "default"), dims
    for dims, want in (((24, 1024, 63, 114, 97), True),
                       ((8, 12, 126, 228, 194), False)):
        picked = apg_stream.staged(*dims, precision="default")
        assert picked["k1"] == picked["k2"] == want, picked
        picked = stream_qn.staged(*dims, precision="default")
        assert picked["s1"] == picked["s2"] == want, picked


@pytest.mark.cuda
@pytest.mark.parametrize("branching,N", [((3, 2, 2), 8), ((16, 16), 4)])
def test_bf16_fused_solve_equals_the_two_kernel_solve(cuda_device, branching,
                                                      N):
    """At "default" the fused kernel runs the same stage bodies as K1 and
    K2: its solve equals the two-kernel solve bit for bit and repeats
    itself, differs from the "highest" solve, and both count under their
    ``_bf16`` wrappers only."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    fa, prefix, step, kw = _stream_problem(cuda_device, branching=branching,
                                           N=N)
    kc = S.stream_constants(fa, prefix_stages=prefix, max_iterations=ITERS)
    before = (S.apg_stream.launches, S.apg_stream_fused.launches,
              S.apg_stream_bf16.launches, S.apg_stream_fused_bf16.launches)
    got = S.apg_stream_fused(kc, step, None, precision="default", **kw)
    ref = S.apg_stream(kc, step, None, precision="default", **kw)
    again = S.apg_stream_fused_bf16(kc, step, None, **kw)
    for out in (ref, again):
        for k in ("control", "u", "x", "v", "primal_infeasibility"):
            assert torch.equal(got[k], out[k]), k
    assert (S.apg_stream.launches, S.apg_stream_fused.launches,
            S.apg_stream_bf16.launches, S.apg_stream_fused_bf16.launches) \
        == (before[0], before[1], before[2] + 1, before[3] + 2)
    high = S.apg_stream(kc, step, None, **kw)
    assert not torch.equal(got["v"], high["v"])
