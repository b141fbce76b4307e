"""The port's plain scenario-sharded solves against the JAX package's.

``rapidnet_tpu_torch.parallel.make_sharded_apg`` and
``make_sharded_quasi_newton`` (the ``mesh=`` argument of
``solver/solve_step.py``, ``solver/apg.py`` and
``solver/quasi_newton.py``) on one module-scoped group of 4 gloo CPU ranks
(``tests/_torch_mesh.run_ranks``), against JAX's shard_map solves on a
4-device virtual mesh (the conftest sets 8 host devices).  Problem: the
controller tests' tree (N 6, branching [4, 2], nx 4, nu 7, seed 7, step
1e-3) with the tanks at LOW_FILL of their maximum: from the nominal state
the FBE/NAMA residual magnitude never falls below its first value within
40 iterations, from there it does within 10.

Cases: APG at a 30-iteration budget and under a tolerance, FBE and NAMA
at 10 iterations and under a tolerance.  Each tolerance is the one the
port's single-device magnitudes give the widest margin around its exit
(``quasi_newton.exit_tolerances``).  Bounds: APG control rtol/atol 1e-5,
u, x and the trace 1e-4 (tests/test_pallas_apg.py:45-51); FBE and NAMA
rtol 1e-3, atol 1e-4 (tests/test_pallas_qn.py:85-89).  The iterations
must be equal and the ranks' controls equal bit for bit.  On a mesh of
one rank (in this process) every output equals the single-device
solve's bit for bit.

The JAX sweeps run their stage recursions as a sequential scan, the
branch the port mirrors (``solve_step.SCAN_MIN_NS``, as
tests/test_torch_quasi_newton.py selects it): JAX's default at a few
slots, a stage-axis cumsum, sums in another order, and the FBE trace
parts from it by ~3e-3 within 10 iterations at this state.

Also ``make_apg(trace_control=True)`` against the JAX one, single
device, and the mesh controller's gate in this process: 'auto' takes the
plain route when the sharded streaming pack raises ``NotStreamable``,
and any other ValueError of the streaming wrapper raises.
"""

import numpy as np
import pytest
import torch

from tests import _torch_mesh as TM
from tests._torch_parity import jax_problem, port_inputs, to_numpy

torch.set_num_threads(2)

APG, FBE, NAMA = "proximalAlgorithm", "globalFbeAlgorithm", "namaAlgorithm"
PROBLEM = dict(nx=4, nu=7, nd=3, ne=2, N=6, branching=(4, 2), seed=7)
LOW_FILL = 0.1
APG_ITERS, QN_ITERS, BUFFER = 30, 10, 5
KEYS = ("control", "x", "u", "primal_infeasibility")
QN_KEYS = KEYS + ("value_fbe", "tau")


@pytest.fixture(autouse=True)
def _jax_sequential_sweeps(monkeypatch):
    from rapidnet_tpu.solver import solve_step as jss
    monkeypatch.setattr(jss, "SCAN_MIN_NS", 1)


def apg_magnitudes(fa, step, kw, iterations):
    """The residual magnitude (the stopping rule) after each iteration of
    the port's single-device APG solve."""
    from rapidnet_tpu_torch.solver import apg
    from rapidnet_tpu_torch.solver import solve_step as ss
    okw = {k: kw[k] for k in ("inv_step", "step_size", "penalty_state",
                              "penalty_safety", "xs_upper")}
    lams = apg.nesterov_lambdas(iterations)
    y = {"xi": torch.zeros_like(fa["d1"]).repeat(1, 1, 2),
         "psi": torch.zeros_like(fa["g"])}
    z = {k: torch.zeros_like(v) for k, v in y.items()}
    mags = []
    for it in range(iterations):
        lam = float(lams[it])
        o = apg.apg_oracle(fa, step, y["xi"] + lam * z["xi"],
                           y["psi"] + lam * z["psi"],
                           prefix_stages=kw["prefix_stages"], **okw)
        mags.append(float(ss.max_abs_residual(o["res_xi"], o["res_psi"])))
        new = {"xi": o["y_xi"], "psi": o["y_psi"]}
        z = {k: new[k] - y[k] for k in y}
        y = new
    return mags


def widest_exit(mags, last):
    from rapidnet_tpu_torch.solver.quasi_newton import exit_tolerances
    exits = exit_tolerances(mags, last)
    assert exits, "no tolerance exit within the budget"
    return exits[0][0]


@pytest.fixture(scope="module")
def problem():
    """The JAX problem, its port tensors, and every case's keywords."""
    from rapidnet_tpu_torch.solver import quasi_newton as qn
    eng, fa, step, kw = jax_problem(**PROBLEM, step_size=1e-3,
                                    x0_scale=LOW_FILL)
    prefix = eng.factor_step().prefix_stages
    fa_t, step_t = port_inputs(fa, step)
    kw = dict(kw, prefix_stages=prefix)
    apg_kw = dict(kw, max_iterations=APG_ITERS)
    qn_kw = dict(kw, max_iterations=QN_ITERS)
    cases = {"apg": (APG, apg_kw),
             "apg_tol": (APG, dict(apg_kw, tolerance=widest_exit(
                 apg_magnitudes(fa_t, step_t, apg_kw, APG_ITERS),
                 APG_ITERS)))}
    for name, alg in (("fbe", FBE), ("nama", NAMA)):
        mags = qn.make_solver(algorithm=alg, lbfgs_buffer_size=BUFFER,
                              trace_magnitude=True, **qn_kw)(
            fa_t, step_t)["residual_magnitude"].numpy()
        cases[name] = (alg, qn_kw)
        cases[f"{name}_tol"] = (alg, dict(qn_kw, tolerance=widest_exit(
            mags, QN_ITERS)))
    return dict(fa=fa, step=step, prefix=prefix, fa_t=fa_t, step_t=step_t,
                cases=cases)


@pytest.fixture(scope="module")
def ranks(problem):
    cases = {name: (alg, {k: v for k, v in kw.items()
                          if k != "prefix_stages"})
             for name, (alg, kw) in problem["cases"].items()}
    return TM.run_ranks(4, TM.sharded_plain_job, to_numpy(problem["fa"]),
                        to_numpy(problem["step"]), problem["prefix"], cases)


def _jax_sharded(problem, name):
    from rapidnet_tpu.parallel import (make_mesh, make_sharded_apg,
                                       make_sharded_quasi_newton,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    alg, kw = problem["cases"][name]
    mesh = make_mesh(4)
    fa, step = problem["fa"], problem["step"]
    if alg == APG:
        run = make_sharded_apg(mesh, fa, step, **kw)
    else:
        run = make_sharded_quasi_newton(mesh, fa, step, algorithm=alg,
                                        lbfgs_buffer_size=BUFFER, **kw)
    return to_numpy(run(shard_factor_arrays(fa, mesh),
                        shard_step_arrays(step, mesh)))


@pytest.mark.parametrize("name", ["apg", "apg_tol", "fbe", "fbe_tol",
                                  "nama", "nama_tol"])
def test_sharded_plain_matches_jax(problem, ranks, name):
    ref = _jax_sharded(problem, name)
    got = ranks[0][name]
    assert int(got["iterations"]) == int(ref["iterations"])
    if name.endswith("_tol"):
        limit = APG_ITERS if name.startswith("apg") else QN_ITERS
        assert int(got["iterations"]) < limit, "no tolerance exit"
    if name.startswith("apg"):
        np.testing.assert_allclose(got["control"], ref["control"],
                                   rtol=1e-5, atol=1e-5)
        for k in KEYS[1:]:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    else:
        for k in QN_KEYS:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-3,
                                       atol=1e-4, err_msg=k)
    for r in ranks[1:]:
        assert np.array_equal(r[name]["control"], got["control"])
        assert np.array_equal(r[name]["u"], got["u"])


@pytest.mark.parametrize("name", ["apg", "apg_tol", "fbe", "nama_tol"])
def test_one_rank_mesh_equals_single_device(problem, name):
    """``mesh=`` on a mesh of one rank (``Mesh(0, 1, "cpu")``, no process
    group: its collectives are local copies) against ``mesh=None``: every
    output bit for bit."""
    from rapidnet_tpu_torch.parallel import (Mesh, make_sharded_apg,
                                             make_sharded_quasi_newton,
                                             shard_factor_arrays)
    from rapidnet_tpu_torch.solver import apg
    from rapidnet_tpu_torch.solver import quasi_newton as qn
    alg, kw = problem["cases"][name]
    fa, step = problem["fa_t"], problem["step_t"]
    if alg == APG:
        ref = apg.make_apg(**kw)(fa, step)
    else:
        ref = qn.make_solver(algorithm=alg, lbfgs_buffer_size=BUFFER,
                             **kw)(fa, step)
    mesh = Mesh(0, 1, "cpu")
    if alg == APG:
        run = make_sharded_apg(mesh, fa, step, **kw)
    else:
        run = make_sharded_quasi_newton(mesh, fa, step, algorithm=alg,
                                        lbfgs_buffer_size=BUFFER, **kw)
    got = run(shard_factor_arrays(fa, mesh), step)
    for k in set(got) - {"y"}:
        assert torch.equal(got[k], ref[k]), k
    for k in ("xi", "psi"):
        assert torch.equal(got["y"][k], ref["y"][k]), k


def test_sharded_refuses_an_undivided_tree(problem):
    """8 slots on 3 ranks: ValueError, as ``Mesh.slots`` raises (no
    collective runs)."""
    from rapidnet_tpu_torch.parallel import Mesh, make_sharded_apg
    _, kw = problem["cases"]["apg"]
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_apg(Mesh(0, 3, "cpu"), problem["fa_t"],
                         problem["step_t"], **kw)


@pytest.mark.parametrize("tolerance", [False, True])
def test_make_apg_trace_control_matches_jax(problem, tolerance):
    """``control_trace``: the unprojected stage-0 u after each iteration,
    (max_iterations, nu), against JAX's ``make_apg(trace_control=True)``
    at the APG bounds (tests/test_pallas_apg.py:45-51).  JAX traces the
    fixed budget only; under a tolerance the port's rows up to the exit
    are held to JAX's fixed-budget trace and the rest are zero."""
    import jax
    from rapidnet_tpu.solver import apg as japg
    from rapidnet_tpu_torch.solver import apg
    _, kw = problem["cases"]["apg_tol" if tolerance else "apg"]
    ref = jax.jit(japg.make_apg(**dict(kw, tolerance=None),
                                trace_control=True))(problem["fa"],
                                                     problem["step"])
    ref_trace = np.asarray(ref["control_trace"])
    got = apg.make_apg(trace_control=True, **kw)(problem["fa_t"],
                                                 problem["step_t"])
    trace = got["control_trace"].numpy()
    assert trace.shape == (APG_ITERS, PROBLEM["nu"])
    n = int(got["iterations"])
    np.testing.assert_allclose(trace[:n], ref_trace[:n], rtol=1e-5,
                               atol=1e-5)
    assert not trace[n:].any()
    np.testing.assert_array_equal(trace[n - 1], got["u"][0, 0].numpy())
    if tolerance:
        assert n < APG_ITERS
    else:
        np.testing.assert_allclose(got["control"], ref["control"],
                                   rtol=1e-5, atol=1e-5)


def _mesh_controller(algorithm, mesh, backend="auto"):
    """``SmpcController(mesh=...)`` on the problem of
    ``TM.controller_job`` (tree [4, 2], N 6, seed 7), 3 iterations."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=6, branching=[4, 2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=7)
    cfg = synthetic_config(net, tree, max_iterations=3, step_size=1e-3)
    cfg.algorithm = algorithm
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend=backend, device="cpu", mesh=mesh)


@pytest.mark.parametrize("algorithm", [APG, FBE])
def test_controller_mesh_auto_falls_back_on_not_streamable(monkeypatch,
                                                           algorithm):
    """'auto' on a mesh that asks for the sharded streaming solve
    (``_auto_streams`` forced, as on a CUDA mesh past the whole-solve
    kernel's limits) with a tree the sharded pack refuses (one rank: no
    stage crosses shards, ``NotStreamable``): route 'plain', the
    refusal in ``route_reason``, and the solve equals ``backend="torch"``
    on the same mesh bit for bit."""
    from rapidnet_tpu_torch.parallel import Mesh
    from rapidnet_tpu_torch.solver.controller import SmpcController
    monkeypatch.setattr(SmpcController, "_auto_streams", lambda self: True)
    ctrl = _mesh_controller(algorithm, Mesh(0, 1, "cpu"))
    ctrl.initialise()
    assert ctrl.route == "plain"
    assert "single-shard" in ctrl.route_reason
    ref = _mesh_controller(algorithm, Mesh(0, 1, "cpu"), "torch")
    assert np.array_equal(ctrl.control_action(0), ref.control_action(0))


@pytest.mark.parametrize("algorithm", [APG, FBE])
def test_controller_mesh_auto_raises_a_wrapper_error(monkeypatch,
                                                     algorithm):
    """A ValueError of the sharded streaming wrapper itself (here its
    device check, planted) raises out of ``initialise`` with 'auto':
    only the pack's ``NotStreamable`` sends the controller to the plain
    solve."""
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    from rapidnet_tpu_torch.parallel import Mesh
    from rapidnet_tpu_torch.solver.controller import SmpcController

    def planted(mesh, fa):
        raise ValueError("planted wrapper fault")

    monkeypatch.setattr(SmpcController, "_auto_streams", lambda self: True)
    monkeypatch.setattr(SS, "pack_stream_sharded", lambda *a, **k: {})
    monkeypatch.setattr(SS, "check_mesh", planted)
    ctrl = _mesh_controller(algorithm, Mesh(0, 1, "cpu"))
    with pytest.raises(ValueError, match="planted wrapper fault"):
        ctrl.initialise()
