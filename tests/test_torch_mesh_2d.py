"""The port's 2-D (batch, scenario) mesh against the JAX package's.

``rapidnet_tpu_torch.parallel.make_mesh_2d`` and its batched solves
``make_sharded_apg_batch``, ``make_sharded_qn_batch`` and
``make_sharded_batch_shared``, and ``BatchedSmpcController(mesh=...)``,
on one module-scoped group of 4 gloo CPU ranks
(``tests/_torch_mesh.Ranks``, ``mesh_2d_job``) arranged (2, 2),
against JAX's ``BatchedSmpcController(mesh=make_mesh_2d(2, 2))`` on the
conftest's virtual host devices (which runs JAX's functions of those
names), and against the port's single-device batch.

The solves: the problem of tests/test_torch_sharded_plain.py (N 6,
branching [4, 2], nx 4, nu 7, seed 7, step 1e-3, the tanks at LOW_FILL of
their maximum, where FBE and NAMA track between two float32
implementations over 10 iterations), B = 4 instances from x0 * (1 + 0.02
N(0, 1)) (numpy seed 7, as bench.py:133-136), APG at 30 iterations, FBE
and NAMA at 10, buffer 5.  Bounds: APG control rtol/atol 1e-5, u 1e-4
(tests/test_pallas_apg.py:45-51); FBE and NAMA rtol 1e-3, atol 1e-4
(tests/test_pallas_qn.py:85-89); the QN traces at the JAX package's
bounds between two implementations (tests/test_pallas_qn.py:59-70), as
the sharded sums reorder the single device's.

The closed loops: tests/test_batch.py's problem (N 8, branching [2, 2],
seed 3), B = 4, 3 steps, APG at 30 iterations and FBE and NAMA at 6
(tests/test_batch.py:330-346), a shared forecaster and one per instance,
against JAX's ``BatchedSmpcController(mesh=make_mesh_2d(2, 2))`` at its
own bounds (tests/test_batch.py:189-192: controls rtol/atol 2e-4,
economic KPI rtol 1e-4).  The ranks' controls must be equal bit for bit.

JAX's sweeps run their stage recursions as a sequential scan, the branch
the port mirrors (``solve_step.SCAN_MIN_NS``, as
tests/test_torch_sharded_plain.py selects it).
"""

import numpy as np
import pytest
import torch

from tests import _torch_mesh as TM
from tests._torch_parity import to_numpy

torch.set_num_threads(2)

APG, FBE, NAMA = "proximalAlgorithm", "globalFbeAlgorithm", "namaAlgorithm"
ALGS = {"apg": APG, "fbe": FBE, "nama": NAMA}
PROBLEM = dict(nx=4, nu=7, nd=3, ne=2, N=6, branching=(4, 2), seed=7)
LOW_FILL = 0.1
B = 4
APG_ITERS, QN_ITERS, BUFFER = 30, 10, 5
LOOP_ITERS = {"apg": 30, "fbe": 6, "nama": 6}
LOOP_STEPS = 3
CASES = {f"{form}_{short}" if form == "shared" else short:
         (form, alg, dict(max_iterations=APG_ITERS if short == "apg"
                          else QN_ITERS))
         for form in ("stacked", "shared") for short, alg in ALGS.items()}
LOOPS = {f"{short}_{fc}": (alg, fc, LOOP_ITERS[short], False)
         for short, alg in ALGS.items() for fc in ("shared", "per_instance")}
LOOPS["apg_shared_warm"] = (APG, "shared", LOOP_ITERS["apg"], True)


@pytest.fixture(scope="module")
def problem():
    """The JAX side's factor arrays, the B instances' steps and their
    shared (base, inst), as numpy arrays, and the solver keywords."""
    from rapidnet_tpu.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import _factor_arrays, _step_arrays

    p = PROBLEM
    net = synthetic_network(nx=p["nx"], nu=p["nu"], nd=p["nd"], ne=p["ne"],
                            seed=p["seed"])
    tree = generate_tree(N=p["N"], branching=list(p["branching"]),
                         nd=p["nd"], nu=p["nu"], seed=p["seed"])
    fc = synthetic_forecaster(N=p["N"], nd=p["nd"], nu=p["nu"],
                              sim_horizon=4, seed=p["seed"])
    cfg = synthetic_config(net, tree, max_iterations=APG_ITERS,
                           step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    rng = np.random.default_rng(7)
    x0 = (LOW_FILL * net.xmax).astype(np.float32)
    x0s = (x0 * (1 + 0.02 * rng.standard_normal((B, x0.size)))
           ).astype(np.float32)
    prev_us = np.tile(cfg.prev_u, (B, 1)).astype(np.float32)
    prev_ds = np.tile(cfg.prev_demand, (B, 1)).astype(np.float32)
    steps = [to_numpy(_step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, x0s[b], prev_us[b],
        prev_ds[b]))) for b in range(B)]
    base, inst = eng.prepare_step_shared(fc.nominal_demand,
                                         fc.nominal_prices, x0s, prev_us,
                                         prev_ds)
    kw = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER))
    return dict(fa=to_numpy(_factor_arrays(eng)), steps=steps,
                base=to_numpy(base), inst=to_numpy(inst), kw=kw,
                prefix=eng.factor_step().prefix_stages)




@pytest.fixture(scope="module")
def started(problem):
    """The 4 ranks, started: they run while ``refs`` compiles JAX's."""
    cases = {name: (form, alg, dict(problem["kw"], **kw))
             for name, (form, alg, kw) in CASES.items()}
    handle = TM.Ranks(4, TM.mesh_2d_job, problem["fa"], problem["steps"],
                      problem["base"], problem["inst"], problem["prefix"],
                      cases, LOOPS, LOOP_STEPS)
    yield handle
    handle.stop()


@pytest.fixture(scope="module")
def refs(problem, started):
    """JAX's 2-D solves of CASES (``make_sharded_apg_batch``,
    ``make_sharded_qn_batch`` and ``make_sharded_batch_shared`` on a
    (2, 2) ``make_mesh_2d``, cold), and JAX's 2-D controllers' loops of
    LOOPS, the warm one too, with their last solves' outputs: one JAX
    compile each, its sweeps on their scan branch."""
    from rapidnet_tpu.parallel import (make_mesh_2d, make_sharded_apg_batch,
                                       make_sharded_batch_shared,
                                       make_sharded_qn_batch,
                                       shard_factor_arrays,
                                       shard_shared_step,
                                       shard_step_arrays_batch)
    from rapidnet_tpu.solver import solve_step as jss
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jss, "SCAN_MIN_NS", 1)
        mesh = make_mesh_2d(2, 2)
        fa = problem["fa"]
        steps = {k: np.stack([s[k] for s in problem["steps"]])
                 for k in problem["steps"][0]}
        args = {"stacked": (shard_step_arrays_batch(steps, mesh),),
                "shared": shard_shared_step(problem["base"],
                                            problem["inst"], mesh)}
        for name in CASES:
            form, alg, kw = _kw(problem, name)
            if alg != APG:
                kw = dict(kw, algorithm=alg, lbfgs_buffer_size=BUFFER)
            if form == "shared":
                run = make_sharded_batch_shared(
                    mesh, fa, problem["base"], problem["inst"], **kw)
            elif alg == APG:
                run = make_sharded_apg_batch(mesh, fa, problem["steps"][0],
                                             **kw)
            else:
                run = make_sharded_qn_batch(mesh, fa, problem["steps"][0],
                                            **kw)
            out[name] = to_numpy(run(shard_factor_arrays(fa, mesh),
                                     *args[form]))
        for name, (alg, forecasts, iterations, warm) in LOOPS.items():
            ctrl = TM.batched_controller("rapidnet_tpu", alg, forecasts,
                                         iterations, mesh=make_mesh_2d(2, 2),
                                         warm_start=warm)
            out[name] = ctrl.closed_loop(LOOP_STEPS)
            out[name]["last"] = to_numpy(ctrl._last)
    return out


@pytest.fixture(scope="module")
def ranks(started, refs):
    return started.wait()


def _kw(problem, name):
    form, alg, kw = CASES[name]
    return form, alg, dict(problem["kw"], prefix_stages=problem["prefix"],
                           **kw)


def _port_single(problem, name):
    """The port's single-device batch of the same case."""
    from rapidnet_tpu_torch.convert import (factor_tensors,
                                            shared_step_tensors,
                                            stacked_step_tensors)
    from rapidnet_tpu_torch.solver import apg
    from rapidnet_tpu_torch.solver import quasi_newton as qn
    form, alg, kw = _kw(problem, name)
    fa = factor_tensors(problem["fa"], "cpu")
    if alg == APG:
        make = (apg.make_apg_batch_shared if form == "shared"
                else apg.make_apg_batch)
    else:
        make = (qn.make_solver_batch_shared if form == "shared"
                else qn.make_solver_batch)
        kw = dict(kw, algorithm=alg, lbfgs_buffer_size=BUFFER)
    args = (shared_step_tensors(problem["base"], problem["inst"], "cpu")
            if form == "shared"
            else (stacked_step_tensors(problem["steps"], "cpu"),))
    return TM._np(make(**kw)(fa, *args))


def _hold(got, ref, alg, what, traces=None):
    """APG: control 1e-5, u, x and the trace 1e-4.  FBE/NAMA: control, u
    and the traces rtol 1e-3, atol 1e-4, or with ``traces`` the JAX
    package's bounds on the traces of two implementations
    (tests/test_pallas_qn.py:59-70)."""
    if alg == APG:
        np.testing.assert_allclose(got["control"], ref["control"],
                                   rtol=1e-5, atol=1e-5, err_msg=what)
        for k in ("u", "x", "primal_infeasibility"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what} {k}")
        return
    bounds = dict.fromkeys(("control", "u", "primal_infeasibility",
                            "value_fbe", "tau"), (1e-3, 1e-4))
    if traces:
        bounds.update(traces)
    for k, (rtol, atol) in bounds.items():
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


# tests/test_pallas_qn.py:59-70: tau, the FBE value and the infeasibility
# between two float32 implementations (the sharded sums reorder the
# single device's)
TRACE_BOUNDS = {"tau": (1e-4, 1e-6), "value_fbe": (2e-3, 2e-4),
                "primal_infeasibility": (2e-3, 1e-4)}


def test_mesh_2d_places_ranks_row_major(ranks):
    """Rank r at batch row r // 2, scenario column r % 2 (JAX's row-major
    ``reshape(n_batch, n_scen)``): ``scen`` is the row's mesh, ``batch``
    the column's."""
    for r, out in enumerate(ranks):
        rank, col, n_scen, row, n_batch, text = out["place"]
        assert (rank, col, n_scen, row, n_batch) == (r, r % 2, 2, r // 2, 2)
        assert "'batch': 2, 'scen': 2" in text


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_batch_matches_single_device(problem, ranks, name):
    """Each 2-D solve against the port's single-device batch (itself held
    to JAX's batches in tests/test_torch_batch.py and
    tests/test_torch_qn_batch.py; JAX's 2-D functions are held to in
    test_sharded_batch_matches_jax); every rank returns the
    global (B, ...) outputs, equal bit for bit across the ranks."""
    _, alg, _ = CASES[name]
    got = ranks[0][name]
    assert got["control"].shape == (B, PROBLEM["nu"])
    ns = int(np.prod(PROBLEM["branching"]))
    assert got["y"]["xi"].shape == (B, PROBLEM["N"], ns, 2 * PROBLEM["nx"])
    single = _port_single(problem, name)
    np.testing.assert_array_equal(got["iterations"], single["iterations"])
    _hold(got, single, alg, "against the single-device batch",
          traces=TRACE_BOUNDS)
    for r in ranks[1:]:
        for k in ("control", "u", "x"):
            assert np.array_equal(r[name][k], got[k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_batch_matches_jax(refs, ranks, name):
    """Each 2-D solve against JAX's function of its name on JAX's (2, 2)
    mesh of the same problem: the iterations equal, the APG or FBE/NAMA
    bounds on the control, u, x and the traces, and the APG duals y at
    the APG bounds of u."""
    _, alg, _ = CASES[name]
    got, ref = ranks[0][name], refs[name]
    np.testing.assert_array_equal(got["iterations"], ref["iterations"])
    _hold(got, ref, alg, "against JAX's 2-D solve")
    if alg == APG:
        for k in ("xi", "psi"):
            np.testing.assert_allclose(got["y"][k], ref["y"][k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"the duals {k}")


@pytest.mark.parametrize("name", list(LOOPS))
def test_batched_controller_mesh_matches_jax(refs, ranks, name):
    """``BatchedSmpcController(mesh=make_mesh_2d(2, 2))``: route 'plain',
    3 steps against JAX's 2-D controller (controls 2e-4, economic KPI
    rtol 1e-4), the ranks' controls bit for bit; ``_last`` kept, and the
    last step's 2-D solve (``make_sharded_batch_shared`` with a shared
    forecaster, else ``make_sharded_apg_batch`` or
    ``make_sharded_qn_batch``) held to JAX's function of that name in
    JAX's controller: the iterations equal, the APG or FBE/NAMA bounds on
    u, x and the traces (the QN traces at the JAX package's bounds
    between two implementations; the APG duals y at the APG bounds of
    u).  The warm loop carries the global duals: JAX's warm 2-D
    controller is its reference, and the port's single-device warm loop
    is held to it too, at the controls' and the KPI's bounds."""
    alg, forecasts, iterations, warm = LOOPS[name]
    got = ranks[0][name]
    assert got["route"] == "plain"
    assert got["controls"].shape == (LOOP_STEPS, B, PROBLEM["nu"])
    ref = refs[name]
    loops = {"the 2-D loop": (got["controls"], got["kpis"]["economicKpi"])}
    if warm:
        single = TM.batched_controller(
            "rapidnet_tpu_torch", alg, forecasts, iterations, device="cpu",
            warm_start=True).closed_loop(LOOP_STEPS)
        loops["the single-device loop"] = (single["controls"],
                                           single["economicKpi"])
    for what, (controls, kpi) in loops.items():
        np.testing.assert_allclose(controls, ref["controls"], rtol=2e-4,
                                   atol=2e-4, err_msg=what)
        np.testing.assert_allclose(kpi, ref["economicKpi"], rtol=1e-4,
                                   atol=1e-9, err_msg=what)
    np.testing.assert_array_equal(got["last"]["control"], got["controls"][-1])
    np.testing.assert_array_equal(got["last"]["iterations"],
                                  ref["last"]["iterations"])
    _hold(got["last"], ref["last"], alg, "the last 2-D solve",
          traces=TRACE_BOUNDS)
    if alg == APG:
        for k in ("xi", "psi"):
            np.testing.assert_allclose(got["last"]["y"][k],
                                       ref["last"]["y"][k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"the duals {k}")
    if warm:
        assert got["carry"]["xi"].shape == (B, 8, 4, 8)
        np.testing.assert_array_equal(got["carry"]["xi"],
                                      got["last"]["y"]["xi"])
    else:
        assert got["carry"] is None
    for r in ranks[1:]:
        assert np.array_equal(r[name]["controls"], got["controls"])
        assert r[name]["kpis"]["economicKpi"].tolist() == \
            got["kpis"]["economicKpi"].tolist()


def test_mesh_2d_refusals_on_the_ranks(ranks):
    """B = 3 on 2 batch rows and a 3 x 2 mesh of 4 ranks raise ValueError
    on every rank (before any collective)."""
    for r in ranks:
        kind, text = r["refusals"]["batch"]
        assert kind == "ValueError" and "B=3" in text
        kind, text = r["refusals"]["world"]
        assert kind == "ValueError" and "3x2" in text


def test_mesh_2d_refusals_in_process(problem):
    """Without ranks: a tree the scenario columns do not divide, a mesh
    that is not a ``Mesh2D``, ``backend='cuda'`` with a mesh, and
    ``make_mesh_2d`` of several ranks without a process group."""
    from rapidnet_tpu_torch.convert import (factor_tensors,
                                            stacked_step_tensors)
    from rapidnet_tpu_torch.parallel import (Mesh, Mesh2D, make_mesh_2d,
                                             make_sharded_apg_batch)
    _, _, kw = _kw(problem, "apg")
    fa = factor_tensors(problem["fa"], "cpu")
    st = stacked_step_tensors(problem["steps"], "cpu")
    with pytest.raises(ValueError, match="not divisible by 3"):
        make_sharded_apg_batch(Mesh2D(0, 1, 3, "cpu"), fa, st, **kw)
    with pytest.raises(TypeError, match="Mesh2D"):
        make_sharded_apg_batch(Mesh(0, 1, "cpu"), fa, st, **kw)
    with pytest.raises(ValueError, match="backend='cuda' with a mesh"):
        TM.batched_controller("rapidnet_tpu_torch", APG, "shared", 5,
                              device="cpu", backend="cuda",
                              mesh=Mesh2D(0, 1, 1, "cpu"))
    with pytest.raises(TypeError, match="Mesh2D"):
        TM.batched_controller("rapidnet_tpu_torch", APG, "shared", 5,
                              device="cpu", mesh=Mesh(0, 1, "cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh_2d(2, 2, devices=["cpu"] * 4)


@pytest.mark.parametrize("name", ["apg", "fbe", "shared_nama"])
def test_one_rank_mesh_2d_equals_single_device(problem, name):
    """``make_mesh_2d(1, 1)`` needs no process group, and its solves are
    the single-device batch's bit for bit."""
    from rapidnet_tpu_torch.convert import (factor_tensors,
                                            shared_step_tensors,
                                            stacked_step_tensors)
    from rapidnet_tpu_torch.parallel import (make_mesh_2d,
                                             make_sharded_apg_batch,
                                             make_sharded_batch_shared,
                                             make_sharded_qn_batch,
                                             shard_factor_arrays)
    form, alg, kw = _kw(problem, name)
    mesh = make_mesh_2d(1, 1, devices=["cpu"])
    fa = factor_tensors(problem["fa"], "cpu")
    fa_l = shard_factor_arrays(fa, mesh)
    if form == "shared":
        args = shared_step_tensors(problem["base"], problem["inst"], "cpu")
        got = make_sharded_batch_shared(mesh, fa, args[0], algorithm=alg,
                                        lbfgs_buffer_size=BUFFER,
                                        **kw)(fa_l, *args)
    else:
        st = stacked_step_tensors(problem["steps"], "cpu")
        if alg == APG:
            got = make_sharded_apg_batch(mesh, fa, st, **kw)(fa_l, st)
        else:
            got = make_sharded_qn_batch(mesh, fa, st, algorithm=alg,
                                        lbfgs_buffer_size=BUFFER,
                                        **kw)(fa_l, st)
    ref = _port_single(problem, name)
    for k, v in TM._np(got).items():
        if k == "y":
            for part in ("xi", "psi"):
                assert np.array_equal(v[part], ref["y"][part]), part
        else:
            assert np.array_equal(v, ref[k]), k
