"""The batched slice: the port's batched solves and controller against JAX's.

The problem and batch are the JAX batch tests' (tests/test_batch.py):
nx=4, nu=7, nd=3, ne=2, N=8, branching [2, 2], B = 3 instances, 30 APG
iterations.  Inputs are made from seeds with numpy and reach the port
through ``rapidnet_tpu_torch.convert``.  Tolerances, with their sources:

* batch inputs: the same NumPy code in both packages, atol 1e-7;
* batched solve against JAX's XLA and interpret-mode Pallas batches:
  control rtol/atol 1e-5, u 1e-4, x atol 1e-3 (tests/test_pallas_apg.py:
  45-51, the first slice's kernel test);
* batched against single: rtol 1e-6, atol 1e-6 (tests/test_batch.py:
  74-76);
* the closed loop: controls rtol 1e-4 with atol 1e-4 * max(|u|, 1), the
  KPIs rtol 1e-4 (tests/test_torch_controller.py).

The batched CUDA kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, to_numpy

torch.set_num_threads(2)

B = 3
ITERS = 30
STEPS = 3
EXACT = dict(rtol=0, atol=1e-7)


def _models(pkg):
    import importlib
    return {k: importlib.import_module(f"{pkg}.model.{k}")
            for k in ("network", "scenario_tree", "forecaster", "config")}


def _build(pkg, forecaster_seed=3):
    """network, tree, forecaster, config from either package's
    generators (tests/test_batch.py's problem)."""
    m = _models(pkg)
    net = m["network"].synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=3)
    tree = m["scenario_tree"].generate_tree(N=8, branching=[2, 2], nd=3,
                                            nu=7, seed=3)
    fc = m["forecaster"].synthetic_forecaster(N=8, nd=3, nu=7,
                                              sim_horizon=6,
                                              seed=forecaster_seed)
    cfg = m["config"].synthetic_config(net, tree, max_iterations=ITERS,
                                       step_size=1e-3)
    return net, tree, fc, cfg


def _forecaster(pkg, seed):
    return _models(pkg)["forecaster"].synthetic_forecaster(
        N=8, nd=3, nu=7, sim_horizon=6, seed=seed)


@pytest.fixture(scope="module")
def problem():
    """The JAX side's factor arrays, per-instance steps and shared
    (base, inst), and the batch's states, all as numpy arrays."""
    from rapidnet_tpu.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu.solver.controller import _factor_arrays, _step_arrays

    net, tree, fc, cfg = _build("rapidnet_tpu")
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    rng = np.random.default_rng(17)
    x0s = (cfg.current_x * (0.9 + 0.2 * rng.random((B, cfg.current_x.size)))
           ).astype(np.float32)
    prev_us = (np.tile(cfg.prev_u, (B, 1)) *
               (0.95 + 0.1 * rng.random((B, cfg.prev_u.size)))
               ).astype(np.float32)
    prev_ds = (np.tile(cfg.prev_demand, (B, 1)) *
               (0.95 + 0.1 * rng.random((B, cfg.prev_demand.size)))
               ).astype(np.float32)
    steps = [to_numpy(_step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, x0s[b], prev_us[b],
        prev_ds[b]))) for b in range(B)]
    base, inst = eng.prepare_step_shared(
        fc.nominal_demand, fc.nominal_prices, x0s, prev_us, prev_ds)
    kw = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety,
              xs_upper=float(XS_UPPER), max_iterations=ITERS)
    return dict(fa=to_numpy(_factor_arrays(eng)), steps=steps, base=base,
                inst=inst, x0s=x0s, prev_us=prev_us, prev_ds=prev_ds, kw=kw,
                prefix=eng.factor_step().prefix_stages)


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


def _port_plain(form, **kw):
    from rapidnet_tpu_torch.solver import apg
    return (apg.make_apg_batch if form == "stacked"
            else apg.make_apg_batch_shared)(**kw)


def _jax_stacked(problem):
    return {k: jnp.stack([s[k] for s in problem["steps"]])
            for k in problem["steps"][0]}


@pytest.mark.parametrize("form", ["shared", "batch"])
def test_batch_inputs_match_jax(problem, form):
    """The port's prepare_step_shared / prepare_step_batch equal JAX's
    array by array (the same NumPy code on the same inputs)."""
    from rapidnet_tpu.engine.engine import Engine as JEngine
    from rapidnet_tpu_torch.engine.engine import Engine as TEngine

    outs = []
    for pkg, engine in (("rapidnet_tpu", JEngine),
                        ("rapidnet_tpu_torch", TEngine)):
        net, tree, fc, cfg = _build(pkg)
        eng = engine(net, tree, cfg)
        fc.predict_demand(0)
        fc.predict_prices(0)
        args = (fc.nominal_demand, fc.nominal_prices, problem["x0s"],
                problem["prev_us"], problem["prev_ds"])
        if form == "shared":
            base, inst = eng.prepare_step_shared(*args)
            outs.append({**{f"base.{k}": v for k, v in base.items()},
                         **{f"inst.{k}": v for k, v in inst.items()}})
        else:
            outs.append(eng.prepare_step_batch(*args))
    ref, got = outs
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **EXACT)


@pytest.mark.parametrize("form", ["stacked", "shared"])
def test_batched_plain_matches_jax(problem, form):
    """The port's plain batched solve against JAX's jitted make_apg_batch
    and the interpret-mode Pallas batch; the kernel's wrapper on the CPU
    runs that plain solve, bit for bit."""
    from rapidnet_tpu.ops import pallas_apg
    from rapidnet_tpu.solver import apg as japg
    from rapidnet_tpu_torch.ops import apg_solve as K

    kw, prefix = problem["kw"], problem["prefix"]
    fa_j = problem["fa"]
    if form == "stacked":
        jargs = (_jax_stacked(problem),)
        xla = jax.jit(japg.make_apg_batch(prefix_stages=prefix, **kw))(
            fa_j, *jargs)
        pallas = pallas_apg.make_apg_pallas_batch(
            fa_j, interpret=True, **kw)(*jargs)
        make_kernel = K.make_apg_kernel_batch
    else:
        jargs = (problem["base"], problem["inst"])
        xla = jax.jit(japg.make_apg_batch_shared(prefix_stages=prefix,
                                                 **kw))(fa_j, *jargs)
        pallas = pallas_apg.make_apg_pallas_batch_shared(
            fa_j, interpret=True, **kw)(*jargs)
        make_kernel = K.make_apg_kernel_batch_shared
    fa, args = _port_args(problem, form)
    got = _port_plain(form, prefix_stages=prefix, **kw)(fa, *args)
    assert got["iterations"].tolist() == [ITERS] * B
    for ref in (xla, pallas):
        assert_close(got["control"], ref["control"], rtol=1e-5, atol=1e-5)
        assert_close(got["u"], ref["u"], rtol=1e-4, atol=1e-4)
        assert_close(got["x"], ref["x"], rtol=1e-4, atol=1e-3)
    for k in ("xi", "psi"):
        yref = np.asarray(xla["y"][k])
        assert_close(got["y"][k], yref, rtol=1e-4,
                     atol=1e-4 * max(np.abs(yref).max(), 1.0))

    wrapped = make_kernel(fa, prefix_stages=prefix, **kw)(*args)
    for k in ("control", "u", "x", "primal_infeasibility", "iterations"):
        assert torch.equal(wrapped[k], got[k]), k


@pytest.mark.parametrize("form", ["stacked", "shared"])
def test_batched_matches_single(problem, form):
    """Each instance of the port's batched solve agrees with the port's
    single solve of that instance's step."""
    from rapidnet_tpu_torch.solver import apg

    kw = dict(problem["kw"], prefix_stages=problem["prefix"])
    fa, args = _port_args(problem, form)
    got = _port_plain(form, **kw)(fa, *args)
    steps = (args[0] if form == "stacked"
             else apg.expand_shared_step(args[0], **args[1]))
    single = apg.make_apg(**kw)
    for b in range(B):
        ref = single(fa, {k: v[b] for k, v in steps.items()})
        for k in ("control", "u", "x", "primal_infeasibility"):
            assert_close(got[k][b], ref[k], rtol=1e-6, atol=1e-6)


def test_tolerance_exits_per_instance(problem):
    """Under a tolerance each instance stops at JAX's iteration for it
    (a vmap of the while_loop) and its trace is zero past its exit."""
    from rapidnet_tpu.solver import apg as japg

    kw, prefix = problem["kw"], problem["prefix"]
    fa, (steps,) = _port_args(problem, "stacked")
    # a tolerance that the instances cross mid-budget, found on the
    # port's side, which compiles nothing
    for tol in np.geomspace(1e4, 1e-3, 43):
        got = _port_plain("stacked", prefix_stages=prefix,
                          tolerance=float(tol), **kw)(fa, steps)
        its = got["iterations"].tolist()
        if all(1 < it < ITERS for it in its):
            break
    else:
        pytest.fail("no tolerance gave mid-budget exits")
    ref = jax.jit(japg.make_apg_batch(prefix_stages=prefix,
                                      tolerance=float(tol), **kw))(
        problem["fa"], _jax_stacked(problem))
    assert its == np.asarray(ref["iterations"]).tolist()
    trace = got["primal_infeasibility"].numpy()
    for b, it in enumerate(its):
        assert (trace[b, it:] == 0).all()
    assert_close(got["control"], ref["control"], rtol=1e-5, atol=1e-5)
    assert_close(trace, ref["primal_infeasibility"], rtol=1e-4, atol=1e-3)


def _controllers(forecasts, **kw):
    """The JAX (backend='xla') and port (device='cpu') batched
    controllers on the same problem and states."""
    from rapidnet_tpu.solver.batch import BatchedSmpcController as JB
    from rapidnet_tpu_torch import BatchedSmpcController as TB

    out = []
    for pkg, cls, extra in (("rapidnet_tpu", JB, dict(backend="xla")),
                            ("rapidnet_tpu_torch", TB,
                             dict(device="cpu"))):
        net, tree, fc, cfg = _build(pkg)
        if forecasts == "per_instance":
            fc = [_forecaster(pkg, seed=3 + b) for b in range(B)]
        x0s = (cfg.current_x * np.linspace(0.9, 1.1, B)[:, None]
               ).astype(np.float32)
        out.append(cls(cfg, net, tree, fc, x0s, **extra, **kw))
    return out


@pytest.mark.parametrize("forecasts", ["shared", "per_instance"])
def test_batched_controller_matches_jax(forecasts):
    jctrl, tctrl = _controllers(forecasts)
    assert tctrl._shared_forecast == (forecasts == "shared")
    ref = jctrl.closed_loop(STEPS)
    got = tctrl.closed_loop(STEPS)
    assert sorted(got) == sorted(ref)
    assert got["controls"].shape == (STEPS, B, 7)
    for t in range(STEPS):
        np.testing.assert_allclose(
            got["controls"][t], ref["controls"][t], rtol=1e-4,
            atol=1e-4 * max(np.abs(ref["controls"][t]).max(), 1.0))
    for k in ("economicKpi", "smoothKpi", "safetyKpi", "networkKpi"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert len(got["solve_times_ms"]) == STEPS


def test_batched_controller_warm_start_runs():
    _, tctrl = _controllers("shared", warm_start=True)
    log = tctrl.closed_loop(2)
    assert log["controls"].shape == (2, B, 7)
    assert np.isfinite(log["controls"]).all()
    assert tctrl._y_carry["xi"].shape[0] == B


def test_batched_backends_agree_on_cpu():
    """'auto' on the CPU takes the batched kernel wrapper's plain
    version, which is the 'torch' backend's solve: the same numbers."""
    from rapidnet_tpu_torch import BatchedSmpcController

    logs = []
    for backend in ("auto", "torch"):
        net, tree, fc, cfg = _build("rapidnet_tpu_torch")
        x0s = np.tile(cfg.current_x, (B, 1))
        logs.append(BatchedSmpcController(
            cfg, net, tree, fc, x0s, backend=backend,
            device="cpu").closed_loop(2))
    np.testing.assert_array_equal(logs[0]["controls"], logs[1]["controls"])


def test_batched_controller_requests_raise():
    """No silent fallback: unknown or impossible requests raise (a mesh
    that is not a ``parallel.Mesh2D`` too; tests/test_torch_mesh_2d.py
    has the 2-D mesh's own refusals)."""
    from rapidnet_tpu_torch import BatchedSmpcController
    from rapidnet_tpu_torch.model.config import (ALGORITHM_FBE,
                                                 ALGORITHM_NAMA)

    net, tree, fc, cfg = _build("rapidnet_tpu_torch")
    x0s = np.tile(cfg.current_x, (B, 1))
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="backend='cuda'"):
        BatchedSmpcController(cfg, net, tree, fc, x0s, backend="cuda", **kw)
    with pytest.raises(ValueError, match="unknown backend"):
        BatchedSmpcController(cfg, net, tree, fc, x0s, backend="xla", **kw)
    with pytest.raises(TypeError, match="Mesh2D"):
        BatchedSmpcController(cfg, net, tree, fc, x0s, mesh=object(), **kw)
    for algorithm in (ALGORITHM_FBE, ALGORITHM_NAMA):
        qn = copy.deepcopy(cfg)
        qn.algorithm = algorithm
        # FBE and NAMA are ported (tests/test_torch_qn_batch.py)
        ctrl = BatchedSmpcController(qn, net, tree, fc, x0s, **kw)
        assert ctrl.config.algorithm == algorithm
    bad = copy.deepcopy(cfg)
    bad.algorithm = "noSuchAlgorithm"
    with pytest.raises(ValueError, match="unknown algorithm"):
        BatchedSmpcController(bad, net, tree, fc, x0s, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            BatchedSmpcController(cfg, net, tree, fc, x0s)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            BatchedSmpcController(cfg, net, tree, fc, x0s, backend="cuda",
                                  device="cuda")


def test_batch_wrapper_rejects_inputs_the_kernel_does_not_take(problem):
    from rapidnet_tpu_torch.ops import apg_solve as K

    kw = problem["kw"]
    fa, (steps,) = _port_args(problem, "stacked")
    kc = K.kernel_constants(fa, prefix_stages=problem["prefix"],
                            max_iterations=ITERS)
    wide = torch.stack([steps["uhat"]] * 2, dim=1).reshape(
        B * 2, *steps["uhat"].shape[1:])
    bad = {
        # another batch stride than one instance after another, or 0
        "batch stride": dict(steps, uhat=wide[::2]),
        # beta is per instance: no batch stride 0
        "not contiguous": dict(steps, beta=steps["beta"][:1].expand(
            B, *steps["beta"].shape[1:])),
        "an instance is not contiguous": dict(
            steps, e=steps["e"].transpose(1, 2).contiguous()
            .transpose(1, 2)),
        "shape": dict(steps, x0=steps["x0"][:, :2]),
        "dtype": dict(steps, prev_u=steps["prev_u"].double()),
        "meta": {k: v.to("meta") for k, v in steps.items()},
    }
    for match, b in bad.items():
        with pytest.raises(ValueError, match=match):
            K.apg_solve_batch(kc, b, None, **kw)
    with pytest.raises(ValueError, match="shape"):
        K.apg_solve_batch(kc, steps, {"xi": torch.zeros(B, 1),
                                      "psi": torch.zeros(B, 1)}, **kw)
    if not torch.cuda.is_available():
        # a CUDA request without a GPU raises; nothing runs on the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            K.apg_solve_batch(kc, {k: v.to("cuda") for k, v in
                                   steps.items()}, None, **kw)
