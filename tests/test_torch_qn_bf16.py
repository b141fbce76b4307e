"""The bf16 L-BFGS history of the whole-solve FBE/NAMA kernel
(rapidnet_tpu_torch/ops/qn_solve.py, ``lbfgs_dtype="bfloat16"``).

On the CPU the wrapper runs its plain version, ``quasi_newton.make_solver``
with each curvature pair rounded to bf16 before its dots (the kernel's
order, ``pallas_qn.py:335-340``).  It is held to the JAX package's
whole-solve kernel with ``lbfgs_dtype=jnp.bfloat16`` in interpret mode on
the JAX QN tests' problem (tests/test_pallas_qn.py:33-56, 15 iterations,
buffer 5) at a step size of 1e-3, where tests/test_torch_qn_solve.py
holds the float32 history (its docstring says why not 1e-4).  The line
search branches on value comparisons, so two float32 implementations
part once one of them picks another trial, and a bf16 history turns
their last-bit differences into whole bf16 steps (2^-8 relative) of a
stored pair.  So the traces must hold the JAX package's bounds between
two implementations (tests/test_pallas_qn.py:59-70: the same tau picked,
the value and the infeasibility close) over at least TRACK leading
iterations, the JAX tests' horizon (7 FBE and 8 NAMA here); the controls
of TRACK-iteration solves hold rtol 1e-3 / atol 1e-4 (:85-89), and of
the 15-iteration solves 0.1 * max(|u|, 1), the JAX test's bound between
a bf16 and a float32 history (:361-362).  Against the port's float32
history that test's own rules (:346-366): the first iteration's
infeasibility equal at rtol 1e-6 and the control within 0.1 * max(|u|,
1).  The CUDA kernel is
held to this plain version on the card (chip_smoke.py phase 29).
"""

import numpy as np
import pytest
import torch

from tests._torch_parity import SMALL, assert_close, jax_problem, port_inputs

torch.set_num_threads(2)

ALGORITHMS = ["globalFbeAlgorithm", "namaAlgorithm"]
ITERS = 15          # tests/test_pallas_qn.py:353
TRACK = 4           # tests/test_pallas_qn.py:28-30
BS = 5


def _problem(max_iterations=ITERS):
    eng, fa, step, kw = jax_problem(**SMALL, step_size=1e-3,
                                    max_iterations=max_iterations)
    return eng, fa, step, dict(kw, lbfgs_buffer_size=BS)


def _port(fa, step, eng):
    from rapidnet_tpu_torch.ops import qn_solve as Q
    fa_t, step_t = port_inputs(fa, step)
    return Q.kernel_constants(fa_t, prefix_stages=eng.factor_step()
                              .prefix_stages), fa_t, step_t


def _jax_bf16(fa, step, kw, algorithm):
    import jax.numpy as jnp
    from rapidnet_tpu.ops import pallas_qn
    return pallas_qn.make_qn_pallas(fa, algorithm=algorithm, interpret=True,
                                    lbfgs_dtype=jnp.bfloat16, **kw)(step)


def _trace_parity(got, ref, n):
    """tests/test_pallas_qn.py:59-70 over the first n iterations."""
    vscale = max(float(np.abs(np.asarray(ref["value_fbe"])).max()), 1.0)
    assert_close(got["tau"][:n], np.asarray(ref["tau"])[:n],
                 rtol=1e-4, atol=1e-6)
    assert_close(got["value_fbe"][:n], np.asarray(ref["value_fbe"])[:n],
                 rtol=2e-3, atol=2e-4 * vscale)
    assert_close(got["primal_infeasibility"][:n],
                 np.asarray(ref["primal_infeasibility"])[:n],
                 rtol=2e-3, atol=1e-4)


def _tracked(got, ref):
    """The leading iterations over which the traces hold
    ``_trace_parity`` (the same tau picked, the value and the
    infeasibility within the bounds)."""
    for n in range(ITERS, 0, -1):
        try:
            _trace_parity(got, ref, n)
            return n
        except AssertionError:
            pass
    return 0


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_bf16_history_tracks_the_jax_bf16_kernel(algorithm):
    from rapidnet_tpu_torch.ops import qn_solve as Q

    eng, fa, step, kw = _problem()
    ref = _jax_bf16(fa, step, kw, algorithm)
    kc, _, step_t = _port(fa, step, eng)
    n0 = Q.qn_solve.launches
    got = Q.qn_solve(kc, step_t, None, algorithm=algorithm,
                     lbfgs_dtype="bfloat16", **kw)
    assert Q.qn_solve.launches == n0          # the CPU never launches
    assert _tracked(got, ref) >= TRACK        # 7 (FBE) and 8 (NAMA) here
    a = np.asarray(ref["control"])
    assert np.abs(got["control"].numpy() - a).max() < 0.1 * max(
        np.abs(a).max(), 1.0)
    # the controls of solves that end inside the horizon
    kw_t = dict(kw, max_iterations=TRACK)
    ref_t = _jax_bf16(fa, step, kw_t, algorithm)
    got_t = Q.qn_solve(kc, step_t, None, algorithm=algorithm,
                       lbfgs_dtype="bfloat16", **kw_t)
    assert_close(got_t["control"], ref_t["control"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_bf16_history_against_the_float32_history(algorithm):
    """tests/test_pallas_qn.py:346-366 on the port: the first iteration
    uses no history, and the bf16 solve stays within the line search's
    branch noise of the float32 one; the knob does round the history."""
    from rapidnet_tpu_torch.ops import qn_solve as Q

    eng, fa, step, kw = _problem()
    kc, _, step_t = _port(fa, step, eng)
    f32 = Q.qn_solve(kc, step_t, None, algorithm=algorithm, **kw)
    bf16 = Q.qn_solve(kc, step_t, None, algorithm=algorithm,
                      lbfgs_dtype="bfloat16", **kw)
    assert_close(bf16["primal_infeasibility"][0],
                 f32["primal_infeasibility"][0], rtol=1e-6, atol=0)
    a = f32["control"].numpy()
    assert np.abs(bf16["control"].numpy() - a).max() < 0.1 * max(
        np.abs(a).max(), 1.0)
    assert not torch.equal(bf16["value_fbe"], f32["value_fbe"])
    same = Q.qn_solve(kc, step_t, None, algorithm=algorithm,
                      lbfgs_dtype="float32", **kw)
    assert torch.equal(same["value_fbe"], f32["value_fbe"])


def test_bf16_batch_wrappers_equal_their_instances():
    """The batch wrappers pass ``lbfgs_dtype`` on: each instance of a
    bf16 batch (stacked and shared-forecast) equals its bf16 single
    solve.  The port's own generators build the problem (SMALL)."""
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            shared_step_tensors)
    from rapidnet_tpu_torch.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver.apg import expand_shared_step

    p, B = SMALL, 3
    net = synthetic_network(nx=p["nx"], nu=p["nu"], nd=p["nd"], ne=p["ne"],
                            seed=p["seed"])
    tree = generate_tree(N=p["N"], branching=list(p["branching"]),
                         nd=p["nd"], nu=p["nu"], seed=p["seed"])
    fc = synthetic_forecaster(N=p["N"], nd=p["nd"], nu=p["nu"],
                              sim_horizon=4, seed=p["seed"])
    cfg = synthetic_config(net, tree, max_iterations=6, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    rng = np.random.default_rng(7)
    x0s = (cfg.current_x * (1 + 0.02 * rng.standard_normal(
        (B, cfg.current_x.size)))).astype(np.float32)
    base, inst = shared_step_tensors(*eng.prepare_step_shared(
        fc.nominal_demand, fc.nominal_prices, x0s,
        np.tile(cfg.prev_u, (B, 1)), np.tile(cfg.prev_demand, (B, 1))),
        "cpu")
    steps = expand_shared_step(base, **inst)
    fa = factor_tensors(factor_arrays(eng), "cpu")
    hyper = dict(algorithm="globalFbeAlgorithm",
                 prefix_stages=eng.factor_step().prefix_stages,
                 inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                 penalty_state=cfg.penalty_state,
                 penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER),
                 max_iterations=6, lbfgs_buffer_size=BS,
                 lbfgs_dtype="bfloat16")
    stacked = Q.make_qn_kernel_batch(fa, **hyper)(
        {k: v.contiguous() for k, v in steps.items()})
    shared = Q.make_qn_kernel_batch_shared(fa, **hyper)(base, inst)
    single = Q.make_qn_kernel(fa, **hyper)
    for b in range(B):
        ref = single({k: v[b].contiguous() for k, v in steps.items()})
        for out in (stacked, shared):
            for k in ("control", "u", "x", "primal_infeasibility",
                      "value_fbe", "tau"):
                assert torch.equal(out[k][b], ref[k]), k


def test_other_history_dtypes_raise():
    from rapidnet_tpu_torch.ops import qn_solve as Q

    eng, fa, step, kw = _problem(max_iterations=2)
    kc, fa_t, step_t = _port(fa, step, eng)
    prefix = eng.factor_step().prefix_stages
    with pytest.raises(ValueError, match="lbfgs_dtype"):
        Q.qn_solve(kc, step_t, None, algorithm="namaAlgorithm",
                   lbfgs_dtype="float16", **kw)
    steps = {k: v[None] for k, v in step_t.items()}
    with pytest.raises(ValueError, match="lbfgs_dtype"):
        Q.qn_solve_batch(kc, steps, None, algorithm="namaAlgorithm",
                         lbfgs_dtype="float16", **kw)
    for make in (Q.make_qn_kernel, Q.make_qn_kernel_batch,
                 Q.make_qn_kernel_batch_shared):
        with pytest.raises(ValueError, match="lbfgs_dtype"):
            make(fa_t, algorithm="namaAlgorithm", prefix_stages=prefix,
                 lbfgs_dtype="float16", **kw)
