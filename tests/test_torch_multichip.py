"""The port's multichip example, dry run and mesh checkpoints against the
JAX package.

One module-scoped group of 4 gloo CPU ranks (``tests/_torch_mesh``,
``multichip_job``) runs ``rapidnet_tpu_torch.examples.multichip_sharded
--devices 4 --iterations 40``, ``examples.dryrun.dryrun_multichip(4)``
and the warm checkpoint resumes of ``SmpcController(mesh=...)`` on the
two rows of a (2, 2) ``make_mesh_2d`` (two 2-rank scenario meshes, each
writing its own file), while this process computes JAX's references on
the conftest's virtual host devices:

* the example against JAX's ``make_sharded_apg`` on a 4-device mesh on
  the example's problem (examples/multichip_sharded.py), and the dry
  run's plain sharded APG and 2-D batch against JAX's on
  ``__graft_entry__._toy_problem``'s: the APG bounds, control rtol/atol
  1e-5 and the trace 1e-4 (tests/test_pallas_apg.py:45-51);
* the dry run's sharded streaming APG against JAX's plain sharded solve
  at the bound of the streaming path against XLA (1e-4,
  tests/test_torch_stream_sharded.py), inside the dry run's own 1e-3
  rule; its 3-iteration sharded streaming FBE against JAX's XLA
  ``make_sharded_quasi_newton`` at rtol 1e-3, atol 1e-4
  (tests/test_pallas_qn.py:85-89);
* ``dryrun.entry`` against ``__graft_entry__.entry`` at the APG bounds;
* a resumed mesh run equals the uninterrupted one bit for bit, on the
  plain and the streaming route, for APG, FBE and NAMA, and its file has
  the single-device file's keys, shapes and dtypes.

JAX's sweeps run their stage recursions as a sequential scan, the branch
the port mirrors (tests/test_torch_sharded_plain.py says why).
"""

import numpy as np
import pytest
import torch

from tests import _torch_mesh as TM
from tests._torch_parity import to_numpy

torch.set_num_threads(2)

APG, FBE, NAMA = "proximalAlgorithm", "globalFbeAlgorithm", "namaAlgorithm"
RESUMES = {f"{short}_{route}": (alg, "auto" if route == "plain"
                                else "stream")
           for route in ("plain", "stream")
           for short, alg in (("apg", APG), ("fbe", FBE), ("nama", NAMA))}


def _apg_kw(cfg, eng):
    from rapidnet_tpu.engine.engine import XS_UPPER
    return dict(prefix_stages=eng.factor_step().prefix_stages,
                inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                penalty_state=cfg.penalty_state,
                penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER),
                max_iterations=cfg.max_iterations)


def _jax_example():
    """examples/multichip_sharded.py's solve at --devices 4 --iterations
    40, in this process."""
    from rapidnet_tpu.engine.engine import Engine
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.parallel import sharding
    from rapidnet_tpu.solver.controller import _factor_arrays, _step_arrays
    net = synthetic_network(nx=16, nu=30, nd=20, ne=5, seed=3)
    tree = generate_tree(N=12, branching=[4, 4], nd=20, nu=30, seed=3)
    fc = synthetic_forecaster(N=12, nd=20, nu=30, sim_horizon=2, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=40, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)
    step = _step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand))
    mesh = sharding.make_mesh(4)
    run = sharding.make_sharded_apg(mesh, fa, step, **_apg_kw(cfg, eng))
    return to_numpy(run(sharding.shard_factor_arrays(fa, mesh),
                        sharding.shard_step_arrays(step, mesh)))


def _jax_dryrun():
    """The solves of ``__graft_entry__.dryrun_multichip(4)`` on XLA: the
    plain sharded APG, the sharded FBE at 3 iterations, the 2-D batch;
    and ``entry()``."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as G
    from rapidnet_tpu.parallel import (make_mesh, make_mesh_2d,
                                       make_sharded_apg,
                                       make_sharded_apg_batch,
                                       make_sharded_quasi_newton,
                                       shard_factor_arrays,
                                       shard_step_arrays,
                                       shard_step_arrays_batch)
    out = {}
    cfg, eng, fa, step = G._toy_problem(N=6, branching=(4, 2),
                                        max_iterations=5)
    mesh = make_mesh(4)
    kw = _apg_kw(cfg, eng)
    fa_sh, step_sh = shard_factor_arrays(fa, mesh), shard_step_arrays(step,
                                                                      mesh)
    out["control"] = to_numpy(make_sharded_apg(mesh, fa, step, **kw)(
        fa_sh, step_sh)["control"])
    out["qn_control"] = to_numpy(make_sharded_quasi_newton(
        mesh, fa, step, algorithm=FBE, lbfgs_buffer_size=5,
        **dict(kw, max_iterations=3))(fa_sh, step_sh)["control"])
    cfg, eng, fa, step = G._toy_problem(N=6, branching=(2, 2),
                                        max_iterations=5)
    mesh2 = make_mesh_2d(2, 2)
    steps = {k: jnp.stack([v] * 4) for k, v in step.items()}
    out["batch_control"] = to_numpy(make_sharded_apg_batch(
        mesh2, fa, step, **_apg_kw(cfg, eng))(
            shard_factor_arrays(fa, mesh2),
            shard_step_arrays_batch(steps, mesh2))["control"])
    fn, args = G.entry()
    out["single"] = to_numpy(jax.jit(fn)(*args)["control"])
    return out


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    directory = tmp_path_factory.mktemp("mesh_ckpt")
    handle = TM.Ranks(4, TM.multichip_job, str(directory), RESUMES)
    yield handle, directory
    handle.stop()


@pytest.fixture(scope="module")
def refs(started):
    from rapidnet_tpu.solver import solve_step as jss
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jss, "SCAN_MIN_NS", 1)
        return {"example": _jax_example(), "dryrun": _jax_dryrun()}


@pytest.fixture(scope="module")
def ranks(started, refs):
    return started[0].wait()


def test_multichip_sharded_matches_jax(refs, ranks):
    """Rank 0 prints the JAX example's lines, the others nothing; the
    ranks' controls are equal bit for bit and held to JAX's."""
    got, text = ranks[0]["example"]
    assert "'scen': 4" in text and "(16 scenarios, 4 per rank)" in text
    assert "control u0:" in text and "final infeasibility:" in text
    for r in ranks[1:]:
        assert r["example"][1] == ""
        assert np.array_equal(r["example"][0]["control"], got["control"])
    ref = refs["example"]
    assert got["u"].shape == ref["u"].shape
    np.testing.assert_allclose(got["control"], ref["control"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["primal_infeasibility"],
                               ref["primal_infeasibility"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("part", ["control", "stream_control", "qn_control",
                                  "batch_control"])
def test_dryrun_multichip_matches_jax(refs, ranks, part):
    """Each solve of ``dryrun_multichip(4)`` against JAX's on the same toy
    problem; every rank returns the same controls."""
    got = ranks[0]["dryrun"][part]
    for r in ranks[1:]:
        assert np.array_equal(r["dryrun"][part], got)
    ref = refs["dryrun"]
    if part == "control":
        np.testing.assert_allclose(got, ref["control"], rtol=1e-5,
                                   atol=1e-5)
    elif part == "stream_control":
        np.testing.assert_allclose(got, ref["control"], rtol=1e-4,
                                   atol=1e-4)
    elif part == "qn_control":
        np.testing.assert_allclose(got, ref["qn_control"], rtol=1e-3,
                                   atol=1e-4)
    else:
        assert got.shape == (4, 7)
        np.testing.assert_allclose(got, ref["batch_control"], rtol=1e-5,
                                   atol=1e-5)


def test_dryrun_refuses_a_wrong_world_size(ranks):
    """``dryrun_multichip(3)`` on 4 ranks: ValueError on every rank."""
    for r in ranks:
        kind, text = r["dryrun_3"]
        assert kind == "ValueError" and "3-device mesh" in text


def test_dryrun_entry_matches_jax(refs):
    from rapidnet_tpu_torch.examples import dryrun
    fn, args = dryrun.entry("cpu")
    got = fn(*args)["control"].numpy()
    np.testing.assert_allclose(got, refs["dryrun"]["single"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(RESUMES))
def test_mesh_checkpoint_resume_is_the_uninterrupted_run(started, ranks,
                                                         name):
    """A warm ``SmpcController(mesh=...)`` saved after step 0 (rank 0 of
    its 2-rank mesh writes, both wait) and resumed by both ranks from
    what rank 0 read (rank 1 passes a path with no file): step 1's
    control and duals equal the uninterrupted run's bit for bit on
    every rank, the two meshes agree, and the file has the single-device
    file's keys, shapes and dtypes."""
    directory = started[1]
    alg, backend = RESUMES[name]
    got = ranks[0][name]
    assert got["t"] == 1
    assert got["route"] == ("plain" if backend == "auto" else "stream")
    for r in ranks:
        res = r[name]
        assert res["t"] == 1
        assert np.array_equal(res["u"], res["u_ref"])
        for k in ("xi", "psi"):
            assert np.array_equal(res["y"][k], res["y_ref"][k]), k
        assert res["kpi"][0] == res["kpi"][1]
        assert np.array_equal(res["u"], got["u"])
    single = str(directory / f"{name}_single")
    from rapidnet_tpu_torch.utils.checkpoint import save_checkpoint
    ctrl = TM.mesh_controller(None, alg, backend, warm_start=True)
    ctrl.control_action(0)
    ctrl.move_forward_in_time()
    save_checkpoint(ctrl, single, sim_time=1)
    with np.load(single + ".npz") as ref, \
            np.load(str(directory / f"{name}_row0.npz")) as mesh_file:
        assert sorted(mesh_file.files) == sorted(ref.files)
        for k in ref.files:
            assert mesh_file[k].shape == ref[k].shape, k
            assert mesh_file[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("name", list(RESUMES))
def test_mesh_checkpoint_is_read_on_rank_0(ranks, name):
    """On a mesh only rank 0 touches the files: ``checkpoint_exists(path,
    mesh)`` is rank 0's answer on every rank (rank 1 passed a path with
    no file), and a file rank 0 lacks makes every rank raise
    FileNotFoundError, none waiting on the others."""
    for r in ranks:
        assert r[name]["exists"] is True
        assert r[name]["missing"] == "FileNotFoundError"
