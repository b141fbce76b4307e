"""The port's examples (rapidnet_tpu_torch/examples/) against the JAX
package.

Each example's ``main`` runs in process on the CPU with the arguments of
tests/test_examples.py:28-71 plus ``--device cpu``, prints the JAX
example's marker line, and its returned controls and KPIs are held to
the JAX package's controller, built here from the same generators and
seeds.  Where the example auto-tunes, the JAX controller takes the
port's tuned step size and preconditioner (the two ``auto_tune``s agree
to rtol 1e-3, tests/test_torch_solve_step.py::test_auto_tune_matches_jax;
the solves are compared on one problem).  Bounds: the APG control bound
rtol/atol 1e-5 (tests/test_pallas_apg.py:45-51), the KPIs at rtol 1e-5.

``batched_monte_carlo`` is held to JAX's ``BatchedSmpcController``.  The
two batches advance their plants with differently rounded products
(ROADMAP queue 3: JAX's batch ``u @ B.T + d @ Gd.T``, the port's
``B @ u + Gd @ d`` as its single controller does), so from step 1 on the
states differ in their last bits; the bounds hold through the 2 steps.

``large_tree_streaming`` runs the streaming solve's plain halves; it is
held to JAX's XLA controller at the bound of the streaming path against
XLA (1e-4, tests/test_torch_stream_sharded.py's
``test_controller_mesh_stream_matches_jax``), and its ``--devices 2``
run over two gloo ranks (``run_ranks(group=False)``) to its own
single-device run at the APG bound.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from tests import _torch_mesh as TM
from tests._torch_files import _data_source, _dwn_mat, _problem

torch.set_num_threads(2)

KPI = ("economic", "smooth", "safety", "network")


def _run(module, argv):
    """``module.main(argv)`` in process: (its result, what it printed)."""
    import importlib
    mod = importlib.import_module(f"rapidnet_tpu_torch.examples.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    return out, buf.getvalue()


def _jax_loop(ctrl, steps):
    """The JAX controller's ``steps``-step loop: controls and KPIs."""
    controls = []
    for t in range(steps):
        controls.append(np.asarray(ctrl.control_action(t)))
        ctrl.move_forward_in_time()
    return np.array(controls), {
        "economic": ctrl.economic_kpi(steps),
        "smooth": ctrl.smooth_kpi(steps),
        "safety": ctrl.safety_kpi(steps),
        "network": ctrl.network_kpi(steps)}


def _tuned(cfg, port_cfg):
    """``cfg`` with the port example's tuned step size and
    preconditioner."""
    cfg.step_size = port_cfg.step_size
    cfg.diag_precnd = np.asarray(port_cfg.diag_precnd)
    return cfg


def _hold(got, ref_controls, ref_kpis, bound=1e-5):
    np.testing.assert_allclose(got["controls"], ref_controls, rtol=bound,
                               atol=bound)
    assert np.isfinite(got["controls"]).all()
    for k in KPI:
        np.testing.assert_allclose(got["kpis"][k], ref_kpis[k], rtol=1e-5,
                                   atol=1e-12, err_msg=k)


def test_barcelona_scale_matches_jax():
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import SmpcController

    got, text = _run("barcelona_scale", ["--device", "cpu", "--scenarios",
                                         "5", "--steps", "1",
                                         "--iterations", "20"])
    assert "economic kpi" in text and got["route"] == "kernel"
    net = synthetic_network(nx=63, nu=114, nd=88, ne=17, seed=42)
    tree = generate_tree(N=24, branching=[5, 1], nd=88, nu=114, seed=42)
    fc = synthetic_forecaster(N=24, nd=88, nu=114, sim_horizon=2, seed=42)
    cfg = _tuned(synthetic_config(net, tree, max_iterations=20),
                 got["config"])
    ref = _jax_loop(SmpcController(cfg, network=net, tree=tree,
                                   forecaster=fc, warm_start=True), 1)
    _hold(got, *ref)


def test_batched_monte_carlo_matches_jax():
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.batch import BatchedSmpcController

    B, steps = 4, 2
    got, text = _run("batched_monte_carlo", [
        "--device", "cpu", "--batch", str(B), "--steps", str(steps),
        "--iterations", "40"])
    assert "solves/s" in text and "OK" in text and got["route"] == "kernel"
    assert got["controls"].shape == (steps, B, 18)
    net = synthetic_network(nx=10, nu=18, nd=12, ne=4, seed=1)
    tree = generate_tree(N=12, branching=[3, 2], nd=12, nu=18, seed=1)
    cfg = synthetic_config(net, tree, max_iterations=40, step_size=1e-3)
    rng = np.random.default_rng(0)
    x0s = cfg.current_x * (0.8 + 0.4 * rng.random((B, 10)))
    fcs = [synthetic_forecaster(N=12, nd=12, nu=18, sim_horizon=steps + 2,
                                seed=100 + b) for b in range(B)]
    log = BatchedSmpcController(cfg, net, tree, fcs, x0s).closed_loop(steps)
    _hold(got, np.asarray(log["controls"]),
          {k: np.asarray(log[f"{k}Kpi"]) for k in KPI})


def test_epanet_to_controller_matches_jax(tmp_path):
    """Its four files byte-equal to the JAX writers' on the same problem
    (the JAX generators' network, tree and forecaster, the port's tuned
    config), both writing into one directory in turn (the config names
    its files by their paths), and its 2-step loop from them against
    JAX's controller on the JAX-written files."""
    from rapidnet_tpu.io import writers
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import SmpcController

    out = tmp_path / "dwn"
    got, text = _run("epanet_to_controller", ["--device", "cpu", "--out",
                                              str(out)])
    assert "KPIs:" in text and (out / "controllerConfig.json").exists()
    net = synthetic_network(nx=3, nu=6, nd=4, ne=2, seed=1)
    fc = synthetic_forecaster(N=12, nd=4, nu=6, sim_horizon=4, seed=1)
    tree = generate_tree(N=12, branching=[2, 2], nd=4, nu=6, seed=1)
    cfg = _tuned(synthetic_config(net, tree, max_iterations=150),
                 got["config"])
    port_bytes = {k: open(p, "rb").read() for k, p in got["paths"].items()}
    ref_paths = writers.export_problem(net, tree, fc, cfg, str(out))
    assert ref_paths == got["paths"]
    for k, path in ref_paths.items():
        assert open(path, "rb").read() == port_bytes[k], k
    ref = _jax_loop(SmpcController(ref_paths["config"]), 2)
    _hold(got, *ref)


def test_closed_loop_reference_fixtures_matches_jax(tmp_path):
    """On a problem that the port's ``export_problem`` writes."""
    from rapidnet_tpu.solver.controller import SmpcController
    from rapidnet_tpu_torch.io.writers import export_problem

    net, tree, fc, cfg, L, Lhat = _problem("rapidnet_tpu_torch")
    paths = export_problem(net, tree, fc, cfg, str(tmp_path / "problem"),
                           mat_l=L, mat_lhat=Lhat)
    got, text = _run("closed_loop_reference_fixtures", [
        "--config", paths["config"], "--steps", "2", "--device", "cpu"])
    assert "economic kpi" in text and got["route"] == "kernel"
    _hold(got, *_jax_loop(SmpcController(paths["config"]), 2))


@pytest.fixture
def data_dir(tmp_path):
    """A dataSource directory (tests/test_torch_io.py's) with a
    dwn.mat-shaped file beside it."""
    ds = _data_source(tmp_path)
    _dwn_mat(ds / "dwn.mat")
    return ds


def test_real_data_dwn_matches_jax(data_dir):
    from rapidnet_tpu.io.matio import load_dwn_forecaster, load_dwn_network
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import SmpcController

    got, text = _run("real_data_closed_loop", [
        "--data-dir", str(data_dir), "--problem", "dwn", "--steps", "2",
        "--iterations", "120", "--start-hour", "0", "--device", "cpu"])
    assert "economic kpi" in text
    mat = str(data_dir / "dwn.mat")
    net = load_dwn_network(mat)
    tree = generate_tree(N=24, branching=[3], nd=net.nd, nu=net.nu, seed=7,
                         demand_sigma=0.002)
    fc = load_dwn_forecaster(mat, N=24, start=0, hours=27)
    cfg = synthetic_config(net, tree, max_iterations=120)
    cfg.current_x = np.maximum(0.12 * net.xmax,
                               1.1 * net.xsafe).astype(np.float32)
    cfg = _tuned(cfg, got["config"])
    ref = _jax_loop(SmpcController(cfg, network=net, tree=tree,
                                   forecaster=fc), 2)
    _hold(got, *ref)


def test_real_data_barcelona_matches_jax(data_dir):
    from rapidnet_tpu.io.datasource import load_barcelona_problem
    from rapidnet_tpu.solver.controller import SmpcController

    got, text = _run("real_data_closed_loop", [
        "--data-dir", str(data_dir), "--problem", "barcelona", "--steps",
        "1", "--iterations", "40", "--device", "cpu"])
    assert "network  kpi" in text
    cfg, net, tree, fc = load_barcelona_problem(str(data_dir),
                                                max_iterations=40)
    ref = _jax_loop(SmpcController(cfg, network=net, tree=tree,
                                   forecaster=fc), 1)
    _hold(got, *ref)


STREAM_ARGS = ["--device", "cpu", "--scenarios", "8", "--iters", "15",
               "--steps", "2"]


def test_large_tree_streaming_matches_jax():
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import SmpcController

    got, text = _run("large_tree_streaming", STREAM_ARGS)
    assert "economic KPI" in text and got["route"] == "stream"
    net = synthetic_network(nx=6, nu=13, nd=8, ne=3, seed=3)
    tree = generate_tree(N=12, branching=[2, 2, 2], nd=8, nu=13, seed=3)
    fc = synthetic_forecaster(N=12, nd=8, nu=13, sim_horizon=2, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=15, step_size=1e-3)
    ref = _jax_loop(SmpcController(cfg, network=net, tree=tree,
                                   forecaster=fc, backend="xla"), 2)
    _hold(got, *ref, bound=1e-4)

    ranks = TM.run_ranks(2, TM.example_job, "large_tree_streaming",
                         STREAM_ARGS, group=False)
    (r0, text0), (r1, text1) = ranks
    assert "economic KPI" in text0 and text1 == ""
    assert r0["route"] == "stream"
    assert np.array_equal(r0["controls"], r1["controls"])
    _hold(r0, got["controls"], got["kpis"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_examples_need_a_gpu_by_default():
    """``--device`` defaults to cuda, which raises without a GPU."""
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _run("batched_monte_carlo", ["--batch", "1", "--steps", "1"])
