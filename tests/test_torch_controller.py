"""The slice end to end: the port's closed loop and CLI against JAX's.

Tolerances are the JAX package's between two solve paths in a closed
loop (tests/test_controller.py:76-77): controls rtol 1e-4 with atol
1e-4 * max(|u|, 1); the KPIs, sums over the same controls, rtol 1e-4.

FBE and NAMA: the line search branches on value comparisons, so two
float32 implementations part after a few iterations
(tests/test_pallas_qn.py:1-15); their closed loops run TRACK = 4
iterations per solve, over which the JAX package holds two
implementations to control rtol 1e-3 / atol 1e-4
(tests/test_pallas_qn.py:85-87); the KPIs, sums over those controls, to
rtol 1e-3.  The JAX sweeps run as the sequential scan the port mirrors
(solve_step.SCAN_MIN_NS, as in tests/test_torch_quasi_newton.py).
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KPIS = ("economicKpi", "smoothKpi", "safetyKpi", "networkKpi")
STEPS = 4


QN_TRACK = 4


def _problem(pkg, algorithm=None, max_iterations=40):
    """nx=4, nu=7 network, N=8 tree with branching [2, 2], 4 forecast
    steps; the same seeds in either package's generators."""
    import importlib
    m = {k: importlib.import_module(f"{pkg}.model.{k}")
         for k in ("network", "scenario_tree", "forecaster", "config")}
    net = m["network"].synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = m["scenario_tree"].generate_tree(N=8, branching=[2, 2], nd=3,
                                            nu=7, seed=7)
    fc = m["forecaster"].synthetic_forecaster(N=8, nd=3, nu=7,
                                              sim_horizon=STEPS, seed=7)
    cfg = m["config"].synthetic_config(net, tree,
                                       max_iterations=max_iterations,
                                       step_size=1e-3)
    if algorithm is not None:
        cfg.algorithm = algorithm
    return cfg, net, tree, fc


def _jax_controller(algorithm=None, max_iterations=40, **kw):
    from rapidnet_tpu.solver.controller import SmpcController
    cfg, net, tree, fc = _problem("rapidnet_tpu", algorithm, max_iterations)
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend="xla", **kw)


def _port_controller(algorithm=None, max_iterations=40, **kw):
    from rapidnet_tpu_torch import SmpcController
    cfg, net, tree, fc = _problem("rapidnet_tpu_torch", algorithm,
                                  max_iterations)
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          device="cpu", **kw)


def _assert_logs_close(got, ref, steps=STEPS, rtol=1e-4):
    """Controls within rtol, atol rtol * max(|u|, 1) (APG) or the
    JAX QN bound's atol 1e-4; KPIs within rtol."""
    for t in range(steps):
        a, b = np.asarray(got[f"control{t}"]), np.asarray(ref[f"control{t}"])
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0))
    for k in KPIS:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, err_msg=k)


@pytest.fixture
def jax_sequential_sweeps(monkeypatch):
    from rapidnet_tpu.solver import solve_step as jss
    monkeypatch.setattr(jss, "SCAN_MIN_NS", 1)


@pytest.mark.parametrize("warm_start", [False, True],
                         ids=["cold", "warm"])
def test_closed_loop_matches_jax(warm_start):
    ref = _jax_controller(warm_start=warm_start).closed_loop(STEPS)
    port = _port_controller(warm_start=warm_start)
    got = port.closed_loop(STEPS)
    _assert_logs_close(got, ref)
    assert "memoryLeakWarning" not in got
    assert port.primal_infeasibility.shape == (40,)


@pytest.mark.parametrize("warm_start", [False, True],
                         ids=["cold", "warm"])
@pytest.mark.parametrize("algorithm", ["globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_qn_closed_loop_matches_jax(algorithm, warm_start,
                                    jax_sequential_sweeps):
    """A 4-step FBE or NAMA closed loop of the port against the JAX
    controller: controls and KPIs, cold and warm-started."""
    kw = dict(algorithm=algorithm, max_iterations=QN_TRACK,
              warm_start=warm_start)
    ref = _jax_controller(**kw).closed_loop(STEPS)
    port = _port_controller(**kw)
    got = port.closed_loop(STEPS)
    _assert_logs_close(got, ref, rtol=1e-3)
    assert "memoryLeakWarning" not in got
    assert port.primal_infeasibility.shape == (QN_TRACK,)


def test_backends_agree_on_cpu():
    """'auto' on the CPU takes the kernel wrapper's plain version, which
    is the 'torch' backend's solve: the same numbers."""
    a = _port_controller(backend="auto").closed_loop(2)
    b = _port_controller(backend="torch").closed_loop(2)
    for t in range(2):
        assert a[f"control{t}"] == b[f"control{t}"]


def test_cli_matches_jax_controller(tmp_path, capsys):
    """The port's CLI on a problem written by the JAX package's writers,
    against the JAX controller on the same files."""
    from rapidnet_tpu.io.writers import export_problem
    from rapidnet_tpu.solver.controller import SmpcController
    from rapidnet_tpu_torch import cli

    paths = export_problem(*(_problem("rapidnet_tpu")[i]
                             for i in (1, 2, 3, 0)), tmp_path / "problem")
    out = tmp_path / "control.json"
    assert cli.main(["--config", paths["config"], "--steps", "3",
                     "--device", "cpu", "--output", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "economic kpi" in printed and "network utility kpi" in printed
    got = json.loads(out.read_text())
    ref = SmpcController(paths["config"], backend="xla").closed_loop(3)
    _assert_logs_close(got, ref, steps=3)


@pytest.mark.parametrize("algorithm", ["globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_cli_runs_the_config_algorithm(algorithm, tmp_path, capsys,
                                       jax_sequential_sweeps):
    """A config that names FBE or NAMA: the port's CLI prints the same
    lines and writes the same JSON keys as for APG, and its controls
    agree with the JAX controller's on the same files."""
    from rapidnet_tpu.solver.controller import SmpcController
    from rapidnet_tpu_torch import cli
    from rapidnet_tpu_torch.io.writers import export_problem

    cfg, net, tree, fc = _problem("rapidnet_tpu_torch", algorithm, QN_TRACK)
    paths = export_problem(net, tree, fc, cfg, tmp_path / "problem")
    out = tmp_path / "control.json"
    assert cli.main(["--config", paths["config"], "--steps", "3",
                     "--device", "cpu", "--output", str(out)]) == 0
    captured = capsys.readouterr()
    assert captured.err.count("time lapsed") == 3
    assert "economic kpi" in captured.out
    got = json.loads(out.read_text())
    assert set(got) == ({f"control{t}" for t in range(3)} |
                        {f"time{t}" for t in range(3)} | set(KPIS))
    assert json.loads(open(paths["config"]).read())["algorithmName"] == \
        algorithm
    ref = SmpcController(paths["config"], backend="xla").closed_loop(3)
    _assert_logs_close(got, ref, steps=3, rtol=1e-3)


def test_cli_external_simulator_writes_state(tmp_path):
    """--external-simulator round-trips the closed-loop state through the
    config JSON (reference simulatorFlag=0)."""
    from rapidnet_tpu.io.writers import export_problem
    from rapidnet_tpu_torch import cli

    paths = export_problem(*(_problem("rapidnet_tpu")[i]
                             for i in (1, 2, 3, 0)), tmp_path)
    before = json.loads(open(paths["config"]).read())["currentX"]
    cli.main(["--config", paths["config"], "--steps", "2", "--device",
              "cpu", "--external-simulator",
              "--output", str(tmp_path / "out.json")])
    after = json.loads(open(paths["config"]).read())
    assert not np.allclose(after["currentX"], before)
    assert np.isfinite(after["prevU"]).all()


def test_package_never_imports_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "import rapidnet_tpu_torch\n"
        "from rapidnet_tpu_torch import cli\n"
        "from rapidnet_tpu_torch.model.config import synthetic_config\n"
        "from rapidnet_tpu_torch.model.forecaster import "
        "synthetic_forecaster\n"
        "from rapidnet_tpu_torch.model.network import synthetic_network\n"
        "from rapidnet_tpu_torch.model.scenario_tree import generate_tree\n"
        "from rapidnet_tpu_torch.solver.tuning import auto_tune\n"
        "from rapidnet_tpu_torch.io import (datasource, epanet, matio, "
        "writers, xls)\n"
        "from rapidnet_tpu_torch.utils import checkpoint, timing\n"
        "from rapidnet_tpu_torch.parallel import (make_sharded_apg, "
        "make_sharded_quasi_newton, shard_factor_arrays)\n"
        "from rapidnet_tpu_torch.examples import (barcelona_scale, "
        "batched_monte_carlo, closed_loop_reference_fixtures, "
        "epanet_to_controller, large_tree_streaming, "
        "real_data_closed_loop)\n"
        "out = batched_monte_carlo.main(['--device', 'cpu', '--batch', '2', "
        "'--steps', '1', '--iterations', '5'])\n"
        "assert out['controls'].shape == (1, 2, 18)\n"
        "net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=1)\n"
        "tree = generate_tree(N=6, branching=[2, 2], nd=3, nu=7, seed=1)\n"
        "fc = synthetic_forecaster(N=6, nd=3, nu=7, seed=1)\n"
        "cfg, _ = auto_tune(net, tree, synthetic_config(net, tree, "
        "max_iterations=10), device='cpu', probes=2, power_iters=2)\n"
        "u = rapidnet_tpu_torch.SmpcController(cfg, network=net, tree=tree,"
        " forecaster=fc, device='cpu').control_action(0)\n"
        "assert u.shape == (7,)\n"
        "for alg in ('globalFbeAlgorithm', 'namaAlgorithm'):\n"
        "    cfg.algorithm = alg\n"
        "    u = rapidnet_tpu_torch.SmpcController(cfg, network=net, "
        "tree=tree, forecaster=fc, device='cpu').control_action(0)\n"
        "    assert u.shape == (7,)\n"
        "cfg.algorithm = 'proximalAlgorithm'\n"
        "import numpy as np\n"
        "bu = rapidnet_tpu_torch.BatchedSmpcController(cfg, net, tree, fc,"
        " np.tile(cfg.current_x, (2, 1)), device='cpu').control_action(0)\n"
        "assert bu.shape == (2, 7)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'rapidnet_tpu.'))]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_device_and_backend_requests_raise():
    """No silent fallback: backend='cuda' needs a CUDA device, and the
    default device is 'cuda', which raises without a GPU."""
    from rapidnet_tpu_torch import SmpcController
    cfg, net, tree, fc = _problem("rapidnet_tpu_torch")
    with pytest.raises(ValueError, match="backend='cuda'"):
        SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                       backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                       backend="xla", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SmpcController(cfg, network=net, tree=tree, forecaster=fc)


def test_unported_options_raise():
    """A mesh that is not a ``parallel.Mesh``, a stream precision that is
    not measured and a streaming FBE/NAMA history storage other than
    float32 or bfloat16 raise; a mesh with backend 'torch' builds the
    plain sharded solve (route 'plain'; its solves are
    tests/test_torch_sharded_plain.py's and
    tests/test_torch_stream_sharded.py's); single-device FBE controllers,
    one instance or a batch, build, with either history storage, and an
    unknown algorithm raises."""
    from rapidnet_tpu_torch import BatchedSmpcController, SmpcController
    from rapidnet_tpu_torch.parallel import Mesh
    from rapidnet_tpu_torch.model.config import ALGORITHM_FBE
    cfg, net, tree, fc = _problem("rapidnet_tpu_torch")
    kw = dict(network=net, tree=tree, forecaster=fc, device="cpu")
    fbe = copy.deepcopy(cfg)
    fbe.algorithm = ALGORITHM_FBE
    assert SmpcController(fbe, **kw).config.algorithm == ALGORITHM_FBE
    assert BatchedSmpcController(
        fbe, net, tree, fc, np.tile(cfg.current_x, (2, 1)),
        device="cpu").config.algorithm == ALGORITHM_FBE
    bad = copy.deepcopy(cfg)
    bad.algorithm = "newtonAlgorithm"
    with pytest.raises(ValueError, match="unknown algorithm"):
        SmpcController(bad, **kw)
    on_mesh = SmpcController(cfg, mesh=Mesh(0, 2, "cpu"), backend="torch",
                             **kw)
    on_mesh.initialise()        # runs no collective
    assert on_mesh.route == "plain"
    with pytest.raises(TypeError, match="parallel.Mesh"):
        SmpcController(cfg, mesh=object(), **kw)
    with pytest.raises(ValueError, match="stream_precision"):
        SmpcController(cfg, stream_precision="default", **kw)
    assert SmpcController(fbe, stream_lbfgs_dtype="bfloat16",
                          **kw).stream_lbfgs_dtype == "bfloat16"
    with pytest.raises(ValueError, match="stream_lbfgs_dtype"):
        SmpcController(cfg, stream_lbfgs_dtype="float16", **kw)
