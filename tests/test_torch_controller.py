"""The slice end to end: the port's closed loop and CLI against JAX's.

Tolerances are the JAX package's between two solve paths in a closed
loop (tests/test_controller.py:76-77): controls rtol 1e-4 with atol
1e-4 * max(|u|, 1); the KPIs, sums over the same controls, rtol 1e-4.
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


def _problem(pkg):
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
    cfg = m["config"].synthetic_config(net, tree, max_iterations=40,
                                       step_size=1e-3)
    return cfg, net, tree, fc


def _jax_controller(**kw):
    from rapidnet_tpu.solver.controller import SmpcController
    cfg, net, tree, fc = _problem("rapidnet_tpu")
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend="xla", **kw)


def _port_controller(**kw):
    from rapidnet_tpu_torch import SmpcController
    cfg, net, tree, fc = _problem("rapidnet_tpu_torch")
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          device="cpu", **kw)


def _assert_logs_close(got, ref, steps=STEPS):
    for t in range(steps):
        a, b = np.asarray(got[f"control{t}"]), np.asarray(ref[f"control{t}"])
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1.0))
    for k in KPIS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("warm_start", [False, True],
                         ids=["cold", "warm"])
def test_closed_loop_matches_jax(warm_start):
    ref = _jax_controller(warm_start=warm_start).closed_loop(STEPS)
    port = _port_controller(warm_start=warm_start)
    got = port.closed_loop(STEPS)
    _assert_logs_close(got, ref)
    assert "memoryLeakWarning" not in got
    assert port.primal_infeasibility.shape == (40,)


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
        "net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=1)\n"
        "tree = generate_tree(N=6, branching=[2, 2], nd=3, nu=7, seed=1)\n"
        "fc = synthetic_forecaster(N=6, nd=3, nu=7, seed=1)\n"
        "cfg, _ = auto_tune(net, tree, synthetic_config(net, tree, "
        "max_iterations=10), device='cpu', probes=2, power_iters=2)\n"
        "u = rapidnet_tpu_torch.SmpcController(cfg, network=net, tree=tree,"
        " forecaster=fc, device='cpu').control_action(0)\n"
        "assert u.shape == (7,)\n"
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
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import ALGORITHM_FBE
    cfg, net, tree, fc = _problem("rapidnet_tpu_torch")
    kw = dict(network=net, tree=tree, forecaster=fc, device="cpu")
    fbe = copy.deepcopy(cfg)
    fbe.algorithm = ALGORITHM_FBE
    with pytest.raises(NotImplementedError, match="item 8"):
        SmpcController(fbe, **kw)
    with pytest.raises(NotImplementedError, match="item 12"):
        SmpcController(cfg, mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="item 7"):
        SmpcController(cfg, stream_precision="default", **kw)
