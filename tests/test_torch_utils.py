"""The port's checkpoint and timing helpers against the JAX package's.

Checkpoints: the port's warm resume is the uninterrupted warm loop bit
for bit (the same solve on the same float32 duals); a checkpoint the JAX
package wrote under its XLA path resumes in the port within the APG
tolerance rtol/atol 1e-5 (tests/test_pallas_apg.py:45-51) of the JAX
resume, two float32 solves of one problem.
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _problem(pkg, max_iterations=30, step_size=1e-4):
    """tests/test_aux.py's small controller problem (:35-47)."""
    import importlib
    m = {k: importlib.import_module(f"{pkg}.model.{k}")
         for k in ("network", "scenario_tree", "forecaster", "config")}
    net = m["network"].synthetic_network(nx=4, nu=6, nd=3, ne=2, seed=3)
    tree = m["scenario_tree"].generate_tree(N=6, branching=[2], nd=3, nu=6,
                                            seed=3)
    fc = m["forecaster"].synthetic_forecaster(N=6, nd=3, nu=6,
                                              sim_horizon=8, seed=3)
    cfg = m["config"].synthetic_config(net, tree,
                                       max_iterations=max_iterations,
                                       step_size=step_size)
    return cfg, net, tree, fc


def _port(warm_start=False, **kw):
    from rapidnet_tpu_torch import SmpcController
    cfg, net, tree, fc = _problem("rapidnet_tpu_torch")
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          device="cpu", warm_start=warm_start, **kw)


def _jax(warm_start=False, backend="xla"):
    from rapidnet_tpu.solver.controller import SmpcController
    cfg, net, tree, fc = _problem("rapidnet_tpu")
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend=backend, warm_start=warm_start)


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_aux.py:49-66 in the port: state, KPI accumulators and
    solve times come back, with the same files on disk."""
    from rapidnet_tpu_torch.utils.checkpoint import (checkpoint_exists,
                                                     load_checkpoint,
                                                     save_checkpoint)
    ctrl = _port()
    ctrl.control_action(0)
    ctrl.move_forward_in_time()
    path = str(tmp_path / "ckpt")
    assert not checkpoint_exists(path)
    save_checkpoint(ctrl, path, sim_time=1)
    assert checkpoint_exists(path)
    assert sorted(os.listdir(tmp_path)) == ["ckpt.json", "ckpt.npz"]
    with np.load(path + ".npz") as data:
        assert sorted(data.files) == ["current_x", "dual_psi", "dual_xi",
                                      "prev_demand", "prev_u"]
        assert data["dual_xi"].dtype == np.float32

    ctrl2 = _port()
    assert load_checkpoint(ctrl2, path) == 1
    np.testing.assert_array_equal(ctrl2.config.current_x,
                                  ctrl.config.current_x)
    np.testing.assert_array_equal(ctrl2.config.prev_u, ctrl.config.prev_u)
    np.testing.assert_array_equal(ctrl2.config.prev_demand,
                                  ctrl.config.prev_demand)
    assert ctrl2.economic_kpi_acc == ctrl.economic_kpi_acc
    assert ctrl2.network_kpi_acc == ctrl.network_kpi_acc
    assert ctrl2.solve_times_ms == ctrl.solve_times_ms
    assert ctrl2._y_carry is None          # a cold controller keeps none
    with open(path + ".json") as fh:
        manifest = json.load(fh)
    assert manifest["algorithm"] == ctrl.config.algorithm


def test_warm_resume_is_the_uninterrupted_loop(tmp_path):
    """A warm controller saved after step 0 and resumed in a fresh one:
    step 1's control, duals and the KPIs after it equal the uninterrupted
    2-step warm loop's, bit for bit."""
    from rapidnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    ref = _port(warm_start=True)
    ref.control_action(0)
    ref.move_forward_in_time()
    path = str(tmp_path / "ckpt")
    save_checkpoint(ref, path, sim_time=1)
    u_ref = ref.control_action(1)
    ref.move_forward_in_time()

    ctrl = _port(warm_start=True)
    t = load_checkpoint(ctrl, path)
    assert ctrl._y_carry["xi"].device.type == "cpu"
    u = ctrl.control_action(t)
    ctrl.move_forward_in_time()
    np.testing.assert_array_equal(u, u_ref)
    for k in ("xi", "psi"):
        assert torch.equal(ctrl._last["y"][k], ref._last["y"][k])
    assert ctrl.economic_kpi_acc == ref.economic_kpi_acc
    assert ctrl.smooth_kpi_acc == ref.smooth_kpi_acc
    # a cold controller resumed from the same file differs: the carry is
    # what made them equal
    cold = _port()
    load_checkpoint(cold, path)
    assert not np.array_equal(cold.control_action(1), u)


def test_jax_xla_checkpoint_resumes_in_the_port(tmp_path):
    """A warm checkpoint the JAX package saved under backend='xla' loads
    into the port; the port's resumed control agrees with the JAX
    package's resume of the same file."""
    from rapidnet_tpu.utils.checkpoint import load_checkpoint as jload
    from rapidnet_tpu.utils.checkpoint import save_checkpoint as jsave
    from rapidnet_tpu_torch.utils.checkpoint import load_checkpoint

    src = _jax(warm_start=True)
    src.control_action(0)
    src.move_forward_in_time()
    path = str(tmp_path / "jax_ckpt")
    jsave(src, path, sim_time=1)

    jctrl = _jax(warm_start=True)
    assert jload(jctrl, path) == 1
    ref = np.asarray(jctrl.control_action(1))
    port = _port(warm_start=True)
    assert load_checkpoint(port, path) == 1
    assert set(port._y_carry) == {"xi", "psi"}
    got = port.control_action(1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the carry mattered: a cold port solve from the same state differs
    cold = _port()
    load_checkpoint(cold, path)
    assert np.abs(cold.control_action(1) - got).max() > 1e-3


def test_checkpoint_refusals(tmp_path):
    """A file holding the JAX package's padded Pallas duals
    (dual_xi1/dual_xi2), written by its own save under backend='pallas',
    raises and names them.  (A controller on a mesh is no longer refused:
    tests/test_torch_multichip.py and the one-rank test below.)"""
    from rapidnet_tpu.utils.checkpoint import save_checkpoint as jsave
    from rapidnet_tpu_torch.utils.checkpoint import load_checkpoint

    src = _jax(warm_start=True, backend="pallas")
    src.control_action(0)
    src.move_forward_in_time()
    path = str(tmp_path / "pallas_ckpt")
    jsave(src, path, sim_time=1)
    with np.load(path + ".npz") as data:
        assert {"dual_xi1", "dual_xi2"} <= set(data.files)
    port = _port(warm_start=True)
    x_before = port.config.current_x.copy()
    with pytest.raises(ValueError, match="dual_xi1/dual_xi2"):
        load_checkpoint(port, path)
    np.testing.assert_array_equal(port.config.current_x, x_before)


@pytest.mark.parametrize("algorithm,backend", [
    ("proximalAlgorithm", "stream"), ("globalFbeAlgorithm", "auto"),
    ("globalFbeAlgorithm", "stream"), ("namaAlgorithm", "auto"),
    ("namaAlgorithm", "stream")])
def test_qn_and_stream_warm_resume_is_the_uninterrupted_loop(
        tmp_path, algorithm, backend):
    """The warm resume of test_warm_resume_is_the_uninterrupted_loop on
    the other routes: FBE and NAMA on the whole-solve route ('auto' on the
    CPU runs the kernel wrapper's plain version) and on the streaming
    route (the kernels' plain halves), APG streaming; ``out["y"]`` is
    {xi, psi} on each (ops/qn_solve.py, solver/qn_stream.py), and step 1
    of the resumed controller equals the uninterrupted loop's bit for
    bit."""
    from rapidnet_tpu_torch import SmpcController
    from tests import _torch_mesh as TM

    def warm():
        cfg, net, tree, fc = _problem("rapidnet_tpu_torch",
                                      max_iterations=10, step_size=1e-3)
        cfg.algorithm = algorithm
        return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              device="cpu", warm_start=True,
                              backend=backend)

    got = TM.warm_resume(warm, str(tmp_path / "ckpt"))
    assert got["route"] == ("kernel" if backend == "auto" else "stream")
    assert got["t"] == 1
    np.testing.assert_array_equal(got["u"], got["u_ref"])
    for k in ("xi", "psi"):
        np.testing.assert_array_equal(got["y"][k], got["y_ref"][k])
    assert got["kpi"][0] == got["kpi"][1]


def test_one_rank_mesh_checkpoint_is_the_single_device_file(tmp_path):
    """A controller on a mesh of one rank (``Mesh(0, 1, "cpu")``, no
    process group) saves the file a single-device controller saves, bit
    for bit (its plain sharded solve is the single-device one), and
    loads it as its global warm carry."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.parallel import Mesh
    from rapidnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
    paths = {}
    for name, mesh in (("single", None), ("mesh", Mesh(0, 1, "cpu"))):
        cfg, net, tree, fc = _problem("rapidnet_tpu_torch")
        ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              device="cpu", warm_start=True, backend="torch",
                              mesh=mesh)
        ctrl.control_action(0)
        ctrl.move_forward_in_time()
        paths[name] = str(tmp_path / name)
        save_checkpoint(ctrl, paths[name], sim_time=1)
    with np.load(paths["single"] + ".npz") as a, \
            np.load(paths["mesh"] + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    cfg, net, tree, fc = _problem("rapidnet_tpu_torch")
    meshed = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                            device="cpu", warm_start=True, backend="torch",
                            mesh=Mesh(0, 1, "cpu"))
    assert load_checkpoint(meshed, paths["mesh"]) == 1
    assert meshed._y_carry["xi"].shape == (6, 2, 8)


# -- timing -------------------------------------------------------------

def test_tictoc():
    from rapidnet_tpu_torch.utils import TicToc

    t = TicToc()
    with pytest.raises(RuntimeError, match="without tic"):
        t.toc()
    for _ in range(2):
        t.tic()
        ms = t.toc(torch.ones(3))
        assert ms >= 0.0
    assert len(t.history_ms) == 2 and t.history_ms[-1] == ms
    with pytest.raises(RuntimeError, match="without tic"):
        t.toc()                              # each toc consumes its tic


def _trace_files(d):
    return [f for f in os.listdir(d) if f.endswith(".json")]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from rapidnet_tpu_torch.utils.timing import profile_trace

    d = tmp_path / "trace"
    with profile_trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = _trace_files(d)
    assert len(files) == 1
    doc = json.loads((d / files[0]).read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]


def test_profile_trace_writes_when_the_body_raises(tmp_path):
    """A body that raises still leaves its trace, under the given name,
    and the context yields the profiler."""
    from rapidnet_tpu_torch.utils.timing import profile_trace

    d = tmp_path / "trace"
    with pytest.raises(RuntimeError, match="body"):
        with profile_trace(str(d), name="failed.json") as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
            raise RuntimeError("body")
    assert _trace_files(d) == ["failed.json"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_cli_profile_dir(tmp_path, capsys):
    """``--device cpu --profile-dir DIR`` writes one Chrome trace of the
    closed loop, and the run's output is the run without it."""
    from rapidnet_tpu_torch import cli
    from rapidnet_tpu_torch.io.writers import export_problem

    cfg, net, tree, fc = _problem("rapidnet_tpu_torch", max_iterations=10)
    paths = export_problem(net, tree, fc, cfg, str(tmp_path / "problem"))
    logs = {}
    for label, extra in (("traced", ["--profile-dir",
                                     str(tmp_path / "trace")]),
                         ("plain", [])):
        out = tmp_path / f"{label}.json"
        assert cli.main(["--config", paths["config"], "--steps", "2",
                         "--device", "cpu", "--output", str(out)] +
                        extra) == 0
        captured = capsys.readouterr()
        assert "economic kpi" in captured.out
        logs[label] = json.loads(out.read_text())
    files = _trace_files(tmp_path / "trace")
    assert len(files) == 1
    doc = json.loads((tmp_path / "trace" / files[0]).read_text())
    assert len(doc["traceEvents"]) > 10
    for t in range(2):
        assert logs["traced"][f"control{t}"] == logs["plain"][f"control{t}"]
