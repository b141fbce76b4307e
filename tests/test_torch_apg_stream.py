"""The streaming APG module (rapidnet_tpu_torch/ops/apg_stream.py).

On the CPU the wrapper runs the kernels' plain halves (K1, K2 and the
tail, in the streaming order); it is held to the JAX package's streaming
kernels in interpret mode (``pallas_stream.make_apg_stream``) and to the
plain solves of both packages (``apg.make_apg``), with the JAX package's
own bounds between its streaming path and its XLA path
(tests/test_pallas_stream.py:63-97): control, u and x within 1e-5 *
max(|ref|, 1), y within 1e-4 * max(|ref|, 1), the trace at rtol = atol
= 1e-3, a warm start's control within 1e-4 * max(|ref|, 1).  The
problem is that file's branchy tree (three prefix aggregations), with
the tanks at 0.98 of their maximum, and above it (1.2), which makes the
state penalties active.  The CUDA kernels are checked against the plain
halves on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import assert_close, jax_problem, port_inputs

torch.set_num_threads(2)

# tests/test_pallas_stream.py:100-134
BRANCHY = dict(nx=4, nu=7, nd=3, ne=2, N=8, branching=(3, 2, 2), seed=11)
ITERS = 40
CASES = {"nominal": 0.98, "stressed": 1.2}
# BASELINE config 5 (bench_ladder.py:47) at the Barcelona-scale widths
CONFIG5 = dict(N=24, ns=1024, nx=63, nu=114, nv=97)
H100_SMEM = 232448        # opt-in shared memory per block of an H100
APG = "proximalAlgorithm"


def _problem(x0_scale, iters=ITERS):
    eng, fa, step, kw = jax_problem(**BRANCHY, max_iterations=iters,
                                    step_size=1e-3, x0_scale=x0_scale)
    return eng.factor_step().prefix_stages, fa, step, kw


def _port(fa, step, prefix, iters=ITERS):
    from rapidnet_tpu_torch.ops import apg_stream as S
    fa_t, step_t = port_inputs(fa, step)
    kc = S.stream_constants(fa_t, prefix_stages=prefix,
                            max_iterations=iters)
    return kc, fa_t, step_t


def _scaled(got, ref, factor):
    ref = np.asarray(ref)
    assert_close(got, ref, rtol=0, atol=factor * max(np.abs(ref).max(), 1.0))


def _assert_stream_bounds(got, ref):
    for k in ("control", "u", "x"):
        _scaled(got[k], ref[k], 1e-5)
    for k in ("xi", "psi"):
        _scaled(got["y"][k], ref["y"][k], 1e-4)
    assert_close(got["primal_infeasibility"], ref["primal_infeasibility"],
                 rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_matches_jax_streaming_kernels(case):
    from rapidnet_tpu.ops import pallas_stream
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, kw = _problem(CASES[case])
    ref = pallas_stream.make_apg_stream(fa, interpret=True, **kw)(step)
    kc, _, step_t = _port(fa, step, prefix)
    n0 = S.apg_stream.launches
    got = S.apg_stream(kc, step_t, None, **kw)
    assert S.apg_stream.launches == n0          # the CPU launches nothing
    assert int(got["iterations"]) == ITERS
    _assert_stream_bounds(got, ref)
    _scaled(got["v"], ref["v"], 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_matches_plain_apg_of_both_packages(case):
    from rapidnet_tpu.solver import apg as japg
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.solver import apg as papg

    prefix, fa, step, kw = _problem(CASES[case])
    kc, fa_t, step_t = _port(fa, step, prefix)
    got = S.apg_stream(kc, step_t, None, **kw)
    xla = jax.jit(japg.make_apg(prefix_stages=prefix, **kw))(fa, step)
    port = papg.make_apg(prefix_stages=prefix, **kw)(fa_t, step_t)
    for ref in (xla, port):
        _assert_stream_bounds(got, ref)
        _scaled(got["v"], ref["v"], 1e-5)


def test_stream_warm_start_matches_jax():
    """y0 from a first solve, as tests/test_pallas_stream.py:82-97."""
    from rapidnet_tpu.solver import apg as japg
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, kw = _problem(CASES["stressed"], iters=25)
    xla = jax.jit(japg.make_apg(prefix_stages=prefix, **kw))
    y0 = xla(fa, step)["y"]
    ref = xla(fa, step, y0)
    kc, _, step_t = _port(fa, step, prefix, iters=25)
    y0_t = {k: torch.tensor(np.asarray(v)) for k, v in y0.items()}
    got = S.apg_stream(kc, step_t, y0_t, **kw)
    _scaled(got["control"], ref["control"], 1e-4)
    assert not torch.equal(got["control"],
                           S.apg_stream(kc, step_t, None, **kw)["control"])


@pytest.mark.parametrize("iterations", [1, 3])
def test_k1_then_k2_is_an_apg_iteration(iterations):
    """K1 then K2 (plain halves), ``iterations`` times, leave x, u and v
    of that many iterations of ``apg.make_apg``."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.solver import apg as papg

    prefix, fa, step, kw = _problem(CASES["stressed"])
    kc, fa_t, step_t = _port(fa, step, prefix)
    kw = dict(kw, max_iterations=iterations)
    st = S.plain_iterations(kc, step_t, iterations=iterations, **kw)
    ref = papg.make_apg(prefix_stages=prefix, **kw)(fa_t, step_t)
    for k in ("x", "u", "v"):
        _scaled(st[k], ref[k].numpy(), 1e-5)
    assert len(st["champions"]) == iterations
    # the champion K1 computes is of the previous iteration's residual
    for i in range(1, iterations):
        assert_close(st["champions"][i], ref["primal_infeasibility"][i - 1],
                     rtol=1e-4, atol=1e-4)


def test_k1_plain_takes_its_scalars():
    """The shrinks scale the x blocks' residuals and upd gates the whole
    dual update, as in pallas_stream.py:343-358."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, kw = _problem(CASES["stressed"])
    kc, _, step_t = _port(fa, step, prefix)
    st = S.plain_iterations(kc, step_t, iterations=5, **kw)
    base = dict(lam_prev=kc["lams"][4], lam_i=kc["lams"][5], upd=1.0,
                k1f=0.0, k2f=0.0, c=kw["inv_step"], step=kw["step_size"],
                xs_upper=kw["xs_upper"])

    def k1(**over):
        return S.k1_plain(kc, step_t["beta"], st["pre"], st["y"], st["z"],
                          **dict(base, **over))

    y0, _, _, _ = k1()
    y1, _, _, _ = k1(k1f=0.5)
    nx = kc["cx1"].shape[-1]
    assert not torch.equal(y1["xi"][..., :nx], y0["xi"][..., :nx])
    assert torch.equal(y1["xi"][..., nx:], y0["xi"][..., nx:])
    assert torch.equal(y1["psi"], y0["psi"])
    y_off, z_off, _, _ = k1(upd=0.0)
    assert torch.equal(y_off["xi"], st["y"]["xi"])
    assert not bool(z_off["psi"].any())


def test_pack_rejects_non_rank1_preconditioner():
    """tests/test_pallas_stream.py:137-158 on the port's pack."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, _ = _problem(CASES["nominal"])
    fa_t, _ = port_inputs(fa, step)
    fa_t["d1"] = fa_t["d1"].clone()
    fa_t["d1"][2, 1, 0] *= 3.0
    with pytest.raises(S.NotStreamable, match="rank|structure|sqrt"):
        S.stream_constants(fa_t, prefix_stages=prefix, max_iterations=ITERS)


@pytest.mark.parametrize("which", ["Cp_not_binary", "Bp_two_parents"])
def test_pack_rejects_an_aggregation_that_is_not_a_tree(which):
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, _ = _problem(CASES["nominal"])
    fa_t, _ = port_inputs(fa, step)
    s = prefix[0]
    if which == "Cp_not_binary":
        Cp = fa_t["prefix_Cp"][s].clone()
        Cp[Cp > 0] = 2.0
        fa_t["prefix_Cp"] = {**fa_t["prefix_Cp"], s: Cp}
        match = "0 and 1"
    else:
        Bp = fa_t["prefix_Bp"][s].clone()
        Bp[0, :] = 1.0
        fa_t["prefix_Bp"] = {**fa_t["prefix_Bp"], s: Bp}
        match = "one 1 per row"
    with pytest.raises(S.NotStreamable, match=match):
        S.stream_constants(fa_t, prefix_stages=prefix, max_iterations=ITERS)


@pytest.mark.parametrize("fault", ["not_rank1", "bad_shape"])
def test_auto_sends_only_a_refused_pack_to_plain(monkeypatch, fault):
    """On a CUDA device, ``auto`` runs the plain solve where the pack
    refuses the tree (and keeps the refusal in ``route_reason``); any
    other error of the pack is raised, not routed."""
    from rapidnet_tpu_torch.solver import controller as C

    ctrl = _port_controller()
    ctrl.initialise()
    fa = dict(ctrl._fa)
    if fault == "not_rank1":
        fa["d1"] = fa["d1"].clone()
        fa["d1"][2, 1, 0] *= 3.0
    else:
        s = max(ctrl.engine.factor_step().prefix_stages)
        fa["prefix_Bp"] = {**fa["prefix_Bp"], s: fa["prefix_Bp"][s][:-1]}
    ctrl._fa = fa
    monkeypatch.setattr(C, "auto_route", lambda *a, **k: "stream")
    ctrl.device = torch.device("cuda")
    kw = dict(prefix_stages=ctrl.engine.factor_step().prefix_stages,
              max_iterations=ITERS)
    if fault == "not_rank1":
        assert ctrl._route(kw) == ("plain", None)
        assert "sqrt(prob)" in ctrl.route_reason
    else:
        with pytest.raises(ValueError, match="shapes"):
            ctrl._route(kw)


def test_check_smem_holds_the_gate_to_the_source():
    """``build.check_smem`` passes where the source's ``<name>_smem``
    gives the gate's bytes and raises where it does not."""
    from types import SimpleNamespace

    from rapidnet_tpu_torch.ops import apg_solve, apg_stream, build, qn_solve

    dims = tuple(CONFIG5.values())
    for name, mod in (("apg_solve", apg_solve), ("qn_solve", qn_solve),
                      ("apg_stream", apg_stream)):
        need = mod.smem(*dims)
        lib = SimpleNamespace(**{f"{name}_smem": lambda *d, n=need: n})
        build.check_smem(lib, name, dims, need)
        lib = SimpleNamespace(**{f"{name}_smem": lambda *d, n=need: n + 4})
        with pytest.raises(RuntimeError, match="shared memory"):
            build.check_smem(lib, name, dims, need)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, kw = _problem(CASES["nominal"])
    kc, fa_t, step_t = _port(fa, step, prefix)
    with pytest.raises(ValueError, match="tolerance"):
        S.apg_stream(kc, step_t, None, tolerance=1e-3, **kw)
    with pytest.raises(ValueError, match="tolerance"):
        S.make_apg_stream_kernel(fa_t, prefix_stages=prefix, tolerance=1e-3,
                                 **kw)
    with pytest.raises(ValueError, match="shape"):
        S.apg_stream(kc, step_t, None, **dict(kw, max_iterations=7))
    with pytest.raises(ValueError, match="dtype"):
        S.apg_stream(kc, dict(step_t, beta=step_t["beta"].double()), None,
                     **kw)
    meta = {k: v.to("meta") for k, v in step_t.items()}
    with pytest.raises(ValueError, match="meta"):
        S.apg_stream(kc, meta, None, **kw)
    with pytest.raises(ValueError, match="cuda only"):
        S.k1_call(kc, step_t, None, None, None, (0.0,) * 5, **kw)


def test_stage_ranges_cut_after_each_aggregation():
    from rapidnet_tpu_torch.ops import apg_stream as S

    assert S.stage_ranges(24, (4, 3, 2, 1)) == (
        (23, 4, -1), (3, 3, 0), (2, 2, 1), (1, 1, 2), (0, 0, 3))
    assert S.stage_ranges(6, ()) == ((5, 0, -1),)
    assert S.stage_ranges(6, (3,)) == ((5, 3, -1), (2, 0, 0))


def test_fits_states_the_kernels_limits():
    """The whole-solve kernels take ns <= 181 and N <= 152 at the
    Barcelona-scale widths (the prefix phase and the stage rows in
    shared memory); the streaming kernels take config 5."""
    from rapidnet_tpu_torch.ops import apg_solve, apg_stream, qn_solve

    w = dict(nx=63, nu=114, nv=97, smem_limit=H100_SMEM)
    for fits in (apg_solve.fits, qn_solve.fits):
        assert fits(24, 181, **w) and not fits(24, 182, **w)
        assert fits(152, 25, **w) and not fits(153, 25, **w)
    assert apg_stream.stream_fits(**CONFIG5, smem_limit=H100_SMEM)
    assert not apg_stream.stream_fits(**dict(CONFIG5, N=70000),
                                      smem_limit=H100_SMEM)
    assert not apg_stream.stream_fits(**CONFIG5, smem_limit=8 * 1024)


# The streaming kernels' shared-memory gate before their staged variants,
# written out: the larger of K1's and K2's work tiles (TILE = 8 slots of
# floats).  The staged variants ask for more only where it fits the
# device, so the gate must still take every tree this took.
def _tile_stream_fits(N, ns, nx, nu, nv, limit):
    smem = 4 * 8 * max(nx + nv + nu, 2 * nu + nx + nv)
    return ns >= 1 and 1 <= N <= 65535 and smem <= limit


# N 1-80, ns 1-2048, nx / nu / nv up to 3x config 5's
GATE_GRID = dict(N=(1, 2, 8, 24, 80), ns=(1, 7, 8, 9, 181, 1024, 2048),
                 nx=(1, 4, 63, 126, 189), nu=(1, 7, 114, 228, 342),
                 nv=(1, 5, 97, 194, 291))


def gate_grid():
    import itertools
    keys = tuple(GATE_GRID)
    for vals in itertools.product(*GATE_GRID.values()):
        yield dict(zip(keys, vals))


@pytest.mark.parametrize("limit", [H100_SMEM, 48 * 1024, 8 * 1024])
def test_stream_fits_takes_every_tree_the_tile_gate_took(limit):
    """Over the grid, ``stream_fits`` refuses no tree that the tile
    gate took, and refuses what it refused (the gate is the unstaged
    variant's, which every launch can fall back to)."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    taken = 0
    for d in gate_grid():
        before = _tile_stream_fits(**d, limit=limit)
        assert S.stream_fits(**d, smem_limit=limit) == before, d
        taken += before
    assert taken > 0


def test_config5_staged_launches_fit_an_h100():
    """At config 5 the staged K1 and K2 (matrices and two operand
    buffers) fit a block's 232,448 bytes with their static shared
    memory, by the formula the source exports
    (``apg_stream_staged_smem``, mirrored by ``staged_smem``); at twice
    its widths they do not, and the gate still takes the tree (the
    unstaged variant)."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    k1, k2, _ = S.staged_smem(**CONFIG5)
    assert (k1, k2) == (144304, 137776)
    assert max(k1, k2) + S.STATIC_SMEM <= H100_SMEM
    wide = dict(CONFIG5, nx=126, nu=228, nv=194)
    k1w, k2w, _ = S.staged_smem(**wide)
    assert min(k1w, k2w) > H100_SMEM
    assert S.stream_fits(**wide, smem_limit=H100_SMEM)


@pytest.mark.parametrize("algorithm,tolerance,ns,route", [
    (APG, None, 25, "kernel"),
    (APG, 1e-3, 25, "kernel"),
    ("namaAlgorithm", None, 25, "kernel"),
    (APG, None, 1024, "stream"),
    (APG, 1e-3, 1024, "plain"),
    ("globalFbeAlgorithm", None, 1024, "stream"),
    ("namaAlgorithm", None, 1024, "stream"),
    ("globalFbeAlgorithm", 1e-3, 1024, "plain"),
    ("namaAlgorithm", 1e-3, 1024, "plain"),
])
def test_auto_route_is_a_function_of_shapes(algorithm, tolerance, ns,
                                             route):
    from rapidnet_tpu_torch.solver.controller import auto_route

    dims = dict(CONFIG5, ns=ns)
    assert auto_route(algorithm, tolerance=tolerance, smem_limit=H100_SMEM,
                      **dims) == route
    # the streaming history kernels take a buffer of up to 15
    big = "plain" if route == "stream" and algorithm != APG else route
    assert auto_route(algorithm, tolerance=tolerance, smem_limit=H100_SMEM,
                      lbfgs_buffer_size=16, **dims) == big
    assert auto_route(algorithm, tolerance=tolerance, smem_limit=H100_SMEM,
                      lbfgs_buffer_size=15, **dims) == route


def _port_controller(**kw):
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=8, branching=[3, 2, 2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=4, seed=7)
    cfg = synthetic_config(net, tree, max_iterations=ITERS, step_size=1e-3)
    algorithm = kw.pop("algorithm", None)
    if algorithm is not None:
        cfg.algorithm = algorithm
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          device="cpu", **kw)


def test_controller_stream_backend_closed_loop():
    """tests/test_pallas_stream.py:161-180 on the port: a 2-step closed
    loop through backend='stream' against the plain backend."""
    stream = _port_controller(backend="stream", stream_precision="highest")
    ref = _port_controller(backend="torch")
    for t in range(2):
        np.testing.assert_allclose(stream.control_action(t),
                                   ref.control_action(t), rtol=1e-4,
                                   atol=1e-3)
        stream.move_forward_in_time()
        ref.move_forward_in_time()
    assert stream.route == "stream" and ref.route == "plain"
    assert stream.primal_infeasibility.shape == (ITERS,)


def test_stream_backend_refusals():
    from rapidnet_tpu_torch import BatchedSmpcController

    with pytest.raises(ValueError, match="tolerance"):
        _port_controller(backend="stream", tolerance=1e-3)
    for algorithm in ("globalFbeAlgorithm", "namaAlgorithm"):
        with pytest.raises(ValueError, match="tolerance"):
            _port_controller(backend="stream", algorithm=algorithm,
                             tolerance=1e-3)
        ctrl = _port_controller(backend="stream", algorithm=algorithm)
        ctrl.initialise()
        assert ctrl.route == "stream"
    ctrl = _port_controller(backend="stream", stream_precision="default")
    ctrl.initialise()
    assert ctrl.route == "stream" and ctrl.stream_precision == "default"
    with pytest.raises(ValueError, match="stream_precision"):
        _port_controller(backend="stream", stream_precision="high")
    with pytest.raises(ValueError, match="stream_lbfgs_dtype"):
        _port_controller(stream_lbfgs_dtype="float16")
    ctrl = _port_controller()
    with pytest.raises(ValueError, match="unknown backend 'stream'"):
        BatchedSmpcController(ctrl.config, ctrl.network, ctrl.tree,
                              ctrl.forecaster, np.zeros((2, 4), np.float32),
                              backend="stream", device="cpu")


def test_cli_stream_backend(tmp_path, capsys):
    """``--backend stream --stream-precision highest`` on the CPU: the
    plain halves, against the plain backend on the same files; and
    ``--stream-precision default``, the plain halves' products at one
    bf16 pass, within the reference's solver-numerics tier of the
    float32 run (1e-1 x max(|control|, 1), docs/roofline.md:125-132) and
    not equal to it."""
    import json

    from rapidnet_tpu_torch import cli
    from rapidnet_tpu_torch.io.writers import export_problem
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=8, branching=[3, 2, 2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=4, seed=7)
    cfg = synthetic_config(net, tree, max_iterations=ITERS, step_size=1e-3)
    paths = export_problem(net, tree, fc, cfg, tmp_path / "problem")
    logs = {}
    runs = {"stream": ("stream", "highest"), "torch": ("torch", None),
            "default": ("stream", "default")}
    for name, (backend, precision) in runs.items():
        out = tmp_path / f"{name}.json"
        extra = ["--stream-precision", precision] if precision else []
        assert cli.main(["--config", paths["config"], "--steps", "2",
                         "--device", "cpu", "--backend", backend,
                         "--output", str(out)] + extra) == 0
        logs[name] = json.loads(out.read_text())
    assert "economic kpi" in capsys.readouterr().out
    for t in range(2):
        np.testing.assert_allclose(logs["stream"][f"control{t}"],
                                   logs["torch"][f"control{t}"], rtol=1e-4,
                                   atol=1e-3)
    # step 0 starts both runs from the same state; later steps move the
    # state by the controls applied
    got = np.asarray(logs["default"]["control0"])
    ref = np.asarray(logs["stream"]["control0"])
    assert np.abs(got - ref).max() <= 1e-1 * max(np.abs(ref).max(), 1.0)
    assert not np.array_equal(got, ref)


def test_package_exports_match_jax():
    """The port exports what the JAX package exports, at the top level
    and from ``io``, and every name imports."""
    import importlib

    import rapidnet_tpu
    import rapidnet_tpu.io
    import rapidnet_tpu_torch
    import rapidnet_tpu_torch.io

    for jax_mod, port_mod in ((rapidnet_tpu, rapidnet_tpu_torch),
                              (rapidnet_tpu.io, rapidnet_tpu_torch.io)):
        assert port_mod.__all__ == jax_mod.__all__
        port = importlib.import_module(port_mod.__name__)
        for name in port_mod.__all__:
            assert getattr(port, name) is not None
    from rapidnet_tpu_torch import Forecaster
    from rapidnet_tpu_torch.model.forecaster import JsonForecaster
    assert issubclass(JsonForecaster, Forecaster)
