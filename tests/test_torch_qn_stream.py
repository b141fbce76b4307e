"""The streaming FBE/NAMA path of the port: the sweeps S1/S2
(rapidnet_tpu_torch/ops/stream_qn.py), the L-BFGS history passes
(ops/lbfgs.py) and the solve (solver/qn_stream.py), on the CPU, where
every wrapper runs its plain version.

Each is held to its JAX counterpart, run as the JAX package's own tests
run it on the CPU (Pallas in interpret mode): ``make_stream_sweeps``,
``make_lbfgs_kernels`` and ``make_qn_stream``.  The problem is the
branchy tree of tests/test_qn_stream.py:145-147 (branching [3, 2, 2],
three prefix aggregations), built from a seed with the in-repo
generators (tests/_torch_parity.py).  Bounds:

* one sweep pass within 1e-5 * max(|ref|, 1): the same arithmetic, one
  pass deep;
* the history dots within 1e-5 of the rep-weighted sum of the
  products' magnitudes (a float32 sum in another order), combine within
  1e-6 * max(|ref|, 1) (the same sum in the same order);
* the solve with the bounds of tests/test_qn_stream.py: over 3 (FBE) and
  2 (NAMA) iterations control, u, x, v and y within 5e-4 * max(|ref|,
  1), the value at rtol = atol = 1e-4, tau at atol 1e-6 and the
  infeasibility at rtol = atol = 1e-3 (:67-84); over 12 iterations and
  from a warm start, the control and u within 1e-3 * max(|ref|, 1)
  (:127-168); the line searches branch on float32 values, so the solves
  are compared over such horizons, not at the full budget;
* a 2-step closed loop within the reference's 1e-1 solver tier
  (:172-207).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import jax_problem, port_inputs
from tests.test_torch_apg_stream import H100_SMEM, gate_grid

torch.set_num_threads(2)

BRANCHY = dict(nx=4, nu=7, nd=3, ne=2, N=8, branching=(3, 2, 2), seed=11)
FBE, NAMA = "globalFbeAlgorithm", "namaAlgorithm"
BUFFER = 5
SHORT = {FBE: 3, NAMA: 2}
LONG = 12
STORAGE = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _problem(x0_scale, iters):
    eng, fa, step, kw = jax_problem(**BRANCHY, max_iterations=iters,
                                    step_size=1e-3, x0_scale=x0_scale)
    return eng.factor_step().prefix_stages, fa, step, kw


@functools.lru_cache(maxsize=None)
def _jax_solver(algorithm, x0_scale, iters, dtype):
    from rapidnet_tpu.solver.qn_stream import make_qn_stream
    _, fa, _, kw = _problem(x0_scale, iters)
    return make_qn_stream(fa, algorithm=algorithm,
                          lbfgs_buffer_size=BUFFER, interpret=True,
                          lbfgs_dtype=STORAGE[dtype][0], **kw)


def _port_solver(algorithm, x0_scale, iters, dtype="float32"):
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream
    prefix, fa, step, kw = _problem(x0_scale, iters)
    fa_t, step_t = port_inputs(fa, step)
    return make_qn_stream(fa_t, algorithm=algorithm, prefix_stages=prefix,
                          lbfgs_buffer_size=BUFFER, lbfgs_dtype=dtype,
                          **kw), step_t


def _scaled(got, ref, factor, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    bound = factor * max(np.abs(ref).max(), 1.0)
    err = np.abs(got - ref).max()
    assert err <= bound, f"{what}: {err} > {bound}"


# ------------------------------------------------------------ the sweeps


def _stressed_state():
    """The dual triple after 5 iterations of the port's streaming FBE
    solve from tanks at 1.2 times their maximum, and the v of one S1 pass
    from it: (prefix, fa, step, kw, w, v) as numpy arrays."""
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    prefix, fa, step, kw = _problem(1.2, 5)
    run, step_t = _port_solver(FBE, 1.2, 5)
    out = run(step_t)
    w = torch.cat([out["y"]["xi"], out["y"]["psi"]], dim=-1)
    v = SQ.s1_plain(run.consts, w, step_t["beta"])
    return prefix, fa, step, kw, w.numpy(), v.numpy()


@pytest.mark.parametrize("affine", [True, False], ids=["solve", "oracle"])
def test_sweep_halves_match_jax(affine):
    from rapidnet_tpu.ops import pallas_stream
    from rapidnet_tpu.ops.pallas_stream_qn import make_stream_sweeps
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    prefix, fa, step, kw, w, v = _stressed_state()
    consts = pallas_stream.pack_stream_constants(fa)
    N, ns, nx, nu, nv, NSP, PX, PU, PV = consts["dims"]
    bwd, fwd = make_stream_sweeps(consts, affine=affine, interpret=True)
    cd = {k: jnp.asarray(consts[k]) for k in
          ("sq", "nhp", "cx1", "cx2", "cu", "Bb", "LT", "iW", "L", "B",
           "CpT", "BpT")}

    def to_t(a, P):
        return pallas_stream._to_t(a, NSP, P)

    w_t = (to_t(w[..., :nx], PX), to_t(w[..., nx:2 * nx], PX),
           to_t(w[..., 2 * nx:], PU))
    sp = pallas_stream.pack_stream_step(step, consts["dims"])
    fa_t, step_t = port_inputs(fa, step)
    kc = S.stream_constants(fa_t, prefix_stages=prefix,
                            max_iterations=kw["max_iterations"])
    n1, n2 = SQ.s1_call.launches, SQ.s2_call.launches
    if affine:
        ref_v = bwd(cd, *w_t, sp["beta"])
        got_v = SQ.s1_call(kc, torch.tensor(w), step_t["beta"])
        ref = fwd(cd, to_t(v, PV), sp["uhat"], sp["e"], sp["x0"], sp["pdu"])
        pdu = step_t["prev_u"] - step_t["prev_uhat"]
        got = SQ.s2_call(kc, torch.tensor(v), step_t["uhat"], step_t["e"],
                         step_t["x0"], pdu)
    else:
        ref_v = bwd(cd, *w_t)
        got_v = SQ.s1_call(kc, torch.tensor(w))
        ref = fwd(cd, to_t(v, PV))
        got = SQ.s2_call(kc, torch.tensor(v))
    assert (SQ.s1_call.launches, SQ.s2_call.launches) == (n1, n2)
    _scaled(got_v, pallas_stream._from_t(ref_v, ns, nv), 1e-5, "v")
    x, u, p1, p2, pp = (pallas_stream._from_t(a, ns, d) for a, d in
                        zip(ref, (nx, nu, nx, nx, nu)))
    _scaled(got[0], x, 1e-5, "x")
    _scaled(got[1], u, 1e-5, "u")
    _scaled(got[2], np.concatenate([p1, p2, pp], axis=-1), 1e-5, "images")
    # the Hessian oracle is the solve step with the affine terms zero
    if not affine:
        zero = {k: torch.zeros_like(t) for k, t in step_t.items()}
        v0 = SQ.s1_plain(kc, torch.tensor(w), zero["beta"])
        assert torch.equal(v0, got_v)


# ---------------------------------------------------- the history passes


def _history(dtype, N=8, ns=12, nx=4, nu=7, M=BUFFER + 1):
    """A full, wrapped history (columns 1..M-1 filled, column 0 zero),
    the new pair and the gradient, seeded, in the storage type; and a
    0/1 rep with zeros where a prefix node repeats."""
    rng = np.random.default_rng(5)
    D = 2 * nx + nu
    tdt = STORAGE[dtype][1]

    def stored(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            ).to(tdt)

    mat_s, mat_y = stored(M, N, ns, D), stored(M, N, ns, D)
    mat_s[0] = 0
    mat_y[0] = 0
    rep = torch.tensor((rng.random((N, ns)) < 0.7).astype(np.float32))
    g = torch.tensor(rng.standard_normal((N, ns, D)).astype(np.float32))
    return rep, mat_s, mat_y, stored(N, ns, D), stored(N, ns, D), g


def _jax_layout(t, nx):
    """(..., N, ns, D) -> {y1, y2, yp} of (..., N, P, ns)."""
    a = np.asarray(t.float())
    return {k: np.swapaxes(a[..., sl], -1, -2) for k, sl in
            (("y1", slice(0, nx)), ("y2", slice(nx, 2 * nx)),
             ("yp", slice(2 * nx, None)))}


@pytest.mark.parametrize("dtype", sorted(STORAGE))
def test_history_passes_match_jax(dtype):
    from rapidnet_tpu.ops.pallas_lbfgs import make_lbfgs_kernels
    from rapidnet_tpu_torch.ops import lbfgs as LB

    nx, nu = 4, 7
    rep, mat_s, mat_y, s, yv, g = _history(dtype)
    M, N, ns, D = mat_s.shape
    jdt = STORAGE[dtype][0]
    dot_sweep, comb = make_lbfgs_kernels(N=N, n_cols=M, PX=nx, PU=nu,
                                         lanes=ns, nb=jdt, interpret=True)

    def jx(t, dt=jdt):
        return {k: jnp.asarray(v, dt) for k, v in _jax_layout(t, nx).items()}

    rep_j = jnp.asarray(np.asarray(rep)[:, None, :])
    dS, dY, selfd = dot_sweep(rep_j, jx(mat_s), jx(mat_y), jx(s), jx(yv),
                              jx(g, jnp.float32))
    n0 = LB.dots.launches
    gS, gY, gself = LB.dots(rep, mat_s, mat_y, s, yv, g)
    assert LB.dots.launches == n0
    assert gself.shape == (6,)
    mag = LB.dots_plain(rep, mat_s.abs(), mat_y.abs(), s.abs(), yv.abs(),
                        g.abs())
    for got, ref, m in ((gS, dS, mag[0]), (gY, dY, mag[1]),
                        (gself, np.asarray(selfd)[:6], mag[2])):
        err = np.abs(np.asarray(got) - np.asarray(ref))
        assert (err <= 1e-5 * np.asarray(m)).all(), (err.max(), dtype)
    coef = torch.tensor(np.random.default_rng(6).standard_normal(2 * M + 1)
                        .astype(np.float32))
    ref = comb(jnp.asarray(np.asarray(coef)), jx(mat_s), jx(mat_y),
               jx(g, jnp.float32))
    got = LB.combine(coef, mat_s, mat_y, g)
    ref = np.concatenate([np.swapaxes(np.asarray(ref[k]), -1, -2)
                          for k in ("y1", "y2", "yp")], axis=-1)
    _scaled(got, ref, 1e-6, "combine")


def test_history_wrappers_refuse_what_the_kernels_do_not_take():
    from rapidnet_tpu_torch.ops import lbfgs as LB

    rep, mat_s, mat_y, s, yv, g = _history("bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        LB.dots(rep, mat_s, mat_y, s.float(), yv, g)
    with pytest.raises(ValueError, match="dtype"):
        LB.dots(rep, mat_s.double(), mat_y.double(), s, yv, g)
    with pytest.raises(ValueError, match="shape"):
        LB.combine(torch.zeros(3), mat_s, mat_y, g)
    big = torch.zeros((LB.MAX_COLS + 1,) + tuple(mat_s.shape[1:]))
    with pytest.raises(ValueError, match="columns"):
        LB.combine(torch.zeros(2 * LB.MAX_COLS + 3), big, big, g)
    with pytest.raises(ValueError, match="meta"):
        LB.combine(torch.zeros(2 * mat_s.shape[0] + 1), mat_s, mat_y,
                   g.to("meta"))


# -------------------------------------------------------------- the solve


def _assert_short_bounds(got, ref):
    for k in ("control", "u", "x", "v"):
        _scaled(got[k], ref[k], 5e-4, k)
    for k in ("xi", "psi"):
        _scaled(got["y"][k], ref["y"][k], 5e-4, k)
    np.testing.assert_allclose(got["value_fbe"], ref["value_fbe"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["tau"], ref["tau"], atol=1e-6)
    np.testing.assert_allclose(got["primal_infeasibility"],
                               ref["primal_infeasibility"], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("algorithm", [FBE, NAMA])
def test_solve_matches_jax_short_horizon(algorithm):
    """Tanks at 1.2 times their maximum (the state penalties active)."""
    iters = SHORT[algorithm]
    _, _, step, _ = _problem(1.2, iters)
    ref = _jax_solver(algorithm, 1.2, iters, "float32")(step)
    run, step_t = _port_solver(algorithm, 1.2, iters)
    got = run(step_t)
    assert int(got["iterations"]) == iters
    _assert_short_bounds(got, ref)
    # the first iteration is the plain dual step: no value, no tau
    assert float(got["value_fbe"][0]) == 0.0 == float(got["tau"][0])


@pytest.mark.parametrize("dtype", sorted(STORAGE))
@pytest.mark.parametrize("algorithm", [FBE, NAMA])
def test_branchy_solve_and_warm_start_match_jax(algorithm, dtype):
    """tests/test_qn_stream.py:127-168 for both algorithms and both
    history storages: 12 iterations from tanks at 0.98, then a warm start
    from the JAX solve's duals."""
    _, _, step, _ = _problem(0.98, LONG)
    jrun = _jax_solver(algorithm, 0.98, LONG, dtype)
    run, step_t = _port_solver(algorithm, 0.98, LONG, dtype)
    ref0, got0 = jrun(step), run(step_t)
    assert float(np.asarray(ref0["tau"]).max()) > 0     # searches fired
    for k in ("control", "u"):
        _scaled(got0[k], ref0[k], 1e-3, k)
    y0 = {k: np.asarray(v) for k, v in ref0["y"].items()}
    ref1 = jrun(step, y0)
    got1 = run(step_t, {k: torch.tensor(v) for k, v in y0.items()})
    for k in ("control", "u"):
        _scaled(got1[k], ref1[k], 1e-3, "warm " + k)
    assert not torch.equal(got1["u"], got0["u"])


def test_bf16_history_is_what_the_solve_stores():
    """The bf16 solve differs from the f32 one (its history is rounded)
    and stays within the 12-iteration bound of it."""
    run32, step_t = _port_solver(FBE, 0.98, LONG)
    run16, _ = _port_solver(FBE, 0.98, LONG, "bfloat16")
    a, b = run32(step_t), run16(step_t)
    assert not torch.equal(a["u"], b["u"])
    _scaled(b["control"], a["control"], 1e-3, "control")


def test_ladder_nan_rule():
    """qn_stream's rule: a trial fails on val > value_ref, so a NaN value
    does not stop the ladder, and a ladder of NaN walks to its last
    trial, tau = 0 (quasi_newton stops on the NaN instead)."""
    from rapidnet_tpu_torch.solver import qn_stream as Q

    n = len(Q.LADDER)
    nan = float("nan")
    ref = torch.tensor(1.0)
    assert Q.LADDER[-1] == 0.0 and n == 11
    assert int(Q.ladder_pick(torch.full((n,), nan), ref)) == n - 1
    assert Q.LADDER[int(Q.ladder_pick(torch.full((n,), nan), ref))] == 0.0
    vals = torch.tensor([nan, 0.5, nan, 2.0] + [3.0] * (n - 4))
    assert int(Q.ladder_pick(vals, ref)) == 3
    assert int(Q.ladder_pick(torch.full((n,), 0.5), ref)) == n - 1
    assert int(Q.ladder_pick(torch.full((n,), 0.5), torch.tensor(nan))) \
        == n - 1
    assert int(Q.ladder_pick(torch.full((n,), 2.0), ref)) == 0


def test_make_qn_stream_refusals():
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream

    prefix, fa, step, kw = _problem(0.98, 4)
    fa_t, _ = port_inputs(fa, step)
    base = dict(algorithm=FBE, prefix_stages=prefix, **kw)
    with pytest.raises(ValueError, match="fixed budget"):
        make_qn_stream(fa_t, lbfgs_buffer_size=5, tolerance=1e-3, **base)
    with pytest.raises(ValueError, match="lbfgs_dtype"):
        make_qn_stream(fa_t, lbfgs_buffer_size=5, lbfgs_dtype="float16",
                       **base)
    with pytest.raises(ValueError, match="buffer"):
        make_qn_stream(fa_t, lbfgs_buffer_size=16, **base)
    with pytest.raises(ValueError, match="quasi-Newton"):
        make_qn_stream(fa_t, lbfgs_buffer_size=5,
                       **dict(base, algorithm="proximalAlgorithm"))


# The sweeps' shared-memory gate before their staged variants, written
# out: the larger of S1's and S2's work tiles (TILE = 8 slots of floats).
# A launch asks for more only where its staged variant fits the device,
# so the gate must take every tree this took.
def _tile_sweep_fits(N, ns, nx, nu, nv, limit):
    smem = 4 * 8 * max(nx + nv + nu, 2 * nu + nx + nv)
    return ns >= 1 and N >= 1 and smem <= limit


@pytest.mark.parametrize("limit", [H100_SMEM, 48 * 1024, 8 * 1024])
def test_sweep_fits_takes_every_tree_the_tile_gate_took(limit):
    """Over the streaming kernels' grid of sizes (``gate_grid``),
    ``stream_qn.stream_fits`` takes exactly the trees the unstaged tile
    formula takes (the staged variant is the source's pick, never the
    gate's)."""
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    taken = 0
    for d in gate_grid():
        before = _tile_sweep_fits(**d, limit=limit)
        assert SQ.stream_fits(**d, smem_limit=limit) == before, d
        taken += before
    assert taken > 0


def test_sweep_wrappers_refuse_what_the_kernels_do_not_take():
    from rapidnet_tpu_torch.ops import stream_qn as SQ

    run, step_t = _port_solver(FBE, 0.98, 4)
    kc = run.consts
    N, ns, nx, nu, nv = SQ.dims(kc)
    w = torch.zeros(N, ns, 2 * nx + nu)
    with pytest.raises(ValueError, match="shape"):
        SQ.s1_call(kc, w[..., 1:].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        SQ.s1_call(kc, w, step_t["beta"].double())
    with pytest.raises(ValueError, match="together"):
        SQ.s2_call(kc, torch.zeros(N, ns, nv), uhat=step_t["uhat"])
    with pytest.raises(ValueError, match="meta"):
        SQ.s2_call(kc, torch.zeros(N, ns, nv, device="meta"))


# ------------------------------------------------------- controller, CLI


def _controller(algorithm, backend, **kw):
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=5)
    tree = generate_tree(N=6, branching=[2, 2], nd=3, nu=7, seed=5)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=5)
    cfg = synthetic_config(net, tree, max_iterations=10, step_size=1e-3)
    cfg.algorithm = algorithm
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend=backend, device="cpu", **kw)


def test_controller_stream_backend_matches_jax():
    """tests/test_qn_stream.py:172-207 on the port: NAMA through
    backend='stream' against the JAX controller's streaming solve, and
    FBE against the port's plain backend, over 2 closed-loop steps."""
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import SmpcController as JaxCtrl

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=5)
    tree = generate_tree(N=6, branching=[2, 2], nd=3, nu=7, seed=5)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=5)
    cfg = synthetic_config(net, tree, max_iterations=10, step_size=1e-3)
    cfg.algorithm = NAMA
    pairs = [(JaxCtrl(cfg, network=net, tree=tree, forecaster=fc,
                      backend="stream"), _controller(NAMA, "stream")),
             (_controller(FBE, "torch"), _controller(FBE, "stream"))]
    for ref, got in pairs:
        for t in range(2):
            a = ref.control_action(t)
            b = got.control_action(t)
            np.testing.assert_allclose(b, a, rtol=1e-1, atol=1e-1)
            ref.move_forward_in_time()
            got.move_forward_in_time()
        assert got.route == "stream"
        assert got.primal_infeasibility.shape == (10,)


def test_controller_stream_lbfgs_dtype():
    for dtype in ("float32", "bfloat16", None):
        ctrl = _controller(FBE, "stream", stream_lbfgs_dtype=dtype)
        assert ctrl.stream_lbfgs_dtype == (dtype or "float32")
    for bad in ("float16", "bf16"):
        with pytest.raises(ValueError, match="stream_lbfgs_dtype"):
            _controller(FBE, "stream", stream_lbfgs_dtype=bad)
    with pytest.raises(ValueError, match="tolerance"):
        _controller(NAMA, "stream", tolerance=1e-3)


def test_auto_sends_a_refused_qn_pack_to_plain(monkeypatch):
    """On a CUDA device, ``auto`` runs the plain FBE solve where the pack
    refuses the tree, with the refusal in ``route_reason``."""
    from rapidnet_tpu_torch.solver import controller as C

    ctrl = _controller(FBE, "auto")
    ctrl.initialise()
    fa = dict(ctrl._fa)
    fa["g"] = fa["g"].clone()
    fa["g"][2, 1, 0] *= 3.0
    ctrl._fa = fa
    monkeypatch.setattr(C, "auto_route", lambda *a, **k: "stream")
    ctrl.device = torch.device("cuda")
    kw = dict(prefix_stages=ctrl.engine.factor_step().prefix_stages,
              max_iterations=10)
    assert ctrl._route(kw) == ("plain", None)
    assert "sqrt(prob)" in ctrl.route_reason


def test_cli_stream_lbfgs_dtype(tmp_path, capsys):
    """``--backend stream --stream-lbfgs-dtype bfloat16`` on the CPU (the
    plain versions) against the float32 history, FBE."""
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
    cfg = synthetic_config(net, tree, max_iterations=12, step_size=1e-3)
    cfg.algorithm = FBE
    paths = export_problem(net, tree, fc, cfg, tmp_path / "problem")
    logs = {}
    for dtype in ("bfloat16", "float32"):
        out = tmp_path / f"{dtype}.json"
        assert cli.main(["--config", paths["config"], "--steps", "2",
                         "--device", "cpu", "--backend", "stream",
                         "--stream-lbfgs-dtype", dtype,
                         "--output", str(out)]) == 0
        logs[dtype] = json.loads(out.read_text())
    assert "economic kpi" in capsys.readouterr().out
    for t in range(2):
        a = np.asarray(logs["float32"][f"control{t}"])
        b = np.asarray(logs["bfloat16"][f"control{t}"])
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-1, atol=1e-1)
