"""The scenario-sharded streaming APG of the port on a CPU mesh.

``rapidnet_tpu_torch/parallel`` (the mesh), ``ops/apg_stream_sharded.py``
(the pack, the plain halves, ``make_apg_stream_sharded``), the sharded
backward sweep ``ops/stream_qn.s1a_plain``, ``SmpcController(mesh=...)``
and the CLI's ``--devices``.  The port's ranks are gloo CPU processes
(tests/_torch_mesh.py: one group of ranks per tree and rank count, in a
module-scoped fixture whose cached results many cases assert on); JAX
runs here, on the conftest's 8-device virtual mesh, with the Pallas
kernels in interpret mode.  The problems are the JAX tests' own
(tests/test_stream_sharded.py:15-38, built from seeds with the in-repo
generators).  Held to the JAX package, with its bounds:

* ``analyze_prefix_locality`` and every rank's pack against
  ``pallas_stream_sharded``'s (:50-67): the slot lines, the local
  handoffs as slot-to-slot operators, the top cross stage's child-sum
  block and broadcast, the lower cross stages;
* ``make_apg_stream_sharded`` against JAX's on [4, 2, 2] over 2 and 4
  ranks, [2, 2, 2] over 4 (a cross stage below s_hi) and [2] over 2 (no
  shard-local stage): control, u, x, v within 1e-5 * max(|ref|, 1), y
  within 1e-4, the trace at rtol = atol = 1e-3 (:90-99); a warm start
  within 1e-4 (:102-125);
* one sharded S1 pass per rank (``s1a_plain``, both variants, and the
  tree with a cross stage below s_hi) against
  JAX's ``make_sharded_sweeps`` backward inside ``shard_map`` on the
  same duals, within 1e-5 * max(|ref|, 1);
* ``partial_parents_plain`` against the JAX pack's child-sum block
  (``XCpT``) on the same carries, and the wrapper's CPU path against it
  exactly; every rank's kernel lists (``parent_block``) ascending within
  each parent and exactly ``x_Cp``'s nonzero pattern (what the kernel's
  bit-for-bit order rests on), and the wrapper refusing carries of
  another width, row count, dtype or device; ``k1a_plain`` on each rank
  against the port's single-device ``k1_plain`` (held to JAX's K1 in
  tests/test_torch_apg_stream.py) on the rank's slots and the stages
  N-1 .. s_hi, within 1e-5;
* ``SmpcController(mesh=..., backend="stream")`` closed loops against
  JAX's controllers: APG within 1e-4 of the XLA controller
  (:128-157), FBE within 5e-3 of the single-device streaming one
  (tests/test_qn_stream.py:254-285); the refusals on a mesh;
* a 2-rank ``cli --device cpu --devices 2`` run against the
  single-device ``--backend stream`` run (the bound of
  tests/test_torch_apg_stream.py's CLI test).
"""

import functools
import json

import numpy as np
import pytest
import torch

from tests import _torch_mesh as TM
from tests._torch_parity import jax_problem, port_inputs, to_numpy

torch.set_num_threads(2)

MAX_ITER = 40
CASES = {"422x2": ((4, 2, 2), 2), "422x4": ((4, 2, 2), 4),
         "222x4": ((2, 2, 2), 4), "2x2": ((2,), 2)}
WARM = "422x2"


@functools.lru_cache(maxsize=None)
def _problem(branching):
    eng, fa, step, kw = jax_problem(nx=4, nu=7, nd=3, ne=2, N=8,
                                    branching=branching, seed=11,
                                    max_iterations=MAX_ITER, step_size=1e-3,
                                    x0_scale=0.98)
    return eng.factor_step().prefix_stages, fa, step, kw


def _dims(fa):
    N, ns, nx = np.asarray(fa["d1"]).shape
    return N, ns, nx, np.asarray(fa["g"]).shape[-1], \
        np.asarray(fa["invWbar"]).shape[0]


def _stressed(fa):
    """A K1 state from a seed (pre-images, duals, z, scalars), a carry
    block and a dual triple; y and z of the size of converged duals, the
    pre-images around the bounds, shrinks at 0.25 and 0.5."""
    N, ns, nx, nu, nv = _dims(fa)
    rng = np.random.default_rng(3)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    st = {"pre_xi": r(N, ns, 2 * nx, scale=50.0),
          "pre_psi": r(N, ns, nu, scale=50.0),
          "y_xi": r(N, ns, 2 * nx, scale=0.1), "y_psi": r(N, ns, nu, scale=0.1),
          "z_xi": r(N, ns, 2 * nx, scale=0.01),
          "z_psi": r(N, ns, nu, scale=0.01),
          "sc": np.array([0.6, 0.7, 1.0, 0.25, 0.5], np.float32),
          "carry": r(ns, nx + nv)}
    return st, r(N, ns, 2 * nx + nu, scale=0.1)


def _jax_sharded(name):
    from rapidnet_tpu.ops.pallas_stream_sharded import \
        make_apg_stream_sharded
    from rapidnet_tpu.parallel import make_mesh
    branching, n = CASES[name]
    _, fa, step, kw = _problem(branching)
    run = make_apg_stream_sharded(make_mesh(n), fa, interpret=True, **kw)
    cold = to_numpy(run(step))
    warm = to_numpy(run(step, cold["y"])) if name == WARM else None
    return cold, warm


@pytest.fixture(scope="module")
def groups():
    """Per case: the JAX reference (cold, warm) and the port's ranks'
    results, built once, on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            branching, n = CASES[name]
            prefix, fa, step, kw = _problem(branching)
            cold, warm = _jax_sharded(name)
            st, w = _stressed(fa)
            y0 = cold["y"] if name == WARM else {
                k: np.zeros_like(v) for k, v in cold["y"].items()}
            ranks = TM.run_ranks(n, TM.apg_job, to_numpy(fa), to_numpy(step),
                                 prefix, kw, y0, st, w)
            cache[name] = {"jax": cold, "jax_warm": warm, "ranks": ranks,
                           "state": st, "w": w}
        return cache[name]

    return get


def _scaled(got, ref, factor, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    bound = factor * max(np.abs(ref).max(), 1.0)
    err = np.abs(got - ref).max()
    assert err <= bound, f"{what}: {err} > {bound}"


# ---------------------------------------------------------------- pack


@pytest.mark.parametrize("branching,n", [((4, 2, 2), 4), ((4, 2, 2), 8),
                                         ((4, 2, 2), 2), ((2, 2, 2), 4),
                                         ((2,), 2)])
def test_locality_analysis_matches_jax(branching, n):
    from rapidnet_tpu.ops.pallas_stream_sharded import \
        analyze_prefix_locality as jax_analyze
    from rapidnet_tpu_torch.ops.apg_stream_sharded import \
        analyze_prefix_locality
    _, fa, _, _ = _problem(branching)
    fa_t, _ = port_inputs(fa, _problem(branching)[2])
    assert analyze_prefix_locality(fa_t, n) == jax_analyze(fa, n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_jax(groups, name):
    """Every rank's constants against JAX's pack of the same shard."""
    from rapidnet_tpu.ops.pallas_stream_sharded import pack_stream_sharded
    branching, n = CASES[name]
    _, fa, _, _ = _problem(branching)
    jp = pack_stream_sharded(fa, n)
    nsl, NSLP = jp["nsl"], jp["dims"][5]
    N, ns = _dims(fa)[:2]
    for j, res in enumerate(groups(name)["ranks"]):
        pk = res["pack"]
        lanes = slice(j * NSLP, j * NSLP + nsl)
        assert pk["s_hi"] == jp["s_hi"] and pk["nsl"] == nsl
        assert tuple(pk["agg_stages"]) == jp["local_stages"]
        assert tuple(pk["cross_stages"]) == jp["cross_stages"]
        assert pk["ranges"][-1][1] == jp["s_hi"]
        for k in ("sq", "nhp", "rep"):
            np.testing.assert_array_equal(pk[k], jp[k][:, 0, lanes])
        # each local stage as a slot-to-slot operator: M[i, j] = 1 when
        # slot i's carry reaches slot j
        for k, s in enumerate(jp["local_stages"]):
            M = np.zeros((nsl, nsl), np.float32)
            for dst in range(nsl):
                par = pk["agg_parent"][k, dst]
                for m in range(pk["agg_ptr"][par], pk["agg_ptr"][par + 1]):
                    M[pk["agg_idx"][m], dst] += 1.0
            ref = jp["LCpT"][j, k, :nsl] @ jp["LBpT"][j, k, :, :nsl]
            np.testing.assert_array_equal(M, ref)
        R = pk["n_parents"]
        np.testing.assert_array_equal(pk["x_Cp"].T, jp["XCpT"][j, :nsl, :R])
        onehot = np.eye(R, dtype=np.float32)[pk["x_parent"]].T
        np.testing.assert_array_equal(onehot, jp["XBpT"][j, :R, :nsl])
        kids = [pk["x_idx"][pk["x_ptr"][r]:pk["x_ptr"][r + 1]]
                for r in range(R)]
        for r in range(R):
            np.testing.assert_array_equal(np.sort(kids[r]),
                                          np.flatnonzero(pk["x_Cp"][r]))
        for s, (CpT, BpT) in jp["xops_low"].items():
            Cp, parent = pk["low"][s]
            np.testing.assert_array_equal(Cp.T, CpT[j, :nsl])
            Rs = Cp.shape[0]
            np.testing.assert_array_equal(
                np.eye(Rs, dtype=np.float32)[parent].T, BpT[j, :, :nsl])


@pytest.mark.parametrize("name", sorted(CASES))
def test_parent_lists_ascend_and_match_the_block(name):
    """Every rank's kernel lists ``x_ptr``/``x_idx`` (``parent_block``)
    against its child-sum block ``x_Cp``: each parent's child slots in
    strictly ascending order (the order in which the kernel sums them,
    what keeps it bit for bit with a plain left fold) and exactly the
    row's nonzero columns; int32, and ``x_width`` = nx + nv."""
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    branching, n = CASES[name]
    prefix, fa, step, _ = _problem(branching)
    fa_t, _ = port_inputs(fa, step)
    N, ns, nx, nu, nv = _dims(fa)
    for rank in range(n):
        kc = SS.pack_stream_sharded(fa_t, n, rank, prefix_stages=prefix,
                                    max_iterations=MAX_ITER)
        ptr, idx = kc["x_ptr"], kc["x_idx"]
        assert ptr.dtype == idx.dtype == torch.int32
        assert kc["x_width"] == nx + nv and kc["nsl"] == ns // n
        R = kc["n_parents"]
        assert ptr.shape == (R + 1,) and int(ptr[0]) == 0
        Cp = kc["x_Cp"].numpy()
        assert int(ptr[-1]) == int(np.count_nonzero(Cp))
        for r in range(R):
            kids = idx[int(ptr[r]):int(ptr[r + 1])].numpy()
            assert (np.diff(kids) > 0).all(), (rank, r, kids)
            np.testing.assert_array_equal(kids, np.flatnonzero(Cp[r]))


@pytest.mark.parametrize("fault", ["width", "rows", "dtype", "device"])
def test_partial_parents_refuses_a_wrong_carry(fault):
    """The wrapper checks each call's carries against the lists' shapes
    and device (its lists are checked once, by ``parent_block``): a
    carry of another width or row count, dtype or device is refused;
    the right one runs the plain block exactly."""
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    prefix, fa, step, _ = _problem((4, 2, 2))
    fa_t, _ = port_inputs(fa, step)
    kc = SS.pack_stream_sharded(fa_t, 2, 0, prefix_stages=prefix,
                                max_iterations=MAX_ITER)
    nsl, W = kc["nsl"], kc["x_width"]
    good = torch.randn(nsl, W, generator=torch.Generator().manual_seed(0))
    assert torch.equal(SS.partial_parents(kc, good),
                       SS.partial_parents_plain(kc, good))
    bad = {"width": good[:, :-1].contiguous(), "rows": good[1:],
           "dtype": good.double(), "device": good.to("meta")}[fault]
    n0 = SS.partial_parents.launches
    with pytest.raises(ValueError, match="carry"):
        SS.partial_parents(kc, bad)
    assert SS.partial_parents.launches == n0


# --------------------------------------------------------------- solves


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_stream_matches_jax(groups, name):
    """tests/test_stream_sharded.py:70-99 on the port's ranks."""
    g = groups(name)
    ref = g["jax"]
    for out in (r["cold"] for r in g["ranks"]):
        for k in ("control", "u", "x", "v"):
            _scaled(out[k], ref[k], 1e-5, k)
        for blk in ("xi", "psi"):
            _scaled(out["y"][blk], ref["y"][blk], 1e-4, blk)
        np.testing.assert_allclose(out["primal_infeasibility"],
                                   ref["primal_infeasibility"], rtol=1e-3,
                                   atol=1e-3)
        assert int(out["iterations"]) == MAX_ITER


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_returns_the_global_solution(groups, name):
    ranks = groups(name)["ranks"]
    _, n = CASES[name]
    assert len(ranks) == n
    for r in ranks[1:]:
        for k in ("control", "u", "x", "v", "primal_infeasibility"):
            np.testing.assert_array_equal(r["cold"][k], ranks[0]["cold"][k])
    N, ns = _dims(_problem(CASES[name][0])[1])[:2]
    assert ranks[0]["cold"]["u"].shape[:2] == (N, ns)


def test_sharded_stream_warm_start_matches_jax(groups):
    """A warm start from the cold solve's duals (:102-125)."""
    g = groups(WARM)
    for r in g["ranks"]:
        _scaled(r["warm"]["control"], g["jax_warm"]["control"], 1e-4,
                "control")
        _scaled(r["warm"]["u"], g["jax_warm"]["u"], 1e-4, "u")


# ---------------------------------------------------------- plain halves


def _jax_backward(name, w, affine):
    """JAX's sharded backward sweep (``make_sharded_sweeps``) inside
    ``shard_map`` on the duals ``w`` (N, ns, D): v (N, ns, nv)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rapidnet_tpu.ops.pallas_stream_sharded import (
        make_sharded_sweeps, pack_stream_sharded, shard_map)
    from rapidnet_tpu.parallel import make_mesh
    from rapidnet_tpu.parallel.sharding import AXIS

    branching, n = CASES[name]
    _, fa, step, _ = _problem(branching)
    c = pack_stream_sharded(fa, n)
    N, ns, nx, nu, nv, NSLP, PX, PU, PV = c["dims"]
    nsl = c["nsl"]
    bwd, _ = make_sharded_sweeps(c, AXIS, affine=affine, interpret=True)
    stacked = ("LCpT", "LBpT", "XCpT", "XBpT")
    cd = {k: c[k] for k in ("sq", "nhp", "cx1", "cx2", "cu", "Bb", "LT",
                            "iW") + stacked}
    for s, (CpT, BpT) in c["xops_low"].items():
        cd[f"xlo_c{s}"], cd[f"xlo_b{s}"] = CpT, BpT

    def spec(k):
        if k in ("sq", "nhp"):
            return P(None, None, AXIS)
        if k in stacked or k.startswith("xlo_"):
            return P(AXIS, *([None] * (np.asarray(cd[k]).ndim - 1)))
        return P()

    def to_t(a, Pd):
        a = jnp.asarray(a).reshape(N, n, nsl, -1).transpose(0, 1, 3, 2)
        a = jnp.pad(a, ((0, 0), (0, 0), (0, Pd - a.shape[2]),
                        (0, NSLP - nsl)))
        return a.transpose(0, 2, 1, 3).reshape(N, Pd, n * NSLP)

    def body(cd, w1, w2, wp, beta):
        cd = {k: (v[0] if k in stacked or k.startswith("xlo_") else v)
              for k, v in cd.items()}
        return bwd(cd, w1, w2, wp, beta) if affine else bwd(cd, w1, w2, wp)

    slab = P(None, None, AXIS)
    fn = shard_map(body, mesh=make_mesh(n),
                   in_specs=({k: spec(k) for k in cd},) + (slab,) * 4,
                   out_specs=slab, check_vma=False)
    v = fn({k: jnp.asarray(v) for k, v in cd.items()},
           to_t(w[..., :nx], PX), to_t(w[..., nx:2 * nx], PX),
           to_t(w[..., 2 * nx:], PU), to_t(step["beta"], PV))
    v = np.asarray(v).reshape(N, PV, n, NSLP)[:, :nv, :, :nsl]
    return v.transpose(0, 2, 3, 1).reshape(N, ns, nv)


@pytest.mark.parametrize("name,variant", [("422x2", "solve"),
                                          ("422x2", "oracle"),
                                          ("222x4", "solve")])
def test_s1a_plain_matches_jax_per_shard(groups, name, variant):
    g = groups(name)
    ref = _jax_backward(name, g["w"], variant == "solve")
    got = np.concatenate([r["s1a"][variant] for r in g["ranks"]], axis=1)
    _scaled(got, ref, 1e-5, variant)
    if variant == "solve":          # the wrapper's CPU path is the plain one
        for r in g["ranks"]:
            np.testing.assert_array_equal(r["s1a"]["call"], r["s1a"]["solve"])


@pytest.mark.parametrize("name", ["422x2", "222x4"])
def test_partial_parents_plain_matches_jax_block(groups, name):
    from rapidnet_tpu.ops.pallas_stream_sharded import pack_stream_sharded
    branching, n = CASES[name]
    g = groups(name)
    jp = pack_stream_sharded(_problem(branching)[1], n)
    nsl = jp["nsl"]
    for j, r in enumerate(g["ranks"]):
        carry = g["state"]["carry"][j * nsl:(j + 1) * nsl]
        R = r["pack"]["n_parents"]
        ref = jp["XCpT"][j, :nsl, :R].T @ carry
        np.testing.assert_allclose(r["k1a"]["pp_plain"], ref, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(r["k1a"]["pp"], r["k1a"]["pp_plain"])


@pytest.mark.parametrize("name", ["422x4", "222x4", "2x2"])
def test_k1a_plain_matches_single_device_k1(groups, name):
    """Each rank's K1a against the single-device K1 pass on its slots and
    the stages N-1 .. s_hi; the ranks' partial parent blocks sum to the
    same total whatever the split."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    branching, n = CASES[name]
    prefix, fa, step, kw = _problem(branching)
    g = groups(name)
    fa_t, step_t = port_inputs(fa, step)
    kc = S.stream_constants(fa_t, prefix_stages=prefix,
                            max_iterations=MAX_ITER)
    st = {k: torch.from_numpy(v) for k, v in g["state"].items()}
    sc = st["sc"]
    y, z, v, _ = S.k1_plain(
        kc, step_t["beta"], {"xi": st["pre_xi"], "psi": st["pre_psi"]},
        {"xi": st["y_xi"], "psi": st["y_psi"]},
        {"xi": st["z_xi"], "psi": st["z_psi"]}, lam_prev=sc[0], lam_i=sc[1],
        upd=sc[2], k1f=sc[3], k2f=sc[4], c=kw["inv_step"],
        step=kw["step_size"], xs_upper=kw["xs_upper"])
    ref = {"y_xi": y["xi"], "y_psi": y["psi"], "z_xi": z["xi"],
           "z_psi": z["psi"], "v": v}
    nsl = _dims(fa)[1] // n
    for j, r in enumerate(g["ranks"]):
        hi = slice(r["pack"]["s_hi"], None)
        for k, full in ref.items():
            _scaled(r["k1a"][k][hi], full[hi, j * nsl:(j + 1) * nsl].numpy(),
                    1e-5, k)
        assert np.isfinite(r["k1a"]["ext"]).all()


# ------------------------------------------------------------ refusals


def test_refusals_without_a_group():
    """ns % ranks != 0, a one-rank mesh (no cross-shard stage), a mesh
    card that does not exist, no process group, a rank outside the
    mesh, a mesh whose device is not the factors'."""
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    from rapidnet_tpu_torch.parallel import Mesh, make_mesh
    prefix, fa, step, kw = _problem((4, 2, 2))
    fa_t, _ = port_inputs(fa, step)
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        SS.analyze_prefix_locality(fa_t, 3)
    with pytest.raises(ValueError, match="single-shard tree"):
        SS.pack_stream_sharded(fa_t, 1, 0, prefix_stages=prefix,
                               max_iterations=MAX_ITER)
    with pytest.raises(ValueError, match="single-shard tree"):
        SS.make_apg_stream_sharded(Mesh(0, 1, "cpu"), fa_t,
                                   prefix_stages=prefix, **kw)
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        SS.make_apg_stream_sharded(Mesh(0, 3, "cpu"), fa_t,
                                   prefix_stages=prefix, **kw)
    with pytest.raises(ValueError, match="tolerance"):
        SS.make_apg_stream_sharded(Mesh(0, 2, "cpu"), fa_t,
                                   prefix_stages=prefix, tolerance=1e-3,
                                   **kw)
    with pytest.raises(RuntimeError, match="cuda:0"):
        Mesh(0, 2, "cuda:0")
    with pytest.raises(ValueError, match="outside"):
        Mesh(2, 2, "cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(2)
    from rapidnet_tpu_torch.parallel import distributed
    assert distributed.host_local_scenario_slice(16) == slice(0, 16)
    mesh = Mesh(1, 2, "cpu")
    assert mesh.slots(16) == slice(8, 16)
    assert torch.equal(mesh.shard(torch.arange(32.).reshape(1, 16, 2)),
                       torch.arange(16., 32.).reshape(1, 8, 2))


def test_a_collective_that_never_comes_fails_the_run():
    """Rank 1 joins no collective; rank 0's waits the group's timeout
    (1 s here) and raises instead of hanging."""
    import datetime
    out = TM.run_ranks(2, TM.stall_job, 4.0, timeout=60,
                       group_timeout=datetime.timedelta(seconds=1))
    kind, waited = out[0]
    assert kind in ("RuntimeError", "DistBackendError",
                    "DistNetworkError"), kind
    assert waited < 4.0


# ----------------------------------------------------------- controller


CTRL_ITERS = {"proximalAlgorithm": 30, "globalFbeAlgorithm": 10}


@pytest.fixture(scope="module")
def controller_ranks():
    return TM.run_ranks(4, TM.controller_job, CTRL_ITERS, 2)


def _jax_controller(algorithm, backend):
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import SmpcController
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=6, branching=[4, 2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=7)
    cfg = synthetic_config(net, tree, max_iterations=CTRL_ITERS[algorithm],
                           step_size=1e-3)
    cfg.algorithm = algorithm
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend=backend)
    controls = []
    for t in range(2):
        controls.append(ctrl.control_action(t))
        ctrl.move_forward_in_time()
    return np.array(controls)


@pytest.mark.parametrize("algorithm,backend,bound", [
    ("proximalAlgorithm", "xla", 1e-4),
    ("globalFbeAlgorithm", "stream", 5e-3)])
def test_controller_mesh_stream_matches_jax(controller_ranks, algorithm,
                                            backend, bound):
    """tests/test_stream_sharded.py:128-157 and
    tests/test_qn_stream.py:254-285 on 4 port ranks: APG against the XLA
    controller, FBE against the single-device streaming one."""
    ref = _jax_controller(algorithm, backend)
    for r in controller_ranks:
        got = r[algorithm]
        assert got["route"] == "stream"
        assert got["trace"].shape == (CTRL_ITERS[algorithm],)
        np.testing.assert_allclose(got["controls"], ref, rtol=bound,
                                   atol=bound)


@pytest.mark.parametrize("case,kind,match", [
    ("auto", "NotImplementedError", "item 12b"),
    ("torch", "NotImplementedError", "item 12b"),
    ("tolerance", "NotImplementedError", "item 12b"),
    ("cuda", "ValueError", "single-device"),
    ("stream_tolerance", "ValueError", "tolerance")])
def test_controller_mesh_refusals(controller_ranks, case, kind, match):
    """On a CPU mesh: 'auto' (every tree fits the whole-solve wrapper
    there), 'torch' and a tolerance need the plain shard_map solves (not
    ported: ROADMAP item 12b); 'cuda' is single-device; 'stream' with a
    tolerance raises as it does on one device."""
    got = controller_ranks[0]["refusals"][case]
    assert got is not None and got[0] == kind and match in got[1], got


def test_cli_devices_two_ranks(tmp_path):
    """``--devices 2 --device cpu`` (two processes over a FileStore)
    against the single-device ``--backend stream`` run on the same
    files; rank 0 alone prints and writes the output."""
    from rapidnet_tpu_torch import cli
    from rapidnet_tpu_torch.io.writers import export_problem
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=8, branching=[3, 2, 2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=4, seed=7)
    cfg = synthetic_config(net, tree, max_iterations=MAX_ITER,
                           step_size=1e-3)
    paths = export_problem(net, tree, fc, cfg, tmp_path / "problem")
    out = tmp_path / "mesh.json"
    res = TM.run_ranks(2, TM.cli_job, paths["config"], str(out),
                       group=False)
    assert [rc for rc, _ in res] == [0, 0]
    assert "economic kpi" in res[0][1] and res[1][1] == ""
    single = tmp_path / "single.json"
    assert cli.main(["--config", paths["config"], "--steps", "2",
                     "--device", "cpu", "--backend", "stream",
                     "--output", str(single)]) == 0
    got, ref = json.loads(out.read_text()), json.loads(single.read_text())
    for t in range(2):
        np.testing.assert_allclose(got[f"control{t}"], ref[f"control{t}"],
                                   rtol=1e-4, atol=1e-3)
