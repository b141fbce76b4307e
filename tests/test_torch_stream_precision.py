"""The streaming kernels' one-pass bf16 products (``precision="default"``).

The JAX package's ``stream_precision="default"`` runs every in-kernel
product of its streaming kernels at one bf16 MXU pass: both operands
rounded to bfloat16, the products summed in float32.  The port's plain
halves do the same (``apg_stream.bf16_round``, ``rounding``): here, on
the CPU, they are held

* to a float64 numpy emulation that rounds the same operands in the same
  places (each product's vector operand and matrix; at each prefix
  handoff each child's carry before the sum and the parent's sum after
  it; in the shard's partial parent block each child's carry), at
  rtol = 1e-5 with atol = 1e-5 x max|emulation|: the rounding points
  agree, and what is left is float32 against float64 arithmetic between
  them;
* to the JAX package, whose DEFAULT on the CPU computes what HIGHEST
  does (tests/test_pallas_stream.py:360-379), so JAX gives the float32
  value of the same pass.  A pass's bound is elementwise and comes from
  bf16's unit roundoff u = 2^-8: each rounding multiplies a term by at
  most (1 + u), a term of an output passes through at most R roundings
  (counted per output below), so the output is off by at most
  ((1 + u)^R - 1) times the same pass run on absolute values (every
  input and matrix replaced by its magnitude, in float32), plus 1e-5 x
  max(|JAX|, 1) for float32's own rounding;
* and 2-step closed loops (APG, FBE, NAMA; one device and a 2-rank CPU
  mesh) to JAX's, whose streaming path equals its XLA path on the CPU.
  An iterative solve has no such bound, so a loop is held to the
  reference's solver-numerics tier, 1e-1 x max(|JAX|, 1)
  (docs/roofline.md:125-132: 25.6 units of u), the bound chip_smoke.py
  phase 35 holds the 500-iteration solves to on the card.

Every "default" result must also differ from the "highest" one: the
rounding happened.  The kernels themselves are held to these plain
halves on the card (chip_smoke.py phases 23 and 35).
"""

import functools

import numpy as np
import pytest
import torch

from tests import _torch_mesh as TM
from tests._torch_parity import jax_problem, port_inputs

torch.set_num_threads(2)

# tests/test_pallas_stream.py:100-134: three prefix aggregations
BRANCHY = dict(nx=4, nu=7, nd=3, ne=2, N=8, branching=(3, 2, 2), seed=11)
ITERS = 40
U = 2.0 ** -8                # bf16's unit roundoff (8 significand bits)
EMU_RTOL = 1e-5
F32_SLACK = 1e-5
LOOP_TIER = 1e-1
LOOP_ITERS = {"proximalAlgorithm": 30, "globalFbeAlgorithm": 10,
              "namaAlgorithm": 10}
LOOP_STEPS = 2


# ------------------------------------------------------------- emulation


def bf(x):
    """float64 values rounded as the port rounds its float32 operands:
    to float32, then to bfloat16 by the bits (round to nearest, ties to
    even), back in float64."""
    b = np.asarray(x, np.float64).astype(np.float32).view(np.uint32)
    b = b.astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def _np(kc):
    """The streaming constants in float64 numpy, the matrices both as they
    are and rounded (``bf``)."""
    keys = ("cx1", "cx2", "cu", "bx_min", "bx_max", "bx_s", "bu_min",
            "bu_max", "sq", "nhp", "rep", "L", "BbT", "iWT", "LT", "BT")
    n = {k: kc[k].double().numpy() for k in keys}
    n.update({f"{k}16": bf(n[k]) for k in ("L", "BbT", "iWT", "LT", "BT")})
    n["agg"] = {s: (kc["fa"]["prefix_Cp"][s].double().numpy(),
                    kc["fa"]["prefix_Bp"][s].double().numpy())
                for s in kc["agg_stages"]}
    return n


def _rows(n, key):
    return n[key][:, None, :] * n["sq"][..., None]


def _mats(n, r):
    return {k: n[f"{k}16"] if r is bf else n[k]
            for k in ("L", "BbT", "iWT", "LT", "BT")}


def emu_backward(n, w, beta, r, stages):
    """The backward recursion over ``stages`` (descending) from zero
    carries: t = d1 w1 + d2 w2 + t, a = [beta +] a + Bb r(t) + L' r(g wp),
    v = nhp iW r(a), the handoff Bp r(Cp r(.)) after each aggregation.
    Returns v (zero elsewhere) and the exit carries [t | a]."""
    nx = n["cx1"].shape[-1]
    m = _mats(n, r)
    tb = _rows(n, "cx1") * w[..., :nx] + _rows(n, "cx2") * w[..., nx:2 * nx]
    gw = r(_rows(n, "cu") * w[..., 2 * nx:])
    N, ns = w.shape[:2]
    t = np.zeros((ns, nx))
    a = np.zeros((ns, m["BbT"].shape[1]))
    v = np.zeros((N, ns, m["iWT"].shape[0]))
    for s in stages:
        t = tb[s] + t
        a = a + r(t) @ m["BbT"] + gw[s] @ m["L"]
        if beta is not None:
            a = a + beta[s]
        v[s] = n["nhp"][s][:, None] * (r(a) @ m["iWT"])
        if s in n["agg"]:
            Cp, Bp = n["agg"][s]
            t, a = Bp @ r(Cp @ r(t)), Bp @ r(Cp @ r(a))
    return v, np.concatenate([t, a], axis=-1)


def emu_forward(n, v, r, uhat=None, e=None, x0=None, pdu=None):
    """du = du + L' r(v), u = du [+ uhat], x = x + B' r(u) [+ e]."""
    m = _mats(n, r)
    ns = v.shape[1]
    nx, nu = n["cx1"].shape[-1], n["cu"].shape[-1]
    dv = r(v) @ m["LT"]
    du = np.broadcast_to(pdu, (ns, nu)) if uhat is not None else \
        np.zeros((ns, nu))
    xs = np.broadcast_to(x0, (ns, nx)) if uhat is not None else \
        np.zeros((ns, nx))
    x, u = [], []
    for s in range(v.shape[0]):
        du = du + dv[s]
        us = uhat[s] + du if uhat is not None else du
        xs = xs + r(us) @ m["BT"]
        if uhat is not None:
            xs = xs + e[s]
        x.append(xs)
        u.append(us)
    return np.stack(x), np.stack(u)


def emu_dual(n, pre, y, z, sc, c, step, xs_upper):
    """K1's dual update and extrapolation (no product): y', z', w and the
    residuals."""
    lam_prev, lam_i, upd, k1f, k2f = sc
    nx = n["cx1"].shape[-1]

    def res(p, wp, lo, hi, shrink):
        return (1.0 - shrink) * (p - np.minimum(np.maximum(p, lo), hi)) - \
            c * wp

    wp = {k: y[k] + lam_prev * z[k] for k in y}
    r_xi = np.concatenate([
        res(pre["xi"][..., :nx], wp["xi"][..., :nx], _rows(n, "bx_min"),
            _rows(n, "bx_max"), k1f),
        res(pre["xi"][..., nx:], wp["xi"][..., nx:], _rows(n, "bx_s"),
            xs_upper, k2f)], axis=-1)
    r_psi = res(pre["psi"], wp["psi"], _rows(n, "bu_min"),
                _rows(n, "bu_max"), 0.0)
    res_ = {"xi": r_xi, "psi": r_psi}
    y_n = {k: y[k] + upd * (lam_prev * z[k] + step * res_[k]) for k in y}
    z_n = {k: y_n[k] - y[k] for k in y}
    w = np.concatenate([y_n[k] + lam_i * z_n[k] for k in ("xi", "psi")],
                       axis=-1)
    return y_n, z_n, w


def emu_k2_pre(n, x, u, y, z, lam_i, c):
    nx = n["cx1"].shape[-1]
    w = {k: y[k] + lam_i * z[k] for k in y}
    return {"xi": np.concatenate([_rows(n, "cx1") * x + c * w["xi"][..., :nx],
                                  _rows(n, "cx2") * x + c * w["xi"][..., nx:]],
                                 axis=-1),
            "psi": _rows(n, "cu") * u + c * w["psi"]}


# --------------------------------------------------------------- problem


def _problem(x0_scale=1.2, iters=ITERS):
    eng, fa, step, kw = jax_problem(**BRANCHY, max_iterations=iters,
                                    step_size=1e-3, x0_scale=x0_scale)
    return eng.factor_step().prefix_stages, fa, step, kw


@pytest.fixture(scope="module")
def problem():
    """The branchy tree with the tanks above their box, its streaming
    constants and a stressed state: the duals, pre-images and v after 5
    plain iterations (float32), and the scalars of iteration 5."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    prefix, fa, step, kw = _problem()
    fa_t, step_t = port_inputs(fa, step)
    kc = S.stream_constants(fa_t, prefix_stages=prefix, max_iterations=ITERS)
    st = S.plain_iterations(kc, step_t, iterations=5, **kw)
    lams = kc["lams"]
    sc = (float(lams[4]), float(lams[5]), 1.0, 0.25, 0.5)
    return dict(prefix=prefix, fa=fa, step=step, kw=kw, fa_t=fa_t,
                step_t=step_t, kc=kc, st=st, sc=sc)


def _emu_close(got, ref, what):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=EMU_RTOL,
                               atol=EMU_RTOL * np.abs(ref).max(),
                               err_msg=what)


def _differs(a, b):
    assert not torch.equal(a, b)


# ------------------------------------------------------------ rounding


def test_bf16_round_matches_the_bit_emulation():
    """``bf16_round`` against the bit emulation on ties (even and odd
    neighbours, both signs), the largest finite values (float32's max
    rounds past bfloat16's to inf), tiny and subnormal values, zeros and
    a seeded spread."""
    from rapidnet_tpu_torch.ops.apg_stream import bf16_round
    ties = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8),
            -(1 + 3 * 2.0 ** -8), 2.0 ** 100 * (1 + 2.0 ** -8)]
    big = [3.3895313892515355e38, 3.3961776e38, 3.4028234663852886e38,
           -3.4028234663852886e38]
    tiny = [1.1754943508222875e-38, 1e-40, -1e-44, 1.4e-45, 0.0, -0.0]
    rng = np.random.default_rng(0)
    spread = rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
    x = np.array(ties + big + tiny + spread.tolist(), np.float32)
    got = bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  bf(x).astype(np.float32).view(np.uint32))
    assert got[0] == 1.0 and got[1] == 1 + 2.0 ** -6     # ties to even
    assert np.isinf(got[len(ties) + 2])


def test_default_gates_grow_by_the_rounded_copies():
    """At "default" K1's (S1's) work area holds t and inner rounded
    beside the carries, K2's (S2's) u rounded beside u: the gates grow by
    exactly those tiles, and every staged variant still takes config 5 on
    an H100 (232,448 bytes of opt-in shared memory a block, less the
    kernels' static shared memory); any other precision raises."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    N, ns, nx, nu, nv = dims = (24, 1024, 63, 114, 97)
    tile = 4 * S.TILE
    high, low = S.staged_smem(*dims), S.staged_smem(*dims, "default")
    assert low[0] - high[0] == tile * (nx + nv)
    assert low[1] - high[1] == tile * nu
    assert low[2] - high[2] == tile * (
        max(nx + nv + nu + nx + nv, 2 * nu + nx + nu) -
        max(nx + nv + nu, 2 * nu + nx))
    assert all(b + S.STATIC_SMEM <= 232448 for b in low)
    assert S.smem(*dims, "default") - S.smem(*dims) == tile * nu
    assert SQ.smem(*dims, "default") == S.smem(*dims, "default")
    assert S.fused_fits(*dims, smem_limit=232448, sm_count=132,
                        precision="default")
    for fn in (S.smem, SQ.smem, S.staged_smem, S.fused_smem):
        with pytest.raises(ValueError, match="precision"):
            fn(*dims, "high")


# ------------------------------------------------- plain vs emulation


def test_k1_k2_and_fused_plain_equal_the_emulation(problem):
    from rapidnet_tpu_torch.ops import apg_stream as S
    kc, st, sc, kw, step_t = (problem[k] for k in
                              ("kc", "st", "sc", "kw", "step_t"))
    n = _np(kc)
    c = kw["inv_step"]
    scal = dict(lam_prev=sc[0], lam_i=sc[1], upd=sc[2], k1f=sc[3],
                k2f=sc[4], c=c, step=kw["step_size"],
                xs_upper=kw["xs_upper"])
    d = {k: {j: st[k][j].double().numpy() for j in ("xi", "psi")}
         for k in ("pre", "y", "z")}
    beta = step_t["beta"].double().numpy()
    y_n, z_n, w = emu_dual(n, d["pre"], d["y"], d["z"], sc, c,
                           kw["step_size"], kw["xs_upper"])
    N = beta.shape[0]
    v_ref, _ = emu_backward(n, w, beta, bf, range(N - 1, -1, -1))
    got = S.k1_plain(kc, step_t["beta"], st["pre"], st["y"], st["z"],
                     precision="default", **scal)
    high = S.k1_plain(kc, step_t["beta"], st["pre"], st["y"], st["z"],
                      **scal)
    for k in ("xi", "psi"):
        _emu_close(got[0][k], y_n[k], f"y.{k}")
        _emu_close(got[1][k], z_n[k], f"z.{k}")
    _emu_close(got[2], v_ref, "k1 v")
    _differs(got[2], high[2])
    # K2 from the "default" K1's outputs
    sd = {k: step_t[k].double().numpy() for k in ("uhat", "e", "x0",
                                                  "prev_u", "prev_uhat")}
    pdu = sd["prev_u"] - sd["prev_uhat"]
    x_ref, u_ref = emu_forward(n, got[2].double().numpy(), bf, sd["uhat"],
                               sd["e"], sd["x0"], pdu)
    k2 = S.k2_plain(kc, got[2], step_t["uhat"], step_t["e"], step_t["x0"],
                    step_t["prev_u"] - step_t["prev_uhat"], got[0], got[1],
                    lam_i=sc[1], c=c, xs_upper=kw["xs_upper"],
                    precision="default")
    _emu_close(k2[0], x_ref, "k2 x")
    _emu_close(k2[1], u_ref, "k2 u")
    pre = emu_k2_pre(n, x_ref, u_ref, {k: got[0][k].double().numpy()
                                       for k in ("xi", "psi")},
                     {k: got[1][k].double().numpy() for k in ("xi", "psi")},
                     sc[1], c)
    for k in ("xi", "psi"):
        _emu_close(k2[2][k], pre[k], f"k2 pre.{k}")
    _differs(k2[0], S.k2_plain(
        kc, got[2], step_t["uhat"], step_t["e"], step_t["x0"],
        step_t["prev_u"] - step_t["prev_uhat"], got[0], got[1],
        lam_i=sc[1], c=c, xs_upper=kw["xs_upper"])[0])
    # the fused iteration: K1 then K2 at the same precision
    fused = S.fused_iteration_plain(
        kc, step_t, {k: st[k] for k in ("pre", "y", "z")}, sc,
        precision="default", **kw)
    _emu_close(fused["v"], v_ref, "fused v")
    _emu_close(fused["x"], x_ref, "fused x")
    _emu_close(fused["u"], u_ref, "fused u")


@pytest.mark.parametrize("affine", [True, False], ids=["solve", "oracle"])
def test_s1_s2_plain_equal_the_emulation(problem, affine):
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    kc, st, step_t = problem["kc"], problem["st"], problem["step_t"]
    n = _np(kc)
    w_t = torch.cat([st["y"]["xi"], st["y"]["psi"]], dim=-1).contiguous()
    w = w_t.double().numpy()
    N = w.shape[0]
    beta = step_t["beta"] if affine else None
    v_ref, _ = emu_backward(n, w, None if beta is None else
                            beta.double().numpy(), bf, range(N - 1, -1, -1))
    got_v = SQ.s1_plain(kc, w_t, beta, precision="default")
    _emu_close(got_v, v_ref, "s1 v")
    _differs(got_v, SQ.s1_plain(kc, w_t, beta))
    aff = ((step_t["uhat"], step_t["e"], step_t["x0"],
            step_t["prev_u"] - step_t["prev_uhat"]) if affine else ())
    x_ref, u_ref = emu_forward(n, got_v.double().numpy(), bf,
                               *(a.double().numpy() for a in aff))
    x, u, images = SQ.s2_plain(kc, got_v, *aff, precision="default")
    _emu_close(x, x_ref, "s2 x")
    _emu_close(u, u_ref, "s2 u")
    _emu_close(images[..., -u_ref.shape[-1]:],
               _rows(n, "cu") * u_ref, "s2 images")
    _differs(x, SQ.s2_plain(kc, got_v, *aff)[0])


def test_k1a_and_parent_block_plain_equal_the_emulation(problem):
    """K1a on each of two shards (one process: the pack needs no group):
    the recursion over stages N-1 .. s_hi with the shard's local
    handoffs, and the partial parent block, which rounds each child's
    carry before its float32 sum and not the sum."""
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    prefix, kw, fa_t, step_t, st, sc = (problem[k] for k in (
        "prefix", "kw", "fa_t", "step_t", "st", "sc"))
    N = fa_t["d1"].shape[0]
    for rank in range(2):
        kc = SS.pack_stream_sharded(fa_t, 2, rank, prefix_stages=prefix,
                                    max_iterations=ITERS)
        n = _np(kc)
        stl = SS.shard_step(kc, step_t)
        sl = kc["slots"]
        outs = {}
        for precision in ("default", "highest"):
            state = SS.new_state(kc, stl, None, ITERS)
            for k in ("pre", "y", "z"):
                for j in ("xi", "psi"):
                    state[f"{k}_{j}"].copy_(st[k][j][:, sl])
            state["sc"].copy_(torch.tensor(sc))
            outs[precision] = (SS.k1a_plain(kc, stl, state,
                                            precision=precision, **kw),
                               state["v"].clone())
        (ext, parents), v = outs["default"]
        d = {k: {j: st[k][j][:, sl].double().numpy() for j in ("xi", "psi")}
             for k in ("pre", "y", "z")}
        _, _, w = emu_dual(n, d["pre"], d["y"], d["z"], sc, kw["inv_step"],
                           kw["step_size"], kw["xs_upper"])
        v_ref, carry = emu_backward(n, w, stl["beta"].double().numpy(), bf,
                                    range(N - 1, kc["s_hi"] - 1, -1))
        hs = slice(kc["s_hi"], N)
        _emu_close(v[hs], v_ref[hs], f"rank {rank} k1a v")
        x_cp = kc["x_Cp"].double().numpy()
        _emu_close(parents, x_cp @ bf(carry), f"rank {rank} parents")
        _differs(v, outs["highest"][1])
        _differs(parents, outs["highest"][0][1])
        # the parent block alone, on a seeded carry
        c32 = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            (kc["nsl"], kc["x_width"])).astype(np.float32))
        got = SS.partial_parents(kc, c32, precision="default")
        _emu_close(got, x_cp @ bf(c32.double().numpy()), "parent block")
        _differs(got, SS.partial_parents(kc, c32))


# ------------------------------------------------------ against the JAX


def _magnitude(kc):
    """The constants with every row and matrix replaced by its magnitude,
    at "highest": a pass run on them bounds each output's sum of |terms|."""
    mag = dict(kc)
    for k in ("cx1", "cx2", "cu", "nhp", "L", "BbT", "iWT", "LT", "BT"):
        mag[k] = kc[k].abs()
    return mag


def _within(got, ref, mag, R, what):
    """|got - ref| <= ((1 + u)^R - 1) mag + F32_SLACK max(|ref|, 1),
    elementwise."""
    got, ref, mag = (np.asarray(a, np.float64) for a in (got, ref, mag))
    bound = ((1 + U) ** R - 1) * mag + \
        F32_SLACK * max(np.abs(ref).max(), 1.0)
    excess = np.abs(got - ref) - bound
    assert excess.max() <= 0, f"{what}: over its bound by {excess.max()}"


def _rounds(kc):
    """R per output of a pass: each handoff rounds a carry twice, and a
    term of v passes the handoffs of t, one rounding of t and of Bb (or of
    g wp and L), the handoffs of a, and the roundings of inner and iW;
    v's error reaches x through the roundings of v and L', and of u and
    B'."""
    H = len(kc["agg_stages"])
    r_v = 4 * H + 4
    return {"v": r_v, "u": r_v + 2, "x": r_v + 4, "s2_u": 2, "s2_x": 4}


@pytest.mark.parametrize("affine", [True, False], ids=["solve", "oracle"])
def test_sweeps_stay_within_the_roundoff_bound_of_jax(problem, affine):
    """One S1 and one S2 pass at "default" against JAX's
    ``make_stream_sweeps(precision="default")`` in interpret mode."""
    import jax.numpy as jnp
    from rapidnet_tpu.ops import pallas_stream
    from rapidnet_tpu.ops.pallas_stream_qn import make_stream_sweeps
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    fa, step, kc, st, step_t = (problem[k] for k in
                                ("fa", "step", "kc", "st", "step_t"))
    consts = pallas_stream.pack_stream_constants(fa)
    N, ns, nx, nu, nv, NSP, PX, PU, PV = consts["dims"]
    bwd, fwd = make_stream_sweeps(consts, affine=affine, interpret=True,
                                  precision="default")
    cd = {k: jnp.asarray(consts[k]) for k in
          ("sq", "nhp", "cx1", "cx2", "cu", "Bb", "LT", "iW", "L", "B",
           "CpT", "BpT")}
    w_t = torch.cat([st["y"]["xi"], st["y"]["psi"]], dim=-1).contiguous()
    w = w_t.numpy()
    sp = pallas_stream.pack_stream_step(step, consts["dims"])

    def to_t(a, P):
        return pallas_stream._to_t(a, NSP, P)

    wj = (to_t(w[..., :nx], PX), to_t(w[..., nx:2 * nx], PX),
          to_t(w[..., 2 * nx:], PU))
    beta = step_t["beta"] if affine else None
    got_v = SQ.s1_call(kc, w_t, beta, precision="default")
    ref_v = pallas_stream._from_t(bwd(cd, *wj, *((sp["beta"],) if affine
                                                  else ())), ns, nv)
    mag = _magnitude(kc)
    R = _rounds(kc)
    mag_v = SQ.s1_plain(mag, w_t.abs(), None if beta is None else beta.abs())
    _within(got_v, ref_v, mag_v, R["v"], "s1 v")
    aff = ((step_t["uhat"], step_t["e"], step_t["x0"],
            step_t["prev_u"] - step_t["prev_uhat"]) if affine else ())
    v_in = torch.from_numpy(np.array(ref_v, np.float32))
    x, u, _ = SQ.s2_call(kc, v_in, *aff, precision="default")
    ref = fwd(cd, to_t(np.asarray(ref_v), PV),
              *((sp["uhat"], sp["e"], sp["x0"], sp["pdu"]) if affine
                else ()))
    x_ref, u_ref = (pallas_stream._from_t(a, ns, d) for a, d in
                    zip(ref[:2], (nx, nu)))
    mag_x, mag_u, _ = SQ.s2_plain(mag, v_in.abs(),
                                  *(a.abs() for a in aff))
    _within(u, u_ref, mag_u, R["s2_u"], "s2 u")
    _within(x, x_ref, mag_x, R["s2_x"], "s2 x")
    _differs(x, SQ.s2_call(kc, v_in, *aff)[0])


def test_apg_iteration_stays_within_the_roundoff_bound_of_jax(problem):
    """One streaming APG iteration (K1, K2 and the tail) from the
    stressed duals at "default", against JAX's ``make_apg_stream(
    precision="default")`` in interpret mode: v, u and x by their
    bounds."""
    from rapidnet_tpu.ops import pallas_stream
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    prefix, fa, step, kw, fa_t, step_t, st = (problem[k] for k in (
        "prefix", "fa", "step", "kw", "fa_t", "step_t", "st"))
    kw1 = dict(kw, max_iterations=1)
    y0 = {k: st["y"][k].contiguous() for k in ("xi", "psi")}
    ref = pallas_stream.make_apg_stream(fa, interpret=True,
                                        precision="default", **kw1)(
        step, {k: y0[k].numpy() for k in y0})
    kc = S.stream_constants(fa_t, prefix_stages=prefix, max_iterations=1)
    got = S.make_apg_stream_kernel(fa_t, prefix_stages=prefix, consts=kc,
                                   precision="default", **kw1)(step_t, y0)
    # the first iteration updates no dual: w = y0
    w = torch.cat([y0["xi"], y0["psi"]], dim=-1)
    mag = _magnitude(kc)
    mag_v = SQ.s1_plain(mag, w.abs(), step_t["beta"].abs())
    pdu = step_t["prev_u"] - step_t["prev_uhat"]
    mag_x, mag_u, _ = SQ.s2_plain(mag, mag_v, step_t["uhat"].abs(),
                                  step_t["e"].abs(), step_t["x0"].abs(),
                                  pdu.abs())
    R = _rounds(kc)
    _within(got["v"], ref["v"], mag_v, R["v"], "v")
    _within(got["u"], ref["u"], mag_u, R["u"], "u")
    _within(got["x"], ref["x"], mag_x, R["x"], "x")
    high = S.make_apg_stream_kernel(fa_t, prefix_stages=prefix, consts=kc,
                                    **kw1)(step_t, y0)
    _differs(got["v"], high["v"])


# ------------------------------------------------------- closed loops


@pytest.fixture(scope="module")
def mesh_loops():
    """The 2-rank CPU mesh's loops at both precisions, started before the
    single-device references are computed; a call returns the ranks'
    results (waited for once)."""
    ranks = TM.Ranks(2, TM.precision_job, LOOP_ITERS, LOOP_STEPS,
                     ("default", "highest"))
    yield functools.cache(ranks.wait)
    ranks.stop()


def _jax_loop(algorithm):
    """JAX's XLA controller on ``TM.mesh_controller``'s problem: its
    controls over LOOP_STEPS steps."""
    from rapidnet_tpu.model.config import synthetic_config
    from rapidnet_tpu.model.forecaster import synthetic_forecaster
    from rapidnet_tpu.model.network import synthetic_network
    from rapidnet_tpu.model.scenario_tree import generate_tree
    from rapidnet_tpu.solver.controller import SmpcController
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=7)
    tree = generate_tree(N=6, branching=[4, 2], nd=3, nu=7, seed=7)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=7)
    cfg = synthetic_config(net, tree, max_iterations=LOOP_ITERS[algorithm],
                           step_size=1e-3)
    cfg.algorithm = algorithm
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend="xla")
    controls = []
    for t in range(LOOP_STEPS):
        controls.append(ctrl.control_action(t))
        ctrl.move_forward_in_time()
    return np.array(controls)


def _port_loop(algorithm, precision):
    ctrl = TM.mesh_controller(None, algorithm, "stream",
                              LOOP_ITERS[algorithm],
                              stream_precision=precision)
    controls = []
    for t in range(LOOP_STEPS):
        controls.append(ctrl.control_action(t))
        ctrl.move_forward_in_time()
    assert ctrl.route == "stream"
    return np.array(controls)


def _tier(got, ref, what):
    err = np.abs(got - ref).max()
    bound = LOOP_TIER * max(np.abs(ref).max(), 1.0)
    assert err <= bound, f"{what}: {err} > {bound}"


@pytest.mark.parametrize("algorithm", sorted(LOOP_ITERS))
def test_closed_loops_at_default_stay_within_the_tier_of_jax(mesh_loops,
                                                             algorithm):
    """2-step loops of ``SmpcController(backend="stream",
    stream_precision="default")`` on one device and on a 2-rank mesh,
    within the solver-numerics tier of JAX's; the mesh's loop against
    the single-device one by the same tier (its parent block rounds once
    where the single-device handoff rounds twice, module docstring of
    ``apg_stream_sharded``); neither equal to its "highest" loop."""
    ref = _jax_loop(algorithm)
    one = _port_loop(algorithm, "default")
    _tier(one, ref, "one device")
    assert not np.array_equal(one, _port_loop(algorithm, "highest"))
    out = mesh_loops()
    for rank, got in enumerate(out):
        controls, route = got[(algorithm, "default")]
        assert route == "stream"
        _tier(controls, ref, f"rank {rank}")
        _tier(controls, one, f"rank {rank} against one device")
        np.testing.assert_array_equal(controls, out[0][(algorithm,
                                                        "default")][0])
        assert not np.array_equal(controls,
                                  got[(algorithm, "highest")][0])
