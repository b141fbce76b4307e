"""The fused streaming APG iteration (rapidnet_tpu_torch/ops/apg_stream.py:
``apg_stream_fused``, ``make_apg_stream_fused``, ``fused_iteration_plain``).

On the CPU the fused wrapper runs its plain version, the two-kernel
streaming solve's (``apg_stream_plain``); it is held to the JAX package's
fused kernel in interpret mode (``pallas_stream.make_apg_stream_fused``)
on that package's branchy tree (tests/test_pallas_stream.py:210-244: nx
4, nu 7, N 8, branching [3, 2, 2], 40 iterations, tanks at 0.98 of their
maximum), cold and warm-started, with that test's bound: control, u, x
and v within 1e-5 * max(|ref|, 1).  The CUDA kernel is held to its
plain version on the card (chip_smoke.py phase 28).
"""

import numpy as np
import pytest
import torch

from tests._torch_parity import jax_problem, port_inputs

torch.set_num_threads(2)

# tests/test_pallas_stream.py:223-235
BRANCHY = dict(nx=4, nu=7, nd=3, ne=2, N=8, branching=(3, 2, 2), seed=11)
ITERS = 40
CONFIG5 = dict(N=24, ns=1024, nx=63, nu=114, nv=97)
H100_SMEM = 232448        # opt-in shared memory per block of an H100
H100_SMS = 132
BOUND = 1e-5              # tests/test_pallas_stream.py:242-244


def _problem(x0_scale=0.98):
    eng, fa, step, kw = jax_problem(**BRANCHY, max_iterations=ITERS,
                                    step_size=1e-3, x0_scale=x0_scale)
    return eng.factor_step().prefix_stages, fa, step, kw


def _scaled(got, ref, factor=BOUND):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=factor * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_fused_matches_jax_fused_kernel(start):
    from rapidnet_tpu.ops import pallas_stream
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, kw = _problem()
    jrun = pallas_stream.make_apg_stream_fused(fa, interpret=True, **kw)
    y0 = None
    if start == "warm":
        y0 = {k: np.asarray(v) for k, v in jrun(step)["y"].items()}
    ref = jrun(step) if y0 is None else jrun(step, y0)
    fa_t, step_t = port_inputs(fa, step)
    run = S.make_apg_stream_fused(fa_t, prefix_stages=prefix, **kw)
    n0 = S.apg_stream_fused.launches
    got = run(step_t, None if y0 is None else
              {k: torch.tensor(v) for k, v in y0.items()})
    assert S.apg_stream_fused.launches == n0      # the CPU launches nothing
    assert int(got["iterations"]) == ITERS
    for k in ("control", "u", "x", "v"):
        _scaled(got[k], ref[k])


def test_fused_iteration_plain_is_k1_then_k2():
    """``fused_iteration_plain`` is one ``k1_plain`` then one ``k2_plain``
    with the same scalars, from a state with nonzero duals (tanks above
    their box, which makes the state penalties active)."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    prefix, fa, step, kw = _problem(x0_scale=1.2)
    fa_t, step_t = port_inputs(fa, step)
    kc = S.stream_constants(fa_t, prefix_stages=prefix, max_iterations=ITERS)
    ps = S.plain_iterations(kc, step_t, iterations=5, **kw)
    sc = (kc["lams"][4], kc["lams"][5], 1.0, 0.25, 0.5)
    state = {"pre": ps["pre"], "y": ps["y"], "z": ps["z"]}
    got = S.fused_iteration_plain(kc, step_t, state, sc, **kw)
    y, z, v, champ = S.k1_plain(
        kc, step_t["beta"], ps["pre"], ps["y"], ps["z"], lam_prev=sc[0],
        lam_i=sc[1], upd=sc[2], k1f=sc[3], k2f=sc[4], c=kw["inv_step"],
        step=kw["step_size"], xs_upper=kw["xs_upper"])
    x, u, pre, d1sq, d2sq = S.k2_plain(
        kc, v, step_t["uhat"], step_t["e"], step_t["x0"],
        step_t["prev_u"] - step_t["prev_uhat"], y, z, lam_i=sc[1],
        c=kw["inv_step"], xs_upper=kw["xs_upper"])
    for k in ("xi", "psi"):
        assert torch.equal(got["y"][k], y[k])
        assert torch.equal(got["z"][k], z[k])
        assert torch.equal(got["pre"][k], pre[k])
    for name, ref in (("v", v), ("champion", champ), ("x", x), ("u", u),
                      ("d1sq", d1sq), ("d2sq", d2sq)):
        assert torch.equal(got[name], ref), name
    assert bool(d1sq > 0) and bool(z["xi"].abs().max() > 0)


def test_fused_fits_is_a_function_of_shapes():
    """Config 5 fits an H100 (128 blocks on 132 SMs); twice the slots, or
    fewer SMs than blocks, do not; the streaming kernels' limits hold
    too.  The fused kernel keeps v's (N, nv, TILE) tiles on chip beside
    the larger of K1's work and K2's without v, so a long horizon passes
    its shared memory before the two kernels'."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    w = dict(smem_limit=H100_SMEM, sm_count=H100_SMS)
    assert S.fused_fits(**CONFIG5, **w)
    assert not S.fused_fits(**dict(CONFIG5, ns=2048), **w)
    assert not S.fused_fits(**CONFIG5, smem_limit=H100_SMEM, sm_count=100)
    assert not S.fused_fits(**dict(CONFIG5, N=70000), **w)
    assert S.fused_smem(**CONFIG5) == 4 * S.TILE * (24 * 97 + 63 + 2 * 114)
    # 80 stages of v's tiles pass the shared memory, the two kernels not
    assert S.fused_smem(**dict(CONFIG5, N=80)) > H100_SMEM
    assert not S.fused_fits(**dict(CONFIG5, N=80), **w)
    assert S.stream_fits(**dict(CONFIG5, N=80), smem_limit=H100_SMEM)


def _tile_fused_fits(N, ns, nx, nu, nv, limit, sms):
    """The fused kernel's gate before its staged variant, written out:
    the streaming gate, v's (N, nv, TILE) tiles beside the larger of K1's
    work and K2's without v, and one block of TILE slots per SM at
    most."""
    stream = 4 * 8 * max(nx + nv + nu, 2 * nu + nx + nv)
    fused = 4 * 8 * (N * nv + max(nx + nv + nu, 2 * nu + nx))
    return (ns >= 1 and 1 <= N <= 65535 and stream <= limit and
            fused <= limit and -(-ns // 8) <= sms)


@pytest.mark.parametrize("limit", [H100_SMEM, 100 * 1024])
def test_fused_fits_takes_every_tree_the_tile_gate_took(limit):
    """Over tests/test_torch_apg_stream.py's grid of shapes (N 1-80, ns
    1-2048, widths up to 3x config 5's), ``fused_fits`` refuses no tree
    that the tile gate took, nor takes one it refused."""
    from rapidnet_tpu_torch.ops import apg_stream as S
    from tests.test_torch_apg_stream import gate_grid

    taken = 0
    for d in gate_grid():
        before = _tile_fused_fits(**d, limit=limit, sms=H100_SMS)
        assert S.fused_fits(**d, smem_limit=limit,
                            sm_count=H100_SMS) == before, d
        taken += before
    assert taken > 0


def test_config5_staged_fused_launch_fits_an_h100():
    """At config 5 the staged fused kernel (v's tiles, the larger work
    area and matrices, one K1 or two K2 operand buffers) fits a block's
    232,448 bytes with its static shared memory, by the source's
    exported formula (mirrored by ``staged_smem``), with one block on
    each of its 128 SMs."""
    from rapidnet_tpu_torch.ops import apg_stream as S

    fused = S.staged_smem(**CONFIG5)[2]
    assert fused == 220848
    assert fused + S.STATIC_SMEM <= H100_SMEM
    assert S.fused_fits(**CONFIG5, smem_limit=H100_SMEM, sm_count=H100_SMS)


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    from types import SimpleNamespace

    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.ops import build

    prefix, fa, step, kw = _problem()
    fa_t, step_t = port_inputs(fa, step)
    with pytest.raises(ValueError, match="tolerance"):
        S.make_apg_stream_fused(fa_t, prefix_stages=prefix, tolerance=1e-3,
                                **kw)
    with pytest.raises(ValueError, match="precision"):
        S.make_apg_stream_fused(fa_t, prefix_stages=prefix,
                                precision="default", **kw)
    kc = S.stream_constants(fa_t, prefix_stages=prefix, max_iterations=ITERS)
    with pytest.raises(ValueError, match="tolerance"):
        S.apg_stream_fused(kc, step_t, None, tolerance=1e-3, **kw)
    meta = {k: v.to("meta") for k, v in step_t.items()}
    with pytest.raises(ValueError, match="meta"):
        S.apg_stream_fused(kc, meta, None, **kw)
    with pytest.raises(ValueError, match="cuda only"):
        S.fused_call(kc, step_t, None, (0.0,) * 5, **kw)
    # the card's check before a launch: 2 blocks of slots on one SM
    S._check_fused(kc, smem_limit=H100_SMEM, sm_count=H100_SMS)
    with pytest.raises(ValueError, match="fused_fits"):
        S._check_fused(kc, smem_limit=H100_SMEM, sm_count=1)
    with pytest.raises(ValueError, match="ranges"):
        S._check_fused(dict(kc, ranges=((0, 0, -1),) * 33),
                       smem_limit=H100_SMEM, sm_count=H100_SMS)
    # the source's export is held to fused_smem
    dims = tuple(CONFIG5.values())
    need = S.fused_smem(*dims)
    lib = SimpleNamespace(apg_stream_fused_smem=lambda *d: need)
    build.check_smem(lib, "apg_stream_fused", dims, need)
    with pytest.raises(RuntimeError, match="shared memory"):
        build.check_smem(lib, "apg_stream_fused", dims, need - 4)
