"""The whole-solve kernel module (rapidnet_tpu_torch/ops/apg_solve.py).

On the CPU the wrapper runs the kernel's plain version; it is held to
both of the JAX package's single solves: the XLA path (``make_apg``) and
the Pallas kernel in interpret mode (``make_apg_pallas``), with the
JAX package's own tolerances between those two
(tests/test_pallas_apg.py:45-51): control 1e-5, u 1e-4, x atol 1e-3.
The CUDA kernel itself is checked against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests._torch_parity import SMALL, assert_close, jax_problem, port_inputs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# "stressed": tanks start above their box, so the state penalties and the
# global shrinks are active
CASES = {"nominal": dict(step_size=1e-4),
         "stressed": dict(step_size=1e-3, x0_scale=1.2)}


def _port_solve(fa, step, kw, prefix, y0=None, tolerance=None):
    from rapidnet_tpu_torch.ops import apg_solve as K
    fa_t, step_t = port_inputs(fa, step)
    kc = K.kernel_constants(fa_t, prefix_stages=prefix,
                            max_iterations=kw["max_iterations"])
    if y0 is not None:
        y0 = {k: torch.tensor(np.asarray(v)) for k, v in y0.items()}
    return K.apg_solve(kc, step_t, y0, tolerance=tolerance, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_and_pallas(case):
    from rapidnet_tpu.ops import pallas_apg
    from rapidnet_tpu.solver import apg as apg_mod

    eng, fa, step, kw = jax_problem(**SMALL, **CASES[case])
    prefix = eng.factor_step().prefix_stages
    xla = jax.jit(apg_mod.make_apg(prefix_stages=prefix, **kw))(fa, step,
                                                                 None)
    pallas = pallas_apg.make_apg_pallas(fa, interpret=True, **kw)(step)
    got = _port_solve(fa, step, kw, prefix)
    assert int(got["iterations"]) == kw["max_iterations"]
    for ref in (xla, pallas):
        assert_close(got["control"], ref["control"], rtol=1e-5, atol=1e-5)
        assert_close(got["u"], ref["u"], rtol=1e-4, atol=1e-4)
        assert_close(got["x"], ref["x"], rtol=1e-4, atol=1e-3)
    scale = max(float(np.abs(np.asarray(xla["primal_infeasibility"])).max()),
                1.0)
    assert_close(got["primal_infeasibility"], xla["primal_infeasibility"],
                 rtol=1e-4, atol=1e-4 * scale)
    for k in ("xi", "psi"):
        yref = np.asarray(xla["y"][k])
        assert_close(got["y"][k], yref, rtol=1e-4,
                     atol=1e-4 * max(np.abs(yref).max(), 1.0))


def test_tolerance_exit_matches_jax():
    """With a tolerance the plain version stops at the JAX solve's
    iteration, on the true residual magnitude, and zero-pads the trace."""
    from rapidnet_tpu.solver import apg as apg_mod

    # at this step size the residual magnitude falls below a tolerance
    # mid-budget (it rises over the first iterations in the cases above)
    eng, fa, step, kw = jax_problem(**SMALL, step_size=1e-3)
    prefix = eng.factor_step().prefix_stages
    # find that tolerance on the port's side, which compiles nothing
    for tol in np.geomspace(1e5, 1e-3, 33):
        got = _port_solve(fa, step, kw, prefix, tolerance=float(tol))
        if 1 < int(got["iterations"]) < kw["max_iterations"]:
            break
    else:
        pytest.fail("no tolerance gave a mid-budget exit")
    ref = jax.jit(apg_mod.make_apg(prefix_stages=prefix,
                                   tolerance=float(tol), **kw))(fa, step,
                                                                None)
    it = int(ref["iterations"])
    assert int(got["iterations"]) == it
    assert_close(got["control"], ref["control"], rtol=1e-5, atol=1e-5)
    trace = got["primal_infeasibility"].numpy()
    assert (trace[it:] == 0).all()
    assert_close(trace, ref["primal_infeasibility"], rtol=1e-4, atol=1e-3)


def test_warm_start_matches_jax():
    from rapidnet_tpu.solver import apg as apg_mod

    eng, fa, step, kw = jax_problem(**SMALL, **CASES["nominal"])
    prefix = eng.factor_step().prefix_stages
    rng = np.random.default_rng(2)
    N, ns, nx = np.asarray(fa["d1"]).shape
    nu = np.asarray(fa["g"]).shape[-1]
    y0 = {"xi": rng.standard_normal((N, ns, 2 * nx)).astype(np.float32),
          "psi": rng.standard_normal((N, ns, nu)).astype(np.float32)}
    ref = jax.jit(apg_mod.make_apg(prefix_stages=prefix, **kw))(fa, step, y0)
    got = _port_solve(fa, step, kw, prefix, y0=y0)
    assert_close(got["control"], ref["control"], rtol=1e-5, atol=1e-5)
    assert_close(got["u"], ref["u"], rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_inputs_the_kernel_does_not_take():
    from rapidnet_tpu_torch.ops import apg_solve as K

    eng, fa, step, kw = jax_problem(**SMALL)
    fa_t, step_t = port_inputs(fa, step)
    kc = K.kernel_constants(fa_t, prefix_stages=eng.factor_step()
                            .prefix_stages, max_iterations=25)
    bad = [dict(step_t, beta=step_t["beta"].double()),
           dict(step_t, uhat=step_t["uhat"][:, :2]),
           dict(step_t, e=step_t["e"].transpose(0, 1).contiguous()
                .transpose(0, 1))]
    for b in bad:
        with pytest.raises(ValueError):
            K.apg_solve(kc, b, None, **kw)
    with pytest.raises(ValueError, match="shape"):
        K.apg_solve(kc, step_t, None, **dict(kw, max_iterations=7))
    meta = {k: v.to("meta") for k, v in step_t.items()}
    with pytest.raises(ValueError, match="meta"):
        K.apg_solve(kc, meta, None, **kw)


def test_no_gpu_means_no_kernel_and_no_fallback(tmp_path, monkeypatch):
    """Without nvcc the build raises; a CUDA device request raises."""
    from rapidnet_tpu_torch.convert import factor_tensors
    from rapidnet_tpu_torch.ops import build
    from rapidnet_tpu_torch.solver.controller import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("apg_solve")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    _, fa, _, _ = jax_problem(**SMALL)
    with pytest.raises((RuntimeError, AssertionError)):
        factor_tensors({"L": np.asarray(fa["L"])}, "cuda")


def test_import_builds_nothing():
    """Importing the kernel modules runs no nvcc and needs none."""
    code = ("from rapidnet_tpu_torch.ops import apg_solve, build\n"
            "assert build.load.cache_info().currsize == 0\n"
            "assert apg_solve.apg_solve.launches == 0\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


H100 = dict(sm_count=132, smem_limit=232448)   # an H100's SMs and opt-in
                                               # shared memory a block


# The routing gate before the cluster-split variants, written out: one
# block a slot for the tail and forward sweeps, one block an instance for
# the prefix, nothing staged.  The variants ask for more shared memory
# only where the device has it (apg_solve.pick), so the gate must still
# take every tree this took, and refuse what it refused.
def _one_block_fits(N, ns, nx, nu, nv, limit):
    RS = -(-N // 8) * 8
    tail = (nu + nx + nv) * RS
    prefix = 2 * (nx + nv) * ns
    forward = (2 * nv + nu + nx) * RS
    return 4 * max(tail, prefix, forward) <= limit


GATE_GRID = dict(N=(1, 8, 24, 100, 152, 153, 200),
                 ns=(1, 4, 25, 181, 182, 1024),
                 nx=(1, 4, 63, 126), nu=(1, 7, 114, 228),
                 nv=(1, 5, 97, 194))


def _grid():
    import itertools
    keys = tuple(GATE_GRID)
    for vals in itertools.product(*GATE_GRID.values()):
        yield dict(zip(keys, vals))


@pytest.mark.parametrize("limit", [232448, 100 * 1024, 48 * 1024])
def test_fits_takes_every_tree_the_one_block_gate_took(limit):
    from rapidnet_tpu_torch.ops import apg_solve as K

    taken = 0
    for d in _grid():
        before = _one_block_fits(**d, limit=limit)
        assert K.fits(**d, smem_limit=limit) == before, d
        taken += before
    assert taken > 0
    assert K.fits(152, 25, 63, 114, 97, smem_limit=232448)
    assert K.fits(24, 181, 63, 114, 97, smem_limit=232448)
    assert not K.fits(153, 25, 63, 114, 97, smem_limit=232448)
    assert not K.fits(24, 182, 63, 114, 97, smem_limit=232448)


@pytest.mark.parametrize("dims,B,want", [
    # the Barcelona problem: 25 slots on clusters of 8 (200 CTAs, two a
    # SM), one prefix cluster of 8, every phase staged
    ((24, 25, 63, 114, 97), 1, (8, 8, (True, True, True))),
    # B = 32: 800 slots fill the card at C = 1, unstaged; 32 prefix
    # clusters of 4 on 128 SMs, staged
    ((24, 25, 63, 114, 97), 32, (1, 4, (False, True, False))),
    ((24, 25, 63, 114, 97), 2, (5, 8, (True, True, True))),
    # the gate's edges: N = 152 (a cluster's unstaged forward sweep does
    # not fit), ns = 181 (its prefix fits only unstaged, on 8 CTAs)
    ((152, 25, 63, 114, 97), 1, (1, 8, (False, True, False))),
    ((24, 181, 63, 114, 97), 1, (1, 8, (True, False, False))),
    ((8, 12, 4, 7, 5), 1, (8, 8, (True, True, True))),
])
def test_pick_takes_the_documented_variant(dims, B, want):
    from rapidnet_tpu_torch.ops import apg_solve as K

    got = K.pick(*dims, B, **H100)
    C, Cp, staged = want
    assert (got["cluster"], got["prefix_cluster"]) == (C, Cp), got
    assert tuple(got["staged"][ph] for ph in K.SWEEP_PHASES) == staged, got
    assert K.decode(K.encode(got)) == got
    # without cluster launch: the one-block clusters, staged as they fit
    flat = K.pick(*dims, B, clusters=False, **H100)
    assert (flat["cluster"], flat["prefix_cluster"]) == (1, 1)


def test_pick_rule_over_a_grid():
    """Over the gate's grid (every tree the gate takes, B 1 and 32): C is
    the largest cluster <= 8 with the slot CTAs within two an SM, unless
    its unstaged sweeps do not fit (then 1); Cp the largest <= 8 with the
    prefix CTAs within the SM count; a staged phase fits; the variant at
    C = Cp = 1 unstaged is the gate's formula."""
    from rapidnet_tpu_torch.ops import apg_solve as K

    room = H100["smem_limit"] - K.STATIC_RESERVE
    for d in _grid():
        dims = tuple(d.values())
        if not K.fits(*dims, smem_limit=H100["smem_limit"]):
            continue
        assert max(K.sweep_smem(*dims).values()) == K.smem(*dims)
        for B in (1, 32):
            v = K.pick(*dims, B, **H100)
            ns = d["ns"]
            best = max(c for c in range(1, 9)
                       if c == 1 or B * ns * c <= 2 * H100["sm_count"])
            plain = K.sweep_smem(*dims, best, v["prefix_cluster"])
            fits = plain["tail"] <= room and plain["forward"] <= room
            assert v["cluster"] == (best if fits else 1), (d, B, v)
            assert v["prefix_cluster"] == max(
                c for c in range(1, 9) if c == 1 or B * c <= 132) or (
                v["prefix_cluster"] == 1 and
                K.sweep_smem(*dims, 1, 8)["prefix"] > room), (d, B, v)
            st = K.sweep_smem(*dims, v["cluster"], v["prefix_cluster"],
                              (True, True, True))
            for ph, on in v["staged"].items():
                assert not on or st[ph] <= room, (d, B, v)
