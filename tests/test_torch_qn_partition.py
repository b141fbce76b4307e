"""The whole-solve QN kernel's flat layout and partial buffers, as
functions of the problem's sizes (``ops/qn_solve.layout``, ``partials``,
``smem``), and the batch wrapper's CPU path.

``csrc/qn_solve.cu`` cuts each instance's dual buffer into chunks and
its rows of u into tiles whose count depends on the sizes alone, never
on the batch, so an instance of a batch runs the reductions of its
single solve.  The card holds these formulas to the source's own
(``qn_solve_partials``, ``qn_solve_smem``) at every launch and in
``tests/test_torch_cuda.py``; here they are held to what the source's
design asks of them.
"""

import numpy as np
import pytest
import torch

from rapidnet_tpu_torch.ops import apg_solve as K
from rapidnet_tpu_torch.ops import qn_solve as Q

H100_SMEM = 232448
# (N, ns, nx, nu): two tiny trees, one whose parts need pads, the
# Barcelona-scale problem and the widest whole-solve tree
SHAPES = {"tiny": (6, 4, 4, 7), "tiny_wide": (8, 12, 4, 7),
          "padded": (5, 3, 3, 5), "barcelona": (24, 25, 63, 114),
          "widest": (24, 181, 63, 114)}
BATCHES = (1, 2, 7, 32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_partials_grow_with_the_batch_alone(shape):
    """Each partial buffer holds B times one instance's floats: the
    chunks and tiles of an instance do not depend on B."""
    one = Q.partials(*SHAPES[shape], 1)
    assert tuple(one) == Q.PARTIAL_KEYS
    for B in BATCHES:
        assert Q.partials(*SHAPES[shape], B) == {k: B * n
                                                 for k, n in one.items()}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_layout_covers_the_dual_buffer(shape):
    """xi from 0, psi from the next multiple of 4 floats, the buffer a
    whole number of 4-float vectors; P chunks of FLAT_THREADS vectors
    cover it with less than one chunk to spare; G tiles of TM rows cover
    the rows of u."""
    N, ns, nx, nu = SHAPES[shape]
    lay = Q.layout(N, ns, nx, nu)
    R = N * ns
    assert lay["XI"] == R * 2 * nx and lay["PS"] == R * nu
    assert lay["XP"] % 4 == 0 and 0 <= lay["XP"] - lay["XI"] < 4
    assert lay["D"] % 4 == 0 and 0 <= lay["D"] - lay["XP"] - lay["PS"] < 4
    chunk = 4 * Q.FLAT_THREADS
    assert (lay["P"] - 1) * chunk < lay["D"] <= lay["P"] * chunk
    cols = -(-nu // Q.TILE_COLS)
    TM = Q.TILE_ROWS * max(1, Q.SMOOTH_THREADS // cols)
    assert lay["G"] == -(-R // TM)
    part = Q.partials(N, ns, nx, nu, 1)
    P, G = lay["P"], lay["G"]
    assert part == {"norm_part": 2 * P, "val_part": 2 * P + 2 * G,
                    "dot_part": 4 * P, "pp": 2 * P, "champ_part": 6 * P}


def test_barcelona_layout_has_no_pads_and_fills_the_card():
    """At the Barcelona-scale sizes the buffer is the unpadded [xi | psi]
    of the earlier layout, and a single solve's flat passes run 141
    chunks, more blocks than the 25 slots they ran before and than the
    H100's 132 SMs."""
    lay = Q.layout(*SHAPES["barcelona"])
    assert lay["XP"] == lay["XI"] == 75600
    assert lay["D"] == lay["XI"] + lay["PS"] == 144000
    assert lay["P"] == 141 and lay["G"] == 19


@pytest.mark.parametrize("nu", [7, 114, 240, 600, 3000])
def test_smoothing_product_stays_under_its_cap(nu):
    """The smoothing product's shared memory (W' and du' in slabs) never
    passes SMOOTH_SMEM_CAP, well under the H100's opt-in limit, so it
    never shrinks the whole-solve gate, which the sweeps set."""
    for N, ns in ((1, 1), (24, 25), (152, 181)):
        sm = Q.layout(N, ns, 63, nu)["smooth_smem"]
        assert 0 < sm <= Q.SMOOTH_SMEM_CAP < H100_SMEM
        assert Q.smem(N, ns, 63, nu, 97) == max(K.smem(N, ns, 63, nu, 97),
                                                sm)


def test_fits_gate_keeps_its_limits():
    """At the Barcelona-scale widths the kernel takes N <= 152 stages and
    ns <= 181 scenarios on an H100, as before the smoothing product."""
    w = dict(nx=63, nu=114, nv=97, smem_limit=H100_SMEM)
    assert Q.fits(N=24, ns=181, **w) and not Q.fits(N=24, ns=182, **w)
    assert Q.fits(N=152, ns=25, **w) and not Q.fits(N=153, ns=25, **w)


def _cpu_batch(batch):
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            shared_step_tensors)
    from rapidnet_tpu_torch.engine.engine import XS_UPPER, Engine
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.apg import expand_shared_step

    cpu = torch.device("cpu")
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=11)
    tree = generate_tree(N=6, branching=[2, 2], nd=3, nu=7, seed=11)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=11)
    cfg = synthetic_config(net, tree, max_iterations=3, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    rng = np.random.default_rng(7)
    x0s = (cfg.current_x * (1.0 + 0.02 * rng.standard_normal(
        (batch, cfg.current_x.size)))).astype(np.float32)
    base, inst = shared_step_tensors(*eng.prepare_step_shared(
        fc.nominal_demand, fc.nominal_prices, x0s,
        np.tile(cfg.prev_u, (batch, 1)), np.tile(cfg.prev_demand,
                                                 (batch, 1))), cpu)
    fa = factor_tensors(factor_arrays(eng), cpu)
    kq = Q.kernel_constants(fa, prefix_stages=eng.factor_step()
                            .prefix_stages)
    kw = dict(algorithm="globalFbeAlgorithm", inv_step=1.0 / cfg.step_size,
              step_size=cfg.step_size, penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER),
              max_iterations=3, lbfgs_buffer_size=2)
    return kq, expand_shared_step(base, **inst), kw


@pytest.mark.parametrize("batch", [1, 2, 7])
def test_cpu_batch_runs_the_plain_version(batch):
    """On CPU tensors the batch wrapper runs the plain batch, whatever B:
    the same outputs, and no kernel launch counted."""
    kq, steps, kw = _cpu_batch(batch)
    n0 = Q.qn_solve_batch.launches
    got = Q.qn_solve_batch(kq, steps, None, **kw)
    assert Q.qn_solve_batch.launches == n0
    ref = Q.qn_solve_batch_plain(kq, steps, None, **kw)
    for k in ("u", "x", "primal_infeasibility", "value_fbe", "tau",
              "iterations", "line_search_trials", "lbfgs_skips"):
        assert torch.equal(got[k], ref[k]), k
    for k in ("xi", "psi"):
        assert torch.equal(got["y"][k], ref["y"][k]), k
    assert got["u"].shape[0] == batch
