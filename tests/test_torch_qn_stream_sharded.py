"""The scenario-sharded streaming FBE/NAMA solve of the port on a CPU mesh.

``rapidnet_tpu_torch/solver/qn_stream.make_qn_stream(mesh=...)``: every
rank's block of the dual triple and of the L-BFGS history, the sharded
backward sweep (``ops/stream_qn.s1a_call``), S2 on the block, and every
reduction all-reduced.  The ranks are gloo CPU processes
(tests/_torch_mesh.py: one group per rank count, in a module-scoped
fixture); JAX runs here on the conftest's 8-device virtual mesh, its
``make_qn_stream(mesh=make_mesh(n))`` with the Pallas kernels in
interpret mode.  The problem is tests/test_qn_stream.py:211-247's
([4, 2, 2], N = 8, 12 iterations, buffer 5, tanks at 0.98 of their
maximum), built from its seeds with the in-repo generators.  Bound, that
test's: control, u and x within 1e-3 * max(|ref|, 1), tau within 0.51
(the shards sum in another order, and the line search branches on the
sums); for FBE and NAMA over 2 and 4 ranks.

The bf16 history rounds every stored difference to 8 bits, so a one-ulp
float32 difference between two implementations can move a stored value
by 2^-8 of itself: on this problem the port's and JAX's single-device
bf16 FBE solves already differ by 1.3e-3 of max(|control|, 1), with
float32 histories by 2e-6, and the port's sharded and single-device bf16
solves differ in u by 1.4e-3.  So the sharded bf16 solve's control is
held to the port's single-device bf16 solve's within 1e-3 (the control
rule of tests/test_torch_qn_stream.py's bf16 test), and its control, u
and x to JAX's sharded bf16 solve within 1e-2.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_mesh as TM
from tests._torch_parity import jax_problem, to_numpy

torch.set_num_threads(2)

ITERS = 12
FBE, NAMA = "globalFbeAlgorithm", "namaAlgorithm"
RUNS = {2: ((FBE, "float32"), (NAMA, "float32"), (FBE, "bfloat16")),
        4: ((FBE, "float32"), (NAMA, "float32"))}
CASES = [(n, alg, dtype) for n, runs in RUNS.items() for alg, dtype in runs]
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def _problem():
    eng, fa, step, kw = jax_problem(nx=4, nu=7, nd=3, ne=2, N=8,
                                    branching=(4, 2, 2), seed=11,
                                    max_iterations=ITERS, step_size=1e-3,
                                    x0_scale=0.98)
    return eng.factor_step().prefix_stages, fa, step, kw


@functools.lru_cache(maxsize=None)
def _jax(n, algorithm, dtype):
    from rapidnet_tpu.parallel import make_mesh
    from rapidnet_tpu.solver.qn_stream import make_qn_stream
    _, fa, step, kw = _problem()
    return to_numpy(make_qn_stream(
        fa, algorithm=algorithm, lbfgs_buffer_size=5, interpret=True,
        mesh=make_mesh(n), lbfgs_dtype=JAX_DTYPE[dtype], **kw)(step))


@pytest.fixture(scope="module")
def ranks():
    """The port's ranks' solves per rank count, on first use."""
    cache = {}

    def get(n):
        if n not in cache:
            prefix, fa, step, kw = _problem()
            cache[n] = TM.run_ranks(n, TM.qn_job, to_numpy(fa),
                                    to_numpy(step), prefix, kw, RUNS[n])
        return cache[n]

    return get


def _scaled(got, ref, factor, what):
    bound = factor * max(np.abs(ref).max(), 1.0)
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    assert err <= bound, f"{what}: {err} > {bound}"


def _single(algorithm, dtype):
    """The port's single-device streaming solve of the problem."""
    from rapidnet_tpu_torch.convert import factor_tensors, step_tensors
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream
    prefix, fa, step, kw = _problem()
    return to_numpy(make_qn_stream(
        factor_tensors(to_numpy(fa), "cpu"), algorithm=algorithm,
        prefix_stages=prefix, lbfgs_buffer_size=5, lbfgs_dtype=dtype,
        **kw)(step_tensors(to_numpy(step), "cpu")))


@pytest.mark.parametrize("n,algorithm,dtype", CASES)
def test_sharded_qn_matches_jax(ranks, n, algorithm, dtype):
    ref = _jax(n, algorithm, dtype)
    bound = 1e-3 if dtype == "float32" else 1e-2
    single = _single(algorithm, dtype) if dtype == "bfloat16" else None
    for r in ranks(n):
        out = r[(algorithm, dtype)]
        for k in ("control", "u", "x"):
            _scaled(out[k], ref[k], bound, k)
        if single is not None:
            _scaled(out["control"], single["control"], 1e-3,
                    "single-device control")
        np.testing.assert_allclose(out["tau"], ref["tau"], atol=0.51)
        assert out["value_fbe"].shape == ref["value_fbe"].shape == (ITERS,)
        assert int(out["iterations"]) == ITERS


@pytest.mark.parametrize("n", sorted(RUNS))
def test_every_rank_returns_the_same_solve(ranks, n):
    """The ranks take the same decisions from the same reduced scalars:
    their gathered outputs are equal."""
    res = ranks(n)
    for key in RUNS[n]:
        for r in res[1:]:
            for k in ("control", "u", "x", "v", "tau", "value_fbe",
                      "primal_infeasibility"):
                np.testing.assert_array_equal(r[key][k], res[0][key][k])
            for blk in ("xi", "psi"):
                np.testing.assert_array_equal(r[key]["y"][blk],
                                              res[0][key]["y"][blk])


def test_bf16_history_stays_near_f32(ranks):
    """The bf16 history's control within 1e-1 * max(|f32|, 1) of the f32
    one's (chip_smoke.py's bound), on the mesh."""
    out = ranks(2)[0]
    _scaled(out[(FBE, "bfloat16")]["control"], out[(FBE, "float32")]["control"],
            1e-1, "control")


def test_mesh_refuses_packed_constants():
    """``consts`` are the single-device pack; on a mesh each rank packs
    its own block."""
    from rapidnet_tpu_torch.convert import factor_tensors
    from rapidnet_tpu_torch.ops import apg_stream as S
    from rapidnet_tpu_torch.parallel import Mesh
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream
    prefix, fa, _, kw = _problem()
    fa_t = factor_tensors(to_numpy(fa), "cpu")
    kc = S.stream_constants(fa_t, prefix_stages=prefix, max_iterations=ITERS)
    with pytest.raises(ValueError, match="per shard"):
        make_qn_stream(fa_t, algorithm=FBE, prefix_stages=prefix,
                       lbfgs_buffer_size=5, consts=kc, mesh=Mesh(0, 2, "cpu"),
                       **kw)
    with pytest.raises(ValueError, match="single-shard tree"):
        make_qn_stream(fa_t, algorithm=NAMA, prefix_stages=prefix,
                       lbfgs_buffer_size=5, mesh=Mesh(0, 1, "cpu"), **kw)
