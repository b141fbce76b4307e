"""The port's config ladder (rapidnet_tpu_torch/bench_ladder.py) and the
bf16 Nesterov difference of the plain APG solve (``dual_dtype``).

On the CPU every ladder row runs its wrappers' plain versions.  The
ladder is held to the JAX package's ``bench_ladder.py`` (imported here,
never by the port) on config 2 (dims (3, 6, 4, 2), H 12, branching [2],
untuned) at 20 iterations: for each backend the port's solver and the
JAX ladder's ``_solver`` on the same state give the same control, APG
rows within 1e-5 * max(|ref|, 1) (tests/test_pallas_apg.py:45-51), the
FBE row at rtol 1e-3 / atol 1e-4 (tests/test_pallas_qn.py:85-89).  The
plain APG solve with a bf16 z is held to JAX's ``make_apg(dual_dtype=
jnp.bfloat16)`` on the SMALL problem with its tanks above their box:
control and u within 1e-4 * max(|ref|, 1), y within 1e-3 * max(|ref|,
1), ten times the float32 solve's bounds (tests/test_pallas_apg.py:45-51,
tests/test_pallas_stream.py:63-97), for z's 8-bit mantissa.
"""

import json

import numpy as np
import pytest
import torch

from tests._torch_parity import SMALL, jax_problem, port_inputs

torch.set_num_threads(2)

ITERS = 20
CONFIG2 = dict(dims=(3, 6, 4, 2), N=12, branching=[2])
ROW_KEYS = {"config", "nodes", "scenarios", "N", "iters", "path", "data",
            "batch", "p50_ms", "solves_per_s", "launches"}


def test_ladder_writes_its_rows(tmp_path):
    from rapidnet_tpu_torch import bench_ladder as L

    out = tmp_path / "ladder.json"
    assert L.main(["--device", "cpu", "--only", "2_binary", "--repeats",
                   "1", "--max-iter", str(ITERS), "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["device"].startswith("cpu")
    (row,) = doc["rows"]
    assert set(row) == ROW_KEYS
    assert row["config"] == "2_binary_tree_H12"
    assert (row["nodes"], row["scenarios"], row["N"]) == (23, 2, 12)
    assert (row["iters"], row["batch"], row["data"]) == (ITERS, 1,
                                                          "synthetic")
    assert row["path"] == "cpu:apg_solve" and row["launches"] == {}
    assert row["p50_ms"] > 0
    assert row["solves_per_s"] == pytest.approx(1e3 / row["p50_ms"])


def test_a_failing_row_is_recorded_and_exits_nonzero(tmp_path, monkeypatch):
    """The batch-16 row raises: it is recorded with its error, the single
    row beside it still runs, and ``main`` returns nonzero."""
    from rapidnet_tpu_torch import bench_ladder as L

    solver = L.solver

    def broken(problem, backend=None, *, batch=None):
        if batch:
            raise RuntimeError("launch refused")
        return solver(problem, backend, batch=batch)

    monkeypatch.setattr(L, "solver", broken)
    out = tmp_path / "ladder.json"
    assert L.main(["--device", "cpu", "--only", "4_barcelona", "--repeats",
                   "1", "--max-iter", "3", "--out", str(out)]) == 1
    rows = {r["config"]: r for r in json.loads(out.read_text())["rows"]}
    assert "launch refused" in rows["4_barcelona_556node_H24_batch16"][
        "error"]
    assert "p50_ms" in rows["4_barcelona_556node_H24"]


@pytest.fixture(scope="module")
def config2():
    """Config 2 on both sides, and one state's step for each."""
    import bench_ladder as JL
    from rapidnet_tpu_torch import bench_ladder as L

    jp = JL._build(*CONFIG2["dims"], CONFIG2["N"], CONFIG2["branching"],
                   tune=False, max_iter=ITERS)
    pp = L.build(*CONFIG2["dims"], CONFIG2["N"], CONFIG2["branching"],
                 tune=False, max_iter=ITERS, device=torch.device("cpu"))
    return jp, pp, jp[3](jp[0].current_x), pp[3](pp[0].current_x)


@pytest.mark.parametrize("backend,jax_kw", [
    (None, {}),
    ("bf16z", {"dual_dtype": "bfloat16"}),
    ("stream", {"backend": "stream"}),
    ("stream_fused", {"backend": "stream_fused"}),
    ("fbe_stream", {"backend": "fbe_stream"}),
])
def test_ladder_solvers_match_the_jax_ladder(config2, backend, jax_kw):
    import bench_ladder as JL
    from rapidnet_tpu_torch import bench_ladder as L

    jp, pp, jstep, pstep = config2
    jfn, _ = JL._solver(*jp[:3], **jax_kw)
    ref = np.asarray(jfn(jstep)["control"])
    fn, _ = L.solver(pp, backend)
    got = fn(pstep)["control"].numpy()
    if backend == "fbe_stream":
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1.0))


def test_shardmap_row_matches_the_jax_sharded_solve(config2):
    """The ``5_1024scenario_H24_shardmap_1dev`` row's solve, the plain
    sharded APG on a mesh of one rank (``Mesh(0, 1, "cpu")``, no process
    group), at config 2 against JAX's ``make_sharded_apg`` on
    a 1-device mesh (the JAX row's solve, ``sharded_overhead_row``)
    within 1e-5 * max(|ref|, 1); then the row through ``run_config``:
    its schema and path, no kernel launched."""
    import torch.distributed as dist
    import bench_ladder as JL
    from rapidnet_tpu.parallel import (make_mesh, make_sharded_apg,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    from rapidnet_tpu_torch import bench_ladder as L

    jp, pp, jstep, pstep = config2
    mesh = make_mesh(1)
    jfn = make_sharded_apg(mesh, jp[2], jstep,
                           prefix_stages=jp[1].factor_step().prefix_stages,
                           **JL._solver_kw(jp[0]))
    ref = np.asarray(jfn(shard_factor_arrays(jp[2], mesh),
                         shard_step_arrays(jstep, mesh))["control"])
    fn, path = L.solver(pp, "shardmap")
    got = fn(pstep)["control"].numpy()
    row = L.run_config("5_1024scenario_H24_shardmap_1dev", pp, 1,
                       backend="shardmap", max_iter=ITERS)
    assert not dist.is_initialized()
    assert path == "make_sharded_apg(1 rank)"
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1.0))
    assert set(row) == ROW_KEYS and row["launches"] == {}
    assert row["path"] == "cpu:make_sharded_apg(1 rank)"


def test_make_apg_bf16_dual_matches_jax():
    import jax
    import jax.numpy as jnp
    from rapidnet_tpu.solver import apg as japg
    from rapidnet_tpu_torch.solver import apg as papg

    eng, fa, step, kw = jax_problem(**SMALL, max_iterations=ITERS,
                                    step_size=1e-3, x0_scale=1.2)
    prefix = eng.factor_step().prefix_stages
    ref = jax.jit(japg.make_apg(prefix_stages=prefix,
                                dual_dtype=jnp.bfloat16, **kw))(fa, step)
    fa_t, step_t = port_inputs(fa, step)
    got = papg.make_apg(prefix_stages=prefix, dual_dtype=torch.bfloat16,
                        **kw)(fa_t, step_t)
    f32 = papg.make_apg(prefix_stages=prefix, **kw)(fa_t, step_t)

    def held(g, r, factor):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=factor * max(np.abs(r).max(), 1.0))

    for k in ("control", "u"):
        held(got[k], ref[k], 1e-4)
    for k in ("xi", "psi"):
        held(got["y"][k], ref["y"][k], 1e-3)
    # the knob stores z in bf16 and changes the solve
    assert not torch.equal(got["u"], f32["u"])
