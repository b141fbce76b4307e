"""Ranks of a CPU scenario mesh for the port's sharded tests.

``run_ranks(n, job, *args)`` starts n processes (spawned), joins them in
a gloo process group over a FileStore in a fresh temporary directory (no
TCP port, so parallel test workers cannot collide), builds the CPU
``parallel.Mesh`` and calls ``job(mesh, *args)`` on every rank.  It
returns the ranks' results in rank order, and raises when a rank fails
or when they are not all done within ``timeout`` seconds (then every
rank is stopped).  The group's own timeout (``GROUP_TIMEOUT``) makes a
rank that waits on a collective that never comes fail.

The jobs below run in the ranks.  This module imports neither JAX nor
the JAX package, and the ranks import nothing that does: the tests hand
them numpy arrays.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import numpy as np

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RUN_TIMEOUT = 240.0


def _entry(rank, n, init, job, args, group, group_timeout, results):
    try:
        import torch
        torch.set_num_threads(1)
        mesh = None
        if group:
            from rapidnet_tpu_torch.parallel import distributed, make_mesh
            distributed.initialize(backend="gloo", init_method=init,
                                   rank=rank, world_size=n,
                                   timeout=group_timeout)
            mesh = make_mesh(n, devices=["cpu"] * n)
        out = job(mesh, *args) if group else job(rank, n, init, *args)
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))


class RankFailure(RuntimeError):
    pass


def run_ranks(n, job, *args, group=True, timeout=RUN_TIMEOUT,
              group_timeout=GROUP_TIMEOUT):
    """``job(mesh, *args)`` on each of n CPU ranks (``group=False``:
    ``job(rank, n, init_method, *args)``, the job joins the group
    itself); the results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="torch_mesh_")
    init = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_entry,
                         args=(r, n, init, job, args, group, group_timeout,
                               results))
             for r in range(n)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            try:
                rank, res = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RankFailure(f"{n} ranks of {job.__name__} not done "
                                      f"within {timeout} s")
                dead = [p.exitcode for p in procs
                        if not p.is_alive() and p.exitcode]
                if dead:
                    raise RankFailure(f"a rank of {job.__name__} died "
                                      f"(exit codes {dead})")
                continue
            if isinstance(res, str):
                raise RankFailure(f"rank {rank} of {job.__name__} failed:\n"
                                  f"{res}")
            out[rank] = res
        for p in procs:
            p.join(30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [out[r] for r in range(n)]


# ---------------------------------------------------------------- jobs


def finish(mesh, out):
    """``out``, after every rank has got here (a job's last collective)."""
    mesh.barrier()
    return out


def _np(tree):
    """Tensors (nested dicts too) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if hasattr(tree, "numpy"):
        return tree.detach().cpu().numpy()
    return tree


def _tensors(fa, step):
    from rapidnet_tpu_torch.convert import factor_tensors, step_tensors
    return factor_tensors(fa, "cpu"), step_tensors(step, "cpu")


def apg_job(mesh, fa, step, prefix, kw, y0, state, w):
    """The sharded APG solve cold and from ``y0``; the rank's pack; one
    K1a pass (``state``: the stressed pre, y, z and the scalars) and the
    partial parent block of its carry; one sharded S1 pass in each
    variant from the duals ``w``."""
    import torch
    from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
    from rapidnet_tpu_torch.ops import stream_qn as SQ
    fa_t, step_t = _tensors(fa, step)
    run = SS.make_apg_stream_sharded(mesh, fa_t, prefix_stages=prefix, **kw)
    kc = run.consts
    out = {"cold": _np(run(step_t)),
           "warm": _np(run(step_t, {k: torch.from_numpy(v)
                                    for k, v in y0.items()}))}
    out["pack"] = {k: _np(kc[k]) for k in
                   ("s_hi", "ranges", "agg_stages", "cross_stages", "nsl",
                    "sq", "nhp", "rep", "agg_parent", "agg_ptr", "agg_idx",
                    "x_ptr", "x_idx", "x_parent", "x_Cp", "n_parents")}
    out["pack"]["low"] = {s: (_np(c), _np(p)) for s, (c, p) in
                          kc["low"].items()}
    stl = SS.shard_step(kc, step_t)
    st = SS.new_state(kc, stl, None, kw["max_iterations"])
    sl = kc["slots"]
    for k in ("pre_xi", "pre_psi", "y_xi", "y_psi", "z_xi", "z_psi"):
        st[k].copy_(torch.from_numpy(state[k])[:, sl])
    st["sc"].copy_(torch.from_numpy(state["sc"]))
    ext, parents = SS.k1a_plain(kc, stl, st, **kw)
    carry = torch.from_numpy(state["carry"])[sl]
    out["k1a"] = {"ext": _np(ext), "parents": _np(parents),
                  **{k: _np(st[k]) for k in ("y_xi", "y_psi", "z_xi",
                                             "z_psi", "v")},
                  "pp": _np(SS.partial_parents(kc, carry)),
                  "pp_plain": _np(SS.partial_parents_plain(kc, carry))}
    w_t = torch.from_numpy(w)[:, sl].contiguous()
    out["s1a"] = {"solve": _np(SQ.s1a_plain(kc, w_t, mesh, stl["beta"])),
                  "oracle": _np(SQ.s1a_plain(kc, w_t, mesh)),
                  "call": _np(SQ.s1a_call(kc, w_t, mesh, stl["beta"]))}
    return finish(mesh, out)


def qn_job(mesh, fa, step, prefix, kw, runs):
    """The sharded FBE/NAMA solves of ``runs`` ((algorithm, history dtype)
    pairs), buffer 5."""
    from rapidnet_tpu_torch.solver.qn_stream import make_qn_stream
    fa_t, step_t = _tensors(fa, step)
    return finish(mesh, {(alg, dtype): _np(make_qn_stream(
        fa_t, algorithm=alg, prefix_stages=prefix, lbfgs_buffer_size=5,
        lbfgs_dtype=dtype, mesh=mesh, **kw)(step_t))
        for alg, dtype in runs})


def sharded_plain_job(mesh, fa, step, prefix, cases):
    """The plain sharded solves of ``cases`` (name -> (algorithm, solver
    keywords)) on this rank's cut of ``fa``, cold, buffer 5 for FBE and
    NAMA: their outputs, in the global layout."""
    from rapidnet_tpu_torch.model.config import ALGORITHM_APG
    from rapidnet_tpu_torch.parallel import (make_sharded_apg,
                                             make_sharded_quasi_newton,
                                             shard_factor_arrays)
    fa_t, step_t = _tensors(fa, step)
    fa_l = shard_factor_arrays(fa_t, mesh)
    out = {}
    for name, (algorithm, kw) in cases.items():
        if algorithm == ALGORITHM_APG:
            run = make_sharded_apg(mesh, fa_t, step_t, prefix_stages=prefix,
                                   **kw)
        else:
            run = make_sharded_quasi_newton(
                mesh, fa_t, step_t, algorithm=algorithm, prefix_stages=prefix,
                lbfgs_buffer_size=5, **kw)
        out[name] = _np(run(fa_l, step_t))
    return finish(mesh, out)


def controller_job(mesh, iterations, steps, seed=7, plain=None):
    """``steps``-step closed loops of ``SmpcController(mesh=...,
    backend="stream")`` on the synthetic problem of the JAX package's
    mesh controller tests (tree [4, 2], N = 6), one per algorithm of
    ``iterations`` (algorithm -> iterations per solve): the controls, the
    route and the trace; then the APG loops of ``plain`` (name ->
    controller keywords), which take the plain sharded route (with the
    last solve's u); then the refusals on the mesh."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=seed)
    tree = generate_tree(N=6, branching=[4, 2], nd=3, nu=7, seed=seed)

    def build(algorithm, backend="stream", iters=10, **kw):
        fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=seed)
        cfg = synthetic_config(net, tree, max_iterations=iters,
                               step_size=1e-3)
        if algorithm is not None:
            cfg.algorithm = algorithm
        return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              backend=backend, device="cpu", mesh=mesh, **kw)

    def loop(ctrl):
        controls, traces = [], []
        for t in range(steps):
            controls.append(ctrl.control_action(t))
            traces.append(ctrl.primal_infeasibility)
            ctrl.move_forward_in_time()
        return {"controls": np.array(controls), "route": ctrl.route,
                "trace": traces[-1], "traces": np.array(traces),
                "u": ctrl._last["u"].cpu().numpy()}

    out = {}
    for algorithm, iters in iterations.items():
        out[algorithm] = loop(build(algorithm, iters=iters))
    for name, kw in (plain or {}).items():
        out[name] = loop(build("proximalAlgorithm",
                               iters=iterations["proximalAlgorithm"], **kw))
    refusals = {}
    for name, kw in (("cuda", {"backend": "cuda"}),
                     ("stream_tolerance", {"tolerance": 1e-3})):
        try:
            ctrl = build(None, **kw)
            ctrl.initialise()
            refusals[name] = None
        except Exception as exc:          # the test asserts on the type
            refusals[name] = (type(exc).__name__, str(exc))
    out["refusals"] = refusals
    return finish(mesh, out)


def cli_job(rank, n, init, config, output):
    """The CLI as one of n ranks: ``--devices n --device cpu`` over the
    FileStore ``init``; returns what it printed."""
    import contextlib
    import io
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(n)
    from rapidnet_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", config, "--steps", "2", "--device", "cpu",
                       "--backend", "stream", "--devices", str(n),
                       "--dist-init", init, "--output", output])
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return rc, buf.getvalue()


def example_job(rank, n, init, module, argv):
    """``rapidnet_tpu_torch.examples.<module>.main`` as one of n ranks,
    ``--devices n`` over the FileStore ``init``: (its controls, KPIs and
    route, what it printed)."""
    import contextlib
    import importlib
    import io
    import torch.distributed as dist
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(n)
    mod = importlib.import_module(f"rapidnet_tpu_torch.examples.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = mod.main(argv + ["--devices", str(n), "--dist-init", init])
    dist.barrier()
    dist.destroy_process_group()
    return ({k: got[k] for k in ("controls", "kpis", "route")},
            buf.getvalue())


def stall_job(mesh, wait):
    """Rank 0 waits on a collective that rank 1 never joins (rank 1
    sleeps ``wait`` seconds, longer than the group's timeout, and joins
    none): the timeout must fail it.  Returns (the error's type, the
    seconds rank 0 waited)."""
    import torch
    if mesh.rank == 1:
        time.sleep(wait)
        return None
    start = time.monotonic()
    try:
        mesh.psum(torch.ones(3))
    except Exception as exc:
        return type(exc).__name__, time.monotonic() - start
    return "no error", time.monotonic() - start
