"""Ranks of a CPU scenario mesh for the port's sharded tests.

``run_ranks(n, job, *args)`` starts n processes (spawned), joins them in
a gloo process group over a FileStore in a fresh temporary directory (no
TCP port, so parallel test workers cannot collide), builds the CPU
``parallel.Mesh`` and calls ``job(mesh, *args)`` on every rank.  It
returns the ranks' results in rank order, and raises when a rank fails
or when they are not all done within ``timeout`` seconds (then every
rank is stopped).  The group's own timeout (``GROUP_TIMEOUT``) makes a
rank that waits on a collective that never comes fail.  ``Ranks`` starts
them and returns at once, so that a test module can compute its JAX
references while the ranks run (``wait()`` collects them).

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


class Ranks:
    """n spawned ranks running ``job`` (``run_ranks``' arguments), started
    at construction so that the caller can work meanwhile; ``wait()``
    returns their results in rank order, ``stop()`` stops every rank
    still running."""

    def __init__(self, n, job, *args, group=True, timeout=RUN_TIMEOUT,
                 group_timeout=GROUP_TIMEOUT):
        ctx = mp.get_context("spawn")
        self.n, self.name = n, job.__name__
        self.results = ctx.Queue()
        tmp = tempfile.mkdtemp(prefix="torch_mesh_")
        init = f"file://{os.path.join(tmp, 'store')}"
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, n, init, job, args, group,
                                        group_timeout, self.results))
                      for r in range(n)]
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.stop()
            raise

    def wait(self):
        out = {}
        try:
            while len(out) < self.n:
                try:
                    rank, res = self.results.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > self.deadline:
                        raise RankFailure(f"{self.n} ranks of {self.name} "
                                          f"not done within {self.timeout} "
                                          "s")
                    dead = [p.exitcode for p in self.procs
                            if not p.is_alive() and p.exitcode]
                    if dead:
                        raise RankFailure(f"a rank of {self.name} died "
                                          f"(exit codes {dead})")
                    continue
                if isinstance(res, str):
                    raise RankFailure(f"rank {rank} of {self.name} "
                                      f"failed:\n{res}")
                out[rank] = res
            for p in self.procs:
                p.join(30)
        finally:
            self.stop()
        return [out[r] for r in range(self.n)]

    def stop(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(5)


def run_ranks(n, job, *args, group=True, timeout=RUN_TIMEOUT,
              group_timeout=GROUP_TIMEOUT):
    """``job(mesh, *args)`` on each of n CPU ranks (``group=False``:
    ``job(rank, n, init_method, *args)``, the job joins the group
    itself); the results in rank order."""
    return Ranks(n, job, *args, group=group, timeout=timeout,
                 group_timeout=group_timeout).wait()


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


def batched_controller(pkg, algorithm, forecasts, iterations, steps_ahead=6,
                       B=4, **kw):
    """``pkg``'s ``BatchedSmpcController`` on tests/test_batch.py's problem
    (nx 4, nu 7, N 8, branching [2, 2], seed 3) with B instances from
    x0 * linspace(0.9, 1.1, B): one shared forecaster (seed 3) or one per
    instance (seeds 3 + b).  Imports only ``pkg``."""
    import importlib
    m = {k: importlib.import_module(f"{pkg}.model.{k}")
         for k in ("network", "scenario_tree", "forecaster", "config")}
    cls = importlib.import_module(f"{pkg}.solver.batch").BatchedSmpcController
    net = m["network"].synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=3)
    tree = m["scenario_tree"].generate_tree(N=8, branching=[2, 2], nd=3,
                                            nu=7, seed=3)

    def fc(seed):
        return m["forecaster"].synthetic_forecaster(
            N=8, nd=3, nu=7, sim_horizon=steps_ahead, seed=seed)

    cfg = m["config"].synthetic_config(net, tree, max_iterations=iterations,
                                       step_size=1e-3)
    cfg.algorithm = algorithm
    fcs = fc(3) if forecasts == "shared" else [fc(3 + b) for b in range(B)]
    x0s = (cfg.current_x * np.linspace(0.9, 1.1, B)[:, None]
           ).astype(np.float32)
    return cls(cfg, net, tree, fcs, x0s, **kw)


def mesh_2d_job(mesh, fa, steps, base, inst, prefix, cases, loops,
                loop_steps):
    """On a (2, 2) ``make_mesh_2d`` of the 4 ranks: each rank's place;
    the 2-D batched solves of ``cases`` (name -> (form 'stacked' or
    'shared', algorithm, solver keywords)) on the global (B, ...) steps
    or (base, inst), cold, buffer 5; the ``loop_steps``-step closed
    loops of ``BatchedSmpcController(mesh=...)`` of ``loops`` (name ->
    (algorithm, forecasts, iterations, warm start)); and the refusals on
    the mesh (B the batch rows do not divide, a wrong world size)."""
    import torch
    from rapidnet_tpu_torch.convert import (factor_tensors,
                                            shared_step_tensors,
                                            stacked_step_tensors)
    from rapidnet_tpu_torch.parallel import (make_mesh_2d,
                                             make_sharded_apg_batch,
                                             make_sharded_batch_shared,
                                             make_sharded_qn_batch,
                                             shard_factor_arrays)
    m2 = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    out = {"place": (m2.rank, m2.scen.rank, m2.scen.size, m2.batch.rank,
                     m2.batch.size, repr(m2))}
    fa_t = factor_tensors(fa, "cpu")
    st = stacked_step_tensors(steps, "cpu")
    sh = shared_step_tensors(base, inst, "cpu")
    fa_l = shard_factor_arrays(fa_t, m2)
    for name, (form, algorithm, kw) in cases.items():
        kw = dict(kw, prefix_stages=prefix)
        if form == "shared":
            run = make_sharded_batch_shared(m2, fa_t, sh[0],
                                            algorithm=algorithm,
                                            lbfgs_buffer_size=5, **kw)
            out[name] = _np(run(fa_l, *sh))
        elif algorithm == "proximalAlgorithm":
            out[name] = _np(make_sharded_apg_batch(m2, fa_t, st, **kw)(
                fa_l, st))
        else:
            out[name] = _np(make_sharded_qn_batch(
                m2, fa_t, st, algorithm=algorithm, lbfgs_buffer_size=5,
                **kw)(fa_l, st))
    for name, (algorithm, forecasts, iterations, warm) in loops.items():
        ctrl = batched_controller("rapidnet_tpu_torch", algorithm,
                                  forecasts, iterations, device="cpu",
                                  mesh=m2, warm_start=warm)
        log = ctrl.closed_loop(loop_steps)
        out[name] = {"controls": log["controls"], "route": ctrl.route,
                     "kpis": {k: log[k] for k in (
                         "economicKpi", "smoothKpi", "safetyKpi",
                         "networkKpi")},
                     "last": _np(ctrl._last),
                     "carry": None if ctrl._y_carry is None
                     else _np(ctrl._y_carry)}
    refusals = {}
    odd = {k: v[:3] for k, v in st.items()}
    for name, call in (
            ("batch", lambda: make_sharded_apg_batch(
                m2, fa_t, st, prefix_stages=prefix,
                **cases["apg"][2])(fa_l, odd)),
            ("world", lambda: make_mesh_2d(3, 2, devices=["cpu"] * 6))):
        try:
            call()
            refusals[name] = None
        except Exception as exc:          # the test asserts on the type
            refusals[name] = (type(exc).__name__, str(exc))
    out["refusals"] = refusals
    return finish(mesh, out)


def _capture(fn, *args):
    """(fn(*args), what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = fn(*args)
    return got, buf.getvalue()


def mesh_controller(mesh, algorithm, backend, iterations=10, seed=7,
                    **kw):
    """``SmpcController`` on the problem of ``controller_job`` (tree
    [4, 2], N 6), on ``mesh`` (None: one device), on the CPU."""
    from rapidnet_tpu_torch import SmpcController
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=seed)
    tree = generate_tree(N=6, branching=[4, 2], nd=3, nu=7, seed=seed)
    fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=4, seed=seed)
    cfg = synthetic_config(net, tree, max_iterations=iterations,
                           step_size=1e-3)
    cfg.algorithm = algorithm
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          backend=backend, device="cpu", mesh=mesh, **kw)


def warm_resume(ctrl_factory, path):
    """A warm controller's step 0, saved to ``path``, and step 1 both
    uninterrupted and resumed in a fresh controller from the file:
    (the two step-1 controls, the two last duals, the two economic KPI
    accumulators, the resumed time, the route).  On a mesh the ranks
    other than its rank 0 pass a path where no file is, as on a host
    that does not see rank 0's disk (only rank 0 may read); ``exists``
    is then ``checkpoint_exists`` of the path each rank passed, and
    ``missing`` the error each rank raised loading a path rank 0 lacks
    too."""
    from rapidnet_tpu_torch.utils.checkpoint import (checkpoint_exists,
                                                     load_checkpoint,
                                                     save_checkpoint)
    a = ctrl_factory()
    mesh = a.mesh
    a.control_action(0)
    a.move_forward_in_time()
    save_checkpoint(a, path, sim_time=1)
    u_ref = a.control_action(1)
    a.move_forward_in_time()
    b = ctrl_factory()
    here = path if mesh is None or mesh.rank == 0 else path + "_elsewhere"
    out = {"exists": checkpoint_exists(here, mesh)}
    t = load_checkpoint(b, here)
    u = b.control_action(t)
    b.move_forward_in_time()
    if mesh is not None:
        try:
            load_checkpoint(ctrl_factory(), path + "_missing")
            out["missing"] = None
        except Exception as exc:          # the test asserts on the type
            out["missing"] = type(exc).__name__
    return dict(out, u=u, u_ref=u_ref, y=_np(b._last["y"]),
                y_ref=_np(a._last["y"]),
                kpi=(b.economic_kpi_acc, a.economic_kpi_acc), t=t,
                route=a.route)


def multichip_job(mesh, directory, resumes):
    """On the 4 ranks: ``multichip_sharded --devices 4 --iterations 40``
    (its result and what it printed); ``dryrun.dryrun_multichip(4)``
    and its refusal of a 3-rank mesh; then on the two rows of a (2, 2)
    ``make_mesh_2d`` (2-rank scenario meshes) the warm checkpoint resumes
    of ``resumes`` (name -> (algorithm, backend)) into ``directory``, a
    file per row."""
    from rapidnet_tpu_torch.examples import dryrun, multichip_sharded
    from rapidnet_tpu_torch.parallel import make_mesh_2d
    out = {"example": _capture(multichip_sharded.main, [
        "--device", "cpu", "--devices", "4", "--iterations", "40"])}
    out["example"][0].pop("network")
    out["dryrun"] = dryrun.dryrun_multichip(4, devices=["cpu"] * 4)
    try:
        dryrun.dryrun_multichip(3, devices=["cpu"] * 3)
        out["dryrun_3"] = None
    except Exception as exc:              # the test asserts on the type
        out["dryrun_3"] = (type(exc).__name__, str(exc))
    m2 = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    row = m2.batch.rank
    for name, (algorithm, backend) in resumes.items():
        out[name] = warm_resume(
            lambda: mesh_controller(m2.scen, algorithm, backend,
                                    warm_start=True),
            os.path.join(directory, f"{name}_row{row}"))
    return finish(mesh, out)
