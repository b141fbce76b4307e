"""Global-FBE and NAMA quasi-Newton dual solvers (L-BFGS accelerated).

Counterpart of ``rapidnet_tpu/solver/quasi_newton.py`` (reference:
``algorithmGlobalFbe`` / ``algorithmNama``, src/SmpcController.cu:
1529-1586), in plain PyTorch:

* the FBE gradient  yvec = -(Hz - t) + step * H(linmap(-(Hz - t))),
  with linmap the Hessian oracle (``oracle``: the solve-step recursion
  with the affine terms zero, computeHessianOracalGlobalFbe, :884-1055);
* an L-BFGS buffer over the dual pair (xi, psi) with the reference's
  1-based rolling column scheme (updateLbfgsBuffer, :1103-1177) and the
  two-loop recursion (:1182-1232);
* backtracking line searches that *cumulatively* apply shrinking tau
  increments while the FBE value keeps improving
  (computeLineSearchLbfgsUpdate :1250-1320, AME variant :1326-1414).

This is the plain version that the whole-solve QN kernel
(ops/qn_solve.py) is held to: a Python loop over the iterations whose
branches (the accept test, the line search) read their scalars on the
host.  ``make_solver`` solves one instance; ``make_solver_batch`` and
``make_solver_batch_shared`` solve B of them, one after another.

``mesh``: the solve of one rank of a scenario mesh on its slot block
(``parallel.make_sharded_quasi_newton`` wraps it), the counterpart of the
JAX functions' ``axis_name``: every dot, norm and value of the dual space
is summed over the ranks (``psum``) before any branch reads it, so the
accept test, every line-search decision and the tolerance exit come out
the same on every rank.  The sums of one step share one all-reduce.

As in the JAX package: the buffers have buffer_size + 1 columns, with
column 0 always zero and rho[0] = 0, so the reference's
``col = 1 + col % size`` wrap and the two-loop's occasional visit to
column 0 are well defined no-ops; the line searches keep the last
(worsening) trial applied; a NaN trial value stops the search
(``val <= value_ref`` is false).
"""

from __future__ import annotations

import numpy as np
import torch

from rapidnet_tpu_torch.model.config import ALGORITHM_FBE, ALGORITHM_NAMA
from rapidnet_tpu_torch.solver import solve_step as ss
from rapidnet_tpu_torch.solver.apg import expand_shared_step

LS_TOLERANCE = 1e-4
LS_MAX_STEPS = 10
DUAL_KEYS = ("xi", "psi")


def masked_dot(a, b, rep):
    """Dual-space dot counting each tree node once ((N, ns, d) layout)."""
    return torch.sum(rep[..., None] * a * b)


def _local_dot(a, b, rep):
    return masked_dot(a["xi"], b["xi"], rep) + \
        masked_dot(a["psi"], b["psi"], rep)


def dual_dot(a, b, rep, mesh=None):
    """<a, b> over the dual pair {xi, psi}, counting each node once."""
    s = _local_dot(a, b, rep)
    return s if mesh is None else mesh.psum(s)


def oracle(fa, xi, psi, *, prefix_stages, mesh=None):
    """The solve-step linear map on a dual direction (affine terms 0)."""
    N, ns = xi.shape[:2]
    nx = fa["d1"].shape[-1]
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    zeros = xi.new_zeros
    return ss.solve_step(
        fa, xi, psi, zeros((N, ns, nv)), zeros((N, ns, nu)),
        zeros((N, ns, nx)), zeros((nx,)), zeros((nu,)), zeros((nu,)),
        prefix_stages=prefix_stages, mesh=mesh)


def value_fbe(fa, step, w, u, res, value_g, *, step_size, mesh=None):
    """FBE value (computeValueFbe, src/SmpcController.cu:1417-1476):

    <w, r> + (step/2) ||r||^2 + g-values + f(u), with
    f = sum_n p_n du_n' W du_n + sum_n p_n u_n' alpha_n and
    du_n = u_n - u_anc(n) (root: - previous control).  On a ``mesh`` the
    four sums are summed over the ranks in one all-reduce.
    """
    rep = fa["rep"]
    du0 = u[0] - step["prev_u"][None, :]
    du = torch.cat([du0[None], u[1:] - u[:-1]], dim=0)
    Wdu = du @ fa["W"].T
    p = fa["prob"]
    wr, rr, smooth, econ = ss.psum_all(
        mesh, _local_dot(w, res, rep), _local_dot(res, res, rep),
        torch.sum(rep[..., None] * (p * du) * Wdu),
        torch.sum(rep[..., None] * (p * u) * step["alpha_price"]))
    val = wr + 0.5 * step_size * rr + value_g
    return val + smooth + econ


def empty_lbfgs(fa, N, ns, buffer_size):
    """A fresh L-BFGS buffer (buffer_size + 1 columns, column 0 zero)."""
    nx = fa["d1"].shape[-1]
    nu = fa["g"].shape[-1]
    zeros = fa["d1"].new_zeros
    n_cols = buffer_size + 1
    return {
        "mat_s": {"xi": zeros((n_cols, N, ns, 2 * nx)),
                  "psi": zeros((n_cols, N, ns, nu))},
        "mat_y": {"xi": zeros((n_cols, N, ns, 2 * nx)),
                  "psi": zeros((n_cols, N, ns, nu))},
        "rho": zeros((n_cols,)), "col": 0, "mem": 0, "skips": 0,
        "hessian": fa["d1"].new_tensor(1.0),
    }


def lbfgs_update_and_direction(fa, lb, y, y_prev, yvec, yvec_prev, *,
                               buffer_size, storage=None, mesh=None):
    """L-BFGS buffer update + two-loop recursion.

    Reference: updateLbfgsBuffer (src/SmpcController.cu:1103-1177) and
    twoLoopRecursionLbfgs (:1182-1232).  ``lb`` is ``empty_lbfgs``'s
    dict (col, mem and skips Python ints); it is not modified.  Returns
    the updated buffer and the direction.  ``storage``: a dtype the
    history is stored in (None: as computed); the pair is rounded to it
    before its dots, as the whole-solve kernel's bf16 history does
    (``ops/qn_solve.py``).
    """
    rep = fa["rep"]
    s = {k: y[k] - y_prev[k] for k in DUAL_KEYS}
    yv = {k: yvec[k] - yvec_prev[k] for k in DUAL_KEYS}
    if storage is not None:
        s = {k: v.to(storage).to(v.dtype) for k, v in s.items()}
        yv = {k: v.to(storage).to(v.dtype) for k, v in yv.items()}
    gg, inv_rho, norm_y2, norm_s2 = ss.psum_all(
        mesh, _local_dot(yvec, yvec, rep), _local_dot(s, yv, rep),
        _local_dot(yv, yv, rep), _local_dot(s, s, rep))
    norm_grad = torch.sqrt(gg)

    norm_grad = torch.where(norm_grad < 1.0, norm_grad ** 3, norm_grad)
    accept = bool(inv_rho / torch.clamp(norm_s2, min=1e-30) >
                  1e-6 * norm_grad)

    mat_s, mat_y, rho = lb["mat_s"], lb["mat_y"], lb["rho"]
    col, mem = lb["col"], lb["mem"]
    if accept:
        col = 1 + (lb["col"] % buffer_size)
        mem = min(lb["mem"] + 1, buffer_size)
        mat_s = {k: mat_s[k].clone() for k in DUAL_KEYS}
        mat_y = {k: mat_y[k].clone() for k in DUAL_KEYS}
        for k in DUAL_KEYS:
            mat_s[k][col] = s[k]
            mat_y[k][col] = yv[k]
        rho = rho.clone()
        rho[col] = 1.0 / inv_rho
    skips = lb["skips"] + (0 if accept else 1)

    gamma = inv_rho / torch.clamp(norm_y2, min=1e-30)
    hessian = torch.where((gamma < 0) | (torch.abs(gamma - lb["hessian"])
                                         == 0),
                          torch.ones_like(gamma), gamma)

    # two-loop recursion on dir = -yvec
    d = {k: -yvec[k] for k in DUAL_KEYS}
    alphas = {}
    for i in range(mem):
        icol = col - i
        icol = mem + icol if icol < 0 else icol
        sk = {k: mat_s[k][icol] for k in DUAL_KEYS}
        a = rho[icol] * dual_dot(sk, d, rep, mesh)
        d = {k: d[k] - a * mat_y[k][icol] for k in DUAL_KEYS}
        alphas[icol] = a
    d = {k: hessian * d[k] for k in DUAL_KEYS}
    for j in range(mem):
        icol = col - (mem - j) + 1     # reference iSize runs mem..1
        icol = mem + icol if icol < 0 else icol
        yk = {k: mat_y[k][icol] for k in DUAL_KEYS}
        b = rho[icol] * dual_dot(yk, d, rep, mesh)
        scale = alphas[icol] - b
        d = {k: d[k] + scale * mat_s[k][icol] for k in DUAL_KEYS}
    lb_new = {"mat_s": mat_s, "mat_y": mat_y, "rho": rho, "col": col,
              "mem": mem, "skips": skips, "hessian": hessian}
    return lb_new, d


def _ls_apply(fa, step, state, w_dir, dirs, tau, *, prox_kwargs,
              step_size, mesh=None):
    """One cumulative line-search application + re-evaluation."""
    x = state["x"] + tau * dirs["x"]
    u = state["u"] + tau * dirs["u"]
    w = {k: state["w"][k] + tau * w_dir[k] for k in DUAL_KEYS}
    prim = {"xi": state["prim"]["xi"] + tau * dirs["prim_xi"],
            "psi": state["prim"]["psi"] + tau * dirs["prim_psi"]}
    dual_xi, dual_psi, value_g = ss.prox_g(
        fa, prim["xi"], prim["psi"], w["xi"], w["psi"], mesh=mesh,
        **prox_kwargs)
    res = {"xi": prim["xi"] - dual_xi, "psi": prim["psi"] - dual_psi}
    val = value_fbe(fa, step, w, u, res, value_g, step_size=step_size,
                    mesh=mesh)
    new_state = {"x": x, "u": u, "w": w, "prim": prim,
                 "dual": {"xi": dual_xi, "psi": dual_psi},
                 "res": res, "value_g": value_g}
    return new_state, val


def tau_line_search(fa, step, state, w_dir, dirs, value_ref,
                    direction_value, *, prox_kwargs, step_size, mesh=None):
    """The reference's cumulative backtracking tau loop (:1280-1315).

    Applies tau increments 1, -1/2, +1/4-1/2... cumulatively while the
    FBE value keeps improving; the final worsening trial stays applied.
    Returns (state, |last tau increment|); the state's ``trials`` is the
    number of trials that ran.
    """
    positive = bool(direction_value > 0)
    if positive or bool(torch.abs(direction_value) < LS_TOLERANCE):
        return dict(state, trials=0), 1.0 if positive else 0.0
    istep, tau, st, trials = 0, 1.0, state, 0
    while istep < LS_MAX_STEPS + 1:
        st, val = _ls_apply(fa, step, st, w_dir, dirs, tau,
                            prox_kwargs=prox_kwargs, step_size=step_size,
                            mesh=mesh)
        trials += 1
        improved = bool(val <= value_ref)
        istep = istep + 1 if improved else LS_MAX_STEPS + 1
        tau_base = -1.0 if istep == 1 else tau
        if improved and istep < LS_MAX_STEPS:
            tau = tau_base + 0.5 ** istep
    return dict(st, trials=trials), abs(tau)


def fbe_line_search(fa, step, state, grad, lbfgs_dir, value_ref, *,
                    prefix_stages, prox_kwargs, step_size, mesh=None):
    """computeLineSearchLbfgsUpdate (src/SmpcController.cu:1250-1320)."""
    h = oracle(fa, lbfgs_dir["xi"], lbfgs_dir["psi"],
               prefix_stages=prefix_stages, mesh=mesh)
    dval = dual_dot(grad, lbfgs_dir, fa["rep"], mesh)
    return tau_line_search(fa, step, state, lbfgs_dir, h, value_ref, dval,
                           prox_kwargs=prox_kwargs, step_size=step_size,
                           mesh=mesh)


def ame_line_search(fa, step, state, lbfgs_dir, value_ref, *,
                    prefix_stages, prox_kwargs, step_size, mesh=None):
    """computeLineSearchAmeLbfgsUpdate (src/SmpcController.cu:1326-1414).

    First takes the gradient (residual) step unconditionally, then runs
    the tau loop along the combined direction d = lbfgsDir - step * res.
    """
    res = state["res"]
    dval = -dual_dot(res, lbfgs_dir, fa["rep"], mesh)
    hres = oracle(fa, res["xi"], res["psi"], prefix_stages=prefix_stages,
                  mesh=mesh)
    st = dict(state)
    st["w"] = {k: state["w"][k] + step_size * res[k] for k in DUAL_KEYS}
    st["x"] = state["x"] + step_size * hres["x"]
    st["u"] = state["u"] + step_size * hres["u"]
    st["prim"] = {"xi": state["prim"]["xi"] + step_size * hres["prim_xi"],
                  "psi": state["prim"]["psi"] +
                  step_size * hres["prim_psi"]}
    comb = {k: lbfgs_dir[k] - step_size * res[k] for k in DUAL_KEYS}
    hcomb = oracle(fa, comb["xi"], comb["psi"], prefix_stages=prefix_stages,
                   mesh=mesh)
    return tau_line_search(fa, step, st, comb, hcomb, value_ref, dval,
                           prox_kwargs=prox_kwargs, step_size=step_size,
                           mesh=mesh)


def make_solver(*, algorithm: str, prefix_stages: tuple, inv_step: float,
                step_size: float, penalty_state: float,
                penalty_safety: float, xs_upper: float,
                max_iterations: int, lbfgs_buffer_size: int,
                tolerance: float | None = None,
                trace_control: bool = False,
                trace_magnitude: bool = False, mesh=None,
                _lbfgs_storage=None):
    """Build the FBE or NAMA solve function fn(fa, step, y0=None).

    * ``y0``: optional dual warm start {"xi", "psi"} (the previous
      solve's ``out["y"]``); the L-BFGS buffer starts fresh.
    * ``tolerance``: stop once the true residual magnitude
      (``max_abs_residual``) is at most ``tolerance``; the traces are
      zero past the exit.
    * ``trace_control``: also return ``control_trace``, the stage-0
      control u[0, 0] after every iteration.
    * ``trace_magnitude``: also return ``residual_magnitude``, the true
      residual magnitude that ``tolerance`` tests, after every iteration
      (zero past the exit).
    * ``mesh``: the solve of this rank of a scenario mesh on its slot
      block (module docstring).
    * ``_lbfgs_storage``: private, the plain version of the whole-solve
      kernel's history storage (``ops/qn_solve.qn_solve_plain``); the
      JAX ``make_solver`` has no such knob.

    Returns control (the stage-0 u projected onto the physical bounds),
    x, u, v, y, and the per-iteration traces primal_infeasibility,
    value_fbe and tau, ``iterations``, ``line_search_trials`` (the
    trials the line searches ran, all iterations together) and
    ``lbfgs_skips`` (the curvature pairs the buffer rejected).
    """
    is_fbe = algorithm == ALGORITHM_FBE
    if not is_fbe and algorithm != ALGORITHM_NAMA:
        raise ValueError(f"unknown quasi-Newton algorithm {algorithm}")
    prox_kwargs = dict(inv_step=inv_step, penalty_state=penalty_state,
                       penalty_safety=penalty_safety, xs_upper=xs_upper)
    need_mag = tolerance is not None or trace_magnitude

    def one_iteration(fa, step, carry, it):
        w = carry["w"]
        sol = ss.solve_step(
            fa, w["xi"], w["psi"], step["beta"], step["uhat"], step["e"],
            step["x0"], step["prev_u"], step["prev_uhat"],
            prefix_stages=prefix_stages, mesh=mesh)
        prim = {"xi": sol["prim_xi"], "psi": sol["prim_psi"]}
        dual_xi, dual_psi, value_g = ss.prox_g(
            fa, prim["xi"], prim["psi"], w["xi"], w["psi"], mesh=mesh,
            **prox_kwargs)
        res = {"xi": prim["xi"] - dual_xi, "psi": prim["psi"] - dual_psi}
        if is_fbe:
            hdir = oracle(fa, -res["xi"], -res["psi"],
                          prefix_stages=prefix_stages, mesh=mesh)
            yvec = {"xi": -res["xi"] + step_size * hdir["prim_xi"],
                    "psi": -res["psi"] + step_size * hdir["prim_psi"]}
        else:
            yvec = {k: -res[k] for k in DUAL_KEYS}
        state = {"x": sol["x"], "u": sol["u"], "w": w, "prim": prim,
                 "dual": {"xi": dual_xi, "psi": dual_psi}, "res": res,
                 "value_g": value_g}
        lb, tau, value, trials = carry["lbfgs"], 0.0, 0.0, 0
        if it > 0:
            value = value_fbe(fa, step, state["w"], state["u"],
                              state["res"], state["value_g"],
                              step_size=step_size, mesh=mesh)
            lb, lbfgs_dir = lbfgs_update_and_direction(
                fa, lb, carry["y"], carry["y_prev"], yvec,
                carry["yvec_prev"], buffer_size=lbfgs_buffer_size,
                storage=_lbfgs_storage, mesh=mesh)
            ls_kw = dict(prefix_stages=prefix_stages,
                         prox_kwargs=prox_kwargs, step_size=step_size,
                         mesh=mesh)
            if is_fbe:
                state, tau = fbe_line_search(fa, step, state, yvec,
                                             lbfgs_dir, value, **ls_kw)
            else:
                state, tau = ame_line_search(fa, step, state, lbfgs_dir,
                                             value, **ls_kw)
            trials = state["trials"]
        # dual update (src/SmpcController.cu:865-880)
        y_new = {k: state["w"][k] + step_size * state["res"][k]
                 for k in DUAL_KEYS}
        infeas = ss.signed_max_abs(state["res"]["xi"], state["res"]["psi"],
                                   mesh)
        mag = (ss.max_abs_residual(state["res"]["xi"], state["res"]["psi"],
                                   mesh) if need_mag else None)
        new_carry = {"y": y_new, "y_prev": carry["y"], "yvec_prev": yvec,
                     "w": y_new, "lbfgs": lb, "x": state["x"],
                     "u": state["u"], "v": sol["v"]}
        return new_carry, (infeas, value, tau, mag, trials)

    def run(fa, step, y0=None):
        N, ns = step["beta"].shape[:2]
        nx = fa["d1"].shape[-1]
        nu = fa["g"].shape[-1]
        nv = fa["invWbar"].shape[0]
        zeros = step["beta"].new_zeros
        zero_dual = {"xi": zeros((N, ns, 2 * nx)), "psi": zeros((N, ns, nu))}
        if y0 is None:
            y0 = zero_dual
        carry = {"y": y0, "y_prev": y0, "yvec_prev": zero_dual, "w": y0,
                 "lbfgs": empty_lbfgs(fa, N, ns, lbfgs_buffer_size),
                 "x": zeros((N, ns, nx)), "u": zeros((N, ns, nu)),
                 "v": zeros((N, ns, nv))}
        traces = {"primal_infeasibility": zeros((max_iterations,)),
                  "value_fbe": zeros((max_iterations,)),
                  "tau": zeros((max_iterations,))}
        mags = zeros((max_iterations,))
        controls = []
        it = trials = 0
        while it < max_iterations:
            carry, (infeas, value, tau, mag, n) = one_iteration(fa, step,
                                                                carry, it)
            trials += n
            traces["primal_infeasibility"][it] = infeas
            traces["value_fbe"][it] = value
            traces["tau"][it] = tau
            if need_mag:
                mags[it] = mag
            controls.append(carry["u"][0, 0])
            it += 1
            if tolerance is not None and not bool(mag > tolerance):
                break
        lo, hi = ss.root_control_bounds(fa)
        out = {"control": torch.clamp(carry["u"][0, 0], lo, hi),
               "x": carry["x"], "u": carry["u"], "v": carry["v"],
               "y": carry["y"], **traces,
               "iterations": torch.tensor(it, dtype=torch.int32,
                                          device=carry["u"].device),
               "line_search_trials": torch.tensor(
                   trials, dtype=torch.int32, device=carry["u"].device),
               "lbfgs_skips": torch.tensor(
                   carry["lbfgs"]["skips"], dtype=torch.int32,
                   device=carry["u"].device)}
        if trace_control:
            out["control_trace"] = torch.stack(controls)
        if trace_magnitude:
            out["residual_magnitude"] = mags
        return out

    return run


def _stack(outs):
    """The per-instance output dicts (nested dicts too) stacked on a
    leading batch axis."""
    return {k: _stack([o[k] for o in outs]) if isinstance(outs[0][k], dict)
            else torch.stack([o[k] for o in outs]) for k in outs[0]}


def make_solver_batch(**kwargs):
    """Batched FBE/NAMA: B independent instances sharing the factor
    tensors.

    Returns fn(fa, steps, y0=None): every leaf of ``steps`` (and of the
    warm start ``y0``, when given) carries a leading batch axis, as do
    the outputs (``iterations``, ``line_search_trials`` and
    ``lbfgs_skips`` are (B,)).  It runs ``make_solver``'s solve on each
    instance in turn, as the TPU kernel's batch does (a ``lax.map``,
    rapidnet_tpu/ops/pallas_qn.py:700-706), so each instance equals its
    single solve exactly; the JAX package's ``make_solver_batch`` (a
    vmap, whose line searches run in masked lockstep) parts from single
    solves at the f32 rounding level.
    """
    run = make_solver(**kwargs)

    def run_batch(fa, steps, y0=None):
        outs = [run(fa, {k: v[b] for k, v in steps.items()},
                    None if y0 is None else {k: v[b] for k, v in y0.items()})
                for b in range(steps["beta"].shape[0])]
        return _stack(outs)

    return run_batch


def make_solver_batch_shared(**kwargs):
    """Batched FBE/NAMA over a shared forecast: fn(fa, base, inst,
    y0=None), with ``(base, inst)`` from ``Engine.prepare_step_shared``;
    the batched steps are assembled on the device
    (``apg.expand_shared_step``)."""
    run_batch = make_solver_batch(**kwargs)

    def run(fa, base, inst, y0=None):
        return run_batch(fa, expand_shared_step(base, **inst), y0)

    return run


def exit_tolerances(mags, last):
    """From a solve's residual magnitudes (``make_solver(...,
    trace_magnitude=True)``: the quantity a tolerance tests), the
    tolerances that stop it at an iteration in (1, last]: a tolerance
    stops the solve at iteration i when magnitude i is the first at most
    the tolerance, so i is an exit for tolerances in [mags[i],
    min(mags[:i])).  Returns (tolerance, i, the ratio of that range's
    ends) for every such exit, the tolerance the geometric middle of its
    range, the widest range (farthest from the edges of its exit) first;
    empty if no iteration in (1, last] is an exit."""
    mags = np.asarray(mags, np.float64)
    exits = []
    for i in range(1, min(last, len(mags))):
        lowest = mags[:i].min()
        if mags[i] < lowest:
            exits.append((float(np.sqrt(lowest * mags[i])), i + 1,
                          float(lowest / mags[i])))
    return sorted(exits, key=lambda e: -e[2])
