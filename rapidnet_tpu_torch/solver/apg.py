"""Dual accelerated proximal gradient (APG) — the default online solver.

Counterpart of ``rapidnet_tpu/solver/apg.py`` (reference:
``SmpcController::algorithmApg``, src/SmpcController.cu:1500-1525, with
the Nesterov theta sequence and extrapolation of :535-557), in plain
PyTorch: a Python loop of tensor operations over the iterations.  This
is the plain version that the whole-solve kernel (ops/apg_solve.py) is
held to.

* ``y0``: warm start from a previous solve's dual pair
  ``{"xi": (N, ns, 2nx), "psi": (N, ns, nu)}`` (the reference always
  cold-starts, src/SmpcController.cu:425-432).
* ``tolerance``: early termination on the true residual magnitude
  (``max_abs_residual``); the reference always runs the full budget.
  This path reads the magnitude on the host once per iteration.
* ``trace_control``: also return ``control_trace``, the unprojected
  stage-0 u after every iteration (the time-to-solution diagnostic).
* ``mesh``: the scenario-sharded solve of one rank
  (``parallel.make_sharded_apg`` wraps it): the oracle's collectives
  (``solve_step``'s ``mesh``) and the trace and stopping rule reduced
  over the ranks, so every rank stops at the same iteration.

The batched solves (``make_apg_batch``, ``make_apg_batch_shared``: B
independent instances over one factor step, the JAX package's ``vmap``
of ``make_apg``) write the batch dimension out: the same loop runs with
a leading batch axis on every per-instance tensor, and the sweeps reduce
their norms, champions and stopping tests per instance.  Under a
``tolerance`` an instance that has met it is frozen (``torch.where``
keeps its state, its trace is zero past its exit) while the others go
on, which is what a ``vmap`` of JAX's ``while_loop`` gives.  A loop over
instances through the single solve would repeat its arithmetic exactly,
but pay the per-operation overhead B times: at Barcelona scale with
B = 32 that took 87-104 s on an H100 against ~2 s for one solve.  The
batched products run as one larger product, so an instance of a batch
can differ from its single solve in the last bits.
"""

from __future__ import annotations

import numpy as np
import torch

from rapidnet_tpu_torch.solver import solve_step as ss


def nesterov_lambdas(max_iterations: int) -> np.ndarray:
    """The data-independent extrapolation weights lam_k (f32 host calc).

    theta_0 = theta_1 = 1;  lam = th1*(1/th0 - 1);
    th1' = (sqrt(th1^4 + 4 th1^2) - th1^2)/2   (src/SmpcController.cu:
    1519-1520 + 535-557).
    """
    th0 = np.float32(1.0)
    th1 = np.float32(1.0)
    lams = np.zeros((max_iterations,), np.float32)
    for k in range(max_iterations):
        lams[k] = th1 * (np.float32(1.0) / th0 - np.float32(1.0))
        th0 = th1
        th1 = np.float32(0.5) * (np.sqrt(th1 ** 4 + 4 * th1 ** 2)
                                 - th1 ** 2)
    return lams


def apg_oracle(fa, step, w_xi, w_psi, *, prefix_stages, inv_step,
               step_size, penalty_state, penalty_safety, xs_upper,
               mesh=None):
    """One dual-gradient step at an injected accelerated dual w.

    Solve step, prox of g, fixed-point residual (Hz - t,
    src/SmpcController.cu:839-850) and dual update (y+ = w + step (Hz -
    t), :854-881).  Returns the solve-step outputs plus dual_xi/dual_psi
    (prox), res_xi/res_psi (fixed-point residual), value_g and the
    updated dual pair y_xi/y_psi.
    """
    sol = ss.solve_step(
        fa, w_xi, w_psi, step["beta"], step["uhat"], step["e"],
        step["x0"], step["prev_u"], step["prev_uhat"],
        prefix_stages=prefix_stages, mesh=mesh)
    dual_xi, dual_psi, value_g = ss.prox_g(
        fa, sol["prim_xi"], sol["prim_psi"], w_xi, w_psi,
        inv_step=inv_step, penalty_state=penalty_state,
        penalty_safety=penalty_safety, xs_upper=xs_upper, mesh=mesh)
    res_xi = sol["prim_xi"] - dual_xi
    res_psi = sol["prim_psi"] - dual_psi
    return dict(sol, dual_xi=dual_xi, dual_psi=dual_psi,
                value_g=value_g, res_xi=res_xi, res_psi=res_psi,
                y_xi=w_xi + step_size * res_xi,
                y_psi=w_psi + step_size * res_psi)


def make_apg(*, prefix_stages: tuple, inv_step: float, step_size: float,
             penalty_state: float, penalty_safety: float, xs_upper: float,
             max_iterations: int, tolerance: float | None = None,
             dual_dtype=torch.float32, mesh=None,
             trace_control: bool = False):
    """Build the APG solve function.

    Returns fn(fa, step, y0=None) -> dict with the final control (the
    stage-0 u projected onto the physical bounds), x, u, v, the dual
    pair y and the per-iteration primal-infeasibility trace
    (zero-padded past the termination point when ``tolerance`` is set).
    A leading batch axis on ``step`` and ``y0`` runs B instances at once
    (``make_apg_batch``).

    ``trace_control``: the output also holds
    ``control_trace``, the unprojected stage-0 u after each iteration,
    (max_iterations, nu) (with a batch axis in front), zero past an
    instance's exit under a ``tolerance``
    (``rapidnet_tpu/solver/apg.py:160-180``).  ``mesh``: the solve of
    this rank of a scenario mesh on its slot block (module docstring).

    ``dual_dtype``: the storage of the Nesterov difference z = y - y_prev
    (``rapidnet_tpu/solver/apg.py:77``, ``:115-116``, ``:133``);
    ``torch.bfloat16`` stores it in half the bytes, the config ladder's
    bf16z row.  y and all arithmetic stay float32.
    """
    oracle_kw = dict(prefix_stages=prefix_stages, inv_step=inv_step,
                     step_size=step_size, penalty_state=penalty_state,
                     penalty_safety=penalty_safety, xs_upper=xs_upper,
                     mesh=mesh)
    lams = nesterov_lambdas(max_iterations)

    def run(fa, step, y0=None):
        lead = step["beta"].shape[:-3]
        N, ns = step["beta"].shape[-3:-1]
        nx = fa["d1"].shape[-1]
        nu = fa["g"].shape[-1]
        nv = fa["invWbar"].shape[0]

        def zeros(*shape):
            return step["beta"].new_zeros((*lead, *shape))

        if y0 is None:
            y0 = {"xi": zeros(N, ns, 2 * nx), "psi": zeros(N, ns, nu)}
        y = {"xi": y0["xi"], "psi": y0["psi"]}
        z = {k: torch.zeros_like(v, dtype=dual_dtype) for k, v in y.items()}
        x, u, v = zeros(N, ns, nx), zeros(N, ns, nu), zeros(N, ns, nv)
        # instances still iterating, and their iteration counts
        active = torch.ones(lead, dtype=torch.bool, device=x.device)
        iterations = torch.zeros(lead, dtype=torch.int32, device=x.device)
        trace, controls = [], []
        for it in range(max_iterations):
            lam = float(lams[it])
            # w = (1+lam) y - lam y_prev = y + lam z  (dual
            # extrapolation, src/SmpcController.cu:544-552)
            w_xi = y["xi"] + lam * z["xi"].to(y["xi"].dtype)
            w_psi = y["psi"] + lam * z["psi"].to(y["psi"].dtype)
            o = apg_oracle(fa, step, w_xi, w_psi, **oracle_kw)
            new = {"y_xi": o["y_xi"], "y_psi": o["y_psi"],
                   "z_xi": (o["y_xi"] - y["xi"]).to(dual_dtype),
                   "z_psi": (o["y_psi"] - y["psi"]).to(dual_dtype),
                   "x": o["x"], "u": o["u"], "v": o["v"]}
            signed = ss.signed_max_abs(o["res_xi"], o["res_psi"], mesh)
            u0 = o["u"][..., 0, 0, :]
            if tolerance is not None:
                # an instance that has stopped keeps its state
                old = {"y_xi": y["xi"], "y_psi": y["psi"], "z_xi": z["xi"],
                       "z_psi": z["psi"], "x": x, "u": u, "v": v}
                keep = ss.per_instance(active)
                new = {k: torch.where(keep, new[k], old[k]) for k in new}
                signed = torch.where(active, signed,
                                     torch.zeros_like(signed))
                u0 = torch.where(active[..., None], u0, torch.zeros_like(u0))
            y = {"xi": new["y_xi"], "psi": new["y_psi"]}
            z = {"xi": new["z_xi"], "psi": new["z_psi"]}
            x, u, v = new["x"], new["u"], new["v"]
            trace.append(signed)
            if trace_control:
                controls.append(u0)
            iterations += active.to(torch.int32)
            if tolerance is not None:
                active = active & (ss.max_abs_residual(o["res_xi"],
                                                       o["res_psi"], mesh)
                                   > tolerance)
                if not bool(active.any()):
                    break
        infeas = zeros(max_iterations)
        if trace:
            infeas[..., :len(trace)] = torch.stack(trace, dim=-1)
        lo, hi = ss.root_control_bounds(fa)
        out = {"control": torch.clamp(u[..., 0, 0, :], lo, hi), "x": x,
               "u": u, "v": v, "y": y, "primal_infeasibility": infeas,
               "iterations": iterations}
        if trace_control:
            out["control_trace"] = zeros(max_iterations, nu)
            if controls:
                out["control_trace"][..., :len(controls), :] = torch.stack(
                    controls, dim=-2)
        return out

    return run


def make_apg_batch(**kwargs):
    """Batched APG: B independent instances sharing the factor tensors.

    Returns fn(fa, steps, y0=None): every leaf of ``steps`` (and of the
    warm start ``y0``, when given) carries a leading batch axis, as do
    the outputs (``iterations`` is (B,)).  It is ``make_apg``'s solve,
    which takes the leading axis as it comes.
    """
    return make_apg(**kwargs)


def expand_shared_step(base: dict, x0, prev_u, prev_uhat, delta_beta0):
    """The step dict from the shared base + the per-instance vectors
    (Engine.prepare_step_shared): only the root-stage beta differs.

    With a leading batch axis on the vectors, every leaf of the result
    gets one: beta is assembled on the vectors' device, and uhat and e
    are views of the base with batch stride 0 (as is alpha_price, where
    the base has it).
    """
    lead = tuple(delta_beta0.shape[:-1])
    beta = base["beta"].expand(*lead, *base["beta"].shape).clone()
    beta[..., 0, :, :] += delta_beta0[..., None, :]
    out = {k: v.expand(*lead, *v.shape) for k, v in base.items()
           if k != "beta"}
    return dict(out, beta=beta, x0=x0, prev_u=prev_u, prev_uhat=prev_uhat)


def make_apg_batch_shared(**kwargs):
    """Batched APG over a shared forecast: fn(fa, base, inst, y0=None).

    ``base`` holds the unbatched fan arrays; ``inst`` the per-instance
    {x0, prev_u, prev_uhat, delta_beta0} (Engine.prepare_step_shared).
    The batched steps are assembled on the device (``expand_shared_step``).
    """
    run_batch = make_apg_batch(**kwargs)

    def run(fa, base, inst, y0=None):
        return run_batch(fa, expand_shared_step(base, **inst), y0)

    return run
