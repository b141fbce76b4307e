"""The dual-gradient oracle: one backward/forward tree sweep, in PyTorch.

Counterpart of ``rapidnet_tpu/solver/solve_step.py`` (reference:
``SmpcController::solveStep``, src/SmpcController.cu:563-755, and the
Hessian oracle ``computeHessianOracalGlobalFbe``, :884-1055).

Fan layout (see model/scenario_tree.py): every stage holds ``ns`` slots,
so the forward sweep needs no gathers and only the short branching
prefix needs child->parent aggregation.  Both sweeps are the sequential
stage recursion of the JAX package's large-tree branch: a loop over
stages carrying the recursion state, with the terms that depend on the
duals alone computed for every stage at once before the loop.  The
per-stage math is two products against shared small matrices.

Every array is float32; products run in full float32 (PyTorch's default
with TF32 off), the counterpart of ``Precision.HIGHEST`` in the JAX
package.

Every function also takes a leading batch axis on the per-instance
arrays (the duals, beta, uhat, e, x0, prev_u, prev_uhat): B independent
instances over one factor step, with the stage, slot and feature axes
last.  The norms, champions and residual magnitudes are then per
instance (over the last three axes).

``mesh``: a ``parallel.Mesh``, the counterpart of the JAX functions'
``axis_name``.  Every rank then holds its block of the slot axis (the
factor dict cut by ``parallel.shard_factor_arrays``) and the collectives
stand where the JAX module has them: the prefix parent block's ``psum``
in the backward sweep (only the (Rp, nx+nv) block crosses ranks), the
``psum`` of the penalty norms in ``prox_g``, the gather of each rank's
champion in ``signed_max_abs`` (the trace stays the same on every rank)
and the ``pmax`` of ``max_abs_residual``.  ``mesh=None`` is the
single-device function.
"""

from __future__ import annotations

import torch


def backward_sweep(fa: dict, w_xi: torch.Tensor, w_psi: torch.Tensor,
                   beta: torch.Tensor, *, prefix_stages: tuple, mesh=None
                   ) -> torch.Tensor:
    """Backward substitution: dual gradient recursion over stages N-1..0.

        t_s     = d1 xi1_s + d2 xi2_s + t_{s+1}
        inner_s = beta_s + inner_{s+1} + t_s Bb' + (g psi_s) L
        v_s     = nhp_s * inner_s invWbar'

    with (t, inner) aggregated child->parent through the factored
    ``prefix_Cp``/``prefix_Bp`` after each stage of ``prefix_stages``;
    on a ``mesh`` the parent block ``Cp @ [t | inner]`` is summed over
    the ranks before ``Bp`` hands it back to the rank's slots.

    Args:
      fa: factor tensors (fan layout d1/d2/g/nhp + shared Bb/L/invWbar).
      w_xi:  (N, ns, 2nx) dual xi input (accelerated dual).
      w_psi: (N, ns, nu) dual psi input.
      beta:  (N, ns, nv) linear cost term (zeros for the Hessian oracle).
      prefix_stages: descending tuple of stages whose child->parent
        handoff needs aggregation (from ScenarioTree.prefix_agg).
    Returns:
      v: (N, ns, nv) candidate null-space controls per stage.
    """
    Bb, L, invWbar = fa["Bb"], fa["L"], fa["invWbar"]
    nx = Bb.shape[1]
    N = w_xi.shape[-3]
    tb = fa["d1"] * w_xi[..., :nx] + fa["d2"] * w_xi[..., nx:]
    h = (fa["g"] * w_psi) @ L
    BbT = Bb.T
    q = torch.zeros_like(tb[..., 0, :, :])
    r = torch.zeros_like(h[..., 0, :, :])
    inner = []
    for s in range(N - 1, -1, -1):
        q = tb[..., s, :, :] + q
        r = beta[..., s, :, :] + r + q @ BbT + h[..., s, :, :]
        inner.append(r)
        if s > 0 and s in prefix_stages:
            Cp, Bp = fa["prefix_Cp"][s], fa["prefix_Bp"][s]
            pq, pr = Cp @ q, Cp @ r
            if mesh is not None:
                parents = mesh.psum(torch.cat([pq, pr], dim=-1))
                pq = parents[..., :nx].contiguous()
                pr = parents[..., nx:].contiguous()
            q = Bp @ pq
            r = Bp @ pr
    inner = torch.stack(inner[::-1], dim=-3)
    return fa["nhp"] * (inner @ invWbar.T)


def forward_sweep(fa: dict, v: torch.Tensor, uhat: torch.Tensor,
                  e: torch.Tensor, x0: torch.Tensor, prev_u: torch.Tensor,
                  prev_uhat: torch.Tensor):
    """Forward substitution + primal H application.

    u_s = uhat_s + du_s with du_s = du_{s-1} + v_s L' (du_{-1} =
    prev_u - prev_uhat);  x_s = x_{s-1} + e_s + u_s B'  (x_{-1} = x0).
    In fan layout the ancestor terms live at the same slot.

    Returns x (N,ns,nx), u (N,ns,nu), prim_xi (N,ns,2nx), prim_psi (N,ns,nu).
    """
    L, B = fa["L"], fa["B"]
    N, ns = v.shape[-3:-1]
    lead = v.shape[:-3]
    dv = v @ L.T
    BT = B.T
    du = (prev_u - prev_uhat)[..., None, :].expand(*lead, ns, L.shape[0])
    x = x0[..., None, :].expand(*lead, ns, B.shape[0])
    xs, us = [], []
    for s in range(N):
        du = du + dv[..., s, :, :]
        u_s = uhat[..., s, :, :] + du
        x = x + e[..., s, :, :] + u_s @ BT
        xs.append(x)
        us.append(u_s)
    x = torch.stack(xs, dim=-3)
    u = torch.stack(us, dim=-3)
    prim_xi = torch.cat([fa["d1"] * x, fa["d2"] * x], dim=-1)
    prim_psi = fa["g"] * u
    return x, u, prim_xi, prim_psi


def solve_step(fa: dict, w_xi, w_psi, beta, uhat, e, x0, prev_u, prev_uhat,
               *, prefix_stages: tuple, mesh=None):
    """Full dual-gradient oracle (backward + forward + primal).

    With beta/uhat/e/x0/prev_* zeroed this is exactly the Hessian oracle
    of the FBE/NAMA algorithms.
    """
    v = backward_sweep(fa, w_xi, w_psi, beta, prefix_stages=prefix_stages,
                       mesh=mesh)
    x, u, prim_xi, prim_psi = forward_sweep(
        fa, v, uhat, e, x0, prev_u, prev_uhat)
    return {"v": v, "x": x, "u": u,
            "prim_xi": prim_xi, "prim_psi": prim_psi}


def _masked_sumsq(x, rep):
    """Sum of squares counting each tree node once (rep de-duplicates),
    per instance."""
    return torch.sum((rep[..., None] * x * x).flatten(-3), dim=-1)


def psum_all(mesh, *parts):
    """The tensors ``parts`` (of one shape) each summed over the mesh's
    ranks, in one all-reduce; unchanged without a mesh."""
    if mesh is None:
        return parts
    return tuple(mesh.psum(torch.stack(parts)).unbind(0))


def per_instance(v):
    """A per-instance scalar, broadcast over the (N, ns, d) axes."""
    return v[..., None, None, None]


def _shrink(dist, thresh):
    return torch.where(dist > thresh,
                       1.0 - thresh / torch.clamp(dist, min=1e-30),
                       torch.zeros_like(dist))


def prox_g(fa: dict, prim_xi, prim_psi, w_xi, w_psi, *, inv_step: float,
           penalty_state: float, penalty_safety: float, xs_upper: float,
           mesh=None):
    """Proximal operator of the constraint function g on the dual pair.

    Reference: SmpcController::proximalFunG (src/SmpcController.cu:
    759-835): box projections on state/control plus soft two-norm
    penalties on the state-box and safety-level violations (a
    global-norm shrink step).

    Returns dual_xi, dual_psi and the g-cost pieces used by the FBE value.
    """
    nx = fa["Bb"].shape[1]
    rep = fa["rep"]
    dual_xi = prim_xi + inv_step * w_xi
    dual_psi = prim_psi + inv_step * w_psi

    pre1 = dual_xi[..., :nx]
    pre2 = dual_xi[..., nx:]
    box1 = torch.clamp(pre1, fa["xmin"], fa["xmax"])
    box2 = torch.clamp(torch.maximum(pre2, fa["xs"]), max=xs_upper)
    diff1 = pre1 - box1
    diff2 = pre2 - box2

    sq1, sq2 = psum_all(mesh, _masked_sumsq(diff1, rep),
                        _masked_sumsq(diff2, rep))
    shrink1 = _shrink(torch.sqrt(sq1), inv_step * penalty_state)
    out1 = box1 + per_instance(shrink1) * diff1
    shrink2 = _shrink(torch.sqrt(sq2), inv_step * penalty_safety)
    out2 = box2 + per_instance(shrink2) * diff2

    dual_xi = torch.cat([out1, out2], dim=-1)
    dual_psi = torch.clamp(dual_psi, fa["umin"], fa["umax"])

    # g-cost pieces (FBE/NAMA value function, src/SmpcController.cu:
    # 798-825): penalty * distance-from-set of the post-prox point.
    gd1, gd2 = psum_all(
        mesh,
        _masked_sumsq(out1 - torch.clamp(out1, fa["xmin"], fa["xmax"]), rep),
        _masked_sumsq(out2 - torch.clamp(torch.maximum(out2, fa["xs"]),
                                         max=xs_upper), rep))
    gd1, gd2 = torch.sqrt(gd1), torch.sqrt(gd2)
    zero = torch.zeros_like(gd1)
    value_g = (torch.where(shrink1 > 0, penalty_state * gd1, zero) +
               torch.where(shrink2 > 0, penalty_safety * gd2, zero))
    return dual_xi, dual_psi, value_g


def root_control_bounds(fa: dict):
    """Bounds for the final control projection — PHYSICAL units.

    The reference clips u0 onto bounds scaled by the preconditioner
    (src/Engine.cu:447-448, src/SmpcController.cu:1649); the JAX package
    and this port project onto the network's physical bounds
    (``umin_phys``/``umax_phys``) instead (docs/parity.md).
    """
    if "umin_phys" in fa:
        return fa["umin_phys"], fa["umax_phys"]
    return fa["umin"][0, 0], fa["umax"][0, 0]


def _champion(flat):
    """The signed value of the first entry of largest magnitude along the
    last axis."""
    at = torch.argmax(torch.abs(flat), dim=-1, keepdim=True)
    return torch.gather(flat, -1, at).squeeze(-1)


def signed_max_abs(res_xi, res_psi, mesh=None):
    """Primal infeasibility diagnostic (the trace).

    Reference quirk preserved (src/SmpcController.cu:1480-1496): Isamax
    picks the entry with max |value| but the *signed* value is returned,
    and the max of the xi/psi representatives is taken.  ``torch.argmax``
    returns the first maximal index, as ``jnp.argmax`` does.  On a
    ``mesh`` each rank's two champions are gathered (one gather) and the
    champion of the ranks' champions taken per block, so every rank
    holds the same trace.
    """
    vx = _champion(res_xi.flatten(-3))
    vp = _champion(res_psi.flatten(-3))
    if mesh is not None:
        ranks = mesh.all_gather(torch.stack([vx, vp], dim=-1)[..., None],
                                dim=-1)
        vx, vp = _champion(ranks).unbind(-1)
    return torch.maximum(vx, vp)


def max_abs_residual(res_xi, res_psi, mesh=None):
    """True residual magnitude max(|res_xi|, |res_psi|)_max — the
    stopping rule.  The signed trace can cancel to ~0 when the two
    blocks' champions have opposite signs, so it is never used to stop.
    On a ``mesh`` the ranks' magnitudes are reduced by a ``pmax``.
    """
    m = torch.maximum(torch.abs(res_xi).flatten(-3).amax(dim=-1),
                      torch.abs(res_psi).flatten(-3).amax(dim=-1))
    return m if mesh is None else mesh.pmax(m)
