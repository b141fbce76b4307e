"""Streaming global-FBE / NAMA for large scenario trees, in PyTorch.

Counterpart of ``rapidnet_tpu/solver/qn_stream.py`` (``make_qn_stream``
with ``mesh=None``; reference: ``algorithmGlobalFbe`` / ``algorithmNama``,
src/SmpcController.cu:1529-1586): the algorithms of
``solver/quasi_newton.py`` for trees past the whole-solve QN kernel's
limits (BASELINE config 5), built on the streaming layout:

* every dual or primal slab is unpadded, stage-major (N, ns, d); the
  dual triple is one (N, ns, D) tensor, D = 2 nx + nu, [y1 | y2 | yp]
  per row (``ops/stream_qn.py``);
* the three oracle sweeps of an iteration (the solve step and the
  Hessian oracle on two directions) are the S1/S2 kernels
  (``ops/stream_qn.py``, ``csrc/stream_qn.cu``);
* the L-BFGS history is touched twice an iteration, by the dots and the
  combine kernels (``ops/lbfgs.py``, ``csrc/lbfgs.cu``), because the
  two-loop recursion runs on span coefficients over carried Gram
  matrices (Gss, Gsy, Gyy, updated one row and column per accepted
  pair); the history is stored in float32 or bfloat16 (``lbfgs_dtype``)
  and updated in place, one column per accepted pair;
* the prox of g, the FBE value and every line-search trial follow from
  reductions by the JAX package's scalar identities (its docstring,
  :19-52): one reduction pass for the shrink scalars, one residual slab,
  and one reduction pass per trial with no slab written.

Everything between the kernels is PyTorch on the device, and nothing in
the iterations reads a value back to the host: the decisions (accept a
curvature pair, skip the search, the first failing trial) are device
scalars used through ``torch.where`` and masks.  So on a CUDA device one
iteration is captured as a CUDA graph and replayed (``replayed``): the
host enqueues an iteration with one call.  The line search's trial
ladder is deterministic (1, 1/2, ..., 1/2^9, 0), so all eleven trials
are reduced and the first failing one is picked on the device, where the
JAX package's while loop stops at it; the state applied is the same.

Iteration 0 has no quasi-Newton step (the JAX package masks it with
``qn_on``; here the loop index decides it on the host): the plain dual
step, with value and tau zero.

The NaN rule is ``qn_stream``'s: a trial stops the ladder when
``val > value_ref``, so a NaN trial value does not stop it, and a ladder
of NaN values walks down to tau = 0, which applies nothing
(``ladder_pick``).  ``solver/quasi_newton.py`` stops on a NaN instead.

The output contract is ``quasi_newton.make_solver``'s: control (the
stage-0 u projected on the physical bounds), x, u, v, y {xi, psi},
primal_infeasibility, value_fbe, tau and iterations.  The budget is
fixed: a tolerance raises, as in the JAX package.

With ``mesh=`` (a ``parallel.Mesh``) the same solve runs scenario-sharded
(``qn_stream.py:177-197``, ``:238-241``, ``:819-849``), one process per
shard: each rank holds its block of slots of every slab and of the
history, the backward sweep is ``stream_qn.s1a_call`` (the partial
parent block of the top cross stage all-reduced), S2 runs on the block,
and every reduction the JAX code psums is all-reduced (SUM): the diff
dots, the value's dots and f-terms, the history dots (after the dots
kernel's own fixed-order reduction on the block), and the line search's
quadratics with all eleven trials' scalars in one call.  So every rank
takes the same decisions from the same reduced scalars.  The champion
of each iteration is kept as the block's four extrema and reduced (MAX)
once at the end.  An iteration has seven all-reduces (and one more for
each sweep per prefix stage below the top cross stage that crosses
shards); every iteration runs eagerly (no graph: a gloo collective
waits for the card).  ``run(step, y0)`` takes the global step and warm
start on every rank and returns the global layout on every rank, the
control rank 0's root slot summed from masked values.

Not ported: ``emulate_shards``, ``ablate``, ``stage_block``,
``interpret``, the padded transposed layout and any precision but full
float32.
"""

from __future__ import annotations

import torch

from rapidnet_tpu_torch.model.config import ALGORITHM_FBE, ALGORITHM_NAMA
from rapidnet_tpu_torch.ops import apg_stream as S
from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
from rapidnet_tpu_torch.ops import lbfgs as LB
from rapidnet_tpu_torch.ops import stream_qn as SQ
from rapidnet_tpu_torch.solver import solve_step as ss
from rapidnet_tpu_torch.solver.quasi_newton import LS_MAX_STEPS, LS_TOLERANCE

LBFGS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOLERANCE_MESSAGE = (
    "the streaming FBE/NAMA solve runs a fixed budget (no tolerance-based "
    "early termination); use backend='cuda' or 'torch'")
# the evaluation points of the cumulative tau loop, and the tau it
# reports for each (the capped 11th trial lands on 0 and reports the
# last increment); qn_stream.py:565-571
LADDER = (1.0,) + tuple(0.5 ** k for k in range(1, LS_MAX_STEPS)) + (0.0,)
LADDER_TAU = LADDER[:-1] + (0.5 ** (LS_MAX_STEPS - 1),)


def lbfgs_storage(lbfgs_dtype) -> torch.dtype:
    """The history's torch dtype from None (float32), 'float32' or
    'bfloat16'."""
    if lbfgs_dtype is None:
        return torch.float32
    if lbfgs_dtype not in LBFGS_DTYPES:
        raise ValueError(f"lbfgs_dtype must be 'float32' or 'bfloat16', "
                         f"got '{lbfgs_dtype}'")
    return LBFGS_DTYPES[lbfgs_dtype]


def ladder_pick(vals, value_ref):
    """The index of the first trial that fails (``val > value_ref``), or
    the last: ``qn_stream.py:581-587``.  A NaN value is no failure."""
    n = vals.shape[0]
    found = (vals > value_ref) | (torch.arange(n, device=vals.device) ==
                                  n - 1)
    return torch.argmax(found.to(torch.int32))


def _pick(t, k):
    """t[k] for a 0-dim index tensor on t's device, with no read back to
    the host."""
    return t.index_select(0, k.view(1))[0]


def signed_champion(res, nx):
    """signed_max_abs as the streaming kernels take it (per block max and
    min, ``qn_stream.signed_champion``)."""
    return S._champion(res[..., :2 * nx], res[..., 2 * nx:])


def make_qn_stream(fa: dict, *, algorithm: str, prefix_stages: tuple,
                   inv_step: float, step_size: float, penalty_state: float,
                   penalty_safety: float, xs_upper: float,
                   max_iterations: int, lbfgs_buffer_size: int,
                   tolerance=None, lbfgs_dtype=None, consts=None,
                   mesh=None):
    """Build the streaming FBE/NAMA solve: run(step, y0=None) -> outputs.

    ``consts``: ``apg_stream.stream_constants(fa, ...)``, or on a mesh
    this rank's ``apg_stream_sharded.pack_stream_sharded``, when the
    caller already packed them (the controller's gate).
    ``lbfgs_dtype``: the history's storage, float32 (default) or
    bfloat16.  ``y0``: a dual warm start {"xi", "psi"} in the XLA path's
    layout; the history starts fresh.  ``mesh``: a ``parallel.Mesh``, the
    scenario-sharded solve (module docstring); every rank calls ``run``
    with the same global inputs.  On CPU tensors the kernels' plain
    versions run.
    """
    if tolerance is not None:
        raise ValueError(TOLERANCE_MESSAGE)
    is_fbe = algorithm == ALGORITHM_FBE
    if not is_fbe and algorithm != ALGORITHM_NAMA:
        raise ValueError(f"unknown quasi-Newton algorithm {algorithm}")
    if int(max_iterations) < 1:
        raise ValueError("the streaming solve runs at least one iteration")
    bs = int(lbfgs_buffer_size)
    n_cols = bs + 1
    if not 1 <= bs <= LB.MAX_COLS - 1:
        raise ValueError(f"lbfgs_buffer_size {bs}: the history kernels take "
                         f"1 to {LB.MAX_COLS - 1}")
    nb = lbfgs_storage(lbfgs_dtype)
    if mesh is None:
        kc = consts if consts is not None else S.stream_constants(
            fa, prefix_stages=prefix_stages,
            max_iterations=int(max_iterations))
    else:
        SS.check_mesh(mesh, fa)
        if consts is not None:
            SS.check_consts(mesh, consts)
        kc = consts if consts is not None else SS.pack_stream_sharded(
            fa, mesh.size, mesh.rank, prefix_stages=prefix_stages,
            max_iterations=int(max_iterations))
    N, ns, nx, nu, nv = SQ.dims(kc)
    D = 2 * nx + nu
    dev = kc["sq"].device
    c = float(inv_step)
    step_c = float(step_size)
    t1c = float(inv_step * penalty_state)
    t2c = float(inv_step * penalty_safety)
    f32 = torch.float32

    # ---------------- constants beyond the sweeps' ----------------
    rep3 = kc["rep"][..., None].contiguous()         # (N, ns, 1)
    p3 = (kc["sq"] * kc["sq"])[..., None]            # node probability

    def bounds():
        """The box of the dual triple as two (N, ns, D) slabs, [y1 | y2 |
        yp] per row (``bounds`` and ``_group_bounds``: the one layout needs
        one pair; y2's upper bound is xs_upper)."""
        lo = torch.cat([S._rows(kc, "bx_min"), S._rows(kc, "bx_s"),
                        S._rows(kc, "bu_min")], dim=-1)
        hi = torch.cat([S._rows(kc, "bx_max"),
                        torch.full((N, ns, nx), float(xs_upper), device=dev),
                        S._rows(kc, "bu_max")], dim=-1)
        return lo, hi

    lo, hi = bounds()
    WT = fa["W"].T.contiguous()
    seg = torch.zeros(D, 3, dtype=f32, device=dev)   # columns -> keys
    seg[:nx, 0] = 1.0
    seg[nx:2 * nx, 1] = 1.0
    seg[2 * nx:, 2] = 1.0
    key_of_col = seg.argmax(dim=1)
    ladder = torch.tensor(LADDER, dtype=f32, device=dev)
    ladder_tau = torch.tensor(LADDER_TAU, dtype=f32, device=dev)
    cols = torch.arange(n_cols, device=dev)
    steps = torch.arange(bs, device=dev)
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    lo_b, hi_b = ss.root_control_bounds(fa)

    rows = N * ns
    rep_row = kc["rep"].reshape(1, rows)
    trial_buf = torch.empty(rows, 5, D, dtype=f32, device=dev)

    def key_sums(prod):
        """Per-key rep-weighted sums of a product slab (N, ns, D): (3,)."""
        return (rep_row @ prod.view(rows, D))[0] @ seg

    def key_sums5(pairs):
        """Per-key rep-weighted sums of a * b for five (a, b) pairs, the
        products written side by side and summed by one product with
        rep: (5, 3)."""
        for i, (a, b) in enumerate(pairs):
            torch.mul(a.view(rows, D), b.view(rows, D), out=trial_buf[:, i])
        return (rep_row @ trial_buf.view(rows, 5 * D)).view(5, D) @ seg

    def shr_cols(shr):
        """A per-key shrink (3,) spread over the D columns."""
        return shr[key_of_col]

    def red(*ts):
        """The block sums ``ts`` summed over the mesh in one all-reduce
        (the JAX code's psums); as they are on one device."""
        if mesh is None:
            return ts
        flat = mesh.psum(torch.cat([t.reshape(-1) for t in ts]))
        return tuple(part.view(t.shape) for part, t in
                     zip(flat.split([t.numel() for t in ts]), ts))

    def champion(res):
        """The signed champion of a residual; on a mesh the block's
        [hi_x, -lo_x, hi_u, -lo_u], reduced once after the solve."""
        if mesh is None:
            return signed_champion(res, nx)
        return SS.for_max(SS._extrema(res[..., :2 * nx], res[..., 2 * nx:]))

    # ---------------- prox of g by scalar identities ----------------
    def diff_dots(prim, w):
        """The box and the clip distance of pre = prim + c w, and the
        per-key ||pre - clip(pre)||^2, rep-weighted, in one pass
        (``diff_dots``; the box and distance are kept for ``res_slabs``)."""
        pre = torch.add(prim, w, alpha=c)
        box = torch.clamp(pre, lo, hi)
        diff = pre - box
        return box, diff, red(key_sums(diff * diff))[0]

    def shrink_scalars(dd):
        """The two-norm shrink factors (per key; yp never shrinks) and the
        value of g from the diff dots (``shrink_scalars``); dd may carry
        a leading trial axis."""
        dist1 = torch.sqrt(dd[..., 0])
        s1 = torch.where(dist1 > t1c, 1.0 - t1c / torch.clamp(dist1, min=1e-30),
                         zero)
        dist2 = torch.sqrt(dd[..., 1])
        s2 = torch.where(dist2 > t2c, 1.0 - t2c / torch.clamp(dist2, min=1e-30),
                         zero)
        value_g = (torch.where(s1 > 0, penalty_state * s1 * dist1, zero) +
                   torch.where(s2 > 0, penalty_safety * s2 * dist2, zero))
        return torch.stack([s1, s2, torch.zeros_like(s1)], dim=-1), value_g

    def res_slabs(prim, box, diff, shr):
        """res = prim - (box + shrink (pre - box)) (``res_slabs``)."""
        return prim - (box + shr_cols(shr) * diff)

    def smooth_econ(sp, u):
        """The f-terms of the FBE value (``smooth_econ``)."""
        du = torch.cat([(u[0] - sp["prev_u"])[None], u[1:] - u[:-1]])
        smooth = torch.sum(rep3 * (p3 * du) * (du @ WT))
        econ = torch.sum(rep3 * (p3 * u) * sp["alpha"])
        return smooth + econ

    # ---------------- oracles ----------------
    def backward(w, beta=None):
        if mesh is None:
            return SQ.s1_call(kc, w, beta)
        return SQ.s1a_call(kc, w, mesh, beta)

    def solve(sp, w):
        v = backward(w, sp["beta"])
        x, u, prim = SQ.s2_call(kc, v, sp["uhat"], sp["e"], sp["x0"],
                                sp["pdu"])
        return {"v": v, "x": x, "u": u, "prim": prim}

    def linmap(d):
        """The Hessian oracle: the same recursion, no affine terms."""
        v = backward(d.contiguous())
        x, u, prim = SQ.s2_call(kc, v)
        return {"v": v, "x": x, "u": u, "prim": prim}

    # ---------------- L-BFGS: Gram-matrix two-loop ----------------
    def lbfgs_update_and_direction(lb, y, y_prev, yvec, yvec_prev):
        """updateLbfgsBuffer + twoLoopRecursionLbfgs, Gram form
        (``lbfgs_update_and_direction``, ``qn_on`` true): one dots pass,
        the accept test and the masked updates of the history column,
        rho and the Gram rows on the device, then the two loops over the
        coefficients, each ``bs`` masked steps (a step past ``mem`` is a
        no-op)."""
        s = (y - y_prev).to(nb)
        yv = (yvec - yvec_prev).to(nb)
        dS, dY, selfd = red(*LB.dots(kc["rep"], lb["mat_s"], lb["mat_y"], s,
                                     yv, yvec))
        dSs, dSy, dSg = dS[:, 0], dS[:, 1], dS[:, 2]
        dYs, dYy, dYg = dY[:, 0], dY[:, 1], dY[:, 2]
        norm_s2, inv_rho, norm_y2 = selfd[0], selfd[1], selfd[2]
        gg, gs_self, gy_self = selfd[3], selfd[4], selfd[5]
        norm_grad = torch.sqrt(gg)
        norm_grad = torch.where(norm_grad < 1.0, norm_grad ** 3, norm_grad)
        accept = (inv_rho / torch.clamp(norm_s2, min=1e-30)
                  > 1e-6 * norm_grad)
        col_new = 1 + lb["col"] % bs
        col = torch.where(accept, col_new, lb["col"])
        mem = torch.where(accept, torch.clamp(lb["mem"] + 1, max=bs),
                          lb["mem"])
        # the new pair written in place into column col_new when accepted
        # (column 0 stays zero; a rejected pair leaves the history as it
        # was)
        at = col_new.view(1)
        for name, new in (("mat_s", s), ("mat_y", yv)):
            mat = lb[name]
            old = mat.index_select(0, at)[0]
            mat.index_copy_(0, at, torch.where(accept, new, old)[None])
        hit = cols == col_new                          # one-hot of col_new
        rho = torch.where(hit & accept, 1.0 / inv_rho, lb["rho"])
        skips = lb["skips"] + (~accept).to(lb["skips"].dtype)
        gamma = inv_rho / torch.clamp(norm_y2, min=1e-30)
        hessian = torch.where((gamma < 0) | (torch.abs(gamma - lb["hessian"])
                                             == 0), one, gamma)

        def put_row_col(G, row, colv):
            Gn = torch.where(hit[:, None], row[None, :], G)
            Gn = torch.where(hit[None, :], colv[:, None], Gn)
            return torch.where(accept, Gn, G)

        v_ss = torch.where(hit, norm_s2, dSs)
        v_yy = torch.where(hit, norm_y2, dYy)
        Gss = put_row_col(lb["Gss"], v_ss, v_ss)
        Gyy = put_row_col(lb["Gyy"], v_yy, v_yy)
        Gsy = put_row_col(lb["Gsy"], torch.where(hit, inv_rho, dYs),
                          torch.where(hit, inv_rho, dSy))
        gs_vec = torch.where(accept & hit, gs_self, dSg)
        gy_vec = torch.where(accept & hit, gy_self, dYg)

        # two-loop recursion on span coefficients (dir = -grad)
        ic1 = col - steps
        ic1 = torch.where(ic1 < 0, mem + ic1, ic1)
        act = steps < mem
        ic1c = torch.clamp(ic1, 0, n_cols - 1)
        rows_s, rows_y = Gss.index_select(0, ic1c), Gsy.index_select(0, ic1c)
        gsv, rh1 = gs_vec.index_select(0, ic1c), rho.index_select(0, ic1c)
        cs = torch.zeros(n_cols, dtype=f32, device=dev)
        cy = torch.zeros(n_cols, dtype=f32, device=dev)
        cg = -one
        alphas = torch.zeros(n_cols, dtype=f32, device=dev)
        for i in range(bs):
            sd = rows_s[i] @ cs + rows_y[i] @ cy + cg * gsv[i]
            a = rh1[i] * sd
            sel = (cols == ic1[i]) & act[i]
            cy = torch.where(sel, cy - a, cy)
            alphas = torch.where(sel, a, alphas)
        cs, cy, cg = hessian * cs, hessian * cy, hessian * cg
        ic2 = col - (mem - steps) + 1
        ic2 = torch.where(ic2 < 0, mem + ic2, ic2)
        ic2c = torch.clamp(ic2, 0, n_cols - 1)
        cols_sy = Gsy.T.index_select(0, ic2c)       # Gsy[:, icol]
        rows_yy = Gyy.index_select(0, ic2c)
        gyv, rh2 = gy_vec.index_select(0, ic2c), rho.index_select(0, ic2c)
        for j in range(bs):
            yd = cols_sy[j] @ cs + rows_yy[j] @ cy + cg * gyv[j]
            b = rh2[j] * yd
            sel = (cols == ic2[j]) & act[j]
            cs = torch.where(sel, cs + (alphas - b), cs)
        lb_new = {"mat_s": lb["mat_s"], "mat_y": lb["mat_y"], "rho": rho,
                  "col": col, "mem": mem, "skips": skips,
                  "hessian": hessian, "Gss": Gss, "Gsy": Gsy, "Gyy": Gyy}
        return lb_new, (cs, cy, cg), (gs_vec, gy_vec, gg)

    def direction(lb, coef, g, g_extra):
        """dir = sum cs s + sum cy y + (cg + g_extra) g: the second
        history pass (``g_extra = step`` gives NAMA's d + step grad)."""
        cs, cy, cg = coef
        coefv = torch.cat([cs, cy, (cg + g_extra).reshape(1)])
        return LB.combine(coefv, lb["mat_s"], lb["mat_y"], g)

    # ---------------- reduction-only line search ----------------
    def _ls_quadratics(sp, base, u_dir):
        """The tau-polynomials of the smoothness and economic terms
        (``_ls_quadratics``)."""
        u0 = base["u"]
        du0 = torch.cat([(u0[0] - sp["prev_u"])[None], u0[1:] - u0[:-1]])
        dud = torch.cat([u_dir[0][None], u_dir[1:] - u_dir[:-1]])
        Wd0, Wdd = du0 @ WT, dud @ WT
        pd0, pdd = p3 * du0, p3 * dud
        s0 = torch.sum(rep3 * pd0 * Wd0)
        s1 = torch.sum(rep3 * pd0 * Wdd) + torch.sum(rep3 * pdd * Wd0)
        s2 = torch.sum(rep3 * pdd * Wdd)
        e0 = torch.sum(rep3 * (p3 * u0) * sp["alpha"])
        e1 = torch.sum(rep3 * (p3 * u_dir) * sp["alpha"])
        return torch.stack([s0, s1, s2, e0, e1])

    def _ls_trial_scalars(base, w_dir, p_dir):
        """Every trial of the ladder, one reduction pass each
        (``_ls_trial_scalars``): per tau and key dd = <diff, diff>,
        dw = <w_t, diff>, a0 = <w_t, res0>, b0 = <res0, res0>,
        rd = <res0, diff>; (n_trials, 5, 3)."""
        out = []
        for tau in LADDER:
            w_t = torch.add(base["w"], w_dir, alpha=tau)
            prim_t = torch.add(base["prim"], p_dir, alpha=tau)
            pre = torch.add(prim_t, w_t, alpha=c)
            box = torch.clamp(pre, lo, hi)
            diff = pre - box
            res0 = prim_t - box
            out.append(key_sums5(((diff, diff), (w_t, diff), (w_t, res0),
                                  (res0, res0), (res0, diff))))
        return torch.stack(out)

    def _ls_val_from(sc, fq):
        """val(tau) of every trial from its scalars (``_ls_val_from``);
        returns (vals, shrinks (n_trials, 3))."""
        dd, dw, a0, b0, rd = (sc[:, k] for k in range(5))
        shr, value_g = shrink_scalars(dd)
        wr = torch.sum(a0 - shr * dw, dim=-1)
        rr = torch.sum(b0 - 2.0 * shr * rd + shr * shr * dd, dim=-1)
        s0, s1, s2, e0, e1 = fq
        f_tau = s0 + ladder * s1 + ladder * ladder * s2 + e0 + ladder * e1
        return wr + 0.5 * step_c * rr + value_g + f_tau, shr

    def tau_search_apply(base, w_dir, p_dir, dirs, fq, value_ref, dval):
        """The cumulative backtracking tau loop (``tau_search_apply``):
        the state and tau of the first failing trial, or no step when the
        direction is not one of descent; one masked materialise.
        Returns (x, u, y_new, infeasibility, tau)."""
        skip = (dval > 0) | (torch.abs(dval) < LS_TOLERANCE)
        trials, fq = red(_ls_trial_scalars(base, w_dir, p_dir), fq)
        vals, shr = _ls_val_from(trials, fq)
        k_star = ladder_pick(vals, value_ref)
        applied = ~skip
        tau_eff = torch.where(applied, _pick(ladder, k_star), zero)
        tau_rep = torch.where(applied, _pick(ladder_tau, k_star),
                              torch.where(dval > 0, one, zero))
        x = base["x"] + tau_eff * dirs["x"]
        u = base["u"] + tau_eff * dirs["u"]
        wt = base["w"] + tau_eff * w_dir
        prim_t = base["prim"] + tau_eff * p_dir
        pre = torch.add(prim_t, wt, alpha=c)
        box = torch.clamp(pre, lo, hi)
        res_t = prim_t - (box + shr_cols(_pick(shr, k_star)) * (pre - box))
        rf = torch.where(applied, res_t, base["res0"])
        return x, u, wt + step_c * rf, champion(rf), tau_rep

    def fbe_line_search(sp, base, lbfgs_dir, value_ref, dval):
        """computeLineSearchLbfgsUpdate (src/SmpcController.cu:1250-1320)."""
        h = linmap(lbfgs_dir)
        fq = _ls_quadratics(sp, base, h["u"])
        return tau_search_apply(base, lbfgs_dir, h["prim"],
                                {"x": h["x"], "u": h["u"]}, fq, value_ref,
                                dval)

    def ame_line_search(sp, state, comb, res, value_ref, dval):
        """computeLineSearchAmeLbfgsUpdate (src/SmpcController.cu:
        1326-1414): the gradient step applied, then the tau loop along
        comb = lbfgsDir - step * res."""
        hres = linmap(res)
        base = {"x": state["x"] + step_c * hres["x"],
                "u": state["u"] + step_c * hres["u"],
                "w": state["w"] + step_c * res,
                "prim": state["prim"] + step_c * hres["prim"],
                "res0": res}
        hcomb = linmap(comb)
        fq = _ls_quadratics(sp, base, hcomb["u"])
        return tau_search_apply(base, comb, hcomb["prim"],
                                {"x": hcomb["x"], "u": hcomb["u"]}, fq,
                                value_ref, dval)

    # ---------------- iteration ----------------
    def one_iteration(sp, carry, it):
        w = carry["w"]
        sol = solve(sp, w)
        prim = sol["prim"]
        box, diff, dd = diff_dots(prim, w)
        shr, value_g = shrink_scalars(dd)
        res = res_slabs(prim, box, diff, shr)
        del box, diff
        if is_fbe:
            yvec = torch.add(-res, linmap(-res)["prim"], alpha=step_c)
        else:
            yvec = -res
        if it == 0:            # no quasi-Newton step: the plain dual step
            y_new = torch.add(w, res, alpha=step_c)
            new_carry = dict(carry, y=y_new, y_prev=carry["y"],
                             yvec_prev=yvec, w=y_new, x=sol["x"],
                             u=sol["u"], v=sol["v"])
            return new_carry, (champion(res), zero, zero)
        wr, rr, fe = red(key_sums(w * res), key_sums(res * res),
                         smooth_econ(sp, sol["u"]))
        value = wr.sum() + 0.5 * step_c * rr.sum() + value_g + fe
        lb, coef, (gs_vec, gy_vec, gg) = lbfgs_update_and_direction(
            carry["lbfgs"], carry["y"], carry["y_prev"], yvec,
            carry["yvec_prev"])
        cs, cy, cg = coef
        # dval = <grad, dir> (FBE), -<res, dir> (NAMA): free in the span
        dval = torch.sum(cs * gs_vec) + torch.sum(cy * gy_vec) + cg * gg
        lbfgs_dir = direction(lb, coef, yvec, 0.0 if is_fbe else step_c)
        base = {"x": sol["x"], "u": sol["u"], "w": w, "prim": prim,
                "res0": res}
        if is_fbe:
            x, u, y_new, infeas, tau = fbe_line_search(sp, base, lbfgs_dir,
                                                       value, dval)
        else:
            x, u, y_new, infeas, tau = ame_line_search(sp, base, lbfgs_dir,
                                                       res, value, dval)
        new_carry = {"y": y_new, "y_prev": carry["y"], "yvec_prev": yvec,
                     "w": y_new, "lbfgs": lb, "x": x, "u": u, "v": sol["v"]}
        return new_carry, (infeas, value, tau)

    def init_carry(y0):
        zeros = torch.zeros(N, ns, D, dtype=f32, device=dev)
        y0 = zeros if y0 is None else y0
        gram = torch.zeros(n_cols, n_cols, dtype=f32, device=dev)
        lb0 = {"mat_s": torch.zeros(n_cols, N, ns, D, dtype=nb, device=dev),
               "mat_y": torch.zeros(n_cols, N, ns, D, dtype=nb, device=dev),
               "rho": torch.zeros(n_cols, dtype=f32, device=dev),
               "col": torch.zeros((), dtype=torch.int64, device=dev),
               "mem": torch.zeros((), dtype=torch.int64, device=dev),
               "skips": torch.zeros((), dtype=torch.int32, device=dev),
               "hessian": one.clone(), "Gss": gram, "Gsy": gram.clone(),
               "Gyy": gram.clone()}
        return {"y": y0, "y_prev": y0, "yvec_prev": zeros, "w": y0,
                "lbfgs": lb0}

    def run(step, y0=None):
        if mesh is not None:
            step = SS.shard_step(kc, step)
            if y0 is not None:
                y0 = {k: mesh.shard(y0[k]) for k in ("xi", "psi")}
        for k, shp in (("beta", (N, ns, nv)), ("uhat", (N, ns, nu)),
                       ("e", (N, ns, nx)), ("alpha_price", (N, ns, nu)),
                       ("x0", (nx,)), ("prev_u", (nu,)),
                       ("prev_uhat", (nu,))):
            S._check(k, step[k], shp, dev)
        sp = {"beta": step["beta"], "uhat": step["uhat"], "e": step["e"],
              "alpha": step["alpha_price"], "x0": step["x0"],
              "prev_u": step["prev_u"],
              "pdu": (step["prev_u"] - step["prev_uhat"]).contiguous()}
        if y0 is not None:
            S._check("y0.xi", y0["xi"], (N, ns, 2 * nx), dev)
            S._check("y0.psi", y0["psi"], (N, ns, nu), dev)
            y0 = torch.cat([y0["xi"], y0["psi"]], dim=-1)
        carry = init_carry(y0)
        K = int(max_iterations)
        traces = torch.zeros(3, K, dtype=f32, device=dev)
        if mesh is not None:
            return sharded(sp, carry, traces)
        eager = K if dev.type != "cuda" else 1
        for it in range(eager):
            carry, rec = one_iteration(sp, carry, it)
            traces[:, it] = torch.stack(rec)
        if eager < K:
            carry = replayed(sp, carry, traces, eager)
        y = carry["y"]
        return {"control": torch.clamp(carry["u"][0, 0], lo_b, hi_b),
                "x": carry["x"], "u": carry["u"],
                "v": carry["v"],
                "y": {"xi": y[..., :2 * nx].contiguous(),
                      "psi": y[..., 2 * nx:].contiguous()},
                "primal_infeasibility": traces[0], "value_fbe": traces[1],
                "tau": traces[2],
                "iterations": torch.full((), K, dtype=torch.int32,
                                         device=dev)}

    def sharded(sp, carry, traces):
        """Every iteration on the rank's block, eagerly; the champions
        reduced once; the outputs gathered to the global layout."""
        K = int(max_iterations)
        cparts = torch.empty(K, 4, dtype=f32, device=dev)
        for it in range(K):
            carry, rec = one_iteration(sp, carry, it)
            cparts[it] = rec[0]
            traces[1:, it] = torch.stack(rec[1:])
        traces[0] = SS.champions(mesh.pmax(cparts))
        y = carry["y"]
        return {"control": SS.root_control(kc, carry["u"], mesh),
                "x": mesh.all_gather(carry["x"]),
                "u": mesh.all_gather(carry["u"]),
                "v": mesh.all_gather(carry["v"]),
                "y": {"xi": mesh.all_gather(y[..., :2 * nx]),
                      "psi": mesh.all_gather(y[..., 2 * nx:])},
                "primal_infeasibility": traces[0], "value_fbe": traces[1],
                "tau": traces[2],
                "iterations": torch.full((), K, dtype=torch.int32,
                                         device=dev)}

    side_stream = []

    def replayed(sp, carry, traces, start):
        """Iterations ``start`` .. K-1 on a CUDA device: iteration
        ``start`` runs as is on a side stream (it warms that stream up:
        the products' workspace), the next is captured as a CUDA graph
        that updates the carry in place, and the graph is replayed for
        the rest, so the host enqueues an iteration with one call.  The
        wrappers count the captured iteration's passes once.  Returns the
        carry, copied back to the current stream."""
        K = int(max_iterations)
        cur = torch.cuda.current_stream(dev)
        if not side_stream:       # one per solver: the products keep a
            side_stream.append(torch.cuda.Stream(dev))   # workspace each
        side = side_stream[0]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            carry, rec = one_iteration(sp, carry, start)
            traces[:, start] = torch.stack(rec)
            if start + 1 < K:
                lb = carry["lbfgs"]
                ctr = torch.full((1,), start + 1, dtype=torch.int64,
                                 device=dev)
                # capture_begin, not torch.cuda.graph, which synchronises
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(capture_error_mode="relaxed")
                try:
                    new, rec = one_iteration(sp, carry, start + 1)
                    # y_prev takes y before y takes the new dual (the
                    # carry's w is y itself)
                    carry["y_prev"].copy_(carry["y"])
                    carry["y"].copy_(new["y"])
                    for k in ("yvec_prev", "x", "u", "v"):
                        carry[k].copy_(new[k])
                    for k in ("rho", "col", "mem", "skips", "hessian",
                              "Gss", "Gsy", "Gyy"):
                        lb[k].copy_(new["lbfgs"][k])
                    traces.index_copy_(1, ctr, torch.stack(rec)[:, None])
                    ctr.add_(1)
                finally:
                    graph.capture_end()
                del new, rec
                for _ in range(start + 1, K):
                    graph.replay()
                del graph
        cur.wait_stream(side)
        return {k: carry[k].clone() for k in ("x", "u", "v", "y")}

    run.consts = kc
    return run
