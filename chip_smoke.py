#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--reference-kernel PATH]

Run from the root of the repository on a machine with a CUDA GPU.  It
imports only ``rapidnet_tpu_torch``, torch and numpy, and in order:

1. builds the kernels from ``rapidnet_tpu_torch/csrc`` with nvcc;
2. builds the Barcelona-scale problem (nx=63 tanks, nu=114 actuators,
   nd=88 demands, ne=17 junctions, horizon 24, branching [5, 5]: 556
   nodes, 25 scenarios; seeds 42; auto-tuned; 500 APG iterations);
3. holds the whole-solve kernel to its plain PyTorch version on one
   step's solve (control, u, x and the infeasibility trace within
   1e-3 * max(|plain|, 1)), and checks that a tolerance solve stops at
   the same iteration on both.  From a state above the tank bounds it
   compares them directly over 50 iterations, and over the full 500
   against a float64 witness (the plain version in float64);
4. runs a 4-step closed loop through ``SmpcController(device="cuda")``
   and checks that every solve launched the kernel, that the controls
   and KPIs are finite and that they agree with the plain backend;
5. times the kernel and the plain version (median of 7 solves each,
   inputs staged on the device, synchronised around each solve).

Then the batched kernel, at B = 32 instances whose states are
x0 * (1 + 0.02 N(0, 1)) (numpy seed 7, as bench.py:133-136):

6a. holds every instance of a batched call, in the shared-forecast form
    (uhat and e read by every instance) and in the stacked form, to the
    single-solve kernel on that instance's step: control, u, x, y and
    the trace within 1e-6 * max(|single|, 1), and says whether they are
    equal bit for bit, as they should be;
6b. holds all 32 instances to the plain batched version at 500
    iterations (1e-3 bound, as phase 3), and checks that under a
    tolerance every instance of a batched call stops at the plain
    version's iteration for it;
6c. holds the batched entry at B = 1 to the single solve, bit for bit;
    with ``--reference-kernel PATH`` (an earlier ``apg_solve.cu``) also
    the single solve to that source's kernel;
7.  runs 3-step batched closed loops through
    ``BatchedSmpcController(device="cuda")`` with a shared forecaster,
    cold and warm-started: one kernel call per step, finite controls and
    KPIs, and instance 0's controls agree with a single-instance
    ``SmpcController(device="cuda")`` from the same state;
8.  times it: batch-32 solves/s (median of 5 batched 500-iteration
    solves), the pipelined rate (4 batched solves enqueued back to back,
    one synchronise, median of 3 rounds), the plain batched version
    (median of 3), and the batched solve's peak device memory.

Then the whole-solve FBE/NAMA kernel (``csrc/qn_solve.cu``), for each of
the two algorithms, at the same problem with an L-BFGS buffer of 5
(bench.py:179-206):

9a. short-horizon parity: the kernel and its plain version over the
    first QN_TRACK_MAX iterations.  TRACK, printed, is the largest
    number of leading iterations over which tau, the FBE value and the
    infeasibility stay within the JAX package's bounds between two
    implementations (tests/test_pallas_qn.py:59-70) and after which the
    control stays within rtol 1e-3 / atol 1e-4 and u within 2e-3 *
    max(|u|, 1), the JAX package's bounds on its synthetic and its
    full-size problem (:85-87, :131-138); it must be at least the
    buffer size plus QN_TRACK_SPARE, so that the kernel's L-BFGS ring
    has wrapped (col = 1 + col % size, the two-loop's visits to the zero
    column) within the iterations held to the plain version.  Over TRACK
    the kernel's counts of line-search trials and of rejected curvature
    pairs equal the plain version's, and more pairs were accepted than
    the buffer holds.  Whether u also holds the synthetic problem's rtol
    1e-3 / atol 1e-3 is printed.
    (The line search branches on value comparisons, so two float32
    solves part after a while.)
9b. 500 iterations: the kernel's median |infeasibility| over the last 20
    iterations within 10 times the plain version's, the control within
    the physical bounds, and two calls equal bit for bit; printed beside
    them, the plain version's residual magnitudes;
9c. the tolerance exit, from tanks at 10 % of their maximum: of the
    tolerances that, by the plain version's residual magnitudes, stop it
    at an iteration past the first over which the traces agree and
    after which the solutions do (as 9a), the one farthest from the
    edges of its exit; the kernel stops at the same iteration, its
    control agrees (as 9a) and its traces are zero past the exit.  (From
    the nominal state the magnitude first falls below its first value
    only where the two float32 solves have parted: 9b prints where, and
    where the two stop under the tolerance the plain version's
    magnitudes suggest there, without gating on it.);
10. 4-step closed loops through ``SmpcController(backend="cuda")``, cold
    and warm-started: one kernel launch per step, finite controls and
    KPIs, the KPIs beside the APG loop's of phase 4 (recorded, not
    gated) and the mean ms per step;
11. timing: the median wall ms of 7 kernel solves (inputs staged,
    synchronised around each; the plain version's time is 9b's), the
    host's enqueue ms, the launches per iteration and the bound (its
    line-search trials as the kernel counted them).

Each phase prints its own line.  The last lines are the card's name and
power limit, one JSON line describing each kernel (with its bound: the
larger of its FP32 operations over 67 TFLOP/s and its bytes, each input
read once and each output written once, over 3.35 TB/s), and the result
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
the result line, as does a machine without a CUDA GPU.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPEATS = 7
MAX_ITER = 500
STRESS_ITER = 50
TOL_FACTOR = 1e-3     # the JAX package's bound between two
                      # implementations of this solve
                      # (__graft_entry__.py:108-110)
WITNESS_FACTOR = 4.0  # the kernel may stray from the float64 witness
                      # at most this many times as far as the plain
                      # float32 version does: two float32 solves that
                      # sum in another order drift alike
BATCH = 32            # bench.py:32
SAME_FACTOR = 1e-6    # batched against single kernel: the same code on
                      # the same inputs, expected equal bit for bit
BATCH_REPEATS = 5     # bench.py:138-147
PIPELINE_DEPTH, PIPELINE_ROUNDS = 4, 3     # bench.py:161-171
FP32_FLOPS = 67e12    # H100 SXM, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
KERNELS = ("apg_solve", "qn_solve")     # the sources under csrc/
QN_ALGORITHMS = {"fbe": "globalFbeAlgorithm", "nama": "namaAlgorithm"}
QN_TRACK_MAX = 30     # the short budget of phases 9a and 9c
LOW_FILL = 0.1        # phase 9c's tanks, as a share of their maximum
QN_TRACK_SPARE = 3    # TRACK >= buffer size + 3: iterations 1 .. size + 2
                      # each offer a curvature pair, and the ring wraps at
                      # the (size + 1)-th accepted one, a rejection to spare
QN_TRACES = ("tau", "value_fbe", "primal_infeasibility")
QN_U_FACTOR = 2e-3    # u within 2e-3 * max(|u|, 1): the JAX package's bound
                      # on its full-size problem (tests/test_pallas_qn.py:131)
QN_LOOP_STEPS = 4
KPI_KEYS = ("economicKpi", "smoothKpi", "safetyKpi", "networkKpi")


class SmokeFailure(Exception):
    pass


def check_close(name, got, ref):
    """|got - ref|_max <= 1e-3 * max(|ref|_max, 1); returns the error."""
    import torch
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    if got.shape != ref.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise SmokeFailure(f"{name}: non-finite values")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    bound = TOL_FACTOR * max(float(ref.abs().max()) if ref.numel() else 0.0,
                             1.0)
    print(f"[compare] {name:22s} max_abs_err {err:.6g}  bound {bound:.6g}")
    if not err <= bound:
        raise SmokeFailure(f"{name}: kernel and plain version disagree "
                           f"({err:.6g} > {bound:.6g})")
    return err


def witness_check(name, kern, plain, wit):
    """The kernel's distance from a float64 witness against the plain
    float32 version's: kernel <= max(WITNESS_FACTOR * plain,
    1e-3 * max(|witness|, 1)).  Returns both distances."""
    import torch
    kern, plain, wit = (t.detach().double().cpu() for t in (kern, plain, wit))
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise SmokeFailure(f"{name}: non-finite values")
    e_k = float((kern - wit).abs().max())
    e_p = float((plain - wit).abs().max())
    scale = float(wit.abs().max())
    bound = max(WITNESS_FACTOR * e_p, TOL_FACTOR * max(scale, 1.0))
    print(f"[witness] {name:22s} kernel-f64 {e_k:.6g}  plain32-f64 "
          f"{e_p:.6g}  bound {bound:.6g}  max|f64| {scale:.6g}")
    if not e_k <= bound:
        raise SmokeFailure(f"{name}: kernel strays from the float64 "
                           f"witness ({e_k:.6g} > {bound:.6g})")
    return e_k, e_p


def compare_instances(name, got, refs):
    """Instance b of the batched outputs ``got`` against ``refs[b]``, on
    control, u, x, y and the trace: max |error| within SAME_FACTOR *
    max(|ref|, 1).  Returns (max error, whether all were bit-equal)."""
    import torch
    keys = ("control", "u", "x", "primal_infeasibility", "y.xi", "y.psi")

    def leaf(out, k):
        return out["y"][k[2:]] if k.startswith("y.") else out[k]

    worst, equal = 0.0, True
    for k in keys:
        err, scale = 0.0, 0.0
        for b, ref in enumerate(refs):
            g, r = leaf(got, k)[b], leaf(ref, k)
            if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
                raise SmokeFailure(f"{name}.{k}[{b}]: non-finite values")
            equal &= bool(torch.equal(g, r))
            err = max(err, float((g.double() - r.double()).abs().max()))
            scale = max(scale, float(r.abs().max()))
        bound = SAME_FACTOR * max(scale, 1.0)
        print(f"[batch] {name}.{k:22s} max_abs_err {err:.6g} over "
              f"{len(refs)} instances  bound {bound:.6g}")
        if not err <= bound:
            raise SmokeFailure(f"{name}.{k}: batched and single kernel "
                               f"disagree ({err:.6g} > {bound:.6g})")
        worst = max(worst, err)
    for b, ref in enumerate(refs):
        if int(got["iterations"][b]) != int(ref["iterations"]):
            raise SmokeFailure(f"{name}: instance {b} iterations differ")
    return worst, equal


def solve_bound(kc, tensors, outputs, iterations, prefix_stages):
    """The least time (ms) the card could take for a solve and what
    sets it: the FP32 operations of its five products per row and the
    prefix aggregations, over 67 TFLOP/s, against the bytes of its
    inputs (each distinct buffer once, a batch-stride-0 view once) and
    outputs over 3.35 TB/s.  Elementwise work (~5% of the operations)
    is left out.  Returns (bound_ms, bound_by, flops, bytes)."""
    fa = kc["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    per_row = 2 * (nu * nv + nx * nv + nv * nv + nv * nu + nu * nx)
    n_agg = sum(1 for s in prefix_stages if s > 0)
    B = outputs["u"].shape[0] if outputs["u"].dim() == 4 else 1
    flops = iterations * B * (N * ns * per_row +
                              2 * n_agg * ns * ns * (nx + nv))
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    nbytes = sum(storages.values()) + sum(
        t.numel() * t.element_size() for t in
        (outputs["x"], outputs["u"], outputs["y"]["xi"],
         outputs["y"]["psi"], outputs["primal_infeasibility"],
         outputs["iterations"], outputs["control"]))
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def within(got, ref, rtol, atol):
    """Whether |got - ref| <= atol + rtol |ref| everywhere."""
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


def check_allclose(name, got, ref, rtol, atol):
    """Elementwise |got - ref| <= atol + rtol |ref|; returns max |error|."""
    import torch
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    if got.shape != ref.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise SmokeFailure(f"{name}: non-finite values")
    diff = (got - ref).abs()
    err = float(diff.max()) if got.numel() else 0.0
    worst = float((diff - rtol * ref.abs()).max()) if got.numel() else 0.0
    print(f"[compare] {name:22s} max_abs_err {err:.6g}  (rtol {rtol:g}, "
          f"atol {atol:g}: worst excess {worst - atol:.6g})")
    if not worst <= atol:
        raise SmokeFailure(f"{name}: kernel and plain version disagree")
    return err


def qn_horizon(kern, plain, n):
    """The number of leading iterations over which the kernel's traces
    stay within the JAX package's bounds of the plain version's (tau
    rtol 1e-4 / atol 1e-6, value 2e-3 / 2e-4 max(|value|, 1),
    infeasibility 2e-3 / 1e-4; tests/test_pallas_qn.py:59-70)."""
    k = {key: kern[key].double().cpu().numpy() for key in QN_TRACES}
    p = {key: plain[key].double().cpu().numpy() for key in QN_TRACES}
    vscale = max(float(abs(p["value_fbe"][:n]).max()), 1.0)
    bounds = {"tau": (1e-4, 1e-6), "value_fbe": (2e-3, 2e-4 * vscale),
              "primal_infeasibility": (2e-3, 1e-4)}
    h = 0
    while h < n and all(abs(k[key][h] - p[key][h]) <= atol +
                        rtol * abs(p[key][h])
                        for key, (rtol, atol) in bounds.items()):
        h += 1
    return h


def solutions_agree(kern, plain):
    """Whether the kernel's control is within rtol 1e-3 / atol 1e-4 of
    the plain version's and its u within QN_U_FACTOR * max(|u|, 1).
    Returns (agree, u's atol)."""
    u_atol = QN_U_FACTOR * max(float(plain["u"].abs().max()), 1.0)
    return (within(kern["control"], plain["control"], 1e-3, 1e-4) and
            within(kern["u"], plain["u"], 0.0, u_atol)), u_atol


def qn_solve_bound(kq, step, out, algorithm, prefix_stages):
    """The least time (ms) the card could take for one FBE/NAMA solve and
    what sets it.  Operations: the products of the tree sweeps (one at
    the first iteration, two for FBE; three at every later one) and of
    the FBE values' smoothing cost du W' (the one before the search and
    one per line-search trial that ran, as the kernel counts them), over
    67 TFLOP/s; elementwise work and the L-BFGS dots are left out.
    Bytes: the inputs read once and the outputs written once, over 3.35
    TB/s.  Returns (bound_ms, bound_by, flops, bytes, trials)."""
    from rapidnet_tpu_torch.ops import qn_solve as Q
    fa = kq["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    per_row = 2 * (nu * nv + nx * nv + nv * nv + nv * nu + nu * nx)
    n_agg = sum(1 for s in prefix_stages if s > 0)
    sweep = N * ns * per_row + 2 * n_agg * ns * ns * (nx + nv)
    value = N * ns * 2 * nu * nu
    iters = int(out["iterations"])
    trials = int(out["line_search_trials"])
    first = 2 if algorithm == QN_ALGORITHMS["fbe"] else 1
    flops = (first * sweep + (iters - 1) * (3 * sweep + value) +
             trials * value) if iters else 0
    tensors = ([fa[k] for k in Q.ROW_KEYS] + [kq[k] for k in Q.MATRIX_KEYS]
               + [step[k] for k in ("beta", "uhat", "e", "alpha_price",
                                    "x0", "prev_u", "prev_uhat")])
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + sum(
        t.numel() * t.element_size() for t in
        (out["x"], out["u"], out["y"]["xi"], out["y"]["psi"],
         out["primal_infeasibility"], out["value_fbe"], out["tau"],
         out["iterations"], out["line_search_trials"], out["control"]))
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes,
            trials)


def qn_phases(cfg, net, tree, fa, make_step, hyper, prefix, apg_kpis):
    """Phases 9a-11 for FBE and NAMA; returns their JSON entries."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import qn_solve as Q
    from rapidnet_tpu_torch.solver import quasi_newton as qn_mod
    from rapidnet_tpu_torch.solver.controller import SmpcController

    kq = Q.kernel_constants(fa, prefix_stages=prefix)
    bs = int(cfg.lbfgs_buffer_size)
    track_min = bs + QN_TRACK_SPARE
    step = make_step(cfg.current_x)
    lo, hi = fa["umin_phys"], fa["umax_phys"]
    entries = []
    for short, algorithm in QN_ALGORITHMS.items():
        qkw = dict(hyper, algorithm=algorithm, lbfgs_buffer_size=bs)

        def kern(n=MAX_ITER, step=step, **kw):
            return Q.qn_solve(kq, step, None, **dict(qkw, max_iterations=n,
                                                     **kw))

        def plain(n=MAX_ITER, step=step, **kw):
            return Q.qn_solve_plain(kq, step, None,
                                    **dict(qkw, max_iterations=n, **kw))

        # 9a. short-horizon parity.  TRACK: the most leading iterations
        # over which the traces agree and after which control and u do
        k_s, p_s = kern(QN_TRACK_MAX), plain(QN_TRACK_MAX)
        traced = qn_horizon(k_s, p_s, QN_TRACK_MAX)
        shown = min(traced + 2, QN_TRACK_MAX)     # to where they part
        for key in QN_TRACES:
            for name, out in (("kernel", k_s), ("plain ", p_s)):
                vals = np.array2string(out[key][:shown].cpu().numpy(),
                                       precision=7, max_line_width=400)
                print(f"[qn] 9a.{short}.{key:20s} {name} {vals}")
        track = traced
        while track >= track_min:
            k_t, p_t = kern(track), plain(track)
            agree, u_atol = solutions_agree(k_t, p_t)
            if agree:
                break
            track -= 1
        print(f"[qn] 9a.{short}: TRACK {track} (the traces agree within the "
              f"JAX bounds over the first {traced} of {QN_TRACK_MAX} "
              f"iterations, control and u after the first {track})")
        if track < track_min:
            raise SmokeFailure(f"{short}: the kernel tracks the plain "
                               f"version over {track} iterations, fewer "
                               f"than {track_min}")
        trials = (int(k_t["line_search_trials"]),
                  int(p_t["line_search_trials"]))
        skips = (int(k_t["lbfgs_skips"]), int(p_t["lbfgs_skips"]))
        print(f"[qn] 9a.{short}: over the first {track} iterations, "
              f"line-search trials: kernel {trials[0]}, plain {trials[1]}; "
              f"rejected curvature pairs: kernel {skips[0]}, plain "
              f"{skips[1]}")
        if trials[0] != trials[1] or skips[0] != skips[1]:
            raise SmokeFailure(f"{short}: the kernel's counts of trials and "
                               f"rejected pairs differ from the plain "
                               f"version's")
        if not track - 1 - skips[1] > bs:
            raise SmokeFailure(f"{short}: the L-BFGS ring did not wrap "
                               f"within the {track} iterations held")
        check_allclose(f"9a.{short}.control", k_t["control"],
                       p_t["control"], 1e-3, 1e-4)
        err_u = check_allclose(f"9a.{short}.u", k_t["u"], p_t["u"], 0.0,
                               u_atol)
        print(f"[qn] 9a.{short}.u within the synthetic problem's bound "
              f"(rtol 1e-3, atol 1e-3): "
              f"{within(k_t['u'], p_t['u'], 1e-3, 1e-3)}")

        # 9b. 500 iterations: quality, bounds, determinism
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_full = qn_mod.make_solver(prefix_stages=prefix,
                                    trace_magnitude=True, **qkw)(fa, step)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        k_full, again = kern(), kern()
        same = all(torch.equal(again[k], k_full[k]) for k in
                   ("x", "u", "iterations", "line_search_trials",
                    "lbfgs_skips") +
                   QN_TRACES) and all(
            torch.equal(again["y"][k], k_full["y"][k]) for k in ("xi", "psi"))
        tail_k = float(np.median(
            k_full["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        tail_p = float(np.median(
            p_full["primal_infeasibility"].abs().cpu().numpy()[-20:]))
        u0 = k_full["control"]
        inside = bool(((u0 >= lo - 1e-5) & (u0 <= hi + 1e-5)).all())
        print(f"[qn] 9b.{short}: {MAX_ITER} iterations, median "
              f"|infeasibility| of the last 20: kernel {tail_k:.6g}, plain "
              f"{tail_p:.6g}; control within the physical bounds: {inside};"
              f" two calls equal bit for bit: {same}; plain solve "
              f"{plain_ms:.3f} ms")
        if not (int(k_full["iterations"]) == MAX_ITER and
                bool(torch.isfinite(k_full["u"]).all())):
            raise SmokeFailure(f"{short}: the 500-iteration solve failed")
        if not tail_k < 10 * max(tail_p, 1e-6):
            raise SmokeFailure(f"{short}: residual tail {tail_k:.6g} above "
                               f"10 x the plain version's {tail_p:.6g}")
        if not inside:
            raise SmokeFailure(f"{short}: control outside the bounds")
        if not same:
            raise SmokeFailure(f"{short}: the kernel does not repeat itself")
        # where a tolerance could stop a solve from this state (recorded,
        # not gated: past TRACK the two solves part)
        mags = p_full["residual_magnitude"].cpu().numpy()
        below = np.flatnonzero(mags[1:] < mags[0])
        print(f"[qn] 9b.{short}: residual magnitude of the first 3 "
              f"iterations {np.array2string(mags[:3], precision=6)}; "
              f"first below the first at iteration "
              f"{int(below[0]) + 2 if below.size else None}")
        nominal = qn_mod.exit_tolerances(mags, MAX_ITER - 1)
        if nominal:
            tol_n, it_n, _ = nominal[0]
            it_kn = int(kern(tolerance=tol_n)["iterations"])
            print(f"[qn] 9b.{short}: tol {tol_n:.6g} stops the plain version"
                  f" at {it_n}, the kernel at {it_kn}")

        # 9c. the tolerance exit.  The residual magnitude of these solves
        # rises after the first iteration and, from the nominal state,
        # first falls below its first value where the two float32 solves
        # have parted (9b prints where); from nearly empty tanks it falls
        # within the iterations over which they track
        step_low = make_step((LOW_FILL * net.xmax).astype(np.float32))
        k_low = kern(QN_TRACK_MAX, step=step_low)
        p_low = qn_mod.make_solver(
            prefix_stages=prefix, trace_magnitude=True,
            **dict(qkw, max_iterations=QN_TRACK_MAX))(fa, step_low)
        traced_low = qn_horizon(k_low, p_low, QN_TRACK_MAX)
        # the widest-ranged exit within the traces' horizon after which
        # control and u agree too (as 9a's TRACK)
        for tol, it_want, ratio in qn_mod.exit_tolerances(
                p_low["residual_magnitude"].cpu().numpy(), traced_low):
            if solutions_agree(kern(it_want, step=step_low),
                               plain(it_want, step=step_low))[0]:
                break
        else:
            raise SmokeFailure(f"{short}: no tolerance stops the plain "
                               f"version within {traced_low} iterations "
                               "where the solutions agree")
        p_tol = plain(step=step_low, tolerance=tol)
        k_tol = kern(step=step_low, tolerance=tol)
        it_p, it_k = int(p_tol["iterations"]), int(k_tol["iterations"])
        print(f"[qn] 9c.{short}: tanks at {LOW_FILL:g} of their maximum: "
              f"traces agree over {traced_low}; tol {tol:.6g} (exit "
              f"{it_want}, its "
              f"range of tolerances spans a factor {ratio:.4g}): plain "
              f"stops at {it_p}, kernel at {it_k} of {MAX_ITER}")
        if not it_p == it_k == it_want:
            raise SmokeFailure(f"{short}: tolerance exits differ")
        check_allclose(f"9c.{short}.control", k_tol["control"],
                       p_tol["control"], 1e-3, 1e-4)
        for key in QN_TRACES:
            if bool((k_tol[key][it_k:] != 0).any()):
                raise SmokeFailure(f"{short}: {key} not zero past the exit")

        # 10. the closed loops (the main path), cold and warm-started
        loop_launches = 0
        for warm in (False, True):
            c = copy.deepcopy(cfg)
            c.algorithm = algorithm
            fc = synthetic_forecaster(N=24, nd=net.nd, nu=net.nu,
                                      sim_horizon=4, seed=42)
            ctrl = SmpcController(c, network=net, tree=tree, forecaster=fc,
                                  backend="cuda", device="cuda",
                                  warm_start=warm)
            ctrl.initialise()
            K.apg_solve.launches = K.apg_solve_batch.launches = 0
            Q.qn_solve.launches = 0
            t0 = time.perf_counter()
            log = ctrl.closed_loop(QN_LOOP_STEPS)
            loop_ms = (time.perf_counter() - t0) * 1e3 / QN_LOOP_STEPS
            n = Q.qn_solve.launches
            label = "warm" if warm else "cold"
            ms = [log[f"time{t}"][0] for t in range(QN_LOOP_STEPS)]
            print(f"[qn] 10.{short}.{label}: {QN_LOOP_STEPS} steps, kernel "
                  f"launches {n}, solve ms per step "
                  f"{', '.join(f'{m:.3f}' for m in ms)}; whole step "
                  f"{loop_ms:.3f} ms")
            if n != QN_LOOP_STEPS or K.apg_solve.launches or \
                    K.apg_solve_batch.launches:
                raise SmokeFailure(f"{short}: {n} kernel launches for "
                                   f"{QN_LOOP_STEPS} solves")
            loop_launches += n
            kpis = {k: log[k] for k in KPI_KEYS}
            controls = np.array([log[f"control{t}"]
                                 for t in range(QN_LOOP_STEPS)])
            if not (np.isfinite(controls).all() and
                    np.isfinite(list(kpis.values())).all()):
                raise SmokeFailure(f"{short}: non-finite controls or KPIs")
            if "memoryLeakWarning" in log:
                raise SmokeFailure(log["memoryLeakWarning"])
            print(f"[qn] 10.{short}.{label} kpis {json.dumps(kpis)}")
            rel = {k: (v - apg_kpis[k]) / max(abs(apg_kpis[k]), 1e-30)
                   for k, v in kpis.items()}
            print(f"[qn] 10.{short}.{label} kpis relative to the APG loop "
                  f"of phase 4 {json.dumps(rel)}")

        # 11. timing, inputs staged on the device
        rng = np.random.default_rng(7)
        x0 = cfg.current_x
        staged = [make_step(x0 * (1.0 + 0.02 * rng.standard_normal(
            x0.shape)).astype(np.float32)) for _ in range(REPEATS)]
        times, enqueue = [], []
        for st in staged:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = kern(step=st)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            enqueue.append((t1 - t0) * 1e3)
            if not bool(torch.isfinite(out["control"]).all()):
                raise SmokeFailure(f"{short}: non-finite control")
        med = float(np.median(times))
        per_it = Q.launches_per_iteration(algorithm, bs, kq["fp"])
        bound = qn_solve_bound(kq, step, k_full, algorithm, prefix)
        print(f"[timing] {short} kernel {MAX_ITER}-iteration solve: median "
              f"{med:.3f} ms of {REPEATS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); host enqueue "
              f"{', '.join(f'{t:.3f}' for t in enqueue)} ms; "
              f"{per_it} launches per iteration after the first; plain "
              f"{plain_ms:.3f} ms")
        print(f"[bound] {short}: {bound[2] / 1e9:.3f} GFLOP, "
              f"{bound[3] / 1e6:.3f} MB: {bound[0]:.6f} ms, set by "
              f"{bound[1]}; {bound[4]} line-search trials in "
              f"{MAX_ITER - 1} searches (the kernel's count)")
        entries.append(
            {"name": f"qn_solve_{short}", "route": "cuda",
             "source": "rapidnet_tpu_torch/csrc/qn_solve.cu",
             "replaces": "rapidnet_tpu/ops/pallas_qn.py:94",
             "launches": loop_launches, "max_abs_err": err_u, "ms": med,
             "plain_ms": plain_ms, "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": None})
    return entries


def solve_inputs(kc, step):
    """Every tensor a solve reads: the constants and the step."""
    from rapidnet_tpu_torch.ops import apg_solve as K
    return ([kc["fa"][k] for k in K.ROW_KEYS] +
            [kc[k] for k in K.MATRIX_KEYS] +
            [step[k] for k in ("beta", "uhat", "e", "x0", "prev_u",
                               "prev_uhat")])


def as_f64(d):
    """A copy of a dict of tensors (nested dicts too) in float64."""
    return {k: as_f64(v) if isinstance(v, dict) else v.double()
            for k, v in d.items()}


def build_problem(device):
    """The port's copy of bench.py:42-65 (Barcelona-scale synthetic)."""
    import numpy as np
    from rapidnet_tpu_torch.convert import (factor_arrays, factor_tensors,
                                            shared_step_tensors,
                                            stacked_step_tensors, step_arrays,
                                            step_tensors)
    from rapidnet_tpu_torch.model.config import synthetic_config
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.model.network import synthetic_network
    from rapidnet_tpu_torch.model.scenario_tree import generate_tree
    from rapidnet_tpu_torch.solver.apg import expand_shared_step
    from rapidnet_tpu_torch.solver.tuning import auto_tune

    nx, nu, nd, ne = 63, 114, 88, 17
    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=42)
    tree = generate_tree(N=24, branching=[5, 5], nd=nd, nu=nu, seed=42)
    fc = synthetic_forecaster(N=24, nd=nd, nu=nu, sim_horizon=4, seed=42)
    cfg0 = synthetic_config(net, tree, max_iterations=MAX_ITER)
    cfg, eng = auto_tune(net, tree, cfg0, device=device)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = factor_tensors(factor_arrays(eng), device)

    def make_step(x0):
        return step_tensors(step_arrays(eng.prepare_step(
            fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
            cfg.prev_demand)), device)

    def make_batch(x0s, shared=True):
        """B instances from states x0s: assembled on the device from the
        shared base (uhat and e with batch stride 0), or stacked from B
        single steps."""
        B = len(x0s)
        if not shared:
            return stacked_step_tensors([step_arrays(eng.prepare_step(
                fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
                cfg.prev_demand)) for x0 in x0s], device)
        base, inst = shared_step_tensors(*eng.prepare_step_shared(
            fc.nominal_demand, fc.nominal_prices, x0s,
            np.tile(cfg.prev_u, (B, 1)), np.tile(cfg.prev_demand, (B, 1))),
            device)
        return expand_shared_step(base, **inst)

    return cfg, eng, net, tree, fa, make_step, make_batch


def apg_phases(args, device, cfg, net, tree, fa, make_step, make_batch,
               prefix, hyper, kc):
    """Phases 3-8, the APG kernel single and batched; returns their JSON
    entries and the KPIs of phase 4's closed loop."""
    import numpy as np
    import torch
    from rapidnet_tpu_torch.model.forecaster import synthetic_forecaster
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import build
    from rapidnet_tpu_torch.solver.batch import BatchedSmpcController
    from rapidnet_tpu_torch.solver.controller import SmpcController

    # 3. kernel against its plain version on one step's solve.  Then a
    # state above the tank bounds, which makes the state-box and safety
    # penalties active, over STRESS_ITER iterations: past ~100 such
    # iterations float32 rounding compounds past the direct bound, so
    # the full budget there is held to a float64 witness instead.
    errs = {}
    x_hot = (1.2 * net.xmax).astype(np.float32)
    for label, x0, n_it in (("", cfg.current_x, MAX_ITER),
                            ("stressed.", x_hot, STRESS_ITER)):
        step = make_step(x0)
        kc_n = K.kernel_constants(fa, prefix_stages=prefix,
                                  max_iterations=n_it)
        hyper_n = dict(hyper, max_iterations=n_it)
        plain = K.apg_solve_plain(kc_n, step, None, **hyper_n)
        kern = K.apg_solve(kc_n, step, None, **hyper_n)
        for k in ("control", "u", "x", "primal_infeasibility"):
            errs[label + k] = check_close(label + k, kern[k], plain[k])
        for k in ("xi", "psi"):
            check_close(f"{label}y.{k}", kern["y"][k], plain["y"][k])
        if int(kern["iterations"]) != n_it:
            raise SmokeFailure(f"kernel ran {int(kern['iterations'])} "
                               f"iterations, expected {n_it}")
    step_hot = make_step(x_hot)
    plain = K.apg_solve_plain(kc, step_hot, None, **hyper)
    kern = K.apg_solve(kc, step_hot, None, **hyper)
    wit = K.apg_solve_plain(dict(kc, fa=as_f64(fa)), as_f64(step_hot),
                            None, **hyper)
    for k in ("control", "u", "x"):
        witness_check(f"stressed500.{k}", kern[k], plain[k], wit[k])
    for k in ("xi", "psi"):
        witness_check(f"stressed500.y.{k}", kern["y"][k], plain["y"][k],
                      wit["y"][k])
    step = make_step(cfg.current_x)

    # a tolerance the solve crosses mid-budget, found on the plain side
    tol = None
    for cand in (1e4, 3e3, 1e3, 3e2, 1e2, 30.0, 10.0, 3.0, 1.0, 0.3, 0.1):
        p_tol = K.apg_solve_plain(kc, step, None, tolerance=cand, **hyper)
        if 1 < int(p_tol["iterations"]) < MAX_ITER:
            tol = cand
            break
    if tol is None:
        raise SmokeFailure("no tolerance gave a mid-budget exit")
    k_tol = K.apg_solve(kc, step, None, tolerance=tol, **hyper)
    it_p, it_k = int(p_tol["iterations"]), int(k_tol["iterations"])
    print(f"[tolerance] tol {tol:g}: plain stops at {it_p}, kernel at {it_k}")
    if it_p != it_k:
        raise SmokeFailure("tolerance exits differ")
    check_close("tol.control", k_tol["control"], p_tol["control"])
    if bool((k_tol["primal_infeasibility"][it_k:] != 0).any()):
        raise SmokeFailure("trace not zero past the exit")

    # 4. the closed loop through the controller (the main path)
    def controller(backend):
        fc = synthetic_forecaster(N=24, nd=net.nd, nu=net.nu,
                                  sim_horizon=4, seed=42)
        ctrl = SmpcController(copy.deepcopy(cfg), network=net, tree=tree,
                              forecaster=fc, backend=backend,
                              device="cuda")
        ctrl.initialise()
        return ctrl

    steps = 4
    ctrl = controller("auto")
    K.apg_solve.launches = K.apg_solve_batch.launches = 0
    t0 = time.perf_counter()
    log = ctrl.closed_loop(steps)
    loop_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = K.apg_solve.launches
    ms = [log[f"time{t}"][0] for t in range(steps)]
    print(f"[closed_loop] {steps} steps, kernel launches {launches}, "
          f"solve ms per step {', '.join(f'{m:.3f}' for m in ms)}; "
          f"whole step (host prep + solve + simulator) {loop_ms:.3f} ms")
    if launches != steps:
        raise SmokeFailure(f"{launches} kernel launches for {steps} solves")
    kpis = {k: log[k] for k in KPI_KEYS}
    apg_kpis = dict(kpis)
    print(f"[closed_loop] kpis {json.dumps(kpis)}")
    controls = np.array([log[f"control{t}"] for t in range(steps)])
    if not (np.isfinite(controls).all() and
            np.isfinite(list(kpis.values())).all()):
        raise SmokeFailure("non-finite controls or KPIs")
    if "memoryLeakWarning" in log:
        raise SmokeFailure(log["memoryLeakWarning"])
    ref_log = controller("torch").closed_loop(steps)
    ref_controls = np.array([ref_log[f"control{t}"] for t in range(steps)])
    check_close("closed_loop.controls", torch.as_tensor(controls),
                torch.as_tensor(ref_controls))

    # 5. timing: median of REPEATS solves each, alternating the order
    rng = np.random.default_rng(7)
    x0 = cfg.current_x
    times = {"kernel": [], "plain": []}
    solvers = {"kernel": K.apg_solve, "plain": K.apg_solve_plain}
    for r in range(REPEATS):
        xr = x0 * (1.0 + 0.02 * rng.standard_normal(x0.shape)
                   ).astype(np.float32)
        step_r = make_step(xr)
        order = ("plain", "kernel") if r % 2 == 0 else ("kernel", "plain")
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solvers[name](kc, step_r, None, **hyper)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(out["control"]).all()):
                raise SmokeFailure(f"{name} solve gave non-finite control")
    med = {k: float(np.median(v)) for k, v in times.items()}
    for name in ("kernel", "plain"):
        runs = ", ".join(f"{t:.3f}" for t in times[name])
        print(f"[timing] {name} {MAX_ITER}-iteration solve: median "
              f"{med[name]:.3f} ms of {REPEATS} ({runs})")

    single_bound = solve_bound(kc, solve_inputs(kc, step_r), out, MAX_ITER,
                               prefix)

    # 6. the batched kernel at B = 32
    rng = np.random.default_rng(7)
    x0s = (x0 * (1.0 + 0.02 * rng.standard_normal((BATCH, x0.size)))
           ).astype(np.float32)
    steps_sh = make_batch(x0s)
    steps_st = make_batch(x0s, shared=False)
    print(f"[batch] B {BATCH}: uhat batch stride "
          f"{steps_sh['uhat'].stride(0)} (shared), "
          f"{steps_st['uhat'].stride(0)} (stacked)")

    def instance(steps, b):
        return {k: v[b].contiguous() for k, v in steps.items()}

    # 6a. every instance against the single-solve kernel
    bitwise = {}
    for form, steps_b in (("shared", steps_sh), ("stacked", steps_st)):
        kb = K.apg_solve_batch(kc, steps_b, None, **hyper)
        singles = [K.apg_solve(kc, instance(steps_b, b), None, **hyper)
                   for b in range(BATCH)]
        _, bitwise[form] = compare_instances(f"6a.{form}", kb, singles)
        print(f"[batch] 6a.{form}: all {BATCH} instances equal to the "
              f"single-solve kernel bit for bit: {bitwise[form]}")
    del singles

    # 6b. every instance against the plain version; a tolerance batch
    kb = K.apg_solve_batch(kc, steps_sh, None, **hyper)
    pb = K.apg_solve_plain(kc, steps_sh, None, **hyper)
    for k in ("control", "u", "x", "primal_infeasibility"):
        errs["batch." + k] = check_close("6b." + k, kb[k], pb[k])
    for k in ("xi", "psi"):
        check_close(f"6b.y.{k}", kb["y"][k], pb["y"][k])
    kt = K.apg_solve_batch(kc, steps_sh, None, tolerance=tol, **hyper)
    pt = K.apg_solve_plain(kc, steps_sh, None, tolerance=tol, **hyper)
    its_k, its_p = kt["iterations"].tolist(), pt["iterations"].tolist()
    print(f"[batch] 6b.tolerance {tol:g}: kernel exits {sorted(set(its_k))}"
          f" (per instance {its_k})")
    if its_k != its_p:
        raise SmokeFailure(f"tolerance exits differ: kernel {its_k}, "
                           f"plain {its_p}")
    for b, it in enumerate(its_k):
        if bool((kt["primal_infeasibility"][b, it:] != 0).any()):
            raise SmokeFailure(f"instance {b}: trace not zero past exit")
    check_close("6b.tol.control", kt["control"], pt["control"])

    # 6c. the batched entry at B = 1 is the single solve
    one = {k: v[:1] for k, v in steps_sh.items()}
    b1 = K.apg_solve_batch(kc, one, None, **hyper)
    s1 = K.apg_solve(kc, instance(steps_sh, 0), None, **hyper)
    _, eq1 = compare_instances("6c.B=1", b1, [s1])
    if not eq1:
        raise SmokeFailure("B = 1 differs from the single solve")
    print("[batch] 6c: B = 1 equals the single solve bit for bit: True")
    if args.reference_kernel:
        ref_lib = ctypes.CDLL(str(build.build("apg_solve",
                                              args.reference_kernel)))
        with torch.cuda.device(device):
            r1 = K._launch(ref_lib, torch.cuda.current_stream().cuda_stream,
                           kc, instance(steps_sh, 0), None, batch=None,
                           tolerance=None, **hyper)
        same = all(torch.equal(r1[k], s1[k]) for k in ("x", "u",
                   "primal_infeasibility", "iterations")) and all(
            torch.equal(r1["y"][k], s1["y"][k]) for k in ("xi", "psi"))
        print(f"[batch] 6c: single solve equals the kernel of "
              f"{args.reference_kernel} bit for bit: {same}")
        if not same:
            raise SmokeFailure("the single solve changed")

    # 7. batched closed loops through the controller (the batch's main
    # path), cold and warm-started
    def batched(warm):
        fc = synthetic_forecaster(N=24, nd=net.nd, nu=net.nu,
                                  sim_horizon=4, seed=42)
        return BatchedSmpcController(copy.deepcopy(cfg), net, tree, fc,
                                     x0s, warm_start=warm, device="cuda")

    b_steps, b_launches, blogs = 3, 0, {}
    for warm in (False, True):
        bctrl = batched(warm)
        K.apg_solve.launches = K.apg_solve_batch.launches = 0
        t0 = time.perf_counter()
        blog = bctrl.closed_loop(b_steps)
        loop_ms = (time.perf_counter() - t0) * 1e3 / b_steps
        n = K.apg_solve_batch.launches
        b_launches += n
        label = "warm" if warm else "cold"
        print(f"[batched_loop] {label}: {b_steps} steps of B {BATCH}, "
              f"batched kernel calls {n}, single-solve calls "
              f"{K.apg_solve.launches}, solve ms per step "
              f"{', '.join(f'{m:.3f}' for m in blog['solve_times_ms'])}; "
              f"whole step {loop_ms:.3f} ms")
        if n != b_steps or K.apg_solve.launches:
            raise SmokeFailure(f"{n} batched kernel calls for {b_steps} "
                               "batched solves")
        kpis = {k: blog[k] for k in KPI_KEYS}
        if not (np.isfinite(blog["controls"]).all() and
                all(np.isfinite(v).all() for v in kpis.values())):
            raise SmokeFailure(f"{label} batched loop: non-finite "
                               "controls or KPIs")
        print(f"[batched_loop] {label} kpis of instance 0: " + json.dumps(
            {k: float(v[0]) for k, v in kpis.items()}))
        blogs[label] = blog
    cfg0 = copy.deepcopy(cfg)
    cfg0.set_current_state(x0s[0])
    fc0 = synthetic_forecaster(N=24, nd=net.nd, nu=net.nu, sim_horizon=4,
                               seed=42)
    slog = SmpcController(cfg0, network=net, tree=tree, forecaster=fc0,
                          device="cuda").closed_loop(b_steps)
    check_close("7.instance0.controls",
                torch.as_tensor(blogs["cold"]["controls"][:, 0]),
                torch.as_tensor(np.array([slog[f"control{t}"]
                                          for t in range(b_steps)])))

    # 8. timing: batched solves, inputs staged on the device
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, res

    batch_ms = []
    for r in range(BATCH_REPEATS):
        steps_r = make_batch((x0 * (1.0 + 0.02 * rng.standard_normal(
            (BATCH, x0.size)))).astype(np.float32))
        ms_r, out_b = timed(lambda: K.apg_solve_batch(kc, steps_r, None,
                                                      **hyper))
        batch_ms.append(ms_r)
        if not bool(torch.isfinite(out_b["control"]).all()):
            raise SmokeFailure("batched solve gave non-finite controls")
    batch_med = float(np.median(batch_ms))
    per = []
    for _ in range(PIPELINE_ROUNDS):
        ms_r, _ = timed(lambda: [K.apg_solve_batch(kc, steps_r, None,
                                                   **hyper)
                                 for _ in range(PIPELINE_DEPTH)])
        per.append(ms_r / PIPELINE_DEPTH)
    pipe_med = float(np.median(per))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    K.apg_solve_batch(kc, steps_r, None, **hyper)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    plain_batch = [timed(lambda: K.apg_solve_plain(
        kc, steps_r, None, **hyper))[0] for _ in range(3)]
    plain_batch_ms = float(np.median(plain_batch))
    batch_bound = solve_bound(kc, solve_inputs(kc, steps_r), out_b,
                              MAX_ITER, prefix)
    print(f"[timing] batched kernel, B {BATCH}, {MAX_ITER} iterations: "
          f"median {batch_med:.3f} ms of {BATCH_REPEATS} ("
          f"{', '.join(f'{t:.3f}' for t in batch_ms)}): "
          f"{BATCH * 1e3 / batch_med:.3f} solves/s")
    print(f"[timing] pipelined, {PIPELINE_DEPTH} batched calls per "
          f"synchronise: median {pipe_med:.3f} ms per call of "
          f"{PIPELINE_ROUNDS} rounds ({', '.join(f'{t:.3f}' for t in per)})"
          f": {BATCH * 1e3 / pipe_med:.3f} solves/s")
    print(f"[timing] single solve {med['kernel']:.3f} ms: "
          f"{1e3 / med['kernel']:.3f} solves/s; batched per instance "
          f"{batch_med / BATCH:.3f} ms")
    print(f"[timing] plain batched version, B {BATCH}: median "
          f"{plain_batch_ms:.3f} ms of 3 ("
          f"{', '.join(f'{t:.3f}' for t in plain_batch)})")
    print(f"[memory] batched solve: peak {peak / 2**20:.3f} MiB allocated, "
          f"{(peak - held) / 2**20:.3f} MiB above the "
          f"{held / 2**20:.3f} MiB held before it")
    for name, (b_ms, by, flops, nbytes) in (("single", single_bound),
                                            ("batched", batch_bound)):
        print(f"[bound] {name}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB: {b_ms:.6f} ms, set by {by}")

    source = "rapidnet_tpu_torch/csrc/apg_solve.cu"
    entries = [
        {"name": "apg_solve", "route": "cuda", "source": source,
         "replaces": "rapidnet_tpu/ops/pallas_apg.py:177",
         "launches": launches, "max_abs_err": errs["u"],
         "ms": med["kernel"], "plain_ms": med["plain"],
         "bound_ms": single_bound[0], "bound_by": single_bound[1],
         "library_ms": None},
        {"name": "apg_solve_batch", "route": "cuda", "source": source,
         "replaces": "rapidnet_tpu/ops/pallas_apg.py:477",
         "launches": b_launches, "max_abs_err": errs["batch.u"],
         "ms": batch_med, "plain_ms": plain_batch_ms,
         "bound_ms": batch_bound[0], "bound_by": batch_bound[1],
         "library_ms": None}]
    return entries, apg_kpis


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference-kernel", default=None,
                    help="an earlier csrc/apg_solve.cu: phase 6c also "
                         "holds the single solve to its kernel, bit for "
                         "bit")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from rapidnet_tpu_torch.engine.engine import XS_UPPER
    from rapidnet_tpu_torch.ops import apg_solve as K
    from rapidnet_tpu_torch.ops import build

    # full float32 products everywhere (the JAX package's HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")

    # 1. build the kernels from the checkout's sources, one nvcc for each
    # source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name, so in libs.items():
        build.load(name)
        print(f"[build] {so.name} built and loaded")
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.3f} s")

    # 2. the Barcelona-scale problem
    t0 = time.perf_counter()
    cfg, eng, net, tree, fa, make_step, make_batch = build_problem(device)
    prefix = eng.factor_step().prefix_stages
    hyper = dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                 penalty_state=cfg.penalty_state,
                 penalty_safety=cfg.penalty_safety,
                 xs_upper=float(XS_UPPER), max_iterations=MAX_ITER)
    kc = K.kernel_constants(fa, prefix_stages=prefix,
                            max_iterations=MAX_ITER)
    print(f"[problem] nx {net.nx} nu {net.nu} nd {net.nd} ne {net.ne} "
          f"N {tree.N} nodes {tree.n_nodes} scenarios {tree.ns} "
          f"prefix_stages {prefix} step_size {cfg.step_size:.6g} "
          f"(tuned in {time.perf_counter() - t0:.3f} s)")

    entries, apg_kpis = apg_phases(args, device, cfg, net, tree, fa,
                                   make_step, make_batch, prefix, hyper, kc)
    entries += qn_phases(cfg, net, tree, fa, make_step, hyper, prefix,
                         apg_kpis)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
