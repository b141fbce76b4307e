"""The whole-solve FBE/NAMA kernel: its wrapper, its plain version, its
count.

Counterpart of ``rapidnet_tpu/ops/pallas_qn.py`` (``make_pallas_qn_solve``
and the single-solve wrapper ``make_qn_pallas``).  The kernel is
``csrc/qn_solve.cu``, CUDA C++ for sm_90a, built on first use by
``ops/build.py``.

``qn_solve`` is the wrapper.  It checks its inputs, then:

* for tensors on the CPU it runs the plain version, ``qn_solve_plain``
  (the same solve in plain PyTorch: ``solver/quasi_newton.py``);
* for tensors on a CUDA device it launches the kernel, or raises.

``qn_solve.launches`` counts kernel calls (one per solve) and nothing
else.  The dual pair keeps the XLA path's unpadded layout ``{"xi": (N,
ns, 2nx), "psi": (N, ns, nu)}``, for the warm start and the output; the
TPU kernel's padded ``{"xi1", "xi2", "psi"}`` is not ported.

The kernel's sweeps are those of ``csrc/apg_solve.cu``, with the same
shared-memory limits on the tree (N <= 152 stages, ns <= 181 scenarios
at the Barcelona-scale widths); a larger tree's launch is refused and
the wrapper raises.  The history is float32 (the TPU kernel's bf16
``lbfgs_dtype`` is not on this path).
"""

from __future__ import annotations

import ctypes

import torch

from rapidnet_tpu_torch.model.config import ALGORITHM_FBE, ALGORITHM_NAMA
from rapidnet_tpu_torch.ops import apg_solve as apg_k
from rapidnet_tpu_torch.ops import build
from rapidnet_tpu_torch.solver import quasi_newton as qn_mod
from rapidnet_tpu_torch.solver import solve_step as ss

ROW_KEYS = ("d1", "d2", "g", "nhp", "rep", "prob", "xmin", "xmax", "xs",
            "umin", "umax")
MATRIX_KEYS = ("L", "BbT", "iWT", "LT", "BT", "Cs", "WT")
STEP_KEYS = ("beta", "uhat", "e", "alpha_price", "x0", "pdu", "prev_u")
STATE_KEYS = ("y", "yp", "yvp", "w", "rs", "yv", "dd", "wd", "df", "x", "u",
              "hx", "hu", "t", "a", "ms", "my", "norm_part", "val_part",
              "dot_part", "pp", "champ_part", "sc", "tr_inf", "tr_val",
              "tr_tau", "st")
N_INT_SCALARS = 10      # the int scalars of csrc/qn_solve.cu (I_COUNT)
N_FLOAT_SCALARS = 4     # the float scalars before rho and alpha (S_RHO)


def kernel_constants(fa: dict, *, prefix_stages: tuple) -> dict:
    """Per-problem kernel inputs, built once on the factors' device: the
    sweep's (``apg_solve.sweep_constants``) and W' for the FBE value."""
    kc = apg_k.sweep_constants(fa, prefix_stages=prefix_stages)
    kc["WT"] = fa["W"].T.contiguous()
    return kc


def _check_algorithm(algorithm):
    if algorithm not in (ALGORITHM_FBE, ALGORITHM_NAMA):
        raise ValueError(f"unknown quasi-Newton algorithm {algorithm}")


def _check_inputs(kc, step, y0):
    fa = kc["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    dev = fa["d1"].device
    shapes = {
        "d1": (N, ns, nx), "d2": (N, ns, nx), "g": (N, ns, nu),
        "nhp": (N, ns, 1), "rep": (N, ns), "prob": (N, ns, 1),
        "xmin": (N, ns, nx), "xmax": (N, ns, nx), "xs": (N, ns, nx),
        "umin": (N, ns, nu), "umax": (N, ns, nu), "L": (nu, nv),
        "BbT": (nx, nv), "iWT": (nv, nv), "LT": (nv, nu), "BT": (nu, nx),
        "Cs": (max(kc["fp"], 1), ns, ns), "WT": (nu, nu),
    }
    for k, shp in shapes.items():
        apg_k._check(k, fa[k] if k in ROW_KEYS else kc[k], shp, dev)
    for k, shp in {"beta": (N, ns, nv), "uhat": (N, ns, nu),
                   "e": (N, ns, nx), "alpha_price": (N, ns, nu),
                   "x0": (nx,), "prev_u": (nu,),
                   "prev_uhat": (nu,)}.items():
        apg_k._check(k, step[k], shp, dev)
    if y0 is not None:
        apg_k._check("y0.xi", y0["xi"], (N, ns, 2 * nx), dev,
                     contiguous=False)
        apg_k._check("y0.psi", y0["psi"], (N, ns, nu), dev,
                     contiguous=False)
    return dev


def qn_solve_plain(kc, step, y0=None, *, algorithm, inv_step, step_size,
                   penalty_state, penalty_safety, xs_upper, max_iterations,
                   lbfgs_buffer_size, tolerance=None):
    """The plain PyTorch version: ``solver/quasi_newton.py``'s solve, on
    any device."""
    run = qn_mod.make_solver(
        algorithm=algorithm, prefix_stages=kc["prefix_stages"],
        inv_step=inv_step, step_size=step_size,
        penalty_state=penalty_state, penalty_safety=penalty_safety,
        xs_upper=xs_upper, max_iterations=max_iterations,
        lbfgs_buffer_size=lbfgs_buffer_size, tolerance=tolerance)
    out = run(kc["fa"], step, y0)
    del out["v"]
    return out


def qn_solve(kc, step, y0=None, *, algorithm, inv_step, step_size,
             penalty_state, penalty_safety, xs_upper, max_iterations,
             lbfgs_buffer_size, tolerance=None):
    """One whole FBE or NAMA solve.  Returns control, x, u, y, the traces
    ``primal_infeasibility``, ``value_fbe`` and ``tau`` (zero past the
    exit), ``iterations``, ``line_search_trials`` (the trials the line
    searches ran, all iterations together) and ``lbfgs_skips`` (the
    curvature pairs the buffer rejected).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_algorithm(algorithm)
    if int(lbfgs_buffer_size) < 1:
        raise ValueError("lbfgs_buffer_size must be at least 1")
    hyper = dict(algorithm=algorithm, inv_step=inv_step,
                 step_size=step_size, penalty_state=penalty_state,
                 penalty_safety=penalty_safety, xs_upper=xs_upper,
                 max_iterations=max_iterations,
                 lbfgs_buffer_size=lbfgs_buffer_size, tolerance=tolerance)
    dev = _check_inputs(kc, step, y0)
    if dev.type == "cpu":
        return qn_solve_plain(kc, step, y0, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"qn_solve runs on cpu or cuda, not {dev.type}")
    lib = build.load("qn_solve")
    # the C host function launches on the current device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        qn_solve.launches += 1
        out = _launch(lib, stream, kc, step, y0, **hyper)
    lo, hi = ss.root_control_bounds(kc["fa"])
    out["control"] = torch.clamp(out["u"][0, 0], lo, hi)
    return out


qn_solve.launches = 0


def _entry(lib):
    """The C entry ``qn_solve``, declared."""
    fn = lib.qn_solve
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * (len(ROW_KEYS) + len(MATRIX_KEYS) +
                                len(STEP_KEYS) + len(STATE_KEYS)) +
                       [i32] * 9 + [f32] * 7 + [i32, f32, ptr])
        fn.restype = i32
        lib.qn_solve_error_string.argtypes = [i32]
        lib.qn_solve_error_string.restype = ctypes.c_char_p
        lib.qn_solve_launches_per_iteration.argtypes = [i32, i32, i32]
        lib.qn_solve_launches_per_iteration.restype = i32
    return fn


def launches_per_iteration(algorithm, lbfgs_buffer_size, fp) -> int:
    """Kernel launches of one iteration after the first, as the kernel's
    source counts them (builds the kernel)."""
    lib = build.load("qn_solve")
    _entry(lib)
    return lib.qn_solve_launches_per_iteration(
        int(algorithm == ALGORITHM_FBE), int(lbfgs_buffer_size), int(fp))


def _launch(lib, stream, kc, step, y0, *, algorithm, inv_step, step_size,
            penalty_state, penalty_safety, xs_upper, max_iterations,
            lbfgs_buffer_size, tolerance):
    """Allocate the outputs and scratch, then run the kernel on
    ``stream`` (the argument order of ``qn_solve`` in the source)."""
    fa = kc["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    dev = fa["d1"].device
    bs = int(lbfgs_buffer_size)
    R = N * ns
    XI = R * 2 * nx
    D = XI + R * nu

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    # the dual-space buffers are flat, [xi (R, 2nx) | psi (R, nu)]
    y = zeros(D)
    if y0 is not None:
        y[:XI] = y0["xi"].reshape(-1)
        y[XI:] = y0["psi"].reshape(-1)
    state = {
        "y": y, "yp": y.clone(), "yvp": zeros(D),
        **{k: empty(D) for k in ("w", "rs", "yv", "dd", "wd", "df")},
        # x and u start at zero, as the JAX solve's carry
        "x": zeros(N, ns, nx), "u": zeros(N, ns, nu),
        "hx": empty(N, ns, nx), "hu": empty(N, ns, nu),
        "t": empty(N, ns, nx), "a": empty(N, ns, nv),
        # column 0 is zeroed by the kernel; the others are written before
        # they are read
        "ms": empty(bs + 1, D), "my": empty(bs + 1, D),
        "norm_part": empty(ns, 2), "val_part": empty(ns, 4),
        "dot_part": empty(ns, 4), "pp": empty(2, ns),
        "champ_part": empty(ns, 6),
        "sc": empty(N_FLOAT_SCALARS + 2 * (bs + 1)),
        "tr_inf": zeros(max_iterations), "tr_val": zeros(max_iterations),
        "tr_tau": zeros(max_iterations),
        "st": torch.empty(N_INT_SCALARS, dtype=torch.int32, device=dev),
    }
    stepd = dict(step, pdu=step["prev_u"] - step["prev_uhat"])
    ptrs = ([fa[k].data_ptr() for k in ROW_KEYS] +
            [kc[k].data_ptr() for k in MATRIX_KEYS] +
            [stepd[k].data_ptr() for k in STEP_KEYS] +
            [state[k].data_ptr() for k in STATE_KEYS])
    hyper = (N, ns, nx, nu, nv, kc["fp"], max_iterations, bs,
             int(algorithm == ALGORITHM_FBE), float(inv_step),
             float(step_size),
             float(inv_step * penalty_state),
             float(inv_step * penalty_safety), float(penalty_state),
             float(penalty_safety), float(xs_upper),
             int(tolerance is not None),
             float(tolerance) if tolerance is not None else 0.0, stream)
    err = _entry(lib)(*ptrs, *hyper)
    if err != 0:
        msg = lib.qn_solve_error_string(err).decode()
        raise RuntimeError(f"qn_solve kernel failed: error {err} ({msg})")
    return {"x": state["x"], "u": state["u"],
            "y": {"xi": y[:XI].view(N, ns, 2 * nx),
                  "psi": y[XI:].view(N, ns, nu)},
            "primal_infeasibility": state["tr_inf"],
            "value_fbe": state["tr_val"], "tau": state["tr_tau"],
            "iterations": state["st"][1],
            "lbfgs_skips": state["st"][4],
            "line_search_trials": state["st"][9]}


def make_qn_kernel(fa: dict, *, algorithm, prefix_stages: tuple,
                   lbfgs_buffer_size, inv_step, step_size, penalty_state,
                   penalty_safety, xs_upper, max_iterations, tolerance=None):
    """The single-solve wrapper (``make_qn_pallas``'s counterpart, the
    contract of ``apg_solve.make_apg_kernel``).

    Builds the kernel constants once and returns run(step, y0=None),
    with ``y0`` the previous solve's unpadded ``out["y"]``.
    """
    _check_algorithm(algorithm)
    kc = kernel_constants(fa, prefix_stages=prefix_stages)
    hyper = dict(algorithm=algorithm, inv_step=inv_step,
                 step_size=step_size, penalty_state=penalty_state,
                 penalty_safety=penalty_safety, xs_upper=xs_upper,
                 max_iterations=max_iterations,
                 lbfgs_buffer_size=lbfgs_buffer_size, tolerance=tolerance)

    def run(step, y0=None):
        return qn_solve(kc, step, y0, **hyper)

    return run
