"""The whole-solve FBE/NAMA kernel: its wrappers, its plain version, its
counts.

Counterpart of ``rapidnet_tpu/ops/pallas_qn.py`` (``make_pallas_qn_solve``,
the single-solve wrapper ``make_qn_pallas`` and the batch wrappers
``make_qn_pallas_batch`` and ``make_qn_pallas_batch_shared``).  The
kernel is ``csrc/qn_solve.cu``, CUDA C++ for sm_90a, built on first use
by ``ops/build.py``.

``qn_solve`` is the wrapper.  It checks its inputs, then:

* for tensors on the CPU it runs the plain version, ``qn_solve_plain``
  (the same solve in plain PyTorch: ``solver/quasi_newton.py``);
* for tensors on a CUDA device it launches the kernel, or raises.

``qn_solve_batch`` is the batched wrapper: B independent solves over one
factor step in one call of the same kernel (its batch axis, where the
TPU kernel ran a ``lax.map``), with a leading batch axis on every
per-instance array; ``uhat``, ``e`` and ``alpha_price`` may be
``expand``-ed views of one array (batch stride 0, the shared forecast).
Its plain version solves the instances one after another
(``quasi_newton.make_solver_batch``).  On an H100 80GB HBM3 (700 W) a
call of 32 500-iteration solves at Barcelona scale takes ~1.05 s (FBE)
and ~1.1 s (NAMA), ~0.58 of the time of the per-slot kernel design that
preceded the flat passes (chip_smoke.py phase 14, in turns; PERF.md
sections 5 and 6).

``qn_solve.launches`` and ``qn_solve_batch.launches`` count kernel calls
(one per solve, one per batched solve) and nothing else.  The dual pair
keeps the XLA path's unpadded layout ``{"xi": (N, ns, 2nx), "psi": (N,
ns, nu)}``, with a leading B in a batch, for the warm start and the
output; the TPU kernel's padded ``{"xi1", "xi2", "psi"}`` is not ported.

The kernel's sweeps are those of ``csrc/apg_solve.cu``, with the same
shared-memory limits on the tree (N <= 152 stages, ns <= 181 scenarios
at the Barcelona-scale widths; ``fits``); a larger tree's launch is
refused and the wrapper raises.  Its dual-space passes are flat: each
instance's buffer, ``[xi | pad | psi | pad]`` (``layout``: no pads at the
Barcelona-scale sizes), is cut into P chunks of FLAT_THREADS 4-float
vectors and its rows of u into G tiles for the FBE value's smoothing
product, both functions of the sizes alone, never of B, so an instance
of a batch repeats its single solve bit for bit.  ``partials`` sizes the
per-chunk partial buffers; every launch holds it to the source's
``qn_solve_partials`` (``check_partials``) as it holds ``smem`` to
``qn_solve_smem``.

``lbfgs_dtype`` is the history's storage, "float32" (default) or
"bfloat16", the TPU kernel's ``lbfgs_dtype`` (``pallas_qn.py:99``): the
bf16 entries of the same source (``qn_solve_bf16``,
``qn_solve_batch_bf16``) round each curvature pair to bf16 before its
dots and rho, store it so and widen it on read; the plain version
applies the same round trip (``make_solver``'s private
``_lbfgs_storage``).  No controller of either package passes it: it is
a knob of these wrappers, as of ``make_qn_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from rapidnet_tpu_torch.model.config import ALGORITHM_FBE, ALGORITHM_NAMA
from rapidnet_tpu_torch.ops import apg_solve as apg_k
from rapidnet_tpu_torch.ops import build
from rapidnet_tpu_torch.solver import apg as apg_mod
from rapidnet_tpu_torch.solver import quasi_newton as qn_mod
from rapidnet_tpu_torch.solver import solve_step as ss
from rapidnet_tpu_torch.solver.qn_stream import lbfgs_storage

ROW_KEYS = ("d1", "d2", "g", "nhp", "rep", "prob", "xmin", "xmax", "xs",
            "umin", "umax")
MATRIX_KEYS = ("L", "BbT", "iWT", "LT", "BT", "Cs", "WT")
STEP_KEYS = ("beta", "uhat", "e", "alpha_price", "x0", "pdu", "prev_u")
STATE_KEYS = ("y", "yp", "yvp", "w", "rs", "yv", "dd", "wd", "df", "x", "u",
              "hx", "hu", "t", "a", "ms", "my", "norm_part", "val_part",
              "dot_part", "pp", "champ_part", "sc", "tr_inf", "tr_val",
              "tr_tau", "st")
PARTIAL_KEYS = ("norm_part", "val_part", "dot_part", "pp", "champ_part")
N_INT_SCALARS = 10      # the int scalars of csrc/qn_solve.cu (I_COUNT)
N_FLOAT_SCALARS = 4     # the float scalars before rho and alpha (S_RHO)
# csrc/qn_solve.cu's flat passes and smoothing product (FLAT_THREADS,
# TILE_ROWS, TILE_COLS, SMOOTH_THREADS, SMOOTH_SMEM_CAP)
FLAT_THREADS = 256
TILE_ROWS, TILE_COLS = 4, 8
SMOOTH_THREADS = 128
SMOOTH_SMEM_CAP = 96 * 1024


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def layout(N: int, ns: int, nx: int, nu: int) -> dict:
    """An instance's flat dual buffer, its chunks and its smoothing tiles
    (``layout`` in csrc/qn_solve.cu), functions of the problem's sizes
    alone: xi (XI floats) from 0, psi (PS) from XP, D in all (each part
    padded to a multiple of 4 floats); P chunks of FLAT_THREADS 4-float
    vectors; G tiles of TM rows of u; the smoothing product's shared
    memory (bytes)."""
    R = N * ns
    XI, PS = R * 2 * nx, R * nu
    XP = _round4(XI)
    D = XP + _round4(PS)
    P = -(-(D // 4) // FLAT_THREADS)
    NCP = -(-nu // TILE_COLS) * TILE_COLS
    TM = TILE_ROWS * max(1, SMOOTH_THREADS // (NCP // TILE_COLS))
    per_k = 4 * (NCP + TM)
    KS = min(nu, max(1, SMOOTH_SMEM_CAP // per_k))
    return {"XI": XI, "XP": XP, "PS": PS, "D": D, "P": P,
            "G": -(-R // TM), "smooth_smem": per_k * KS}


def partials(N: int, ns: int, nx: int, nu: int, B: int) -> dict:
    """Floats of each per-chunk partial buffer for B instances
    (``qn_solve_partials`` in the source, held to it at every launch):
    per instance 2P norm, 2P + 2G value (the residual's chunks, then the
    smoothing tiles), 4P dot, 2P two-loop and 6P champion floats."""
    lay = layout(N, ns, nx, nu)
    P, G = lay["P"], lay["G"]
    per = {"norm_part": 2 * P, "val_part": 2 * P + 2 * G,
           "dot_part": 4 * P, "pp": 2 * P, "champ_part": 6 * P}
    return {k: B * n for k, n in per.items()}


def fits(N: int, ns: int, nx: int, nu: int, nv: int,
         smem_limit: int | None = None) -> bool:
    """Whether the whole-solve FBE/NAMA kernel takes a tree of these
    sizes: the sweeps' shared memory (``apg_solve.sweep_smem``) and the
    smoothing product's (W' and du' slabs, at most SMOOTH_SMEM_CAP)
    within ``smem_limit`` (default: the current CUDA device's opt-in
    limit per block), the formulas of ``run_solve`` in
    csrc/qn_solve.cu."""
    return smem(N, ns, nx, nu, nv) <= build.smem_optin(smem_limit)


def smem(N: int, ns: int, nx: int, nu: int, nv: int) -> int:
    """The most shared memory (bytes) a launch at these sizes asks for
    (``qn_solve_smem`` in the source, checked at every launch)."""
    return max(apg_k.smem(N, ns, nx, nu, nv),
               layout(N, ns, nx, nu)["smooth_smem"])


def kernel_constants(fa: dict, *, prefix_stages: tuple) -> dict:
    """Per-problem kernel inputs, built once on the factors' device: the
    sweep's (``apg_solve.sweep_constants``) and W' for the FBE value."""
    kc = apg_k.sweep_constants(fa, prefix_stages=prefix_stages)
    kc["WT"] = fa["W"].T.contiguous()
    return kc


def _check_algorithm(algorithm):
    if algorithm not in (ALGORITHM_FBE, ALGORITHM_NAMA):
        raise ValueError(f"unknown quasi-Newton algorithm {algorithm}")


def _check_constants(kc):
    """Returns the problem's sizes N, ns, nx, nu, nv and the device."""
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
    return N, ns, nx, nu, nv, dev


def _check_inputs(kc, step, y0):
    N, ns, nx, nu, nv, dev = _check_constants(kc)
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


def _check_batch_inputs(kc, steps, y0):
    """Returns B, the batch strides of uhat, e and alpha_price, and the
    device (``apg_solve._check_batch_inputs``'s rules)."""
    N, ns, nx, nu, nv, dev = _check_constants(kc)
    beta = steps["beta"]
    if not isinstance(beta, torch.Tensor) or beta.dim() != 4:
        raise ValueError("steps['beta'] must be a (B, N, ns, nv) tensor")
    B = beta.shape[0]
    if B < 1:
        raise ValueError("an empty batch")
    for k, shp in {"beta": (N, ns, nv), "x0": (nx,), "prev_u": (nu,),
                   "prev_uhat": (nu,)}.items():
        apg_k._check(k, steps[k], (B, *shp), dev)
    strides = tuple(apg_k._check_shareable(k, steps[k], (B, N, ns, d), dev)
                    for k, d in (("uhat", nu), ("e", nx),
                                 ("alpha_price", nu)))
    if y0 is not None:
        apg_k._check("y0.xi", y0["xi"], (B, N, ns, 2 * nx), dev,
                     contiguous=False)
        apg_k._check("y0.psi", y0["psi"], (B, N, ns, nu), dev,
                     contiguous=False)
    return B, strides, dev


def _plain_storage(lbfgs_dtype):
    """``make_solver``'s ``_lbfgs_storage`` for a history dtype: None for
    float32 (the pair as computed), else the dtype it is rounded to."""
    nb = lbfgs_storage(lbfgs_dtype)
    return None if nb == torch.float32 else nb


def qn_solve_plain(kc, step, y0=None, *, lbfgs_dtype="float32", **hyper):
    """The plain PyTorch version: ``solver/quasi_newton.py``'s solve, on
    any device (``hyper``: ``make_solver``'s settings but the prefix
    stages), with the history's bf16 round trip where asked."""
    run = qn_mod.make_solver(prefix_stages=kc["prefix_stages"],
                             _lbfgs_storage=_plain_storage(lbfgs_dtype),
                             **hyper)
    out = run(kc["fa"], step, y0)
    del out["v"]
    return out


def qn_solve_batch_plain(kc, steps, y0=None, *, lbfgs_dtype="float32",
                         **hyper):
    """The plain batched version: ``quasi_newton.make_solver_batch``, the
    instances solved one after another, on any device."""
    run = qn_mod.make_solver_batch(
        prefix_stages=kc["prefix_stages"],
        _lbfgs_storage=_plain_storage(lbfgs_dtype), **hyper)
    out = run(kc["fa"], steps, y0)
    del out["v"]
    return out


def _hyper(algorithm, inv_step, step_size, penalty_state, penalty_safety,
           xs_upper, max_iterations, lbfgs_buffer_size, tolerance,
           lbfgs_dtype):
    """The solve's settings as keyword arguments, checked."""
    _check_algorithm(algorithm)
    if int(lbfgs_buffer_size) < 1:
        raise ValueError("lbfgs_buffer_size must be at least 1")
    lbfgs_storage(lbfgs_dtype)
    return dict(algorithm=algorithm, inv_step=inv_step,
                step_size=step_size, penalty_state=penalty_state,
                penalty_safety=penalty_safety, xs_upper=xs_upper,
                max_iterations=max_iterations,
                lbfgs_buffer_size=lbfgs_buffer_size, tolerance=tolerance,
                lbfgs_dtype=lbfgs_dtype)


def qn_solve(kc, step, y0=None, *, algorithm, inv_step, step_size,
             penalty_state, penalty_safety, xs_upper, max_iterations,
             lbfgs_buffer_size, tolerance=None, lbfgs_dtype="float32"):
    """One whole FBE or NAMA solve.  Returns control, x, u, y, the traces
    ``primal_infeasibility``, ``value_fbe`` and ``tau`` (zero past the
    exit), ``iterations``, ``line_search_trials`` (the trials the line
    searches ran, all iterations together) and ``lbfgs_skips`` (the
    curvature pairs the buffer rejected).  ``lbfgs_dtype``: the
    history's storage, "float32" or "bfloat16".

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    hyper = _hyper(algorithm, inv_step, step_size, penalty_state,
                   penalty_safety, xs_upper, max_iterations,
                   lbfgs_buffer_size, tolerance, lbfgs_dtype)
    dev = _check_inputs(kc, step, y0)
    if dev.type == "cpu":
        return qn_solve_plain(kc, step, y0, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"qn_solve runs on cpu or cuda, not {dev.type}")
    lib = _load(kc)
    check_partials(lib, _dims(kc), 1)
    # the C host function launches on the current device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        qn_solve.launches += 1
        out = _launch(lib, stream, kc, step, y0, batch=None, **hyper)
    lo, hi = ss.root_control_bounds(kc["fa"])
    out["control"] = torch.clamp(out["u"][0, 0], lo, hi)
    return out


qn_solve.launches = 0


def qn_solve_batch(kc, steps, y0=None, *, algorithm, inv_step, step_size,
                   penalty_state, penalty_safety, xs_upper, max_iterations,
                   lbfgs_buffer_size, tolerance=None, lbfgs_dtype="float32"):
    """B independent whole FBE or NAMA solves in one call.

    Every leaf of ``steps`` (and of ``y0``) carries a leading batch axis,
    as do the outputs; ``uhat``, ``e`` and ``alpha_price`` may be
    ``expand``-ed views of one array (batch stride 0).  Returns control
    (B, nu), x, u, y, the three traces (B, max_iterations), and
    ``iterations``, ``line_search_trials`` and ``lbfgs_skips`` (B,).
    ``lbfgs_dtype`` as in ``qn_solve``.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    hyper = _hyper(algorithm, inv_step, step_size, penalty_state,
                   penalty_safety, xs_upper, max_iterations,
                   lbfgs_buffer_size, tolerance, lbfgs_dtype)
    B, strides, dev = _check_batch_inputs(kc, steps, y0)
    if dev.type == "cpu":
        return qn_solve_batch_plain(kc, steps, y0, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"qn_solve_batch runs on cpu or cuda, not "
                         f"{dev.type}")
    lib = _load(kc)
    check_partials(lib, _dims(kc), B)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        qn_solve_batch.launches += 1
        out = _launch(lib, stream, kc, steps, y0, batch=B, strides=strides,
                      **hyper)
    lo, hi = ss.root_control_bounds(kc["fa"])
    out["control"] = torch.clamp(out["u"][:, 0, 0], lo, hi)
    return out


qn_solve_batch.launches = 0


def _dims(kc) -> tuple:
    """The problem's sizes (N, ns, nx, nu, nv)."""
    fa = kc["fa"]
    return (*fa["d1"].shape, fa["g"].shape[-1], fa["invWbar"].shape[0])


def _load(kc) -> ctypes.CDLL:
    """``csrc/qn_solve.cu``, built and loaded, with the shared memory its
    launch asks for at these constants' sizes held to ``smem``."""
    dims = _dims(kc)
    lib = build.load("qn_solve")
    build.check_smem(lib, "qn_solve", dims, smem(*dims))
    return lib


def check_partials(lib: ctypes.CDLL, dims: tuple, B: int) -> None:
    """Raise when the source sizes the partial buffers of B instances at
    ``dims`` (N, ns, nx, nu, nv) otherwise than ``partials`` does: one
    formula, held to the source's ``qn_solve_partials`` at every
    launch."""
    fn = lib.qn_solve_partials
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    got = (ctypes.c_longlong * len(PARTIAL_KEYS))()
    fn(*dims[:4], B, ctypes.addressof(got))
    want = partials(*dims[:4], B)
    if list(got) != [want[k] for k in PARTIAL_KEYS]:
        raise RuntimeError(f"csrc/qn_solve.cu sizes the partials of {B} "
                           f"instances at {dims} as {list(got)}; "
                           f"ops/qn_solve.py as {want}")


def _entry(lib, batched: bool, bf16: bool = False):
    """The C entry ``qn_solve_batch`` or ``qn_solve`` (``_bf16``: the
    history stored in bf16), declared."""
    fn = getattr(lib, ("qn_solve_batch" if batched else "qn_solve") +
                 ("_bf16" if bf16 else ""))
    if fn.argtypes is None:
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        fn.argtypes = ([ptr] * (len(ROW_KEYS) + len(MATRIX_KEYS) +
                                len(STEP_KEYS) + len(STATE_KEYS)) +
                       ([i32, i64, i64, i64] if batched else []) +
                       [i32] * 9 + [f32] * 7 + [i32, f32, ptr])
        fn.restype = i32
        lib.qn_solve_error_string.argtypes = [i32]
        lib.qn_solve_error_string.restype = ctypes.c_char_p
    return fn


def launches_per_iteration(algorithm, lbfgs_buffer_size, fp) -> int:
    """Kernel launches of one iteration after the first, whatever the
    batch, as the kernel's source counts them (builds the kernel)."""
    fn = build.load("qn_solve").qn_solve_launches_per_iteration
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(int(algorithm == ALGORITHM_FBE), int(lbfgs_buffer_size),
              int(fp))


def _launch(lib, stream, kc, step, y0, *, batch, strides=(0, 0, 0),
            algorithm, inv_step, step_size, penalty_state, penalty_safety,
            xs_upper, max_iterations, lbfgs_buffer_size, tolerance,
            lbfgs_dtype="float32"):
    """Allocate the outputs and scratch, then run the kernel on
    ``stream`` (the argument order of ``qn_solve`` in the source).

    ``batch=None`` is the single solve (C entry ``qn_solve``); an int B
    the batched one (``qn_solve_batch``), with a leading B on every
    per-instance array and ``strides`` the batch strides of uhat, e and
    alpha_price.
    """
    fa = kc["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    dev = fa["d1"].device
    bs = int(lbfgs_buffer_size)
    lay = layout(N, ns, nx, nu)
    XI, XP, PS, D = lay["XI"], lay["XP"], lay["PS"], lay["D"]
    lead = () if batch is None else (batch,)
    nb = lbfgs_storage(lbfgs_dtype)
    bf16 = nb == torch.bfloat16

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=dev)

    # the dual-space buffers are flat, [xi (R, 2nx) | pad | psi (R, nu)
    # | pad] per instance (``layout``), the pads zero
    y = zeros(D)
    if y0 is not None:
        y[..., :XI] = y0["xi"].reshape(*lead, -1)
        y[..., XP:XP + PS] = y0["psi"].reshape(*lead, -1)
    part = partials(N, ns, nx, nu, 1)
    state = {
        "y": y, "yp": y.clone(), "yvp": zeros(D),
        **{k: empty(D) for k in ("w", "rs", "yv", "dd", "wd", "df")},
        # x and u start at zero, as the JAX solve's carry
        "x": zeros(N, ns, nx), "u": zeros(N, ns, nu),
        "hx": empty(N, ns, nx), "hu": empty(N, ns, nu),
        "t": empty(N, ns, nx), "a": empty(N, ns, nv),
        # column 0 is zeroed by the kernel; the others are written before
        # they are read
        "ms": torch.empty(lead + (bs + 1, D), dtype=nb, device=dev),
        "my": torch.empty(lead + (bs + 1, D), dtype=nb, device=dev),
        **{k: empty(part[k]) for k in PARTIAL_KEYS},
        "sc": empty(N_FLOAT_SCALARS + 2 * (bs + 1)),
        "tr_inf": zeros(max_iterations), "tr_val": zeros(max_iterations),
        "tr_tau": zeros(max_iterations),
        "st": torch.empty(lead + (N_INT_SCALARS,), dtype=torch.int32,
                          device=dev),
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
    if batch is None:
        err = _entry(lib, False, bf16)(*ptrs, *hyper)
    else:
        err = _entry(lib, True, bf16)(*ptrs, batch, *strides, *hyper)
    if err != 0:
        msg = lib.qn_solve_error_string(err).decode()
        raise RuntimeError(f"qn_solve kernel failed: error {err} ({msg})")
    st = state["st"]
    return {"x": state["x"], "u": state["u"],
            "y": {"xi": y[..., :XI].view(*lead, N, ns, 2 * nx),
                  "psi": y[..., XP:XP + PS].view(*lead, N, ns, nu)},
            "primal_infeasibility": state["tr_inf"],
            "value_fbe": state["tr_val"], "tau": state["tr_tau"],
            "iterations": st[..., 1],
            "lbfgs_skips": st[..., 4],
            "line_search_trials": st[..., 9]}


def make_qn_kernel(fa: dict, *, algorithm, prefix_stages: tuple,
                   lbfgs_buffer_size, inv_step, step_size, penalty_state,
                   penalty_safety, xs_upper, max_iterations, tolerance=None,
                   lbfgs_dtype="float32"):
    """The single-solve wrapper (``make_qn_pallas``'s counterpart, the
    contract of ``apg_solve.make_apg_kernel``).

    Builds the kernel constants once and returns run(step, y0=None),
    with ``y0`` the previous solve's unpadded ``out["y"]``.
    ``lbfgs_dtype``: the history's storage, "float32" or "bfloat16".
    """
    hyper = _hyper(algorithm, inv_step, step_size, penalty_state,
                   penalty_safety, xs_upper, max_iterations,
                   lbfgs_buffer_size, tolerance, lbfgs_dtype)
    kc = kernel_constants(fa, prefix_stages=prefix_stages)

    def run(step, y0=None):
        return qn_solve(kc, step, y0, **hyper)

    return run


def make_qn_kernel_batch(fa: dict, *, algorithm, prefix_stages: tuple,
                         lbfgs_buffer_size, inv_step, step_size,
                         penalty_state, penalty_safety, xs_upper,
                         max_iterations, tolerance=None,
                         lbfgs_dtype="float32"):
    """The batched wrapper (``make_qn_pallas_batch``'s counterpart, the
    contract of ``apg_solve.make_apg_kernel_batch``).

    Builds the kernel constants once and returns run(steps, y0=None),
    every leaf of ``steps`` and ``y0`` with a leading batch axis.
    ``lbfgs_dtype`` as in ``make_qn_kernel``.
    """
    hyper = _hyper(algorithm, inv_step, step_size, penalty_state,
                   penalty_safety, xs_upper, max_iterations,
                   lbfgs_buffer_size, tolerance, lbfgs_dtype)
    kc = kernel_constants(fa, prefix_stages=prefix_stages)

    def run(steps, y0=None):
        return qn_solve_batch(kc, steps, y0, **hyper)

    return run


def make_qn_kernel_batch_shared(fa: dict, **kwargs):
    """The shared-forecast batched wrapper
    (``make_qn_pallas_batch_shared``'s counterpart): run(base, inst,
    y0=None), with ``(base, inst)`` from ``Engine.prepare_step_shared``
    as tensors.  Each instance's beta is assembled on the device; uhat, e
    and alpha_price go to the kernel as one array read by every
    instance.
    """
    run_batch = make_qn_kernel_batch(fa, **kwargs)

    def run(base, inst, y0=None):
        return run_batch(apg_mod.expand_shared_step(base, **inst), y0)

    return run
