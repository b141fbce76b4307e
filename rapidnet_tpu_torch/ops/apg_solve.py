"""The whole-solve APG kernel: its wrapper, its plain version, its count.

Counterpart of ``rapidnet_tpu/ops/pallas_apg.py`` (``make_pallas_solve``,
the single-solve wrapper ``make_apg_pallas`` and the batch wrappers).
The kernel is ``csrc/apg_solve.cu``, CUDA C++ for sm_90a, built on first
use by ``ops/build.py``.

``apg_solve`` is the wrapper.  It checks its inputs, then:

* for tensors on the CPU it runs the plain version, ``apg_solve_plain``
  (the same solve in plain PyTorch: ``solver/apg.py``);
* for tensors on a CUDA device it launches the kernel, or raises.

``apg_solve_batch`` is the batched wrapper (the counterpart of
``make_apg_pallas_batch`` and ``make_apg_pallas_batch_shared``,
``pallas_apg.py:477-523``): B independent solves over one factor step
in one call of the same kernel, with a leading batch axis on every
per-instance array.  Its plain version is ``apg_solve_plain`` too: the
plain solve takes the leading batch axis as it comes.

``apg_solve.launches`` and ``apg_solve_batch.launches`` count kernel
calls (one per solve, one per batched solve) and nothing else.  The
dual pair keeps the XLA path's unpadded layout ``{"xi": (N, ns, 2nx),
"psi": (N, ns, nu)}``, with a leading B in a batch.

The kernel keeps one slot's stage rows, and the branching prefix's
slot rows, in a block's shared memory (at most 227 KB): at the
Barcelona-scale widths that admits N <= 152 stages and ns <= 181
scenarios.  ``fits`` says whether a tree is within those limits, by the
formulas of the launch; a larger tree's launch is refused and the
wrapper raises.  The controllers' ``auto`` sends such trees to the
streaming kernels (``ops/apg_stream.py``).

The source picks a variant for each launch from the sizes and the
device's limits: slot clusters of C CTAs, prefix clusters of Cp, and
which phases stage their matrices in shared memory.  ``variant`` reads
the pick from the source, ``pick`` writes the rule out, ``sweep_smem``
the shared memory of any variant; every tree ``fits`` takes runs, at
worst in the one-block variant (C = Cp = 1, nothing staged), whose
shared memory is the gate's.  Every variant gives the same bits.
``solve_as`` runs a batched call in a given variant, and
``phase_spans`` one call of the clock64-instrumented build: tools for
holding the variants to each other and timing them, not the product
path.
"""

from __future__ import annotations

import ctypes

import torch

from rapidnet_tpu_torch.ops import build
from rapidnet_tpu_torch.solver import apg as apg_mod
from rapidnet_tpu_torch.solver import solve_step as ss

ROW_KEYS = ("d1", "d2", "g", "nhp", "rep", "xmin", "xmax", "xs", "umin",
            "umax")
MATRIX_KEYS = ("L", "BbT", "iWT", "LT", "BT", "Cs", "lams")
STEP_KEYS = ("beta", "uhat", "e", "x0", "pdu")
ROW_GROUP = 8        # stage rows are padded to a multiple (csrc/apg_solve.cu)
STATE_KEYS = ("y_xi", "y_psi", "yp_xi", "yp_psi", "w_xi", "w_psi", "t",
              "a", "df_xi", "df_psi", "x", "u", "norm_part", "champ_part",
              "trace", "status")
# the instrumented build (csrc/apg_solve.cu's Part, in its order): the
# parts of a block whose SM cycles ``phase_spans`` reads, each with its
# phase (Phase: tail, prefix, forward, dual update)
CLOCK_DEFINES = ("APG_SOLVE_CLOCK",)
PHASES = ("tail", "prefix", "forward", "dual")
SWEEP_PHASES = PHASES[:3]    # the phases whose variants stage matrices
SPAN_PARTS = (
    ("tail.start", 0), ("tail.elementwise", 0), ("tail.share", 0),
    ("tail.L", 0), ("tail.BbT", 0), ("tail.scan", 0), ("tail.store", 0),
    ("prefix.load", 1), ("prefix.tS", 1), ("prefix.share", 1),
    ("prefix.BbT", 1), ("prefix.children", 1),
    ("forward.load", 2), ("forward.iW", 2), ("forward.share", 2),
    ("forward.LT", 2), ("forward.u_scan", 2), ("forward.BT", 2),
    ("forward.x_scan", 2), ("forward.prox", 2), ("forward.norms", 2),
    ("dual.shrinks", 3), ("dual.update", 3), ("dual.reduce", 3))


MAX_CLUSTER = 8          # the portable cluster size (csrc/apg_solve.cu)
STATIC_RESERVE = 2048    # bytes a variant past the gate's leaves for static
                         # shared memory (csrc/apg_solve.cu)
CTAS_PER_SM = 2          # slot-cluster CTAs the pick lets share an SM
H100_SMEM_PER_SM = 233472   # an H100's shared memory an SM


def sweep_smem(N: int, ns: int, nx: int, nu: int, nv: int, C: int = 1,
               Cp: int = 1, staged: tuple = (False, False, False)) -> dict:
    """Dynamic shared memory (bytes) of the sweep phases at these sizes in
    a variant, as the launch computes it (``sweep_smem`` in
    csrc/apg_solve.cu, exported per phase as ``apg_solve_sweep_smem``):
    slot clusters of C CTAs, prefix clusters of Cp, and which phases
    (tail, prefix, forward) stage their matrices.  The default, the
    unstaged variant at C = Cp = 1, is the one-block sweeps' (the same
    sweeps in csrc/qn_solve.cu) and the routing gate's."""
    RS = -(-N // ROW_GROUP) * ROW_GROUP
    nvw, nuw, nxw = -(-nv // C), -(-nu // C), -(-nx // C)
    pxw, pvw = -(-nx // Cp), -(-nv // Cp)
    P = -(-ns // 4) * 4 if Cp > 1 else ns
    st_tail, st_prefix, st_fwd = staged
    tail = (nu + nx + nvw) * RS + (st_tail and (nu + nx) * nvw)
    prefix = ((2 if Cp > 1 else 1) * nx * P + (pxw + 2 * pvw) * ns +
              (st_prefix and nx * pvw + ns * ns))
    fwd = ((2 * nv + nu + nxw) * RS + (C > 1 and 2 * nx * RS) +
           (st_fwd and nv * nvw + nv * nuw + nu * nxw))
    return {"tail": 4 * tail, "prefix": 4 * prefix, "forward": 4 * fwd}


def smem(N: int, ns: int, nx: int, nu: int, nv: int) -> int:
    """The most shared memory (bytes) a launch of the unstaged variant at
    C = Cp = 1 asks for (``apg_solve_smem`` in the source, checked at
    every launch): every tree within it runs, whatever variant the
    source picks for it."""
    return max(sweep_smem(N, ns, nx, nu, nv).values())


def fits(N: int, ns: int, nx: int, nu: int, nv: int,
         smem_limit: int | None = None) -> bool:
    """Whether the whole-solve APG kernel takes a tree of these sizes:
    every phase's shared memory within ``smem_limit`` (default: the
    current CUDA device's opt-in limit per block)."""
    return smem(N, ns, nx, nu, nv) <= build.smem_optin(smem_limit)


def encode(v: dict) -> int:
    """A variant as the source encodes it: staged tail | prefix << 1 |
    forward << 2 | C << 4 | Cp << 8."""
    st = v["staged"]
    return (int(st["tail"]) | int(st["prefix"]) << 1 |
            int(st["forward"]) << 2 | v["cluster"] << 4 |
            v["prefix_cluster"] << 8)


def decode(code: int) -> dict:
    """``encode``'s inverse: {"cluster": C, "prefix_cluster": Cp,
    "staged": {phase: bool}}."""
    return {"cluster": (code >> 4) & 15, "prefix_cluster": (code >> 8) & 15,
            "staged": {ph: bool(code >> j & 1)
                       for j, ph in enumerate(SWEEP_PHASES)}}


def pick(N: int, ns: int, nx: int, nu: int, nv: int, B: int = 1, *,
         sm_count: int, smem_limit: int, clusters: bool = True,
         smem_per_sm: int = H100_SMEM_PER_SM,
         cluster: int | None = None) -> dict:
    """The variant the source picks for these sizes on a device with
    ``sm_count`` SMs, ``smem_limit`` bytes of opt-in shared memory a block
    and ``smem_per_sm`` an SM (``pick_sizes`` in csrc/apg_solve.cu): the
    largest C <= 8 with the B * ns * C slot CTAs within CTAS_PER_SM an
    SM, the largest Cp <= 8 with B * Cp within the SM count (1 each
    without cluster launch); a cluster whose unstaged variant does not fit
    the shared memory less STATIC_RESERVE runs at 1; then the prefix
    stages its matrices where its staged variant fits, and the slot phases
    where theirs fit and the launch's CTAs are all resident at once.
    (The source also runs a cluster at 1 where the device reports that it
    cannot hold one at once; an H100 holds these.)  ``cluster`` forces C,
    with the rest of the rule as it is: what profile_solve.py's
    ``--sweep`` times."""
    C = Cp = 1
    if clusters:
        C = cluster or max([c for c in range(1, MAX_CLUSTER + 1)
                            if B * ns * c <= CTAS_PER_SM * sm_count],
                           default=1)
        Cp = max([c for c in range(1, MAX_CLUSTER + 1) if B * c <= sm_count],
                 default=1)
    room = smem_limit - STATIC_RESERVE
    plain = sweep_smem(N, ns, nx, nu, nv, C, Cp)
    if plain["tail"] > room or plain["forward"] > room:
        C = 1
    if plain["prefix"] > room:
        Cp = 1
    st = sweep_smem(N, ns, nx, nu, nv, C, Cp, (True, True, True))
    ctas = B * ns * C
    per_sm = 1 if ctas <= sm_count else CTAS_PER_SM

    def resident(smem):
        return (smem <= room and ctas <= per_sm * sm_count and
                per_sm * (smem + STATIC_RESERVE) <= smem_per_sm)

    return {"cluster": C, "prefix_cluster": Cp,
            "staged": {"tail": resident(st["tail"]),
                       "prefix": st["prefix"] <= room,
                       "forward": resident(st["forward"])}}


def variant(N: int, ns: int, nx: int, nu: int, nv: int, B: int = 1) -> dict:
    """The variant a launch at these sizes takes on the current CUDA
    device, as the source reports it (``apg_solve_variant``; B = 1 the
    single solve, else a batched call of B); ``decode``'s dict."""
    lib = build.load("apg_solve")
    fn = lib.apg_solve_variant
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    code = fn(N, ns, nx, nu, nv, B)
    if code < 0:
        raise RuntimeError(f"apg_solve_variant failed: error {-code}")
    return decode(code)


def sweep_constants(fa: dict, *, prefix_stages: tuple) -> dict:
    """The tree sweep's kernel inputs, built once on the factors' device:
    the factor tensors, the transposed shared matrices and the prefix
    aggregation stack ``Cs`` (fp, ns, ns) — ``Cs[s]`` is applied after
    prefix stage s, the identity where the tree does not branch."""
    dev = fa["d1"].device
    ns = fa["d1"].shape[1]
    fp = prefix_stages[0] + 1 if prefix_stages else 0
    eye = torch.eye(ns, dtype=torch.float32, device=dev)
    Cs = torch.stack([fa["prefix_C"][s] if s in prefix_stages else eye
                      for s in range(max(fp, 1))])
    return {
        "fa": fa, "prefix_stages": tuple(prefix_stages), "fp": fp,
        "L": fa["L"], "BbT": fa["Bb"].T.contiguous(),
        "iWT": fa["invWbar"].T.contiguous(), "LT": fa["L"].T.contiguous(),
        "BT": fa["B"].T.contiguous(), "Cs": Cs.contiguous(),
    }


def kernel_constants(fa: dict, *, prefix_stages: tuple,
                     max_iterations: int) -> dict:
    """Per-problem kernel inputs, built once on the factors' device:
    ``sweep_constants`` and the Nesterov lambda table."""
    kc = sweep_constants(fa, prefix_stages=prefix_stages)
    kc["lams"] = torch.as_tensor(apg_mod.nesterov_lambdas(max_iterations),
                                 device=fa["d1"].device)
    return kc


def _check(name, t, shape, device, *, contiguous=True):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                         "float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_shareable(name, t, shape, device) -> int:
    """A (B, ...) step input that the kernel also takes as one array read
    by every instance (an ``expand`` of it: batch stride 0).  Returns the
    batch stride in elements."""
    _check(name, t, shape, device, contiguous=False)
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: an instance is not contiguous")
    inner = t[0].numel()
    if t.shape[0] == 1 or t.stride(0) == 0:
        return 0
    if t.stride(0) != inner:
        raise ValueError(f"{name}: batch stride {t.stride(0)}, the kernel "
                         f"takes {inner} (one instance after another) or 0 "
                         "(one array for every instance)")
    return inner


def _check_constants(kc, max_iterations):
    fa = kc["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    dev = fa["d1"].device
    shapes = {
        "d1": (N, ns, nx), "d2": (N, ns, nx), "g": (N, ns, nu),
        "nhp": (N, ns, 1), "rep": (N, ns), "xmin": (N, ns, nx),
        "xmax": (N, ns, nx), "xs": (N, ns, nx), "umin": (N, ns, nu),
        "umax": (N, ns, nu), "L": (nu, nv), "BbT": (nx, nv),
        "iWT": (nv, nv), "LT": (nv, nu), "BT": (nu, nx),
        "Cs": (max(kc["fp"], 1), ns, ns), "lams": (max_iterations,),
    }
    for k, shp in shapes.items():
        _check(k, fa[k] if k in ROW_KEYS else kc[k], shp, dev)
    return N, ns, nx, nu, nv, dev


def _check_inputs(kc, step, y0, max_iterations):
    N, ns, nx, nu, nv, dev = _check_constants(kc, max_iterations)
    for k, shp in {"beta": (N, ns, nv), "uhat": (N, ns, nu),
                   "e": (N, ns, nx), "x0": (nx,), "prev_u": (nu,),
                   "prev_uhat": (nu,)}.items():
        _check(k, step[k], shp, dev)
    if y0 is not None:
        _check("y0.xi", y0["xi"], (N, ns, 2 * nx), dev)
        _check("y0.psi", y0["psi"], (N, ns, nu), dev)
    return dev


def _check_batch_inputs(kc, steps, y0, max_iterations):
    """Returns B, the batch strides of uhat and e, and the device."""
    N, ns, nx, nu, nv, dev = _check_constants(kc, max_iterations)
    beta = steps["beta"]
    if not isinstance(beta, torch.Tensor) or beta.dim() != 4:
        raise ValueError("steps['beta'] must be a (B, N, ns, nv) tensor")
    B = beta.shape[0]
    if B < 1:
        raise ValueError("an empty batch")
    for k, shp in {"beta": (N, ns, nv), "x0": (nx,), "prev_u": (nu,),
                   "prev_uhat": (nu,)}.items():
        _check(k, steps[k], (B, *shp), dev)
    uhat_bs = _check_shareable("uhat", steps["uhat"], (B, N, ns, nu), dev)
    e_bs = _check_shareable("e", steps["e"], (B, N, ns, nx), dev)
    if y0 is not None:
        _check("y0.xi", y0["xi"], (B, N, ns, 2 * nx), dev)
        _check("y0.psi", y0["psi"], (B, N, ns, nu), dev)
    return B, uhat_bs, e_bs, dev


def apg_solve_plain(kc, step, y0=None, *, inv_step, step_size,
                    penalty_state, penalty_safety, xs_upper,
                    max_iterations, tolerance=None):
    """The plain PyTorch version: ``solver/apg.py``'s solve, any device,
    single or (with a leading batch axis on ``step`` and ``y0``)
    batched."""
    run = apg_mod.make_apg(
        prefix_stages=kc["prefix_stages"], inv_step=inv_step,
        step_size=step_size, penalty_state=penalty_state,
        penalty_safety=penalty_safety, xs_upper=xs_upper,
        max_iterations=max_iterations, tolerance=tolerance)
    out = run(kc["fa"], step, y0)
    del out["v"]
    return out


def apg_solve(kc, step, y0=None, *, inv_step, step_size, penalty_state,
              penalty_safety, xs_upper, max_iterations, tolerance=None):
    """One whole APG solve.  Returns control, x, u, y, the trace
    (``primal_infeasibility``, zero past the exit) and ``iterations``.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations,
                 tolerance=tolerance)
    dev = _check_inputs(kc, step, y0, max_iterations)
    if dev.type == "cpu":
        return apg_solve_plain(kc, step, y0, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"apg_solve runs on cpu or cuda, not {dev.type}")
    lib = _load(kc)
    # the C host function launches on the current device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        apg_solve.launches += 1
        out = _launch(lib, stream, kc, step, y0, batch=None, **hyper)
    lo, hi = ss.root_control_bounds(kc["fa"])
    out["control"] = torch.clamp(out["u"][0, 0], lo, hi)
    return out


apg_solve.launches = 0


def apg_solve_batch(kc, steps, y0=None, *, inv_step, step_size,
                    penalty_state, penalty_safety, xs_upper, max_iterations,
                    tolerance=None):
    """B independent whole APG solves in one call.

    Every leaf of ``steps`` (and of ``y0``) carries a leading batch axis,
    as do the outputs; ``uhat`` and ``e`` may be ``expand``-ed views of
    one array (batch stride 0).  Returns control (B, nu), x, u, y, the
    traces (B, max_iterations) and ``iterations`` (B,).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations,
                 tolerance=tolerance)
    B, uhat_bs, e_bs, dev = _check_batch_inputs(kc, steps, y0,
                                                max_iterations)
    if dev.type == "cpu":
        return apg_solve_plain(kc, steps, y0, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"apg_solve_batch runs on cpu or cuda, not "
                         f"{dev.type}")
    lib = _load(kc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        apg_solve_batch.launches += 1
        out = _launch(lib, stream, kc, steps, y0, batch=B, uhat_bs=uhat_bs,
                      e_bs=e_bs, **hyper)
    lo, hi = ss.root_control_bounds(kc["fa"])
    out["control"] = torch.clamp(out["u"][:, 0, 0], lo, hi)
    return out


apg_solve_batch.launches = 0


def _load(kc) -> ctypes.CDLL:
    """``csrc/apg_solve.cu``, built and loaded, with the shared memory its
    launch asks for at these constants' sizes held to ``smem``."""
    fa = kc["fa"]
    dims = (*fa["d1"].shape, fa["g"].shape[-1], fa["invWbar"].shape[0])
    lib = build.load("apg_solve")
    build.check_smem(lib, "apg_solve", dims, smem(*dims))
    return lib


def _entry(lib, batched: bool, forced: bool = False):
    """The C entry ``apg_solve_batch`` or ``apg_solve``, declared; with
    ``forced`` ``apg_solve_batch_as`` (a variant's code after the
    stream)."""
    fn = (lib.apg_solve_batch_as if forced else
          lib.apg_solve_batch if batched else lib.apg_solve)
    if fn.argtypes is None:
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        fn.argtypes = (
            [ptr] * (len(ROW_KEYS) + len(MATRIX_KEYS) + len(STEP_KEYS) +
                     len(STATE_KEYS)) +
            ([i32, i64, i64] if batched else []) +
            [i32] * 7 + [f32] * 5 + [i32, f32, ptr] +
            ([i32] if forced else []))
        fn.restype = i32
        lib.apg_solve_error_string.argtypes = [i32]
        lib.apg_solve_error_string.restype = ctypes.c_char_p
    return fn


def _launch(lib, stream, kc, step, y0, *, batch, uhat_bs=0, e_bs=0,
            inv_step, step_size, penalty_state, penalty_safety, xs_upper,
            max_iterations, tolerance, code=None):
    """Allocate the outputs and scratch, then run the kernel on
    ``stream`` (the argument order of ``apg_solve`` in the source).

    ``batch=None`` is the single solve (C entry ``apg_solve``); an int B
    the batched one (``apg_solve_batch``), with a leading B on every
    per-instance array; with ``code`` (an int B required) the batched one
    in that variant (``apg_solve_batch_as``).
    """
    fa = kc["fa"]
    N, ns, nx = fa["d1"].shape
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    dev = fa["d1"].device
    lead = () if batch is None else (batch,)

    def empty(*shape):
        return torch.empty(lead + shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=dev)

    if y0 is None:
        y_xi, y_psi = zeros(N, ns, 2 * nx), zeros(N, ns, nu)
    else:
        y_xi, y_psi = y0["xi"].clone(), y0["psi"].clone()
    state = {
        "y_xi": y_xi, "y_psi": y_psi,
        "yp_xi": y_xi.clone(), "yp_psi": y_psi.clone(),
        "w_xi": empty(N, ns, 2 * nx), "w_psi": empty(N, ns, nu),
        "t": empty(N, ns, nx), "a": empty(N, ns, nv),
        "df_xi": empty(N, ns, 2 * nx), "df_psi": empty(N, ns, nu),
        # x, u and the trace start at zero, as the JAX solve's carry
        "x": zeros(N, ns, nx), "u": zeros(N, ns, nu),
        "norm_part": empty(ns, 2), "champ_part": empty(ns, 6),
        "trace": zeros(max_iterations),
        "status": torch.zeros(lead + (2,), dtype=torch.int32, device=dev),
    }
    pdu = step["prev_u"] - step["prev_uhat"]
    stepd = dict(step, pdu=pdu)
    ptrs = ([fa[k].data_ptr() for k in ROW_KEYS] +
            [kc[k].data_ptr() for k in MATRIX_KEYS] +
            [stepd[k].data_ptr() for k in STEP_KEYS] +
            [state[k].data_ptr() for k in STATE_KEYS])
    hyper = (N, ns, nx, nu, nv, kc["fp"], max_iterations,
             float(inv_step), float(step_size),
             float(inv_step * penalty_state),
             float(inv_step * penalty_safety), float(xs_upper),
             int(tolerance is not None),
             float(tolerance) if tolerance is not None else 0.0, stream)
    if batch is None:
        err = _entry(lib, False)(*ptrs, *hyper)
    elif code is None:
        err = _entry(lib, True)(*ptrs, batch, uhat_bs, e_bs, *hyper)
    else:
        err = _entry(lib, True, True)(*ptrs, batch, uhat_bs, e_bs, *hyper,
                                      code)
    if err != 0:
        msg = lib.apg_solve_error_string(err).decode()
        raise RuntimeError(f"apg_solve kernel failed: error {err} ({msg})")
    return {"x": state["x"], "u": state["u"],
            "y": {"xi": state["y_xi"], "psi": state["y_psi"]},
            "primal_infeasibility": state["trace"],
            "iterations": state["status"][..., 1]}


def solve_as(kc, steps, y0=None, *, code: int, tolerance=None, **hyper):
    """One batched call (a leading batch axis on ``steps``, B = 1 too) on
    CUDA tensors in the variant ``code`` (``encode``) instead of the one
    the sizes pick: for holding the variants to each other and timing
    them.  Not the product path: it counts no launch.  Raises where the
    variant does not fit."""
    lib = build.load("apg_solve")
    B = steps["beta"].shape[0]
    dev = kc["fa"]["d1"].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _launch(lib, stream, kc, steps, y0, batch=B, code=code,
                       tolerance=tolerance, **_strides(kc, steps, B),
                       **hyper)


def phase_spans(kc, step, y0=None, *, batch=None, tolerance=None,
                **hyper):
    """One solve (``batch=None``) or one batched call of B solves (``step``
    with a leading batch axis) of the instrumented build
    (``CLOCK_DEFINES``) on CUDA tensors.  Returns the outputs, under
    "cycles" the SM cycles of each part of ``SPAN_PARTS`` per block and
    launch of its phase (summed over a launch's prefix stages), and under
    "blocks" each phase's blocks summed over the launches.  A
    measurement, not the product path: its marks add block barriers."""
    import numpy as np
    lib = build.load("apg_solve", CLOCK_DEFINES)
    lib.apg_solve_spans.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.apg_solve_spans.restype = ctypes.c_int
    n = len(SPAN_PARTS) + len(PHASES)
    buf = (ctypes.c_ulonglong * n)()

    def read():
        err = lib.apg_solve_spans(buf)
        if err != 0:
            raise RuntimeError(f"apg_solve_spans failed: error {err}")
        return np.array(buf[:], dtype=np.float64)

    dev = kc["fa"]["d1"].device
    read()                               # zeroes what came before
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = _launch(lib, stream, kc, step, y0, batch=batch,
                      tolerance=tolerance, **_strides(kc, step, batch),
                      **hyper)
    got = read()
    blocks = dict(zip(PHASES, got[len(SPAN_PARTS):].tolist()))
    cycles = {name: float(c) / max(blocks[PHASES[ph]], 1.0)
              for (name, ph), c in zip(SPAN_PARTS, got[:len(SPAN_PARTS)])}
    return {"out": out, "cycles": cycles, "blocks": blocks}


def _strides(kc, step, batch):
    """The batch strides of uhat and e that ``_launch`` takes."""
    if batch is None:
        return {}
    _, uhat_bs, e_bs, _ = _check_batch_inputs(kc, step, None,
                                              kc["lams"].shape[0])
    return {"uhat_bs": uhat_bs, "e_bs": e_bs}


def make_apg_kernel(fa: dict, *, prefix_stages: tuple, inv_step, step_size,
                    penalty_state, penalty_safety, xs_upper, max_iterations,
                    tolerance=None):
    """The single-solve wrapper (``make_apg_pallas``'s counterpart).

    Builds the kernel constants once and returns run(step, y0=None).
    """
    kc = kernel_constants(fa, prefix_stages=prefix_stages,
                          max_iterations=max_iterations)
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations,
                 tolerance=tolerance)

    def run(step, y0=None):
        return apg_solve(kc, step, y0, **hyper)

    return run


def make_apg_kernel_batch(fa: dict, *, prefix_stages: tuple, inv_step,
                          step_size, penalty_state, penalty_safety,
                          xs_upper, max_iterations, tolerance=None):
    """The batched wrapper (``make_apg_pallas_batch``'s counterpart).

    Builds the kernel constants once and returns run(steps, y0=None),
    every leaf of ``steps`` and ``y0`` with a leading batch axis.
    """
    kc = kernel_constants(fa, prefix_stages=prefix_stages,
                          max_iterations=max_iterations)
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations,
                 tolerance=tolerance)

    def run(steps, y0=None):
        return apg_solve_batch(kc, steps, y0, **hyper)

    return run


def make_apg_kernel_batch_shared(fa: dict, **kwargs):
    """The shared-forecast batched wrapper
    (``make_apg_pallas_batch_shared``'s counterpart): run(base, inst,
    y0=None), with ``(base, inst)`` from ``Engine.prepare_step_shared``
    as tensors.  Each instance's beta is assembled on the device; uhat
    and e go to the kernel as one array read by every instance.
    """
    run_batch = make_apg_kernel_batch(fa, **kwargs)

    def run(base, inst, y0=None):
        return run_batch(apg_mod.expand_shared_step(base, **inst), y0)

    return run
