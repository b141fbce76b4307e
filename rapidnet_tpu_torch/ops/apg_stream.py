"""The streaming APG iteration: its wrapper, its plain halves, its counts.

Counterpart of ``rapidnet_tpu/ops/pallas_stream.py`` (``make_apg_stream``:
the two grid-over-stages kernels K1 and K2, and the run that composes
them).  The kernels are ``csrc/apg_stream.cu``, CUDA C++ for sm_90a,
built on first use by ``ops/build.py``.  They serve the trees past the
whole-solve kernels' shared-memory limits (``apg_solve.fits``): BASELINE
config 5 (24 stages, 1024 scenarios) at the Barcelona-scale widths.

One APG iteration is two passes over the tree:

* K1, backward over the stages: the previous iteration's prox residual
  and dual update, the signed infeasibility champion of that residual,
  the extrapolation w = y' + lam z', then the backward recursion carrying
  t and a from stage to stage, with the child->parent handoff at the
  branching-prefix stages; it writes y', z' and v;
* K2, forward: u and x, the prox pre-images d x + c w, g u + c w, and
  the two rep-weighted squared distances whose roots set the shrink
  factors that the next K1 reads.

Iteration i's dual update runs inside K1 of iteration i + 1; a final
tail applies the last one.  So the trace entry of iteration i is the
champion that K1 of iteration i + 1 computes (``pallas_stream.py:629-660``).

Host half: ``stream_constants`` packs, once, the rank-1 form of the
preconditioner (d1, d2, g and every bound are sqrt(prob) x a per-stage
row; it checks that they are, as ``pack_stream_constants`` does), the
shared matrices, the Nesterov table and the prefix aggregation as index
lists (each slot's parent and each parent's child slots).  The TPU's
128-lane and 8-sublane padding, its stage blocks and its VMEM budget
are not ported: ``stream_fits`` states the H100 kernels' own limits.

Plain half: ``k1_plain`` and ``k2_plain`` are one call of each kernel in
plain PyTorch on the unpadded (N, ns, d) layout, with the same inputs,
outputs and scalars (lam_prev, lam_i, upd, k1f, k2f); ``apg_stream_plain``
composes them in the streaming order with the final tail.  The output
contract is ``solver/apg.make_apg``'s: control (projected on the physical
bounds), x, u, v, y {xi, psi}, primal_infeasibility and iterations.

``apg_stream`` is the wrapper: CPU tensors run ``apg_stream_plain``; CUDA
tensors launch the kernels or raise.  Each kernel has two variants of
the same stage bodies, which the source's C entry picks from the sizes
and the device: staged (the shared matrices and each stage's streaming
operands copied into shared memory by the copy engine) where that fits,
else unstaged (read from device memory); ``stream_fits`` and
``fused_fits`` are the unstaged variants' limits, ``staged_smem`` the
staged ones' shared memory and ``staged`` the pick.  ``stage_spans``
runs one K1 and one K2 pass of the instrumented build
(``CLOCK_DEFINES``) and reads the SM cycles of each part of a block's
stage.  Their times on an H100, and the
plain version's, are in PERF.md sections 5 and 6 (chip_smoke.py phases
18 and 28, profile_solve.py --stream).  ``apg_stream.launches`` counts its
solves; ``k1_call`` and ``k2_call`` (one K1 or one K2 pass on the card,
to hold each to its plain half) count theirs.  The fixed budget only: a
tolerance raises, as ``backend='stream'`` does in the JAX package.

The fused iteration (``apg_stream_fused``, ``make_apg_stream_fused``) is
the counterpart of ``pallas_stream.py::make_apg_stream_fused`` (:686):
the same iteration as one cooperative launch of ``fused_kernel`` in the
same source, the stage bodies of K1 and K2 in one kernel with a grid
barrier at each prefix handoff, w and v kept on chip between the
phases.  It computes the function the two-kernel iteration computes, so
its plain version is ``fused_iteration_plain`` (``k1_plain`` then
``k2_plain`` with the same scalars) and its plain solve is
``apg_stream_plain``.  ``fused_fits`` states its limits (v's tiles in a
block's shared memory; every block resident at once: one tile of slots
a block, at most one block per SM guaranteed); ``fused_call`` runs one
fused iteration on the card from a
given state and scalars, to hold it to ``fused_iteration_plain``.
No controller routes to it: ``backend="stream"`` stays the two-kernel
path, as in the JAX package, whose only caller of the fused kernel is
its config ladder (``bench_ladder.py:563-577``); the port's is
``rapidnet_tpu_torch/bench_ladder.py``.
"""

from __future__ import annotations

import ctypes

import torch

from rapidnet_tpu_torch.ops import build
from rapidnet_tpu_torch.solver import apg as apg_mod
from rapidnet_tpu_torch.solver import solve_step as ss

TILE = 8                 # scenario slots per block (csrc/apg_stream.cu)
KIDS = 8                 # child slots a handoff gather lists at once
STATIC_SMEM = 4 * (256 + TILE + TILE * (KIDS + 2)) + 16
                         # the kernels' static shared memory at most: the
                         # block reduction's buffer, nhp's tile, the
                         # gather's child lists and two barriers
MAX_GRID_Y = 65535       # the tail's grid runs the stages on blockIdx.y
RANK1 = (("d1", "cx1"), ("d2", "cx2"), ("g", "cu"), ("xmin", "bx_min"),
         ("xmax", "bx_max"), ("xs", "bx_s"), ("umin", "bu_min"),
         ("umax", "bu_max"))
ROW_KEYS = ("cx1", "cx2", "cu", "bx_min", "bx_max", "bx_s", "bu_min",
            "bu_max", "sq", "nhp", "rep")
MATRIX_KEYS = ("L", "BbT", "iWT", "LT", "BT", "lams")
INDEX_KEYS = ("agg_parent", "agg_ptr", "agg_idx")
STEP_KEYS = ("beta", "uhat", "e", "x0", "pdu")
STATE_KEYS = ("y_xi", "y_psi", "z_xi", "z_psi", "pre_xi", "pre_psi", "v",
              "x", "u", "carry", "norm_part", "champ_part", "sc", "trace")
MODES = {"solve": 0, "k1": 1, "k2": 2}
FUSED_MODES = {"solve": 0, "iteration": 1}
MAX_FUSED_RANGES = 32    # K1 ranges the fused kernel takes (MAX_RANGES in
                         # the source, whose entry refuses more)
FUSED_PRECISIONS = ("highest",)
# the instrumented build (csrc/apg_stream.cu's Part, in its order): the
# parts of a block's stage whose SM cycles ``stage_spans`` reads
CLOCK_DEFINES = ("APG_STREAM_CLOCK",)
SPAN_PARTS = ("k1_start", "x_pass", "u_pass", "BbT", "L", "iWT", "k1_end",
              "k2_load", "LT", "BT", "pre_x", "pre_u", "k2_end", "k1_wait",
              "k2_wait")
TOLERANCE_MESSAGE = (
    "backend='stream' does not support tolerance-based early "
    "termination; use backend='cuda' (in-kernel early exit) or 'torch'")


class NotStreamable(ValueError):
    """The factors are not of the form the streaming kernels take: a
    preconditioner or bound that is not sqrt(prob) x a per-stage row, or
    a prefix aggregation that is not 0/1 with one parent per slot; on a
    mesh also a tree the sharded pack cannot cut
    (``apg_stream_sharded.pack_stream_sharded``)."""


def stream_fits(N: int, ns: int, nx: int, nu: int, nv: int,
                smem_limit: int | None = None) -> bool:
    """Whether the streaming kernels take a tree of these sizes: their
    shared memory (the K1 and K2 tiles, the same formula as the launch)
    within ``smem_limit`` (default: the current CUDA device's opt-in
    limit per block), and the stages within the tail's grid."""
    return (ns >= 1 and 1 <= N <= MAX_GRID_Y and
            smem(N, ns, nx, nu, nv) <= build.smem_optin(smem_limit))


def smem(N: int, ns: int, nx: int, nu: int, nv: int) -> int:
    """The most shared memory (bytes) a launch at these sizes asks for,
    the larger of the K1 and K2 tiles (``apg_stream_smem`` in the
    source, checked at every launch)."""
    return 4 * TILE * max(nx + nv + nu, 2 * nu + nx + nv)


def fused_smem(N: int, ns: int, nx: int, nu: int, nv: int) -> int:
    """Shared memory (bytes) of the fused kernel: the (N, nv, TILE) tiles
    of v it keeps on chip beside the larger of K1's work and K2's
    without its v tile (``apg_stream_fused_smem`` in the source, checked
    at every launch)."""
    return 4 * TILE * (N * nv + max(nx + nv + nu, 2 * nu + nx))


def _room(n: int) -> int:
    """Floats a staged segment of n floats takes (``room`` in the
    source): rounded up to 4, and 4 more to land at its source's offset
    within 16 bytes."""
    return -(-n // 4) * 4 + 4 if n else 0


def staged_smem(N: int, ns: int, nx: int, nu: int, nv: int) -> tuple:
    """Dynamic shared memory (bytes) of the staged variants of K1, K2 and
    the fused kernel (``apg_stream_staged_smem`` in the source, which
    the card tests hold this to): the work areas, the matrices and the
    operand buffers, one for K1 and two for K2, one of K1's or two of
    K2's for the fused kernel.  A launch takes the staged variant where
    this and the kernel's static shared memory fit the device's opt-in
    limit, else the unstaged one (``smem``, ``fused_smem``); the source
    decides (``staged``)."""
    t = TILE
    k1_work, k2_work = (nx + nv + nu) * t, (2 * nu + nx + nv) * t
    k1_mats = _room(nx * nv) + _room(nu * nv) + _room(nv * nv)
    k2_mats = _room(nv * nu) + _room(nu * nx)
    rows_x = [nx] * 5
    k1_buf = sum(map(_room, [2 * nx * t] * 3 + [nu * t] * 3 +
                     [nv * t, t, t] + rows_x + [nu] * 3))

    def k2_buf(fused):
        own = ([(2 * nx + nu) * t] if fused else
               [nv * t] + [2 * nx * t] * 2 + [nu * t] * 2)
        return sum(map(_room, own + [nu * t, nx * t, t, t] + rows_x + [nu]))

    fused_work = max(k1_work, k2_work - nv * t)
    return (4 * (k1_work + k1_mats + k1_buf),
            4 * (k2_work + k2_mats + 2 * k2_buf(False)),
            4 * (N * nv * t + fused_work + max(k1_mats, k2_mats) +
                 max(k1_buf, 2 * k2_buf(True))))


def staged(N: int, ns: int, nx: int, nu: int, nv: int) -> dict:
    """Which variant each kernel takes at these sizes on the current CUDA
    device, as the source's C entries choose it (``apg_stream_staged``):
    {"k1", "k2", "fused"} -> True where staged (the matrices and a
    stage's operands in shared memory), False where it reads them from
    device memory."""
    lib = build.load("apg_stream")
    fn = lib.apg_stream_staged
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    mask = fn(N, ns, nx, nu, nv)
    if mask < 0:
        raise RuntimeError(f"apg_stream_staged failed: error {-mask}")
    return {"k1": bool(mask & 1), "k2": bool(mask & 2),
            "fused": bool(mask & 4)}


def fused_fits(N: int, ns: int, nx: int, nu: int, nv: int,
               smem_limit: int | None = None,
               sm_count: int | None = None) -> bool:
    """Whether the fused kernel takes a tree of these sizes: the
    streaming kernels' limits (``stream_fits``), its shared memory
    (``fused_smem``) within ``smem_limit``, and its grid (one block per
    TILE slots) no larger than the SMs (``sm_count``, default: the
    current CUDA device's), so that every block can be resident at once
    whatever its registers.  The launch checks the exact occupancy and
    refuses a grid that is not resident."""
    if sm_count is None:
        sm_count = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return (stream_fits(N, ns, nx, nu, nv, smem_limit) and
            fused_smem(N, ns, nx, nu, nv) <= build.smem_optin(smem_limit)
            and -(-ns // TILE) <= int(sm_count))


def _rank1_rows(fa: dict, sq: torch.Tensor) -> dict:
    """The per-stage rows of d1, d2, g and the bounds, recovered from
    slot 0 and checked against every slot (pallas_stream.py:85-109)."""
    rows = {}
    for name, key in RANK1:
        full = fa[name]
        row = full[:, 0, :] / sq[:, :1]
        rec = row[:, None, :] * sq[:, :, None]
        if not torch.allclose(rec, full, rtol=1e-5, atol=1e-6):
            raise NotStreamable(
                f"{name} is not sqrt(prob) x per-stage row — the "
                "streaming kernel requires the standard preconditioner "
                "structure (engine/engine.py)")
        rows[key] = row.contiguous()
    return rows


def _aggregation(fa: dict, stages: tuple, ns: int, dev) -> dict:
    """The prefix aggregations as index lists, in the order of
    ``stages``: each slot's parent (one 1 per row of Bp) and each
    parent's child slots (the 1s of its row of Cp), in CSR form with
    parents numbered across the stages."""
    parents, ptr, idx = [], [0], []
    base = 0
    for s in stages:
        Cp = fa["prefix_Cp"][s].cpu()
        Bp = fa["prefix_Bp"][s].cpu()
        for name, m in (("prefix_Cp", Cp), ("prefix_Bp", Bp)):
            if not bool(((m == 0) | (m == 1)).all()):
                raise NotStreamable(f"{name}[{s}] has entries other "
                                    "than 0 and 1")
        if Bp.shape[0] != ns or Cp.shape != (Bp.shape[1], ns):
            raise ValueError(f"prefix_Cp/prefix_Bp[{s}]: shapes "
                             f"{tuple(Cp.shape)}, {tuple(Bp.shape)}")
        if not bool((Bp.sum(dim=1) == 1).all()):
            raise NotStreamable(f"prefix_Bp[{s}] must have one 1 per row")
        parents.append(Bp.argmax(dim=1) + base)
        for r in range(Cp.shape[0]):
            kids = torch.nonzero(Cp[r]).flatten().tolist()
            idx += kids
            ptr.append(ptr[-1] + len(kids))
        base += Cp.shape[0]

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    return {"agg_parent": (torch.stack(parents).to(torch.int32).to(dev)
                           if parents else i32([0])),
            "agg_ptr": i32(ptr), "agg_idx": i32(idx if idx else [0])}


def stage_ranges(N: int, agg_stages: tuple, stop: int = 0) -> tuple:
    """K1's launches: (first stage, last stage, aggregation read at the
    start or -1), the stages descending from N - 1 to ``stop``, cut after
    each aggregation (every one above ``stop``)."""
    ranges, hi, gather = [], N - 1, -1
    for k, p in enumerate(agg_stages):
        ranges.append((hi, p, gather))
        hi, gather = p - 1, k
    ranges.append((hi, stop, gather))
    return tuple(ranges)


def stream_constants(fa: dict, *, prefix_stages: tuple,
                     max_iterations: int) -> dict:
    """The streaming kernels' inputs, built once on the factors' device
    (``pack_stream_constants``'s counterpart, unpadded).  Raises
    ``NotStreamable`` (a ValueError) when the factors are not of the
    rank-1 form, or the prefix aggregation is not 0/1 with one parent per
    slot."""
    dev = fa["d1"].device
    N, ns, _ = fa["d1"].shape
    sq = torch.sqrt(fa["prob"][..., 0])
    kc = _rank1_rows(fa, sq)
    agg = tuple(s for s in sorted(prefix_stages, reverse=True) if s > 0)
    kc.update(_aggregation(fa, agg, ns, dev))
    kc.update({
        "fa": fa, "prefix_stages": tuple(prefix_stages), "agg_stages": agg,
        "ranges": stage_ranges(N, agg),
        "sq": sq.contiguous(), "nhp": fa["nhp"][..., 0].contiguous(),
        "rep": fa["rep"],
        "L": fa["L"], "BbT": fa["Bb"].T.contiguous(),
        "iWT": fa["invWbar"].T.contiguous(), "LT": fa["L"].T.contiguous(),
        "BT": fa["B"].T.contiguous(),
        # lam_i for i = 0 .. max_iterations (the last is read, not used,
        # by the scalars before the tail)
        "lams": torch.as_tensor(apg_mod.nesterov_lambdas(max_iterations + 1),
                                device=dev),
    })
    return kc


# ---------------------------------------------------------------- plain


def _rows(kc, key):
    """A rank-1 slab: the per-stage row times sqrt(prob), (N, ns, d)."""
    return kc[key][:, None, :] * kc["sq"][..., None]


def _clip(pre, lo, hi):
    """jnp.clip(pre, lo, hi): max with lo, then min with hi (a tensor or
    a number)."""
    out = torch.maximum(pre, lo)
    if isinstance(hi, torch.Tensor):
        return torch.minimum(out, hi)
    return torch.clamp(out, max=hi)


def _residual(pre, w, lo, hi, shrink, c):
    """(1 - shrink)(pre - clip(pre, lo, hi)) - c w."""
    return (1.0 - shrink) * (pre - _clip(pre, lo, hi)) - c * w


def _residuals(kc, pre, w, k1f, k2f, c, xs_upper):
    """The three residual blocks (x box, safety level, u box)."""
    nx = kc["cx1"].shape[-1]
    r1 = _residual(pre["xi"][..., :nx], w["xi"][..., :nx],
                   _rows(kc, "bx_min"), _rows(kc, "bx_max"), k1f, c)
    r2 = _residual(pre["xi"][..., nx:], w["xi"][..., nx:],
                   _rows(kc, "bx_s"), xs_upper, k2f, c)
    rp = _residual(pre["psi"], w["psi"], _rows(kc, "bu_min"),
                   _rows(kc, "bu_max"), 0.0, c)
    return torch.cat([r1, r2], dim=-1), rp


def _champion(r_xi, r_psi):
    """The signed infeasibility champion as the TPU kernel takes it
    (pallas_stream.py:362-378): per block max and min, hi if hi > -lo
    else lo, then the larger of the two."""
    def signed(r):
        hi, lo = r.max(), r.min()
        return torch.where(hi > -lo, hi, lo)
    return torch.maximum(signed(r_xi), signed(r_psi))


def k1_plain(kc, beta, pre, y, z, *, lam_prev, lam_i, upd, k1f, k2f, c,
             step, xs_upper):
    """One K1 pass in plain PyTorch: the previous iteration's residual
    and dual update, its champion, the extrapolation and the backward
    recursion.  ``pre``, ``y``, ``z``: {"xi", "psi"} on (N, ns, d).
    Returns (y', z', v, champion)."""
    fa = kc["fa"]
    nx = kc["cx1"].shape[-1]
    w_prev = {k: y[k] + lam_prev * z[k] for k in y}
    r_xi, r_psi = _residuals(kc, pre, w_prev, k1f, k2f, c, xs_upper)
    y_n = {"xi": y["xi"] + upd * (lam_prev * z["xi"] + step * r_xi),
           "psi": y["psi"] + upd * (lam_prev * z["psi"] + step * r_psi)}
    z_n = {k: y_n[k] - y[k] for k in y}
    w = {k: y_n[k] + lam_i * z_n[k] for k in y}
    tb = (_rows(kc, "cx1") * w["xi"][..., :nx] +
          _rows(kc, "cx2") * w["xi"][..., nx:])
    gw = _rows(kc, "cu") * w["psi"]
    BbT, L = kc["BbT"], kc["L"]
    N = tb.shape[0]
    q = torch.zeros_like(tb[0])
    r = torch.zeros_like(beta[0])
    inner = []
    for s in range(N - 1, -1, -1):
        q = tb[s] + q
        r = beta[s] + r + q @ BbT + gw[s] @ L
        inner.append(r)
        if s in kc["agg_stages"]:
            Cp, Bp = fa["prefix_Cp"][s], fa["prefix_Bp"][s]
            q = Bp @ (Cp @ q)
            r = Bp @ (Cp @ r)
    inner = torch.stack(inner[::-1])
    v = kc["nhp"][..., None] * (inner @ kc["iWT"])
    return y_n, z_n, v, _champion(r_xi, r_psi)


def k2_plain(kc, v, uhat, e, x0, pdu, y, z, *, lam_i, c, xs_upper):
    """One K2 pass in plain PyTorch: the forward recursion, the prox
    pre-images and the two rep-weighted squared distances.  Returns
    (x, u, pre {"xi", "psi"}, d1sq, d2sq)."""
    nx = kc["cx1"].shape[-1]
    ns = v.shape[1]
    dv = v @ kc["LT"]
    du = pdu.expand(ns, -1)
    xs = x0.expand(ns, -1)
    x, u = [], []
    for s in range(v.shape[0]):
        du = du + dv[s]
        u_s = uhat[s] + du
        xs = xs + e[s] + u_s @ kc["BT"]
        x.append(xs)
        u.append(u_s)
    x, u = torch.stack(x), torch.stack(u)
    w = {k: y[k] + lam_i * z[k] for k in y}
    pre1 = _rows(kc, "cx1") * x + c * w["xi"][..., :nx]
    pre2 = _rows(kc, "cx2") * x + c * w["xi"][..., nx:]
    prep = _rows(kc, "cu") * u + c * w["psi"]
    df1 = pre1 - _clip(pre1, _rows(kc, "bx_min"), _rows(kc, "bx_max"))
    df2 = pre2 - _clip(pre2, _rows(kc, "bx_s"), xs_upper)
    rep = kc["rep"][..., None]
    return (x, u, {"xi": torch.cat([pre1, pre2], dim=-1), "psi": prep},
            torch.sum(rep * df1 * df1), torch.sum(rep * df2 * df2))


def _shrink(sumsq, thresh):
    dist = torch.sqrt(sumsq)
    return torch.where(dist > thresh,
                       1.0 - thresh / torch.clamp(dist, min=1e-30),
                       torch.zeros_like(dist))


def _hyper(inv_step, penalty_state, penalty_safety, **_):
    return (float(inv_step), float(inv_step * penalty_state),
            float(inv_step * penalty_safety))


def plain_iterations(kc, step, y0=None, *, iterations, inv_step,
                     step_size, penalty_state, penalty_safety, xs_upper,
                     **_):
    """``iterations`` passes of K1 then K2 from a cold (or ``y0``) start,
    in plain PyTorch.  Returns the state the next K1 reads: y, z, pre,
    x, u, v, the shrinks k1f, k2f and the champions of iterations
    -1 .. iterations - 2 (the first is of no residual: K1 of the first
    iteration updates nothing)."""
    c, t1c, t2c = _hyper(inv_step, penalty_state, penalty_safety)
    ref = step["beta"]
    N, ns = ref.shape[:2]
    nx = kc["cx1"].shape[-1]
    nu = kc["cu"].shape[-1]
    if y0 is None:
        y = {"xi": ref.new_zeros(N, ns, 2 * nx), "psi": ref.new_zeros(
            N, ns, nu)}
    else:
        y = {"xi": y0["xi"], "psi": y0["psi"]}
    z = {k: torch.zeros_like(y[k]) for k in y}
    pre = {k: torch.zeros_like(y[k]) for k in y}
    k1f = k2f = ref.new_zeros(())
    pdu = step["prev_u"] - step["prev_uhat"]
    lams = kc["lams"]
    x = u = v = None
    champs = []
    for it in range(iterations):
        lam_i = lams[it]
        y, z, v, champ = k1_plain(
            kc, step["beta"], pre, y, z, lam_prev=lams[max(it - 1, 0)],
            lam_i=lam_i, upd=1.0 if it > 0 else 0.0, k1f=k1f, k2f=k2f,
            c=c, step=step_size, xs_upper=xs_upper)
        x, u, pre, d1sq, d2sq = k2_plain(
            kc, v, step["uhat"], step["e"], step["x0"], pdu, y, z,
            lam_i=lam_i, c=c, xs_upper=xs_upper)
        k1f, k2f = _shrink(d1sq, t1c), _shrink(d2sq, t2c)
        champs.append(champ)
    return {"y": y, "z": z, "pre": pre, "x": x, "u": u, "v": v,
            "k1f": k1f, "k2f": k2f, "champions": champs}


def fused_iteration_plain(kc, step, state, scalars, *, inv_step,
                          step_size, xs_upper, **_):
    """One fused iteration in plain PyTorch: ``k1_plain`` then
    ``k2_plain`` with the same scalars (lam_prev, lam_i, upd, k1f, k2f),
    from ``state`` = {"pre", "y", "z"}, each {"xi", "psi"}.  Returns y',
    z', v, the champion, x, u, the pre-images and the two squared
    distances."""
    lam_prev, lam_i, upd, k1f, k2f = scalars
    c = float(inv_step)
    y, z, v, champ = k1_plain(
        kc, step["beta"], state["pre"], state["y"], state["z"],
        lam_prev=lam_prev, lam_i=lam_i, upd=upd, k1f=k1f, k2f=k2f, c=c,
        step=step_size, xs_upper=xs_upper)
    x, u, pre, d1sq, d2sq = k2_plain(
        kc, v, step["uhat"], step["e"], step["x0"],
        step["prev_u"] - step["prev_uhat"], y, z, lam_i=lam_i, c=c,
        xs_upper=xs_upper)
    return {"y": y, "z": z, "v": v, "champion": champ, "x": x, "u": u,
            "pre": pre, "d1sq": d1sq, "d2sq": d2sq}


def _check_budget(max_iterations, tolerance):
    if tolerance is not None:
        raise ValueError(TOLERANCE_MESSAGE)
    if int(max_iterations) < 1:
        raise ValueError("the streaming solve runs at least one iteration")


def apg_stream_plain(kc, step, y0=None, *, inv_step, step_size,
                     penalty_state, penalty_safety, xs_upper,
                     max_iterations, tolerance=None):
    """The whole streaming solve in plain PyTorch: ``max_iterations``
    K1/K2 passes, then the final dual update (the tail,
    pallas_stream.py:629-660), with the trace shifted by one place."""
    _check_budget(max_iterations, tolerance)
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper)
    st = plain_iterations(kc, step, y0, iterations=max_iterations, **hyper)
    c = float(inv_step)
    lam = kc["lams"][max_iterations - 1]
    w = {k: st["y"][k] + lam * st["z"][k] for k in st["y"]}
    r_xi, r_psi = _residuals(kc, st["pre"], w, st["k1f"], st["k2f"], c,
                             xs_upper)
    y = {"xi": w["xi"] + step_size * r_xi, "psi": w["psi"] + step_size * r_psi}
    trace = torch.stack(st["champions"][1:] + [_champion(r_xi, r_psi)])
    lo, hi = ss.root_control_bounds(kc["fa"])
    return {"control": torch.clamp(st["u"][0, 0], lo, hi), "x": st["x"],
            "u": st["u"], "v": st["v"], "y": y,
            "primal_infeasibility": trace,
            "iterations": torch.tensor(max_iterations, dtype=torch.int32,
                                       device=trace.device)}


# -------------------------------------------------------------- wrapper


def _check(name, t, shape, device, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _dims(kc):
    N, ns = kc["sq"].shape
    return N, ns, kc["cx1"].shape[-1], kc["cu"].shape[-1], kc["iWT"].shape[0]


def _check_inputs(kc, step, y0, max_iterations):
    """The constants' and the step's devices, types and shapes (as
    ``apg_solve._check_inputs``); returns the device."""
    N, ns, nx, nu, nv = _dims(kc)
    dev = kc["sq"].device
    shapes = {"cx1": (N, nx), "cx2": (N, nx), "cu": (N, nu),
              "bx_min": (N, nx), "bx_max": (N, nx), "bx_s": (N, nx),
              "bu_min": (N, nu), "bu_max": (N, nu), "sq": (N, ns),
              "nhp": (N, ns), "rep": (N, ns), "L": (nu, nv),
              "BbT": (nx, nv), "iWT": (nv, nv), "LT": (nv, nu),
              "BT": (nu, nx), "lams": (max_iterations + 1,)}
    for k, shp in shapes.items():
        _check(k, kc[k], shp, dev)
    for k in INDEX_KEYS:
        _check(k, kc[k], tuple(kc[k].shape), dev, torch.int32)
    for k, shp in {"beta": (N, ns, nv), "uhat": (N, ns, nu),
                   "e": (N, ns, nx), "x0": (nx,), "prev_u": (nu,),
                   "prev_uhat": (nu,)}.items():
        _check(k, step[k], shp, dev)
    if y0 is not None:
        _check("y0.xi", y0["xi"], (N, ns, 2 * nx), dev)
        _check("y0.psi", y0["psi"], (N, ns, nu), dev)
    return dev


def _entry(lib, fused=False):
    """The C entry ``apg_stream`` (or ``apg_stream_fused``, which takes
    the scratch w after the counter), declared."""
    fn = lib.apg_stream_fused if fused else lib.apg_stream
    if fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * (len(ROW_KEYS) + len(MATRIX_KEYS) +
                                len(INDEX_KEYS) + len(STEP_KEYS) +
                                len(STATE_KEYS) + 1 + int(fused)) +
                       [i32] * 6 + [ptr, i32] + [f32] * 5 + [i32, ptr])
        fn.restype = i32
        lib.apg_stream_tile.restype = i32
        lib.apg_stream_error_string.argtypes = [i32]
        lib.apg_stream_error_string.restype = ctypes.c_char_p
        if lib.apg_stream_tile() != TILE:
            raise RuntimeError("csrc/apg_stream.cu's tile differs from "
                               "ops/apg_stream.TILE")
    return fn


def _state(kc, step, y0, max_iterations, fused=False):
    """The kernels' state, outputs and scratch on the device: the dual
    pair from ``y0`` (or zero), z and the pre-images zero, as the JAX
    run starts them; with ``fused``, the fused kernel's scratch w (N,
    ns, 2nx + nu)."""
    N, ns, nx, nu, nv = _dims(kc)
    dev = kc["sq"].device
    nb = -(-ns // TILE)
    n_champ = max(len(kc["ranges"]), N) * nb

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    if y0 is None:
        y_xi, y_psi = zeros(N, ns, 2 * nx), zeros(N, ns, nu)
    else:
        y_xi, y_psi = y0["xi"].clone(), y0["psi"].clone()
    extra = {"w": empty(N, ns, 2 * nx + nu)} if fused else {}
    return {**extra, "y_xi": y_xi, "y_psi": y_psi,
            "z_xi": zeros(N, ns, 2 * nx), "z_psi": zeros(N, ns, nu),
            "pre_xi": zeros(N, ns, 2 * nx), "pre_psi": zeros(N, ns, nu),
            "v": empty(N, ns, nv), "x": empty(N, ns, nx),
            "u": empty(N, ns, nu), "carry": empty(2, ns, nx + nv),
            "norm_part": empty(nb, 2), "champ_part": empty(n_champ, 4),
            "sc": zeros(5), "trace": zeros(max_iterations),
            "ctr": torch.zeros(1, dtype=torch.int32, device=dev)}


def _call(kc, step, state, entry, fused, mode, *, inv_step, step_size,
          penalty_state, penalty_safety, xs_upper, max_iterations,
          lib=None):
    """Enqueue ``mode`` of the C entry ``entry`` of ``lib`` (default: the
    checkout's build) on the current stream of the constants' device:
    the argument order of ``apg_stream`` (and of ``apg_stream_fused``,
    with the scratch w after the counter) in the source.  Raises on a
    refused launch."""
    N, ns, nx, nu, nv = _dims(kc)
    if not stream_fits(N, ns, nx, nu, nv):
        raise ValueError(f"the streaming kernels do not take this tree "
                         f"(N {N}, ns {ns}, nx {nx}, nu {nu}, nv {nv}): "
                         "past stream_fits")
    dev = kc["sq"].device
    lib = lib or build.load("apg_stream")
    fn = _entry(lib, fused)
    build.check_smem(lib, "apg_stream", (N, ns, nx, nu, nv),
                     smem(N, ns, nx, nu, nv))
    if fused:
        build.check_smem(lib, "apg_stream_fused", (N, ns, nx, nu, nv),
                         fused_smem(N, ns, nx, nu, nv))
    stepd = dict(step, pdu=(step["prev_u"] - step["prev_uhat"]).contiguous())
    ptrs = ([kc[k].data_ptr() for k in ROW_KEYS + MATRIX_KEYS + INDEX_KEYS]
            + [stepd[k].data_ptr() for k in STEP_KEYS]
            + [state[k].data_ptr() for k in STATE_KEYS + ("ctr",)]
            + ([state["w"].data_ptr()] if fused else []))
    flat = [v for r in kc["ranges"] for v in r]
    ranges = (ctypes.c_int * len(flat))(*flat)
    c, t1c, t2c = _hyper(inv_step, penalty_state, penalty_safety)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, N, ns, nx, nu, nv, int(max_iterations), ranges,
                 len(kc["ranges"]), c, float(step_size), t1c, t2c,
                 float(xs_upper), mode, stream)
    if err != 0:
        msg = lib.apg_stream_error_string(err).decode()
        raise RuntimeError(f"{entry} kernel failed: error {err} ({msg})")


def _launch(kc, step, state, mode, **hyper):
    """``mode`` ("solve", "k1" or "k2") of the two-kernel entry."""
    _call(kc, step, state, "apg_stream", False, MODES[mode], **hyper)


def _launch_fused(kc, step, state, mode, **hyper):
    """``mode`` ("solve" or "iteration") of the fused entry."""
    _check_fused(kc)
    _call(kc, step, state, "apg_stream_fused", True, FUSED_MODES[mode],
          **hyper)


def _check_fused(kc, smem_limit=None, sm_count=None):
    """Raise where the fused kernel does not take the tree: past
    ``fused_fits``, or more K1 ranges than it carries."""
    N, ns, nx, nu, nv = _dims(kc)
    if not fused_fits(N, ns, nx, nu, nv, smem_limit, sm_count):
        raise ValueError(f"the fused kernel does not take this tree (N {N}, "
                         f"ns {ns}, nx {nx}, nu {nu}, nv {nv}): past "
                         "fused_fits")
    if len(kc["ranges"]) > MAX_FUSED_RANGES:
        raise ValueError(f"{len(kc['ranges'])} ranges of stages: the fused "
                         f"kernel takes at most {MAX_FUSED_RANGES}")


def _outputs(kc, state, max_iterations):
    """A solve's outputs from the kernels' state."""
    lo, hi = ss.root_control_bounds(kc["fa"])
    return {"control": torch.clamp(state["u"][0, 0], lo, hi),
            "x": state["x"], "u": state["u"], "v": state["v"],
            "y": {"xi": state["y_xi"], "psi": state["y_psi"]},
            "primal_infeasibility": state["trace"],
            "iterations": torch.tensor(max_iterations, dtype=torch.int32,
                                       device=state["u"].device)}


def apg_stream(kc, step, y0=None, *, inv_step, step_size, penalty_state,
               penalty_safety, xs_upper, max_iterations, tolerance=None):
    """One streaming APG solve of ``max_iterations`` iterations.  Returns
    control, x, u, v, y, the trace and ``iterations``.

    CPU tensors run the plain version; CUDA tensors launch the kernels.
    """
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations)
    _check_budget(max_iterations, tolerance)
    dev = _check_inputs(kc, step, y0, max_iterations)
    if dev.type == "cpu":
        return apg_stream_plain(kc, step, y0, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"apg_stream runs on cpu or cuda, not {dev.type}")
    state = _state(kc, step, y0, max_iterations)
    apg_stream.launches += 1
    _launch(kc, step, state, "solve", **hyper)
    return _outputs(kc, state, max_iterations)


apg_stream.launches = 0


def apg_stream_fused(kc, step, y0=None, *, inv_step, step_size,
                     penalty_state, penalty_safety, xs_upper,
                     max_iterations, tolerance=None):
    """One streaming APG solve of ``max_iterations`` fused iterations
    (one cooperative launch each), with ``apg_stream``'s outputs.

    CPU tensors run the plain version (``apg_stream_plain``); CUDA
    tensors launch the fused kernel or raise.
    """
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations)
    _check_budget(max_iterations, tolerance)
    dev = _check_inputs(kc, step, y0, max_iterations)
    if dev.type == "cpu":
        return apg_stream_plain(kc, step, y0, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"apg_stream_fused runs on cpu or cuda, not "
                         f"{dev.type}")
    state = _state(kc, step, y0, max_iterations, fused=True)
    apg_stream_fused.launches += 1
    _launch_fused(kc, step, state, "solve", **hyper)
    return _outputs(kc, state, max_iterations)


apg_stream_fused.launches = 0


def _single_pass(kc, step, scalars, hyper, mode, fill, lib=None):
    """One K1 or K2 pass on the card with the given scalars (lam_prev,
    lam_i, upd, k1f, k2f) and the state ``fill`` puts in place, by
    ``lib`` (default: the checkout's build)."""
    dev = _check_inputs(kc, step, None, hyper["max_iterations"])
    if dev.type != "cuda":
        raise ValueError(f"the single {mode} pass runs on cuda only")
    fused = mode == "iteration"
    state = _state(kc, step, None, hyper["max_iterations"], fused=fused)
    state["sc"][:] = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                                   device=dev).reshape(())
                                   for s in scalars])
    fill(state)
    (_launch_fused if fused else _launch)(kc, step, state, mode, lib=lib,
                                          **hyper)
    return state


def _champion_of(kc, st):
    """The champion from K1's per-block partials of every range."""
    n = len(kc["ranges"]) * -(-kc["sq"].shape[1] // TILE)
    part = st["champ_part"][:n]
    hx, lx = part[:, 0].max(), part[:, 1].min()
    hp, lp = part[:, 2].max(), part[:, 3].min()
    return torch.maximum(torch.where(hx > -lx, hx, lx),
                         torch.where(hp > -lp, hp, lp))


def _k1_pass(kc, step, pre, y, z, scalars, hyper, lib=None):
    def fill(st):
        for k in ("xi", "psi"):
            st[f"pre_{k}"].copy_(pre[k])
            st[f"y_{k}"].copy_(y[k])
            st[f"z_{k}"].copy_(z[k])

    st = _single_pass(kc, step, scalars, hyper, "k1", fill, lib)
    return ({"xi": st["y_xi"], "psi": st["y_psi"]},
            {"xi": st["z_xi"], "psi": st["z_psi"]}, st["v"],
            _champion_of(kc, st))


def _k2_pass(kc, step, v, y, z, scalars, hyper, lib=None):
    def fill(st):
        st["v"].copy_(v)
        for k in ("xi", "psi"):
            st[f"y_{k}"].copy_(y[k])
            st[f"z_{k}"].copy_(z[k])

    st = _single_pass(kc, step, scalars, hyper, "k2", fill, lib)
    return (st["x"], st["u"], {"xi": st["pre_xi"], "psi": st["pre_psi"]},
            st["norm_part"][:, 0].sum(), st["norm_part"][:, 1].sum())


def k1_call(kc, step, pre, y, z, scalars, **hyper):
    """One K1 pass of the kernel on CUDA tensors (every range of stages),
    from the state ``pre``, ``y``, ``z`` with ``scalars`` = (lam_prev,
    lam_i, upd, k1f, k2f).  Returns (y', z', v, champion), as
    ``k1_plain``; the champion is combined from the kernel's per-block
    partials."""
    k1_call.launches += 1
    return _k1_pass(kc, step, pre, y, z, scalars, hyper)


k1_call.launches = 0


def k2_call(kc, step, v, y, z, scalars, **hyper):
    """One K2 pass of the kernel on CUDA tensors from v and the updated
    y, z, with ``scalars`` as ``k1_call``'s.  Returns (x, u, pre, d1sq,
    d2sq), as ``k2_plain``; the sums are the kernel's per-block partials
    added up."""
    k2_call.launches += 1
    return _k2_pass(kc, step, v, y, z, scalars, hyper)


k2_call.launches = 0


def stage_spans(kc, step, pre, y, z, scalars, **hyper):
    """One K1 pass, then one K2 pass from its y', z' and v, of the
    instrumented build (``CLOCK_DEFINES``) on CUDA tensors, from the
    state and scalars ``k1_call`` takes.  Returns the two passes'
    outputs (as ``k1_call``'s and ``k2_call``'s) and, under "cycles",
    the SM cycles of each part of ``SPAN_PARTS`` summed over the blocks
    and the launches of its pass.  A measurement, not the product path:
    its marks add block barriers."""
    import numpy as np
    lib = build.load("apg_stream", CLOCK_DEFINES)
    lib.apg_stream_spans.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.apg_stream_spans.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * len(SPAN_PARTS))()

    def read():
        err = lib.apg_stream_spans(buf)
        if err != 0:
            raise RuntimeError(f"apg_stream_spans failed: error {err}")
        return np.array(buf[:], dtype=np.int64)

    read()                               # zeroes what came before
    k1 = _k1_pass(kc, step, pre, y, z, scalars, hyper, lib)
    c1 = read()
    k2 = _k2_pass(kc, step, k1[2], k1[0], k1[1], scalars, hyper, lib)
    cycles = c1 + read()
    return {"k1": k1, "k2": k2,
            "cycles": dict(zip(SPAN_PARTS, cycles.tolist()))}


def fused_call(kc, step, state, scalars, **hyper):
    """One fused iteration of the kernel on CUDA tensors, from ``state``
    = {"pre", "y", "z"} with ``scalars`` = (lam_prev, lam_i, upd, k1f,
    k2f).  Returns ``fused_iteration_plain``'s dict; the champion and the
    squared distances are combined from the kernel's per-block
    partials."""
    def fill(st):
        for k in ("xi", "psi"):
            st[f"pre_{k}"].copy_(state["pre"][k])
            st[f"y_{k}"].copy_(state["y"][k])
            st[f"z_{k}"].copy_(state["z"][k])

    fused_call.launches += 1
    st = _single_pass(kc, step, scalars, hyper, "iteration", fill)
    return {"y": {"xi": st["y_xi"], "psi": st["y_psi"]},
            "z": {"xi": st["z_xi"], "psi": st["z_psi"]}, "v": st["v"],
            "champion": _champion_of(kc, st), "x": st["x"], "u": st["u"],
            "pre": {"xi": st["pre_xi"], "psi": st["pre_psi"]},
            "d1sq": st["norm_part"][:, 0].sum(),
            "d2sq": st["norm_part"][:, 1].sum()}


fused_call.launches = 0


def make_apg_stream_fused(fa: dict, *, prefix_stages: tuple, inv_step,
                          step_size, penalty_state, penalty_safety,
                          xs_upper, max_iterations, precision="highest",
                          tolerance=None, consts=None):
    """The fused streaming solve (``make_apg_stream_fused``'s
    counterpart): builds the constants once (or takes ``consts`` from
    ``stream_constants``) and returns run(step, y0=None).  ``precision``
    takes only "highest" (the products run in full float32, as the
    port's streaming path does); a tolerance raises."""
    if precision not in FUSED_PRECISIONS:
        raise ValueError(f"precision must be 'highest' (the fused kernel's "
                         f"products run in full float32), got "
                         f"'{precision}'")
    _check_budget(max_iterations, tolerance)
    kc = consts if consts is not None else stream_constants(
        fa, prefix_stages=prefix_stages, max_iterations=max_iterations)
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations)

    def run(step, y0=None):
        return apg_stream_fused(kc, step, y0, **hyper)

    return run


def make_apg_stream_kernel(fa: dict, *, prefix_stages: tuple, inv_step,
                           step_size, penalty_state, penalty_safety,
                           xs_upper, max_iterations, tolerance=None,
                           consts=None):
    """The streaming solve (``make_apg_stream``'s counterpart), with the
    contract of ``apg_solve.make_apg_kernel``: builds the constants once
    (or takes ``consts`` from ``stream_constants``) and returns
    run(step, y0=None).  Raises on a tolerance, as the JAX package's
    ``backend='stream'`` does."""
    _check_budget(max_iterations, tolerance)
    kc = consts if consts is not None else stream_constants(
        fa, prefix_stages=prefix_stages, max_iterations=max_iterations)
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=max_iterations)

    def run(step, y0=None):
        return apg_stream(kc, step, y0, **hyper)

    return run
