"""Scenario-sharded streaming APG: the per-shard halves, their wrappers.

Counterpart of ``rapidnet_tpu/ops/pallas_stream_sharded.py``
(``analyze_prefix_locality``, ``pack_stream_sharded`` and
``make_apg_stream_sharded``; its ``make_sharded_sweeps`` is
``ops/stream_qn.s1a_call``).  Every rank of a ``parallel.Mesh`` owns a
contiguous block of nsl = ns / size scenario slots and runs the
streaming APG iteration on that block; only the tree edges that cross
shards are all-reduced (the JAX module's docstring, :10-30):

* the forward sweep (K2) is per slot, so it runs unchanged on the block;
* the backward sweep's child -> parent handoffs are shard-local at every
  prefix stage whose parents' slots lie inside one block (the deep
  stages); only the top ``s_hi`` stages cross shards.

One iteration on a rank (``make_apg_stream_sharded``):

* ``k1a_call``: K1 of ``csrc/apg_stream.cu`` (mode 1) over the block and
  the stages N-1 .. s_hi, with the handoffs numbered within the shard
  (``stage_ranges`` stops at s_hi), then ``partial_parents``
  (``csrc/stream_sharded.cu``): for each parent of stage s_hi, the sum of
  the exit carries [t | a] of its child slots in this block;
* one all-reduce (SUM) of that block;
* ``low_tail``, PyTorch on the rank's device: stages s_hi-1 .. 0 (the
  dual update, the stage recursion, the champion of those stages, and
  at each lower cross stage its own partial block and all-reduce), as
  the JAX module's XLA tail (:560-628);
* ``k2_local``: K2 (mode 2) on the block, and its two squared-distance
  partials summed on the rank and all-reduced (SUM); the shrinks and the
  next iteration's scalars (lam_prev, lam_i, upd, k1f, k2f) are computed
  on the device into the ``sc`` that the next K1 reads.

The infeasibility champion of each iteration is kept per rank as its
four block extrema and reduced (MAX) once after the last iteration, so an
iteration has two all-reduces (three or more when a prefix stage below
s_hi crosses shards); the trace is one place back, with the final tail's
value appended (:668-694).  Every iteration runs eagerly: a gloo
collective waits for the card and cannot be captured in a CUDA graph.

``run(step, y0=None)`` keeps JAX's contract: global (N, ns, d) inputs of
which every rank takes its block, outputs gathered back to the global
layout on every rank, and the control the root slot of rank 0, summed
from masked values.  On CPU tensors the plain halves run (``k1a_plain``,
``partial_parents_plain``, ``apg_stream.k2_plain`` on the block); on
CUDA tensors the kernels run or the call raises.  The layout is the
port's unpadded (N, nsl, d) per rank, with no lane padding.

``precision`` "default" (one bf16 pass a product, the JAX module's
``precision=``): K1 and K2 run their ``_bf16`` entries on the block,
and the partial parent block rounds each child's carry before its sum
(``partial_parents_bf16``, :357-358); the all-reduce, the broadcast back
to the slots (HIGHEST, :567-568) and ``low_tail`` (XLA at HIGHEST,
:531-536) stay float32.  So the sharded solve's handoff at s_hi rounds
once where the single-device one rounds twice (the parent's sum too),
and the two do not repeat each other bit for bit at "default", as in
the JAX package.  The launches are counted under ``k1a_call_bf16``,
``k2_local_bf16`` and ``partial_parents_bf16``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rapidnet_tpu_torch.ops import apg_stream as S
from rapidnet_tpu_torch.ops import build
from rapidnet_tpu_torch.solver import solve_step as ss

SINGLE_SHARD = "single-shard tree — use make_apg_stream"


# ---------------------------------------------------------------- host


def analyze_prefix_locality(fa: dict, n_shards: int) -> dict:
    """Classify each branching-prefix aggregation stage as shard-local or
    cross-shard for contiguous equal scenario blocks (``pallas_stream_
    sharded.py:62-92``): stage s is local iff every parent's child slots
    lie inside one block.  Returns {"s_hi": the topmost cross stage (0
    if none), "local": [...], "cross": [...], "nsl"} (stages
    descending)."""
    ns = fa["d1"].shape[1]
    if ns % n_shards != 0:
        raise ValueError(f"ns={ns} not divisible by {n_shards} shards")
    nsl = ns // n_shards
    local, cross = [], []
    for s in sorted(fa["prefix_Cp"].keys(), reverse=True):
        Cp = fa["prefix_Cp"][s].cpu().numpy()
        ok = True
        for row in Cp:
            cols = np.flatnonzero(row)
            if cols.size and cols[0] // nsl != cols[-1] // nsl:
                ok = False
                break
        (local if ok else cross).append(s)
    s_hi = max(cross) if cross else 0
    for s in local:
        if s < s_hi:
            raise S.NotStreamable(
                f"prefix stage {s} is shard-local below the cross-shard "
                f"stage {s_hi} — unsupported tree/shard layout")
    return {"s_hi": s_hi, "local": local, "cross": cross, "nsl": nsl}


def pack_stream_sharded(fa: dict, n_shards: int, rank: int, *,
                        prefix_stages: tuple, max_iterations: int) -> dict:
    """The constants of shard ``rank`` of ``n_shards`` (``pack_stream_
    sharded``, :107-211, as one rank's share), on the factors' device.

    ``apg_stream.stream_constants`` (so K1, K2, S1 and S2 take them
    unchanged) with the slot-dependent keys made the block's: sq, nhp and
    rep (N, nsl); the handoff lists of the shard-local prefix stages,
    slots and parents numbered within the shard; ``ranges`` from N-1 down
    to s_hi.  Besides: for the top cross stage s_hi, ``parent_block``'s
    keys (``x_Cp``, its 0/1 child-sum block over the local columns, and
    the kernel's lists ``x_ptr``/``x_idx``) and ``x_parent``, each local
    slot's parent; ``low``, for each cross stage below s_hi, its
    child-sum block over the local columns and each local slot's
    parent.  Raises a ValueError when ns is not a multiple of
    ``n_shards``, and ``NotStreamable`` when no stage crosses shards, a
    shard-local stage lies below a cross one, or the factors are not of
    the rank-1, 0/1 form."""
    info = analyze_prefix_locality(fa, n_shards)
    s_hi = info["s_hi"]
    if s_hi == 0:
        raise S.NotStreamable(SINGLE_SHARD)
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} outside {n_shards} shards")
    # checks the rank-1 rows and that every aggregation is 0/1 with one
    # parent a slot
    kc = S.stream_constants(fa, prefix_stages=prefix_stages,
                            max_iterations=max_iterations)
    dev = fa["d1"].device
    N = fa["d1"].shape[0]
    nsl = info["nsl"]
    sl = slice(rank * nsl, (rank + 1) * nsl)

    def block(s):
        """Stage s's child-sum block over the local columns, and each
        local slot's parent."""
        Cp, Bp = fa["prefix_Cp"][s].cpu(), fa["prefix_Bp"][s].cpu()
        return Cp[:, sl].contiguous(), Bp[sl].argmax(dim=1)

    # shard-local handoffs: the parents whose child slots lie in the block
    local = tuple(sorted(info["local"], reverse=True))
    loc_Cp, loc_Bp = {}, {}
    for s in local:
        Cp, Bp = fa["prefix_Cp"][s].cpu(), fa["prefix_Bp"][s].cpu()
        rows = [r for r, cols in enumerate(Cp.numpy())
                if cols.any() and np.flatnonzero(cols)[0] // nsl == rank]
        loc_Cp[s] = Cp[rows][:, sl].contiguous().to(dev)
        loc_Bp[s] = Bp[sl][:, rows].contiguous().to(dev)
    kc.update(S._aggregation({"prefix_Cp": loc_Cp, "prefix_Bp": loc_Bp},
                             local, nsl, dev))

    x_Cp, x_parent = block(s_hi)
    low = {s: tuple(t.to(dev) for t in block(s))
           for s in info["cross"] if s != s_hi}
    kc.update(parent_block(x_Cp.to(dev),
                           kc["cx1"].shape[-1] + kc["iWT"].shape[0]))
    kc.update({
        "fa": {"prefix_Cp": loc_Cp, "prefix_Bp": loc_Bp}, "root": fa,
        "agg_stages": local, "ranges": S.stage_ranges(N, local, stop=s_hi),
        "s_hi": s_hi,
        "cross_stages": tuple(sorted(info["cross"], reverse=True)),
        "low": low, "n_shards": n_shards, "rank": rank, "nsl": nsl,
        "ns": fa["d1"].shape[1], "slots": sl,
        "x_parent": x_parent.to(dev),
        "sq": kc["sq"][:, sl].contiguous(),
        "nhp": kc["nhp"][:, sl].contiguous(),
        "rep": kc["rep"][:, sl].contiguous()})
    return kc


def shard_step(kc: dict, step: dict) -> dict:
    """The rank's block of a global step dict: (N, ns, d) slabs cut on the
    slot axis, the vectors whole."""
    sl = kc["slots"]
    return {k: (v[:, sl].contiguous() if v.dim() == 3 else v)
            for k, v in step.items()}


# ------------------------------------------------------------ the parents


def parent_block(x_Cp: torch.Tensor, width: int) -> dict:
    """The partial parent block's constants from the top cross stage's
    0/1 child-sum block ``x_Cp`` (n_parents, nsl), on its device:
    ``x_Cp``; ``x_ptr`` (n_parents + 1) and ``x_idx``, each parent's
    child slots in ascending order (CSR, int32: the order in which the
    kernel sums them); ``n_parents``; ``nsl``; ``x_width``, the width
    nx + nv of the carries summed; and ``x_device``, their device.  The
    lists are made, and so checked, here once: ``partial_parents``
    checks only the carries a call."""
    ptr, idx = [0], []
    for row in x_Cp.cpu():
        kids = torch.nonzero(row).flatten().tolist()    # ascending
        idx += kids
        ptr.append(ptr[-1] + len(kids))
    dev = x_Cp.device
    return {"x_Cp": x_Cp,
            "x_ptr": torch.tensor(ptr, dtype=torch.int32, device=dev),
            "x_idx": torch.tensor(idx or [0], dtype=torch.int32, device=dev),
            "n_parents": x_Cp.shape[0], "nsl": x_Cp.shape[1],
            "x_width": int(width), "x_device": dev}


def partial_parents_plain(kc: dict, carry: torch.Tensor,
                          precision: str = "highest") -> torch.Tensor:
    """The shard's share of each stage-s_hi parent's child sum of the
    exit carries ``carry`` (nsl, nx + nv): (n_parents, nx + nv), the
    0/1 child-sum block over the local columns times the carries
    (``dot(t_s, XCpT)``), the carries rounded to bfloat16 at
    "default"."""
    return kc["x_Cp"] @ S.rounding(precision)(carry)


def _lib(entry="partial_parents"):
    """The library and its C entry ``entry`` (``partial_parents`` or
    ``partial_parents_bf16``, one argument list), declared."""
    lib = build.load("stream_sharded")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [i32, i32, ptr]
        fn.restype = i32
        lib.stream_sharded_error_string.argtypes = [i32]
        lib.stream_sharded_error_string.restype = ctypes.c_char_p
    return lib, fn


def partial_parents(kc: dict, carry: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """``partial_parents_plain`` on CPU tensors; on CUDA tensors the
    kernel of ``csrc/stream_sharded.cu`` (at "default" its entry
    ``partial_parents_bf16``), or a raise.  A call checks only ``carry``:
    (nsl, x_width) float32, contiguous, on the lists' device
    (``parent_block`` made and checked the lists once), and enters no
    device context when that device is the current one."""
    bf16 = S.check_precision(precision)
    dev, R, W = kc["x_device"], kc["n_parents"], kc["x_width"]
    S._check("carry", carry, (kc["nsl"], W), dev)
    if dev.type == "cpu":
        return partial_parents_plain(kc, carry, precision)
    if dev.type != "cuda":
        raise ValueError(f"partial_parents runs on cpu or cuda, not "
                         f"{dev.type}")
    out = carry.new_empty((R, W))
    entry = "partial_parents_bf16" if bf16 else "partial_parents"
    lib, fn = _lib(entry)
    S.count(partial_parents, partial_parents_bf16, precision)
    args = (carry.data_ptr(), kc["x_ptr"].data_ptr(), kc["x_idx"].data_ptr(),
            out.data_ptr(), R, W, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        msg = lib.stream_sharded_error_string(err).decode()
        raise RuntimeError(f"{entry} kernel failed: error {err} ({msg})")
    return out


partial_parents.launches = 0
partial_parents_bf16 = S.bf16_wrapper(partial_parents)


def spread_parents(kc: dict, parents: torch.Tensor) -> tuple:
    """The reduced stage-s_hi parents back on the local slots: (t, a),
    each slot its parent's row (``parents @ XBpT``)."""
    nx = kc["cx1"].shape[-1]
    rows = parents.index_select(0, kc["x_parent"])
    return rows[:, :nx], rows[:, nx:]


def low_handoff(kc: dict, s: int, t, a, mesh) -> tuple:
    """The handoff at a cross stage s below s_hi: the block's child sums
    of [t | a] over its columns, all-reduced, then each local slot its
    parent's row (:613-619)."""
    nx = t.shape[-1]
    Cp, parent = kc["low"][s]
    part = mesh.psum(Cp @ torch.cat([t, a], dim=-1))
    rows = part.index_select(0, parent)
    return rows[:, :nx], rows[:, nx:]


# ------------------------------------------------------------------ K1a


def _stage_rows(kc: dict, stages: slice) -> dict:
    """The rows and sq of ``kc`` for a range of stages (for
    ``apg_stream._residuals`` and ``_rows`` on a slice of the slab)."""
    keys = ("cx1", "cx2", "cu", "bx_min", "bx_max", "bx_s", "bu_min",
            "bu_max", "sq")
    return {k: kc[k][stages] for k in keys}


def _extrema(r_xi, r_psi) -> torch.Tensor:
    """[hi_x, lo_x, hi_u, lo_u] of a residual."""
    return torch.stack([r_xi.max(), r_xi.min(), r_psi.max(), r_psi.min()])


def _merge(e1, e2) -> torch.Tensor:
    return torch.stack([torch.maximum(e1[0], e2[0]),
                        torch.minimum(e1[1], e2[1]),
                        torch.maximum(e1[2], e2[2]),
                        torch.minimum(e1[3], e2[3])])


def _dual_update(kr, pre, y, z, sc, c, step, xs_upper):
    """The previous iteration's residual and dual update on a range of
    stages: (y', z', residual xi, residual psi)."""
    lam_prev, upd, k1f, k2f = sc[0], sc[2], sc[3], sc[4]
    w_prev = {k: y[k] + lam_prev * z[k] for k in y}
    r_xi, r_psi = S._residuals(kr, pre, w_prev, k1f, k2f, c, xs_upper)
    y_n = {"xi": y["xi"] + upd * (lam_prev * z["xi"] + step * r_xi),
           "psi": y["psi"] + upd * (lam_prev * z["psi"] + step * r_psi)}
    return y_n, {k: y_n[k] - y[k] for k in y}, r_xi, r_psi


def _stage(kr, i, beta_s, w, t, a, BbT, L, rnd=S._same):
    """The backward recursion at stage index ``i`` of ``kr``'s rows:
    t = d1 w1 + d2 w2 + t, a = beta + a + Bb t + L'(g wp), each product's
    vector operand through ``rnd`` (the matrices given as the products
    read them)."""
    nx = kr["cx1"].shape[-1]
    sq = kr["sq"][i][:, None]
    t = (kr["cx1"][i] * sq) * w["xi"][:, :nx] + \
        (kr["cx2"][i] * sq) * w["xi"][:, nx:] + t
    a = beta_s + a + rnd(t) @ BbT + rnd((kr["cu"][i] * sq) * w["psi"]) @ L
    return t, a


def _views(state, stages):
    return ({"xi": state["pre_xi"][stages], "psi": state["pre_psi"][stages]},
            {"xi": state["y_xi"][stages], "psi": state["y_psi"][stages]},
            {"xi": state["z_xi"][stages], "psi": state["z_psi"][stages]})


def k1a_plain(kc, step, state, *, inv_step, step_size, xs_upper,
              precision="highest", **_):
    """One K1a pass in plain PyTorch on the rank's block: the dual update
    and the backward recursion over stages N-1 .. s_hi with the local
    handoffs, in place on ``state`` (y, z, and v of those stages; the
    scalars in ``state["sc"]``), the products at ``precision``.  Returns
    ([hi_x, lo_x, hi_u, lo_u] of those stages' residual, the shard's
    partial parent block)."""
    rnd, mats = S.rounding(precision), S.matrices(kc, precision)
    N = kc["sq"].shape[0]
    s_hi = kc["s_hi"]
    hs = slice(s_hi, N)
    kr = _stage_rows(kc, hs)
    sc = state["sc"]
    pre, y, z = _views(state, hs)
    y_n, z_n, r_xi, r_psi = _dual_update(kr, pre, y, z, sc, float(inv_step),
                                         step_size, xs_upper)
    lam_i = sc[1]
    w = {k: y_n[k] + lam_i * z_n[k] for k in y}
    nx, nv = kc["cx1"].shape[-1], kc["iWT"].shape[0]
    beta = step["beta"]
    t = w["xi"].new_zeros(w["xi"].shape[1], nx)
    a = w["xi"].new_zeros(w["xi"].shape[1], nv)
    inner = [None] * (N - s_hi)
    for s in range(N - 1, s_hi - 1, -1):
        i = s - s_hi
        t, a = _stage(kr, i, beta[s], {k: w[k][i] for k in w}, t, a,
                      mats["BbT"], mats["L"], rnd)
        inner[i] = a
        if s in kc["agg_stages"]:
            Cp, Bp = kc["fa"]["prefix_Cp"][s], kc["fa"]["prefix_Bp"][s]
            t, a = S._handoff(Cp, Bp, t, rnd), S._handoff(Cp, Bp, a, rnd)
    for k in ("xi", "psi"):
        state[f"y_{k}"][hs] = y_n[k]
        state[f"z_{k}"][hs] = z_n[k]
    state["v"][hs] = kc["nhp"][hs][..., None] * (rnd(torch.stack(inner)) @
                                                 mats["iWT"])
    parents = partial_parents_plain(kc, torch.cat([t, a], dim=-1), precision)
    return _extrema(r_xi, r_psi), parents


def k1a_call(kc, step, state, precision="highest", **hyper):
    """One K1a pass: on CPU tensors ``k1a_plain``; on CUDA tensors K1 of
    ``csrc/apg_stream.cu`` over the shard's stage ranges (mode 1), then
    ``partial_parents`` on the carries its last launch wrote, both at
    ``precision``."""
    S.check_precision(precision)
    dev = kc["sq"].device
    if dev.type == "cpu":
        return k1a_plain(kc, step, state, precision=precision, **hyper)
    if dev.type != "cuda":
        raise ValueError(f"k1a_call runs on cpu or cuda, not {dev.type}")
    S.count(k1a_call, k1a_call_bf16, precision)
    S._launch(kc, step, state, "k1", precision=precision, **hyper)
    n = len(kc["ranges"])
    part = state["champ_part"][:n * -(-kc["nsl"] // S.TILE)]
    ext = torch.stack([part[:, 0].max(), part[:, 1].min(),
                       part[:, 2].max(), part[:, 3].min()])
    return ext, partial_parents(kc, state["carry"][(n - 1) & 1], precision)


k1a_call.launches = 0
k1a_call_bf16 = S.bf16_wrapper(k1a_call)


# ------------------------------------------------------------ low tail


def low_tail(kc, step, state, parents, mesh, *, inv_step, step_size,
             xs_upper, **_):
    """Stages s_hi-1 .. 0 on the rank's block (PyTorch on its device; the
    JAX module's XLA tail, :560-628): from the all-reduced parents of
    stage s_hi, the dual update, the recursion and v of each stage, in
    place on ``state``, with the handoff of every lower cross stage
    all-reduced; float32 at any precision (HIGHEST there, :531-536).
    Returns the extrema of those stages' residual."""
    s_hi = kc["s_hi"]
    c = float(inv_step)
    sc = state["sc"]
    lam_i = sc[1]
    t, a = spread_parents(kc, parents)
    ext = None
    for s in range(s_hi - 1, -1, -1):
        st = slice(s, s + 1)
        kr = _stage_rows(kc, st)
        pre, y, z = _views(state, st)
        y_n, z_n, r_xi, r_psi = _dual_update(kr, pre, y, z, sc, c,
                                             step_size, xs_upper)
        e = _extrema(r_xi, r_psi)
        ext = e if ext is None else _merge(ext, e)
        for k in ("xi", "psi"):
            state[f"y_{k}"][st] = y_n[k]
            state[f"z_{k}"][st] = z_n[k]
        w = {k: (y_n[k] + lam_i * z_n[k])[0] for k in y}
        t, a = _stage(kr, 0, step["beta"][s], w, t, a, kc["BbT"], kc["L"])
        state["v"][s] = kc["nhp"][s][:, None] * (a @ kc["iWT"])
        if s > 0 and s in kc["low"]:
            t, a = low_handoff(kc, s, t, a, mesh)
    return ext


# ------------------------------------------------------------------ K2


def k2_local(kc, step, state, precision="highest", **hyper):
    """One K2 pass on the rank's block at ``precision``, in place on
    ``state`` (x, u and the pre-images); returns the block's two squared
    distances (2,).  On CPU tensors ``apg_stream.k2_plain``; on CUDA
    tensors K2 of ``csrc/apg_stream.cu`` (mode 2) and its partials
    summed."""
    S.check_precision(precision)
    dev = kc["sq"].device
    if dev.type == "cpu":
        y = {"xi": state["y_xi"], "psi": state["y_psi"]}
        z = {"xi": state["z_xi"], "psi": state["z_psi"]}
        x, u, pre, d1sq, d2sq = S.k2_plain(
            kc, state["v"], step["uhat"], step["e"], step["x0"],
            step["prev_u"] - step["prev_uhat"], y, z,
            lam_i=state["sc"][1], c=float(hyper["inv_step"]),
            xs_upper=hyper["xs_upper"], precision=precision)
        state["x"].copy_(x)
        state["u"].copy_(u)
        state["pre_xi"].copy_(pre["xi"])
        state["pre_psi"].copy_(pre["psi"])
        return torch.stack([d1sq, d2sq])
    if dev.type != "cuda":
        raise ValueError(f"k2_local runs on cpu or cuda, not {dev.type}")
    S.count(k2_local, k2_local_bf16, precision)
    S._launch(kc, step, state, "k2", precision=precision, **hyper)
    return state["norm_part"].sum(dim=0)


k2_local.launches = 0
k2_local_bf16 = S.bf16_wrapper(k2_local)


# --------------------------------------------------------------- helpers


def new_state(kc, step, y0, max_iterations):
    """The rank's kernel state (``apg_stream._state`` on the block): on
    the CPU the same tensors, zero where the kernels would leave them
    unset."""
    st = S._state(kc, step, y0, max_iterations)
    if kc["sq"].device.type == "cpu":
        for k in ("v", "x", "u", "carry"):
            st[k].zero_()
    return st


def set_scalars(state, kc, it, k1f, k2f):
    """``sc`` = (lam_prev, lam_i, upd, k1f, k2f) of iteration ``it``, on the
    device (the single-device kernel's scalar phase)."""
    lams = kc["lams"]
    upd = lams[0] * 0.0 + (1.0 if it > 0 else 0.0)
    state["sc"].copy_(torch.stack([lams[max(it - 1, 0)], lams[it], upd,
                                   k1f, k2f]))


def champions(cparts: torch.Tensor) -> torch.Tensor:
    """The signed champion of each row of all-reduced [hi_x, -lo_x, hi_u,
    -lo_u]: hi if hi > -lo else lo, per block, then the larger."""
    vx = torch.where(cparts[:, 0] > cparts[:, 1], cparts[:, 0],
                     -cparts[:, 1])
    vp = torch.where(cparts[:, 2] > cparts[:, 3], cparts[:, 2],
                     -cparts[:, 3])
    return torch.maximum(vx, vp)


def for_max(ext: torch.Tensor) -> torch.Tensor:
    """[hi_x, lo_x, hi_u, lo_u] as [hi_x, -lo_x, hi_u, -lo_u], so that one
    MAX all-reduce gives the global extrema of all four."""
    return ext * ext.new_tensor([1.0, -1.0, 1.0, -1.0])


def root_control(kc, u_local, mesh):
    """The stage-0 control: rank 0's root slot, summed from masked values
    (:696-700), projected on the physical bounds."""
    u0 = u_local[0, 0]
    if mesh.axis_index() != 0:
        u0 = torch.zeros_like(u0)
    lo, hi = ss.root_control_bounds(kc["root"])
    return torch.clamp(mesh.psum(u0), lo, hi)


def check_mesh(mesh, fa):
    """The mesh's device must be the factors'."""
    if fa["d1"].device != mesh.device:
        raise ValueError(f"the factors are on {fa['d1'].device}, the mesh's "
                         f"device is {mesh.device}")


def check_consts(mesh, kc: dict) -> None:
    """Constants handed to a sharded solve must be this rank's
    ``pack_stream_sharded``, not the single-device pack."""
    if (kc.get("n_shards"), kc.get("rank")) != (mesh.size, mesh.rank):
        raise ValueError("consts on a mesh are packed per shard: pass "
                         "this rank's pack_stream_sharded(fa, mesh.size, "
                         "mesh.rank, ...)")


# ---------------------------------------------------------------- solve


def make_apg_stream_sharded(mesh, fa: dict, *, prefix_stages: tuple,
                            inv_step, step_size, penalty_state,
                            penalty_safety, xs_upper, max_iterations,
                            tolerance=None, consts=None,
                            precision="highest"):
    """The streaming APG solve over a 1-D scenario mesh (``make_apg_
    stream_sharded``, :217-793): run(step, y0=None), collective, every
    rank calling it with the same global step.  Same output contract as
    ``apg_stream.make_apg_stream_kernel``; x, u, v and y come back in the
    global layout on every rank.  ``consts``: this rank's
    ``pack_stream_sharded`` when the caller already packed it (the
    controller's gate).  ``precision``: the kernels' products, "highest"
    or "default" (module docstring); any other raises."""
    S.check_precision(precision)
    S._check_budget(max_iterations, tolerance)
    check_mesh(mesh, fa)
    K = int(max_iterations)
    if consts is not None:
        check_consts(mesh, consts)
    kc = consts if consts is not None else pack_stream_sharded(
        fa, mesh.size, mesh.rank, prefix_stages=prefix_stages,
        max_iterations=K)
    hyper = dict(inv_step=inv_step, step_size=step_size,
                 penalty_state=penalty_state, penalty_safety=penalty_safety,
                 xs_upper=xs_upper, max_iterations=K)
    c, t1c, t2c = S._hyper(inv_step, penalty_state, penalty_safety)
    dev = mesh.device

    def run(step, y0=None):
        stl = shard_step(kc, step)
        y0l = None if y0 is None else {k: mesh.shard(y0[k]) for k in y0}
        S._check_inputs(kc, stl, y0l, K, precision)
        state = new_state(kc, stl, y0l, K)
        k1f = k2f = torch.zeros((), device=dev)
        cparts = torch.empty(K + 1, 4, device=dev)
        for it in range(K):
            set_scalars(state, kc, it, k1f, k2f)
            ext, parents = k1a_call(kc, stl, state, precision, **hyper)
            tail = low_tail(kc, stl, state, mesh.psum(parents), mesh,
                            **hyper)
            cparts[it] = for_max(_merge(ext, tail))
            d = mesh.psum(k2_local(kc, stl, state, precision, **hyper))
            k1f, k2f = S._shrink(d[0], t1c), S._shrink(d[1], t2c)
        # the final dual update (the tail), shard-local
        lam = kc["lams"][K - 1]
        y = {"xi": state["y_xi"], "psi": state["y_psi"]}
        w = {k: y[k] + lam * state[f"z_{k}"] for k in y}
        pre = {"xi": state["pre_xi"], "psi": state["pre_psi"]}
        r_xi, r_psi = S._residuals(kc, pre, w, k1f, k2f, c, xs_upper)
        y_f = {"xi": w["xi"] + step_size * r_xi,
               "psi": w["psi"] + step_size * r_psi}
        cparts[K] = for_max(_extrema(r_xi, r_psi))
        trace = champions(mesh.pmax(cparts))[1:]
        return {"control": root_control(kc, state["u"], mesh),
                "x": mesh.all_gather(state["x"]),
                "u": mesh.all_gather(state["u"]),
                "v": mesh.all_gather(state["v"]),
                "y": {k: mesh.all_gather(y_f[k]) for k in y_f},
                "primal_infeasibility": trace,
                "iterations": torch.tensor(K, dtype=torch.int32,
                                           device=dev)}

    run.consts = kc
    return run
