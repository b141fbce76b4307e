"""The streaming oracle sweeps S1/S2: their wrappers, plain versions, counts.

Counterpart of ``rapidnet_tpu/ops/pallas_stream_qn.py``
(``make_stream_sweeps``).  The kernels are ``csrc/stream_qn.cu``, CUDA
C++ for sm_90a, built on first use by ``ops/build.py``.  They are the
bare tree oracle that the streaming FBE/NAMA solve
(``solver/qn_stream.py``) calls three times an iteration, on trees past
the whole-solve QN kernel's shared-memory limits (``qn_solve.fits``):

* S1, backward over the stages: the dual triple w -> v, the backward
  recursion t = d1 w1 + d2 w2 + t, inner = a + Bb t + L'(g wp) [+ beta],
  v = nhp iW inner, with the child -> parent handoff at the prefix
  stages;
* S2, forward: v -> x, u and the primal images p1 = d1 x, p2 = d2 x,
  pp = g u, with du = du + L v, u = du [+ uhat], x = x + B u [+ e] from
  du = pdu and x = x0 (or zero).

``affine=True`` is the solve step (the bracketed terms and the start);
``affine=False`` is the Hessian oracle, which reads none of them.

Layout: unpadded, stage-major (N, ns, d) rows.  The dual triple is one
tensor (N, ns, D), D = 2 nx + nu, [w1 | w2 | wp] per row (so ``xi`` of
the XLA path is its first 2 nx columns and ``psi`` the rest), and so are
the images [p1 | p2 | pp].  The constants are those of the streaming APG
kernels (``apg_stream.stream_constants``: the rank-1 rows, the matrices
and the prefix handoffs as index lists, the stage ranges).

``s1_call`` and ``s2_call`` are the wrappers: on CPU tensors they run
``s1_plain`` and ``s2_plain``; on CUDA tensors they launch the kernels or
raise.  ``s1_call.launches`` and ``s2_call.launches`` count the passes
they launched (S1 launches one kernel per range of stages).  Each kernel
has two variants of the same stage bodies, which the source's C entry
picks from the sizes and the device: staged (the shared matrices and
each stage's operands copied into shared memory by the copy engine, a
stage ahead) where that fits, else unstaged (read from device memory).
``stream_fits`` is the unstaged variants' limit and ``staged`` reads the
pick and the staged variants' shared memory from the source.
``sweep_spans`` runs one S1 and one S2 pass of the instrumented build
(``CLOCK_DEFINES``) and reads the SM cycles of each part of a block's
stage.  Their times on an H100 are in PERF.md section 6 (chip_smoke.py
phases 22 and 27, profile_solve.py --stream --spans --algorithm fbe).

On a scenario mesh (``make_sharded_sweeps`` of
``rapidnet_tpu/ops/pallas_stream_sharded.py``, :799-1029) each rank runs
the sweeps on its block of slots with the shard's constants
(``apg_stream_sharded.pack_stream_sharded``): S2 is ``s2_call`` on the
block; the backward sweep is ``s1a_call``, S1 (mode 1) over stages
N-1 .. s_hi with the handoffs numbered within the shard, the partial
parent block of stage s_hi (``apg_stream_sharded.partial_parents``),
one all-reduce of it, and the root-side stages s_hi-1 .. 0 in PyTorch
with no dual update (:978-1004).  ``s1a_plain`` is the same with the
plain halves.
"""

from __future__ import annotations

import ctypes

import torch

from rapidnet_tpu_torch.ops import apg_stream as S
from rapidnet_tpu_torch.ops import apg_stream_sharded as SS
from rapidnet_tpu_torch.ops import build

TILE = 8                 # scenario slots per block (csrc/stream_qn.cu)
CONST_KEYS = ("cx1", "cx2", "cu", "sq", "nhp", "L", "BbT", "iWT", "LT",
              "BT") + S.INDEX_KEYS
# the instrumented build (csrc/stream_qn.cu's Part, in its order): the
# parts of a block's S1 and S2 stage whose SM cycles ``sweep_spans`` reads
CLOCK_DEFINES = ("STREAM_QN_CLOCK",)
SPAN_PARTS = ("s1_start", "s1_wait", "s1_pass", "BbT", "L", "iWT", "s1_end",
              "s2_start", "s2_wait", "s2_load", "LT", "BT", "images")


def smem(N: int, ns: int, nx: int, nu: int, nv: int) -> int:
    """The most shared memory (bytes) a launch at these sizes asks for,
    the larger of the S1 and S2 tiles (``stream_qn_smem`` in the source,
    checked at every launch)."""
    return 4 * TILE * max(nx + nv + nu, 2 * nu + nx + nv)


def stream_fits(N: int, ns: int, nx: int, nu: int, nv: int,
                smem_limit: int | None = None) -> bool:
    """Whether S1/S2 take a tree of these sizes: their unstaged tiles'
    shared memory within ``smem_limit`` (default: the current CUDA
    device's opt-in limit per block).  A launch takes the staged variant
    only where its larger shared memory fits, so this refuses no tree
    either variant takes."""
    return ns >= 1 and N >= 1 and \
        smem(N, ns, nx, nu, nv) <= build.smem_optin(smem_limit)


def staged(N: int, ns: int, nx: int, nu: int, nv: int) -> dict:
    """Which variant S1 and S2 take at these sizes on the current CUDA
    device, as the source's C entry chooses it (``stream_qn_staged``),
    and the staged variants' dynamic shared memory in bytes
    (``stream_qn_staged_smem``): {"s1": bool, "s2": bool, "s1_smem": int,
    "s2_smem": int}."""
    lib = build.load("stream_qn")
    pick = lib.stream_qn_staged
    pick.argtypes = [ctypes.c_int] * 5
    pick.restype = ctypes.c_int
    size = lib.stream_qn_staged_smem
    size.argtypes = [ctypes.c_int] * 6
    size.restype = ctypes.c_longlong
    mask = pick(N, ns, nx, nu, nv)
    if mask < 0:
        raise RuntimeError(f"stream_qn_staged failed: error {-mask}")
    return {"s1": bool(mask & 1), "s2": bool(mask & 2),
            "s1_smem": size(N, ns, nx, nu, nv, 0),
            "s2_smem": size(N, ns, nx, nu, nv, 1)}


def dims(kc) -> tuple:
    """(N, ns, nx, nu, nv) of the streaming constants."""
    return S._dims(kc)


# ---------------------------------------------------------------- plain


def s1_plain(kc, w, beta=None):
    """One S1 pass in plain PyTorch (pallas_stream_qn.py:79-126): the dual
    triple ``w`` (N, ns, D) -> v (N, ns, nv); ``beta`` (N, ns, nv) for the
    solve step, None for the Hessian oracle."""
    fa = kc["fa"]
    nx = kc["cx1"].shape[-1]
    tb = (S._rows(kc, "cx1") * w[..., :nx] +
          S._rows(kc, "cx2") * w[..., nx:2 * nx])
    gw = S._rows(kc, "cu") * w[..., 2 * nx:]
    BbT, L = kc["BbT"], kc["L"]
    N = tb.shape[0]
    q = torch.zeros_like(tb[0])
    r = w.new_zeros(w.shape[1], BbT.shape[1])
    inner = []
    for s in range(N - 1, -1, -1):
        q = tb[s] + q
        r = r + q @ BbT + gw[s] @ L
        if beta is not None:
            r = r + beta[s]
        inner.append(r)
        if s in kc["agg_stages"]:
            Cp, Bp = fa["prefix_Cp"][s], fa["prefix_Bp"][s]
            q = Bp @ (Cp @ q)
            r = Bp @ (Cp @ r)
    inner = torch.stack(inner[::-1])
    return kc["nhp"][..., None] * (inner @ kc["iWT"])


def s2_plain(kc, v, uhat=None, e=None, x0=None, pdu=None):
    """One S2 pass in plain PyTorch (pallas_stream_qn.py:129-166): v ->
    (x, u, images (N, ns, D)); ``uhat``, ``e``, ``x0`` and ``pdu`` for the
    solve step, all None for the Hessian oracle."""
    affine = uhat is not None
    ns = v.shape[1]
    nx = kc["cx1"].shape[-1]
    nu = kc["cu"].shape[-1]
    dv = v @ kc["LT"]
    du = pdu.expand(ns, -1) if affine else v.new_zeros(ns, nu)
    xs = x0.expand(ns, -1) if affine else v.new_zeros(ns, nx)
    x, u = [], []
    for s in range(v.shape[0]):
        du = du + dv[s]
        u_s = uhat[s] + du if affine else du
        xs = xs + u_s @ kc["BT"]
        if affine:
            xs = xs + e[s]
        x.append(xs)
        u.append(u_s)
    x, u = torch.stack(x), torch.stack(u)
    images = torch.cat([S._rows(kc, "cx1") * x, S._rows(kc, "cx2") * x,
                        S._rows(kc, "cu") * u], dim=-1)
    return x, u, images


# -------------------------------------------------------------- wrappers


def _check_consts(kc):
    """The constants' devices, types and shapes; returns the device."""
    N, ns, nx, nu, nv = dims(kc)
    dev = kc["sq"].device
    shapes = {"cx1": (N, nx), "cx2": (N, nx), "cu": (N, nu), "sq": (N, ns),
              "nhp": (N, ns), "L": (nu, nv), "BbT": (nx, nv),
              "iWT": (nv, nv), "LT": (nv, nu), "BT": (nu, nx)}
    for k, shp in shapes.items():
        S._check(k, kc[k], shp, dev)
    for k in S.INDEX_KEYS:
        S._check(k, kc[k], tuple(kc[k].shape), dev, torch.int32)
    return dev


def _entry(lib):
    """The C entry ``stream_qn``, declared."""
    fn = lib.stream_qn
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 24 + [i32] * 5 + [ptr, i32, i32, i32, ptr]
        fn.restype = i32
        lib.stream_qn_tile.restype = i32
        lib.stream_qn_error_string.argtypes = [i32]
        lib.stream_qn_error_string.restype = ctypes.c_char_p
        if lib.stream_qn_tile() != TILE:
            raise RuntimeError("csrc/stream_qn.cu's tile differs from "
                               "ops/stream_qn.TILE")
    return fn


def _launch(kc, mode, affine, *, w=None, v, x=None, u=None, pr=None,
            beta=None, uhat=None, e=None, x0=None, pdu=None, carry=None,
            lib=None):
    """Enqueue one S1 (mode 1) or S2 (mode 2) pass on the current stream
    of the constants' device; S1's two carry buffers are ``carry`` (2, ns,
    nx + nv) when given.  ``lib``: the library to launch (default: the
    checkout's).  Raises on a refused launch."""
    N, ns, nx, nu, nv = dims(kc)
    if not stream_fits(N, ns, nx, nu, nv):
        raise ValueError(f"the streaming sweeps do not take this tree (N {N},"
                         f" ns {ns}, nx {nx}, nu {nu}, nv {nv})")
    dev = kc["sq"].device
    lib = lib if lib is not None else build.load("stream_qn")
    fn = _entry(lib)
    build.check_smem(lib, "stream_qn", (N, ns, nx, nu, nv),
                     smem(N, ns, nx, nu, nv))
    if mode == 1 and carry is None:
        carry = torch.empty((2, ns, nx + nv), dtype=torch.float32,
                            device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    flat = [r for rng in kc["ranges"] for r in rng]
    ranges = (ctypes.c_int * len(flat))(*flat)
    args = ([ptr(kc[k]) for k in CONST_KEYS] +
            [ptr(t) for t in (beta, uhat, e, x0, pdu, w, v, x, u, pr, carry)])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, N, ns, nx, nu, nv, ranges, len(kc["ranges"]),
                 int(affine), mode, stream)
    if err != 0:
        msg = lib.stream_qn_error_string(err).decode()
        raise RuntimeError(f"stream_qn kernel failed: error {err} ({msg})")


def s1_call(kc, w, beta=None):
    """One S1 pass: ``w`` (N, ns, D) -> v (N, ns, nv); ``beta`` for the
    solve step (affine), None for the Hessian oracle.  CPU tensors run
    ``s1_plain``; CUDA tensors launch the kernel."""
    N, ns, nx, nu, nv = dims(kc)
    dev = _check_consts(kc)
    S._check("w", w, (N, ns, 2 * nx + nu), dev)
    if beta is not None:
        S._check("beta", beta, (N, ns, nv), dev)
    if dev.type == "cpu":
        return s1_plain(kc, w, beta)
    if dev.type != "cuda":
        raise ValueError(f"s1_call runs on cpu or cuda, not {dev.type}")
    v = torch.empty((N, ns, nv), dtype=torch.float32, device=dev)
    s1_call.launches += 1
    _launch(kc, 1, beta is not None, w=w, v=v, beta=beta)
    return v


s1_call.launches = 0


def s2_call(kc, v, uhat=None, e=None, x0=None, pdu=None):
    """One S2 pass: v -> (x, u, images); ``uhat``, ``e``, ``x0``, ``pdu``
    for the solve step (all or none).  CPU tensors run ``s2_plain``; CUDA
    tensors launch the kernel."""
    N, ns, nx, nu, nv = dims(kc)
    dev = _check_consts(kc)
    S._check("v", v, (N, ns, nv), dev)
    affine = [t is not None for t in (uhat, e, x0, pdu)]
    if any(affine) and not all(affine):
        raise ValueError("s2_call takes uhat, e, x0 and pdu together")
    if affine[0]:
        for k, t, shp in (("uhat", uhat, (N, ns, nu)), ("e", e, (N, ns, nx)),
                          ("x0", x0, (nx,)), ("pdu", pdu, (nu,))):
            S._check(k, t, shp, dev)
    if dev.type == "cpu":
        return s2_plain(kc, v, uhat, e, x0, pdu)
    if dev.type != "cuda":
        raise ValueError(f"s2_call runs on cpu or cuda, not {dev.type}")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    x, u, pr = empty(N, ns, nx), empty(N, ns, nu), empty(N, ns, 2 * nx + nu)
    s2_call.launches += 1
    _launch(kc, 2, affine[0], v=v, x=x, u=u, pr=pr, uhat=uhat, e=e, x0=x0,
            pdu=pdu)
    return x, u, pr


s2_call.launches = 0


def sweep_spans(kc, w, beta=None, uhat=None, e=None, x0=None, pdu=None):
    """One S1 pass (``w`` -> v) and one S2 pass from its v, of the
    instrumented build (``CLOCK_DEFINES``) on CUDA tensors: the solve
    step with ``beta`` and the S2 operands, the Hessian oracle without.
    Returns v, S2's (x, u, images) and, under "cycles", the SM cycles of
    each part of ``SPAN_PARTS`` summed over the blocks and the launches
    of its pass.  A measurement, not the product path: its marks add
    block barriers."""
    import numpy as np
    N, ns, nx, nu, nv = dims(kc)
    dev = kc["sq"].device
    lib = build.load("stream_qn", CLOCK_DEFINES)
    lib.stream_qn_spans.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.stream_qn_spans.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * len(SPAN_PARTS))()

    def read():
        err = lib.stream_qn_spans(buf)
        if err != 0:
            raise RuntimeError(f"stream_qn_spans failed: error {err}")
        return np.array(buf[:], dtype=np.int64)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    read()                               # zeroes what came before
    v = empty(N, ns, nv)
    _launch(kc, 1, beta is not None, w=w, v=v, beta=beta, lib=lib)
    x, u, pr = empty(N, ns, nx), empty(N, ns, nu), empty(N, ns, 2 * nx + nu)
    _launch(kc, 2, uhat is not None, v=v, x=x, u=u, pr=pr, uhat=uhat, e=e,
            x0=x0, pdu=pdu, lib=lib)
    return {"v": v, "s2": (x, u, pr),
            "cycles": dict(zip(SPAN_PARTS, read().tolist()))}


# ------------------------------------------------------ sharded sweeps


def _s1_high_plain(kc, w, beta):
    """S1 over stages N-1 .. s_hi on the rank's block with the local
    handoffs, in plain PyTorch: (v, zero below s_hi; the exit carries
    [t | a] (nsl, nx + nv))."""
    fa = kc["fa"]
    nx = kc["cx1"].shape[-1]
    N, s_hi = w.shape[0], kc["s_hi"]
    tb = (S._rows(kc, "cx1") * w[..., :nx] +
          S._rows(kc, "cx2") * w[..., nx:2 * nx])
    gw = S._rows(kc, "cu") * w[..., 2 * nx:]
    BbT, L = kc["BbT"], kc["L"]
    q = torch.zeros_like(tb[0])
    r = w.new_zeros(w.shape[1], BbT.shape[1])
    v = w.new_zeros(N, w.shape[1], kc["iWT"].shape[0])
    for s in range(N - 1, s_hi - 1, -1):
        q = tb[s] + q
        r = r + q @ BbT + gw[s] @ L
        if beta is not None:
            r = r + beta[s]
        v[s] = kc["nhp"][s][:, None] * (r @ kc["iWT"])
        if s in kc["agg_stages"]:
            Cp, Bp = fa["prefix_Cp"][s], fa["prefix_Bp"][s]
            q = Bp @ (Cp @ q)
            r = Bp @ (Cp @ r)
    return v, torch.cat([q, r], dim=-1)


def _s1_low_tail(kc, w, v, parents, mesh, beta):
    """Stages s_hi-1 .. 0 of S1 on the rank's block from the all-reduced
    parents of stage s_hi, in place on ``v``, with the handoff of every
    lower cross stage all-reduced (:978-1004)."""
    nx = kc["cx1"].shape[-1]
    t, a = SS.spread_parents(kc, parents)
    for s in range(kc["s_hi"] - 1, -1, -1):
        sq = kc["sq"][s][:, None]
        t = (kc["cx1"][s] * sq) * w[s, :, :nx] + \
            (kc["cx2"][s] * sq) * w[s, :, nx:2 * nx] + t
        a = a + t @ kc["BbT"] + ((kc["cu"][s] * sq) * w[s, :, 2 * nx:]) @ \
            kc["L"]
        if beta is not None:
            a = a + beta[s]
        v[s] = kc["nhp"][s][:, None] * (a @ kc["iWT"])
        if s > 0 and s in kc["low"]:
            t, a = SS.low_handoff(kc, s, t, a, mesh)
    return v


def _check_shard(kc, w, beta):
    N, ns, nx, nu, nv = dims(kc)
    dev = _check_consts(kc)
    S._check("w", w, (N, ns, 2 * nx + nu), dev)
    if beta is not None:
        S._check("beta", beta, (N, ns, nv), dev)
    return dev


def s1a_plain(kc, w, mesh, beta=None):
    """One sharded backward sweep with the plain halves: the rank's block
    of the dual triple ``w`` -> its block of v.  Collective."""
    _check_shard(kc, w, beta)
    v, carry = _s1_high_plain(kc, w, beta)
    parents = mesh.psum(SS.partial_parents_plain(kc, carry))
    return _s1_low_tail(kc, w, v, parents, mesh, beta)


def s1a_call(kc, w, mesh, beta=None):
    """One sharded backward sweep (``make_sharded_sweeps``' backward):
    on CPU tensors ``s1a_plain``; on CUDA tensors S1 of
    ``csrc/stream_qn.cu`` over the shard's stage ranges and
    ``partial_parents`` on the carries of its last launch, then the
    all-reduce and the root-side stages.  Collective."""
    dev = _check_shard(kc, w, beta)
    if dev.type == "cpu":
        return s1a_plain(kc, w, mesh, beta)
    if dev.type != "cuda":
        raise ValueError(f"s1a_call runs on cpu or cuda, not {dev.type}")
    N, ns, nx, nu, nv = dims(kc)
    v = torch.empty((N, ns, nv), dtype=torch.float32, device=dev)
    carry = torch.empty((2, ns, nx + nv), dtype=torch.float32, device=dev)
    s1a_call.launches += 1
    _launch(kc, 1, beta is not None, w=w, v=v, beta=beta, carry=carry)
    last = carry[(len(kc["ranges"]) - 1) & 1]
    parents = mesh.psum(SS.partial_parents(kc, last))
    return _s1_low_tail(kc, w, v, parents, mesh, beta)


s1a_call.launches = 0
