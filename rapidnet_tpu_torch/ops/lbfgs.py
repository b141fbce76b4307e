"""The L-BFGS history passes: their wrappers, plain versions and counts.

Counterpart of ``rapidnet_tpu/ops/pallas_lbfgs.py``
(``make_lbfgs_kernels``).  The kernels are ``csrc/lbfgs.cu``, CUDA C++
for sm_90a, built on first use by ``ops/build.py``.  The Gram-form
L-BFGS of the streaming FBE/NAMA solve (``solver/qn_stream.py``) touches
its s/y history twice an iteration:

* ``dots``: every column's rep-weighted dots with [s, yv, g] (the new
  pair and the gradient) and the six self-dots <s,s>, <s,yv>, <yv,yv>,
  <g,g>, <s,g>, <yv,g>, in one pass over both histories;
* ``combine``: the direction sum_m cs_m s_m + sum_m cy_m y_m + cg g, in
  one pass.

Layout: a history is (M, N, ns, D), M = buffer size + 1 columns of the
dual triple's (N, ns, D) layout (``ops/stream_qn.py``), stored in
float32 or bfloat16; ``s`` and ``yv`` are in the storage type, ``g`` and
the direction in float32, ``rep`` (N, ns) weights each row (a tree node
once).  The plain versions widen the same stored values to float32.
The TPU kernel's self-dot output has 8 slots of which 6 are used
(``pallas_lbfgs.py:134``); here it has 6.

``dots`` and ``combine`` are the wrappers: CPU tensors run
``dots_plain`` and ``combine_plain``; CUDA tensors launch the kernels or
raise.  ``dots.launches`` and ``combine.launches`` count their launches.
The bfloat16 dots run a vector body (16-byte loads) where the source's
rule takes it, D and E multiples of 8 and every operand 16-byte aligned,
and the one-value body otherwise; ``vector_path`` asks the source.
"""

from __future__ import annotations

import ctypes

import torch

from rapidnet_tpu_torch.ops import build

MAX_COLS = 16            # csrc/lbfgs.cu: buffer sizes up to 15
STORAGE = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------- plain


def dots_plain(rep, mat_s, mat_y, s, yv, g):
    """One dot pass in plain PyTorch (pallas_lbfgs.py:72-121).  Returns
    dS (M, 3) = <s_m, [s, yv, g]>, dY (M, 3) likewise for y_m, and the six
    self-dots, all rep-weighted and float32."""
    r = rep[..., None]
    sf, yf = s.float(), yv.float()
    ts, ty, tg = r * sf, r * yf, r * g
    rhs = torch.stack([ts, ty, tg]).reshape(3, -1).T        # (E, 3)
    M = mat_s.shape[0]
    dS = mat_s.float().reshape(M, -1) @ rhs
    dY = mat_y.float().reshape(M, -1) @ rhs
    selfd = torch.stack([torch.sum(ts * sf), torch.sum(ts * yf),
                         torch.sum(ty * yf), torch.sum(tg * g),
                         torch.sum(ts * g), torch.sum(ty * g)])
    return dS, dY, selfd


def combine_plain(coef, mat_s, mat_y, g):
    """One combine pass in plain PyTorch (pallas_lbfgs.py:150-160):
    coef[2M] g + sum_m (coef[m] s_m + coef[M + m] y_m), float32."""
    M = mat_s.shape[0]
    out = coef[2 * M] * g
    for m in range(M):
        out = out + (coef[m] * mat_s[m].float() +
                     coef[M + m] * mat_y[m].float())
    return out


# -------------------------------------------------------------- wrappers


def _check(name, t, shape, device, dtypes):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                         f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_history(mat_s, mat_y, g):
    """The histories' and g's devices, types and shapes; returns (device,
    storage type, M, E)."""
    if mat_s.dim() != 4:
        raise ValueError(f"mat_s: shape {tuple(mat_s.shape)}, expected "
                         "(M, N, ns, D)")
    dev, nb = mat_s.device, mat_s.dtype
    if nb not in STORAGE:
        raise ValueError(f"history dtype {nb}, the kernels take {STORAGE}")
    M = mat_s.shape[0]
    if not 1 <= M <= MAX_COLS:
        raise ValueError(f"{M} history columns; the kernels take 1 to "
                         f"{MAX_COLS}")
    _check("mat_s", mat_s, mat_s.shape, dev, (nb,))
    _check("mat_y", mat_y, mat_s.shape, dev, (nb,))
    _check("g", g, mat_s.shape[1:], dev, (torch.float32,))
    E = g.numel()
    if E >= 2 ** 31:
        raise ValueError(f"{E} values per column; the kernels take < 2^31")
    return dev, nb, M, E


def _lib():
    lib = build.load("lbfgs")
    if lib.lbfgs_dots.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lbfgs_dots.argtypes = [ptr] * 10 + [i64, i32, i32, i32, ptr]
        lib.lbfgs_dots.restype = i32
        lib.lbfgs_combine.argtypes = [ptr] * 5 + [i64, i32, i32, ptr]
        lib.lbfgs_combine.restype = i32
        lib.lbfgs_dot_blocks.restype = i32
        lib.lbfgs_max_cols.restype = i32
        lib.lbfgs_error_string.argtypes = [i32]
        lib.lbfgs_error_string.restype = ctypes.c_char_p
        if lib.lbfgs_max_cols() != MAX_COLS:
            raise RuntimeError("csrc/lbfgs.cu's MAX_COLS differs from "
                               "ops/lbfgs.MAX_COLS")
    return lib


def _raise(lib, err, what):
    if err != 0:
        msg = lib.lbfgs_error_string(err).decode()
        raise RuntimeError(f"lbfgs {what} kernel failed: error {err} ({msg})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def dots(rep, mat_s, mat_y, s, yv, g):
    """One dot pass over both histories: (dS (M, 3), dY (M, 3), selfd
    (6,)), float32.  CPU tensors run ``dots_plain``; CUDA tensors launch
    the kernel."""
    dev, nb, M, E = _check_history(mat_s, mat_y, g)
    _check("s", s, g.shape, dev, (nb,))
    _check("yv", yv, g.shape, dev, (nb,))
    _check("rep", rep, g.shape[:2], dev, (torch.float32,))
    if dev.type == "cpu":
        return dots_plain(rep, mat_s, mat_y, s, yv, g)
    if dev.type != "cuda":
        raise ValueError(f"lbfgs.dots runs on cpu or cuda, not {dev.type}")
    lib = _lib()
    Q = 6 * M + 6
    part = torch.empty(lib.lbfgs_dot_blocks() * Q, dtype=torch.float32,
                       device=dev)
    out = torch.empty(6 * M + 6, dtype=torch.float32, device=dev)
    dS, dY, selfd = out[:3 * M], out[3 * M:6 * M], out[6 * M:]
    dots.launches += 1
    with torch.cuda.device(dev):
        err = lib.lbfgs_dots(rep.data_ptr(), mat_s.data_ptr(),
                             mat_y.data_ptr(), s.data_ptr(), yv.data_ptr(),
                             g.data_ptr(), part.data_ptr(), dS.data_ptr(),
                             dY.data_ptr(), selfd.data_ptr(), E,
                             g.shape[-1], M, int(nb == torch.bfloat16),
                             _stream(dev))
    _raise(lib, err, "dots")
    return dS.view(M, 3), dY.view(M, 3), selfd


dots.launches = 0


def vector_path(mat_s, mat_y, s, yv, g) -> bool:
    """Whether ``dots`` takes the vector body on these CUDA operands:
    the source's own rule (``lbfgs_dots_vector``), from the shapes,
    the storage type and the pointers."""
    dev, nb, M, E = _check_history(mat_s, mat_y, g)
    if dev.type != "cuda":
        raise ValueError(f"vector_path asks the CUDA source; the operands "
                         f"are on {dev}")
    fn = _lib().lbfgs_dots_vector
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int]
    fn.restype = ctypes.c_int
    return bool(fn(mat_s.data_ptr(), mat_y.data_ptr(), s.data_ptr(),
                   yv.data_ptr(), g.data_ptr(), E, g.shape[-1],
                   int(nb == torch.bfloat16)))


def combine(coef, mat_s, mat_y, g):
    """One combine pass: the float32 direction (N, ns, D).  CPU tensors
    run ``combine_plain``; CUDA tensors launch the kernel."""
    dev, nb, M, E = _check_history(mat_s, mat_y, g)
    _check("coef", coef, (2 * M + 1,), dev, (torch.float32,))
    if dev.type == "cpu":
        return combine_plain(coef, mat_s, mat_y, g)
    if dev.type != "cuda":
        raise ValueError(f"lbfgs.combine runs on cpu or cuda, not "
                         f"{dev.type}")
    lib = _lib()
    out = torch.empty_like(g)
    combine.launches += 1
    with torch.cuda.device(dev):
        err = lib.lbfgs_combine(coef.data_ptr(), mat_s.data_ptr(),
                                mat_y.data_ptr(), g.data_ptr(),
                                out.data_ptr(), E, M,
                                int(nb == torch.bfloat16), _stream(dev))
    _raise(lib, err, "combine")
    return out


combine.launches = 0
