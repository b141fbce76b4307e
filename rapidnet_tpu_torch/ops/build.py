"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/lib<name>_<hash>.so`` (the directory is ignored by git):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so <name>.cu

The hash covers the source and the flags, so an edited source is never
served from a stale library.  Nothing builds when this module is
imported: the first call of ``load`` for a name builds it, once per
checkout, and the library stays loaded for the life of the process.
``ptxas``'s report (registers, shared memory and spills per kernel) is
kept beside the library as ``lib<name>_<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return found


def _source(name: str, source=None) -> Path:
    return Path(source) if source is not None else CSRC_DIR / f"{name}.cu"


def _flags(defines: tuple) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, source=None, defines: tuple = ()) -> Path:
    src = _source(name, source).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, source=None, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (or the file ``source``), with the
    preprocessor macros ``defines`` set, unless its library exists;
    return it."""
    so = library_path(name, source, defines)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *_flags(defines), "-o", str(tmp),
           str(_source(name, source))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}:\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)      # atomic: a concurrent loader sees all or none
    return so


def smem_optin(smem_limit: int | None = None) -> int:
    """``smem_limit``, or the current CUDA device's opt-in shared memory
    per block (232,448 bytes on an H100): the most a launch may ask
    for."""
    if smem_limit is not None:
        return int(smem_limit)
    import torch
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).shared_memory_per_block_optin


def check_smem(lib: ctypes.CDLL, name: str, dims: tuple, need: int) -> None:
    """Raise when ``csrc/<name>.cu`` asks for other shared memory at
    ``dims`` (N, ns, nx, nu, nv) than ``need``, the routing gate's
    formula in ``ops/<name>.py``: one formula, held to the launch's own
    (``<name>_smem`` in the source) at every launch."""
    fn = getattr(lib, f"{name}_smem")
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    got = fn(*dims)
    if got != need:
        raise RuntimeError(f"csrc/{name}.cu asks for {got} bytes of shared "
                           f"memory at {dims}; ops/{name}.py's gate "
                           f"computes {need}")


@functools.cache
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` with ``defines``;
    cached per process."""
    return ctypes.CDLL(str(build(name, defines=defines)))
