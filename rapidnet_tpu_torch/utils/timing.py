"""Timing + profiling helpers.

The port's copy of ``rapidnet_tpu/utils/timing.py``.  Reference
counterpart: the cudaEvent tic/toc of src/Utilities.cu:428-471 (used by
main.cu:55-59 to log per-solve wall ms).  Here: host wall-clock around a
synchronise of the devices that hold the given CUDA tensors, and
``torch.profiler`` traces (Chrome trace format, one file per trace) for
kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class TicToc:
    """Host wall-clock timer with device synchronisation."""

    def __init__(self):
        self._t0 = None
        self.history_ms: list[float] = []

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, *sync_tensors) -> float:
        """Elapsed ms; first waits for the devices of the given CUDA
        tensors (a CPU tensor is ready when it is returned)."""
        for t in sync_tensors:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
        if self._t0 is None:
            raise RuntimeError("toc() called without tic()")
        ms = (time.perf_counter() - self._t0) * 1e3
        self.history_ms.append(ms)
        self._t0 = None
        return ms


@contextlib.contextmanager
def profile_trace(log_dir: str, name: str | None = None):
    """``torch.profiler`` trace context: CPU activity, and CUDA activity
    whenever a GPU is present.  Yields the profiler.  On exit, also when
    the body raises, it stops the profiler (waiting for the GPU first
    when the body returned) and writes a Chrome trace named ``name``
    (default ``trace_<pid>_<ns>.json``; open it in Perfetto or
    chrome://tracing) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, name or f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
