"""rapidnet_tpu_torch — the scenario-tree stochastic MPC engine in PyTorch.

The port of ``rapidnet_tpu`` (JAX) to PyTorch and CUDA for one NVIDIA
H100.  The host layer (``model``, ``engine``, ``io``) is a NumPy copy of
the JAX package's, because importing any ``rapidnet_tpu`` module imports
JAX; tensors begin at the factor-array boundary (``convert``).  The
solver is plain PyTorch (``solver``), and three CUDA kernels written for
Hopper, built with nvcc on first use, run the solves on the card: the
whole APG solve (``ops/apg_solve.py``, ``csrc/apg_solve.cu``), the whole
FBE/NAMA solve (``ops/qn_solve.py``, ``csrc/qn_solve.cu``), each also
running B independent solves in one call for ``BatchedSmpcController``,
and, for trees past the whole-solve kernels' shared-memory limits, the
streaming APG iteration (``ops/apg_stream.py``, ``csrc/apg_stream.cu``:
two kernels an iteration, or one cooperative launch, the fused kernel
of the config ladder's fused row, ``bench_ladder.py``) and the
streaming FBE/NAMA solve (``solver/qn_stream.py``) over its oracle
sweeps (``ops/stream_qn.py``, ``csrc/stream_qn.cu``) and L-BFGS history
passes (``ops/lbfgs.py``, ``csrc/lbfgs.cu``).  Those streaming solves
also run scenario-sharded, one process per shard on torch.distributed
(``parallel/``, ``ops/apg_stream_sharded.py``, ``csrc/stream_sharded.cu``).

This package imports torch and never jax.
"""

__version__ = "0.1.0"

from rapidnet_tpu_torch.model.network import DwnNetwork
from rapidnet_tpu_torch.model.scenario_tree import ScenarioTree
from rapidnet_tpu_torch.model.forecaster import Forecaster
from rapidnet_tpu_torch.model.config import SmpcConfig
from rapidnet_tpu_torch.engine.engine import Engine
from rapidnet_tpu_torch.solver.controller import SmpcController
from rapidnet_tpu_torch.solver.batch import BatchedSmpcController

__all__ = [
    "DwnNetwork",
    "ScenarioTree",
    "Forecaster",
    "SmpcConfig",
    "Engine",
    "SmpcController",
    "BatchedSmpcController",
]
