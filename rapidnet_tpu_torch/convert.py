"""The boundary between the NumPy host layer and the solver's tensors.

Counterpart of ``_factor_arrays``/``_step_arrays`` in
``rapidnet_tpu/solver/controller.py`` and ``_stack`` in
``rapidnet_tpu/solver/batch.py``.  ``factor_arrays`` and
``step_arrays`` gather the host layer's outputs into plain dicts of
numpy arrays with the JAX package's keys; ``factor_tensors``,
``step_tensors``, ``stacked_step_tensors`` and ``shared_step_tensors``
turn such dicts (from either package) into float32 tensors on one
device, so the tests can feed both packages the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from rapidnet_tpu_torch.engine.engine import Engine, StepData

PREFIX_KEYS = ("prefix_C", "prefix_Cp", "prefix_Bp")
SHARED_BASE_KEYS = ("beta", "uhat", "e", "alpha_price")


def factor_arrays(engine: Engine) -> dict:
    """FactorData -> dict of numpy arrays (the JAX package's keys)."""
    fd = engine.factor_step()
    fa = {
        "L": fd.L, "B": fd.B, "Bb": fd.Bb, "invWbar": fd.invWbar,
        "d1": fd.d1, "d2": fd.d2, "g": fd.g,
        "nhp": fd.neg_half_over_prob, "prob": fd.prob, "rep": fd.rep,
        "xmin": fd.xmin, "xmax": fd.xmax, "xs": fd.xs,
        "umin": fd.umin, "umax": fd.umax,
        "prefix_C": dict(fd.prefix_C),
        "prefix_Cp": dict(fd.prefix_Cp),
        "prefix_Bp": dict(fd.prefix_Bp),
        # the FBE value's smoothing cost and its null-space image
        "Wv": engine.Wv, "alpha1": engine.network.alpha1,
        "W": engine.config.cost_w,
        # PHYSICAL control bounds for the final projection (see
        # solver/solve_step.root_control_bounds)
        "umin_phys": engine.network.umin, "umax_phys": engine.network.umax,
    }
    return fa


def step_arrays(step: StepData) -> dict:
    return {"beta": step.beta, "uhat": step.uhat, "e": step.e,
            "alpha_price": step.alpha_price,
            "x0": step.x0, "prev_u": step.prev_u,
            "prev_uhat": step.prev_uhat}


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def factor_tensors(fa_np: dict, device) -> dict:
    """Factor dict of numpy arrays -> float32 tensors on ``device``.

    The prefix aggregation dicts keep their integer stage keys.
    """
    out = {}
    for k, v in fa_np.items():
        if k in PREFIX_KEYS:
            out[k] = {int(s): _tensor(m, device) for s, m in v.items()}
        else:
            out[k] = _tensor(v, device)
    return out


def step_tensors(step_np: dict, device) -> dict:
    return {k: _tensor(v, device) for k, v in step_np.items()}


def stacked_step_tensors(steps_np, device) -> dict:
    """B step dicts of numpy arrays -> one dict of (B, ...) tensors (the
    JAX package's ``solver/batch.py::_stack``)."""
    return {k: _tensor(np.stack([s[k] for s in steps_np]), device)
            for k in steps_np[0]}


def shared_step_tensors(base_np: dict, inst_np: dict, device
                        ) -> tuple[dict, dict]:
    """``Engine.prepare_step_shared``'s ``(base, inst)`` -> tensors.

    ``base`` keeps the solver's fan arrays (beta, uhat, e and the FBE
    value's alpha_price: O(tree) bytes); ``inst`` the per-instance
    (B, ...) vectors x0, prev_u, prev_uhat and delta_beta0 (O(B nu)
    bytes).
    """
    return ({k: _tensor(base_np[k], device) for k in SHARED_BASE_KEYS},
            {k: _tensor(v, device) for k, v in inst_np.items()})
