"""Model checkpoint/resume (port of flashe_tpu/runtime/checkpoint.py).

Reference scope (enter_point.py:202-216, 262-269): export the model weights
plus meta including `aggregate_iter`; restore resumes the federation loop
from that iteration.  Cipher state (PRP seed) is per-job and deliberately
not checkpointed, as in the reference.  The optimizer state and the
quantizer's running layer statistics are saved too, so a resumed job
quantizes identically to an uninterrupted one.

The port's own format, not flax serialization: a pickle of numpy arrays,
the parameters keyed by flax path name in the flax layout, the optimizer's
state_dict with its tensors as numpy.  A file written on the card loads on
the CPU and back.  It does not read a JAX package checkpoint, whose
parameters are one flax-serialized byte string: `read_blob` names such a
file as what it is rather than failing later inside a load.  Load only
files this program wrote: unpickling runs code.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "read_blob"]


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_torch(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def save_checkpoint(path: str, params, aggregate_iter: int,
                    opt_state=None,
                    quantizer_stats: Dict[str, Any] | None = None):
    """params: {flax path name: tensor or array}; opt_state: an
    optimizer's state_dict."""
    blob = {
        "params": {k: np.asarray(_to_numpy(v)) for k, v in params.items()},
        "aggregate_iter": aggregate_iter,
        "opt_state": None if opt_state is None else _to_numpy(opt_state),
        "quantizer_stats": {
            k: np.asarray(_to_numpy(v))
            for k, v in (quantizer_stats or {}).items()
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f)
    os.replace(tmp, path)


def read_blob(path: str) -> dict:
    """The unpickled checkpoint file, checked to be the port's format."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not isinstance(blob, dict) or "aggregate_iter" not in blob:
        raise ValueError(f"{path} is not a flashe checkpoint")
    if not isinstance(blob.get("params"), dict):
        raise ValueError(
            f"{path} is a JAX package (flashe_tpu) checkpoint: its "
            "parameters are flax-serialized bytes, which flashe_tpu_torch "
            "does not read; it loads only checkpoints that flashe_tpu_torch "
            "wrote")
    return blob


def load_checkpoint(path: str) -> dict:
    """-> {"params": {name: np.ndarray}, "aggregate_iter", "opt_state" (a
    state_dict with torch tensors, for Optimizer.load_state_dict, or None),
    "quantizer_stats": {name: np.ndarray}}."""
    blob = read_blob(path)
    return {
        "params": blob["params"],
        "aggregate_iter": blob["aggregate_iter"],
        "opt_state": None if blob.get("opt_state") is None
        else _to_torch(blob["opt_state"]),
        "quantizer_stats": blob.get("quantizer_stats", {}),
    }
