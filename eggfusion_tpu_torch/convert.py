"""Surfel-map state to and from numpy.

This system has no model weights: the surfel map is its state. A map moves
between the JAX package and this port as a dict of numpy arrays named as
the fields of `eggfusion_tpu/core/surfels.py::SurfelMap` (transposed (k, C)
layout, `count` a 0-d int32 array). The round trip is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.core.surfels import FIELDS, SurfelMap

_DTYPES = {
    "observe_count": torch.int32, "tic": torch.int32, "error_count": torch.int32,
    "count": torch.int32, "stable": torch.bool, "active": torch.bool,
}


def surfel_map_from_numpy(fields: dict, device=None) -> SurfelMap:
    """Build a `SurfelMap` on `device` from a dict of numpy arrays."""
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise KeyError(f"surfel fields missing: {missing}")
    out = {}
    for f in FIELDS:
        dt = _DTYPES.get(f, torch.float32)
        out[f] = torch.as_tensor(np.array(fields[f]), device=device).to(dt)
    return SurfelMap(**out)


def surfel_map_to_numpy(s: SurfelMap) -> dict:
    """Dict of numpy arrays (host copies) of every SoA field."""
    return {f: getattr(s, f).detach().cpu().numpy() for f in FIELDS}
