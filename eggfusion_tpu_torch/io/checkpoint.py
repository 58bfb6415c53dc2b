"""Full-state checkpoints for mid-run resume (port of
`eggfusion_tpu/io/checkpoint.py`).

One `.npz` holds every field of the surfel map as `surfel__<field>`, in the
transposed (k, C) layout both packages keep, and any extra arrays
(trajectory, frame clock) as `extra__<key>`; a file written by either
package loads in the other with every field bit-equal. The arrays pass
through `convert.py`.
"""
from __future__ import annotations

import os

import numpy as np

from eggfusion_tpu_torch.convert import surfel_map_from_numpy, surfel_map_to_numpy
from eggfusion_tpu_torch.core.surfels import FIELDS, SurfelMap


def save_checkpoint(path: str, surfels: SurfelMap, extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"surfel__{k}": v for k, v in surfel_map_to_numpy(surfels).items()}
    for k, v in (extra or {}).items():
        flat[f"extra__{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_checkpoint(path: str, device=None) -> tuple[SurfelMap, dict]:
    """(surfel map on `device`, extras as numpy arrays)."""
    fields, extra = {}, {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            if k.startswith("surfel__") and k[len("surfel__"):] in FIELDS:
                fields[k[len("surfel__"):]] = data[k]
            elif k.startswith("extra__"):
                extra[k[len("extra__"):]] = data[k]
    return surfel_map_from_numpy(fields, device), extra
