"""Pinhole camera model (port of `eggfusion_tpu/geometry/camera.py`).

`CameraIntrinsics` is a hashable NamedTuple of Python floats; `as_tensor`
puts (fx, fy, cx, cy) on a device, `on_device` keeps that tensor for reuse.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def fovx(self) -> float:
        return focal2fov(self.fx, self.width)

    @property
    def fovy(self) -> float:
        return focal2fov(self.fy, self.height)

    @classmethod
    def from_calibration(cls, calib) -> "CameraIntrinsics":
        """The intrinsics of a config's `Dataset.Calibration` section."""
        return cls(fx=float(calib.fx), fy=float(calib.fy), cx=float(calib.cx), cy=float(calib.cy),
                   width=int(calib.width), height=int(calib.height))

    def scaled(self, factor: float) -> "CameraIntrinsics":
        """Intrinsics of a pyramid level downsampled by `factor` (e.g. 2**l)."""
        return CameraIntrinsics(
            fx=self.fx / factor,
            fy=self.fy / factor,
            cx=self.cx / factor,
            cy=self.cy / factor,
            width=int(self.width // factor),
            height=int(self.height // factor),
        )

    def as_tensor(self, device=None, dtype=torch.float32) -> torch.Tensor:
        """(fx, fy, cx, cy) as a tensor on `device`."""
        return torch.tensor([self.fx, self.fy, self.cx, self.cy], dtype=dtype, device=device)

    def on_device(self, device) -> torch.Tensor:
        """`as_tensor(device)` made once per intrinsics and device, and
        shared by every caller after: a frame's intrinsics cost no upload.
        Read-only: no caller writes into it."""
        return _on_device(self, torch.device(device))


@functools.lru_cache(maxsize=64)
def _on_device(intr: CameraIntrinsics, device: torch.device) -> torch.Tensor:
    return intr.as_tensor(device)
