"""RGB-D datasets (port of `eggfusion_tpu/data/datasets.py`, the synthetic
part): `SyntheticDataset` and the synthetic case of `load_dataset`.

Frames are generated up front on the dataset's device. With
`Dataset.device_frames` they stay there as float color / metric depth;
otherwise they round-trip through uint8 color and host depth, as the JAX
dataset does. The buffered reader (`get_buffer_frame`) returns frames in
order from the calling thread.
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.data import synthetic as syn
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics


class SyntheticDataset:
    """Analytic corner-scene sequence with exact GT (see `data.synthetic`)."""

    def __init__(self, config, device):
        calib = config.Dataset.Calibration
        self.device = torch.device(device)
        self.intrinsics = CameraIntrinsics(
            fx=float(calib.fx), fy=float(calib.fy), cx=float(calib.cx), cy=float(calib.cy),
            width=int(calib.width), height=int(calib.height))
        ds = config.Dataset
        for key, default in (("trajectory", "sway"), ("scene", "corner")):
            if str(ds.get(key, default)) != default:
                raise NotImplementedError(f"Dataset.{key} {ds.get(key)!r} is not ported (only {default!r})")
        for key in ("noise", "texture_detail", "textureless_x", "lazy_device"):
            if ds.get(key):
                raise NotImplementedError(f"Dataset.{key} is not ported")
        n = int(ds.get("n_frames", 30))
        self.n_imgs = n
        self.poses = list(syn.make_trajectory(n))
        self.ts = list(np.arange(n) * 0.05)
        self.depth_scale = 1.0
        self._unique = min(n, int(ds.get("unique_frames", n)))
        self._device_frames = bool(ds.get("device_frames", False))
        self._frames = []
        for i in range(self._unique):
            color, depth = syn.render_corner_scene(self.intrinsics, self.poses[i], device=self.device)
            if self._device_frames:
                self._frames.append((color, depth))
            else:
                self._frames.append(((color.cpu().numpy() * 255).astype(np.uint8),
                                     depth.cpu().numpy()[..., 0]))
        shape = (self.intrinsics.height, self.intrinsics.width, 1)
        self._mask = (torch.ones(shape, device=self.device) if self._device_frames
                      else np.ones(shape, bool))
        self._next = 0

    def __len__(self) -> int:
        return self.n_imgs

    def __getitem__(self, idx: int):
        color, depth = self._frames[idx % self._unique]
        return self.ts[idx], color, depth, self._mask, self.poses[idx % self._unique]

    def get_buffer_frame(self):
        """The next frame in sequence order."""
        item = self[self._next]
        self._next += 1
        return item


def load_dataset(config, device):
    """Dataset factory; the port has the synthetic dataset only."""
    kind = config.Dataset.type
    if kind != "synthetic":
        raise NotImplementedError(f"dataset type {kind!r} is not ported (only 'synthetic')")
    ds = SyntheticDataset(config, device)
    ds.frame_nlevel = int(config.get("Tracking", {}).get("pyramid_level", 3))
    ds.bilateral_mode = str(config.get("System", {}).get("bilateral_mode", "exact"))
    return ds
