"""RGB-D datasets (port of `eggfusion_tpu/data/datasets.py`, the synthetic
part): `SyntheticDataset` and the synthetic case of `load_dataset`.

Frames are generated up front on the dataset's device, or on demand with
`Dataset.lazy_device`. With `Dataset.device_frames` they stay there as float
color / metric depth; otherwise they round-trip through uint8 color and host
depth, as the JAX dataset does. `Dataset.noise` applies the host-side sensor
noise model to each generated frame. The buffered reader
(`get_buffer_frame`) returns frames in order from the calling thread.
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.data import synthetic as syn
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics


class SyntheticDataset:
    """Analytic synthetic sequence with exact GT (see `data.synthetic`):
    `Dataset.trajectory` (sway, handheld, loop, orbit) drawn from
    `Dataset.seed`, `scene` (corner, room), `texture_detail`,
    `textureless_x` and `noise` (keyword arguments of
    `synthetic.apply_sensor_noise`, plus an ignored `enabled`)."""

    def __init__(self, config, device):
        calib = config.Dataset.Calibration
        self.device = torch.device(device)
        self.intrinsics = CameraIntrinsics(
            fx=float(calib.fx), fy=float(calib.fy), cx=float(calib.cx), cy=float(calib.cy),
            width=int(calib.width), height=int(calib.height))
        ds = config.Dataset
        n = int(ds.get("n_frames", 30))
        seed = int(ds.get("seed", 0))
        noise = dict(ds.get("noise", {}) or {})
        self.n_imgs = n
        self.poses = list(syn.TRAJECTORIES[str(ds.get("trajectory", "sway"))](n, seed))
        self.ts = list(np.arange(n) * 0.05)
        self.depth_scale = 1.0
        self._unique = min(n, int(ds.get("unique_frames", n)))
        self._render = dict(detail=float(ds.get("texture_detail", 0.0)),
                            flat_x=float(ds.get("textureless_x", 0.0)),
                            scene=str(ds.get("scene", "corner")), device=self.device)
        # lazy_device: render each frame on demand, on the device (noise is
        # not applied: it is a host-side model)
        self._lazy = bool(ds.get("lazy_device", False))
        self._device_frames = self._lazy or bool(ds.get("device_frames", False))
        self._frames = []
        for i in range(0 if self._lazy else self._unique):
            color, depth = syn.render_corner_scene(self.intrinsics, self.poses[i], **self._render)
            if noise:
                c, d = syn.apply_sensor_noise(
                    color.cpu().numpy(), depth.cpu().numpy(), seed=seed * 100003 + i,
                    **{k: float(v) for k, v in noise.items() if k != "enabled"})
                color, depth = torch.from_numpy(c).to(self.device), torch.from_numpy(d).to(self.device)
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
        pose = self.poses[idx % self._unique]
        if self._lazy:
            color, depth = syn.render_corner_scene(self.intrinsics, pose, **self._render)
        else:
            color, depth = self._frames[idx % self._unique]
        return self.ts[idx], color, depth, self._mask, pose

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
