"""Per-frame state container and preprocessing (port of
`eggfusion_tpu/core/frame.py`).

A `Frame` holds the GT pose (host numpy), the estimated pose (one (4, 4)
device tensor), intrinsics, the bilateral-filtered metric depth and the
tracking pyramid, all on the frame's device.
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.ops import image as imops
from eggfusion_tpu_torch.ops.pyramid import build_pyramid


def prepare_frame_inputs(color_u8, depth_raw, mask, depth_scale: float, bilateral: str = "exact"):
    """Normalize color, scale + bilateral-filter depth (13, 0.03, 4.5).
    Returns (color f32 (H, W, 3), depth f32 (H, W, 1), mask f32 (H, W, 1)).
    Color is scaled by the float32 reciprocal of 255, as XLA evaluates the
    JAX package's division by the constant."""
    color = color_u8.to(torch.float32) * (1.0 / 255.0)
    depth = depth_raw.to(torch.float32) / depth_scale
    if depth.dim() == 2:
        depth = depth[..., None]
    depth = imops.bilateral(bilateral)(depth, 13, 0.03, 4.5)
    mask = mask.to(torch.float32)
    if mask.dim() == 2:
        mask = mask[..., None]
    return color, depth, mask


class Frame:
    """Frame on a device: `.color`, `.depth`, `.mask`, `.pyramid` tensors."""

    def __init__(self, uid: int, ts: float, color_u8, depth_raw, mask, gt_pose_w2c: np.ndarray,
                 intr: CameraIntrinsics, depth_scale: float, device, nlevel: int = 3,
                 prefiltered: bool = False, filter_depth: bool = False, bilateral: str = "exact"):
        self.uid = uid
        self.ts = float(ts)
        self.device = torch.device(device)
        self.intr = intr.as_tensor(self.device)
        self.width, self.height = intr.width, intr.height
        self.gt_w2c = np.asarray(gt_pose_w2c, np.float32)
        self.sparse_tracking = False  # the tracker's seed came from the sparse frontend
        self._w2c = None
        self._gt_w2c_dev = None
        to = lambda x: torch.as_tensor(x, device=self.device)

        if prefiltered:
            # inputs already float color / metric depth
            self.color = to(color_u8).to(torch.float32)
            d = to(depth_raw).to(torch.float32)
            d = d if d.dim() == 3 else d[..., None]
            if filter_depth:
                d = imops.bilateral(bilateral)(d, 13, 0.03, 4.5)
            self.depth = d
            m = to(mask).to(torch.float32)
            self.mask = m if m.dim() == 3 else m[..., None]
        else:
            if isinstance(depth_raw, np.ndarray) and depth_raw.dtype == np.uint16:
                depth_raw = depth_raw.astype(np.int32)  # exact; CUDA has few uint16 operations
            self.color, self.depth, self.mask = prepare_frame_inputs(
                to(color_u8), to(depth_raw), to(mask), float(depth_scale), bilateral)
        self.pyramid = build_pyramid(self.color, self.depth, self.mask, self.intr, nlevel=nlevel,
                                     bilateral=bilateral)

    def update_transform_gt(self) -> None:
        """Commit the GT pose as the estimate (frame 0 / only_mapping)."""
        if self._gt_w2c_dev is None:
            self._gt_w2c_dev = torch.as_tensor(self.gt_w2c, device=self.device)
        self._w2c = self._gt_w2c_dev

    def update_transform_matrix(self, w2c: torch.Tensor) -> None:
        """Set the pose from a full (4, 4) w2c."""
        self._w2c = w2c.to(torch.float32)

    def w2c_matrix(self) -> torch.Tensor:
        assert self._w2c is not None, "pose not set yet (tracker runs first)"
        return self._w2c
