"""Per-frame state container and preprocessing (port of
`eggfusion_tpu/core/frame.py`).

A `Frame` holds the GT pose (host numpy), the estimated pose (one (4, 4)
device tensor), intrinsics, the bilateral-filtered metric depth and the
tracking pyramid, all on the frame's device. With `programs`
(`utils.graphs`) the preparation and the pyramid run as one program, whose
outputs the next frame's preparation overwrites: a consumer that keeps a
frame's maps past the next frame clones them (`core.mapper.KeyFrame`, the
held-out views of `system.EGGFusion`).
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.ops import image as imops
from eggfusion_tpu_torch.ops.pyramid import build_pyramid
from eggfusion_tpu_torch.utils import trace
from eggfusion_tpu_torch.utils.device import upload


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


def frame_inputs(color, depth, mask, intr, depth_scale: float, nlevel: int, bilateral: str,
                 prefiltered: bool, filter_depth: bool):
    """(color, depth, mask, pyramid) of a frame's device inputs: u8 color and
    raw depth through `prepare_frame_inputs`, or (`prefiltered`) float color
    and metric depth, bilateral-filtered with `filter_depth`."""
    if prefiltered:
        color = color.to(torch.float32)
        depth = depth.to(torch.float32)
        depth = depth if depth.dim() == 3 else depth[..., None]
        if filter_depth:
            depth = imops.bilateral(bilateral)(depth, 13, 0.03, 4.5)
        mask = mask.to(torch.float32)
        mask = mask if mask.dim() == 3 else mask[..., None]
    else:
        color, depth, mask = prepare_frame_inputs(color, depth, mask, depth_scale, bilateral)
    return color, depth, mask, build_pyramid(color, depth, mask, intr, nlevel=nlevel, bilateral=bilateral)


def _frame_program(_state, x, **static):
    return frame_inputs(*x, **static)


class Frame:
    """Frame on a device: `.color`, `.depth`, `.mask`, `.pyramid` tensors.
    `programs` (a `utils.graphs.Programs`) runs the preparation as its
    "frame" program. The upload and the preparation run under the span
    "frame" (`utils/trace.py`). Host arrays go to a CUDA device through
    pinned staging buffers (`utils.device.upload`), so the host queues the
    frame without waiting for the device, and so does the GT pose when it is
    committed (`update_transform_gt`); to the CPU they are copied;
    tensors are taken as they are. The intrinsics tensor is shared
    (`CameraIntrinsics.on_device`)."""

    def __init__(self, uid: int, ts: float, color_u8, depth_raw, mask, gt_pose_w2c: np.ndarray,
                 intr: CameraIntrinsics, depth_scale: float, device, nlevel: int = 3,
                 prefiltered: bool = False, filter_depth: bool = False, bilateral: str = "exact",
                 programs=None):
        self.uid = uid
        self.ts = float(ts)
        self.device = torch.device(device)
        self.width, self.height = intr.width, intr.height
        self.gt_w2c = np.asarray(gt_pose_w2c, np.float32)
        self.sparse_tracking = False  # the tracker's seed came from the sparse frontend
        self._w2c = None
        self._gt_w2c_dev = None
        with trace.span("frame"):
            self.intr = intr.on_device(self.device)
            # uint16 depth widened to int32: exact; CUDA has few uint16 operations
            widen = np.int32 if isinstance(depth_raw, np.ndarray) and depth_raw.dtype == np.uint16 else None
            x = (self._to(color_u8), self._to(depth_raw, widen), self._to(mask), self.intr)
            static = dict(depth_scale=float(depth_scale), nlevel=nlevel, bilateral=bilateral,
                          prefiltered=prefiltered, filter_depth=filter_depth)
            if programs is None:
                out = frame_inputs(*x, **static)
            else:
                out = programs.program("frame", _frame_program)(static, None, x)
        self.color, self.depth, self.mask, self.pyramid = out

    def _to(self, x, dtype=None) -> torch.Tensor:
        """A host array on the frame's device (cast to the numpy `dtype`, if
        given): to CUDA through `upload`'s pinned staging, to the CPU as a
        copy; a tensor as it is."""
        if not isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=self.device)
        if self.device.type == "cuda":
            return upload(x, self.device, dtype)
        return torch.as_tensor(x if dtype is None else x.astype(dtype), device=self.device)

    def update_transform_gt(self) -> None:
        """Commit the GT pose as the estimate (frame 0 / only_mapping): on
        CUDA through the frame's staged upload, so the host does not wait
        for the device (under `System.only_mapping` every frame commits
        one)."""
        if self._gt_w2c_dev is None:
            self._gt_w2c_dev = self._to(self.gt_w2c)
        self._w2c = self._gt_w2c_dev

    def update_transform_matrix(self, w2c: torch.Tensor) -> None:
        """Set the pose from a full (4, 4) w2c."""
        self._w2c = w2c.to(torch.float32)

    def w2c_matrix(self) -> torch.Tensor:
        assert self._w2c is not None, "pose not set yet (tracker runs first)"
        return self._w2c
