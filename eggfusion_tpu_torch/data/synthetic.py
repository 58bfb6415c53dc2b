"""Analytic synthetic RGB-D scenes with ground-truth trajectories (port of
`eggfusion_tpu/data/synthetic.py`, in part: the corner scene, the sway
trajectory and `make_sequence`).

A convex "room corner" of textured planes is ray-cast analytically from any
camera pose, on the caller's device. Poses are w2c 4x4; depth is metric.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics


def _plane(n, d):
    n = np.asarray(n, dtype=np.float32)
    n = n / np.linalg.norm(n)
    return [n[0], n[1], n[2], d]


# convex room: the viewer is inside the intersection of half-spaces n.p <= d
_PLANES = np.array(
    [
        _plane([1.0, 1.0, 1.2], 2.4),
        _plane([-1.0, 1.0, 1.2], 2.4),
        _plane([0.0, -1.0, 0.9], 2.0),
        [0.0, 0.0, 1.0, 4.5],
        [-1.0, 0.0, 0.0, 3.0],
        [1.0, 0.0, 0.0, 3.0],
        [0.0, 1.0, 0.0, 2.2],
        [0.0, -1.0, 0.0, 2.2],
    ],
    dtype=np.float32,
)

SCENES = {"corner": _PLANES}


def _texture(p: torch.Tensor) -> torch.Tensor:
    """Smooth 3-channel procedural texture of world position (..., 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.35 * torch.sin(2.1 * x + 0.7) * torch.cos(1.7 * y)
    g = 0.5 + 0.35 * torch.sin(1.3 * y + 2.9 * z)
    b = 0.5 + 0.35 * torch.cos(2.3 * z + 1.1 * x + 0.4)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def render_corner_scene(intr: CameraIntrinsics, w2c, device=None, scene: str = "corner"):
    """Ray-cast the convex scene from pose `w2c` on `device`.

    Returns (color (H, W, 3) in [0, 1], depth (H, W, 1) metric)."""
    w2c = torch.as_tensor(np.asarray(w2c, np.float32), device=device)
    H, W = intr.height, intr.width
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    rays = torch.stack([(xs - intr.cx) / intr.fx, (ys - intr.cy) / intr.fy, torch.ones_like(xs)], dim=-1)
    R = w2c[:3, :3]
    t = w2c[:3, 3]
    cam_center = -R.T @ t
    rays_w = rays @ R  # R^T applied to each ray
    planes = torch.as_tensor(SCENES[scene], device=device)
    n = planes[:, :3]
    d = planes[:, 3]
    denom = torch.einsum("hwc,pc->hwp", rays_w, n)
    numer = d[None, None, :] - torch.einsum("c,pc->p", cam_center, n)[None, None, :]
    z = numer / torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, 1e-8), denom)
    z = torch.where(z > 0.05, z, torch.full_like(z, float("inf")))
    depth = torch.amin(z, dim=-1)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    p_w = cam_center[None, None, :] + depth[..., None] * rays_w
    color = _texture(p_w)
    color = torch.where(depth[..., None] > 0, color, torch.zeros_like(color))
    return color, depth[..., None]


class SyntheticSequence(NamedTuple):
    """A ground-truth trajectory through the corner scene."""

    intr: CameraIntrinsics
    poses_w2c: np.ndarray  # (N, 4, 4)
    timestamps: np.ndarray  # (N,)


def make_trajectory(n_frames: int = 30, translation_scale: float = 0.015,
                    rotation_scale: float = 0.004) -> np.ndarray:
    """Smooth sway trajectory: (N, 4, 4) w2c poses, frame 0 = identity, with
    per-frame motion independent of the sequence length (120-frame sway
    period, tanh-saturating amplitude)."""
    poses = []
    i_sat = 20.0
    om = 2 * math.pi / 120.0
    for i in range(n_frames):
        ei = i_sat * math.tanh(i / i_sat)
        tx = translation_scale * ei * math.sin(0.5 + om * i)
        ty = 0.5 * translation_scale * ei * math.sin(2 * om * i)
        tz = -0.8 * translation_scale * ei
        wy = rotation_scale * ei * math.sin(om * i + 0.3)
        wx = 0.5 * rotation_scale * ei * math.cos(om * i)
        cy_, sy_ = math.cos(wy), math.sin(wy)
        cx_, sx_ = math.cos(wx), math.sin(wx)
        Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = (Ry @ Rx).astype(np.float32)
        T[:3, 3] = [tx, ty, tz]
        poses.append(T)
    return np.stack(poses)


def make_sequence(n_frames: int = 30, width: int = 160, height: int = 120) -> SyntheticSequence:
    intr = CameraIntrinsics(
        fx=0.9 * width, fy=0.9 * width, cx=width / 2 - 0.5, cy=height / 2 - 0.5, width=width, height=height
    )
    return SyntheticSequence(intr=intr, poses_w2c=make_trajectory(n_frames),
                             timestamps=np.arange(n_frames) * 0.05)
