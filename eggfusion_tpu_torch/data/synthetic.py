"""Analytic synthetic RGB-D scenes with ground-truth trajectories (port of
`eggfusion_tpu/data/synthetic.py`).

A convex scene of textured planes ("corner": a room corner; "room": a large
beveled box) is ray-cast analytically from any camera pose, on the caller's
device. Poses are w2c 4x4; depth is metric. The trajectories and the
sensor-noise model are host numpy, as in the JAX module, so both packages
draw the same numbers from the same seeds.
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

# an 8 x 4.4 x 8 m box with two beveled corners (the map-growth scene of the
# `orbit` trajectory)
_PLANES_ROOM = np.array(
    [
        [-1.0, 0.0, 0.0, 4.0],
        [1.0, 0.0, 0.0, 4.0],
        [0.0, 1.0, 0.0, 2.2],
        [0.0, -1.0, 0.0, 2.2],
        [0.0, 0.0, 1.0, 4.0],
        [0.0, 0.0, -1.0, 4.0],
        _plane([1.0, 0.0, 1.0], 5.2),
        _plane([-1.0, 0.0, -1.0], 5.2),
    ],
    dtype=np.float32,
)

SCENES = {"corner": _PLANES, "room": _PLANES_ROOM}


def _texture(p: torch.Tensor, detail: float = 0.0, flat_x: float = 0.0) -> torch.Tensor:
    """Smooth 3-channel procedural texture of world position (..., 3).

    `detail` > 0 adds a high-frequency speckle layer (the smooth texture has
    no FAST corners at test resolutions); `flat_x` > 0 paints everything
    left of x = -flat_x one constant color (a textureless segment)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.35 * torch.sin(2.1 * x + 0.7) * torch.cos(1.7 * y)
    g = 0.5 + 0.35 * torch.sin(1.3 * y + 2.9 * z)
    b = 0.5 + 0.35 * torch.cos(2.3 * z + 1.1 * x + 0.4)
    tex = torch.stack([r, g, b], dim=-1)
    if detail > 0.0:
        s = (torch.tanh(4.0 * torch.sin(37.0 * x) * torch.sin(29.0 * y + 1.3) * torch.sin(41.0 * z + 0.7))
             + 0.5 * torch.tanh(4.0 * torch.sin(61.0 * x + 2.1) * torch.sin(53.0 * z)))
        tex = tex + detail * s[..., None]
    if flat_x > 0.0:
        tex = torch.where((p[..., 0] < -flat_x)[..., None], torch.full_like(tex, 0.55), tex)
    return torch.clamp(tex, 0.0, 1.0)


def render_corner_scene(intr: CameraIntrinsics, w2c, detail: float = 0.0, flat_x: float = 0.0,
                        scene: str = "corner", device=None):
    """Ray-cast the convex scene `scene` from pose `w2c` on `device`.

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
    color = _texture(p_w, detail, flat_x)
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


def make_handheld_trajectory(n_frames: int = 60, seed: int = 0,
                             jitter_t: float = 0.004, jitter_r: float = 0.005,
                             fast_rot_start: int = 24, fast_rot_len: int = 10,
                             fast_rot_step: float = 0.035) -> np.ndarray:
    """The sway trajectory plus per-frame white-noise pose jitter and a
    fast-rotation burst of `fast_rot_step` rad/frame yaw over
    `fast_rot_len` frames."""
    rng = np.random.default_rng(seed)
    base = make_trajectory(n_frames)
    poses = []
    yaw = 0.0
    for i in range(n_frames):
        T = base[i].copy()
        if fast_rot_start <= i < fast_rot_start + fast_rot_len:
            yaw += fast_rot_step
        wj = rng.normal(scale=jitter_r, size=3)
        cy_, sy_ = math.cos(yaw + wj[1]), math.sin(yaw + wj[1])
        cx_, sx_ = math.cos(wj[0]), math.sin(wj[0])
        cz_, sz_ = math.cos(wj[2]), math.sin(wj[2])
        Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]])
        Rz = np.array([[cz_, -sz_, 0], [sz_, cz_, 0], [0, 0, 1]])
        T[:3, :3] = (Ry @ Rx @ Rz @ T[:3, :3]).astype(np.float32)
        T[:3, 3] += rng.normal(scale=jitter_t, size=3).astype(np.float32)
        poses.append(T.astype(np.float32))
    return np.stack(poses)


def make_loop_trajectory(n_frames: int = 60, reach: float = 0.35,
                         yaw_reach: float = 0.30, seed: int = 0,
                         jitter_t: float = 0.002, jitter_r: float = 0.002) -> np.ndarray:
    """Out-and-back loop: the camera translates and yaws away over the first
    half and returns over the second, so frame N-1 revisits frame 0's view."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        s = math.sin(math.pi * i / max(n_frames - 1, 1))
        yaw = yaw_reach * s
        tx = reach * s
        ty = 0.3 * reach * math.sin(2 * math.pi * i / max(n_frames - 1, 1))
        cy_, sy_ = math.cos(yaw), math.sin(yaw)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], np.float32)
        T[:3, 3] = [tx + rng.normal(scale=jitter_t), ty + rng.normal(scale=jitter_t), 0.0]
        wj = rng.normal(scale=jitter_r)
        cx_, sx_ = math.cos(wj), math.sin(wj)
        Rx = np.array([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]], np.float32)
        T[:3, :3] = Rx @ T[:3, :3]
        poses.append(T)
    return np.stack(poses)


def make_orbit_trajectory(n_frames: int = 300, radius: float = 2.2,
                          turns: float = 1.0, bob: float = 0.08, seed: int = 0,
                          jitter_t: float = 0.0, jitter_r: float = 0.0) -> np.ndarray:
    """Orbit inside the `room` scene with the camera facing outward, so every
    frame sees fresh wall: `turns` circuits of radius `radius` over n_frames
    with a vertical bob; (N, 4, 4) w2c."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        th = 2 * math.pi * turns * i / max(n_frames - 1, 1)
        c = np.array([radius * math.sin(th), bob * math.sin(5 * th), -radius * math.cos(th)], np.float64)
        yaw = math.pi - th + (rng.normal(scale=jitter_r) if jitter_r else 0.0)
        cy_, sy_ = math.cos(yaw), math.sin(yaw)
        Rc2w = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], np.float64)
        if jitter_t:
            c = c + rng.normal(scale=jitter_t, size=3)
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = Rc2w.T  # w2c
        T[:3, 3] = -Rc2w.T @ c
        poses.append(T.astype(np.float32))
    return np.stack(poses)


TRAJECTORIES = {
    "sway": lambda n, seed: make_trajectory(n),
    "handheld": lambda n, seed: make_handheld_trajectory(n, seed=seed),
    "loop": lambda n, seed: make_loop_trajectory(n, seed=seed),
    "orbit": lambda n, seed: make_orbit_trajectory(n, seed=seed),
}


def apply_sensor_noise(color: np.ndarray, depth: np.ndarray, seed: int,
                       depth_sigma0: float = 0.001, depth_sigma2: float = 0.0015,
                       depth_quant: float = 0.0028, edge_dropout_px: int = 2,
                       dropout_frac: float = 0.005, color_sigma: float = 0.02):
    """Kinect-style sensor noise on host numpy: depth gets Gaussian noise of
    sigma0 + sigma2 z^2, is quantized to steps of depth_quant z^2, loses
    most pixels within `edge_dropout_px` of a discontinuity and a
    `dropout_frac` salt of random pixels; color gets clipped Gaussian
    noise."""
    rng = np.random.default_rng(seed)
    edge_dropout_px = int(edge_dropout_px)
    d = np.asarray(depth, np.float32).copy()
    squeeze = d.ndim == 3
    if squeeze:
        d = d[..., 0]
    valid = d > 0
    z = np.where(valid, d, 1.0)
    sigma = depth_sigma0 + depth_sigma2 * z * z
    d = d + rng.normal(size=d.shape).astype(np.float32) * sigma * valid
    step = np.maximum(depth_quant * z * z, 1e-6)
    d = np.round(d / step) * step
    gy, gx = np.gradient(np.where(valid, d, 0.0))
    edge = (np.abs(gx) + np.abs(gy)) > 0.05
    if edge_dropout_px > 0:
        from scipy.ndimage import binary_dilation

        edge = binary_dilation(edge, iterations=edge_dropout_px)
        drop = edge & (rng.uniform(size=d.shape) < 0.7)
        d = np.where(drop, 0.0, d)
    if dropout_frac > 0:
        d = np.where(rng.uniform(size=d.shape) < dropout_frac, 0.0, d)
    d = np.maximum(d, 0.0).astype(np.float32)
    c = np.asarray(color, np.float32)
    if c.max() > 1.5:  # uint8 range
        c = c / 255.0
    c = np.clip(c + rng.normal(size=c.shape).astype(np.float32) * color_sigma, 0.0, 1.0)
    return c, (d[..., None] if squeeze else d)


def make_sequence(n_frames: int = 30, width: int = 160, height: int = 120) -> SyntheticSequence:
    intr = CameraIntrinsics(
        fx=0.9 * width, fy=0.9 * width, cx=width / 2 - 0.5, cy=height / 2 - 0.5, width=width, height=height
    )
    return SyntheticSequence(intr=intr, poses_w2c=make_trajectory(n_frames),
                             timestamps=np.arange(n_frames) * 0.05)
