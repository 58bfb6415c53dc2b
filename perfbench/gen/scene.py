"""The benchmark's analytic scenes: convex rooms of textured planes, ray-cast
from any camera pose in plain torch.

Frozen copy of `eggfusion_tpu_torch/data/synthetic.py` (`_PLANES`,
`_texture`, `render_corner_scene`) at commit 90c4a41, with an octagonal
room of the benchmark's own (the synthetic module's `room` box, seen from
its orbit, often shows one wall alone, along which depth tracking cannot
tell a sideways move). The texture is shifted by a per-seed offset, so
that seeds change what the camera sees and not how much work it makes;
the geometry is the same for every seed.

Poses are world-to-camera (4, 4); depth is metric; a point lies inside a
scene where n . p <= d for every plane row (n, d).
"""
from __future__ import annotations

import numpy as np
import torch


def _plane(n, d):
    n = np.asarray(n, dtype=np.float64)
    n = n / np.linalg.norm(n)
    return [n[0], n[1], n[2], d]


# a room corner: three slanted walls, a back wall and four side walls
CORNER = np.array(
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

# a room of eight walls 3.7 m from its centre, 2.4 m high: from anywhere
# inside, a 90-degree view holds walls of two or three orientations and a
# strip of floor and ceiling
OCTAGON = np.array(
    [[np.sin(k * np.pi / 4), 0.0, -np.cos(k * np.pi / 4), 3.7] for k in range(8)]
    + [[0.0, 1.0, 0.0, 1.2], [0.0, -1.0, 0.0, 1.2]],
    dtype=np.float32,
)

SCENES = {"corner": CORNER, "octagon": OCTAGON}


def texture(p: torch.Tensor, detail: float = 0.0, offset=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Smooth 3-channel procedural texture of world position (..., 3),
    evaluated at p + `offset`; `detail` > 0 adds a high-frequency speckle."""
    q = p + torch.as_tensor(offset, dtype=p.dtype, device=p.device)
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    r = 0.5 + 0.35 * torch.sin(2.1 * x + 0.7) * torch.cos(1.7 * y)
    g = 0.5 + 0.35 * torch.sin(1.3 * y + 2.9 * z)
    b = 0.5 + 0.35 * torch.cos(2.3 * z + 1.1 * x + 0.4)
    tex = torch.stack([r, g, b], dim=-1)
    if detail > 0.0:
        s = (torch.tanh(4.0 * torch.sin(37.0 * x) * torch.sin(29.0 * y + 1.3) * torch.sin(41.0 * z + 0.7))
             + 0.5 * torch.tanh(4.0 * torch.sin(61.0 * x + 2.1) * torch.sin(53.0 * z)))
        tex = tex + detail * s[..., None]
    return torch.clamp(tex, 0.0, 1.0)


def rays(intr, device) -> torch.Tensor:
    """(H, W, 3) camera rays (x, y, 1) through the pixel centres of `intr`
    (fx, fy, cx, cy, width, height)."""
    fx, fy, cx, cy, W, H = intr
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)


def raycast(planes, intr, w2c, device=None, dtype=torch.float32):
    """Depth (H, W) along each pixel's ray to the first plane of the convex
    scene `planes` (rows n, d), seen from the w2c pose; 0 where no plane is
    hit in front. Also returns the world points (H, W, 3)."""
    w2c = torch.as_tensor(np.asarray(w2c), dtype=dtype, device=device)
    r = rays(intr, device).to(dtype)
    R, t = w2c[:3, :3], w2c[:3, 3]
    centre = -R.T @ t
    rays_w = r @ R  # R^T applied to each ray
    pl = torch.as_tensor(np.asarray(planes), dtype=dtype, device=device)
    n, d = pl[:, :3], pl[:, 3]
    denom = rays_w @ n.T
    numer = d - n @ centre
    z = numer / torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, 1e-8), denom)
    z = torch.where(z > 0.05, z, torch.full_like(z, float("inf")))
    depth = torch.amin(z, dim=-1)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    return depth, centre + depth[..., None] * rays_w


def render(pl: np.ndarray, intr, w2c, detail: float = 0.0, offset=(0.0, 0.0, 0.0), device=None):
    """Color (H, W, 3) in [0, 1] and metric depth (H, W) of the scene of
    plane rows `pl` from the w2c pose."""
    depth, p_w = raycast(pl, intr, w2c, device)
    color = texture(p_w, detail, offset)
    return torch.where(depth[..., None] > 0, color, torch.zeros_like(color)), depth
