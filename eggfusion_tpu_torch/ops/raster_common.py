"""Shared surfel-projection math for the renderers (port of
`eggfusion_tpu/ops/raster_common.py`).

Per surfel: projected mean, 2D covariance by EWA splatting of the surfel's
tangent disk, view-dependent SH color, camera-frame normal. Outputs stay
TRANSPOSED (k, N) as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from eggfusion_tpu_torch.geometry import sh as shlib
from eggfusion_tpu_torch.geometry import transforms as tf

# low-pass dilation of the projected footprint, as in 3DGS (pixels^2)
LOWPASS = 0.3
NEAR_Z = 0.05
ALPHA_EPS = 1.0 / 255.0
MAX_ALPHA = 0.99


def rotate(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R @ x for a (3, 3) R and (3, N) columns, as separate elementwise
    products and sums: each column's result is rounded the same whatever N
    is. A matrix product is not: cuBLAS picks its kernel by the batch size,
    so the same surfel would project a few ulps apart in maps of another
    capacity or in a frustum-compacted prefix, and near-coplanar splats
    would swap their depth order."""
    return R[:, 0:1] * x[0:1] + R[:, 1:2] * x[1:2] + R[:, 2:3] * x[2:3]


class ProjectedSurfels(NamedTuple):
    """TRANSPOSED (k, N) per-surfel screen-space quantities."""

    mean2d: torch.Tensor  # (2, N) pixel coords (u; v)
    depth: torch.Tensor  # (N,) view-space z of the center
    conic: torch.Tensor  # (3, N) inverse 2D covariance (a, b, c): [[a, b], [b, c]]
    radius: torch.Tensor  # (N,) screen-space 3-sigma radius in pixels
    color: torch.Tensor  # (3, N) view-dependent RGB
    normal_cam: torch.Tensor  # (3, N) camera-frame unit normal
    p_cam: torch.Tensor  # (3, N) camera-frame center
    opacity: torch.Tensor  # (N,) activated opacity (0 for culled/inactive)
    valid: torch.Tensor  # (N,) bool


def project_surfels(params: dict, w2c: torch.Tensor, intr: torch.Tensor, width: int, height: int,
                    sh_degree: int = 3, need_color: bool = True) -> ProjectedSurfels:
    """Project surfels (transposed (k, N) `render_params` dict) into a
    pinhole camera."""
    xyz = params["xyz"]  # (3, N)
    R = w2c[:3, :3]
    t = w2c[:3, 3]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]

    p_cam = rotate(R, xyz) + t[:, None]  # (3, N)
    px, py, z = p_cam[0], p_cam[1], p_cam[2]
    z_safe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = fx * px / z_safe + cx
    v = fy * py / z_safe + cy
    mean2d = torch.stack([u, v], dim=0)

    # tangent disk axes in camera frame: columns 0/1 of R(q), scaled
    Rs = tf.build_rotation_t(params["rotations"])  # (3, 3, N)
    s = params["scales"]
    tu = rotate(R, Rs[:, 0] * s[0])
    tv = rotate(R, Rs[:, 1] * s[1])

    # A surfel at or behind the near plane is never rendered (`valid` below),
    # but within ~1e-4 m of the camera plane its covariance overflows
    # float32, and the zero gradient it receives times the NaN local
    # derivatives would be NaN (the JAX module's gradient is): its covariance
    # is taken at depth 1 instead.
    z_cov = torch.where(z <= NEAR_Z, torch.ones_like(z), z_safe)
    inv_z = 1.0 / z_cov
    inv_z2 = inv_z * inv_z

    def proj_axis(a):
        jx = fx * (a[0] * inv_z - px * a[2] * inv_z2)
        jy = fy * (a[1] * inv_z - py * a[2] * inv_z2)
        return jx, jy

    ax, ay = proj_axis(tu)
    bx, by = proj_axis(tv)
    cxx = ax * ax + bx * bx + LOWPASS
    cxy = ax * ay + bx * by
    cyy = ay * ay + by * by + LOWPASS
    det = cxx * cyy - cxy * cxy
    det = torch.clamp(det, min=1e-12)
    conic = torch.stack([cyy / det, -cxy / det, cxx / det], dim=0)

    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    radius = 3.0 * torch.sqrt(lam)

    if need_color:
        cam_center = -(R.T @ t)
        dirs = xyz - cam_center[:, None]
        dirs = dirs / torch.sqrt(dirs[0] ** 2 + dirs[1] ** 2 + dirs[2] ** 2 + 1e-12)
        color = shlib.eval_sh_t(sh_degree, params["shs"], dirs)
        color = torch.clamp(color + 0.5, min=0.0)
    else:  # geometry-only render: skip the SH evaluation entirely
        color = torch.zeros_like(xyz)

    normal_cam = rotate(R, params["normal"])
    # orient normals toward the camera (surfels are two-sided disks)
    flip = torch.sign(-torch.sum(normal_cam * p_cam, dim=0))
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    normal_cam = normal_cam * flip

    inb = (
        (z > NEAR_Z)
        & (u + radius > 0)
        & (u - radius < width)
        & (v + radius > 0)
        & (v - radius < height)
    )
    valid = inb & params["active"]
    opacity = torch.where(valid, params["opacity"][0], torch.zeros_like(params["opacity"][0]))

    return ProjectedSurfels(
        mean2d=mean2d,
        depth=z,
        conic=conic,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        color=color,
        normal_cam=normal_cam,
        p_cam=p_cam,
        opacity=opacity,
        valid=valid,
    )
