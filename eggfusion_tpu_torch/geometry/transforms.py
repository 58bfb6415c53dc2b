"""Quaternion / rotation / map-transform utilities (port of
`eggfusion_tpu/geometry/transforms.py`). Quaternions are (w, x, y, z).

Surfel fields keep the JAX package's transposed (k, N) layout, so the `_t`
functions take and return (k, N) tensors.
"""
from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3) (normalizes
    first)."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(norm, min=1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1),
            torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1),
            torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def build_rotation_t(q: torch.Tensor) -> torch.Tensor:
    """Transposed-layout `build_rotation`: (4, N) wxyz -> (3, 3, N)."""
    r, x, y, z = q[0], q[1], q[2], q[3]
    inv = 1.0 / torch.sqrt(r * r + x * x + y * y + z * z + 1e-24)
    r, x, y, z = r * inv, x * inv, y * inv, z * inv
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)]),
            torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)]),
            torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def normal_from_quat_t(q: torch.Tensor) -> torch.Tensor:
    """Third column of R(q) for (4, N) quaternions -> unit (3, N)."""
    r, x, y, z = q[0], q[1], q[2], q[3]
    inv = 1.0 / torch.sqrt(r * r + x * x + y * y + z * z + 1e-24)
    r, x, y, z = r * inv, x * inv, y * inv, z * inv
    nx = 2 * (x * z + r * y)
    ny = 2 * (y * z - r * x)
    nz = 1 - 2 * (x * x + y * y)
    inv_n = 1.0 / (torch.sqrt(nx * nx + ny * ny + nz * nz) + 1e-8)
    return torch.stack([nx * inv_n, ny * inv_n, nz * inv_n])


def rot_z_to_t(target: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating +z onto each column of `target` (3, N) -> (4, N)."""
    nx, ny, nz = target[0], target[1], target[2]
    ax, ay = -ny, nx
    inv = 1.0 / (torch.sqrt(ax * ax + ay * ay) + 1e-8)
    ax, ay = ax * inv, ay * inv
    dot = torch.clamp(nz, -1.0 + 1e-7, 1.0 - 1e-7)
    half = torch.arccos(dot) * 0.5
    s = torch.sin(half)
    return torch.stack([torch.cos(half), ax * s, ay * s, torch.zeros_like(s)])


def transform_map(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform to an (H, W, 3) map."""
    return points @ R.T + t


def _pixel_grid(H: int, W: int, like: torch.Tensor):
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=like.dtype, device=like.device),
        torch.arange(W, dtype=like.dtype, device=like.device),
        indexing="ij",
    )
    return ys, xs


def compute_incident_angle(normal_map: torch.Tensor, intr) -> torch.Tensor:
    """|cos| between per-pixel viewing ray and normal, (H, W, 1)."""
    H, W = normal_map.shape[:2]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    ys, xs = _pixel_grid(H, W, normal_map)
    proj = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    proj = proj / (torch.linalg.vector_norm(proj, dim=-1, keepdim=True) + 1e-8)
    nrm = normal_map / (torch.linalg.vector_norm(normal_map, dim=-1, keepdim=True) + 1e-8)
    cos = torch.abs(torch.sum(nrm * proj, dim=-1))
    return cos[..., None]


def compute_confidence(coords: torch.Tensor, center: torch.Tensor, max_radius: float,
                       two_sigma_2: float) -> torch.Tensor:
    """Radial Gaussian confidence map."""
    radial = torch.linalg.vector_norm(coords - center, dim=-1) / max_radius
    return torch.exp(-(radial**2) / two_sigma_2)
