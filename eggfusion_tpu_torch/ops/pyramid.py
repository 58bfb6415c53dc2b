"""Image pyramid for dense tracking (port of `eggfusion_tpu/ops/pyramid.py`).

An N-level pyramid of intensity, disparity, Scharr gradients (gx, gy, |g|),
validity mask, vertex map, normal map and per-level intrinsics, with the
reference's quirks kept: BGR gray coefficients applied to RGB input, the
per-level depth re-filtered bilaterally, vertex/normal maps downsampled
rather than recomputed.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eggfusion_tpu_torch.ops import image as imops

RGB_COEFF = (0.299, 0.587, 0.114)  # applied reversed, as in the reference
_RGB_COEFF_F32 = tuple(float(torch.tensor(v, dtype=torch.float32)) for v in RGB_COEFF)


class PyramidLevel(NamedTuple):
    intensity: torch.Tensor  # (H, W, 1)
    intr: torch.Tensor  # (4,) fx, fy, cx, cy
    disp: torch.Tensor  # (H, W, 1) inverse depth
    grad: torch.Tensor  # (H, W, 3) gx, gy, |g|
    mask: torch.Tensor  # (H, W, 1) bool
    vertex: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor  # (H, W, 3)


Pyramid = Tuple[PyramidLevel, ...]


def _gray(color: torch.Tensor) -> torch.Tensor:
    """c0 k2 + c1 k1 + c2 k0 as XLA evaluates the JAX expression on the CPU:
    fma(c2, k0, fma(c0, k2, c1 k1)). The fused steps run in float64 and
    round to float32 where an FMA rounds (a float32 product is exact in
    float64), so the intensity — and the uint8 image the sparse frontend
    reads from it — is the JAX package's bit for bit."""
    f64 = torch.float64
    k = _RGB_COEFF_F32
    inner = (color[..., 0].to(f64) * k[2] + (color[..., 1] * RGB_COEFF[1]).to(f64)).to(torch.float32)
    return (color[..., 2].to(f64) * k[0] + inner.to(f64)).to(torch.float32)[..., None]


def _grad3(gray: torch.Tensor) -> torch.Tensor:
    gx, gy = imops.scharr_gradient(gray)
    mag = torch.sqrt(gx**2 + gy**2 + 1e-6)
    return torch.stack([gx, gy, mag], dim=-1)


def build_pyramid(color: torch.Tensor, depth: torch.Tensor, mask: torch.Tensor, intr: torch.Tensor,
                  nlevel: int = 3, bilateral: str = "exact") -> Pyramid:
    """Build an `nlevel` pyramid from (H, W, 3) color, (H, W, 1) depth,
    (H, W, 1) float mask and (4,) intrinsics."""
    gray = _gray(color)
    vmap, nmap = imops.compute_vertex_and_normal(depth, intr)
    levels = [PyramidLevel(
        intensity=gray, intr=intr, disp=1.0 / (depth + 1e-6), grad=_grad3(gray),
        mask=(mask > 0.9) & (depth > 0.1), vertex=vmap, normal=nmap,
    )]
    depth_l, mask_l, gray_l, vmap_l, nmap_l = depth, mask, gray, vmap, nmap
    bilat = imops.bilateral(bilateral)
    for _ in range(1, nlevel):
        gray_l = imops.gaussian_downsample(gray_l)
        depth_l = bilat(imops.gaussian_downsample(depth_l), 13, 0.03, 4.5)
        mask_l = imops.gaussian_downsample(mask_l)
        vmap_l = imops.gaussian_downsample(vmap_l)
        nmap_l = imops.gaussian_downsample(nmap_l)
        nmap_l = nmap_l / (torch.linalg.vector_norm(nmap_l, dim=-1, keepdim=True) + 1e-12)
        levels.append(PyramidLevel(
            intensity=gray_l, intr=levels[-1].intr / 2.0, disp=1.0 / (depth_l + 1e-6),
            grad=_grad3(gray_l), mask=(mask_l > 0.9) & (depth_l > 0.1),
            vertex=vmap_l, normal=nmap_l,
        ))
    return tuple(levels)
