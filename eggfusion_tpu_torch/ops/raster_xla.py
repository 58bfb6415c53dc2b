"""Golden all-pairs differentiable surfel compositor (port of
`eggfusion_tpu/ops/raster_xla.py`).

Depth-sorted front-to-back alpha compositing over ALL pixels — O(N * H * W),
exact and differentiable by torch autograd. This is the port's oracle and
its CPU backend ("xla" keeps the JAX package's backend name).

Chunks of `chunk` depth-sorted surfels are blended at once: per chunk the
transmittance in front of each surfel is the running product of (1 - alpha)
(`torch.cumprod`), and each chunk runs under activation checkpointing, as
the JAX version's `jax.checkpoint`-ed scan does. Surfels that project
invalid contribute exactly nothing (alpha 0) and are dropped up front; that
selection reads their count on the host, which is fine for an oracle.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from eggfusion_tpu_torch.ops import raster_common as rc

CHUNK = 32


def _blend_chunk(rgb, nrm, dep, opa, T, xs, ys, ray, mean, conic, color, normal, pcam, op):
    """Blend K depth-ordered surfels (rows of the chunk tensors) over the
    (H, W) carry."""
    dx = xs[None] - mean[:, 0, None, None]  # (K, H, W)
    dy = ys[None] - mean[:, 1, None, None]
    c0, c1, c2 = (conic[:, i, None, None] for i in range(3))
    power = -0.5 * (c0 * dx * dx + 2 * c1 * dx * dy + c2 * dy * dy)
    alpha = torch.clamp(op[:, None, None] * torch.exp(power), max=rc.MAX_ALPHA)
    alpha = torch.where(alpha >= rc.ALPHA_EPS, alpha, torch.zeros_like(alpha))
    # transmittance in front of each surfel: exclusive running product
    one_m = 1.0 - alpha
    prefix = torch.cumprod(one_m, dim=0)
    T_k = T[None] * torch.cat([torch.ones_like(prefix[:1]), prefix[:-1]], dim=0)
    w = T_k * alpha
    # geometry-aware depth: ray/plane intersection with the surfel disk
    denom = (ray[None, ..., 0] * normal[:, 0, None, None] + ray[None, ..., 1] * normal[:, 1, None, None]
             + ray[None, ..., 2] * normal[:, 2, None, None])
    pn = torch.sum(pcam * normal, dim=-1)[:, None, None]
    small = torch.abs(denom) < 1e-6
    z_plane = pn / torch.where(small, torch.full_like(denom, 1e-6), denom)
    z_px = torch.where((z_plane > rc.NEAR_Z) & ~small, z_plane, pcam[:, 2, None, None].expand_as(z_plane))
    rgb = rgb + torch.einsum("khw,kc->hwc", w, color)
    nrm = nrm + torch.einsum("khw,kc->hwc", w, normal)
    dep = dep + torch.sum(w * z_px, dim=0)
    opa = opa + torch.sum(w, dim=0)
    T = T_k[-1] * one_m[-1]
    return rgb, nrm, dep, opa, T


def render_xla(params: dict, w2c: torch.Tensor, intr: torch.Tensor, width: int, height: int,
               sh_degree: int = 3, chunk: int = CHUNK) -> dict:
    """Render surfels to (H, W, *) color/normal/depth/opacity maps."""
    proj = rc.project_surfels(params, w2c, intr, width, height, sh_degree)
    dev = proj.depth.device
    order = torch.argsort(torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, float("inf"))),
                          stable=True)
    order = order[: int(proj.valid.sum())]  # host read: oracle path only

    def take(x):
        return x.index_select(0, order)

    mean2d = take(proj.mean2d.T)
    conic = take(proj.conic.T)
    color = take(proj.color.T)
    normal = take(proj.normal_cam.T)
    p_cam = take(proj.p_cam.T)
    opacity = take(proj.opacity)

    H, W = height, width
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    ray = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)

    f32 = dict(dtype=torch.float32, device=dev)
    carry = (torch.zeros((H, W, 3), **f32), torch.zeros((H, W, 3), **f32),
             torch.zeros((H, W), **f32), torch.zeros((H, W), **f32), torch.ones((H, W), **f32))
    use_ckpt = torch.is_grad_enabled() and any(
        torch.is_tensor(v) and v.requires_grad for v in params.values())
    for i in range(0, order.shape[0], chunk):
        sl = slice(i, i + chunk)
        args = (*carry, xs, ys, ray, mean2d[sl], conic[sl], color[sl], normal[sl], p_cam[sl], opacity[sl])
        carry = (checkpoint(_blend_chunk, *args, use_reentrant=False) if use_ckpt
                 else _blend_chunk(*args))
    rgb, nrm, dep, opa, _T = carry

    # normalize depth/normal by the accumulated weight (see the JAX module)
    wsum = torch.clamp(opa, min=1e-6)
    dep = dep / wsum
    nrm = nrm / wsum[..., None]
    return {
        "color": rgb,
        "normal": nrm,
        "depth": dep[..., None],
        "opacity": opa[..., None],
    }
