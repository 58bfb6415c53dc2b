"""Dense-tracking normal-equation builders (port of
`eggfusion_tpu/ops/reduce.py`): projective warp + point-to-plane ICP +
photometric terms, reduced to a 6x6 system per Gauss-Newton iteration.

Resampling keeps the JAX module's paired pack (each pixel carries its
x+1 neighbour), so one row gather returns two bilinear corners.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from eggfusion_tpu_torch.ops.image import decimate2d, gather_index
from eggfusion_tpu_torch.ops.pyramid import PyramidLevel


def sampling_pack(frame: PyramidLevel) -> torch.Tensor:
    """Paired resampling pack of one pyramid level: (H, W, 20) — channels
    0..9 [intensity, gx, gy, vertex(3), normal(3), mask] at pixel x, 10..19
    the same at x+1 (zero past the last column)."""
    mask = frame.mask
    if mask.dim() == 2:
        mask = mask[..., None]
    P = torch.cat([frame.intensity, frame.grad[..., :2], frame.vertex, frame.normal,
                   mask.to(frame.intensity.dtype)], dim=-1)
    P_x1 = torch.cat([P[:, 1:], torch.zeros_like(P[:, :1])], dim=1)
    return torch.cat([P, P_x1], dim=-1)


def _sample_packed(pack: torch.Tensor, coords: torch.Tensor):
    """Bilinear [intensity, gx, gy] (zeros padding), nearest vertex/normal
    and mask>0.8 at normalized coords, from two row gathers."""
    H, W, _ = pack.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    x0c = gather_index(x0, W)
    y0c = gather_index(y0, H)
    y1c = gather_index(y0 + 1, H)

    s0 = pack[y0c, x0c]
    s1 = pack[y1c, x0c]

    dt = pack.dtype
    inx0 = ((x0 >= 0) & (x0 <= W - 1)).to(dt)
    inx1 = (x0 + 1 <= W - 1).to(dt)
    iny0 = ((y0 >= 0) & (y0 <= H - 1)).to(dt)
    iny1 = ((y0 + 1 >= 0) & (y0 + 1 <= H - 1)).to(dt)

    w00 = ((1 - fx) * (1 - fy) * inx0 * iny0)[..., None]
    w10 = (fx * (1 - fy) * inx1 * iny0)[..., None]
    w01 = ((1 - fx) * fy * inx0 * iny1)[..., None]
    w11 = (fx * fy * inx1 * iny1)[..., None]
    bil = (s0[..., 0:3] * w00 + s0[..., 10:13] * w10
           + s1[..., 0:3] * w01 + s1[..., 10:13] * w11)

    selx = torch.round(x) > x0  # round-half-even corner choice
    sely = torch.round(y) > y0
    srow = torch.where(sely[..., None], s1, s0)
    near = torch.where(selx[..., None], srow[..., 10:], srow[..., :10])
    return bil, near[..., 3:6], near[..., 6:9], near[..., 9] > 0.8


def projective_warp(transform: torch.Tensor, disp: torch.Tensor, intr: torch.Tensor, stride: int = 1,
                    row0: int = 0, full_hw: tuple[int, int] | None = None):
    """Dense projective warp + 2x6 SE(3) Jacobian; `disp` may be stride-
    sliced, coords address the full-resolution target. A row shard of the
    strided grid passes its first row `row0` (in strided rows) and the
    unsharded grid's (H, W) = (Hs * stride, Ws * stride) as `full_hw`.
    Returns (warped_grid (H, W, 2) in [-1, 1], dxdxi (H, W, 2, 6))."""
    d = disp[..., 0] if disp.dim() == 3 else disp
    Hs, Ws = d.shape
    H, W = full_hw if full_hw is not None else (Hs * stride, Ws * stride)
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + Hs, dtype=d.dtype, device=d.device) * stride,
        torch.arange(Ws, dtype=d.dtype, device=d.device) * stride, indexing="ij")
    us = (xs - cx) / fx
    vs = (ys - cy) / fy
    Ps = torch.stack([us, vs, torch.ones_like(us), d], dim=-1)
    Pt = Ps @ transform.T
    ut = Pt[..., 0] / Pt[..., 2]
    vt = Pt[..., 1] / Pt[..., 2]
    dt = Pt[..., 3] / Pt[..., 2]
    O = torch.zeros_like(ut)
    dxdxi = torch.stack(
        [
            dt * fx, O, -ut * dt * fx, -ut * vt * fx, (1 + ut * ut) * fx, -vt * fx,
            O, dt * fy, -vt * dt * fy, -(1 + vt * vt) * fy, ut * vt * fy, ut * fy,
        ],
        dim=-1,
    ).reshape(Hs, Ws, 2, 6)
    wx = 2.0 * (fx * ut + cx) / (W - 1) - 1.0
    wy = 2.0 * (fy * vt + cy) / (H - 1) - 1.0
    return torch.stack([wx, wy], dim=-1), dxdxi


def _weighted_normal_eq(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """H = (wJ)^T J, g = (wJ)^T r, n = sum(w)."""
    Jw = J * w[:, None]
    return Jw.T @ J, Jw.T @ r, torch.sum(w)


def solve_gn(A: torch.Tensor, b: torch.Tensor, lm: float = 1.0e-6) -> torch.Tensor:
    """Damped 6x6 solve (A + lm*I) dx = b, on the device (`solve_ex` does
    not read its error status back to the host)."""
    A = A + lm * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A, b.reshape(-1, 1))[0][:, 0]


class ConstraintGrid(NamedTuple):
    """The model side of one level's constraints on the strided grid, with
    the frame's per-constraint masks: every input of a normal-equation
    build but the frame's resampling pack. A row shard (pixel-sharded
    tracking, `core.tracker._shard_prep`) keeps the unsharded grid's size
    and its own first row."""

    disp: torch.Tensor  # (Hs, Ws, 1)
    vertex: torch.Tensor  # (Hs, Ws, 3)
    normal: torch.Tensor  # (Hs, Ws, 3)
    mask: torch.Tensor  # (Hs, Ws, 1) bool
    intensity: torch.Tensor  # (Hs, Ws, 1)
    frame_mask: torch.Tensor  # (Hs, Ws, 1) bool
    frame_gradmag: torch.Tensor  # (Hs, Ws)
    intr: torch.Tensor  # (4,)
    stride: int
    row0: int  # first strided row of this shard
    full_hw: tuple  # (Hs * stride, Ws * stride) of the unsharded grid


def constraint_grid(model: PyramidLevel, frame: PyramidLevel, stride: int = 1) -> ConstraintGrid:
    """The strided constraint grid of one level (x[::stride, ::stride])."""
    sl = (lambda x: decimate2d(x, stride)) if stride > 1 else (lambda x: x)
    disp = sl(model.disp)
    return ConstraintGrid(disp=disp, vertex=sl(model.vertex), normal=sl(model.normal), mask=sl(model.mask),
                          intensity=sl(model.intensity), frame_mask=sl(frame.mask),
                          frame_gradmag=sl(frame.grad[..., 2]), intr=model.intr, stride=stride, row0=0,
                          full_hw=(disp.shape[0] * stride, disp.shape[1] * stride))


def build_normal_equations(model: PyramidLevel, frame: PyramidLevel, transform: torch.Tensor,
                           angle_thres_deg: float, dist_thres: float, use_rgb: bool,
                           rgb_weight: float, stride: int = 1, pack: torch.Tensor | None = None):
    """One GN build at one pyramid level: (A (6, 6), b (6,), valid count,
    icp residual-square sum, icp count), with the reference's gates."""
    if pack is None:
        pack = sampling_pack(frame)
    return grid_normal_equations(constraint_grid(model, frame, stride), pack, transform, angle_thres_deg,
                                 dist_thres, use_rgb, rgb_weight)


def grid_normal_equations(grid: ConstraintGrid, pack: torch.Tensor, transform: torch.Tensor,
                          angle_thres_deg: float, dist_thres: float, use_rgb: bool, rgb_weight: float):
    """`build_normal_equations` over a constraint grid or a row shard of
    one; the partial sums of a split add up to the whole grid's."""
    m_vert, m_norm, m_mask, m_int = grid.vertex, grid.normal, grid.mask, grid.intensity
    f_mask_orig, f_gradmag = grid.frame_mask, grid.frame_gradmag
    coords, Jc = projective_warp(transform, grid.disp, grid.intr, grid.stride, grid.row0, grid.full_hw)
    c = coords.reshape(-1, 2)
    bil, vcurr3, ncurr3, mwarp = _sample_packed(pack, coords)
    vcurr = vcurr3.reshape(-1, 3)
    ncurr = ncurr3.reshape(-1, 3)
    mask_warp = mwarp.reshape(-1)

    # ---- point-to-plane ICP ----
    vprev = (m_vert.reshape(-1, 3) @ transform[:3, :3].T) + transform[:3, 3]
    nprev = m_norm.reshape(-1, 3) @ transform[:3, :3].T
    delta_v = vcurr - vprev
    cross_n = torch.linalg.cross(ncurr, nprev, dim=-1)
    dist = torch.linalg.vector_norm(delta_v, dim=-1)
    sine = torch.linalg.vector_norm(cross_n, dim=-1)

    bound = 0.98
    inb_icp = (c[:, 0] > -bound) & (c[:, 0] < bound) & (c[:, 1] > -bound) & (c[:, 1] < bound)
    nan_mask = ~torch.any(torch.isnan(cross_n), dim=-1)
    pos_mask = vprev[:, 2] > 0
    gates = (sine < math.sin(angle_thres_deg * math.pi / 180.0)) & (dist < dist_thres)
    w_icp = (inb_icp & nan_mask & pos_mask & gates
             & m_mask.reshape(-1) & f_mask_orig.reshape(-1)).to(coords.dtype)

    r_icp = torch.nan_to_num(torch.sum(ncurr * delta_v, dim=-1))
    J_icp = torch.nan_to_num(torch.cat([ncurr, torch.linalg.cross(vprev, ncurr, dim=-1)], dim=-1))
    A, b, n = _weighted_normal_eq(J_icp, r_icp, w_icp)
    r2_icp = torch.sum(w_icp * r_icp * r_icp)
    n_icp = n

    # ---- photometric ----
    if use_rgb:
        sample_I = bil[..., 0]
        Ji = bil[..., 1:3]
        bound = 0.90
        inb_rgb = (c[:, 0] > -bound) & (c[:, 0] < bound) & (c[:, 1] > -bound) & (c[:, 1] < bound)
        grad_gate = f_gradmag.reshape(-1) > 1.0
        w_rgb = (inb_rgb & m_mask.reshape(-1) & grad_gate & mask_warp).to(coords.dtype)
        J_rgb = torch.nan_to_num(torch.einsum("hwk,hwkj->hwj", Ji, Jc).reshape(-1, 6))
        r_rgb = torch.nan_to_num((m_int[..., 0] - sample_I).reshape(-1))
        A_rgb, b_rgb, n_rgb = _weighted_normal_eq(J_rgb, r_rgb, w_rgb)
        A = A + rgb_weight * A_rgb
        b = b + rgb_weight * b_rgb
        n = n + n_rgb
    return A, b, n, r2_icp, n_icp
