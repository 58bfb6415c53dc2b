"""Probabilistic surfel fusion (port of `eggfusion_tpu/ops/fusion.py`).

Information-form filter on the surfel state: each surfel reads the
measurement at its own (rounded) center pixel and fuses it if it is the
nearest surfel there (`winner_flags`, one stable sort by a fused
pixel|depth key) and the measurement agrees in position and normal. Every
per-surfel chain is componentwise on the transposed (k, N) state. Updates
write the surfel map in place (the JAX version donates it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from eggfusion_tpu_torch.core.surfels import SurfelConfig, SurfelMap, prune_surfels
from eggfusion_tpu_torch.geometry import sh as shlib
from eggfusion_tpu_torch.geometry import transforms as tf


def _center_pixels(xyz, active, w2c, intr, width: int, height: int):
    """Each surfel's rounded center pixel (u, v), validity and z."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    p_cam = w2c[:3, :3] @ xyz + w2c[:3, 3][:, None]
    z = p_cam[2]
    z_safe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = torch.round(fx * p_cam[0] / z_safe + cx)
    v = torch.round(fy * p_cam[1] / z_safe + cy)
    ok = active & (z > 0.05) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    # clip in float before the integer cast (out-of-range casts are undefined)
    u = torch.clamp(u, -1, width).to(torch.int64)
    v = torch.clamp(v, -1, height).to(torch.int64)
    return u, v, ok, z


def project_surfels_to_frame(xyz: torch.Tensor, active: torch.Tensor, w2c: torch.Tensor,
                             intr: torch.Tensor, width: int, height: int):
    """Per-pixel nearest-surfel index map (H, W) int (-1 where empty) and
    depth buffer (H, W) f32 (0 where empty); ties go to the larger index."""
    u, v, ok, z = _center_pixels(xyz, active, w2c, intr, width, height)
    HW = width * height
    pix = torch.where(ok, v * width + u, torch.full_like(u, HW))
    zbuf = torch.full((HW + 1,), float("inf"), dtype=torch.float32, device=xyz.device)
    zbuf = zbuf.scatter_reduce(0, pix, torch.where(ok, z, torch.full_like(z, float("inf"))), "amin")
    iswin = ok & (z <= zbuf[pix])
    idx = torch.arange(xyz.shape[-1], dtype=torch.int64, device=xyz.device)
    imap = torch.full((HW + 1,), -1, dtype=torch.int64, device=xyz.device)
    imap = imap.scatter_reduce(0, pix, torch.where(iswin, idx, torch.full_like(idx, -1)), "amax")
    depth = torch.where(torch.isfinite(zbuf[:HW]), zbuf[:HW], torch.zeros_like(zbuf[:HW]))
    return imap[:HW].reshape(height, width), depth.reshape(height, width)


class FusionStats(NamedTuple):
    fused_pixels: torch.Tensor  # () i32 number of pixels fused into surfels
    error_pixels: torch.Tensor  # () i32 association failures counted as errors


WINNER_DEPTH_BITS = 12
WINNER_DEPTH_FAR = 20.0


def winner_flags(xyz, active, w2c, intr, width: int, height: int):
    """Per-surfel nearest-at-its-pixel flags via one stable sort of an int64
    (pixel << 12 | quantized depth) key; frames too large for the 32-bit
    key budget sort exactly by (pixel, depth) instead, as the JAX module.
    Returns (winner (N,) bool, uc (N,), vc (N,)) with uc/vc clipped."""
    u, v, ok, z = _center_pixels(xyz, active, w2c, intr, width, height)
    HW = width * height
    pix = torch.where(ok, v * width + u, torch.full_like(u, HW))
    if (HW + 1) << WINNER_DEPTH_BITS <= 1 << 32:
        qmax = (1 << WINNER_DEPTH_BITS) - 1
        qz = torch.clamp(z * (qmax / WINNER_DEPTH_FAR), 0, qmax).to(torch.int64)
        skey, sidx = torch.sort((pix << WINNER_DEPTH_BITS) | qz, stable=True)
        spix = skey >> WINNER_DEPTH_BITS
    else:  # exact lexicographic (pixel, depth) order
        by_z = torch.sort(z, stable=True).indices
        by_pix = torch.sort(pix[by_z], stable=True).indices
        sidx = by_z[by_pix]
        spix = pix[sidx]
    first = torch.ones_like(spix, dtype=torch.bool)
    first[1:] = spix[1:] != spix[:-1]
    win_sorted = first & (spix < HW)
    winner = torch.empty_like(win_sorted)
    winner[sidx] = win_sorted
    return winner & ok, torch.clamp(u, 0, width - 1), torch.clamp(v, 0, height - 1)


def _fuse_with_winner(s: SurfelMap, winner, uc, vc, vertex_w, normal_w, color, depth, geo_mask,
                      fusion_dist_thres: float, cfg: SurfelConfig):
    """Information-filter fusion given the association flags; updates
    position/normal of touched unstable surfels, observe/error counts."""
    meas = torch.cat([vertex_w, normal_w, color, depth, geo_mask.to(torch.float32)], dim=-1)[vc, uc]
    mT = meas.T  # (11, N)
    v_m = mT[0:3]
    n_m = mT[3:6]
    c_m = mT[6:9]
    d_m = mT[9]
    valid_meas = (mT[10] > 0.5) & (d_m > 0)

    dvec = v_m - s.xyz
    dist2 = dvec[0] ** 2 + dvec[1] ** 2 + dvec[2] ** 2
    n_s = s.get_normal()
    ndot = n_m[0] * n_s[0] + n_m[1] * n_s[1] + n_m[2] * n_s[2]
    associate = (winner & valid_meas & (dist2 < fusion_dist_thres * fusion_dist_thres)
                 & (torch.abs(ndot) > 0.5))
    errors = winner & valid_meas & ~associate

    n_m = n_m * torch.where(ndot < 0, -1.0, 1.0)
    zero = torch.zeros_like(d_m)
    lam_p = torch.where(associate, 1.0 / torch.clamp((d_m * cfg.alpha_p) ** 2, min=1e-12), zero)
    lam_n = torch.where(associate, 1.0 / torch.clamp((d_m * cfg.alpha_n) ** 2, min=1e-12), zero)

    lam_p_old = 1.0 / s.sigma2[0]
    lam_n_old = 1.0 / s.sigma2[1]
    lam_p_new = lam_p_old + lam_p
    lam_n_new = lam_n_old + lam_n

    eta_new = s.eta + torch.cat([v_m * lam_p, n_m * lam_n], dim=0)
    xyz_new = eta_new[0:3] / lam_p_new
    normal_new = eta_new[3:6] / lam_n_new
    normal_new = normal_new / (
        torch.sqrt(normal_new[0] ** 2 + normal_new[1] ** 2 + normal_new[2] ** 2) + 1e-8)

    touched = associate
    fuse_geo = touched & ~s.stable & s.active
    rot_new = tf.rot_z_to_t(normal_new)
    col_new = (s.get_color() * lam_p_old + c_m * lam_p) / lam_p_new
    dc_new = shlib.rgb_to_sh(col_new)[:, None, :]

    fg = fuse_geo[None]
    tc = touched[None]
    s = s.replace(
        xyz=torch.where(fg, xyz_new, s.xyz),
        rotation=torch.where(fg, rot_new, s.rotation),
        features_dc=torch.where(fuse_geo[None, None], dc_new, s.features_dc),
        eta=torch.where(tc, eta_new, s.eta),
        sigma2=torch.where(tc, torch.stack([1.0 / lam_p_new, 1.0 / lam_n_new], dim=0), s.sigma2),
        observe_count=s.observe_count + touched.to(torch.int32),
        error_count=s.error_count + errors.to(torch.int32),
    )
    stats = FusionStats(
        fused_pixels=torch.sum(associate.to(torch.int32)),
        error_pixels=torch.sum(errors.to(torch.int32)),
    )
    return s, stats


def fuse_surfels(s: SurfelMap, imap, w2c, intr, vertex_w, normal_w, color, depth, geo_mask,
                 fusion_dist_thres: float, cfg: SurfelConfig):
    """Fusion against an explicit index map (the exact z-buffer association)."""
    H, W = imap.shape
    u, v, ok, _z = _center_pixels(s.xyz, s.active, w2c, intr, W, H)
    uc = torch.clamp(u, 0, W - 1)
    vc = torch.clamp(v, 0, H - 1)
    winner = ok & (imap[vc, uc] == torch.arange(s.capacity, device=imap.device))
    return _fuse_with_winner(s, winner, uc, vc, vertex_w, normal_w, color, depth, geo_mask,
                             fusion_dist_thres, cfg)


def fuse_frame(s: SurfelMap, w2c, intr, vertex_w, normal_w, color, depth, geo_mask,
               fusion_dist_thres: float, cfg: SurfelConfig):
    """Per-frame fusion: sort-based winner association + gather-form
    information fusion (the hot path of `core.mapper.map_update`)."""
    H, W = vertex_w.shape[:2]
    winner, uc, vc = winner_flags(s.xyz, s.active, w2c, intr, W, H)
    return _fuse_with_winner(s, winner, uc, vc, vertex_w, normal_w, color, depth, geo_mask,
                             fusion_dist_thres, cfg)


def prune_unstable(s: SurfelMap, cfg: SurfelConfig, time, max_age: int = 30):
    """Cull surfels observed mostly in error and old unstable surfels that
    never gained confidence."""
    age = time - s.tic
    bad_errors = (s.error_count > 5) & (s.error_count > 3 * s.observe_count)
    stale = (age > max_age) & (~s.stable) & (s.observe_count < 2)
    return prune_surfels(s, s.active & (bad_errors | stale))
