"""The reference that decides `correct`: the benchmark's own scene and
ground-truth trajectory, against which the program's outputs are judged.

Plain torch and numpy. It imports nothing of the program: the harness hands
it the program's outputs as plain tensors (the estimated poses, the active
surfels' centres, the model view of the window's last frame: depth, color
and the pixels taken from the render) and the stream the benchmark
generated. What the program derived from the inputs (its map, its render)
the reference works out again from the scene: the ray-cast depth and
texture at a pose, a point's distance to the scene's surface.

Every number is a gap, in millimetres or 8-bit color levels, between an
output and what the reference says it should be; `judge` holds each against
its limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.gen import scene as scenes


def _quantiles(x: torch.Tensor, qs) -> list:
    """Quantiles of a 1-D tensor by linear interpolation (numpy's default),
    for any length."""
    v = torch.sort(x).values
    out = []
    for q in qs:
        pos = q * (len(v) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(v) - 1)
        out.append(float(v[lo] + (v[hi] - v[lo]) * (pos - lo)))
    return out


def _centres(w2c: np.ndarray) -> np.ndarray:
    """Camera centres (N, 3) of w2c poses (N, 4, 4)."""
    R, t = w2c[:, :3, :3], w2c[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def pose_numbers(est_w2c: np.ndarray, gt_w2c: np.ndarray) -> dict:
    """Tracking: `rpe_mm`, the largest error of a frame's motion from the
    frame before (the translation of est_rel^-1 gt_rel); `ate_mm`, the root
    mean square camera-centre error; `rot_deg`, the largest rotation error.
    Both trajectories are float64 w2c (N, 4, 4) in one world frame."""
    est, gt = np.asarray(est_w2c, np.float64), np.asarray(gt_w2c, np.float64)
    ate = np.linalg.norm(_centres(est) - _centres(gt), axis=1)
    rel_e = est[1:] @ np.linalg.inv(est[:-1])
    rel_g = gt[1:] @ np.linalg.inv(gt[:-1])
    err = np.linalg.inv(rel_e) @ rel_g
    rpe = np.linalg.norm(err[:, :3, 3], axis=1)
    dR = np.linalg.inv(est[:, :3, :3]) @ gt[:, :3, :3]
    cos = np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)
    return {"rpe_mm": float(rpe.max() * 1e3) if len(rpe) else 0.0,
            "rpe_p50_mm": float(np.median(rpe) * 1e3) if len(rpe) else 0.0,
            "ate_mm": float(math.sqrt(np.mean(ate ** 2)) * 1e3),
            "ate_max_mm": float(ate.max() * 1e3),
            "rot_deg": float(np.degrees(np.arccos(cos)).max())}


def surface_distance(planes: np.ndarray, p: torch.Tensor) -> torch.Tensor:
    """Distance (M,) of points (M, 3) from the surface of the convex scene
    {x : n . x <= d}: for a point inside, to the nearest plane; outside, by
    the plane it lies furthest beyond (exact near a face)."""
    pl = torch.as_tensor(np.asarray(planes), dtype=p.dtype, device=p.device)
    s = p @ pl[:, :3].T - pl[:, 3]
    return torch.abs(torch.amax(s, dim=1))


def map_numbers(planes: np.ndarray, xyz_scene: torch.Tensor) -> dict:
    """Mapping: the median and the 95th percentile (`map_mm`,
    `map_p95_mm`) of the active surfels' distance to the scene's surface."""
    if xyz_scene.shape[0] == 0:
        return {"map_mm": math.inf, "map_p95_mm": math.inf, "surfels": 0}
    d = surface_distance(planes, xyz_scene.to(torch.float64)) * 1e3
    q = _quantiles(d, (0.5, 0.95))
    return {"map_mm": q[0], "map_p95_mm": q[1], "surfels": int(xyz_scene.shape[0])}


def view_numbers(planes: np.ndarray, intr: tuple, w2c_scene: np.ndarray, depth: torch.Tensor,
                 mask: torch.Tensor) -> dict:
    """Renderer: the median gap (`view_mm`) between the model view's depth
    (H, W) and the scene's depth ray-cast at the same pose, over the
    pixels the program took from its render (`mask`); `view_share`, the
    share of such pixels. No pixel reads as an infinite gap."""
    ref, _ = scenes.raycast(planes, intr, w2c_scene, device=depth.device, dtype=torch.float64)
    m = mask.bool() & (ref > 0)
    share = float(m.float().mean())
    if not bool(m.any()):
        return {"view_mm": math.inf, "view_p90_mm": math.inf, "view_share": share}
    gap = torch.abs(depth.to(torch.float64)[m] - ref[m]) * 1e3
    q = _quantiles(gap, (0.5, 0.9))
    return {"view_mm": q[0], "view_p90_mm": q[1], "view_share": share}


def _box(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    """The mean over a k x k window around each pixel of an (H, W, C) image
    (over the pixels inside the image)."""
    y = F.avg_pool2d(x.permute(2, 0, 1)[None], k, 1, k // 2, count_include_pad=False)
    return y[0].permute(1, 2, 0)


def color_numbers(planes: np.ndarray, detail: float, offset: tuple, intr: tuple, w2c_scene: np.ndarray,
                  color: torch.Tensor, mask: torch.Tensor) -> dict:
    """Renderer and map optimization: the model view's color (H, W, 3) in
    [0, 1] against the scene's texture ray-cast at the same pose, over the
    pixels the program took from its render (`mask`). `view_color_levels`:
    the median gap in 8-bit levels (averaged over the three channels), with
    its 90th percentile and mean; `view_color_dssim`: the median of 1 -
    SSIM (7 x 7 windows, averaged over the channels), which reads blur and
    ghosting rather than a uniform bias. The surfels' colors are what the
    window optimization fits; fusion and spawning alone leave them at an
    average of the colors seen."""
    ref_depth, p_w = scenes.raycast(planes, intr, w2c_scene, device=color.device, dtype=torch.float64)
    ref = scenes.texture(p_w, detail, offset)
    col = color.to(torch.float64)
    m = mask.bool() & (ref_depth > 0)
    if not bool(m.any()):
        return {k: math.inf for k in ("view_color_levels", "view_color_p90_levels", "view_color_mean_levels",
                                       "view_color_dssim")}
    gap = torch.mean(torch.abs(col[m] - ref[m]), dim=-1) * 255.0
    q = _quantiles(gap, (0.5, 0.9))
    mr, mc = _box(ref), _box(col)
    vr, vc, cov = _box(ref * ref) - mr * mr, _box(col * col) - mc * mc, _box(ref * col) - mr * mc
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mr * mc + c1) * (2 * cov + c2)) / ((mr * mr + mc * mc + c1) * (vr + vc + c2))
    dssim = _quantiles(1.0 - ssim.mean(dim=-1)[m], (0.5,))[0]
    return {"view_color_levels": q[0], "view_color_p90_levels": q[1], "view_color_mean_levels": float(gap.mean()),
            "view_color_dssim": dssim}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit: (all within, {name: {value,
    limit}}). A number passes when it is at most its limit; a NaN or a
    missing number fails."""
    out = {name: {"value": numbers.get(name, math.nan), "limit": lim} for name, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in out.values()), out
