"""Trajectory, render and reconstruction evaluation (port of
`eggfusion_tpu/utils/eval.py`). Host numpy and scipy, as in the JAX module.

  ate_rmse / cumulative_ate  Horn-aligned ATE RMSE in centimeters;
  matrix_to_tum              a TUM trajectory row;
  psnr / ssim / ms_ssim /    render metrics of one view (`eval_render`);
  depth_l1
  unproject_depth /          accuracy, completeness and F1 of the map
  eval_recon                 against observed depth clouds.

LPIPS needs pretrained AlexNet weights, which the repository does not ship
and a run may not fetch: `eval_render` reports it as None with a note.
"""
from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray):
    """Closed-form Horn alignment of two (3, N) trajectories.

    Returns (rot, trans, per-point translational error)."""
    model_c = model - model.mean(axis=1, keepdims=True)
    data_c = data - data.mean(axis=1, keepdims=True)
    W = model_c @ data_c.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(axis=1, keepdims=True) - rot @ model.mean(axis=1, keepdims=True)
    err = rot @ model + trans - data
    return rot, trans, np.sqrt(np.sum(err * err, axis=0))


def ate_rmse(poses_ref: np.ndarray, poses_est: np.ndarray) -> float:
    """ATE RMSE in centimeters. poses_*: (N, 3) translations."""
    est = np.asarray(poses_est, np.float64).T
    ref = np.asarray(poses_ref, np.float64).T
    _, _, err = horn_align(est, ref)
    return float(np.sqrt(err @ err / len(err)) * 100.0)


def cumulative_ate(poses_ref: np.ndarray, poses_est: np.ndarray) -> np.ndarray:
    """ATE RMSE (cm) of every trajectory prefix from running sums (one 3x3
    SVD per prefix)."""
    m = np.asarray(poses_est, np.float64)
    d = np.asarray(poses_ref, np.float64)
    n = len(m)
    out = np.empty(n)
    sum_m = np.zeros(3)
    sum_d = np.zeros(3)
    sum_mm = 0.0
    sum_dd = 0.0
    sum_W = np.zeros((3, 3))
    for k in range(n):
        sum_m += m[k]
        sum_d += d[k]
        sum_mm += m[k] @ m[k]
        sum_dd += d[k] @ d[k]
        sum_W += np.outer(m[k], d[k])
        c = k + 1
        mu_m = sum_m / c
        mu_d = sum_d / c
        S_mm = sum_mm - c * (mu_m @ mu_m)
        S_dd = sum_dd - c * (mu_d @ mu_d)
        W = sum_W - c * np.outer(mu_m, mu_d)
        U, sig, Vh = np.linalg.svd(W.T)
        sign = np.sign(np.linalg.det(U) * np.linalg.det(Vh)) or 1.0
        tr = sig[0] + sig[1] + sign * sig[2]
        sq = max(S_mm + S_dd - 2.0 * tr, 0.0)
        out[k] = np.sqrt(sq / c) * 100.0
    return out


def matrix_to_tum(ts: float, matrix: np.ndarray) -> list:
    """[ts, tx, ty, tz, qx, qy, qz, qw] of a c2w matrix."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(matrix[:3, :3]).as_quat()
    p = matrix[:3, 3]
    return [ts, p[0], p[1], p[2], q[0], q[1], q[2], q[3]]


def psnr(est: np.ndarray, ref: np.ndarray, mask: np.ndarray | None = None) -> float:
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    if mask is not None:
        m = np.broadcast_to(np.asarray(mask, bool), est.shape)
        diff2 = ((est - ref) ** 2)[m]
    else:
        diff2 = (est - ref) ** 2
    mse = float(diff2.mean()) if diff2.size else float("nan")
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def _gauss(x: np.ndarray, sig: float = 1.5) -> np.ndarray:
    """Gaussian window of the SSIM family (over H and W only)."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(x, sigma=(sig, sig, 0) if x.ndim == 3 else sig)


SSIM_C1, SSIM_C2 = 0.01**2, 0.03**2


def ssim(est: np.ndarray, ref: np.ndarray) -> float:
    """Single-scale SSIM with a Gaussian window (sigma 1.5) and the standard
    constants."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    mu1, mu2 = _gauss(est), _gauss(ref)
    mu1s, mu2s, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _gauss(est * est) - mu1s
    s2 = _gauss(ref * ref) - mu2s
    s12 = _gauss(est * ref) - mu12
    m = ((2 * mu12 + SSIM_C1) * (2 * s12 + SSIM_C2)) / ((mu1s + mu2s + SSIM_C1) * (s1 + s2 + SSIM_C2))
    return float(m.mean())


def ms_ssim(est: np.ndarray, ref: np.ndarray, levels: int = 5) -> float:
    """Multi-scale SSIM (Wang et al. 2003) with the standard weights: each
    level contributes contrast-structure, the last adds luminance; scales are
    2x2 average pools. Uses fewer levels when the image gets smaller than the
    11-pixel window, and falls back to `ssim` below one level."""
    weights = np.asarray([0.0448, 0.2856, 0.3001, 0.2363, 0.1333], np.float64)[:levels]
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)

    def cs_and_ssim(a, b):
        mu1, mu2 = _gauss(a), _gauss(b)
        mu1s, mu2s, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = _gauss(a * a) - mu1s
        s2 = _gauss(b * b) - mu2s
        s12 = _gauss(a * b) - mu12
        cs = (2 * s12 + SSIM_C2) / (s1 + s2 + SSIM_C2)
        lum = (2 * mu12 + SSIM_C1) / (mu1s + mu2s + SSIM_C1)
        return float(cs.mean()), float((lum * cs).mean())

    def pool(x):
        h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
        x = x[:h, :w]
        return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])

    vals = []
    a, b = est, ref
    for li in range(len(weights)):
        if min(a.shape[0], a.shape[1]) < 11:
            break
        cs, ss = cs_and_ssim(a, b)
        vals.append(max(ss if li == len(weights) - 1 else cs, 1e-12))
        if li < len(weights) - 1:
            a, b = pool(a), pool(b)
    if not vals:
        return ssim(est, ref)
    w = weights[: len(vals)] / weights[: len(vals)].sum()
    return float(np.prod(np.asarray(vals) ** w))


def depth_l1(est: np.ndarray, ref: np.ndarray, mask: np.ndarray | None = None) -> float:
    est = np.asarray(est, np.float64).squeeze()
    ref = np.asarray(ref, np.float64).squeeze()
    m = ref > 0 if mask is None else (np.asarray(mask, bool).squeeze() & (ref > 0))
    if not m.any():
        return float("nan")
    return float(np.abs(est - ref)[m].mean())


def eval_render(ref_color, ref_depth, est_color, est_depth) -> dict:
    """PSNR / SSIM / MS-SSIM / depth-L1 on the depth-valid region (the
    colors are zeroed where the reference depth is invalid), plus LPIPS
    (None without weights, with `lpips_note`)."""
    ref_color = np.asarray(ref_color, np.float64)
    est_color = np.asarray(est_color, np.float64)
    mask = np.asarray(ref_depth).squeeze() > 0
    ec = est_color * mask[..., None]
    rc = ref_color * mask[..., None]
    out = {
        "psnr": psnr(est_color, ref_color, mask[..., None]),
        "ssim": ssim(ec, rc),
        "ms_ssim": ms_ssim(ec, rc),
        "depth_l1": depth_l1(est_depth, ref_depth),
    }
    lp = _lpips(ec, rc)
    out["lpips"] = lp
    if lp is None:
        out["lpips_note"] = "unavailable (no local AlexNet weights)"
    return out


def unproject_depth(depth: np.ndarray, intr, c2w: np.ndarray, stride: int = 4) -> np.ndarray:
    """World-frame points (M, 3) of a depth map, every `stride`-th pixel;
    `intr` is (fx, fy, cx, cy); depths <= 0 are dropped."""
    d = np.asarray(depth, np.float64).squeeze()[::stride, ::stride]
    fx, fy, cx, cy = [float(x) for x in np.asarray(intr).reshape(-1)[:4]]
    H, W = d.shape
    ys, xs = np.mgrid[0:H, 0:W]
    xs = xs * stride
    ys = ys * stride
    m = d > 0
    z = d[m]
    x = (xs[m] - cx) / fx * z
    y = (ys[m] - cy) / fy * z
    pts = np.stack([x, y, z, np.ones_like(z)], axis=0)
    return (np.asarray(c2w, np.float64) @ pts)[:3].T


def eval_recon(map_xyz: np.ndarray, obs_clouds: list, thresh: float = 0.01,
               max_points: int = 200_000, rng=None) -> dict:
    """Accuracy (map point -> nearest observed point), completeness
    (observed point -> nearest map point) and their F-score at `thresh`
    (meters), against the observed depth clouds. Clouds above `max_points`
    are subsampled with `rng` (default `np.random.default_rng(0)`)."""
    from scipy.spatial import cKDTree

    rng = rng or np.random.default_rng(0)
    obs = np.concatenate(obs_clouds, axis=0)
    if len(obs) == 0 or len(map_xyz) == 0:
        return {}
    if len(obs) > max_points:
        obs = obs[rng.choice(len(obs), max_points, replace=False)]
    mx = np.asarray(map_xyz, np.float64)
    if len(mx) > max_points:
        mx = mx[rng.choice(len(mx), max_points, replace=False)]
    acc = cKDTree(obs).query(mx, workers=-1)[0]
    comp = cKDTree(mx).query(obs, workers=-1)[0]
    precision = float((acc < thresh).mean())
    recall = float((comp < thresh).mean())
    return {
        "recon_acc_mean": float(acc.mean()),
        "recon_acc_p90": float(np.quantile(acc, 0.9)),
        "recon_comp_mean": float(comp.mean()),
        "recon_comp_p90": float(np.quantile(comp, 0.9)),
        "recon_precision": precision,
        "recon_recall": recall,
        "recon_f1": (2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0),
        "recon_thresh_m": thresh,
        "n_map_points": int(len(mx)),
        "n_obs_points": int(len(obs)),
    }


def _lpips(est: np.ndarray, ref: np.ndarray) -> float | None:
    """LPIPS(alex) needs pretrained AlexNet weights; none ship with the
    repository, so it is unavailable (None)."""
    return None
