"""Trajectory evaluation (port of `eggfusion_tpu/utils/eval.py`, the
trajectory part): Horn alignment, ATE RMSE in centimeters, and the O(n)
cumulative ATE curve. Host numpy."""
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
