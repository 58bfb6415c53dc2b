"""SE(3)/SO(3) Lie-group math (port of `eggfusion_tpu/geometry/lie.py`).

Conventions as in the JAX module:
  * so3 vector `theta` is the rotation axis-angle (3,).
  * se3 vector `tau` = [theta(3), rho(3)] for `se3_to_SE3`.
  * `update_transform`: dx = [dt(3), dw(3)]; R <- exp(dw) @ R, t <- dt + t.
"""
from __future__ import annotations

import torch

_EPS = 1e-7


def skew(x: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a (..., 3) vector -> (..., 3, 3)."""
    o = torch.zeros_like(x[..., 0])
    return torch.stack(
        [
            torch.stack([o, -x[..., 2], x[..., 1]], dim=-1),
            torch.stack([x[..., 2], o, -x[..., 0]], dim=-1),
            torch.stack([-x[..., 1], x[..., 0], o], dim=-1),
        ],
        dim=-2,
    )


def _safe_angle(theta: torch.Tensor):
    """(small, angle) with the norm replaced by 1 where tiny, so the untaken
    branch never yields NaN/inf."""
    norm2 = torch.sum(theta * theta, dim=-1)
    small = norm2 < 1e-10
    angle = torch.sqrt(torch.where(small, torch.ones_like(norm2), norm2))
    return small[..., None, None], angle[..., None, None]


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_to_SO3(theta: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) via Rodrigues, (..., 3) -> (..., 3, 3)."""
    W = skew(theta)
    W2 = W @ W
    small, safe = _safe_angle(theta)
    I = _eye3(W)
    taylor = I + W + 0.5 * W2
    exact = I + (torch.sin(safe) / safe) * W + ((1.0 - torch.cos(safe)) / (safe**2)) * W2
    return torch.where(small, taylor, exact)


def SO3_to_so3(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3), (..., 3, 3) -> (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0 + _EPS, 1.0 - _EPS)
    theta = torch.arccos(cos_t)
    small = theta < 1e-5
    safe = torch.where(small, torch.ones_like(theta), theta)
    lnR = (theta / (2.0 * torch.sin(safe)))[..., None, None] * (R - R.transpose(-2, -1))
    w = torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)
    w_small = torch.stack(
        [
            (R[..., 2, 1] - R[..., 1, 2]) / 2.0,
            (R[..., 0, 2] - R[..., 2, 0]) / 2.0,
            (R[..., 1, 0] - R[..., 0, 1]) / 2.0,
        ],
        dim=-1,
    )
    return torch.where(small[..., None], w_small, w)


def V_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Left-Jacobian V of SO(3)."""
    W = skew(theta)
    W2 = W @ W
    small, safe = _safe_angle(theta)
    I = _eye3(W)
    taylor = I + 0.5 * W + (1.0 / 6.0) * W2
    exact = I + ((1.0 - torch.cos(safe)) / safe**2) * W + ((safe - torch.sin(safe)) / safe**3) * W2
    return torch.where(small, taylor, exact)


def se3_to_SE3(tau: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3): tau = [theta(3), rho(3)] -> 4x4."""
    theta, rho = tau[..., :3], tau[..., 3:]
    R = so3_to_SO3(theta)
    t = (V_matrix(theta) @ rho[..., None])[..., 0]
    T = torch.zeros(tau.shape[:-1] + (4, 4), dtype=tau.dtype, device=tau.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def SE3_to_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) -> se(3): returns [rho(3), theta(3)]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    theta = SO3_to_so3(R)
    Vinv = torch.linalg.inv_ex(V_matrix(theta))[0]  # _ex: no host sync
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, theta], dim=-1)


def update_transform(transform: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Apply the tracker's 6-DoF increment dx = [dt(3), dw(3)]:
    R <- exp(dw) @ R ;  t <- dt + t. Returns a new matrix."""
    dR = so3_to_SO3(dx[3:])
    T = transform.clone()
    T[:3, :3] = dR @ transform[:3, :3]
    T[:3, 3] = dx[:3] + transform[:3, 3]
    return T


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-2, -1)
    ti = -(Rt @ t[..., None])[..., 0]
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = ti
    out[..., 3, 3] = 1.0
    return out
