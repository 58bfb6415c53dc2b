"""Image-processing ops (port of `eggfusion_tpu/ops/image.py`).

Plain PyTorch: vertex/normal maps from depth, Scharr gradients, border-
renormalized Gaussian downsampling, the bilateral depth filters, grid
sampling and forward differences. Images are channel-last (H, W, C) as in
the JAX package. Shifted-window sums stay shift-and-add loops over padded
images (no convolutions); the blur + decimate is two banded float32 matrix
products, as in the JAX module (TF32 is off, see `utils.device`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _grid(H: int, W: int, like: torch.Tensor):
    return torch.meshgrid(torch.arange(H, dtype=like.dtype, device=like.device),
                          torch.arange(W, dtype=like.dtype, device=like.device), indexing="ij")


def _vertex_diff_planes(X, Y, Z):
    """Forward differences a = v[y+1]-v, b = v[x+1]-v as 6 (H, W) planes."""

    def dx(p):
        return torch.cat([p[:, 1:], p[:, -1:]], dim=1) - p

    def dy(p):
        return torch.cat([p[1:, :], p[-1:, :]], dim=0) - p

    return dy(X), dy(Y), dy(Z), dx(X), dx(Y), dx(Z)


def _cross_normalize_planes(ax, ay, az, bx, by, bz):
    nx = ay * bz - az * by
    ny = az * bx - ax * bz
    nz = ax * by - ay * bx
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    scale = torch.where(norm > 1e-12, 1.0 / torch.clamp(norm, min=1e-12), torch.zeros_like(norm))
    return torch.stack([nx * scale, ny * scale, nz * scale], dim=-1)


def compute_vertex_and_normal(depth: torch.Tensor, intr):
    """Vertex + normal maps (H, W, 3) from an (H, W[, 1]) depth map."""
    d = depth[..., 0] if depth.dim() == 3 else depth
    H, W = d.shape
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    ys, xs = _grid(H, W, d)
    X = (xs - cx) * d / fx
    Y = (ys - cy) * d / fy
    vmap = torch.stack([X, Y, d], dim=-1)
    nmap = _cross_normalize_planes(*_vertex_diff_planes(X, Y, d))
    return vmap, nmap


# Effective correlation kernels of the reference's gradient kernel
_SCHARR_X = np.array(
    [[-0.52201, 0.0, 0.52201], [-0.79451, 0.0, 0.79451], [-0.52201, 0.0, 0.52201]], dtype=np.float32
)
_SCHARR_Y = _SCHARR_X.T.copy()


def _correlate3x3(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """3x3 correlation with zero padding on a (H, W) image (shift-add)."""
    H, W = img.shape
    pad = F.pad(img, (1, 1, 1, 1))
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            if k[dy, dx] != 0.0:
                out = out + float(k[dy, dx]) * pad[dy:dy + H, dx:dx + W]
    return out


def scharr_gradient(img: torch.Tensor):
    """Scharr-like gradients of a (H, W) or (H, W, 1) image -> (gx, gy)."""
    im = img[..., 0] if img.dim() == 3 else img
    return _correlate3x3(im, _SCHARR_X), _correlate3x3(im, _SCHARR_Y)


_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32)
_GAUSS5x5 = np.outer(_BINOMIAL5, _BINOMIAL5)


@functools.lru_cache(maxsize=None)
def _decimation_matrix_cached(n: int, taps_key, stride: int, device: str) -> torch.Tensor:
    """One upload per (size, taps, device): a per-call upload from pageable
    memory would also stall the host until the device caught up."""
    taps = np.asarray(taps_key, np.float64)
    r = len(taps) // 2
    no = -(-n // stride)
    D = np.zeros((no, n), np.float32)
    for o in range(no):
        c = o * stride
        lo, hi = max(0, c - r), min(n, c + r + 1)
        w = taps[lo - c + r: hi - c + r]
        D[o, lo:hi] = w / w.sum()
    return torch.as_tensor(D, device=device)


def _decimation_matrix(n: int, taps: np.ndarray, stride: int, like: torch.Tensor) -> torch.Tensor:
    """(ceil(n/stride), n) banded blur+decimate matrix, rows renormalized by
    the in-bounds weight sum, on `like`'s device."""
    return _decimation_matrix_cached(n, tuple(np.asarray(taps, np.float64).tolist()), stride,
                                     str(like.device))


def _blur_decimate2(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable renormalized blur + stride-2 decimation of (H, W, C)."""
    H, W, _C = img.shape
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    ky = kernel[:, pw].astype(np.float64)
    kx = kernel[ph, :].astype(np.float64) / float(kernel[ph, pw])
    Dr = _decimation_matrix(H, ky, 2, img)
    Dc = _decimation_matrix(W, kx, 2, img)
    x = img.permute(2, 0, 1)  # (C, H, W)
    out = torch.einsum("oh,chw->cow", Dr, x)
    out = torch.einsum("wv,cov->cow", Dc, out)
    return out.permute(1, 2, 0)


def decimate2d(x: torch.Tensor, stride: int) -> torch.Tensor:
    """x[::stride, ::stride] of an (H, W[, C]) map (exact; the JAX module's
    one-hot matrix products compute the same values)."""
    if stride == 1:
        return x
    return x[::stride, ::stride]


def gaussian_downsample(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur + 2x decimation, border-renormalized; output
    floor(H/2) x floor(W/2). Accepts (H, W, C) or (H, W)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W, _ = img.shape
    out = _blur_decimate2(img, _GAUSS5x5)[: H // 2, : W // 2]
    return out[..., 0] if squeeze else out


def bilateral_filter(img: torch.Tensor, window_size: int = 13, sigma_color: float = 0.03,
                     sigma_space: float = 4.5) -> torch.Tensor:
    """Single-channel bilateral filter; out-of-bounds taps are excluded from
    both numerator and normalizer. img: (H, W) or (H, W, 1)."""
    squeeze = img.dim() == 3
    x = img[..., 0] if squeeze else img
    r = window_size // 2
    H, W = x.shape
    inv_s = 1.0 / (2.0 * sigma_space * sigma_space)
    inv_c = 1.0 / (2.0 * sigma_color * sigma_color)
    pad = F.pad(x, (r, r, r, r))
    valid = F.pad(torch.ones_like(x), (r, r, r, r))
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = pad[r + dy: r + dy + H, r + dx: r + dx + W]
            vm = valid[r + dy: r + dy + H, r + dx: r + dx + W]
            dc = x - nb
            w = torch.exp(-(dy * dy + dx * dx) * inv_s - dc * dc * inv_c) * vm
            num = num + nb * w
            den = den + w
    out = num / den
    return out[..., None] if squeeze else out


def bilateral_filter_separable(img: torch.Tensor, window_size: int = 13, sigma_color: float = 0.03,
                               sigma_space: float = 4.5) -> torch.Tensor:
    """Separable approximation of the bilateral filter (row pass then column
    pass)."""
    squeeze = img.dim() == 3
    x = img[..., 0] if squeeze else img
    r = window_size // 2
    inv_s = 1.0 / (2.0 * sigma_space * sigma_space)
    inv_c = 1.0 / (2.0 * sigma_color * sigma_color)

    def pass1d(v, axis):
        H, W = v.shape
        padding = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
        pad = F.pad(v, padding)
        valid = F.pad(torch.ones_like(v), padding)
        num = torch.zeros_like(v)
        den = torch.zeros_like(v)
        for d in range(-r, r + 1):
            if axis == 0:
                nb, vm = pad[r + d: r + d + H, :], valid[r + d: r + d + H, :]
            else:
                nb, vm = pad[:, r + d: r + d + W], valid[:, r + d: r + d + W]
            dc = v - nb
            w = torch.exp(-(d * d) * inv_s - dc * dc * inv_c) * vm
            num = num + nb * w
            den = den + w
        return num / den

    out = pass1d(pass1d(x, 0), 1)
    return out[..., None] if squeeze else out


def bilateral(mode: str):
    """The depth filter of `System.bilateral_mode` ("exact" | "separable")."""
    return bilateral_filter_separable if mode == "separable" else bilateral_filter


def _unnormalize(coords: torch.Tensor, H: int, W: int):
    """[-1, 1] normalized coords -> pixel coords, align_corners=True."""
    x = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    return x, y


def gather_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """Integer-valued float coords -> gather indices in [0, n - 1]; NaN reads
    index 0, as the JAX module's float->int cast does (torch casts NaN to
    INT64_MIN, a device-side assert in the gather)."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, n - 1).long()


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor, padding: str = "zeros") -> torch.Tensor:
    """Bilinear sample of (H, W, C) at normalized coords (..., 2)
    (align_corners=True); padding 'zeros' | 'border'."""
    H, W, _C = img.shape
    x, y = _unnormalize(coords, H, W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0

    def gather(ix, iy):
        ic = gather_index(ix, W)
        jc = gather_index(iy, H)
        vals = img[jc, ic]
        if padding == "zeros":
            inb = ((ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)).to(img.dtype)
            vals = vals * inb[..., None]
        return vals

    v00 = gather(x0, y0)
    v10 = gather(x0 + 1, y0)
    v01 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    w00 = ((1 - dx) * (1 - dy))[..., None]
    w10 = (dx * (1 - dy))[..., None]
    w01 = ((1 - dx) * dy)[..., None]
    w11 = (dx * dy)[..., None]
    return v00 * w00 + v10 * w10 + v01 * w01 + v11 * w11


def nearest_sample(img: torch.Tensor, coords: torch.Tensor, padding: str = "border") -> torch.Tensor:
    """Nearest-neighbor sample of (H, W, C) at normalized coords (..., 2),
    round-half-even, border or zeros padding."""
    H, W, _C = img.shape
    x, y = _unnormalize(coords, H, W)
    ix = torch.round(x)
    iy = torch.round(y)
    ic = gather_index(ix, W)
    jc = gather_index(iy, H)
    vals = img[jc, ic]
    if padding == "zeros":
        inb = ((ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)).to(img.dtype)
        vals = vals * inb[..., None]
    return vals


def diff_gradients(depth: torch.Tensor):
    """Forward differences with a zero last column/row; (H, W[, 1]) ->
    (gx, gy), each (H, W)."""
    d = depth[..., 0] if depth.dim() == 3 else depth
    gx = torch.cat([d[:, 1:] - d[:, :-1], torch.zeros_like(d[:, :1])], dim=1)
    gy = torch.cat([d[1:, :] - d[:-1, :], torch.zeros_like(d[:1, :])], dim=0)
    return gx, gy
