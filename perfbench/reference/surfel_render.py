"""A plain reference render of the program's surfel map: no tiles, no tile
caps. Every surfel whose footprint covers a pixel is composited there,
front to back in the order of the surfels' view depth. It follows upstream's
forward pass (diff-gaussian-surfels, the 3DGS rasterizer it forks): color
from SH, depth, normal, alpha, the alpha floor and the transmittance stop.

    out = render(surfels, w2c, intr, width, height)        # (H, W, C) maps
    counts = subcolumn_counts(surfels, w2c, intr, width, height)
    numbers = counters(counts, cap)                          # binned, tail, max_run

Plain torch. It imports nothing of the program and nothing of JAX, so it
runs on the card with the program's state freed. `surfels` holds the
program's parameterization as the program stores it, transposed (k, N):
`xyz` (3, N), `rotation` (4, N) quaternion wxyz, not normalized,
`scaling` (3, N) log scales, `opacity` (1, N) logit, `features_dc`
(3, 1, N) and `features_rest` (3, R, N) SH coefficients, `active` (N,).
`w2c` is (4, 4); `intr` is (fx, fy, cx, cy). Inputs and projection are
float32, with TF32 off for the call. The transmittance prefix and the sums
are float64, so the reference's own rounding stays far below a float32
render's. Pixels are processed in bands of rows, and surfels in chunks, so
a 1752x1168 view of millions of surfels fits on the card.

Per surfel, as the program projects it: the camera-frame centre; its
tangent axes (the first two columns of the rotation, scaled) through the
projection's Jacobian, plus a 0.3 px^2 low-pass, give the 2D covariance and
its inverse (the conic); the radius is 3 sqrt of its larger eigenvalue; the
color is SH of degree `sh_degree` along the ray from the camera centre,
+ 0.5 and clipped at 0; the normal is the rotation's third column, turned
to face the camera. Per pixel (centre at integer coordinates): alpha =
min(0.99, opacity exp(power)), left out below 1/255 or where the power is
positive; weights T alpha with T the product of (1 - alpha) in front; a
surfel whose T (1 - alpha) would fall below `t_stop` ends the pixel
(upstream's 1e-4). Depth per pixel is where the ray meets the surfel's
plane (the centre's depth where that plane is edge-on or nearer than the
near plane), and depth and normal are divided by the accumulated opacity
(at least 1e-6).

Departures from upstream, each the program's own choice:
- Footprint: a surfel covers the pixels inside the square of its radius
  around its centre; upstream evaluates every pixel of the 16x16 tiles that
  square touches. Neither set depends on a tile grid here.
- The radius is not rounded up to a whole pixel (upstream's `ceil`), the
  eigenvalue's discriminant is clipped at 0 (upstream's at 0.1), and the
  near plane is at 0.05 m (upstream culls at 0.2 m).
- The Jacobian takes the surfel's own view direction, not one clamped to
  1.3 times the field of view.
- No background term: the program's compositor adds none (upstream adds
  the background times the final T).
- Depth is the ray's intersection with the surfel's plane, as the program's
  compositor computes it; upstream's fork is not in the repository and is
  not followed here beyond what the program documents.

Against the program's tile renderer (`ops/raster_tile.py`) the reference
differs where the renderer departs from it: the renderer keeps, in each
32x32 sub-column, the nearest 3/4 of a fixed number of slots exactly and
then every fourth entry (the stratified tail), and drops the rest; a
surfel enters at most 2 x 2 sub-columns and tile rows, its radius clipped
at 31.5 px; it sorts by a 19-bit depth key (0.23 mm steps to 120 m), so
surfels closer in depth than that keep their index order; and it runs each
pixel to the end of its list, with no transmittance stop (`t_stop` 0
here). `subcolumn_counts` counts each sub-column's list as that renderer
bins it, before any cap, to check its counters against.
"""
from __future__ import annotations

import math

import torch

T_STOP = 1e-4  # upstream's transmittance stop
ALPHA_EPS = 1.0 / 255.0
MAX_ALPHA = 0.99
NEAR_Z = 0.05
LOWPASS = 0.3
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)

# the tile renderer's binning, for `subcolumn_counts`: 32-px sub-columns,
# 32-px tile rows, a window of 2 x 2 of them, radius clipped to fit it
SUB_W, TILE_H, WINDOW = 32, 32, 2
BIN_RADIUS_MAX = (WINDOW * 32 - 1) / 2


class _NoTF32:
    """TF32 off for the block, as it was after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _rotate(R, x):
    """R @ x for (3, 3) R and (3, N) x, one elementwise sum per row."""
    return R[:, 0:1] * x[0:1] + R[:, 1:2] * x[1:2] + R[:, 2:3] * x[2:3]


def _rotation(q):
    """(3, 3, N) rotation matrices of (4, N) quaternions wxyz."""
    r, x, y, z = q[0], q[1], q[2], q[3]
    inv = 1.0 / torch.sqrt(r * r + x * x + y * y + z * z + 1e-24)
    r, x, y, z = r * inv, x * inv, y * inv, z * inv
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)]),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)]),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]),
    ])


def _sh(deg: int, sh, d):
    """RGB (3, N) of SH coefficients (3, K, N) along unit directions (3, N)."""
    out = SH_C0 * sh[:, 0]
    if deg < 1:
        return out
    x, y, z = d[0], d[1], d[2]
    out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if deg < 2:
        return out
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5] + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
           + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg < 3:
        return out
    return (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11] + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13] + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])


def project(surfels: dict, w2c, intr, width: int, height: int, sh_degree: int = 3) -> dict:
    """Per surfel (N,): centre `u`, `v`, depth `z`, conic `a`, `b`, `c`,
    `radius`, `opacity`, `valid` (active, beyond the near plane, its square
    meeting the image), and rows `color`, `normal`, `p_cam` (N, 3)."""
    f32 = torch.float32
    xyz = surfels["xyz"].to(f32)
    dev = xyz.device
    w2c = torch.as_tensor(w2c, dtype=f32, device=dev)
    fx, fy, cx, cy = torch.as_tensor(intr, dtype=f32, device=dev).reshape(-1)[:4]
    R, t = w2c[:3, :3], w2c[:3, 3]
    p_cam = _rotate(R, xyz) + t[:, None]
    px, py, z = p_cam[0], p_cam[1], p_cam[2]
    z_safe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = fx * px / z_safe + cx
    v = fy * py / z_safe + cy

    q = surfels["rotation"].to(f32)
    q = q / (torch.linalg.vector_norm(q, dim=0, keepdim=True) + 1e-12)
    q = torch.nan_to_num(q, nan=1.0)
    Rs = _rotation(q)
    s = torch.exp(surfels["scaling"].to(f32))
    tu = _rotate(R, Rs[:, 0] * s[0])
    tv = _rotate(R, Rs[:, 1] * s[1])
    z_cov = torch.where(z <= NEAR_Z, torch.ones_like(z), z_safe)
    inv_z = 1.0 / z_cov
    inv_z2 = inv_z * inv_z
    ax = fx * (tu[0] * inv_z - px * tu[2] * inv_z2)
    ay = fy * (tu[1] * inv_z - py * tu[2] * inv_z2)
    bx = fx * (tv[0] * inv_z - px * tv[2] * inv_z2)
    by = fy * (tv[1] * inv_z - py * tv[2] * inv_z2)
    cxx = ax * ax + bx * bx + LOWPASS
    cxy = ax * ay + bx * by
    cyy = ay * ay + by * by + LOWPASS
    det = torch.clamp(cxx * cyy - cxy * cxy, min=1e-12)
    mid = 0.5 * (cxx + cyy)
    radius = 3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0)))

    cam = -(R.T @ t)
    dirs = xyz - cam[:, None]
    dirs = dirs / torch.sqrt(dirs[0] ** 2 + dirs[1] ** 2 + dirs[2] ** 2 + 1e-12)
    shs = torch.cat([surfels["features_dc"], surfels["features_rest"]], dim=1).to(f32)
    color = torch.clamp(_sh(sh_degree, shs, dirs) + 0.5, min=0.0)

    r, x, y, zq = surfels["rotation"].to(f32)
    inv = 1.0 / torch.sqrt(r * r + x * x + y * y + zq * zq + 1e-24)
    r, x, y, zq = r * inv, x * inv, y * inv, zq * inv
    nx, ny, nz = 2 * (x * zq + r * y), 2 * (y * zq - r * x), 1 - 2 * (x * x + y * y)
    inv_n = 1.0 / (torch.sqrt(nx * nx + ny * ny + nz * nz) + 1e-8)
    normal = _rotate(R, torch.stack([nx * inv_n, ny * inv_n, nz * inv_n]))
    flip = torch.sign(-torch.sum(normal * p_cam, dim=0))
    normal = normal * torch.where(flip == 0, torch.ones_like(flip), flip)

    inb = (z > NEAR_Z) & (u + radius > 0) & (u - radius < width) & (v + radius > 0) & (v - radius < height)
    valid = inb & surfels["active"].to(torch.bool)
    return {"u": u, "v": v, "z": z, "a": cyy / det, "b": -cxy / det, "c": cxx / det, "radius": radius,
            "opacity": torch.sigmoid(surfels["opacity"].to(f32)[0]), "valid": valid,
            "color": color.T, "normal": normal.T, "p_cam": p_cam.T}


def _pairs(lo_x, hi_x, lo_y, hi_y, width: int):
    """Every (surfel row, pixel) pair of the boxes [lo_x, hi_x] x [lo_y,
    hi_y] (inclusive, one per surfel row), as (row, x, y) int64."""
    nx = hi_x - lo_x + 1
    n = nx * (hi_y - lo_y + 1)
    row = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    start = torch.cumsum(n, 0) - n
    k = torch.arange(row.numel(), device=n.device) - start[row]
    return row, lo_x[row] + k % nx[row], lo_y[row] + torch.div(k, nx[row], rounding_mode="floor")


@torch.no_grad()
def render(surfels: dict, w2c, intr, width: int, height: int, sh_degree: int = 3, t_stop: float = T_STOP,
           band_rows: int = 32, max_pairs: int = 1 << 25) -> dict:
    """The reference render: `color` (H, W, 3), `depth` (H, W, 1), `normal`
    (H, W, 3), `opacity` (H, W, 1) float32, and `T` (H, W) the transmittance
    left. `t_stop` 0 runs every pixel to the end of its list."""
    with _NoTF32():
        P = project(surfels, w2c, intr, width, height, sh_degree)
        dev = P["u"].device
        f64 = torch.float64
        order = torch.argsort(torch.where(P["valid"], P["z"], torch.full_like(P["z"], math.inf)), stable=True)
        order = order[: int(P["valid"].sum())]
        S = {k: v.index_select(0, order) for k, v in P.items()}
        M = order.numel()
        fx, fy, cx, cy = torch.as_tensor(intr, dtype=torch.float32, device=dev).reshape(-1)[:4]
        r = S["radius"]
        x_lo = torch.clamp(torch.ceil(S["u"] - r), min=0).to(torch.int64)
        x_hi = torch.clamp(torch.floor(S["u"] + r), max=width - 1).to(torch.int64)
        y_lo = torch.ceil(S["v"] - r).to(torch.int64)
        y_hi = torch.floor(S["v"] + r).to(torch.int64)
        npx = width * height
        acc = torch.zeros((npx, 8), dtype=f64, device=dev)  # rgb, normal, depth, opacity
        T_left = torch.ones(npx, dtype=f64, device=dev)
        for y0 in range(0, height, band_rows):
            y1 = min(y0 + band_rows, height)
            lo_y, hi_y = torch.clamp(y_lo, min=y0), torch.clamp(y_hi, max=y1 - 1)
            rows = torch.nonzero((x_hi >= x_lo) & (hi_y >= lo_y)).reshape(-1)
            if rows.numel() == 0:
                continue
            n = (x_hi - x_lo + 1)[rows] * (hi_y - lo_y + 1)[rows]
            ends = torch.cumsum(n, 0)
            keep_sid, keep_pix, keep_alpha = [], [], []
            c0 = 0
            while c0 < rows.numel():  # surfel chunks of at most max_pairs pairs
                c1 = int(torch.searchsorted(ends, (ends[c0] - n[c0] + max_pairs).reshape(1), right=True)[0])
                c1 = max(c1, c0 + 1)
                sid = rows[c0:c1]
                j, px, py = _pairs(x_lo[sid], x_hi[sid], lo_y[sid], hi_y[sid], width)
                sid = sid[j]
                dx = px.to(torch.float32) - S["u"][sid]
                dy = py.to(torch.float32) - S["v"][sid]
                power = -0.5 * (S["a"][sid] * dx * dx + S["c"][sid] * dy * dy) - S["b"][sid] * dx * dy
                alpha = torch.clamp(S["opacity"][sid] * torch.exp(power), max=MAX_ALPHA)
                ok = (alpha >= ALPHA_EPS) & (power <= 0)
                keep_sid.append(sid[ok])
                keep_pix.append((py * width + px)[ok])
                keep_alpha.append(alpha[ok])
                c0 = c1
            sid, pix, alpha = torch.cat(keep_sid), torch.cat(keep_pix), torch.cat(keep_alpha).to(f64)
            if sid.numel() == 0:
                continue
            # front to back within each pixel: surfels are indexed in depth order
            perm = torch.argsort(pix * M + sid)
            sid, pix, alpha = sid[perm], pix[perm], alpha[perm]
            log_t = torch.log1p(-alpha)
            csum = torch.cumsum(log_t, 0)
            first = torch.ones_like(pix, dtype=torch.bool)
            first[1:] = pix[1:] != pix[:-1]
            iota = torch.arange(pix.numel(), device=dev)
            start = torch.cummax(torch.where(first, iota, torch.zeros_like(iota)), 0).values
            before = csum - log_t - (csum[start] - log_t[start])  # log T in front of each pair
            T_before = torch.exp(before)
            T_after = torch.exp(before + log_t)
            if t_stop > 0:  # the stop ends a pixel at the first pair that would pass it
                live = T_after >= t_stop
                sid, pix, alpha, T_before, T_after = sid[live], pix[live], alpha[live], T_before[live], T_after[live]
            w = T_before * alpha
            # the pixel's depth on the surfel's plane in float32, as the
            # tile renderer takes it: near edge-on the division is
            # ill-conditioned, and another precision would read another depth
            xs = (pix % width).to(torch.float32)
            ys = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
            nrm, pc = S["normal"][sid], S["p_cam"][sid]
            denom = ((xs - cx) / fx) * nrm[:, 0] + ((ys - cy) / fy) * nrm[:, 1] + nrm[:, 2]
            pn = pc[:, 0] * nrm[:, 0] + pc[:, 1] * nrm[:, 1] + pc[:, 2] * nrm[:, 2]
            flat = torch.abs(denom) < 1e-6
            z_plane = pn / torch.where(flat, torch.full_like(denom, 1e-6), denom)
            z_px = torch.where((z_plane > NEAR_Z) & ~flat, z_plane, pc[:, 2])
            vals = torch.cat([S["color"][sid], nrm, z_px[:, None], torch.ones_like(z_px)[:, None]], 1).to(f64)
            acc.index_add_(0, pix, vals * w[:, None])
            T_left.scatter_reduce_(0, pix, T_after, reduce="amin")
        wsum = torch.clamp(acc[:, 7], min=1e-6)
        H, W = height, width
        out = {"color": acc[:, 0:3], "normal": acc[:, 3:6] / wsum[:, None], "depth": (acc[:, 6] / wsum)[:, None],
               "opacity": acc[:, 7:8]}
        out = {k: v.to(torch.float32).reshape(H, W, -1) for k, v in out.items()}
        out["T"] = T_left.to(torch.float32).reshape(H, W)
        return out


@torch.no_grad()
def subcolumn_counts(surfels: dict, w2c, intr, width: int, height: int) -> torch.Tensor:
    """The length of each 32x32 sub-column's list (tile rows, sub-columns)
    int64, as the tile renderer bins the surfels before any cap: each valid
    surfel enters the sub-columns and tile rows its radius (clipped to 31.5
    px) touches, at most 2 of each, clipped to the image's grid."""
    with _NoTF32():
        P = project(surfels, w2c, intr, width, height, sh_degree=0)
    sx_n = -(-width // 128) * (128 // SUB_W)
    ty_n = -(-height // TILE_H)
    u, v, valid = P["u"], P["v"], P["valid"]
    r = torch.clamp(P["radius"], max=BIN_RADIUS_MAX)

    def cell(x, size, hi):
        return torch.clamp(torch.floor(x / size), 0, hi).to(torch.int64)

    sx0, ty0 = cell(u - r, SUB_W, sx_n - 1), cell(v - r, TILE_H, ty_n - 1)
    sx1 = torch.minimum(cell(u + r, SUB_W, sx_n - 1), sx0 + WINDOW - 1)
    ty1 = torch.minimum(cell(v + r, TILE_H, ty_n - 1), ty0 + WINDOW - 1)
    counts = torch.zeros(ty_n * sx_n, dtype=torch.int64, device=u.device)
    for ky in range(WINDOW):
        for kx in range(WINDOW):
            ok = valid & (sx0 + kx <= sx1) & (ty0 + ky <= ty1)
            counts += torch.bincount(((ty0 + ky) * sx_n + sx0 + kx)[ok], minlength=ty_n * sx_n)
    return counts.reshape(ty_n, sx_n)


def counters(counts: torch.Tensor, cap: int) -> dict:
    """The tile renderer's counters of one binning at entry capacity `cap`
    (cap / 4 slots a sub-column, the nearest 3/4 of them exact):
    `binned_entries`, `tail_entries` (past those 3/4) and `max_run`."""
    near = (cap // 4) * 3 // 4
    return {"binned_entries": int(counts.sum()), "tail_entries": int(torch.clamp(counts - near, min=0).sum()),
            "max_run": int(counts.max()) if counts.numel() else 0}
