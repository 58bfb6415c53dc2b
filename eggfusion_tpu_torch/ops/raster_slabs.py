"""Synthetic entry slabs for holding the compositor kernels against their
plain versions: random well-formed slabs, adversarial slabs for the row
cull, and a slab the cull drops whole. Each returns (entries (T, cap, 16)
f32, counts (T, 4) i32, intr (4,) f32, tx_tiles) on the CPU, made from
`seed` with numpy; used by `tests/test_torch_kernels_cuda.py` and
`chip_smoke.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from eggfusion_tpu_torch.ops import raster_tile as rt


def random_slab(cap, tx=2, ty=2, seed=0):
    """Random but well-formed entries: splats inside their sub-column,
    positive-definite conics, camera-facing normals, ragged counts."""
    rng = np.random.default_rng(seed)
    n_tiles = tx * ty
    capsub = cap // rt.N_SUB
    e = np.zeros((n_tiles, capsub, rt.N_SUB, rt.N_ATTR), np.float32)
    t = np.arange(n_tiles)[:, None, None]
    c = np.arange(rt.N_SUB)[None, None, :]
    shape = (n_tiles, capsub, rt.N_SUB)
    e[..., rt.A_U] = (t % tx) * rt.TILE_W + c * rt.SUB_W + rng.uniform(-8, 40, shape)
    e[..., rt.A_V] = (t // tx) * rt.TILE_H + rng.uniform(-8, 40, shape)
    e[..., rt.A_CA] = rng.uniform(0.01, 0.2, shape)
    e[..., rt.A_CC] = rng.uniform(0.01, 0.2, shape)
    e[..., rt.A_CB] = rng.uniform(-0.5, 0.5, shape) * np.sqrt(e[..., rt.A_CA] * e[..., rt.A_CC])
    e[..., rt.A_OP] = rng.uniform(0.0, 1.0, shape)
    e[..., rt.A_R:rt.A_B + 1] = rng.uniform(size=shape + (3,))
    n = rng.normal(size=shape + (3,)) * 0.3 + [0, 0, -1]
    e[..., rt.A_NX:rt.A_NZ + 1] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    e[..., rt.A_PX:rt.A_PY + 1] = rng.normal(size=shape + (2,)) * 0.3
    e[..., rt.A_PZ] = np.sort(rng.uniform(0.5, 4.0, shape), axis=1)
    counts = rng.integers(0, capsub + 1, (n_tiles, rt.N_SUB)).astype(np.int32)
    counts[0, 0] = 0
    counts[-1, -1] = capsub
    entries = torch.from_numpy(e.reshape(n_tiles, cap, rt.N_ATTR))
    intr = torch.tensor([300.0, 300.0, tx * rt.TILE_W / 2 - 0.5, ty * rt.TILE_H / 2 - 0.5])
    return entries, torch.from_numpy(counts), intr, tx


def adversarial_slab(cap, tx=2, ty=2, seed=0, wide=False):
    """Entries that test the row cull: a mix, per slot, of tiny splats,
    elongated splats at random angles (one axis up to 20 px, the other
    below 0.5 px, plus the LOWPASS dilation), conics with b^2 near a c
    (1 - |b| / sqrt(a c) from 2e-3), opacities within 1e-3 of 1/255, and
    centres up to 64 px off the sub-column and its rows.

    `wide` stretches the long axis to 64 px and lets 1 - |b| / sqrt(a c)
    fall to 1e-5. There float32 evaluation of the exponent loses most of
    its digits to cancellation, so the kernel and its plain version, each
    rounding in its own order, may differ by more than the forward
    tolerance; such slabs hold the kernel to its build without the cull
    (bit for bit) and to a float64 evaluation, not to that tolerance."""
    entries, counts, intr, tx = random_slab(cap, tx, ty, seed)
    rng = np.random.default_rng(seed + 100)
    e = entries.numpy().reshape(tx * ty, cap // rt.N_SUB, rt.N_SUB, rt.N_ATTR)
    shape = e.shape[:3]
    t = np.arange(tx * ty)[:, None, None]
    c = np.arange(rt.N_SUB)[None, None, :]
    e[..., rt.A_U] = (t % tx) * rt.TILE_W + c * rt.SUB_W + rng.uniform(-64, 96, shape)
    e[..., rt.A_V] = (t // tx) * rt.TILE_H + rng.uniform(-64, 96, shape)
    kind = rng.integers(0, 4, shape)
    # tiny: sigma 0.2-1 px
    tiny = rng.uniform(1.0, 25.0, shape + (2,))
    # elongated: covariance of a long and a short axis plus LOWPASS
    th = rng.uniform(0, np.pi, shape)
    s1, s2 = rng.uniform(5, 64 if wide else 20, shape), rng.uniform(0, 0.5, shape)
    cxx = (s1 * np.cos(th)) ** 2 + (s2 * np.sin(th)) ** 2 + 0.3
    cyy = (s1 * np.sin(th)) ** 2 + (s2 * np.cos(th)) ** 2 + 0.3
    cxy = (s1 ** 2 - s2 ** 2) * np.cos(th) * np.sin(th)
    det = cxx * cyy - cxy ** 2
    # near-singular: b = rho sqrt(a c), 1 - |rho| in [2e-3, 2e-2] (det / a c
    # from just under 4e-3 to 4e-2, on both sides of the cull's 4e-3 limit)
    a_s, c_s = rng.uniform(0.001, 0.5, shape), rng.uniform(0.001, 0.5, shape)
    sign = rng.choice([-1, 1], shape)
    b_s = sign * (1 - rng.uniform(1e-5 if wide else 2e-3, 2e-2, shape)) * np.sqrt(a_s * c_s)
    a = np.select([kind == 0, kind == 1, kind == 2], [tiny[..., 0], cyy / det, a_s], e[..., rt.A_CA])
    b = np.select([kind == 0, kind == 1, kind == 2], [0 * tiny[..., 0], -cxy / det, b_s], e[..., rt.A_CB])
    cc = np.select([kind == 0, kind == 1, kind == 2], [tiny[..., 1], cxx / det, c_s], e[..., rt.A_CC])
    e[..., rt.A_CA], e[..., rt.A_CB], e[..., rt.A_CC] = a, b, cc
    thresh = rng.uniform(size=shape) < 0.5
    e[..., rt.A_OP] = np.where(thresh, 1 / 255 + rng.uniform(-1e-3, 1e-3, shape), e[..., rt.A_OP])
    return torch.from_numpy(e.reshape(tx * ty, cap, rt.N_ATTR)), counts, intr, tx


def culled_slab(cap):
    """A slab whose every visited entry the cull drops: opacity below 1/255,
    or a compact splat whose footprint misses its sub-column."""
    entries, counts, intr, tx = random_slab(cap, seed=3)
    e = entries.numpy().reshape(-1, cap // rt.N_SUB, rt.N_SUB, rt.N_ATTR)
    e[..., rt.A_CA] = e[..., rt.A_CC] = 0.5
    e[..., rt.A_CB] = 0.0
    e[:, 0::2, :, rt.A_OP] = 0.5 / 255
    e[:, 1::2, :, rt.A_U] -= 60.0
    e[:, 1::2, :, rt.A_OP] = 0.9
    entries = torch.from_numpy(e.reshape(-1, cap, rt.N_ATTR))
    counts = torch.full_like(counts, cap // rt.N_SUB)
    if rt.count_kept_pairs(entries, counts, tx, cap):
        raise AssertionError("culled_slab: the cull keeps some pairs")
    return entries, counts, intr, tx
