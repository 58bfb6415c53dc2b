"""Tile-binned differentiable surfel rasterizer with hand-written Hopper
kernels (port of `eggfusion_tpu/ops/raster_pallas.py`).

Pipeline, as in the JAX module:
  1. project (torch, differentiable) — `raster_common.project_surfels`.
  2. sub-column binning (torch, non-differentiable): each surfel emits up to
     KSUB*KY candidate (32-px sub-column, surfel) entries; ONE stable sort by
     the fused (subtile << DEPTH_BITS | quantized depth) key yields depth-
     ordered entry runs per sub-column, cut to CAP/4 slots with the
     stratified tail (`_bin_entries`).
  3. per-tile gather of a (T, CAP, 16) entry slab whose rows interleave the
     tile's 4 sub-columns (row = slot * 4 + sub-column); its gradient
     gathers back through `back_map` (`_ExpandEntries`), no scatter.
  4. compositing: `composite_fwd` / `composite_bwd` run the CUDA kernels of
     `csrc/composite_fwd.cu` and `csrc/composite_bwd.cu` on CUDA tensors,
     and their plain PyTorch versions (`composite_plain`,
     `composite_bwd_plain`) on CPU tensors. A CUDA tensor never takes the
     plain path: the kernel launches or the wrapper raises.

The geometry of binning is the JAX module's default and fixed here:
32x128-px tiles, 32-px sub-columns, a 2x2 (sub-column x tile-row)
candidate window, 19 depth bits, tail stride 4, and the sweep runs to each
sub-column's own slot count (the JAX module's EXIT_MODE "count").
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from eggfusion_tpu_torch.ops import raster_common as rc

TILE_H = 32
TILE_W = 128
SUB_W = 32
N_SUB = TILE_W // SUB_W  # sub-columns per tile
KSUB = 2  # candidate window, x, in sub-columns
KY = 2  # candidate window, y, in tile rows
BIN_RADIUS_MAX_X = (KSUB * SUB_W - 1) / 2
BIN_RADIUS_MAX_Y = (KY * TILE_H - 1) / 2
CHUNK = 16  # slot-groups per chunk: the cap granularity of the JAX module
DEPTH_BITS = 19
DEPTH_FAR = 120.0
TAIL_STRIDE = 4
MAX_BWD_CAP = 2048  # the backward kernel holds a whole sub-column (cap / 4 slots) in shared memory

# entry attribute layout (column of the (CAP, 16) slab)
A_U, A_V = 0, 1
A_CA, A_CB, A_CC = 2, 3, 4
A_OP = 5
A_R, A_G, A_B = 6, 7, 8
A_NX, A_NY, A_NZ = 9, 10, 11
A_PX, A_PY, A_PZ = 12, 13, 14
N_ATTR = 16

# launches of each CUDA kernel; the plain versions do not count
LAUNCHES = {"composite_fwd": 0, "composite_geom": 0, "composite_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _chunk_for(cap: int) -> int:
    return min(CHUNK, max(1, cap // N_SUB))


def n_tiles_static(width: int, height: int) -> int:
    """Number of compositor tiles for an image size."""
    return _cdiv(width, TILE_W) * _cdiv(height, TILE_H)


# --------------------------------------------------------------------------
# binning (non-differentiable)
# --------------------------------------------------------------------------


def _bin_entries(depth, mean2d, radius, valid, n_tiles, tx_tiles, ty_tiles, cap,
                 need_back: bool = True):
    """Fixed-window sub-column binning via one fused (subtile, depth) key.

    Keys are int64 with the JAX module's uint32 bit layout; the sort is
    stable, so equal keys keep candidate order. Returns (entry_sid (T, CAP)
    int64 original surfel per slab row, counts (T, N_SUB) int32, back_map
    (N, K) int64 flat slab row of each candidate or -1 — None when
    `need_back` is False —, max_run () int32 true deepest run)."""
    dev = mean2d.device
    n = mean2d.shape[-1]
    capsub = cap // N_SUB
    n_sub = n_tiles * N_SUB
    sx_tiles = tx_tiles * N_SUB
    u = mean2d[0]
    v = mean2d[1]
    rx = torch.clamp(radius, max=BIN_RADIUS_MAX_X)
    ry = torch.clamp(radius, max=BIN_RADIUS_MAX_Y)

    def cell(x, size, hi):  # floor, then clip (in float: saturating)
        return torch.clamp(torch.floor(x / size), 0, hi).to(torch.int64)

    sx0 = cell(u - rx, SUB_W, sx_tiles - 1)
    ty0 = cell(v - ry, TILE_H, ty_tiles - 1)
    sx1 = torch.minimum(cell(u + rx, SUB_W, sx_tiles - 1), sx0 + KSUB - 1)
    ty1 = torch.minimum(cell(v + ry, TILE_H, ty_tiles - 1), ty0 + KY - 1)

    qmax = (1 << DEPTH_BITS) - 1
    qdepth = torch.clamp(depth * (qmax / DEPTH_FAR), 0, qmax).to(torch.int64)

    K = KSUB * KY
    assert n_sub < (1 << (32 - DEPTH_BITS)), "subtile id must fit the key budget"
    keys = []
    for ky in range(KY):
        for kx in range(KSUB):
            sx = sx0 + kx
            ty = ty0 + ky
            ok = valid & (sx <= sx1) & (ty <= ty1)
            tile = ty * tx_tiles + sx // N_SUB
            subtile = torch.where(ok, tile * N_SUB + sx % N_SUB, torch.full_like(tile, n_sub))
            keys.append((subtile << DEPTH_BITS) | qdepth)
    keys = torch.stack(keys, dim=-1).reshape(-1)  # (N*K,) surfel-major

    nk = n * K
    skeys, sorted_j = torch.sort(keys, stable=True)
    sorted_sub = skeys >> DEPTH_BITS
    sorted_sid = sorted_j // K

    sub_ids = torch.arange(n_sub, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_sub, sub_ids, right=False)
    ends = torch.searchsorted(sorted_sub, sub_ids, right=True)
    run = ends - starts

    # stratified-tail overflow: the nearest 3/4 of the slots exactly, then
    # every TAIL_STRIDE-th entry of the remainder
    near = capsub * 3 // 4
    kept_tail = torch.clamp(run - near, min=0)
    kept = torch.clamp(torch.minimum(run, torch.full_like(run, near))
                       + (kept_tail + TAIL_STRIDE - 1) // TAIL_STRIDE, max=capsub)
    counts = kept.reshape(n_tiles, N_SUB).to(torch.int32)
    max_run = torch.max(run).to(torch.int32)

    off = torch.arange(capsub, dtype=torch.int64, device=dev)
    off = torch.where(off < near, off, near + (off - near) * TAIL_STRIDE)
    pos = starts.reshape(n_tiles, 1, N_SUB) + off.reshape(1, capsub, 1)
    entry_sid = sorted_sid[torch.clamp(pos.reshape(n_tiles, cap), 0, nk - 1)]

    if not need_back:
        return entry_sid, counts, None, max_run

    iota = torch.arange(nk, dtype=torch.int64, device=dev)
    is_start = torch.ones_like(sorted_sub, dtype=torch.bool)
    is_start[1:] = sorted_sub[1:] != sorted_sub[:-1]
    seg_start = torch.cummax(torch.where(is_start, iota, torch.zeros_like(iota)), dim=0).values
    slot_sorted = iota - seg_start
    tail = slot_sorted - near
    tail_kept = (tail >= 0) & (tail % TAIL_STRIDE == 0)
    slab_slot = torch.where(tail < 0, slot_sorted, near + torch.div(tail, TAIL_STRIDE, rounding_mode="floor"))
    slot_ok = (tail < 0) | tail_kept
    flat_sorted = torch.where(
        (sorted_sub < n_sub) & slot_ok & (slab_slot < capsub),
        (sorted_sub // N_SUB) * cap + slab_slot * N_SUB + sorted_sub % N_SUB,
        torch.full_like(sorted_sub, -1),
    )
    # inverse permutation: each candidate's flat slot back in original order
    back_flat = torch.empty_like(flat_sorted)
    back_flat[sorted_j] = flat_sorted
    back_map = back_flat.reshape(n, K)
    return entry_sid, counts, back_map, max_run


class _ExpandEntries(torch.autograd.Function):
    """Gather per-surfel attrs (N, 16) into tile slabs (T, CAP, 16); the
    backward gathers d(entries) through `back_map` (each surfel sums its
    <= K entry-slot gradients in a fixed order) — no scatter, no atomics."""

    @staticmethod
    def forward(ctx, attrs, entry_sid, back_map):
        ctx.save_for_backward(back_map)
        return attrs[entry_sid]

    @staticmethod
    def backward(ctx, g):
        (back_map,) = ctx.saved_tensors
        flat = g.reshape(-1, g.shape[-1])
        picked = flat[torch.clamp(back_map, 0, flat.shape[0] - 1)]  # (N, K, 16)
        d_attrs = torch.where((back_map >= 0)[..., None], picked, torch.zeros_like(picked)).sum(dim=1)
        return d_attrs, None, None


class Binning(NamedTuple):
    """Per-camera tile-binning artifact (non-differentiable), reusable
    across the optimization steps run on one camera."""

    entry_sid: torch.Tensor  # (T, CAP) int64, rows interleave sub-columns
    counts: torch.Tensor  # (T, N_SUB) int32 per-sub-column slot counts
    back_map: torch.Tensor  # (N, K) int64


def tile_pixel_mask(keep: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Expand a per-tile keep mask (n_tiles,) to a per-pixel (H, W) bool mask."""
    tx = _cdiv(width, TILE_W)
    ty = _cdiv(height, TILE_H)
    m = keep.reshape(ty, 1, tx, 1).expand(ty, TILE_H, tx, TILE_W).reshape(ty * TILE_H, tx * TILE_W)
    return m[:height, :width]


def _grid(width: int, height: int):
    hp = _cdiv(height, TILE_H) * TILE_H
    wp = _cdiv(width, TILE_W) * TILE_W
    return hp, wp, wp // TILE_W, hp // TILE_H


@torch.no_grad()
def compute_binning(params: dict, w2c, intr, width: int, height: int, cap: int = 512) -> Binning:
    """Standalone tile binning for `render_tile(..., binning=...)`."""
    _hp, _wp, tx_tiles, ty_tiles = _grid(width, height)
    proj = rc.project_surfels(params, w2c, intr, width, height, sh_degree=0, need_color=False)
    entry_sid, counts, back_map, _ = _bin_entries(
        proj.depth, proj.mean2d, proj.radius, proj.valid,
        tx_tiles * ty_tiles, tx_tiles, ty_tiles, cap,
    )
    return Binning(entry_sid, counts, back_map)


# --------------------------------------------------------------------------
# plain PyTorch compositor (the kernels' reference; the CPU path)
# --------------------------------------------------------------------------


def _tile_origin(tiles: torch.Tensor, tx_tiles: int):
    return (tiles % tx_tiles) * TILE_W, (tiles // tx_tiles) * TILE_H


def _tile_sweep(entries, counts, tx_tiles: int, cap: int, tiles: torch.Tensor):
    """Per-pixel view of the tiles `tiles`: the slab as (Tb, slots, N_SUB,
    16), each lane's sub-column, the pixel centres xs, ys (Tb, TILE_H,
    TILE_W), each lane's slot count (Tb, 1, TILE_W) and the deepest count."""
    dev = entries.device
    capsub = cap // N_SUB
    E = entries.index_select(0, tiles).reshape(-1, capsub, N_SUB, N_ATTR)
    n = torch.clamp(counts.index_select(0, tiles), max=capsub)  # (Tb, N_SUB)
    Tb = E.shape[0]
    x0, y0 = _tile_origin(tiles, tx_tiles)
    lane = torch.arange(TILE_W, device=dev)
    lane_sub = lane // SUB_W
    xs = (x0[:, None, None] + lane[None, None, :]).to(torch.float32).expand(Tb, TILE_H, TILE_W)
    ys = (y0[:, None, None] + torch.arange(TILE_H, device=dev)[None, :, None]).to(torch.float32)
    ys = ys.expand(Tb, TILE_H, TILE_W)
    n_lane = n[:, lane_sub][:, None, :]
    n_max = int(n.max()) if n.numel() else 0  # host read: plain path only
    return E, lane_sub, xs, ys, n_lane, n_max


def _slot_alpha(a, xs, ys, vmask):
    """Alpha of one slot's entries `a` (..., 16) at pixels (xs, ys): zero
    where `vmask` is 0 (past the count) or below ALPHA_EPS."""
    dx = xs - a[..., A_U]
    dy = ys - a[..., A_V]
    power = -0.5 * (a[..., A_CA] * dx * dx + a[..., A_CC] * dy * dy) - a[..., A_CB] * dx * dy
    raw = a[..., A_OP] * torch.exp(power)
    alpha = torch.clamp(raw, max=rc.MAX_ALPHA) * vmask
    return torch.where(alpha >= rc.ALPHA_EPS, alpha, torch.zeros_like(alpha))


def cull_extent(entries):
    """Half extents (half_w, half_h), in pixels, of the region around each
    entry's centre (u, v) where its alpha can be nonzero: the kernels' row
    cull (`csrc/composite_common.cuh::cull_rows`). `inf` where the entry is
    never culled (a non-finite value, or a conic that is not safely positive
    definite: det <= 4e-3 a c, a <= 0 or c <= 0), -1 where it is dead on
    every pixel (op too small).

    alpha >= ALPHA_EPS needs Q = a dx^2 + 2 b dx dy + c dy^2 <= tau =
    2 ln(255 op); inside that ellipse |dx| <= sqrt(tau c / det) and |dy| <=
    sqrt(tau a / det). tau is padded by 2e-3 of itself plus 1e-3 and each
    extent by 1 px, so float rounding never puts a live pair outside."""
    u, v, a, b, c, op = (entries[..., i] for i in (A_U, A_V, A_CA, A_CB, A_CC, A_OP))
    det = a * c - b * b
    finite = torch.isfinite(torch.stack([u, v, a, b, c, op, det])).all(dim=0)
    cullable = finite & (a > 0) & (c > 0) & (det > 4e-3 * a * c)
    tau = 2.0 * torch.log(255.0 * op)
    taup = tau + 2e-3 * torch.abs(tau) + 1e-3
    alive = taup >= 0  # False for NaN (op <= 0)
    inf = torch.full_like(u, float("inf"))

    def extent(num):
        e = torch.where(alive, torch.sqrt(taup * num / det) + 1.0, torch.full_like(u, -1.0))
        return torch.where(cullable, e, inf)

    return extent(c), extent(a)


def count_kept_pairs(entries, counts, tx_tiles: int, cap: int) -> int:
    """Number of visited (pixel, slot) pairs in the rows the cull keeps: for
    each visited slot whose column extent meets its 32-px sub-column, the
    sub-column's 32 pixels of every row within its row extent (the
    backward's granularity; the forward's warps take rows in pairs)."""
    capsub = cap // N_SUB
    n_tiles = entries.shape[0]
    dev = entries.device
    E = entries.reshape(n_tiles, capsub, N_SUB, N_ATTR)
    hw, hh = cull_extent(E)
    u, v = E[..., A_U], E[..., A_V]
    tiles = torch.arange(n_tiles, device=dev)
    x0, y0 = _tile_origin(tiles, tx_tiles)
    sub_x0 = (x0[:, None] + torch.arange(N_SUB, device=dev)[None, :] * SUB_W).to(torch.float32)[:, None, :]
    visited = torch.arange(capsub, device=dev)[None, :, None] < torch.clamp(counts, max=capsub)[:, None, :]
    meets = visited & (u + hw >= sub_x0) & (u - hw <= sub_x0 + (SUB_W - 1))
    ys = (y0[:, None] + torch.arange(TILE_H, device=dev)[None, :]).to(torch.float32)[:, None, None, :]
    rows = ((v - hh)[..., None] <= ys) & ((v + hh)[..., None] >= ys)
    return int((rows & meets[..., None]).sum()) * SUB_W


def count_live_pairs(entries, counts, tx_tiles: int, cap: int) -> int:
    """Number of (pixel, slot) pairs a sweep visits whose alpha is nonzero.
    Only these need the weight, depth, accumulation and gradient work; the
    other visited pairs need only their alpha. Used to bound the kernels'
    work by what the data needs."""
    tiles = torch.arange(entries.shape[0], device=entries.device)
    E, lane_sub, xs, ys, n_lane, n_max = _tile_sweep(entries, counts, tx_tiles, cap, tiles)
    live = torch.zeros((), dtype=torch.int64, device=entries.device)
    for s in range(n_max):
        alpha = _slot_alpha(E[:, s][:, lane_sub][:, None, :, :], xs, ys, (s < n_lane).to(torch.float32))
        live += (alpha > 0).sum()
    return int(live)


def composite_plain(entries, counts, intr, tx_tiles: int, cap: int, geom: bool = False,
                    tiles: torch.Tensor | None = None):
    """Front-to-back compositing of the tiles `tiles` (default: all), in
    PyTorch, vectorized over (tile, pixel) and looping over slots.

    Returns per-tile images (Tb, C, TILE_H, TILE_W) for C channels
    [r, g, b, nx, ny, nz, depth, opacity, T] (geom: [depth, opacity, T]).
    Pixels of lane j see only sub-column j // SUB_W's entries; slots at or
    past a sub-column's count have alpha 0. Autograd through this function
    is the plain backward."""
    dev = entries.device
    if tiles is None:
        tiles = torch.arange(entries.shape[0], device=dev)
    E, lane_sub, xs, ys, n_lane, n_max = _tile_sweep(entries, counts, tx_tiles, cap, tiles)
    Tb = E.shape[0]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    rx = (xs - cx) / fx
    ry = (ys - cy) / fy

    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros((Tb, TILE_H, TILE_W), **f32)
    acc = [zero] * (2 if geom else 8)
    T = torch.ones((Tb, TILE_H, TILE_W), **f32)
    for s in range(n_max):
        a = E[:, s][:, lane_sub][:, None, :, :]  # (Tb, 1, TILE_W, 16)
        at = lambda i: a[..., i]
        alpha = _slot_alpha(a, xs, ys, (s < n_lane).to(torch.float32))
        denom = rx * at(A_NX) + ry * at(A_NY) + at(A_NZ)
        pn = at(A_PX) * at(A_NX) + at(A_PY) * at(A_NY) + at(A_PZ) * at(A_NZ)
        denom_ok = torch.abs(denom) >= 1e-6
        z_plane = pn / torch.where(denom_ok, denom, torch.full_like(denom, 1e-6))
        use_plane = (z_plane > rc.NEAR_Z) & denom_ok
        z_px = torch.where(use_plane, z_plane, at(A_PZ).expand_as(z_plane))
        w = T * alpha
        if geom:
            acc = [acc[0] + w * z_px, acc[1] + w]
        else:
            chans = (A_R, A_G, A_B, A_NX, A_NY, A_NZ)
            acc = [acc[i] + w * at(c) for i, c in enumerate(chans)] + [acc[6] + w * z_px, acc[7] + w]
        T = T * (1.0 - alpha)
    return torch.stack(acc + [T], dim=1)


def _tiles_to_image(x: torch.Tensor, tx_tiles: int) -> torch.Tensor:
    """(T, C, TILE_H, TILE_W) per-tile images -> (C, hp, wp)."""
    T, C = x.shape[:2]
    ty = T // tx_tiles
    return x.reshape(ty, tx_tiles, C, TILE_H, TILE_W).permute(2, 0, 3, 1, 4).reshape(
        C, ty * TILE_H, tx_tiles * TILE_W)


def _image_to_tiles(img: torch.Tensor, tx_tiles: int, tiles: torch.Tensor) -> torch.Tensor:
    """(C, hp, wp) -> (Tb, C, TILE_H, TILE_W) for the tiles `tiles`."""
    C, hp, _wp = img.shape
    ty = hp // TILE_H
    t = img.reshape(C, ty, TILE_H, tx_tiles, TILE_W).permute(1, 3, 0, 2, 4).reshape(-1, C, TILE_H, TILE_W)
    return t.index_select(0, tiles)


def _split(img_stack: torch.Tensor, geom: bool):
    """(C, hp, wp) channel stack -> the kernel's output tuple."""
    if geom:
        return img_stack[0], img_stack[1], img_stack[2]
    return img_stack[0:3], img_stack[3:6], img_stack[6], img_stack[7], img_stack[8]


def composite_bwd_plain(entries, counts, intr, g_rgb, g_nrm, g_dep, g_opa, g_T,
                        tx_tiles: int, cap: int, tile_batch: int | None = None):
    """VJP of `composite_plain` w.r.t. the entry slab, by autograd, over
    batches of `tile_batch` tiles (tiles are independent; batching bounds
    the memory autograd keeps)."""
    dev = entries.device
    n_tiles = entries.shape[0]
    cot = torch.cat([g_rgb, g_nrm, g_dep[None], g_opa[None], g_T[None]], dim=0)
    d = torch.zeros_like(entries)
    step = tile_batch or n_tiles
    for t0 in range(0, n_tiles, step):
        tiles = torch.arange(t0, min(t0 + step, n_tiles), device=dev)
        with torch.enable_grad():
            e = entries.detach().requires_grad_(True)
            out = composite_plain(e, counts, intr, tx_tiles, cap, tiles=tiles)
            (g,) = torch.autograd.grad(out, e, _image_to_tiles(cot, tx_tiles, tiles), allow_unused=True)
        if g is not None:
            d += g
    return d


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_inputs(entries, counts, intr, tx_tiles: int, cap: int):
    if entries.dtype != torch.float32 or entries.dim() != 3 or entries.shape[1:] != (cap, N_ATTR):
        raise ValueError(f"entries must be float32 (T, {cap}, {N_ATTR}), got "
                         f"{tuple(entries.shape)} {entries.dtype}")
    n_tiles = entries.shape[0]
    if counts.dtype != torch.int32 or tuple(counts.shape) != (n_tiles, N_SUB):
        raise ValueError(f"counts must be int32 ({n_tiles}, {N_SUB}), got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if intr.dtype != torch.float32 or intr.numel() != 4:
        raise ValueError("intr must be 4 float32 values (fx, fy, cx, cy)")
    if n_tiles % tx_tiles or cap % N_SUB:
        raise ValueError(f"{n_tiles} tiles do not form rows of {tx_tiles}, or cap {cap} % {N_SUB}")
    devs = {entries.device, counts.device, intr.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return n_tiles, entries.device


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def composite_fwd(entries, counts, intr, tx_tiles: int, cap: int, geom: bool = False):
    """Forward compositor: (rgb (3, hp, wp), nrm (3, hp, wp), depth, opacity,
    T_final (hp, wp)) — geom: (depth, opacity, T_final).

    CPU tensors take `composite_plain`; CUDA tensors launch the kernel of
    `csrc/composite_fwd.cu` (GEOM template for `geom`)."""
    _n_tiles, dev = _check_inputs(entries, counts, intr, tx_tiles, cap)
    if dev.type == "cpu":
        return _split(_tiles_to_image(composite_plain(entries, counts, intr, tx_tiles, cap, geom), tx_tiles), geom)
    if dev.type != "cuda":
        raise ValueError(f"no compositor for device {dev}")
    from eggfusion_tpu_torch.ops import cuda_build

    out = _launch_fwd(cuda_build.load("composite_fwd"), entries, counts, intr, tx_tiles, cap, geom)
    LAUNCHES["composite_geom" if geom else "composite_fwd"] += 1
    return out


def _launch_fwd(lib, entries, counts, intr, tx_tiles: int, cap: int, geom: bool):
    """Launch the forward kernel of the loaded library `lib` on checked CUDA
    inputs (the wrapper's launch; the checks launch a second build through
    it)."""
    from eggfusion_tpu_torch.ops import cuda_build

    n_tiles, dev = entries.shape[0], entries.device
    hp = (n_tiles // tx_tiles) * TILE_H
    wp = tx_tiles * TILE_W
    entries, counts, intr = entries.contiguous(), counts.contiguous(), intr.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dep, opa, T = (torch.empty((hp, wp), **f32) for _ in range(3))
    rgb = nrm = None
    if not geom:
        rgb, nrm = torch.empty((3, hp, wp), **f32), torch.empty((3, hp, wp), **f32)
    err = lib.egg_composite_fwd(
        _ptr(counts), _ptr(intr), _ptr(entries),
        _ptr(rgb) if rgb is not None else None, _ptr(nrm) if nrm is not None else None,
        _ptr(dep), _ptr(opa), _ptr(T),
        n_tiles, tx_tiles, cap, int(geom), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"composite_fwd kernel launch failed: {cuda_build.error_string(err)}")
    return (dep, opa, T) if geom else (rgb, nrm, dep, opa, T)


def composite_bwd(entries, counts, intr, g_rgb, g_nrm, g_dep, g_opa, g_T, T_fin,
                  tx_tiles: int, cap: int):
    """VJP of the full forward compositor w.r.t. the entry slab: d_entries
    (T, CAP, 16), zero on rows no sub-column reaches and on column 15.

    CPU tensors take `composite_bwd_plain`; CUDA tensors launch the kernel
    of `csrc/composite_bwd.cu`."""
    n_tiles, dev = _check_inputs(entries, counts, intr, tx_tiles, cap)
    if dev.type == "cpu":
        return composite_bwd_plain(entries, counts, intr, g_rgb, g_nrm, g_dep, g_opa, g_T, tx_tiles, cap)
    if dev.type != "cuda":
        raise ValueError(f"no compositor for device {dev}")
    if cap > MAX_BWD_CAP:
        raise ValueError(f"backward compositor supports cap <= {MAX_BWD_CAP}, got {cap}")
    hp = (n_tiles // tx_tiles) * TILE_H
    wp = tx_tiles * TILE_W
    for name, g, shape in (("g_rgb", g_rgb, (3, hp, wp)), ("g_nrm", g_nrm, (3, hp, wp)),
                           ("g_dep", g_dep, (hp, wp)), ("g_opa", g_opa, (hp, wp)),
                           ("g_T", g_T, (hp, wp)), ("T_fin", T_fin, (hp, wp))):
        if tuple(g.shape) != shape or g.dtype != torch.float32 or g.device != dev:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got {tuple(g.shape)} {g.dtype}")
    from eggfusion_tpu_torch.ops import cuda_build

    d_entries = _launch_bwd(cuda_build.load("composite_bwd"), entries, counts, intr, g_rgb, g_nrm, g_dep,
                            g_opa, g_T, T_fin, tx_tiles, cap)
    LAUNCHES["composite_bwd"] += 1
    return d_entries


def _launch_bwd(lib, entries, counts, intr, g_rgb, g_nrm, g_dep, g_opa, g_T, T_fin, tx_tiles: int, cap: int):
    """Launch the backward kernel of the loaded library `lib` on checked
    CUDA inputs (the wrapper's launch; the checks launch a second build
    through it)."""
    from eggfusion_tpu_torch.ops import cuda_build

    ins = [t.contiguous() for t in (counts, intr, entries, g_rgb, g_nrm, g_dep, g_opa, g_T, T_fin)]
    d_entries = torch.zeros_like(entries)
    err = lib.egg_composite_bwd(*[_ptr(t) for t in ins], _ptr(d_entries), entries.shape[0], tx_tiles, cap,
                                torch.cuda.current_stream(entries.device).cuda_stream)
    if err:
        raise RuntimeError(f"composite_bwd kernel launch failed: {cuda_build.error_string(err)}")
    return d_entries


class _Composite(torch.autograd.Function):
    """Full forward compositor with the backward compositor as its VJP."""

    @staticmethod
    def forward(ctx, entries, counts, intr, tx_tiles: int, cap: int):
        rgb, nrm, dep, opa, T = composite_fwd(entries, counts, intr, tx_tiles, cap)
        ctx.save_for_backward(entries, counts, intr, T)
        ctx.tx_tiles, ctx.cap = tx_tiles, cap
        return rgb, nrm, dep, opa, T

    @staticmethod
    def backward(ctx, g_rgb, g_nrm, g_dep, g_opa, g_T):
        entries, counts, intr, T_fin = ctx.saved_tensors
        d = composite_bwd(entries, counts, intr, g_rgb, g_nrm, g_dep, g_opa, g_T, T_fin,
                          ctx.tx_tiles, ctx.cap)
        return d, None, None, None, None


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------


def render_tile(params: dict, w2c: torch.Tensor, intr: torch.Tensor, width: int, height: int,
                sh_degree: int = 3, cap: int = 512, binning: Binning | None = None,
                geom_only: bool = False, need_grad: bool = True,
                tile_keep: torch.Tensor | None = None, with_occupancy: bool = False) -> dict:
    """Render surfels to (H, W, *) color/normal/depth/opacity maps (the JAX
    module's `render_pallas`, same options and output dict).

    `binning` reuses a `compute_binning` result; `geom_only` returns only
    {depth, opacity} through the geometry-only kernel; `need_grad=False`
    skips building the gradient back-map; `tile_keep` ((n_tiles,) bool)
    composites only the kept tiles; `with_occupancy` adds "max_occupancy",
    the true deepest sub-column candidate count."""
    assert cap % (N_SUB * _chunk_for(cap)) == 0, (
        f"cap must be a multiple of {N_SUB * _chunk_for(cap)} (sub-column slot chunks)")
    hp, wp, tx_tiles, ty_tiles = _grid(width, height)
    n_tiles = tx_tiles * ty_tiles

    proj = rc.project_surfels(params, w2c, intr, width, height, sh_degree, need_color=not geom_only)

    max_run = None
    if binning is not None:
        entry_sid, counts, back_map = binning
    else:
        entry_sid, counts, back_map, max_run = _bin_entries(
            proj.depth.detach(), proj.mean2d.detach(), proj.radius.detach(), proj.valid,
            n_tiles, tx_tiles, ty_tiles, cap, need_back=need_grad and not geom_only,
        )

    n = proj.mean2d.shape[-1]
    attrs = torch.cat(
        [proj.mean2d, proj.conic, proj.opacity[None], proj.color, proj.normal_cam, proj.p_cam,
         torch.ones((1, n), dtype=torch.float32, device=proj.mean2d.device)],
        dim=0,
    ).T.contiguous()  # (N, 16)

    if tile_keep is not None:
        # dropped tiles get count 0: their kernel blocks exit at once
        counts = torch.where(tile_keep[:, None], counts, torch.zeros_like(counts))

    if back_map is None:
        entries = attrs[entry_sid]
    else:
        entries = _ExpandEntries.apply(attrs, entry_sid, back_map)

    if with_occupancy:
        assert max_run is not None, "with_occupancy requires in-call binning"

    intr32 = intr.to(torch.float32)
    if geom_only:
        dep, opa, _T = composite_fwd(entries.detach(), counts, intr32, tx_tiles, cap, geom=True)
        dep = dep[:height, :width]
        opa = opa[:height, :width]
        wsum = torch.clamp(opa, min=1e-6)
        out = {"depth": (dep / wsum)[..., None], "opacity": opa[..., None]}
        if with_occupancy:
            out["max_occupancy"] = max_run
        return out

    rgb, nrm, dep, opa, _T = _Composite.apply(entries, counts, intr32, tx_tiles, cap)
    rgb = rgb.permute(1, 2, 0)[:height, :width, :]
    nrm = nrm.permute(1, 2, 0)[:height, :width, :]
    dep = dep[:height, :width]
    opa = opa[:height, :width]

    wsum = torch.clamp(opa, min=1e-6)
    dep = dep / wsum
    nrm = nrm / wsum[..., None]
    out = {"color": rgb, "normal": nrm, "depth": dep[..., None], "opacity": opa[..., None]}
    if with_occupancy:
        out["max_occupancy"] = max_run
    return out
