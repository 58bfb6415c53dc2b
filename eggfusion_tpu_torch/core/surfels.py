"""Gaussian-surfel map: a structure of tensors whose capacity changes only
by `grow_surfels` / `shrink_surfels` (port of `eggfusion_tpu/core/surfels.py`).

The map keeps the JAX package's layout: every per-surfel field is stored
TRANSPOSED, (k, C), with an active mask and an append watermark `count`.
`SurfelMap` is a dataclass of tensors; the functions below return the map
they are given, updated IN PLACE where the JAX code donates the surfel state
(its `donate_argnums`) — callers must not keep aliases to old field values.
`assign` and `resize_into` write a map into another map's buffers: the
system keeps its map in one set of buffers per capacity, the state of its
captured programs. Nothing here reads a device scalar on the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from eggfusion_tpu_torch.geometry import sh as shlib
from eggfusion_tpu_torch.geometry import transforms as tf

# exp(-30) ~ 1e-13: numerically zero thickness but finite in float32 autograd
FLAT_LOG_SCALE = -30.0

# SoA field names in the JAX package's order (`SurfelMap` there)
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
          "eta", "sigma2", "observe_count", "tic", "error_count", "stable",
          "active", "count")


class SurfelConfig(NamedTuple):
    """Static surfel configuration (the config's `Surfel:` section)."""

    capacity: int = 1_000_000
    max_sh_degree: int = 3
    active_sh_degree: int = 3
    init_opacity: float = 0.99
    alpha_p: float = 1.0
    alpha_n: float = 0.5
    stable_confidence: float = 10.0


@dataclasses.dataclass
class SurfelMap:
    """Fixed-capacity surfel SoA. All tensors have TRAILING dim = capacity."""

    xyz: torch.Tensor  # (3, C) world position
    features_dc: torch.Tensor  # (3, 1, C) SH DC
    features_rest: torch.Tensor  # (3, R, C) higher SH, R = (deg+1)^2 - 1
    scaling: torch.Tensor  # (3, C) log-scale; [2] pinned flat
    rotation: torch.Tensor  # (4, C) unnormalized quaternion wxyz
    opacity: torch.Tensor  # (1, C) logit opacity
    eta: torch.Tensor  # (6, C) information vector [pos*lam_p, normal*lam_n]
    sigma2: torch.Tensor  # (2, C) variances [sigma2_p, sigma2_n]
    observe_count: torch.Tensor  # (C,) i32
    tic: torch.Tensor  # (C,) i32 creation time
    error_count: torch.Tensor  # (C,) i32
    stable: torch.Tensor  # (C,) bool
    active: torch.Tensor  # (C,) bool allocated & alive
    count: torch.Tensor  # () i32 append watermark

    @staticmethod
    def empty(cfg: SurfelConfig, device=None) -> "SurfelMap":
        C = cfg.capacity
        R = (cfg.max_sh_degree + 1) ** 2 - 1
        f = dict(dtype=torch.float32, device=device)
        i = dict(dtype=torch.int32, device=device)
        rotation = torch.zeros((4, C), **f)
        rotation[0] = 1.0
        return SurfelMap(
            xyz=torch.zeros((3, C), **f),
            features_dc=torch.zeros((3, 1, C), **f),
            features_rest=torch.zeros((3, R, C), **f),
            scaling=torch.full((3, C), FLAT_LOG_SCALE, **f),
            rotation=rotation,
            opacity=torch.zeros((1, C), **f),
            eta=torch.zeros((6, C), **f),
            sigma2=torch.ones((2, C), **f),
            observe_count=torch.zeros((C,), **i),
            tic=torch.zeros((C,), **i),
            error_count=torch.zeros((C,), **i),
            stable=torch.zeros((C,), dtype=torch.bool, device=device),
            active=torch.zeros((C,), dtype=torch.bool, device=device),
            count=torch.zeros((), **i),
        )

    def replace(self, **changes) -> "SurfelMap":
        return dataclasses.replace(self, **changes)

    # ---- derived quantities (activations) -----------------------------------

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / (torch.linalg.vector_norm(self.rotation, dim=0, keepdim=True) + 1e-12)

    def get_normal(self) -> torch.Tensor:
        """Column of R at the min-scale axis, always index 2 (scaling[2] is
        pinned to FLAT_LOG_SCALE) -> (3, C)."""
        return tf.normal_from_quat_t(self.rotation)

    def get_features(self) -> torch.Tensor:
        """(3, (deg+1)^2, C) stacked SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_radius(self) -> torch.Tensor:
        """(sum(scales) - min(scale)) / 2 -> (C,)."""
        s = self.get_scaling()
        return (torch.sum(s, dim=0) - torch.amin(s, dim=0)) / 2.0

    def get_color(self) -> torch.Tensor:
        return shlib.sh_to_rgb(self.features_dc[:, 0, :])  # (3, C)

    def get_confidence(self) -> torch.Tensor:
        return torch.sum(1.0 / self.sigma2, dim=0)

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32))


class SpawnBatch(NamedTuple):
    """Fixed-size batch of candidate surfels to append (invalid rows masked).
    ROW layout (K, k)."""

    xyz: torch.Tensor  # (K, 3)
    normal: torch.Tensor  # (K, 3)
    color: torch.Tensor  # (K, 3)
    dist: torch.Tensor  # (K, 3) linear scales (3rd entry ignored)
    eta: torch.Tensor  # (K, 6)
    sigma2: torch.Tensor  # (K, 2)
    valid: torch.Tensor  # (K,) bool


def append_surfels(s: SurfelMap, batch: SpawnBatch, time, init_opacity: float) -> SurfelMap:
    """Append a fixed-size spawn batch into the slots above the watermark
    (in place).

    Valid rows are compacted to the front (stable sort) and written into the
    K-slot window [start, start + K) with start = clip(count, 0, C - K); new
    slot r of the window takes new row r - shift, shift = count - start.
    Slots past capacity keep their old content (drop-at-capacity). The
    window start is a device scalar, so the write is an index_copy_ with
    device indices — no host readback.
    """
    C = s.capacity
    K = batch.xyz.shape[0]
    dev = s.device
    valid = batch.valid & (torch.sum(torch.abs(batch.normal), dim=-1) > 1e-12)

    order = torch.sort((~valid).to(torch.int8), stable=True).indices
    Kw = min(K, C)
    sel = order[:Kw]
    n_valid = torch.clamp(torch.sum(valid.to(torch.int32)), max=Kw)
    K = Kw

    xyz = batch.xyz[sel].T  # (3, K)
    normal = batch.normal[sel].T
    color = batch.color[sel].T
    dist = batch.dist[sel].T
    eta = batch.eta[sel].T  # (6, K)
    sigma2 = batch.sigma2[sel].T  # (2, K)

    q = tf.rot_z_to_t(normal)  # (4, K)
    scales = torch.log(torch.clamp(dist, min=1e-12))
    scales[2] = FLAT_LOG_SCALE
    dc = shlib.rgb_to_sh(color)[:, None, :]  # (3, 1, K)
    opa = tf.inverse_sigmoid(torch.full((1, K), init_opacity, dtype=torch.float32, device=dev))

    start = torch.clamp(s.count, 0, C - K)
    shift = s.count - start
    r = torch.arange(K, dtype=torch.int32, device=dev)
    write = (r >= shift) & (r - shift < n_valid) & (start + r < C)
    slots = (start + r).long()
    src = torch.clamp(r - shift, 0, K - 1).long()

    def blend(dst, new):
        old = dst.index_select(-1, slots)
        aligned = new.index_select(-1, src)
        m = write.reshape((1,) * (dst.ndim - 1) + (K,))
        dst.index_copy_(-1, slots, torch.where(m, aligned.to(dst.dtype), old))

    t32 = torch.as_tensor(time, dtype=torch.int32, device=dev)
    blend(s.xyz, xyz)
    blend(s.features_dc, dc)
    blend(s.features_rest, torch.zeros(s.features_rest.shape[:-1] + (K,), device=dev))
    blend(s.scaling, scales)
    blend(s.rotation, q)
    blend(s.opacity, opa)
    blend(s.eta, eta)
    blend(s.sigma2, sigma2)
    blend(s.observe_count, torch.zeros((K,), dtype=torch.int32, device=dev))
    blend(s.tic, t32.expand(K))
    blend(s.error_count, torch.zeros((K,), dtype=torch.int32, device=dev))
    blend(s.stable, torch.zeros((K,), dtype=torch.bool, device=dev))
    blend(s.active, torch.ones((K,), dtype=torch.bool, device=dev))
    s.count = torch.clamp(s.count + n_valid, max=C).to(torch.int32)
    return s


def grow_surfels(s: SurfelMap, new_capacity: int) -> SurfelMap:
    """A new map of `new_capacity` slots: `s` in the leading slots, the rest
    the empty map's fills (flat log-scale, rotation w = 1, sigma2 1,
    inactive). `s` itself when it already has that many."""
    C = s.capacity
    if new_capacity <= C:
        return s
    pad = new_capacity - C

    def ext(x, fill=0):
        return torch.cat([x, torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype, device=x.device)], dim=-1)

    rotation = ext(s.rotation)
    rotation[0, C:] = 1.0
    return SurfelMap(
        xyz=ext(s.xyz), features_dc=ext(s.features_dc), features_rest=ext(s.features_rest),
        scaling=ext(s.scaling, FLAT_LOG_SCALE), rotation=rotation, opacity=ext(s.opacity),
        eta=ext(s.eta), sigma2=ext(s.sigma2, 1), observe_count=ext(s.observe_count), tic=ext(s.tic),
        error_count=ext(s.error_count), stable=ext(s.stable, False), active=ext(s.active, False),
        count=s.count)


def shrink_surfels(s: SurfelMap, new_capacity: int) -> SurfelMap:
    """The leading `new_capacity` slots of `s` (fresh tensors). The caller
    guarantees that the watermark `count` fits; `s` itself when it has no
    more slots than that."""
    if new_capacity >= s.capacity:
        return s
    out = {f: getattr(s, f)[..., :new_capacity].clone() for f in FIELDS if f != "count"}
    return SurfelMap(**out, count=s.count)


def prefix(s: SurfelMap, n: int) -> SurfelMap:
    """Views of the leading `n` slots of `s` (the watermark the same tensor):
    a write through them writes `s`. `s` itself when it has no more."""
    if n >= s.capacity:
        return s
    return SurfelMap(**{f: getattr(s, f)[..., :n] for f in FIELDS if f != "count"}, count=s.count)


def assign(dst: SurfelMap, src: SurfelMap) -> SurfelMap:
    """Write every field of `src` into `dst`'s buffer of the same shape
    (fields that are the same tensor are skipped); returns `dst`."""
    for f in FIELDS:
        a, b = getattr(dst, f), getattr(src, f)
        if a is not b:
            a.copy_(b)
    return dst


def resize_into(s: SurfelMap, dst: SurfelMap) -> SurfelMap:
    """`grow_surfels` / `shrink_surfels` of `s` to the capacity of `dst`, an
    empty map (`SurfelMap.empty`, never written), written into its buffers:
    the leading slots and the watermark; the slots past `s` keep the empty
    map's fills, which are `grow_surfels`'. Returns `dst`."""
    n = min(s.capacity, dst.capacity)
    for f in FIELDS:
        if f == "count":
            dst.count.copy_(s.count)
        else:
            getattr(dst, f)[..., :n].copy_(getattr(s, f)[..., :n])
    return dst


def prune_surfels(s: SurfelMap, delete_mask: torch.Tensor) -> SurfelMap:
    """Mask-based deletion: slots stay, `active` clears."""
    return s.replace(active=s.active & ~delete_mask)


def compact_surfels(s: SurfelMap) -> SurfelMap:
    """Move all active surfels to the front (stable), count = num_active."""
    order = torch.sort((~s.active).to(torch.int8), stable=True).indices
    out = {f: getattr(s, f).index_select(-1, order) for f in FIELDS if f != "count"}
    return SurfelMap(**out, count=s.num_active().to(torch.int32))


def render_params(s: SurfelMap) -> dict:
    """Derived render inputs. Transposed layout: (k, C) per-surfel fields."""
    rotations = torch.nan_to_num(s.get_rotation(), nan=1.0)
    return {
        "xyz": s.xyz,  # (3, C)
        "opacity": s.get_opacity(),  # (1, C)
        "scales": s.get_scaling(),  # (3, C)
        "rotations": rotations,  # (4, C)
        "normal": s.get_normal(),  # (3, C)
        "shs": s.get_features(),  # (3, K, C)
        "radius": s.get_radius(),  # (C,)
        "active": s.active,  # (C,)
    }


def update_stability(s: SurfelMap, threshold: float = 10.0) -> SurfelMap:
    """Promote surfels whose information confidence exceeds the threshold."""
    s.stable = (s.get_confidence() > threshold) & s.active
    return s
