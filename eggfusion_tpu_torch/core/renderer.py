"""Renderer facade: selects the rasterizer backend (port of
`eggfusion_tpu/core/renderer.py`).

Backends, named as in the JAX package:
  "pallas" — the tile compositor (`ops.raster_tile`), whose forward,
             geometry-only and backward passes are the CUDA kernels of
             `csrc/` on the GPU; default on CUDA.
  "xla"    — the all-pairs oracle (`ops.raster_xla`); default on the CPU.
Outputs are channel-last (H, W, C).
"""
from __future__ import annotations

import torch

from eggfusion_tpu_torch.ops import raster_tile
from eggfusion_tpu_torch.ops.raster_xla import render_xla


def default_backend(device: torch.device) -> str:
    return "pallas" if torch.device(device).type == "cuda" else "xla"


class Renderer:
    def __init__(self, cfg, device, backend: str | None = None):
        surfel = cfg.Surfel
        self.device = torch.device(device)
        self.max_sh_degree = int(surfel.max_sh_degree)
        active = int(surfel.active_sh_degree)
        self.active_sh_degree = self.max_sh_degree if active < 0 else active
        self.backend = backend or str(cfg.System.get("render_backend", "")) or default_backend(self.device)
        if self.backend not in ("pallas", "xla"):
            raise ValueError(f"unknown render backend {self.backend!r}")
        # per-tile entry capacity of the tile compositor (4 sub-columns of
        # cap/4 slots each) for coverage-critical renders
        self.raster_cap = int(cfg.System.get("raster_cap", 2048))
        # entry capacity of optimization (gradient) renders, never above
        # raster_cap; 0 = 1024
        self.opt_raster_cap = min(int(cfg.System.get("opt_raster_cap", 0)) or 1024, self.raster_cap)
        # adaptive model-render cap: the mapper renders at model_cap_min
        # while the measured occupancy stays under the small slab's ceiling
        self.adaptive_model_cap = (bool(cfg.System.get("adaptive_model_cap", True))
                                   and self.backend == "pallas")
        self.model_cap_min = min(int(cfg.System.get("model_cap_min", 0)) or 1024, self.raster_cap)

    def render_at(self, params: dict, w2c, intr, width: int, height: int, cache=None,
                  geom_only: bool = False, need_grad: bool = True, tile_keep=None,
                  cap: int | None = None, with_occupancy: bool = False, with_stats: bool = False) -> dict:
        """See the JAX method: `geom_only` returns {depth, opacity};
        `need_grad=False` skips the gradient back-map; `tile_keep`,
        `with_occupancy` and `with_stats` (the binning's counters,
        "bin_stats") apply to the tile backend."""
        if self.backend == "pallas":
            return raster_tile.render_tile(params, w2c, intr, width, height,
                                           sh_degree=self.active_sh_degree,
                                           cap=cap or self.raster_cap, binning=cache,
                                           geom_only=geom_only, need_grad=need_grad,
                                           tile_keep=tile_keep, with_occupancy=with_occupancy,
                                           with_stats=with_stats)
        out = render_xla(params, w2c, intr, width, height, sh_degree=self.active_sh_degree)
        if geom_only:
            out = {"depth": out["depth"], "opacity": out["opacity"]}
        return out

    def precompute_cache(self, params: dict, w2c, intr, width: int, height: int,
                         cap: int | None = None):
        """Per-camera tile binning, reusable across a few optimization steps
        on one camera; None for the all-pairs backend."""
        if self.backend == "pallas":
            return raster_tile.compute_binning(params, w2c, intr, width, height,
                                               cap=cap or self.raster_cap)
        return None
