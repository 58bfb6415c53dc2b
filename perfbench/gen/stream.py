"""What a generator builds on: a traffic mix's unique poses and frames,
drawn from the seed, and the `Stream` it hands to the harness.

A seed changes the texture's offset alone. The scene's geometry, the
trajectory and the number of frames are the traffic file's, the same for
every seed: every seed asks for the same work.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from perfbench.gen import scene, trajectories

SEED_MOD = 1 << 62


def intrinsics(calib: dict) -> tuple:
    """(fx, fy, cx, cy, width, height) of a configuration's calibration."""
    return (float(calib["fx"]), float(calib["fy"]), float(calib["cx"]), float(calib["cy"]),
            int(calib["width"]), int(calib["height"]))


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


def unique_poses(traffic: dict) -> np.ndarray:
    """The (ramp + period, 4, 4) w2c poses of the mix's unique frames, in
    the scene's frame."""
    n = int(traffic["ramp"]) + int(traffic["period"])
    kind = traffic["trajectory"]
    if kind == "orbit":
        return trajectories.orbit(n, int(traffic["period"]), math.radians(float(traffic["start_deg"])),
                                  math.radians(float(traffic["sweep_deg"])), float(traffic["radius"]),
                                  float(traffic["bob"]))
    if kind == "sway":
        return trajectories.sway(n, int(traffic["ramp"]))
    raise ValueError(f"unknown trajectory {kind!r}")


def scene_planes(traffic: dict) -> np.ndarray:
    return scene.SCENES[traffic["scene"]]


def texture_offset(seed: int) -> tuple:
    """The texture's offset (3,) that `seed` draws."""
    return tuple(seed_rng(seed, 3).uniform(0.0, 20.0, size=3))


def render_frame(traffic: dict, seed: int, intr: tuple, w2c: np.ndarray, device):
    """The clean color (H, W, 3) in [0, 1] and metric depth (H, W) of one
    unique pose, on `device`."""
    return scene.render(scene_planes(traffic), intr, w2c, float(traffic["detail"]), texture_offset(seed), device)


@dataclass
class Stream:
    """A periodic camera stream through the scene of plane rows `planes`,
    textured with `detail` at `offset`. `gt_w2c` (n_unique, 4, 4) float64
    are the unique poses in the scene's frame; stream frame k replays
    unique frame `unique(k)`. Host frames: `color` (n_unique, H, W, 3)
    uint8 and `depth` (n_unique, H, W) uint16 in `depth_scale` units. A
    generator that writes a recording instead sets `path`, which the
    program's own loader then reads (`harness.port.system`)."""

    planes: np.ndarray
    detail: float
    offset: tuple
    intr: tuple
    depth_scale: float
    ramp: int
    period: int
    rate_hz: float
    gt_w2c: np.ndarray
    color: np.ndarray | None = None
    depth: np.ndarray | None = None
    path: str | None = None

    def unique(self, k: int) -> int:
        return trajectories.unique_index(k, self.ramp, self.period)

    def gt_rebased(self, k: int) -> np.ndarray:
        """Stream frame k's w2c relative to frame 0's, as a dataset rebases
        its poses (frame 0 becomes the identity)."""
        return self.gt_w2c[self.unique(k)] @ np.linalg.inv(self.gt_w2c[self.unique(0)])

    def timestamp(self, k: int) -> float:
        return k / self.rate_hz
