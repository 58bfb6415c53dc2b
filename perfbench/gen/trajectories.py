"""Camera trajectories of the benchmark's streams, as host numpy (N, 4, 4)
world-to-camera poses.

Frozen copy of `eggfusion_tpu_torch/data/synthetic.py`'s
`make_trajectory` (sway) and `make_orbit_trajectory` at commit 90c4a41,
changed so that every stream is periodic: the sway's amplitude ramp stops
at frame `ramp` (from there the motion repeats every 120 frames exactly),
and the orbit sweeps an arc out and back in `period` frames. A stream of
any length replays these unique poses by `unique_index`.
"""
from __future__ import annotations

import math

import numpy as np

SWAY_PERIOD = 120


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def sway(n: int, ramp: int = 60, translation_scale: float = 0.015, rotation_scale: float = 0.004):
    """The sway of `bench.py`: frame 0 at the identity, a tanh amplitude
    ramp over the first `ramp` frames, then a 120-frame sway period."""
    poses = []
    i_sat = 20.0
    om = 2 * math.pi / SWAY_PERIOD
    for i in range(n):
        ei = i_sat * math.tanh(min(i, ramp) / i_sat)
        tx = translation_scale * ei * math.sin(0.5 + om * i)
        ty = 0.5 * translation_scale * ei * math.sin(2 * om * i)
        tz = -0.8 * translation_scale * ei
        wy = rotation_scale * ei * math.sin(om * i + 0.3)
        wx = 0.5 * rotation_scale * ei * math.cos(om * i)
        T = np.eye(4)
        T[:3, :3] = _rot_y(wy) @ _rot_x(wx)
        T[:3, 3] = [tx, ty, tz]
        poses.append(T)
    return np.stack(poses)


def orbit(n: int, period: int, start: float, sweep: float, radius: float = 2.2, bob: float = 0.08):
    """A camera on a circle of radius `radius` facing outward, sweeping
    from the angle `start` to `start + sweep` and back once every `period`
    frames, its angular speed a sine (at rest at either end), with a
    vertical bob of `bob` metres (two bobs each way)."""
    poses = []
    for i in range(n):
        ph = 2 * math.pi * i / period
        th = start + 0.5 * sweep * (1 - math.cos(ph))
        c = np.array([radius * math.sin(th), bob * math.sin(4 * ph), -radius * math.cos(th)])
        Rc2w = _rot_y(math.pi - th)
        T = np.eye(4)
        T[:3, :3] = Rc2w.T
        T[:3, 3] = -Rc2w.T @ c
        poses.append(T)
    return np.stack(poses)


def unique_index(k: int, ramp: int, period: int) -> int:
    """The unique frame that stream frame `k` replays: the first `ramp`
    frames once, then a period of `period` frames over and over."""
    return k if k < ramp + period else ramp + (k - ramp) % period
