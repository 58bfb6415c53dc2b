"""The generators make the same inputs from the same seed, other inputs
from another, and the same amount of work from every seed."""
import os

import math

import numpy as np
import pytest

from perfbench.gen import scene, trajectories
from perfbench.harness import manifest

CALIB = {"fx": 60.0, "fy": 60.0, "cx": 39.5, "cy": 29.5, "width": 80, "height": 60, "depth_scale": 5000.0}


def _traffic(name: str) -> dict:
    t = manifest.load_json(os.path.join(manifest.BENCH_DIR, "traffic", f"{name}.json"))
    t.update(ramp=min(t["ramp"], 3), period=4)
    return t


def _make(name: str, seed: int, tmp_path, tag: str) -> dict:
    t = _traffic(name)
    d = tmp_path / f"{name}-{seed}-{tag}"
    d.mkdir()
    s = manifest.generator(t).make(CALIB, t, seed, "cpu", str(d))
    return {"gt": s.gt_w2c, "color": s.color, "depth": s.depth, "offset": np.asarray(s.offset)}


@pytest.mark.parametrize("name", ["orbit", "sway"])
def test_same_seed_same_inputs(name, tmp_path):
    big = (1 << 31) + 12345  # seeds reach past 32 signed bits
    a, b, c = _make(name, big, tmp_path, "a"), _make(name, big, tmp_path, "b"), _make(name, 7, tmp_path, "c")
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["color"], c["color"])
    for k in ("gt", "depth"):  # the same work for every seed
        assert np.array_equal(a[k], c[k]), k


def test_streams_are_periodic():
    assert [trajectories.unique_index(k, 3, 4) for k in range(12)] == [0, 1, 2, 3, 4, 5, 6, 3, 4, 5, 6, 3]
    sway = trajectories.sway(60 + 240)
    assert np.allclose(sway[60:180], sway[180:300])
    orbit = trajectories.orbit(691, 690, 0.3, math.radians(220))
    assert np.allclose(orbit[0], orbit[690], atol=1e-12)
    # no jump where a period wraps: the step over the wrap is a step of the period
    step = lambda a, b: np.linalg.norm((a @ np.linalg.inv(b))[:3, 3])
    assert abs(step(sway[60], sway[179]) - step(sway[61], sway[60])) < 5e-3
    assert step(orbit[0], orbit[689]) < 2 * step(orbit[1], orbit[0]) + 1e-9


def test_orbit_sweeps_its_arc():
    """The orbit's camera turns from its start to start + sweep and back,
    never faster than sweep * pi / period radians a frame."""
    sweep, period = math.radians(220), 690
    poses = trajectories.orbit(period, period, 0.0, sweep, radius=1.2, bob=0.0)
    centres = -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3])
    th = np.unwrap(np.arctan2(centres[:, 0], -centres[:, 2]))
    assert abs(th.max() - sweep) < 1e-4 and abs(th.min()) < 1e-12
    assert np.allclose(np.linalg.norm(centres[:, [0, 2]], axis=1), 1.2)
    assert np.abs(np.diff(th)).max() <= sweep * math.pi / period + 1e-9


def test_scene_render():
    col, dep = scene.render(scene.SCENES["corner"], (60.0, 60.0, 39.5, 29.5, 80, 60), np.eye(4))
    assert dep.min() > 0 and col.shape == (60, 80, 3)
