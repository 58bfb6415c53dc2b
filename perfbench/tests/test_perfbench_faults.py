"""`correct` comes out false when the timed path is broken underneath: a run
of `replica.sway` on the CPU at a tenth of its size, past the harness's look
for a chip, once sound and once with each fault the cell can have planted
in the program:

- a step that returns its state unchanged: tracking hands back the previous
  pose;
- an answer altered where it is produced: the tracked pose moved by 3 mm;
  the renderer's depth scaled by 1.002.

The cell has no batch to halve and no exchange between chips. At this size
the limits are the test's own, set between the sound run's readings (rpe
0.69 mm, ate 2.25 mm, map 0.69 mm, view 0.59 mm, by one run) and the faults'.

One more step can return its state unchanged: the window optimization's
Adam step. Its effect shows only where the map is dense enough to hold the
texture and has had hundreds of steps, which a run on the CPU cannot
reach (at a tenth of the size, 40 frames: a color gap of 46.4 levels sound,
47.1 frozen). So that fault is planted on the card, in `replica.sway` as
the benchmark runs it, against the cell's own limits.
"""
import time

import pytest
import torch

from perfbench.harness import driver

LIMITS = {"rpe_mm": 2.0, "ate_mm": 6.0, "map_mm": 2.0, "view_mm": 2.0}


def _run():
    torch.set_num_threads(2)
    line, numbers = driver.run("replica.sway", 4242, 1e9, False, time.perf_counter(), device="cpu", scale=0.1,
                               max_frames=6, limits=LIMITS)
    return line, numbers


def _track_frozen(monkeypatch):
    from eggfusion_tpu_torch.core import tracker

    orig = tracker.Tracker.track_pose

    def track_pose(self, pm, pf, seed, prev):
        return (prev.clone(),) + tuple(orig(self, pm, pf, seed, prev)[1:])

    monkeypatch.setattr(tracker.Tracker, "track_pose", track_pose)


def _pose_altered(monkeypatch):
    from eggfusion_tpu_torch.core import tracker

    orig = tracker.Tracker.track_pose

    def track_pose(self, pm, pf, seed, prev):
        out = orig(self, pm, pf, seed, prev)
        w2c = out[0].clone()
        w2c[0, 3] += 0.003
        return (w2c,) + tuple(out[1:])

    monkeypatch.setattr(tracker.Tracker, "track_pose", track_pose)


def _opt_frozen(monkeypatch):
    from eggfusion_tpu_torch.core import mapper

    monkeypatch.setattr(mapper, "_adam_update", lambda params, grads, moments, step, lrs: (params, moments))


def _render_altered(monkeypatch):
    from eggfusion_tpu_torch.core import renderer

    orig = renderer.Renderer.render_at

    def render_at(self, *a, **k):
        out = orig(self, *a, **k)
        return {**out, "depth": out["depth"] * 1.002}

    monkeypatch.setattr(renderer.Renderer, "render_at", render_at)


def test_sound_run_is_correct():
    line, numbers = _run()
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(LIMITS)


@pytest.mark.parametrize("fault", [_track_frozen, _pose_altered, _render_altered],
                         ids=["state_unchanged", "pose_altered", "render_altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line, numbers = _run()
    assert not line["correct"], (line["checks"], numbers)


@pytest.mark.cuda
def test_frozen_optimizer_is_not_correct_on_the_card(cuda_device, monkeypatch):
    _opt_frozen(monkeypatch)
    line, numbers = driver.run("replica.sway", 20261018, 20.0, False, time.perf_counter())
    assert not line["correct"], (line["checks"], numbers)
