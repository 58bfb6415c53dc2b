"""The port's run modes against the JAX package: the half-resolution model
view (`Tracking.model_view_down`), the GN early exit (`Tracking.early_exit`),
the settled-frame render skip (`Mapping.settled_skip`) and the forward
frustum compaction (`EGG_FRUSTUM_COMPACT_MIN`).

One sequence runs all three modes at once in both packages: 10 frames of
`tests/test_torch_system.py`'s setup (120x90 synthetic, the "xla"
compositor, the JAX one with 8 surfels per scan step, the port replaying
the JAX spawn draws, recovery off, a fixed map) with `model_view_down` 2
and `solver_stride` 1 (`bench.py`'s BENCH_MVDOWN), `early_exit` with
factor 1.0 (it fires at this size) and `settled_skip` with tolerances wide
enough to fire here (count spread 1e5, 10 deg and 0.5 m a frame); one
init step and `local_map_iter` 1 keep the run short.

Tolerances: poses as the system parity test (0.1 mm, 0.01 deg); the frames
that skip, the surfel count of every frame and the model pyramid's shapes
equal. `dense_track` with the early exit, at factors 1.0 and 0.05 (the
default), within 1e-5 of JAX's delta, rms and count (float32 sums in
another order), the converged flag equal. The frustum compaction's output columns equal
JAX's; a compacted render equals the uncompacted one within the kernels'
forward tolerance, 1e-4 of (1 + |value|).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eggfusion_tpu.core.renderer as j_renderer
from eggfusion_tpu import config as jcfg
from eggfusion_tpu.core import tracker as jtr
from eggfusion_tpu.data.datasets import load_dataset as j_load_dataset
from eggfusion_tpu.main import build_frame as j_build_frame
from eggfusion_tpu.ops import raster_pallas as jrp
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core import tracker as ttr
from eggfusion_tpu_torch.main import run as t_run
from eggfusion_tpu_torch.ops import raster_tile as trt
from test_torch_system import JaxDraws, _pose_errors
from test_torch_tracking import _rotation, _scene_pyramid, _to_torch_pyramid

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

N_FRAMES = 10


def _cfg(lib, tmp):
    return lib.default_config(
        Dataset={"type": "synthetic", "n_frames": N_FRAMES, "preload": False,
                 "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                                 "width": 120, "height": 90, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 1, "local_map_iter": 1, "sample_ratio": 0.03, "sample_ratio_init": 0.08,
                 "settled_skip": True, "settled_skip_tol": 100000, "settled_skip_max_rot": 10.0,
                 "settled_skip_max_trans": 0.5},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0, "model_view_down": 2, "solver_stride": 1, "early_exit": True,
                  "early_exit_factor": 1.0},
        System={"save_dir": str(tmp), "root_dir": str(tmp), "render_backend": "xla", "capacity_bucketing": False,
                "final_global_opt": False, "eval_tracking": False, "eval_render": False, "eval_recon": False},
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both systems after the 10 frames, the JAX frame pyramid's depth and
    the port's GN iterations run."""
    tmp = tmp_path_factory.mktemp("torch_variants")
    cfg_j = _cfg(jcfg, tmp / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_renderer, "render_xla", functools.partial(j_render_xla, chunk=8))
        ef_j = JEGGFusion(cfg_j)
        dataset = j_load_dataset(cfg_j)
        for fid in range(N_FRAMES):
            frame = j_build_frame(dataset, fid, False, nlevel=ef_j.nlevel_frame)
            ef_j.reconstruct(frame)
    ttr.EARLY_EXIT_ITERATIONS["run"] = 0
    ef_t = t_run(_cfg(tcfg, tmp / "torch"), device="cpu", random_source=JaxDraws())
    return ef_j, ef_t, len(frame.pyramid), ttr.EARLY_EXIT_ITERATIONS["run"]


def test_poses(runs):
    ef_j, ef_t, *_ = runs
    t_err, r_err = _pose_errors(ef_j._traj_np("est"), ef_t._traj_np("est"))
    assert t_err.max() < 1e-4, t_err
    assert r_err.max() < 0.01, r_err


def test_settled_frames_skip(runs):
    ef_j, ef_t, *_ = runs
    skips_j = [m["render_skips"] for m in ef_j.metrics if m["frame"] >= 0]
    skips_t = [m["render_skips"] for m in ef_t.metrics if m["frame"] >= 0]
    assert skips_t == skips_j
    fell_on = [i for i in range(1, N_FRAMES) if skips_j[i] > skips_j[i - 1]]
    assert ef_t.mapper.skip_frames == fell_on and len(fell_on) >= 2
    assert all(b - a >= 2 for a, b in zip(fell_on, fell_on[1:]))  # never two in a row


def test_surfel_counts(runs):
    ef_j, ef_t, *_ = runs
    n_j = [int(m["surfels"]) for m in ef_j.metrics if m["frame"] >= 0]
    n_t = [int(m["surfels"]) for m in ef_t.metrics if m["frame"] >= 0]
    assert n_t == n_j


def test_model_view_pyramid(runs):
    """The model pyramid's base is the 1/2 view; frames build one level more."""
    ef_j, ef_t, frame_levels, _ = runs
    shapes_j = [tuple(lvl.intensity.shape) for lvl in ef_j.model_map["pyramid"]]
    shapes_t = [tuple(lvl.intensity.shape) for lvl in ef_t.model_map["pyramid"]]
    assert shapes_t == shapes_j == [(45, 60, 1), (22, 30, 1), (11, 15, 1)]
    assert frame_levels == ef_t.nlevel_frame == 4
    np.testing.assert_allclose(ef_t.model_map["pyramid"][0].intr.numpy(),
                               np.asarray(ef_j.model_map["pyramid"][0].intr), rtol=1e-6)


def test_early_exit_fired(runs):
    """Some levels stopped early: fewer GN iterations than configured."""
    _, ef_t, _, iters = runs
    assert 0 < iters < sum(ef_t.tracker.config.pyramid_iters) * (N_FRAMES - 1)


CASES = {
    "identity": (None, {}),
    "small_motion": (([0.0, 0.02, 0.0], [0.02, 0.0, 0.01]), {"solver_stride": 2}),
}


@pytest.mark.parametrize("factor", [1.0, 0.05])
@pytest.mark.parametrize("case", list(CASES))
def test_dense_track_early_exit(case, factor):
    key, kw = CASES[case]
    pm = _scene_pyramid(None)
    pf = pm if key is None else _scene_pyramid(tuple(map(tuple, key)))
    kw = dict(kw, early_exit=True, early_exit_factor=factor, pyramid_iters=(6, 6, 6))
    out_j = jtr.dense_track(pm, pf, jnp.eye(4), jtr.TrackerConfig(**kw))
    ttr.EARLY_EXIT_ITERATIONS["run"] = 0
    out_t = ttr.dense_track(_to_torch_pyramid(pm), _to_torch_pyramid(pf), torch.eye(4), ttr.TrackerConfig(**kw))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-5)
    assert bool(out_t[1]) == bool(out_j[1])
    for a, b in zip(out_t[2:], out_j[2:]):
        assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-7)
    assert 0 < ttr.EARLY_EXIT_ITERATIONS["run"] < 18  # a level stopped early


def _random_params(n=512, seed=3):
    rng = np.random.default_rng(seed)
    # spread wide: well under half of them in the frustum
    xyz = np.stack([rng.uniform(-5, 5, n), rng.uniform(-4, 4, n), rng.uniform(-2, 5, n)]).astype(np.float32)
    quat = rng.standard_normal((4, n)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    return {
        "xyz": xyz,
        "opacity": rng.uniform(0.2, 0.99, (1, n)).astype(np.float32),
        "scales": np.concatenate([rng.uniform(0.01, 0.05, (2, n)), np.full((1, n), 1e-6)]).astype(np.float32),
        "rotations": quat,
        "normal": quat[1:],
        "shs": rng.uniform(0, 1, (3, 1, n)).astype(np.float32),
        "radius": rng.uniform(0.01, 0.05, n).astype(np.float32),
        "active": rng.uniform(size=n) < 0.8,
    }


def test_frustum_compact_columns():
    params = _random_params()
    w2c = _rotation([0.05, -0.1, 0.02], [0.1, 0.0, 0.3])
    intr = np.asarray([110.0, 110.0, 59.5, 44.5], np.float32)
    out_j = jrp._frustum_compact({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(w2c),
                                 jnp.asarray(intr), 120, 90)
    out_t = trt.frustum_compact({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(w2c),
                                torch.from_numpy(intr), 120, 90)
    assert set(out_t) == set(out_j)
    for k in out_j:
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]), err_msg=k)
    assert 0 < out_t["active"].sum() < 256 == out_t["xyz"].shape[-1]


def test_compacted_render_matches(monkeypatch):
    """A forward render from the compacted prefix equals the full render
    (the compaction keeps every surfel a tile can see while they fit in half
    the slots); a gradient render is never compacted."""
    params = {k: torch.from_numpy(v) for k, v in _random_params(n=384, seed=5).items()}
    w2c = torch.from_numpy(_rotation([0.0, 0.05, 0.0], [0.0, 0.0, 0.2]))
    intr = torch.tensor([110.0, 110.0, 59.5, 44.5])
    full = trt.render_tile(params, w2c, intr, 120, 90, sh_degree=0, cap=256, need_grad=False)
    monkeypatch.setattr(trt, "FRUSTUM_COMPACT_MIN", 0)
    seen = []
    real = trt.frustum_compact
    monkeypatch.setattr(trt, "frustum_compact", lambda *a: seen.append(1) or real(*a))
    comp = trt.render_tile(params, w2c, intr, 120, 90, sh_degree=0, cap=256, need_grad=False)
    assert seen == [1]
    for k in full:
        assert float(((comp[k] - full[k]).abs() / (1 + full[k].abs())).max()) <= 1e-4, k
    trt.render_tile(params, w2c, intr, 120, 90, sh_degree=0, cap=256)
    assert seen == [1]
