"""Port parity of tracking recovery and of the synthetic data it is tested
on: the coarse rotation sweep, descriptor relocalization and its native
binding, the synthetic scene's texture options, trajectories and sensor
noise, the NaN guard; and the port's own corrupted-frame runs of
`tests/test_recovery.py`.

Tolerances: the rotation sweep on the same model view and frame commits the
same number of hypotheses and seeds within 1e-4 (float32 Gauss-Newton on
pyramids built by each package); relocalization picks the same keyframe
with the same inlier count and a pose within 1e-5 (the same C++ on the same
images); the native binding returns the same keypoints and descriptors bit
for bit; synthetic frames agree to 1e-5, trajectories and the noise model
exactly (host numpy). The corrupted-frame run keeps the JAX test's bound:
ATE over the good frames under 3 cm.
"""
import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggfusion_tpu import config as jcfg
from eggfusion_tpu.core.frame import Frame as JFrame
from eggfusion_tpu.data import synthetic as jsyn
from eggfusion_tpu.ops.pyramid import build_pyramid as j_build_pyramid
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core.frame import Frame as TFrame
from eggfusion_tpu_torch.core.mapper import KeyFrame
from eggfusion_tpu_torch.data import synthetic as tsyn
from eggfusion_tpu_torch.data.datasets import load_dataset as t_load_dataset
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.main import build_frame as t_build_frame
from eggfusion_tpu_torch.ops.pyramid import build_pyramid as t_build_pyramid
from eggfusion_tpu_torch.system import EGGFusion as TEGGFusion
from eggfusion_tpu_torch.utils import eval as t_eval

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 120, 90


def _intr(w=W, h=H, f=110.0):
    return CameraIntrinsics(fx=f, fy=f, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)


def _pose_yaw(deg, t=(0.0, 0.0, 0.0)):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T[:3, 3] = t
    return T


def _cfg(lib, tmp_path, n_frames=4, **system):
    """`tests/test_recovery.py`'s configuration."""
    return lib.default_config(
        Dataset={"type": "synthetic", "n_frames": n_frames, "preload": False,
                 "Calibration": {"fx": 110.0, "fy": 110.0, "cx": W / 2 - 0.5, "cy": H / 2 - 0.5,
                                 "width": W, "height": H, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 6144},
        Tracking={"recover_after": 2},
        Mapping={"local_map_iter_init": 6, "local_map_iter": 2, "sample_ratio": 0.05, "sample_ratio_init": 0.15},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        System={"save_dir": str(tmp_path / "run"), "root_dir": str(tmp_path), "final_global_opt": False,
                "render_backend": "xla", "capacity_bucketing": False, **system},
    )


# ---- synthetic data ----------------------------------------------------------


@pytest.mark.parametrize("detail,flat_x,scene", [(0.25, 0.0, "corner"), (0.0, 0.5, "corner"),
                                                 (0.25, 0.5, "room")])
def test_synthetic_scene_options(detail, flat_x, scene):
    intr = _intr(64, 48, 60.0)
    pose = _pose_yaw(30.0, (0.1, -0.05, 0.2))
    cj, dj = jsyn.render_corner_scene(intr, pose, detail=detail, flat_x=flat_x, scene=scene)
    ct, dt = tsyn.render_corner_scene(intr, pose, detail=detail, flat_x=flat_x, scene=scene)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    assert float(dt.min()) > 0


@pytest.mark.parametrize("name", ["handheld", "loop", "orbit"])
def test_trajectories(name):
    np.testing.assert_array_equal(tsyn.TRAJECTORIES[name](40, 3), jsyn.TRAJECTORIES[name](40, 3))


def test_sensor_noise():
    rng = np.random.default_rng(0)
    color = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (48, 64, 1)).astype(np.float32)
    depth[10:20, 10:30] = 0.0
    for a, b in zip(tsyn.apply_sensor_noise(color, depth, seed=5), jsyn.apply_sensor_noise(color, depth, seed=5)):
        np.testing.assert_array_equal(a, b)


def test_dataset_options(tmp_path):
    """The dataset keys: trajectory, seed, texture, scene, lazy frames on
    the device, and noise applied to each frame with the JAX seeds."""
    ds_cfg = {"trajectory": "handheld", "seed": 3, "texture_detail": 0.25, "textureless_x": 0.5}
    base = _cfg(tcfg, tmp_path, n_frames=3)
    cfg = tcfg.merge(base, {"Dataset": {**ds_cfg, "device_frames": True}})
    lazy = t_load_dataset(tcfg.merge(cfg, {"Dataset": {"lazy_device": True}}), "cpu")
    eager = t_load_dataset(cfg, "cpu")
    noise = {"enabled": True, "color_sigma": 0.05}
    noisy = t_load_dataset(tcfg.merge(cfg, {"Dataset": {"noise": noise}}), "cpu")
    np.testing.assert_array_equal(np.stack(eager.poses), jsyn.make_handheld_trajectory(3, seed=3))
    intr = eager.intrinsics
    for i in range(3):
        _, c, d, _, pose = eager[i]
        _, cl, dl, _, _ = lazy[i]
        assert torch.equal(c, cl) and torch.equal(d, dl)
        ct, dt = tsyn.render_corner_scene(intr, pose, detail=0.25, flat_x=0.5)
        assert torch.equal(c, ct) and torch.equal(d, dt)
        cn, dn = tsyn.apply_sensor_noise(c.numpy(), d.numpy(), seed=3 * 100003 + i, color_sigma=0.05)
        _, c2, d2, _, _ = noisy[i]
        np.testing.assert_array_equal(c2.numpy(), cn)
        np.testing.assert_array_equal(d2.numpy(), dn)


# ---- recovery parity ---------------------------------------------------------


def test_rotation_hypothesis_seed(tmp_path):
    """The coarse rotation sweep of both packages on the same model view
    (the scene at the origin) and frame (yawed by -12 deg)."""
    cj, ct = _cfg(jcfg, tmp_path), _cfg(tcfg, tmp_path)
    ef_j, ef_t = JEGGFusion(cj), TEGGFusion(ct, device="cpu")
    intr = _intr()
    A, B = _pose_yaw(0.0), _pose_yaw(-12.0, (0.01, 0.0, -0.02))
    c0, d0 = (np.array(x) for x in jsyn.render_corner_scene(intr, A))
    c1, d1 = (np.array(x) for x in jsyn.render_corner_scene(intr, B))
    ia = np.asarray([intr.fx, intr.fy, intr.cx, intr.cy], np.float32)
    ones = np.ones((H, W, 1), np.float32)
    ef_j.model_map = {"transform": jnp.asarray(A), "pyramid": j_build_pyramid(
        jnp.asarray(c0), jnp.asarray(d0), jnp.asarray(ones), jnp.asarray(ia), nlevel=3)}
    ef_t.model_map = {"transform": torch.from_numpy(A), "pyramid": t_build_pyramid(
        torch.from_numpy(c0), torch.from_numpy(d0), torch.from_numpy(ones), torch.from_numpy(ia), nlevel=3)}
    args = dict(uid=1, ts=0.05, color_u8=c1, depth_raw=d1[..., 0], mask=ones[..., 0], gt_pose_w2c=B,
                depth_scale=1.0, nlevel=3, prefiltered=True)
    n_j = ef_j._rotation_hypothesis_seed(JFrame(intr=jsyn.CameraIntrinsics(*intr), **args))
    n_t = ef_t._rotation_hypothesis_seed(TFrame(intr=intr, device="cpu", **args))
    assert n_t == n_j > 0
    np.testing.assert_allclose(ef_t.tracker.seed_override.numpy(), np.asarray(ef_j.tracker.seed_override),
                               atol=1e-4)
    # the override is one-shot: the next seed consumes it
    override = ef_t.tracker.seed_override
    assert torch.equal(ef_t.tracker._seed_delta(None, None), override) and ef_t.tracker.seed_override is None


RW, RH, DETAIL = 160, 120, 0.25


def _reloc_scene():
    """`tests/test_reloc.py`'s keyframes (yaw 0 and 40 deg) and a query
    near the first, as host arrays."""
    intr = CameraIntrinsics(fx=0.9 * RW, fy=0.9 * RW, cx=RW / 2 - 0.5, cy=RH / 2 - 0.5, width=RW, height=RH)
    poses = {0: _pose_yaw(0.0), 7: _pose_yaw(40.0, (0.3, 0.0, 0.1))}
    kfs = {}
    for uid, w2c in poses.items():
        c, d = jsyn.render_corner_scene(intr, w2c, detail=DETAIL)
        kfs[uid] = (w2c, np.asarray(c), np.asarray(d))
    query = _pose_yaw(2.0, (0.02, 0.0, -0.01))
    c, d = jsyn.render_corner_scene(intr, query, detail=DETAIL)
    cfg = lambda lib: lib.default_config(
        Dataset={"type": "synthetic", "Calibration": {"fx": intr.fx, "fy": intr.fy, "cx": intr.cx, "cy": intr.cy,
                                                      "width": RW, "height": RH, "depth_scale": 1.0}},
        Tracking={"fast_threshold": 10})
    return intr, kfs, query, np.asarray(c), np.asarray(d), cfg


def test_relocalizer_parity():
    from eggfusion_tpu.core.reloc import DescriptorRelocalizer as JReloc
    from eggfusion_tpu.ops.pyramid import _gray as j_gray
    from eggfusion_tpu_torch.core.reloc import DescriptorRelocalizer as TReloc

    intr, kfs, query, color, depth, cfg = _reloc_scene()
    # the same lost frame for both: its pyramid intensity and depth
    gray = np.asarray(j_gray(jnp.asarray(color)))
    frame_j = SimpleNamespace(pyramid=[SimpleNamespace(intensity=gray)], depth=depth)
    frame_t = SimpleNamespace(pyramid=[SimpleNamespace(intensity=torch.from_numpy(gray))],
                              depth=torch.from_numpy(depth))
    kf_j = {u: SimpleNamespace(uid=u, w2c=w, maps={"color": c, "depth": d}) for u, (w, c, d) in kfs.items()}
    kf_t = {u: SimpleNamespace(uid=u, w2c=torch.from_numpy(w), maps={"color": torch.from_numpy(c),
                                                                     "depth": torch.from_numpy(d)})
            for u, (w, c, d) in kfs.items()}
    hit_j = JReloc(cfg(jcfg)).relocalize(frame_j, kf_j)
    hit_t = TReloc(cfg(tcfg)).relocalize(frame_t, kf_t)
    assert hit_j is not None and hit_t is not None
    assert hit_t[1] == hit_j[1] == 0  # the matching view, not the latest keyframe
    assert hit_t[2] == hit_j[2] >= 20
    np.testing.assert_allclose(hit_t[0], hit_j[0], atol=1e-5)
    assert np.linalg.norm(hit_t[0][:3, 3] - query[:3, 3]) < 0.02


def test_relocalizer_needs_texture():
    from eggfusion_tpu_torch.core.reloc import DescriptorRelocalizer

    _, kfs, _, _, _, cfg = _reloc_scene()
    w, c, d = kfs[0]
    kf = SimpleNamespace(uid=0, w2c=torch.from_numpy(w), maps={"color": torch.from_numpy(c),
                                                               "depth": torch.from_numpy(d)})
    blank = SimpleNamespace(pyramid=[SimpleNamespace(intensity=torch.full((RH, RW, 1), 0.5))],
                            depth=torch.ones((RH, RW, 1)))
    assert DescriptorRelocalizer(cfg(tcfg)).relocalize(blank, {0: kf}) is None


def test_native_binding_parity():
    """The port's own build of `native/sparse_frontend.cpp` and its
    bindings give the JAX package's bindings' results bit for bit."""
    from eggfusion_tpu.native import sparse as j_nsp
    from eggfusion_tpu_torch import native as t_native
    from eggfusion_tpu_torch.native import sparse as t_nsp
    from eggfusion_tpu_torch.core.reloc import _to_gray_u8

    _, kfs, _, color, depth, _ = _reloc_scene()
    g0, g1 = _to_gray_u8(kfs[0][1]), _to_gray_u8(color)
    a, b = t_nsp.detect(g0, threshold=10), j_nsp.detect(g0, threshold=10)
    assert len(a[0]) > 50
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    c1 = t_nsp.detect(g1, threshold=10)
    args = (*a, *c1, kfs[0][2][..., 0], depth[..., 0], 144.0, 144.0, RW / 2 - 0.5, RH / 2 - 0.5)
    (dt, nt), (dj, nj) = t_nsp.track(*args), j_nsp.track(*args)
    assert nt == nj > 0 and np.array_equal(dt, dj)
    path = t_native.target("sparse_frontend")
    assert path.exists() and path.parent == t_native.BUILD_DIR


# ---- the port's system -------------------------------------------------------


def _corrupt_frame(uid, gt_pose):
    """Depth dropout and a flat color: the dense solve cannot converge."""
    return TFrame(uid=uid, ts=uid * 0.05, color_u8=np.full((H, W, 3), 0.5, np.float32),
                  depth_raw=np.zeros((H, W), np.float32), mask=np.ones((H, W), np.float32),
                  gt_pose_w2c=np.asarray(gt_pose, np.float32), intr=_intr(), depth_scale=1.0, device="cpu",
                  nlevel=3, prefiltered=True)


def test_recovers_after_tracking_loss(tmp_path):
    n = 16
    cfg = _cfg(tcfg, tmp_path, n_frames=n)
    dataset = t_load_dataset(cfg, "cpu")
    ef = TEGGFusion(cfg, device="cpu")
    bad = range(6, 9)
    for fid in range(n):
        ef.reconstruct(_corrupt_frame(fid, dataset.poses[fid]) if fid in bad
                       else t_build_frame(dataset, fid, False, "cpu"))
    recs = [m for m in ef.metrics if "recovered_to_kf" in m]
    assert recs, "recovery never triggered"
    assert all("rot_sweep_converged" in m for m in recs)
    good = [i for i in range(n) if i not in bad]
    ref, est = ef._traj_np("ref")[good][:, :3, 3], ef._traj_np("est")[good][:, :3, 3]
    assert t_eval.ate_rmse(ref, est) < 3.0


def test_no_recovery_on_clean_sequence(tmp_path):
    n = 10
    cfg = _cfg(tcfg, tmp_path, n_frames=n)
    dataset = t_load_dataset(cfg, "cpu")
    ef = TEGGFusion(cfg, device="cpu")
    for fid in range(n):
        ef.reconstruct(t_build_frame(dataset, fid, False, "cpu"))
    assert not [m for m in ef.metrics if "recovered_to_kf" in m]
    assert ef.tracker.recover_after == 2 and ef.tracker.readback_lag == 3


def test_nan_keyframe_map_raises(tmp_path):
    cfg = _cfg(tcfg, tmp_path, check_nan=True)
    dataset = t_load_dataset(cfg, "cpu")
    ef = TEGGFusion(cfg, device="cpu")
    for fid in range(2):
        ef.reconstruct(t_build_frame(dataset, fid, False, "cpu"))
    km = ef.mapper.keyframe_manager
    kf = km.keyframes[km.ids()[-1]]
    kf.maps["color"] = kf.maps["color"].clone()
    kf.maps["color"][0, 0, 0] = float("nan")
    km.sliding_window.clear()
    km.sliding_window.append(kf)
    with pytest.raises(FloatingPointError, match="non-finite"):
        ef.mapper.frame_batch_optimization(None)
    assert TEGGFusion(_cfg(tcfg, tmp_path), device="cpu").mapper.debug_nan is False


def test_keyframe_host_storage(tmp_path):
    """`System.keyframe_storage: host` keeps numpy maps, for the keyframes
    and for the sliding window's members (as the JAX mapper builds them),
    and uploads the same values on demand."""
    cfg = _cfg(tcfg, tmp_path, keyframe_storage="host")
    dataset = t_load_dataset(cfg, "cpu")
    ef = TEGGFusion(cfg, device="cpu")
    frame = t_build_frame(dataset, 0, False, "cpu")
    ef.reconstruct(frame)
    kf = ef.mapper.keyframe_manager.keyframes[0]
    assert kf.storage == "host" and all(isinstance(v, np.ndarray) for v in kf.maps.values())
    window = list(ef.mapper.keyframe_manager.sliding_window)
    assert window
    for member in window:
        assert member.storage == "host" and all(isinstance(v, np.ndarray) for v in member.maps.values())
    dev = KeyFrame(frame, ef.frame_map, 0, 0).device_maps()
    for k, v in kf.device_maps().items():
        assert torch.equal(v, dev[k]), k
