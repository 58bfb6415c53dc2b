"""The port's OpenCV sparse frontend and live Azure Kinect reader against the
JAX package's, on the CPU.

- `OpenCVSparseInitializer`: both packages' classes track the same frame
  stand-ins (the intensity and depth each frontend reads, numpy for JAX and
  torch for the port) from `cv2.setRNGSeed(0)`: the port's textured corner
  scene at 320x240 from two poses of its sway trajectory, which solve, then
  a flat gray frame, which does not (None in both). The poses agree to
  1e-6 on the translation (the same OpenCV calls on the same arrays), and
  so do the states each carries forward. `SparseInitializer` takes
  "opencv" to the class, and the class raises its `RuntimeError` when `cv2`
  cannot be imported, as JAX's does.
- `AzureKinectLive`, on a stand-in `pyk4a` module: both classes read the same
  synthetic 1280x720 BGRA capture, resized to a 480x270 calibration. Color
  is within one level (OpenCV's fixed-point rounding, which
  `tests/test_torch_datasets.py::test_resize_matches_cv2` also allows);
  depth, mask, timestamp and pose are equal. Without `pyk4a` both raise
  their `RuntimeError`.
"""
import sys
from types import ModuleType, SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import eggfusion_tpu.core.sparse_init as j_sparse_init
import eggfusion_tpu.data.datasets as j_datasets
from eggfusion_tpu import config as jcfg
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core import sparse_init as t_sparse_init
from eggfusion_tpu_torch.data import datasets as t_datasets
from eggfusion_tpu_torch.data import synthetic as tsyn
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 320, 240
CALIB = {"fx": 260.0, "fy": 260.0, "cx": 159.5, "cy": 119.5, "width": W, "height": H, "depth_scale": 1.0}


def _sparse_cfg(lib):
    return lib.default_config(Dataset={"Calibration": CALIB}, Tracking={"sparse_backend": "opencv"})


def _frames(lib):
    """Frame stand-ins: two views of the textured corner scene and a flat
    gray frame; the first carries its pose."""
    intr = CameraIntrinsics(**{k: CALIB[k] for k in ("fx", "fy", "cx", "cy", "width", "height")})
    poses = tsyn.TRAJECTORIES["sway"](4, 0)
    views = []
    for pose in poses[:2]:
        color, depth = tsyn.render_corner_scene(intr, pose, detail=0.5, device="cpu")
        views.append((color.numpy() @ np.float32([0.299, 0.587, 0.114]), depth.numpy()))
    views.append((np.full((H, W), 0.5, np.float32), views[1][1]))
    conv = (lambda x: x) if lib == "jax" else torch.from_numpy
    out = []
    for i, (gray, depth) in enumerate(views):
        w2c = np.asarray(poses[0], np.float32) if i == 0 else None
        out.append(SimpleNamespace(pyramid=[SimpleNamespace(intensity=conv(gray[..., None].astype(np.float32)))],
                                   depth=conv(depth.astype(np.float32)),
                                   _w2c=None if w2c is None else conv(w2c),
                                   w2c_matrix=(lambda w=w2c: conv(w))))
    return out


def _track_all(init, frames):
    cv2.setRNGSeed(0)
    out = []
    for f in frames:
        out.append((init.track(f), np.array(init.prev[3], np.float64)))
    return out


def test_opencv_frontend_matches_jax():
    init_t = t_sparse_init.SparseInitializer(_sparse_cfg(tcfg))
    assert isinstance(init_t, t_sparse_init.OpenCVSparseInitializer)
    got = _track_all(init_t, _frames("torch"))
    want = _track_all(j_sparse_init.OpenCVSparseInitializer(_sparse_cfg(jcfg)), _frames("jax"))
    assert [r is None for r, _ in got] == [r is None for r, _ in want] == [True, False, True]
    for (a, sa), (b, sb) in zip(got, want):
        if a is not None:
            np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=1e-6, rtol=0)
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        np.testing.assert_allclose(sa, sb, atol=1e-6, rtol=0)
    # the solve moves the camera by about the trajectory's step
    assert 0 < np.linalg.norm(got[1][0][:3, 3] - got[0][1][:3, 3]) < 0.1


def test_opencv_frontend_needs_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="requires OpenCV"):
        t_sparse_init.OpenCVSparseInitializer(_sparse_cfg(tcfg))
    monkeypatch.setattr(j_sparse_init, "cv2", None)
    with pytest.raises(RuntimeError, match="requires OpenCV"):
        j_sparse_init.OpenCVSparseInitializer(_sparse_cfg(jcfg))


def _fake_pyk4a(capture):
    """A stand-in `pyk4a` module whose camera returns `capture`."""
    mod = ModuleType("pyk4a")
    mod.ColorResolution = SimpleNamespace(RES_720P="720p")
    mod.DepthMode = SimpleNamespace(WFOV_2X2BINNED="wfov_2x2")
    mod.started = []

    class Config:
        def __init__(self, color_resolution, depth_mode):
            self.color_resolution, self.depth_mode = color_resolution, depth_mode

    class PyK4A:
        def __init__(self, config):
            self.config = config

        def start(self):
            mod.started.append((self.config.color_resolution, self.config.depth_mode))

        def get_capture(self):
            return capture

    mod.Config, mod.PyK4A = Config, PyK4A
    return mod


def _live_cfg(lib):
    return lib.default_config(Dataset={
        "type": "kinect_live", "max_frames": 7,
        "Calibration": {"fx": 300.0, "fy": 300.0, "cx": 239.5, "cy": 134.5, "width": 480, "height": 270,
                        "depth_scale": 1000.0}})


def test_kinect_live_matches_jax(monkeypatch):
    rng = np.random.default_rng(7)
    # BGRA with a distinct range per channel, so the channel order shows
    bgra = np.stack([rng.integers(lo, hi, (720, 1280)) for lo, hi in ((0, 64), (64, 128), (128, 256), (255, 256))],
                    -1).astype(np.uint8)
    capture = SimpleNamespace(color=bgra,
                              transformed_depth=rng.integers(0, 6000, (720, 1280), dtype=np.uint16),
                              color_timestamp_usec=1_234_567)
    mod = _fake_pyk4a(capture)
    monkeypatch.setitem(sys.modules, "pyk4a", mod)
    ds_t = t_datasets.AzureKinectLive(_live_cfg(tcfg))
    ds_j = j_datasets.AzureKinectLive(_live_cfg(jcfg))
    assert mod.started == [("720p", "wfov_2x2")] * 2
    assert len(ds_t) == len(ds_j) == 7 and ds_t.depth_scale == ds_j.depth_scale == 1000.0
    ts_t, color_t, depth_t, mask_t, pose_t = ds_t[0]
    ts_j, color_j, depth_j, mask_j, pose_j = ds_j[0]
    assert color_t.shape == color_j.shape == (270, 480, 3) and color_t.dtype == color_j.dtype == np.uint8
    assert np.abs(color_t.astype(int) - color_j.astype(int)).max() <= 1
    np.testing.assert_array_equal(depth_t, depth_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(pose_t, pose_j)
    assert ts_t == ts_j == 1.234567
    # BGRA -> RGB: red is the capture's third channel, blue its first
    assert np.abs(color_t.astype(float).mean((0, 1)) - bgra[..., 2::-1].mean((0, 1))).max() < 1.0
    assert color_t[..., 0].min() >= 128 and color_t[..., 2].max() < 64
    ds = t_datasets.load_dataset(tcfg.merge(_live_cfg(tcfg), {"Dataset": {"preload": False}}), "cpu")
    assert isinstance(ds, t_datasets.AzureKinectLive)


def test_kinect_live_needs_pyk4a(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyk4a", None)
    for cls, lib in ((t_datasets.AzureKinectLive, tcfg), (j_datasets.AzureKinectLive, jcfg)):
        with pytest.raises(RuntimeError, match="requires pyk4a"):
            cls(_live_cfg(lib))
