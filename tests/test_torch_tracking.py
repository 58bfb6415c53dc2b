"""Port parity of the tracking front end: image ops, the pyramid, frame
preparation, the GN normal equations and `dense_track_pose`, against the
JAX package on the same numpy inputs (the 80x60 corner-scene cases of
`tests/test_tracker.py` and random images in the style of
`tests/test_image_ops.py`).

Tolerances: elementwise image ops 1e-5 (float32, same formulas); the
blur-decimate products and the normal equations 1e-4 relative (float32
sums over thousands of pixels in another order); poses 1e-4.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggfusion_tpu.core import frame as jframe
from eggfusion_tpu.core import tracker as jtr
from eggfusion_tpu.data.synthetic import render_corner_scene
from eggfusion_tpu.geometry.camera import CameraIntrinsics
from eggfusion_tpu.ops import image as jim
from eggfusion_tpu.ops import pyramid as jpyr
from eggfusion_tpu.ops import reduce as jgn
from eggfusion_tpu_torch.core import frame as tframe
from eggfusion_tpu_torch.core import tracker as ttr
from eggfusion_tpu_torch.ops import image as tim
from eggfusion_tpu_torch.ops import pyramid as tpyr
from eggfusion_tpu_torch.ops import reduce as tgn

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

INTR = CameraIntrinsics(fx=72.0, fy=72.0, cx=39.5, cy=29.5, width=80, height=60)
INTR_NP = np.asarray([72.0, 72.0, 39.5, 29.5], np.float32)


@pytest.fixture
def rng(request):
    """A generator of the test's own, seeded from its name (parameters
    included): a test's inputs do not depend on which tests ran before it
    in the worker."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t) else np.asarray(t),
                               np.asarray(j), atol=atol, rtol=rtol)


def _depth(rng, h=60, w=80):
    d = 1.5 + 0.2 * rng.standard_normal((h, w)).astype(np.float32) * 0.1
    d[:, w // 2:] += 0.5  # a depth edge
    return d.astype(np.float32)


def _rotation(rotvec, trans):
    from scipy.spatial.transform import Rotation

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32)
    T[:3, 3] = trans
    return T


@functools.lru_cache(maxsize=None)
def _scene_pyramid(key):
    w2c = np.eye(4, dtype=np.float32) if key is None else _rotation(*key)
    color, depth = render_corner_scene(INTR, w2c)
    return jpyr.build_pyramid(color, depth, jnp.ones_like(depth), INTR.as_array(), nlevel=3)


def _to_torch_pyramid(pyr):
    return tuple(tpyr.PyramidLevel(*[_t(x) for x in lvl]) for lvl in pyr)


@pytest.mark.parametrize("op", ["vertex_normal", "scharr", "downsample_even", "downsample_odd",
                                "decimate", "diff_gradients"])
def test_image_ops(op, rng):
    d = _depth(rng)
    if op == "vertex_normal":
        for a, b in zip(jim.compute_vertex_and_normal(jnp.asarray(d)[..., None], jnp.asarray(INTR_NP)),
                        tim.compute_vertex_and_normal(_t(d)[..., None], _t(INTR_NP))):
            _close(a, b)
    elif op == "scharr":
        for a, b in zip(jim.scharr_gradient(jnp.asarray(d)), tim.scharr_gradient(_t(d))):
            _close(a, b)
    elif op.startswith("downsample"):
        img = rng.uniform(size=(61, 79, 3) if op.endswith("odd") else (60, 80, 3)).astype(np.float32)
        _close(jim.gaussian_downsample(jnp.asarray(img)), tim.gaussian_downsample(_t(img)), atol=1e-5, rtol=1e-5)
    elif op == "decimate":
        img = rng.uniform(size=(60, 80, 3)).astype(np.float32)
        _close(jim.decimate2d(jnp.asarray(img), 4), tim.decimate2d(_t(img), 4), atol=0)
        m = img[..., 0] > 0.5
        np.testing.assert_array_equal(tim.decimate2d(_t(m), 2).numpy(), np.asarray(jim.decimate2d(jnp.asarray(m), 2)))
    else:
        for a, b in zip(jim.diff_gradients(jnp.asarray(d)), tim.diff_gradients(_t(d))):
            _close(a, b)


@pytest.mark.parametrize("mode", ["exact", "separable"])
def test_bilateral_filters(mode, rng):
    d = _depth(rng, 30, 40)[..., None]
    fj = jim.bilateral_filter if mode == "exact" else jim.bilateral_filter_separable
    _close(fj(jnp.asarray(d), 13, 0.03, 4.5), tim.bilateral(mode)(_t(d), 13, 0.03, 4.5), atol=1e-5)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sampling(padding, rng):
    img = rng.uniform(size=(20, 30, 3)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (7, 9, 2)).astype(np.float32)
    _close(jim.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), padding),
           tim.bilinear_sample(_t(img), _t(coords), padding), atol=1e-6)
    _close(jim.nearest_sample(jnp.asarray(img), jnp.asarray(coords), padding),
           tim.nearest_sample(_t(img), _t(coords), padding), atol=0)


@pytest.mark.parametrize("sampler", ["packed", "bilinear", "nearest"])
def test_sampling_nan_coords(sampler, rng):
    """A NaN coordinate (a NaN pose mid-solve) samples as the JAX module's
    float->int cast has it (index 0) instead of failing in the gather."""
    coords = rng.uniform(-1.1, 1.1, (7, 9, 2)).astype(np.float32)
    coords[1, 2, 0] = coords[3, 4, 1] = coords[5, 6] = np.nan
    if sampler == "packed":
        pack = rng.uniform(size=(20, 30, 20)).astype(np.float32)
        outs_j = jgn._sample_packed(jnp.asarray(pack), jnp.asarray(coords))
        outs_t = tgn._sample_packed(_t(pack), _t(coords))
    else:
        img = rng.uniform(size=(20, 30, 3)).astype(np.float32)
        fj = jim.bilinear_sample if sampler == "bilinear" else jim.nearest_sample
        ft = tim.bilinear_sample if sampler == "bilinear" else tim.nearest_sample
        outs_j, outs_t = (fj(jnp.asarray(img), jnp.asarray(coords)),), (ft(_t(img), _t(coords)),)
    for a, b in zip(outs_j, outs_t):
        _close(a, b, atol=1e-6)


@pytest.mark.parametrize("bilateral", ["exact", "separable"])
def test_prepare_frame_and_pyramid(bilateral, rng):
    color_u8 = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    depth = _depth(rng) * 1000.0
    mask = np.ones((60, 80), np.float32)
    cj, dj, mj = jframe.prepare_frame_inputs(jnp.asarray(color_u8), jnp.asarray(depth), jnp.asarray(mask),
                                             jnp.float32(1000.0), 3, bilateral)
    ct, dt, mt = tframe.prepare_frame_inputs(_t(color_u8), _t(depth), _t(mask), 1000.0, bilateral)
    for a, b in ((cj, ct), (dj, dt), (mj, mt)):
        _close(a, b, atol=1e-5, rtol=1e-6)
    pj = jpyr.build_pyramid(cj, dj, mj, jnp.asarray(INTR_NP), nlevel=3, bilateral=bilateral)
    pt = tpyr.build_pyramid(ct, dt, mt, _t(INTR_NP), nlevel=3, bilateral=bilateral)
    for lj, lt in zip(pj, pt):
        for f in lj._fields:
            a, b = getattr(lj, f), getattr(lt, f)
            if f == "mask":
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            else:
                # disparity is 1/depth: relative bound
                _close(a, b, atol=1e-4, rtol=1e-4)


# the perturbation cases of tests/test_tracker.py::TestDenseTrack: (frame pose, config)
CASES = {
    "identity": (None, dict(use_rgb=False)),
    "small_pose": (([0.002, -0.004, 0.003], [0.008, -0.005, 0.006]), dict(use_rgb=False, pyramid_iters=(4, 4, 4))),
    "rgb_term": (([0.0, 0.003, -0.002], [-0.006, 0.004, 0.0]),
                 dict(use_rgb=True, rgb_weight=1e-4, pyramid_iters=(4, 4, 4))),
    "larger_motion": (([0.0, 0.01, 0.0], [0.03, 0.0, -0.02]), dict(use_rgb=False, pyramid_iters=(5, 5, 5))),
}


def _normal_equations_jax(model, frame, T, use_rgb, stride):
    return jax.jit(jgn.build_normal_equations, static_argnums=(3, 4, 5, 6, 7))(
        model, frame, T, 20.0, 0.1, use_rgb, 1e-4, stride)


@pytest.mark.parametrize("stride", [1, 2])
def test_normal_equations_per_level(stride):
    key = ([0.0, 0.003, -0.002], [-0.006, 0.004, 0.0])
    pm, pf = _scene_pyramid(None), _scene_pyramid(tuple(map(tuple, key)))
    tm, tf_ = _to_torch_pyramid(pm), _to_torch_pyramid(pf)
    T = _rotation([0.001, 0.0, -0.001], [0.002, 0.0, 0.001])
    for lvl in range(3):
        outs_j = _normal_equations_jax(pm[lvl], pf[lvl], jnp.asarray(T), True, stride)
        outs_t = tgn.build_normal_equations(tm[lvl], tf_[lvl], _t(T), 20.0, 0.1, True, 1e-4, stride=stride)
        names = ("A", "b", "n", "r2", "n_icp")
        for name, a, b in zip(names, outs_j, outs_t):
            a = np.asarray(a)
            scale = max(np.abs(a).max(), 1e-12)
            assert np.abs(b.numpy() - a).max() <= 1e-4 * scale, (lvl, name)
        assert float(outs_t[2]) > 10  # constraints survive the gates


@pytest.mark.parametrize("case", list(CASES))
def test_dense_track_pose(case):
    key, kw = CASES[case]
    pm = _scene_pyramid(None)
    pf = pm if key is None else _scene_pyramid(tuple(map(tuple, key)))
    cfg_j = jtr.TrackerConfig(**kw)
    cfg_t = ttr.TrackerConfig(**kw)
    prev = _rotation([0.0, 0.01, 0.0], [0.05, 0.0, 0.0])
    curr_j, conv_j, _, _ = jtr.dense_track_pose(pm, pf, jnp.eye(4), jnp.asarray(prev), cfg_j)
    curr_t, conv_t, _, _ = ttr.dense_track_pose(_to_torch_pyramid(pm), _to_torch_pyramid(pf), torch.eye(4),
                                                _t(prev), cfg_t)
    _close(curr_j, curr_t, atol=1e-4)
    assert bool(conv_t) == bool(conv_j)
