"""Port parity: `eggfusion_tpu_torch.geometry` against `eggfusion_tpu.geometry`
on the cases of `tests/test_geometry.py`, same float32 inputs drawn with
numpy. Tolerance 1e-6 absolute (1e-5 where a trigonometric or inverse
chain amplifies float32 rounding): both sides are float32 elementwise math
with the same formulas, differing only in libm rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggfusion_tpu.geometry import camera as jcam
from eggfusion_tpu.geometry import lie as jlie
from eggfusion_tpu.geometry import sh as jsh
from eggfusion_tpu.geometry import transforms as jtf
from eggfusion_tpu_torch.geometry import camera as tcam
from eggfusion_tpu_torch.geometry import lie as tlie
from eggfusion_tpu_torch.geometry import sh as tsh
from eggfusion_tpu_torch.geometry import transforms as ttf

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

RNG = np.random.default_rng(0)
ROTVECS = [np.zeros(3), [1e-7, 0, 0], [0.3, -0.2, 0.1], [0.0, 2.5, 0.4], [1.0, 1.0, -1.0]]


def _close(j, t, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t),
                               np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("w", ROTVECS)
def test_so3_exp_log(w):
    w = np.asarray(w, np.float32)
    Rj = jlie.so3_to_SO3(jnp.asarray(w))
    Rt = tlie.so3_to_SO3(torch.from_numpy(w))
    _close(Rj, Rt)
    _close(jlie.SO3_to_so3(Rj), tlie.SO3_to_so3(torch.from_numpy(np.array(Rj))), atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_se3_roundtrip_and_invert(seed):
    tau = np.random.default_rng(seed).normal(scale=0.3, size=6).astype(np.float32)
    Tj = jlie.se3_to_SE3(jnp.asarray(tau))
    Tt = tlie.se3_to_SE3(torch.from_numpy(tau))
    _close(Tj, Tt)
    _close(jlie.SE3_to_se3(Tj), tlie.SE3_to_se3(Tt), atol=1e-5)
    _close(jlie.invert_se3(Tj), tlie.invert_se3(Tt), atol=1e-6)
    dx = np.random.default_rng(seed + 7).normal(scale=0.05, size=6).astype(np.float32)
    _close(jlie.update_transform(Tj, jnp.asarray(dx)), tlie.update_transform(Tt, torch.from_numpy(dx)))


def test_camera_intrinsics():
    j = jcam.CameraIntrinsics(300.0, 310.0, 159.5, 119.5, 320, 240)
    t = tcam.CameraIntrinsics(300.0, 310.0, 159.5, 119.5, 320, 240)
    assert (t.fovx, t.fovy) == (j.fovx, j.fovy)
    assert tuple(t.scaled(4)) == tuple(j.scaled(4))
    _close(j.as_array(), t.as_tensor())
    assert tcam.fov2focal(t.fovx, 320) == pytest.approx(jcam.fov2focal(j.fovx, 320))


def test_quaternion_rotations():
    q = RNG.normal(size=(4, 32)).astype(np.float32)
    _close(jtf.build_rotation_t(jnp.asarray(q)), ttf.build_rotation_t(torch.from_numpy(q)))
    _close(jtf.normal_from_quat_t(jnp.asarray(q)), ttf.normal_from_quat_t(torch.from_numpy(q)))
    _close(jtf.build_rotation(jnp.asarray(q.T)), ttf.build_rotation(torch.from_numpy(q.T.copy())))
    n = RNG.normal(size=(3, 32)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    _close(jtf.rot_z_to_t(jnp.asarray(n)), ttf.rot_z_to_t(torch.from_numpy(n)), atol=1e-5)
    x = RNG.uniform(0.05, 0.95, 16).astype(np.float32)
    _close(jtf.inverse_sigmoid(jnp.asarray(x)), ttf.inverse_sigmoid(torch.from_numpy(x)), atol=1e-5)


def test_map_transforms():
    pts = RNG.normal(size=(6, 5, 3)).astype(np.float32)
    T = np.array(jlie.se3_to_SE3(jnp.asarray([0.1, -0.2, 0.3, 0.5, 0.0, -0.4], jnp.float32)))
    R, t = T[:3, :3], T[:3, 3]
    _close(jtf.transform_map(jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t)),
           ttf.transform_map(torch.from_numpy(pts), torch.from_numpy(R), torch.from_numpy(t)))
    intr = np.asarray([5.0, 5.0, 2.0, 2.5], np.float32)
    _close(jtf.compute_incident_angle(jnp.asarray(pts), jnp.asarray(intr)),
           ttf.compute_incident_angle(torch.from_numpy(pts), torch.from_numpy(intr)))
    coords = RNG.uniform(0, 10, (6, 5, 2)).astype(np.float32)
    _close(jtf.compute_confidence(jnp.asarray(coords), jnp.asarray(intr[2:]), 400.0, 0.72),
           ttf.compute_confidence(torch.from_numpy(coords), torch.from_numpy(intr[2:]), 400.0, 0.72))


@pytest.mark.parametrize("deg", range(5))
def test_eval_sh(deg):
    shc = RNG.normal(size=(3, (deg + 1) ** 2, 40)).astype(np.float32)
    d = RNG.normal(size=(3, 40)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    _close(jsh.eval_sh_t(deg, jnp.asarray(shc), jnp.asarray(d)),
           tsh.eval_sh_t(deg, torch.from_numpy(shc), torch.from_numpy(d)), atol=1e-5)


def test_rgb_sh_roundtrip():
    rgb = RNG.uniform(size=(3, 10)).astype(np.float32)
    _close(jsh.rgb_to_sh(jnp.asarray(rgb)), tsh.rgb_to_sh(torch.from_numpy(rgb)))
    _close(jsh.sh_to_rgb(jnp.asarray(rgb)), tsh.sh_to_rgb(torch.from_numpy(rgb)))
