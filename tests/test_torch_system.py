"""The port's slice as a whole: `EGGFusion.reconstruct` of the PyTorch port
against the JAX package on the same synthetic sequence, plus the port's
purity and device rules.

Both systems run 8 frames of the `tests/test_system_e2e.py` configuration
(120x90, 6144 surfels, SH 0) with the all-pairs "xla" compositor, tracking
recovery off (`recover_after 0`, a documented value) and a fixed-capacity
map. The port's mapper replays the JAX spawn draws, so both spawn from the
same uniforms; the run crosses frame 0's init burst and amortized
optimization steps.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from eggfusion_tpu import config as jcfg
from eggfusion_tpu.data.datasets import load_dataset as j_load_dataset
from eggfusion_tpu.main import build_frame as j_build_frame
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.main import run as t_run
from eggfusion_tpu_torch.system import EGGFusion as TEGGFusion
from eggfusion_tpu_torch.utils import eval as t_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8


def _cfg(lib, tmp, backend="xla"):
    return lib.default_config(
        Dataset={
            "type": "synthetic", "n_frames": N_FRAMES, "preload": False,
            "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                            "width": 120, "height": 90, "depth_scale": 1.0},
        },
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 6, "local_map_iter": 2, "final_global_opt_iter": 4,
                 "sample_ratio": 0.05, "sample_ratio_init": 0.15},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0},
        System={"save_dir": str(tmp), "root_dir": str(tmp), "render_backend": backend,
                "capacity_bucketing": False, "final_global_opt": False},
    )


class JaxDraws:
    """The JAX mapper's random draws, replayed into the port: spawn
    uniforms are `uniform(fold_in(PRNGKey(seed), time), (H, W))`, tile
    draws `uniform(fold_in(PRNGKey(0x7115), step), (n,))`."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)
        self.tile_key = jax.random.PRNGKey(0x7115)

    def spawn(self, time, height, width):
        u = jax.random.uniform(jax.random.fold_in(self.key, time), (height, width))
        return torch.from_numpy(np.array(u))

    def tiles(self, step, n_tiles):
        return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(self.tile_key, step), (n_tiles,))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    cfg_j = _cfg(jcfg, tmp / "jax")
    ef_j = JEGGFusion(cfg_j)
    dataset = j_load_dataset(cfg_j)
    for fid in range(N_FRAMES):
        ef_j.reconstruct(j_build_frame(dataset, fid, False))
    ef_t = t_run(_cfg(tcfg, tmp / "torch"), device="cpu", random_source=JaxDraws())
    return ef_j, ef_t


def _pose_errors(c2w_a, c2w_b):
    t_err = np.linalg.norm(c2w_a[:, :3, 3] - c2w_b[:, :3, 3], axis=-1)
    rel = np.einsum("nij,nkj->nik", c2w_a[:, :3, :3], c2w_b[:, :3, :3])
    r_err = np.degrees(Rotation.from_matrix(rel).magnitude())
    return t_err, r_err


class TestSliceParity:
    def test_per_frame_poses(self, runs):
        ef_j, ef_t = runs
        est_j, est_t = ef_j._traj_np("est"), ef_t._traj_np("est")
        assert est_t.shape == est_j.shape == (N_FRAMES, 4, 4)
        t_err, r_err = _pose_errors(est_j, est_t)
        # float32 pipelines with different reduction orders: 0.1 mm / 0.01 deg
        assert t_err.max() < 1e-4, t_err
        assert r_err.max() < 0.01, r_err

    def test_active_surfels(self, runs):
        ef_j, ef_t = runs
        n_j = int(ef_j.mapper.surfels.num_active())
        n_t = int(ef_t.mapper.surfels.num_active())
        # spawn masks threshold rendered opacity/depth: a few border pixels
        # may flip between the two float32 compositors
        assert abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
        assert ef_t.mapper.opt_steps_total == ef_j.mapper.opt_steps_total

    def test_ate(self, runs):
        ef_j, ef_t = runs
        ref = ef_j._traj_np("ref")[:, :3, 3]
        ate_j = t_eval.ate_rmse(ref, ef_j._traj_np("est")[:, :3, 3])
        ate_t = t_eval.ate_rmse(ref, ef_t._traj_np("est")[:, :3, 3])
        assert abs(ate_t - ate_j) < 1e-3, (ate_t, ate_j)  # cm


def test_tile_backend_alone(tmp_path):
    """The port on its tile compositor (plain kernels on the CPU) keeps the
    bounds `tests/test_system_e2e.py` holds the JAX system to."""
    ef = t_run(_cfg(tcfg, tmp_path, backend="pallas"), device="cpu")
    assert ef.renderer.backend == "pallas"
    ref = ef._traj_np("ref")[:, :3, 3]
    est = ef._traj_np("est")[:, :3, 3]
    assert t_eval.ate_rmse(ref, est) < 1.0
    n = int(ef.mapper.surfels.num_active())
    assert 100 < n <= 6144
    assert ef.mapper.opt_steps_total > 0


def test_entry_point_requires_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEGGFusion(_cfg(tcfg, tmp_path))


def test_package_imports_without_jax():
    """Importing the port (in a fresh process: this one has JAX loaded)
    loads no JAX and nothing of the JAX package."""
    code = (
        "import sys\n"
        "import eggfusion_tpu_torch, eggfusion_tpu_torch.system, eggfusion_tpu_torch.main\n"
        "import eggfusion_tpu_torch.ops.raster_tile, eggfusion_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'eggfusion_tpu.'))"
        " or m == 'eggfusion_tpu']\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_sources_name_no_jax():
    """No source of the port (nor chip_smoke.py) imports JAX or the JAX
    package."""
    import re

    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+eggfusion_tpu\b(?!_torch)"
                     r"|from\s+eggfusion_tpu(\.|\s)(?!_torch))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "eggfusion_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders


def test_synthetic_sequence():
    """The port's synthetic scene and trajectory match the JAX module's."""
    from eggfusion_tpu.data import synthetic as jsyn
    from eggfusion_tpu_torch.data import synthetic as tsyn

    seq_j, seq_t = jsyn.make_sequence(12, 64, 48), tsyn.make_sequence(12, 64, 48)
    np.testing.assert_array_equal(seq_t.poses_w2c, seq_j.poses_w2c)
    assert tuple(seq_t.intr) == tuple(seq_j.intr)
    for i in (0, 11):
        cj, dj = jsyn.render_corner_scene(seq_j.intr, seq_j.poses_w2c[i])
        ct, dt = tsyn.render_corner_scene(seq_t.intr, seq_t.poses_w2c[i])
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
