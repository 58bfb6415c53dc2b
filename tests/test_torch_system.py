"""The port's whole run against the JAX package on the same synthetic
sequence: `EGGFusion.reconstruct`, then `finish()` (the global keyframe
optimization, PLY, checkpoint) and the render and reconstruction
evaluations; a resume of the JAX run's checkpoint by the port; plus the
port's purity and device rules.

Both systems run 8 frames of the `tests/test_system_e2e.py` configuration
(120x90, 6144 surfels, SH 0, 4 global-opt steps per keyframe, a held-out
view every third frame) with the all-pairs "xla" compositor, tracking
recovery off (`recover_after 0`, a documented value) and a fixed-capacity
map. The port's mapper replays the JAX spawn draws, so both spawn from the
same uniforms; the run crosses frame 0's init burst and amortized
optimization steps. The JAX compositor runs with 8 surfels per scan step
instead of 32: the same blend, one surfel after another in depth order,
compiled in a fraction of the time. The port's system runs its programs
through the CPU plumbing of its compile layer (`EGGFusion(graphs=True)`:
static inputs, outputs owned by the program) in poison mode, after a full
`warmup()`: a consumer that kept an output of a program across its next
call would read NaN.

Tolerances of the end of the run: the finish steps and keyframes equal;
positions and rotations bit-unchanged by finish in both packages (their
final learning rates are 0); where the two maps hold the same surfel, the
change finish makes to any other field agrees within `test_opt_step`'s
contract composed over the n steps (2 lr per step everywhere; 1e-6 per step
except on at most 1 % of the values per step, the noise-level gradients
whose Adam step may flip); PSNR within 0.05 dB, SSIM within 2e-3, depth-L1 within 1e-3
relative, recon F1 within 0.01; the held-out frames equal. The resumed run
keeps the ATE under 1 cm.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import eggfusion_tpu.core.renderer as j_renderer
from eggfusion_tpu import config as jcfg
from eggfusion_tpu.data.datasets import load_dataset as j_load_dataset
from eggfusion_tpu.main import build_frame as j_build_frame
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.data.datasets import load_dataset as t_load_dataset
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.main import build_frame as t_build_frame
from eggfusion_tpu_torch.main import run as t_run
from eggfusion_tpu_torch.system import EGGFusion as TEGGFusion
from eggfusion_tpu_torch.utils import eval as t_eval

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8


def _cfg(lib, tmp, backend="xla", n_frames=N_FRAMES):
    return lib.default_config(
        Dataset={
            "type": "synthetic", "n_frames": n_frames, "preload": False,
            "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                            "width": 120, "height": 90, "depth_scale": 1.0},
        },
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 6, "local_map_iter": 2, "final_global_opt_iter": 4,
                 "sample_ratio": 0.05, "sample_ratio_init": 0.15},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0},
        System={"save_dir": str(tmp), "root_dir": str(tmp), "render_backend": backend,
                "capacity_bucketing": False, "final_global_opt": True, "heldout_stride": 3},
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


def _map_np(s):
    return {f: np.array(getattr(s, f)) for f in tsf.FIELDS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both systems after the frame loop, `finish()` and the evaluations;
    `before` holds each map and step count just before `finish()`."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
    cfg_j = _cfg(jcfg, tmp / "jax")
    before = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_renderer, "render_xla", functools.partial(j_render_xla, chunk=8))
        ef_j = JEGGFusion(cfg_j)
        dataset = j_load_dataset(cfg_j)
        for fid in range(N_FRAMES):
            ef_j.reconstruct(j_build_frame(dataset, fid, False))
        before["jax"] = (_map_np(ef_j.mapper.surfels), ef_j.mapper.opt_steps_total)
        ef_j.finish()
        ef_j.evaluate_render()
        ef_j.evaluate_recon()

    def on_stage(name, ef):
        if name == "loop":
            before["torch"] = (_map_np(ef.mapper.surfels), ef.mapper.opt_steps_total)

    real_init = TEGGFusion.__init__

    def plumbed(self, *args, **kwargs):
        real_init(self, *args, graphs=True, **kwargs)
        self.programs.poison = True

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TEGGFusion, "__init__", plumbed)
        mp.setattr(TEGGFusion, "warmup", functools.partialmethod(TEGGFusion.warmup, full=True))
        ef_t = t_run(_cfg(tcfg, tmp / "torch"), device="cpu", random_source=JaxDraws(), on_stage=on_stage)
    return ef_j, ef_t, before


def _pose_errors(c2w_a, c2w_b):
    t_err = np.linalg.norm(c2w_a[:, :3, 3] - c2w_b[:, :3, 3], axis=-1)
    rel = np.einsum("nij,nkj->nik", c2w_a[:, :3, :3], c2w_b[:, :3, :3])
    r_err = np.degrees(Rotation.from_matrix(rel).magnitude())
    return t_err, r_err


class TestSliceParity:
    def test_warmup_before_frame0(self, runs):
        """`main.run` warmed the port's system up before frame 0, as the JAX
        `main.run` does, through its program plumbing: the programs were
        made then and the frames replayed them (the trajectory the next test
        holds to the JAX one is this system's)."""
        _, ef_t, _ = runs
        assert ef_t.warmup_s is not None and ef_t.programs.mode == "plumb"
        stats = ef_t.programs.stats()
        for name in ("frame", "track", "preprocess", "map_update", "opt_step"):
            assert stats[name]["captures"] >= 1 and stats[name]["replays"] >= N_FRAMES - 1, (name, stats[name])

    def test_per_frame_poses(self, runs):
        ef_j, ef_t, _ = runs
        est_j, est_t = ef_j._traj_np("est"), ef_t._traj_np("est")
        assert est_t.shape == est_j.shape == (N_FRAMES, 4, 4)
        t_err, r_err = _pose_errors(est_j, est_t)
        # float32 pipelines with different reduction orders: 0.1 mm / 0.01 deg
        assert t_err.max() < 1e-4, t_err
        assert r_err.max() < 0.01, r_err

    def test_active_surfels(self, runs):
        ef_j, ef_t, _ = runs
        n_j = int(ef_j.mapper.surfels.num_active())
        n_t = int(ef_t.mapper.surfels.num_active())
        # spawn masks threshold rendered opacity/depth: a few border pixels
        # may flip between the two float32 compositors
        assert abs(n_t - n_j) <= 0.01 * n_j, (n_t, n_j)
        assert ef_t.mapper.opt_steps_total == ef_j.mapper.opt_steps_total

    def test_ate(self, runs):
        ef_j, ef_t, _ = runs
        ref = ef_j._traj_np("ref")[:, :3, 3]
        ate_j = t_eval.ate_rmse(ref, ef_j._traj_np("est")[:, :3, 3])
        ate_t = t_eval.ate_rmse(ref, ef_t._traj_np("est")[:, :3, 3])
        assert abs(ate_t - ate_j) < 1e-3, (ate_t, ate_j)  # cm


class TestFinishParity:
    def test_global_opt_steps(self, runs):
        ef_j, ef_t, before = runs
        ids = ef_t.mapper.keyframe_manager.ids()
        assert ids == ef_j.mapper.keyframe_manager.ids()
        steps_t = ef_t.mapper.opt_steps_total - before["torch"][1]
        steps_j = ef_j.mapper.opt_steps_total - before["jax"][1]
        assert steps_t == steps_j == ef_t.mapper.mcfg.final_global_opt_iter * len(ids) > 0

    def test_geometry_unchanged(self, runs):
        """`final_position_lr` and `final_rotation_lr` are 0: finish leaves
        positions and rotations bit for bit as they were."""
        ef_j, ef_t, before = runs
        after = {"jax": _map_np(ef_j.mapper.surfels), "torch": _map_np(ef_t.mapper.surfels)}
        for pkg in ("jax", "torch"):
            for f in ("xyz", "rotation"):
                np.testing.assert_array_equal(after[pkg][f], before[pkg][0][f], err_msg=f"{pkg} {f}")

    def test_optimized_fields(self, runs):
        ef_j, ef_t, before = runs
        n = ef_t.mapper.opt_steps_total - before["torch"][1]
        b_j, b_t = before["jax"][0], before["torch"][0]
        a_j, a_t = _map_np(ef_j.mapper.surfels), _map_np(ef_t.mapper.surfels)
        # slots that hold the same surfel in both maps
        same = b_j["active"] & b_t["active"] & np.all(np.abs(b_t["xyz"] - b_j["xyz"]) < 1e-5, axis=0)
        assert same.mean() > 0.9 * b_j["active"].mean()
        lrs = ef_t.mapper.global_lrs
        for f in ("features_dc", "scaling", "opacity"):
            d = np.abs((a_t[f] - b_t[f]) - (a_j[f] - b_j[f]))[..., same]
            assert d.max() <= 2 * lrs[f] * n + 1e-6, (f, d.max())
            assert np.mean(d <= 1e-6 * n) > 1 - 0.01 * n, (f, np.mean(d <= 1e-6 * n))
            moved = np.abs(a_t[f] - b_t[f])[..., same]
            assert moved.max() > 0, f  # the global optimization did move this field

    def test_render_metrics(self, runs):
        ef_j, ef_t, _ = runs
        rep = {}
        for pkg, ef in (("jax", ef_j), ("torch", ef_t)):
            with open(os.path.join(ef.save_dir, "render_metrics.json")) as f:
                rep[pkg] = json.load(f)
        mj, mt = rep["jax"]["mean"], rep["torch"]["mean"]
        assert abs(mt["psnr"] - mj["psnr"]) < 0.05, (mt, mj)
        assert abs(mt["ssim"] - mj["ssim"]) < 2e-3, (mt, mj)
        assert mt["depth_l1"] == pytest.approx(mj["depth_l1"], rel=1e-3)
        assert mt["lpips"] is None and mt["lpips_note"] == mj["lpips_note"]
        hj, ht = rep["jax"]["held_out"], rep["torch"]["held_out"]
        assert [r["frame"] for r in ht["per_frame"]] == [r["frame"] for r in hj["per_frame"]] == [1, 4, 7]
        assert abs(ht["mean"]["psnr"] - hj["mean"]["psnr"]) < 0.05, (ht["mean"], hj["mean"])

    def test_recon_metrics(self, runs):
        ef_j, ef_t, _ = runs
        rep = {}
        for pkg, ef in (("jax", ef_j), ("torch", ef_t)):
            with open(os.path.join(ef.save_dir, "recon_metrics.json")) as f:
                rep[pkg] = json.load(f)
        assert abs(rep["torch"]["recon_f1"] - rep["jax"]["recon_f1"]) < 0.01, rep
        assert rep["torch"]["recon_thresh_m"] == 0.01

    def test_artifacts(self, runs):
        """The port's run writes the artifacts of the JAX CLI run."""
        ef_j, ef_t, _ = runs
        for name in ("final_surfels.ply", "checkpoint.npz", "trajectory_ref_tum.txt",
                     "trajectory_est_tum.txt", "render_metrics.json", "recon_metrics.json"):
            assert os.path.exists(os.path.join(ef_t.save_dir, name)), name
        est = np.loadtxt(os.path.join(ef_t.save_dir, "trajectory_est_tum.txt"))
        assert est.shape == (N_FRAMES, 8)

    def test_resume_jax_checkpoint(self, runs, tmp_path):
        """The port resumes the JAX run from its `checkpoint.npz` and
        reconstructs two more frames of the sequence."""
        ef_j, _, _ = runs
        cfg = _cfg(tcfg, tmp_path, n_frames=N_FRAMES + 2)
        ef = TEGGFusion(cfg, device="cpu", random_source=JaxDraws())
        ef.resume(os.path.join(ef_j.save_dir, "checkpoint.npz"))
        assert ef.mapper.time == ef_j.mapper.time == N_FRAMES
        assert int(ef.mapper.surfels.num_active()) == int(ef_j.mapper.surfels.num_active())
        assert ef.model_map is not None and "pyramid" in ef.model_map
        dataset = t_load_dataset(cfg, "cpu")
        for fid in (N_FRAMES, N_FRAMES + 1):
            ef.reconstruct(t_build_frame(dataset, fid, False, "cpu"))
        ref, est = ef._traj_np("ref"), ef._traj_np("est")
        assert len(est) == N_FRAMES + 2
        assert t_eval.ate_rmse(ref[:, :3, 3], est[:, :3, 3]) < 1.0

    def test_reload_ply(self, runs, tmp_path):
        """The port reloads its PLY into a fresh system; above
        `Viewer.max_surfels_num` it keeps that many, the first, as the JAX
        package does."""
        _, ef_t, _ = runs
        path = os.path.join(ef_t.save_dir, "final_surfels.ply")
        ef = TEGGFusion(_cfg(tcfg, tmp_path), device="cpu")
        ef.reload(path)
        n = int(ef_t.mapper.surfels.num_active())
        assert int(ef.mapper.surfels.num_active()) == int(ef.mapper.surfels.count) == n
        act = ef_t.mapper.surfels.active
        for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
            assert torch.equal(getattr(ef.mapper.surfels, f)[..., :n], getattr(ef_t.mapper.surfels, f)[..., act])
        cfg = _cfg(tcfg, tmp_path)
        cfg.Viewer.max_surfels_num = n - 1
        ef = TEGGFusion(cfg, device="cpu")
        ef.reload(path)
        assert ef.mapper.surfels.capacity == int(ef.mapper.surfels.count) == n - 1
        assert torch.equal(ef.mapper.surfels.xyz, ef_t.mapper.surfels.xyz[..., act][..., :n - 1])


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
        "import eggfusion_tpu_torch.io.ply, eggfusion_tpu_torch.io.checkpoint, eggfusion_tpu_torch.utils.eval\n"
        "import eggfusion_tpu_torch.native.sparse, eggfusion_tpu_torch.core.reloc\n"
        "import eggfusion_tpu_torch.parallel.mesh\n"
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
