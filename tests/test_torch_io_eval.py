"""Port parity of what a run leaves behind: the PLY map, the checkpoint and
the evaluation functions, against the JAX package's.

Tolerances: the PLY the two systems write for the same map is the same
bytes; each package's reader loads the other's file to equal arrays; a
checkpoint written by one package loads in the other with every field
bit-equal (same dtype, same bits). The evaluation functions, on numpy
inputs made from a seed, agree to 1e-6 relative (they are the same host
numpy and scipy code).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eggfusion_tpu import config as jcfg
from eggfusion_tpu.core import surfels as jsf
from eggfusion_tpu.io import checkpoint as j_ckpt
from eggfusion_tpu.io import ply as j_ply
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu.utils import eval as j_eval
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.convert import surfel_map_from_numpy, surfel_map_to_numpy
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.io import checkpoint as t_ckpt
from eggfusion_tpu_torch.io import ply as t_ply
from eggfusion_tpu_torch.system import EGGFusion as TEGGFusion
from eggfusion_tpu_torch.utils import eval as t_eval

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

CAP = 512
SH = 1  # features_rest holds 3 coefficients per channel


def _random_map(seed=0):
    """Every SoA field filled from a seed, about 70 % of the slots active."""
    rng = np.random.default_rng(seed)
    R = (SH + 1) ** 2 - 1
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda: rng.integers(0, 50, CAP).astype(np.int32)
    return {
        "xyz": f(3, CAP), "features_dc": f(3, 1, CAP), "features_rest": f(3, R, CAP),
        "scaling": f(3, CAP), "rotation": f(4, CAP), "opacity": f(1, CAP), "eta": f(6, CAP),
        "sigma2": np.abs(f(2, CAP)), "observe_count": i(), "tic": i(), "error_count": i(),
        "stable": rng.uniform(size=CAP) < 0.3, "active": rng.uniform(size=CAP) < 0.7,
        "count": np.asarray(CAP - 7, np.int32),
    }


def _cfg(lib, tmp):
    return lib.default_config(
        Dataset={"type": "synthetic", "Calibration": {"fx": 60.0, "fy": 60.0, "cx": 31.5, "cy": 23.5,
                                                      "width": 64, "height": 48, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": CAP},
        Surfel={"max_sh_degree": SH, "active_sh_degree": SH},
        System={"save_dir": str(tmp), "render_backend": "xla", "capacity_bucketing": False},
    )


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """A JAX and a port system holding the same random map."""
    tmp = tmp_path_factory.mktemp("io")
    m = _random_map()
    ef_j = JEGGFusion(_cfg(jcfg, tmp / "jax"))
    ef_j.mapper.surfels = jsf.SurfelMap(**{k: jnp.asarray(v) for k, v in m.items()})
    ef_t = TEGGFusion(_cfg(tcfg, tmp / "torch"), device="cpu")
    ef_t.mapper.surfels = surfel_map_from_numpy(m, "cpu")
    return m, ef_j, ef_t, tmp


def test_ply_same_bytes(systems):
    m, ef_j, ef_t, tmp = systems
    ef_j.save_ply(str(tmp / "j.ply"))
    ef_t.save_ply(str(tmp / "t.ply"))
    data = (tmp / "t.ply").read_bytes()
    assert data == (tmp / "j.ply").read_bytes()
    assert f"element vertex {int(m['active'].sum())}".encode() in data


def test_ply_cross_read(systems):
    """Each reader loads the other package's file; the port reloads the
    JAX file into its map."""
    m, ef_j, ef_t, tmp = systems
    ef_j.save_ply(str(tmp / "j2.ply"))
    ef_t.save_ply(str(tmp / "t2.ply"))
    a, b = t_ply.load_ply(str(tmp / "j2.ply")), j_ply.load_ply(str(tmp / "t2.ply"))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    act = m["active"]
    np.testing.assert_array_equal(a["features_rest"], m["features_rest"].T[act])
    ef = TEGGFusion(_cfg(tcfg, tmp / "reload"), device="cpu")
    ef.reload(str(tmp / "j2.ply"))
    n = int(act.sum())
    s = surfel_map_to_numpy(ef.mapper.surfels)
    assert int(s["count"]) == n and s["active"][:n].all() and not s["active"][n:].any()
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(s[f][..., :n], m[f][..., act], err_msg=f)


def _assert_same_fields(got: dict, want: dict):
    assert set(got) == set(want) == set(tsf.FIELDS)
    for k in tsf.FIELDS:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


EXTRA = {"traj_ref": np.eye(4, dtype=np.float32)[None].repeat(3, 0), "ts": np.arange(3) * 0.05,
         "time": np.int64(3)}


def test_checkpoint_jax_to_torch(systems):
    m, ef_j, _, tmp = systems
    path = str(tmp / "j.npz")
    j_ckpt.save_checkpoint(path, ef_j.mapper.surfels, extra=EXTRA)
    s, extra = t_ckpt.load_checkpoint(path, "cpu")
    _assert_same_fields(surfel_map_to_numpy(s), m)
    for k, v in EXTRA.items():
        np.testing.assert_array_equal(extra[k], v)
        assert extra[k].dtype == np.asarray(v).dtype


def test_checkpoint_torch_to_jax(systems):
    m, _, ef_t, tmp = systems
    path = str(tmp / "t.npz")
    t_ckpt.save_checkpoint(path, ef_t.mapper.surfels, extra=EXTRA)
    s, extra = j_ckpt.load_checkpoint(path)
    _assert_same_fields({f: np.asarray(getattr(s, f)) for f in tsf.FIELDS}, m)
    assert int(extra["time"]) == 3


def test_resume_other_capacity(systems, tmp_path):
    """A checkpoint of another capacity than the configured maximum (a rung
    of the capacity ladder) resumes at its own capacity, as in the JAX
    package, above the maximum too; its watermark is the consumed count."""
    m, ef_j, _, tmp = systems
    path = str(tmp / "j_cap.npz")
    j_ckpt.save_checkpoint(path, ef_j.mapper.surfels, extra=EXTRA)
    cfg = _cfg(tcfg, tmp_path)
    for max_surfels in (2 * CAP, int(m["count"]) - 1):
        cfg.Viewer.max_surfels_num = max_surfels
        ef = TEGGFusion(cfg, device="cpu")
        ef.resume(path)
        s = surfel_map_to_numpy(ef.mapper.surfels)
        assert s["active"].shape == (CAP,) and int(s["count"]) == int(m["count"]) and ef.mapper.time == 3
        assert (ef.mapper.ladder.known_count, ef.mapper.ladder.known_time) == (int(m["count"]), 2)
        _assert_same_fields(s, m)


# ---- evaluation functions ----------------------------------------------------


def _images(rng, h=96, w=128):
    ref = rng.uniform(size=(h, w, 3))
    est = np.clip(ref + rng.normal(scale=0.1, size=ref.shape), 0, 1)
    depth = rng.uniform(0.5, 3.0, (h, w, 1))
    depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    return est.astype(np.float32), ref.astype(np.float32), depth.astype(np.float32)


def _c2w(rng):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
    T[:3, 3] = rng.normal(size=3)
    return T


def _case(name, rng):
    """(args, kwargs) of one call of `name`."""
    est, ref, depth = _images(rng)
    if name == "matrix_to_tum":
        return (0.25, _c2w(rng)), {}
    if name == "psnr":
        return (est, ref, depth > 0), {}
    if name in ("ssim", "ms_ssim"):
        est, ref, _ = _images(rng, 192, 256)  # five MS-SSIM scales
        return (est, ref), {}
    if name == "depth_l1":
        return (depth + rng.normal(scale=0.01, size=depth.shape).astype(np.float32), depth), {}
    if name == "eval_render":
        return (ref, depth, est, depth * 1.01), {}
    if name == "unproject_depth":
        return (depth, np.asarray([60.0, 62.0, 63.5, 47.5]), _c2w(rng)), {"stride": 3}
    if name == "eval_recon":
        clouds = [rng.normal(size=(3000, 3)), rng.normal(size=(2500, 3))]
        return (rng.normal(size=(4000, 3)), clouds), {"thresh": 0.2, "max_points": 5000}
    raise KeyError(name)


def _close(a, b, name):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            _close(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (str, type(None))):
        assert a == b, name
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["matrix_to_tum", "psnr", "ssim", "ms_ssim", "depth_l1", "eval_render",
                                  "unproject_depth", "eval_recon"])
def test_eval_function(name):
    args, kw = _case(name, np.random.default_rng(7))
    got = getattr(t_eval, name)(*args, **kw)
    want = getattr(j_eval, name)(*args, **kw)
    _close(got, want, name)
    if name == "eval_render":
        assert got["lpips"] is None and "lpips_note" in got


def test_recon_subsamples_like_jax():
    """Above `max_points`, both packages draw the same subsample from the
    default generator (seed 0) and from a caller's."""
    rng = np.random.default_rng(3)
    m, clouds = rng.normal(size=(900, 3)), [rng.normal(size=(800, 3))]
    for r in (None, 5):
        kw = {"max_points": 300}
        got = t_eval.eval_recon(m, clouds, **kw, rng=None if r is None else np.random.default_rng(r))
        want = j_eval.eval_recon(m, clouds, **kw, rng=None if r is None else np.random.default_rng(r))
        assert got == want


# ---- the command line ----------------------------------------------------------


def _yaml_config(tmp_path, n_frames):
    """A complete configuration in one yaml file: 64x48, 3-4 frames, the
    all-pairs compositor, the default end of run (global optimization,
    render and recon evaluations) and a held-out view at frame 1."""
    import yaml

    cfg = tcfg.default_config(
        Dataset={"type": "synthetic", "n_frames": n_frames, "preload": True,
                 "Calibration": {"fx": 60.0, "fy": 60.0, "cx": 31.5, "cy": 23.5, "width": 64, "height": 48,
                                 "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 2048},
        Mapping={"local_map_iter_init": 3, "local_map_iter": 1, "final_global_opt_iter": 2},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        System={"root_dir": str(tmp_path / "results"), "render_backend": "xla", "heldout_stride": 3},
    )
    path = tmp_path / f"run{n_frames}.yaml"
    path.write_text(yaml.safe_dump(cfg.to_plain()))
    return str(path)


ARTIFACTS = ("final_surfels.ply", "checkpoint.npz", "trajectory_ref_tum.txt", "trajectory_est_tum.txt",
             "render_metrics.json", "recon_metrics.json")


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    from eggfusion_tpu_torch import main as t_main

    tmp = tmp_path_factory.mktemp("cli")
    return t_main.main(["--config", _yaml_config(tmp, 3), "--device", "cpu"]), tmp


def test_cli_run_writes_artifacts(cli_run):
    import json
    import os

    ef, _ = cli_run
    for name in ARTIFACTS:
        assert os.path.exists(os.path.join(ef.save_dir, name)), name
    assert os.path.exists(os.path.join(ef.save_dir, "config.yaml"))  # the workspace copy
    with open(os.path.join(ef.save_dir, "render_metrics.json")) as f:
        rep = json.load(f)
    assert [r["frame"] for r in rep["held_out"]["per_frame"]] == [1]
    assert ef.mapper.opt_steps_total > 0 and ef.run_finish_s > 0 and ef.run_eval_s > 0


def test_cli_resume(cli_run):
    """`--resume` continues the run from its checkpoint to the longer
    sequence's end."""
    import os

    from eggfusion_tpu_torch import main as t_main

    ef, tmp = cli_run
    ef2 = t_main.main(["--config", _yaml_config(tmp, 4), "--device", "cpu",
                       "--resume", os.path.join(ef.save_dir, "checkpoint.npz")])
    assert ef2.mapper.time == 4 and len(ef2.traj["est"]) == 4
    assert [m["frame"] for m in ef2.metrics if m["frame"] >= 0] == [3]
    ref, est = ef2._traj_np("ref"), ef2._traj_np("est")
    np.testing.assert_array_equal(est[:3], ef._traj_np("est"))
    assert t_eval.ate_rmse(ref[:, :3, 3], est[:, :3, 3]) < 1.0
