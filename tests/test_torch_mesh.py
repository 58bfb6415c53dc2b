"""The port's keyframe-parallel window optimization and pixel-sharded
tracking (`System.mesh_devices`, `eggfusion_tpu_torch/parallel/mesh.py`)
against the JAX package's mesh path, on the CPU.

The JAX step runs on the suite's virtual CPU mesh (`tests/conftest.py`), the
port's on 1 and 2 shards of the CPU device: the same split of the keyframe
batch and the same reduction. A fixed tiny map (200 surfels, 40x30 views,
the all-pairs compositor, the JAX one with 8 surfels per scan step) and a
3-keyframe window (B = 3 on one shard, 4 with one padding member on two:
a padding member's JAX image loss is exactly 0 and finite, so the port
leaves it out).

Tolerances: the window step's loss and the optimized fields after each of
2 Adam steps within 1e-5 relative (float32 sums in another order; Adam's
first steps move a field by about its learning rate, 1e-5 to 1e-3, so a
disagreement in a gradient's sign would show). The port on 1 and on 2
shards over 6 frames of the synthetic sequence at 80x60: trajectories within
`tests/test_parallel.py`'s atol 5e-4. Pixel-sharded `dense_track` against
the unsharded one: delta within 1e-5, the converged flag equal, the
constraint count within 1e-5 relative and the point-to-plane rms, a square
root of a float32 sum of squares taken in another order, within 1e-4.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggfusion_tpu.core import mapper as jmapper
from eggfusion_tpu.core import surfels as jsf
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu.parallel import mesh as jmesh
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.convert import surfel_map_from_numpy
from eggfusion_tpu_torch.core import mapper as tmapper
from eggfusion_tpu_torch.core import tracker as ttr
from eggfusion_tpu_torch.core.mapper import Mapping
from eggfusion_tpu_torch.core.renderer import Renderer
from eggfusion_tpu_torch.core.tracker import Tracker
from eggfusion_tpu_torch.main import run as t_run
from eggfusion_tpu_torch.ops.raster_xla import render_xla as t_render_xla
from eggfusion_tpu_torch.parallel import mesh as tmesh
from test_torch_tracking import _rotation, _scene_pyramid, _to_torch_pyramid

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 40, 30
INTR = np.asarray([36.0, 36.0, 19.5, 14.5], np.float32)
LRS = {"xyz": 1e-5, "features_dc": 1e-3, "features_rest": 5e-5, "opacity": 1e-5, "scaling": 5e-4,
       "rotation": 1e-4}
MCFG = dict(color_weight=1.0, depth_weight=1.0, normal_weight=1.0, reg_weight=10.0, reg_weight_n=1.0)


def _map_fields(n=200, cap=256, seed=0):
    rng = np.random.default_rng(seed)
    f = {
        "xyz": np.zeros((3, cap), np.float32), "features_dc": np.zeros((3, 1, cap), np.float32),
        "features_rest": np.zeros((3, 0, cap), np.float32), "scaling": np.full((3, cap), -30.0, np.float32),
        "rotation": np.zeros((4, cap), np.float32), "opacity": np.zeros((1, cap), np.float32),
        "eta": np.zeros((6, cap), np.float32), "sigma2": np.ones((2, cap), np.float32),
        "observe_count": np.zeros(cap, np.int32), "tic": np.zeros(cap, np.int32),
        "error_count": np.zeros(cap, np.int32), "stable": np.zeros(cap, bool),
        "active": np.arange(cap) < n, "count": np.asarray(n, np.int32),
    }
    f["xyz"][:, :n] = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.7, 0.7, n),
                                2.0 + 0.3 * rng.standard_normal(n)])
    f["features_dc"][:, 0, :n] = rng.uniform(-1, 1, (3, n))
    f["scaling"][:2, :n] = np.log(rng.uniform(0.1, 0.25, (2, n)))
    q = np.stack([np.ones(n), 0.2 * rng.standard_normal(n), 0.2 * rng.standard_normal(n), np.zeros(n)])
    f["rotation"][:, :n] = q / np.linalg.norm(q, axis=0)
    f["rotation"][0, n:] = 1.0
    f["opacity"][0, :n] = rng.uniform(0.5, 3.0, n)
    return f


def _keyframes(fields, seed=1):
    """Three keyframes: renders of a perturbed copy of the map from three
    poses, with noise."""
    rng = np.random.default_rng(seed)
    s = jsf.SurfelMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    s = s.replace(xyz=s.xyz + 0.02 * jnp.asarray(rng.standard_normal(s.xyz.shape), jnp.float32))
    kfs = []
    for i in range(3):
        w2c = _rotation([0.02 * i, -0.03 * i, 0.0], [0.05 * i, 0.0, 0.02 * i])
        out = j_render_xla(jsf.render_params(s), jnp.asarray(w2c), jnp.asarray(INTR), W, H, sh_degree=0, chunk=8)
        maps = {"color": np.clip(np.asarray(out["color"]) + 0.05 * rng.standard_normal((H, W, 3)), 0, 1),
                "depth": np.asarray(out["depth"]), "normal": np.asarray(out["normal"]),
                "rgb_mask": np.ones((H, W, 1), bool), "geo_mask": np.asarray(out["opacity"]) > 0.5}
        kfs.append(({k: v.astype(np.float32) if v.dtype != bool else v for k, v in maps.items()}, w2c))
    return kfs


def _jax_steps(fields, kfs, n_dev, pad, n_steps=2):
    mesh = jmesh.make_mesh(n_dev)
    render_at = lambda rp, w2c, intr, w, h, cap=None: j_render_xla(rp, w2c, intr, w, h, sh_degree=0, chunk=8)
    step = jmesh.make_window_opt_step(render_at, jmapper.MapperConfig(**MCFG), mesh)
    s = jsf.SurfelMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    maps = [m for m, _ in kfs] + [{k: np.zeros_like(v) for k, v in kfs[0][0].items()}] * pad
    kf_batch = {k: jnp.asarray(np.stack([m[k] for m in maps])) for k in maps[0]}
    w2c = jnp.asarray(np.stack([w for _, w in kfs] + [np.eye(4, dtype=np.float32)] * pad))
    valid = jnp.asarray([1.0] * len(kfs) + [0.0] * pad, jnp.float32)
    moments = jmapper._adam_init({k: getattr(s, k) for k in jmapper.OPT_FIELDS})
    geo = jmapper._geo_snapshot(s)
    lrs = {k: jnp.float32(v) for k, v in LRS.items()}
    count, out = jnp.int32(0), []
    for _ in range(n_steps):
        s, moments, count, loss = step(s, moments, count, kf_batch, w2c, valid, jnp.asarray(INTR), geo, lrs, W, H)
        out.append((float(loss), {k: np.array(getattr(s, k)) for k in jmapper.OPT_FIELDS}))
    return out


def _torch_steps(fields, kfs, n_dev, n_steps=2):
    devices = tmesh.make_mesh(n_dev, "cpu")
    render_at = lambda rp, w2c, intr, w, h, cap=None: t_render_xla(rp, w2c, intr, w, h, sh_degree=0)
    step = tmesh.make_window_opt_step(render_at, tmapper.MapperConfig(**MCFG), devices)
    s = surfel_map_from_numpy(fields)
    members = [SimpleNamespace(device_maps=lambda m=m: {k: torch.from_numpy(v) for k, v in m.items()},
                               w2c=torch.from_numpy(w), intr=torch.from_numpy(INTR)) for m, w in kfs]
    B = -(-max(3, n_dev) // n_dev) * n_dev
    batch = tmesh.window_batch(members, B, devices)
    moments = tmapper._adam_init({k: getattr(s, k) for k in tmapper.OPT_FIELDS})
    geo = tmapper._geo_snapshot(s)
    count, out = torch.zeros((), dtype=torch.int32), []
    for _ in range(n_steps):
        s, moments, count, loss = step(s, moments, count, batch, geo, LRS, W, H)
        out.append((float(loss), {k: getattr(s, k).numpy().copy() for k in tmapper.OPT_FIELDS}))
    return out, batch


@pytest.fixture(scope="module")
def window():
    fields = _map_fields()
    return fields, _keyframes(fields)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_window_step_matches_jax(window, n_dev):
    fields, kfs = window
    pad = (-len(kfs)) % n_dev
    ref = _jax_steps(fields, kfs, n_dev, pad)
    got, batch = _torch_steps(fields, kfs, n_dev)
    assert [len(m) for m in batch.shards] == ([3] if n_dev == 1 else [2, 1]) and batch.n_valid == 3
    for (loss_j, f_j), (loss_t, f_t) in zip(ref, got):
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
        for k in tmapper.OPT_FIELDS:
            np.testing.assert_allclose(f_t[k], f_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
    moved = np.abs(got[-1][1]["features_dc"] - fields["features_dc"]).max()
    assert moved > 1e-4  # the steps did optimize


def test_padding_member_adds_nothing(window):
    """A JAX padding member (zero maps, identity pose, v = 0) has a finite
    image loss, exactly 0: the port may leave it unrendered."""
    fields, kfs = window
    s = jsf.SurfelMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    out = j_render_xla(jsf.render_params(s), jnp.eye(4), jnp.asarray(INTR), W, H, sh_degree=0, chunk=8)
    zeros = {k: jnp.zeros_like(jnp.asarray(v)) for k, v in kfs[0][0].items()}
    loss = jmapper.compute_image_loss(out, zeros, jmapper.MapperConfig(**MCFG))
    assert np.isfinite(float(loss)) and float(loss) == 0.0


def _seq_cfg(tmp, mesh_devices):
    return tcfg.default_config(
        Dataset={"type": "synthetic", "n_frames": 6, "preload": False,
                 "Calibration": {"fx": 72.0, "fy": 72.0, "cx": 39.5, "cy": 29.5,
                                 "width": 80, "height": 60, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 2, "local_map_iter": 2, "sample_ratio": 0.03, "sample_ratio_init": 0.08},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0},
        System={"save_dir": str(tmp / f"mesh{mesh_devices}"), "mesh_devices": mesh_devices, "render_backend": "xla",
                "capacity_bucketing": False, "final_global_opt": False, "eval_tracking": False,
                "eval_render": False, "eval_recon": False},
    )


def test_mesh_sizes_agree(tmp_path):
    """The same window-batched run on one shard and on two (pixel-sharded
    tracking included) gives the same trajectory."""
    runs = [t_run(_seq_cfg(tmp_path, n), device="cpu") for n in (1, 2)]
    for ef in runs:
        assert ef.mapper.devices is not None and ef.mapper.opt_steps_total > 0
    assert runs[1].tracker.devices == [torch.device("cpu")] * 2
    np.testing.assert_allclose(runs[1]._traj_np("est"), runs[0]._traj_np("est"), atol=5e-4)
    assert runs[0].mapper.opt_steps_total == runs[1].mapper.opt_steps_total


@pytest.mark.parametrize("n_shards", [2, 3])
def test_pixel_sharded_dense_track(n_shards):
    pm = _scene_pyramid(None)
    pf = _scene_pyramid(((0.0, 0.02, 0.0), (0.02, 0.0, 0.01)))
    pm_t, pf_t = _to_torch_pyramid(pm), _to_torch_pyramid(pf)
    cfg = ttr.TrackerConfig(solver_stride=2, solver_stride_fine=3)
    whole = ttr.dense_track(pm_t, pf_t, torch.eye(4), cfg)
    sharded = ttr.dense_track(pm_t, pf_t, torch.eye(4), cfg, devices=[torch.device("cpu")] * n_shards)
    np.testing.assert_allclose(sharded[0].numpy(), whole[0].numpy(), atol=1e-5)
    assert bool(sharded[1]) == bool(whole[1])
    assert float(sharded[2]) == pytest.approx(float(whole[2]), rel=1e-4)
    assert float(sharded[3]) == pytest.approx(float(whole[3]), rel=1e-5)


def test_shards_cover_the_grid():
    """The row shards of a strided grid hold every constraint once."""
    from eggfusion_tpu_torch.ops import reduce as tgn

    pm = _to_torch_pyramid(_scene_pyramid(None))
    grids = [g for g, _ in ttr._level_shards(pm[0], pm[0], 3, [torch.device("cpu")] * 3)]
    whole = tgn.constraint_grid(pm[0], pm[0], 3)
    assert [g.row0 for g in grids] == [0, 6, 13] and all(g.full_hw == whole.full_hw for g in grids)
    for f in ("disp", "vertex", "frame_mask", "frame_gradmag"):
        assert torch.equal(torch.cat([getattr(g, f) for g in grids]), getattr(whole, f))


def test_mesh_needs_gpus():
    """Asking for more GPUs than are visible raises; it never shrinks."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="GPUs are visible"):
        tmesh.make_mesh(n, "cuda")
    cfg = tcfg.default_config(System={"mesh_devices": n})
    with pytest.raises(ValueError, match="GPUs are visible"):
        Tracker(cfg, "cuda")
    with pytest.raises(ValueError, match="GPUs are visible"):
        Mapping(cfg, Renderer(cfg, "cpu", backend="xla"), "cuda")
    assert tmesh.make_mesh(2, "cpu") == [torch.device("cpu")] * 2
