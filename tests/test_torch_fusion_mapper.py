"""Port parity of fusion and the mapper: `fuse_frame`, the mapping loss,
Adam, and one `map_update` and one `opt_step` of `Mapping` started from the
same surfel map (moved across with `convert.py`) and the same keyframe, on
the configuration of `tests/test_system_e2e.py` (120x90, 6144 surfels,
SH 0) with the all-pairs "xla" compositor. The port replays the JAX spawn
uniforms. The JAX compositor runs with 8 surfels per scan step instead of
32: the same blend, one surfel after another in depth order, compiled in a
fraction of the time.

Tolerances: fused surfel fields 1e-5 (float32 information-filter updates);
losses 1e-5 relative; after one Adam step, parameters within 1e-6 except
where a gradient is at float32 noise level, whose step direction may flip:
those are bounded by twice the learning rate and must be rare.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggfusion_tpu import config as jcfg
import eggfusion_tpu.core.renderer as j_renderer
from eggfusion_tpu.core import mapper as jmapper
from eggfusion_tpu.core.renderer import Renderer as JRenderer
from eggfusion_tpu.data.datasets import load_dataset as j_load_dataset
from eggfusion_tpu.main import build_frame as j_build_frame
from eggfusion_tpu.ops import fusion as jfusion
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu.system import preprocess_frame_map as j_preprocess
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.convert import surfel_map_from_numpy, surfel_map_to_numpy
from eggfusion_tpu_torch.core import mapper as tmapper
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.core.renderer import Renderer as TRenderer
from eggfusion_tpu_torch.ops import fusion as tfusion

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 120, 90


def _cfg(lib):
    return lib.default_config(
        Dataset={"type": "synthetic", "n_frames": 4, "preload": False,
                 "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                                 "width": W, "height": H, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 6, "local_map_iter": 2, "sample_ratio": 0.05,
                 "sample_ratio_init": 0.15},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0},
        System={"render_backend": "xla", "capacity_bucketing": False},
    )


class JaxDraws:
    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def spawn(self, time, height, width):
        return torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(self.key, time), (height, width))))

    def tiles(self, step, n_tiles):  # unused by the all-pairs backend
        raise AssertionError("no tile draws on the xla backend")


def _t(x):
    return torch.from_numpy(np.array(x))


def _map_np(s):
    return {f: np.array(getattr(s, f)) for f in tsf.FIELDS}


def _frame_map(dataset, fid):
    f = j_build_frame(dataset, fid, False)
    f.update_transform_gt()
    p0 = f.pyramid[0]
    fm = j_preprocess(f.color, f.depth, p0.vertex, p0.normal, f.mask, f.intr, f.w2c_matrix(), 5.0)
    return f, fm


def _fm_torch(fm):
    return {k: _t(v) for k, v in fm.items()}


@pytest.fixture(scope="module")
def setup():
    """A JAX map after frame 0's spawn, frame 1's frame_map, and both mappers;
    the JAX renders of the module's tests composite 8 surfels per step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_renderer, "render_xla", functools.partial(j_render_xla, chunk=8))
        cfg_j, cfg_t = _cfg(jcfg), _cfg(tcfg)
        jm = jmapper.Mapping(cfg_j, JRenderer(cfg_j))
        tm = tmapper.Mapping(cfg_t, TRenderer(cfg_t, "cpu"), "cpu", random_source=JaxDraws())
        dataset = j_load_dataset(cfg_j)
        f0, fm0 = _frame_map(dataset, 0)
        s0, _, _ = jm._map_update(jm.surfels, fm0, f0.w2c_matrix(), f0.intr, jnp.int32(0), jm._rng, W, H, True,
                                  True, model_cap=jm.model_cap, conv=jnp.bool_(True), down=1, do_render=True)
        f1, fm1 = _frame_map(dataset, 1)
        yield jm, tm, _map_np(s0), (f0, fm0), (f1, fm1)


def test_fuse_frame(setup):
    jm, tm, s_np, _, (f1, fm1) = setup
    sj, stats_j = jfusion.fuse_frame(jm.surfels.replace(**{k: jnp.asarray(v) for k, v in s_np.items()}),
                                     f1.w2c_matrix(), f1.intr, fm1["vertex_map_w"], fm1["normal_map_w"],
                                     fm1["color_map"], fm1["depth_map"], fm1["geo_mask"], 0.03, jm.scfg)
    st, stats_t = tfusion.fuse_frame(surfel_map_from_numpy(s_np, "cpu"), _t(f1.w2c_matrix()), _t(f1.intr),
                                     _t(fm1["vertex_map_w"]), _t(fm1["normal_map_w"]), _t(fm1["color_map"]),
                                     _t(fm1["depth_map"]), _t(fm1["geo_mask"]), 0.03, tm.scfg)
    assert int(stats_t.fused_pixels) == int(stats_j.fused_pixels) > 100
    assert int(stats_t.error_pixels) == int(stats_j.error_pixels)
    a, b = _map_np(sj), surfel_map_to_numpy(st)
    for f in tsf.FIELDS:
        if a[f].dtype.kind in "biu":
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        else:
            np.testing.assert_allclose(b[f], a[f], atol=1e-5, rtol=1e-5, err_msg=f)


def test_map_update(setup):
    jm, tm, s_np, _, (f1, fm1) = setup
    sj, mm_j, stats_j = jm._map_update(jm.surfels.replace(**{k: jnp.asarray(v) for k, v in s_np.items()}),
                                       fm1, f1.w2c_matrix(), f1.intr, jnp.int32(1), jm._rng, W, H, False, True,
                                       model_cap=jm.model_cap, conv=jnp.bool_(True), down=1, do_render=True)
    with torch.no_grad():
        st, mm_t, stats_t = tm.map_update(surfel_map_from_numpy(s_np, "cpu"), _fm_torch(fm1),
                                          _t(f1.w2c_matrix()), _t(f1.intr), 1, W, H, False, True)
    np.testing.assert_array_equal(stats_t.numpy()[:2], np.asarray(stats_j)[:2])
    a, b = _map_np(sj), surfel_map_to_numpy(st)
    # spawns threshold the rendered opacity/depth: allow a handful of flips
    assert abs(int(b["count"]) - int(a["count"])) <= 2, (b["count"], a["count"])
    n = min(int(a["count"]), int(b["count"]))
    same = np.all(np.isclose(b["xyz"][:, :n], a["xyz"][:, :n], atol=1e-5), axis=0)
    assert same.mean() > 0.995
    for k in ("rendered_color", "rendered_depth"):
        diff = np.abs(mm_t[k].numpy() - np.asarray(mm_j[k]))
        assert np.mean(diff < 1e-4) > 0.999, k
    np.testing.assert_allclose(mm_t["pyramid"][0].intensity.numpy(),
                               np.asarray(mm_j["pyramid"][0].intensity), atol=1e-3)


def test_loss_and_adam():
    rng = np.random.default_rng(3)
    shape = (H, W)
    out = {"color": rng.uniform(size=shape + (3,)), "depth": rng.uniform(1, 2, shape + (1,)),
           "normal": rng.normal(size=shape + (3,))}
    kf = {"color": rng.uniform(size=shape + (3,)), "depth": rng.uniform(1, 2, shape + (1,)),
          "normal": rng.normal(size=shape + (3,)), "rgb_mask": rng.uniform(size=shape + (1,)) > 0.1,
          "geo_mask": rng.uniform(size=shape + (1,)) > 0.2}
    f32 = lambda d: {k: v.astype(np.float32) if v.dtype.kind == "f" else v for k, v in d.items()}
    out, kf = f32(out), f32(kf)
    pix = rng.uniform(size=shape) > 0.5
    mcfg_j, mcfg_t = jmapper.MapperConfig(), tmapper.MapperConfig()
    lj = jmapper.compute_image_loss({k: jnp.asarray(v) for k, v in out.items()},
                                    {k: jnp.asarray(v) for k, v in kf.items()}, mcfg_j, jnp.asarray(pix))
    lt = tmapper.compute_image_loss({k: _t(v) for k, v in out.items()}, {k: _t(v) for k, v in kf.items()},
                                    mcfg_t, _t(pix))
    assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    params = {"a": rng.normal(size=(3, 50)).astype(np.float32), "b": rng.normal(size=(1, 50)).astype(np.float32)}
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    moms = {k: (rng.normal(size=v.shape).astype(np.float32) * 0.1, rng.uniform(size=v.shape).astype(np.float32) * 0.1)
            for k, v in params.items()}
    lrs = {"a": 1e-3, "b": 1e-2}
    pj, mj = jmapper._adam_update({k: jnp.asarray(v) for k, v in params.items()},
                                  {k: jnp.asarray(v) for k, v in grads.items()},
                                  {k: tuple(map(jnp.asarray, v)) for k, v in moms.items()}, jnp.int32(4),
                                  {k: jnp.float32(v) for k, v in lrs.items()})
    pt, mt = tmapper._adam_update({k: _t(v) for k, v in params.items()}, {k: _t(v) for k, v in grads.items()},
                                  {k: tuple(map(_t, v)) for k, v in moms.items()}, torch.tensor(4), lrs)
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-6)
        for a, b in zip(mj[k], mt[k]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_opt_step(setup):
    jm, tm, s_np, (f0, fm0), _ = setup
    kfm_j = {"color": fm0["color_map"], "depth": fm0["depth_map"], "normal": fm0["normal_map_c"],
             "rgb_mask": fm0["rgb_mask"], "geo_mask": fm0["geo_mask"]}
    sj = jm.surfels.replace(**{k: jnp.asarray(v) for k, v in s_np.items()})
    params = {k: getattr(sj, k) for k in jmapper.OPT_FIELDS}
    geo = jmapper._geo_snapshot(sj)
    sj, _, _, loss_j = jm._opt_step(sj, jmapper._adam_init(params), jnp.int32(0), kfm_j, f0.w2c_matrix(),
                                    f0.intr, geo, jm._lrs_dev(jm.sw_lrs), W, H, None, jm._tile_rng)
    a = _map_np(sj)

    st = surfel_map_from_numpy(s_np, "cpu")
    moments = tmapper._adam_init({k: getattr(st, k) for k in tmapper.OPT_FIELDS})
    kfm_t = {k: _t(v) for k, v in kfm_j.items()}
    st, _, step, loss_t = tm.opt_step(st, moments, torch.zeros((), dtype=torch.int32), kfm_t,
                                      _t(f0.w2c_matrix()), _t(f0.intr), tmapper._geo_snapshot(st),
                                      tm.sw_lrs, W, H, None)
    assert int(step) == 1
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    b = surfel_map_to_numpy(st)
    lrs = {"xyz": tm.sw_lrs["xyz"], "features_dc": tm.sw_lrs["features_dc"], "scaling": tm.sw_lrs["scaling"],
           "rotation": tm.sw_lrs["rotation"], "opacity": tm.sw_lrs["opacity"]}
    for k, lr in lrs.items():
        d = np.abs(b[k] - a[k])
        assert d.max() <= 2 * lr + 1e-6, (k, d.max())
        assert np.mean(d <= 1e-6) > 0.99, (k, np.mean(d <= 1e-6))


def test_index_map_fusion(setup):
    """The z-buffer index map and fusion against it (the exact-association
    path) match the JAX functions."""
    jm, tm, s_np, _, (f1, fm1) = setup
    sj = jm.surfels.replace(**{k: jnp.asarray(v) for k, v in s_np.items()})
    st = surfel_map_from_numpy(s_np, "cpu")
    imap_j, dep_j = jfusion.project_surfels_to_frame(sj.xyz, sj.active, f1.w2c_matrix(), f1.intr, W, H)
    imap_t, dep_t = tfusion.project_surfels_to_frame(st.xyz, st.active, _t(f1.w2c_matrix()), _t(f1.intr), W, H)
    np.testing.assert_array_equal(imap_t.numpy(), np.asarray(imap_j))
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j), atol=1e-6)
    assert (imap_t >= 0).sum() > 100
    args_j = (f1.w2c_matrix(), f1.intr, fm1["vertex_map_w"], fm1["normal_map_w"], fm1["color_map"],
              fm1["depth_map"], fm1["geo_mask"], 0.03, jm.scfg)
    sj2, stats_j = jfusion.fuse_surfels(sj, imap_j, *args_j)
    st2, stats_t = tfusion.fuse_surfels(st, imap_t, *[_t(a) for a in args_j[:7]], 0.03, tm.scfg)
    assert int(stats_t.fused_pixels) == int(stats_j.fused_pixels)
    np.testing.assert_allclose(st2.xyz.numpy(), np.asarray(sj2.xyz), atol=1e-5)
