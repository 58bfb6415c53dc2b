"""The port's mapper under a mesh (`System.mesh_devices`) against the JAX
package's, on the CPU: the window-batched amortized schedule, the window
batches and the trajectory they give, and the batches of the global
keyframe optimization of `finish()`.

One sequence runs in both packages on a mesh of 2: JAX on the suite's
virtual CPU mesh (`tests/conftest.py`), the port on 2 shards of the CPU
device. It is `tests/test_parallel.py`'s setup (120x90 synthetic, 6144
surfels, SH 0) with the "xla" compositor (the JAX one with 8 surfels per
scan step), the port replaying the JAX spawn draws, recovery off, a fixed
map, over 5 frames. A keyframe check and a window member on more frames
than by default (`sw_optimize_freq` 2, `sw_add_freq` 1, `check_keyframe_t`
5 mm) fill the 3-member window, with one padding member on 2 shards. At 80x60 the
coarsest level of the last frame's solve holds 8 constraints (condition
number ~3e7), where float32 rounding alone decides whether the solve
converges in either package, so the sequence runs at 120x90.

Tolerances: the opt-step count and the surfel count after every frame,
the keyframes and every window batch (member uids and batch size) equal;
poses within the system parity test's 0.1 mm / 0.01 deg (float32 sums in
another order). Without a sequence: `_window_batch`'s size and members,
and the batches `keyframe_optimization` draws for `finish()`, equal JAX's
for meshes of 1, 2 and 3 on 5 keyframes.
"""
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eggfusion_tpu.core.renderer as j_renderer
from eggfusion_tpu import config as jcfg
from eggfusion_tpu.core import mapper as jmapper
from eggfusion_tpu.data.datasets import load_dataset as j_load_dataset
from eggfusion_tpu.main import build_frame as j_build_frame
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core import mapper as tmapper
from eggfusion_tpu_torch.core.renderer import Renderer as TRenderer
from eggfusion_tpu_torch.main import run as t_run
from eggfusion_tpu_torch.parallel import mesh as tmesh
from test_torch_system import JaxDraws, _pose_errors

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

N_FRAMES = 5
MESH = 2


def _cfg(lib, tmp, mesh_devices=MESH):
    return lib.default_config(
        Dataset={"type": "synthetic", "n_frames": N_FRAMES, "preload": False,
                 "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                                 "width": 120, "height": 90, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 1, "local_map_iter": 1, "final_global_opt_iter": 2,
                 "sample_ratio": 0.02, "sample_ratio_init": 0.04, "sw_optimize_freq": 2, "sw_add_freq": 1},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0, "check_keyframe_t": 0.005},
        System={"save_dir": str(tmp), "root_dir": str(tmp), "mesh_devices": mesh_devices, "render_backend": "xla",
                "capacity_bucketing": False, "final_global_opt": False, "eval_tracking": False,
                "eval_render": False, "eval_recon": False},
    )


def _record_batches(mp, cls, log, built):
    """Log (time, member uids) of every `_window_batch` call of `cls`, and
    the member uids of each batch it builds (not cached) into `built`."""
    real = cls._window_batch

    def logged(self, kfs):
        key = tuple(kf.uid for kf in kfs)
        log.append((self.time, key))
        if self._window_batch_cache is None or self._window_batch_cache[0] != key:
            built.append(key)
        return real(self, kfs)

    mp.setattr(cls, "_window_batch", logged)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both systems after the frame loop: for each, the system, its
    `_window_batch` calls and the sizes of the batches it built."""
    tmp = tmp_path_factory.mktemp("torch_mesh_system")
    out = {k: {"calls": [], "built": [], "sizes": []} for k in ("jax", "torch")}
    j, t = out["jax"], out["torch"]
    cfg_j = _cfg(jcfg, tmp / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_renderer, "render_xla", functools.partial(j_render_xla, chunk=8))
        _record_batches(mp, jmapper.Mapping, j["calls"], j["built"])
        ef_j = JEGGFusion(cfg_j)
        dataset = j_load_dataset(cfg_j)
        for fid in range(N_FRAMES):
            ef_j.reconstruct(j_build_frame(dataset, fid, False))
    j["ef"] = ef_j
    real = tmesh.window_batch
    with pytest.MonkeyPatch.context() as mp:
        _record_batches(mp, tmapper.Mapping, t["calls"], t["built"])
        mp.setattr(tmesh, "window_batch", lambda kfs, b, devices: t["sizes"].append(b) or real(kfs, b, devices))
        t["ef"] = t_run(_cfg(tcfg, tmp / "torch"), device="cpu", random_source=JaxDraws())
    return out


def test_mesh_run_matches_jax(runs):
    """Per frame the same opt steps (the amortized accumulator under a mesh
    advances local_map_iter / sw_optimize_freq batched steps a frame), the
    same surfel counts and poses, and the same keyframes."""
    ef_j, ef_t = runs["jax"]["ef"], runs["torch"]["ef"]
    assert ef_t.mapper.devices == [torch.device("cpu")] * MESH and ef_t.tracker.devices == ef_t.mapper.devices
    for key in ("opt_steps", "surfels"):
        per_j = [int(m[key]) for m in ef_j.metrics if m["frame"] >= 0]
        per_t = [int(m[key]) for m in ef_t.metrics if m["frame"] >= 0]
        assert per_t == per_j, key
    t_err, r_err = _pose_errors(ef_j._traj_np("est"), ef_t._traj_np("est"))
    assert t_err.max() < 1e-4, t_err
    assert r_err.max() < 0.01, r_err
    assert ef_t.mapper.opt_steps_total == ef_j.mapper.opt_steps_total > 0
    assert ef_t.mapper.keyframe_manager.ids() == ef_j.mapper.keyframe_manager.ids()
    assert int(ef_t.mapper.surfels.num_active()) == int(np.asarray(ef_j.mapper.surfels.num_active()))


def test_mesh_batches_match_jax(runs):
    """Every window batch holds the same keyframes, built at the same
    size."""
    j, t = runs["jax"], runs["torch"]
    assert t["calls"] == j["calls"]
    assert t["built"] == j["built"]
    # JAX: B = window_size (3) rounded up to the mesh (4), one padding member
    ef_j = j["ef"]
    B = -(-max(ef_j.mapper.keyframe_manager.window_size, MESH) // MESH) * MESH
    assert t["sizes"] == [B] * len(j["built"])
    assert max(len(u) for u in j["built"]) == 3


def _fake_keyframes(n, lib):
    """`n` keyframes with 4x3 maps, as window members of either package."""
    kfs = []
    for uid in range(n):
        maps = {"color": np.full((3, 4, 3), uid, np.float32), "depth": np.full((3, 4, 1), uid, np.float32)}
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = uid
        intr = np.asarray([4.0, 4.0, 1.5, 1.0], np.float32)
        if lib == "jax":
            kfs.append(SimpleNamespace(uid=uid, w2c=jnp.asarray(w2c), intr=jnp.asarray(intr), width=4, height=3,
                                       device_maps=lambda m=maps: {k: jnp.asarray(v) for k, v in m.items()}))
        else:
            kfs.append(SimpleNamespace(uid=uid, w2c=torch.from_numpy(w2c), intr=torch.from_numpy(intr), width=4,
                                       height=3, device_maps=lambda m=maps: {k: torch.from_numpy(v)
                                                                            for k, v in m.items()}))
    return kfs


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_batch_composition_matches_jax(tmp_path, n_dev, monkeypatch):
    """`_window_batch` over a window of 3 and `keyframe_optimization`'s
    draws over 5 keyframes, on a mesh of `n_dev`, as the JAX mapper makes
    them."""
    from eggfusion_tpu.core.renderer import Renderer as JRenderer

    mappers = {"jax": jmapper.Mapping(_cfg(jcfg, tmp_path, n_dev), JRenderer(_cfg(jcfg, tmp_path, n_dev))),
               "torch": tmapper.Mapping(_cfg(tcfg, tmp_path, n_dev),
                                        TRenderer(_cfg(tcfg, tmp_path, n_dev), "cpu", backend="xla"), "cpu")}
    sizes = []
    real = tmesh.window_batch
    monkeypatch.setattr(tmesh, "window_batch", lambda kfs, b, devices: sizes.append(b) or real(kfs, b, devices))
    drawn = {}
    for lib, m in mappers.items():
        kfs = _fake_keyframes(5, lib)
        batch = m._window_batch(kfs[:3])
        if lib == "jax":
            _, w2c, valid = batch
            valid = [int(v) for v in np.asarray(valid)]
            members = [int(x) for x in np.asarray(w2c)[:, 0, 3]][:sum(valid)]
        else:
            (B,) = sizes
            valid = [1] * batch.n_valid + [0] * (B - batch.n_valid)
            members = [int(w2c[0, 3]) for shard in batch.shards for _, w2c, _ in shard]
            per = B // n_dev
            assert [len(sh) for sh in batch.shards] == [min(per, max(0, 3 - i * per)) for i in range(n_dev)]
        drawn[lib] = {"valid": valid, "members": members}
        m.keyframe_manager.keyframes = {kf.uid: kf for kf in kfs}
        m.time = 7
        runs = []
        monkeypatch.setattr(type(m), "_optimize_batched",
                            lambda self, batches, n_steps, lrs, runs=runs: runs.append(
                                ([[kf.uid for kf in b] for b in batches], n_steps)))
        m.keyframe_optimization()
        drawn[lib]["global"] = runs
    assert drawn["torch"] == drawn["jax"]
    assert len(drawn["jax"]["valid"]) == -(-max(3, n_dev) // n_dev) * n_dev
    (batches, n_steps), = drawn["jax"]["global"]
    # final_global_opt_iter 2 x 5 keyframes // window 3 batches of 3 draws, one step each
    assert n_steps == 1 and len(batches) == 3 and all(len(b) == 3 for b in batches)
    assert len({tuple(b) for b in batches}) > 1
