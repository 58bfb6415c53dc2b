"""The port's entry points against the JAX package's `__graft_entry__.py`,
its multichip dryrun and its mesh-scaling table, on the CPU.

- `_example_state`: the port's map against the JAX one carried across by
  `convert.py`, at 32x24 with 128 surfels in 256 slots: every field the
  numpy draws fill directly (positions, information vectors, variances,
  colors, scales, opacities, counters, masks) bit for bit, the rotations
  built from the normals within 2.4e-7 (two float32 ulps at 1).
- The entry loss on that state: the port's `fn` against JAX's `render_xla`
  + `compute_loss` (the JAX entry's function, jitted) at rtol 1e-5. JAX's
  gradients are not taken: their compile alone takes ~30 s here.
- `entry(device="cpu")` at its default size: a finite loss and finite
  gradients.
- `dryrun_multichip(2, device="cpu")` on 2 shards of the CPU device at the
  JAX dryrun's size (128x64, 8 frames): its own assertions hold and
  `frame_s` has a time per frame. The JAX dryrun itself runs in
  `tests/test_parallel.py`; `tests/test_torch_mesh_system.py` holds the mesh
  against JAX.
- The scaling table's rows on 1 and 2 CPU shards: the JAX table's keys
  (`results/mesh_scaling.json`) and the port's, the window filling at frame
  6 (a member every 3 frames) and trajectories within 5e-4 of each other
  (the bound of `tests/test_parallel.py`).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from eggfusion_tpu.core import surfels as jsf
from eggfusion_tpu.core.mapper import MapperConfig as JMapperConfig, compute_loss as j_compute_loss
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu_torch import entry as tentry
from eggfusion_tpu_torch import mesh_scaling
from eggfusion_tpu_torch.convert import surfel_map_from_numpy
from eggfusion_tpu_torch.core.surfels import FIELDS

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

SMALL = (32, 24, 128, 256)  # width, height, surfels, capacity
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_states():
    js, jintr, W, H = graft._example_state(*SMALL)
    ts, tintr, _, _ = tentry._example_state(*SMALL, device="cpu")
    return js, jintr, ts, tintr, W, H


def test_example_state_matches_jax(small_states):
    js, jintr, ts, tintr, _, _ = small_states
    carried = surfel_map_from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, "cpu")
    for f in FIELDS:
        a, b = getattr(carried, f).numpy(), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f == "rotation":
            np.testing.assert_allclose(b, a, atol=2.4e-7, rtol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(tintr.numpy(), np.asarray(jintr))
    assert int(ts.num_active()) == SMALL[2]


def test_entry_loss_matches_jax(small_states):
    js, jintr, ts, tintr, W, H = small_states

    def j_fn(xyz, features_dc, opacity, w2c, color_ref, depth_ref):
        s2 = js.replace(xyz=xyz, features_dc=features_dc, opacity=opacity)
        out = j_render_xla(jsf.render_params(s2), w2c, jintr, W, H, sh_degree=0)
        kf = {"color": color_ref, "depth": depth_ref, "normal": out["normal"],
              "rgb_mask": jnp.ones((H, W, 1), bool), "geo_mask": depth_ref > 0}
        geo = {"position": jax.lax.stop_gradient(s2.xyz), "normal": jax.lax.stop_gradient(s2.get_normal())}
        return j_compute_loss(out, kf, s2, geo, JMapperConfig())

    j_args = (js.xyz, js.features_dc, js.opacity, jnp.eye(4), jnp.full((H, W, 3), 0.5), jnp.full((H, W, 1), 2.0))
    j_loss = float(jax.jit(j_fn)(*j_args))
    t_loss = tentry._loss_fn(ts, tintr, W, H)(*[torch.from_numpy(np.array(a)) for a in j_args])
    np.testing.assert_allclose(float(t_loss), j_loss, rtol=1e-5)


def test_entry_default_size_cpu():
    fn, args = tentry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    args = [a.clone().requires_grad_(i < 3) for i, a in enumerate(args)]
    loss = fn(*args)
    grads = torch.autograd.grad(loss, args[:3])
    assert loss.shape == () and torch.isfinite(loss)
    for a, g in zip(args, grads):
        assert g.shape == a.shape and bool(torch.isfinite(g).all())
    assert float(grads[0].abs().max()) > 0


def test_dryrun_multichip_cpu():
    r = tentry.dryrun_multichip(2, device="cpu")
    assert r["n_devices"] == 2 and (r["width"], r["height"], r["n_frames"]) == (128, 64, 8)
    assert np.isfinite(r["ate_cm"]) and r["max_fused_px"] > 100 and r["surfels"] > 500 and r["opt_steps"] >= 4
    assert len(r["frame_s"]) == 8 and all(t > 0 for t in r["frame_s"])


def test_scaling_rows_cpu():
    with open(os.path.join(REPO, "results", "mesh_scaling.json")) as f:
        jax_keys = set(json.load(f)["rows"][0])
    rows, trajs = [], []
    for n in (1, 2):
        r, ef = mesh_scaling.row(n, 128, 64, 8, 8192, None, device=torch.device("cpu"))
        rows.append(r)
        trajs.append(ef._traj_np("est"))
    for n, r in zip((1, 2), rows):
        assert jax_keys <= set(r) and r["n_devices"] == n and r["window"] == 3
        assert r["window_sizes"] == [1, 1, 1, 2, 2, 2, 3, 3] and r["window_full_frame"] == 6
        assert r["steady_ms_per_frame"] == pytest.approx(1e3 * float(np.median(r["frame_s"][6:])))
        assert r["launches_by_gpu"] == {"composite_fwd": [0], "composite_bwd": [0]}  # the CPU launches no kernel
    assert np.abs(trajs[0] - trajs[1]).max() < 5e-4
    assert mesh_scaling.steady([1.0, 2.0], [1, 2], 4) == (None, None)
