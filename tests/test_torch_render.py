"""Port parity of the renderers: projection, the all-pairs oracle with its
gradients, the tile binning, and the tile compositor (its plain PyTorch
kernels on the CPU) against `render_pallas(interpret=True)`, on the scene
and sizes of `tests/test_raster_pallas.py` (160x96, CAP 256, 64 surfels).

The JAX all-pairs oracle runs with 8 surfels per scan step instead of 32:
the same blend, one surfel after another in depth order, compiled in a
fraction of the time.

Tolerances: images 1e-5 absolute plus 1e-5 relative (float32 compositing
in a different association order); gradients 1e-4 relative to each field's largest
gradient (sums over pixels and entries run in another order). Binning is
integer and compared exactly on a scene without key ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggfusion_tpu.core import surfels as jsf
from eggfusion_tpu.ops import raster_common as jrc
from eggfusion_tpu.ops import raster_pallas as jrp
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu_torch.convert import surfel_map_from_numpy
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.ops import raster_common as trc
from eggfusion_tpu_torch.ops import raster_tile as trt
from eggfusion_tpu_torch.ops.raster_xla import render_xla as t_render_xla

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 160, 96
INTR = np.asarray([100.0, 100.0, W / 2 - 0.5, H / 2 - 0.5], np.float32)
CAP = 256
GRAD_FIELDS = ("xyz", "opacity", "scales", "rotations", "normal", "shs")
OUT_KEYS = ("color", "normal", "depth", "opacity")


def _random_scene(n=64, seed=0, scale_range=(0.01, 0.045)):
    """The scene of `tests/test_raster_pallas.py::_random_scene`."""
    rng = np.random.default_rng(seed)
    cfg = jsf.SurfelConfig(capacity=2 * n, max_sh_degree=0, active_sh_degree=0)
    s = jsf.SurfelMap.empty(cfg)
    xyz = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))], -1).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    batch = jsf.SpawnBatch(
        xyz=jnp.asarray(xyz), normal=jnp.asarray(nrm),
        color=jnp.asarray(rng.uniform(size=(n, 3)).astype(np.float32)),
        dist=jnp.asarray(rng.uniform(*scale_range, (n, 3)).astype(np.float32)),
        eta=jnp.zeros((n, 6)), sigma2=jnp.ones((n, 2)), valid=jnp.ones(n, bool),
    )
    return jsf.append_surfels(s, batch, jnp.int32(0), 0.95)


@pytest.fixture(scope="module")
def scene():
    sj = _random_scene()
    st = surfel_map_from_numpy({f: np.asarray(getattr(sj, f)) for f in tsf.FIELDS}, "cpu")
    pj = jsf.render_params(sj)
    pt = tsf.render_params(st)
    return pj, pt


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_out(oj, ot, keys=OUT_KEYS, tol=1e-5):
    # depth and normal are divided by the accumulated weight, which is tiny
    # at fringe pixels: there the bound is relative
    for k in keys:
        np.testing.assert_allclose(_np(ot[k]), _np(oj[k]), atol=tol, rtol=tol, err_msg=k)


def _close_grads(gj, gt, rtol=1e-4):
    for k in gj:
        a, b = _np(gj[k]), _np(gt[k])
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() <= rtol * scale, (k, np.abs(a - b).max(), scale)


def _loss_j(o):
    return (jnp.mean(jnp.abs(o["color"] - 0.3)) + jnp.mean(jnp.abs(o["depth"] - 1.5))
            + jnp.mean(o["normal"] ** 2) + jnp.mean(o["opacity"]))


def _loss_t(o):
    return (torch.mean(torch.abs(o["color"] - 0.3)) + torch.mean(torch.abs(o["depth"] - 1.5))
            + torch.mean(o["normal"] ** 2) + torch.mean(o["opacity"]))


def _jax_value_and_grads(pj, render):
    def loss(sub):
        return _loss_j(render({**pj, **sub}))

    sub = {k: pj[k] for k in GRAD_FIELDS}
    out = render(pj)
    return out, jax.grad(loss)(sub)


def _torch_value_and_grads(pt, render):
    sub = {k: pt[k].detach().clone().requires_grad_(True) for k in GRAD_FIELDS}
    out = render({**pt, **sub})
    grads = torch.autograd.grad(_loss_t(out), [sub[k] for k in GRAD_FIELDS])
    return out, dict(zip(GRAD_FIELDS, grads))


def test_project_surfels(scene):
    pj, pt = scene
    a = jrc.project_surfels(pj, jnp.eye(4), jnp.asarray(INTR), W, H, sh_degree=0)
    b = trc.project_surfels(pt, torch.eye(4), torch.from_numpy(INTR), W, H, sh_degree=0)
    for f in a._fields:
        if f == "valid":
            np.testing.assert_array_equal(_np(getattr(b, f)), _np(getattr(a, f)))
        else:
            np.testing.assert_allclose(_np(getattr(b, f)), _np(getattr(a, f)), rtol=1e-5, atol=1e-5, err_msg=f)


def test_projection_grad_at_camera_plane(scene):
    """A surfel 2e-6 m off the camera plane, 4 m to the side: its
    covariance overflows float32 in the JAX module, whose gradient is then
    NaN (a zero gradient times a NaN local derivative). The port's values
    agree wherever a render reads them (valid surfels, and the radius,
    zero elsewhere) and its gradient stays finite."""
    pj, pt = scene
    xyz = np.asarray(pj["xyz"]).copy()
    xyz[:, 0] = [4.2, -1.0, 2e-6]
    pj = {**pj, "xyz": jnp.asarray(xyz)}
    a = jrc.project_surfels(pj, jnp.eye(4), jnp.asarray(INTR), W, H, sh_degree=0)
    params = {k: (v.detach().clone().requires_grad_(v.is_floating_point()) if torch.is_tensor(v) else v)
              for k, v in pt.items()}
    params["xyz"] = torch.from_numpy(xyz).requires_grad_(True)
    b = trc.project_surfels(params, torch.eye(4), torch.from_numpy(INTR), W, H, sh_degree=0)
    assert not np.isfinite(_np(a.conic)[:, 0]).all()
    np.testing.assert_array_equal(_np(b.valid), _np(a.valid))
    valid = _np(a.valid)
    for f in ("mean2d", "radius"):  # `test_project_surfels`' tolerance
        np.testing.assert_allclose(_np(getattr(b, f)), _np(getattr(a, f)), rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(_np(b.conic)[:, valid], _np(a.conic)[:, valid], rtol=1e-5, atol=1e-5)
    assert torch.isfinite(b.conic).all()
    loss = (b.conic * torch.where(b.valid, 1.0, 0.0)).sum() + b.mean2d[:, b.valid].sum()
    grads = torch.autograd.grad(loss, [params["xyz"], params["scales"], params["rotations"]])
    assert all(torch.isfinite(g).all() for g in grads)


def test_render_xla_outputs_and_grads(scene):
    pj, pt = scene
    oj, gj = _jax_value_and_grads(pj, lambda p: j_render_xla(p, jnp.eye(4), jnp.asarray(INTR), W, H, sh_degree=0,
                                                             chunk=8))
    ot, gt = _torch_value_and_grads(pt, lambda p: t_render_xla(p, torch.eye(4), torch.from_numpy(INTR), W, H, sh_degree=0))
    _close_out(oj, ot)
    _close_grads(gj, gt)


def test_bin_entries_exact(scene):
    pj, _ = scene
    proj = jrc.project_surfels(pj, jnp.eye(4), jnp.asarray(INTR), W, H, sh_degree=0)
    nt = jrp.n_tiles_static(W, H)
    tx, ty = -(-W // jrp.TILE_W), -(-H // jrp.TILE_H)
    sid_j, cnt_j, back_j, run_j = jrp._bin_entries(proj.depth, proj.mean2d, proj.radius, proj.valid,
                                                   nt, tx, ty, CAP)
    t = lambda x: torch.from_numpy(np.array(x))
    sid_t, cnt_t, back_t, run_t = trt._bin_entries(t(proj.depth), t(proj.mean2d), t(proj.radius),
                                                   t(proj.valid), nt, tx, ty, CAP)
    # the scene must not tie keys (equal keys may order differently)
    keys_valid = np.asarray(proj.depth)[np.asarray(proj.valid)]
    assert len(np.unique(keys_valid)) == len(keys_valid)
    np.testing.assert_array_equal(_np(cnt_t), np.asarray(cnt_j))
    assert int(run_t) == int(run_j)
    np.testing.assert_array_equal(_np(back_t), np.asarray(back_j))
    rows = (np.arange(CAP)[None, :] // trt.N_SUB) < np.asarray(cnt_j)[:, np.arange(CAP) % trt.N_SUB]
    np.testing.assert_array_equal(_np(sid_t)[rows], np.asarray(sid_j)[rows])
    assert rows.sum() > 100


def test_tile_renderer_forward_and_grads(scene):
    pj, pt = scene
    oj, gj = _jax_value_and_grads(pj, lambda p: jrp.render_pallas(p, jnp.eye(4), jnp.asarray(INTR), W, H,
                                                                  sh_degree=0, cap=CAP, interpret=True))
    ot, gt = _torch_value_and_grads(pt, lambda p: trt.render_tile(p, torch.eye(4), torch.from_numpy(INTR), W, H,
                                                                  sh_degree=0, cap=CAP))
    _close_out(oj, ot)
    _close_grads(gj, gt)


def test_tile_renderer_geom_only_and_overflow(scene):
    pj, pt = scene
    kw = dict(sh_degree=0, interpret=True)
    oj = jrp.render_pallas(pj, jnp.eye(4), jnp.asarray(INTR), W, H, cap=CAP, geom_only=True, need_grad=False, **kw)
    ot = trt.render_tile(pt, torch.eye(4), torch.from_numpy(INTR), W, H, sh_degree=0, cap=CAP,
                         geom_only=True, need_grad=False)
    assert set(ot) == {"depth", "opacity"}
    _close_out(oj, ot, keys=("depth", "opacity"))
    # overflow: cap 32 (8 slots per sub-column) drops into the stratified tail
    oj = jrp.render_pallas(pj, jnp.eye(4), jnp.asarray(INTR), W, H, cap=32, need_grad=False,
                           with_occupancy=True, **kw)
    ot = trt.render_tile(pt, torch.eye(4), torch.from_numpy(INTR), W, H, sh_degree=0, cap=32,
                         need_grad=False, with_occupancy=True)
    assert int(ot["max_occupancy"]) == int(oj["max_occupancy"]) > 8
    _close_out(oj, ot)


def test_tile_subset_and_cached_binning(scene):
    pj, pt = scene
    nt = trt.n_tiles_static(W, H)
    keep = np.arange(nt) % 2 == 0
    oj, gj = _jax_value_and_grads(pj, lambda p: jrp.render_pallas(
        p, jnp.eye(4), jnp.asarray(INTR), W, H, sh_degree=0, cap=CAP, interpret=True,
        tile_keep=jnp.asarray(keep)))
    binning = trt.compute_binning(pt, torch.eye(4), torch.from_numpy(INTR), W, H, cap=CAP)
    ot, gt = _torch_value_and_grads(pt, lambda p: trt.render_tile(
        p, torch.eye(4), torch.from_numpy(INTR), W, H, sh_degree=0, cap=CAP,
        tile_keep=torch.from_numpy(keep), binning=binning))
    _close_out(oj, ot)
    _close_grads(gj, gt)
    pm = trt.tile_pixel_mask(torch.from_numpy(keep), W, H)
    np.testing.assert_array_equal(_np(pm), np.asarray(jrp.tile_pixel_mask(jnp.asarray(keep), W, H)))
    assert float(ot["opacity"].detach()[~pm].abs().max()) == 0.0


def test_plain_backward_matches_finite_difference():
    """The compositor's plain backward (autograd through the plain forward)
    against central differences of the plain forward on a tiny scene whose
    splats are wide enough that no alpha cut-off (1/255, 0.99) lies inside
    their sub-column — the forward is smooth there. 1% relative: float32
    outputs, step 1e-3 relative to each attribute."""
    rng = np.random.default_rng(1)
    cap, tx = 16, 1
    e = np.zeros((1, cap, trt.N_ATTR), np.float32)
    for s in range(cap // trt.N_SUB):
        for c in range(trt.N_SUB):
            row = e[0, s * trt.N_SUB + c]
            row[trt.A_U] = c * 32 + rng.uniform(8, 24)
            row[trt.A_V] = rng.uniform(8, 24)
            row[[trt.A_CA, trt.A_CB, trt.A_CC]] = [rng.uniform(1e-3, 2e-3), 2e-4, rng.uniform(1e-3, 2e-3)]
            row[trt.A_OP] = rng.uniform(0.3, 0.7)
            row[trt.A_R:trt.A_B + 1] = rng.uniform(size=3)
            nrm = rng.normal(size=3) * 0.2 + [0, 0, -1]
            row[trt.A_NX:trt.A_NZ + 1] = nrm / np.linalg.norm(nrm)
            row[trt.A_PX:trt.A_PZ + 1] = [rng.normal() * 0.1, rng.normal() * 0.1, 1.0 + s * 0.2]
    entries = torch.from_numpy(e)
    counts = torch.tensor([[4, 3, 2, 4]], dtype=torch.int32)
    intr = torch.tensor([100.0, 100.0, 64.0, 16.0])
    hp, wp = 32, 128
    cots = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((3, hp, wp), (3, hp, wp), (hp, wp), (hp, wp), (hp, wp))]
    outs = trt.composite_fwd(entries, counts, intr, tx, cap)
    d = trt.composite_bwd(entries, counts, intr, *cots, outs[4], tx, cap)
    # rows past their sub-column's count and the padding column get nothing
    rows = np.arange(cap)
    dead = (rows // trt.N_SUB) >= counts.numpy()[0][rows % trt.N_SUB]
    assert np.abs(d.numpy()[0][dead]).max() == 0.0
    assert np.abs(d.numpy()[..., 15]).max() == 0.0

    def f(x):
        return sum(float((o.double() * c.double()).sum())
                   for o, c in zip(trt.composite_fwd(x, counts, intr, tx, cap), cots))

    h = 1e-3
    for k in range(4):
        v = torch.from_numpy((rng.normal(size=e.shape) * (np.abs(e) + 1e-2)).astype(np.float32))
        v[..., 15] = 0
        v[0, dead] = 0
        fd = (f(entries + h * v) - f(entries - h * v)) / (2 * h)
        an = float((d.double() * v.double()).sum())
        assert abs(fd - an) <= 0.01 * abs(an), (k, fd, an)


def test_plain_backward_of_empty_tiles():
    """The plain backward gives zero gradients for tile batches whose tiles
    hold no entry (an opt step's tile subset can keep only such tiles),
    and still the gradients of the other batches."""
    from eggfusion_tpu_torch.ops.raster_slabs import random_slab

    entries, counts, intr, tx = random_slab(64)
    counts[:2] = 0  # the first tile batch is empty
    outs = trt.composite_fwd(entries, counts, intr, tx, 64)
    g = torch.Generator().manual_seed(3)
    cots = [torch.randn(o.shape, generator=g) for o in outs]
    d = trt.composite_bwd_plain(entries, counts, intr, *cots, tx, 64, tile_batch=2)
    assert float(d[:2].abs().max()) == 0.0 and float(d[2:].abs().max()) > 0
    whole = trt.composite_bwd_plain(entries, counts, intr, *cots, tx, 64)
    torch.testing.assert_close(d, whole, rtol=1e-5, atol=1e-6)
    empty = torch.zeros_like(counts)
    assert float(trt.composite_bwd_plain(entries, empty, intr, *cots, tx, 64).abs().max()) == 0.0


def test_count_live_pairs():
    """The live-pair count that bounds the kernels' work: slots of opacity
    0.5 with a near-flat footprint are live on all 32x32 pixels of their
    sub-column, slots of opacity 0.002 (< ALPHA_EPS) and slots past the
    count on none. Exact: no pixel lies near the 1/255 cut-off."""
    cap, tx = 32, 2
    e = np.zeros((2, cap, trt.N_ATTR), np.float32)
    rows = np.arange(cap)
    e[:, :, trt.A_U] = (rows % trt.N_SUB) * 32 + 16 + np.arange(2)[:, None] * trt.TILE_W
    e[:, :, trt.A_V] = 16
    e[:, :, [trt.A_CA, trt.A_CC]] = 1e-6
    e[:, :, trt.A_OP] = np.where(rows % 3 == 0, 0.002, 0.5)
    counts = np.array([[8, 5, 0, 3], [2, 8, 7, 1]], np.int32)
    live_slots = sum(int(((np.arange(counts[t, c]) * trt.N_SUB + c) % 3 != 0).sum())
                     for t in range(2) for c in range(trt.N_SUB))
    got = trt.count_live_pairs(torch.from_numpy(e), torch.from_numpy(counts), tx, cap)
    assert got == live_slots * trt.TILE_H * trt.SUB_W


def test_overflow_keeps_nearest():
    """`tests/test_raster_pallas.py::TestCapacityOverflow` on the port: with
    CAP below the load of the center sub-column, the nearest surfels are
    kept and an opaque pixel renders as with room for all."""
    n = 40
    rng = np.random.default_rng(3)
    s = tsf.SurfelMap.empty(tsf.SurfelConfig(capacity=n, max_sh_degree=0, active_sh_degree=0))
    color = rng.uniform(size=(n, 3)).astype(np.float32)
    color[0] = [1.0, 0.0, 0.0]
    z = np.linspace(1.0, 3.0, n, dtype=np.float32)[:, None]
    batch = tsf.SpawnBatch(
        xyz=torch.from_numpy(np.concatenate([np.zeros((n, 2), np.float32), z], -1)),
        normal=torch.tensor([0.0, 0.0, -1.0]).repeat(n, 1), color=torch.from_numpy(color),
        dist=torch.full((n, 3), 0.2), eta=torch.zeros((n, 6)), sigma2=torch.ones((n, 2)),
        valid=torch.ones(n, dtype=torch.bool))
    params = tsf.render_params(tsf.append_surfels(s, batch, 0, 0.99))
    render = lambda cap: trt.render_tile(params, torch.eye(4), torch.from_numpy(INTR), W, H, sh_degree=0,
                                         cap=cap, need_grad=False)
    full, cut = render(128), render(32)
    cy, cx = H // 2, W // 2
    np.testing.assert_allclose(cut["color"][cy, cx].numpy(), full["color"][cy, cx].numpy(), atol=1e-4)
    assert float(cut["color"][cy, cx, 0]) > 0.9  # the nearest (red) surfel wins
