"""The compositor kernels' row cull never drops a live pair.

`raster_tile.cull_extent` is the plain twin of the kernels' predicate
(`csrc/composite_common.cuh::cull_rows`): a pair whose alpha is nonzero
must lie within the entry's half extents. Checked here by a property test
over single entries (random conics from tiny to huge, conics with b^2 near
a c, the LOWPASS-only footprint, opacities within 1e-3 of 1/255, centres up
to 64 px outside the sub-column), on the slab a small synthetic scene
bins to and on the adversarial slabs of `raster_slabs`. Exact: the alphas are those of `_slot_alpha`, the plain
compositor's, and the test asserts containment, not a tolerance.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.ops import raster_common as trc
from eggfusion_tpu_torch.ops import raster_tile as trt
from eggfusion_tpu_torch.ops.raster_slabs import adversarial_slab

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

# the pixel centres of one 32x32 sub-column at the origin
_XS, _YS = (g.to(torch.float32) for g in torch.meshgrid(torch.arange(trt.SUB_W), torch.arange(trt.TILE_H),
                                                       indexing="xy"))


def _entry(u, v, a, b, c, op):
    e = torch.zeros(trt.N_ATTR, dtype=torch.float32)
    e[[trt.A_U, trt.A_V, trt.A_CA, trt.A_CB, trt.A_CC, trt.A_OP]] = torch.tensor(
        [u, v, a, b, c, op], dtype=torch.float32)
    return e


def _assert_live_inside(e):
    """Every pixel of the sub-column where `e` has nonzero alpha lies inside
    its cull extent; returns the number of live pixels."""
    alpha = trt._slot_alpha(e, _XS, _YS, torch.ones(()))
    live = alpha > 0
    hw, hh = trt.cull_extent(e)
    inside = ((_XS - e[trt.A_U]).abs() <= hw) & ((_YS - e[trt.A_V]).abs() <= hh)
    assert not bool((live & ~inside).any()), (e.tolist(), float(hw), float(hh), int(live.sum()))
    return int(live.sum())


def _conic_from_axes(ax, ay, bx, by):
    """The conic `project_surfels` gives for projected tangent axes (ax, ay),
    (bx, by): the inverse of their covariance plus the LOWPASS dilation,
    computed in float64 and rounded to float32 as the slab holds it."""
    cxx = ax * ax + bx * bx + trc.LOWPASS
    cxy = ax * ay + bx * by
    cyy = ay * ay + by * by + trc.LOWPASS
    det = max(cxx * cyy - cxy * cxy, 1e-12)
    return cyy / det, -cxy / det, cxx / det


_log_len = st.floats(min_value=-4.0, max_value=3.0)  # axis lengths 1e-4 .. 1e3 px
_angle = st.floats(min_value=0.0, max_value=np.pi)
_centre = st.floats(min_value=-64.0, max_value=trt.SUB_W + 64.0)
_opacity = st.one_of(
    st.floats(min_value=1.0 / 255.0 - 1e-3, max_value=1.0 / 255.0 + 1e-3),
    st.floats(min_value=0.0, max_value=1.0),
)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(l1=_log_len, l2=_log_len, th=_angle, u=_centre, v=_centre, op=_opacity)
def test_cull_keeps_every_live_pair_projected(l1, l2, th, u, v, op):
    """Conics as projection makes them: two tangent axes (one may vanish,
    leaving the LOWPASS-only footprint, or both be huge and near-parallel)."""
    s1, s2 = 10.0 ** l1, 10.0 ** l2
    a, b, c = _conic_from_axes(s1 * np.cos(th), s1 * np.sin(th), -s2 * np.sin(th), s2 * np.cos(th))
    _assert_live_inside(_entry(u, v, a, b, c, op))


@settings(max_examples=400, deadline=None, derandomize=True)
@given(la=st.floats(min_value=-6.0, max_value=3.0), lc=st.floats(min_value=-6.0, max_value=3.0),
       rho=st.one_of(st.floats(min_value=-1.0, max_value=1.0),
                     st.floats(min_value=1.0 - 1e-3, max_value=1.0),
                     st.floats(min_value=-1.0, max_value=-1.0 + 1e-3)),
       u=_centre, v=_centre, op=_opacity)
def test_cull_keeps_every_live_pair_raw_conic(la, lc, rho, u, v, op):
    """Conics drawn directly, b = rho sqrt(a c) with rho up to +-1 (b^2 -> a c)."""
    a, c = 10.0 ** la, 10.0 ** lc
    _assert_live_inside(_entry(u, v, a, rho * np.sqrt(a * c), c, op))


@settings(max_examples=600, deadline=None, derandomize=True)
@given(l1=_log_len, l2=_log_len, th=_angle, op=st.floats(min_value=0.005, max_value=1.0),
       delta=st.floats(min_value=-1e-6, max_value=1e-5), vertical=st.booleans())
def test_cull_keeps_live_pairs_on_the_ellipse(l1, l2, th, op, delta, vertical):
    """The pixel sits at the ellipse's extreme point in y (or x), a relative
    `delta` outside the exact boundary Q = tau, where float32 rounding
    decides whether its alpha reaches 1/255: the padded extents must still
    hold it when it is live."""
    s1, s2 = 10.0 ** l1, 10.0 ** l2
    a, b, c = (float(np.float32(x)) for x in _conic_from_axes(
        s1 * np.cos(th), s1 * np.sin(th), -s2 * np.sin(th), s2 * np.cos(th)))
    op = float(np.float32(op))
    det = a * c - b * b
    tau = 2.0 * np.log(255.0 * op)
    if vertical:  # extreme point in y: dy = sqrt(tau a / det), dx = -b dy / a
        dy = np.sqrt(tau * a / det) * (1 + delta)
        dx = -b * dy / a
    else:
        dx = np.sqrt(tau * c / det) * (1 + delta)
        dy = -b * dx / c
    if max(abs(dx), abs(dy)) > 1e4:
        return
    _assert_live_inside(_entry(16.0 - dx, 16.0 - dy, a, b, c, op))


def test_cull_extent_special_cases():
    """Footprints the cull must leave alone, and those it drops whole."""
    inf = float("inf")
    lowpass = 1.0 / trc.LOWPASS
    cases = [
        (_entry(16, 16, lowpass, 0.0, lowpass, 0.9), None),          # LOWPASS-only: finite extent
        (_entry(16, 16, 1.0, 0.999, 1.0, 0.9), (inf, inf)),           # det <= 4e-3 a c: never culled
        (_entry(16, 16, -1.0, 0.0, 1.0, 0.9), (inf, inf)),            # not positive definite
        (_entry(float("nan"), 16, 1.0, 0.0, 1.0, 0.9), (inf, inf)),  # non-finite
        (_entry(16, 16, 1.0, 0.0, 1.0, 0.0), (-1.0, -1.0)),           # op 0: dead
        (_entry(16, 16, 1.0, 0.0, 1.0, 0.5 / 255), (-1.0, -1.0)),     # op < 1/255: dead
    ]
    for e, want in cases:
        hw, hh = (float(x) for x in trt.cull_extent(e))
        if want is None:
            assert 1.0 < hw < 6.0 and 1.0 < hh < 6.0
        else:
            assert (hw, hh) == want
        _assert_live_inside(e)


def _scene_slab(cap=256, n=400, seed=0):
    """The slab a small synthetic scene bins to (160x96, the port's own
    projection and binning), with its counts."""
    rng = np.random.default_rng(seed)
    W, H = 160, 96
    intr = torch.tensor([100.0, 100.0, W / 2 - 0.5, H / 2 - 0.5])
    xyz = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))], -1)
    nrm = rng.normal(size=(n, 3)) + [0, 0, -2]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    batch = tsf.SpawnBatch(xyz=f32(xyz), normal=f32(nrm), color=f32(rng.uniform(size=(n, 3))),
                           dist=f32(rng.uniform(0.002, 0.06, (n, 3))), eta=torch.zeros((n, 6)),
                           sigma2=torch.ones((n, 2)), valid=torch.ones(n, dtype=torch.bool))
    s = tsf.append_surfels(tsf.SurfelMap.empty(tsf.SurfelConfig(capacity=n, max_sh_degree=0,
                                                                 active_sh_degree=0)), batch, 0, 0.5)
    params = tsf.render_params(s)
    hp, wp, tx, ty = trt._grid(W, H)
    proj = trc.project_surfels(params, torch.eye(4), intr, W, H, sh_degree=0)
    sid, counts, _, _ = trt._bin_entries(proj.depth, proj.mean2d, proj.radius, proj.valid,
                                         tx * ty, tx, ty, cap, need_back=False)
    attrs = torch.cat([proj.mean2d, proj.conic, proj.opacity[None], proj.color, proj.normal_cam,
                       proj.p_cam, torch.ones_like(proj.opacity)[None]], dim=0).T
    return attrs[sid].contiguous(), counts, tx, cap


def _assert_slab_live_inside(entries, counts, tx, cap):
    """Every live (pixel, slot) pair of the slab's sweep lies in its slot's
    cull extent, and the kept pairs cover the live ones; returns the live
    pairs."""
    tiles = torch.arange(entries.shape[0])
    E, lane_sub, xs, ys, n_lane, n_max = trt._tile_sweep(entries, counts, tx, cap, tiles)
    hw, hh = trt.cull_extent(E)  # (T, slots, N_SUB)
    n_live = 0
    for s in range(n_max):
        a = E[:, s][:, lane_sub][:, None, :, :]
        live = trt._slot_alpha(a, xs, ys, (s < n_lane).to(torch.float32)) > 0
        w, h = hw[:, s][:, lane_sub][:, None, :], hh[:, s][:, lane_sub][:, None, :]
        inside = ((xs - a[..., trt.A_U]).abs() <= w) & ((ys - a[..., trt.A_V]).abs() <= h)
        assert not bool((live & ~inside).any()), s
        n_live += int(live.sum())
    assert n_live == trt.count_live_pairs(entries, counts, tx, cap)
    visited = int(torch.clamp(counts, max=cap // trt.N_SUB).sum()) * trt.TILE_H * trt.SUB_W
    assert n_live <= trt.count_kept_pairs(entries, counts, tx, cap) < visited
    return n_live


def test_cull_on_scene_slab():
    """On a binned scene."""
    assert _assert_slab_live_inside(*_scene_slab()) > 1000


@pytest.mark.parametrize("wide", [False, True])
def test_cull_on_adversarial_slab(wide):
    """On the slabs the card checks the kernels on (`raster_slabs`), the
    wide ones included."""
    entries, counts, _intr, tx = adversarial_slab(256, seed=256, wide=wide)
    assert _assert_slab_live_inside(entries, counts, tx, 256) > 1000


@pytest.mark.parametrize("seed", [1, 2])
def test_count_kept_pairs_by_hand(seed):
    """`count_kept_pairs` against a per-pixel count of the same predicate."""
    entries, counts, tx, cap = _scene_slab(cap=64, n=200, seed=seed)
    capsub = cap // trt.N_SUB
    want = 0
    hw, hh = trt.cull_extent(entries)
    for t in range(entries.shape[0]):
        x0, y0 = (t % tx) * trt.TILE_W, (t // tx) * trt.TILE_H
        for row in range(cap):
            slot, c = divmod(row, trt.N_SUB)
            if slot >= min(int(counts[t, c]), capsub):
                continue
            # float32 arithmetic, as the predicate's
            u, v, w, h = (np.float32(x[t, row]) for x in (entries[..., trt.A_U], entries[..., trt.A_V], hw, hh))
            sx = x0 + c * trt.SUB_W
            if not (u + w >= sx and u - w <= sx + trt.SUB_W - 1):
                continue
            ylo, yhi = v - h, v + h
            want += sum(ylo <= y <= yhi for y in range(y0, y0 + trt.TILE_H)) * trt.SUB_W
    assert trt.count_kept_pairs(entries, counts, tx, cap) == want
