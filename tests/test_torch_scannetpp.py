"""The ScanNet++ profile on the port (`configs/scannetpp/39f36da05b.yaml`
as the benchmark's configuration `perfbench/configs/scannetpp.json` holds
it, on the benchmark's `orbit` traffic): the tile renderer against the plain
reference render (`perfbench/reference/surfel_render.py`), the renderer's
binning counters, the mapping-only frame through `EGGFusion`, a capacity
ladder whose last rung is not a multiple of 8192, and the ground-truth pose
committed through the frame's staged upload.

On the CPU, on seeded random surfels at small sizes. On the card (`cuda`):
no synchronizing call in `track` under `System.only_mapping`.

Tolerances: (a) the tile renderer and the reference sum the same terms in
another order and with another precision (float32 one slot at a time
against float64 prefix sums), so they agree to float32 rounding: 2e-6 of a
value's size where a pixel holds up to ~25 terms of magnitude up to 4
(depth in metres). bfloat16 (8 bits) or a TF32 product (10 bits) would be
off by 1e-3 of the value or more. Where the reference stops at upstream's
transmittance floor the gap is bounded by the transmittance it stopped at.
(b)-(d) are exact: counts, bits and capacities.
"""
import os

import numpy as np
import pytest
import torch

from eggfusion_tpu_torch.convert import surfel_map_from_numpy
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.core.frame import Frame
from eggfusion_tpu_torch.core.capacity import capacity_ladder
from eggfusion_tpu_torch.core.mapper import RENDER_COUNTS
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.main import build_frame
from eggfusion_tpu_torch.ops import raster_tile as rt
from eggfusion_tpu_torch.system import EGGFusion
from eggfusion_tpu_torch.utils import device as devutil
from eggfusion_tpu_torch.utils.graphs import same_bits
from perfbench.harness import driver, manifest, port
from perfbench.reference import surfel_render as ref

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 128, 96
INTR = torch.tensor([120.0, 120.0, 63.5, 47.5])
FIELDS = ("xyz", "rotation", "scaling", "opacity", "features_dc", "features_rest", "active")
# float32 rounding of sums of up to ~25 terms, relative to the value's size
RTOL = 2e-6


def random_map(n: int, seed: int, opacity=(0.05, 0.35), radius_px=12.0, box=(-8, W + 8, -8, H + 8),
               size=(0.1, 1.0), facing=2.0):
    """`n` seeded random surfels in front of the identity camera, centred in
    the pixel box (u0, u1, v0, v1): depths 1 mm apart or more in 1.5-3.5 m
    (the tile renderer's depth key has 0.23 mm steps), every footprint
    inside the image's sub-column windows (radius under `radius_px`; the
    scales a share in `size` of the largest), opacities in `opacity`, SH 3
    colors; `facing` turns the disks towards the camera."""
    rng = np.random.default_rng(seed)
    capacity = n
    z = 1.5 + rng.permutation(n) * (2.0 / n)
    u = rng.uniform(box[0], box[1], n)
    v = rng.uniform(box[2], box[3], n)
    fx, fy, cx, cy = INTR.tolist()
    xyz = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z]).astype(np.float32)
    # 3 sigma (with the 0.3 px^2 low-pass) under radius_px at the nearest depth
    s_max = np.sqrt((radius_px / 3.0) ** 2 - 0.3) * 1.5 / fx
    q = rng.normal(size=(4, n))
    q[0] += facing
    m = tsf.SurfelMap.empty(tsf.SurfelConfig(capacity=capacity), device="cpu")
    out = {f: getattr(m, f).numpy().copy() for f in tsf.FIELDS}
    out["xyz"][:, :n] = xyz
    out["rotation"][:, :n] = q.astype(np.float32)
    out["scaling"][:2, :n] = np.log(rng.uniform(*size, (2, n)) * s_max).astype(np.float32)
    p = rng.uniform(*opacity, n)
    out["opacity"][0, :n] = np.log(p / (1 - p)).astype(np.float32)
    out["features_dc"][:, :, :n] = rng.normal(0, 1.0, (3, 1, n)).astype(np.float32)
    out["features_rest"][:, :, :n] = rng.normal(0, 0.2, out["features_rest"][:, :, :n].shape).astype(np.float32)
    out["active"][:n] = True
    out["count"] = np.int32(n)
    return surfel_map_from_numpy(out, "cpu")


def as_ref(s) -> dict:
    return {f: getattr(s, f) for f in FIELDS}


def tile_render(s, cap: int):
    return rt.render_tile(tsf.render_params(s), torch.eye(4), INTR, W, H, sh_degree=3, cap=cap, need_grad=False,
                          with_stats=True)


def close(got, want, scale: float):
    return float((got - want).abs().max()), RTOL * scale


# ------------------------------------------------ (a) against the reference


SCENES = {
    # 600 surfels over the whole image: 70 % of the pixels covered
    "spread": dict(n=600, seed=13, cover=0.7),
    # 300 disks facing the camera in a 16 px box: lists ~280 deep, the
    # middle of the box past the stop
    "dense": dict(n=300, seed=17, cover=0.03, box=(56, 72, 40, 56), opacity=(0.25, 0.35), size=(0.7, 1.0),
                  facing=20.0),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tile_render_matches_the_reference(scene):
    """With caps above every list, the tile renderer is the reference's
    render without the transmittance stop to float32 rounding; at
    upstream's stop they part only on the pixels it ended, and there by no
    more than the transmittance it left."""
    sc = SCENES[scene]
    s = random_map(**{k: v for k, v in sc.items() if k != "cover"})
    counts = ref.subcolumn_counts(as_ref(s), torch.eye(4), INTR, W, H)
    cap = 2048
    assert int(counts.max()) <= (cap // 4) * 3 // 4, "a list reaches the stratified tail"
    out = tile_render(s, cap)
    want = ref.render(as_ref(s), torch.eye(4), INTR, W, H, t_stop=0.0)
    assert int(out["bin_stats"][2]) == int(counts.max()) > 20
    covered = want["opacity"][..., 0] > 1e-3
    assert covered.float().mean() > sc["cover"]
    for k, scale in (("color", 3.0), ("normal", 1.0), ("opacity", 1.0)):
        gap, tol = close(out[k], want[k], scale)
        assert gap <= tol, (k, gap, tol)
    gap, tol = close(out["depth"][covered], want["depth"][covered], 4.0)
    assert gap <= tol, ("depth", gap, tol)
    # the pixels the stop ended: what lies behind weighs at most the T it left
    full = want
    want = ref.render(as_ref(s), torch.eye(4), INTR, W, H)
    stopped = full["T"] < ref.T_STOP
    assert bool(stopped.any()) == (scene == "dense")
    gap = (out["opacity"] - want["opacity"])[..., 0]
    assert float(gap[~stopped].abs().max()) <= RTOL
    if scene == "dense":
        assert bool((gap[stopped] >= -RTOL).all()) and bool((gap[stopped] <= want["T"][stopped] + RTOL).all())
        assert float(want["T"][stopped].min()) >= ref.T_STOP


# ------------------------------------------------------ (b) the counters


@pytest.mark.parametrize("cap", [64, 128, 2048])
def test_counters_equal_the_reference_counts(cap):
    """`binned_entries`, `tail_entries` and `max_run` of a render and of a
    cached binning are the reference's counts of each sub-column's list,
    with the caps low enough that the tail is taken, and high."""
    s = random_map(3000, seed=29, opacity=(0.05, 0.99))
    want = ref.counters(ref.subcolumn_counts(as_ref(s), torch.eye(4), INTR, W, H), cap)
    got = dict(zip(RENDER_COUNTS, tile_render(s, cap)["bin_stats"].tolist()))
    assert got == want
    binning = rt.compute_binning(tsf.render_params(s), torch.eye(4), INTR, W, H, cap=cap)
    assert dict(zip(RENDER_COUNTS, binning.stats.tolist())) == want
    assert (want["tail_entries"] > 0) == (cap < 2048)


# ------------------------------------------ the benchmark's configuration


def profile_doc() -> dict:
    return manifest.load_json(os.path.join(manifest.ROOT, "perfbench", "configs", "scannetpp.json"))


def orbit() -> dict:
    return manifest.load_json(os.path.join(manifest.ROOT, "perfbench", "traffic", "orbit.json"))


def test_configuration_is_upstreams_merged_yaml():
    """The configuration is upstream's merged yaml at its published widths,
    each group it departs in named under `reduced` and present in the
    merged `config`; the map is allocated at `max_surfels_num` from frame 0,
    as upstream allocates it (`min_capacity`, the ladder's last rung)."""
    from eggfusion_tpu_torch import config as cfglib

    doc = profile_doc()
    assert doc["name"] == "scannetpp"
    root = manifest.ROOT
    c = doc["config"]
    cal = c["Dataset"]["Calibration"]
    assert (cal["width"], cal["height"], cal["fx"], cal["fy"], cal["cx"], cal["cy"], cal["depth_scale"]) == (
        1752, 1168, 1439.0, 1439.0, 875.5, 583.5, 1000.0)
    assert (c["Surfel"]["active_sh_degree"], c["Viewer"]["max_surfels_num"], c["Mapping"]["local_map_iter"],
            c["Mapping"]["sample_ratio"], c["System"]["only_mapping"], c["System"]["depth_range_max"]) == (
        3, 3_000_000, 8, 0.05, True, 8.0)
    assert c["System"]["min_capacity"] == c["Viewer"]["max_surfels_num"]
    assert "min_capacity" in doc["reduced"]["System"]
    assert set(doc["reduced"]) <= set(c)
    src = cfglib.load_config(os.path.join(root, doc["yaml"]), make_workspace=False).to_plain()
    for k in ("base_config", "data_config"):
        src.pop(k, None)
    assert {k for k in set(src) | set(c) if src.get(k) != c.get(k)} <= set(doc["reduced"])


# --------------------------------------- (c) the profile through EGGFusion


def small_profile(scale: float, max_surfels: int | None = None):
    """The `scannetpp` configuration as the benchmark runs it, its camera
    `scale` times the size, on the tile backend, with 2 of frame 0's 20
    optimization steps (on the CPU each costs ~0.5 s, whatever the size:
    the plain compositor loops over a sub-column's slots, and frame 0's
    lists fill them) and the map on the ladder from its first rung (not
    allocated at `max_surfels_num`, as the cell's)."""
    doc = profile_doc()
    del doc["config"]["System"]["min_capacity"]
    doc["config"]["Dataset"]["Calibration"] = driver._scaled(doc["config"]["Dataset"]["Calibration"], scale)
    doc["config"]["System"]["render_backend"] = "pallas"
    doc["config"]["Mapping"]["local_map_iter_init"] = 2
    if max_surfels is not None:
        doc["config"]["Viewer"]["max_surfels_num"] = max_surfels
    return doc


def stream_of(doc, tmp_path, seed: int):
    traffic = dict(orbit(), period=24)
    calib = doc["config"]["Dataset"]["Calibration"]
    return manifest.generator(traffic).make(calib, traffic, seed, "cpu", str(tmp_path))


def test_profile_runs_mapping_only_on_the_tile_backend(tmp_path):
    """Six frames of the ScanNet++ profile at 1/20 of its size: every pose
    is the ground truth's float32 bits, and from frame `count_lag` (1 in
    the profile) on every record carries the binning counters of the frame
    that many before, the optimization
    steps' as the steps times their binning's."""
    doc = small_profile(0.05)
    cfg = port.config(doc)
    assert cfg.System.only_mapping and cfg.Surfel.active_sh_degree == 3
    stream = stream_of(doc, tmp_path, seed=2 ** 31 + 5)
    ef, ds, preload = port.system(cfg, stream, "cpu")
    assert ef.renderer.backend == "pallas"
    build, reconstruct = port.frame_fn(ef, ds, preload)
    for k in range(6):
        f = build(k)
        reconstruct(f)
        gt = torch.as_tensor(ds[k][4])
        assert same_bits(f.w2c_matrix(), gt), k
    recs = [m for m in ef.metrics if m.get("frame", -1) >= 0]
    lag = ef.mapper.count_lag
    assert lag == cfg.System.count_lag == 1
    for m in recs[:lag]:
        assert "render_frames" not in m
    for m in recs[lag:]:
        assert m["render_frames"] == 1 and m["render_frame"] == m["frame"] - lag
        assert set(RENDER_COUNTS) | {k + "_opt" for k in RENDER_COUNTS} <= set(m)
        assert 0 <= m["tail_entries"] <= m["binned_entries"] and 0 <= m["tail_entries_opt"] <= m["binned_entries_opt"]
    # frame 0 renders no model (nothing to render yet) but optimizes its window
    assert recs[lag]["binned_entries"] == 0 and recs[lag]["binned_entries_opt"] > 0
    assert all(m["binned_entries"] > 0 and m["max_run"] > 0 for m in recs[lag + 1:])
    read = lambda name: manifest.metric_reader(name)({"ef_metrics": recs})
    binned = sum(m["binned_entries"] + m["binned_entries_opt"] for m in recs[lag:])
    assert read("renderer.entries_per_frame") == pytest.approx(binned / (len(recs) - lag) / 1e6)
    tail = sum(m["tail_entries"] + m["tail_entries_opt"] for m in recs[lag:])
    assert read("renderer.tail_share") == pytest.approx(100.0 * tail / binned)
    # a program without the counters: nothing to read, nothing raised
    assert read("renderer.tail_share") is not None
    for name in ("renderer.tail_share", "renderer.entries_per_frame"):
        assert manifest.metric_reader(name)({"ef_metrics": [{"frame": 3, "readback_ms": 0.1}]}) is None


# ------------------------------------- (d) a last rung off the 8192 grid


def test_ladder_last_rung_off_the_grid_grows_and_shrinks(tmp_path):
    """A 50000-slot maximum: the ladder ends 32768, 49152, 50000. A map at
    49152 with too little spawn room grows into 50000 in the frame loop,
    whose programs it captures there; maintenance that leaves few surfels
    shrinks it back to 32768, the surviving surfels bit for bit."""
    assert capacity_ladder(50000) == [32768, 49152, 50000]
    assert capacity_ladder(3_000_000)[-4:] == [622592, 1245184, 2490368, 3_000_000]
    doc = small_profile(0.05, max_surfels=50000)
    cfg = port.config(doc)
    stream = stream_of(doc, tmp_path, seed=77)
    ef = EGGFusion(cfg, device="cpu", graphs=True)  # the programs' static buffers, as on CUDA
    ds = port.HostDataset(stream, cfg)
    ef.dataset = ds
    m = ef.mapper
    assert m.ladder.rungs == [32768, 49152, 50000]
    # after frame 0 the map moves to 49152 and fills to a watermark that
    # leaves too little spawn room
    ef.reconstruct(build_frame(ds, 0, False, "cpu", nlevel=ef.nlevel_frame, programs=ef.programs))
    m._move_to_rung(49152)
    s = m.surfels
    n0 = int(s.count)
    filler = random_map(49152 - n0 - 100, seed=5)
    for f in tsf.FIELDS:
        if f != "count":
            getattr(s, f)[..., n0:49152 - 100] = getattr(filler, f)
    s.count.fill_(49152 - 100)
    m.ladder.maintained(49152 - 100, m.time - 1, m.time, m.surfels.capacity, immediate=False)
    before = {f: getattr(s, f)[..., :49152 - 100].clone() for f in ("xyz", "rotation", "scaling", "opacity")}
    m.fit_capacity()
    assert m.surfels.capacity == 50000
    for f, t in before.items():
        assert same_bits(getattr(m.surfels, f)[..., :49152 - 100], t), f
    ef.reconstruct(build_frame(ds, 1, False, "cpu", nlevel=ef.nlevel_frame, programs=ef.programs))
    assert m.surfels.capacity == 50000 and 50000 in m._captured_rungs
    assert {e.rung for e in ef.programs.programs["map_update"].entries.values()} == {50000}
    # keep the first few hundred surfels: a compaction, then the rung that holds them
    keep = 300
    m.surfels.active[keep:] = False
    kept = {f: getattr(m.surfels, f)[..., :keep].clone() for f in ("xyz", "rotation", "features_dc")}
    m._maintain_decide(int(m.surfels.count), int(m.surfels.num_active()), m.time)
    assert m.surfels.capacity == 32768 and int(m.surfels.count) == keep
    for f, t in kept.items():
        assert same_bits(getattr(m.surfels, f)[..., :keep], t), f
    ef.reconstruct(build_frame(ds, 2, False, "cpu", nlevel=ef.nlevel_frame, programs=ef.programs))
    assert m.surfels.capacity == 32768


# ------------------------------------- the ground-truth pose's upload


def test_gt_pose_goes_through_the_staged_upload(monkeypatch):
    """`update_transform_gt` hands the pose to `utils/device.upload`, the
    frame's staged path, and commits the bytes the plain copy gives."""
    calls = []

    def fake_upload(a, device, dtype=None):
        buf = np.empty(a.shape, np.dtype(a.dtype if dtype is None else dtype))
        devutil.stage(a, buf)
        calls.append((a.shape, buf.dtype))
        return torch.from_numpy(buf)

    intr = CameraIntrinsics(fx=40.0, fy=40.0, cx=15.5, cy=11.5, width=32, height=24)
    gt = np.random.default_rng(3).normal(size=(4, 4)).astype(np.float64)
    f = Frame(uid=0, ts=0.0, color_u8=np.zeros((24, 32, 3), np.uint8), depth_raw=np.ones((24, 32), np.uint16),
              mask=np.ones((24, 32), bool), gt_pose_w2c=gt, intr=intr, depth_scale=1000.0, device="cpu")
    monkeypatch.setattr("eggfusion_tpu_torch.core.frame.upload", fake_upload)
    f.device = torch.device("cuda")  # the staged branch; `upload` stands in for the copy
    f.update_transform_gt()
    assert calls == [((4, 4), np.dtype(np.float32))]
    want = torch.as_tensor(np.asarray(gt, np.float32))
    assert same_bits(f.w2c_matrix(), want)
    f.update_transform_gt()  # committed once a frame: the tensor is kept
    assert len(calls) == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the staged upload copies from pinned memory on a CUDA stream")
    return torch.device("cuda")


@pytest.mark.cuda
def test_track_makes_no_synchronizing_call_under_only_mapping(card, tmp_path):
    """Under `System.only_mapping` every frame commits its ground-truth
    pose in `track`; at a third of the ScanNet++ size no frame of `track`
    synchronizes with the device once the staging ring is warm."""
    doc = small_profile(1.0 / 3.0)
    cfg = port.config(doc)
    traffic = dict(orbit(), period=16)
    stream = manifest.generator(traffic).make(doc["config"]["Dataset"]["Calibration"], traffic, 7, card,
                                              str(tmp_path))
    ef, ds, preload = port.system(cfg, stream, card)
    build, reconstruct = port.frame_fn(ef, ds, preload)
    ef.warmup()
    for k in range(3):
        reconstruct(build(k))
    torch.cuda.synchronize()
    for k in range(3, 9):
        f = build(k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ef.tracker.tracking(f, ef.model_map)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert same_bits(f.w2c_matrix().cpu(), torch.as_tensor(ds[k][4])), k
    torch.cuda.synchronize()
