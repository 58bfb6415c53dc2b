"""The port's RGB-D datasets, image files, frame-preparation kernels and
sparse seed against the JAX package's, and a TUM recording run end to end
by both packages.

Fixtures are written on the fly in the real layouts, as
`tests/test_dataset_fixtures.py` writes them (Pillow PNG / JPEG, 120x90,
the same calibration): TUM (radially distorted, jittered timestamps, an
unmatched image), Replica, ScanNet++ (train and test split) and Azure
Kinect.

Tolerances: every loader item (timestamp, color, depth, mask, pose) and the
pivot bit-equal; the port's PNG reader bit-equal to Pillow; remap and depth
conversion bit-equal to the JAX package's binding (the same C++); resizes
within one intensity level of `cv2.resize` (linear; nearest exact); sparse
seeds within 1e-6; end to end (both packages on the "xla" compositor, the
port replaying the JAX spawn draws), poses within 2e-6 m and 1e-4 deg and
the surfel count and map capacity of every frame identical;
`evaluate_render_dataset` on the ScanNet++ test split within 1e-6
relative.
"""
import functools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import eggfusion_tpu.core.renderer as j_renderer
import eggfusion_tpu.core.sparse_init as j_sparse_init
from eggfusion_tpu import config as jcfg
from eggfusion_tpu.data.datasets import load_dataset as j_load_dataset
from eggfusion_tpu.main import build_frame as j_build_frame
from eggfusion_tpu.native import loader as j_loader
from eggfusion_tpu.ops.raster_xla import render_xla as j_render_xla
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.convert import surfel_map_from_numpy
from eggfusion_tpu_torch.core import sparse_init as t_sparse_init
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.data import datasets as t_datasets
from eggfusion_tpu_torch.data import synthetic as tsyn
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.io import png as t_png
from eggfusion_tpu_torch.main import run as t_run
from eggfusion_tpu_torch.native import loader as t_loader
from eggfusion_tpu_torch.system import EGGFusion as TEGGFusion
from test_torch_system import JaxDraws

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 120, 90
FX, FY, CX, CY = 110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5
N_FRAMES = 6
K1 = 0.06  # the radial distortion of `tests/test_tum_composed.py`
SCALES = {"tum": 5000.0, "replica": 6553.5, "scannetpp": 1000.0, "azure": 1000.0}


def _save_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _save_jpg(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path, quality=98)


def _distort(img):
    """The image a camera with radial distortion K1 records (the inverse
    lens model by fixed-point iteration, bilinear sampling)."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    xd, yd = (xs - CX) / FX, (ys - CY) / FY
    xu, yu = xd.copy(), yd.copy()
    for _ in range(8):
        radial = 1.0 + K1 * (xu * xu + yu * yu)
        xu, yu = xd / radial, yd / radial
    sx, sy = np.clip(xu * FX + CX, 0, W - 1), np.clip(yu * FY + CY, 0, H - 1)
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    ax, ay = sx - x0, sy - y0
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    return ((img[y0, x0] * (1 - ax) + img[y0, x1] * ax) * (1 - ay)
            + (img[y1, x0] * (1 - ax) + img[y1, x1] * ax) * ay)


def _write_tum(root, colors, depths, poses):
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.default_rng(1)
    rgb, dep, gt = ["# color images"], ["# depth maps"], ["# ground truth trajectory"]
    for i in range(N_FRAMES):
        ts = 1305031100.0 + i * 0.0625 + rng.uniform(-0.005, 0.005)
        _save_png(root / "rgb" / f"{ts:.6f}.png", (np.clip(_distort(colors[i]), 0, 1) * 255).astype(np.uint8))
        d = np.round(np.clip(_distort(depths[i]), 0, None) * SCALES["tum"]).astype(np.uint16)
        _save_png(root / "depth" / f"{ts:.6f}.png", d)
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        dep.append(f"{ts + rng.uniform(0, 0.01):.6f} depth/{ts:.6f}.png")
        c2w = np.linalg.inv(poses[i])
        q, t = Rotation.from_matrix(c2w[:3, :3]).as_quat(), c2w[:3, 3]
        gt.append(f"{ts + 0.004:.6f} " + " ".join(f"{v:.7f}" for v in (*t, *q)))
    rgb.append(f"{ts + 0.5:.6f} rgb/unmatched.png")  # no depth or pose near it
    for name, lines in (("rgb", rgb), ("depth", dep), ("groundtruth", gt)):
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n")


def _write_replica(root, colors, depths, poses):
    (root / "results").mkdir(parents=True)
    for i in range(N_FRAMES):
        _save_jpg(root / "results" / f"frame{i:06d}.jpg", (colors[i] * 255).astype(np.uint8))
        _save_png(root / "results" / f"depth{i:06d}.png", np.round(depths[i] * SCALES["replica"]).astype(np.uint16))
    (root / "traj.txt").write_text("\n".join(" ".join(f"{v:.9f}" for v in np.linalg.inv(p).reshape(-1))
                                             for p in poses) + "\n")


def _write_scannetpp(root, colors, depths, poses):
    for d in ("dslr/undistorted_images", "dslr/undistorted_depths", "dslr/nerfstudio"):
        (root / d).mkdir(parents=True)
    flip = np.array([[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)
    entries, names = [], []
    for i in range(N_FRAMES):
        name = f"DSC{i:05d}"
        names.append(name)
        _save_jpg(root / "dslr/undistorted_images" / f"{name}.JPG", (colors[i] * 255).astype(np.uint8))
        _save_png(root / "dslr/undistorted_depths" / f"{name}.png",
                  np.round(depths[i] * SCALES["scannetpp"]).astype(np.uint16))
        v = flip @ np.linalg.inv(poses[i])
        v[:, 1:3] *= -1
        entries.append({"file_path": f"{name}.JPG", "transform_matrix": v.tolist(), "is_bad": i == 2})
    (root / "dslr/nerfstudio/transforms_undistorted.json").write_text(json.dumps({"frames": entries}))
    (root / "dslr/train_test_lists.json").write_text(json.dumps(
        {"train": [f"{n}.JPG" for n in names[:-2]], "test": [f"{n}.JPG" for n in names[-2:]]}))


def _write_azure(root, colors, depths, _poses):
    (root / "color").mkdir(parents=True)
    (root / "depth").mkdir()
    for i in range(N_FRAMES):
        _save_jpg(root / "color" / f"{i:06d}.jpg", (colors[i] * 255).astype(np.uint8))
        _save_png(root / "depth" / f"{i:06d}.png", np.round(depths[i] * SCALES["azure"]).astype(np.uint16))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The four recordings of one textured sway sequence."""
    tmp = tmp_path_factory.mktemp("datasets")
    intr = CameraIntrinsics(fx=FX, fy=FY, cx=CX, cy=CY, width=W, height=H)
    poses = tsyn.make_trajectory(N_FRAMES)
    colors, depths = [], []
    for p in poses:
        c, d = tsyn.render_corner_scene(intr, p, detail=0.35)
        colors.append(c.numpy())
        depths.append(d.numpy()[..., 0])
    for kind, write in (("tum", _write_tum), ("replica", _write_replica), ("scannetpp", _write_scannetpp),
                        ("azure", _write_azure)):
        write(tmp / kind, colors, depths, poses)
    return tmp


def _cfg(lib, tmp, kind, **sections):
    """`tests/test_dataset_fixtures.py`'s configuration of the recording
    `kind`, merged with `sections`."""
    calib = {"fx": FX, "fy": FY, "cx": CX, "cy": CY, "width": W, "height": H, "depth_scale": SCALES[kind]}
    if kind == "tum":
        calib.update(k1=K1, distorted=True)
    cfg = lib.default_config(
        Dataset={"type": kind, "dataset_path": str(tmp / kind), "preload": False, "Calibration": calib},
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 6, "local_map_iter": 2, "final_global_opt_iter": 2,
                 "sample_ratio": 0.05, "sample_ratio_init": 0.15},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
    )
    return lib.merge(cfg, sections)


# ---- loaders -----------------------------------------------------------------


@pytest.mark.parametrize("kind,test", [("tum", False), ("replica", False), ("scannetpp", False),
                                       ("scannetpp", True), ("azure", False)])
def test_loader_bit_equal(trees, kind, test):
    ds_j = j_load_dataset(_cfg(jcfg, trees, kind), test=test)
    ds_t = t_datasets.load_dataset(_cfg(tcfg, trees, kind), "cpu", test=test)
    assert len(ds_t) == len(ds_j) > 0
    np.testing.assert_array_equal(ds_t.pivot, ds_j.pivot)
    if kind == "tum":
        assert ds_t.distorted and ds_j._distorted and len(ds_t) == N_FRAMES  # the unmatched image dropped
        np.testing.assert_array_equal(ds_t.mask, ds_j.mask)
        assert 0.5 < ds_t.mask.mean() < 1.0
    if kind == "scannetpp":
        assert len(ds_t) == (2 if test else N_FRAMES - 3)  # `is_bad` frame 2 left out
    for i in range(len(ds_t)):
        for a, b in zip(ds_t[i], ds_j[i]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), (kind, i)
    # the prefetch thread hands out the same items, in order
    ds_p = t_datasets.load_dataset(tcfg.merge(_cfg(tcfg, trees, kind), {"Dataset": {"preload": True}}), "cpu",
                                   test=test)
    for i in range(len(ds_t)):
        assert all(np.array_equal(a, b) for a, b in zip(ds_p.get_buffer_frame(), ds_t[i]))
    assert len(ds_p.prefetch_ms) == len(ds_t)


def test_prefetch_raises_read_errors(trees, tmp_path):
    import shutil

    shutil.copytree(trees / "azure", tmp_path / "azure")
    (tmp_path / "azure" / "depth" / "000001.png").write_bytes(b"not a png")
    ds = t_datasets.load_dataset(tcfg.merge(_cfg(tcfg, tmp_path, "azure"), {"Dataset": {"preload": True}}), "cpu")
    ds.get_buffer_frame()
    with pytest.raises(ValueError, match="not a PNG"):
        ds.get_buffer_frame()


def test_unported_kinds_raise(trees, monkeypatch):
    """The live camera and the OpenCV frontend raise, as in JAX, when their
    library is missing (both are ported: `tests/test_torch_frontends.py`)."""
    import sys

    monkeypatch.setitem(sys.modules, "pyk4a", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="pyk4a"):
        t_datasets.load_dataset(tcfg.merge(_cfg(tcfg, trees, "azure"), {"Dataset": {"type": "kinect_live"}}), "cpu")
    with pytest.raises(RuntimeError, match="OpenCV"):
        t_sparse_init.SparseInitializer(tcfg.default_config(Tracking={"sparse_backend": "opencv"}))


def test_jpeg_needs_pillow(trees, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        t_datasets.read_image(str(trees / "azure" / "color" / "000000.jpg"))
    assert t_datasets.read_image(str(trees / "azure" / "depth" / "000000.png")).dtype == np.uint16


# ---- image files and frame-preparation kernels -----------------------------------


def _filtered_png(path, img: np.ndarray, bpp: int):
    """A PNG whose rows cycle through the five filter types (the inverse of
    the reader's unfiltering, written out from the spec)."""
    import struct
    import zlib

    h = img.shape[0]
    raw = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img  # 16-bit samples are big-endian
    rows = raw.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        ft = y % 5
        if ft == 0:
            pred = np.zeros_like(x)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(np.concatenate([[ft], (x - pred) % 256]).astype(np.uint8))
    depth, color = (16, 0) if img.dtype == np.uint16 else (8, {1: 0, 3: 2, 4: 6}[bpp])
    chunk = lambda k, b: struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))
    with open(path, "wb") as f:
        f.write(t_png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h, depth, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray16"])
def test_png_reader_matches_pillow(tmp_path, kind):
    from PIL import Image

    rng = np.random.default_rng(len(kind))
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = (np.stack([xx * 5, yy * 7, xx + yy, xx * yy], -1) % 256).astype(np.uint8)
    img = np.clip(smooth.astype(int) + rng.integers(-4, 5, smooth.shape), 0, 255).astype(np.uint8)
    img = {"rgb": img[..., :3], "rgba": img, "gray": img[..., 0],
           "gray16": (xx * 1201 + yy * 37 + rng.integers(0, 9, xx.shape)).astype(np.uint16)}[kind]
    bpp = {"rgb": 3, "rgba": 4, "gray": 1, "gray16": 2}[kind]
    files = {"pillow": tmp_path / "pil.png", "filters": tmp_path / "filt.png", "port": tmp_path / "port.png"}
    Image.fromarray(img).save(files["pillow"])  # Pillow picks a filter per row
    _filtered_png(files["filters"], img, bpp)
    t_png.write_png(files["port"], img)
    for name, path in files.items():
        want = np.array(Image.open(path))
        got = t_png.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, img, err_msg=name)


def test_png_rejects_bad_files(tmp_path):
    path = tmp_path / "a.png"
    t_png.write_png(path, np.zeros((4, 5, 3), np.uint8))
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF  # inside the IDAT chunk: its CRC no longer matches
    (tmp_path / "b.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        t_png.read_png(tmp_path / "b.png")
    with pytest.raises(ValueError, match="write_png takes"):
        t_png.write_png(tmp_path / "c.png", np.zeros((4, 5, 3), np.uint16))


def test_remap_and_depth_convert_bit_equal(trees):
    ds = t_datasets.load_dataset(_cfg(tcfg, trees, "tum"), "cpu")
    mapx, mapy = ds.xymap
    rng = np.random.default_rng(0)
    color = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 30000, (H, W), dtype=np.uint16)
    f32 = rng.normal(size=(H, W, 2)).astype(np.float32)
    for src in (color, color[..., 0], f32):
        a, b = t_loader.remap(src, mapx, mapy), j_loader.remap(src, mapx, mapy)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for maps in ((None, None), (mapx, mapy)):
        kw = dict(mapx=maps[0], mapy=maps[1], min_m=0.1, max_m=5.0)
        a, b = t_loader.depth_to_metric(depth, 5000.0, **kw), j_loader.depth_to_metric(depth, 5000.0, **kw)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("size", [(68, 100), (135, 181), (480, 640)])
def test_resize_matches_cv2(size):
    import cv2

    rng = np.random.default_rng(size[0])
    color = rng.integers(0, 256, (H * 3, W * 3, 3), dtype=np.uint8)
    depth = rng.integers(0, 60000, (H * 3, W * 3), dtype=np.uint16)
    h, w = size
    want = cv2.resize(color, (w, h), interpolation=cv2.INTER_LINEAR).astype(int)
    got = t_datasets.resize_linear(color, w, h)
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want).max() <= 1  # cv2 rounds fixed point
    np.testing.assert_array_equal(t_datasets.resize_nearest(depth, w, h),
                                  cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST))


# ---- sparse seed -------------------------------------------------------------


def _frames_for_sparse(ds, lib):
    """Frame stand-ins holding what the frontend reads, with identical
    values for both packages; frame 0 carries its ground-truth pose."""
    out = []
    for i in range(len(ds)):
        _ts, color, depth, _m, pose = ds[i]
        gray = (color.astype(np.float32) @ np.float32([0.114, 0.587, 0.299]) / 255.0)[..., None]
        dep = (depth.astype(np.float32) / SCALES["tum"])[..., None]
        w2c = np.asarray(pose, np.float32) if i == 0 else None
        conv = (lambda x: x) if lib == "jax" else torch.from_numpy
        out.append(SimpleNamespace(pyramid=[SimpleNamespace(intensity=conv(gray))], depth=conv(dep),
                                   _w2c=None if w2c is None else conv(w2c),
                                   w2c_matrix=(lambda w=w2c: conv(w))))
    return out


def test_sparse_seeds(trees):
    cfg_j = _cfg(jcfg, trees, "tum", Tracking={"fast_threshold": 8, "orb_min_matches": 12})
    cfg_t = _cfg(tcfg, trees, "tum", Tracking={"fast_threshold": 8, "orb_min_matches": 12})
    ds = t_datasets.load_dataset(cfg_t, "cpu")
    init_j = j_sparse_init.NativeSparseInitializer(cfg_j)
    init_t = t_sparse_init.SparseInitializer(cfg_t)
    n_seeds = 0
    for fj, ft in zip(_frames_for_sparse(ds, "jax"), _frames_for_sparse(ds, "torch")):
        a, b = init_t.track(ft), init_j.track(fj)
        assert (a is None) == (b is None)
        if a is not None:
            n_seeds += 1
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        np.testing.assert_allclose(init_t.prev[3], init_j.prev[3], atol=1e-6, rtol=0)
    assert n_seeds >= N_FRAMES - 2


# ---- end to end ----------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(trees):
    """Both packages on the TUM recording: `use_sparse`, the capacity
    ladder on (JAX's default), the frontend's image and seed of every
    frame recorded."""
    sections = dict(Tracking={"use_sparse": True, "fast_threshold": 8, "orb_min_matches": 12},
                    Mapping={"local_map_iter_init": 2},
                    System={"render_backend": "xla", "save_dir": str(trees / "run_torch"), "final_global_opt": False,
                            "eval_tracking": False, "eval_render": False, "eval_recon": False})
    seen = {"jax": [], "torch": []}

    def spy(cls, key, gray):
        track = cls.track

        def wrapped(self, frame):
            seed = track(self, frame)
            seen[key].append((gray(frame), seed))
            return seed
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        # the JAX compositor scans 8 surfels per step (as `tests/test_torch_system.py`)
        mp.setattr(j_renderer, "render_xla", functools.partial(j_render_xla, chunk=8))
        mp.setattr(j_sparse_init.NativeSparseInitializer, "track",
                   spy(j_sparse_init.NativeSparseInitializer, "jax",
                       lambda f: (np.asarray(f.pyramid[0].intensity)[..., 0] * 255).astype(np.uint8)))
        mp.setattr(t_sparse_init.NativeSparseInitializer, "track",
                   spy(t_sparse_init.NativeSparseInitializer, "torch", t_sparse_init.NativeSparseInitializer.gray_u8))
        cfg_j = _cfg(jcfg, trees, "tum", **sections)
        ef_j = JEGGFusion(cfg_j)
        ds_j = j_load_dataset(cfg_j)
        caps_j = []
        for fid in range(len(ds_j)):
            ef_j.reconstruct(j_build_frame(ds_j, fid, False))
            caps_j.append((ef_j.mapper.surfels.capacity, int(ef_j.metrics[-1]["surfels"])))
        ef_t = t_run(_cfg(tcfg, trees, "tum", Dataset={"preload": True}, **sections), device="cpu",
                     random_source=JaxDraws())
    caps_t = [(m["capacity"], int(m["surfels"])) for m in ef_t.metrics if m["frame"] >= 0]
    return ef_j, ef_t, caps_j, caps_t, seen


def test_tum_poses(runs):
    ef_j, ef_t, _, _, _ = runs
    a, b = ef_j._traj_np("est"), ef_t._traj_np("est")
    assert a.shape == b.shape == (N_FRAMES, 4, 4)
    np.testing.assert_array_equal(ef_t._traj_np("ref"), ef_j._traj_np("ref"))
    assert np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max() < 2e-6
    rel = np.einsum("nij,nkj->nik", a[:, :3, :3], b[:, :3, :3])
    assert np.degrees(Rotation.from_matrix(rel).magnitude()).max() < 1e-4


def test_tum_counts_and_capacity(runs):
    ef_j, ef_t, caps_j, caps_t, _ = runs
    assert ef_t.mapper.ladder.bucketing and ef_j.mapper.bucketing
    assert caps_t == caps_j
    assert ef_t.mapper.opt_steps_total == ef_j.mapper.opt_steps_total


def test_tum_sparse_frontend(runs):
    """The frontend read the same bytes and seeded the same frames."""
    ef_j, ef_t, _, _, seen = runs
    assert len(seen["torch"]) == len(seen["jax"]) == N_FRAMES
    for (g_t, s_t), (g_j, s_j) in zip(seen["torch"], seen["jax"]):
        assert g_t.tobytes() == g_j.tobytes()
        assert (s_t is None) == (s_j is None)
        if s_t is not None:
            np.testing.assert_allclose(s_t, s_j, atol=1e-6, rtol=0)
    assert ef_t.tracker.sparse_seeds == ef_j.tracker.sparse_seeds >= N_FRAMES // 2


def test_evaluate_render_dataset(runs, trees):
    """Both packages score the same map on the ScanNet++ test split, its
    poses re-based into the train split's world."""
    surfels = runs[0].mapper.surfels
    cfg_t = _cfg(tcfg, trees, "scannetpp", System={"render_backend": "xla", "save_dir": str(trees / "eval_t")})
    cfg_j = _cfg(jcfg, trees, "scannetpp", System={"render_backend": "xla", "save_dir": str(trees / "eval_j")})
    ef_t = TEGGFusion(cfg_t, device="cpu")
    ef_t.mapper.surfels = surfel_map_from_numpy({f: np.asarray(getattr(surfels, f)) for f in tsf.FIELDS}, "cpu")
    train = t_datasets.load_dataset(cfg_t, "cpu")
    rep_t = ef_t.evaluate_render_dataset(t_datasets.load_dataset(cfg_t, "cpu", test=True), train_pivot=train.pivot)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_renderer, "render_xla", functools.partial(j_render_xla, chunk=8))
        ef_j = JEGGFusion(cfg_j)
        ef_j.mapper.surfels = surfels
        rep_j = ef_j.evaluate_render_dataset(j_load_dataset(cfg_j, test=True), train_pivot=train.pivot)
    assert rep_t["n_frames"] == rep_j["n_frames"] == 2
    for k in ("psnr", "ssim", "depth_l1"):
        assert rep_t["mean"][k] == pytest.approx(rep_j["mean"][k], rel=1e-6), k
        for r_t, r_j in zip(rep_t["per_frame"], rep_j["per_frame"]):
            assert r_t[k] == pytest.approx(r_j[k], rel=1e-6), k
    with open(os.path.join(ef_t.save_dir, "render_metrics_testsplit.json")) as f:
        assert json.load(f)["n_frames"] == 2


def test_only_mapping_takes_ground_truth(trees):
    """ScanNet++'s `System.only_mapping`: every frame takes its ground-truth
    pose, as in the JAX package."""
    cfg = _cfg(tcfg, trees, "scannetpp", Mapping={"local_map_iter_init": 2, "local_map_iter": 1},
               System={"render_backend": "xla", "only_mapping": True, "save_dir": str(trees / "om"),
                       "final_global_opt": False, "eval_render": False, "eval_recon": False})
    ef = t_run(cfg, device="cpu", max_frames=3)
    np.testing.assert_allclose(ef._traj_np("est"), ef._traj_np("ref"), atol=1e-6)
    assert int(ef.mapper.surfels.num_active()) > 100
