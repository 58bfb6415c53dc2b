"""RGB-D datasets (port of `eggfusion_tpu/data/datasets.py`): TUM RGB-D,
Replica, ScanNet++ and Azure Kinect recordings on disk, a live Azure Kinect
camera (`pyk4a`), and the synthetic sequence.

The on-disk datasets share `RGBDDataset`: the calibration, the
undistortion map of the radial-tangential lens model with its validity
mask, and a prefetch thread (`start_prefetch` / `get_buffer_frame`) that
decodes and undistorts frames while the device works. Parsers keep the
JAX module's semantics: TUM timestamp association (`max_dt` 0.08 s, culled
to 32 fps), poses re-based so that frame 0 is the identity (the `pivot`
keeps frame 0's pose), the ScanNet++ train / test lists, `is_bad` frames
and axis flip. Color is remapped bilinearly (`native/frame_loader.cpp`),
depth at the nearest source pixel. PNG is read by `io.png`; JPEG (the
color of Replica, ScanNet++ and Azure Kinect) needs Pillow. Frames whose
size differs from the calibration (ScanNet++, Azure Kinect) are resized as
`cv2.resize` does: linear for color, nearest for depth.

The synthetic sequence renders its frames up front on the dataset's
device, or on demand with `Dataset.lazy_device`. With
`Dataset.device_frames` they stay there as float color / metric depth;
otherwise they round-trip through uint8 color and host depth, as the JAX
dataset does. `Dataset.noise` applies the host-side sensor noise model to
each generated frame. Its buffered reader (`get_buffer_frame`) returns
frames in order from the calling thread.
"""
from __future__ import annotations

import glob
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from eggfusion_tpu_torch.data import synthetic as syn
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.io.png import read_png
from eggfusion_tpu_torch.native import loader as nloader


def build_undistort_map(K: np.ndarray, dist: np.ndarray, width: int, height: int):
    """(mapx, mapy) float32 (H, W): the source pixel in the distorted image
    of each undistorted pixel, through the radial-tangential (k1, k2, p1,
    p2, k3) model (cv2.initUndistortRectifyMap with R = I, P = K)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = [float(d) for d in dist[:5]]
    ys, xs = np.meshgrid(np.arange(height, dtype=np.float64), np.arange(width, dtype=np.float64), indexing="ij")
    x = (xs - cx) / fx
    y = (ys - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return (xd * fx + cx).astype(np.float32), (yd * fy + cy).astype(np.float32)


def remap_nearest(img: np.ndarray, xymap) -> np.ndarray:
    """`img` sampled at the nearest pixel of each (mapx, mapy); samples
    outside the image are 0 (invalid depth)."""
    mapx, mapy = xymap
    H, W = img.shape[:2]
    xi = np.rint(mapx).astype(np.int64)
    yi = np.rint(mapy).astype(np.int64)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
    return np.where(ok, out, 0).astype(img.dtype)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize with pixel centres aligned (cv2.INTER_LINEAR);
    integer images are rounded to the nearest value."""
    h, w = img.shape[:2]

    def axis(n_out, n_in):
        x = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1)
        x0 = np.floor(x).astype(np.int64)
        return x0, np.minimum(x0 + 1, n_in - 1), (x - x0).astype(np.float32)

    y0, y1, ay = axis(height, h)
    x0, x1, ax = axis(width, w)
    f = img.astype(np.float32)
    if img.ndim == 3:
        ax = ax[:, None]
    ay = ay[:, None, None] if img.ndim == 3 else ay[:, None]
    top = f[y0][:, x0] * (1 - ax) + f[y0][:, x1] * ax
    bot = f[y1][:, x0] * (1 - ax) + f[y1][:, x1] * ax
    out = top * (1 - ay) + bot * ay
    if np.issubdtype(img.dtype, np.integer):
        out = np.floor(out + 0.5)
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest resize as cv2.INTER_NEAREST: source index floor(i * in / out)."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    return img[ys][:, xs]


def read_image(path: str) -> np.ndarray:
    """A dataset image as `np.array(PIL.Image.open(path))` gives it: PNG
    through `io.png`, anything else (JPEG) through Pillow."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"reading {path} needs Pillow (the PIL package), which is not installed") from e
    with Image.open(path) as im:
        return np.array(im)


class RGBDDataset:
    """An RGB-D recording on disk: calibration, undistortion and a prefetch
    thread. Items are (timestamp, color (H, W, 3) uint8, raw depth (H, W),
    validity mask (H, W, 1) bool, ground-truth w2c (4, 4))."""

    def __init__(self, config):
        calib = config.Dataset.Calibration
        self.intrinsics = CameraIntrinsics.from_calibration(calib)
        self.depth_scale = float(calib.depth_scale)
        K = np.array([[calib.fx, 0, calib.cx], [0, calib.fy, calib.cy], [0, 0, 1]], np.float64)
        dist = np.array([calib.get(k, 0.0) for k in ("k1", "k2", "p1", "p2", "k3")], np.float64)
        W, H = self.intrinsics.width, self.intrinsics.height
        self.distorted = bool(np.any(dist != 0))
        if self.distorted:
            self.xymap = build_undistort_map(K, dist, W, H)
            self.mask = ((self.xymap[0] > 0) & (self.xymap[1] > 0) & (self.xymap[0] < W)
                         & (self.xymap[1] < H))
        else:
            self.xymap = None
            self.mask = np.ones((H, W), bool)
        self.pivot = np.eye(4)
        self.color_paths: list = []
        self.depth_paths: list = []
        self.poses: list = []
        self.ts: list = []
        self.n_imgs = 0
        self._queue: queue.Queue | None = None
        self.prefetch_ms: list[float] = []  # host ms of each prefetched item: decode + undistortion

    def start_prefetch(self, buffer_size: int = 8) -> None:
        """Read the items in order on a daemon thread, `buffer_size` ahead
        of `get_buffer_frame`; a failed read is raised there."""
        self._queue = queue.Queue(maxsize=buffer_size)

        def worker():
            for i in range(self.n_imgs):
                t0 = time.perf_counter()
                try:
                    item = self[i]
                except Exception as e:  # handed to the consumer, which raises it
                    self._queue.put(e)
                    return
                self.prefetch_ms.append((time.perf_counter() - t0) * 1e3)
                self._queue.put(item)

        threading.Thread(target=worker, daemon=True).start()

    def get_buffer_frame(self):
        if self._queue is None:
            raise RuntimeError("call start_prefetch() first")
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def __getitem__(self, idx: int):
        color = read_image(self.color_paths[idx])
        depth = read_image(self.depth_paths[idx])
        if self.xymap is not None:
            # depth is undistorted too, at the nearest source pixel:
            # interpolated depth would invent geometry across edges
            color = nloader.remap(color, *self.xymap)
            depth = remap_nearest(depth, self.xymap)
        return self.ts[idx], color, depth, self.mask[..., None], self.poses[idx]

    def __len__(self) -> int:
        return self.n_imgs

    def _rebase(self) -> None:
        """Poses relative to frame 0's (which becomes the identity)."""
        init_w2c = self.poses[0]
        self.poses = [p @ np.linalg.inv(init_w2c) for p in self.poses]
        self.pivot = init_w2c


class TUMDataset(RGBDDataset):
    """TUM RGB-D: `rgb.txt`, `depth.txt` and `groundtruth.txt` (timestamp,
    translation, quaternion x y z w of c2w)."""

    def __init__(self, config):
        super().__init__(config)
        from scipy.spatial.transform import Rotation

        root = config.Dataset.dataset_path
        image_data = np.loadtxt(os.path.join(root, "rgb.txt"), delimiter=" ", dtype=np.str_)
        depth_data = np.loadtxt(os.path.join(root, "depth.txt"), delimiter=" ", dtype=np.str_)
        pose_data = np.loadtxt(os.path.join(root, "groundtruth.txt"), delimiter=" ", dtype=np.str_,
                               skiprows=1).astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_dep = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_dep, t_pose)
        keep = [0]  # cull to 32 fps
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / 32:
                keep.append(i)
        for ix in keep:
            i, j, k = assoc[ix]
            self.color_paths.append(os.path.join(root, image_data[i, 1]))
            self.depth_paths.append(os.path.join(root, depth_data[j, 1]))
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(pose_data[k, 4:]).as_matrix()
            c2w[:3, 3] = pose_data[k, 1:4]
            self.poses.append(np.linalg.inv(c2w))
            self.ts.append(t_img[i])
        self._rebase()
        self.n_imgs = len(self.color_paths)

    @staticmethod
    def _associate(t_img, t_dep, t_pose, max_dt: float = 0.08):
        """(image, depth, pose) index triples whose nearest depth and pose
        lie within `max_dt` seconds of the image."""
        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_dep - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_dep[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc


class ReplicaDataset(RGBDDataset):
    """Replica: `results/frame*.jpg`, `results/depth*.png`, `traj.txt`
    (one c2w row-major per line)."""

    def __init__(self, config):
        super().__init__(config)
        root = config.Dataset.dataset_path
        self.color_paths = sorted(glob.glob(f"{root}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{root}/results/depth*.png"))
        with open(os.path.join(root, "traj.txt")) as f:
            lines = f.readlines()
        self.poses = [np.linalg.inv(np.array(list(map(float, l.split()))).reshape(4, 4)) for l in lines]
        self.poses = self.poses[: len(self.color_paths)]
        self._rebase()
        self.n_imgs = len(self.color_paths)
        self.ts = list(np.arange(self.n_imgs) * 0.05)


class ScanNetPPDataset(RGBDDataset):
    """ScanNet++ DSLR: `dslr/undistorted_images/*.JPG`,
    `dslr/undistorted_depths/*.png`, the nerfstudio transforms and
    `train_test_lists.json`; `test` selects the test split."""

    def __init__(self, config, test: bool = False):
        super().__init__(config)
        root = config.Dataset.dataset_path
        all_color = sorted(glob.glob(f"{root}/dslr/undistorted_images/*.JPG"))
        all_depth = sorted(glob.glob(f"{root}/dslr/undistorted_depths/*.png"))
        poses, ok = {}, {}
        with open(os.path.join(root, "dslr/nerfstudio", "transforms_undistorted.json")) as f:
            data = json.load(f)
        for item in data["frames"] + data.get("test_frames", []):
            key = os.path.splitext(os.path.basename(item["file_path"]))[0]
            poses[key] = np.array(item["transform_matrix"]).reshape(4, 4)
            ok[key] = not item.get("is_bad", False)
        with open(os.path.join(root, "dslr/train_test_lists.json")) as f:
            lists = json.load(f)
        names = sorted(os.path.splitext(os.path.basename(p))[0] for p in lists["test" if test else "train"])
        names = [n for n in names if ok.get(n, False)]
        # the axis flip of the ScanNet++ convention
        flip = np.array([[0, 1, 0, 0], [1, 0, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)
        for k in poses:
            v = poses[k].copy()
            v[:, 1:3] *= -1
            poses[k] = flip @ v
        sel = set(names)
        stem = lambda p: os.path.splitext(os.path.basename(p))[0]
        self.color_paths = [p for p in all_color if stem(p) in sel]
        self.depth_paths = [p for p in all_depth if stem(p) in sel]
        init_c2w = poses[names[0]]
        self.poses = [np.linalg.inv(poses[n]) @ init_c2w for n in names]
        self.pivot = np.linalg.inv(init_c2w)
        self.n_imgs = len(self.color_paths)
        self.ts = list(np.arange(self.n_imgs) * 0.05)

    def __getitem__(self, idx: int):
        ts, color, depth, mask, pose = super().__getitem__(idx)
        W, H = self.intrinsics.width, self.intrinsics.height
        if color.shape[0] != H:
            color, depth = resize_linear(color, W, H), resize_nearest(depth, W, H)
        return ts, color, depth, mask, pose


class AzureKinectDataset(RGBDDataset):
    """An Azure Kinect recording: `color/*.jpg`, `depth/*.png` (mm), no
    ground truth (identity poses)."""

    def __init__(self, config):
        super().__init__(config)
        root = config.Dataset.dataset_path
        self.color_paths = sorted(glob.glob(f"{root}/color/*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{root}/depth/*.png"))
        if len(self.color_paths) != len(self.depth_paths):
            raise ValueError(f"{root}: {len(self.color_paths)} color and {len(self.depth_paths)} depth images")
        self.n_imgs = len(self.color_paths)
        self.poses = [np.eye(4) for _ in range(self.n_imgs)]
        self.ts = list(np.arange(self.n_imgs) * 0.05)

    def __getitem__(self, idx: int):
        W, H = self.intrinsics.width, self.intrinsics.height
        color = read_image(self.color_paths[idx])
        depth = read_image(self.depth_paths[idx])
        if color.shape[:2] != (H, W):
            color = resize_linear(color, W, H)
        if depth.shape[:2] != (H, W):
            depth = resize_nearest(depth, W, H)
        return self.ts[idx], color, depth, np.ones((H, W, 1), bool), self.poses[idx]


class AzureKinectLive(RGBDDataset):
    """A live Azure Kinect camera (`Dataset.type: kinect_live`) through
    `pyk4a`, imported when the dataset is built (raises without it): 720p
    color, 2x2-binned wide depth mapped into the color camera, resized to
    the calibration's size (linear color, nearest depth); `max_frames`
    items (default 10000), no ground truth (identity poses)."""

    def __init__(self, config):
        try:
            import pyk4a
            from pyk4a import Config as K4AConfig, PyK4A
        except ImportError as e:
            raise RuntimeError("AzureKinectLive requires pyk4a") from e
        super().__init__(config)
        self.k4a = PyK4A(K4AConfig(
            color_resolution=pyk4a.ColorResolution.RES_720P,
            depth_mode=pyk4a.DepthMode.WFOV_2X2BINNED,
        ))
        self.k4a.start()
        self.n_imgs = int(config.Dataset.get("max_frames", 10_000))
        self.depth_scale = 1000.0

    def __getitem__(self, idx: int):
        W, H = self.intrinsics.width, self.intrinsics.height
        capture = self.k4a.get_capture()
        color = capture.color[:, :, 2::-1].copy()  # BGRA -> RGB
        ts = capture.color_timestamp_usec / 1e6
        color = resize_linear(color, W, H)
        depth = resize_nearest(capture.transformed_depth, W, H)
        return ts, color, depth, np.ones((H, W, 1), bool), np.eye(4)


class SyntheticDataset:
    """Analytic synthetic sequence with exact GT (see `data.synthetic`):
    `Dataset.trajectory` (sway, handheld, loop, orbit) drawn from
    `Dataset.seed`, `scene` (corner, room), `texture_detail`,
    `textureless_x` and `noise` (keyword arguments of
    `synthetic.apply_sensor_noise`, plus an ignored `enabled`)."""

    def __init__(self, config, device):
        self.device = torch.device(device)
        self.intrinsics = CameraIntrinsics.from_calibration(config.Dataset.Calibration)
        ds = config.Dataset
        n = int(ds.get("n_frames", 30))
        seed = int(ds.get("seed", 0))
        noise = dict(ds.get("noise", {}) or {})
        self.n_imgs = n
        self.poses = list(syn.TRAJECTORIES[str(ds.get("trajectory", "sway"))](n, seed))
        self.ts = list(np.arange(n) * 0.05)
        self.depth_scale = 1.0
        self._unique = min(n, int(ds.get("unique_frames", n)))
        self._render = dict(detail=float(ds.get("texture_detail", 0.0)),
                            flat_x=float(ds.get("textureless_x", 0.0)),
                            scene=str(ds.get("scene", "corner")), device=self.device)
        # lazy_device: render each frame on demand, on the device (noise is
        # not applied: it is a host-side model)
        self._lazy = bool(ds.get("lazy_device", False))
        self._device_frames = self._lazy or bool(ds.get("device_frames", False))
        self._frames = []
        for i in range(0 if self._lazy else self._unique):
            color, depth = syn.render_corner_scene(self.intrinsics, self.poses[i], **self._render)
            if noise:
                c, d = syn.apply_sensor_noise(
                    color.cpu().numpy(), depth.cpu().numpy(), seed=seed * 100003 + i,
                    **{k: float(v) for k, v in noise.items() if k != "enabled"})
                color, depth = torch.from_numpy(c).to(self.device), torch.from_numpy(d).to(self.device)
            if self._device_frames:
                self._frames.append((color, depth))
            else:
                self._frames.append(((color.cpu().numpy() * 255).astype(np.uint8),
                                     depth.cpu().numpy()[..., 0]))
        shape = (self.intrinsics.height, self.intrinsics.width, 1)
        self._mask = (torch.ones(shape, device=self.device) if self._device_frames
                      else np.ones(shape, bool))
        self._next = 0

    def __len__(self) -> int:
        return self.n_imgs

    def __getitem__(self, idx: int):
        pose = self.poses[idx % self._unique]
        if self._lazy:
            color, depth = syn.render_corner_scene(self.intrinsics, pose, **self._render)
        else:
            color, depth = self._frames[idx % self._unique]
        return self.ts[idx], color, depth, self._mask, pose

    def get_buffer_frame(self):
        """The next frame in sequence order."""
        item = self[self._next]
        self._next += 1
        return item


def load_dataset(config, device, test: bool = False):
    """The dataset `Dataset.type` names: tum, replica, scannetpp (`test`:
    its test split), azure, kinect_live or synthetic. Stamps the pyramid
    depth and the bilateral mode the frames need and, unless
    `Dataset.preload` is off, starts the prefetch of an on-disk dataset or
    camera."""
    kind = config.Dataset.type
    if kind == "synthetic":
        ds = SyntheticDataset(config, device)
    elif kind == "tum":
        ds = TUMDataset(config)
    elif kind == "replica":
        ds = ReplicaDataset(config)
    elif kind == "scannetpp":
        ds = ScanNetPPDataset(config, test)
    elif kind == "azure":
        ds = AzureKinectDataset(config)
    elif kind == "kinect_live":
        ds = AzureKinectLive(config)
    else:
        raise ValueError(f"Unknown dataset type: {kind}")
    # the frame pyramid's depth: extra levels when the model view renders
    # downsampled (Tracking.model_view_down; see core.tracker)
    t = config.get("Tracking", {})
    ds.frame_nlevel = int(t.get("pyramid_level", 3)) + (int(t.get("model_view_down", 1)).bit_length() - 1)
    ds.bilateral_mode = str(config.get("System", {}).get("bilateral_mode", "exact"))
    if isinstance(ds, RGBDDataset) and bool(config.Dataset.get("preload", True)):
        ds.start_prefetch()
    return ds
