"""The benchmark's one door into the program (`eggfusion_tpu_torch`): build
its configuration and system, hand it frames as `main.run`'s loop does, and
read back what it produced for the reference to judge."""
from __future__ import annotations

import copy

import numpy as np
import torch


def config(doc: dict, dataset_path: str | None = None):
    """The program's configuration from a configuration file's `config`
    (the merged yaml as run), with the recording's path when the traffic
    writes one."""
    from eggfusion_tpu_torch.config import Config

    plain = copy.deepcopy(doc["config"])
    if dataset_path is not None:
        plain["Dataset"]["dataset_path"] = dataset_path
    return Config.wrap(plain)


class HostDataset:
    """The dataset interface `main.build_frame` reads, over a stream's
    host-resident frames: `intrinsics`, `depth_scale`, and item k as
    (timestamp, uint8 color, uint16 depth, validity mask, w2c relative to
    frame 0's)."""

    def __init__(self, stream, cfg):
        from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics

        self.stream = stream
        self.intrinsics = CameraIntrinsics.from_calibration(cfg.Dataset.Calibration)
        self.depth_scale = float(cfg.Dataset.Calibration.depth_scale)
        t = cfg.get("Tracking", {})
        self.frame_nlevel = int(t.get("pyramid_level", 3)) + (int(t.get("model_view_down", 1)).bit_length() - 1)
        self.bilateral_mode = str(cfg.get("System", {}).get("bilateral_mode", "exact"))
        H, W = stream.color.shape[1:3]
        self.mask = np.ones((H, W, 1), bool)
        self._pivot_inv = np.linalg.inv(stream.gt_w2c[stream.unique(0)])

    def __getitem__(self, k: int):
        u = self.stream.unique(k)
        gt = (self.stream.gt_w2c[u] @ self._pivot_inv).astype(np.float32)
        return self.stream.timestamp(k), self.stream.color[u], self.stream.depth[u], self.mask, gt

    def __len__(self) -> int:
        return 1 << 30


def system(cfg, stream, device):
    """(EGGFusion, dataset, preload): the system with its dataset set, the
    way `main.run` builds them. A stream of host frames is read through
    `HostDataset`; a recording through the program's own loader (which,
    under `Dataset.preload`, starts its prefetch thread)."""
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.system import EGGFusion

    ef = EGGFusion(cfg, device=device)
    if stream.path is None:
        ds, preload = HostDataset(stream, cfg), False
    else:
        ds, preload = load_dataset(cfg, ef.device), bool(cfg.Dataset.get("preload", True))
    ef.dataset = ds
    return ef, ds, preload


def frame_fn(ef, ds, preload: bool):
    """`frame(k)`: build stream frame k (`main.build_frame`) and reconstruct
    it; returns the frame."""
    from eggfusion_tpu_torch.main import build_frame

    def build(k: int):
        return build_frame(ds, k, preload, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs)

    return build, ef.reconstruct


def outputs(ef) -> dict:
    """What the run produced, as plain tensors: every frame's estimated
    w2c (N, 4, 4) float64 and the active surfels' centres (M, 3)."""
    est = []
    for m in ef.traj["est"]:
        if isinstance(m, np.ndarray):  # a host c2w (never in a plain run)
            est.append(torch.as_tensor(np.linalg.inv(m)))
        else:
            est.append(m.detach().to("cpu", torch.float64))
    s = ef.mapper.surfels
    return {"est_w2c": torch.stack(est).numpy(), "xyz": s.xyz.detach()[:, s.active.bool()].T.contiguous()}


def model_view(ef) -> dict:
    """A copy of the current model view, on the device (no host sync):
    depth (H, W), color (H, W, 3), the mask of pixels taken from the
    render, and the w2c pose (4, 4) it was rendered at."""
    mm = ef.model_map
    return {
        "view_depth": mm["rendered_depth"][..., 0].detach().clone(),
        "view_color": mm["rendered_color"].detach().clone(),
        "view_mask": mm["mask"].detach().clone(),
        "view_w2c": mm["transform"].detach().clone(),
    }
