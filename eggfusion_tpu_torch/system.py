"""System orchestrator: the per-frame reconstruct pipeline (port of
`eggfusion_tpu/system.py`, in part).

reconstruct(frame) = track -> preprocess -> map -> postprocess ->
trajectory bookkeeping. Ported: `preprocess_frame_map`,
`postprocess_model_map`, and from `EGGFusion` the constructor,
`reconstruct`, `preprocess`, `postprocess`, the trajectory bookkeeping and
`evaluate_trajectory` (ATE, trajectory text files). Not ported: tracking
recovery (a run that would need it raises), `finish` (global optimization,
PLY and checkpoint export), resume/reload and the render/recon evaluations.
"""
from __future__ import annotations

import os
import time as _time

import numpy as np
import torch

from eggfusion_tpu_torch.core import surfels as sf
from eggfusion_tpu_torch.core.mapper import Mapping
from eggfusion_tpu_torch.core.renderer import Renderer
from eggfusion_tpu_torch.core.tracker import Tracker
from eggfusion_tpu_torch.geometry import transforms as tf
from eggfusion_tpu_torch.ops import image as imops
from eggfusion_tpu_torch.ops.pyramid import build_pyramid
from eggfusion_tpu_torch.utils import eval as evalu
from eggfusion_tpu_torch.utils.device import resolve_device


def preprocess_frame_map(color, depth, vmap, nmap, mask, intr, w2c, reco_normal_thres: float):
    """Build the frame_map: depth-gradient edge mask, grazing-angle mask,
    invalid zeroing, radial confidence, world-frame maps."""
    c2w = torch.linalg.inv_ex(w2c)[0]
    gx, gy = imops.diff_gradients(depth)
    edge_mask = torch.sqrt(gx**2 + gy**2) > 0.1
    similarity = tf.compute_incident_angle(nmap, intr)[..., 0]
    normal_mask = similarity < torch.sin(torch.deg2rad(torch.tensor(float(reco_normal_thres))))
    inf_mask = torch.any(torch.isinf(nmap), dim=-1)
    invalid = normal_mask | torch.all(nmap == 0, dim=-1) | edge_mask | inf_mask
    inv3 = invalid[..., None]
    depth = torch.where(inv3, torch.zeros_like(depth), depth)
    nmap = torch.where(inv3, torch.zeros_like(nmap), nmap)
    vmap = torch.where(inv3, torch.zeros_like(vmap), vmap)
    H, W = depth.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                            torch.arange(W, dtype=torch.float32, device=depth.device), indexing="ij")
    conf = tf.compute_confidence(torch.stack([xs, ys], dim=-1), intr[2:4], 400.0, 0.72)
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    return {
        "color_map": color,
        "depth_map": depth,
        "vertex_map_c": vmap,
        "normal_map_c": nmap,
        "confidence_map": conf,
        "rgb_mask": mask > 0.5,
        "geo_mask": ~inv3,
        "vertex_map_w": tf.transform_map(vmap, R, t),
        "normal_map_w": tf.transform_map(nmap, R, torch.zeros_like(t)),
    }


def postprocess_model_map(rendered: dict, frame_map: dict, intr, w2c, reco_normal_thres: float,
                          reco_depth_thres: float, reco_opacity_thres: float, depth_min: float,
                          depth_max: float, nlevel: int, bilateral: str = "exact"):
    """Consistency masks + fill-in from the frame + the next frame's
    tracking pyramid."""
    n1 = frame_map["normal_map_c"]
    n2 = rendered["render_normal"]
    cos = torch.sum(n1 * n2, dim=-1) / (
        torch.linalg.vector_norm(n1, dim=-1) * torch.linalg.vector_norm(n2, dim=-1) + 1e-8)
    angle = torch.rad2deg(torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7)))
    normal_mask = angle < reco_normal_thres
    d1 = frame_map["depth_map"]
    d2 = rendered["render_depth"]
    depth_range = (d2 > depth_min) & (d2 < depth_max)
    depth_mask = (torch.abs(d1 - d2) < reco_depth_thres) & frame_map["geo_mask"] & depth_range
    opacity_mask = rendered["render_opacity"][..., 0] > reco_opacity_thres
    valid = normal_mask & depth_mask[..., 0] & opacity_mask
    color = torch.where(valid[..., None], rendered["render_color"], frame_map["color_map"])
    depth = torch.where(valid[..., None], rendered["render_depth"], frame_map["depth_map"])
    pyramid = build_pyramid(color, depth, opacity_mask[..., None].to(torch.float32), intr,
                            nlevel=nlevel, bilateral=bilateral)
    return {
        "rendered_color": color,
        "rendered_depth": depth,
        "mask": valid,
        "opacity_mask": opacity_mask,
        "transform": w2c,
        "pyramid": pyramid,
    }


class EGGFusion:
    """The SLAM system. `device` None means CUDA (raises without a GPU);
    `random_source` replaces the mapper's random draws (see
    `core.mapper.RandomSource`)."""

    def __init__(self, cfg, device=None, random_source=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.renderer = Renderer(cfg, self.device)
        self.tracker = Tracker(cfg, self.device)
        self.mapper = Mapping(cfg, self.renderer, self.device, random_source=random_source)
        self.frame_map = None
        self.model_map = None
        s = cfg.System
        self.save_dir = s.get("save_dir", "") or "results/run"
        self.reco_normal_thres = float(s.reco_normal_threshold)
        self.reco_depth_thres = float(s.reco_depth_threshold)
        self.reco_opacity_thres = float(s.reco_opacity_threshold)
        self.depth_range_min = float(s.depth_range_min)
        self.depth_range_max = float(s.depth_range_max)
        self.nlevel = int(cfg.Tracking.pyramid_level)
        self.bilateral = str(s.get("bilateral_mode", "exact"))
        self.traj = {"ts": [], "ref": [], "est": []}
        self.metrics = []

    # ---- per-frame pipeline -------------------------------------------------

    def reconstruct(self, frame) -> None:
        t0 = _time.perf_counter()
        if self.model_map is not None and self.tracker.needs_recovery():
            raise RuntimeError(
                f"tracking failed {self.tracker._fail_streak} frames in a row at frame {frame.uid}; "
                "tracking recovery is not ported (Tracking.recover_after 0 disables the check)")
        self.tracker.tracking(frame, self.model_map)
        t1 = _time.perf_counter()
        self.preprocess(frame)
        model_map = self.mapper.mapping(
            frame, self.frame_map,
            fail_streak=max(self.tracker._fail_streak, self.tracker.chronic_fails))
        t2 = _time.perf_counter()
        if model_map is not None:
            self.model_map = model_map
        else:
            # optimization frame: render AFTER the window optimization
            self.postprocess(frame)
        t3 = _time.perf_counter()
        self.append_trajectory(frame)
        rec = {
            "frame": frame.uid,
            "track_ms": (t1 - t0) * 1e3,
            "map_ms": (t2 - t1) * 1e3,
            "post_ms": (t3 - t2) * 1e3,
            "surfels": self.mapper.surfels.num_active(),  # device scalar, read lazily
            "opt_steps": self.mapper.opt_steps_total,
        }
        fs = self.mapper.fusion_stats
        if fs:
            t_last = next(reversed(fs))
            rec["stats_frame"] = t_last
            rec["fused_px"], rec["error_px"] = fs[t_last]
        ol = self.mapper.opt_losses
        if ol:
            t_loss = next(reversed(ol))
            rec["opt_loss_frame"] = t_loss
            rec["opt_loss"] = ol[t_loss]
        self.metrics.append(rec)

    def preprocess(self, frame) -> None:
        p0 = frame.pyramid[0]
        self.frame_map = preprocess_frame_map(
            frame.color, frame.depth, p0.vertex, p0.normal, frame.mask, frame.intr,
            frame.w2c_matrix(), self.reco_normal_thres)

    def postprocess(self, frame) -> None:
        """Render the model at the frame's pose and build the next tracking
        model map."""
        with torch.no_grad():
            out = self.renderer.render_at(sf.render_params(self.mapper.surfels), frame.w2c_matrix(),
                                          frame.intr, frame.width, frame.height, need_grad=False)
            rendered = {"render_color": out["color"], "render_depth": out["depth"],
                        "render_normal": out["normal"], "render_opacity": out["opacity"]}
            self.model_map = postprocess_model_map(
                rendered, self.frame_map, frame.intr, frame.w2c_matrix(), self.reco_normal_thres,
                self.reco_depth_thres, self.reco_opacity_thres, self.depth_range_min,
                self.depth_range_max, self.nlevel, bilateral=self.bilateral)

    def append_trajectory(self, frame) -> None:
        # the estimate stays a device handle; `_traj_np` converts in bulk
        self.traj["ts"].append(frame.ts)
        self.traj["ref"].append(np.linalg.inv(frame.gt_w2c))
        self.traj["est"].append(frame.w2c_matrix())

    def _traj_np(self, key: str) -> np.ndarray:
        """A trajectory as host c2w matrices (N, 4, 4)."""
        entries = self.traj[key]
        if not entries:
            return np.zeros((0, 4, 4), np.float32)
        idx_dev = [i for i, m in enumerate(entries) if not isinstance(m, np.ndarray)]
        if idx_dev:
            conv = np.linalg.inv(torch.stack([entries[i] for i in idx_dev]).cpu().numpy())
            for j, i in enumerate(idx_dev):
                entries[i] = conv[j]
        return np.stack(entries).astype(np.float32)

    def evaluate_trajectory(self) -> float:
        """ATE RMSE (cm) of the whole run; writes the reference and estimated
        trajectories (N x 16 rows) under `save_dir`."""
        os.makedirs(self.save_dir, exist_ok=True)
        ref = self._traj_np("ref")
        est = self._traj_np("est")
        np.savetxt(os.path.join(self.save_dir, "trajectory_ref.txt"), ref.reshape(-1, 16))
        np.savetxt(os.path.join(self.save_dir, "trajectory_est.txt"), est.reshape(-1, 16))
        ate = float(evalu.cumulative_ate(ref[:, :3, 3], est[:, :3, 3])[-1])
        print(f"ATE RMSE: {ate:.05f}cm")
        return ate
