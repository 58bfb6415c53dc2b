"""System orchestrator: the per-frame reconstruct pipeline, the end of a
run and its evaluations (port of `eggfusion_tpu/system.py`).

reconstruct(frame) = [recover] -> track -> preprocess -> map -> postprocess
-> trajectory bookkeeping. After `Tracking.recover_after` failed dense
solves in a row, `_recover_tracking` re-anchors the model view at a
descriptor-relocalized pose, the last converged pose or the last keyframe,
and seeds the next solve from a coarse rotation sweep. `finish` runs the
global keyframe optimization and writes `final_surfels.ply` and
`checkpoint.npz`; `resume` continues a run from such a checkpoint (either
package's) and `reload` loads a PLY map. The evaluations write the TUM
trajectories and the render (keyframe and held-out views) and
reconstruction metrics under `save_dir`; `evaluate_render_dataset` scores
renders at the ground-truth poses of another split of a dataset (the
ScanNet++ test split).

The frame's programs run through the system's program cache
(`utils.graphs.Programs`, the counterpart of the JAX package's jitted
programs): the frame preparation and its pyramid, `dense_track_pose`,
`preprocess_frame_map`, the map update (with `postprocess_model_map`),
the burst schedule's render and postprocess, the opt step, the binning and
the model render, map maintenance's prune and compaction, and under a mesh
(`System.mesh_devices`) the window-batched step and the pixel-sharded
tracker (programs per device, `parallel/mesh.py`, `core/tracker.py`). On
CUDA each is a captured CUDA graph; `warmup` captures them before frame 0,
as the JAX `warmup` compiles (the mesh's window step at its first use: its
keys follow the window's members). What stays eager: `Tracking.early_exit`
(a readback per GN iteration), recovery and its rotation sweep (the
re-anchor's render replays the model render), the evaluations except
where they replay a captured key, and the sparse frontend's host read (it
comes before the tracking program; its seed is an input).
"""
from __future__ import annotations

import json
import os
import time as _time

import numpy as np
import torch

from eggfusion_tpu_torch.core import surfels as sf
from eggfusion_tpu_torch.core.frame import Frame
from eggfusion_tpu_torch.core.mapper import KEEP_MODEL_MAP, Mapping
from eggfusion_tpu_torch.core.renderer import Renderer
from eggfusion_tpu_torch.core.tracker import Tracker, dense_track
from eggfusion_tpu_torch.geometry import transforms as tf
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.io import checkpoint as ckpt
from eggfusion_tpu_torch.io import ply as plyio
from eggfusion_tpu_torch.ops import image as imops
from eggfusion_tpu_torch.ops.pyramid import build_pyramid
from eggfusion_tpu_torch.utils import eval as evalu
from eggfusion_tpu_torch.utils import trace
from eggfusion_tpu_torch.utils.device import resolve_device
from eggfusion_tpu_torch.utils.graphs import Programs


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


def _preprocess_program(_state, x, *, reco_normal_thres):
    return preprocess_frame_map(*x, reco_normal_thres)


def postprocess_model_map(rendered: dict, frame_map: dict, intr, w2c, reco_normal_thres: float,
                          reco_depth_thres: float, reco_opacity_thres: float, depth_min: float,
                          depth_max: float, nlevel: int, down: int = 1, bilateral: str = "exact"):
    """Consistency masks + fill-in from the frame + the next frame's
    tracking pyramid. `down` > 1 (Tracking.model_view_down): the rendered
    maps are at 1/down resolution; the frame's maps are subsampled
    [::down, ::down] to match and the intrinsics divided by `down`."""
    if down > 1:
        frame_map = {k: frame_map[k][::down, ::down]
                     for k in ("normal_map_c", "depth_map", "color_map", "geo_mask")}
        intr = intr / down
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
    `core.mapper.RandomSource`); `graphs` None runs the frame's programs as
    CUDA graphs on CUDA and eagerly on the CPU, True as graphs (on the CPU:
    through the same static buffers, eagerly), False eagerly
    (`utils.graphs.Programs`)."""

    def __init__(self, cfg, device=None, random_source=None, graphs=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.programs = Programs(self.device, graphs)
        self.renderer = Renderer(cfg, self.device)
        self.tracker = Tracker(cfg, self.device, self.programs)
        self.mapper = Mapping(cfg, self.renderer, self.device, random_source=random_source,
                              programs=self.programs)
        self.frame_map = None
        self.model_map = None
        s = cfg.System
        self.save_dir = s.get("save_dir", "") or "results/run"
        self.final_global_opt = bool(s.final_global_opt)
        self.reco_normal_thres = float(s.reco_normal_threshold)
        self.reco_depth_thres = float(s.reco_depth_threshold)
        self.reco_opacity_thres = float(s.reco_opacity_threshold)
        self.depth_range_min = float(s.depth_range_min)
        self.depth_range_max = float(s.depth_range_max)
        self.nlevel = int(cfg.Tracking.pyramid_level)
        # model-view downsample (Tracking.model_view_down): the tracking and
        # spawn model view renders at 1/down; frames build `view_off` extra
        # pyramid levels so the tracker pairs the model pyramid with the
        # frame pyramid an octave (or two) down
        self.mv_down = int(cfg.Tracking.get("model_view_down", 1))
        self.view_off = self.tracker.view_off
        self.nlevel_frame = self.nlevel + self.view_off
        self.bilateral = str(s.get("bilateral_mode", "exact"))
        self.traj = {"ts": [], "ref": [], "est": []}
        self.metrics = []
        # held-out render evaluation: every `heldout_stride`-th frame (offset
        # by half a stride, so it interleaves the keyframe checks) keeps its
        # color, depth and tracked pose on the device; frames that become
        # keyframes are left out at evaluation time. 0 disables.
        self.heldout_stride = int(s.get("heldout_stride", 25))
        self.heldout_max = int(s.get("heldout_max", 8))
        self._heldout: list = []  # (uid, w2c, color, depth)
        # recovery: descriptor relocalization (built at the first recovery)
        # and the coarse rotation sweep that seeds the re-lock
        self._reloc = None
        self._reloc_enabled = bool(cfg.Tracking.get("reloc_descriptors", True))
        self._rot_sweep = bool(cfg.Tracking.get("recovery_rotation_sweep", True))
        self._p_post = self.programs.program("postprocess", self._postprocess_program)
        if self.mapper.mcfg.opt_schedule != "amortized":
            self.mapper.capture_hooks.append(self._capture_postprocess)
        self.warmup_s = None  # seconds of `warmup`, once it ran

    # ---- the programs ahead of frame 0 --------------------------------------

    def warmup(self, full: bool | None = None) -> None:
        """Capture the frame's programs before frame 0 (the JAX `warmup`).

        Builds the CUDA kernels (on CUDA), then a frame — the run's first
        (`self.dataset`, if set) or a dummy one — and captures the tracking
        program on its pyramid; with `full` (default: on CUDA) the frame,
        preprocess, map-update (frame 0's and the later frames'), opt-step,
        binning and model-render programs at the starting rung, and with
        `System.precompile_ladder` those of every rung above it (off by
        default, as in JAX). Runs no frame: the system's state is left as it
        was, and `frame_map` is reset."""
        t0 = _time.perf_counter()
        if full is None:
            full = self.device.type == "cuda"
        if self.device.type == "cuda" and self.renderer.backend == "pallas":
            from eggfusion_tpu_torch.ops import cuda_build

            cuda_build.build()
        programs = self.programs if full else None
        dataset = getattr(self, "dataset", None)
        if dataset is not None:
            from eggfusion_tpu_torch.main import build_frame

            f = build_frame(dataset, 0, False, self.device, nlevel=self.nlevel_frame, programs=programs)
        else:
            intr = CameraIntrinsics.from_calibration(self.cfg.Dataset.Calibration)
            H, W = intr.height, intr.width
            f = Frame(uid=-1, ts=0.0, color_u8=np.zeros((H, W, 3), np.float32), depth_raw=np.ones((H, W), np.float32),
                      mask=np.ones((H, W), np.float32), gt_pose_w2c=np.eye(4, dtype=np.float32), intr=intr,
                      depth_scale=1.0, device=self.device, nlevel=self.nlevel_frame, prefiltered=True,
                      bilateral=self.bilateral, programs=programs)
        f.update_transform_gt()
        self.tracker.capture(f.pyramid[self.view_off:], f.pyramid[self.view_off:])
        if full:
            self.preprocess(f)
            self.mapper.capture_rung(self.frame_map, f.w2c_matrix(), f.intr, f.width, f.height, first=True)
            # frame 0's model view (its map update renders nothing)
            self._capture_postprocess(self.mapper.surfels, self.frame_map, f.w2c_matrix(), f.intr, f.width,
                                      f.height)
            if bool(self.cfg.System.get("precompile_ladder", False)):
                n = self.mapper.precompile_ladder(self.frame_map, f.w2c_matrix(), f.intr, f.width, f.height)
                print(f"warmup: captured the programs of {n} ladder rungs ahead")
        self.frame_map = None  # dummy-frame state must not leak into frame 0
        self.warmup_s = _time.perf_counter() - t0

    def _postprocess_program(self, s, x, *, width, height, down):
        with torch.no_grad():
            intr = x["intr"]
            out = self.renderer.render_at(sf.render_params(s), x["w2c"], intr / down if down > 1 else intr,
                                          width // down, height // down, need_grad=False)
            rendered = {"render_color": out["color"], "render_depth": out["depth"],
                        "render_normal": out["normal"], "render_opacity": out["opacity"]}
            return postprocess_model_map(
                rendered, x["frame_map"], intr, x["w2c"], self.reco_normal_thres, self.reco_depth_thres,
                self.reco_opacity_thres, self.depth_range_min, self.depth_range_max, self.nlevel, down=down,
                bilateral=self.bilateral)

    def _capture_postprocess(self, s, frame_map, w2c, intr, width, height) -> None:
        self._p_post.prepare({"width": width, "height": height, "down": self.mv_down}, s,
                             {"frame_map": frame_map, "w2c": w2c, "intr": intr}, rung=s.capacity)

    # ---- recovery -----------------------------------------------------------

    def _model_map_at(self, w2c) -> dict:
        """A tracking model map (render + pyramid) at an arbitrary pose: the
        re-anchor of recovery and resume."""
        intr = CameraIntrinsics.from_calibration(self.cfg.Dataset.Calibration)
        d = self.mv_down
        ia = intr.as_tensor(self.device) / d
        out = self.mapper.render(w2c, ia, intr.width // d, intr.height // d)
        opa = out["opacity"] > self.reco_opacity_thres
        pyramid = build_pyramid(out["color"], out["depth"], opa.to(torch.float32), ia, nlevel=self.nlevel)
        return {"transform": w2c, "pyramid": pyramid}

    def _rotation_hypothesis_seed(self, frame) -> int:
        """Solve the coarsest pyramid level alone from a fan of pure-rotation
        seeds (yaw 0, +-8, +-16, +-24 deg; pitch +-8) and install the best
        committed delta (least point-to-plane RMS) as the tracker's one-shot
        seed. The commit rule is `dense_track_pose`'s. Returns the number of
        committed hypotheses; reads the device on every hypothesis (recovery
        is rare)."""
        if self.model_map is None or "pyramid" not in self.model_map:
            return 0
        cfg = self.tracker.config
        L = cfg.pyramid_level
        pm = (self.model_map["pyramid"][L - 1],)
        pf = (frame.pyramid[L - 1 + self.view_off],)
        coarse_cfg = cfg._replace(pyramid_level=1, pyramid_iters=(6,), solver_stride_fine=0)

        def rot(axis, deg):
            a = np.deg2rad(deg)
            c, s = np.cos(a), np.sin(a)
            R = np.eye(4, dtype=np.float32)
            if axis == "y":
                R[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            else:
                R[:3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
            return R

        hyps = [("y", d) for d in (0.0, 8.0, -8.0, 16.0, -16.0, 24.0, -24.0)]
        hyps += [("x", d) for d in (8.0, -8.0)]
        best = None
        n_conv = 0
        for axis, deg in hyps:
            seed = torch.as_tensor(rot(axis, deg), device=self.device)
            delta, conv, rms, n_icp = dense_track(pm, pf, seed, coarse_cfg, self.tracker.devices)
            with trace.waiting("readback"):
                conv, rms, n_icp = bool(conv), float(rms), float(n_icp)
            ok = conv or (cfg.commit_min_count > 0 and rms < cfg.commit_rms_m and n_icp >= cfg.commit_min_count)
            if ok:
                n_conv += 1
                if best is None or rms < best[0]:
                    best = (rms, delta)
        if best is not None:
            self.tracker.seed_override = best[1]
        return n_conv

    def _recover_tracking(self, frame=None) -> bool:
        """Re-anchor tracking after a failure streak. The anchor, best
        first: (1) the pose that descriptor relocalization solves against
        its best-matching keyframe; (2) the last pose whose dense solve
        converged; (3) the last keyframe. The model view is rendered anew at
        the anchor and the motion model cleared; a record goes to
        `metrics`. Runs under the span "recover"."""
        with trace.span("recover"):
            return self._recover(frame)

    def _recover(self, frame) -> bool:
        km = self.mapper.keyframe_manager
        anchor = anchor_id = None
        reloc_inliers = 0
        if frame is not None and self._reloc_enabled and km.keyframes:
            if self._reloc is None:
                from eggfusion_tpu_torch.core.reloc import DescriptorRelocalizer

                self._reloc = DescriptorRelocalizer(self.cfg)
            hit = self._reloc.relocalize(frame, km.keyframes)
            if hit is not None:
                w2c, anchor_id, reloc_inliers = hit
                anchor = torch.as_tensor(w2c, device=self.device)
        if anchor is None:
            anchor, anchor_id = self.tracker.last_good_w2c, -1
        if anchor is None:
            ids = km.ids()
            if not ids:
                return False
            kf = km.keyframes[ids[-1]]
            anchor, anchor_id = kf.w2c, kf.uid
        self.model_map = self._model_map_at(anchor)
        self.tracker.reset_motion()
        rec = {"frame": -1, "recovered_to_kf": anchor_id}
        if reloc_inliers:
            rec["reloc_inliers"] = reloc_inliers
        if frame is not None and self._rot_sweep:
            rec["rot_sweep_converged"] = self._rotation_hypothesis_seed(frame)
        self.metrics.append(rec)
        return True

    # ---- per-frame pipeline -------------------------------------------------

    def reconstruct(self, frame) -> None:
        """Track, map and render one frame, and append its record to
        `metrics`: host ms of tracking (`track_ms`), preprocess and mapping
        (`map_ms`) and the model view (`post_ms`); of those and of the frame's
        preparation before it, host ms blocked on reads of the device
        (`readback_ms`), making program entries (`capture_ms`) and on the
        staging buffers of the frame's upload (`upload_ms`). On the tile
        backend the record also carries the renders' binning counters of the
        frames read since the last record, `count_lag` frames late
        (`Mapping.take_render_counts`: `binned_entries`, `tail_entries`,
        `max_run` of the map update's render, the same with `_opt` of the
        optimization steps, `render_frames` frames up to `render_frame`).
        A frame whose window optimization ran steps records the slots they
        ran on (`opt_slots`, the work rung of `core/capacity.py`)."""
        t0 = _time.perf_counter()
        if self.model_map is not None and self.tracker.needs_recovery():
            self._recover_tracking(frame)
        self.tracker.tracking(frame, self.model_map)
        t1 = _time.perf_counter()
        self.preprocess(frame)
        model_map = self.mapper.mapping(
            frame, self.frame_map,
            fail_streak=max(self.tracker._fail_streak, self.tracker.chronic_fails))
        t2 = _time.perf_counter()
        if isinstance(model_map, str) and model_map == KEEP_MODEL_MAP:
            pass  # settled fuse-only frame: track against the previous model view
        elif model_map is not None:
            self.model_map = model_map
        else:
            # optimization frame: render AFTER the window optimization
            self.postprocess(frame)
        t3 = _time.perf_counter()
        self.append_trajectory(frame)
        if self.heldout_stride > 0 and frame.uid % self.heldout_stride == self.heldout_stride // 2:
            # copies: the frame's maps belong to the frame program
            self._heldout.append((frame.uid, frame.w2c_matrix(), frame.color.clone(), frame.depth.clone()))
            if len(self._heldout) > self.heldout_max:
                self._heldout.pop(0)
        rec = {
            "frame": frame.uid,
            "track_ms": (t1 - t0) * 1e3,
            "map_ms": (t2 - t1) * 1e3,
            "post_ms": (t3 - t2) * 1e3,
            "surfels": self.mapper.surfels.num_active(),  # device scalar, read lazily
            "capacity": self.mapper.surfels.capacity,
            "opt_steps": self.mapper.opt_steps_total,
            **trace.take_waits(),
            **self.mapper.take_render_counts(),
        }
        if self.mapper.frame_opt_slots is not None:
            rec["opt_slots"] = self.mapper.frame_opt_slots
        if self.mapper.settled_skip:
            rec["render_skips"] = self.mapper.render_skips
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
        with trace.span("preprocess"):
            p0 = frame.pyramid[0]
            x = (frame.color, frame.depth, p0.vertex, p0.normal, frame.mask, frame.intr, frame.w2c_matrix())
            self.frame_map = self.programs.program("preprocess", _preprocess_program)(
                {"reco_normal_thres": self.reco_normal_thres}, None, x)

    def postprocess(self, frame) -> None:
        """Render the model at the frame's pose (at 1/model_view_down) and
        build the next tracking model map."""
        s = self.mapper.surfels
        with trace.span("model_view"):
            self.model_map = self._p_post(
                {"width": frame.width, "height": frame.height, "down": self.mv_down}, s,
                {"frame_map": self.frame_map, "w2c": frame.w2c_matrix(), "intr": frame.intr}, rung=s.capacity)

    def append_trajectory(self, frame) -> None:
        # the estimate stays a device handle; `_traj_np` converts in bulk
        self.traj["ts"].append(frame.ts)
        self.traj["ref"].append(np.linalg.inv(frame.gt_w2c))
        self.traj["est"].append(frame.w2c_matrix())

    def _traj_np(self, key: str) -> np.ndarray:
        """A trajectory as host c2w matrices (N, 4, 4). Entries are host c2w
        arrays (ground truth, resumed, converted) or device w2c handles,
        converted here in one transfer."""
        entries = self.traj[key]
        if not entries:
            return np.zeros((0, 4, 4), np.float32)
        idx_dev = [i for i, m in enumerate(entries) if not isinstance(m, np.ndarray)]
        if idx_dev:
            conv = np.linalg.inv(torch.stack([entries[i] for i in idx_dev]).cpu().numpy())
            for j, i in enumerate(idx_dev):
                entries[i] = conv[j]
        return np.stack(entries).astype(np.float32)

    # ---- the end of a run ---------------------------------------------------

    def finish(self) -> None:
        """The global keyframe optimization (under `System.final_global_opt`),
        then `final_surfels.ply` and `checkpoint.npz` under `save_dir`."""
        print("Finishing...")
        print(f"Keyframe IDs: {self.mapper.keyframe_manager.ids()}")
        if self.final_global_opt:
            self.mapper.keyframe_optimization()
        os.makedirs(self.save_dir, exist_ok=True)
        self.save_ply(os.path.join(self.save_dir, "final_surfels.ply"))
        ckpt.save_checkpoint(
            os.path.join(self.save_dir, "checkpoint.npz"), self.mapper.surfels,
            extra={"traj_ref": self._traj_np("ref"), "traj_est": self._traj_np("est"),
                   "ts": np.asarray(self.traj["ts"]), "time": np.int64(self.mapper.time)})

    def save_ply(self, path: str) -> None:
        s = self.mapper.surfels
        act = _host(s.active)
        # PLY rows (N, k...) are the transposed (k..., C) fields' full axis
        # reversal
        row = lambda x: _host(x).T[act]
        plyio.save_ply(path, row(s.xyz), row(s.features_dc), row(s.features_rest), row(s.scaling),
                       row(s.rotation), row(s.opacity))
        print(f"Saved surfels to {path}")

    def resume(self, path: str) -> None:
        """Continue a run from a `checkpoint.npz` of either package: the whole
        surfel map (fusion state included) at the checkpoint's capacity, the
        trajectory and the frame clock; the model view is rendered at the
        last estimated pose and the tracker takes that pose as its
        history."""
        s, extra = ckpt.load_checkpoint(path, self.device)
        if "time" in extra:
            self.mapper.time = int(extra["time"])
        self.mapper.adopt(s, int(s.count))
        if "ts" in extra:
            self.traj = {
                "ts": list(np.asarray(extra["ts"])),
                "ref": [np.asarray(m) for m in extra.get("traj_ref", [])],
                "est": [np.asarray(m) for m in extra.get("traj_est", [])],
            }
        if self.traj["est"]:
            last_c2w = np.asarray(self.traj["est"][-1])
            w2c = torch.as_tensor(np.linalg.inv(last_c2w), dtype=torch.float32, device=self.device)
            self.model_map = self._model_map_at(w2c)
            self.tracker._push_pose(w2c)
            self.tracker.initialized = True
        print(f"Resumed {int(s.count)} surfels @ frame {self.mapper.time} from {path}")

    def reload(self, path: str) -> None:
        """Load a PLY map into the leading slots (its 3DGS fields; the
        fusion state starts fresh). A map too large for the current
        capacity grows to the ladder's rung for it; above
        `Viewer.max_surfels_num` the first that many surfels are kept."""
        data = plyio.load_ply(path)
        s = self.mapper.surfels
        n = len(data["xyz"])
        if n > s.capacity:
            s = sf.grow_surfels(s, self.mapper.ladder.rung_for(n))
        n = min(n, s.capacity)
        fields = ["xyz", "features_dc", "scaling", "rotation", "opacity"]
        if data["features_rest"].shape[1] == s.features_rest.shape[1]:
            fields.append("features_rest")
        for f in fields:
            # PLY rows (n, k...) -> leading slots of the (k..., C) field
            getattr(s, f)[..., :n] = torch.as_tensor(np.ascontiguousarray(data[f][:n].T), device=self.device)
        s.active[:n] = True
        s.count = torch.tensor(n, dtype=torch.int32, device=self.device)
        self.mapper.adopt(s, n)
        print(f"Reloaded {n} surfels from {path}")

    # ---- evaluation ---------------------------------------------------------

    def evaluate_trajectory(self, plot: bool = True) -> float:
        """ATE RMSE (cm) of the whole run; writes the reference and estimated
        trajectories under `save_dir` in TUM format and as N x 16 rows, and,
        where matplotlib is present, the ATE curve and three trajectory
        plots."""
        os.makedirs(self.save_dir, exist_ok=True)
        ref = self._traj_np("ref")
        est = self._traj_np("est")
        ts = self.traj["ts"]
        np.savetxt(os.path.join(self.save_dir, "trajectory_ref_tum.txt"),
                   [evalu.matrix_to_tum(t, m) for t, m in zip(ts, ref)])
        np.savetxt(os.path.join(self.save_dir, "trajectory_est_tum.txt"),
                   [evalu.matrix_to_tum(t, m) for t, m in zip(ts, est)])
        np.savetxt(os.path.join(self.save_dir, "trajectory_ref.txt"), ref.reshape(-1, 16))
        np.savetxt(os.path.join(self.save_dir, "trajectory_est.txt"), est.reshape(-1, 16))
        ates = evalu.cumulative_ate(ref[:, :3, 3], est[:, :3, 3])
        ate = float(ates[-1])
        if plot:
            try:
                import matplotlib

                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                plt.figure()
                plt.plot(ates)
                plt.title(f"ate:{ate}")
                plt.savefig(os.path.join(self.save_dir, "ates.png"))
                for a, b, name in [(0, 1, "xy"), (1, 2, "yz"), (0, 2, "xz")]:
                    plt.figure()
                    plt.plot(est[:, a, 3], est[:, b, 3])
                    plt.plot(ref[:, a, 3], ref[:, b, 3])
                    plt.legend(["es", "gt"])
                    plt.savefig(os.path.join(self.save_dir, f"traj_{name}.jpg"))
                plt.close("all")
            except Exception as e:  # plotting is best-effort
                print(f"plotting skipped: {e}")
        print(f"ATE RMSE: {ate:.05f}cm")
        return ate

    def evaluate_recon(self, thresh: float = 0.01) -> dict:
        """Accuracy, completeness and F-score at `thresh` (meters) of the map
        against the keyframes' depth clouds at their solved poses; each
        surfel counts as its center and four points at +-0.7 sigma along its
        tangent axes. Writes `recon_metrics.json`."""
        clouds = []
        for kf in self.mapper.keyframe_manager.keyframes.values():
            # the cloud at least as dense as the map: every pixel at test
            # sizes, every 4th at full width
            clouds.append(evalu.unproject_depth(_host(kf.maps["depth"]), _host(kf.intr),
                                                np.linalg.inv(_host(kf.w2c)),
                                                stride=max(1, min(4, kf.width // 320))))
        s = self.mapper.surfels
        act = _host(s.active)
        xyz = _host(s.xyz).T[act]
        q = _host(s.rotation).T[act]  # (M, 4) wxyz, unnormalized
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        tu = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)], 1)
        tv = np.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)], 1)
        sc = np.exp(_host(s.scaling).T[act][:, :2])
        du = 0.7 * sc[:, :1] * tu
        dv = 0.7 * sc[:, 1:2] * tv
        samples = np.concatenate([xyz, xyz + du, xyz - du, xyz + dv, xyz - dv])
        rep = evalu.eval_recon(samples, clouds, thresh=thresh) if clouds else {}
        if rep:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "recon_metrics.json"), "w") as f:
                json.dump(rep, f, indent=2)
            print("Recon metrics:", {k: round(v, 5) if isinstance(v, float) else v for k, v in rep.items()})
        return rep

    @staticmethod
    def _device_render_metrics(ref_color, ref_depth, est_color, est_depth) -> torch.Tensor:
        """(2,) [PSNR, masked depth-L1] computed on the device."""
        mse = torch.mean((ref_color - est_color) ** 2)
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
        m = ref_depth > 0
        dl1 = (torch.sum(torch.where(m, torch.abs(ref_depth - est_depth), torch.zeros_like(ref_depth)))
               / torch.clamp(torch.sum(m.to(torch.float32)), min=1.0))
        return torch.stack([psnr, dl1])

    def evaluate_render_heldout(self) -> dict:
        """PSNR and depth-L1 of renders at the stored non-keyframe poses
        (views the optimizer never fit), computed on the device."""
        kf_uids = set(self.mapper.keyframe_manager.keyframes.keys())
        intr = CameraIntrinsics.from_calibration(self.cfg.Dataset.Calibration)
        ia = intr.as_tensor(self.device)
        rows = []
        for uid, w2c, color, depth in self._heldout:
            if uid in kf_uids:
                continue
            out = self.mapper.render(w2c, ia, intr.width, intr.height)
            v = _host(self._device_render_metrics(color, depth, out["color"], out["depth"]))
            rows.append({"frame": uid, "psnr": float(v[0]), "depth_l1": float(v[1])})
        if not rows:
            return {}
        return {
            "per_frame": rows,
            "mean": {"psnr": float(np.mean([r["psnr"] for r in rows])),
                     "depth_l1": float(np.mean([r["depth_l1"] for r in rows]))},
            "n_frames": len(rows),
        }

    def evaluate_render_dataset(self, dataset, train_pivot: np.ndarray | None = None) -> dict:
        """Render metrics at every ground-truth pose of a loaded split
        (`load_dataset(cfg, device, test=True)`), written to
        `render_metrics_testsplit.json`. `train_pivot` is the pivot of the
        split the map was built from: each split re-bases its poses on its
        own frame 0, so w2c_run = w2c_split @ pivot_split @ inv(train_pivot)."""
        intr = CameraIntrinsics.from_calibration(self.cfg.Dataset.Calibration)
        ia = intr.as_tensor(self.device)
        adj = np.eye(4)
        if train_pivot is not None and getattr(dataset, "pivot", None) is not None:
            adj = np.asarray(dataset.pivot) @ np.linalg.inv(np.asarray(train_pivot))
        depth_scale = float(self.cfg.Dataset.Calibration.depth_scale)
        rows = []
        for i in range(len(dataset)):
            _ts, color, depth, _mask, w2c = dataset[i]
            w2c = torch.as_tensor(np.asarray(w2c) @ adj, dtype=torch.float32, device=self.device)
            out = self.mapper.render(w2c, ia, intr.width, intr.height)
            r = evalu.eval_render(color.astype(np.float32) / 255.0,
                                  (depth.astype(np.float32) / depth_scale)[..., None],
                                  _host(out["color"]), _host(out["depth"]))
            r["frame"] = i
            rows.append(r)
        if not rows:
            return {}
        vals = lambda k: [r[k] for r in rows if isinstance(r.get(k), (int, float)) and np.isfinite(r[k])]
        rep = {
            "per_frame": [{k: v for k, v in r.items() if not isinstance(v, float) or np.isfinite(v)}
                          for r in rows],
            "mean": {k: float(np.mean(vals(k))) for k in ("psnr", "ssim", "depth_l1") if vals(k)},
            "n_frames": len(rows),
        }
        os.makedirs(self.save_dir, exist_ok=True)
        with open(os.path.join(self.save_dir, "render_metrics_testsplit.json"), "w") as f:
            json.dump(rep, f, indent=2)
        return rep

    def evaluate_render(self) -> dict:
        """Render metrics over the keyframes (host SSIM and MS-SSIM, each
        keyframe's maps pulled once) and a held-out section (see
        `evaluate_render_heldout`); writes `render_metrics.json` and returns
        the keyframe means."""
        results = []
        for kf in self.mapper.keyframe_manager.keyframes.values():
            out = self.mapper.render(kf.w2c, kf.intr, kf.width, kf.height)
            results.append(evalu.eval_render(_host(kf.maps["color"]), _host(kf.maps["depth"]),
                                             _host(out["color"]), _host(out["depth"])))
        if not results:
            return {}

        def nanmean(vals):
            # notes (lpips_note) pass through; values are numbers or None
            msgs = [v for v in vals if isinstance(v, str)]
            if msgs:
                return msgs[0]
            vals = [v for v in vals if v is not None and np.isfinite(v)]
            return float(np.mean(vals)) if vals else None

        agg = {k: nanmean([r[k] for r in results]) for k in results[0]}
        held_out = self.evaluate_render_heldout()
        san = lambda v: v if isinstance(v, str) or v is None or np.isfinite(v) else None
        os.makedirs(self.save_dir, exist_ok=True)
        with open(os.path.join(self.save_dir, "render_metrics.json"), "w") as f:
            json.dump({"per_keyframe": [{k: san(v) for k, v in r.items()} for r in results],
                       "mean": agg, "held_out": held_out}, f, indent=2)
        print("Render metrics:", agg)
        if held_out:
            print("Held-out render metrics:", held_out["mean"], f"({held_out['n_frames']} non-keyframe views)")
        return agg
