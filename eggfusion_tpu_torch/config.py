"""Hierarchical YAML configuration (port of `eggfusion_tpu/config.py`).

Reimplements the reference's OmegaConf 3-file merge (reference
`main.py:15-37`) without the omegaconf dependency: a scene yaml names its
`base_config` and `data_config`; merge order base <- data <- scene, deep
per-key. Section names (Dataset/Viewer/Tracking/Mapping/Surfel/System) match
the reference for config parity.
"""
from __future__ import annotations

import os
from datetime import datetime
from typing import Any

import yaml


class Config(dict):
    """Dict with attribute access, recursive wrapping and `.get` fallback."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_plain(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def merge(base: dict, override: dict) -> Config:
    """Deep merge: override wins per key (OmegaConf.merge semantics)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return Config.wrap(out)


def load_yaml(path: str) -> Config:
    with open(path) as f:
        return Config.wrap(yaml.safe_load(f) or {})


def load_config(path: str, make_workspace: bool = True) -> Config:
    """3-level merge + timestamped workspace creation (reference
    `load_config`, `main.py:15-37`)."""
    scene = load_yaml(path)
    root = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        if p and not os.path.isabs(p) and not os.path.exists(p):
            cand = os.path.normpath(os.path.join(root, "..", "..", p))
            if os.path.exists(cand):
                return cand
            cand = os.path.normpath(os.path.join(root, p))
            if os.path.exists(cand):
                return cand
        return p

    data = load_yaml(resolve(scene["data_config"])) if "data_config" in scene else Config()
    base = load_yaml(resolve(scene["base_config"])) if "base_config" in scene else Config()
    cfg = merge(merge(base, data), scene)

    if make_workspace:
        root_dir = cfg.System.root_dir
        ts = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        save_dir = f"{cfg.Dataset.type}_{cfg.Dataset.get('scene', 'scene')}_{ts}"
        cfg.System.save_dir = os.path.join(root_dir, save_dir)
        os.makedirs(cfg.System.save_dir, exist_ok=True)
        with open(os.path.join(cfg.System.save_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg.to_plain(), f, sort_keys=False)
    return cfg


# Built-in defaults so programmatic use (tests, bench) needs no yaml files.
DEFAULTS = {
    "Dataset": {
        "type": "synthetic",
        "scene": "corner",
        "preload": True,
        "Calibration": {
            "fx": 300.0, "fy": 300.0, "cx": 159.5, "cy": 119.5,
            "width": 320, "height": 240, "depth_scale": 1.0,
            "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
            "distorted": False,
        },
    },
    "Viewer": {"max_depth": 10, "max_surfels_num": 200000, "image_scale": 0.2},
    "Tracking": {
        "pyramid_level": 3,
        # DEFAULTS stay at REFERENCE PARITY (ADVICE r4): the TPU-tuned
        # values ([3, 3, 2] iters, opt_step_scale 0.5 — priced on the
        # 1280x704 synthetic A/B plus the adversarial probe) are owned by
        # configs/base.yaml; default_config users get reference behavior.
        "pyramid_iters": [3, 3, 3],
        "angle_threshold": 20,
        "distance_threshold": 0.1,
        "use_rgb": True,
        "rgb_weight": 1.0e-4,
        "use_sparse": False,
        "use_motion_model": True,
        "motion_damping": 0.5,
        "residual_thres": 0.01,
        "dx_threshold": 0.001,
        "check_keyframe_R": 20,
        "check_keyframe_t": 0.3,
        "sliding_window_size": 3,
        # model-view downsample factor (round 5, TPU-fast): 1 = reference
        # parity (the tracking/spawn model view renders at full frame
        # resolution). 2 = the model view renders at HALF resolution and
        # dense tracking pairs it with the frame pyramid one octave down —
        # with solver_stride 1 the finest-level constraint count equals the
        # full-res stride-2 grid, while the coverage-critical model render
        # and the tracking gathers run at a quarter of the pixels. The map
        # OPTIMIZATION path (keyframe renders, losses) stays full-res, so
        # reconstruction quality is unaffected except through spawn-mask
        # granularity and tracking. Tuned value lives in configs/base.yaml.
        "model_view_down": 1,
    },
    "Mapping": {
        "add_opacity_thres": 0.8,
        "add_depth_thres": 0.05,
        "add_color_thres": 0.5,
        "sample_ratio": 0.025,
        "sample_ratio_init": 0.2,
        "local_map_iter_init": 20,
        "local_map_iter": 3,
        "position_lr": 1.0e-5,
        "feature_lr": 1.0e-3,
        "opacity_lr": 1.0e-5,
        "scaling_lr": 5.0e-4,
        "rotation_lr": 1.0e-4,
        "final_position_lr": 0.0,
        "final_feature_lr": 1.0e-3,
        "final_opacity_lr": 1.0e-5,
        "final_scaling_lr": 1.0e-3,
        "final_rotation_lr": 0.0,
        "final_global_opt_iter": 60,
        "init_scale_ratio": 2.0,
        "sw_optimize_freq": 6,
        "sw_add_freq": 3,
        "color_weight": 1.0,
        "depth_weight": 1.0,
        "normal_weight": 1.0,
        "reg_weight": 10.0,
        "reg_weight_n": 1.0,
        "fusion_dist_thres": 0.03,
        "opt_tile_fraction": 0.5,
        "opt_step_scale": 1.0,  # reference-parity step rate; the tuned 0.5
        #                         lives in configs/base.yaml (ADVICE r4)
        # settled-frame render skip (round 5b): when the lag-N surfel counts
        # are flat (no spawns) and tracking is healthy, skip the per-frame
        # model render + spawn on at most every other frame — the tracker
        # uses the previous view, one frame staler. OFF here (the reference
        # renders every frame); the TPU-fast default is configs/base.yaml.
        "settled_skip": False,
        "settled_skip_tol": 64,        # count-spread floor (absolute)
        "settled_skip_tol_frac": 5.0e-4,  # ...and relative to map size
        "settled_skip_max_rot": 0.3,   # deg/frame motion gate
        "settled_skip_max_trans": 0.025,  # m/frame motion gate
        "cull_dist_thres": 0.0,
        "state_threshold": 30,
        "background": [1.0, 1.0, 1.0],
    },
    "Surfel": {
        "init_opacity": 0.99,
        "scale_factor": 1.0,
        "min_radius": 0.001,
        "max_radius": 0.05,
        "active_sh_degree": 3,
        "max_sh_degree": 3,
        "stable_grad_coeff": 1.0e-3,
        "confidence_thres": 5.0,
        "alpha_p": 1.0,
        "alpha_n": 0.5,
    },
    "System": {
        "root_dir": "results",
        "save_dir": "",
        "only_mapping": False,
        "raster_cap": 2048,  # see configs/base.yaml System.raster_cap note
        "opt_raster_cap": 1024,  # optimization-render capacity (gradient path)
        "final_global_opt": True,
        "eval_tracking": True,
        "eval_render": True,
        "eval_recon": True,
        "reco_normal_threshold": 5,
        "reco_depth_threshold": 0.01,
        "reco_opacity_threshold": 0.8,
        "depth_range_min": 0.1,
        "depth_range_max": 5.0,
        # depth bilateral-filter variant: "exact" = the reference's full
        # 13x13 window (`tracking.cu:777-848`); "separable" = row+column
        # approximation (26 taps vs 169). DEFAULT stays reference parity;
        # the TPU-tuned value lives in configs/base.yaml once priced.
        "bilateral_mode": "exact",
        "seed": 0,
    },
}


def default_config(**overrides) -> Config:
    cfg = merge(DEFAULTS, overrides)
    return cfg


def slice_config(n_frames: int, save_dir: str, burst: bool = False,
                 final_global_opt: bool = False) -> Config:
    """`bench.py`'s 1280x704 synthetic workload with a fixed 262144-slot map
    (`capacity_bucketing` off) and every frame unique (no `unique_frames`
    cycling); `burst` switches to `Mapping.opt_schedule: burst`,
    `final_global_opt` turns on `finish()`'s global keyframe optimization
    (off in `bench.py`)."""
    w, h = 1280, 704
    mapping = {"local_map_iter": 3, "opt_step_scale": 0.5}
    if burst:
        mapping["opt_schedule"] = "burst"
    return default_config(
        Dataset={"type": "synthetic", "n_frames": n_frames, "device_frames": True, "preload": False,
                 "Calibration": {"fx": 600.0, "fy": 600.0, "cx": w / 2 - 0.5, "cy": h / 2 - 0.5,
                                 "width": w, "height": h, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 262144},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Mapping=mapping,
        Tracking={"pyramid_iters": [3, 3, 2], "solver_stride_fine": 4},
        System={"save_dir": save_dir, "final_global_opt": final_global_opt, "bilateral_mode": "separable",
                "capacity_bucketing": False},
    )
