"""CLI driver (port of `eggfusion_tpu/main.py`).

Usage (on a CUDA GPU; `--device cpu` runs on the CPU):
    python -m eggfusion_tpu_torch.main --synthetic --frames 30 --verbose
    python -m eggfusion_tpu_torch.main --config configs/tum/fr1_desk.yaml
    python -m eggfusion_tpu_torch.main --synthetic --resume results/synthetic_run_torch/checkpoint.npz

A run reconstructs the sequence, then calls `finish()` (the global keyframe
optimization, `final_surfels.ply`, `checkpoint.npz`) and each evaluation its
config enables (trajectory, render, reconstruction).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_frame(dataset, fid: int, preload: bool, device, nlevel: int = 3, programs=None):
    """Frame `fid` of `dataset` (the next one of its prefetch with
    `preload`) on `device`, prepared through the "frame" program of
    `programs` (a system's `programs`) when given."""
    from eggfusion_tpu_torch.core.frame import Frame

    nlevel = getattr(dataset, "frame_nlevel", nlevel)
    bilateral = getattr(dataset, "bilateral_mode", "exact")
    ts, color, depth, mask, gt_pose = dataset.get_buffer_frame() if preload else dataset[fid]
    if isinstance(mask, np.ndarray):
        # the validity mask is the dataset's (its undistortion map): upload
        # it once per dataset and device
        cached = getattr(dataset, "_mask_dev", None)
        if cached is None or cached[0] != str(device):
            cached = dataset._mask_dev = (str(device), torch.as_tensor(mask, dtype=torch.float32, device=device))
        mask = cached[1]
    device_feed = isinstance(color, torch.Tensor)  # float color / metric depth
    return Frame(uid=fid, ts=ts, color_u8=color, depth_raw=depth, mask=mask,
                 gt_pose_w2c=np.asarray(gt_pose), intr=dataset.intrinsics,
                 depth_scale=dataset.depth_scale, device=device, nlevel=nlevel,
                 prefiltered=device_feed, filter_depth=device_feed, bilateral=bilateral, programs=programs)


def run(cfg, max_frames: int | None = None, verbose: bool = False, resume: str | None = None,
        device=None, random_source=None, on_stage=None):
    """Reconstruct the configured sequence (from the checkpoint `resume`,
    if given), then `finish()` and the enabled evaluations; returns the
    `EGGFusion`, with the dataset it read as `dataset`. The system's
    programs are captured before frame 0 (`EGGFusion.warmup`). Seconds on
    the system: `run_wall_s` for the frame loop, `run_frame0_s` for its
    first frame, `run_finish_s` and `run_eval_s`.
    `on_stage(name, ef)`, if given, is called after the frame loop ("loop"),
    `finish()` ("finish") and the evaluations ("eval"), each after the
    device has drained."""
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.system import EGGFusion

    ef = EGGFusion(cfg, device=device, random_source=random_source)
    dataset = ef.dataset = load_dataset(cfg, ef.device)
    ef.warmup()
    start = 0
    if resume:
        ef.resume(resume)
        start = ef.mapper.time
    n = len(dataset) if max_frames is None else min(len(dataset), max_frames)
    # the buffered reader starts at frame 0; a resumed run indexes directly
    preload = bool(cfg.Dataset.get("preload", True)) and start == 0
    sync = torch.cuda.synchronize if ef.device.type == "cuda" else (lambda: None)
    stage = on_stage or (lambda name, ef: None)
    t_start = time.perf_counter()
    for fid in range(start, n):
        frame = build_frame(dataset, fid, preload, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs)
        ef.reconstruct(frame)
        if fid == start:  # frame 0 carries the init burst: timed apart
            sync()
            ef.run_frame0_s = time.perf_counter() - t_start
        if verbose or fid % 25 == 0:
            m = ef.metrics[-1]
            print(f"frame {fid}/{n}  track {m['track_ms']:.1f}ms  map {m['map_ms']:.1f}ms  "
                  f"post {m['post_ms']:.1f}ms  surfels {int(m['surfels'])}")
    sync()
    ef.run_wall_s = time.perf_counter() - t_start
    done = n - start
    print(f"Processed {done} frames in {ef.run_wall_s:.2f}s ({done / max(ef.run_wall_s, 1e-9):.2f} FPS)")
    stage("loop", ef)

    t0 = time.perf_counter()
    ef.finish()
    sync()
    ef.run_finish_s = time.perf_counter() - t0
    stage("finish", ef)

    t0 = time.perf_counter()
    s = cfg.System
    if s.get("eval_tracking", True):
        ef.evaluate_trajectory()
    if s.get("eval_render", False):
        ef.evaluate_render()
    if s.get("eval_recon", False):
        ef.evaluate_recon()
    sync()
    ef.run_eval_s = time.perf_counter() - t0
    stage("eval", ef)
    return ef


def main(argv=None):
    parser = argparse.ArgumentParser(description="EggFusion RGB-D dense SLAM (PyTorch / CUDA)")
    parser.add_argument("--config", type=str, default=None, help="scene yaml (configs/)")
    parser.add_argument("--synthetic", action="store_true", help="run the built-in synthetic sequence")
    parser.add_argument("--frames", type=int, default=None, help="limit number of frames")
    parser.add_argument("--resume", type=str, default=None, help="resume from a checkpoint.npz")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from eggfusion_tpu_torch import config as cfglib

    if args.config:
        cfg = cfglib.load_config(args.config)
    elif args.synthetic:
        cfg = cfglib.default_config()
        cfg.System.save_dir = "results/synthetic_run_torch"
    else:
        parser.error("either --config or --synthetic is required")
    return run(cfg, max_frames=args.frames, verbose=args.verbose, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
