"""CLI driver (port of `eggfusion_tpu/main.py`).

Usage (on a CUDA GPU):
    python -m eggfusion_tpu_torch.main --synthetic --frames 30 --verbose

`run` stops after the frame loop and the trajectory evaluation; the JAX
driver's `finish()` (global optimization, PLY and checkpoint export) and
render/recon evaluations are not ported.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_frame(dataset, fid: int, preload: bool, device, nlevel: int = 3):
    from eggfusion_tpu_torch.core.frame import Frame

    nlevel = getattr(dataset, "frame_nlevel", nlevel)
    bilateral = getattr(dataset, "bilateral_mode", "exact")
    ts, color, depth, mask, gt_pose = dataset.get_buffer_frame() if preload else dataset[fid]
    device_feed = isinstance(color, torch.Tensor)  # float color / metric depth
    return Frame(uid=fid, ts=ts, color_u8=color, depth_raw=depth, mask=mask,
                 gt_pose_w2c=np.asarray(gt_pose), intr=dataset.intrinsics,
                 depth_scale=dataset.depth_scale, device=device, nlevel=nlevel,
                 prefiltered=device_feed, filter_depth=device_feed, bilateral=bilateral)


def run(cfg, max_frames: int | None = None, verbose: bool = False, device=None,
        random_source=None):
    """Reconstruct the configured sequence; returns the `EGGFusion`."""
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.system import EGGFusion

    ef = EGGFusion(cfg, device=device, random_source=random_source)
    dataset = load_dataset(cfg, ef.device)
    n = len(dataset) if max_frames is None else min(len(dataset), max_frames)
    preload = bool(cfg.Dataset.get("preload", True))
    sync = torch.cuda.synchronize if ef.device.type == "cuda" else (lambda: None)
    t_start = time.perf_counter()
    for fid in range(n):
        frame = build_frame(dataset, fid, preload, ef.device, nlevel=ef.nlevel)
        ef.reconstruct(frame)
        if fid == 0:  # frame 0 carries the init burst: timed apart
            sync()
            ef.run_frame0_s = time.perf_counter() - t_start
        if verbose or fid % 25 == 0:
            m = ef.metrics[-1]
            print(f"frame {fid}/{n}  track {m['track_ms']:.1f}ms  map {m['map_ms']:.1f}ms  "
                  f"post {m['post_ms']:.1f}ms  surfels {int(m['surfels'])}")
    sync()
    wall = time.perf_counter() - t_start
    ef.run_wall_s = wall
    print(f"Processed {n} frames in {wall:.2f}s ({n / max(wall, 1e-9):.2f} FPS)")
    if cfg.System.get("eval_tracking", True):
        ef.evaluate_trajectory()
    return ef


def main(argv=None):
    parser = argparse.ArgumentParser(description="EggFusion RGB-D dense SLAM (PyTorch / CUDA)")
    parser.add_argument("--synthetic", action="store_true", help="run the built-in synthetic sequence")
    parser.add_argument("--frames", type=int, default=None, help="limit number of frames")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if not args.synthetic:
        parser.error("--synthetic is required (the port has the synthetic dataset only)")

    from eggfusion_tpu_torch import config as cfglib

    # tracking recovery is not ported: recover_after 0 disables it
    cfg = cfglib.default_config(Tracking={"recover_after": 0})
    cfg.System.save_dir = "results/synthetic_run_torch"
    return run(cfg, max_frames=args.frames, verbose=args.verbose, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
