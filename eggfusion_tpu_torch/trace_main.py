"""Trace the port's main path on a CUDA GPU and report where the time goes.

    python -m eggfusion_tpu_torch.trace_main --frames 48 --warmup 8
    python -m eggfusion_tpu_torch.trace_main --mesh --frames 32 --warmup 12

Runs `EGGFusion.reconstruct` over the synthetic sequence in the slice
configuration (`config.slice_config`: `bench.py`'s 1280x704 workload with a
fixed 262144-slot map and no frame cycling), its programs on CUDA graphs
after `EGGFusion.warmup` as `main.run` runs them: `--warmup` frames, then
half of the rest timed without the profiler, then the other half under
`torch.profiler` (CPU + CUDA). Prints one JSON line: the untraced frame
time, device time per frame and by kernel name from the trace (kernels
replayed from a graph included), the device busy share (device time per
frame over the untraced frame time), the host-side phase times per frame
and the programs captured in the timed and traced frames. `--mesh` traces
instead the one-GPU row of `mesh_scaling.py`'s 640x480 table at the
default slab caps (`parallel.mesh.dryrun_config`: `mesh_devices: 1`,
262144 slots, a window of 4, the window-batched step every frame).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eggfusion_tpu_torch.config import slice_config
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
    from eggfusion_tpu_torch.system import EGGFusion

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=48)
    parser.add_argument("--warmup", type=int, default=8)
    parser.add_argument("--top", type=int, default=25, help="kernels listed by device time")
    parser.add_argument("--mesh", action="store_true", help="trace the 640x480 mesh configuration on one GPU")
    args = parser.parse_args(argv)

    save_dir = os.path.join("chiprun_out", "trace_main")
    if args.mesh:
        from eggfusion_tpu_torch.parallel.mesh import dryrun_config

        cfg = dryrun_config(1, 640, 480, args.frames, 262144, {
            "Tracking": {"sliding_window_size": 4},
            "System": {"raster_cap": 2048, "opt_raster_cap": 1024, "save_dir": save_dir}})
    else:
        cfg = slice_config(args.frames, save_dir)
    ef = EGGFusion(cfg)
    dataset = ef.dataset = load_dataset(cfg, ef.device)
    ef.warmup()

    def step(fid):
        ef.reconstruct(build_frame(dataset, fid, False, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs))

    # warm-up, then an untimed-by-profiler half (frame rate), then a traced
    # half (device time: the profiler slows the host, not the kernels)
    mid = (args.warmup + args.frames) // 2
    for fid in range(args.warmup):
        step(fid)
    torch.cuda.synchronize()
    captures = ef.programs.captures()
    t0 = time.perf_counter()
    for fid in range(args.warmup, mid):
        step(fid)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / (mid - args.warmup)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fid in range(mid, args.frames):
            step(fid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.frames - mid

    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    metrics = ef.metrics[args.warmup:mid]
    phase_ms = {p: sum(m[p] for m in metrics) / max(len(metrics), 1) for p in ("track_ms", "map_ms", "post_ms")}
    out = {
        "gpu": torch.cuda.get_device_name(0),
        "mesh_devices": int(args.mesh),
        "captures_after_warmup_frames": ef.programs.captures() - captures,
        "untraced_frames": mid - args.warmup,
        "untraced_ms_per_frame": untraced_ms,
        "untraced_fps": 1e3 / untraced_ms,
        "traced_frames": n,
        "traced_ms_per_frame": wall * 1e3 / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "device_busy_share_untraced": busy_us / 1e3 / n / untraced_ms,
        "kernel_launches_per_frame": sum(k[1] for k in kernels) / n,
        "host_phase_ms_per_frame": phase_ms,
        "top_kernels": [{"name": k[2][:120], "ms_per_frame": k[0] / 1e3 / n, "calls_per_frame": k[1] / n}
                        for k in kernels[:args.top]],
        "ate_cm": ef.evaluate_trajectory(),
        "active_surfels": int(ef.mapper.surfels.num_active()),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
