"""Benchmark of the PyTorch / CUDA port: end-to-end track+map frames per
second on `bench.py`'s workload, on one CUDA GPU.

    python3 bench_torch.py

The workload and sequence are `bench.py`'s (the JAX package's benchmark),
built through the port's `config.default_config`: 1280x704 synthetic
frames (10 unique, kept on the device), a 600000-surfel map on the capacity
ladder, SH 0, `local_map_iter` 3, `opt_step_scale` 0.5, pyramid iterations
[3, 3, 2], finest solver stride 4, the separable bilateral filter, no final
global optimization. `EGGFusion.warmup` captures the frame's programs and
builds the CUDA kernels before any frame; then 8 warm-up frames,
`maintain_map`, 2 absorb frames (they capture the programs of the rung the
maintenance shrank the map to), `maintain_map`, and 40 frames timed
between two device fences. The same `BENCH_*` environment knobs as
`bench.py`: WARMUP, FRAMES, WIDTH, HEIGHT, SURFELS, UNIQUE_FRAMES, LMI, SKIP,
MVDOWN, STRIDE_FINE, RASTER_CAP, BILATERAL.

Prints one JSON line {"metric", "value", "unit", "vs_baseline"} (against
30 FPS, `BASELINE.md`); phase timings, the host dispatch ms of each timed
frame, the device tail and the graph captures made during the timed frames
(0 when every program was captured before) go to stderr.
"""
from __future__ import annotations

import json
import os
import sys
import time

BASELINE_FPS = 30.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_config(n_frames: int, env=os.environ):
    """`bench.py`'s configuration through the port's `default_config`, for a
    sequence of `n_frames` frames, with the `BENCH_*` knobs of `env`."""
    from eggfusion_tpu_torch import config as cfglib

    width = int(env.get("BENCH_WIDTH", 1280))
    height = int(env.get("BENCH_HEIGHT", 704))
    system = {"save_dir": "results/bench_torch", "final_global_opt": False, "bilateral_mode": "separable"}
    if env.get("BENCH_RASTER_CAP"):
        system["raster_cap"] = int(env["BENCH_RASTER_CAP"])
    if env.get("BENCH_BILATERAL"):
        system["bilateral_mode"] = env["BENCH_BILATERAL"]
    tracking = {"pyramid_iters": [3, 3, 2], "solver_stride_fine": 4}
    if env.get("BENCH_MVDOWN") == "2":
        tracking.update(model_view_down=2, solver_stride=1)
    if env.get("BENCH_STRIDE_FINE") is not None:
        tracking["solver_stride_fine"] = int(env["BENCH_STRIDE_FINE"])
    mapping = {"local_map_iter": int(env.get("BENCH_LMI", 3)), "opt_step_scale": 0.5}
    if env.get("BENCH_SKIP") == "1":
        mapping["settled_skip"] = True
    return cfglib.default_config(
        Dataset={"type": "synthetic", "n_frames": n_frames,
                 "unique_frames": int(env.get("BENCH_UNIQUE_FRAMES", 10)), "device_frames": True,
                 "preload": False,
                 "Calibration": {"fx": 600.0, "fy": 600.0, "cx": width / 2 - 0.5, "cy": height / 2 - 0.5,
                                 "width": width, "height": height, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": int(env.get("BENCH_SURFELS", 600_000))},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Mapping=mapping,
        Tracking=tracking,
        System=system,
    )


def main(device=None) -> dict:
    """Run the benchmark and print its line; returns the line's dict with
    the graph captures made in the timed frames (`captures_timed`), their
    wall and host-dispatch seconds and their kernel launches. `device` None is CUDA (raises without a
    GPU); the tests pass "cpu"."""
    import torch

    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
    from eggfusion_tpu_torch.ops.raster_tile import LAUNCHES
    from eggfusion_tpu_torch.system import EGGFusion

    n_warm = int(os.environ.get("BENCH_WARMUP", 8))
    n_frames = int(os.environ.get("BENCH_FRAMES", 40))
    cfg = bench_config(n_warm + n_frames)
    t_init = time.perf_counter()
    ef = EGGFusion(cfg, device=device)
    dataset = ef.dataset = load_dataset(cfg, ef.device)
    log(f"[bench] dataset ready in {time.perf_counter() - t_init:.1f}s")
    cuda = ef.device.type == "cuda"

    def device_fence():
        if cuda:
            torch.cuda.synchronize(ef.device)

    def frame(fid: int):
        ef.reconstruct(build_frame(dataset, fid, False, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs))

    t1 = time.perf_counter()
    ef.warmup()
    log(f"[bench] warmup (kernel build + {ef.programs.captures()} program captures) in "
        f"{time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    warm_ms = []
    for fid in range(n_warm):
        tf = time.perf_counter()
        frame(fid)
        device_fence()
        warm_ms.append((time.perf_counter() - tf) * 1e3)
    # maintenance prunes frame 0's spawn burst and shrinks the map to the
    # steady rung; the absorb frames capture that rung's programs
    ef.mapper.maintain_map()
    for fid in range(2):
        frame(fid % n_warm)
        device_fence()
    ef.mapper.maintain_map()
    device_fence()
    log(f"[bench] {n_warm} warmup frames in {time.perf_counter() - t1:.1f}s (per frame: "
        + " ".join(f"{t:.0f}" for t in warm_ms) + f"); steady capacity {ef.mapper.surfels.capacity}")

    captures0 = ef.programs.captures()
    launches0 = dict(LAUNCHES)
    device_fence()
    t0 = time.perf_counter()
    per_frame = []  # host dispatch ms per frame (not device time)
    for fid in range(n_warm, n_warm + n_frames):
        tf = time.perf_counter()
        frame(fid)
        per_frame.append((time.perf_counter() - tf) * 1e3)
    device_fence()
    wall = time.perf_counter() - t0
    dispatch = sum(per_frame) / 1e3
    captures_timed = ef.programs.captures() - captures0
    launches = {k: LAUNCHES[k] - launches0[k] for k in LAUNCHES}
    log(f"[bench] {n_frames} timed frames in {wall:.3f}s (host dispatch {dispatch:.3f}s, "
        f"device tail {wall - dispatch:.3f}s); graph captures in the timed frames: {captures_timed}")
    log("[bench] per-frame host-dispatch ms: " + " ".join(f"{t:.1f}" for t in per_frame))
    log(f"[bench] surfels at end: {int(ef.mapper.surfels.num_active())}, capacity {ef.mapper.surfels.capacity}")

    fps = n_frames / wall
    name = torch.cuda.get_device_name(ef.device) if cuda else "cpu"
    w, h = cfg.Dataset.Calibration.width, cfg.Dataset.Calibration.height
    line = {"metric": f"synthetic {w}x{h} track+map FPS ({name})", "value": round(fps, 3), "unit": "fps",
            "vs_baseline": round(fps / BASELINE_FPS, 4)}
    print(json.dumps(line), flush=True)
    return {**line, "captures_timed": captures_timed, "wall_s": wall, "dispatch_s": dispatch, "launches": launches}


if __name__ == "__main__":
    main()
