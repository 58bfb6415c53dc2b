"""Per-device-count scaling table of the multichip dryrun, on GPUs (the
port's counterpart of `tools/mesh_scaling.py`).

    python -m eggfusion_tpu_torch.mesh_scaling [--width 128 --height 64 --frames 8 --max-surfels 8192]
        [--window N] [--no-shard-tracking] [--raster-cap C --opt-raster-cap C] [--device cpu]

Runs `parallel.mesh.run_multichip_dryrun`'s pipeline on meshes of 1, 2 and 4
GPUs (the counts above the visible GPUs are skipped, one line each), each
twice: on CUDA graphs (the system's default) and eagerly
(`EGGFusion(graphs=False)`), and writes `chiprun_out/mesh_scaling_torch.json`:
one row per count with the graph run's dryrun keys and

- `steady_ms_per_frame`: the median of `frame_s` over the frames from the
  one at which the sliding window first holds all its members
  (`window_full_frame`; None, with the median, when it never does). Before
  that, `window_batch` leaves the padding members out, so some GPUs render
  nothing;
- `window`: the sliding window's size, the same in every row (`--window`;
  by default the configuration's 3): every row runs the same algorithm on
  the same keyframes. A GPU whose block of the window batch holds no
  member renders nothing, so on 4 GPUs a window of 3 leaves GPU 3 idle;
  `--window 4` gives each of them a member;
- `overrides`: the configuration changed from the dryrun's by the options
  (`--no-shard-tracking`: GN on the first GPU alone, no pixel sharding;
  `--raster-cap` / `--opt-raster-cap`: the slab caps, 256 / 128 in the
  dryrun);
- `launches_by_gpu`: the forward and backward compositor launches of the
  run on each GPU (graph replays counted, and the eager runs before each
  capture: `warm_launches_by_gpu` counts those alone);
- `traj_max_abs_diff`: the largest difference of its trajectory (c2w
  matrices) from the first row's;
- `eager`: the eager run's `steady_ms_per_frame`, `window_full_frame`,
  `wall_s` and `launches_by_gpu`, and `graphs_bit_equal`: whether the two
  runs' trajectories and final maps hold the same bits;
- `captures_after_window_full`: the graphs captured after the frame at
  which the window first holds all its members (a rung the map grows onto
  is captured there).

The card's name and power limit (`nvidia-smi`) go into the file beside the
rows. `--device cpu` runs the same on 1, 2 and 4 shards of the CPU (a CPU
run's times are not device times).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics

import torch

from eggfusion_tpu_torch.utils.device import gpu_name_and_limit

COUNTS = (1, 2, 4)
KERNELS = ("composite_fwd", "composite_bwd")


def steady(frame_s: list, window_sizes: list, window: int) -> tuple[int | None, float | None]:
    """(window_full_frame, steady_ms_per_frame) of one run."""
    full = next((i for i, n in enumerate(window_sizes) if n >= window), None)
    if full is None:
        return None, None
    return full, 1e3 * statistics.median(frame_s[full:])


def _run(cfg, device, graphs) -> tuple[dict, object]:
    """One dryrun of `cfg` with `graphs`: its dryrun keys with the window
    sizes, the steady time and the launches by GPU, and its `EGGFusion`."""
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.parallel import mesh as pmesh

    rt.reset_launch_counts()
    result, ef, window_sizes = pmesh.dryrun(cfg, device, graphs=graphs)
    by_dev = dict(rt.LAUNCHES_BY_DEVICE)
    full, ms = steady(result["frame_s"], window_sizes, int(cfg.Tracking.sliding_window_size))
    mesh = [str(d) for d in ef.mapper.devices]
    by_gpu = lambda counts: {k: [counts.get(f"{k}:{d}", 0) for d in dict.fromkeys(mesh)] for k in KERNELS}
    return {**result, "window_sizes": window_sizes, "window_full_frame": full, "steady_ms_per_frame": ms,
            "launches_by_gpu": by_gpu(by_dev), "warm_launches_by_gpu": by_gpu(ef.programs.warm_launches)}, ef


def row(n: int, width: int, height: int, frames: int, max_surfels: int, overrides: dict | None,
        device) -> tuple[dict, object]:
    """One row of the table (the dryrun's configuration with `overrides`),
    and the graph run's `EGGFusion`. Where the system's programs run
    eagerly anyway (on the CPU) the eager columns are that run's own."""
    from eggfusion_tpu_torch.core.surfels import FIELDS
    from eggfusion_tpu_torch.parallel import mesh as pmesh
    from eggfusion_tpu_torch.utils.graphs import same_bits

    cfg = pmesh.dryrun_config(n, width, height, frames, max_surfels, overrides)
    r, ef = _run(cfg, device, None)
    eager, equal = r, True
    if ef.programs.enabled:
        eager, ef_e = _run(cfg, device, False)
        equal = ef._traj_np("est").tobytes() == ef_e._traj_np("est").tobytes() and all(
            same_bits(getattr(ef.mapper.surfels, f), getattr(ef_e.mapper.surfels, f)) for f in FIELDS)
        del ef_e
    full, captures = r["window_full_frame"], r["captures"]
    return {**r, "window": int(cfg.Tracking.sliding_window_size), "overrides": overrides or {},
            "captures_after_window_full": None if full is None else captures[-1] - captures[full],
            "graphs_bit_equal": equal,
            "eager": {k: eager[k] for k in ("steady_ms_per_frame", "window_full_frame", "wall_s",
                                            "launches_by_gpu")}}, ef


def table(width: int = 128, height: int = 64, frames: int = 8, max_surfels: int = 8192,
          overrides: dict | None = None, counts=COUNTS, device=None) -> dict:
    """The scaling table over `counts` devices (on CUDA: those that fit the
    visible GPUs; on the CPU: shards of the CPU device)."""
    dev = torch.device(device if device is not None else "cuda")
    visible = torch.cuda.device_count() if dev.type == "cuda" else max(counts)
    run = [n for n in counts if n <= visible]
    for n in counts:
        if n > visible:
            print(f"skip {n} devices (have {visible})", flush=True)
    rows, base = [], None
    for n in run:
        r, ef = row(n, width, height, frames, max_surfels, overrides, dev)
        est = ef._traj_np("est")
        base = est if base is None else base
        r["traj_max_abs_diff"] = float(abs(est - base).max())
        del ef
        rows.append(r)
        print(json.dumps({k: v for k, v in r.items() if k not in ("frame_s", "window_sizes", "captures")}),
              flush=True)
    return {"gpu": gpu_name_and_limit() if dev.type == "cuda" else None, "device": dev.type,
            "gpus_visible": torch.cuda.device_count(), "rows": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="multichip dryrun scaling table on 1, 2 and 4 GPUs")
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--max-surfels", type=int, default=8192)
    p.add_argument("--window", type=int, default=None,
                   help="sliding window size of every row (default: the configuration's, 3)")
    p.add_argument("--no-shard-tracking", action="store_true", help="Tracking.shard_tracking false")
    p.add_argument("--raster-cap", type=int, default=None, help="System.raster_cap (dryrun: 256)")
    p.add_argument("--opt-raster-cap", type=int, default=None, help="System.opt_raster_cap (dryrun: 128)")
    p.add_argument("--device", default="cuda", help="cuda (GPUs) or cpu (shards of the CPU)")
    p.add_argument("--out", default=os.path.join("chiprun_out", "mesh_scaling_torch.json"))
    a = p.parse_args(argv)
    tracking = {k: v for k, v in (("sliding_window_size", a.window),
                                  ("shard_tracking", False if a.no_shard_tracking else None)) if v is not None}
    system = {k: v for k, v in (("raster_cap", a.raster_cap), ("opt_raster_cap", a.opt_raster_cap)) if v is not None}
    overrides = {k: v for k, v in (("Tracking", tracking), ("System", system)) if v}
    out = table(a.width, a.height, a.frames, a.max_surfels, overrides, device=a.device)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}), flush=True)
    return out


if __name__ == "__main__":
    main()
