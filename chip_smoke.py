"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:
  1. build  — compile the CUDA kernels of eggfusion_tpu_torch/csrc with nvcc
              (all sources at once) and load them;
  2. check  — run each kernel and its plain PyTorch version on the same
              inputs at the main path's shapes (a 1280x704 view of the
              synthetic map spawned from frame 0, 262144 slots: 220 tiles,
              CAP 2048 forward, CAP 1024 with a tile subset backward), hold
              them to the stated tolerances and time both;
  3. main   — `eggfusion_tpu_torch.main.run` on 48 frames of the synthetic
              sequence at 1280x704 in the slice configuration
              (`eggfusion_tpu_torch.config.slice_config`: `bench.py`'s
              workload, 8 + 40 frames), with the launch counts
              zeroed just before and read just after; fails unless the
              forward and backward kernels ran, ATE < 1 cm and the map is
              non-empty;
  4. burst  — the same with `Mapping.opt_schedule: burst` for 7 frames, so
              frame 6 is an optimization frame; fails unless the
              geometry-only kernel ran.
Then the kernels line, the card's `nvidia-smi` name and power limit, and
the last line {"ok": true, "device": {...}}. Any failure exits non-zero
before the last line. Needs no network; JAX is not imported.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet) used for the least-time bound
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations per visited (pixel, entry) pair, counting exp and divide
# as one and a fused multiply-add as two. Every visited pair needs its alpha
# (17; the backward evaluates it twice, 34). A live pair (alpha >= ALPHA_EPS)
# needs in addition the surfel-plane depth (6), weight and transmittance (3)
# and the accumulation (2 per channel: 8 channels full, 2 geometry-only);
# in the backward, the 15 gradients and the suffix update (76).
OPS_ALPHA = {"composite_fwd": 17, "composite_geom": 17, "composite_bwd": 34}
OPS_LIVE = {"composite_fwd": 6 + 3 + 16, "composite_geom": 6 + 3 + 4, "composite_bwd": 76}
FWD_TOL = 1e-4  # |kernel - plain| / (1 + |plain|): expf and FMA contraction differ
BWD_TOL = 1e-3  # per gradient column, relative to its largest value: reduction order differs


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(name: str, pairs: int, live_pairs: int, bytes_moved: int) -> tuple[float, str]:
    t_ops = (pairs * OPS_ALPHA[name] + live_pairs * OPS_LIVE[name]) / PEAK_FP32_FLOPS * 1e3
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(cfglib, torch) -> dict:
    """Phase 2: each kernel against its plain version on a real map."""
    from eggfusion_tpu_torch.core import surfels as sf
    from eggfusion_tpu_torch.core.mapper import Mapping
    from eggfusion_tpu_torch.core.renderer import Renderer
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
    from eggfusion_tpu_torch.ops import raster_common as rc
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.system import preprocess_frame_map

    dev = torch.device("cuda")
    cfg = cfglib.slice_config(2, os.path.join(OUT_DIR, "check"))
    ds = load_dataset(cfg, dev)
    renderer = Renderer(cfg, dev)
    mapper = Mapping(cfg, renderer, dev)
    frame = build_frame(ds, 0, False, dev)
    frame.update_transform_gt()
    p0 = frame.pyramid[0]
    fm = preprocess_frame_map(frame.color, frame.depth, p0.vertex, p0.normal, frame.mask, frame.intr,
                              frame.w2c_matrix(), 5.0)
    with torch.no_grad():
        s, _, _ = mapper.map_update(mapper.surfels, fm, frame.w2c_matrix(), frame.intr, 0, frame.width,
                                    frame.height, True, True)
    # view the map from frame 1's pose, as the next frame's model render does
    w2c = torch.as_tensor(ds[1][4], device=dev)
    intr = frame.intr
    W, H = frame.width, frame.height
    hp, wp, tx, ty = rt._grid(W, H)
    n_tiles = tx * ty
    params = sf.render_params(s)
    proj = rc.project_surfels(params, w2c, intr, W, H, 0)
    attrs = torch.cat([proj.mean2d, proj.conic, proj.opacity[None], proj.color, proj.normal_cam,
                       proj.p_cam, torch.ones_like(proj.opacity)[None]], dim=0).T.contiguous()
    results = {"surfels": int(s.num_active()), "tiles": n_tiles}

    def entries_for(cap, need_back):
        sid, counts, back, _ = rt._bin_entries(proj.depth, proj.mean2d, proj.radius, proj.valid,
                                               n_tiles, tx, ty, cap, need_back=need_back)
        return attrs[sid].contiguous(), counts, back

    def errs_of(a, b):  # (relative to 1 + |plain|, absolute)
        return float(((a - b).abs() / (1 + b.abs())).max()), float((a - b).abs().max())

    # ---- forward, full and geometry-only, CAP 2048 ----
    cap = 2048
    entries, counts, _ = entries_for(cap, False)
    n_pairs = int(torch.clamp(counts, max=cap // rt.N_SUB).sum()) * rt.TILE_H * rt.SUB_W
    n_entries = int(torch.clamp(counts, max=cap // rt.N_SUB).sum())
    live_pairs = rt.count_live_pairs(entries, counts, tx, cap)
    for geom, name in ((False, "composite_fwd"), (True, "composite_geom")):
        k_out = rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
        torch.cuda.synchronize()
        p_out = rt._split(rt._tiles_to_image(rt.composite_plain(entries, counts, intr, tx, cap, geom), tx), geom)
        errs = [errs_of(a, b) for a, b in zip(k_out, p_out)]
        ms = cuda_ms(lambda: rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom), reps=20)
        plain_ms = cuda_ms(lambda: rt.composite_plain(entries, counts, intr, tx, cap, geom), reps=2, warm=1)
        planes = 3 if geom else 9
        bytes_moved = n_entries * 64 + counts.numel() * 4 + 16 + planes * hp * wp * 4
        b_ms, b_by = bound_ms(name, n_pairs, live_pairs, bytes_moved)
        results[name] = {"cap": cap, "entries": n_entries, "pairs": n_pairs, "live_pairs": live_pairs,
                         "max_abs_err": max(e[1] for e in errs), "max_rel_err": max(e[0] for e in errs),
                         "tol": FWD_TOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        emit({"phase": "check", "kernel": name, **results[name]})
        if not all(torch.isfinite(x).all() for x in k_out):
            fail(f"{name}: non-finite output")
        if results[name]["max_rel_err"] > FWD_TOL:
            fail(f"{name}: kernel differs from its plain version by {results[name]['max_rel_err']}")

    # ---- backward, CAP 1024 with a half tile subset ----
    cap = 1024
    entries, counts, _ = entries_for(cap, True)
    keep = torch.rand(n_tiles, generator=torch.Generator(device=dev).manual_seed(7), device=dev) < 0.5
    counts = torch.where(keep[:, None], counts, torch.zeros_like(counts))
    rgb, nrm, dep, opa, T = rt.composite_fwd(entries, counts, intr, tx, cap)
    g = torch.Generator(device=dev).manual_seed(11)
    cots = [torch.randn(x.shape, generator=g, device=dev) for x in (rgb, nrm, dep, opa, T)]
    d_k = rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)
    torch.cuda.synchronize()
    d_p = rt.composite_bwd_plain(entries, counts, intr, *cots, tx, cap, tile_batch=16)
    col_scale = d_p.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    rel = float(((d_k - d_p).abs().amax(dim=(0, 1)) / col_scale)[:15].max())
    n_entries = int(torch.clamp(counts, max=cap // rt.N_SUB).sum())
    n_pairs = n_entries * rt.TILE_H * rt.SUB_W
    live_pairs = rt.count_live_pairs(entries, counts, tx, cap)
    ms = cuda_ms(lambda: rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap), reps=20)
    plain_ms = cuda_ms(lambda: rt.composite_bwd_plain(entries, counts, intr, *cots, tx, cap, tile_batch=16),
                       reps=1, warm=0)
    bytes_moved = n_entries * 64 + counts.numel() * 4 + 16 + 10 * hp * wp * 4 + entries.numel() * 4
    b_ms, b_by = bound_ms("composite_bwd", n_pairs, live_pairs, bytes_moved)
    results["composite_bwd"] = {"cap": cap, "kept_tiles": int(keep.sum()), "entries": n_entries, "pairs": n_pairs,
                                "live_pairs": live_pairs,
                                "max_abs_err": float((d_k - d_p).abs().max()), "max_rel_err": rel,
                                "tol": BWD_TOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "check", "kernel": "composite_bwd", **results["composite_bwd"]})
    if not torch.isfinite(d_k).all():
        fail("composite_bwd: non-finite gradients")
    if rel > BWD_TOL:
        fail(f"composite_bwd: kernel differs from its plain version by {rel} (relative)")
    # determinism: a second launch gives the same bits
    if not torch.equal(d_k, rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)):
        fail("composite_bwd: two launches disagree")
    return results


def drive(cfglib, torch, n_frames: int, burst: bool) -> dict:
    """Phases 3 and 4: the main path through `main.run`, with the launch
    counts zeroed just before and read just after."""
    from eggfusion_tpu_torch.main import run
    from eggfusion_tpu_torch.ops import raster_tile as rt

    name = "burst" if burst else "main"
    cfg = cfglib.slice_config(n_frames, os.path.join(OUT_DIR, name), burst=burst)
    rt.reset_launch_counts()
    ef = run(cfg)  # the default device: CUDA
    torch.cuda.synchronize()
    launches = dict(rt.LAUNCHES)
    ate = ef.evaluate_trajectory()
    n_active = int(ef.mapper.surfels.num_active())
    track = [m["track_ms"] for m in ef.metrics]
    total = [m["track_ms"] + m["map_ms"] + m["post_ms"] for m in ef.metrics]
    out = {"phase": name, "frames": n_frames, "wall_s": ef.run_wall_s, "fps": n_frames / ef.run_wall_s,
           "fps_after_frame0": (n_frames - 1) / max(ef.run_wall_s - ef.run_frame0_s, 1e-9),
           "frame_ms": [round(t, 3) for t in total], "track_ms": [round(t, 3) for t in track],
           "ate_cm": ate, "active_surfels": n_active, "opt_steps": ef.mapper.opt_steps_total,
           "launches": launches, "model_cap_switches": ef.mapper.cap_switches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    mm = ef.model_map
    if not all(torch.isfinite(mm[k]).all() for k in ("rendered_color", "rendered_depth")):
        fail(f"{name}: non-finite model view")
    if not (ate < 1.0):
        fail(f"{name}: ATE {ate} cm >= 1 cm")
    if not 0 < n_active <= 262144:
        fail(f"{name}: map has {n_active} active surfels")
    for k in ("composite_fwd", "composite_bwd") + (("composite_geom",) if burst else ()):
        if launches[k] <= 0:
            fail(f"{name}: kernel {k} was never launched on this path")
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "eggfusion_tpu_torch", "csrc")):
        fail("eggfusion_tpu_torch/ not found beside chip_smoke.py: run from a checkout of the repository")
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    from eggfusion_tpu_torch import config as cfglib
    from eggfusion_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    gpu = smi[0] if smi else "unknown"
    t0 = time.perf_counter()
    report = cuda_build.build()
    ptxas = {k: [ln.strip() for ln in v["log"].splitlines() if "registers" in ln or "spill" in ln]
             for k, v in report.items()}
    for name in cuda_build.SIGNATURES:
        cuda_build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda, "ptxas": ptxas})

    checks = check_kernels(cfglib, torch)
    main_run = drive(cfglib, torch, n_frames=48, burst=False)
    burst_run = drive(cfglib, torch, n_frames=7, burst=True)

    src = "eggfusion_tpu_torch/csrc/"
    rows = [
        ("composite_fwd", src + "composite_fwd.cu", "eggfusion_tpu/ops/raster_pallas.py:586", main_run),
        ("composite_geom", src + "composite_fwd.cu", "eggfusion_tpu/ops/raster_pallas.py:565", burst_run),
        ("composite_bwd", src + "composite_bwd.cu", "eggfusion_tpu/ops/raster_pallas.py:597", main_run),
    ]
    kernels = []
    for name, source, replaces, path in rows:
        c = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": path["launches"][name], "max_abs_err": c["max_abs_err"],
                        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": None})
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "checks": checks, "main": main_run, "burst": burst_run, "kernels": kernels},
                  f, indent=1)
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
