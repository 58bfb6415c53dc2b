"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line:
  1. build  — compile the CUDA kernels of eggfusion_tpu_torch/csrc with nvcc
              (all sources at once, each also without its row cull:
              `cuda_build.NO_CULL`) and load them; report each kernel's
              registers and spills (ptxas) and resident blocks per SM;
  2. check  — run each kernel and its plain PyTorch version on the same
              inputs at the main path's shapes (a 1280x704 view of the
              synthetic map spawned from frame 0, 262144 slots: 220 tiles,
              CAP 2048 forward; CAP 1024 with a tile subset, the opt step's
              shape, for the backward and again for the forward), hold
              them to the stated tolerances and time both (`ms`: single
              calls, `stream_ms`: back-to-back launches); hold each kernel
              bit for bit to its build without the cull; count the visited,
              kept (rows the cull keeps) and live pairs;
     adversarial — each kernel against its plain version and, bit for bit,
              against its build without the cull on the row cull's
              adversarial slabs (`raster_slabs`), on the wide ones (the
              forward's float32 drift reported against float64, not held
              to its tolerance) and on a fully culled slab;
  3. main   — `eggfusion_tpu_torch.main.run` on 48 frames of the synthetic
              sequence at 1280x704 in the slice configuration
              (`eggfusion_tpu_torch.config.slice_config`: `bench.py`'s
              workload, 8 + 40 frames, tracking recovery on) with
              `final_global_opt` on; the launch counts are zeroed just
              before the frame loop and read and zeroed again after it,
              after `finish()` and after the evaluations (`run`'s
              `on_stage`); fails unless the forward and backward kernels
              ran in the loop, ATE < 1 cm and the map is non-empty;
     finish — the same run's `finish()` and evaluations: keyframes,
              global-opt steps, seconds, launches of each, the PLY's bytes
              and surfels, whether `checkpoint.npz` loads back bit for bit,
              keyframe PSNR / SSIM / depth-L1, the held-out views, recon F1
              and accuracy at 2 cm; fails unless both compositors ran in
              `finish()`, the checkpoint round-trips and the evaluations
              keep the bounds `tests/test_system_e2e.py` holds the JAX
              system to;
  4. burst  — the same with `Mapping.opt_schedule: burst` for 7 frames, so
              frame 6 is an optimization frame; fails unless the
              geometry-only kernel ran;
  5. recovery — 20 frames with `texture_detail` 0.25, frames 6-8 corrupted
              (no depth, flat color) as in `tests/test_recovery.py`, through
              `EGGFusion.reconstruct`; fails unless recovery fired, its
              re-anchor launched the forward kernel and the ATE over the
              good frames is < 3 cm;
  6. resume — a new `EGGFusion` resumes from the main phase's checkpoint and
              reconstructs frames 48-51; fails unless the frame clock and
              the active surfels equal the saved ones at load and the ATE
              over all 52 frames is < 1 cm;
  7. tum    — `configs/tum/fr1_desk.yaml` as it stands (640x480, its five
              lens coefficients, `use_sparse`, a 3M `max_surfels_num` on the
              capacity ladder) through `main.run` on a 60-frame TUM-layout
              recording written by the port's PNG writer under build/ (the
              `room` scene on an orbit of 1 degree a frame, forward-distorted,
              sensor noise, jittered timestamps, one unmatched image); prints
              the capacity of every frame, the sparse-seed count, FPS,
              frame-0 seconds, the prefetch thread's ms per frame (decode
              and undistortion; the first includes the g++ builds of the
              frame loader and the PNG unfilter), keyframe PSNR /
              depth-L1, recon F1, and the steady FPS over 20 frames on the
              ladder and on a fixed 3M map in turns; holds every kernel to
              its plain version (and bit for bit to its build without the
              cull) on the final map seen from the last frame, 75 tiles, at
              the model render's and the opt step's shapes (phase
              "tum_check": a value off by more than the tolerance passes
              only if the plain version is as far off its float64
              evaluation, as at edge-on plane depths); runs the same
              configuration on 16 noise-free frames of the `corner` scene,
              where the dense solve is well posed; fails unless the
              undistortion is live, sparse seeds cover half the frames, ATE <
              3 cm, the map is finite, keyframe PSNR > 12 dB, depth-L1 <
              0.15 m and recon F1 > 0.7, the map grew and ended below 3M,
              the forward and backward kernels ran, and the dense solve
              converged on half the corner frames with ATE < 1 cm;
  8. variants — the JAX package's run modes, 24 frames each of the slice
              configuration: the model view at 1/2 with solver stride 1
              (`Tracking.model_view_down`), at the model-render cap 2048 and
              at 4096 (the cap the 1/2 view needs), the settled-frame render skip
              (`Mapping.settled_skip`; wider tolerances, said so in the
              line, if the defaults never fire) and the GN early exit
              (`Tracking.early_exit`); prints each run's
              frames per second beside the main phase's, ATE, the model
              pyramid's base, the skipped frames and the GN iterations run;
              holds every kernel to its plain version on the 1/2 view of the
              cap-4096 run's map ("variants_check"); fails unless ATE < 1 cm
              (< 3 cm with the early exit), the cap-4096 map stays under
              200k surfels, a render was skipped and both kernels ran;
  9. mesh   — the window-batched, keyframe-sharded optimization with
              pixel-sharded tracking (`System.mesh_devices`), 24 frames
              each eager and on CUDA graphs: on one GPU, then with 2 shards
              both on cuda:0 (trajectory within 5e-4 of the first), 7
              frames of the burst schedule with the 1/2 view under a mesh
              (the geometry-only kernel must run), then, with 2 or more
              GPUs, on min(4, count) GPUs (the same agreement, both kernels
              launched on every GPU, the backward on the last one held to
              its plain version with phase "tum_check"'s float64 band and
              to the same launch on cuda:0 bit for bit; with one GPU the
              line says so); fails unless
              ATE < 1 cm, batched steps ran, each graph run is bit-equal to
              its eager twin, captures nothing after the frame that fills
              its window and launches each kernel on each GPU as often as
              its eager twin once the eager runs before its captures are
              set apart; prints host launch calls a frame (3 profiled
              frames) and the batched step's ms in both.
              `python3 chip_smoke.py --phase mesh` runs the build and the
              multi-GPU part alone.
 10. dryrun — the entry points (`eggfusion_tpu_torch.entry`, the
              counterparts of `__graft_entry__.py`):
              `entry()` (one render of `render_xla` plus the mapping loss) on
              the card, whose loss and gradients must be finite and agree
              with the same function on CPU tensors (the loss within 1e-4,
              the gradients as `entry_card_vs_cpu` says), its forward +
              backward timed; `dryrun_multichip(1)` and the same dryrun on 2
              shards both on cuda:0, whose own assertions must hold and whose
              trajectories must agree within 5e-4, both compositors
              launched; every kernel against its plain version on the
              dryrun's final map at its caps (256, 128: "dryrun_check"); the
              OpenCV frontend and the live Azure Kinect dataset raise their
              RuntimeError where `cv2` / `pyk4a` are missing.
              `python3 chip_smoke.py --phase scaling` runs the build and
              `eggfusion_tpu_torch.mesh_scaling`'s table on 1, 2 and 4 GPUs
              (those visible) at the JAX dryrun's size and at 640x480 over
              32 frames, there also without the pixel-sharded tracker and
              at the default slab caps (on a machine with 4 GPUs for the
              4-GPU rows).
 11. graphs — the compile layer (`eggfusion_tpu_torch/utils/graphs.py`):
              two 24-frame runs of the slice configuration from the same
              seed, eager (`EGGFusion(graphs=False)`) and on CUDA graphs
              (the default), whose trajectories and final maps must agree bit
              for bit; one replay of each captured program (tracking, frame,
              map update, opt step) against an eager call on the same inputs,
              bit for bit; host launches and device kernels per frame
              (`torch.profiler`, 3 more frames), ms per frame and FPS after
              frame 0, capture seconds per program and pool bytes per rung;
              then one line of `bench_torch.main()` at its default workload,
              which must capture no graph in its timed frames, and the
              memory `warmup` holds with `System.precompile_ladder` on that
              workload. `python3 chip_smoke.py --phase graphs` runs the
              build and this phase alone.
Every phase runs on CUDA graphs wherever its path is captured (the system's
default); the launch counts add each graph's kernel launches at every
replay, so they count real launches.
After phase 3 ("frustum"), one forward render of the main path's final map
through the frustum compaction (`raster_tile.frustum_compact`) against the
uncompacted render of the surfels it keeps and against the full render,
each within the forward tolerance, both timed.
Then the kernels line, the card's `nvidia-smi` name and power limit, and
the last line {"ok": true, "device": {...}}. Any failure exits non-zero
before the last line. Needs no network; JAX is not imported.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import statistics
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet) used for the least-time bound
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations per (pixel, entry) pair, counting exp and divide as one
# and a fused multiply-add as two. The bound charges an alpha (17) to every
# pair in the rows the exact row cull keeps: the others have alpha 0 and need
# no work. A live pair (alpha >= ALPHA_EPS) needs in addition the
# surfel-plane depth (6), weight and transmittance (3) and the accumulation
# (2 per channel: 8 channels full, 2 geometry-only); in the backward, the 15
# gradients and the suffix update (76). `bound_ms_visited` keeps the earlier
# formula for comparison: every visited pair its alpha (twice in the
# backward), the same live work.
OPS_ALPHA = 17
OPS_ALPHA_VISITED = {"composite_fwd": 17, "composite_geom": 17, "composite_bwd": 34}
OPS_LIVE = {"composite_fwd": 6 + 3 + 16, "composite_geom": 6 + 3 + 4, "composite_bwd": 76}
FWD_TOL = 1e-4  # |kernel - plain| / (1 + |plain|): expf and FMA contraction differ
BWD_TOL = 1e-3  # per gradient column, relative to its largest value: reduction order differs


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_times(fn, reps: int, warm: int = 2) -> list[float]:
    """Device milliseconds of each of `reps` calls of `fn` (CUDA events),
    after `warm` calls."""
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
    return times


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    return statistics.median(cuda_times(fn, reps, warm))


def stream_ms(fn, reps: int = 20, per: int = 10) -> float:
    """Device milliseconds of one call of `fn`: the median over `reps` of
    CUDA events around `per` back-to-back calls, divided by `per` (the
    launches queue up, so the host's launch latency is hidden)."""
    return statistics.median(t / per for t in cuda_times(lambda: [fn() for _ in range(per)], reps, warm=1))


def bound(name: str, pc: dict, bytes_moved: int) -> dict:
    """The least time of the kernel's work on these inputs: the larger of
    its operations over the FP32 peak and its bytes over the memory rate."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = (pc["kept_pairs"] * OPS_ALPHA + pc["live_pairs"] * OPS_LIVE[name]) / PEAK_FP32_FLOPS * 1e3
    t_visited = (pc["pairs"] * OPS_ALPHA_VISITED[name] + pc["live_pairs"] * OPS_LIVE[name]) / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_visited": max(t_visited, t_bytes)}


def ptxas_usage(report: dict) -> dict:
    """Registers, stack and spill bytes of each kernel from the ptxas report
    of `cuda_build.build()` (the forward library holds the full and the
    geometry-only instantiation)."""
    out: dict = {}
    for (lib, defines), v in report.items():
        if defines:
            continue
        name = None
        for ln in v["log"].splitlines():
            if "Compiling entry function" in ln:
                name = "composite_geom" if (lib == "composite_fwd" and "ILb1E" in ln) else lib
            elif name and "spill stores" in ln:
                stack, stores, loads = (int(x) for x in re.findall(r"(\d+) bytes", ln)[:3])
                out.setdefault(name, {}).update(stack_bytes=stack, spill_store_bytes=stores,
                                                spill_load_bytes=loads)
            elif name and "registers" in ln:
                out.setdefault(name, {})["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def map_view(torch, s, w2c, intr, W: int, H: int) -> dict:
    """The surfel map `s` seen from the camera `w2c` as a model render sees
    it: the camera, the tile grid, `slab(cap, need_back) -> (entries,
    counts)` binning it at a cap, and `keep`, the opt step's tile subset
    (about half the tiles, from a fixed seed)."""
    from eggfusion_tpu_torch.core import surfels as sf
    from eggfusion_tpu_torch.ops import raster_common as rc
    from eggfusion_tpu_torch.ops import raster_tile as rt

    dev = w2c.device
    hp, wp, tx, ty = rt._grid(W, H)
    n_tiles = tx * ty
    with torch.no_grad():
        proj = rc.project_surfels(sf.render_params(s), w2c, intr, W, H, 0)
    attrs = torch.cat([proj.mean2d, proj.conic, proj.opacity[None], proj.color, proj.normal_cam,
                       proj.p_cam, torch.ones_like(proj.opacity)[None]], dim=0).T.contiguous()

    def slab(cap, need_back=False):
        sid, counts, _, _ = rt._bin_entries(proj.depth, proj.mean2d, proj.radius, proj.valid,
                                            n_tiles, tx, ty, cap, need_back=need_back)
        return attrs[sid].contiguous(), counts

    keep = torch.rand(n_tiles, generator=torch.Generator(device=dev).manual_seed(7), device=dev) < 0.5
    return {"surfels": int(s.num_active()), "size": [W, H], "intr": intr, "tx": tx, "n_tiles": n_tiles,
            "hp": hp, "wp": wp, "slab": slab, "keep": keep}


def main_path_view(cfglib, torch) -> dict:
    """The map spawned from frame 0 of the main path's sequence, seen from
    frame 1's pose as the next frame's model render sees it (`map_view`).
    Shared by the kernel checks and the kernel probe."""
    from eggfusion_tpu_torch.core.mapper import Mapping
    from eggfusion_tpu_torch.core.renderer import Renderer
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
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
    return map_view(torch, s, torch.as_tensor(ds[1][4], device=dev), frame.intr, frame.width, frame.height)


def pair_counts(rt, entries, counts, tx, cap) -> dict:
    """Visited, kept (rows the cull keeps) and live (alpha > 0) pairs."""
    n_entries = int(counts.clamp(max=cap // rt.N_SUB).sum())
    return {"entries": n_entries, "pairs": n_entries * rt.TILE_H * rt.SUB_W,
            "kept_pairs": rt.count_kept_pairs(entries, counts, tx, cap),
            "live_pairs": rt.count_live_pairs(entries, counts, tx, cap)}


def fwd_errors(k_out, p_out) -> tuple[float, float]:
    """(max relative error against 1 + |plain|, max absolute error)."""
    rel = max(float(((a - b).abs() / (1 + b.abs())).max()) for a, b in zip(k_out, p_out))
    return rel, max(float((a - b).abs().max()) for a, b in zip(k_out, p_out))


def bwd_errors(d_k, d_p) -> tuple[float, float]:
    """(max over gradient columns of the error relative to the column's
    largest plain value, max absolute error)."""
    col_scale = d_p.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    return float(((d_k - d_p).abs().amax(dim=(0, 1)) / col_scale)[:15].max()), float((d_k - d_p).abs().max())


def no_cull(rt, cuda_build):
    """(forward, backward) launchers of the kernels built without the row
    cull, with the wrappers' arguments; their launches are not counted."""
    fwd_lib = cuda_build.load("composite_fwd", cuda_build.NO_CULL)
    bwd_lib = cuda_build.load("composite_bwd", cuda_build.NO_CULL)
    return (lambda *a, geom=False: rt._launch_fwd(fwd_lib, *a, geom),
            lambda *a: rt._launch_bwd(bwd_lib, *a))


def same_bits(a, b) -> bool:
    """Two output tuples hold equal values (a zero's sign aside)."""
    return all(bool((x == y).all()) for x, y in zip(a, b))


def fwd_misses(k_out, p_out, p64) -> tuple[int, int, float, float]:
    """Pixels where the forward misses FWD_TOL of its float32 plain version
    and also lies further from the plain version's float64 evaluation than
    FWD_TOL plus the float32 plain version's own distance from it (the
    float32 evaluation is ill-conditioned there, e.g. the plane depth of a
    surfel seen edge-on); the pixels held by that second rule; the largest
    errors of the kernel and of the float32 plain version against float64,
    relative to 1 + |float64|."""
    misses = held = 0
    k64 = p64_rel = 0.0
    for a, b, c in zip(k_out, p_out, p64):
        a, b = a.double(), b.double()
        off = (a - b).abs() > FWD_TOL * (1 + b.abs())
        within = (a - c).abs() <= FWD_TOL * (1 + c.abs()) + (b - c).abs()
        misses += int((off & ~within).sum())
        held += int((off & within).sum())
        k64 = max(k64, float(((a - c).abs() / (1 + c.abs())).max()))
        p64_rel = max(p64_rel, float(((b - c).abs() / (1 + c.abs())).max()))
    return misses, held, k64, p64_rel


def bwd_misses(d_k, d_p, d_64) -> tuple[int, int, float, float]:
    """As `fwd_misses` for the backward, with errors relative to each
    gradient column's largest plain value (BWD_TOL)."""
    d_k, d_p = d_k.double(), d_p.double()
    scale = d_p.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    off = (d_k - d_p).abs() > BWD_TOL * scale
    within = (d_k - d_64).abs() <= BWD_TOL * scale + (d_p - d_64).abs()
    rel = lambda x: float(((x - d_64).abs().amax(dim=(0, 1)) / scale)[:15].max())
    return int((off & ~within)[..., :15].sum()), int((off & within)[..., :15].sum()), rel(d_k), rel(d_p)


def check_view(torch, view: dict, timed: bool, phase: str, f64_band: bool = False, cap: int = 2048,
               opt_cap: int = 1024) -> dict:
    """Each kernel against its plain version on the binned map of `view`,
    at the shapes a frame gives it: the forward, full and geometry-only, at
    CAP `cap` over all tiles (the model render), the full forward and the
    backward at CAP `opt_cap` over the opt step's tile subset. Each is held to
    its tolerance and bit for bit to its build without the cull; with
    `f64_band`, a value off its float32 plain version by more than the
    tolerance passes only where the plain version is itself as far off its
    float64 evaluation (`fwd_misses`, `bwd_misses`). With `timed`, kernel
    and plain version are timed too. Emits one line per kernel under
    `phase`."""
    from eggfusion_tpu_torch.ops import cuda_build
    from eggfusion_tpu_torch.ops import raster_tile as rt

    intr, tx, n_tiles, hp, wp = (view[k] for k in ("intr", "tx", "n_tiles", "hp", "wp"))
    fwd_nc, bwd_nc = no_cull(rt, cuda_build)
    results = {"surfels": view["surfels"], "size": view["size"], "tiles": n_tiles}

    def subset(counts):
        return torch.where(view["keep"][:, None], counts, torch.zeros_like(counts))

    def check_fwd(entries, counts, cap, geom):
        k_out = rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
        torch.cuda.synchronize()
        p_out = rt._split(rt._tiles_to_image(rt.composite_plain(entries, counts, intr, tx, cap, geom), tx), geom)
        if not all(torch.isfinite(x).all() for x in k_out):
            fail(f"{phase}: forward (geom={geom}, cap {cap}): non-finite output")
        rel, ab = fwd_errors(k_out, p_out)
        r = {"max_abs_err": ab, "max_rel_err": rel, "no_cull_same_bits": True}
        if f64_band and rel > FWD_TOL:
            p64 = rt._split(rt._tiles_to_image(rt.composite_plain(entries.double(), counts, intr.double(), tx, cap,
                                                                  geom), tx), geom)
            misses, held, k64, p64_rel = fwd_misses(k_out, p_out, p64)
            r.update(band_held_values=held, rel_err_vs_f64=k64, plain_rel_err_vs_f64=p64_rel)
            if misses:
                fail(f"{phase}: forward (geom={geom}, cap {cap}): {misses} values differ from the plain version "
                     f"by more than {FWD_TOL} and from its float64 evaluation by more than the plain version")
        elif rel > FWD_TOL:
            fail(f"{phase}: forward (geom={geom}, cap {cap}): kernel differs from its plain version by {rel}")
        if not same_bits(k_out, fwd_nc(entries, counts, intr, tx, cap, geom=geom)):
            fail(f"{phase}: forward (geom={geom}, cap {cap}): the row cull changes the output")
        if timed:
            call = lambda: rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
            times = cuda_times(call, reps=20)
            r.update(ms=statistics.median(times), ms_min_max=[min(times), max(times)], stream_ms=stream_ms(call),
                     no_cull_stream_ms=stream_ms(lambda: fwd_nc(entries, counts, intr, tx, cap, geom=geom)))
        return r

    # ---- forward, full and geometry-only, CAP `cap` over all tiles (the
    # model render), and the full forward at the opt step's shape too ----
    entries, counts = view["slab"](cap)
    pc = pair_counts(rt, entries, counts, tx, cap)
    opt_entries, opt_counts = view["slab"](opt_cap)
    opt_counts = subset(opt_counts)
    for geom, name in ((False, "composite_fwd"), (True, "composite_geom")):
        r = check_fwd(entries, counts, cap, geom)
        results[name] = {"cap": cap, **pc, **r, "tol": FWD_TOL}
        if timed:
            plain_ms = cuda_ms(lambda: rt.composite_plain(entries, counts, intr, tx, cap, geom), reps=2, warm=1)
            planes = 3 if geom else 9
            bytes_moved = pc["entries"] * 64 + counts.numel() * 4 + 16 + planes * hp * wp * 4
            results[name].update(plain_ms=plain_ms, **bound(name, pc, bytes_moved))
        if not geom:
            r2 = check_fwd(opt_entries, opt_counts, opt_cap, False)
            if timed:
                results[name]["ms_by_shape"] = {f"cap{cap}_all_tiles": r["ms"],
                                                f"cap{opt_cap}_half_tiles": r2["ms"]}
            results[name]["opt_shape"] = {"cap": opt_cap, "kept_tiles": int(view["keep"].sum()),
                                          **pair_counts(rt, opt_entries, opt_counts, tx, opt_cap), **r2}
        emit({"phase": phase, "kernel": name, **results[name]})

    # ---- backward, CAP `opt_cap` with a half tile subset (the opt step) ----
    cap = opt_cap
    entries, counts = opt_entries, opt_counts
    rgb, nrm, dep, opa, T = rt.composite_fwd(entries, counts, intr, tx, cap)
    g = torch.Generator(device="cuda").manual_seed(11)
    cots = [torch.randn(x.shape, generator=g, device=x.device) for x in (rgb, nrm, dep, opa, T)]
    d_k = rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)
    torch.cuda.synchronize()
    d_p = rt.composite_bwd_plain(entries, counts, intr, *cots, tx, cap, tile_batch=16)
    rel, ab = bwd_errors(d_k, d_p)
    pc = pair_counts(rt, entries, counts, tx, cap)
    results["composite_bwd"] = {"cap": cap, "kept_tiles": int(view["keep"].sum()), **pc,
                                "max_abs_err": ab, "max_rel_err": rel, "tol": BWD_TOL}
    misses = 0
    if f64_band and rel > BWD_TOL:
        d_64 = rt.composite_bwd_plain(entries.double(), counts, intr.double(), *(c.double() for c in cots), tx, cap,
                                      tile_batch=16)
        misses, held, k64, p64_rel = bwd_misses(d_k, d_p, d_64)
        results["composite_bwd"].update(band_held_values=held, rel_err_vs_f64=k64, plain_rel_err_vs_f64=p64_rel)
    if timed:
        call = lambda: rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)
        times = cuda_times(call, reps=20)
        plain_ms = cuda_ms(lambda: rt.composite_bwd_plain(entries, counts, intr, *cots, tx, cap, tile_batch=16),
                           reps=1, warm=0)
        bytes_moved = pc["entries"] * 64 + counts.numel() * 4 + 16 + 10 * hp * wp * 4 + entries.numel() * 4
        results["composite_bwd"].update(
            ms=statistics.median(times), ms_min_max=[min(times), max(times)], stream_ms=stream_ms(call),
            no_cull_stream_ms=stream_ms(lambda: bwd_nc(entries, counts, intr, *cots, T, tx, cap)),
            plain_ms=plain_ms, **bound("composite_bwd", pc, bytes_moved))
    emit({"phase": phase, "kernel": "composite_bwd", **results["composite_bwd"]})
    if not torch.isfinite(d_k).all():
        fail(f"{phase}: composite_bwd: non-finite gradients")
    if misses:
        fail(f"{phase}: composite_bwd: {misses} gradients differ from the plain version by more than {BWD_TOL} "
             f"and from its float64 evaluation by more than the plain version")
    if rel > BWD_TOL and not f64_band:
        fail(f"{phase}: composite_bwd: kernel differs from its plain version by {rel} (relative)")
    # determinism: a second launch gives the same bits, and so does the build without the cull
    if not torch.equal(d_k, rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)):
        fail(f"{phase}: composite_bwd: two launches disagree")
    if not torch.equal(d_k, bwd_nc(entries, counts, intr, *cots, T, tx, cap)):
        fail(f"{phase}: composite_bwd: the row cull changes the gradients")
    return results


def check_kernels(cfglib, torch) -> dict:
    """Phase 2: each kernel against its plain version on the main path's
    map, bit for bit against its build without the cull, and timed."""
    return check_view(torch, main_path_view(cfglib, torch), timed=True, phase="check")


def check_adversarial(torch) -> dict:
    """Phase 2b: every kernel on the adversarial slabs of the row cull
    (`raster_slabs.adversarial_slab`) at caps 256, 1024 and 2048, bit for
    bit against its build without the cull, and against its plain version
    within the tolerances; on the wide ones the forward is not held to its
    tolerance: its drift from a float64 evaluation of the plain version is
    reported beside the float32 plain version's own. And on a slab the
    cull drops whole, which must give T = 1, empty channels and zero
    gradients exactly."""
    from eggfusion_tpu_torch.ops import cuda_build, raster_slabs
    from eggfusion_tpu_torch.ops import raster_tile as rt

    dev = "cuda"
    fwd_nc, bwd_nc = no_cull(rt, cuda_build)
    out = {}
    cases = [(f"{kind}_cap{cap}", cap, raster_slabs.adversarial_slab(cap, seed=cap, wide=kind == "wide"))
             for kind in ("adversarial", "wide") for cap in (256, 1024, 2048)]
    cases.append(("culled_cap2048", 2048, raster_slabs.culled_slab(2048)))
    for label, cap, (entries, counts, intr, tx) in cases:
        wide = label.startswith("wide")
        ins = [x.to(dev) for x in (entries, counts, intr)]
        row = pair_counts(rt, entries, counts, tx, cap)
        for geom in (False, True):
            tag = "fwd_geom" if geom else "fwd"
            k_out = rt.composite_fwd(*ins, tx, cap, geom=geom)
            p_out = [x.to(dev) for x in rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)]
            rel, _ = fwd_errors(k_out, p_out)
            row[f"{tag}_rel_err"] = rel
            if not all(torch.isfinite(x).all() for x in k_out):
                fail(f"{label}: forward (geom={geom}) gives non-finite values")
            if not same_bits(k_out, fwd_nc(*ins, tx, cap, geom=geom)):
                fail(f"{label}: forward (geom={geom}): the row cull changes the output")
            if wide:
                p64 = rt._split(rt._tiles_to_image(rt.composite_plain(entries.double(), counts, intr.double(), tx,
                                                                      cap, geom), tx), geom)
                p64 = [x.to(dev) for x in p64]
                row[f"{tag}_rel_err_vs_f64"] = fwd_errors([x.double() for x in k_out], p64)[0]
                row[f"{tag}_plain_rel_err_vs_f64"] = fwd_errors([x.double() for x in p_out], p64)[0]
            elif rel > FWD_TOL:
                fail(f"{label}: forward (geom={geom}) differs from its plain version by {rel}")
            if label.startswith("culled") and not (torch.equal(k_out[-1], torch.ones_like(k_out[-1]))
                                                   and all(float(x.abs().max()) == 0 for x in k_out[:-1])):
                fail(f"{label}: forward (geom={geom}) of a fully culled slab is not empty")
        T = rt.composite_fwd(entries, counts, intr, tx, cap)[4]
        g = torch.Generator().manual_seed(cap)
        cots = [torch.randn(s, generator=g) for s in ((3,) + T.shape, (3,) + T.shape, T.shape, T.shape, T.shape)]
        d_p = rt.composite_bwd_plain(entries, counts, intr, *cots, tx, cap)
        bwd_ins = ins + [x.to(dev) for x in cots] + [T.to(dev)]
        d_k = rt.composite_bwd(*bwd_ins, tx, cap)
        rel, _ = bwd_errors(d_k.cpu(), d_p)
        row["bwd_rel_err"] = rel
        if not torch.isfinite(d_k).all():
            fail(f"{label}: backward gives non-finite values")
        if not torch.equal(d_k, bwd_nc(*bwd_ins, tx, cap)):
            fail(f"{label}: backward: the row cull changes the gradients")
        if rel > BWD_TOL:
            fail(f"{label}: backward differs from its plain version by {rel}")
        if label.startswith("culled") and float(d_k.abs().max()) != 0:
            fail(f"{label}: backward of a fully culled slab is not zero")
        row["no_cull_same_bits"] = True
        out[label] = row
        emit({"phase": "adversarial", "slab": label, "cap": cap, **row})
    return out


def drive(cfglib, torch, n_frames: int, burst: bool, final_global_opt: bool = False):
    """Phases 3 and 4: the main path through `main.run`, with the launch
    counts zeroed just before the frame loop and read (then zeroed) after
    the loop, after `finish()` and after the evaluations. Returns the
    phase's record, the launches of each stage and the system."""
    from eggfusion_tpu_torch.main import run
    from eggfusion_tpu_torch.ops import raster_tile as rt

    name = "burst" if burst else "main"
    cfg = cfglib.slice_config(n_frames, os.path.join(OUT_DIR, name), burst=burst,
                              final_global_opt=final_global_opt)
    stages = {}

    def on_stage(stage, ef):
        stages[stage] = dict(rt.LAUNCHES)
        rt.reset_launch_counts()

    rt.reset_launch_counts()
    ef = run(cfg, on_stage=on_stage)  # the default device: CUDA
    launches = stages["loop"]
    ate = ef.evaluate_trajectory(plot=False)
    n_active = int(ef.mapper.surfels.num_active())
    frames = [m for m in ef.metrics if m["frame"] >= 0]
    track = [m["track_ms"] for m in frames]
    total = [m["track_ms"] + m["map_ms"] + m["post_ms"] for m in frames]
    out = {"phase": name, "frames": n_frames, "wall_s": ef.run_wall_s, "fps": n_frames / ef.run_wall_s,
           "fps_after_frame0": (n_frames - 1) / max(ef.run_wall_s - ef.run_frame0_s, 1e-9),
           "frame_ms": [round(t, 3) for t in total], "track_ms": [round(t, 3) for t in track],
           "ate_cm": ate, "active_surfels": n_active, "opt_steps": frames[-1]["opt_steps"],
           "launches": launches, "recoveries": len(ef.metrics) - len(frames),
           "model_cap_switches": ef.mapper.cap_switches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "graph_captures": ef.programs.captures(), "warmup_s": ef.warmup_s}
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
    return out, stages, ef


def same_map_bits(a, b) -> bool:
    """Every field of two surfel maps holds the same bits."""
    from eggfusion_tpu_torch.core.surfels import FIELDS

    return all(getattr(a, f).cpu().numpy().tobytes() == getattr(b, f).cpu().numpy().tobytes() for f in FIELDS)


def check_finish(torch, ef, stages: dict, loop_steps: int) -> dict:
    """Phase 3b: what the main run's `finish()` and evaluations did."""
    from eggfusion_tpu_torch.io import checkpoint as ckpt
    from eggfusion_tpu_torch.io import ply as plyio

    ply = os.path.join(ef.save_dir, "final_surfels.ply")
    s, extra = ckpt.load_checkpoint(os.path.join(ef.save_dir, "checkpoint.npz"), ef.device)
    round_trip = (same_map_bits(s, ef.mapper.surfels) and int(extra["time"]) == ef.mapper.time
                  and np.array_equal(extra["traj_est"], ef._traj_np("est")))
    with open(os.path.join(ef.save_dir, "render_metrics.json")) as f:
        render = json.load(f)
    recon = ef.evaluate_recon(thresh=0.02)
    held = render["held_out"]
    kf = render["mean"]
    out = {"phase": "finish", "keyframes": ef.mapper.keyframe_manager.ids(),
           "global_opt_steps": ef.mapper.opt_steps_total - loop_steps,
           "finish_s": ef.run_finish_s, "eval_s": ef.run_eval_s,
           "launches_finish": stages["finish"], "launches_eval": stages["eval"],
           "ply_bytes": os.path.getsize(ply), "ply_surfels": len(plyio.load_ply(ply)["xyz"]),
           "active_surfels": int(ef.mapper.surfels.num_active()), "checkpoint_bit_exact": round_trip,
           "psnr": kf["psnr"], "ssim": kf["ssim"], "ms_ssim": kf["ms_ssim"], "depth_l1": kf["depth_l1"],
           "heldout_frames": [r["frame"] for r in held.get("per_frame", [])],
           "heldout_psnr": held.get("mean", {}).get("psnr"), "heldout_depth_l1": held.get("mean", {}).get("depth_l1"),
           "recon_f1_2cm": recon.get("recon_f1"), "recon_acc_mean_2cm": recon.get("recon_acc_mean")}
    emit(out)
    for k in ("composite_fwd", "composite_bwd"):
        if stages["finish"][k] <= 0:
            fail(f"finish: kernel {k} was never launched by finish()")
    if not round_trip:
        fail("finish: checkpoint.npz does not load back bit for bit")
    if out["ply_surfels"] != out["active_surfels"]:
        fail(f"finish: the PLY holds {out['ply_surfels']} surfels, the map {out['active_surfels']}")
    if not (kf["psnr"] > 12.0 and kf["depth_l1"] < 0.15):
        fail(f"finish: keyframe render metrics {kf}")
    if not (held and held["mean"]["psnr"] > 10.0 and held["mean"]["depth_l1"] < 0.2):
        fail(f"finish: held-out render metrics {held}")
    if not (recon.get("recon_f1", 0.0) > 0.7 and recon["recon_acc_mean"] < 0.05):
        fail(f"finish: recon metrics at 2 cm {recon}")
    return out


def check_recovery(cfglib, torch, n_frames: int = 20, bad=range(6, 9)) -> dict:
    """Phase 5: tracking loss on corrupted frames and the recovery, through
    `EGGFusion.reconstruct`; the re-anchor's launches are counted around
    `_recover_tracking`."""
    from eggfusion_tpu_torch.core.frame import Frame
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.system import EGGFusion
    from eggfusion_tpu_torch.utils import eval as evalu

    cfg = cfglib.merge(cfglib.slice_config(n_frames, os.path.join(OUT_DIR, "recovery")),
                       {"Dataset": {"texture_detail": 0.25}})
    ef = EGGFusion(cfg)
    dev = ef.device
    ds = load_dataset(cfg, dev)
    recoveries = []
    plain_recover = ef._recover_tracking

    def counted_recover(frame=None):
        torch.cuda.synchronize()
        before, t0 = dict(rt.LAUNCHES), time.perf_counter()
        ok = plain_recover(frame)
        torch.cuda.synchronize()
        recoveries.append({"frame": frame.uid, "ms": (time.perf_counter() - t0) * 1e3,
                           "fwd_launches": rt.LAUNCHES["composite_fwd"] - before["composite_fwd"],
                           **{k: v for k, v in ef.metrics[-1].items() if k != "frame"}})
        return ok

    ef._recover_tracking = counted_recover
    H, W = ds.intrinsics.height, ds.intrinsics.width
    rt.reset_launch_counts()
    t0 = time.perf_counter()
    for fid in range(n_frames):
        if fid in bad:
            frame = Frame(uid=fid, ts=ds.ts[fid], color_u8=torch.full((H, W, 3), 0.5, device=dev),
                          depth_raw=torch.zeros((H, W, 1), device=dev), mask=torch.ones((H, W, 1), device=dev),
                          gt_pose_w2c=ds.poses[fid], intr=ds.intrinsics, depth_scale=1.0, device=dev,
                          nlevel=ef.nlevel_frame, prefiltered=True, filter_depth=True, bilateral=ds.bilateral_mode)
        else:
            frame = build_frame(ds, fid, False, dev, nlevel=ef.nlevel_frame)
        ef.reconstruct(frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(rt.LAUNCHES)
    good = [i for i in range(n_frames) if i not in bad]
    ref, est = ef._traj_np("ref"), ef._traj_np("est")
    ate = evalu.ate_rmse(ref[good][:, :3, 3], est[good][:, :3, 3])
    frames = {m["frame"]: m for m in ef.metrics if m["frame"] >= 0}
    for r in recoveries:
        r["frame_ms"] = frames[r["frame"]]["track_ms"] + frames[r["frame"]]["map_ms"] + frames[r["frame"]]["post_ms"]
    out = {"phase": "recovery", "frames": n_frames, "corrupted": list(bad), "wall_s": wall,
           "recoveries": recoveries, "ate_good_cm": ate, "ate_all_cm": evalu.ate_rmse(ref[:, :3, 3], est[:, :3, 3]),
           "launches": launches, "active_surfels": int(ef.mapper.surfels.num_active())}
    emit(out)
    if not recoveries:
        fail("recovery: tracking recovery never fired")
    if not all(r["fwd_launches"] > 0 for r in recoveries):
        fail(f"recovery: a re-anchor did not launch the forward kernel: {recoveries}")
    if not ate < 3.0:
        fail(f"recovery: ATE over the good frames {ate} cm >= 3 cm")
    return out


def check_resume(cfglib, torch, ckpt_path: str, saved, n_more: int = 4) -> dict:
    """Phase 6: a new system resumes the main phase's checkpoint and
    reconstructs `n_more` frames of the same sequence."""
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.system import EGGFusion
    from eggfusion_tpu_torch.utils import eval as evalu

    time0, active0 = saved
    n = time0 + n_more
    cfg = cfglib.merge(cfglib.slice_config(n, os.path.join(OUT_DIR, "resume")), {"Dataset": {"lazy_device": True}})
    rt.reset_launch_counts()
    ef = EGGFusion(cfg)
    t0 = time.perf_counter()
    ef.resume(ckpt_path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    at_load = {"time": ef.mapper.time, "active_surfels": int(ef.mapper.surfels.num_active()),
               "launches": dict(rt.LAUNCHES)}
    ds = load_dataset(cfg, ef.device)
    for fid in range(ef.mapper.time, n):
        ef.reconstruct(build_frame(ds, fid, False, ef.device, nlevel=ef.nlevel_frame))
    torch.cuda.synchronize()
    ref, est = ef._traj_np("ref"), ef._traj_np("est")
    ate = evalu.ate_rmse(ref[:, :3, 3], est[:, :3, 3])
    out = {"phase": "resume", "saved": {"time": time0, "active_surfels": active0}, "at_load": at_load,
           "load_s": load_s, "frames": len(est), "ate_cm": ate, "launches": dict(rt.LAUNCHES),
           "active_surfels": int(ef.mapper.surfels.num_active())}
    emit(out)
    if (at_load["time"], at_load["active_surfels"]) != (time0, active0):
        fail(f"resume: loaded {at_load}, saved time {time0} and {active0} active surfels")
    if len(est) != n or not ate < 1.0:
        fail(f"resume: ATE {ate} cm over {len(est)} frames")
    return out


SMOKE_RUNS = os.path.join(REPO, "build", "smoke_runs")


def variant_run(cfglib, torch, label: str, overrides: dict, n_frames: int = 24) -> tuple:
    """`main.run` over `n_frames` of the slice configuration with
    `overrides` merged in (no evaluations), the launch counts zeroed just
    before the frame loop and read just after. Returns the record and the
    system."""
    from eggfusion_tpu_torch.core import tracker as ttr
    from eggfusion_tpu_torch.main import run
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.utils import eval as evalu

    # the runs' PLY and checkpoint stay out of OUT_DIR (`check_mesh`
    # removes them)
    cfg = cfglib.merge(cfglib.slice_config(n_frames, os.path.join(SMOKE_RUNS, label)),
                       cfglib.merge(overrides, {"System": {"eval_tracking": False, "eval_render": False,
                                                           "eval_recon": False}}))
    stages = {}

    def on_stage(stage, ef):
        stages[stage] = dict(rt.LAUNCHES)
        stages[stage + "_by_device"] = dict(rt.LAUNCHES_BY_DEVICE)
        rt.reset_launch_counts()

    rt.reset_launch_counts()
    ttr.EARLY_EXIT_ITERATIONS["run"] = 0
    ef = run(cfg, on_stage=on_stage)
    ref, est = ef._traj_np("ref"), ef._traj_np("est")
    rec = {"label": label, "frames": n_frames, "fps": n_frames / ef.run_wall_s,
           "fps_after_frame0": (n_frames - 1) / max(ef.run_wall_s - ef.run_frame0_s, 1e-9),
           "ate_cm": evalu.ate_rmse(ref[:, :3, 3], est[:, :3, 3]),
           "active_surfels": int(ef.mapper.surfels.num_active()), "opt_steps": ef.mapper.opt_steps_total,
           "model_pyramid_base": list(ef.model_map["pyramid"][0].intensity.shape),
           "frame_pyramid_levels": ef.nlevel_frame,
           "launches": stages["loop"], "launches_by_device": stages["loop_by_device"]}
    return rec, ef


def check_variants(cfglib, torch, main_fps: float) -> dict:
    """Phase "variants": the JAX package's run modes on the slice
    configuration, 24 frames each: the model view at 1/2 with solver stride
    1 (`bench.py`'s BENCH_MVDOWN), and again with a model-render cap of 4096
    (the JAX package's `halfview4096` A/B arm, `tools/accuracy_ab.py`: a
    1/2-view sub-column spans twice the scene, and at cap 2048 its slab
    overflows into the spawn flood that arm measured), the settled-frame
    render skip (with wider tolerances if the defaults never fire on this
    scene), and the GN early exit. Then
    every kernel against its plain version on the half-resolution view of
    the cap-4096 run's final map, the forward at that cap."""
    from eggfusion_tpu_torch.core import tracker as ttr

    out = {"main_fps_after_frame0": main_fps}
    mvdown = {"Tracking": {"model_view_down": 2, "solver_stride": 1}}
    out["mvdown"], ef = variant_run(cfglib, torch, "mvdown", mvdown)
    del ef
    rec, ef = variant_run(cfglib, torch, "mvdown_cap4096", cfglib.merge(mvdown, {"System": {"raster_cap": 4096}}))
    out["mvdown_cap4096"] = rec
    sm, ds = ef.mapper.surfels, ef.dataset
    w2c = torch.as_tensor(np.asarray(ds[len(ds) - 1][4], np.float32), device=ef.device)
    intr = ds.intrinsics
    view = map_view(torch, sm, w2c, intr.as_tensor(ef.device) / 2, intr.width // 2, intr.height // 2)
    kernels = check_view(torch, view, timed=False, phase="variants_check", cap=4096)
    rec["kernel_check"] = {k: {"max_rel_err": v["max_rel_err"], "pairs": v["pairs"]}
                           for k, v in kernels.items() if isinstance(v, dict)}
    del ef
    skip = {"Mapping": {"settled_skip": True}}
    rec, ef = variant_run(cfglib, torch, "settled_skip", skip)
    rec["tolerances"] = "default"
    if ef.mapper.render_skips == 0:
        out["settled_skip_default"] = rec
        wide = {"settled_skip_tol_frac": 0.05, "settled_skip_max_rot": 2.0, "settled_skip_max_trans": 0.05}
        rec, ef = variant_run(cfglib, torch, "settled_skip", cfglib.merge(skip, {"Mapping": wide}))
        rec["tolerances"] = wide
    rec.update(render_skips=ef.mapper.render_skips, skip_frames=ef.mapper.skip_frames)
    out["settled_skip"] = rec
    del ef
    rec, ef = variant_run(cfglib, torch, "early_exit", {"Tracking": {"early_exit": True}})
    rec["gn_iterations"] = ttr.EARLY_EXIT_ITERATIONS["run"]
    rec["gn_iterations_configured"] = sum(ef.tracker.config.pyramid_iters) * (rec["frames"] - 1)
    out["early_exit"] = rec
    del ef
    emit({"phase": "variants", **out})
    for label in ("mvdown", "mvdown_cap4096"):
        if out[label]["model_pyramid_base"][:2] != [352, 640] or out[label]["frame_pyramid_levels"] != 4:
            fail(f"variants: {label}'s model pyramid starts at {out[label]['model_pyramid_base']}, not the 1/2 view")
    for label in ("mvdown", "mvdown_cap4096", "settled_skip"):
        for k in ("composite_fwd", "composite_bwd"):
            if out[label]["launches"][k] <= 0:
                fail(f"variants: kernel {k} was never launched on {label}")
        if not out[label]["ate_cm"] < 1.0:
            fail(f"variants: {label} ATE {out[label]['ate_cm']} cm >= 1 cm")
    # the JAX package's halfview4096 arm kept a healthy map (154013 surfels
    # against 134830 at full view): the slab must hold the 1/2 view
    if not out["mvdown_cap4096"]["active_surfels"] < 200000:
        fail(f"variants: the 1/2 view at cap 4096 grew the map to {out['mvdown_cap4096']['active_surfels']}")
    if not out["settled_skip"]["render_skips"] > 0:
        fail("variants: settled_skip never skipped a render")
    if not out["early_exit"]["ate_cm"] < 3.0:
        fail(f"variants: early_exit ATE {out['early_exit']['ate_cm']} cm >= 3 cm")
    return out


def batched_step_ms(ef) -> float:
    """Median device-clock milliseconds (CUDA events on the first GPU,
    whose Adam step waits for every GPU's gradients) of the window-batched
    step on the run's final map and window, after the run (on graphs: its
    programs' replays)."""
    m = ef.mapper
    window = list(m.keyframe_manager.sliding_window)
    batch = m._window_batch(window)
    return cuda_ms(lambda: m._window_opt_step(m.surfels, m._opt_moments, m._opt_stepno, batch, m._opt_geo,
                                              m.sw_lrs, window[0].width, window[0].height), reps=5)


def mesh_pair(cfglib, torch, label: str, overrides: dict, n_frames: int = 24) -> tuple:
    """One mesh configuration eager and on CUDA graphs (`graphs_run`, the
    slice configuration with `overrides`, `n_frames` + 3 profiled frames):
    the graph run's record with the eager run's beside it (`eager`), whether
    the two trajectories and final maps hold the same bits, the launches by
    device of the graph run less its capture runs' (`launches_by_device_net`)
    and whether they equal the eager run's, and the batched step's ms in
    both, with the graph run's trajectory under "traj". Returns it and the
    graph run's system (the eager one is dropped before it starts)."""
    from eggfusion_tpu_torch.core.surfels import FIELDS
    from eggfusion_tpu_torch.utils.graphs import same_bits

    eager, ef, traj_e, map_e = graphs_run(cfglib, torch, False, n_frames, overrides=overrides, name=label)
    # the amortized schedule's window step (the burst schedule keeps no
    # window state between its optimization frames)
    eager["batched_step_ms"] = batched_step_ms(ef) if ef.mapper._opt_geo is not None else None
    del ef
    rec, ef, traj_g, map_g = graphs_run(cfglib, torch, None, n_frames, overrides=overrides, name=label)
    rec["batched_step_ms"] = batched_step_ms(ef) if ef.mapper._opt_geo is not None else None
    net = {k: n - rec["capture_warm_launches"].get(k, 0) for k, n in rec["launches_by_device"].items()}
    net = {k: n for k, n in net.items() if n}
    rec.update(label=label, eager=eager, trajectory_bit_equal=traj_e.tobytes() == traj_g.tobytes(),
               map_fields_differing=[f for f in FIELDS if not same_bits(map_e[f], map_g[f])],
               launches_by_device_net=net, launches_equal_eager=net == eager["launches_by_device"],
               replays={k: v["replays"] for k, v in ef.programs.stats().items() if v["replays"]})
    emit({"phase": "mesh_pair", "label": label, **{k: rec[k] for k in (
        "trajectory_bit_equal", "map_fields_differing", "captures_after_window_full", "launches_equal_eager",
        "host_launches_per_frame", "ms_per_frame_after_frame0", "ms_per_frame_after_window_full", "batched_step_ms",
        "ate_cm")},
        "eager": {k: eager[k] for k in ("host_launches_per_frame", "ms_per_frame_after_frame0",
                                        "ms_per_frame_after_window_full", "batched_step_ms")}})
    rec["traj"] = traj_g
    return rec, ef


def check_mesh(cfglib, torch, n_frames: int = 24, multi_only: bool = False) -> dict:
    """Phase "mesh": the window-batched, keyframe-sharded optimization with
    pixel-sharded tracking (`System.mesh_devices`), 24 frames of the slice
    configuration, each run eager and on CUDA graphs (`mesh_pair`): on one
    GPU; with 2 shards both placed on cuda:0 (the split and the reduction
    without a second card), which must give the first run's trajectory
    within 5e-4; 7 frames of the burst schedule with the 1/2 view on one
    GPU; and, with 2 or more GPUs visible, on n = min(4, count) GPUs with a
    window of n keyframes against the same window on one GPU (on graphs):
    the same agreement, both kernels launched on every GPU, and the backward
    on the last GPU held to its plain version (with the float64 band of
    `check_view`) and bit for bit to the same launch on cuda:0. Every pair must be bit-equal,
    capture nothing after the frame that fills the window, and launch each
    kernel on each GPU as often as eager once the capture runs' launches
    are set apart; the line gives host launch calls a frame in both."""
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.parallel import mesh as pmesh

    out = {}
    if not multi_only:
        rec, ef = mesh_pair(cfglib, torch, "mesh1", {"System": {"mesh_devices": 1}}, n_frames)
        base = rec.pop("traj")
        out["mesh1"] = rec
        del ef
        real_make_mesh = pmesh.make_mesh
        pmesh.make_mesh = lambda n, device: [torch.device("cuda", 0)] * n
        try:
            rec, ef = mesh_pair(cfglib, torch, "mesh2_on_gpu0", {"System": {"mesh_devices": 2}}, n_frames)
        finally:
            pmesh.make_mesh = real_make_mesh
        rec["traj_max_abs_diff"] = float(np.abs(rec.pop("traj") - base).max())
        out["mesh2_on_gpu0"] = rec
        del ef
        # the burst schedule under a mesh with the 1/2 model view: frame 6
        # optimizes, its spawn render is the geometry-only kernel at 1/2
        rec, ef = mesh_pair(cfglib, torch, "burst_mvdown_mesh1",
                            {"Mapping": {"opt_schedule": "burst"}, "System": {"mesh_devices": 1, "raster_cap": 4096},
                             "Tracking": {"model_view_down": 2, "solver_stride": 1}}, 7)
        rec.pop("traj")
        out["burst_mvdown_mesh1"] = rec
        del ef
    count = torch.cuda.device_count()
    if count < 2:
        out["multi_gpu"] = f"not run: {count} GPU visible, no multi-GPU run possible"
    else:
        n = min(4, count)
        # a window of n keyframes, one per GPU once it fills (a GPU whose
        # block holds only padding renders nothing), in both runs
        window = {"Tracking": {"sliding_window_size": n}}
        rec, ef, base, _map = graphs_run(cfglib, torch, None, n_frames, overrides=cfglib.merge(
            window, {"System": {"mesh_devices": 1}}), name=f"mesh1_window{n}")
        rec["batched_step_ms"] = batched_step_ms(ef)
        out[f"mesh1_window{n}"] = rec
        del ef, _map
        rec, ef = mesh_pair(cfglib, torch, f"mesh{n}", cfglib.merge(window, {"System": {"mesh_devices": n}}),
                            n_frames)
        rec["traj_max_abs_diff"] = float(np.abs(rec.pop("traj") - base).max())
        # the backward on the last GPU against its plain version
        last = torch.device("cuda", n - 1)
        ds = ef.dataset
        w2c = torch.as_tensor(np.asarray(ds[len(ds) - 1][4], np.float32), device=last)
        s = ef.mapper.surfels
        s_last = s.replace(**{f: getattr(s, f).to(last) for f in ("xyz", "features_dc", "features_rest", "scaling",
                                                                   "rotation", "opacity", "active")})
        view = map_view(torch, s_last, w2c, ds.intrinsics.as_tensor(last), ds.intrinsics.width,
                        ds.intrinsics.height)
        entries, counts = view["slab"](1024)
        counts = torch.where(view["keep"][:, None], counts, torch.zeros_like(counts))
        intr, tx = view["intr"], view["tx"]
        outs = rt.composite_fwd(entries, counts, intr, tx, 1024)
        g = torch.Generator(device=last).manual_seed(11)
        cots = [torch.randn(x.shape, generator=g, device=last) for x in outs]
        d_k = rt.composite_bwd(entries, counts, intr, *cots, outs[4], tx, 1024)
        d_p = rt.composite_bwd_plain(entries, counts, intr, *cots, tx, 1024, tile_batch=16)
        rel, ab = bwd_errors(d_k, d_p)
        gpu0 = torch.device("cuda", 0)
        d_k0 = rt.composite_bwd(entries.to(gpu0), counts.to(gpu0), intr.to(gpu0), *(c.to(gpu0) for c in cots),
                                outs[4].to(gpu0), tx, 1024)
        rec["bwd_last_gpu"] = {"device": str(last), "max_rel_err": rel, "max_abs_err": ab, "tol": BWD_TOL,
                               "same_bits_on_gpu0": bool(torch.equal(d_k0.cpu(), d_k.cpu()))}
        # as in phase "tum_check": a gradient off its float32 plain version
        # by more than BWD_TOL passes only where the plain version is as far
        # off its float64 evaluation (an ill-conditioned column sum)
        if rel > BWD_TOL:
            d_64 = rt.composite_bwd_plain(entries.double(), counts, intr.double(), *(c.double() for c in cots), tx,
                                          1024, tile_batch=16)
            misses, held, k64, p64_rel = bwd_misses(d_k, d_p, d_64)
            rec["bwd_last_gpu"].update(f64_misses=misses, f64_band_held=held, rel_err_vs_f64=k64,
                                       plain_rel_err_vs_f64=p64_rel)
        out[f"mesh{n}"] = rec
        del ef
    emit({"phase": "mesh", **out})
    if count >= 2:
        rec = out[f"mesh{n}"]
        missing = [f"{k}:cuda:{i}" for k in ("composite_fwd", "composite_bwd") for i in range(n)
                   if rec["launches_by_device"].get(f"{k}:cuda:{i}", 0) <= 0]
        if missing:
            fail(f"mesh: no launches of {missing} on the {n}-GPU run")
        if not rec["traj_max_abs_diff"] <= 5e-4:
            fail(f"mesh: {n} GPUs differ from one by {rec['traj_max_abs_diff']} in the trajectory")
        b = rec["bwd_last_gpu"]
        if not b["same_bits_on_gpu0"] or b.get("f64_misses", 0):
            fail(f"mesh: the backward on {last} differs from its plain version (float64 band) or from the same "
                 f"launch on cuda:0: {b}")
    for label, r in out.items():
        if not isinstance(r, dict):
            continue
        if not (r["ate_cm"] < 1.0 and r["opt_steps"] > 0):
            fail(f"mesh: {label} ATE {r['ate_cm']} cm, {r['opt_steps']} batched steps")
        for k in ("composite_fwd", "composite_bwd"):
            if r["launches"][k] <= 0:
                fail(f"mesh: kernel {k} was never launched on {label}")
        if "eager" not in r:
            continue
        if r["mode"] != "graph" or r["eager"]["mode"] != "eager":
            fail(f"mesh: {label} ran in modes {r['mode']} / {r['eager']['mode']}, not graph / eager")
        if not r["trajectory_bit_equal"] or r["map_fields_differing"]:
            fail(f"mesh: {label} on graphs differs from eager (trajectory bit-equal {r['trajectory_bit_equal']}, "
                 f"map fields differing {r['map_fields_differing']})")
        if r["captures_after_window_full"] != 0:
            fail(f"mesh: {label} captured {r['captures_after_window_full']} graphs after its window filled")
        if not r["launches_equal_eager"]:
            fail(f"mesh: {label} launches by device {r['launches_by_device_net']} (capture runs set apart), "
                 f"eager {r['eager']['launches_by_device']}")
    if "burst_mvdown_mesh1" in out and out["burst_mvdown_mesh1"]["launches"]["composite_geom"] <= 0:
        fail("mesh: the geometry-only kernel was never launched on the burst schedule under a mesh")
    if "mesh2_on_gpu0" in out and not out["mesh2_on_gpu0"]["traj_max_abs_diff"] <= 5e-4:
        fail(f"mesh: 2 shards differ from one by {out['mesh2_on_gpu0']['traj_max_abs_diff']} in the trajectory")
    shutil.rmtree(SMOKE_RUNS, ignore_errors=True)
    return out


# entry() on the card against the CPU: the loss (relative), each gradient
# (relative to its field's largest) and the share of gradients allowed past
# ENTRY_TOL; see `entry_card_vs_cpu`
ENTRY_TOL = 1e-4
ENTRY_GRAD_TOL = 2e-2
ENTRY_GRAD_SHARE = 0.01


def entry_loss_grads(torch, tentry, device: str, dtype=None):
    """((loss, gradients), fwd_bwd) of `entry()`'s function on `device`:
    the loss and its gradients w.r.t. the three map fields, and the call
    that computes them. With `dtype` (float64), the same function on the
    example map and arguments cast to it."""
    from eggfusion_tpu_torch.core.surfels import FIELDS

    fn, args = tentry.entry(device=device)
    if dtype is not None:
        s, intr, W, H = tentry._example_state(device=device)
        s = s.replace(**{f: getattr(s, f).to(dtype) for f in FIELDS if getattr(s, f).is_floating_point()})
        fn, args = tentry._loss_fn(s, intr.to(dtype), W, H), [a.to(dtype) for a in args]
    args = [a.detach().clone().requires_grad_(i < 3) for i, a in enumerate(args)]

    def fwd_bwd():
        loss = fn(*args)
        return loss.detach(), torch.autograd.grad(loss, args[:3])

    return fwd_bwd(), fwd_bwd


def entry_card_vs_cpu(torch, tentry) -> tuple[dict, object]:
    """`entry()` on the card against the same function on CPU tensors: the
    loss within ENTRY_TOL (relative); every gradient within ENTRY_GRAD_TOL
    of its field's largest CPU value, and all but ENTRY_GRAD_SHARE of them
    within ENTRY_TOL. Float32 gradients of a few surfels are ill-conditioned
    (the CPU's own are up to ~5e-3 of the largest off their float64
    evaluation, reported beside), so a card that sums in another order
    lands as far off there. Returns the record and the card's forward +
    backward call."""
    (loss_g, grads_g), fwd_bwd_g = entry_loss_grads(torch, tentry, "cuda")
    (loss_c, grads_c), _ = entry_loss_grads(torch, tentry, "cpu")
    (_, grads_64), _ = entry_loss_grads(torch, tentry, "cpu", torch.float64)
    rec = {"loss": float(loss_g), "loss_cpu": float(loss_c),
           "loss_rel_err": abs(float(loss_g) - float(loss_c)) / max(abs(float(loss_c)), 1e-30),
           "finite": bool(torch.isfinite(loss_g)) and all(bool(torch.isfinite(g).all()) for g in grads_g),
           "grad_max_rel_err": 0.0, "grad_share_off": 0.0, "card_grad_rel_err_vs_f64": 0.0,
           "cpu_grad_rel_err_vs_f64": 0.0, "tol": ENTRY_TOL, "grad_tol": ENTRY_GRAD_TOL,
           "grad_share_tol": ENTRY_GRAD_SHARE}
    for g, c, c64 in zip(grads_g, grads_c, grads_64):
        g, c = g.cpu().double(), c.double()
        scale = float(c.abs().max())
        rec["grad_max_rel_err"] = max(rec["grad_max_rel_err"], float((g - c).abs().max()) / scale)
        rec["grad_share_off"] = max(rec["grad_share_off"], float(((g - c).abs() > ENTRY_TOL * scale).double().mean()))
        rec["card_grad_rel_err_vs_f64"] = max(rec["card_grad_rel_err_vs_f64"], float((g - c64).abs().max()) / scale)
        rec["cpu_grad_rel_err_vs_f64"] = max(rec["cpu_grad_rel_err_vs_f64"], float((c - c64).abs().max()) / scale)
    rec["ok"] = (rec["finite"] and rec["loss_rel_err"] <= ENTRY_TOL and rec["grad_max_rel_err"] <= ENTRY_GRAD_TOL
                 and rec["grad_share_off"] <= ENTRY_GRAD_SHARE)
    return rec, fwd_bwd_g


def check_dryrun(cfglib, torch) -> dict:
    """Phase "dryrun": the port's entry points
    (`eggfusion_tpu_torch.entry`). `entry()` on the card: loss and
    gradients finite and close to the same function on CPU tensors
    (`entry_card_vs_cpu`), its forward + backward timed (CUDA events);
    `dryrun_multichip(1)` and the same dryrun on 2 shards placed on cuda:0,
    each with the launch counts zeroed just before and read just after: the dryrun's own
    assertions hold, the trajectories agree within 5e-4, both compositors
    ran; then every kernel against its plain version on the 1-GPU dryrun's
    final map at the dryrun's caps (256 model render, 128 opt step).
    Without `cv2` or `pyk4a`, the OpenCV frontend or the live Azure Kinect
    dataset must raise its `RuntimeError`; where a library is importable,
    the line says so (and the OpenCV frontend is built)."""
    import importlib.util

    from eggfusion_tpu_torch import entry as tentry
    from eggfusion_tpu_torch.core.sparse_init import SparseInitializer
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.parallel import mesh as pmesh

    out = {}
    # ---- entry(): the card against the CPU ----
    out["entry"], fwd_bwd = entry_card_vs_cpu(torch, tentry)
    times = cuda_times(fwd_bwd, reps=10)
    out["entry"].update(fwd_bwd_ms=statistics.median(times), fwd_bwd_ms_min_max=[min(times), max(times)])
    # ---- dryrun_multichip(1), then 2 shards on cuda:0; the systems the
    # dryruns ran are kept (the entry point returns only its dict) ----
    kept = []
    real_dryrun, real_make_mesh = pmesh.dryrun, pmesh.make_mesh

    def keep(*args, **kwargs):
        result = real_dryrun(*args, **kwargs)
        kept.append(result[1])
        return result

    pmesh.dryrun = keep
    try:
        for label, n in (("gpu1", 1), ("shards2_on_gpu0", 2)):
            if n > 1:
                pmesh.make_mesh = lambda n, device: [torch.device("cuda", 0)] * n
            rt.reset_launch_counts()
            rec = tentry.dryrun_multichip(n)
            rec["launches"], rec["launches_by_device"] = dict(rt.LAUNCHES), dict(rt.LAUNCHES_BY_DEVICE)
            out[label] = rec
    finally:
        pmesh.dryrun, pmesh.make_mesh = real_dryrun, real_make_mesh
    ef1, ef2 = kept
    base = ef1._traj_np("est")
    out["shards2_on_gpu0"]["traj_max_abs_diff"] = float(np.abs(ef2._traj_np("est") - base).max())
    # ---- the kernels on the dryrun's final map, at its caps ----
    cfg = ef1.cfg
    intr = CameraIntrinsics.from_calibration(cfg.Dataset.Calibration)
    w2c = torch.as_tensor(np.linalg.inv(base[-1]).astype(np.float32), device="cuda")
    view = map_view(torch, ef1.mapper.surfels, w2c, intr.as_tensor("cuda"), intr.width, intr.height)
    check = check_view(torch, view, timed=False, phase="dryrun_check", cap=int(cfg.System.raster_cap),
                       opt_cap=int(cfg.System.opt_raster_cap))
    out["check"] = {k: {f: v[f] for f in ("cap", "max_abs_err", "max_rel_err") if f in v}
                    for k, v in check.items() if isinstance(v, dict)}
    del kept[:], ef1, ef2
    # ---- the frontends that need a library: OpenCV, pyk4a ----
    for name, module, build in (
            ("opencv", "cv2", lambda: SparseInitializer(cfglib.default_config(Tracking={"sparse_backend": "opencv"}))),
            ("kinect_live", "pyk4a",
             lambda: load_dataset(cfglib.default_config(Dataset={"type": "kinect_live", "preload": False}), "cuda"))):
        if importlib.util.find_spec(module) is not None:
            if module == "cv2":  # needs no camera: build it
                out[name] = f"cv2 is importable here: built {type(build()).__name__}"
            else:
                out[name] = f"{module} is importable here: not built (it opens a camera)"
            continue
        try:
            build()
        except RuntimeError as e:
            out[name] = f"raised RuntimeError: {e}"
        else:
            fail(f"dryrun: {name} without {module} did not raise")
    emit({"phase": "dryrun", **out})
    e = out["entry"]
    if not e["ok"]:
        fail(f"dryrun: entry() on the card: finite {e['finite']}, loss {e['loss_rel_err']} off the CPU, "
             f"gradients up to {e['grad_max_rel_err']}, a share {e['grad_share_off']} past {ENTRY_TOL}")
    for label in ("gpu1", "shards2_on_gpu0"):
        for k in ("composite_fwd", "composite_bwd"):
            if out[label]["launches"][k] <= 0:
                fail(f"dryrun: kernel {k} was never launched on {label}")
    if not out["shards2_on_gpu0"]["traj_max_abs_diff"] <= 5e-4:
        fail(f"dryrun: 2 shards differ from one GPU by {out['shards2_on_gpu0']['traj_max_abs_diff']}")
    return out


def check_scaling(torch) -> dict:
    """`--phase scaling`: `eggfusion_tpu_torch.mesh_scaling`'s table on 1,
    2 and 4 GPUs (those visible): at the JAX dryrun's size and window (128x64,
    8 frames, 8192 surfels, a window of 3); then at 640x480 over 32 frames
    with a 262144-surfel map and a window of min(4, GPUs) (one member per
    GPU), as the dryrun configures it, without the pixel-sharded tracker,
    at the port's default slab caps (2048, 1024), and with both changes.
    Each row runs on CUDA graphs and eagerly. Each table goes to its own
    file under chiprun_out/. Fails unless every GPU that holds a window
    member launched both compositors and each graph run is bit-equal to its
    eager twin. Trajectory
    differences across device counts are reported, not held: at the
    dryrun's slab caps (256, 128) the sub-columns overflow, where float
    sums in another order can tip a frame's tracking (phases "dryrun" and
    "mesh" hold the agreement)."""
    from eggfusion_tpu_torch import mesh_scaling

    vga = ["--width", "640", "--height", "480", "--frames", "32", "--max-surfels", "262144",
           "--window", str(max(3, min(4, torch.cuda.device_count())))]
    caps = ["--raster-cap", "2048", "--opt-raster-cap", "1024"]
    tables = {}
    for label, args in (("mesh_scaling_torch", []),
                        ("mesh_scaling_torch_640x480", vga),
                        ("mesh_scaling_torch_640x480_no_shard", vga + ["--no-shard-tracking"]),
                        ("mesh_scaling_torch_640x480_cap2048", vga + caps),
                        ("mesh_scaling_torch_640x480_cap2048_no_shard", vga + caps + ["--no-shard-tracking"])):
        t = mesh_scaling.main(args + ["--out", os.path.join(OUT_DIR, label + ".json")])
        tables[label] = t
        for r in t["rows"]:
            emit({"phase": "scaling", "table": label,
                  **{k: v for k, v in r.items() if k not in ("frame_s", "window_sizes", "overrides", "captures")}})
            busy = min(r["n_devices"], r["window"])
            idle = [f"{k}:cuda:{i}" for k, per in r["launches_by_gpu"].items() for i in range(busy)
                    if i >= len(per) or per[i] <= 0]
            if idle:
                fail(f"scaling: {label} on {r['n_devices']} GPUs: no launches of {idle}")
            if not r["graphs_bit_equal"]:
                fail(f"scaling: {label} on {r['n_devices']} GPUs: the graph run differs from the eager run")
    return tables


HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def profiled_launches(torch, step, frames) -> dict:
    """Launches per frame over `frames` (each run by `step`) under
    `torch.profiler`: the host's launch calls (kernels, graphs, copies and
    fills: `HOST_LAUNCH_CALLS`) and the kernels the device ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fid in frames:
            step(fid)
        torch.cuda.synchronize()
    host = dev = 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            dev += e.count
        elif e.key in HOST_LAUNCH_CALLS:
            host += e.count
    return {"host_launches_per_frame": host / len(frames), "device_kernels_per_frame": dev / len(frames)}


def graphs_run(cfglib, torch, graphs, n_frames: int = 24, n_profiled: int = 3, overrides: dict | None = None,
               name: str = "graphs") -> tuple:
    """`n_frames` of the slice configuration (with `overrides` merged in)
    through `EGGFusion.reconstruct` with `graphs` (None: CUDA graphs, the
    default; False: eager), after `warmup`; then `n_profiled` more frames
    under the profiler. The launch counts are zeroed after `warmup` and read
    after `n_frames`, by kernel and by device, beside the launches the eager
    runs before the captures made in those frames account for
    (`Programs.warm_launches`). Returns the record, the system, and the
    trajectory and map after `n_frames`."""
    from eggfusion_tpu_torch.core.surfels import FIELDS
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.main import build_frame
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.system import EGGFusion
    from eggfusion_tpu_torch.utils import eval as evalu

    label = "eager" if graphs is False else "graphs"
    cfg = cfglib.slice_config(n_frames + n_profiled, os.path.join(SMOKE_RUNS, f"{name}_{label}"))
    cfg = cfglib.merge(cfg, overrides or {})
    ef = EGGFusion(cfg, graphs=graphs)
    ds = ef.dataset = load_dataset(cfg, ef.device)

    def step(fid):
        ef.reconstruct(build_frame(ds, fid, False, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ef.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    captures_warmup = ef.programs.captures()
    warm0 = dict(ef.programs.warm_launches)
    rt.reset_launch_counts()
    captures, window = [], []
    sync = lambda: [torch.cuda.synchronize(i) for i in range(torch.cuda.device_count())]
    full = t_full = None
    t0 = time.perf_counter()
    for fid in range(n_frames):
        step(fid)
        if fid == 0:
            sync()
            frame0_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        captures.append(ef.programs.captures())
        window.append(len(ef.mapper.keyframe_manager.sliding_window))
        if full is None and window[-1] >= ef.mapper.keyframe_manager.window_size:
            full = fid
            sync()
            t_full = time.perf_counter()
    sync()
    t_end = time.perf_counter()
    wall = t_end - t0
    steady_ms = (t_end - t_full) * 1e3 / (n_frames - 1 - full) if full is not None and full < n_frames - 1 else None
    launches, by_device = dict(rt.LAUNCHES), dict(rt.LAUNCHES_BY_DEVICE)
    warm = {k: n - warm0.get(k, 0) for k, n in ef.programs.warm_launches.items() if n != warm0.get(k, 0)}
    traj = ef._traj_np("est")
    fields = {f: getattr(ef.mapper.surfels, f).clone() for f in FIELDS}
    captures_frames = ef.programs.captures() - captures_warmup
    prof = profiled_launches(torch, step, range(n_frames, n_frames + n_profiled))
    ref = ef._traj_np("ref")
    rec = {"label": label, "mode": ef.programs.mode, "frames": n_frames, "warmup_s": warmup_s,
           "captures_warmup": captures_warmup, "captures_in_frames": captures_frames,
           "captures_per_frame": [b - a for a, b in zip([captures_warmup] + captures, captures)],
           "window_full_frame": full,
           "captures_after_window_full": None if full is None else captures[-1] - captures[full],
           "frame0_s": frame0_s,
           "ms_per_frame_after_frame0": wall * 1e3 / (n_frames - 1), "fps_after_frame0": (n_frames - 1) / wall,
           "ms_per_frame_after_window_full": steady_ms,
           **prof, "launches": launches, "launches_by_device": by_device, "capture_warm_launches": warm,
           "ate_cm": evalu.ate_rmse(ref[:n_frames, :3, 3], traj[:, :3, 3]),
           "opt_steps": ef.mapper.opt_steps_total, "active_surfels": int(ef.mapper.surfels.num_active())}
    return rec, ef, traj, fields


def ladder_capture(torch) -> dict:
    """`System.precompile_ladder` on `bench_torch.py`'s workload: the bytes
    `warmup` holds after capturing the starting rung and every rung above
    it (graph pools and empty maps by rung; allocated and reserved in all,
    against a baseline taken with no other system alive), and its
    seconds."""
    import bench_torch
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.system import EGGFusion

    cfg = bench_torch.bench_config(2, env={})
    cfg.System.precompile_ladder = True
    gc.collect()  # the earlier phases' systems (their programs hold cycles)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    ef = EGGFusion(cfg)
    ef.dataset = load_dataset(cfg, ef.device)
    t0 = time.perf_counter()
    ef.warmup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pools: dict = {}
    for st in ef.programs.stats().values():
        for rung, b in st["pool_bytes"].items():
            pools[rung] = pools.get(rung, 0) + b
    maps = {str(c): sum(t.numel() * t.element_size() for t in vars(m).values())
            for c, m in ef.mapper.maps_ahead.items()}
    out = {"start_capacity": ef.mapper.surfels.capacity, "rungs_ahead": sorted(ef.mapper.maps_ahead),
           "warmup_s": seconds, "captures": ef.programs.captures(), "pool_bytes_by_rung": pools,
           "empty_map_bytes_by_rung": maps, "allocated_bytes": torch.cuda.memory_allocated() - base,
           "reserved_bytes": torch.cuda.memory_reserved() - base_reserved}
    del ef
    return out


def check_graphs(cfglib, torch) -> dict:
    """Phase "graphs": the compile layer. Two 24-frame runs of the slice
    configuration from the same seed, eager (`graphs=False`) and with CUDA
    graphs (the default), whose trajectories and final maps must agree bit
    for bit; one replay of each captured program against an eager call on
    the same inputs, bit for bit; launches per frame (host and device), ms
    per frame, capture seconds per program and pool bytes per rung; then one
    line of `bench_torch.main()` at its default workload, which must
    capture no graph in its timed frames; and what `warmup` holds with
    `System.precompile_ladder` on that workload (`ladder_capture`)."""
    from eggfusion_tpu_torch.core.surfels import FIELDS
    from eggfusion_tpu_torch.utils.graphs import same_bits

    eager, ef_e, traj_e, map_e = graphs_run(cfglib, torch, False)
    del ef_e
    rec, ef, traj_g, map_g = graphs_run(cfglib, torch, None)
    traj_equal = traj_e.tobytes() == traj_g.tobytes()
    differ = [f for f in FIELDS if not same_bits(map_e[f], map_g[f])]
    stats = ef.programs.stats()
    replay = {name: ef.programs.programs[name].check_replay() for name in ("track", "frame", "map_update",
                                                                          "opt_step")}
    pools: dict = {}
    for st in stats.values():
        for rung, b in st["pool_bytes"].items():
            pools[rung] = pools.get(rung, 0) + b
    out = {"phase": "graphs", "eager": eager, "graphs": rec, "trajectory_bit_equal": traj_equal,
           "map_fields_differing": differ, "replay_vs_eager": replay,
           "capture_s": {k: v["capture_s"] for k, v in stats.items()},
           "captures": {k: v["captures"] for k, v in stats.items()},
           "replays": {k: v["replays"] for k, v in stats.items()},
           "pool_bytes_by_rung": pools,
           "max_traj_diff": float(np.abs(traj_e - traj_g).max())}
    emit(out)
    del ef
    import bench_torch

    bench = bench_torch.main()
    out["bench"] = bench
    emit({"phase": "graphs_bench", **bench})
    out["precompile_ladder"] = ladder_capture(torch)
    emit({"phase": "graphs_ladder", **out["precompile_ladder"]})
    if rec["mode"] != "graph" or rec["captures_warmup"] == 0:
        fail(f"graphs: the default system ran no CUDA graph ({rec['mode']}, {rec['captures_warmup']} captures)")
    if not traj_equal or differ:
        fail(f"graphs: the graph run differs from the eager run (trajectory bit-equal {traj_equal}, "
             f"map fields differing {differ})")
    bad = {k: v for k, v in replay.items() if not (v["outputs_equal"] and v["state_equal"])}
    if bad:
        fail(f"graphs: a replay differs from its eager call: {bad}")
    if not rec["host_launches_per_frame"] < eager["host_launches_per_frame"]:
        fail("graphs: the graph run launches no fewer times per frame than the eager run")
    if bench["captures_timed"]:
        fail(f"graphs: bench_torch captured {bench['captures_timed']} graphs in its timed frames")
    return out


def check_frustum_compact(torch, ef) -> dict:
    """A compacted forward render (`raster_tile.frustum_compact`, on from
    any size) of the main path's final map at CAP 2048, both timed, held to
    the uncompacted render of the surfels the compaction keeps (its
    gather, reorder and re-derived `active`) and to the full render, each
    within the forward tolerance; at the last frame's pose, or at an
    earlier frame's if more surfels than the half-capacity prefix are in
    view there. The compaction keeps surfels within 63 px of the image, as
    the JAX module does: a surfel further out whose splat still reached in
    would be dropped, and the check against the full render would fail."""
    from eggfusion_tpu_torch.core import surfels as sf
    from eggfusion_tpu_torch.ops import raster_tile as rt

    ds, s = ef.dataset, ef.mapper.surfels
    intr = ds.intrinsics
    ia = intr.as_tensor(ef.device)
    n = s.capacity
    with torch.no_grad():
        params = sf.render_params(s)
        tagged = dict(params, slot=torch.arange(n, device=ef.device))
        for fid in (len(ds) - 1, len(ds) // 2, 0):
            w2c = torch.as_tensor(np.asarray(ds[fid][4], np.float32), device=ef.device)
            comp_params = rt.frustum_compact(tagged, w2c, ia, intr.width, intr.height)
            kept = int(comp_params["active"].sum())
            if kept < n // 2:
                break
        else:
            fail(f"frustum: {kept} surfels in view exceed the compacted prefix of {n // 2} at every pose tried")
        kept_mask = torch.zeros(n, dtype=torch.bool, device=ef.device)
        kept_mask[comp_params["slot"][comp_params["active"]]] = True
        render = lambda p: rt.render_tile(p, w2c, ia, intr.width, intr.height, sh_degree=0, cap=2048,
                                          need_grad=False)
        full = render(params)
        same_set = render(dict(params, active=kept_mask))
        full_ms = cuda_ms(lambda: render(params), reps=10)
        saved = rt.FRUSTUM_COMPACT_MIN
        rt.FRUSTUM_COMPACT_MIN = 0
        try:
            comp = render(params)
            comp_ms = cuda_ms(lambda: render(params), reps=10)
        finally:
            rt.FRUSTUM_COMPACT_MIN = saved
    rel = lambda a, b: max(float(((a[k] - b[k]).abs() / (1 + b[k].abs())).max()) for k in b)
    over = sum(int(((comp[k] - full[k]).abs() > FWD_TOL * (1 + full[k].abs())).sum()) for k in full)
    out = {"phase": "frustum", "frame": fid, "capacity": n, "kept": kept, "prefix": n // 2,
           "max_rel_err": rel(comp, same_set), "tol": FWD_TOL, "same_bits": same_bits(
               [comp[k] for k in full], [same_set[k] for k in full]),
           "vs_full_render": {"max_rel_err": rel(comp, full), "values_over_tol": over,
                              "values": sum(v.numel() for v in full.values())},
           "render_ms": full_ms, "compacted_render_ms": comp_ms}
    emit(out)
    if not out["max_rel_err"] <= FWD_TOL:
        fail(f"frustum: the compacted render differs from the render of the surfels it keeps by "
             f"{out['max_rel_err']}")
    if over > 0:
        fail(f"frustum: the compacted render differs from the full render by {out['vs_full_render']['max_rel_err']} "
             f"({over} values over the tolerance)")
    return out


TUM_CONFIG = os.path.join(REPO, "configs", "tum", "fr1_desk.yaml")


def inverse_distortion(intr, dist) -> tuple:
    """(sx, sy): the undistorted pixel that each pixel of a camera with the
    radial-tangential coefficients `dist` (k1, k2, p1, p2, k3) sees, by 20
    fixed-point steps of x_u = (x_d - tangential(x_u)) / radial(x_u); with
    the pixel residual of the forward model."""
    k1, k2, p1, p2, k3 = dist
    ys, xs = np.meshgrid(np.arange(intr.height, dtype=np.float64), np.arange(intr.width, dtype=np.float64),
                         indexing="ij")
    xd, yd = (xs - intr.cx) / intr.fx, (ys - intr.cy) / intr.fy
    xu, yu = xd.copy(), yd.copy()
    for _ in range(21):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        tx, ty = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu), p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        fx_err, fy_err = xu * radial + tx - xd, yu * radial + ty - yd
        xu, yu = (xd - tx) / radial, (yd - ty) / radial
    residual = float(np.hypot(fx_err * intr.fx, fy_err * intr.fy).max())
    return xu * intr.fx + intr.cx, yu * intr.fy + intr.cy, residual


def sample(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, nearest: bool) -> np.ndarray:
    """`img` at the pixel positions (sx, sy), clamped to the image: bilinear
    for color, nearest for depth."""
    H, W = img.shape[:2]
    sx, sy = np.clip(sx, 0, W - 1), np.clip(sy, 0, H - 1)
    if nearest:
        return img[np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64)]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    return ((img[y0, x0] * (1 - ax) + img[y0, x1] * ax) * (1 - ay)
            + (img[y1, x0] * (1 - ax) + img[y1, x1] * ax) * ay)


def fine_texture(color, depth, intr, w2c, cell: float = 0.03):
    """`color` plus a mosaic of `cell`-metre cubes of random gray on the
    scene's surfaces: `texture_detail`'s speckle is ~50 px wide at 640x480
    and 2 m, too smooth for FAST corners (a handful a frame), and a regular
    pattern would defeat descriptor matching."""
    import torch

    dev = color.device
    H, W = depth.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    rays = torch.stack([(xs - intr.cx) / intr.fx, (ys - intr.cy) / intr.fy, torch.ones_like(xs)], dim=-1)
    c2w = torch.as_tensor(np.linalg.inv(np.asarray(w2c, np.float64)), dtype=torch.float32, device=dev)
    p = (rays * depth) @ c2w[:3, :3].T + c2w[:3, 3]
    q = torch.floor(p / cell + 0.37).to(torch.int64)  # offset: no wall lies on a cell boundary
    h = (q[..., 0] * 73856093) ^ (q[..., 1] * 19349663) ^ (q[..., 2] * 83492791)
    value = (h % 1021).to(torch.float32) / 1020.0 - 0.5
    return torch.clamp(color + 0.5 * value[..., None] * (depth > 0), 0.0, 1.0)


def write_tum_fixture(torch, root: str, cfg, n_frames: int, seed: int = 4, device: str = "cuda",
                      noise: bool = True, scene: str = "room") -> dict:
    """A TUM RGB-D recording on disk, written by the port's PNG writer: the
    synthetic `room` scene (`texture_detail` 0.35 and `fine_texture` for
    FAST corners) seen from an orbit of radius 1 m turning 1 degree a frame
    (fresh wall in every frame; 1.7 cm a frame, TUM fr1's pace),
    forward-distorted with the configuration's lens, then (`noise`) the
    sensor noise model; `rgb.txt`, `depth.txt` (depth_scale units) and
    `groundtruth.txt` with jittered timestamps, one color image without
    depth or pose (the association drops it)."""
    from scipy.spatial.transform import Rotation

    from eggfusion_tpu_torch.data import synthetic as syn
    from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
    from eggfusion_tpu_torch.io.png import write_png

    calib = cfg.Dataset.Calibration
    intr = CameraIntrinsics.from_calibration(calib)
    dist = [float(calib.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2", "k3")]
    sx, sy, residual = inverse_distortion(intr, dist)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    if scene == "room":
        poses = syn.make_orbit_trajectory(n_frames, radius=1.0, turns=(n_frames - 1) / 360, seed=seed)
    else:
        poses = syn.make_trajectory(n_frames)
    rng = np.random.default_rng(seed)
    rgb, dep = ["# color images"], ["# depth maps"]
    gt = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    t0 = time.perf_counter()
    for i in range(n_frames):
        color, depth = syn.render_corner_scene(intr, poses[i], detail=0.35, scene=scene, device=device)
        color = fine_texture(color, depth, intr, poses[i])
        c = sample(color.cpu().numpy(), sx, sy, nearest=False)
        d = sample(depth.cpu().numpy()[..., 0], sx, sy, nearest=True)
        if noise:
            c, d = syn.apply_sensor_noise(c, d, seed=seed * 1000 + i)
        ts = 1305031102.0 + 0.04 * i + rng.uniform(-0.004, 0.004)
        write_png(os.path.join(root, "rgb", f"{ts:.6f}.png"), (np.clip(c, 0, 1) * 255).astype(np.uint8))
        write_png(os.path.join(root, "depth", f"{ts:.6f}.png"),
                  np.round(np.clip(d, 0, None) * float(calib.depth_scale)).astype(np.uint16))
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        dep.append(f"{ts + rng.uniform(0.0, 0.01):.6f} depth/{ts:.6f}.png")
        c2w = np.linalg.inv(poses[i].astype(np.float64))
        q, t = Rotation.from_matrix(c2w[:3, :3]).as_quat(), c2w[:3, 3]
        gt.append(f"{ts + 0.002:.6f} " + " ".join(f"{v:.7f}" for v in (*t, *q)))
    rgb.append(f"{ts + 0.5:.6f} rgb/unmatched.png")
    for name, lines in (("rgb", rgb), ("depth", dep), ("groundtruth", gt)):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"frames": n_frames, "images": n_frames + 1, "inverse_residual_px": residual,
            "write_s": time.perf_counter() - t0}


def run_frames(torch, cfg, n_frames: int):
    """`EGGFusion.reconstruct` over the first `n_frames` of the dataset,
    decoded before the clock starts. Returns the system, the frames per
    second over frames 1 to `n_frames` - 1, and the converged flag of each
    frame the dense solve tracked."""
    from eggfusion_tpu_torch.core.frame import Frame
    from eggfusion_tpu_torch.data.datasets import load_dataset
    from eggfusion_tpu_torch.system import EGGFusion

    ef = EGGFusion(cfg)
    ds = load_dataset(cfg, ef.device)
    items = [ds[i] for i in range(n_frames)]
    mask = torch.as_tensor(items[0][3], dtype=torch.float32, device=ef.device)
    converged = []
    track = ef.tracker.tracking

    def tracking(frame, model_map):
        track(frame, model_map)
        if hasattr(frame, "tracking_converged"):
            converged.append(frame.tracking_converged)

    ef.tracker.tracking = tracking
    t0 = None
    for i, (ts, color, depth, _mask, pose) in enumerate(items):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ef.reconstruct(Frame(uid=i, ts=ts, color_u8=color, depth_raw=depth, mask=mask, gt_pose_w2c=pose,
                             intr=ds.intrinsics, depth_scale=ds.depth_scale, device=ef.device, nlevel=ef.nlevel_frame,
                             bilateral=ds.bilateral_mode))
    torch.cuda.synchronize()
    return ef, (n_frames - 1) / (time.perf_counter() - t0), [bool(c) for c in converged]


def check_dense(cfglib, torch, cfg, work: str, n_frames: int = 16) -> dict:
    """The dense tracker at 640x480: the same configuration on a noise-free
    recording of the `corner` scene (three walls in view) on the sway
    trajectory. The main recording cannot show it: the dense solve never
    converges there, most likely because its orbit sees one wall, along
    which point-to-plane alignment slides, and its sensor noise keeps the
    finest level's residual above `residual_thres` 0.001. Returns the
    frames whose dense solve converged (and so set the pose) and the ATE."""
    from eggfusion_tpu_torch.utils import eval as evalu

    root = os.path.join(work, "rgbd_corner")
    write_tum_fixture(torch, root, cfg, n_frames, noise=False, scene="corner")
    cfg = cfglib.merge(cfg, {"Dataset": {"dataset_path": root, "preload": False}})
    ef, fps, converged = run_frames(torch, cfg, n_frames)
    ref, est = ef._traj_np("ref"), ef._traj_np("est")
    return {"frames": n_frames, "converged": sum(converged), "tracked": len(converged),
            "sparse_seeds": ef.tracker.sparse_seeds, "recoveries": len(ef.metrics) - n_frames,
            "ate_cm": evalu.ate_rmse(ref[:, :3, 3], est[:, :3, 3]), "fps": fps}


def check_tum(cfglib, torch, n_frames: int = 60, n_compare: int = 20) -> dict:
    """Phase 7: `configs/tum/fr1_desk.yaml` as it stands (640x480, its lens,
    `use_sparse`, `max_surfels_num` 3M with the capacity ladder) through
    `main.run` on a TUM recording written at that size; then the kernels
    against their plain versions on its final map, the dense tracker on a
    noise-free recording (`check_dense`), and the steady frame rate over
    `n_compare` frames with the ladder and with a fixed 3M map, in turns."""
    from eggfusion_tpu_torch.core import surfels as sf
    from eggfusion_tpu_torch.main import run
    from eggfusion_tpu_torch.ops import raster_tile as rt
    from eggfusion_tpu_torch.utils import eval as evalu

    # the recording (~80 MB) and the run's files stay out of chiprun_out/
    work = os.path.join(REPO, "build", "tum_smoke")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "rgbd_dataset")
    cfg = cfglib.load_config(TUM_CONFIG, make_workspace=False)
    cfg.Dataset.dataset_path = root
    cfg.System.save_dir = os.path.join(work, "run")
    fixture = write_tum_fixture(torch, root, cfg, n_frames)
    emit({"phase": "tum_fixture", **fixture})
    stages = {}

    def on_stage(stage, ef):
        stages[stage] = dict(rt.LAUNCHES)
        rt.reset_launch_counts()

    rt.reset_launch_counts()
    ef = run(cfg, on_stage=on_stage)
    ds = ef.dataset
    launches = stages["loop"]
    # the kernels against their plain versions on this path's inputs: the
    # final map (its capacity changed on the way) from the last frame's
    # pose, 5 x 15 tiles
    sm = ef.mapper.surfels
    w2c = torch.as_tensor(np.asarray(ds[len(ds) - 1][4], np.float32), device=ef.device)
    view = map_view(torch, sm, w2c, ds.intrinsics.as_tensor(ef.device), ds.intrinsics.width, ds.intrinsics.height)
    kernels = check_view(torch, view, timed=False, phase="tum_check", f64_band=True)
    finite = all(bool(torch.isfinite(getattr(sm, f)[..., sm.active]).all()) for f in sf.FIELDS
                 if getattr(sm, f).is_floating_point())
    ref, est = ef._traj_np("ref"), ef._traj_np("est")
    ate = evalu.ate_rmse(ref[:, :3, 3], est[:, :3, 3])
    frames = [m for m in ef.metrics if m["frame"] >= 0]
    caps = [m["capacity"] for m in frames]
    with open(os.path.join(ef.save_dir, "render_metrics.json")) as f:
        render = json.load(f)["mean"]
    with open(os.path.join(ef.save_dir, "recon_metrics.json")) as f:
        recon = json.load(f)
    dense = check_dense(cfglib, torch, cfg, work)
    compare = {}
    for label, bucketing in (("ladder", True), ("fixed", False)):
        c = cfglib.merge(cfg, {"Dataset": {"preload": False}, "System": {"capacity_bucketing": bucketing}})
        run_ef, fps, _ = run_frames(torch, c, n_compare)
        compare[label] = {"fps": fps, "capacity": run_ef.mapper.surfels.capacity,
                          "active_surfels": int(run_ef.mapper.surfels.num_active())}
        del run_ef
    shutil.rmtree(work, ignore_errors=True)
    out = {"phase": "tum", "frames": len(frames), "size": [ds.intrinsics.width, ds.intrinsics.height],
           "distorted": ds.distorted, "mask_valid_share": float(ds.mask.mean()),
           "max_surfels_num": ef.mapper.ladder.max_capacity, "capacities": caps,
           "capacity_changes": [(m["frame"], m["capacity"]) for a, m in zip(frames, frames[1:])
                                if m["capacity"] != a["capacity"]],
           "sparse_seeds": ef.tracker.sparse_seeds, "sparse_seed_share": ef.tracker.sparse_seeds / len(frames),
           "fps": len(frames) / ef.run_wall_s,
           "fps_after_frame0": (len(frames) - 1) / max(ef.run_wall_s - ef.run_frame0_s, 1e-9),
           "frame0_s": ef.run_frame0_s, "prefetch_ms_first": ds.prefetch_ms[0],
           "prefetch_ms_median": statistics.median(ds.prefetch_ms[1:]), "prefetch_ms_max": max(ds.prefetch_ms[1:]),
           "ate_cm": ate, "active_surfels": int(ef.mapper.surfels.num_active()),
           "opt_steps": ef.mapper.opt_steps_total, "recoveries": len(ef.metrics) - len(frames),
           "keyframes": len(ef.mapper.keyframe_manager), "psnr": render.get("psnr"),
           "depth_l1": render.get("depth_l1"), "recon_f1": recon.get("recon_f1"),
           "finish_s": ef.run_finish_s, "eval_s": ef.run_eval_s, "launches": launches, "map_finite": finite,
           "kernel_check": {k: {"max_rel_err": v["max_rel_err"], "band_held_values": v.get("band_held_values", 0),
                                "pairs": v["pairs"]} for k, v in kernels.items() if isinstance(v, dict)},
           "dense": dense, "steady_fps": compare, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "graph_captures": ef.programs.captures(),
           "capture_s": sum(v["capture_s"] for v in ef.programs.stats().values())}
    emit(out)
    if not (ds.distorted and out["mask_valid_share"] < 1.0):
        fail("tum: the undistortion path is not live")
    if not out["sparse_seeds"] >= len(frames) / 2:
        fail(f"tum: sparse seeds on {out['sparse_seeds']} of {len(frames)} frames")
    if not ate < 3.0:
        fail(f"tum: ATE {ate} cm >= 3 cm")
    if not finite:
        fail("tum: the map holds non-finite values")
    if not (dense["converged"] >= dense["tracked"] / 2 and dense["ate_cm"] < 1.0):
        fail(f"tum: the dense solve converged on {dense['converged']} of {dense['tracked']} frames of the corner "
             f"recording, ATE {dense['ate_cm']} cm")
    # the finish phase's bounds (`tests/test_system_e2e.py`'s)
    if not (render["psnr"] > 12.0 and render["depth_l1"] < 0.15 and recon.get("recon_f1", 0.0) > 0.7):
        fail(f"tum: keyframe PSNR {render['psnr']}, depth-L1 {render['depth_l1']}, recon F1 {recon.get('recon_f1')}")
    grew = any(b > a for a, b in zip(caps, caps[1:]))
    if not (out["capacity_changes"] and grew and caps[-1] < ef.mapper.ladder.max_capacity):
        fail(f"tum: the map never grew, or ended at its maximum: {out['capacity_changes']}")
    for k in ("composite_fwd", "composite_bwd"):
        if launches[k] <= 0:
            fail(f"tum: kernel {k} was never launched on this path")
    return out


def main(argv: list[str]) -> None:
    import torch

    # `--phase mesh`: the build and the multi-GPU part of phase "mesh" alone;
    # `--phase graphs`, `--phase dryrun`: the build and that phase alone;
    # `--phase scaling`: the build and the mesh-scaling tables
    phases = argv[argv.index("--phase") + 1:][:1] if "--phase" in argv else []

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "eggfusion_tpu_torch", "csrc")):
        fail("eggfusion_tpu_torch/ not found beside chip_smoke.py: run from a checkout of the repository")
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    from eggfusion_tpu_torch import config as cfglib
    from eggfusion_tpu_torch.ops import cuda_build
    from eggfusion_tpu_torch.utils.device import gpu_name_and_limit

    gpu = gpu_name_and_limit() or "unknown"
    t0 = time.perf_counter()
    report = cuda_build.build(variants=((), cuda_build.NO_CULL))
    for name in cuda_build.SIGNATURES:
        cuda_build.load(name)
        cuda_build.load(name, cuda_build.NO_CULL)
    # resident blocks per SM at the caps the main path launches with
    blocks = {"composite_fwd": {c: cuda_build.blocks_per_sm("composite_fwd", c, 0) for c in (1024, 2048)},
              "composite_geom": {c: cuda_build.blocks_per_sm("composite_fwd", c, 1) for c in (1024, 2048)},
              "composite_bwd": {1024: cuda_build.blocks_per_sm("composite_bwd", 1024)}}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas_usage(report), "blocks_per_sm": blocks})

    if phases == ["graphs"]:
        check_graphs(cfglib, torch)
        print(gpu, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    if phases == ["mesh"]:
        mesh = check_mesh(cfglib, torch, multi_only=True)
        print(gpu, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    if phases in (["scaling"], ["dryrun"]):
        if phases == ["scaling"]:
            check_scaling(torch)
        else:
            check_dryrun(cfglib, torch)
        print(gpu, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    checks = check_kernels(cfglib, torch)
    adversarial = check_adversarial(torch)
    main_run, main_stages, ef = drive(cfglib, torch, n_frames=48, burst=False, final_global_opt=True)
    finish = check_finish(torch, ef, main_stages, main_run["opt_steps"])
    frustum = check_frustum_compact(torch, ef)
    saved = (ef.mapper.time, int(ef.mapper.surfels.num_active()))
    ckpt_path = os.path.join(ef.save_dir, "checkpoint.npz")
    del ef
    burst_run, burst_stages, _ = drive(cfglib, torch, n_frames=7, burst=True)
    recovery = check_recovery(cfglib, torch)
    resume = check_resume(cfglib, torch, ckpt_path, saved)
    tum = check_tum(cfglib, torch)
    variants = check_variants(cfglib, torch, main_run["fps_after_frame0"])
    mesh = check_mesh(cfglib, torch)
    dryrun = check_dryrun(cfglib, torch)
    graphs = check_graphs(cfglib, torch)
    by_path = {"main": main_stages["loop"], "finish": main_stages["finish"], "eval": main_stages["eval"],
               "burst": burst_stages["loop"], "recovery": recovery["launches"], "resume": resume["launches"],
               "tum": tum["launches"], "mvdown": variants["mvdown"]["launches"],
               "mvdown_cap4096": variants["mvdown_cap4096"]["launches"],
               "settled_skip": variants["settled_skip"]["launches"],
               "early_exit": variants["early_exit"]["launches"],
               **{label: r["launches"] for label, r in mesh.items() if isinstance(r, dict)},
               "dryrun": dryrun["gpu1"]["launches"], "dryrun_shards2_on_gpu0": dryrun["shards2_on_gpu0"]["launches"],
               "graphs_eager": graphs["eager"]["launches"], "graphs": graphs["graphs"]["launches"],
               "bench": graphs["bench"]["launches"]}

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
                        "bound_by": c["bound_by"], "library_ms": None, "stream_ms": c["stream_ms"],
                        "bound_ms_visited": c["bound_ms_visited"],
                        "launches_by_path": {p: v[name] for p, v in by_path.items()}})
        if "ms_by_shape" in c:
            kernels[-1]["ms_by_shape"] = c["ms_by_shape"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "checks": checks, "adversarial": adversarial, "main": main_run,
                   "finish": finish, "burst": burst_run, "recovery": recovery, "resume": resume,
                   "tum": tum, "variants": variants, "mesh": mesh, "dryrun": dryrun, "frustum": frustum,
                   "graphs": graphs, "kernels": kernels},
                  f, indent=1)
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except Exception:
        # A fault on the card (a device-side assert) prints its messages when
        # the CUDA context is torn down at exit, after the traceback, and can
        # bury it; leaving without that teardown keeps the traceback the last
        # thing on stderr. The exit code is 1, as for any failed check.
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
