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
import re
import statistics
import subprocess
import sys
import time

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


def main_path_view(cfglib, torch):
    """The map spawned from frame 0 of the main path's sequence, seen from
    frame 1's pose as the next frame's model render sees it: its size, the
    camera and `slab(cap, need_back) -> (entries, counts)` binning it at a
    cap. Shared by the kernel checks and the kernel probe."""
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
    w2c = torch.as_tensor(ds[1][4], device=dev)
    W, H = frame.width, frame.height
    hp, wp, tx, ty = rt._grid(W, H)
    n_tiles = tx * ty
    proj = rc.project_surfels(sf.render_params(s), w2c, frame.intr, W, H, 0)
    attrs = torch.cat([proj.mean2d, proj.conic, proj.opacity[None], proj.color, proj.normal_cam,
                       proj.p_cam, torch.ones_like(proj.opacity)[None]], dim=0).T.contiguous()

    def slab(cap, need_back=False):
        sid, counts, _, _ = rt._bin_entries(proj.depth, proj.mean2d, proj.radius, proj.valid,
                                            n_tiles, tx, ty, cap, need_back=need_back)
        return attrs[sid].contiguous(), counts

    # the opt step's tile subset: about half the tiles, from a fixed seed
    keep = torch.rand(n_tiles, generator=torch.Generator(device=dev).manual_seed(7), device=dev) < 0.5
    return {"surfels": int(s.num_active()), "intr": frame.intr, "tx": tx, "n_tiles": n_tiles, "hp": hp,
            "wp": wp, "slab": slab, "keep": keep}


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


def check_kernels(cfglib, torch) -> dict:
    """Phase 2: each kernel against its plain version on a real map, and
    bit for bit against its build without the cull."""
    from eggfusion_tpu_torch.ops import cuda_build
    from eggfusion_tpu_torch.ops import raster_tile as rt

    view = main_path_view(cfglib, torch)
    intr, tx, n_tiles, hp, wp = (view[k] for k in ("intr", "tx", "n_tiles", "hp", "wp"))
    fwd_nc, bwd_nc = no_cull(rt, cuda_build)
    results = {"surfels": view["surfels"], "tiles": n_tiles}

    def subset(counts):
        return torch.where(view["keep"][:, None], counts, torch.zeros_like(counts))

    def check_fwd(entries, counts, cap, geom):
        k_out = rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
        torch.cuda.synchronize()
        p_out = rt._split(rt._tiles_to_image(rt.composite_plain(entries, counts, intr, tx, cap, geom), tx), geom)
        if not all(torch.isfinite(x).all() for x in k_out):
            fail(f"forward (geom={geom}, cap {cap}): non-finite output")
        rel, ab = fwd_errors(k_out, p_out)
        if rel > FWD_TOL:
            fail(f"forward (geom={geom}, cap {cap}): kernel differs from its plain version by {rel}")
        if not same_bits(k_out, fwd_nc(entries, counts, intr, tx, cap, geom=geom)):
            fail(f"forward (geom={geom}, cap {cap}): the row cull changes the output")
        call = lambda: rt.composite_fwd(entries, counts, intr, tx, cap, geom=geom)
        times = cuda_times(call, reps=20)
        return {"max_abs_err": ab, "max_rel_err": rel, "ms": statistics.median(times),
                "ms_min_max": [min(times), max(times)], "stream_ms": stream_ms(call),
                "no_cull_stream_ms": stream_ms(lambda: fwd_nc(entries, counts, intr, tx, cap, geom=geom)),
                "no_cull_same_bits": True}

    # ---- forward, full and geometry-only, CAP 2048 over all tiles (the model
    # render), and the full forward at the opt step's shape too ----
    cap = 2048
    entries, counts = view["slab"](cap)
    pc = pair_counts(rt, entries, counts, tx, cap)
    opt_entries, opt_counts = view["slab"](1024)
    opt_counts = subset(opt_counts)
    for geom, name in ((False, "composite_fwd"), (True, "composite_geom")):
        r = check_fwd(entries, counts, cap, geom)
        plain_ms = cuda_ms(lambda: rt.composite_plain(entries, counts, intr, tx, cap, geom), reps=2, warm=1)
        planes = 3 if geom else 9
        bytes_moved = pc["entries"] * 64 + counts.numel() * 4 + 16 + planes * hp * wp * 4
        results[name] = {"cap": cap, **pc, **r, "tol": FWD_TOL, "plain_ms": plain_ms,
                         **bound(name, pc, bytes_moved)}
        if not geom:
            r2 = check_fwd(opt_entries, opt_counts, 1024, False)
            results[name]["ms_by_shape"] = {"cap2048_all_tiles": r["ms"], "cap1024_half_tiles": r2["ms"]}
            results[name]["opt_shape"] = {"cap": 1024, "kept_tiles": int(view["keep"].sum()),
                                          **pair_counts(rt, opt_entries, opt_counts, tx, 1024), **r2}
        emit({"phase": "check", "kernel": name, **results[name]})

    # ---- backward, CAP 1024 with a half tile subset (the opt step) ----
    cap = 1024
    entries, counts = opt_entries, opt_counts
    rgb, nrm, dep, opa, T = rt.composite_fwd(entries, counts, intr, tx, cap)
    g = torch.Generator(device="cuda").manual_seed(11)
    cots = [torch.randn(x.shape, generator=g, device=x.device) for x in (rgb, nrm, dep, opa, T)]
    d_k = rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)
    torch.cuda.synchronize()
    d_p = rt.composite_bwd_plain(entries, counts, intr, *cots, tx, cap, tile_batch=16)
    rel, ab = bwd_errors(d_k, d_p)
    pc = pair_counts(rt, entries, counts, tx, cap)
    call = lambda: rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)
    times = cuda_times(call, reps=20)
    plain_ms = cuda_ms(lambda: rt.composite_bwd_plain(entries, counts, intr, *cots, tx, cap, tile_batch=16),
                       reps=1, warm=0)
    bytes_moved = pc["entries"] * 64 + counts.numel() * 4 + 16 + 10 * hp * wp * 4 + entries.numel() * 4
    results["composite_bwd"] = {"cap": cap, "kept_tiles": int(view["keep"].sum()), **pc,
                                "max_abs_err": ab, "max_rel_err": rel, "tol": BWD_TOL,
                                "ms": statistics.median(times), "ms_min_max": [min(times), max(times)],
                                "stream_ms": stream_ms(call),
                                "no_cull_stream_ms": stream_ms(lambda: bwd_nc(entries, counts, intr, *cots, T,
                                                                              tx, cap)),
                                "plain_ms": plain_ms, **bound("composite_bwd", pc, bytes_moved)}
    emit({"phase": "check", "kernel": "composite_bwd", **results["composite_bwd"]})
    if not torch.isfinite(d_k).all():
        fail("composite_bwd: non-finite gradients")
    if rel > BWD_TOL:
        fail(f"composite_bwd: kernel differs from its plain version by {rel} (relative)")
    # determinism: a second launch gives the same bits, and so does the build without the cull
    if not torch.equal(d_k, rt.composite_bwd(entries, counts, intr, *cots, T, tx, cap)):
        fail("composite_bwd: two launches disagree")
    if not torch.equal(d_k, bwd_nc(entries, counts, intr, *cots, T, tx, cap)):
        fail("composite_bwd: the row cull changes the gradients")
    return results


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

    checks = check_kernels(cfglib, torch)
    adversarial = check_adversarial(torch)
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
                        "bound_by": c["bound_by"], "library_ms": None, "stream_ms": c["stream_ms"],
                        "bound_ms_visited": c["bound_ms_visited"]})
        if "ms_by_shape" in c:
            kernels[-1]["ms_by_shape"] = c["ms_by_shape"]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "checks": checks, "adversarial": adversarial, "main": main_run,
                   "burst": burst_run, "kernels": kernels},
                  f, indent=1)
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
