"""One run of one cell: generate the inputs from the seed, build and warm up
the system, measure the window, judge what it produced, print the result.

The loop is closed, as `main.run`'s: frame k + 1 is requested when
`reconstruct` of frame k returns. The window starts at a device fence,
takes frames while fewer than `seconds` have passed, and ends at a fence
after the last one. Frame k's latency runs from its request (before
`build_frame`) to the device finishing its work (a CUDA event recorded
after `reconstruct`, read against the event recorded at the window's
start); no frame waits for another's fence.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from perfbench.harness import manifest, stats
from perfbench.harness.trace import Tracer, summarize

FORBIDDEN = ("jax", "jaxlib", "flax", "eggfusion_tpu")
GIB = float(1 << 30)


class NoDevice(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _scaled(calib: dict, scale: float) -> dict:
    """A calibration for a camera `scale` times the size (tests only)."""
    c = dict(calib)
    c["width"], c["height"] = int(round(c["width"] * scale)), int(round(c["height"] * scale))
    c["fx"], c["fy"] = c["fx"] * scale, c["fy"] * scale
    c["cx"], c["cy"] = (c["cx"] + 0.5) * scale - 0.5, (c["cy"] + 0.5) * scale - 0.5
    return c


def _set_tf32(torch, on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
        control: str | None = None, scale: float | None = None, max_frames: int | None = None,
        limits: dict | None = None):
    """Run cell `name` once; returns its result line (a dict) and every
    number the reference read (`checks` holds those with a limit). `control`
    "tf32" runs the program with its TF32 path on (the control of
    `correct`); `scale` shrinks the camera, `max_frames` caps the window and
    `limits` replaces the cell's (CPU tests only)."""
    import torch

    from perfbench.harness import port
    from perfbench.reference import check

    cell = manifest.find_cell(name)
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoDevice(f"cell {name} needs {cell.chips} CUDA device(s); {n} available")
    cfg_doc = json.loads(json.dumps(cell.config))
    calib = cfg_doc["config"]["Dataset"]["Calibration"]
    if scale is not None:
        calib = cfg_doc["config"]["Dataset"]["Calibration"] = _scaled(calib, scale)
    traffic = cell.traffic
    _set_tf32(torch, False)

    workdir = tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get("TMPDIR"))
    try:
        t0 = time.perf_counter()
        stream = manifest.generator(traffic).make(calib, traffic, seed, device, workdir)
        if cuda:
            torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        log(f"[perfbench] inputs generated in {gen_s:.3f} s ({len(stream.gt_w2c)} unique frames)")
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cfg = port.config(cfg_doc, stream.path)
        ef, ds, preload = port.system(cfg, stream, device)
        if control == "tf32":
            _set_tf32(torch, True)
        elif control is not None:
            raise ValueError(f"unknown control {control!r}")
        build, reconstruct = port.frame_fn(ef, ds, preload)

        def fence():
            if cuda:
                torch.cuda.synchronize()

        t1 = time.perf_counter()
        ef.warmup()
        n_warm = int(traffic["warm_frames"])
        for k in range(n_warm):
            reconstruct(build(k))
        fence()
        log(f"[perfbench] warmup {ef.warmup_s:.3f} s, {n_warm} warm frames "
            f"{time.perf_counter() - t1 - ef.warmup_s:.3f} s, capacity {ef.mapper.surfels.capacity}")

        # the model view the reference judges is stream frame `view_frame`'s,
        # a frame every run reaches, so that its quality does not follow how
        # many frames the window held (a capped window judges its last one)
        view_frame = int(traffic["view_frame"])
        if max_frames is not None:
            view_frame = min(view_frame, n_warm + max_frames - 1)
        assert view_frame >= n_warm, (view_frame, n_warm)
        views = []

        def snap(k: int) -> None:
            if k == view_frame:
                views.append(port.model_view(ef))

        tracer = Tracer(trace)
        window = _window(torch, ef, build, reconstruct, n_warm, seconds, tracer, fence, cuda, max_frames, snap)
        setup_s = window["t_window"] - t_start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        n = window["frames"]
        recs = ef.metrics[len(ef.metrics) - window["records"]:]
        record = {
            "frames": n,
            "window_s": window["wall_s"],
            "build_ms": window["build_ms"],
            "latency_ms": window["latency_ms"],
            "ef_metrics": [m for m in recs if m.get("frame", -1) >= 0],
            "captures": window["captures"],
            "capacity": int(ef.mapper.surfels.capacity),
            "trace": tracer.reduce() if trace else None,
        }
        failed = sum(1 for m in recs if "recovered_to_kf" in m)
        k = n_warm + n
        while not views:  # the window closed before the judged frame: run on to it, untimed
            reconstruct(build(k))
            snap(k)
            k += 1
        log(f"[perfbench] model view judged at frame {view_frame}"
            + (f", {k - n_warm - n} frames past the window" if k > n_warm + n else ""))
        out = {**port.outputs(ef), **views.pop()}
        # the reference runs once the program's state is freed
        del ef, ds, build, reconstruct, recs, snap
        if cuda:
            torch.cuda.empty_cache()
        numbers = _numbers(check, stream, out, n_warm, n)
        del out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    ok, judged = check.judge(numbers, cell.limits if limits is None else limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {
            "fps": stats.fps(n, window["wall_s"]),
            "frame_ms_p95": stats.percentile(window["latency_ms"], 95),
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": n, "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        summary = summarize(record["trace"])
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        line["breakdown"] = summary["breakdown"]
    log(f"[perfbench] {n} frames in {window['wall_s']:.3f} s, setup {setup_s:.3f} s (inputs {gen_s:.3f} s), "
        f"captures in the window {record['captures']}, recoveries {failed}, capacity {record['capacity']}")
    log("[perfbench] numbers " + json.dumps(numbers))
    if cuda:
        log(f"[perfbench] card {_card()}")
    line["checks"] = judged
    return line, numbers


def _window(torch, ef, build, reconstruct, k0: int, seconds: float, tracer, fence, cuda: bool,
            max_frames: int | None, snap) -> dict:
    """The measured frames, from stream frame k0 on; `snap(k)` after each."""
    events, request_s, build_ms, rec_ms = [], [], [], []
    records0 = len(ef.metrics)
    captures0 = ef.programs.captures()
    tracer.start()
    with tracer.span("window"):
        fence()
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            start.record()
        t0 = time.perf_counter()
        k = k0
        while True:
            tr = time.perf_counter() - t0
            if tr >= seconds or (max_frames is not None and k - k0 >= max_frames):
                break
            with tracer.span("build_frame"):
                frame = build(k)
            tb = time.perf_counter() - t0
            with tracer.span("reconstruct"):
                reconstruct(frame)
                snap(k)
            te = time.perf_counter() - t0
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            request_s.append(tr)
            build_ms.append((tb - tr) * 1e3)
            rec_ms.append((te - tb) * 1e3)
            k += 1
        with tracer.span("fence"):
            fence()
        wall = time.perf_counter() - t0
    tracer.stop()
    if cuda:
        done_ms = [start.elapsed_time(ev) for ev in events]
    else:  # no device clock: the host's return stands for completion
        done_ms = [(r * 1e3 + b + c) for r, b, c in zip(request_s, build_ms, rec_ms)]
    return {
        "t_window": t0,
        "frames": k - k0,
        "wall_s": wall,
        "latency_ms": list(stats.frame_latencies_ms(request_s, done_ms)),
        "build_ms": build_ms,
        "records": len(ef.metrics) - records0,
        "captures": ef.programs.captures() - captures0,
    }


def _numbers(check, stream, out: dict, n_warm: int, n: int) -> dict:
    """The reference's readings of what the window produced: the poses of
    the window's frames (with the frame before the first, for its
    motion), the map, the judged frame's model view (depth and color)."""
    planes = stream.planes
    pivot = stream.gt_w2c[stream.unique(0)]
    est = out["est_w2c"]
    ks = range(n_warm - 1, n_warm + n)
    gt = np.stack([stream.gt_rebased(k) for k in ks])
    numbers = check.pose_numbers(est[n_warm - 1:n_warm + n], gt)
    pivot_inv = np.linalg.inv(pivot)
    import torch

    xyz = out["xyz"].to(torch.float64)
    R = torch.as_tensor(pivot_inv[:3, :3], dtype=torch.float64, device=xyz.device)
    t = torch.as_tensor(pivot_inv[:3, 3], dtype=torch.float64, device=xyz.device)
    numbers.update(check.map_numbers(planes, xyz @ R.T + t))
    view_w2c = out["view_w2c"].to("cpu", torch.float64).numpy() @ pivot
    numbers.update(check.view_numbers(planes, stream.intr, view_w2c, out["view_depth"], out["view_mask"]))
    numbers.update(check.color_numbers(planes, stream.detail, stream.offset, stream.intr, view_w2c,
                                       out["view_color"], out["view_mask"]))
    return {k: (v if not isinstance(v, float) or math.isfinite(v) else float("inf")) for k, v in numbers.items()}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (no nvidia-smi)"
