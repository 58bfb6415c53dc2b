"""The program's renderer against the plain reference render
(`perfbench/reference/surfel_render.py`) at a benchmark cell's view frame,
on the map the timed path built.

    python3 tools/reference_view.py --workload scannetpp.orbit --seed 7 --seconds 20

Runs the cell once as the benchmark does (`perfbench/harness/driver.py`,
untraced). Right after the view frame's `reconstruct` (the frame whose
model view `correct` judges), the active surfels are copied. After the
run, the reference renders them at the view frame's pose, and the script prints one
JSON line: the median and 95th percentile of the depth gap (mm) and the
color gap (8-bit levels, mean over the channels) between the reference and

- the program's model view, over the pixels it took from its render
  (rendered before the frame's spawns and optimization steps, which the
  copy holds);
- the program's tile renderer on the copied map at the same pose, at the
  model view's cap (`System.raster_cap`) and at the optimization steps'
  (`System.opt_raster_cap`), over the pixels both cover (opacity > 0.5),
  split by whether the pixel's 32x32 sub-column list reaches the stratified
  tail at that cap;

beside the window's `renderer.tail_share` and `renderer.entries_per_frame`
(from its frame records) and the run's result line. The copy and the
script's own work run outside the window, except the copy when the window
reaches the view frame (one frame's latency). `--device cpu --scale 0.05
--max-frames 2` rehearses it on the CPU at a small size.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FIELDS = ("xyz", "rotation", "scaling", "opacity", "features_dc", "features_rest", "active")


def _q(x, qs=(0.5, 0.95)):
    import torch

    if x.numel() == 0:
        return [None for _ in qs]
    return [float(v) for v in torch.quantile(x.double(), torch.tensor(qs, dtype=torch.float64, device=x.device))]


def _gaps(name, depth_a, depth_b, color_a, color_b, m) -> dict:
    import torch

    d = torch.abs(depth_a - depth_b)[m] * 1e3
    c = torch.mean(torch.abs(color_a - color_b), dim=-1)[m] * 255.0
    (d50, d95), (c50, c95) = _q(d), _q(c)
    return {f"{name}_pixels": int(m.sum()), f"{name}_depth_mm_p50": d50, f"{name}_depth_mm_p95": d95,
            f"{name}_color_levels_p50": c50, f"{name}_color_levels_p95": c95}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    # a rehearsal on the CPU at a small size (`driver.run`'s test options)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scale", type=float, default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    args = parser.parse_args(argv)
    dev = args.device

    import torch

    from perfbench.harness import driver, manifest, port
    from perfbench.reference import surfel_render as ref

    kept = {}
    model_view = port.model_view

    def snap(ef):
        view = model_view(ef)
        s = ef.mapper.surfels
        act = s.active.bool()
        kept["surfels"] = {f: getattr(s, f).detach()[..., act].clone() for f in FIELDS}
        kept["metrics"] = ef.metrics
        kept["view"] = {k: v.clone() for k, v in view.items()}
        return view

    port.model_view = snap
    line, numbers = driver.run(args.workload, args.seed, args.seconds, False, T_START, device=dev, scale=args.scale,
                               max_frames=args.max_frames)
    port.model_view = model_view

    cell = manifest.find_cell(args.workload)
    doc = json.loads(json.dumps(cell.config))
    if args.scale is not None:
        doc["config"]["Dataset"]["Calibration"] = driver._scaled(doc["config"]["Dataset"]["Calibration"], args.scale)
    cfg = port.config(doc)
    calib = cfg.Dataset.Calibration
    W, H = int(calib.width), int(calib.height)
    intr = torch.tensor([calib.fx, calib.fy, calib.cx, calib.cy], dtype=torch.float32, device=dev)
    view, surfels = kept["view"], kept["surfels"]
    w2c = view["view_w2c"].to(torch.float32)
    sh = int(cfg.Surfel.active_sh_degree)
    t0 = time.perf_counter()
    want = ref.render(surfels, w2c, intr, W, H, sh_degree=sh)
    if dev == "cuda":
        torch.cuda.synchronize()
    out = {"workload": args.workload, "seed": args.seed, "correct": line["correct"], "numbers": numbers,
           "surfels": int(surfels["xyz"].shape[1]), "reference_s": time.perf_counter() - t0}
    out.update(_gaps("view", view["view_depth"], want["depth"][..., 0], view["view_color"], want["color"],
                     view["view_mask"].bool()))

    from eggfusion_tpu_torch.core import surfels as sf
    from eggfusion_tpu_torch.core.renderer import Renderer

    renderer = Renderer(cfg, dev, backend="pallas")
    full = sf.SurfelMap.empty(sf.SurfelConfig(capacity=surfels["xyz"].shape[1],
                                              max_sh_degree=int(cfg.Surfel.max_sh_degree)), device=dev)
    for f in FIELDS:
        getattr(full, f).copy_(surfels[f])
    counts = ref.subcolumn_counts(surfels, w2c, intr, W, H)
    for name, cap in (("render", renderer.raster_cap), ("opt_render", renderer.opt_raster_cap)):
        with torch.no_grad():
            got = renderer.render_at(sf.render_params(full), w2c, intr, W, H, need_grad=False, cap=cap)
        both = (got["opacity"][..., 0] > 0.5) & (want["opacity"][..., 0] > 0.5)
        near = (cap // 4) * 3 // 4
        tail = (counts > near).repeat_interleave(32, 0).repeat_interleave(32, 1)[:H, :W]
        out.update(ref.counters(counts, cap) if name == "render" else {})
        out.update(_gaps(name, got["depth"][..., 0], want["depth"][..., 0], got["color"], want["color"], both))
        out.update(_gaps(name + "_exact", got["depth"][..., 0], want["depth"][..., 0], got["color"], want["color"],
                         both & ~tail))
        out.update(_gaps(name + "_tail", got["depth"][..., 0], want["depth"][..., 0], got["color"], want["color"],
                         both & tail))
        out[name + "_tail_subcolumns"] = float((counts > near).float().mean())
    n_warm = int(cell.traffic["warm_frames"])
    window = range(n_warm, n_warm + int(line["attempted"]))
    record = {"ef_metrics": [m for m in kept["metrics"] if m.get("frame", -1) in window]}
    for m in ("renderer.tail_share", "renderer.entries_per_frame"):
        out[m] = manifest.metric_reader(m)(record)
    out["line"] = line
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
