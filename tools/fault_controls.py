"""A benchmark cell run under planted faults, for the upper readings its
limits are set from (`PERF.md` §2), one JSON line a run:

    python3 tools/fault_controls.py --workload scannetpp.orbit --runs bf16:11 bf16:12 frozen:13 --seconds 20

`bf16` rounds the map's float parameters to bfloat16 after every frame (the
nearest precision below the float32 the program computes in, on a frame
whose work is elementwise); `frozen` sets every learning rate of the
window optimization to 0 (a frozen Adam step); `sound` runs the cell as it
is. All runs share one process, so the kernels are built once; each is the
benchmark's own run (`perfbench/harness/driver.py`, untraced) with the
fault planted around it. `--device cpu --scale 0.05 --max-frames 3`
rehearses it on the CPU at a small size (with `--max-surfels` to cap the
map there).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "eta")
MODES = ("sound", "bf16", "frozen")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--runs", nargs="+", required=True, help="<mode>:<seed>, mode one of " + ", ".join(MODES))
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scale", type=float, default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--max-surfels", type=int, default=None)
    args = parser.parse_args(argv)
    runs = [(r.split(":")[0], int(r.split(":")[1])) for r in args.runs]
    assert all(m in MODES for m, _ in runs), runs

    import torch

    from perfbench.harness import driver, manifest, port

    state = {"mode": None}
    find_cell = manifest.find_cell

    def cell(name, root=manifest.ROOT):
        c = find_cell(name, root)
        cfg = c.config["config"]
        if state["mode"] == "frozen":
            for k in list(cfg["Mapping"]):
                if k.endswith("_lr"):
                    cfg["Mapping"][k] = 0.0
        if args.max_surfels is not None:
            cfg["Viewer"]["max_surfels_num"] = args.max_surfels
            if "min_capacity" in cfg["System"]:
                cfg["System"]["min_capacity"] = args.max_surfels
        return c

    frame_fn = port.frame_fn

    def rounded(ef, ds, preload):
        build, rec = frame_fn(ef, ds, preload)

        def reconstruct(frame):
            out = rec(frame)
            if state["mode"] == "bf16":
                s = ef.mapper.surfels
                with torch.no_grad():
                    for f in FIELDS:
                        t = getattr(s, f)
                        t.copy_(t.to(torch.bfloat16).to(torch.float32))
            return out

        return build, reconstruct

    manifest.find_cell, port.frame_fn = cell, rounded
    for mode, seed in runs:
        state["mode"] = mode
        line, numbers = driver.run(args.workload, seed, args.seconds, False, time.perf_counter(), device=args.device,
                                   scale=args.scale, max_frames=args.max_frames)
        print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"], "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()}}), flush=True)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    manifest.find_cell, port.frame_fn = find_cell, frame_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
