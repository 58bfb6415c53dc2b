"""The control of `correct`, and the readings its limits are set from.

    python3 perfbench/control.py --workload replica.orbit --seeds 11 12 13 --seconds 20

For each seed, one run of the cell as the benchmark runs it and one with the
program's TF32 path on (`torch.backends.cuda.matmul.allow_tf32` and
`cudnn.allow_tf32`, which the program turns off: it computes in float32);
all in one process, so the kernels are built once. Prints one JSON line a
run: the seed, the control or not, `correct` and every number the
reference read. The benchmark's own runs never run the control.
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


def readings(workload: str, seeds, seconds: float, controls=(None, "tf32")) -> list:
    import torch

    from perfbench.harness import driver

    out = []
    for seed in seeds:
        for control in controls:
            line, numbers = driver.run(workload, seed, seconds, False, time.perf_counter(), control=control)
            out.append({"workload": workload, "seed": seed, "control": control, "correct": line["correct"],
                        "numbers": numbers, "metrics": {k: v["value"] for k, v in line["metrics"].items()}})
            print(json.dumps(out[-1]), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--plain-only", action="store_true", help="no control runs")
    args = parser.parse_args(argv)
    readings(args.workload, args.seeds, args.seconds, (None,) if args.plain_only else (None, "tf32"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
