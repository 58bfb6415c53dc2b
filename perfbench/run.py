"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload replica.orbit --seed 7 --seconds 20 --trace 0

From the root of a checkout, on a machine with the CUDA devices the cell
asks for. `BENCHMARK.json` names the cells; `perfbench/harness/driver.py`
says what a run does. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and last `checks`: each number that decided `correct`
beside its limit); the same numbers end standard error. Exits with 2, and
prints no result, without enough CUDA devices; with 3 if a module of JAX
or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every cache of the program sits at a fixed path inside the checkout: the
# program's nvcc and g++ builds under build/eggfusion_tpu_torch/ (its own
# choice), Triton's (should the program come to use it) here
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench", "triton")


def _finite(x):
    """The line's numbers as JSON takes them: a non-finite gap is null."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one benchmark cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench.harness import driver

    try:
        line, _numbers = driver.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except driver.NoDevice as e:
        driver.log(f"[perfbench] {e}")
        return 2
    bad = driver.forbidden_modules()
    if bad:
        driver.log(f"[perfbench] modules of JAX or of the JAX package were loaded: {bad}")
        return 3
    for name, c in line["checks"].items():
        driver.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
