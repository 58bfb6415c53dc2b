"""Run one cell traced, with the device time split by the program's spans.

    python3 perfbench/spans.py --workload replica.orbit --seed 7 --seconds 20

The run of `perfbench/run.py --trace 1`, with `perfbench/harness/spans.py`'s
tracer in place of the benchmark's: the last line of standard output is
that run's result line, each idle gap's label followed by the program span
the host was in (`reconstruct:frame197/capture`), plus `spans`: device ms a
frame under each program span (`by_span`) and under each layer's spans
(`layers`), and the share of the device time launched in `build_frame` and
`reconstruct` that program spans hold (`attributed_share`, %). A program
without spans gives empty `by_span` and `layers` and the labels as they
were. Exit codes as `run.py`'s.
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
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench", "triton")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one traced run of one benchmark cell, by program span")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    from perfbench import run
    from perfbench.harness import driver, spans

    made = []

    def tracer(enabled):
        made.append(spans.SpanTracer(enabled))
        return made[-1]

    driver.Tracer, driver.summarize = tracer, spans.summarize
    try:
        line, _numbers = driver.run(args.workload, args.seed, args.seconds, True, T_START)
    except driver.NoDevice as e:
        driver.log(f"[perfbench] {e}")
        return 2
    bad = driver.forbidden_modules()
    if bad:
        driver.log(f"[perfbench] modules of JAX or of the JAX package were loaded: {bad}")
        return 3
    tr, frames = made[-1].reduced, line["attempted"]
    layers = {k: spans.device_ms_per_frame(tr, frames, names) for k, names in spans.LAYERS.items()}
    line["spans"] = {"attributed_share": spans.attributed_share(tr), "by_span": spans.by_span(tr, frames),
                     "layers": {k: v for k, v in layers.items() if v is not None}}
    driver.log("[perfbench] spans " + json.dumps(line["spans"]))
    print(json.dumps(run._finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
