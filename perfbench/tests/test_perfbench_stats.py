"""The arithmetic of the end-to-end metrics and of the trace: every frame of
the window counts, and device time is a union of intervals."""
import math

import numpy as np

from perfbench.harness import manifest, stats
from perfbench.harness.trace import summarize


def test_p95_and_fps_count_every_frame_with_a_stall():
    # 200 frames of 50 ms, one stalls 2 s: the window is 11.95 s long
    request_s = np.arange(200) * 0.05
    request_s[150:] += 1.95
    done_ms = request_s * 1e3 + 40.0
    done_ms[149] += 1950.0
    lat = np.round(stats.frame_latencies_ms(request_s, done_ms), 6)
    assert lat[149] == 1990.0 and np.sum(lat == 40.0) == 199
    # nearest rank: 10 frames at or above the 95th percentile of 200
    assert stats.percentile(lat, 95) == 40.0
    lat[139:149] = 500.0  # 11 slow frames: the 190th of 200 is one of them
    assert stats.percentile(lat, 95) == 500.0
    assert stats.percentile(list(range(1, 101)), 95) == 95.0
    assert math.isnan(stats.percentile([], 95))
    wall = request_s[-1] + 0.05
    assert stats.fps(200, wall) == 200 / wall


def test_union_of_overlapping_streams():
    # two streams: [0, 10) and [5, 20) overlap; [30, 40) alone; [35, 36) inside it
    s, e = [0, 5, 30, 35], [10, 20, 40, 36]
    us, ue = stats.union(s, e)
    assert list(us) == [0, 30] and list(ue) == [20, 40]
    assert stats.busy_ns(s, e, 0, 50) == 30  # a sum of durations would say 36
    gs, ge = stats.gaps(s, e, 0, 50)
    assert list(zip(gs, ge)) == [(20, 30), (40, 50)]
    assert stats.busy_ns(s, e, 8, 32) == 14  # clipped to the window
    assert stats.busy_ns([], [], 0, 10) == 0


def _trace():
    # frame 0: build 0-10, reconstruct 10-60, fence 60-70; kernels on two streams
    return {
        "window_ns": (0, 100),
        "op_name": ["a", "b", "a", "composite_fwd_kernel<false>", "memcpy"],
        "op_kind": np.asarray(["kernel", "kernel", "kernel", "kernel", "gpu_memcpy"]),
        "op_start": np.asarray([12, 15, 40, 42, 80], np.int64),
        "op_end": np.asarray([30, 35, 50, 46, 90], np.int64),
        "spans": [("build_frame", 0, 0, 10), ("reconstruct", 0, 10, 60), ("fence", 0, 60, 70)],
    }


def test_trace_summary_and_readers():
    tr = _trace()
    out = summarize(tr)
    assert round(out["busy_s"] * 1e9) == 43 and round(out["window_s"] * 1e9) == 100
    assert [(n, round(s * 1e9)) for n, s in out["breakdown"]["device_ops"][:2]] == [("a", 28), ("b", 20)]
    # gaps [0, 12) in build_frame, [35, 40) and [50, 80) in reconstruct, [90, 100) after the fence
    gaps = [(n, round(s * 1e9)) for n, s in out["breakdown"]["idle_gaps"]]
    assert gaps == [("reconstruct:frame0", 30), ("build_frame:frame0", 12), ("between spans", 10),
                    ("reconstruct:frame0", 5)]
    record = {"frames": 1, "trace": tr, "build_ms": [2.0], "ef_metrics": [], "latency_ms": [1.0],
              "captures": 0, "capacity": 32768}
    assert abs(manifest.metric_reader("device.idle_share")(record) - 57.0) < 1e-9
    assert manifest.metric_reader("device.kernels_per_frame")(record) == 4.0
    assert abs(manifest.metric_reader("kernels.composite_ms")(record) - 4e-6) < 1e-18
    assert manifest.metric_reader("datasets.host_ms")(record) == 2.0
    assert manifest.metric_reader("tracking.host_ms")(record) is None
    untraced = dict(record, trace=None)
    for name in ("device.idle_share", "device.kernels_per_frame", "kernels.composite_ms"):
        assert manifest.metric_reader(name)(untraced) is None
