"""Device operations belong to the program span open at their launch, and
idle gaps carry the program span the host was in: a hand-built trace."""
import numpy as np
import pytest

from perfbench.harness import manifest
from perfbench.harness.spans import (LAYERS, attributed_share, by_span, device_ms_per_frame, innermost, span_parents,
                                     summarize)

MAIN, OTHER = 1, 2


def _trace():
    # one frame on the main thread: build_frame 0-10 (program span frame
    # 1-9), reconstruct 10-100 holding track 12-30 (a readback 25-29 in it)
    # and map_update 40-60 (a capture 45-55 in it); another thread opens
    # track 20-35
    prog = [("frame", 1, 9, MAIN), ("track", 12, 30, MAIN), ("track", 20, 35, OTHER), ("readback", 25, 29, MAIN),
            ("map_update", 40, 60, MAIN), ("capture", 45, 55, MAIN)]
    start, end, tid = (np.asarray([p[i] for p in prog]) for i in (1, 2, 3))
    parent = span_parents(start, end, tid)
    # ops: the frame's upload (launched at 2, run 3-8); track's graph,
    # launched at 14 and run 31-36, after its span closed; a readback's copy
    # launched at 26; a kernel launched on the main thread at 32, between
    # spans, while the other thread's track is open; map_update's binning
    # launched at 42; a capture's warm run launched at 50; map_update's
    # graph launched at 57, run 80-85; a launch kineto did not record (-1)
    launch = np.asarray([2, 14, 14, 26, 32, 42, 50, 57, -1])
    op_tid = np.asarray([MAIN] * 8 + [-1])
    return {
        "window_ns": (0, 120),
        "op_name": ["upload", "gn", "gn", "d2h", "stray", "bin", "warm", "fuse", "lost"],
        "op_kind": np.asarray(["gpu_memcpy", "kernel", "kernel", "gpu_memcpy", "kernel", "kernel", "kernel",
                               "kernel", "kernel"]),
        "op_start": np.asarray([3, 31, 34, 36, 39, 44, 71, 80, 90], np.int64),
        "op_end": np.asarray([8, 34, 36, 37, 40, 46, 75, 85, 92], np.int64),
        "spans": [("build_frame", 0, 0, 10), ("reconstruct", 0, 10, 100), ("fence", 0, 100, 110)],
        "main_tid": MAIN,
        "prog_spans": prog,
        "prog_parent": parent,
        "op_launch": launch,
        "op_tid": op_tid,
        "op_span": innermost(launch, op_tid, start, end, tid, parent),
    }


def test_an_operation_belongs_to_the_innermost_span_open_at_its_launch():
    tr = _trace()
    assert list(tr["prog_parent"]) == [-1, -1, -1, 1, -1, 4]
    names = [tr["prog_spans"][j][0] if j >= 0 else None for j in tr["op_span"]]
    # the graph's kernels ran after track closed; the stray launch sat
    # between the main thread's spans (the other thread's track does not
    # count); the unrecorded launch belongs to none
    assert names == ["frame", "track", "track", "readback", None, "map_update", "capture", "map_update", None]
    assert tr["op_span"][1] == tr["op_span"][2] == 1
    # an instant on a span's edge is inside it; a thread with no spans holds none
    assert list(innermost([12, 30, 31, 45, 55, 20], [MAIN, MAIN, MAIN, MAIN, MAIN, 3], *_arrays(tr))) == [
        1, 1, -1, 5, 5, -1]


def _arrays(tr):
    p = tr["prog_spans"]
    return ([s for _n, s, _e, _t in p], [e for _n, _s, e, _t in p], [t for *_x, t in p], tr["prog_parent"])


def test_nested_spans_sharing_a_start_keep_the_inner_one():
    start, end, tid = [0, 0, 2], [10, 5, 4], [MAIN] * 3
    parent = span_parents(start, end, tid)
    assert list(parent) == [-1, 0, 1]
    assert list(innermost([0, 3, 6, 11], [MAIN] * 4, start, end, tid, parent)) == [1, 2, 0, -1]


def test_layer_metrics_read_their_spans_and_what_nests_in_them():
    tr = _trace()
    layer = lambda name: device_ms_per_frame(tr, 1, LAYERS[name])
    assert layer("datasets.device_ms") == pytest.approx(5e-6)
    assert layer("tracking.device_ms") == pytest.approx(6e-6)  # the graph's 3 + 2 ns and its readback's copy
    assert layer("mapping.device_ms") == pytest.approx(11e-6)  # the binning, the warm run, the update's graph
    assert layer("mapping.opt_device_ms") is None  # no window_opt span in this trace
    assert by_span(tr, 2) == pytest.approx({"capture": 2e-6, "frame": 2.5e-6, "map_update": 5.5e-6,
                                            "readback": 0.5e-6, "track": 3e-6})
    record = {"frames": 1, "trace": tr, "ef_metrics": [{"frame": 7, "readback_ms": 2.0, "capture_ms": 0.0},
                                                       {"frame": 8, "readback_ms": 4.0, "capture_ms": 9.0}]}
    assert manifest.metric_reader("device.readback_wait_ms")(record) == 3.0
    assert manifest.metric_reader("graphs.capture_ms")(record) == 4.5
    # a program without spans or counters: nothing to read, nothing raised
    bare = dict(tr, prog_spans=[], prog_parent=np.zeros(0, np.int64), op_span=np.full(9, -1))
    for names in LAYERS.values():
        assert device_ms_per_frame(bare, 1, names) is None
        assert device_ms_per_frame(None, 1, names) is None
    assert by_span(bare, 1) == {}
    for name in ("device.readback_wait_ms", "graphs.capture_ms"):
        assert manifest.metric_reader(name)({"frames": 1, "trace": bare, "ef_metrics": [{"frame": 7}]}) is None
        assert manifest.metric_reader(name)({"frames": 0, "trace": None, "ef_metrics": []}) is None


def test_idle_gaps_name_the_program_span_and_the_share_attributed():
    tr = _trace()
    gaps = [(n, round(s * 1e9)) for n, s in summarize(tr)["breakdown"]["idle_gaps"]]
    # [92, 120) and [75, 80), [85, 90), [37, 39) began in no program span;
    # [46, 71) in the capture inside map_update, [8, 31) in frame, [40, 44)
    # in map_update as it opened; [0, 3) before frame opened
    assert gaps == [("reconstruct:frame0", 28), ("reconstruct:frame0/capture", 25),
                    ("build_frame:frame0/frame", 23), ("reconstruct:frame0", 5), ("reconstruct:frame0", 5),
                    ("reconstruct:frame0/map_update", 4), ("build_frame:frame0", 3), ("reconstruct:frame0", 2)]
    # of the 23 ns launched in build_frame or reconstruct, the stray
    # kernel's 1 ns belongs to no program span; the unrecorded launch is
    # in neither
    assert attributed_share(tr) == pytest.approx(100.0 * 22 / 23)
    # a trace of a program without spans: the labels stay as they were
    bare = dict(tr, prog_spans=[], prog_parent=np.zeros(0, np.int64), op_span=np.full(9, -1))
    assert [n for n, _s in summarize(bare)["breakdown"]["idle_gaps"]][:3] == [
        "reconstruct:frame0", "reconstruct:frame0", "build_frame:frame0"]
    assert attributed_share(bare) == 0.0


def test_span_tracer_reads_the_program_spans_of_a_profile():
    import torch
    from torch.profiler import record_function

    from perfbench.harness.spans import SpanTracer

    tracer = SpanTracer(True)
    tracer.start()
    with tracer.span("window"):
        with tracer.span("build_frame"), record_function("frame"):
            x = torch.ones(64) + 1
        with tracer.span("reconstruct"), record_function("track"), record_function("readback"):
            float((x * 2).sum())
    tracer.stop()
    tr = tracer.reduce()
    assert tracer.reduced is tr
    assert [n for n, *_ in tr["spans"]] == ["build_frame", "reconstruct"]  # the benchmark's spans stay apart
    assert [(n, t) for n, _s, _e, t in tr["prog_spans"]] == [("frame", tr["main_tid"]), ("track", tr["main_tid"]),
                                                             ("readback", tr["main_tid"])]
    assert list(tr["prog_parent"]) == [-1, -1, 1]
    assert len(tr["op_span"]) == len(tr["op_launch"]) == len(tr["op_tid"]) == len(tr["op_start"])
