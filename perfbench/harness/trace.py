"""The traced run: `torch.profiler` over the measured frames, reduced to
what the per-layer metrics and the `breakdown` read.

The benchmark's own spans (`build_frame`, `reconstruct`, `fence`, and
`window` around them all) are profiler annotations, so they share the
device operations' clock. Device operations are the kernels (graph
replays included), copies and fills on every stream; the device is busy
where at least one runs (a union of intervals, never a sum).
"""
from __future__ import annotations

import contextlib

import numpy as np

from perfbench.harness import stats

SPANS = ("build_frame", "reconstruct", "fence")
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e, cuda_type) -> str:
    """An event's kineto activity: `activity_type()` where this PyTorch has
    it, else worked out from the device and the name."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        return str(act())
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if e.device_type() != cuda_type:
        return "user_annotation" if annotation or e.name() in SPANS + ("window",) else "cpu_op"
    if annotation or e.name() in SPANS + ("window",):
        return "gpu_user_annotation"
    n = e.name().lower()
    return "gpu_memcpy" if n.startswith("memcpy") else "gpu_memset" if n.startswith("memset") else "kernel"


def _span_ns(e):
    """(start, end) in nanoseconds."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


class Tracer:
    """Spans as profiler annotations when `enabled`, else no-ops."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def start(self) -> None:
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """The trace as arrays: device operations (name, kind, start_ns,
        end_ns) and the benchmark's spans (name, frame, start_ns, end_ns),
        with the window's bounds."""
        import torch

        cuda_type = torch.autograd.DeviceType.CUDA
        names, kinds, starts, ends = [], [], [], []
        spans = []
        window = None
        frame_of = {}
        for e in self.prof.profiler.kineto_results.events():
            act = _kind(e, cuda_type)
            if act in DEVICE_OPS:
                names.append(e.name())
                kinds.append(act)
                s0, s1 = _span_ns(e)
                starts.append(s0)
                ends.append(s1)
            elif act == "user_annotation":
                n = e.name()
                if n == "window":
                    window = _span_ns(e)
                elif n in SPANS:
                    spans.append((n, *_span_ns(e)))
        spans.sort(key=lambda s: s[1])
        # a span's frame: build_frame opens each frame
        k = -1
        for i, (n, _s, _e) in enumerate(spans):
            if n == "build_frame":
                k += 1
            frame_of[i] = k
        return {
            "window_ns": window,
            "op_name": names,
            "op_kind": np.asarray(kinds),
            "op_start": np.asarray(starts, np.int64),
            "op_end": np.asarray(ends, np.int64),
            "spans": [(n, frame_of[i], s, e) for i, (n, s, e) in enumerate(spans)],
        }


def summarize(tr: dict, top: int = 10) -> dict:
    """busy_s and window_s of the traced window, and the breakdown: the
    device operations that took most time (summed by name) and the longest
    idle gaps, each named by the benchmark span the host was in when it
    began."""
    lo, hi = tr["window_ns"]
    busy = stats.busy_ns(tr["op_start"], tr["op_end"], lo, hi)
    by_name: dict = {}
    for n, s, e in zip(tr["op_name"], tr["op_start"], tr["op_end"]):
        by_name[n] = by_name.get(n, 0) + int(e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gs, ge = stats.gaps(tr["op_start"], tr["op_end"], lo, hi)
    order = np.argsort(-(ge - gs), kind="stable")[:top]
    span_starts = np.asarray([s for _n, _k, s, _e in tr["spans"]], np.int64)
    named = []
    for i in order:
        j = int(np.searchsorted(span_starts, gs[i], side="right")) - 1
        if j >= 0 and tr["spans"][j][3] >= gs[i]:
            n, k = tr["spans"][j][0], tr["spans"][j][1]
            label = f"{n}:frame{k}"
        else:
            label = "between spans"
        named.append([label, (ge[i] - gs[i]) / 1e9])
    return {
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "breakdown": {"device_ops": [[n, ns / 1e9] for n, ns in ops], "idle_gaps": named},
    }
