"""The program's own spans in a traced run: which phase of the frame launched
each device operation, and which one the host was in at each idle gap.

The program opens `record_function` ranges on its frame path while a
profiler records (`eggfusion_tpu_torch/utils/trace.py`: `frame`, `track`,
`map_update`, `window_opt`, `capture`, `readback`, ...); they share the
trace's clock with the device operations. Every annotation that is not one
of the benchmark's spans (`trace.SPANS`, `window`) is one of them.

The rule: a device operation belongs to the innermost program span that was
open on the host thread that launched it, at the launch: the
`cudaLaunchKernel`, `cudaGraphLaunch` or `cudaMemcpyAsync` call kineto
correlates with it, however late the device ran it. An operation launched
in no program span, or whose launching call the trace lacks, belongs to
none. `span_parents` and `innermost` hold the rule over plain arrays.

`SpanTracer` is the benchmark's `Tracer` whose `reduce()` adds these
spans; `summarize` adds, after a slash, the innermost program span open on
the benchmark's thread at each idle gap's start to the gap's label
(`reconstruct:frame197/capture`). `perfbench/spans.py` runs a cell with
them; `perfbench/run.py` does not.
"""
from __future__ import annotations

import numpy as np

from perfbench.harness import stats, trace

HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")
# the program spans each layer's device time is read from (nested spans
# counted in the span that holds them)
LAYERS = {
    "datasets.device_ms": ("frame",),
    "tracking.device_ms": ("track", "recover"),
    "mapping.device_ms": ("preprocess", "map_update", "maintain", "window_opt", "model_view"),
    "mapping.opt_device_ms": ("window_opt",),
    "mapping.view_device_ms": ("model_view",),
}


class SpanTracer(trace.Tracer):
    """`Tracer` whose `reduce()` also returns the program's spans
    (`prog_spans`: name, start_ns, end_ns, host thread; `prog_parent`: the
    span each sits in), each device operation's launch (`op_launch` ns, -1
    where unknown; `op_tid`) and the program span it belongs to (`op_span`,
    -1 for none), and the host thread of the benchmark's spans
    (`main_tid`). The last result stays in `reduced`."""

    reduced = None

    def reduce(self) -> dict:
        import torch

        tr = super().reduce()
        cuda_type = torch.autograd.DeviceType.CUDA
        op_corr, prog = [], []
        launch_of = {}  # CUPTI correlation id -> (start_ns, tid) of the launching call
        main_tid = -1
        for e in self.prof.profiler.kineto_results.events():  # the order `Tracer.reduce` read the operations in
            act = trace._kind(e, cuda_type)
            if act in trace.DEVICE_OPS:
                op_corr.append(e.correlation_id())
            elif act in HOST_OPS and e.name().startswith("cu"):  # a CUDA runtime or driver call
                launch_of[e.correlation_id()] = (trace._span_ns(e)[0], e.start_thread_id())
            elif act == "user_annotation":
                n = e.name()
                if n == "window":
                    main_tid = e.start_thread_id()
                elif n not in trace.SPANS:
                    prog.append((n, *trace._span_ns(e), e.start_thread_id()))
        prog.sort(key=lambda s: (s[1], -s[2]))
        launch = [launch_of.get(c, (-1, -1)) for c in op_corr]
        op_launch = np.asarray([t for t, _ in launch], np.int64)
        op_tid = np.asarray([t for _, t in launch], np.int64)
        start, end, tid = _columns(prog)
        parent = span_parents(start, end, tid)
        tr.update(main_tid=main_tid, prog_spans=prog, prog_parent=parent, op_launch=op_launch, op_tid=op_tid,
                  op_span=innermost(op_launch, op_tid, start, end, tid, parent))
        self.reduced = tr
        return tr


def _columns(prog):
    """start_ns, end_ns and host thread of program spans, as arrays."""
    return tuple(np.asarray([p[i] for p in prog], np.int64) for i in (1, 2, 3))


def span_parents(start, end, tid) -> np.ndarray:
    """For spans (start_ns, end_ns, host thread) that nest on each thread,
    as the ranges of context managers do: each span's innermost enclosing
    span on its thread, as an index, or -1."""
    start, end, tid = (np.asarray(a, np.int64) for a in (start, end, tid))
    parent = np.full(len(start), -1, np.int64)
    stack: list = []
    for i in np.lexsort((-end, start, tid)):
        while stack and not (tid[stack[-1]] == tid[i] and end[i] <= end[stack[-1]]):
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    return parent


def innermost(t, t_tid, start, end, tid, parent) -> np.ndarray:
    """For each instant `t[i]` on host thread `t_tid[i]`, the index of the
    innermost span open there and then (start <= t <= end, on that thread),
    or -1; `parent` is `span_parents` of the spans."""
    t, t_tid, start, end, tid, parent = (np.asarray(a, np.int64) for a in (t, t_tid, start, end, tid, parent))
    out = np.full(len(t), -1, np.int64)
    for th in np.unique(tid):
        mine = np.flatnonzero(tid == th)
        mine = mine[np.lexsort((-end[mine], start[mine]))]  # an enclosing span before those it holds
        q = np.flatnonzero(t_tid == th)
        j = np.searchsorted(start[mine], t[q], side="right") - 1
        idx = np.where(j >= 0, mine[np.maximum(j, 0)], -1)
        while True:  # climb out of the spans that closed before the instant
            closed = (idx >= 0) & (end[np.maximum(idx, 0)] < t[q])
            if not closed.any():
                break
            idx = np.where(closed, parent[np.maximum(idx, 0)], idx)
        out[q] = idx
    return out


def _under(tr: dict, names) -> np.ndarray:
    """Per device operation: whether the program span it belongs to is
    named in `names` or sits inside one that is."""
    prog = tr["prog_spans"]
    under = np.zeros(len(prog) + 1, bool)  # the last entry stands for "no span"
    for i in np.lexsort(([-e for _n, _s, e, _t in prog], [s for _n, s, _e, _t in prog])):  # parents first
        p = tr["prog_parent"][i]
        under[i] = prog[i][0] in names or (p >= 0 and under[p])
    return under[tr["op_span"]]


def device_ms_per_frame(tr: dict, frames: int, names) -> float | None:
    """Device ms a frame of the operations that belong to the program spans
    `names` or to spans inside them; None without a trace or frames, or
    when no such span opened (a program without these spans)."""
    if tr is None or not frames or not any(n in names for n, *_ in tr.get("prog_spans") or []):
        return None
    dur = tr["op_end"] - tr["op_start"]
    return float(dur[_under(tr, names)].sum()) / 1e6 / frames


def attributed_share(tr: dict) -> float | None:
    """Of the device time launched inside the benchmark's `build_frame` and
    `reconstruct` spans, the share (%) that belongs to a program span; None
    where the trace holds no launch inside them."""
    frames = [(s, e) for n, _k, s, e in tr["spans"] if n in ("build_frame", "reconstruct")]
    if not frames or "op_launch" not in tr:
        return None
    f_start = np.asarray([s for s, _e in frames], np.int64)
    f_end = np.asarray([e for _s, e in frames], np.int64)
    f_tid = np.full(len(frames), tr["main_tid"], np.int64)
    inside = innermost(tr["op_launch"], tr["op_tid"], f_start, f_end, f_tid, span_parents(f_start, f_end, f_tid)) >= 0
    dur = tr["op_end"] - tr["op_start"]
    total = int(dur[inside].sum())
    return 100.0 * int(dur[inside & (tr["op_span"] >= 0)].sum()) / total if total else None


def by_span(tr: dict, frames: int) -> dict:
    """Device ms a frame under each program span name that opened, a nested
    span's time counted in the span that holds it too."""
    names = sorted({n for n, *_ in tr.get("prog_spans") or []})
    return {n: device_ms_per_frame(tr, frames, (n,)) for n in names}


def summarize(tr: dict, top: int = 10) -> dict:
    """`trace.summarize`, each idle gap's label followed by the innermost
    program span open on the benchmark's thread when the gap began
    (`reconstruct:frame197/capture`); a gap in no program span keeps its
    label as it is."""
    out = trace.summarize(tr, top)
    prog = tr.get("prog_spans") or []
    if prog:
        lo, hi = tr["window_ns"]
        gs, ge = stats.gaps(tr["op_start"], tr["op_end"], lo, hi)
        order = np.argsort(-(ge - gs), kind="stable")[:top]  # the gaps `trace.summarize` named, in its order
        inner = innermost(gs[order], np.full(len(order), tr["main_tid"]), *_columns(prog), tr["prog_parent"])
        for gap, p in zip(out["breakdown"]["idle_gaps"], inner):
            if p >= 0:
                gap[0] += "/" + prog[p][0]
    return out
