"""Spans of the program's own phases, and the host time a frame waits.

`span(name)` is a `torch.profiler.record_function` range while a profiler
records on this thread, and a shared no-op otherwise: the spans land in the
profiler's trace beside the device operations, on their clock, and cost one
check when no profiler runs. The spans of a frame:

  frame       `core/frame.py`: upload, bilateral filter, frame pyramid
  track       `Tracker.tracking`: the seed and the dense GN program(s)
  recover     `EGGFusion._recover_tracking`: reloc, rotation sweep, re-anchor
  preprocess  `EGGFusion.preprocess`: the frame map
  map_update  `Mapping.mapping`: the rung, the update program (fusion, the
              model view's render and pyramid, spawn) and its lagged reads
  maintain    `Mapping.mapping`: prune and compaction
  window_opt  `Mapping.mapping`: the window's members, keyframe decisions
              and the window optimization's steps
  model_view  `EGGFusion.postprocess`: the model view's render and pyramid
              where the map update leaves them out (the burst schedule's
              optimization frames)
  capture     a new program entry: its static inputs and, on CUDA, its
              eager warm runs and graph capture (`utils/graphs.py`)
  readback    the host blocked on the device for a value
  upload      the host blocked on a staging buffer of a frame's upload whose
              previous copy has not run yet (`utils/device.py`)

`capture`, `readback` and `upload` (through `waiting`) also add their host
seconds to counters that `EGGFusion.reconstruct` takes into each frame's
record (`capture_ms`, `readback_ms`, `upload_ms`) whether or not a profiler
runs. The counters are process-wide, like `raster_tile.LAUNCHES`.
"""
from __future__ import annotations

import contextlib
import time

import torch

_OFF = contextlib.nullcontext()

# host seconds since the last `take_waits`
_WAIT_S = {"readback": 0.0, "capture": 0.0, "upload": 0.0}


def span(name: str):
    """A profiler range `name` while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def waiting(kind: str):
    """Span `kind` ("readback", "capture" or "upload") whose host seconds
    add to the frame's counter of that kind."""
    t0 = time.perf_counter()
    try:
        with span(kind):
            yield
    finally:
        _WAIT_S[kind] += time.perf_counter() - t0


def take_waits() -> dict:
    """`readback_ms`, `capture_ms` and `upload_ms` since the last call;
    resets them."""
    out = {f"{kind}_ms": s * 1e3 for kind, s in _WAIT_S.items()}
    _WAIT_S.update(dict.fromkeys(_WAIT_S, 0.0))
    return out
