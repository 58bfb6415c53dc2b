"""Device selection, the GPU's name and power limit, and host readbacks
(`Lagged` ones too) and uploads that do not stall the device queue.

No JAX counterpart: JAX picks its platform globally and starts async copies
with `Array.copy_to_host_async`; here both are explicit.
"""
from __future__ import annotations

import itertools
import subprocess
from collections import deque

import numpy as np
import torch

from eggfusion_tpu_torch.utils import trace


def gpu_name_and_limit() -> str | None:
    """The first GPU's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, or None
    where there is no `nvidia-smi`."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present — entry points never fall back to the CPU silently; tests pass
    `device="cpu"`. On CUDA, float32 convolutions and matrix products are
    pinned to full float32 (no TF32): the JAX reference computes in float32;
    and the small dense solves (the tracker's 6x6, the 4x4 inverses) to
    cuSOLVER, whose calls a CUDA graph can capture (MAGMA's synchronize).
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "eggfusion_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.preferred_linalg_library("cusolver")
    return dev


class HostReadback:
    """A device tensor copied to the host without blocking the host thread.

    On CUDA the copy goes into pinned memory on the current stream and an
    event marks its end; `numpy()` waits only for that event, which by the
    time a lagged consumer reads it (N frames later) has long passed — so
    the frame loop never drains the device queue. On the CPU it is a copy.
    """

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self._event = None
        if t.is_cuda:
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t.clone()

    def numpy(self):
        with trace.waiting("readback"):
            if self._event is not None:
                self._event.synchronize()
            return self._buf.numpy()


class Lagged:
    """Device values the host reads `lag` frames late: `push(time, value)`
    starts the copy of a tensor (of each of a tuple) made at frame `time`;
    `ready(now)` yields each `(time, value)` pushed at `now - lag` or
    earlier once, oldest first, as numpy (a tuple of them)."""

    def __init__(self, lag: int):
        self.lag, self._q = lag, deque()

    def push(self, time: int, value) -> None:
        self._q.append((time, tuple(map(HostReadback, value)) if isinstance(value, tuple) else HostReadback(value)))

    def ready(self, now: int):
        while self._q and self._q[0][0] <= now - self.lag:
            t, r = self._q.popleft()
            yield t, tuple(x.numpy() for x in r) if isinstance(r, tuple) else r.numpy()

    def clear(self) -> None:
        self._q.clear()


# `upload`'s page-locked staging buffers, in turn, per device, shape and dtype
UPLOAD_SLOTS = 3
_STAGING: dict = {}  # (device, shape, numpy dtype) -> cycle of (pinned tensor, its numpy view, event)


def stage(a: np.ndarray, buf: np.ndarray) -> None:
    """Write host array `a` into the staging buffer `buf`, cast to its dtype
    as `astype` casts (uint16 depth widened to int32): the cast and the
    staging in one host pass."""
    np.copyto(buf, a, casting="unsafe")


def upload(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    """Host array `a` (cast to the numpy `dtype` as `astype` casts it, if
    given) as a new tensor on CUDA `device`, without blocking the host
    thread: `a` is written into a pinned staging buffer (the cast and the
    staging are one host pass) and copied from it on the device's current
    stream; an event marks the copy's end.

    Each device, shape and dtype has a ring of `UPLOAD_SLOTS` buffers, taken
    in turn. A buffer is rewritten only once its previous copy has run: the
    host waits for that event under `trace.waiting("upload")`, which happens
    only when the host runs more than `UPLOAD_SLOTS` uploads ahead of the
    device. The buffers live as long as the process, like the CUDA
    allocator's cache."""
    dt = np.dtype(a.dtype if dtype is None else dtype)
    key = (device, a.shape, dt)
    ring = _STAGING.get(key)
    if ring is None:
        tdtype = torch.from_numpy(np.empty(0, dt)).dtype
        pinned = [torch.empty(a.shape, dtype=tdtype, pin_memory=True) for _ in range(UPLOAD_SLOTS)]
        ring = _STAGING[key] = itertools.cycle([(t, t.numpy(), torch.cuda.Event()) for t in pinned])
    pinned, view, event = next(ring)
    if not event.query():
        with trace.waiting("upload"):
            event.synchronize()
    stage(a, view)
    out = torch.empty(pinned.shape, dtype=pinned.dtype, device=device)
    out.copy_(pinned, non_blocking=True)
    event.record(torch.cuda.current_stream(out.device))
    return out
