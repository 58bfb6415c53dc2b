"""Device selection, the GPU's name and power limit, and host readbacks that
do not stall the device queue.

No JAX counterpart: JAX picks its platform globally and starts async copies
with `Array.copy_to_host_async`; here both are explicit.
"""
from __future__ import annotations

import subprocess

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
