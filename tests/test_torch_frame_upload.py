"""A frame's upload (`core/frame.py`, `utils/device.py`,
`CameraIntrinsics.on_device`).

Host frames come as the benchmark's `HostDataset` hands them: uint8 color,
uint16 depth, a host validity mask that `main.build_frame` uploads once.
On the CPU: the widening of uint16 depth into the staging buffer equals
`astype(np.int32)` bit for bit; the intrinsics tensor is one per
(intrinsics, device); `build_frame` gives the frame the plain
`torch.as_tensor` path gives, eager and through the programs' static
buffers; the benchmark's reader of the upload wait. On the card (`cuda`):
no synchronizing call in `build_frame` once a frame is warm, and with the
device held behind while more frames are staged than the ring has slots,
every frame bit-equal to the plain path and the host's wait counted in
`upload_ms`.
"""
import numpy as np
import pytest
import torch

from eggfusion_tpu_torch.core.frame import frame_inputs
from eggfusion_tpu_torch.geometry.camera import CameraIntrinsics
from eggfusion_tpu_torch.main import build_frame
from eggfusion_tpu_torch.utils import device as devutil
from eggfusion_tpu_torch.utils import trace
from eggfusion_tpu_torch.utils.graphs import Programs, flatten, same_bits
from perfbench.harness import manifest

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

DEPTH_SCALE = 6553.5  # the Replica cells'


class HostFrames:
    """`build_frame`'s dataset interface over `n` seeded host frames of
    W x H: uint8 color, uint16 depth (0.3-6 m, a tenth of the pixels 0)."""

    def __init__(self, n: int, W: int, H: int, seed: int, bilateral: str = "exact"):
        rng = np.random.default_rng(seed)
        self.intrinsics = CameraIntrinsics(fx=W / 2, fy=W / 2, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
        self.depth_scale = DEPTH_SCALE
        self.bilateral_mode = bilateral
        self.color = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
        depth = rng.integers(int(0.3 * DEPTH_SCALE), int(6.0 * DEPTH_SCALE), (n, H, W), dtype=np.uint16)
        self.depth = np.where(rng.random((n, H, W)) < 0.1, 0, depth).astype(np.uint16)
        self.mask = np.ones((H, W, 1), bool)

    def __getitem__(self, k: int):
        return float(k), self.color[k], self.depth[k], self.mask, np.eye(4, dtype=np.float32)

    def __len__(self) -> int:
        return len(self.color)


def plain_frame(ds: HostFrames, k: int, device) -> list:
    """Frame k's (color, depth, mask, pyramid) tensors as the plain path
    makes them: `torch.as_tensor` of the host arrays, depth widened by
    `astype(np.int32)`."""
    to = lambda a: torch.as_tensor(a, device=device)
    x = (to(ds.color[k]), to(ds.depth[k].astype(np.int32)), to(ds.mask).to(torch.float32),
         ds.intrinsics.as_tensor(device))
    return flatten(frame_inputs(*x, depth_scale=DEPTH_SCALE, nlevel=3, bilateral=ds.bilateral_mode,
                                prefiltered=False, filter_depth=False))[1]


def frame_tensors(f) -> list:
    return flatten((f.color, f.depth, f.mask, f.pyramid))[1]


# ------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("case", ["cells_1200x680", "full_range"])
def test_widening_into_the_staging_buffer_is_astype(case):
    if case == "full_range":
        depth = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    else:
        depth = np.random.default_rng(11).integers(0, 1 << 16, (680, 1200), dtype=np.uint16)
    buf = np.full(depth.shape, -1, np.int32)
    devutil.stage(depth, buf)
    want = depth.astype(np.int32)
    assert buf.dtype == want.dtype and buf.tobytes() == want.tobytes()


def test_intrinsics_tensor_is_one_per_intrinsics_and_device():
    intr = CameraIntrinsics(fx=600.0, fy=600.0, cx=599.5, cy=339.5, width=1200, height=680)
    t = intr.on_device("cpu")
    assert torch.equal(t, intr.as_tensor("cpu"))
    assert intr.on_device(torch.device("cpu")) is t
    assert CameraIntrinsics(*intr).on_device("cpu") is t  # equal intrinsics, another tuple
    other = intr._replace(cx=600.0)
    assert other.on_device("cpu") is not t and float(other.on_device("cpu")[2]) == 600.0
    meta = intr.on_device("meta")
    assert meta is not t and meta.device.type == "meta"
    # the frames of one dataset share it
    ds = HostFrames(2, 32, 24, seed=3)
    f0, f1 = (build_frame(ds, k, False, "cpu") for k in range(2))
    assert f0.intr is f1.intr is ds.intrinsics.on_device("cpu")


@pytest.mark.parametrize("graphs", [False, True])
def test_build_frame_on_the_cpu_gives_the_plain_frame(graphs):
    ds = HostFrames(3, 48, 32, seed=5)
    programs = Programs("cpu", graphs=True) if graphs else None
    for k in range(3):
        f = build_frame(ds, k, False, "cpu", programs=programs)
        got, want = frame_tensors(f), plain_frame(ds, k, "cpu")
        assert len(got) == len(want) and all(same_bits(a, b) for a, b in zip(got, want)), k
        assert torch.equal(f.intr, ds.intrinsics.as_tensor("cpu"))


def test_upload_wait_metric_reads_the_frame_records():
    read = manifest.metric_reader("datasets.upload_wait_ms")
    assert read({"ef_metrics": [{"frame": 3, "upload_ms": 0.0}, {"frame": 4, "upload_ms": 0.5}]}) == 0.25
    # a program without the counter: nothing to read, nothing raised
    assert read({"ef_metrics": [{"frame": 3, "readback_ms": 1.0}]}) is None
    assert read({"ef_metrics": []}) is None


def test_take_waits_carries_the_upload_counter():
    trace.take_waits()
    with trace.waiting("upload"):
        pass
    waits = trace.take_waits()
    assert set(waits) == {"readback_ms", "capture_ms", "upload_ms"} and waits["upload_ms"] > 0.0
    assert trace.take_waits()["upload_ms"] == 0.0


# ------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the staged upload copies from pinned memory on a CUDA stream")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("graphs", [False, True])
def test_build_frame_makes_no_synchronizing_call(card, graphs):
    ds = HostFrames(11, 1200, 680, seed=7, bilateral="separable")
    programs = Programs(card) if graphs else None
    build_frame(ds, 0, False, card, programs=programs)  # the mask, the intrinsics, the staging rings, the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(1, 11):
            build_frame(ds, k, False, card, programs=programs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_frames_staged_behind_a_held_device_are_the_plain_frames(card):
    """Twice as many frames as the ring has slots are staged while the
    device sleeps: a slot rewritten under a pending copy would hand a frame
    a later frame's pixels; the host's wait for the slots is counted."""
    n = 2 * devutil.UPLOAD_SLOTS
    ds = HostFrames(n + 1, 1200, 680, seed=9, bilateral="separable")
    programs = Programs(card)
    build_frame(ds, n, False, card, programs=programs)  # warm: capture, rings made
    torch.cuda.synchronize()
    trace.take_waits()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of device time at the H100's clock
    kept = []
    for k in range(n):
        f = build_frame(ds, k, False, card, programs=programs)
        kept.append([t.clone() for t in frame_tensors(f)])  # the program's next replay overwrites them
    upload_ms = trace.take_waits()["upload_ms"]
    torch.cuda.synchronize()
    for k, got in enumerate(kept):
        want = plain_frame(ds, k, card)
        assert len(got) == len(want) and all(same_bits(a, b) for a, b in zip(got, want)), k
    # frames UPLOAD_SLOTS.. waited for the slots of the frames before them
    assert upload_ms > 50.0, upload_ms
