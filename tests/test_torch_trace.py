"""The port's spans and wait counters (`utils/trace.py`).

A few frames of a 64x48 synthetic sequence, on the CPU, through the
programs' static buffers (`graphs=True`: new entries run under "capture"),
on the burst schedule with an optimization every frame (so
`EGGFusion.postprocess` renders the model view, and the keyframe check
reads the device at once) and maintenance every frame, with a recovery
forced by a failure streak at frame 1. Under the profiler, over frame 1,
every span of the frame path opens; with no profiler running none is made;
every frame record carries the three wait counters.
"""
import pytest
import torch
from torch.autograd.profiler import profile, record_function

from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.data.datasets import load_dataset
from eggfusion_tpu_torch.main import build_frame
from eggfusion_tpu_torch.system import EGGFusion
from eggfusion_tpu_torch.utils import trace

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

SPANS = ("frame", "track", "recover", "preprocess", "map_update", "window_opt", "maintain", "model_view",
         "capture", "readback")
N_FRAMES = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(system, `frame(k)`, the user annotations of frame 1 as (name, start,
    end, thread))."""
    tmp = tmp_path_factory.mktemp("trace")
    cfg = tcfg.default_config(
        Dataset={"type": "synthetic", "n_frames": N_FRAMES + 2, "preload": False,
                 "Calibration": {"fx": 60.0, "fy": 60.0, "cx": 31.5, "cy": 23.5,
                                 "width": 64, "height": 48, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 6144},
        Mapping={"opt_schedule": "burst", "sw_optimize_freq": 1, "local_map_iter_init": 1, "local_map_iter": 1,
                 "prune_freq": 1, "sample_ratio": 0.05, "sample_ratio_init": 0.15},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 2, "reloc_descriptors": False, "recovery_rotation_sweep": False,
                  "pyramid_iters": [1, 1, 1]},
        System={"save_dir": str(tmp), "render_backend": "pallas", "capacity_bucketing": False},
    )
    ef = EGGFusion(cfg, device="cpu", graphs=True)
    ef.dataset = load_dataset(cfg, ef.device)

    def frame(k):
        ef.reconstruct(build_frame(ef.dataset, k, False, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs))

    frame(0)
    # the autograd profiler: kineto with CPU activity, as `torch.profiler`
    # records it, without that one's import of torch._inductor at start
    with profile() as prof:
        ef.tracker._fail_streak = ef.tracker.recover_after  # a streak long enough for a recovery
        for k in range(1, N_FRAMES):
            with record_function("reconstruct"):
                frame(k)
    spans = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in prof.kineto_results.events() if e.is_user_annotation()]
    return ef, frame, spans


def test_every_span_opens_inside_the_frame(run):
    ef, _frame, spans = run
    names = {n for n, *_ in spans}
    assert set(SPANS) <= names, set(SPANS) - names
    frames = [(s, e, t) for n, s, e, t in spans if n == "reconstruct"]
    for name in ("map_update", "window_opt", "model_view", "recover"):
        for n, s, e, t in spans:
            if n == name:
                assert any(fs <= s and e <= fe and ft == t for fs, fe, ft in frames), name
    assert any("recovered_to_kf" in m for m in ef.metrics)


def test_no_span_without_a_profiler(run, monkeypatch):
    _ef, frame, _spans = run
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: made.append(name))
    assert not torch.autograd._profiler_enabled()
    frame(N_FRAMES)
    assert made == []
    assert trace.span("track") is trace.span("readback")


def test_frame_records_carry_the_waits(run):
    ef, _frame, _spans = run
    recs = [m for m in ef.metrics if m.get("frame", -1) >= 0]
    assert len(recs) >= N_FRAMES
    for m in recs:
        for key in ("readback_ms", "capture_ms", "upload_ms"):
            assert isinstance(m[key], float) and m[key] >= 0.0, (key, m)
    assert recs[0]["capture_ms"] > 0.0  # frame 0 makes its programs' entries
    assert any(m["readback_ms"] > 0.0 for m in recs)
    assert trace.take_waits() == {"readback_ms": 0.0, "capture_ms": 0.0, "upload_ms": 0.0}
