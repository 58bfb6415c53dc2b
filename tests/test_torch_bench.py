"""`bench_torch.py`, the port's twin of `bench.py`: its workload and knobs,
its one JSON line (run on the CPU at a tiny size: a 128x96 frame, a
1024-slot map, 1 + 2 frames, frame 0's optimization cut to 2 steps and the
tile compositor's plain kernels, so it runs in seconds), and its refusal to
run without a GPU unless asked for the CPU.
"""
import json

import pytest
import torch

import bench_torch
from eggfusion_tpu_torch import config as tcfg

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

TINY = {"BENCH_WIDTH": "128", "BENCH_HEIGHT": "96", "BENCH_SURFELS": "1024", "BENCH_WARMUP": "1",
        "BENCH_FRAMES": "2"}


def test_workload_is_bench_py_s():
    """Defaults: `bench.py`'s workload; each knob changes what it names."""
    cfg = bench_torch.bench_config(48, env={})
    cal = cfg.Dataset.Calibration
    assert (cal.width, cal.height, cal.fx, cal.cx, cal.cy) == (1280, 704, 600.0, 639.5, 351.5)
    assert cfg.Dataset.unique_frames == 10 and cfg.Dataset.device_frames and cfg.Dataset.n_frames == 48
    assert cfg.Viewer.max_surfels_num == 600_000 and cfg.System.get("capacity_bucketing", True)
    assert (cfg.Surfel.max_sh_degree, cfg.Surfel.active_sh_degree) == (0, 0)
    assert (cfg.Mapping.local_map_iter, cfg.Mapping.opt_step_scale) == (3, 0.5)
    assert list(cfg.Tracking.pyramid_iters) == [3, 3, 2] and cfg.Tracking.solver_stride_fine == 4
    assert cfg.System.bilateral_mode == "separable" and not cfg.System.final_global_opt
    knobs = bench_torch.bench_config(4, env={"BENCH_MVDOWN": "2", "BENCH_SKIP": "1", "BENCH_LMI": "5",
                                             "BENCH_STRIDE_FINE": "0", "BENCH_RASTER_CAP": "4096",
                                             "BENCH_BILATERAL": "exact", "BENCH_UNIQUE_FRAMES": "3"})
    assert (knobs.Tracking.model_view_down, knobs.Tracking.solver_stride) == (2, 1)
    assert knobs.Tracking.solver_stride_fine == 0 and knobs.Mapping.local_map_iter == 5
    assert knobs.Mapping.settled_skip and knobs.System.raster_cap == 4096
    assert knobs.System.bilateral_mode == "exact" and knobs.Dataset.unique_frames == 3


def test_one_json_line_on_the_cpu(monkeypatch, capsys, tmp_path):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    plain = bench_torch.bench_config
    monkeypatch.setattr(bench_torch, "bench_config", lambda n, env=None: tcfg.merge(
        plain(n, env or dict(TINY)),
        {"Mapping": {"local_map_iter_init": 2}, "System": {"render_backend": "pallas"}}))
    out = bench_torch.main(device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "synthetic 128x96 track+map FPS (cpu)" and rec["unit"] == "fps"
    assert rec["value"] > 0 and rec["vs_baseline"] == round(rec["value"] / 30.0, 4)
    assert out["captures_timed"] == 0


def test_needs_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main()
