"""The mesh's programs in the port's compile layer (`utils/graphs.py`): the
pixel-sharded tracker (`core/tracker.py`: "track_prep", "track_shard",
"track_reduce"), the window-batched step (`parallel/mesh.py`:
"window_shard", "window_reduce") and map maintenance (`core/mapper.py`:
"prune", "compact"), run through the programs' static buffers against the
same system run eagerly.

On the CPU a mesh of 2 is two shards of the CPU device, and a `Program`
has no graph: with `EGGFusion(graphs=True)` it runs its function eagerly
through the static inputs and outputs a CUDA graph would have, and in
`poison` mode fills a key's previous outputs with NaN before its next call,
as a replay overwrites them. Two shards on one device whose programs
shared a key would poison each other's partials before their sum.

The run: 10 frames of a 120x90 synthetic sequence on a mesh of 2 with the
tile compositor (its plain kernels on the CPU, at the multichip dryrun's
small slab caps, 256 and 128, which keep them fast) on a fixed 6144-slot
map, the window-batched amortized step on frames 0, 3, 6 and 9 (a window
of 4 fills a member every 3 frames: from frame 6 on both shards render,
on frame 9 two members each, so their window-step keys differ only by the
shard's index),
maintenance every 4 frames culling every unstable surfel seen once, and a
compaction threshold low enough that frame 4's prune leads to a compaction
at frame 7. Tolerance: none; the
trajectory and every map field are bit-equal to the eager run's. No JAX
runs here: `tests/test_torch_mesh.py` and `tests/test_torch_mesh_system.py`
hold the mesh to the JAX package. Tests marked `cuda` replay each new
program on the card against an eager call on the same inputs, bit for
bit, on 2 shards of cuda:0; run them there with

    python -m pytest --noconftest tests/test_torch_mesh_graphs.py -q -m cuda
"""
import pytest
import torch

from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.data.datasets import load_dataset
from eggfusion_tpu_torch.main import build_frame
from eggfusion_tpu_torch.parallel import mesh as tmesh
from eggfusion_tpu_torch.system import EGGFusion
from eggfusion_tpu_torch.utils import graphs

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

N_FRAMES = 10
MESH_PROGRAMS = ("track_prep", "track_shard", "track_reduce", "window_shard", "window_reduce", "prune", "compact")


def _cfg(tmp, mesh_devices=2, n_frames=N_FRAMES):
    return tcfg.default_config(
        Dataset={"type": "synthetic", "n_frames": n_frames, "preload": False,
                 "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                                 "width": 120, "height": 90, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 6144},
        Mapping={"local_map_iter_init": 2, "local_map_iter": 2, "sample_ratio": 0.05, "sample_ratio_init": 0.05,
                 "prune_freq": 4, "prune_max_age": 0, "compact_frag": 0.001},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0, "sliding_window_size": 4},
        System={"save_dir": str(tmp), "render_backend": "pallas", "capacity_bucketing": False,
                "raster_cap": 256, "opt_raster_cap": 128, "mesh_devices": mesh_devices},
    )


def _run(ef, n_frames, warmup=False):
    """Reconstruct `n_frames`; returns the frames whose mapping compacted
    the map."""
    if warmup:
        ef.warmup(full=True)
    compacted = []
    for fid in range(n_frames):
        before = ef.programs.programs["compact"].replays if "compact" in ef.programs.programs else 0
        ef.reconstruct(build_frame(ef.dataset, fid, False, ef.device, nlevel=ef.nlevel_frame,
                                   programs=ef.programs))
        if ef.programs.enabled and ef.programs.programs["compact"].replays > before:
            compacted.append(fid)
    return compacted


def _system(cfg, graphs_on, device="cpu"):
    ef = EGGFusion(cfg, device=device, graphs=graphs_on)
    ef.dataset = load_dataset(cfg, ef.device)
    return ef


@pytest.fixture(scope="module")
def eager(tmp_path_factory):
    ef = _system(_cfg(tmp_path_factory.mktemp("eager")), False)
    _run(ef, N_FRAMES)
    return ef


def test_mesh_plumbing_matches_eager(eager, tmp_path):
    """10 frames on a mesh of 2 through the programs' plumbing in poison
    mode, after a full `warmup`: bit-equal to the eager run in trajectory
    and in every map field, with the sharded tracker, the window step and
    maintenance replayed, a compaction among them."""
    ef = _system(_cfg(tmp_path), True)
    ef.programs.poison = True
    compacted = _run(ef, N_FRAMES, warmup=True)
    assert ef.mapper.devices == [torch.device("cpu")] * 2 and ef.tracker.devices == ef.mapper.devices
    assert compacted == [7]
    assert ef._traj_np("est").tobytes() == eager._traj_np("est").tobytes()
    for f in tsf.FIELDS:
        assert graphs.same_bits(getattr(ef.mapper.surfels, f), getattr(eager.mapper.surfels, f)), f
    assert ef.mapper.opt_steps_total == eager.mapper.opt_steps_total > 0
    stats = ef.programs.stats()
    assert all(stats[name]["replays"] > 0 for name in MESH_PROGRAMS), {k: stats[k]["replays"]
                                                                       for k in MESH_PROGRAMS}
    # both shards render window members: one window-step key per shard and
    # fill level, the tracker's keys per shard and level
    assert len(ef.mapper.keyframe_manager.sliding_window) == 4
    for name in ("window_shard", "track_shard"):
        assert {e.static["shard"] for e in ef.programs.programs[name].entries.values()} == {0, 1}, name
    # the mesh renders the window batched: the single-device opt step and
    # its binning never run
    assert stats["opt_step"]["captures"] == stats["bin_cache"]["captures"] == 0


def test_one_device_mesh_runs_the_track_program(tmp_path):
    """On a mesh of the system's own device the tracker replays the one
    "track" program, as without a mesh, and the sharded programs never
    run; the window step runs as its programs."""
    ef = _system(_cfg(tmp_path, mesh_devices=1, n_frames=3), True)
    _run(ef, 3)
    stats = ef.programs.stats()
    assert ef.tracker.devices == [torch.device("cpu")]
    assert stats["track"]["replays"] == 2
    assert all(name not in stats or stats[name]["replays"] == 0 for name in ("track_prep", "track_shard",
                                                                              "track_reduce"))
    assert stats["window_shard"]["replays"] > 0 and stats["window_reduce"]["replays"] > 0


# ---------------------------------------------------------------- on the card


@pytest.fixture(scope="module")
def cuda_mesh(tmp_path_factory):
    """A 128x96 system with CUDA graphs on 2 shards of cuda:0 after 10
    frames (a full window, a prune and a compaction)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    cfg = _cfg(tmp_path_factory.mktemp("cuda_mesh"))
    cfg.Dataset.Calibration.update(width=128, height=96, cx=63.5, cy=47.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmesh, "make_mesh", lambda n, device: [torch.device("cuda", 0)] * n)
        ef = _system(cfg, None, device="cuda")
    _run(ef, N_FRAMES, warmup=True)
    torch.cuda.synchronize()
    assert ef.programs.mode == "graph"
    return ef


@pytest.mark.cuda
@pytest.mark.parametrize("name", MESH_PROGRAMS)
def test_mesh_replay_matches_eager_on_the_card(cuda_mesh, name):
    """A replay of the program's last captured entry (the first one for a
    program captured and never called) against an eager call of its
    function on the same inputs and state: every output and the state bit
    for bit."""
    p = cuda_mesh.programs.programs[name]
    r = p.check_replay(p.last or next(iter(p.entries.values())))
    assert r["outputs_equal"] and r["state_equal"], r
