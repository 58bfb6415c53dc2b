"""The port's compile layer (`utils/graphs.py`): the frame's programs run
through static input buffers and graph-owned outputs, against the same
system run eagerly.

On the CPU a `Program` has no graph: with `EGGFusion(graphs=True)` it runs
its function eagerly through the static inputs and outputs a CUDA graph
would have, and in `poison` mode fills a key's previous outputs with NaN
(integers with -2**30, booleans inverted) before its next call, as a replay
overwrites them. A consumer that keeps an output across a call then shows
up as a difference from the eager run.

The slice runs 10 frames of a 120x90 synthetic sequence on the tile
compositor (its plain kernels on the CPU: binning caches, tile subsets, the
adaptive model cap) with the capacity ladder on a small ladder of the
test's own (2048 ... 6144 slots), so the map grows once, and a window whose
keyframes stay over later frames. Tolerance: none; the trajectory and every
map field are bit-equal to the eager run's. Tests marked `cuda` replay the
captured tracking and opt-step programs on the card against eager calls on
the same inputs, bit for bit; run them there with

    python -m pytest --noconftest tests/test_torch_graphs.py -q -m cuda
"""
import gc
import weakref

import pytest
import torch

from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core import mapper as tmapper
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.data.datasets import load_dataset
from eggfusion_tpu_torch.main import build_frame
from eggfusion_tpu_torch.system import EGGFusion
from eggfusion_tpu_torch.utils import graphs

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

N_FRAMES = 10
LADDER = [2048, 3072, 4096, 6144]


def _cfg(tmp, n_frames=N_FRAMES, **system):
    return tcfg.default_config(
        Dataset={"type": "synthetic", "n_frames": n_frames, "preload": False,
                 "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                                 "width": 120, "height": 90, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": LADDER[-1]},
        # every pixel may spawn (opacity threshold above 1): the map grows
        # by a few hundred surfels a frame and crosses a rung by frame 7
        Mapping={"local_map_iter_init": 2, "local_map_iter": 2, "opt_step_scale": 0.5, "sample_ratio": 0.05,
                 "sample_ratio_init": 0.05, "opt_tile_fraction": 0.5, "add_opacity_thres": 1.01},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0},
        System={"save_dir": str(tmp), "render_backend": "pallas", **system},
    )


def _system(cfg, graphs_on):
    """A system on the test's ladder, its map on the rung the ladder gives."""
    ef = EGGFusion(cfg, device="cpu", graphs=graphs_on)
    m = ef.mapper
    m.ladder.rungs = list(LADDER)
    m.adopt(tsf.SurfelMap.empty(m.scfg._replace(capacity=m.ladder.start()), device="cpu"), 0)
    ef.dataset = load_dataset(cfg, ef.device)
    return ef


def _run(ef, n_frames=N_FRAMES, warmup=False):
    """Reconstruct `n_frames`; returns the (capacity, captures) after each."""
    if warmup:
        ef.warmup(full=True)
    seen = []
    for fid in range(n_frames):
        ef.reconstruct(build_frame(ef.dataset, fid, False, ef.device, nlevel=ef.nlevel_frame,
                                   programs=ef.programs))
        seen.append((ef.mapper.surfels.capacity, ef.programs.captures()))
    return seen


@pytest.fixture(scope="module")
def eager(tmp_path_factory):
    ef = _system(_cfg(tmp_path_factory.mktemp("eager")), False)
    return ef, _run(ef)


def test_graphs_argument(tmp_path):
    """None: eager on the CPU (graphs on CUDA); True: the CPU plumbing;
    False: eager."""
    cfg = _cfg(tmp_path)
    assert EGGFusion(cfg, device="cpu").programs.mode == "eager"
    assert EGGFusion(cfg, device="cpu", graphs=True).programs.mode == "plumb"
    assert EGGFusion(cfg, device="cpu", graphs=False).programs.mode == "eager"


def test_pytrees_hold_no_tensor_past_the_call():
    """`flatten` / `unflatten` make no reference cycle: a tensor they saw is
    freed when its last reference goes, with the garbage collector off (a
    cycle would hold a program's inputs, on the card device memory, until
    the collector ran)."""
    t = torch.zeros(3)
    ref = weakref.ref(t)
    gc.disable()
    try:
        spec, leaves = graphs.flatten({"a": (t, 1), "b": [t]})
        tree = graphs.unflatten(spec, leaves)
        assert tree["a"][0] is t and tree["a"][1] == 1 and tree["b"][0] is t
        del t, leaves, tree
        assert ref() is None
    finally:
        gc.enable()


def test_poison_catches_a_kept_output():
    """Poison mode: an output kept across the next call of its key turns to
    NaN (-2**30, inverted), as a replay overwrites it; an output passed back
    in as an input, another key's output and the state are left alone."""
    progs = graphs.Programs("cpu", graphs=True)
    progs.poison = True

    def fn(state, x, *, k):
        state.add_(1)
        return {"y": x["a"] * k, "i": x["n"] + 1, "b": x["a"] > 0, "a": x["a"]}

    p = progs.program("toy", fn)
    state = torch.zeros(2)
    x = {"a": torch.ones(3), "n": torch.zeros(2, dtype=torch.int64)}
    first = p({"k": 2.0}, state, x)
    other = p({"k": 3.0}, state, x)
    kept = {k: v.clone() for k, v in first.items()}
    second = p({"k": 2.0}, state, {"a": first["a"], "n": x["n"]})
    assert torch.isnan(first["y"]).all()
    assert (first["i"] == -(2 ** 30)).all()
    assert torch.equal(first["b"], ~kept["b"])
    assert torch.equal(first["a"], kept["a"])  # passed back in: read, not poisoned
    assert torch.equal(second["y"], kept["y"]) and torch.equal(second["b"], kept["b"])
    assert torch.equal(other["y"], torch.full((3,), 3.0))
    assert torch.equal(state, torch.full((2,), 3.0))
    assert (p.captures, p.replays) == (2, 3)


def test_poison_catches_a_missing_copy(tmp_path, monkeypatch):
    """Without its copies of the frame's maps a keyframe holds program
    outputs, which the next frame's calls overwrite: in poison mode the
    window's first keyframe holds a NaN depth map and inverted masks (its
    color, the preprocess program's static input, holds the next frame's)
    one frame later, where the opt steps that read it would find them."""
    real = tmapper.KeyFrame.__init__

    def no_copy(self, frame, frame_map, time, fid, storage="device"):
        real(self, frame, frame_map, time, fid, storage)
        self.maps = {"color": frame_map["color_map"], "depth": frame_map["depth_map"],
                     "normal": frame_map["normal_map_c"], "rgb_mask": frame_map["rgb_mask"],
                     "geo_mask": frame_map["geo_mask"]}

    monkeypatch.setattr(tmapper.KeyFrame, "__init__", no_copy)
    ef = _system(_cfg(tmp_path, n_frames=2), True)
    ef.programs.poison = True
    _run(ef, 2)
    kf = ef.mapper.keyframe_manager.sliding_window[0]
    assert kf.uid == 0 and torch.isnan(kf.maps["depth"]).all()
    assert torch.equal(kf.maps["color"], ef.frame_map["color_map"])
    assert not kf.maps["rgb_mask"].any()  # the frame's mask is all valid: inverted


@pytest.mark.parametrize("precompile", [False, True])
def test_plumbing_matches_eager(eager, tmp_path, precompile):
    """10 frames through the programs' plumbing in poison mode, after a
    full `warmup` (with `System.precompile_ladder`: every rung above the
    start captured ahead), bit-equal to the eager run in trajectory and in
    every map field. The run crosses the optimization frames, one growth of
    the map and keyframes that stay in the window; programs are captured in
    the warmup and, without the ladder precompile, once more on the new
    rung, never otherwise."""
    ef_e, seen_e = eager
    ef = _system(_cfg(tmp_path, precompile_ladder=precompile), True)
    ef.programs.poison = True
    seen = _run(ef, warmup=True)
    assert [c for c, _ in seen] == [c for c, _ in seen_e]
    caps = [c for c, _ in seen]
    assert caps[-1] > caps[0]  # one growth
    grew = caps.index(caps[-1])
    captures = [n for _, n in seen]
    assert len(set(captures[:grew])) == 1  # nothing captured on the first rung after warmup
    if precompile:
        assert len(set(captures)) == 1
    else:
        assert captures[grew] > captures[grew - 1] and len(set(captures[grew:])) == 1
    window = [kf.uid for kf in ef.mapper.keyframe_manager.sliding_window]
    assert window[0] < N_FRAMES - 3 and ef.mapper.opt_steps_total > 0 and ef.mapper.time > 6
    assert ef._traj_np("est").tobytes() == ef_e._traj_np("est").tobytes()
    for f in tsf.FIELDS:
        assert graphs.same_bits(getattr(ef.mapper.surfels, f), getattr(ef_e.mapper.surfels, f)), f
    assert ef.mapper.opt_steps_total == ef_e.mapper.opt_steps_total
    stats = ef.programs.stats()
    assert {"frame", "track", "preprocess", "map_update", "opt_step", "bin_cache"} <= {
        k for k, v in stats.items() if v["replays"]}


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_run(tmp_path):
    """A 128x96 system with CUDA graphs after 8 frames (a window with opt
    steps on it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    cfg = _cfg(tmp_path, n_frames=8)
    cfg.Dataset.Calibration.update(width=128, height=96, cx=63.5, cy=47.5)
    cfg.System.render_backend = "pallas"
    ef = EGGFusion(cfg)
    ef.dataset = load_dataset(cfg, ef.device)
    _run(ef, 8, warmup=True)
    torch.cuda.synchronize()
    assert ef.programs.mode == "graph"
    return ef


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["track", "opt_step"])
def test_replay_matches_eager_on_the_card(cuda_run, name):
    """A replay of the captured program against an eager call of its
    function on the same inputs and state: every output and the state bit
    for bit."""
    r = cuda_run.programs.programs[name].check_replay()
    assert r["outputs_equal"] and r["state_equal"], r
