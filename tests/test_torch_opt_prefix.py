"""The window optimization on the map's leading slots (the work rung,
`CapacityLadder.opt_slots`) against the same steps on the whole allocation.

A map of 8192 slots held there by `System.min_capacity`, ~1000 surfels in
front of a 64x48 camera, SH 1, on the tile compositor (its plain kernels on
the CPU), with a ladder of the test's own (2048 ... 8192) so that the work
rung sits below the allocation. Slots between the active surfels and the
watermark are pruned holes; slots past it hold inactive leftovers of a
compaction, then the empty map's fills.

(a) One whole-map step leaves every field and Adam moment at or above the
    watermark bit-unchanged: the precondition of the prefix.
(b), (c), (e) A step, a round of steps across a move of the work rung up
    with the cached binning padded, and one across a compaction and a move
    down with the binning made anew, agree with the whole-map run on the
    work rung's slots; the slots past it are untouched. Tolerance: the steps
    differ only in the rounding of the regularizer's two global sums (the
    position norm and the masked mean of the normal term), which add fewer
    exact zeros in another reduction order. That moves the loss and each
    gradient by a few float32 ulps; Adam's update is lr x m / (sqrt(v) +
    eps), so a parameter moves by a few ulps of itself plus a few ulps of
    the learning rate a step: rtol 1e-6 and atol 1e-9 (the largest learning
    rate here is 1e-3) after four steps, and the loss to rtol 1e-6 (on the
    CPU at these sizes both come out bit-equal). A bfloat16 or TF32 step
    would be off by 1e-3 of the value.
(d) Eight frames of a synthetic sequence through `EGGFusion` with the map
    held at 16384 slots: every step runs on a rung at or above the device's
    watermark at that step, read after the run, the rung moves, and each
    frame record carries it (`opt_slots`); without `min_capacity` the work
    rung is the capacity on every frame.
(f) A deferred maintenance does not move the work rung: its watermark bound
    comes from count readbacks whose stream maintenance cuts only for the
    ladder's count.

The test marked `cuda` replays an opt step captured on a work rung below
the allocation against an eager call, bit for bit; run it on the card with

    python -m pytest --noconftest tests/test_torch_opt_prefix.py -q -m cuda
"""
import types

import numpy as np
import pytest
import torch

from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core import mapper as tmapper
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.core.renderer import Renderer
from eggfusion_tpu_torch.data.datasets import load_dataset
from eggfusion_tpu_torch.main import build_frame
from eggfusion_tpu_torch.system import EGGFusion
from eggfusion_tpu_torch.utils.graphs import Programs, same_bits
from perfbench.harness import manifest

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 64, 48
INTR = torch.tensor([60.0, 60.0, 31.5, 23.5])
CAP = 8192
LADDER = [2048, 4096, 6144, CAP]
N_ACTIVE, COUNT = 1000, 1200
RTOL, ATOL = 1e-6, 1e-9


def _cfg():
    return tcfg.default_config(
        Dataset={"Calibration": {"fx": 60.0, "fy": 60.0, "cx": 31.5, "cy": 23.5, "width": W, "height": H}},
        Viewer={"max_surfels_num": CAP},
        Surfel={"max_sh_degree": 1, "active_sh_degree": 1},
        System={"render_backend": "pallas", "min_capacity": CAP},
    )


def _fill(s, lo: int, hi: int, rng, active: bool) -> None:
    """Surfels in slots [lo, hi) in front of the identity camera."""
    n = hi - lo
    z = rng.uniform(1.5, 3.5, n)
    u, v = rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n)
    fx, fy, cx, cy = INTR.tolist()
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    s.xyz[:, lo:hi] = f32([(u - cx) * z / fx, (v - cy) * z / fy, z])
    q = rng.normal(size=(4, n))
    q[0] += 2.0
    s.rotation[:, lo:hi] = f32(q)
    s.scaling[:2, lo:hi] = f32(np.log(rng.uniform(0.01, 0.03, (2, n))))
    s.opacity[0, lo:hi] = f32(rng.uniform(-1.0, 1.0, n))
    s.features_dc[:, 0, lo:hi] = f32(rng.normal(0, 1, (3, n)))
    s.features_rest[:, :, lo:hi] = f32(rng.normal(0, 0.2, (3, s.features_rest.shape[1], n)))
    s.active[lo:hi] = active


def _mapper(programs=None, rungs=LADDER):
    """A mapper on ladder `rungs` (the whole map: [CAP]), its map at CAP:
    active surfels in [0, N_ACTIVE), pruned holes up to the watermark COUNT,
    leftovers of a compaction (inactive) in [COUNT, 3000), the empty map's
    fills past it, the count known as of frame 4 at frame 5; the round
    started (geometry snapshot, Adam moments zero)."""
    cfg = _cfg()
    m = tmapper.Mapping(cfg, Renderer(cfg, "cpu"), "cpu", programs=programs)
    assert m.surfels.capacity == CAP
    m.ladder.rungs = list(rungs)
    rng = np.random.default_rng(7)
    _fill(m.surfels, 0, COUNT, rng, True)
    m.surfels.active[N_ACTIVE:COUNT] = False
    _fill(m.surfels, COUNT, 3000, rng, False)
    m.surfels.count.fill_(COUNT)
    m.time = 5
    m.adopt(m.surfels, COUNT)
    m._adam_state("window")
    return m


def _keyframe(seed: int = 3):
    rng = np.random.default_rng(seed)
    kf = types.SimpleNamespace(uid=11, w2c=torch.eye(4), intr=INTR.clone(), width=W, height=H)
    normal = np.zeros((H, W, 3), np.float32)
    normal[..., 2] = -1.0
    kfm = {"color": torch.as_tensor(rng.uniform(0, 1, (H, W, 3)).astype(np.float32)),
           "depth": torch.as_tensor(rng.uniform(2.0, 3.0, (H, W, 1)).astype(np.float32)),
           "normal": torch.as_tensor(normal),
           "rgb_mask": torch.ones((H, W, 1), dtype=torch.bool), "geo_mask": torch.ones((H, W, 1), dtype=torch.bool)}
    return kf, kfm


def _state(m) -> dict:
    """Every float field of the map and every Adam moment (clones)."""
    out = {f: getattr(m.surfels, f).clone() for f in tmapper.OPT_FIELDS + ("eta", "sigma2")}
    moments, _ = m._adam_buffers("window")
    for k, (mm, vv) in moments.items():
        out[f"m.{k}"], out[f"v.{k}"] = mm.clone(), vv.clone()
    return out


def _step(m, geo, cache=None):
    kf, kfm = _keyframe()
    return float(m._opt("window", kf, kfm, geo, m.sw_lrs, cache))


def _close(a: dict, b: dict, n: int) -> None:
    for k in a:
        torch.testing.assert_close(a[k][..., :n], b[k][..., :n], rtol=RTOL, atol=ATOL, msg=k)


def test_whole_map_step_leaves_the_slots_past_the_watermark():
    """(a) Slots at or above the watermark: inactive, no binning entry, the
    regularizer's terms zero (equal to the snapshot, the normal masked),
    zero moments; one whole-map step leaves every field and moment there
    bit for bit."""
    m = _mapper(rungs=[CAP])
    assert m.ladder.opt_slots == CAP
    geo = tmapper._geo_snapshot(m.surfels)
    before = _state(m)
    _step(m, geo)
    _step(m, geo)
    after = _state(m)
    for k in before:
        assert same_bits(after[k][..., COUNT:], before[k][..., COUNT:]), k
    moved = float((after["xyz"][:, :N_ACTIVE] - before["xyz"][:, :N_ACTIVE]).abs().max())
    assert moved > 0 and float(after["m.features_dc"][..., :N_ACTIVE].abs().max()) > 0


def test_prefix_step_matches_the_whole_map():
    """(b) Three steps on the work rung (2048 slots) against three on the
    whole map, each binning for itself: equal on the rung's slots to float32
    rounding, the slots past it untouched."""
    m_full, m_pre = _mapper(rungs=[CAP]), _mapper()
    assert m_pre.ladder.opt_slots == 2048 < CAP == m_full.ladder.opt_slots
    start = _state(m_pre)
    geo_f, geo_p = tmapper._geo_snapshot(m_full.surfels), tmapper._geo_snapshot(m_pre.surfels)
    for _ in range(3):
        lf, lp = _step(m_full, geo_f), _step(m_pre, geo_p)
        assert lp == pytest.approx(lf, rel=RTOL)
    full, pre = _state(m_full), _state(m_pre)
    _close(pre, full, 2048)
    for k in pre:
        assert same_bits(pre[k][..., 2048:], start[k][..., 2048:]), k
    assert not same_bits(pre["xyz"], start["xyz"])


def test_prefix_round_across_a_rung_move():
    """(c) A round with a cached binning: two steps, a map update that
    appends past the work rung (2048 -> 4096: the cached binning padded
    with empty rows, the previous rung's programs dropped), two more steps,
    against the whole-map round with its binning of every slot; through
    the programs' plumbing (static inputs, outputs the program owns)."""
    runs = {}
    for name in ("full", "prefix"):
        m = _mapper(Programs("cpu", graphs=True), [CAP] if name == "full" else LADDER)
        geo = tmapper._geo_snapshot(m.surfels)
        kf, _ = _keyframe()
        m._opt_cache_map[kf.uid] = tmapper.rt.Binning(*(t.clone() for t in m._binning(kf)))
        losses = [_step(m, geo, m._opt_cache_map[kf.uid]) for _ in range(2)]
        # the frame's map update: 1100 new surfels above the watermark, past
        # the rung; the host reads the watermark `count_lag` frames later
        _fill(m.surfels, COUNT, 2300, np.random.default_rng(9), True)
        m.surfels.count.fill_(2300)
        m.time += 1
        m.ladder.observe(m.time - m.count_lag, m.surfels.count)
        m.fit_capacity()
        losses += [_step(m, geo, m._opt_cache_map[kf.uid]) for _ in range(2)]
        runs[name] = (m, losses, _state(m))
    m_full, l_full, s_full = runs["full"]
    m_pre, l_pre, s_pre = runs["prefix"]
    assert m_full.ladder.opt_slots == CAP and m_pre.ladder.opt_slots == 4096
    assert m_pre._opt_cache_map[11].back_map.shape[0] == 4096
    assert {e.rung for e in m_pre._p_opt.entries.values()} == {4096}
    assert {e.rung for e in m_pre._p_bin.entries.values()} == set()
    assert l_pre == pytest.approx(l_full, rel=RTOL)
    _close(s_pre, s_full, 4096)
    for k in s_pre:  # nothing past the rung moved, in either run
        assert same_bits(s_pre[k][..., 4096:], s_full[k][..., 4096:]), k
    # a padded binning: the binning it was, then rows of -1
    b = m_pre._opt_cache_map[11]
    bm = tmapper._pad_binning(b, 6144).back_map
    assert same_bits(bm[:4096], b.back_map) and bool((bm[4096:] == -1).all())


def test_prefix_round_across_a_compaction_and_a_move_down():
    """(e) The map grows past 4096 slots (the work rung 2048 -> 6144), a
    compaction takes the watermark to 800, the same frame's round bins at
    6144 and steps once; `count_lag` frames later the lower count moves the
    rung down to 4096. The binning of 6144 slots indexes the compaction's
    inactive slots past 4096 in its unused entries, so the move drops it and
    the next step bins anew; two steps on, the run agrees with the
    whole-map run, which kept its binning."""
    runs = {}
    for name in ("full", "prefix"):
        m = _mapper(Programs("cpu", graphs=True), [CAP] if name == "full" else LADDER)
        _fill(m.surfels, COUNT, 4500, np.random.default_rng(9), True)
        m.surfels.count.fill_(4500)
        m.time += 1
        m.ladder.observe(m.time - m.count_lag, m.surfels.count)
        m.fit_capacity()
        rungs = [m.ladder.opt_slots]
        m.surfels.active[800:] = False  # pruned: 3700 holes under the watermark
        m._maintain_decide(4500, 800, m.time)
        assert int(m.surfels.count) == 800 and not m._opt_cache_map
        m._adam_state("window")
        geo = tmapper._geo_snapshot(m.surfels)
        kf, _ = _keyframe()
        m._opt_cache_map[kf.uid] = tmapper.rt.Binning(*(t.clone() for t in m._binning(kf)))
        losses = [_step(m, geo, m._opt_cache_map[kf.uid])]
        m.ladder.observe(m.time, m.surfels.count)
        m.time += m.count_lag
        m.fit_capacity()
        rungs.append(m.ladder.opt_slots)
        if kf.uid not in m._opt_cache_map:
            m._opt_cache_map[kf.uid] = tmapper.rt.Binning(*(t.clone() for t in m._binning(kf)))
        losses += [_step(m, geo, m._opt_cache_map[kf.uid]) for _ in range(2)]
        runs[name] = (rungs, losses, _state(m))
    (r_full, l_full, s_full), (r_pre, l_pre, s_pre) = runs["full"], runs["prefix"]
    assert r_full == [CAP, CAP] and r_pre == [6144, 4096]
    assert l_pre == pytest.approx(l_full, rel=RTOL)
    _close(s_pre, s_full, 4096)
    for k in s_pre:
        assert same_bits(s_pre[k][..., 4096:], s_full[k][..., 4096:]), k


def test_work_rung_bound_survives_a_deferred_maintenance():
    """(f) A deferred maintenance (prune at frame 6, decided `count_lag` + 1
    frames later) sets the ladder's known count back to frame 6's and cuts
    the readbacks after it from that count. The work rung bounds the
    watermark from every readback of the stream, so at a constant
    watermark of 1200 it stays at 2048 (1200 + 2 x 409 spawns); the
    ladder's count would have read 1200 + 4 x 409 at frame 10 and moved it
    to 4096 and back."""
    m = _mapper()
    rungs = []
    for f in range(5, 12):
        m.time = f
        m.fit_capacity()
        rungs.append(m.ladder.opt_slots)
        m.ladder.observe(f, m.surfels.count)
        m._maintain_finish()
        if f == 6:
            m.maintain_map(defer=True)
    assert m.ladder.known_time == 6 and int(m.surfels.count) == COUNT
    assert rungs == [2048] * 7, rungs


# --------------------------------------------------- (d) through EGGFusion


def _system(tmp_path, held: bool, device: str = "cpu"):
    """Eight frames of a 120x90 synthetic sequence whose map grows by a few
    hundred surfels a frame, on the test's ladder up to 16384 slots, through
    the programs (the CPU's plumbing, CUDA graphs on the card); `held`: the
    map allocated at 16384 by `System.min_capacity`. Returns the system,
    its frame records and (work rung, watermark, capacity) at each step."""
    system = {"save_dir": str(tmp_path), "render_backend": "pallas"}
    if held:
        system["min_capacity"] = 16384
    cfg = tcfg.default_config(
        Dataset={"type": "synthetic", "n_frames": 8, "preload": False,
                 "Calibration": {"fx": 110.0, "fy": 110.0, "cx": 59.5, "cy": 44.5,
                                 "width": 120, "height": 90, "depth_scale": 1.0}},
        Viewer={"max_surfels_num": 16384},
        Mapping={"local_map_iter_init": 2, "local_map_iter": 2, "opt_step_scale": 0.5, "sample_ratio": 0.05,
                 "sample_ratio_init": 0.05, "add_opacity_thres": 1.01},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        Tracking={"recover_after": 0},
        System=system,
    )
    ef = EGGFusion(cfg, device=device, graphs=True)
    m = ef.mapper
    m.ladder.rungs = [2048, 3072, 4096, 6144, 8192, 16384]
    m.adopt(m.surfels if held else tsf.SurfelMap.empty(m.scfg._replace(capacity=m.ladder.start()), device=device),
            0)
    ef.dataset = load_dataset(cfg, ef.device)
    steps = []
    opt = m._opt

    def spy(*args, **kw):
        steps.append((m.ladder.opt_slots, m.surfels.count.clone(), m.surfels.capacity))
        return opt(*args, **kw)

    m._opt = spy
    ef.warmup(full=True)
    for fid in range(8):
        ef.reconstruct(build_frame(ef.dataset, fid, False, ef.device, nlevel=ef.nlevel_frame, programs=ef.programs))
    recs = [r for r in ef.metrics if r.get("frame", -1) >= 0]
    return ef, recs, [(p, int(c), cap) for p, c, cap in steps]


def test_work_rung_bounds_the_watermark_in_a_run(tmp_path):
    """(d) Held at 16384 slots: every step's rung holds the device's
    watermark at that step and lies below the allocation, the rung moves
    up as the map grows, and the frame records carry it; on the ladder the
    rung is the capacity on every frame."""
    ef, recs, steps = _system(tmp_path, held=True)
    assert ef.mapper.surfels.capacity == 16384 and len(steps) >= 4
    assert all(count <= slots < cap for slots, count, cap in steps), steps
    rungs = [slots for slots, _, _ in steps]
    assert rungs == sorted(rungs) and len(set(rungs)) >= 2, rungs
    assert {r["opt_slots"] for r in recs if "opt_slots" in r} == set(rungs)
    assert all("opt_slots" in r for r in recs if r["frame"] == 0)
    read = manifest.metric_reader("mapping.opt_slots")
    slots = [r["opt_slots"] for r in recs if "opt_slots" in r]
    assert read({"ef_metrics": recs}) == pytest.approx(sum(slots) / len(slots))
    assert read({"ef_metrics": [{"frame": 3, "readback_ms": 0.1}]}) is None

    _, recs, steps = _system(tmp_path / "ladder", held=False)
    assert all(slots == cap for slots, _, cap in steps)
    assert all(r["opt_slots"] == r["capacity"] for r in recs if "opt_slots" in r)
    assert len({r["capacity"] for r in recs}) >= 2  # the map climbed the ladder


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")


@pytest.mark.cuda
def test_prefix_step_replays_as_it_runs_eagerly_on_the_card(card, tmp_path):
    """The opt step captured on a work rung below the allocation (views of
    the map's and the moments' leading slots as the graph's state): a
    replay against an eager call of its function on the same inputs and
    state, every output and the state bit for bit."""
    ef, _, steps = _system(tmp_path, held=True, device="cuda")
    assert all(count <= slots < cap for slots, count, cap in steps), steps
    p = ef.programs.programs["opt_step"]
    assert p.last.rung < 16384
    r = p.check_replay()
    assert r["outputs_equal"] and r["state_equal"], r
