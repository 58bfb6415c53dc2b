"""The port's capacity ladder against the JAX package's.

Tolerances: none — `grow_surfels` / `shrink_surfels` give bit-equal maps,
the ladders are equal lists, and the two mappers, driven by the same count
readbacks, maintenance decisions and watermarks, hold the same capacity,
consumed count and consumed time after every step. `reload` of a PLY
larger than the map and `resume` of a checkpoint of another capacity leave
both packages with the same map. No frame is rendered.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eggfusion_tpu import config as jcfg
from eggfusion_tpu.core import surfels as jsf
from eggfusion_tpu.core.mapper import Mapping as JMapping
from eggfusion_tpu.core.renderer import Renderer as JRenderer
from eggfusion_tpu.io import checkpoint as j_ckpt
from eggfusion_tpu.system import EGGFusion as JEGGFusion
from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.convert import surfel_map_from_numpy, surfel_map_to_numpy
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.core.capacity import capacity_ladder
from eggfusion_tpu_torch.core.mapper import Mapping as TMapping
from eggfusion_tpu_torch.core.renderer import Renderer as TRenderer
from eggfusion_tpu_torch.io import ply as t_ply
from eggfusion_tpu_torch.ops import raster_tile as rt
from eggfusion_tpu_torch.system import EGGFusion as TEGGFusion

# the test workers share the CPU: a small intra-op pool per process keeps
# them from oversubscribing it
torch.set_num_threads(2)

W, H = 64, 48


def _cfg(lib, max_surfels=300_000, **system):
    return lib.default_config(
        Dataset={"Calibration": {"fx": 60.0, "fy": 60.0, "cx": 31.5, "cy": 23.5, "width": W, "height": H}},
        Viewer={"max_surfels_num": max_surfels},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        System={"render_backend": "xla", **system},
    )


def _mappers(cfg_j, cfg_t):
    return (JMapping(cfg_j, JRenderer(cfg_j, backend="xla")),
            TMapping(cfg_t, TRenderer(cfg_t, "cpu"), "cpu"))


def _state(mp):
    """(capacity, consumed count, its frame): the JAX mapper's, the port's
    ladder's."""
    if isinstance(mp, TMapping):
        return mp.surfels.capacity, mp.ladder.known_count, mp.ladder.known_time
    return mp.surfels.capacity, mp._known_count, mp._known_time


def _set_watermark(mj, mt, count):
    """The append watermark of both maps (capped by capacity, as the spawn
    append caps it)."""
    mj.surfels = mj.surfels.replace(count=jnp.int32(min(count, mj.surfels.capacity)))
    mt.surfels.count = torch.tensor(min(count, mt.surfels.capacity), dtype=torch.int32)


def _frame(mj, mt, t, count):
    """One frame of the host loop: the capacity check at the start of
    `mapping`, then the frame's count readback."""
    for mp in (mj, mt):
        mp.time = t
    mj._ensure_capacity(first=t == 0)
    mt.fit_capacity()
    _set_watermark(mj, mt, count)
    mj._count_pending.append((t, jnp.int32(int(mj.surfels.count))))
    mt.ladder.observe(t, mt.surfels.count)


@pytest.mark.parametrize("max_surfels", [6144, 32768, 200_000, 262144, 1_000_000, 3_000_000])
def test_ladder_rungs(max_surfels):
    mj = JMapping.__new__(JMapping)  # the ladder alone: no map allocated
    cfg = _cfg(jcfg, max_surfels)
    factor, coarse_at = 1.4, 524288
    expect, c = [], 32768
    while c < max_surfels:  # the JAX constructor's loop (`mapper.py:521-526`)
        expect.append(c)
        c = -(-int(c * (factor if c < coarse_at else 2.0)) // 8192) * 8192
    expect.append(max_surfels)
    assert capacity_ladder(max_surfels) == expect
    if max_surfels <= 262144:  # small enough to build both mappers
        mj, mt = _mappers(cfg, _cfg(tcfg, max_surfels))
        assert mt.ladder.rungs == mj._ladder == expect
        assert mt.surfels.capacity == mj.surfels.capacity


def _random_map(cap, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    i = lambda: rng.integers(0, 50, cap).astype(np.int32)
    return {"xyz": f(3, cap), "features_dc": f(3, 1, cap), "features_rest": f(3, 3, cap), "scaling": f(3, cap),
            "rotation": f(4, cap), "opacity": f(1, cap), "eta": f(6, cap), "sigma2": np.abs(f(2, cap)),
            "observe_count": i(), "tic": i(), "error_count": i(), "stable": rng.uniform(size=cap) < 0.3,
            "active": rng.uniform(size=cap) < 0.7, "count": np.asarray(cap - 5, np.int32)}


@pytest.mark.parametrize("new_capacity", [300, 512, 1000])
def test_grow_shrink_bit_equal(new_capacity):
    m = _random_map(512)
    js = jsf.SurfelMap(**{k: jnp.asarray(v) for k, v in m.items()})
    ts = surfel_map_from_numpy(m, "cpu")
    if new_capacity >= 512:
        got, want = tsf.grow_surfels(ts, new_capacity), jsf.grow_surfels(js, new_capacity)
    else:
        got, want = tsf.shrink_surfels(ts, new_capacity), jsf.shrink_surfels(js, new_capacity)
    got = surfel_map_to_numpy(got)
    for k in tsf.FIELDS:
        w = np.asarray(getattr(want, k))
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_host_decisions_match_jax():
    """Growth over several rungs, a need above the maximum, shrink after a
    compaction, the shrink cooldown when the watermark sits above the
    smaller rung, and shrink-on-compact of a direct `maintain_map`."""
    mj, mt = _mappers(_cfg(jcfg, 120_000), _cfg(tcfg, 120_000))
    margin = mt.ladder.spawn_margin
    assert margin == mj._spawn_margin and _state(mt) == _state(mj)
    trace = []

    def check(step):
        assert _state(mt) == _state(mj), (step, _state(mt), _state(mj))
        trace.append(_state(mt)[0])

    counts = [1200, 9000, 30000, 41000, 52000, 76000, 99000, 118000, 119500, 119900, 119900, 119900]
    for t, c in enumerate(counts):
        _frame(mj, mt, t, c)
        check(("grow", t))
    t = len(counts)
    # maintenance: the live loop's deferred decision (no shrink there),
    # compaction when fragmentation exceeds compact_frag of capacity
    for mp in (mj, mt):
        mp.time = t
    mj._maintain_decide(119900, 20000, t - 1, immediate=False)
    mt._maintain_decide(119900, 20000, t - 1, immediate=False)
    check("compact")
    # the next frames shrink (every rung is ready) once the need allows it;
    # the watermark of the map is what the compaction left
    for dt, c in enumerate([21000, 21500, 22000, 60000, 61000, 61000, 61000, 61000]):
        _frame(mj, mt, t + 1 + dt, c)
        check(("shrink", dt))
    # the cooldown: the consumed count is small, the watermark is not
    t = t + 10
    for mp in (mj, mt):
        mp.time = t
    mj._count_pending.clear()
    mj._known_count, mj._known_time = 1000, t - 1
    mt.ladder.maintained(1000, t - 1, t, mt.surfels.capacity, immediate=False)
    _set_watermark(mj, mt, 50000)
    mj._ensure_capacity(first=False)
    mt.fit_capacity()
    check("cooldown")
    assert mt.ladder.cooldown == mj._shrink_cooldown > t
    # shrink-on-compact of a direct call
    mj._maintain_decide(3000, 3000, t)
    mt._maintain_decide(3000, 3000, t)
    check("direct")
    n = len(counts)
    assert max(trace[:n]) == 120_000 and len(set(trace[:n])) >= 5  # every rung up to the maximum
    assert min(trace[n + 1:n + 9]) < trace[n] and max(trace[n + 1:n + 9]) > min(trace[n + 1:n + 9])  # shrink, regrow
    assert trace[-1] < trace[-2]  # shrink-on-compact



def test_shrink_margin_widens_when_the_map_regrows():
    """A map that grows between compactions (every `prune_freq` = 30
    frames): each compaction lets the JAX ladder shrink a rung, and the
    next spawns grow it back. The port makes the same decisions through
    the first regrowth; having outgrown the smaller rung, it widens its
    shrink margin to what would have kept it on its rung at that shrink's
    need, and keeps its rung through the later compactions."""
    mj, mt = _mappers(_cfg(jcfg, 120_000), _cfg(tcfg, 120_000))
    caps = []
    t = 0

    def run(counts):
        nonlocal t
        for c in counts:
            _frame(mj, mt, t, c)
            caps.append((mj.surfels.capacity, mt.surfels.capacity))
            t += 1

    run([1200, 20000, 45000, 60000] + [70000] * 26)
    for _cycle in range(3):
        for mp in (mj, mt):
            mp.time = t
        mj._maintain_decide(70000, 40000, t - 1, immediate=False)
        mt._maintain_decide(70000, 40000, t - 1, immediate=False)
        _set_watermark(mj, mt, 40000)  # what the compaction left
        run([40000] * 3 + [52000] * 3 + [70000] * 24)
    jax_caps, port_caps = zip(*caps)
    assert jax_caps[:60] == port_caps[:60]
    assert mt.ladder.shrink_margin == 49152 - (40000 + mt.ladder.spawn_margin) + 1
    for k in (30, 60, 90):  # JAX: shrink after each compaction, regrow within 6 frames
        assert jax_caps[k] == 49152 and jax_caps[k + 5] == 73728 == jax_caps[k - 1]
    assert set(port_caps[35:]) == {73728}
    # a map that does fall below that need shrinks in both
    for mp in (mj, mt):
        mp.time = t
    mj._maintain_decide(70000, 10000, t - 1, immediate=False)
    mt._maintain_decide(70000, 10000, t - 1, immediate=False)
    _set_watermark(mj, mt, 10000)
    run([10000] * 3)
    assert caps[-1] == (32768, 32768)

def test_default_config_follows_jax():
    """Under `default_config()` (capacity bucketing on, JAX's default) the
    port's map starts on the JAX package's rung and grows with it; a map
    fixed at `Viewer.max_surfels_num` computes another compaction
    threshold and spawn cut-off."""
    cfg_j, cfg_t = jcfg.default_config(), tcfg.default_config()
    mj, mt = _mappers(cfg_j, cfg_t)
    assert mt.surfels.capacity == mj.surfels.capacity < int(cfg_t.Viewer.max_surfels_num)
    assert mj.bucketing and mt.ladder.bucketing
    for t, c in enumerate([24000, 30000, 36000, 45000, 60000]):
        _frame(mj, mt, t, c)
        assert _state(mt) == _state(mj), t
    assert mt.surfels.capacity > mt.ladder.rungs[0]


def test_stale_binning_raises():
    """A binning cached before the map changed capacity is refused, not
    rendered with the wrong slots."""
    m = _random_map(512, seed=3)
    m["xyz"][2] = np.abs(m["xyz"][2]) + 2.0
    m["scaling"][:] = -3.0
    s = surfel_map_from_numpy(m, "cpu")
    w2c, intr = torch.eye(4), torch.tensor([60.0, 60.0, 31.5, 23.5])
    binning = rt.compute_binning(tsf.render_params(s), w2c, intr, W, H, cap=256)
    rt.render_tile(tsf.render_params(s), w2c, intr, W, H, sh_degree=1, cap=256, binning=binning)
    grown = tsf.grow_surfels(s, 1024)
    with pytest.raises(ValueError, match="stale binning"):
        rt.render_tile(tsf.render_params(grown), w2c, intr, W, H, sh_degree=1, cap=256, binning=binning)


@pytest.mark.parametrize("n_rows", [2000, 40000, 45000])
def test_reload_follows_jax(tmp_path, n_rows):
    """A PLY larger than the map grows it to the ladder's rung for it;
    above `Viewer.max_surfels_num` (40000) the first 40000 rows are kept."""
    rng = np.random.default_rng(n_rows)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    path = str(tmp_path / "map.ply")
    t_ply.save_ply(path, f(n_rows, 3), f(n_rows, 3, 1), np.zeros((n_rows, 3, 0), np.float32), f(n_rows, 3),
                   f(n_rows, 4), f(n_rows, 1))
    ef_j = JEGGFusion(_cfg(jcfg, 40000, save_dir=str(tmp_path / "j")))
    ef_t = TEGGFusion(_cfg(tcfg, 40000, save_dir=str(tmp_path / "t")), device="cpu")
    ef_j.reload(path)
    ef_t.reload(path)
    got = surfel_map_to_numpy(ef_t.mapper.surfels)
    for k in tsf.FIELDS:
        assert got[k].tobytes() == np.asarray(getattr(ef_j.mapper.surfels, k)).tobytes(), k
    assert _state(ef_t.mapper) == _state(ef_j.mapper)
    assert int(got["count"]) == min(n_rows, 40000)


def test_resume_keeps_checkpoint_capacity(tmp_path):
    """Both packages resume a checkpoint at its own capacity, whatever the
    configured maximum, with the consumed count its watermark."""
    m = _random_map(4096, seed=5)
    path = str(tmp_path / "ckpt.npz")
    j_ckpt.save_checkpoint(path, jsf.SurfelMap(**{k: jnp.asarray(v) for k, v in m.items()}),
                           extra={"time": np.int64(7)})
    for max_surfels in (2048, 65536):
        ef_j = JEGGFusion(_cfg(jcfg, max_surfels))
        ef_t = TEGGFusion(_cfg(tcfg, max_surfels), device="cpu")
        ef_j.resume(path)
        ef_t.resume(path)
        assert _state(ef_t.mapper) == _state(ef_j.mapper) == (4096, int(m["count"]), 6)
        assert ef_t.mapper.time == ef_j.mapper.time == 7
