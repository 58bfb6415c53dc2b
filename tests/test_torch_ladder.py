"""The surfel map's slot policy (`core/capacity.py`) through the mapper's
own calls on the host, and the lag queue the mapper reads device values
through (`utils/device.Lagged`).

`test_decision_trace` runs a `Mapping` through a scripted run, its map and
its programs stand-ins (a map is its capacity and its count; a program is
the set of rung tags it holds: `prepare` and a call add the tag, `drop`
removes it), and holds it, frame by frame, to the decisions the mapper made
before the policy left it, recorded with the same script on that mapper.
Each frame makes the calls `Mapping.mapping` makes, in its order:
`fit_capacity`; `capture_rung` on a rung the map first stands on; the
frame's count readback (`ladder.observe`); the deferred maintenance
(`_maintain_finish`, then `maintain_map(defer=True)` every `prune_freq`
frames on the script's two counts; a compaction leaves the script's
watermark); the window optimization's step (`_opt`). A resume is `adopt`.
A frame's entry is (capacity, work rung, the ladder's count, its frame, the
tags dropped).

Profiles:
  * scannetpp (`perfbench/configs/scannetpp.json`): 1752x1168,
    `sample_ratio` 0.05, so `spawn_cap` 204889 and `spawn_cap_init` 614156,
    `count_lag` 1, the map held at 3000000 by `System.min_capacity`. The
    work rung climbs 622592 -> 1245184 -> 2490368 (crossing at watermarks
    417703 / 1040295); after a compaction the bound falls to 622592's, and
    the shrink's margin holds it at 1245184 until it climbs back; a resume
    of a 3000000-slot map starts it anew.
  * replica (`perfbench/configs/replica.json`): 1200x680, `sample_ratio`
    0.025, `count_lag` 2, the ladder up to 1000000. The map climbs from
    311296 to the maximum, shrinks to 442368 after a compaction and grows
    back (widening the shrink's margin); a resume of a 442368-slot map grows
    to 622592, where the widened margin keeps it through a second
    compaction.
  * floor: the scannetpp widths with the floor at 1245184, below the
    3000000 maximum. The map starts on the floor with the work rung below
    it, grows off the floor, shrinks back onto it after a compaction (the
    work rung then falls to 622592 and climbs back), grows off it again
    (widening the shrink's margin), and a resume of a 2490368-slot map
    holding 250000 surfels shrinks onto the floor at once, where the work
    rung comes from the bound the resume set (622592; the shrink's margin
    from the rung it left would keep 1245184).
"""
import types

import pytest
import torch

from eggfusion_tpu_torch import config as tcfg
from eggfusion_tpu_torch.core import mapper as tmapper
from eggfusion_tpu_torch.core import surfels as tsf
from eggfusion_tpu_torch.core.renderer import Renderer
from eggfusion_tpu_torch.utils.device import Lagged


def _scannetpp():
    counts = [417703, 417704, 700000, 1040295, 1040296, 1200000]
    counts += [1200000 + 5000 * (t - 5) for t in range(6, 33)]
    counts += [405000 + 60000 * (t - 33) for t in range(33, 46)]  # after the compaction
    counts += [820000 + 20000 * (t - 46) for t in range(46, 50)]  # after the resume
    return dict(size=(1168, 1752), sample_ratio=0.05, max=3_000_000, floor=3_000_000, lag=1, counts=counts,
                prunes={30: (1325000, 400000)}, resumes={46: (3_000_000, 800000)})


def _replica():
    counts = [240000 + 16000 * t for t in range(0, 34)]
    counts += [320000 + 12000 * (t - 34) for t in range(34, 52)]  # after the compaction
    counts += [405000 + 35000 * (t - 52) for t in range(52, 57)]  # after the resume
    counts += [545000 + 5000 * (t - 56) for t in range(57, 64)]
    counts += [352000 + 2000 * (t - 64) for t in range(64, 68)]  # after the second compaction
    return dict(size=(680, 1200), sample_ratio=0.025, max=1_000_000, floor=0, lag=2, counts=counts,
                prunes={30: (720000, 300000), 60: (565000, 350000)}, resumes={52: (442368, 400000)})


def _floor():
    counts = [400000 + 60000 * t for t in range(0, 15)]
    counts += [1240000 + 10000 * (t - 14) for t in range(15, 33)]
    counts += [320000 + 30000 * (t - 33) for t in range(33, 38)]  # after the compaction
    counts += [440000 + 100000 * (t - 37) for t in range(38, 52)]
    counts += [260000 + 20000 * (t - 52) for t in range(52, 63)]  # after the resume
    counts += [215000 + 5000 * (t - 63) for t in range(63, 66)]  # after the second compaction
    # a prune's (watermark, active count, the watermark its compaction leaves)
    return dict(size=(1168, 1752), sample_ratio=0.05, max=3_000_000, floor=1245184, lag=1, counts=counts,
                prunes={30: (1400000, 300000, 310000), 60: (420000, 200000, 210000)},
                resumes={52: (2490368, 250000)})


PROFILES = {"scannetpp": _scannetpp, "replica": _replica, "floor": _floor}

# recorded on the mapper of commit 1b808fd, whose `Mapping` held the policy: the
# same run with `_ensure_capacity` and `_update_opt_slots` for `fit_capacity`, its
# two count queues' appends for `ladder.observe` and `forget_pending` for `adopt`
TRACE = {
    "scannetpp": [
        (3000000, 622592, 0, -1, ()), (3000000, 622592, 417703, 0, ()),
        (3000000, 1245184, 417704, 1, (622592,)), (3000000, 1245184, 700000, 2, ()),
        (3000000, 1245184, 1040295, 3, ()), (3000000, 2490368, 1040296, 4, (1245184,)),
        (3000000, 2490368, 1200000, 5, ()), (3000000, 2490368, 1205000, 6, ()),
        (3000000, 2490368, 1210000, 7, ()), (3000000, 2490368, 1215000, 8, ()),
        (3000000, 2490368, 1220000, 9, ()), (3000000, 2490368, 1225000, 10, ()),
        (3000000, 2490368, 1230000, 11, ()), (3000000, 2490368, 1235000, 12, ()),
        (3000000, 2490368, 1240000, 13, ()), (3000000, 2490368, 1245000, 14, ()),
        (3000000, 2490368, 1250000, 15, ()), (3000000, 2490368, 1255000, 16, ()),
        (3000000, 2490368, 1260000, 17, ()), (3000000, 2490368, 1265000, 18, ()),
        (3000000, 2490368, 1270000, 19, ()), (3000000, 2490368, 1275000, 20, ()),
        (3000000, 2490368, 1280000, 21, ()), (3000000, 2490368, 1285000, 22, ()),
        (3000000, 2490368, 1290000, 23, ()), (3000000, 2490368, 1295000, 24, ()),
        (3000000, 2490368, 1300000, 25, ()), (3000000, 2490368, 1305000, 26, ()),
        (3000000, 2490368, 1310000, 27, ()), (3000000, 2490368, 1315000, 28, ()),
        (3000000, 2490368, 1320000, 29, ()), (3000000, 2490368, 1325000, 30, ()),
        (3000000, 2490368, 400000, 30, ()), (3000000, 2490368, 400000, 30, ()),
        (3000000, 1245184, 405000, 33, (2490368,)), (3000000, 1245184, 465000, 34, ()),
        (3000000, 1245184, 525000, 35, ()), (3000000, 1245184, 585000, 36, ()),
        (3000000, 1245184, 645000, 37, ()), (3000000, 1245184, 705000, 38, ()),
        (3000000, 1245184, 765000, 39, ()), (3000000, 1245184, 825000, 40, ()),
        (3000000, 1245184, 885000, 41, ()), (3000000, 1245184, 945000, 42, ()),
        (3000000, 1245184, 1005000, 43, ()), (3000000, 2490368, 1065000, 44, (1245184,)),
        (3000000, 1245184, 800000, 45, (2490368, 3000000)), (3000000, 1245184, 820000, 46, ()),
        (3000000, 1245184, 840000, 47, ()), (3000000, 1245184, 860000, 48, ()),
    ],
    "replica": [
        (311296, 311296, 0, -1, ()), (311296, 311296, 0, -1, ()),
        (311296, 311296, 240000, 0, ()), (311296, 311296, 256000, 1, ()),
        (311296, 311296, 272000, 2, ()), (311296, 311296, 288000, 3, ()),
        (311296, 311296, 304000, 4, ()), (442368, 442368, 311296, 5, (311296,)),
        (442368, 442368, 311296, 6, ()), (442368, 442368, 352000, 7, ()),
        (442368, 442368, 368000, 8, ()), (442368, 442368, 384000, 9, ()),
        (442368, 442368, 400000, 10, ()), (442368, 442368, 416000, 11, ()),
        (442368, 442368, 432000, 12, ()), (622592, 622592, 442368, 13, (442368,)),
        (622592, 622592, 442368, 14, ()), (622592, 622592, 480000, 15, ()),
        (622592, 622592, 496000, 16, ()), (622592, 622592, 512000, 17, ()),
        (622592, 622592, 528000, 18, ()), (622592, 622592, 544000, 19, ()),
        (622592, 622592, 560000, 20, ()), (622592, 622592, 576000, 21, ()),
        (622592, 622592, 592000, 22, ()), (622592, 622592, 608000, 23, ()),
        (1000000, 1000000, 622592, 24, (622592,)), (1000000, 1000000, 622592, 25, ()),
        (1000000, 1000000, 656000, 26, ()), (1000000, 1000000, 672000, 27, ()),
        (1000000, 1000000, 688000, 28, ()), (1000000, 1000000, 704000, 29, ()),
        (1000000, 1000000, 720000, 30, ()), (1000000, 1000000, 300000, 30, ()),
        (442368, 442368, 300000, 34, (1000000,)), (442368, 442368, 300000, 34, ()),
        (442368, 442368, 320000, 34, ()), (442368, 442368, 332000, 35, ()),
        (442368, 442368, 344000, 36, ()), (442368, 442368, 356000, 37, ()),
        (442368, 442368, 368000, 38, ()), (442368, 442368, 380000, 39, ()),
        (442368, 442368, 392000, 40, ()), (442368, 442368, 404000, 41, ()),
        (442368, 442368, 416000, 42, ()), (442368, 442368, 428000, 43, ()),
        (622592, 622592, 440000, 44, (442368,)), (622592, 622592, 442368, 45, ()),
        (622592, 622592, 464000, 46, ()), (622592, 622592, 476000, 47, ()),
        (622592, 622592, 488000, 48, ()), (622592, 622592, 500000, 49, ()),
        (442368, 442368, 400000, 51, (622592,)), (442368, 442368, 400000, 51, ()),
        (442368, 442368, 405000, 52, ()), (622592, 622592, 440000, 53, (442368,)),
        (622592, 622592, 442368, 54, ()), (622592, 622592, 510000, 55, ()),
        (622592, 622592, 545000, 56, ()), (622592, 622592, 550000, 57, ()),
        (622592, 622592, 555000, 58, ()), (622592, 622592, 560000, 59, ()),
        (622592, 622592, 565000, 60, ()), (622592, 622592, 350000, 60, ()),
        (622592, 622592, 350000, 60, ()), (622592, 622592, 350000, 60, ()),
        (622592, 622592, 352000, 64, ()), (622592, 622592, 354000, 65, ()),
    ],
    "floor": [
        (1245184, 622592, 0, -1, ()), (1245184, 622592, 400000, 0, ()),
        (1245184, 1245184, 460000, 1, (622592,)), (1245184, 1245184, 520000, 2, ()),
        (1245184, 1245184, 580000, 3, ()), (1245184, 1245184, 640000, 4, ()),
        (1245184, 1245184, 700000, 5, ()), (1245184, 1245184, 760000, 6, ()),
        (1245184, 1245184, 820000, 7, ()), (1245184, 1245184, 880000, 8, ()),
        (1245184, 1245184, 940000, 9, ()), (1245184, 1245184, 1000000, 10, ()),
        (1245184, 1245184, 1060000, 11, ()), (1245184, 1245184, 1120000, 12, ()),
        (1245184, 1245184, 1180000, 13, ()), (2490368, 2490368, 1240000, 14, (1245184,)),
        (2490368, 2490368, 1250000, 15, ()), (2490368, 2490368, 1260000, 16, ()),
        (2490368, 2490368, 1270000, 17, ()), (2490368, 2490368, 1280000, 18, ()),
        (2490368, 2490368, 1290000, 19, ()), (2490368, 2490368, 1300000, 20, ()),
        (2490368, 2490368, 1310000, 21, ()), (2490368, 2490368, 1320000, 22, ()),
        (2490368, 2490368, 1330000, 23, ()), (2490368, 2490368, 1340000, 24, ()),
        (2490368, 2490368, 1350000, 25, ()), (2490368, 2490368, 1360000, 26, ()),
        (2490368, 2490368, 1370000, 27, ()), (2490368, 2490368, 1380000, 28, ()),
        (2490368, 2490368, 1390000, 29, ()), (2490368, 2490368, 1400000, 30, ()),
        (2490368, 2490368, 300000, 30, ()), (1245184, 1245184, 310000, 33, (2490368,)),
        (1245184, 622592, 320000, 33, (1245184,)), (1245184, 622592, 350000, 34, ()),
        (1245184, 622592, 380000, 35, ()), (1245184, 622592, 410000, 36, ()),
        (1245184, 1245184, 440000, 37, (622592,)), (1245184, 1245184, 540000, 38, ()),
        (1245184, 1245184, 640000, 39, ()), (1245184, 1245184, 740000, 40, ()),
        (1245184, 1245184, 840000, 41, ()), (1245184, 1245184, 940000, 42, ()),
        (1245184, 1245184, 1040000, 43, ()), (1245184, 1245184, 1140000, 44, ()),
        (2490368, 2490368, 1240000, 45, (1245184,)), (2490368, 2490368, 1340000, 46, ()),
        (2490368, 2490368, 1440000, 47, ()), (2490368, 2490368, 1540000, 48, ()),
        (2490368, 2490368, 1640000, 49, ()), (2490368, 2490368, 1740000, 50, ()),
        (1245184, 622592, 250000, 52, (2490368,)), (1245184, 622592, 260000, 52, ()),
        (1245184, 622592, 280000, 53, ()), (1245184, 622592, 300000, 54, ()),
        (1245184, 622592, 320000, 55, ()), (1245184, 622592, 340000, 56, ()),
        (1245184, 622592, 360000, 57, ()), (1245184, 622592, 380000, 58, ()),
        (1245184, 622592, 400000, 59, ()), (1245184, 1245184, 420000, 60, (622592,)),
        (1245184, 1245184, 200000, 60, ()), (1245184, 1245184, 200000, 60, ()),
        (1245184, 1245184, 215000, 63, ()), (1245184, 1245184, 220000, 64, ()),
    ],
}


class _Map:
    """A map as the slot policy sees it: its capacity and its count (the
    fields, which no decision reads, are None)."""

    def __init__(self, capacity: int, count: int = 0):
        self.capacity, self.count = capacity, torch.tensor(count, dtype=torch.int32)

    def __getattr__(self, name):
        if name in tmapper.OPT_FIELDS:
            return None
        raise AttributeError(name)


class _Program:
    def __init__(self, dropped: set):
        self.dropped, self.tags, self.result = dropped, set(), None

    def prepare(self, static, state, inputs, rung=None, device=None):
        self.tags.add(rung)

    def __call__(self, static, state, inputs, rung=None, device=None):
        self.tags.add(rung)
        return self.result(state) if self.result else (None, None)

    def drop(self, rung=None):
        gone = set(self.tags) if rung is None else self.tags & {rung}
        self.tags -= gone
        self.dropped |= gone


class _Programs:
    enabled = True

    def __init__(self):
        self.programs, self.dropped = {}, set()

    def program(self, name, fn):
        return self.programs.setdefault(name, _Program(self.dropped))

    def drop(self, rung=None):
        for p in self.programs.values():
            p.drop(rung)


def _mapper(prof, monkeypatch):
    """A `Mapping` of the profile on stand-in maps and programs."""
    H, W = prof["size"]
    cfg = tcfg.default_config(
        Dataset={"Calibration": {"fx": 600.0, "fy": 600.0, "cx": W / 2 - 0.5, "cy": H / 2 - 0.5,
                                 "width": W, "height": H}},
        Viewer={"max_surfels_num": prof["max"]},
        Mapping={"sample_ratio": prof["sample_ratio"], "sample_ratio_init": 0.2},
        Surfel={"max_sh_degree": 0, "active_sh_degree": 0},
        System={"render_backend": "xla", "min_capacity": prof["floor"], "count_lag": prof["lag"]})
    monkeypatch.setattr(tsf.SurfelMap, "empty", staticmethod(lambda scfg, device=None: _Map(scfg.capacity)))
    for name in ("grow_surfels", "shrink_surfels", "prefix"):
        monkeypatch.setattr(tsf, name, lambda s, n: _Map(n, int(s.count)))
    monkeypatch.setattr(tmapper, "_geo_snapshot", lambda s: {})
    monkeypatch.setattr(tmapper, "_adam_init", lambda params: {})
    return tmapper.Mapping(cfg, Renderer(cfg, "cpu"), "cpu", programs=_Programs())


def _run(m, prof) -> list:
    """The scripted run through `m`; returns its trace."""
    dropped = m.programs.dropped
    frame_map = dict.fromkeys(("color_map", "depth_map", "normal_map_c", "rgb_mask", "geo_mask"))
    kf = types.SimpleNamespace(w2c=None, intr=None, width=8, height=8)
    left = {}
    m._p_compact.result = lambda s: setattr(s, "count", torch.tensor(left["n"], dtype=torch.int32))
    out = []
    for t, count in enumerate(prof["counts"]):
        dropped.clear()
        m.time = t
        if t in prof["resumes"]:
            cap, n = prof["resumes"][t]
            m.adopt(_Map(cap, n), n)
        m.fit_capacity()
        if m.surfels.capacity not in m._captured_rungs:
            m.capture_rung(frame_map, None, None, kf.width, kf.height, first=t == 0)
        m.surfels.count = torch.tensor(min(count, m.surfels.capacity), dtype=torch.int32)
        m.ladder.observe(t, m.surfels.count)
        m._maintain_finish()
        if t > 0 and t % m.mcfg.prune_freq == 0:
            cnt, act, *after = prof["prunes"][t]
            left["n"] = after[0] if after else act
            m._p_prune.result = lambda s, c=cnt, a=act: (torch.tensor(c), torch.tensor(a))
            m.maintain_map(defer=True)
        m._opt("window", kf, {}, {}, {}, cache=True)
        lad = m.ladder
        out.append((m.surfels.capacity, lad.opt_slots, lad.known_count, lad.known_time, tuple(sorted(dropped))))
    return out


@pytest.mark.parametrize("profile", list(PROFILES))
def test_decision_trace(profile, monkeypatch):
    prof = PROFILES[profile]()
    got = _run(_mapper(prof, monkeypatch), prof)
    want = TRACE[profile]
    assert len(got) == len(want) == len(prof["counts"])
    for t, (g, w) in enumerate(zip(got, want)):
        assert g == w, (t, g, w)


def test_lagged_reads_a_value_lag_frames_late():
    """A value pushed at frame t is read first at frame t + lag, once;
    `clear` drops what was not read; a tuple is read member by member."""
    q = Lagged(2)
    q.push(3, torch.tensor(7))
    q.push(4, (torch.tensor(1), torch.tensor([2, 3])))
    assert list(q.ready(4)) == []
    [(t, v)] = list(q.ready(5))
    assert (t, int(v)) == (3, 7)
    assert list(q.ready(5)) == []
    [(t, (a, b))] = list(q.ready(6))
    assert t == 4 and int(a) == 1 and b.tolist() == [2, 3]
    q.push(6, torch.tensor(9))
    q.clear()
    assert list(q.ready(100)) == []


def test_leaving_a_floor_rung_drops_its_work_rungs(monkeypatch):
    """A map on a 2490368-slot floor captures the window optimization's
    programs on its work rung and each rung above it (622592, 1245184);
    moving the map off the floor drops them with the floor rung's own."""
    prof = dict(_floor(), floor=2490368)
    m = _mapper(prof, monkeypatch)
    frame_map = dict.fromkeys(("color_map", "depth_map", "normal_map_c", "rgb_mask", "geo_mask"))
    m.fit_capacity()
    m.capture_rung(frame_map, None, None, 8, 8, first=True)
    opt, cache = m.programs.programs["opt_step"], m.programs.programs["bin_cache"]
    assert (m.surfels.capacity, m.ladder.opt_slots) == (2490368, 622592)
    assert opt.tags == cache.tags == {622592, 1245184}
    m._move_to_rung(3_000_000)
    assert m.programs.dropped == {622592, 1245184, 2490368}
    assert not any(p.tags for p in m.programs.programs.values())
