"""The surfel map's slots, decided on the host once a frame (the capacity
code of the JAX `core/mapper.py`, with the port's work rung); `Mapping`
acts on the decisions. The capacity is a rung of `capacity_ladder`
(`System.capacity_bucketing`), at least the floor `System.min_capacity`.
The work rung `opt_slots`, the slots the window optimization spans (past
the watermark every slot is inactive with zero Adam moments), is the rung
for the watermark bound where the floor holds the capacity above the
count's need, else the capacity. Both read one stream of count readbacks,
`count_lag` frames late. A decision that counts the map itself (a shrink,
maintenance) cuts it: the readbacks pushed before it no longer set the
ladder's count, but still bound the work rung.
"""
from __future__ import annotations

from typing import NamedTuple

from eggfusion_tpu_torch.utils.device import Lagged


def capacity_ladder(max_capacity: int, factor: float = 1.4, coarse_at: int = 524288,
                    factor_large: float = 2.0) -> list[int]:
    """The map's capacity rungs: 32768, then each rung times `factor`
    (`factor_large` from `coarse_at` on) rounded up to a multiple of 8192,
    capped by a last rung of `max_capacity`."""
    ladder = []
    c = 32768
    while c < max_capacity:
        ladder.append(c)
        f = factor if c < coarse_at else factor_large
        c = -(-int(c * f) // 8192) * 8192
    ladder.append(max_capacity)
    return ladder


# a frame's capacity and work rung, the work rung it leaves, whether slots
# moved (cached binnings and Adam moments refer to them), and the counts the
# ladder read, oldest first
Plan = NamedTuple("Plan", [("capacity", int), ("opt_slots", int), ("work_from", int), ("invalidate", bool),
                           ("read", list)])


class CapacityLadder:
    """`rungs` ascending, the last the maximum; `spawn_cap` / `spawn_cap_init`:
    what a map update (frame 0's) can append; `prefix` False (a mesh) keeps
    the work rung at the capacity."""

    def __init__(self, rungs, spawn_cap: int, spawn_cap_init: int, count_lag: int = 2, prune_freq: int = 30,
                 min_capacity: int = 0, bucketing: bool = True, prefix: bool = True):
        self.rungs, self.min_capacity = list(rungs), min_capacity
        self.bucketing, self.prefix = bucketing, prefix
        self.spawn_cap, self.spawn_cap_init, self.prune_freq = spawn_cap, spawn_cap_init, prune_freq
        self.spawn_margin = self.shrink_margin = spawn_cap // 8 + 2048
        self.cooldown = 0
        self.counts = Lagged(count_lag)
        self.forget(0, 0, self.start())

    @classmethod
    def from_config(cls, cfg, spawn_cap: int, spawn_cap_init: int, prefix: bool = True) -> "CapacityLadder":
        s = cfg.System
        rungs = capacity_ladder(int(cfg.Viewer.max_surfels_num), float(s.get("bucket_factor", 1.4)),
                                int(s.get("bucket_coarse_at", 524288)), float(s.get("bucket_factor_large", 2.0)))
        return cls(rungs, spawn_cap, spawn_cap_init, max(1, int(s.get("count_lag", 2))),
                   int(cfg.Mapping.get("prune_freq", 30)), int(s.get("min_capacity", 0)),
                   bool(s.get("capacity_bucketing", True)), prefix)

    @property
    def max_capacity(self) -> int:
        return self.rungs[-1]

    def rung_for(self, n: int) -> int:
        """The smallest rung that holds `n`, at least the floor, at most the maximum."""
        n = min(max(n, self.min_capacity), self.max_capacity)
        return next(c for c in self.rungs if c >= n)

    def start(self) -> int:
        """A new map's capacity: the rung for frame 0's spawns."""
        return self.rung_for(self.spawn_cap_init + self.spawn_margin) if self.bucketing else self.max_capacity

    def work_tags(self, capacity: int) -> list[int]:
        """The work rungs below `capacity` that programs on such a map can
        carry: the rungs below it where the floor holds it, else none."""
        engaged = self.prefix and self.bucketing and capacity <= self.rung_for(0)
        return [r for r in self.rungs if r < capacity] if engaged else []

    def work_rung(self, capacity: int, time: int, margin: int = 0) -> int:
        """The smallest rung that holds the watermark bound at frame `time`
        plus `margin`, at most `capacity`: the count bound plus `spawn_cap`
        a frame since (frame 0's up to `spawn_cap_init`)."""
        if not self.work_tags(capacity):
            return capacity
        count, t = self._bound
        need = count + (time - t) * self.spawn_cap + (self.spawn_cap_init - self.spawn_cap if t < 0 else 0)
        return min(next((c for c in self.rungs if c >= need + margin), capacity), capacity)

    def observe(self, time: int, count) -> None:
        """Start reading the map's count (a device scalar) after frame `time`'s update."""
        self.counts.push(time, count)
        self._newest = max(self._newest, time)

    def _count(self, count: int, time: int) -> None:
        """A decision's own count of the map as of frame `time`: it cuts the stream."""
        self.known_count, self.known_time, self._cut = count, time, self._newest

    def plan(self, time: int, capacity: int, read_watermark) -> Plan:
        """Frame `time`'s slots on a map of `capacity` slots, from the counts
        due; `read_watermark()` reads the map's count on the host, only when
        a shrink is possible."""
        fresh, read = None, []
        for t, v in self.counts.ready(time):
            fresh = (int(v), t)
            if t > self._cut:
                self.known_count, self.known_time = fresh
                read.append(self.known_count)
        new, invalidate = capacity, False
        if self.bucketing:
            new, invalidate = self._fit(time, capacity, read_watermark)
        if new != capacity:  # the hysteresis starts from the new capacity's rung for the bound so far
            self.opt_slots = self.work_rung(new, time)
        if fresh is not None:
            self._bound = fresh
        # up as soon as the bound passes the rung; down only when the bound
        # plus the shrink's margin fits a lower rung
        old = min(self.opt_slots, new)
        work = self.work_rung(new, time)
        if work < old:
            work = min(old, self.work_rung(new, time, self.shrink_margin))
        self.opt_slots = work
        return Plan(new, work, old, invalidate, read)

    def _fit(self, time: int, capacity: int, read_watermark) -> tuple[int, bool]:
        """Grow to the rung for the count plus `spawn_margin` (and frame 0's
        burst; a need past the maximum drops the slots' state too), or shrink
        to the rung for that plus the shrink's margin if the watermark fits
        it (else wait `prune_freq` frames); outgrowing a rung it shrank to
        widens the margin to what would have kept the map there."""
        need = self.known_count + self.spawn_margin + (self.spawn_cap_init if self.known_time < 0 else 0)
        if need > capacity:
            if self._last_shrink is not None:
                rung, need_then = self._last_shrink
                self.shrink_margin = max(self.shrink_margin, rung - need_then + 1)
                self._last_shrink = None
            return self.rung_for(need), True
        rung = self.rung_for(need + self.shrink_margin)
        if rung >= capacity or time < self.cooldown:
            return capacity, False
        wm = read_watermark()
        if wm > rung:
            self.cooldown = time + max(self.prune_freq, 1)
            return capacity, False
        self._count(wm, time)
        self._last_shrink = (rung, need)
        return rung, True

    def maintained(self, count: int, known_time: int, time: int, capacity: int, immediate: bool) -> int:
        """Maintenance counted `count` slots in use as of frame `known_time`; a
        direct call (`immediate`) also shrinks to the rung for it plus two
        spawn margins. Returns the capacity to stand on."""
        self._count(count, known_time)
        rung = self.rung_for(count + 2 * self.spawn_margin)
        if self.bucketing and immediate and count <= rung < capacity:
            self.opt_slots = self.work_rung(rung, time)
            return rung
        return capacity

    def forget(self, count: int, time: int, capacity: int) -> None:
        """A map of `capacity` slots, `count` in use before `time`, replaced the map."""
        self.counts.clear()
        self._newest = self._cut = -1
        self._last_shrink = None
        self.known_count, self.known_time = self._bound = (count, time - 1)
        self.opt_slots = self.work_rung(capacity, time)
