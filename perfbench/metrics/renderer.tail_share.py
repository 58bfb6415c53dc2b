"""renderer.tail_share: the share of the entries binned into 32x32
sub-columns that lie past the exact 3/4 of their sub-column's slots, where
the stratified tail keeps only every fourth and the cap drops the rest:
100 x sum(tail_entries + tail_entries_opt) / sum(binned_entries +
binned_entries_opt) over the window's frame records (`EGGFusion.metrics`;
the map update's render and the optimization steps together). A program
without the counters reads nothing."""

BINNED = ("binned_entries", "binned_entries_opt")
TAIL = ("tail_entries", "tail_entries_opt")


def read(record):
    recs = [m for m in record["ef_metrics"] if "render_frames" in m]
    binned = sum(m.get(k, 0) for m in recs for k in BINNED)
    return 100.0 * sum(m.get(k, 0) for m in recs for k in TAIL) / binned if binned else None
