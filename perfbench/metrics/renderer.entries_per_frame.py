"""renderer.entries_per_frame: millions of entries binned into 32x32
sub-columns a frame, the map update's render and the optimization steps
together (each step counts the entries of the binning it composites): the
sum of `binned_entries + binned_entries_opt` over the window's frame records
(`EGGFusion.metrics`) over the frames they cover (`render_frames`). A
program without the counters reads nothing."""


def read(record):
    recs = [m for m in record["ef_metrics"] if "render_frames" in m]
    frames = sum(m["render_frames"] for m in recs)
    if not frames:
        return None
    return sum(m.get("binned_entries", 0) + m.get("binned_entries_opt", 0) for m in recs) / frames / 1e6
