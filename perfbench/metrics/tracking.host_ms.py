"""tracking.host_ms: the program's own host `track_ms` a frame
(`EGGFusion.metrics`), recovery and the sparse seed's readback included,
averaged over the window's frames."""


def read(record):
    ms = [m["track_ms"] for m in record["ef_metrics"]]
    return sum(ms) / len(ms) if ms else None
