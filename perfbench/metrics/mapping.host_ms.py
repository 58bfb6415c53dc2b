"""mapping.host_ms: the program's own host `map_ms + post_ms` a frame
(`EGGFusion.metrics`), averaged over the window's frames."""


def read(record):
    ms = [m["map_ms"] + m["post_ms"] for m in record["ef_metrics"]]
    return sum(ms) / len(ms) if ms else None
