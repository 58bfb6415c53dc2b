"""graphs.capture_ms: host ms a frame spent making program entries (static
inputs, warm runs, graph captures): the mean `capture_ms` of the window's
frame records (`EGGFusion.metrics`)."""


def read(record):
    ms = [m["capture_ms"] for m in record["ef_metrics"] if "capture_ms" in m]
    return sum(ms) / len(ms) if ms else None
