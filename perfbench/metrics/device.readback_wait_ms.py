"""device.readback_wait_ms: host ms a frame blocked on reads of the device
(lagged readbacks, synchronous checks): the mean `readback_ms` of the
window's frame records (`EGGFusion.metrics`)."""


def read(record):
    ms = [m["readback_ms"] for m in record["ef_metrics"] if "readback_ms" in m]
    return sum(ms) / len(ms) if ms else None
