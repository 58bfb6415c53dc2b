"""datasets.upload_wait_ms: host ms a frame blocked on the staging buffers
of the frame's upload (a buffer whose previous copy to the device has not
run yet): the mean `upload_ms` of the window's frame records
(`EGGFusion.metrics`). A program without the counter reads nothing."""


def read(record):
    ms = [m["upload_ms"] for m in record["ef_metrics"] if "upload_ms" in m]
    return sum(ms) / len(ms) if ms else None
