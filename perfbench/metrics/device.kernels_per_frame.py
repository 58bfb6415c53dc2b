"""device.kernels_per_frame: device kernels in the trace a frame, those a
graph replays included."""


def read(record):
    tr = record["trace"]
    if tr is None or not record["frames"]:
        return None
    n = int((tr["op_kind"] == "kernel").sum())
    return n / record["frames"] if n else None
