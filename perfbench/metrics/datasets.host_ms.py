"""datasets.host_ms: host ms a frame in `main.build_frame` (the benchmark's
span around it): the loader's decode or prefetch wait, undistortion,
upload and the frame program's launch."""


def read(record):
    ms = record["build_ms"]
    return sum(ms) / len(ms) if ms else None
