"""kernels.composite_ms: device ms a frame in the surfel compositors
(`csrc/composite_fwd.cu`: forward and geometry-only; `csrc/composite_bwd.cu`),
by kernel name in the trace, graph replays included."""

NAMES = ("composite_fwd_kernel", "composite_bwd_kernel")


def read(record):
    tr = record["trace"]
    if tr is None or not record["frames"]:
        return None
    ns = sum(int(e - s) for n, s, e in zip(tr["op_name"], tr["op_start"], tr["op_end"])
             if any(k in n for k in NAMES))
    return ns / 1e6 / record["frames"] if ns else None
