"""device.idle_share: the share of the traced window in which no device
operation (kernel, copy or fill, on any stream) ran: 100 x (1 - union of
their intervals / the window)."""
from perfbench.harness import stats


def read(record):
    tr = record["trace"]
    if tr is None or tr["window_ns"] is None:
        return None
    lo, hi = tr["window_ns"]
    return 100.0 * (1.0 - stats.busy_ns(tr["op_start"], tr["op_end"], lo, hi) / (hi - lo))
