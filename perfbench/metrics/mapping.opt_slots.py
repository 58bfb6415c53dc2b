"""mapping.opt_slots: the slots the window optimization's steps and
binnings ran on (`opt_slots` of `EGGFusion.metrics`, the work rung: the
smallest ladder rung that holds the map's watermark bound, at most the
capacity), averaged over the window's frames that ran steps. A program
without the counter reads nothing."""


def read(record):
    slots = [m["opt_slots"] for m in record["ef_metrics"] if "opt_slots" in m]
    return sum(slots) / len(slots) if slots else None
