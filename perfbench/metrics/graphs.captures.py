"""graphs.captures: CUDA graphs the program captured during the window
(`Programs.captures()` at its end less at its start): the rungs the map
grew into, which users pay for in the frame that captures them."""


def read(record):
    return record["captures"]
